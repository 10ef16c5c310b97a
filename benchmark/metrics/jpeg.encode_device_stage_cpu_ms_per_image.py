"""jpeg.encode_device_stage_cpu_ms_per_image: counter
imgcodec.jpeg.encode_device_stage.cpu_s (CPU time of the encode's device
stage, codecs/jpeg/batch_encode.py: the calling thread's over the span, its
spinning wait for the coefficients included, plus what the encode pool's
threads spend gathering host images) over the images encoded in the traced
window."""
UNIT = "ms/image"
SOURCE = "program_span"
COUNTER = "imgcodec.jpeg.encode_device_stage.cpu_s"


def read(run):
    n = sum(run.encode_routes.values())
    if COUNTER not in run.counters or not n:
        return None
    return run.counters[COUNTER] * 1e3 / n
