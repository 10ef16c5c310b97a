"""jpeg.encode_device_stage_ms_per_image: span
imgcodec.jpeg.encode_device_stage (the encode's device stage with its
coefficient copy, codecs/jpeg/batch_encode.py; the host waits for the card
inside it), summed over the threads that ran it (thread time, with waits
for the interpreter lock inside), over the images encoded in the traced
window."""
UNIT = "ms/image"
SOURCE = "program_span"
SPAN = "imgcodec.jpeg.encode_device_stage"


def read(run):
    n = sum(run.encode_routes.values())
    if SPAN not in run.spans or not n:
        return None
    return run.spans[SPAN] * 1e3 / n
