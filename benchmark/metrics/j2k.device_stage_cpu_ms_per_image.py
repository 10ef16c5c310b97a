"""j2k.device_stage_cpu_ms_per_image: counter
imgcodec.jpeg2k.device_stage.cpu_s, the host CPU time of the J2K device
pixel stage (codecs/jpeg2000/core.py: enqueueing the inverse 5/3, inverse
RCT, level shift and cast on the card), its thread's over span
imgcodec.jpeg2k.device_stage, over the images pulled in the traced
window."""
UNIT = "ms/image"
SOURCE = "program_span"
COUNTER = "imgcodec.jpeg2k.device_stage.cpu_s"


def read(run):
    n = sum(len(idx) for _t, idx in run.pulled)
    if COUNTER not in run.counters or not n:
        return None
    return run.counters[COUNTER] * 1e3 / n
