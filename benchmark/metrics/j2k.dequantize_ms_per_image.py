"""j2k.dequantize_ms_per_image: span imgcodec.jpeg2k.dequantize (the
dequantisation of 9/7 subbands, codecs/jpeg2000/core.py: its enqueue
where the card dequantises, the host pass where the host does), wall time
summed over the threads that ran it, over the images pulled in the traced
window. None where the program has no such span."""
UNIT = "ms/image"
SOURCE = "program_span"
SPAN = "imgcodec.jpeg2k.dequantize"


def read(run):
    n = sum(len(idx) for _t, idx in run.pulled)
    if SPAN not in run.spans or not n:
        return None
    return run.spans[SPAN] * 1e3 / n
