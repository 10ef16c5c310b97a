"""jpeg.pixel_stage_ms_per_image: span imgcodec.jpeg.pixel_stage (the
enqueue of K1, upsampling and colour, codecs/jpeg/batch.py), wall time
summed over the threads that ran it, over the images pulled in the traced
window."""
UNIT = "ms/image"
SOURCE = "program_span"
SPAN = "imgcodec.jpeg.pixel_stage"


def read(run):
    n = sum(len(idx) for _t, idx in run.pulled)
    if SPAN not in run.spans or not n:
        return None
    return run.spans[SPAN] * 1e3 / n
