"""jpeg.parse_ms_per_image: span imgcodec.jpeg.parse (the Python header parse,
codecs/jpeg/batch.py), summed over the threads that ran it (thread time,
with waits for the interpreter lock inside), over the images pulled in the
traced window."""
UNIT = "ms/image"
SOURCE = "program_span"
SPAN = "imgcodec.jpeg.parse"


def read(run):
    n = sum(len(idx) for _t, idx in run.pulled)
    if SPAN not in run.spans or not n:
        return None
    return run.spans[SPAN] * 1e3 / n
