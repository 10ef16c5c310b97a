"""j2k.h2d_bytes_per_image: counter imgcodec.jpeg2k.h2d_bytes (the subbands
of each image, copied to the card in one upload) over the images pulled in
the traced window; source: the program's counter."""
UNIT = "B/image"
SOURCE = "program_counter"
COUNTER = "imgcodec.jpeg2k.h2d_bytes"


def read(run):
    n = sum(len(idx) for _t, idx in run.pulled)
    if COUNTER not in run.counters or not n:
        return None
    return run.counters[COUNTER] / n
