"""jpeg.parse_cpu_ms_per_image: counter imgcodec.jpeg.parse.cpu_s (CPU time
of the Python header parse, codecs/jpeg/batch.py: the calling thread's over
span imgcodec.jpeg.parse, plus what the entropy pool's threads spend in
`parse_range`) over the images pulled in the traced window."""
UNIT = "ms/image"
SOURCE = "program_span"
COUNTER = "imgcodec.jpeg.parse.cpu_s"


def read(run):
    n = sum(len(idx) for _t, idx in run.pulled)
    if COUNTER not in run.counters or not n:
        return None
    return run.counters[COUNTER] * 1e3 / n
