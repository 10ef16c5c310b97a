"""jpeg.host_entropy_cpu_ms_per_image: counter
imgcodec.jpeg.host_entropy.cpu_s (CPU time of the host route's native
entropy decode: the calling thread's over span imgcodec.jpeg.host_entropy,
plus what the entropy pool's threads spend in `fill`) over the images pulled
in the traced window."""
UNIT = "ms/image"
SOURCE = "program_span"
COUNTER = "imgcodec.jpeg.host_entropy.cpu_s"


def read(run):
    n = sum(len(idx) for _t, idx in run.pulled)
    if COUNTER not in run.counters or not n:
        return None
    return run.counters[COUNTER] * 1e3 / n
