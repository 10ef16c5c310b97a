"""j2k.t2_cpu_ms_per_image: counter imgcodec.jpeg2k.t2.cpu_s, the CPU time
of Tier-2 (codecs/jpeg2000/core.py: the packet headers and code-block
segments of every tile), its thread's over span imgcodec.jpeg2k.t2, over
the images pulled in the traced window."""
UNIT = "ms/image"
SOURCE = "program_span"
COUNTER = "imgcodec.jpeg2k.t2.cpu_s"


def read(run):
    n = sum(len(idx) for _t, idx in run.pulled)
    if COUNTER not in run.counters or not n:
        return None
    return run.counters[COUNTER] * 1e3 / n
