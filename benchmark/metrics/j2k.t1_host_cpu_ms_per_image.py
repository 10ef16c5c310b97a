"""j2k.t1_host_cpu_ms_per_image: counter imgcodec.jpeg2k.t1_host.cpu_s,
the CPU time of the host Tier-1 (the native code-block decode of
codecs/jpeg2000/core.py's host sinks, native/j2k_block_batch.cpp): the
calling thread's over span imgcodec.jpeg2k.t1_host and the native worker
threads' that the call starts, charged to the span; over the images pulled
in the traced window. None where the program has no such span (one that
predates it) or decoded nothing there."""
UNIT = "ms/image"
SOURCE = "program_span"
COUNTER = "imgcodec.jpeg2k.t1_host.cpu_s"


def read(run):
    n = sum(len(idx) for _t, idx in run.pulled)
    if COUNTER not in run.counters or not n:
        return None
    return run.counters[COUNTER] * 1e3 / n
