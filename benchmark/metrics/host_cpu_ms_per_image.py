"""host_cpu_ms_per_image: the process's CPU time (user and system, every
thread) from the window's start to its close, over the images completed in
it; source: host clock (the process's CPU clock)."""
UNIT = "ms/image"
SOURCE = "host_clock"


def read(run):
    if not run.images or run.cpu_s is None:
        return None
    return run.cpu_s * 1e3 / run.images
