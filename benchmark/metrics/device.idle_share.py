"""device.idle_share: 1 - (union of the intervals in which a kernel, copy
or set ran on the card, on any stream) / (the traced window's length), in
%; source: the torch.profiler trace."""
UNIT = "%"
SOURCE = "device_trace"


def read(run):
    t = run.device_trace
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
