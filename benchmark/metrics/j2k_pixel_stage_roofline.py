"""j2k_pixel_stage_roofline: the J2K device pixel stage (inverse 5/3,
inverse RCT, level shift, cast to uint8: torch kernels) as a share of its
roofline, in %: the least time of its bytes counted from the corpus
(work_j2k.stage_bytes over every image pulled in the traced window) over
the summed time of every kernel in the torch.profiler trace. A J2K decode's
only device work is this stage, so every kernel of the window is its; the
upload's copy is not a kernel and is not counted."""
from benchmark import work_j2k

UNIT = "%"
SOURCE = "device_trace"
COMPONENTS = 3  # RGB


def read(run):
    t = run.device_trace
    seconds = sum(t["kernels_s"].values()) if t else 0.0
    if not seconds:
        return None
    dims = [(run.specs[i].height, run.specs[i].width)
            for _t, idx in run.pulled for i in idx]
    return work_j2k.stage_roofline_pct(dims, COMPONENTS, seconds,
                                       run.device_name)
