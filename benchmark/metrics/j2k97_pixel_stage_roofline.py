"""j2k97_pixel_stage_roofline: the J2K irreversible device pixel stage
(dequantisation, inverse 9/7, inverse ICT, level shift, rounding and the
cast to uint16: torch kernels) as a share of its roofline, in %: the least
time of its bytes counted from the corpus (work_j2k97.stage_bytes over
every image pulled in the traced window) over the summed time of every
kernel in the torch.profiler trace. The cell's Tier-1 runs on the host, so
every kernel of the window is the stage's; the upload's copy is not a
kernel and is not counted."""
from benchmark import work_j2k97

UNIT = "%"
SOURCE = "device_trace"
COMPONENTS = 3  # X'Y'Z'


def read(run):
    t = run.device_trace
    seconds = sum(t["kernels_s"].values()) if t else 0.0
    if not seconds:
        return None
    dims = [(run.specs[i].height, run.specs[i].width)
            for _t, idx in run.pulled for i in idx]
    return work_j2k97.stage_roofline_pct(dims, COMPONENTS, seconds,
                                         run.device_name)
