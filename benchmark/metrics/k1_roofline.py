"""k1_roofline: K1 (dequant + IDCT, csrc/idct.cu, kernel idct_blocks_kernel)
as a share of its roofline, in %: the least time of the work counted from
the corpus (work.transform_work over every image decoded in the traced
window) over the kernel's time in the torch.profiler trace."""
from benchmark import work

UNIT = "%"
SOURCE = "device_trace"
KERNEL = "idct_blocks_kernel"


def read(run):
    t = run.device_trace
    if not t or not t["kernels_s"].get(KERNEL):
        return None
    sub = run.traffic["corpus"].get("subsampling", "420")
    dims = [(run.specs[i].height, run.specs[i].width)
            for _t, idx in run.pulled for i in idx]
    ops, nbytes = work.transform_work(dims, sub)
    return work.roofline_pct(ops, nbytes, t["kernels_s"][KERNEL],
                             run.device_name)
