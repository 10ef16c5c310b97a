"""fdct_roofline: the encode's fDCT + quantisation (fdct_quant_blocks,
csrc/fdct.cu, kernel fdct_quant_kernel) as a share of its roofline, in %:
the least time of the work counted from the output geometry (the traffic's
resize size, or the input's; work.transform_work over every image encoded
in the traced window) over the kernel's time in the torch.profiler
trace."""
from benchmark import work

UNIT = "%"
SOURCE = "device_trace"
KERNEL = "fdct_quant_kernel"


def read(run):
    t = run.device_trace
    if not t or not t["kernels_s"].get(KERNEL):
        return None
    r = run.traffic.get("resize")
    sub = run.traffic["encode"]["subsampling"]
    dims = [((r["height"], r["width"]) if r else
             (run.specs[i].height, run.specs[i].width))
            for _t, idx in run.pulled for i in idx]
    ops, nbytes = work.transform_work(dims, sub)
    return work.roofline_pct(ops, nbytes, t["kernels_s"][KERNEL],
                             run.device_name)
