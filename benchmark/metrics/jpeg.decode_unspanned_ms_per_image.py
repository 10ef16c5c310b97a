"""jpeg.decode_unspanned_ms_per_image: counter
imgcodec.decode.cuda_jpeg_hybrid_decoder.self_s (the JPEG decoder plugin's
wall time outside its child spans on its own thread: bucketing, results,
flag checks) over the images pulled in the traced window: what of the
decode no layer span covers."""
UNIT = "ms/image"
SOURCE = "program_span"
COUNTER = "imgcodec.decode.cuda_jpeg_hybrid_decoder.self_s"


def read(run):
    n = sum(len(idx) for _t, idx in run.pulled)
    if COUNTER not in run.counters or not n:
        return None
    return run.counters[COUNTER] * 1e3 / n
