"""jpeg.encode_host_entropy_cpu_ms_per_image: counter
imgcodec.jpeg.encode_host_entropy.cpu_s (CPU time of the encode's host
Huffman coding: the calling thread's over the span, plus what the encode
pool's threads spend in each sample's task) over the images encoded in the
traced window."""
UNIT = "ms/image"
SOURCE = "program_span"
COUNTER = "imgcodec.jpeg.encode_host_entropy.cpu_s"


def read(run):
    n = sum(run.encode_routes.values())
    if COUNTER not in run.counters or not n:
        return None
    return run.counters[COUNTER] * 1e3 / n
