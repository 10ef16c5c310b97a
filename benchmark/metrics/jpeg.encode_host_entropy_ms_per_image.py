"""jpeg.encode_host_entropy_ms_per_image: span
imgcodec.jpeg.encode_host_entropy (the encode's host Huffman coding),
summed over the threads that ran it (thread time, with waits for the
interpreter lock inside), over the images encoded in the traced window."""
UNIT = "ms/image"
SOURCE = "program_span"
SPAN = "imgcodec.jpeg.encode_host_entropy"


def read(run):
    n = sum(run.encode_routes.values())
    if SPAN not in run.spans or not n:
        return None
    return run.spans[SPAN] * 1e3 / n
