"""jpeg.host_entropy_ms_per_image: span imgcodec.jpeg.host_entropy (the native
host entropy decode of the host route), summed over the threads that ran it
(thread time, with waits for the interpreter lock inside), over the images
pulled in the traced window."""
UNIT = "ms/image"
SOURCE = "program_span"
SPAN = "imgcodec.jpeg.host_entropy"


def read(run):
    n = sum(len(idx) for _t, idx in run.pulled)
    if SPAN not in run.spans or not n:
        return None
    return run.spans[SPAN] * 1e3 / n
