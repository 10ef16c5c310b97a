"""images_per_s: images completed in the window over its length. An image
is completed when its batch has been yielded with its pixels complete
(decode) or its output bytes are in hand (transcode); source: host clock."""
UNIT = "images/s"
SOURCE = "host_clock"


def read(run):
    return run.images / run.seconds if run.images else None
