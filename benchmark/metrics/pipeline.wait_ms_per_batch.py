"""pipeline.wait_ms_per_batch: span imgcodec.pipeline.device_wait (the
consumer's wait for a batch's device work, pipeline.decode_batches) summed
over the traced window, over the batches pulled in it."""
UNIT = "ms"
SOURCE = "program_span"
SPAN = "imgcodec.pipeline.device_wait"


def read(run):
    if SPAN not in run.spans or not run.pulled:
        return None
    return run.spans[SPAN] * 1e3 / len(run.pulled)
