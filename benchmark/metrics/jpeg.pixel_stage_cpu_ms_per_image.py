"""jpeg.pixel_stage_cpu_ms_per_image: counter imgcodec.jpeg.pixel_stage.cpu_s
(CPU time of the threads that ran span imgcodec.jpeg.pixel_stage, over it)
over the images pulled in the traced window. Beside
jpeg.pixel_stage_ms_per_image it tells the stage's work from its waits."""
UNIT = "ms/image"
SOURCE = "program_span"
COUNTER = "imgcodec.jpeg.pixel_stage.cpu_s"


def read(run):
    n = sum(len(idx) for _t, idx in run.pulled)
    if COUNTER not in run.counters or not n:
        return None
    return run.counters[COUNTER] * 1e3 / n
