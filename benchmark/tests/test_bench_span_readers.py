"""The readers of the program's CPU and self-time counters and of the pixel
stage's span: the value from a made-up run, and no value where the program
has no such counter or span (a program that predates them)."""
import os
from types import SimpleNamespace

import pytest

from benchmark import run
from benchmark.tests.conftest import ROOT

# 2 batches pulled, 6 images; 4 images encoded
PULLED = [(0.0, [0, 1, 2]), (0.1, [3, 4, 5])]
ENCODED = {"device": 3, "host": 1, "progressive": 0}
P = "imgcodec.jpeg."

CASES = [
    ("jpeg.parse_cpu_ms_per_image", "counters", P + "parse.cpu_s", 6),
    ("jpeg.host_entropy_cpu_ms_per_image", "counters",
     P + "host_entropy.cpu_s", 6),
    ("jpeg.pixel_stage_ms_per_image", "spans", P + "pixel_stage", 6),
    ("jpeg.pixel_stage_cpu_ms_per_image", "counters",
     P + "pixel_stage.cpu_s", 6),
    ("jpeg.decode_unspanned_ms_per_image", "counters",
     "imgcodec.decode.cuda_jpeg_hybrid_decoder.self_s", 6),
    ("jpeg.encode_device_stage_cpu_ms_per_image", "counters",
     P + "encode_device_stage.cpu_s", 4),
    ("jpeg.encode_host_entropy_cpu_ms_per_image", "counters",
     P + "encode_host_entropy.cpu_s", 4),
]


def reader(name):
    return run.load_file(os.path.join(ROOT, "benchmark", "metrics",
                                      f"{name}.py"), "m")


def fake_run(where=None, key=None, value=None):
    r = SimpleNamespace(spans={P + "parse": 9.0}, counters={
        P + "h2d_bytes": 5.0, P + "parse.self_s": 7.0},
        pulled=PULLED, encode_routes=dict(ENCODED))
    if where is not None:
        getattr(r, where)[key] = value
    return r


@pytest.mark.parametrize("name,where,key,images", CASES,
                         ids=[c[0] for c in CASES])
def test_reader_value_and_absence(name, where, key, images):
    m = reader(name)
    assert m.read(fake_run(where, key, 0.012)) == pytest.approx(
        12.0 / images)
    # the program without the counter or span: no number, no raise
    assert m.read(fake_run()) is None
    # nothing pulled or encoded in the window: no number
    empty = fake_run(where, key, 0.012)
    empty.pulled, empty.encode_routes = [], {"device": 0}
    assert m.read(empty) is None
