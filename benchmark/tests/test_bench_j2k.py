"""The J2K cell's own pieces on the CPU: faults that must make `correct`
false (a sample one LSB off, the lossy 9/7 decode of the same pixels), the
stage's roofline arithmetic, and the readers of its counters."""
import os
from types import SimpleNamespace

import numpy as np
import pytest

from benchmark import j2k_streams, run, work_j2k
from benchmark.tests.conftest import ROOT, bench_all, tiny

CELL = "j2k_lossless_1024"
SEED = 2 ** 31 + 4099


def run_tiny(seconds=2.0):
    return run.run_cell(CELL, SEED, seconds, False, device="cpu",
                        overrides=tiny(CELL), gen_workers=1,
                        bench=bench_all())


def test_one_sample_one_lsb_off_is_not_correct(monkeypatch):
    """Every decoded image leaves the device stage with its first sample's
    lowest bit flipped: each judged image is one sample outside."""
    from nvimagecodec_tpu_torch.codecs.jpeg2000 import core

    real = core._to_samples

    def altered(img, depth):
        out = real(img, depth).clone()
        out[0, 0, 0] ^= 1
        return out

    monkeypatch.setattr(core, "_to_samples", altered)
    result = run_tiny()
    assert result["correct"] is False
    judged = result["detail"]["judged"]
    assert judged > 0
    assert result["checks"]["samples_outside"]["value"] == judged
    assert result["checks"]["off_device"]["value"] == 0


def test_the_lossy_97_stream_of_the_same_pixels_is_not_correct(monkeypatch):
    """The entry given the irreversible 9/7 codestreams of the same pixels
    (the same settings otherwise): decoded, they are not the source."""
    def lossy(self, jpegs):
        return [j2k_streams.encode(j2k_streams.source_pixels(j),
                                   irreversible=True) for j in jpegs]

    monkeypatch.setattr(j2k_streams.Converter, "map", lossy)
    result = run_tiny()
    assert result["failed"] == 0
    assert result["correct"] is False
    assert result["checks"]["samples_outside"]["value"] > 0


def test_the_source_is_what_the_streams_decode_to():
    """The lossless codestream of a JPEG's pixels is the pixels: Pillow's
    own OpenJPEG decode of it gives them back."""
    import io

    from PIL import Image
    from benchmark import corpus

    _specs, streams = corpus.make_streams(
        dict(tiny(CELL)["corpus"], texture_std=50, noise_std=0,
             quality=[95], subsampling="444"), SEED, workers=1)
    px = j2k_streams.source_pixels(streams[0])
    data = j2k_streams.convert(streams[0])
    assert data[:4] == b"\xff\x4f\xff\x51"  # a raw codestream
    with Image.open(io.BytesIO(data)) as im:
        assert np.array_equal(np.asarray(im), px)


def test_stage_bytes_and_roofline():
    nbytes = work_j2k.stage_bytes([(1024, 1024)], 3)
    assert nbytes == 1024 * 1024 * 3 * 5
    card = "NVIDIA H100 80GB HBM3"
    least = nbytes / 3.35e12
    assert least * 1e3 == pytest.approx(0.0047, abs=5e-5)
    assert work_j2k.stage_roofline_pct([(1024, 1024)], 3, 2 * least,
                                       card) == pytest.approx(50.0)
    assert work_j2k.stage_roofline_pct([(1024, 1024)], 3, 0.0, card) is None


def reader(name):
    return run.load_file(os.path.join(ROOT, "benchmark", "metrics",
                                      f"{name}.py"), "m")


PULLED = [(0.0, [0, 1, 2]), (0.1, [3, 4, 5])]
K = "imgcodec.jpeg2k."


@pytest.mark.parametrize("name,key,scale", [
    ("j2k.t2_cpu_ms_per_image", K + "t2.cpu_s", 1e3),
    ("j2k.t1_cpu_ms_per_image", K + "t1.cpu_s", 1e3),
    ("j2k.device_stage_cpu_ms_per_image", K + "device_stage.cpu_s", 1e3),
    ("j2k.h2d_bytes_per_image", K + "h2d_bytes", 1.0)])
def test_counter_readers(name, key, scale):
    m = reader(name)
    r = SimpleNamespace(counters={key: 0.012}, pulled=PULLED)
    assert m.read(r) == pytest.approx(0.012 * scale / 6)
    # a program without the counter (the parent of the Tier spans): none
    assert m.read(SimpleNamespace(counters={}, pulled=PULLED)) is None
    assert m.read(SimpleNamespace(counters={key: 1.0}, pulled=[])) is None


def test_roofline_reader_sums_every_kernel():
    m = reader("j2k_pixel_stage_roofline")
    spec = SimpleNamespace(height=1024, width=1024)
    least = work_j2k.stage_bytes([(1024, 1024)] * 6, 3) / 3.35e12
    r = SimpleNamespace(
        device_trace={"kernels_s": {"a": least, "b": least}},
        specs=[spec] * 6, pulled=PULLED, device_name="NVIDIA H100 80GB HBM3")
    assert m.read(r) == pytest.approx(50.0)
    r.device_trace = None
    assert m.read(r) is None
    r.device_trace = {"kernels_s": {}}
    assert m.read(r) is None
