"""The digital-cinema cell's own pieces on the CPU: the stream maker's
Profile-3 checks, faults that must make `correct` false (the control, and
the program's reconstruction before the mid-interval rule), the stage's
roofline arithmetic, the readers of its spans and counters; and on the
card one 2K frame within 1 of OpenJPEG."""
import os
from types import SimpleNamespace

import numpy as np
import pytest

from benchmark import dci_streams, run, work_j2k97
from benchmark.checks import j2k_dci_samples
from benchmark.photo import textured_photo
from benchmark.tests.conftest import ROOT, bench_all, tiny

CELL = "j2k_dci2k_24"
SEED = 2 ** 31 + 2111


def run_tiny(seconds=2.0):
    return run.run_cell(CELL, SEED, seconds, False, device="cpu",
                        overrides=tiny(CELL), gen_workers=1,
                        bench=bench_all())


def test_the_maker_writes_and_checks_profile3_streams():
    """One small frame: SIZ Rsiz 0x0003 and 12 bits, COD CPRL, 32x32, 9/7,
    ICT and the cinema precincts, three tile-parts, the caps scaled to
    its area; OpenJPEG's decode of it is near the frame. A cap below what
    OpenJPEG wrote, or a stream of other settings, is refused."""
    xyz = dci_streams.xyz12(textured_photo(64, 96, 3, 50, 0))
    assert xyz.dtype == np.uint16 and int(xyz.max()) < 4096
    data = dci_streams.encode(xyz)
    m = dci_streams.read_markers(data)
    assert m.rsiz == 0x0003 and m.size == (64, 96)
    assert m.depths == (12,) * 3 and m.signed == (False,) * 3
    assert (m.progression, m.layers, m.mct, m.levels) == (4, 1, 1, 5)
    assert (m.cblk, m.style, m.transform) == ((32, 32), 0, 0)
    assert m.precincts == ((7, 7),) + ((8, 8),) * 5
    assert len(m.tile_parts) == 3 and m.tlm
    cs, comp = dci_streams.caps(64, 96)
    assert sum(m.tile_parts) <= cs and max(m.tile_parts) <= comp
    back = dci_streams.opj_decode(data)
    assert back.shape == xyz.shape and back.dtype == np.uint16
    mse = np.mean((back.astype(float) - xyz) ** 2)
    assert 25 < 10 * np.log10(4095 ** 2 / mse) < 50  # rate-limited
    with pytest.raises(ValueError, match="bytes"):
        dci_streams.check(data, (64, 96), sum(m.tile_parts) - 1, comp)
    with pytest.raises(ValueError, match="size"):
        dci_streams.check(data, (64, 97), cs, comp)


def test_the_caps_are_dci_at_2k_and_scale_with_area():
    assert dci_streams.caps(1080, 2048) == (1302083, 1041666)
    assert dci_streams.caps(540, 1024) == (1302083 // 4, 1041666 // 4)


def test_a_tiny_run_is_correct_and_truncates():
    """At the tiny size the frames keep the 2K bits a sample, so every
    included block is cut above plane 0: the program is within 1 of
    OpenJPEG on every judged frame."""
    result = run_tiny()
    assert result["correct"] is True, result["checks"]
    assert result["detail"]["judged"] > 0


def test_the_reconstruction_before_the_midpoint_rule_is_not_correct(
        monkeypatch):
    """Every 9/7 coefficient at the middle of the finest bin,
    (|q| + 0.5) step, as the program reconstructed before: frames off by
    more than 1."""
    from nvimagecodec_tpu_torch.codecs.jpeg2000 import core

    monkeypatch.setattr(core, "_midpoint", lambda plan, c: False)
    result = run_tiny()
    assert result["failed"] == 0
    assert result["correct"] is False
    assert result["checks"]["samples_beyond_one"]["value"] > 0
    assert result["checks"]["off_device"]["value"] == 0


def test_the_control_is_far_beyond_one():
    """The reference's synthesis in bfloat16 of the float64 analysis of
    OpenJPEG's frames misses most samples by more than 1."""
    from benchmark import corpus

    params = dict(tiny(CELL)["corpus"], photo_size=[120, 160],
                  geometry=[[120, 160, 1.0]], quality=[95],
                  subsampling="444", texture_std=50, noise_std=0)
    _specs, streams = corpus.make_streams(params, SEED, workers=1)
    got = [(k, j2k_dci_samples.control_output(streams, k, {}))
           for k in (0, 1)]
    numbers = j2k_dci_samples.judge(got, streams, {})
    assert numbers["samples_beyond_one"] > 0.1 * 2 * 120 * 160 * 3
    assert numbers["off_device"] == 0


def test_stage_bytes_and_roofline():
    nbytes = work_j2k97.stage_bytes([(1080, 2048)], 3)
    assert nbytes == 1080 * 2048 * 3 * 6
    card = "NVIDIA H100 80GB HBM3"
    least = nbytes / 3.35e12
    assert work_j2k97.stage_roofline_pct([(1080, 2048)], 3, 4 * least,
                                         card) == pytest.approx(25.0)
    assert work_j2k97.stage_roofline_pct([(1080, 2048)], 3, 0.0,
                                         card) is None


def reader(name):
    return run.load_file(os.path.join(ROOT, "benchmark", "metrics",
                                      f"{name}.py"), "m")


PULLED = [(0.0, [0, 1, 2]), (0.1, [3, 4, 5])]
K = "imgcodec.jpeg2k."


def test_t1_host_reader():
    m = reader("j2k.t1_host_cpu_ms_per_image")
    r = SimpleNamespace(counters={K + "t1_host.cpu_s": 2.4}, pulled=PULLED)
    assert m.read(r) == pytest.approx(400.0)
    # the parent has no such span: none
    assert m.read(SimpleNamespace(counters={K + "t1.cpu_s": 2.4},
                                  pulled=PULLED)) is None
    assert m.read(SimpleNamespace(counters={K + "t1_host.cpu_s": 1.0},
                                  pulled=[])) is None


def test_dequantize_reader():
    m = reader("j2k.dequantize_ms_per_image")
    r = SimpleNamespace(spans={K + "dequantize": 0.003}, pulled=PULLED)
    assert m.read(r) == pytest.approx(0.5)
    assert m.read(SimpleNamespace(spans={}, pulled=PULLED)) is None


def test_truncated_share_reader():
    m = reader("j2k.truncated_block_share")
    r = SimpleNamespace(counters={K + "codeblocks_truncated": 30,
                                  K + "codeblocks": 40})
    assert m.read(r) == pytest.approx(75.0)
    assert m.read(SimpleNamespace(counters={K + "codeblocks": 40})) is None
    assert m.read(SimpleNamespace(counters={
        K + "codeblocks_truncated": 0, K + "codeblocks": 0})) is None


def test_roofline_reader_sums_every_kernel():
    m = reader("j2k97_pixel_stage_roofline")
    spec = SimpleNamespace(height=1080, width=2048)
    least = work_j2k97.stage_bytes([(1080, 2048)] * 6, 3) / 3.35e12
    r = SimpleNamespace(
        device_trace={"kernels_s": {"a": least, "b": least}},
        specs=[spec] * 6, pulled=PULLED, device_name="NVIDIA H100 80GB HBM3")
    assert m.read(r) == pytest.approx(50.0)
    r.device_trace = None
    assert m.read(r) is None


@pytest.mark.gpu
def test_a_2k_frame_on_the_card_is_within_one_of_openjpeg(cuda):
    """A full 2048x1080 frame of the maker through `Decoder(device="cuda")`
    with `allow_any_depth`: a CUDA uint16 [1080, 2048, 3] tensor within 1
    of libopenjp2's decode, on the device route."""
    import nvimagecodec_tpu_torch as nic
    from nvimagecodec_tpu_torch.codecs.jpeg2000 import core

    xyz = dci_streams.xyz12(textured_photo(1080, 2048, 21, 50, 0))
    data = dci_streams.encode(xyz)
    want = dci_streams.opj_decode(data)
    before = core.ROUTES["device"]
    dec = nic.Decoder(device=cuda, options="cuda_jpeg2k_hybrid_decoder:"
                                           "device_pixel_stage=true")
    out = dec.decode(data, params=nic.DecodeParams(allow_any_depth=True))
    a = out.array
    assert a.device.type == "cuda" and tuple(a.shape) == (1080, 2048, 3)
    got = a.cpu().numpy()
    assert got.dtype == np.uint16
    assert np.abs(got.astype(int) - want).max() <= 1
    assert core.ROUTES["device"] == before + 1
