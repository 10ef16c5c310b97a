"""The port's JPEG 2000 decode of codestreams another encoder wrote: OpenJPEG
through Pillow, lossless with `opj_compress`'s defaults (5/3, RCT, 5
levels, 64x64 code-blocks, LRCP), the streams of the benchmark's
`j2k_lossless_1024` cell. Held on the CPU against the benchmark's plain
reference (benchmark/reference/j2k.py: 5/3 lifting, RCT and level shift
from T.800's formulas) and against the source pixels, a lossless decode's
exact answer."""
import threading
import time

import numpy as np
import pytest
import torch

PIL = pytest.importorskip("PIL")
from PIL import features  # noqa: E402

if not features.check("jpg_2000"):
    pytest.skip("Pillow has no JPEG 2000 (OpenJPEG)", allow_module_level=True)

import nvimagecodec_tpu_torch as port  # noqa: E402
from benchmark import j2k_streams  # noqa: E402
from benchmark.reference import j2k as ref  # noqa: E402
from nvimagecodec_tpu_torch.codecs.jpeg2000 import core  # noqa: E402
from nvimagecodec_tpu_torch.pipeline import decode_batches  # noqa: E402
from util import make_photo  # noqa: E402

FORCED = "cuda_jpeg2k_hybrid_decoder:device_pixel_stage=true"


def _pixels(h, w, channels, seed):
    """Seeded photo-like pixels with noise, [h, w] or [h, w, 3] uint8."""
    img = make_photo(h, w, seed=seed, channels=channels).astype(np.int16)
    noise = np.random.default_rng(seed).integers(-12, 13, img.shape)
    return np.clip(img + noise, 0, 255).astype(np.uint8)


def _equal_subbands(got, want):
    (gLL, gb), (wLL, wb) = got, want
    assert len(gb) == len(wb)
    assert torch.equal(gLL, wLL)
    for g, w in zip(gb, wb):
        for u, v in zip(g, w):
            assert torch.equal(u, v)


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("levels", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("h,w", [(64, 48), (33, 47)])
def test_device_stage_on_reference_subbands_gives_the_source(h, w, levels,
                                                             channels):
    """The port's pixel stage (inverse 5/3, inverse RCT, level shift; torch
    ops on device "cpu") on the reference's forward transform of the
    pixels gives the pixels back."""
    px = _pixels(h, w, channels, seed=h * 10 + levels)
    LL, bands = ref.analyse_image(px, levels)
    out = core.device_pixels(LL, bands, (h, w), True, channels == 3, 8)
    got = out.permute(1, 2, 0).numpy()
    want = px[..., None] if px.ndim == 2 else px
    assert got.dtype == np.int32 and np.array_equal(got, want)


STREAMS = {"96x80": (96, 80, 3), "96x80_gray": (96, 80, 1),
           "256x256": (256, 256, 3)}


def _stream(name, seed=5):
    h, w, c = STREAMS[name]
    px = _pixels(h, w, c, seed)
    return px, j2k_streams.encode(px)


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_tier1_subbands_equal_the_reference_transform(name):
    """Tier-2 and Tier-1 of an OpenJPEG stream (the subbands the host stages
    leave in the upload buffer) equal the reference's level shift, RCT and
    5-level 5/3 analysis of the source, coefficient for coefficient."""
    px, data = _stream(name)
    job = core._decode_host_stages(data, 0, torch.device("cpu"), 0, None,
                                   False)
    assert isinstance(job, core._DeviceJob)
    assert job.cp.reversible and job.cp.levels == j2k_streams.LEVELS
    assert job.cp.mct == (px.ndim == 3)
    _equal_subbands(job.stage.host_tensors(),
                    ref.analyse_image(px, j2k_streams.LEVELS))


@pytest.mark.parametrize("site", ["card_table", "native_into",
                                  "native_blocks"])
def test_tier1_sites_agree(site, monkeypatch):
    """Each Tier-1 site, forced on the device route of the same OpenJPEG
    stream, leaves the same subbands: the reference's analysis of the
    source (the card's table decoded on the CPU by its plain version)."""
    px, data = _stream("96x80")
    real = core.plan_stream
    monkeypatch.setattr(core, "plan_stream", lambda *a, **k: real(
        *a, **k)._replace(tier1=site))
    job = core._decode_host_stages(data, 0, torch.device("cpu"), 0, None,
                                   False)
    # the card's table goes through its plain version on the CPU
    assert (job.stage.t1 is not None) == (site == "card_table")
    _equal_subbands(job.stage.upload(torch.device("cpu")),
                    ref.analyse_image(px, j2k_streams.LEVELS))


@pytest.mark.parametrize("options", ["", FORCED])
def test_decoder_through_two_batches_in_flight_gives_the_source(options):
    """`Decoder(device="cpu")` under `decode_batches(depth=2)`, batches of
    three streams: every image is the source, in order; with the pixel
    stage forced, every one took the device route."""
    pairs = [_stream(n, seed=s) for s, n in enumerate(
        ["96x80", "96x80_gray", "256x256", "96x80", "256x256", "96x80"])]
    batches = [[d for _p, d in pairs[i:i + 3]] for i in (0, 3, 0)]
    want = [[p for p, _d in pairs[i:i + 3]] for i in (0, 3, 0)]
    before = dict(core.ROUTES)
    dec = port.Decoder(device="cpu", options=options)
    got = list(decode_batches(batches, decoder=dec, drop_failed=False,
                              depth=2))
    assert len(got) == len(batches)
    for outs, pixels in zip(got, want):
        for o, px in zip(outs, pixels):
            assert o is not None
            assert np.array_equal(o.array.numpy(), px)
    routes = {k: core.ROUTES[k] - before[k] for k in before}
    if options:
        assert routes == {"device": 9, "device_tiles": 0, "host": 0}


def test_batches_in_flight_share_one_sample_pool(monkeypatch):
    """Two batches in flight decode their samples on the plugin's one pool
    (a thread a core): never more samples at once than cores, every sample
    on a pool thread, and every image still the source."""
    from nvimagecodec_tpu_torch.codecs import jpeg2000 as plugin

    monkeypatch.setattr(plugin.os, "cpu_count", lambda: 2)
    monkeypatch.setattr(plugin, "_SAMPLE_POOL", [None])
    real = plugin.decode_j2k
    lock = threading.Lock()
    state = {"now": 0, "most": 0, "threads": set()}

    def spy(*a, **k):
        with lock:
            state["now"] += 1
            state["most"] = max(state["most"], state["now"])
            state["threads"].add(threading.current_thread().name)
        try:
            time.sleep(0.02)  # let the other batch's samples arrive
            return real(*a, **k)
        finally:
            with lock:
                state["now"] -= 1

    monkeypatch.setattr(plugin, "decode_j2k", spy)
    pairs = [_stream("96x80", seed=s) for s in range(4)]
    batches = [[d for _p, d in pairs]] * 3
    dec = port.Decoder(device="cpu", options=FORCED)
    try:
        got = list(decode_batches(batches, decoder=dec, drop_failed=False,
                                  depth=2))
    finally:
        plugin._SAMPLE_POOL[0].shutdown()
    assert state["most"] == 2
    assert all(n.startswith("j2k-sample") for n in state["threads"])
    for outs in got:
        assert [np.array_equal(o.array.numpy(), p)
                for o, (p, _d) in zip(outs, pairs)] == [True] * 4


class _CountingLock:
    def __init__(self):
        self.lock = threading.Lock()
        self.taken = 0

    def __enter__(self):
        self.lock.acquire()
        self.taken += 1
        return self

    def __exit__(self, *exc):
        self.lock.release()
        return False


def test_device_stage_launches_under_the_lock_on_cuda_only(monkeypatch):
    """The device stage takes the launch lock for a CUDA device, and lets
    it go when the stage fails (here the upload to a CUDA device that a
    CPU build lacks, or that a card refuses); on the CPU it runs without
    it."""
    lock = _CountingLock()
    monkeypatch.setattr(core, "_LAUNCH_LOCK", lock)
    px, data = _stream("96x80")
    job = core._decode_host_stages(data, 0, torch.device("cpu"), 0, None,
                                   False)
    out = core._run_device_stage(job)
    assert np.array_equal(out.numpy(), px) and lock.taken == 0

    def refused(self, device):
        raise RuntimeError("no such device")

    monkeypatch.setattr(core._SubbandStage, "upload", refused)
    with pytest.raises(core.J2kDeviceStageError, match="no such device"):
        core._run_device_stage(job._replace(device=torch.device("cuda", 0)))
    assert lock.taken == 1 and not lock.lock.locked()
