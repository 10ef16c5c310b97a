"""The J2K decode's spans and counters (`core/trace.py`) on the CPU: Tier-2
and Tier-1 spans under the host stage, the native Tier-1 workers' CPU time
charged to the Tier-1 span, the sample pool's spans under the plugin's,
the code-block, native-row and codestream-byte counters, and nothing
counted or measured while collection is off."""
import numpy as np
import pytest
import torch

pytest.importorskip("PIL")
from PIL import features  # noqa: E402

if not features.check("jpg_2000"):
    pytest.skip("Pillow has no JPEG 2000 (OpenJPEG)", allow_module_level=True)

import nvimagecodec_tpu_torch as port  # noqa: E402
from benchmark import j2k_streams  # noqa: E402
from benchmark.reference import j2k as ref  # noqa: E402
from nvimagecodec_tpu_torch.codecs.jpeg2000 import core  # noqa: E402
from nvimagecodec_tpu_torch.core import trace  # noqa: E402
from nvimagecodec_tpu_torch.ops import j2k_t1  # noqa: E402
from util import make_photo  # noqa: E402

CPU = torch.device("cpu")
HOST = "imgcodec.jpeg2k.host_stage"
T1, T2 = "imgcodec.jpeg2k.t1", "imgcodec.jpeg2k.t2"
CBLK = 64


def _stream(h=256, w=256, seed=3):
    img = make_photo(h, w, seed=seed).astype(np.int16)
    noise = np.random.default_rng(seed).integers(-12, 13, img.shape)
    px = np.clip(img + noise, 0, 255).astype(np.uint8)
    return px, j2k_streams.encode(px)


def _collected(fn):
    trace.start_collect()
    try:
        fn()
    finally:
        got = trace.stop_collect()
    return got


def _blocks_with_coefficients(px) -> int:
    """Code-blocks the lossless stream of px carries: those of the 64x64
    grid of every subband (anchored at 0, no precincts) with a nonzero
    coefficient, counted on the reference's transform."""
    LL, bands = ref.analyse_image(px, j2k_streams.LEVELS)
    n = 0
    for band in [LL] + [b for t in bands for b in t]:
        for comp in band:
            h, w = comp.shape
            for y in range(0, h, CBLK):
                for x in range(0, w, CBLK):
                    n += bool(comp[y:y + CBLK, x:x + CBLK].any())
    return n


def test_tier_spans_nest_under_the_host_stage():
    px, data = _stream()
    got = _collected(lambda: core.decode_j2k(data, device=CPU))
    ev = {e["name"]: e for e in got["events"]}
    for name in (T1, T2):
        assert ev[name]["parent"] == ev[HOST]["id"]
        assert ev[name]["batch"] == ev[HOST]["batch"]
    # Tier-2 reads the packets before Tier-1 decodes their blocks
    assert ev[T2]["end_ns"] <= ev[T1]["start_ns"]
    assert {T1 + ".cpu_s", T2 + ".cpu_s"} <= set(got["counters"])


def test_sample_pool_spans_are_the_plugins_children():
    """A batch of three goes over the plugin's sample pool: each sample's
    host stage is a child of the plugin's span, in its batch, and its CPU
    is in the plugin span's total."""
    streams = [_stream(96, 80, seed=s)[1] for s in range(3)]
    dec = port.Decoder(device="cpu")
    got = _collected(lambda: dec.decode(streams))
    ev = {}
    for e in got["events"]:
        ev.setdefault(e["name"], []).append(e)
    plugin = ev["imgcodec.decode.cuda_jpeg2k_hybrid_decoder"]
    assert len(plugin) == 1 and len(ev[HOST]) == 3
    for e in ev[HOST]:
        assert e["parent"] == plugin[0]["id"]
        assert e["batch"] == plugin[0]["batch"]
    c = got["counters"]
    assert c["imgcodec.decode.cuda_jpeg2k_hybrid_decoder.cpu_s"] >= \
        c[HOST + ".cpu_s"] > 0


def test_codeblock_and_byte_counters_are_what_the_streams_hold():
    pairs = [_stream(96, 80, seed=1), _stream(256, 256, seed=2)]

    def run():
        for _px, data in pairs:
            core.decode_j2k(data, device=CPU)

    c = _collected(run)["counters"]
    assert c["imgcodec.jpeg2k.stream_bytes"] == sum(len(d) for _p, d in pairs)
    assert c["imgcodec.jpeg2k.codeblocks"] == sum(
        _blocks_with_coefficients(px) for px, _d in pairs)


@pytest.mark.parametrize("route", ["card_table", "native_into",
                                   "native_blocks", "ht"])
def test_native_rows_counter_counts_the_blocks_of_the_native_pass(
        route, monkeypatch):
    """`imgcodec.jpeg2k.codeblocks_native_rows` counts the code-blocks
    whose row Tier-2's native pass wrote: on the table route every block
    sent to the card (`codeblocks_device`); on the host routes, the
    part-1 (5/3 and 9/7) and HT ones, every block decoded, none counted on
    a card: no route is left that builds a block's row in Python."""
    px, data = _stream(128, 96)
    if route == "native_blocks":
        data = core.encode_j2k(px, reversible=False, levels=3,
                               stream_type="j2k")
    elif route == "ht":
        data = core.encode_j2k(px, reversible=True, levels=3, ht=True,
                               stream_type="j2k")
    device = None
    if route == "card_table":
        real = core.tier1_on_device
        monkeypatch.setattr(core, "tier1_on_device", lambda device, *a: real(
            torch.device("cuda"), *a))
        device = CPU
    c = _collected(lambda: core.decode_j2k(data, device=device))["counters"]
    n = c["imgcodec.jpeg2k.codeblocks"]
    assert n > 0 and c["imgcodec.jpeg2k.codeblocks_native_rows"] == n
    assert c.get("imgcodec.jpeg2k.codeblocks_device", 0) == (
        n if route == "card_table" else 0)


def test_native_workers_cpu_is_charged_to_tier1():
    """On 4 native workers, Tier-1's CPU total exceeds what its own thread
    spent over the span: the workers' time is charged to it."""
    _px, data = _stream(512, 512)
    got = _collected(lambda: core.decode_j2k(data, num_threads=4,
                                             device=CPU))
    own = [e["cpu_ns"] for e in got["events"] if e["name"] == T1]
    assert len(own) == 1
    assert got["counters"][T1 + ".cpu_s"] > own[0] * 1e-9


def test_nothing_is_counted_or_measured_with_collection_off(monkeypatch):
    asked = []
    real = j2k_t1.decode_batch_into

    def spy(*args, **kw):
        asked.append(kw["count_cpu"])
        return real(*args, **kw)

    monkeypatch.setattr(j2k_t1, "decode_batch_into", spy)
    _px, data = _stream()
    core.decode_j2k(data, num_threads=4, device=CPU)
    # the native workers are given no clock to read
    assert asked and not any(asked)
    got = _collected(lambda: None)
    assert got["counters"] == {} and got["events"] == []
