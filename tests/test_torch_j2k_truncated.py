"""Rate-limited irreversible JPEG 2000: code-blocks whose included coding
passes end above bit-plane 0, as every 9/7 stream cut to a byte budget has
them. Each coefficient is reconstructed at the middle of the interval its
decoded bit-planes leave (T.800 E.1.1.2, r = 1/2): the native decoder
writes it with one fractional bit (native/j2k_t1.cpp, kMidpoint), and the
pixel stage multiplies by half the quantiser step.

Held on the CPU against OpenJPEG (Pillow's, and the digital-cinema maker's
own libopenjp2 decode at 12 bits), against the benchmark's plain 9/7
reference (benchmark/reference/j2k97.py), and against the coefficients a
truncated block was coded from."""
import io

import numpy as np
import pytest
import torch

PIL = pytest.importorskip("PIL")
from PIL import Image, features  # noqa: E402

if not features.check("jpg_2000"):
    pytest.skip("Pillow has no JPEG 2000 (OpenJPEG)", allow_module_level=True)

import nvimagecodec_tpu_torch as port  # noqa: E402
from benchmark import dci_streams, j2k_streams  # noqa: E402
from benchmark.photo import textured_photo  # noqa: E402
from benchmark.reference import j2k97  # noqa: E402
from nvimagecodec_tpu_torch.codecs.jpeg2000 import core, t1_bridge  # noqa: E402
from nvimagecodec_tpu_torch.core import trace  # noqa: E402
from nvimagecodec_tpu_torch.ops import j2k_t1  # noqa: E402
from nvimagecodec_tpu_torch.pipeline import decode_batches  # noqa: E402

CPU = torch.device("cpu")
FORCED = "cuda_jpeg2k_hybrid_decoder:device_pixel_stage=true"
ROUTES = {"host": None, "device_cpu": CPU}


def _psnr(a, b, peak):
    err = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10 * np.log10(peak * peak / err)


def _decode(data, route):
    img = core.decode_j2k(data, device=ROUTES[route])
    return img.numpy() if isinstance(img, torch.Tensor) else img


# ---------------------------------------- 8-bit streams cut by Pillow
PILLOW = {
    "lrcp_64": dict(quality_layers=[24]),
    "cprl_32_precincts": dict(quality_layers=[16], codeblock_size=(32, 32),
                              progression="CPRL", precinct_size=(64, 64)),
    "two_layers": dict(quality_layers=[40, 12]),
    "gray": dict(quality_layers=[20]),
}


def _pillow_stream(name):
    px = textured_photo(112, 144, 11, 50, 0)
    if name == "gray":
        px = px[:, :, 0]
    out = io.BytesIO()
    Image.fromarray(px).save(out, format="JPEG2000", irreversible=True,
                             quality_mode="rates", no_jp2=True,
                             **PILLOW[name])
    data = out.getvalue()
    with Image.open(io.BytesIO(data)) as im:
        return px, data, np.asarray(im)


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("name", sorted(PILLOW))
def test_rate_limited_97_streams_decode_as_openjpeg(name, route):
    """Pillow's OpenJPEG cuts the 9/7 streams to its rates, so blocks end
    above plane 0; the port's decode is within 1 of OpenJPEG's on both
    pixel routes, at OpenJPEG's PSNR to the source within 0.01 dB."""
    px, data, want = _pillow_stream(name)
    c = _collected(lambda: _decode(data, route))
    got = c.pop("image")
    assert c["imgcodec.jpeg2k.codeblocks_truncated"] > 0
    assert got.shape == want.shape and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want).max() <= 1
    assert abs(_psnr(got, px, 255) - _psnr(want, px, 255)) <= 0.01


# ------------------------------ 12-bit streams of the digital-cinema maker
CINEMA = {"135x256": (135, 256, 3), "96x160": (96, 160, 5)}


def _cinema_stream(name):
    h, w, seed = CINEMA[name]
    xyz = dci_streams.xyz12(textured_photo(h, w, seed, 50, 0))
    data = dci_streams.encode(xyz)  # checked: Profile-3 markers, caps
    return xyz, data, dci_streams.opj_decode(data)


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("name", sorted(CINEMA))
def test_cinema_streams_decode_as_openjpeg_at_12_bits(name, route):
    """Profile-3 12-bit X'Y'Z' streams at the 2K cap's bits a sample:
    within 1 of libopenjp2's own decode, uint16, at its PSNR within 0.01
    dB; their blocks are truncated."""
    xyz, data, want = _cinema_stream(name)
    c = _collected(lambda: _decode(data, route))
    got = c.pop("image")
    assert c["imgcodec.jpeg2k.codeblocks_truncated"] > 0
    assert got.shape == want.shape and got.dtype == np.uint16
    assert np.abs(got.astype(int) - want).max() <= 1
    assert abs(_psnr(got, xyz, 4095) - _psnr(want, xyz, 4095)) <= 0.01


def test_cinema_frames_through_the_decoder_and_two_batches_in_flight():
    """`Decoder(device="cpu")` with the device stage forced, under
    `decode_batches(DecodeParams(allow_any_depth=True), depth=2)`: every
    frame uint16 X'Y'Z' [H, W, 3] within 1 of OpenJPEG, on the device
    route."""
    streams = [_cinema_stream(n) for n in sorted(CINEMA)]
    before = dict(core.ROUTES)
    dec = port.Decoder(device="cpu", options=FORCED)
    got = list(decode_batches([[d for _x, d, _w in streams]] * 2,
                              port.DecodeParams(allow_any_depth=True),
                              decoder=dec, drop_failed=False, depth=2))
    for outs in got:
        for o, (_x, _d, want) in zip(outs, streams):
            a = o.array.numpy()
            assert a.dtype == np.uint16 and a.shape == want.shape
            assert np.abs(a.astype(int) - want).max() <= 1
    assert core.ROUTES["device"] - before["device"] == 4


def test_the_markers_the_maker_checks():
    """A small stream of the maker carries what the cell states: Rsiz
    0x0003, 12 bits, CPRL, 32x32, 9/7 and ICT, the cinema precincts,
    three tile-parts within the scaled caps; a stream of other settings
    (Pillow's lossless one) is refused."""
    _x, data, _w = _cinema_stream("96x160")
    m = dci_streams.read_markers(data)
    cs, comp = dci_streams.caps(96, 160)
    assert (m.rsiz, m.depths, m.progression, m.cblk, m.transform, m.mct) \
        == (3, (12, 12, 12), 4, (32, 32), 0, 1)
    assert m.precincts == ((7, 7),) + ((8, 8),) * 5
    assert len(m.tile_parts) == 3 and sum(m.tile_parts) <= cs
    assert max(m.tile_parts) <= comp
    other = j2k_streams.encode(textured_photo(96, 160, 1, 50, 0))
    with pytest.raises(ValueError, match="Profile-3"):
        dci_streams.check(other, (96, 160), cs, comp)


# --------------------------- the stage against the plain 9/7 reference
def test_dequantisation_and_97_stage_equal_the_reference():
    """Seeded quantised subbands (the reference's analysis of a 12-bit
    frame, a seeded step a band) and seeded counts of bit-planes left
    undecoded a coefficient: the half-steps the native decoder writes,
    dequantised and synthesised by the port's device stage (device "cpu",
    float32), equal the reference's T.800 E-6 dequantisation, 9/7
    synthesis and inverse ICT in float64, to float32's rounding:
    coefficients within 2^-22 relative, samples within 1 and equal but
    for rounding ties."""
    rng = np.random.default_rng(7)
    h, w, levels, depth = 72, 88, 4, 12
    xyz = dci_streams.xyz12(textured_photo(h, w, 9, 50, 0))
    LL0, bands0 = j2k97.analyse_image(xyz, levels, depth)
    shapes = _band_shapes(h, w, levels)
    coefs = [LL0] + [b for t in bands0 for b in t]
    deq, leaves, steps = [], [], []
    for c, (bh, bw) in zip(coefs, shapes):
        assert c.shape == (3, bh, bw)
        step = float(rng.uniform(0.5, 8.0))
        left = rng.integers(0, 5, (3, bh, bw))
        mag = (np.floor(np.abs(c.numpy()) / step).astype(np.int64)
               >> left << left)
        q = np.where(c.numpy() < 0, -mag, mag)
        v2 = np.where(q == 0, 0, np.sign(q) * (2 * mag + (1 << left)))
        leaves.append(v2.astype(np.int32))
        steps.append(step / 2)
        deq.append(j2k97.dequantize(torch.from_numpy(q),
                                    torch.from_numpy(left), step))
    LLs = deq[0]
    bands_ref = [deq[1 + 3 * k:4 + 3 * k] for k in range(levels)]
    stage = core._SubbandStage((3,), shapes, CPU, None, steps)
    for leaf, v in zip(stage.leaves, leaves):
        leaf[...] = v
    LL, bands = stage.upload(CPU)
    assert LL.dtype == torch.float32
    np.testing.assert_allclose(LL.double().numpy(), LLs.numpy(),
                               rtol=2 ** -22)
    for got, want in zip(bands, bands_ref):
        for g, v in zip(got, want):
            np.testing.assert_allclose(g.double().numpy(), v.numpy(),
                                       rtol=2 ** -22)
    out = core.device_pixels(LL, bands, (h, w), False, True, depth)
    got = out.permute(1, 2, 0).numpy()
    want = j2k97.synthesise_image(LLs, [tuple(b) for b in bands_ref], depth)
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3


def _band_shapes(h, w, levels):
    """The stage's leaf shapes of an [h, w] image: LL, then (HL, LH, HH)
    finest first."""
    from nvimagecodec_tpu_torch.ops.dwt import subband_dims

    dims = subband_dims(h, w, levels)
    shapes = [dims[levels]]
    for s in range(levels):
        (ph, pw), (lh, lw) = dims[s], dims[s + 1]
        shapes += [(lh, pw - lw), (ph - lh, lw), (ph - lh, pw - lw)]
    return shapes


# ----------------------- the native decoder's half-steps, block by block
@pytest.mark.parametrize("style", [0, 0x01 | 0x04, 0x02 | 0x08 | 0x20])
def test_every_truncation_point_reconstructs_mid_interval(style):
    """A seeded block coded by the port's own Tier-1 encoder, decoded after
    every number of its passes under the mid-interval style: each nonzero
    value v is 2|q| + 2^L for the interval [|q|, |q| + 2^L) of its decoded
    planes, which holds the coded coefficient c, with the sign of c, and
    L the plane of the last pass (one higher for a coefficient a last
    significance pass did not reach); a zero stays below the last plane's
    reach. All passes give 2|c| + 1."""
    rng = np.random.default_rng(style + 3)
    coef = (rng.laplace(0, 40, (32, 32))).astype(np.int32)
    coef[rng.random((32, 32)) < 0.3] = 0
    batch = t1_bridge.EncodeBatch(False)
    batch.add(0, coef, 1, style=style)
    (_k, res), = list(batch.run(1))
    seg, nbps, npasses = res[0], res[1], res[2]
    if style & 0x05:
        ends = res[3]
        lens = np.diff([0] + ends).astype(np.int32)
        seg = (np.int32(len(ends)).tobytes() + lens.tobytes() + seg)
    for k in range(1, npasses + 1):
        v = _decode_block(seg, nbps, k, style | core._MIDPOINT)
        last = k - 1
        plane = nbps - 1 if last == 0 else nbps - 2 - (last - 1) // 3
        mag, c = np.abs(v.astype(np.int64)), np.abs(coef.astype(np.int64))
        nz = mag > 0
        assert np.array_equal(np.sign(v[nz]), np.sign(coef[nz]))
        low = mag & -mag  # 2^L
        assert np.all(mag[nz] - low[nz] <= 2 * c[nz])
        assert np.all(2 * c[nz] < mag[nz] + low[nz])
        spp = last > 0 and (last - 1) % 3 == 0
        allowed = {1 << plane, 1 << (plane + 1)} if spp else {1 << plane}
        assert set(np.unique(low[nz]).tolist()) <= allowed
        assert np.all(c[~nz] < (1 << (plane + (2 if spp else 1))))
    full = _decode_block(seg, nbps, npasses, style | core._MIDPOINT)
    want = np.where(coef == 0, 0, np.sign(coef) * (2 * np.abs(coef) + 1))
    assert np.array_equal(full, want)


def _decode_block(seg, nbps, passes, style):
    out = np.zeros((32, 32), np.int32)
    j2k_t1.decode_batch_into(
        "T1", seg, [j2k_t1.t1_row(0, len(seg), 32, 32, 1, nbps, passes,
                                  style)], out.ctypes.data, [0], [32], 1)
    return out


# ------------------------------- the lossless path is left as it was
def test_lossless_rows_carry_no_midpoint_bit_and_are_unchanged(monkeypatch):
    """J's OpenJPEG lossless streams: the rows of the card's table are the
    same with the mid-interval bit's plumbing taken out, none carries it,
    and the decode is the source."""
    px = textured_photo(96, 128, 4, 50, 0)
    data = j2k_streams.encode(px)
    real = core.plan_stream
    monkeypatch.setattr(core, "plan_stream", lambda *a, **k: real(
        *a, **k)._replace(tier1="card_table"))
    now = _table_rows(data)
    monkeypatch.setattr(core, "_MIDPOINT", 0)
    before = _table_rows(data)
    assert np.array_equal(now, before)
    assert not ((now[:, 4] >> 8) & 0x80).any()
    monkeypatch.undo()
    assert np.array_equal(core.decode_j2k(data, device=None), px)


def _table_rows(data):
    job = core._decode_host_stages(data, 0, CPU, 0, None, False)
    return job.stage.t1.rows()


# ------------------------------------------------------------- tracing
def _collected(fn):
    trace.start_collect()
    try:
        img = fn()
    finally:
        got = trace.stop_collect()
    c = dict(got["counters"])
    c["spans"] = got["spans"]
    c["image"] = img
    return c


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_host_tier1_and_dequantisation_are_spanned_and_counted(route):
    """The host Tier-1's span carries its workers' CPU and sits inside
    Tier-1's; the dequantisation has its span on both routes; the passes
    decoded and the truncated blocks are counted from the rows."""
    _x, data, _w = _cinema_stream("135x256")
    c = _collected(lambda: core.decode_j2k(data, num_threads=4,
                                           device=ROUTES[route]))
    spans = c["spans"]
    assert "imgcodec.jpeg2k.t1_host" in spans
    assert "imgcodec.jpeg2k.dequantize" in spans
    assert 0 < c["imgcodec.jpeg2k.t1_host.cpu_s"] <= \
        c["imgcodec.jpeg2k.t1.cpu_s"]
    n = c["imgcodec.jpeg2k.codeblocks"]
    assert 0 < c["imgcodec.jpeg2k.codeblocks_truncated"] <= n
    assert c["imgcodec.jpeg2k.coding_passes"] >= n
