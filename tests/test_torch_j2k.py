"""The port's JPEG2000 stack (nvimagecodec_tpu_torch/codecs/jpeg2000) against
the JAX package's, on the same inputs made from a seed, on the CPU.

Tolerances:
- `encode_j2k`: the bytes equal the reference's, every case;
- `decode_j2k` host path (`device=None`): pixels equal the reference's
  `use_jax=False`;
- the device pixel stage run on `device="cpu"`: bit-exact for 5/3 against
  both reference paths (`use_jax=False` and `use_jax=True` on the CPU
  backend), within 1 for 9/7 (float32 lifting against float64);
- `Decoder(device="cpu")` / `Encoder(device="cpu")` equal the reference's
  `Decoder()` / `Encoder()`.
"""
import ctypes
import hashlib
import os
import struct
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import oracle
import nvimagecodec_tpu as ref
import nvimagecodec_tpu_torch as port
from nvimagecodec_tpu.codecs.jpeg2000 import core as ref_core
from nvimagecodec_tpu.codecs.jpeg2000.codestream import (
    parse_main_header as ref_parse_main_header,
)
from nvimagecodec_tpu_torch.codecs import jpeg2000 as port_j2k
from nvimagecodec_tpu_torch.codecs import system_codecs as port_sys
from nvimagecodec_tpu_torch.codecs.jpeg2000 import core as port_core
from nvimagecodec_tpu_torch.codecs.jpeg2000.codestream import (
    parse_main_header,
    unwrap_jp2,
)
from nvimagecodec_tpu_torch.ops import dwt as port_dwt
from nvimagecodec_tpu_torch.ops import j2k_t1
from nvimagecodec_tpu_torch.parallel.mesh import make_mesh
from test_torch_j2k_t1_device import (KINDS, _bad_qcd, _blob, _card_table,
                                      _no_launch, _on_card_rule, _stream)
from util import make_photo, psnr

CPU = torch.device("cpu")
HTJ2K = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_corpus",
                     "htj2k")
HT_STREAMS = sorted(f for f in os.listdir(HTJ2K)
                    if f.endswith((".j2k", ".jp2")))


def _opj_loads():
    """The system-openjpeg rung registers itself only where libopenjp2
    loads and passes its self-check."""
    return "system_openjpeg_decoder" in [
        d.plugin_id
        for d in port.global_registry().codec("jpeg2k").decoders]


def _photo(h=128, w=160, seed=1):
    return make_photo(h, w, seed=seed)


def _u16(h=100, w=150, seed=2):
    rng = np.random.default_rng(seed)
    base = make_photo(h, w, seed=seed).astype(np.uint16) * 257
    return (base ^ rng.integers(0, 256, base.shape).astype(np.uint16))


def _planar420(h=96, w=128, seed=4):
    rng = np.random.default_rng(seed)
    img = make_photo(h, w, seed=seed)
    return [img[:, :, 0], img[::2, ::2, 1].copy(),
            rng.integers(0, 256, (h // 2, w // 2)).astype(np.uint8)]


# name -> (image maker, encode_j2k keywords)
ENCODES = {
    "reversible": (_photo, dict(reversible=True, levels=3)),
    "reversible_j2k": (_photo, dict(reversible=True, levels=3,
                                    stream_type="j2k")),
    "irreversible_q80": (_photo, dict(reversible=False, quality=80,
                                      levels=3)),
    "irreversible_q40": (_photo, dict(reversible=False, quality=40,
                                      levels=2)),
    "tiled_uniform": (lambda: _photo(128, 192),
                      dict(reversible=True, levels=3, tile_size=64)),
    "tiled_uniform_irrev": (lambda: _photo(128, 192),
                            dict(reversible=False, quality=75, levels=2,
                                 tile_size=64)),
    "tiled_partial": (lambda: _photo(100, 150, 2),
                      dict(reversible=True, levels=2, tile_size=64)),
    "tiled_odd_tile": (lambda: _photo(90, 99, 3),
                       dict(reversible=True, levels=2, tile_size=33)),
    "layers3": (_photo, dict(reversible=True, levels=3, num_layers=3)),
    "layers_irrev": (_photo, dict(reversible=False, quality=85, levels=3,
                                  num_layers=4)),
    "prog_LRCP": (_photo, dict(levels=2, num_layers=2, prog_order="LRCP",
                               precincts=(5, 5))),
    "prog_RLCP": (_photo, dict(levels=2, num_layers=2, prog_order="RLCP",
                               precincts=(5, 5))),
    "prog_RPCL": (_photo, dict(levels=2, num_layers=2, prog_order="RPCL",
                               precincts=(5, 5))),
    "prog_PCRL": (_photo, dict(levels=2, num_layers=2, prog_order="PCRL",
                               precincts=(5, 5))),
    "prog_CPRL": (_photo, dict(levels=2, num_layers=2, prog_order="CPRL",
                               precincts=(5, 5))),
    "precincts_per_res": (_photo, dict(levels=3,
                                       precincts=[(4, 4), (5, 5), (6, 6)])),
    "cblk32": (_photo, dict(levels=3, cblk=(32, 32))),
    "cblk16x64": (_photo, dict(levels=2, cblk=(16, 64))),
    "levels0": (lambda: _photo(37, 53), dict(levels=0)),
    "ht": (_photo, dict(reversible=True, levels=3, ht=True)),
    "ht_irrev": (_photo, dict(reversible=False, quality=85, levels=3,
                              ht=True)),
    "ht3": (_photo, dict(reversible=True, levels=2, ht=3)),
    "ht_jph": (_photo, dict(reversible=True, levels=2, ht=True,
                            stream_type="jph")),
    "target_psnr": (_photo, dict(reversible=False, levels=3,
                                 target_psnr=40.0)),
    "target_psnr_u16": (_u16, dict(reversible=False, levels=3,
                                   target_psnr=58.0)),
    "per_comp": (_photo, dict(levels=2, per_comp={
        1: {"cblk": (32, 32)}, 2: {"eps_shift": 1}})),
    "subsampled_planar": (_planar420, dict(levels=2,
                                           sub=[(1, 1), (2, 2), (2, 2)])),
    "subsampled_planar_irrev": (_planar420, dict(
        reversible=False, quality=80, levels=2,
        sub=[(1, 1), (2, 2), (2, 2)], colorspace="sycc")),
    "uint16": (_u16, dict(reversible=True, levels=2)),
    "uint16_irrev": (_u16, dict(reversible=False, quality=90, levels=2)),
    "gray": (lambda: _photo()[:, :, 1], dict(reversible=True, levels=3)),
    "gray_irrev": (lambda: _photo()[:, :, 1], dict(reversible=False,
                                                   quality=70, levels=3)),
    "signed_int16": (lambda: (_u16().astype(np.int32) - 32768).astype(
        np.int16), dict(reversible=True, levels=2)),
    "grid_offset": (lambda: _photo(61, 77), dict(levels=2, tile_size=32,
                                                 grid_offset=(5, 3))),
    "roi_maxshift": (lambda: _photo(64, 64), dict(levels=2,
                                                  roi=(16, 16, 48, 48))),
    "bypass": (_photo, dict(levels=2, mode_switches=0x01)),
    "termall": (_photo, dict(levels=2, mode_switches=0x04, num_layers=2)),
    "reset_causal_segsym": (_photo, dict(levels=2, mode_switches=0x2A)),
    "tiny": (lambda: _photo(8, 8), dict(levels=5)),
}


def _both(name):
    maker, kw = ENCODES[name]
    img = maker()
    return img, ref_core.encode_j2k(img, **kw), port_core.encode_j2k(img,
                                                                     **kw)


def _same(a, b):
    if isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b)
        for u, v in zip(a, b):
            _same(u, v)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b)


@pytest.mark.parametrize("name", sorted(ENCODES))
def test_encode_j2k_bytes_equal_reference(name):
    _img, a, b = _both(name)
    assert isinstance(b, bytes)
    assert a == b


@pytest.mark.parametrize("name", sorted(ENCODES))
def test_decode_j2k_host_path_equals_reference(name):
    img, a, _b = _both(name)
    want = ref_core.decode_j2k(a)
    got = port_core.decode_j2k(a, device=None)
    assert not isinstance(got, torch.Tensor)
    _same(want, got)
    kw = ENCODES[name][1]
    lossless = (kw.get("reversible", True) and kw.get("ht") != 3
                and not isinstance(img, list))
    if lossless:
        _same(got, img)


@pytest.mark.parametrize("name", ["subsampled_planar",
                                  "subsampled_planar_irrev"])
def test_decode_j2k_planar_equals_reference(name):
    _img, a, _b = _both(name)
    _same(ref_core.decode_j2k(a, planar=True),
          port_core.decode_j2k(a, planar=True, device=None))


@pytest.mark.parametrize("fname", HT_STREAMS)
def test_htj2k_corpus_decodes_like_reference(fname):
    with open(os.path.join(HTJ2K, fname), "rb") as f:
        data = f.read()
    want = ref_core.decode_j2k(data)
    _same(want, port_core.decode_j2k(data, device=None))
    got = port_core.decode_j2k(data, device=CPU)
    dev = got.numpy() if isinstance(got, torch.Tensor) else got
    assert dev.dtype == want.dtype and dev.shape == want.shape
    _, cp, _ = parse_main_header(unwrap_jp2(data), 0)
    tol = 0 if cp.reversible else 1
    assert np.abs(dev.astype(np.int64) - want.astype(np.int64)).max() <= tol


@pytest.mark.parametrize("discard", [1, 2])
@pytest.mark.parametrize("name", ["reversible", "irreversible_q80",
                                  "tiled_partial", "ht"])
def test_discard_levels_equal_reference(name, discard):
    _img, a, _b = _both(name)
    _same(ref_core.decode_j2k(a, discard_levels=discard),
          port_core.decode_j2k(a, discard_levels=discard, device=None))


@pytest.mark.parametrize("name", ["reversible", "irreversible_q80",
                                  "tiled_partial", "tiled_uniform",
                                  "subsampled_planar"])
def test_region_decode_equals_reference(name):
    _img, a, _b = _both(name)
    rg_ref = ref.Region(17, 23, 70, 101)
    rg = port.Region(17, 23, 70, 101)
    want = ref_core.decode_j2k(a, region=rg_ref)
    _same(want, port_core.decode_j2k(a, region=rg, device=None))
    # a region keeps the pixel stage on the host even when a device is named
    got = port_core.decode_j2k(a, region=rg, device=CPU)
    assert not isinstance(got, torch.Tensor)
    _same(want, got)


# ---------------------------------------------------------------- stage
STAGE = {  # name -> (route the stream must take, tolerance)
    "reversible": ("device", 0),
    "reversible_j2k": ("device", 0),
    "irreversible_q80": ("device", 1),
    "irreversible_q40": ("device", 1),
    "tiled_uniform": ("device_tiles", 0),
    "tiled_uniform_irrev": ("device_tiles", 1),
    "tiled_partial": ("host", 0),
    "tiled_odd_tile": ("host", 0),
    "layers3": ("device", 0),
    "ht": ("device", 0),
    "ht_irrev": ("device", 1),
    "target_psnr_u16": ("device", 1),
    "per_comp": ("host", 0),
    "subsampled_planar": ("host", 0),
    "uint16": ("device", 0),
    "uint16_irrev": ("device", 1),
    "gray": ("device", 0),
    "gray_irrev": ("device", 1),
    "signed_int16": ("host", 0),
    "grid_offset": ("host", 0),
    "roi_maxshift": ("device", 0),
    "levels0": ("device", 0),
    "tiny": ("device", 0),
}


def _routes_delta(before):
    return {k: port_core.ROUTES[k] - before[k] for k in before
            if port_core.ROUTES[k] != before[k]}


@pytest.mark.parametrize("name", sorted(STAGE))
def test_device_stage_on_cpu_matches_both_reference_paths(name):
    route, tol = STAGE[name]
    _img, a, _b = _both(name)
    host = np.asarray(ref_core.decode_j2k(a, use_jax=False))
    jaxed = np.asarray(ref_core.decode_j2k(a, use_jax=True))
    before = dict(port_core.ROUTES)
    got = port_core.decode_j2k(a, device=CPU)
    assert _routes_delta(before) == {route: 1}
    if route == "host":
        assert isinstance(got, np.ndarray)
        dev = got
    else:
        assert isinstance(got, torch.Tensor) and got.device == CPU
        assert got.is_contiguous()
        dev = got.numpy()
    assert dev.dtype == host.dtype and dev.shape == host.shape
    for want in (host, jaxed):
        d = np.abs(dev.astype(np.int64) - want.astype(np.int64))
        assert d.max() <= tol, (name, d.max())


def test_tile_grid_with_odd_band_geometry_keeps_the_host_path():
    """Tiles whose sides are no multiple of 2^levels have per-tile subband
    sizes: not one stack, so the host path takes them, exactly."""
    img = _photo(80, 120, 6)
    data = port_core.encode_j2k(img, levels=4, tile_size=40)
    before = dict(port_core.ROUTES)
    got = port_core.decode_j2k(data, device=CPU)
    assert _routes_delta(before) == {"host": 1}
    assert np.array_equal(got, img)


def test_device_pixels_constants_and_rounding():
    """The ICT constants are the reference's, rounding is half to even and
    the clamp saturates, on hand-made stacks without any DWT level."""
    y = torch.tensor([[[0.5, 1.5, 2.5, -300.0, 300.0]]])
    z = torch.zeros_like(y)
    px = port_core.device_pixels(torch.cat([y, z, z]), [], (1, 5), False,
                                 True, 8)
    assert px.dtype == torch.int32
    assert px[0].tolist() == [[128, 130, 130, 0, 255]]
    cb = torch.full_like(y, 10.0)
    cr = torch.full_like(y, -20.0)
    px = port_core.device_pixels(torch.cat([z, cb, cr]), [], (1, 5), False,
                                 True, 8)[:, 0, 0].tolist()
    want = [round(1.402 * -20) + 128,
            round(-0.344136 * 10 - 0.714136 * -20) + 128,
            round(1.772 * 10) + 128]
    assert px == want
    # RCT on int32: g = y - ((cb + cr) >> 2), arithmetic shift
    yi = torch.tensor([[[5]], [[-3]], [[-2]]], dtype=torch.int32)
    px = port_core.device_pixels(yi, [], (1, 1), True, True, 8)
    g = 5 - ((-3 + -2) >> 2)
    assert px[:, 0, 0].tolist() == [128 + -2 + g, 128 + g, 128 + -3 + g]


def test_subbands_go_up_in_one_buffer(monkeypatch):
    """Every subband of the tile lives in ONE flat host buffer that is
    uploaded by one copy; the leaves handed to the IDWT are views of the one
    device buffer, and T1 wrote the reversible blocks into it directly."""
    _img, a, _b = _both("reversible")
    stages = []
    real_upload = port_core._SubbandStage.upload

    def upload(self, device):
        stages.append(self)
        out = real_upload(self, device)
        LL, bands = out
        base = LL.untyped_storage().data_ptr()
        for lvl in bands:
            for b in lvl:
                assert b.untyped_storage().data_ptr() == base
        return out

    monkeypatch.setattr(port_core._SubbandStage, "upload", upload)
    port_core.decode_j2k(a, device=CPU)
    assert len(stages) == 1
    st = stages[0]
    assert st.flat.dtype == torch.int32 and st.flat.dim() == 1
    assert len(st.leaves) == 1 + 3 * 3
    assert st.flat.numel() == 3 * 128 * 160  # the pyramid tiles the plane
    for leaf in st.leaves:
        assert np.shares_memory(leaf, st.flat.numpy())
    assert any(leaf.any() for leaf in st.leaves)
    # a uniform grid: one buffer for all tiles, leaves [T, C, h, w]; 9/7
    # leaves hold int32 half-steps, a step a leaf to scale them by
    stages.clear()
    _img, a, _b = _both("tiled_uniform_irrev")
    port_core.decode_j2k(a, device=CPU)
    assert len(stages) == 1 and stages[0].flat.dtype == torch.int32
    assert len(stages[0].steps) == len(stages[0].leaves)
    assert stages[0].leaves[0].shape[:2] == (6, 3)


def test_device_stage_failure_is_its_own_exception(monkeypatch):
    _img, a, _b = _both("reversible")

    def boom(*args, **kw):
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(port_dwt, "idwt2d", boom)
    with pytest.raises(port_core.J2kDeviceStageError, match="illegal"):
        port_core.decode_j2k(a, device=CPU)
    # the host path does not go through ops/dwt for 5/3 and still decodes
    assert np.array_equal(port_core.decode_j2k(a, device=None), _img)
    assert not issubclass(port_core.J2kDeviceStageError, ValueError)


def test_host_stage_rejections_are_value_errors():
    img = _photo(64, 64)
    s = port_core.encode_j2k(img, reversible=True, levels=2,
                             stream_type="j2k")
    i = s.find(b"\xff\x52")  # COD; an RGN of an unsupported style before it
    body = bytes([0, 0])
    bad = s[:i] + b"\xff\x5e" + struct.pack(">H", 2 + len(body)) + body + s[i:]
    for dev in (None, CPU):
        with pytest.raises(ValueError):
            port_core.decode_j2k(bad, device=dev)
    with pytest.raises(ValueError):
        ref_core.decode_j2k(bad)


def test_no_environment_switch_decides_the_route(monkeypatch):
    _img, a, _b = _both("reversible")
    for var, val in (("TIC_J2K_DEVICE", "0"), ("TIC_J2K_NO_DEVICE", "1")):
        monkeypatch.setenv(var, val)
        assert isinstance(port_core.decode_j2k(a, device=CPU), torch.Tensor)
        monkeypatch.delenv(var)
    for name in ("_h2d_lat_ms", "_h2d_mb_per_s", "_j2k_device_fn",
                 "_decode_single_tile_sharded"):
        assert not hasattr(port_core, name)
    assert port_core.device_route_auto(1 << 20, CPU) is False
    assert port_core.device_route_auto(1 << 20, None) is False
    assert port_core.device_route_auto(1 << 20, "cuda") is True
    assert port_core.device_route_auto(255 * 256, "cuda:0") is False


# ------------------------------------------------------------ public API
def _img_eq(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b)


def _jp2(name, **kw):
    maker, base = ENCODES[name]
    return port_core.encode_j2k(maker(), **{**base, **kw})


def _sycc_jp2():
    return ref.Encoder().encode(
        _photo(120, 160, 30), codec="jp2",
        params=ref.EncodeParams(
            quality=90, chroma_subsampling=ref.ChromaSubsampling.CSS_420,
            jpeg2k=ref.Jpeg2kEncodeParams(reversible=False)))


API_STREAMS = {
    "j2k": lambda: _jp2("reversible_j2k"),
    "jp2": lambda: _jp2("reversible"),
    "jp2_irrev": lambda: _jp2("irreversible_q80"),
    "tiled_uniform": lambda: _jp2("tiled_uniform"),
    "tiled_partial": lambda: _jp2("tiled_partial"),
    "ht": lambda: _jp2("ht"),
    "gray": lambda: _jp2("gray"),
    "uint16": lambda: _jp2("uint16"),
    "sycc": _sycc_jp2,
}


@pytest.mark.parametrize("stage", ["default", "forced", "off"])
@pytest.mark.parametrize("name", sorted(API_STREAMS))
def test_decoder_equals_reference_decoder(name, stage):
    """`Decoder(device="cpu")` keeps the pixel stage on the host unless the
    option asks for it; with the torch stage forced 5/3 stays exact and 9/7
    within 1 (sYCC: the colour conversion may carry the 1 on)."""
    data = API_STREAMS[name]()
    opt = {"default": "", "forced": ":device_pixel_stage=true",
           "off": ":device_pixel_stage=false"}[stage]
    dec = port.Decoder(device="cpu", options=(
        "cuda_jpeg2k_hybrid_decoder" + opt) if opt else "")
    before = dict(port_core.ROUTES)
    got = dec.decode(data)
    want = ref.Decoder().decode(data)
    assert isinstance(got, port.Image) and got.array.device == CPU
    a, b = np.asarray(got), np.asarray(want)
    assert a.dtype == b.dtype and a.shape == b.shape
    lossy = name in ("jp2_irrev", "sycc")
    if stage == "forced" and lossy:
        assert np.abs(a.astype(int) - b.astype(int)).max() <= (
            1 if name == "jp2_irrev" else 3)
    else:
        assert np.array_equal(a, b)
    routed = _routes_delta(before)
    if stage == "forced" and name not in ("tiled_partial", "sycc"):
        assert set(routed) <= {"device", "device_tiles"} and routed
    else:
        assert routed == {"host": 1}


@pytest.mark.parametrize("any_depth", [False, True])
@pytest.mark.parametrize("stage", ["true", "false"])
def test_decoder_16_bit_with_and_without_any_depth(any_depth, stage):
    data = _jp2("uint16")
    dec = port.Decoder(device="cpu", options=(
        f"cuda_jpeg2k_hybrid_decoder:device_pixel_stage={stage}"))
    got = dec.decode(data, port.DecodeParams(allow_any_depth=any_depth))
    want = ref.Decoder().decode(
        data, ref.DecodeParams(allow_any_depth=any_depth))
    _img_eq(got, want)
    assert np.asarray(got).dtype == (np.uint16 if any_depth else np.uint8)


@pytest.mark.parametrize("levels", [1, 2])
def test_decoder_discard_levels_option(levels):
    data = _jp2("reversible")
    got = port.Decoder(device="cpu", options=(
        f"cuda_jpeg2k_hybrid_decoder:discard_levels={levels} "
        "cuda_jpeg2k_hybrid_decoder:device_pixel_stage=true")).decode(data)
    want = ref.Decoder(options=(
        f"tpu_jpeg2k_hybrid_decoder:discard_levels={levels}")).decode(data)
    _img_eq(got, want)
    assert np.asarray(got).shape == (128 >> levels, 160 >> levels, 3)


@pytest.mark.parametrize("name", ["jp2", "tiled_partial", "jp2_irrev"])
def test_decoder_roi_is_the_host_stage_and_equals_reference(name):
    data = API_STREAMS[name]()
    p = port.DecodeParams(enable_roi=True,
                          region=port.Region(10, 20, 90, 140))
    pr = ref.DecodeParams(enable_roi=True,
                          region=ref.Region(10, 20, 90, 140))
    before = dict(port_core.ROUTES)
    got = port.Decoder(device="cpu", options=(
        "cuda_jpeg2k_hybrid_decoder:device_pixel_stage=true")).decode(data, p)
    assert _routes_delta(before) == {"host": 1}
    _img_eq(got, ref.Decoder().decode(data, pr))
    assert np.asarray(got).shape == (80, 120, 3)


def test_sycc_conversion_runs_on_the_tensor(monkeypatch):
    """A device-decoded sYCC image is converted where it lives and is not
    pulled to numpy: `_finish` gets a tensor and returns one."""
    rng = np.random.default_rng(3)
    ycc = rng.integers(0, 256, (12, 16, 3)).astype(np.uint8)
    t = port_j2k._finish(torch.from_numpy(ycc), True, True)
    n = port_j2k._finish(ycc, True, True)
    assert isinstance(t, torch.Tensor) and isinstance(n, np.ndarray)
    from nvimagecodec_tpu.ops.color import ycbcr_to_rgb_i32 as ref_conv
    r, g, b = ref_conv(ycc[:, :, 0], ycc[:, :, 1], ycc[:, :, 2], maxval=255)
    want = np.stack([r, g, b], axis=-1).astype(np.uint8)
    assert np.array_equal(t.numpy(), want) and np.array_equal(n, want)
    y16 = rng.integers(0, 65536, (12, 16, 3)).astype(np.uint16)
    r, g, b = ref_conv(y16[:, :, 0], y16[:, :, 1], y16[:, :, 2],
                       maxval=65535)
    want16 = np.stack([r, g, b], axis=-1).astype(np.uint16)
    assert np.array_equal(port_j2k._finish(y16, True, False), want16)
    assert np.array_equal(port_j2k._finish(torch.from_numpy(y16), True,
                                           True).numpy(),
                          (want16 >> 8).astype(np.uint8))


# ----------------------------------------------------------------- encoder
def _golden(name):
    img = make_photo(60, 80, seed=7)
    gray = img[..., 0]
    return {
        "jp2_lossless": (img, "jp2", dict(
            jpeg2k=dict(reversible=True)), "3b31672a8d27e2f5f5b8e78c59d89f01"),
        "j2k_q70": (img, "jpeg2k", dict(
            quality=70, jpeg2k=dict(stream_type="j2k")),
            "bc0df3fb2a2b9e9ba40e9369834c55ce"),
        "jp2_gray_lossless": (gray, "jp2", dict(
            jpeg2k=dict(reversible=True)), "9f2ca2ec06554b76ea8cfc52aa752162"),
    }[name]


def _params(pkg, spec):
    spec = dict(spec)
    jp = spec.pop("jpeg2k", None)
    if jp is not None:
        spec["jpeg2k"] = pkg.Jpeg2kEncodeParams(**jp)
    css = spec.pop("css", None)
    if css is not None:
        spec["chroma_subsampling"] = getattr(pkg.ChromaSubsampling, css)
    return pkg.EncodeParams(**spec)


@pytest.mark.parametrize("name", ["jp2_lossless", "j2k_q70",
                                  "jp2_gray_lossless"])
def test_encoder_goldens_equal_reference(name):
    pix, codec, spec, md5 = _golden(name)
    got = port.Encoder(device="cpu").encode(pix, codec, _params(port, spec))
    want = ref.Encoder().encode(pix, codec=codec, params=_params(ref, spec))
    assert got == want
    assert hashlib.md5(got).hexdigest() == md5


ENCODER_CASES = {
    "css420": dict(quality=90, css="CSS_420", jpeg2k=dict(reversible=False)),
    "css422": dict(quality=85, css="CSS_422", jpeg2k=dict(reversible=False)),
    "css420_reversible": dict(css="CSS_420", jpeg2k=dict(reversible=True)),
    "psnr42": dict(target_psnr=42.0, jpeg2k=dict(reversible=False)),
    "q100_is_reversible": dict(quality=100, jpeg2k=dict(reversible=False)),
    "ht": dict(jpeg2k=dict(reversible=True, ht=True)),
    "layers_precincts": dict(quality=80, jpeg2k=dict(
        num_layers=3, prog_order="RPCL", precincts=(6, 6),
        num_resolutions=4, code_block_w=32, code_block_h=32)),
    "u16_lossless": dict(jpeg2k=dict(reversible=True, stream_type="j2k")),
}


@pytest.mark.parametrize("name", sorted(ENCODER_CASES))
def test_encoder_bytes_equal_reference(name):
    img = _photo(120, 160, 30)
    if "u16" in name:
        img = _u16(120, 160, 30)
    spec = ENCODER_CASES[name]
    got = port.Encoder(device="cpu").encode(img, "jp2", _params(port, spec))
    want = ref.Encoder().encode(img, codec="jp2", params=_params(ref, spec))
    assert got is not None and got == want
    back = port.Decoder(device="cpu").decode(
        got, port.DecodeParams(allow_any_depth=True))
    assert np.asarray(back).shape == img.shape
    if name in ("q100_is_reversible", "ht", "u16_lossless"):
        assert np.array_equal(np.asarray(back), img)
    elif "u16" not in name:
        assert psnr(img, np.asarray(back)) > 30.0


def test_encoder_takes_tensors_and_lists_and_rejects_floats():
    img = _photo(64, 80, 9)
    enc = port.Encoder(device="cpu")
    p = port.EncodeParams(jpeg2k=port.Jpeg2kEncodeParams(reversible=True))
    a = enc.encode(img, "jp2", p)
    b = enc.encode(torch.from_numpy(img), "jp2", p)
    c = enc.encode([img, img[:, :, 0]], "j2k", p)
    assert a == b and len(c) == 2 and all(c)
    assert np.array_equal(np.asarray(port.Decoder(device="cpu").decode(c[1])),
                          img[:, :, 0])
    assert enc.encode(img.astype(np.float32), "jp2", p) is None
    # odd sizes cannot be box-filtered 2x2, and the int32 colour conversion
    # overflows on 16-bit samples: the sample fails, as in the reference,
    # and does not raise
    spec = dict(css="CSS_420", jpeg2k=dict(reversible=False))
    for bad in (_photo(61, 81, 9), _u16(64, 80, 9)):
        assert enc.encode(bad, "jp2", _params(port, spec)) is None
        assert ref.Encoder().encode(bad, codec="jp2",
                                    params=_params(ref, spec)) is None


def test_encoder_plugin_identity():
    reg = port.global_registry()
    encs = reg.codec("jpeg2k").encoders
    assert [e.plugin_id for e in encs] == ["jpeg2k_encoder"]
    assert encs[0].backend_kind == port.BackendKind.CPU_ONLY
    assert "tpu" not in encs[0].plugin_id


# ------------------------------------------------- registry and fallbacks
def test_registry_ladder_for_jpeg2k():
    ids = [d.plugin_id for d in port.global_registry().codec(
        "jpeg2k").decoders]
    assert ids[0] == "cuda_jpeg2k_hybrid_decoder"
    if _opj_loads():
        assert ids == ["cuda_jpeg2k_hybrid_decoder",
                       "system_openjpeg_decoder"]
    dec = port.global_registry().codec("jpeg2k").decoders[0]
    assert dec.backend_kind == port.BackendKind.HYBRID_CPU_GPU
    assert dec.priority == port.Priority.HIGH


def test_corrupt_stream_gives_a_none_slot():
    good = _jp2("reversible_j2k")
    junk = good[:50] + b"\x12\x34" * 200  # SOC and SIZ, then no marker
    ref_out = ref.Decoder().decode([good, junk, good[:40]])
    for opt in ("true", "false"):
        out = port.Decoder(device="cpu", options=(
            f"cuda_jpeg2k_hybrid_decoder:device_pixel_stage={opt}")).decode(
                [good, junk, good[:40]])
        # the native decoder rejects `junk`; what the system-openjpeg rung
        # below it makes of it is the same under both packages
        assert [o is None for o in out] == [o is None for o in ref_out]
        assert out[0] is not None and out[2] is None
    with pytest.raises(ValueError):
        port_core.decode_j2k(junk, device=None)


def _rejected_stream():
    """HT mixed with MQ blocks (style 0x41): the native decoder rejects it."""
    img = _photo(48, 48, 3)
    s = bytearray(port_core.encode_j2k(img, reversible=True, levels=1,
                                       stream_type="j2k"))
    cod = s.find(b"\xff\x52")
    style_off = cod + 4 + 1 + 4 + 3
    erterm = bytes(s[:style_off]) + bytes([s[style_off] | 0x10]) + bytes(
        s[style_off + 1:])
    mixed = bytes(s[:style_off]) + bytes([s[style_off] | 0x41]) + bytes(
        s[style_off + 1:])
    return img, erterm, mixed


def test_erterm_accepted_ht_mix_rejected_like_reference():
    img, erterm, mixed = _rejected_stream()
    for dev in (None, CPU):
        assert np.array_equal(np.asarray(
            port_core.decode_j2k(erterm, device=dev)), img)
        with pytest.raises(ValueError):
            port_core.decode_j2k(mixed, device=dev)


@pytest.mark.parametrize("stage", ["true", "false"])
def test_host_stage_rejection_falls_to_system_openjpeg(stage, monkeypatch):
    if not _opj_loads():
        pytest.skip("libopenjp2 does not load on this machine")
    img = _photo(64, 64)
    s = port_core.encode_j2k(img, reversible=True, levels=2,
                             stream_type="j2k")
    i = s.find(b"\xff\x52")
    body = bytes([0, 0])  # RGN the native decoder rejects
    rgn = s[:i] + b"\xff\x5e" + struct.pack(">H", 2 + len(body)) + body + s[i:]
    answered = []
    real = port_sys.OpjJpeg2kDecoder.decode_batch

    def spy(self, data_batch, info_batch, params):
        answered.append(len(data_batch))
        return real(self, data_batch, info_batch, params)

    monkeypatch.setattr(port_sys.OpjJpeg2kDecoder, "decode_batch", spy)
    dec = port.Decoder(device="cpu", options=(
        f"cuda_jpeg2k_hybrid_decoder:device_pixel_stage={stage}"))
    out = dec.decode([s, rgn, s])
    assert answered == [1]  # only the rejected sample went down the ladder
    for o in (out[0], out[2]):
        assert np.array_equal(np.asarray(o), img)
    # what openjpeg makes of the hand-made marker is its own affair; the
    # reference's decoder gives the same slot
    want = ref.Decoder().decode([rgn])[0]
    assert (out[1] is None) == (want is None)


@pytest.mark.parametrize("entry", ["decode", "decode_one", "decode_async",
                                   "user_executor", "mixed_batch"])
def test_device_stage_error_raises_from_every_entry(entry, monkeypatch):
    """A failure of the device stage comes out of every entry point, after
    every sample's worker has ended, and no other decoder answers it."""
    streams = [_jp2("reversible_j2k"), _jp2("gray"), _jp2("tiled_uniform")]
    running = []
    lock = threading.Lock()

    def boom(*args, **kw):
        with lock:
            running.append(threading.current_thread().name)
        raise RuntimeError("CUDA error: launch failed")

    opj_calls = []
    monkeypatch.setattr(port_dwt, "idwt2d", boom)
    monkeypatch.setattr(port_sys.OpjJpeg2kDecoder, "decode_batch",
                        lambda self, *a: opj_calls.append(a))
    opts = "cuda_jpeg2k_hybrid_decoder:device_pixel_stage=true"
    err = port_core.J2kDeviceStageError
    if entry in ("decode", "decode_one"):
        with pytest.raises(err, match="launch failed"):
            port.Decoder(device="cpu", options=opts).decode(
                streams if entry == "decode" else streams[0])
    elif entry == "decode_async":
        fut = port.Decoder(device="cpu", options=opts).decode_async(streams)
        with pytest.raises(err, match="launch failed"):
            fut.wait_all(timeout=60)
    elif entry == "user_executor":
        with ThreadPoolExecutor(2) as pool:
            dec = port.Decoder(device="cpu", options=opts, executor=pool)
            with pytest.raises(err, match="launch failed"):
                dec.decode(streams)
            fut = dec.decode_async(streams)
            with pytest.raises(err, match="launch failed"):
                fut.wait_new(timeout=60)
    else:
        png = oracle.png_encode(make_photo(20, 24, seed=1))
        with pytest.raises(err, match="launch failed"):
            port.Decoder(device="cpu", options=opts).decode([png] + streams)
    assert opj_calls == []
    if entry != "decode_one":
        assert len(running) >= len(streams)  # every sample ran to its end


def test_a_host_failure_beside_a_device_failure_still_raises(monkeypatch):
    good = _jp2("reversible_j2k")
    junk = good[:50] + b"\x12\x34" * 200
    monkeypatch.setattr(port_dwt, "idwt2d", lambda *a, **k: 1 / 0)
    with pytest.raises(port_core.J2kDeviceStageError, match="ZeroDivision"):
        port.Decoder(device="cpu", options=(
            "cuda_jpeg2k_hybrid_decoder:device_pixel_stage=true")).decode(
                [junk, good])


@pytest.mark.parametrize("broken", ["ycbcr_to_rgb_i32", "widen_uint16"])
def test_a_failure_after_the_idwt_is_a_device_stage_error(broken,
                                                          monkeypatch):
    """The sYCC conversion and the `>> 8` narrowing run on the device
    stage's tensor: their failure is raised too, and no other decoder
    answers it."""
    if broken == "ycbcr_to_rgb_i32":
        img = _photo(64, 80, 5)
        data = port_core.encode_j2k(img, reversible=True, levels=2,
                                    colorspace="sycc")
    else:
        data = _jp2("uint16")
    good = _jp2("gray")

    def boom(*args, **kw):
        raise RuntimeError("CUDA error: an illegal memory access")

    opj_calls = []
    monkeypatch.setattr(port_j2k, broken, boom)
    monkeypatch.setattr(port_sys.OpjJpeg2kDecoder, "decode_batch",
                        lambda self, *a: opj_calls.append(a))
    dec = port.Decoder(device="cpu", options=(
        "cuda_jpeg2k_hybrid_decoder:device_pixel_stage=true"))
    before = dict(port_core.ROUTES)
    for batch in (data, [good, data]):
        with pytest.raises(port_core.J2kDeviceStageError, match="illegal"):
            dec.decode(batch)
    with pytest.raises(port_core.J2kDeviceStageError, match="illegal"):
        dec.decode_async([data, good]).wait_all(timeout=60)
    assert _routes_delta(before) == {"device": 5}  # the stage itself ran
    assert opj_calls == []
    # the same operation on a numpy image of the host path is the host
    # stage's: that sample fails alone
    host = port.Decoder(device="cpu", options=(
        "cuda_jpeg2k_hybrid_decoder:device_pixel_stage=false"))
    out = host.decode([good, data])
    assert out[0] is not None and out[1] is None


def test_a_failed_pinned_allocation_is_a_device_stage_error(monkeypatch):
    """The upload buffer of a CUDA device is pinned through the CUDA
    runtime, in the host stage (the subbands) or in the upload (the
    code-block table, where Tier-1 runs on the card): its failure is the
    device stage's."""
    def pinned_fails(real):
        def make(*args, pin_memory=False, **kw):
            if pin_memory:
                raise RuntimeError("CUDA error: out of memory")
            return real(*args, **kw)
        return make

    monkeypatch.setattr(port_core.torch, "zeros", pinned_fails(torch.zeros))
    monkeypatch.setattr(port_core.torch, "empty", pinned_fails(torch.empty))
    a = _jp2("reversible_j2k")
    with pytest.raises(port_core.J2kDeviceStageError, match="pinned.*out of"):
        port_core.decode_j2k(a, device=torch.device("cuda"))
    dec = port_j2k.Jpeg2kHybridCudaDecoder()
    dec.set_options({"device": "cuda", "device_pixel_stage": "true"})
    with pytest.raises(port_core.J2kDeviceStageError, match="pinned"):
        dec.decode_batch([a, a], [None, None], port.DecodeParams())
    # a CPU device pins nothing
    assert isinstance(port_core.decode_j2k(a, device=CPU), torch.Tensor)


# ------------------------------------------------------ mixed devices
def _mixed_batch():
    photo = _photo(100, 150, 2)
    jpeg = oracle.jpeg_encode(photo, 90, "420")
    single = port_core.encode_j2k(photo, reversible=True, levels=2)
    partial = port_core.encode_j2k(photo, reversible=True, levels=2,
                                   tile_size=64)
    png = oracle.png_encode(photo)
    return photo, [jpeg, single, partial, png]


@pytest.mark.parametrize("to_device", [False, True])
def test_mixed_batch_lies_on_the_decoders_device(to_device):
    photo, batch = _mixed_batch()
    dec = port.Decoder(device="cpu", options=(
        "cuda_jpeg2k_hybrid_decoder:device_pixel_stage=true"))
    before = dict(port_core.ROUTES)
    out = dec.decode(batch, to_device=to_device)
    assert _routes_delta(before) == {"device": 1, "host": 1}
    assert all(isinstance(o, port.Image) for o in out)
    assert all(o.array.device == dec.device for o in out)
    for o in out[1:]:
        assert np.array_equal(np.asarray(o), photo)
    assert np.abs(np.asarray(out[0]).astype(int) - photo).max() < 40
    one = dec.read(batch[2], to_device=to_device)
    assert np.array_equal(np.asarray(one), photo)


def test_to_device_moves_host_results(monkeypatch):
    """With to_device every image goes through `.to(decoder.device)`: the
    host-decoded ones are the ones that move (checked with the meta device
    standing in for another device)."""
    _photo_, batch = _mixed_batch()
    dec = port.Decoder(device="cpu")
    dec.device = torch.device("meta")
    out = dec.decode(batch[1:], to_device=True)
    assert all(o.array.device.type == "meta" for o in out)
    out = dec.decode(batch[1:])
    assert all(o.array.device.type == "cpu" for o in out)


def test_decoder_hands_its_device_to_the_j2k_plugin():
    dec = port.Decoder(device="cpu", options=(
        "cuda_jpeg2k_hybrid_decoder:device=cuda:3"))
    dec.decode(_jp2("gray"))  # instantiates the plugin with its options
    plug = [p for p in dec._generic._instance_cache.values()
            if getattr(p, "plugin_id", "") == "cuda_jpeg2k_hybrid_decoder"]
    assert plug and plug[0].device == CPU
    assert plug[0].device_pixel_stage is None


def test_plugin_route_rule(monkeypatch):
    """Unset, the option follows device_route_auto: never on the CPU, on a
    CUDA device from DEVICE_STAGE_MIN_PIXELS on."""
    plug = port_j2k.Jpeg2kHybridCudaDecoder()
    info = port.CodeStream(_jp2("reversible")).get_image_info()
    plug.set_options({"device": "cpu"})
    assert plug._stage_device(info) is None
    plug.set_options({"device": "cuda"})
    assert plug._stage_device(info) is None  # 128x160 is under the floor
    monkeypatch.setattr(port_core, "DEVICE_STAGE_MIN_PIXELS", 128 * 160)
    assert plug._stage_device(info) == torch.device("cuda")
    plug.set_options({"device": "cuda", "device_pixel_stage": "false"})
    assert plug._stage_device(info) is None
    plug.set_options({"device": "cpu", "device_pixel_stage": "true"})
    assert plug._stage_device(info) == CPU


def test_siz_of_subsampled_encode_equals_reference():
    spec = dict(quality=90, css="CSS_420", jpeg2k=dict(reversible=False))
    data = port.Encoder(device="cpu").encode(_photo(120, 160, 30), "jp2",
                                             _params(port, spec))
    siz, _cp, _ = parse_main_header(unwrap_jp2(data), 0)
    rsiz, _rcp, _ = ref_parse_main_header(unwrap_jp2(data), 0)
    assert siz.sub_x == rsiz.sub_x == [1, 2, 2]
    assert siz.sub_y == rsiz.sub_y == [1, 2, 2]


def _without_tile_part(cs: bytes, tile: int) -> bytes:
    """A raw codestream with the tile-parts of one tile cut out (each SOT
    segment spans Psot bytes from its marker)."""
    _siz, _cp, pos = parse_main_header(cs, 0)
    out, p = bytearray(cs[:pos]), pos
    while cs[p:p + 2] == b"\xff\x90":
        isot, psot = struct.unpack(">HI", cs[p + 4:p + 10])
        if isot != tile:
            out += cs[p:p + psot]
        p += psot
    return bytes(out + cs[p:])


# ---------------------------------------------------------------- the plan
def _port_stream(name):
    maker, kw = ENCODES[name]
    return port_core.encode_j2k(maker(), **kw)


# case -> (stream, plan_stream keywords, pixel route, Tier-1 site on the
# CPU, Tier-1 site on a CUDA device)
PLANS = {
    "one_tile": (lambda: _port_stream("reversible"), {}, "device_tile",
                 "native_into", "card_table"),
    "uniform_grid": (lambda: _port_stream("tiled_uniform"), {},
                     "device_grid", "native_into", "card_table"),
    "grid_missing_tile": (lambda: _without_tile_part(port_core.encode_j2k(
        _photo(64, 64, seed=8), reversible=True, levels=2, tile_size=16,
        stream_type="j2k"), 5), {}, "device_grid", "native_into",
        "card_table"),
    "odd_band_geometry": (lambda: port_core.encode_j2k(
        _photo(80, 120, 6), levels=4, tile_size=40), {}, "host",
        "native_into", "native_into"),
    "irreversible": (lambda: _port_stream("irreversible_q80"), {},
                     "device_tile", "native_blocks", "native_blocks"),
    "ht": (lambda: _port_stream("ht"), {}, "device_tile", "native_into",
           "native_into"),
    "rgn": (lambda: _port_stream("roi_maxshift"), {}, "device_tile",
            "native_into", "native_into"),
    "subsampled": (lambda: _port_stream("subsampled_planar"), {}, "host",
                   "native_into", "native_into"),
    "signed": (lambda: _port_stream("signed_int16"), {}, "host",
               "native_into", "native_into"),
    "region": (lambda: _port_stream("reversible"),
               {"region": port.Region(17, 23, 70, 101)}, "host",
               "native_into", "native_into"),
    "discard": (lambda: _port_stream("reversible"), {"discard_levels": 1},
                "host", "native_into", "native_into"),
    "coc": (lambda: _port_stream("per_comp"), {}, "host", "native_into",
            "native_into"),
    "mesh": (lambda: _port_stream("reversible"), {"mesh": True},
             "device_tile", "native_into", "native_into"),
}


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("case", sorted(PLANS))
def test_stream_plan(case, device):
    """The pixel route and the Tier-1 site `plan_stream` decides from the
    main header, on the CPU and on a CUDA-named device (the plan needs no
    card): the routes the decode takes (ROUTES above) and, on a CUDA
    device, the card's Tier-1 wherever `tier1_on_device` holds."""
    make, kw, pixels, on_cpu, on_cuda = PLANS[case]
    kw = dict(kw)
    if kw.get("mesh"):
        kw["mesh"] = make_mesh(dp=1, sp=2, devices=[CPU] * 2)
    plan = port_core.plan_stream(unwrap_jp2(make()), torch.device(device),
                                 **kw)
    assert (plan.pixels, plan.tier1) == (
        pixels, on_cpu if device == "cpu" else on_cuda)
    # no device named: the host route, with the host Tier-1
    host = port_core.plan_stream(unwrap_jp2(make()), None, **kw)
    assert (host.pixels, host.tier1) == ("host", on_cpu)


@pytest.mark.parametrize("tile", [0, 5, 15])
def test_missing_tile_decodes_like_the_host_path(tile):
    """A uniform 4x4 grid with one tile-part cut out: the device route
    (forced, on the CPU) gives the host route's image, the tiles present
    and zero where the tile is missing, as the JAX package's host route
    does."""
    img = _photo(64, 64, seed=8)
    full = port_core.encode_j2k(img, reversible=True, levels=2, tile_size=16,
                                stream_type="j2k")
    cut = _without_tile_part(full, tile)
    assert len(cut) < len(full)
    before = dict(port_core.ROUTES)
    dev = port_core.decode_j2k(cut, device="cpu")
    assert _routes_delta(before) == {"device_tiles": 1}
    host = port_core.decode_j2k(cut, device=None)
    theirs = np.asarray(ref_core.decode_j2k(cut, use_jax=False))
    assert isinstance(dev, torch.Tensor)
    np.testing.assert_array_equal(dev.numpy(), host)
    np.testing.assert_array_equal(host, theirs)
    ty, tx = divmod(tile, 4)
    want = img.copy()
    want[ty * 16:(ty + 1) * 16, tx * 16:(tx + 1) * 16] = 0
    np.testing.assert_array_equal(host, want)
    # and through the Decoder with the stage forced
    got = port.Decoder(device="cpu", options=(
        "cuda_jpeg2k_hybrid_decoder:device_pixel_stage=true")).decode(cut)
    assert torch.equal(got.array, dev)


# ---------------------------------- Tier-2's native rows against the reference
# (the table route's cases of tests/test_torch_j2k_t1_device.py, held here
# against the JAX package's Tier-2: that file runs on the card's machine,
# which has no JAX)
def _reference_table(data, stage):
    """The rows of the table and its data, built here block by block from
    the JAX package's Tier-2 (its PacketDecoder: code-blocks laid out by
    `cblk_grid_precinct`, their state from `tic_t2_dump`, their segments)
    and `t1_row`, in the order the device route adds them; the stage gives
    each band's plane."""
    from nvimagecodec_tpu.codecs.jpeg2000 import t2 as ref_t2
    from nvimagecodec_tpu.codecs.jpeg2000.codestream import (
        HeaderBitReader as RefReader)
    from nvimagecodec_tpu_torch.codecs.jpeg2000.codestream import (
        iter_tile_parts, progression_iter, unwrap_jp2)

    cs = unwrap_jp2(data)
    plan = port_core.plan_stream(cs, CPU)
    rows, parts = [], []
    size = 0
    for tidx, tdata, ppt, tpoc in iter_tile_parts(cs, plan.pos,
                                                  ppm=plan.cp.ppm):
        tile = port_core._tile(plan, tidx, tpoc)
        pdec = ref_t2.PacketDecoder(plan.siz, plan.cp, tile.resolutions)
        br = RefReader(tdata if ppt is None else ppt, 0)
        body_pos = ctypes.c_int64(0)
        for l, r, c, p in progression_iter(tile.cp, tile.resolutions,
                                           plan.siz.ncomp, tile.rect[0],
                                           tile.rect[1], sub=plan.sub):
            if ppt is None:
                pdec.read_packet(br, c, r, l, p)
            else:
                pdec.read_packet(br, c, r, l, p, body=tdata,
                                 body_pos=body_pos)
        base = size
        parts.append(tdata)
        size += len(tdata)
        for c, cc in enumerate(plan.ccs):
            for i, (r, bi) in enumerate(port_core._band_order(cc)):
                band = tile.resolutions[c][r].bands[bi]
                mb = cc.band_q[i][0] + cc.guard_bits - 1
                plane = stage.plane_offset(
                    *port_core._leaf(plan, tile, c, r, bi))
                style = cc.cblk_style & 0x2F
                for cb in pdec.band_cblks(c, r, bi):
                    if not cb.included or cb.num_passes == 0:
                        continue
                    segs = [tdata[x[0]:x[0] + x[1]] if type(x) is tuple
                            else x for x in cb.segments]
                    if style & 0x05:
                        seg = _blob([len(x) for x in segs or [b""]],
                                    b"".join(segs))
                    elif len(cb.segments) == 1 and type(
                            cb.segments[0]) is tuple:
                        seg = None
                        off, ln = base + cb.segments[0][0], len(segs[0])
                    else:
                        seg = b"".join(segs)
                    if seg is not None:
                        off, ln = size, len(seg)
                        parts.append(seg)
                        size += len(seg)
                    rows.append(j2k_t1.t1_row(
                        off, ln, cb.x1 - cb.x0, cb.y1 - cb.y0, band.btype,
                        max(0, mb - cb.zero_bps), cb.num_passes, style)
                        + (band.w, plane + (cb.y0 - band.y0) * band.w
                           + cb.x0 - band.x0))
    return np.asarray(rows, np.int64), b"".join(parts)


@pytest.mark.parametrize("kind", KINDS)
def test_native_rows_and_staged_buffer_equal_the_reference_rows(
        kind, monkeypatch):
    """The rows Tier-2 writes in its one native pass a tile, and the
    staged buffer, equal the rows built here from the JAX package's Tier-2
    block by block: the same fields in the same order, and the same data
    (each tile's data, then its joined segments and blobs)."""
    px = make_photo(128, 192, seed=7)
    data = _stream(kind, px)
    job = _card_table(data, monkeypatch)
    want, want_data = _reference_table(data, job.stage)
    table = job.stage.t1
    got = table.rows()
    assert len(got) == len(want) > 0
    assert np.array_equal(got[:, :8], want[:, :8])
    assert np.array_equal(j2k_t1.row_dest(got[:, 8], got[:, 9]), want[:, 8])
    buf, lay = table.staged()
    assert bytes(buf[lay.data_start:].numpy()) == want_data
    staged = buf[:lay.rows * j2k_t1.ROW * 4].view(torch.int32).view(
        lay.rows, j2k_t1.ROW).numpy()
    order = np.argsort(-want[:, 1], kind="stable")
    assert np.array_equal(staged[:, :8], want[order, :8])


def _malformed(kind):
    """A 2-layer stream cut short inside its tile data (packets whose
    bodies, or headers, run past its end), or with every band's exponent
    at 31 (`_bad_qcd`)."""
    px = make_photo(96, 128, seed=12)
    data = port_core.encode_j2k(px, reversible=True, levels=3, num_layers=2,
                           stream_type="j2k")
    if kind == "bad_qcd":
        return _bad_qcd(data)
    i = data.find(b"\xff\x93") + 2
    return data[:i + (len(data) - i) * int(kind[3:]) // 100]


@pytest.mark.parametrize("route", ["card_table", "host"])
@pytest.mark.parametrize("kind", ["cut00", "cut02", "cut50", "cut97",
                                  "bad_qcd"])
def test_malformed_streams_raise_todays_messages(kind, route, monkeypatch):
    """Truncated packets and blocks the native decoder refuses raise the
    ValueError the JAX package's decoder raises for the same stream, on
    the table route (before any launch) and on the host route."""
    data = _malformed(kind)
    with pytest.raises(ValueError) as want:
        ref_core.decode_j2k(data)
    device = None
    if route == "card_table":
        said = _on_card_rule(monkeypatch)
        _no_launch(monkeypatch)
        device = CPU
    with pytest.raises(ValueError) as got:
        port_core.decode_j2k(data, device=device)
    assert str(got.value) == str(want.value)
    if route == "card_table":
        assert said == [True]
