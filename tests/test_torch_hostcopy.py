"""The CUDA port's own host layer against the JAX package's, on the same
inputs: what the port copied must compute what the original computes.

Exact where the code is integer or the identical numpy code (the header
parse, the route plan, the native index scan and word packing, the side
band, the progressive scope check, the IDCT matrix, the parsers, the host
encoder's bytes); within 1 where the port's CPU JPEG decoder ends in the
port's torch pixel stage and the JAX package's in numpy (exact with
`bitexact`). The JPEG2000 host layer (codestream, tag trees, Tier-2 plans,
the native block coders and 5/3 transforms) is exact. Each side gets its own
package's classes; values are compared, never identities."""
import dataclasses
import enum
import os
import threading

import numpy as np
import pytest

import oracle
import nvimagecodec_tpu as ref
import nvimagecodec_tpu_torch as port
from nvimagecodec_tpu.codecs.jpeg import device_entropy as ref_de
from nvimagecodec_tpu.codecs.jpeg import encode as ref_encode
from nvimagecodec_tpu.codecs.jpeg import headers as ref_headers
from nvimagecodec_tpu.core import scheduler as ref_scheduler
from nvimagecodec_tpu.core.registry import global_registry as ref_registry
from nvimagecodec_tpu.ops import dct as ref_dct
from nvimagecodec_tpu.ops import pallas_entropy as ref_pe
from nvimagecodec_tpu_torch import native
from nvimagecodec_tpu_torch.codecs.jpeg import device_entropy as port_de
from nvimagecodec_tpu_torch.codecs.jpeg import encode as port_encode
from nvimagecodec_tpu_torch.codecs.jpeg import headers as port_headers
from nvimagecodec_tpu_torch.core import scheduler as port_scheduler
from nvimagecodec_tpu_torch.ops import dct as port_dct
from nvimagecodec_tpu_torch.ops import entropy_kernels as port_ek
from util import make_photo

CLASSES = ["420", "422", "444", "440", "411", "410", "gray"]


def plain(x):
    """Dataclasses, enums, arrays and containers as plain Python values, so
    that results of the two packages compare by value."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, enum.Enum):
        return x.name
    if isinstance(x, np.ndarray):
        return (str(x.dtype), x.shape, x.tolist())
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, (np.integer, np.floating)):
        return x.item()
    return x


def _jpeg(ss, seed=0, h=72, w=104, **kw):
    img = make_photo(h, w, seed=seed)
    return oracle.jpeg_encode(img[:, :, 0] if ss == "gray" else img, 85,
                              *(() if ss == "gray" else (ss,)), **kw)


def _both_frames(data):
    return (ref_headers.parse_jpeg_structure(data),
            port_headers.parse_jpeg_structure(data))


@pytest.mark.parametrize("ss", CLASSES)
@pytest.mark.parametrize("kind", ["baseline", "dri", "progressive"])
def test_parse_jpeg_structure_equals_reference(ss, kind):
    kw = {"baseline": {}, "dri": {"restart_interval": 3},
          "progressive": {"progressive": True, "restart_interval": 4}}[kind]
    a, b = _both_frames(_jpeg(ss, **kw))
    assert type(a) is not type(b)
    assert plain(a) == plain(b)
    assert a.mcu_geometry() == b.mcu_geometry()
    assert (a.hmax, a.vmax, a.is_progressive) == (b.hmax, b.vmax,
                                                   b.is_progressive)


@pytest.mark.parametrize("ss", CLASSES)
@pytest.mark.parametrize("rows", [0, 1, 2])
def test_device_entropy_plan_equals_reference(ss, rows):
    """rows = 0: no restart markers (idx plan); else a restart interval of
    that many MCU rows (dri plan)."""
    f = port_headers.parse_jpeg_structure(_jpeg(ss))
    ri = rows * -(-f.width // (8 * f.hmax))
    a, b = _both_frames(_jpeg(ss, restart_interval=ri))
    want, got = ref_de.device_entropy_plan(a), port_de.device_entropy_plan(b)
    assert want is not None and plain(want) == plain(got)
    assert ref_de.frame_segments(a) == port_de.frame_segments(b) \
        if ri else True
    assert plain(ref_pe.entropy_kernel_spec(a, want[2])) == plain(
        port_ek.entropy_kernel_spec(b, got[2]))


def test_device_entropy_plan_declines_like_reference():
    for data in (_jpeg("420", restart_interval=5),  # not whole MCU rows
                 _jpeg("420", progressive=True)):
        a, b = _both_frames(data)
        assert ref_de.device_entropy_plan(a) is None
        assert port_de.device_entropy_plan(b) is None


@pytest.mark.parametrize("ss", CLASSES)
def test_index_scan_and_packing_equal_reference(ss):
    datas = [_jpeg(ss, seed=s) for s in range(5)]
    bad = bytearray(datas[3])  # a scan with stray markers in it
    bad[len(bad) // 2:len(bad) // 2 + 64] = b"\xff\xd9" * 32
    datas[3] = bytes(bad)
    outs = []
    for headers, de in ((ref_headers, ref_de), (port_headers, port_de)):
        frames = {i: headers.parse_jpeg_structure(d)
                  for i, d in enumerate(datas)}
        raws = dict(enumerate(datas))
        _kind, _key, R, nsegs = de.device_entropy_plan(frames[0])
        mx = -(-frames[0].width // (8 * frames[0].hmax))
        good = list(frames)
        scans, (arena, offs, dlens, bits, preds, nout) = de.index_scan_batch(
            frames, raws, good, R // mx, nsegs, 2)
        ok = [k for k, i in enumerate(good) if scans[i] is not None]
        ks = np.asarray(ok)
        W = de.indexed_words_needed_batch(dlens[ks], bits[ks], nsegs)
        S = -(-len(ok) * nsegs // 128) * 128
        words = np.zeros((W, S), np.uint32)
        start_bits = np.zeros(S, np.int32)
        bad = de.pack_indexed_batch(arena, offs, dlens, bits, ks, nsegs,
                                    words, W, start_bits, 2)
        outs.append((ok, nout.tolist(), dlens.tolist(),
                     bits[ks, :nsegs].tolist(),
                     preds[ks, :nsegs * 4].tolist(), W, bad,
                     words.tolist(), start_bits.tolist()))
    assert outs[0] == outs[1]
    assert {0, 1, 2, 4} <= set(outs[0][0])


def test_make_side_equals_reference():
    rng = np.random.default_rng(3)
    seg = rng.integers(0, 40, 256).astype(np.int32)
    start = rng.integers(0, 1 << 20, 256).astype(np.int32)
    dc0 = rng.integers(-1024, 1024, (4, 256)).astype(np.int32)
    for args in ((seg,), (seg, start), (seg, start, dc0), (seg, None, dc0)):
        np.testing.assert_array_equal(ref_pe.make_side(*args),
                                      port_ek.make_side(*args))


@pytest.mark.parametrize("ss", ["420", "444", "gray"])
def test_prog_scan_specs_equals_reference(ss):
    a, b = _both_frames(_jpeg(ss, progressive=True, restart_interval=4))
    assert plain(ref_pe.prog_scan_specs(a)) == plain(
        port_ek.prog_scan_specs(b))
    for data in (_jpeg(ss, progressive=True),  # no restart markers
                 _jpeg(ss)):  # not progressive
        a, b = _both_frames(data)
        with pytest.raises(ValueError) as ea:
            ref_pe.prog_scan_specs(a)
        with pytest.raises(ValueError) as eb:
            port_ek.prog_scan_specs(b)
        assert str(ea.value) == str(eb.value)


@pytest.mark.parametrize("quality", [10, 50, 85, 100])
def test_dct_matrices_equal_reference(quality):
    from nvimagecodec_tpu.codecs.jpeg import tables as ref_tables
    from nvimagecodec_tpu_torch.codecs.jpeg import tables as port_tables

    for name in ("STD_LUMA_QUANT", "STD_CHROMA_QUANT"):
        qa = ref_tables.quality_scaled_quant(getattr(ref_tables, name),
                                             quality)
        qb = port_tables.quality_scaled_quant(getattr(port_tables, name),
                                              quality)
        np.testing.assert_array_equal(qa, qb)
        np.testing.assert_array_equal(ref_dct.dequant_idct_matrix(qa),
                                      port_dct.dequant_idct_matrix(qb))
        np.testing.assert_array_equal(ref_dct.quant_dct_matrix(qa),
                                      port_dct.quant_dct_matrix(qb))


def _streams():
    img = make_photo(40, 56, seed=9)
    exif = __import__("util").add_exif_orientation
    return {
        "jpeg": exif(oracle.jpeg_encode(img, 85, "422"), 6),
        "jpeg_prog": oracle.jpeg_encode(img, 85, "420", progressive=True),
        "png": oracle.png_encode(img),
        "png_gray": oracle.png_encode(img[:, :, 0]),
        "tiff": oracle.tiff_encode(img),
        "webp": oracle.webp_encode_rgb(img, 80.0),
        "webp_lossless": oracle.webp_encode_rgb(img, 80.0, lossless=True),
        "bmp": ref.Encoder().encode(img, "bmp"),
        "pnm": ref.Encoder().encode(img, "pnm"),
        "pgm": ref.Encoder().encode(img[:, :, 0], "pnm"),
    }


@pytest.mark.parametrize("name", ["jpeg", "jpeg_prog", "png", "png_gray",
                                  "tiff", "webp", "webp_lossless", "bmp",
                                  "pnm", "pgm"])
def test_parsers_equal_reference(name):
    data = _streams()[name]
    a = ref.CodeStream(data, ref_registry())
    b = port.CodeStream(data)
    assert a.codec_name == b.codec_name
    ia, ib = a.get_image_info(), b.get_image_info()
    assert type(ia) is not type(ib)
    assert plain(ia) == plain(ib)


def _cpu_decoders(options=""):
    a = ref.Decoder(backends=[ref.Backend(ref.BackendKind.CPU_ONLY)],
                    options=options)
    b = port.Decoder(device="cpu", options=options,
                     backends=[port.Backend(port.BackendKind.CPU_ONLY)])
    return a, b


@pytest.mark.parametrize("ss", CLASSES)
@pytest.mark.parametrize("bitexact", [False, True])
def test_cpu_jpeg_decoder_matches_reference(ss, bitexact):
    """The port's cpu_jpeg_decoder ends in the port's torch pixel stage: the
    float IDCT sums in another order than numpy's, so within 1; the integer
    islow IDCT is exact."""
    opts = "cpu_jpeg_decoder:bitexact=true" if bitexact else ""
    a, b = _cpu_decoders(opts)
    for data in (_jpeg(ss), _jpeg(ss, progressive=True)):
        want, got = np.asarray(a.decode(data)), np.asarray(b.decode(data))
        assert want.shape == got.shape and want.dtype == got.dtype
        d = int(np.abs(want.astype(int) - got.astype(int)).max())
        assert d == 0 if bitexact else d <= 1


def test_cpu_jpeg_decoder_roi_and_12bit_match_reference(photo):
    a, b = _cpu_decoders()
    data = _jpeg("420", h=96, w=128)
    region = port.Region(16, 24, 70, 100)
    want = a.decode(data, ref.DecodeParams(
        enable_roi=True, region=ref.Region(16, 24, 70, 100)))
    got = b.decode(data, port.DecodeParams(enable_roi=True, region=region))
    assert got.shape == (54, 76, 3)
    assert int(np.abs(np.asarray(want).astype(int)
                      - np.asarray(got).astype(int)).max()) <= 1
    img12 = ((photo.astype(np.uint16) << 4) | (photo >> 4)).astype(np.uint16)
    data12 = ref.Encoder().encode(img12, "jpeg", ref.EncodeParams(quality=95))
    for any_depth in (False, True):
        want = np.asarray(a.decode(
            data12, ref.DecodeParams(allow_any_depth=any_depth)))
        got = np.asarray(b.decode(
            data12, port.DecodeParams(allow_any_depth=any_depth)))
        assert got.dtype == want.dtype == (np.uint16 if any_depth
                                           else np.uint8)
        assert int(np.abs(want.astype(int) - got.astype(int)).max()) <= (
            16 if any_depth else 1)


_ENCODES = {
    "444": dict(quality=90),
    "420": dict(quality=75, chroma_subsampling="420"),
    "411": dict(quality=60, chroma_subsampling="411"),
    "optimized": dict(quality=85, chroma_subsampling="422", optimized=True),
    "progressive": dict(quality=85, chroma_subsampling="420",
                        progressive=True),
    "gray": dict(quality=85, gray=True),
    "12bit": dict(quality=95, deep=True),
}


@pytest.mark.parametrize("case", sorted(_ENCODES))
def test_host_jpeg_encoder_bytes_equal_reference(case):
    """The port's host encoder runs colour and downsampling through the
    port's integer-exact torch ops and the fDCT product in numpy, as the
    original does: the same bytes."""
    kw = dict(_ENCODES[case])
    img = make_photo(57, 83, seed=5)
    if kw.pop("gray", False):
        img = img[:, :, 0]
    if kw.pop("deep", False):
        img = (img.astype(np.uint16) << 4) | (img >> 4)
    jp = dict(optimized_huffman=kw.pop("optimized", False),
              progressive=kw.pop("progressive", False))
    want = ref_encode.encode_jpeg(img, ref.EncodeParams(
        jpeg=ref.JpegEncodeParams(**jp), **kw))
    got = port_encode.encode_jpeg(img, port.EncodeParams(
        jpeg=port.JpegEncodeParams(**jp), **kw))
    assert want == got
    frames = _both_frames(got)
    for a, b in zip(ref_encode.encode_pixels(img, frames[0]),
                    port_encode.encode_pixels(img, frames[1])):
        np.testing.assert_array_equal(a, b)


def test_scheduler_gives_none_slot_for_corrupt_sample_like_reference():
    good = [_jpeg("444", seed=s) for s in range(3)]
    datas = [good[0], b"\xff\xd8\xff\xe0garbage", good[1],
             oracle.png_encode(make_photo(24, 32, seed=1)), b"not an image",
             good[2][:200]]  # cut short: only a lenient rung reads it
    cpu = ref.Backend(ref.BackendKind.CPU_ONLY)
    a = ref_scheduler.GenericDecoder(registry=ref_registry(), backends=[cpu])
    b = port_scheduler.GenericDecoder(
        options="cuda_jpeg_hybrid_decoder:device=cpu")
    ra = a.decode_batch([ref.CodeStream(d, ref_registry()) for d in datas])
    rb = b.decode_batch([port.CodeStream(d) for d in datas])
    for x, y in zip(ra, rb):
        ok = bool(x.status & ref.ProcessingStatus.SUCCESS)
        assert ok == bool(y.status & port.ProcessingStatus.SUCCESS)
        assert (x.array is None) == (y.array is None)
        if ok:
            assert int(np.abs(np.asarray(x.array).astype(int)
                              - np.asarray(y.array).astype(int)).max()) <= 1
    none = [r.array is None for r in rb]
    assert none[:5] == [False, True, False, False, True]
    out = port.Decoder(device="cpu").decode(datas)
    assert [o is None for o in out] == none


def test_enums_and_params_carry_the_same_values():
    for name in ("ProcessingStatus", "ChromaSubsampling", "ColorSpec",
                 "SampleFormat", "SampleDataType", "JpegEncoding",
                 "Orientation", "Priority", "Status"):
        a, b = getattr(ref, name), getattr(port, name)
        assert a is not b
        assert {m.name: m.value for m in a} == {m.name: m.value for m in b}
    assert plain(ref.DecodeParams()) == plain(port.DecodeParams())
    assert plain(ref.EncodeParams()) == plain(port.EncodeParams())
    assert int(port.BackendKind.CPU_ONLY) == int(ref.BackendKind.CPU_ONLY)
    assert not {int(k) for k in port.BackendKind if k.name != "CPU_ONLY"} & {
        int(k) for k in ref.BackendKind}


def test_native_library_is_the_ports_own():
    """Built from the port's sources into the port's build directory (which
    git ignores), with the JAX package's symbols under the same names."""
    from nvimagecodec_tpu import native as ref_native

    L = native.lib()
    here = os.path.dirname(os.path.abspath(native.__file__))
    assert here.endswith(os.path.join("nvimagecodec_tpu_torch", "native"))
    assert os.path.dirname(native._SO) == native.BUILD_DIR
    assert os.path.basename(native.BUILD_DIR) == "build"
    assert os.path.exists(native._SO)
    assert native._SO != ref_native._SO
    for sym in ("tic_jpeg_decode_coefficients_into", "tic_jpeg_index_scan_batch",
                "tic_jpeg_pack_indexed_batch", "tic_jpeg_split_segments",
                "tic_jpeg_encode_scan", "tic_png_defilter",
                "tic_tiff_lzw_decode", "tic_vp8_decode",
                "tic_jpeg_lossless_decode"):
        assert hasattr(L, sym) and hasattr(ref_native.lib(), sym)
    assert not any(f.endswith(".so") for f in os.listdir(here))


def test_native_build_is_atomic_under_concurrent_builds(tmp_path):
    """Several builds of one library at once: every one ends with a whole,
    loadable file, and no temporary file is left behind."""
    import ctypes

    src = tmp_path / "one.cpp"
    src.write_text('extern "C" int tic_one() { return 1; }\n')
    so = str(tmp_path / "out" / "libone.so")
    errors = []

    def build():
        try:
            native.build_shared(so, [str(src)], ["-O0"])
            assert ctypes.CDLL(so).tic_one() == 1
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert os.listdir(os.path.dirname(so)) == ["libone.so"]
    assert not native.needs_build(so, [str(src)])
    os.utime(str(src), (os.path.getmtime(so) + 5,) * 2)
    assert native.needs_build(so, [str(src)])
    with pytest.raises(RuntimeError, match="native build"):
        (tmp_path / "bad.cpp").write_text("this is not C++\n")
        native.build_shared(so, [str(tmp_path / "bad.cpp")])
    assert os.listdir(os.path.dirname(so)) == ["libone.so"]


# -- the JPEG2000 host layer -------------------------------------------------
def _j2k_modules():
    from nvimagecodec_tpu.codecs.jpeg2000 import (
        codestream as rc, core as rcore, t1_bridge as rb, t2 as rt2,
        tagtree as rtt)
    from nvimagecodec_tpu_torch.codecs.jpeg2000 import (
        codestream as pc, core as pcore, t1_bridge as pb, t2 as pt2,
        tagtree as ptt)
    return (rc, rcore, rb, rt2, rtt), (pc, pcore, pb, pt2, ptt)


_J2K_STREAMS = {
    "reversible": dict(reversible=True, levels=3),
    "irreversible": dict(reversible=False, quality=70, levels=2),
    "tiled_layers": dict(levels=2, tile_size=48, num_layers=3,
                         prog_order="RPCL", precincts=(5, 5)),
    "ht": dict(levels=2, ht=True, stream_type="jph"),
    "per_comp": dict(levels=2, per_comp={1: {"cblk": (32, 32)},
                                         2: {"eps_shift": 1}}),
    "offset": dict(levels=2, tile_size=32, grid_offset=(5, 3)),
}


@pytest.mark.parametrize("name", sorted(_J2K_STREAMS))
def test_j2k_codestream_parse_equals_reference(name):
    (rc, rcore, _rb, _rt2, _rtt), (pc, _pcore, _pb, _pt2, _ptt) = (
        _j2k_modules())
    data = rcore.encode_j2k(make_photo(72, 104, seed=5),
                            **_J2K_STREAMS[name])
    assert pc.jp2_colorspace(data) == rc.jp2_colorspace(data)
    cs = rc.unwrap_jp2(data)
    assert pc.unwrap_jp2(data) == cs
    (rsiz, rcp, rpos), (psiz, pcp, ppos) = (rc.parse_main_header(cs, 0),
                                            pc.parse_main_header(cs, 0))
    assert type(rsiz) is not type(psiz)
    assert plain(rsiz) == plain(psiz) and plain(rcp) == plain(pcp)
    assert rpos == ppos
    assert (list(rc.iter_tile_parts(cs, rpos, ppm=rcp.ppm))
            == list(pc.iter_tile_parts(cs, ppos, ppm=pcp.ppm)))
    for t in range(rsiz.tiles_x * rsiz.tiles_y):
        assert rsiz.tile_rect(t) == psiz.tile_rect(t)
    x0, y0, x1, y1 = rsiz.tile_rect(0)
    rres = rc.build_resolutions(x0, y0, x1, y1, rcp.levels)
    pres = pc.build_resolutions(x0, y0, x1, y1, pcp.levels)
    assert plain(rres) == plain(pres)
    assert (list(rc.progression_iter(rcp, {c: rres for c in range(3)}, 3,
                                     x0, y0))
            == list(pc.progression_iter(pcp, {c: pres for c in range(3)}, 3,
                                        x0, y0)))
    # the writers give the reference's marker segments back
    assert pc.write_siz(psiz) == rc.write_siz(rsiz)
    assert pc.write_cod(pcp) == rc.write_cod(rcp)
    assert pc.write_qcd(pcp) == rc.write_qcd(rcp)
    assert pc.wrap_jp2(cs, psiz, "sycc") == rc.wrap_jp2(cs, rsiz, "sycc")


def test_j2k_tagtree_and_header_bits_equal_reference():
    (rc, _rcore, _rb, rt2, rtt), (pc, _pcore, _pb, pt2, ptt) = _j2k_modules()
    rng = np.random.default_rng(9)
    vals = rng.integers(0, 6, (5, 7))
    outs = []
    for cs_mod, tt_mod in ((rc, rtt), (pc, ptt)):
        tree = tt_mod.TagTree(7, 5)
        tree.set_values(vals.ravel().tolist())
        bw = cs_mod.HeaderBitWriter()
        for y in range(5):
            for x in range(7):
                k = 1  # every leaf to full resolution, rising thresholds
                while True:
                    tree.encode(bw, x, y, k)
                    if tree.coded[tree._index(0, x, y)]:
                        break
                    k += 1
        data = bw.flush()
        dec = tt_mod.TagTree(7, 5)
        br = cs_mod.HeaderBitReader(data, 0)
        for y in range(5):
            for x in range(7):
                k = 1
                while not dec.decode(br, x, y, k):
                    k += 1
                assert dec.leaf_value(x, y) == vals[y, x]
        outs.append(data)
    assert outs[0] == outs[1]
    for n in (1, 2, 3, 5, 6, 36, 37, 164):
        a, b = rc.HeaderBitWriter(), pc.HeaderBitWriter()
        rt2._npasses_write(a, n)
        pt2._npasses_write(b, n)
        assert a.flush() == b.flush()
    for style in (0x01, 0x04, 0x05):
        for npasses in (1, 4, 10, 13):
            assert (rt2.seg_pass_groups(style, npasses)
                    == pt2.seg_pass_groups(style, npasses))
    seg = bytes(rng.integers(0, 255, 300).astype(np.uint8))
    assert (plain(rt2.plan_layers(seg, 13, 2, 4))
            == plain(pt2.plan_layers(seg, 13, 2, 4)))
    assert (plain(rt2.plan_layers_ht(seg[:100], seg[100:], 3, 1, 3))
            == plain(pt2.plan_layers_ht(seg[:100], seg[100:], 3, 1, 3)))


@pytest.mark.parametrize("kind", ["t1", "ht"])
def test_j2k_block_coders_equal_reference(kind):
    (_rc, _rcore, rb, _rt2, _rtt), (_pc, _pcore, pb, _pt2, _ptt) = (
        _j2k_modules())
    rng = np.random.default_rng(4)
    for (h, w), band in (((64, 64), 0), ((17, 33), 1), ((5, 64), 3)):
        blk = (rng.integers(-300, 300, (h, w))
               * (rng.random((h, w)) < 0.4)).astype(np.int32)
        if kind == "t1":
            a, b = rb.t1_encode(blk, band), pb.t1_encode(blk, band)
            assert a == b
            seg, nbps, npasses = b
            back = pb.t1_decode(seg, w, h, band, nbps, npasses)
            assert np.array_equal(back, rb.t1_decode(seg, w, h, band, nbps,
                                                     npasses))
        else:
            a, b = rb.ht_encode(blk), pb.ht_encode(blk)
            assert a == b
            cup, ref_seg, B, umax = b
            back = pb.ht_decode(cup, ref_seg, 1, w, h, B, 31 - B + 1)
            assert np.array_equal(back, rb.ht_decode(cup, ref_seg, 1, w, h,
                                                     B, 31 - B + 1))
        assert np.array_equal(back, blk)
    # the batched entries, through one tile's worth of blocks
    blocks = [(rng.integers(-99, 99, (32, 32))).astype(np.int32)
              for _ in range(6)]
    res = []
    for mod in (rb, pb):
        eb = mod.EncodeBatch(kind == "ht")
        for i, blk in enumerate(blocks):
            eb.add(i, blk, i % 4)
        res.append(list(eb.run(2)))
    assert res[0] == res[1]


@pytest.mark.parametrize("origin", [(0, 0), (3, 5), (1, 0)])
def test_j2k_native_53_transforms_equal_reference(origin):
    (_rc, _rcore, rb, _rt2, _rtt), (_pc, _pcore, pb, _pt2, _ptt) = (
        _j2k_modules())
    from nvimagecodec_tpu.ops import dwt as ref_dwt

    rng = np.random.default_rng(6)
    plane = rng.integers(-255, 256, (45, 61)).astype(np.int32)
    for levels in (1, 3):
        LLr, br = rb.fdwt53(plane, levels, origin)
        LLp, bp = pb.fdwt53(plane, levels, origin)
        LLn, bn = ref_dwt.dwt2d(plane, levels, True, origin)
        assert np.array_equal(LLr, LLp) and np.array_equal(LLn, LLp)
        for x, y, z in zip(br, bp, bn):
            for u, v, w in zip(x, y, z):
                assert np.array_equal(u, v) and np.array_equal(w, v)
        back = pb.idwt53(LLp, bp, plane.shape, origin)
        assert np.array_equal(back, plane)
        assert np.array_equal(back, rb.idwt53(LLr, br, plane.shape, origin))


def test_j2k_native_entries_are_declared():
    """Every `tic_*` entry the J2K bridge calls has its argument types
    declared in the port's native module (ctypes would pass ints and
    pointers by guess otherwise)."""
    L = native.lib()
    for sym in ("tic_j2k_t1_decode", "tic_j2k_t1_encode",
                "tic_ht_decode_block", "tic_ht_encode_block",
                "tic_t1_decode_batch_into", "tic_ht_decode_batch_into",
                "tic_t1_encode_batch_addr", "tic_ht_encode_batch_addr",
                "tic_idwt53", "tic_fdwt53", "tic_j2k_rct_shift_u8",
                "tic_j2k_shift_u8", "tic_t2_create", "tic_t2_free",
                "tic_t2_add_resolutions", "tic_t2_read_packets",
                "tic_t2_blocks", "tic_t2_side", "tic_t2_rows",
                "tic_t1_rows_check", "tic_t2e_create",
                "tic_t2e_free", "tic_t2e_add_precband",
                "tic_t2e_write_packet"):
        assert getattr(L, sym).argtypes is not None, sym
    assert "not part of the port" not in native.__doc__
    src = os.path.dirname(os.path.abspath(native.__file__))
    for f in ("j2k_t1.cpp", "j2k_ht.cpp", "j2k_t2.cpp", "j2k_block_batch.cpp",
              "j2k_idwt.cpp", "j2k_finish.cpp", "j2k_ht_tables.inc"):
        assert os.path.exists(os.path.join(src, f)), f


def test_j2k_epilogue_equals_numpy():
    import ctypes

    L = native.lib()
    rng = np.random.default_rng(8)
    y, cb, cr = (rng.integers(-200, 200, 999).astype(np.int32)
                 for _ in range(3))
    out = np.empty((999, 3), np.uint8)
    i32p, u8p = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint8)
    assert L.tic_j2k_rct_shift_u8(y.ctypes.data_as(i32p),
                                  cb.ctypes.data_as(i32p),
                                  cr.ctypes.data_as(i32p), 999,
                                  out.ctypes.data_as(u8p)) == 0
    g = y - ((cb + cr) >> 2)
    want = np.clip(np.stack([cr + g, g, cb + g], -1) + 128, 0, 255)
    assert np.array_equal(out, want.astype(np.uint8))
    one = np.empty(999, np.uint8)
    assert L.tic_j2k_shift_u8(y.ctypes.data_as(i32p), 999, 1,
                              one.ctypes.data_as(u8p)) == 0
    assert np.array_equal(one, np.clip(y + 128, 0, 255).astype(np.uint8))


# -- the multi-device layer's host helpers -----------------------------------
@pytest.mark.parametrize("shards,keyed", [(2, False), (4, False), (3, True)])
def test_shard_streams_equals_reference(shards, keyed):
    from nvimagecodec_tpu.parallel.multihost import (
        shard_streams as ref_shard_streams,
    )
    from nvimagecodec_tpu_torch.parallel.multihost import shard_streams

    rng = np.random.default_rng(shards)
    streams = [bytes(int(rng.integers(1, 3000))) for _ in range(29)]
    keys = ([(int(rng.integers(0, 3)), -len(s)) for s in streams] if keyed
            else None)
    assert (shard_streams(streams, shards, keys)
            == ref_shard_streams(streams, shards, keys))
