"""Card tests of the CUDA port: the hand-written kernels against their plain
PyTorch versions, the Decoder (idx and dri routes) and the progressive
route on the GPU against the same on the CPU, and the encode device stage,
the Encoder, resize, the input pipeline and the command line on the GPU
against the same on the CPU; and the JPEG2000 device pixel stage, the torch
DWT and the J2K Decoder / Encoder on the GPU against the same on the CPU;
and fdct_quant_blocks: against its plain version, against the digests of
its pinned bits, at the edges of its tiling and from an unaligned source;
and the multi-device layer: an image encoded alone against the same image in a batch, Decoder(mesh=),
GenericEncoder(mesh=) and decode_j2k(mesh=) on meshes of the one card
(and a shard on cuda:1 where a second card is present).
They need a CUDA device and skip without one. On the GPU machine:

    python -m pytest tests/test_torch_gpu.py -m gpu -q
"""
import hashlib

import numpy as np
import pytest
import torch

import nvimagecodec_tpu_torch as port
import torch_corpus
from nvimagecodec_tpu_torch.codecs.jpeg.encode import encode_jpeg
from nvimagecodec_tpu_torch.codecs.jpeg.headers import parse_jpeg_structure
from nvimagecodec_tpu_torch.codecs.jpeg.pixel import ZIGZAG_NAT
from nvimagecodec_tpu_torch.codecs.jpeg.tables import (
    STD_CHROMA_QUANT,
    STD_LUMA_QUANT,
    quality_scaled_quant,
)
from nvimagecodec_tpu_torch.codecs.jpeg import batch as jb
from nvimagecodec_tpu_torch.codecs.jpeg import device_entropy as de
from nvimagecodec_tpu_torch.codecs.jpeg2000 import core as j2k
from nvimagecodec_tpu_torch.ops import dwt as dwt_ops
from nvimagecodec_tpu_torch.ops import entropy_kernels as ek
from nvimagecodec_tpu_torch.ops import kernels
from util import make_photo

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def jpgs():
    params = port.EncodeParams(
        quality=85, chroma_subsampling=port.ChromaSubsampling.CSS_420)
    return [encode_jpeg(make_photo(120, 168, seed=s), params)
            for s in range(20)]


@pytest.mark.parametrize("zigzag,K", [(False, 64), (True, 64), (True, 27)])
def test_k1_kernel_vs_plain(cuda, zigzag, K):
    rng = np.random.default_rng(K)
    x = torch.from_numpy(rng.integers(-300, 300, (3, 9, 13, K))
                         .astype(np.int16)).to(cuda)
    M = kernels.idct_matrix(quality_scaled_quant(STD_CHROMA_QUANT, 70), cuda)
    before = kernels.dequant_idct_blocks.launches
    got = kernels.dequant_idct_blocks(x, M, 8, zigzag)
    assert kernels.dequant_idct_blocks.launches == before + 1
    want = kernels.dequant_idct_blocks_plain(x, M, 8, zigzag)
    torch.cuda.synchronize()
    assert int((got - want).abs().max()) <= 1


@pytest.mark.parametrize("nblocks,K,precision", [
    (1, 64, 8), (127, 64, 8), (129, 64, 8), (301, 10, 8), (513, 33, 8),
    (1000, 64, 12)])
def test_k1_partial_tiles_and_prefixes(cuda, nblocks, K, precision):
    """Block counts around the kernel's 128-block tile, zigzag prefixes whose
    rows are not 16-byte aligned, and a source pointer off a 16-byte
    boundary: all equal the plain version within 1, and the unaligned source
    gives what the aligned one gives."""
    rng = np.random.default_rng(nblocks)
    amp = 3000 if precision == 12 else 300
    x = torch.from_numpy(rng.integers(-amp, amp, (1, 1, nblocks, K))
                         .astype(np.int16)).to(cuda)
    M = kernels.idct_matrix(quality_scaled_quant(STD_CHROMA_QUANT, 80), cuda)
    got = kernels.dequant_idct_blocks(x, M, precision, True)
    want = kernels.dequant_idct_blocks_plain(x, M, precision, True)
    assert int((got - want).abs().max()) <= 1
    assert int(got.max()) <= (1 << precision) - 1 and int(got.min()) >= 0
    odd = torch.empty(nblocks * K + 3, dtype=torch.int16, device=cuda)
    view = odd[3:].view(1, 1, nblocks, K)
    view.copy_(x)
    assert torch.equal(kernels.dequant_idct_blocks(view, M, precision, True),
                       got)


def test_k1_zigzag_equals_natural(cuda):
    rng = np.random.default_rng(1)
    nat = rng.integers(-100, 100, (2, 4, 5, 64)).astype(np.int16)
    M = kernels.idct_matrix(quality_scaled_quant(STD_CHROMA_QUANT, 90), cuda)
    a = kernels.dequant_idct_blocks(torch.from_numpy(nat).to(cuda), M)
    zz = np.ascontiguousarray(nat[..., ZIGZAG_NAT])
    b = kernels.dequant_idct_blocks(torch.from_numpy(zz).to(cuda), M,
                                    zigzag=True)
    assert torch.equal(a, b)


def test_k1_rejects_bad_input(cuda):
    M = kernels.idct_matrix(quality_scaled_quant(STD_CHROMA_QUANT, 90), cuda)
    x = torch.zeros((1, 2, 2, 64), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        kernels.dequant_idct_blocks(x, M)


def _k2_args(jpgs, n, dev):
    """`decode_segments_into`'s arguments for the first n streams, split as
    the idx route splits them."""
    frames = {i: jb.parse_jpeg_structure(d) for i, d in enumerate(jpgs[:n])}
    raws = dict(enumerate(jpgs[:n]))
    f0 = frames[0]
    _kind, _key, R, nsegs = jb.route_plan(f0)
    ok, bad, bad_scan, words, side = jb.split_indexed(
        list(range(n)), frames, raws, R, nsegs, dev)
    assert len(ok) == n and not bad and not bad_scan
    R, _comp_map, tables = ek.huffman_tables(f0, R)
    mx = -(-f0.width // (8 * f0.hmax))
    my = -(-f0.height // (8 * f0.vmax))
    return [words.to(dev), side.to(dev), torch.from_numpy(tables).to(dev),
            torch.from_numpy(ek.lookahead_tables(tables)).to(dev), R,
            [(c.h, c.v) for c in f0.components], mx, my, n, nsegs]


def _k2_equal(args):
    """K2 against its plain version on the same device inputs; err."""
    before = ek.decode_segments_into.launches
    stacks, err = ek.decode_segments_into(*args)
    assert ek.decode_segments_into.launches == before + 1
    want, err_p = ek.decode_segments_into_plain(*args[:3], *args[4:])
    torch.cuda.synchronize()
    for a, b in zip(stacks, want):
        assert a.is_contiguous() and a.shape == b.shape and torch.equal(a, b)
    assert torch.equal(err, err_p)
    return err


def test_k2_kernel_vs_plain(cuda, jpgs):
    args = _k2_args(jpgs, 5, cuda)
    assert not _k2_equal(args).any()
    args[0][3:7, 2] = -1  # a corrupted lane: no code is sixteen 1 bits
    assert int(_k2_equal(args)[2]) == 1


def _std_tables(ncomp):
    """[ncomp, 2, 34 + nv] from the Annex K tables: luma, then chroma."""
    from nvimagecodec_tpu_torch.codecs.jpeg.headers import HuffTable
    from nvimagecodec_tpu_torch.codecs.jpeg.tables import (
        STD_AC_CHROMA,
        STD_AC_LUMA,
        STD_DC_CHROMA,
        STD_DC_LUMA,
    )

    def row(t):
        return ek._canonical(HuffTable(list(t[0][1:]), list(t[1])))

    pairs = [(row(STD_DC_LUMA), row(STD_AC_LUMA))] + \
        [(row(STD_DC_CHROMA), row(STD_AC_CHROMA))] * (ncomp - 1)
    nv = max(len(r) for pair in pairs for r in pair)
    out = np.zeros((ncomp, 2, nv), np.int32)
    for ci, pair in enumerate(pairs):
        for tc, r in enumerate(pair):
            out[ci, tc, :len(r)] = r
    return out


@pytest.mark.parametrize("hv,mcus_x,mcus_y,rows,B,S", [
    ([(2, 2), (1, 1), (1, 1)], 5, 7, 2, 3, 128),   # a short last segment
    ([(1, 1)], 9, 4, 1, 5, 21),                     # gray, S off the CTA
    ([(1, 1), (1, 1), (1, 1)], 3, 5, 5, 67, 67),    # one segment an image
    ([(4, 1), (1, 1), (1, 1)], 4, 3, 1, 2, 6),      # 4:1:1
    ([(1, 2), (1, 1), (1, 1), (1, 2)], 2, 9, 4, 4, 13),  # 4 components
])
def test_k2_ragged_shapes_on_random_bits(cuda, hv, mcus_x, mcus_y, rows, B, S):
    """Random words (every error path is met), lanes of 0 MCUs, short last
    segments whose padding rows are dropped, S that is no multiple of the
    lanes a CTA serves: stacks and err equal the plain version's."""
    rng = np.random.default_rng(S)
    R = rows * mcus_x
    nsegs = -(-mcus_y // rows)
    assert B * nsegs <= S
    tables = _std_tables(len(hv))
    words = rng.integers(-2**31, 2**31, (40, S), dtype=np.int64).astype(np.int32)
    side = np.zeros((6, S), np.int32)
    side[0, :B * nsegs] = R
    side[0, nsegs - 1:B * nsegs:nsegs] = mcus_x * (mcus_y - (nsegs - 1) * rows)
    side[0, 1] = 0  # a segment the packer gave up on
    side[1] = rng.integers(0, 32, S)
    side[2:6] = rng.integers(-500, 500, (4, S))
    words[1:3, 0] = -1  # no code is sixteen 1 bits: lane 0 is flagged
    args = [torch.from_numpy(words).to(cuda), torch.from_numpy(side).to(cuda),
            torch.from_numpy(tables).to(cuda),
            torch.from_numpy(ek.lookahead_tables(tables)).to(cuda), R, hv,
            mcus_x, mcus_y, B, nsegs]
    err = _k2_equal(args)
    assert int(err[0]) == 1 and not err[B * nsegs:].any()


def test_k2_rejects_bad_input(cuda, jpgs):
    args = _k2_args(jpgs, 4, cuda)
    for i, bad in ((0, args[0].to(torch.int64)), (0, args[0].T.contiguous().T),
                   (3, args[3].cpu()), (3, args[3][:, :100])):
        a = list(args)
        a[i] = bad
        with pytest.raises(ValueError):
            ek.decode_segments_into(*a)


def test_decoder_gpu_vs_cpu(cuda, jpgs):
    before = dict(jb.ROUTES)
    gpu = port.Decoder(device="cuda").decode(jpgs)
    assert jb.ROUTES["idx"] - before["idx"] == len(jpgs)
    cpu = port.Decoder(device="cpu").decode(jpgs)
    for g, c in zip(gpu, cpu):
        assert g.device.type == "cuda"
        assert int((g.array.cpu().int() - c.array.int()).abs().max()) <= 1


def test_decoder_gpu_idx_equals_host_route(cuda, jpgs):
    params = port.DecodeParams()
    idx = jb.decode_batch_cuda(jpgs, params, cuda)
    host = jb.decode_batch_cuda(jpgs, params, cuda, device_entropy=False)
    for a, b in zip(idx, host):
        assert torch.equal(a.array, b.array)


def test_decoder_gpu_bitexact_equals_cpu(cuda, jpgs):
    opt = "cuda_jpeg_hybrid_decoder:bitexact=true"
    gpu = port.Decoder(device="cuda", options=opt).decode(jpgs)
    cpu = port.Decoder(device="cpu", options=opt).decode(jpgs)
    for g, c in zip(gpu, cpu):
        assert torch.equal(g.array.cpu(), c.array)


def _k3_equal(kind, inputs, before, geom):
    """K3 against its plain version from the same planes; err."""
    mine = [p.clone() for p in before]
    want = [p.clone() for p in before]
    n = ek.decode_prog_scan_into.launches
    err = ek.decode_prog_scan_into(kind, *inputs, mine, *geom)
    assert ek.decode_prog_scan_into.launches == n + 1
    err_p = ek.decode_prog_scan_into_plain(kind, *inputs[:3], want, *geom)
    torch.cuda.synchronize()
    for a, b in zip(mine, want):
        assert torch.equal(a, b)
    assert torch.equal(err, err_p)
    return err


@pytest.fixture(scope="module")
def k3_scans(cuda):
    """Every scan of one committed progressive stream: [(kind, inputs on
    the card, the planes before the scan, geometry)]."""
    data = torch_corpus.progressive_streams()[0]
    seen = []
    real = de.decode_prog_scan_into

    def capture(kind, words, side, tables, look, planes, *geom):
        seen.append((kind, (words, side, tables, look),
                     [p.clone() for p in planes], geom))
        return real(kind, words, side, tables, look, planes, *geom)

    de.decode_prog_scan_into = capture
    try:
        de.decode_progressive_device(parse_jpeg_structure(data), data, cuda)
    finally:
        de.decode_prog_scan_into = real
    torch.cuda.synchronize()
    return seen


@pytest.mark.parametrize("kind", ["dc", "dcref", "ac", "acref"])
def test_k3_kernel_vs_plain(k3_scans, kind):
    runs = [r for r in k3_scans if r[0] == kind]
    assert runs
    for n, (_kind, inputs, before, geom) in enumerate(runs):
        assert not _k3_equal(kind, inputs, before, geom).any()
        bad = (inputs[0].clone(),) + inputs[1:]
        bad[0][1:5, 3] = -1  # a corrupted lane: no code is sixteen 1 bits
        err = _k3_equal(kind, bad, before, geom)
        if n == 0 and kind in ("dc", "ac"):
            assert int(err[3]) == 1


@pytest.mark.parametrize("kind,ss,se,al", [
    ("dc", 0, 0, 1), ("dc", 0, 0, 0), ("dcref", 0, 0, 0), ("dcref", 0, 0, 15),
    ("ac", 1, 5, 2), ("ac", 7, 7, 0), ("ac", 1, 63, 1), ("ac", 6, 63, 0),
    ("acref", 1, 5, 1), ("acref", 9, 9, 0), ("acref", 1, 63, 0),
    ("acref", 6, 63, 2)])
@pytest.mark.parametrize("hv,mcus_x,mcus_y,R,S", [
    ([(2, 2), (1, 1), (1, 1)], 5, 3, 4, 128),  # 4:2:0, a short last lane
    ([(1, 1)], 7, 5, 3, 13),                   # 1 component, S off the CTA
    ([(2, 1), (1, 1), (1, 1)], 3, 4, 20, 3),   # one lane holds every unit
])
def test_k3_ragged_shapes_on_random_bits(cuda, kind, ss, se, al, hv, mcus_x,
                                         mcus_y, R, S):
    """Random words on planes of random history (every error path is met):
    lanes of 0 units, lanes that claim more units than the grid has, a true
    block grid narrower than its plane, a band of one position, S that is
    no multiple of the lanes a CTA serves. Planes and err equal the plain
    version's."""
    rng = np.random.default_rng(ss * 64 + se + S)
    dc = ss == 0
    comp = len(hv) - 1 if not dc else 0
    h, v = hv[comp]
    grid = None if dc else (mcus_x * h - (h > 1), mcus_y * v)
    units = mcus_x * mcus_y if dc else grid[0] * grid[1]
    assert units <= S * R
    nsegs = -(-units // R)
    std = _std_tables(len(hv))
    tables = np.ascontiguousarray(std[:, 0] if kind == "dc" else std[:1, 1])
    words = rng.integers(-2**31, 2**31, (48, S), dtype=np.int64).astype(np.int32)
    side = np.zeros((6, S), np.int32)
    side[0, :nsegs] = R  # the last lane claims units past the grid
    if nsegs > 2:
        side[0, 1] = 0
    side[1] = rng.integers(0, 32, S)
    if kind == "dc":
        side[2:6] = rng.integers(-300, 300, (4, S))
    planes = []
    for ph, pv in hv:
        p = rng.integers(-40, 40, (mcus_y * pv, mcus_x * ph, 64))
        p[rng.random(p.shape) < 0.6] = 0
        planes.append(torch.from_numpy(p.astype(np.int16)).to(cuda))
    inputs = (torch.from_numpy(words).to(cuda), torch.from_numpy(side).to(cuda),
              torch.from_numpy(tables).to(cuda),
              torch.from_numpy(ek.lookahead_tables(tables)).to(cuda))
    _k3_equal(kind, inputs, planes, (R, hv, mcus_x, comp, grid, ss, se, al))


def test_k3_rejects_bad_planes(cuda, k3_scans):
    kind, inputs, before, geom = next(r for r in k3_scans if r[0] == "ac")
    wrong_type = [p.to(torch.int32) for p in before]
    strided = [p.permute(1, 0, 2).contiguous().permute(1, 0, 2)
               for p in before]
    on_host = [p.cpu() for p in before]
    for planes in (wrong_type, strided, on_host, before[:1]):
        with pytest.raises(ValueError):
            ek.decode_prog_scan_into(kind, *inputs, planes, *geom)


def test_progressive_route_gpu_vs_cpu(cuda):
    data = torch_corpus.progressive_streams()[1]
    frame = parse_jpeg_structure(data)
    gpu = de.decode_progressive_device(frame, data, cuda)
    cpu = de.decode_progressive_device(frame, data, "cpu")
    for g, c in zip(gpu, cpu):
        assert g.device.type == "cuda" and torch.equal(g.cpu(), c)
    img = jb.decode_progressive(data, cuda)
    want = jb.decode_progressive(data, "cpu")
    assert int((img.cpu().int() - want.int()).abs().max()) <= 1


def test_decoder_gpu_dri_route_equals_host_route(cuda):
    photos = [make_photo(120, 168, seed=s) for s in range(20)]
    datas = [torch_corpus.encode_dri(p, 85, 11) for p in photos]
    params = port.DecodeParams()
    before = dict(jb.ROUTES)
    dri = jb.decode_batch_cuda(datas, params, cuda)
    assert jb.ROUTES["dri"] - before["dri"] == len(datas)
    assert jb.ROUTES["reissued"] == before["reissued"]
    host = jb.decode_batch_cuda(datas, params, cuda, device_entropy=False)
    for a, b in zip(dri, host):
        assert a.array.device.type == "cuda"
        assert torch.equal(a.array, b.array)
    cpu = port.Decoder(device="cpu").decode(datas[:4])
    for g, c in zip(dri, cpu):
        assert int((g.array.cpu().int() - c.array.int()).abs().max()) <= 1


# ------------------------------------------- encode, resize, pipeline, CLI

def _photos_on(cuda, n=20, h=120, w=168):
    photos = [make_photo(h, w, seed=s) for s in range(n)]
    return photos, [torch.from_numpy(p).to(cuda) for p in photos]


@pytest.mark.parametrize("css", ["444", "422", "420", "440", "411", "gray",
                                 "uint16"])
def test_encode_pixels_gpu_vs_cpu(cuda, css):
    """The card's coefficients against the CPU's: at most 1 on fewer than
    1% of entries (the reference's bar between its backends)."""
    from nvimagecodec_tpu_torch.codecs.jpeg import batch_encode as be
    from nvimagecodec_tpu_torch.codecs.jpeg.encode import encode_pixels

    imgs = np.stack([make_photo(121, 203, seed=s) for s in range(4)])
    if css == "gray":
        imgs = imgs[..., 0].copy()
    if css == "uint16":
        imgs = (imgs.astype(np.uint16) << 4) | (imgs >> 4)
    params = port.EncodeParams(
        quality=85,
        chroma_subsampling=css if css not in ("gray", "uint16") else "420")
    frame = be.bucket_frame(imgs.shape[1:], params,
                            12 if css == "uint16" else 8)
    want = encode_pixels(imgs, frame, "cpu")
    for src in (imgs, torch.from_numpy(imgs).to(cuda)):
        got = encode_pixels(src, frame, cuda)
        for g, w in zip(got, want):
            assert g.device.type == "cuda" and g.dtype == torch.int32
            d = (g.cpu() - w).abs()
            assert int(d.max()) <= 1 and float((d > 0).double().mean()) < 0.01


def test_encoder_gpu_takes_cuda_tensors_without_host_copy(cuda, monkeypatch):
    from nvimagecodec_tpu_torch.codecs.jpeg import batch_encode as be

    photos, tensors = _photos_on(cuda)
    copies = []
    real = be.host_array
    monkeypatch.setattr(be, "host_array",
                        lambda img: (copies.append(1), real(img))[1])
    params = port.EncodeParams(quality=85, chroma_subsampling="420")
    before = dict(be.ROUTES)
    enc = port.Encoder(device="cuda")
    streams = enc.encode(tensors, "jpeg", params)
    assert be.ROUTES["device"] - before["device"] == len(tensors)
    assert copies == []
    monkeypatch.undo()
    back = port.Decoder(device="cuda").decode(streams)
    host = port.Encoder(device="cpu").encode(photos, "jpeg", params)
    want = port.Decoder(device="cpu").decode(host)
    for t, b, w in zip(tensors, back, want):
        assert b.device.type == "cuda"
        mse = float(((b.array.float() - t.float()) ** 2).mean())
        assert 10 * np.log10(255 ** 2 / mse) > 33
        # the card's stream against the CPU's: quantizer boundary effects
        assert int((b.array.cpu().int() - w.array.int()).abs().max()) <= 2
    # host images, a mixed bucket and a single image take the same route
    mixed = enc.encode([photos[0], tensors[1], tensors[2].cpu()], "jpeg",
                       params)
    assert all(d is not None for d in mixed)
    # the library's product may round a boundary case otherwise at another
    # batch size: the same pixels within 2, not the same bytes
    one = port.Decoder(device="cuda").decode(
        enc.encode(tensors[0], "jpeg", params))
    assert int((one.array.int() - back[0].array.int()).abs().max()) <= 2


def test_encoder_gpu_uint16_gray_and_rejected_samples(cuda):
    photos, tensors = _photos_on(cuda, n=3, h=64, w=80)
    deep = ((tensors[0].int() << 4) | (tensors[0].int() >> 4)).to(
        torch.int16).view(torch.uint16)
    batch = [deep, tensors[1][..., 0].contiguous(),
             tensors[2].float(), tensors[2]]
    out = port.Encoder(device="cuda").encode(
        batch, "jpeg", port.EncodeParams(quality=90,
                                         chroma_subsampling="420"))
    assert [d is None for d in out] == [False, False, True, False]
    dec = port.Decoder(device="cuda")
    back = dec.decode(out[0], port.DecodeParams(allow_any_depth=True))
    assert back.dtype == np.uint16 and back.shape == (64, 80, 3)
    assert dec.decode(out[1]).shape == (64, 80)


def test_encoder_gpu_host_route_gives_the_cpu_bytes(cuda):
    photos, tensors = _photos_on(cuda, n=4)
    params = port.EncodeParams(quality=88, chroma_subsampling="420")
    opt = "cuda_jpeg_hybrid_encoder:device_stage=false"
    got = port.Encoder(device="cuda", options=opt).encode(tensors, "jpeg",
                                                         params)
    want = port.Encoder(device="cpu", options=opt).encode(photos, "jpeg",
                                                          params)
    assert got == want


def test_encoder_gpu_refuses_tf32(cuda):
    """The encode's product is fdct_quant_blocks, not a matmul, so TF32 no
    longer needs refusing: with allow_tf32 on, encode_batch_cuda and the
    Encoder give the bytes they give with it off."""
    from nvimagecodec_tpu_torch.codecs.jpeg import batch_encode as be

    _, tensors = _photos_on(cuda, n=8)
    params = port.EncodeParams(quality=85, chroma_subsampling="420")

    def batch():
        return [r.data for r in be.encode_batch_cuda(tensors, params, cuda)]

    want = batch()
    assert None not in want
    want_enc = port.Encoder(device="cuda").encode(tensors, "jpeg", params)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        assert batch() == want
        assert port.Encoder(device="cuda").encode(tensors, "jpeg",
                                                  params) == want_enc
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.parametrize("interp", ["bilinear", "bicubic", "lanczos"])
@pytest.mark.parametrize("dtype", ["uint8", "uint16", "float32"])
def test_resize_gpu_vs_cpu(cuda, interp, dtype):
    """Within 1 of the CPU (which equals the reference's numpy path) for
    integer images; 1e-3 of the range for float32."""
    from nvimagecodec_tpu_torch.ops import resize as R

    rng = np.random.default_rng(7)
    a = rng.integers(0, 256 if dtype == "uint8" else 65536,
                     (3, 61, 77, 3)).astype(
                         np.float32 if dtype == "float32" else dtype)
    t = torch.from_numpy(a)
    for oh, ow in [(24, 80), (128, 31)]:
        want = R.resize(t, oh, ow, interp)
        got = R.resize(t.to(cuda), oh, ow, interp)
        assert got.device.type == "cuda" and got.dtype == want.dtype
        g = got.cpu()
        if dtype == "uint16":
            g, want = g.view(torch.int16).int() & 0xFFFF, \
                want.view(torch.int16).int() & 0xFFFF
        d = float((g.double() - want.double()).abs().max())
        assert d <= (65536 * 1e-3 if dtype == "float32" else 1)
    for k in range(4):
        assert torch.equal(R.rotate90(t.to(cuda), k).cpu(), R.rotate90(t, k))
    assert torch.equal(R.flip(t.to(cuda), True, True).cpu(),
                       R.flip(t, True, True))


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_pipeline_gpu_equals_unpipelined(cuda, jpgs, depth):
    from nvimagecodec_tpu_torch.pipeline import decode_batches

    dec = port.Decoder(device="cuda")
    batches = [jpgs, jpgs[:16], jpgs[2:], jpgs[:3]]
    want = [dec.decode(b) for b in batches]
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    got = []
    for batch in decode_batches(batches, decoder=dec, depth=depth):
        # a consumer on another stream reads without further synchronisation
        with torch.cuda.stream(side):
            got.append([im.array.clone() for im in batch])
    torch.cuda.synchronize()
    for g_batch, w_batch in zip(got, want):
        assert len(g_batch) == len(w_batch)
        for g, w in zip(g_batch, w_batch):
            assert torch.equal(g, w.array)


def test_cli_gpu(cuda, jpgs, tmp_path):
    import subprocess
    import sys

    src = tmp_path / "in"
    src.mkdir()
    for i, d in enumerate(jpgs[:4]):
        (src / f"p{i}.jpg").write_bytes(d)
    root = __file__.rsplit("/tests/", 1)[0]

    def run(*argv):
        r = subprocess.run([sys.executable, "-m",
                            "nvimagecodec_tpu_torch.cli", *argv],
                           capture_output=True, text=True, cwd=root,
                           timeout=600)
        assert r.returncode == 0, r.stderr[-2000:]
        return r.stdout

    assert "processed 4/4" in run("imtrans", "-i", str(src), "-c", "jpeg",
                                  "-o", str(tmp_path / "out"))
    run("improc", "-i", str(src / "p0.jpg"), "--resize", "64x48", "--crop",
        "8,8,100,90", "-c", "png", "-o", str(tmp_path / "r.png"))
    dec = port.Decoder(device="cuda")
    for i in range(4):
        assert dec.read(str(tmp_path / "out" / f"p{i}.jpg")).shape == \
            (120, 168, 3)
    assert dec.read(str(tmp_path / "r.png")).shape == (48, 64, 3)
    assert "cuda:0" in run("imtrans", "-i", "x", "--list-devices")


# -- JPEG2000: the device pixel stage on the card ---------------------------
_J2K_CASES = {
    "reversible": (dict(reversible=True, levels=5), 0),
    "irreversible": (dict(reversible=False, quality=85, levels=5), 1),
    "tiles": (dict(reversible=True, levels=3, tile_size=128), 0),
    "tiles_irrev": (dict(reversible=False, quality=80, levels=3,
                         tile_size=128), 1),
    "ht": (dict(reversible=True, levels=4, ht=True), 0),
    "odd_size": (dict(reversible=True, levels=4), 0),
}


@pytest.mark.parametrize("name", sorted(_J2K_CASES))
def test_j2k_device_stage_gpu_vs_cpu(cuda, name):
    kw, tol = _J2K_CASES[name]
    img = (make_photo(333, 517, seed=3) if name == "odd_size"
           else make_photo(256, 384, seed=3))
    data = j2k.encode_j2k(img, stream_type="j2k", **kw)
    host = j2k.decode_j2k(data, device=None)
    before = dict(j2k.ROUTES)
    got = j2k.decode_j2k(data, device=cuda)
    assert got.is_cuda and got.dtype == torch.uint8 and got.is_contiguous()
    route = "device_tiles" if "tile_size" in kw else "device"
    assert j2k.ROUTES[route] == before[route] + 1
    d = (got.cpu().numpy().astype(int) - host.astype(int))
    assert np.abs(d).max() <= tol
    if tol == 0:
        assert np.array_equal(host, img)
    cpu_stage = j2k.decode_j2k(data, device=torch.device("cpu"))
    assert np.abs(got.cpu().numpy().astype(int)
                  - cpu_stage.numpy().astype(int)).max() <= tol


@pytest.mark.parametrize("dtype,gray", [("uint16", False), ("uint8", True),
                                        ("uint16", True)])
def test_j2k_device_stage_gpu_depths_and_gray(cuda, dtype, gray):
    img = make_photo(200, 300, seed=5)
    if dtype == "uint16":
        img = img.astype(np.uint16) * 257 + 3
    if gray:
        img = img[:, :, 0]
    data = j2k.encode_j2k(img, reversible=True, levels=4)
    got = j2k.decode_j2k(data, device=cuda)
    assert got.is_cuda and str(got.dtype) == f"torch.{dtype}"
    assert np.array_equal(got.cpu().numpy(), img)


@pytest.mark.parametrize("reversible", [True, False])
def test_dwt_gpu_vs_cpu(cuda, reversible):
    rng = np.random.default_rng(2)
    x = rng.integers(-500, 500, (2, 3, 97, 131)).astype(
        np.int32 if reversible else np.float32)
    for origin in ((0, 0), (3, 5)):
        LLc, bc = dwt_ops.dwt2d(torch.from_numpy(x), 3, reversible, origin)
        LLg, bg = dwt_ops.dwt2d(torch.from_numpy(x).to(cuda), 3, reversible,
                                origin)
        yc = dwt_ops.idwt2d(LLc, bc, (97, 131), reversible, origin)
        yg = dwt_ops.idwt2d(LLg, bg, (97, 131), reversible, origin)
        assert yg.is_cuda
        if reversible:
            assert torch.equal(LLg.cpu(), LLc) and torch.equal(yg.cpu(), yc)
            assert np.array_equal(yg.cpu().numpy(), x)
        else:
            assert (LLg.cpu() - LLc).abs().max() <= 1e-3 * LLc.abs().max()
            assert (yg.cpu() - yc).abs().max() <= 1e-3 * 500


def test_j2k_decoder_gpu_routes_and_mixed_batch(cuda, jpgs, monkeypatch):
    """Decoder(device="cuda"): a full-size stream takes the device stage and
    comes back on the card, a small one and a partial grid stay on the host;
    to_device puts the whole mixed batch on the card."""
    big = make_photo(512, 512, seed=1)
    small = make_photo(100, 150, seed=2)
    streams = [
        jpgs[0],
        j2k.encode_j2k(big, reversible=True, levels=5),
        j2k.encode_j2k(small, reversible=True, levels=2, tile_size=64),
        port.Encoder(device="cpu").encode(small, "png"),
        j2k.encode_j2k(small, reversible=True, levels=2),
    ]
    dec = port.Decoder(device="cuda")
    before = dict(j2k.ROUTES)
    out = dec.decode(streams)
    took = {k: j2k.ROUTES[k] - before[k] for k in before}
    assert took == {"device": 1, "device_tiles": 0, "host": 2}
    assert [o.array.is_cuda for o in out] == [True, True, False, False,
                                              False]
    assert np.array_equal(out[1].cpu().array.numpy(), big)
    moved = dec.decode(streams, to_device=True)
    assert all(o.array.is_cuda for o in moved)
    for o, want in zip(moved[1:], (big, small, small, small)):
        assert np.array_equal(o.array.cpu().numpy(), want)
    off = port.Decoder(device="cuda", options=(
        "cuda_jpeg2k_hybrid_decoder:device_pixel_stage=false"))
    o = off.decode(streams[1])
    assert not o.array.is_cuda and np.array_equal(o.array.numpy(), big)


def test_j2k_device_failure_raises_on_gpu(cuda, monkeypatch):
    data = j2k.encode_j2k(make_photo(512, 512, seed=1), reversible=True)

    def boom(*a, **k):
        raise RuntimeError("CUDA error: launch failed")

    monkeypatch.setattr(dwt_ops, "idwt2d", boom)
    with pytest.raises(j2k.J2kDeviceStageError, match="launch failed"):
        port.Decoder(device="cuda").decode([data, data])


def test_j2k_failure_on_the_decoded_cuda_tensor_raises(cuda, monkeypatch):
    """The plugin's narrowing runs on the decoded CUDA tensor: its failure
    is the device stage's and is raised, not answered by another decoder."""
    from nvimagecodec_tpu_torch.codecs import jpeg2000 as j2k_plugin
    from nvimagecodec_tpu_torch.codecs import system_codecs

    deep = make_photo(512, 512, seed=1).astype(np.uint16) * 257
    data = j2k.encode_j2k(deep, reversible=True)

    def boom(*a, **k):
        raise RuntimeError("CUDA error: launch failed")

    answered = []
    monkeypatch.setattr(j2k_plugin, "widen_uint16", boom)
    monkeypatch.setattr(system_codecs.OpjJpeg2kDecoder, "decode_batch",
                        lambda self, *a: answered.append(a))
    with pytest.raises(j2k.J2kDeviceStageError, match="launch failed"):
        port.Decoder(device="cuda").decode([data, data])
    assert answered == []


def test_j2k_encoder_gpu_takes_cuda_tensors(cuda):
    # at the device stage's floor, so the decode comes back on the card
    img = make_photo(512, 512, seed=4)
    p = port.EncodeParams(jpeg2k=port.Jpeg2kEncodeParams(reversible=True))
    data = port.Encoder(device="cuda").encode(
        torch.from_numpy(img).to(cuda), "jp2", p)
    assert data == port.Encoder(device="cpu").encode(img, "jp2", p)
    back = port.Decoder(device="cuda").decode(data)
    assert back.array.is_cuda
    assert np.array_equal(back.array.cpu().numpy(), img)


# ---------------------------------------- fdct_quant_blocks, several devices

def test_fdct_kernel_vs_plain_and_batch_independent(cuda):
    from nvimagecodec_tpu_torch.codecs.jpeg.encode import quant_matrix

    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.integers(-128, 128, (5000, 64))
                         .astype(np.float32)).to(cuda)
    M = quant_matrix(quality_scaled_quant(STD_CHROMA_QUANT, 85), cuda)
    before = kernels.fdct_quant_blocks.launches
    got = kernels.fdct_quant_blocks(x, M)
    assert kernels.fdct_quant_blocks.launches == before + 1
    d = (got - kernels.fdct_quant_blocks_plain(x, M)).abs()
    assert int(d.max()) <= 1 and float((d > 0).double().mean()) < 0.01
    for lo, n in ((0, 1), (3, 7), (129, 1000)):
        assert torch.equal(kernels.fdct_quant_blocks(
            x[lo:lo + n].contiguous(), M), got[lo:lo + n])


# The bits of fdct_quant_blocks on the card, pinned. Both digests were taken
# from the kernel's first design (one staged tile at a time in a grid-stride
# loop); every later design keeps the fixed fmaf order and must give them.
FDCT_BLOCKS_SHA256 = ("8549488e15ddb8bf795a84860b346e47"
                      "44e3b4f72870fc14ea79f5f8b33f3b04")
FDCT_STREAMS_SHA256 = ("2199f3fb32ec93643442c3e98bd6a8bd"
                       "411f849a4f6c9489360e54d5fa8c7d99")
# blocks of a launch that wraps the kernel's ring of tile stages once on
# every SM of an H100, plus one: 132 SMs x 4 stages (kStages in
# csrc/fdct.cu) x 128-block tiles + 1
FDCT_RING_BLOCKS = 132 * 4 * 128 + 1


def fdct_digest_inputs(device):
    """[(samples, matrix)] of the blocks digest: 5000 8-bit blocks (integers
    in [-128, 128)) then 5000 12-bit ones ([-2048, 2048)), both from
    default_rng(12), each under the chroma q85 and the luma q50 matrix."""
    from nvimagecodec_tpu_torch.codecs.jpeg.encode import quant_matrix

    rng = np.random.default_rng(12)
    xs = [torch.from_numpy(rng.integers(lo, -lo, (5000, 64))
                           .astype(np.float32)).to(device)
          for lo in (-128, -2048)]
    Ms = [quant_matrix(quality_scaled_quant(STD_CHROMA_QUANT, 85), device),
          quant_matrix(quality_scaled_quant(STD_LUMA_QUANT, 50), device)]
    return [(x, M) for M in Ms for x in xs]


def fdct_blocks_digest(fdct, device) -> str:
    """SHA-256 of fdct(x, M)'s int32 coefficients over `fdct_digest_inputs`,
    in order."""
    h = hashlib.sha256()
    for x, M in fdct_digest_inputs(device):
        h.update(fdct(x, M).cpu().numpy().astype("<i4").tobytes())
    return h.hexdigest()


def fdct_streams_digest(encoder, device) -> str:
    """SHA-256 of the 8 JPEG streams `encoder` gives for `_photos_on(n=8)` at
    q85 4:2:0, each after its length in 4 little-endian bytes."""
    _photos, tensors = _photos_on(device, n=8)
    params = port.EncodeParams(quality=85, chroma_subsampling="420")
    h = hashlib.sha256()
    for data in encoder.encode(tensors, "jpeg", params):
        h.update(len(data).to_bytes(4, "little") + data)
    return h.hexdigest()


def test_fdct_gives_the_pinned_coefficients(cuda):
    assert fdct_blocks_digest(kernels.fdct_quant_blocks,
                              cuda) == FDCT_BLOCKS_SHA256


def test_encoder_gives_the_pinned_streams(cuda):
    assert fdct_streams_digest(port.Encoder(device="cuda"),
                               cuda) == FDCT_STREAMS_SHA256


@pytest.mark.parametrize("n", [1, 127, 128, 129, FDCT_RING_BLOCKS])
@pytest.mark.parametrize("aligned", [True, False])
def test_fdct_edges_equal_a_slice_of_a_larger_launch(cuda, n, aligned):
    """A launch of n blocks gives the coefficients those blocks get inside a
    larger launch, from a 16-byte aligned source or from one 4 bytes past
    it, and stays within 1 of the plain version on fewer than 1% of
    entries."""
    from nvimagecodec_tpu_torch.codecs.jpeg.encode import quant_matrix

    rng = np.random.default_rng(n)
    big = max(5000, n + 1000)
    x = torch.from_numpy(rng.integers(-128, 128, (big, 64))
                         .astype(np.float32)).to(cuda)
    M = quant_matrix(quality_scaled_quant(STD_LUMA_QUANT, 85), cuda)
    whole = kernels.fdct_quant_blocks(x, M)
    lo = 3
    part = x[lo:lo + n].contiguous()
    if not aligned:
        buf = torch.empty(n * 64 + 1, dtype=torch.float32, device=cuda)
        part = buf[1:].view(n, 64)
        part.copy_(x[lo:lo + n])
        assert part.data_ptr() % 16 == 4
    got = kernels.fdct_quant_blocks(part, M)
    assert torch.equal(got, whole[lo:lo + n])
    d = (got - kernels.fdct_quant_blocks_plain(part, M)).abs()
    assert int(d.max()) <= 1 and float((d > 0).double().mean()) < 0.01


def _cuda_mesh(cuda, dp=1, sp=1):
    from nvimagecodec_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(dp=dp, sp=sp, devices=[cuda] * (dp * sp))


def test_decoder_mesh_on_one_card_is_bit_exact(cuda, jpgs):
    """Decoder(mesh=) with dp=2 over the one card twice: every image equals
    the unsharded decode, idx and dri buckets both on the device route."""
    dri = torch_corpus.dri_streams()[:4] * 8
    for streams in (jpgs * 2, dri):  # shards of 20 and 16 images
        want = port.Decoder(device="cuda").decode(streams)
        k2 = ek.decode_segments_into.launches
        before = dict(jb.ROUTES)
        got = port.Decoder(mesh=_cuda_mesh(cuda, 2)).decode(streams)
        assert ek.decode_segments_into.launches == k2 + 2  # one a shard
        assert jb.ROUTES["host"] == before["host"]
        for a, b in zip(want, got):
            assert b.array.is_cuda and torch.equal(a.array, b.array)


def test_one_image_alone_gives_its_batch_bytes(cuda):
    """The encode device stage sums every coefficient in one order, so an
    image encoded alone gives the bytes it gets inside a batch of 256."""
    photos, tensors = _photos_on(cuda, n=8)
    batch = [tensors[j % 8] for j in range(256)]
    params = port.EncodeParams(quality=85, chroma_subsampling="420")
    enc = port.Encoder(device="cuda")
    together = enc.encode(batch, "jpeg", params)
    for j in range(8):
        assert enc.encode(tensors[j], "jpeg", params) == together[j]
        assert together[j + 8] == together[j]


def test_sharded_encode_gives_the_unsharded_bytes(cuda):
    from nvimagecodec_tpu_torch.core.scheduler import GenericEncoder

    photos, tensors = _photos_on(cuda, n=20)
    params = port.EncodeParams(quality=85, chroma_subsampling="420")
    want = port.Encoder(device="cuda").encode(tensors, "jpeg", params)
    for dp in (2, 3):
        enc = GenericEncoder(registry=port.port_registry(),
                             mesh=_cuda_mesh(cuda, dp))
        got = [r.data for r in enc.encode_batch(tensors, [None] * 20,
                                                "jpeg", params)]
        assert got == want


def test_j2k_mesh_on_one_card_is_bit_exact(cuda):
    img = make_photo(256, 256, seed=6)
    for kw in (dict(levels=5), dict(levels=3, tile_size=64)):
        data = j2k.encode_j2k(img, reversible=True, **kw)
        for sp in (2, 4):
            got = j2k.decode_j2k(data, device=None,
                                 mesh=_cuda_mesh(cuda, 1, sp))
            assert got.is_cuda and np.array_equal(got.cpu().numpy(), img)


def test_j2k_mesh_counts_the_bytes_each_device_copies(cuda, monkeypatch):
    """imgcodec.jpeg2k.h2d_bytes on the sharded paths adds what each device
    copies from the host: its tiles, or its rows, which sum to the
    unsharded upload of the subbands (Tier-1 on the host: on the card the
    unsharded decode uploads its code-block table and codestream instead);
    and where coarse levels run replicated (7 levels of 256 rows over
    sp=4), their subbands once a device on top."""
    from nvimagecodec_tpu_torch.core import trace

    monkeypatch.setattr(j2k, "tier1_on_device", lambda *a: False)

    def h2d(data, mesh):
        trace.start_collect()
        j2k.decode_j2k(data, device=cuda if mesh is None else None,
                       mesh=mesh)
        torch.cuda.synchronize()
        return trace.stop_collect()["counters"]["imgcodec.jpeg2k.h2d_bytes"]

    img = make_photo(256, 256, seed=6)
    for kw, more in ((dict(levels=5), False),
                     (dict(levels=3, tile_size=64), False),
                     (dict(levels=7), True)):
        data = j2k.encode_j2k(img, reversible=True, **kw)
        one = h2d(data, None)
        got = h2d(data, _cuda_mesh(cuda, 1, 4))
        assert got > one if more else got == one, (kw, got, one)


def test_a_second_card_runs_its_own_shard(cuda):
    """With two cards, the dp=2 mesh of make_mesh() puts a shard on cuda:1:
    its kernels launch there (under torch.cuda.device of the shard), its
    images come back there, and everything equals the one-card decode and
    encode; J2K rows over sp=2 exchange halos between the cards."""
    from nvimagecodec_tpu_torch.core.scheduler import GenericEncoder
    from nvimagecodec_tpu_torch.parallel.mesh import make_mesh

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    mesh = make_mesh(dp=2, devices=["cuda:0", "cuda:1"])
    streams = [encode_jpeg(make_photo(120, 168, seed=s), port.EncodeParams(
        quality=85, chroma_subsampling="420")) for s in range(32)]
    want = port.Decoder(device="cuda:0").decode(streams)
    got = port.Decoder(mesh=mesh).decode(streams)
    torch.cuda.synchronize()
    assert {str(o.array.device) for o in got} == {"cuda:0", "cuda:1"}
    for a, b in zip(want, got):
        assert torch.equal(a.array, b.array.to("cuda:0"))
    params = port.EncodeParams(quality=85, chroma_subsampling="420")
    tensors = [o.array for o in want]
    enc = GenericEncoder(registry=port.port_registry(), mesh=mesh)
    assert [r.data for r in enc.encode_batch(tensors, [None] * 32, "jpeg",
                                             params)] == port.Encoder(
        device="cuda:0").encode(tensors, "jpeg", params)
    img = make_photo(256, 256, seed=6)
    data = j2k.encode_j2k(img, reversible=True, levels=5)
    out = j2k.decode_j2k(data, device=None,
                         mesh=make_mesh(dp=1, sp=2,
                                        devices=["cuda:0", "cuda:1"]))
    assert out.device == torch.device("cuda:0")
    assert np.array_equal(out.cpu().numpy(), img)
