"""Card tests of the CUDA port: the hand-written kernels against their plain
PyTorch versions, and the Decoder (idx and dri routes) and the progressive
route on the GPU against the same on the CPU.
They need a CUDA device and skip without one. On the GPU machine:

    python -m pytest tests/test_torch_gpu.py -m gpu -q
"""
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
    quality_scaled_quant,
)
from nvimagecodec_tpu_torch.codecs.jpeg import batch as jb
from nvimagecodec_tpu_torch.codecs.jpeg import device_entropy as de
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


def _k2_inputs(jpgs, n, dev):
    frames = {i: jb.parse_jpeg_structure(d) for i, d in enumerate(jpgs[:n])}
    raws = dict(enumerate(jpgs[:n]))
    _kind, _key, R, nsegs = jb.route_plan(frames[0])
    ok, bad, bad_scan, words, side = jb.split_indexed(
        list(range(n)), frames, raws, R, nsegs, dev)
    assert len(ok) == n and not bad and not bad_scan
    R, comp_map, tables = ek.huffman_tables(frames[0], R)
    return words.to(dev), side.to(dev), torch.from_numpy(tables).to(dev), \
        R, comp_map


def test_k2_kernel_vs_plain(cuda, jpgs):
    words, side, tables, R, comp_map = _k2_inputs(jpgs, 5, cuda)
    words[3:7, 2] = -1  # a corrupted lane: no code is sixteen 1 bits
    out, err = ek.decode_segments(words, side, tables, R, comp_map)
    ref_out, ref_err = ek.decode_segments_plain(words, side, tables, R,
                                                comp_map)
    assert torch.equal(out, ref_out) and torch.equal(err, ref_err)
    assert int(err[2]) == 1


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


@pytest.fixture(scope="module")
def k3_scans(cuda):
    """Every scan of one committed progressive stream through K3 and its
    plain version on the same device inputs: [(kind, kernel, plain)]."""
    data = torch_corpus.progressive_streams()[0]
    seen = []
    real = de.decode_prog_scan

    def both(kind, words, side, tables, *rest):
        before = ek.decode_prog_scan.launches
        got = real(kind, words, side, tables, *rest)
        assert ek.decode_prog_scan.launches == before + 1
        want = ek.decode_prog_scan_plain(kind, words, side, tables, *rest)
        bad = words.clone()
        bad[1:5, 3] = -1  # a corrupted lane: no code is sixteen 1 bits
        seen.append((kind, got, want, real(kind, bad, side, tables, *rest),
                     ek.decode_prog_scan_plain(kind, bad, side, tables,
                                               *rest)))
        return got

    de.decode_prog_scan = both
    try:
        de.decode_progressive_device(parse_jpeg_structure(data), data, cuda)
    finally:
        de.decode_prog_scan = real
    torch.cuda.synchronize()
    return seen


@pytest.mark.parametrize("kind", ["dc", "dcref", "ac", "acref"])
def test_k3_kernel_vs_plain(k3_scans, kind):
    runs = [r for r in k3_scans if r[0] == kind]
    assert runs
    for _kind, got, want, got_bad, want_bad in runs:
        for a, b in zip(got + got_bad, want + want_bad):
            assert torch.equal(a, b)
        assert not got[1].any()
    if kind in ("dc", "ac"):
        assert int(runs[0][3][1][3]) == 1


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
