"""K2 (baseline Huffman decode) of the CUDA port against the JAX package.

On the CPU the K2 wrapper runs its plain PyTorch version, which is built on
`decode_segments_plain`, the TPU kernel's own contract. That must match the
Pallas kernel run in interpret mode (as tests/test_device_entropy.py runs
it) bit for bit, coefficients and error flags both, on index-scanned words
(the main path) and on restart-split words, and the stacks of
`decode_segments_into` must equal the pure-Python host decoder's
(tests/test_torch_entropy_into.py holds them against the reference's
reassembly).
"""
import numpy as np
import pytest
import torch

import oracle
from nvimagecodec_tpu.codecs.jpeg.device_entropy import (
    index_scan_batch,
    indexed_words_needed_batch,
    pack_indexed_batch,
    split_batch_segments,
)
from nvimagecodec_tpu.codecs.jpeg.entropy_py import decode_coefficients
from nvimagecodec_tpu.codecs.jpeg.headers import parse_jpeg_structure
from nvimagecodec_tpu.codecs.jpeg.pixel import ZIGZAG_NAT
from nvimagecodec_tpu.ops.pallas_entropy import decode_segments_device
from nvimagecodec_tpu_torch.ops import entropy_kernels as ek
from util import make_photo

CHROMA = ["420", "422", "444", "440", "411", "410", "gray"]


def _encode(ss, seed, restart_interval=0, q=88):
    img = make_photo(96, 144, seed=seed)
    if ss == "gray":
        return oracle.jpeg_encode(img[:, :, 0], q,
                                  restart_interval=restart_interval)
    return oracle.jpeg_encode(img, q, ss, restart_interval=restart_interval)


def _mcus(frame):
    mx = -(-frame.width // (8 * frame.hmax))
    my = -(-frame.height // (8 * frame.vmax))
    return mx, my


def _idx_words(datas):
    """Index-scan + pack a bucket the way the idx route does: one MCU row
    per lane. Returns (frame, words, side, R, nsegs)."""
    frames = [parse_jpeg_structure(d) for d in datas]
    f0 = frames[0]
    mx, my = _mcus(f0)
    idxs = list(range(len(datas)))
    scans, (arena, offs, dlens, bits, preds, _n) = index_scan_batch(
        frames, datas, idxs, 1, my, 2)
    assert all(scans[i] is not None for i in idxs)
    W = indexed_words_needed_batch(dlens, bits, my)
    B = len(datas)
    S = -(-B * my // 128) * 128
    words = np.zeros((W, S), np.uint32)
    start = np.zeros(S, np.int32)
    assert not pack_indexed_batch(arena, offs, dlens, bits, np.arange(B), my,
                                  words, W, start, 2)
    side = np.zeros((6, S), np.int32)
    side[0, :B * my] = mx
    side[1] = start
    side[2:6, :B * my] = (preds[:, :my * 4].reshape(B, my, 4)
                          .transpose(2, 0, 1).reshape(4, B * my))
    return f0, words, side, mx, my


def _dri_words(datas):
    frames = [parse_jpeg_structure(d) for d in datas]
    f0 = frames[0]
    max_words = max(f.scans[0].data_end - f.scans[0].data_start
                    for f in frames) // 4 + 8
    words, seg_mcus, nsegs, bad = split_batch_segments(frames, datas,
                                                       max_words)
    assert not bad
    side = np.zeros((6, words.shape[1]), np.int32)
    side[0] = seg_mcus
    return f0, words, side, f0.restart_interval, nsegs


def _into_args(frame, words, side, R):
    """`decode_segments_into`'s arguments up to mcus_y, on the CPU."""
    R2, _comp_map, tables = ek.huffman_tables(frame, R)
    mx, my = _mcus(frame)
    return (torch.from_numpy(words.view(np.int32)), torch.from_numpy(side),
            torch.from_numpy(tables),
            torch.from_numpy(ek.lookahead_tables(tables)), R2,
            [(c.h, c.v) for c in frame.components], mx, my)


def _both(frame, words, side, R):
    """(reference out, reference err, port out, port err) as numpy."""
    out_j, err_j = decode_segments_device(
        frame, words, side[0], interpret=True, R=R, start_bits=side[1],
        dc0=side[2:6])
    R2, comp_map, tables = ek.huffman_tables(frame, R)
    out_t, err_t = ek.decode_segments_plain(
        torch.from_numpy(words.view(np.int32)), torch.from_numpy(side),
        torch.from_numpy(tables), R2, comp_map)
    return (np.asarray(out_j), np.asarray(err_j), out_t.numpy(),
            err_t.numpy())


@pytest.mark.parametrize("ss", CHROMA)
def test_idx_words_bit_exact_vs_pallas(ss):
    frame, words, side, R, _ = _idx_words([_encode(ss, 5)])
    out_j, err_j, out_t, err_t = _both(frame, words, side, R)
    np.testing.assert_array_equal(out_t, out_j)
    np.testing.assert_array_equal(err_t, err_j)
    assert not err_t.any()


@pytest.mark.parametrize("ss", ["420", "444", "gray"])
def test_dri_words_bit_exact_vs_pallas(ss):
    f = parse_jpeg_structure(_encode(ss, 6))
    ri = _mcus(f)[0]
    frame, words, side, R, _ = _dri_words(
        [_encode(ss, s, restart_interval=ri) for s in (6, 7)])
    out_j, err_j, out_t, err_t = _both(frame, words, side, R)
    np.testing.assert_array_equal(out_t, out_j)
    np.testing.assert_array_equal(err_t, err_j)


def test_corrupted_lane_flags_match_pallas():
    frame, words, side, R, my = _idx_words([_encode("420", 8)])
    words = words.copy()
    words[2:6, 3] = 0xFFFFFFFF  # no Huffman code is sixteen 1 bits
    out_j, err_j, out_t, err_t = _both(frame, words, side, R)
    np.testing.assert_array_equal(out_t, out_j)
    np.testing.assert_array_equal(err_t, err_j)
    assert err_t[3] == 1 and err_t[:my].sum() >= 1


@pytest.mark.parametrize("ss", ["420", "411"])
def test_reassembled_vs_python_host_decoder(ss):
    datas = [_encode(ss, s) for s in (9, 10)]
    frame, words, side, R, nsegs = _idx_words(datas)
    comps, err = ek.decode_segments_into(*_into_args(frame, words, side, R),
                                         len(datas), nsegs)
    assert not err.any() and all(c.is_contiguous() for c in comps)
    nat = torch.from_numpy(np.argsort(ZIGZAG_NAT))
    for i, d in enumerate(datas):
        ref = decode_coefficients(parse_jpeg_structure(d), d)
        for c, r in zip(comps, ref):
            mine = c[i].index_select(-1, nat).numpy()
            np.testing.assert_array_equal(mine[:r.shape[0], :r.shape[1]], r)


def test_tables_tensor_layout():
    frame = parse_jpeg_structure(_encode("420", 11))
    R, comp_map, tables = ek.huffman_tables(frame, 9)
    assert R == 9 and comp_map == (0, 0, 0, 0, 1, 2)
    assert tables.dtype == np.int32 and tables.shape[:2] == (3, 2)
    # standard luma DC table: 12 values, codes of lengths 2..9
    assert tables[0, 0, 1] == -1 and tables[0, 0, 2] == 0
    np.testing.assert_array_equal(tables[0, 0, 34:46], np.arange(12))


def test_cpu_wrapper_uses_plain_version():
    frame, words, side, R, nsegs = _idx_words([_encode("444", 12)])
    args = _into_args(frame, words, side, R)
    before = ek.decode_segments_into.launches
    out, err = ek.decode_segments_into(*args, 1, nsegs)
    assert ek.decode_segments_into.launches == before
    plain = args[:3] + args[4:]  # the plain version reads no lookahead rows
    ref_out, ref_err = ek.decode_segments_into_plain(*plain, 1, nsegs)
    assert all(torch.equal(a, b) for a, b in zip(out, ref_out))
    assert torch.equal(err, ref_err)


def test_wrapper_refuses_other_devices():
    w = torch.zeros((4, 128), dtype=torch.int32, device="meta")
    s = torch.zeros((6, 128), dtype=torch.int32, device="meta")
    t = torch.zeros((1, 2, 35), dtype=torch.int32, device="meta")
    k = torch.zeros((2, 512), dtype=torch.int16, device="meta")
    with pytest.raises(ValueError):
        ek.decode_segments_into(w, s, t, k, 1, [(1, 1)], 1, 1, 1, 1)
