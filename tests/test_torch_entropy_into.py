"""The CUDA port's entropy entries that store where the pixel stage reads,
against the JAX package, on the CPU.

- `lookahead_tables`: every 16-bit peek decodes to the same (found, length,
  symbol) through the lookahead row (or its escape) as through the
  canonical walk.
- `decode_segments_into` (its plain version here): the stacks equal the
  Pallas K2 kernel in interpret mode followed by the reference's
  `reassemble_components`, exactly, and the flags equal the kernel's.
- `decode_prog_scan_into` (its plain version here): driven with the words
  the reference's `decode_progressive_device` builds, the planes equal the
  reference's after every scan, exactly, and the flags equal the Pallas K3
  kernel's in interpret mode.
"""
import sys

import numpy as np
import pytest
import torch

import oracle
import nvimagecodec_tpu.ops.pallas_entropy as pe
from nvimagecodec_tpu.codecs.jpeg.device_entropy import (
    decode_progressive_device as ref_decode_progressive_device,
    reassemble_components as ref_reassemble_components,
)
from nvimagecodec_tpu.codecs.jpeg.headers import parse_jpeg_structure
from nvimagecodec_tpu.ops.pallas_entropy import decode_segments_device
from nvimagecodec_tpu_torch.codecs.jpeg.headers import HuffTable
from nvimagecodec_tpu_torch.ops import entropy_kernels as ek
from test_torch_entropy import _dri_words, _encode, _idx_words, _into_args, _mcus
from test_torch_prog_entropy import _randomized_params
from util import make_photo


# (a) the lookahead rows against the canonical walk

def _table_rows(case):
    """Canonical rows [n, 34 + nv] for a named set of tables."""
    if case == "standard":
        frame = parse_jpeg_structure(_encode("420", 3))
        return ek.huffman_tables(frame, 1)[2].reshape(4 + 2, -1)
    if case == "optimised":
        img = make_photo(96, 144, seed=4)
        frame = parse_jpeg_structure(oracle.jpeg_encode(img, 70, "420",
                                                        optimize=True))
        return ek.huffman_tables(frame, 1)[2].reshape(6, -1)
    if case == "progressive":
        img = make_photo(96, 144, seed=5)
        frame = parse_jpeg_structure(oracle.jpeg_encode(
            img, 85, "420", progressive=True, restart_interval=6))
        rows = [ek.prog_scan_tables(frame, s) for s in frame.scans]
        width = max(r.shape[1] for r in rows)
        return np.concatenate([np.pad(r, ((0, 0), (0, width - r.shape[1])))
                               for r in rows])
    # codes missing: lengths 1, 3 and 12 only, so most prefixes match no
    # code at all, one code is longer than any lookahead, and the last
    # length's value indices run past nv (they read 0)
    bits = [1, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0, 3] + [0] * 4
    row = ek._canonical(HuffTable(bits=bits, values=[7, 0x21, 0xF0, 5, 9]))
    short = row[:-2].copy()  # nv = 3: indices 3 and 4 lie outside
    none = np.concatenate([np.full(17, -1, np.int32), np.zeros(18, np.int32)])
    width = len(row)
    return np.stack([np.pad(r, (0, width - len(r)))
                     for r in (row, short, none)])


@pytest.mark.parametrize("L", [8, 9, 10])
@pytest.mark.parametrize("case", ["standard", "optimised", "progressive",
                                  "missing"])
def test_lookahead_equals_canonical_walk_on_every_peek(case, L):
    rows = _table_rows(case)
    look = ek.lookahead_tables(rows, L)
    assert look.dtype == np.int16 and look.shape == (len(rows), 1 << L)
    peeks = torch.arange(1 << 16, dtype=torch.int64)
    for row, lk in zip(rows, look):
        found, ln, sym = ek._huff_decode(peeks << 16,
                                         torch.from_numpy(row).to(torch.int64))
        found, ln, sym = found.numpy(), ln.numpy(), sym.numpy()
        e = lk.astype(np.int64)[np.arange(1 << 16) >> (16 - L)]
        hit = e != 0
        # a hit is the walk's answer; an escape is a longer or a missing code
        assert found[hit].all()
        np.testing.assert_array_equal(e[hit] >> 8, ln[hit])
        np.testing.assert_array_equal(e[hit] & 0xFF, sym[hit])
        assert (~found[~hit] | (ln[~hit] > L)).all()
        # and nothing the row could answer is left to the escape
        assert hit[found & (ln <= L)].all()
    if case == "missing":
        assert not look[2].any() and (look[0] == 0).sum() > 0


def test_lookahead_is_cached_by_content_and_checks_L():
    rows = _table_rows("standard")
    assert ek.lookahead_tables(rows) is ek.lookahead_tables(rows.copy())
    assert ek.lookahead_tables(rows).shape[1] == 1 << ek.LOOK_BITS
    with pytest.raises(ValueError):
        ek.lookahead_tables(rows, 13)


# (b) K2: stacks against the Pallas kernel + the reference's reassembly

def _k2_both(frame, words, side, R, B, nsegs):
    out_j, err_j = decode_segments_device(
        frame, words, side[0], interpret=True, R=R, start_bits=side[1],
        dc0=side[2:6])
    want = ref_reassemble_components(np, np.asarray(out_j), frame, B, nsegs, R)
    got, err = ek.decode_segments_into(*_into_args(frame, words, side, R),
                                       B, nsegs)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.is_contiguous() and g.dtype == torch.int16
        np.testing.assert_array_equal(g.numpy(), w)
    np.testing.assert_array_equal(err.numpy(), np.asarray(err_j).reshape(-1))
    return err.numpy()


@pytest.mark.parametrize("ss", ["420", "444", "411", "440", "gray"])
def test_idx_stacks_equal_pallas_and_reference_reassembly(ss):
    datas = [_encode(ss, s) for s in (5, 6)]
    frame, words, side, R, nsegs = _idx_words(datas)
    assert not _k2_both(frame, words, side, R, len(datas), nsegs).any()


@pytest.mark.parametrize("ss,rows", [("420", 1), ("444", 5), ("411", 1),
                                     ("440", 4), ("gray", 5)])
def test_dri_stacks_equal_pallas_and_reference_reassembly(ss, rows):
    """`rows` MCU rows a restart interval; where it does not divide the
    image's MCU rows the last segment is short and its padding rows drop."""
    ri = rows * _mcus(parse_jpeg_structure(_encode(ss, 6)))[0]
    datas = [_encode(ss, s, restart_interval=ri) for s in (6, 7)]
    frame, words, side, R, nsegs = _dri_words(datas)
    assert not _k2_both(frame, words, side, R, len(datas), nsegs).any()


@pytest.mark.parametrize("route", ["idx", "dri"])
def test_corrupted_segment_garbage_and_flags_equal(route):
    if route == "idx":
        frame, words, side, R, nsegs = _idx_words([_encode("420", 8)])
    else:
        ri = _mcus(parse_jpeg_structure(_encode("420", 8)))[0]
        frame, words, side, R, nsegs = _dri_words(
            [_encode("420", 8, restart_interval=ri)])
    words = words.copy()
    words[2:6, 3] = 0xFFFFFFFF  # no Huffman code is sixteen 1 bits
    err = _k2_both(frame, words, side, R, 1, nsegs)
    assert err[3] == 1


def test_lane_of_zero_mcus_gives_zero_blocks():
    """A segment the packer gave up on (0 MCUs) is zero in the stacks."""
    frame, words, side, R, nsegs = _idx_words([_encode("420", 9)])
    side = side.copy()
    side[0, 2] = 0
    _k2_both(frame, words, side, R, 1, nsegs)
    got, _err = ek.decode_segments_into(*_into_args(frame, words, side, R),
                                        1, nsegs)
    v = frame.components[0].v
    assert not got[0][0, 2 * v:3 * v].any() and got[0][0, :2 * v].any()


@pytest.mark.parametrize("what", ["dtype", "strides", "look", "cover", "lanes"])
def test_k2_wrapper_raises_on_bad_input(what):
    frame, words, side, R, nsegs = _idx_words([_encode("420", 9)])
    a = list(_into_args(frame, words, side, R))
    B = 1
    if what == "dtype":
        a[0] = a[0].to(torch.int64)
    elif what == "strides":
        a[1] = a[1].T.contiguous().T
    elif what == "look":
        a[3] = a[3][:, :100]
    elif what == "cover":
        nsegs -= 1  # the segments no longer cover the image
    else:
        B = 1000  # more lanes than the words hold
    with pytest.raises(ValueError):
        ek.decode_segments_into(*a, B, nsegs)


# (c) K3: planes against the reference's, scan by scan

def _prog_scan_by_scan(monkeypatch, data, corrupt=None):
    """Run the reference's decode_progressive_device (Pallas kernel in
    interpret mode). At every scan, hand the words it built to the port's
    `decode_prog_scan_into` on the port's own planes; before that, compare
    the planes both sides hold from the scans so far. Returns (the port's
    planes, the reference's or None if it raised, [(kind, port err,
    reference err)])."""
    frame = parse_jpeg_structure(data)
    hv = [(c.h, c.v) for c in frame.components]
    mx, my = _mcus(frame)
    planes = [torch.zeros((my * v, mx * h, 64), dtype=torch.int16)
              for h, v in hv]
    real = pe.decode_prog_scan_device
    seen = []

    def both(fr, scan, words, seg_units, interpret=False, band_in=None):
        theirs = sys._getframe(1).f_locals["coefs"]  # after the scans so far
        for mine, ref in zip(planes, theirs):
            np.testing.assert_array_equal(mine.numpy(), ref)
        kind = ek.prog_scan_kind(scan)
        if corrupt is not None:
            words = corrupt(len(seen), kind, words)
        out, err = real(fr, scan, words, seg_units, True, band_in)
        tables = ek.prog_scan_tables(fr, scan)
        ci, grid = 0, None
        if scan.ss != 0:
            ci = scan.comp_indices[0]
            grid = fr.comp_true_blocks(fr.components[ci])
        err_t = ek.decode_prog_scan_into(
            kind, torch.from_numpy(words.view(np.int32)),
            torch.from_numpy(pe.make_side(seg_units)),
            torch.from_numpy(tables),
            torch.from_numpy(ek.lookahead_tables(tables)), planes,
            scan.restart_interval, hv, mx, ci, grid, scan.ss, scan.se,
            scan.al)
        seen.append((kind, err_t.numpy(), np.asarray(err).reshape(-1)))
        return out, err

    monkeypatch.setattr(pe, "decode_prog_scan_device", both)
    try:
        want = ref_decode_progressive_device(frame, data, interpret=True)
    except ValueError as e:
        assert corrupt is not None, e
        want = None
    return planes, want, seen


def _assert_prog_equal(planes, want, seen):
    for mine, ref in zip(planes, want):
        np.testing.assert_array_equal(mine.numpy(), ref)
    for _kind, err_t, err_j in seen:
        np.testing.assert_array_equal(err_t, err_j)
        assert not err_t.any()


@pytest.mark.parametrize("stream", ["spectral_420", "spectral_444",
                                    "full_420", "full_422", "full_gray"])
def test_planes_equal_reference_after_every_scan(monkeypatch, stream):
    photo = make_photo(96, 144, seed=23)
    kind, ss = stream.split("_")
    src = photo[:, :, 0] if ss == "gray" else photo
    if kind == "spectral":
        data = oracle.jpeg_encode_spectral(src, 88, ss, split=5,
                                           restart_interval=6)
        kinds = {"dc", "ac"}
    else:
        data = oracle.jpeg_encode(src, 88, ss, progressive=True,
                                  restart_interval=5)
        kinds = {"dc", "ac", "dcref", "acref"}
    planes, want, seen = _prog_scan_by_scan(monkeypatch, data)
    assert {k for k, *_ in seen} == kinds
    _assert_prog_equal(planes, want, seen)


@pytest.mark.parametrize("trial,h,w,q,ss,ri", _randomized_params())
def test_refinement_battery_planes_equal_reference(monkeypatch, trial, h, w,
                                                   q, ss, ri):
    img = make_photo(h, w, seed=1000 + trial)
    src = img[:, :, 0] if ss == "gray" else img
    data = oracle.jpeg_encode(src, q, ss, progressive=True,
                              restart_interval=ri)
    _assert_prog_equal(*_prog_scan_by_scan(monkeypatch, data))


@pytest.mark.parametrize("target", ["dc", "ac", "acref"])
def test_flagged_lane_flags_equal_reference(monkeypatch, target):
    """0xFFFFFFFF words in one column of the first scan of the target kind:
    the reference raises on its kernel's flag, and the port's flags for that
    scan are the kernel's."""
    data = oracle.jpeg_encode(make_photo(96, 144, seed=23), 88, "420",
                              progressive=True, restart_interval=6)
    hit = []

    def corrupt(n, kind, words):
        if kind != target or hit:
            return words
        hit.append(n)
        words = words.copy()
        words[1:5, 3] = 0xFFFFFFFF
        return words

    _planes, want, seen = _prog_scan_by_scan(monkeypatch, data, corrupt)
    assert want is None and len(seen) == hit[0] + 1
    kind, err_t, err_j = seen[-1]
    assert kind == target and err_t[3] == 1
    np.testing.assert_array_equal(err_t, err_j)


def _scan_args(S=128, nv=1, planes=None):
    planes = planes or [torch.zeros((4, 6, 64), dtype=torch.int16)]
    return [torch.zeros((4, S), dtype=torch.int32),
            torch.zeros((6, S), dtype=torch.int32),
            torch.zeros((1, 34 + nv), dtype=torch.int32),
            torch.zeros((1, 512), dtype=torch.int16), planes]


def test_lane_of_zero_units_zeroes_ac_and_keeps_refinements():
    """A unit of the grid that its lane does not decode: "dc" and "ac" give
    it zeros (what the TPU kernel's output held), the refinements leave it
    as it was."""
    for kind, ss, se in (("dc", 0, 0), ("dcref", 0, 0), ("ac", 3, 9),
                         ("acref", 3, 9)):
        planes = [torch.full((4, 6, 64), 5, dtype=torch.int16)]
        grid = None if ss == 0 else (5, 3)
        err = ek.decode_prog_scan_into(kind, *_scan_args(planes=planes), 4,
                                       [(1, 1)], 6, 0, grid, ss, se, 1)
        assert not err.any()
        p = planes[0]
        if kind == "dc":
            assert not p[..., 0].any() and (p[..., 1:] == 5).all()
        elif kind == "ac":
            assert not p[:3, :5, 3:10].any()
            assert (p[3] == 5).all() and (p[:, 5] == 5).all()
            assert (p[..., :3] == 5).all() and (p[..., 10:] == 5).all()
        else:
            assert (p == 5).all()


@pytest.mark.parametrize("what", ["dtype", "strides", "shape", "grid", "lanes",
                                  "tables"])
def test_k3_wrapper_raises_on_bad_input(what):
    a = _scan_args()
    grid, R = (5, 3), 4
    if what == "dtype":
        a[4] = [a[4][0].to(torch.int32)]
    elif what == "strides":
        a[4] = [torch.zeros((4, 64, 6), dtype=torch.int16).permute(0, 2, 1)]
    elif what == "shape":
        a[4] = [torch.zeros((4, 7, 64), dtype=torch.int16)]
    elif what == "grid":
        grid = (7, 3)  # wider than the plane
    elif what == "lanes":
        a[0], a[1] = a[0][:, :2].contiguous(), a[1][:, :2].contiguous()
    else:
        a[2] = a[2].to(torch.int64)
    with pytest.raises(ValueError):
        ek.decode_prog_scan_into("ac", *a, R, [(1, 1)], 6, 0, grid, 1, 63, 0)
