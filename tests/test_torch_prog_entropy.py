"""K3 (progressive Huffman decode) and the progressive route of the CUDA
port against the JAX package.

On the CPU the K3 wrapper runs its plain PyTorch version, which is built on
`decode_prog_scan_plain`, the TPU kernel's own contract. Per scan that must
equal the Pallas kernel run in interpret mode bit for bit, `out` and `err`,
on the very inputs the reference's `decode_progressive_device` builds (a
clean stream of each kind, and corrupted lanes;
tests/test_torch_entropy_into.py holds `decode_prog_scan_into`'s planes
against the reference's scan by scan). The port's
`decode_progressive_device` must equal the host entropy decoder on the
reference's progressive battery, and the route's images must be within 1
of the reference Decoder's (exact with bitexact).
"""
import numpy as np
import pytest
import torch

import oracle
import nvimagecodec_tpu as ref
import nvimagecodec_tpu.ops.pallas_entropy as pe
from nvimagecodec_tpu.codecs.jpeg import _entropy_decode
from nvimagecodec_tpu.codecs.jpeg.device_entropy import (
    decode_progressive_device as ref_decode_progressive_device,
)
from nvimagecodec_tpu.codecs.jpeg.headers import parse_jpeg_structure
from nvimagecodec_tpu.codecs.jpeg.pixel import ZIGZAG_NAT
from nvimagecodec_tpu_torch.codecs.jpeg import batch as jb
from nvimagecodec_tpu_torch.codecs.jpeg.device_entropy import (
    decode_progressive_device,
)
from nvimagecodec_tpu_torch.ops import entropy_kernels as ek
from util import make_photo


@pytest.fixture(scope="module")
def photo():
    return make_photo(96, 144, seed=23)


def _comp_map(frame, scan):
    if scan.ss != 0:
        return (0,)
    return tuple(ci for ci, c in enumerate(frame.components)
                 for _ in range(c.h * c.v))


def _port_scan(frame, scan, words, seg_units, band_in):
    """The port's plain K3 (the TPU kernel's contract) on the reference's
    numpy inputs."""
    cmap = _comp_map(frame, scan)
    return ek.decode_prog_scan_plain(
        ek.prog_scan_kind(scan), torch.from_numpy(words.view(np.int32)),
        torch.from_numpy(pe.make_side(seg_units)),
        torch.from_numpy(ek.prog_scan_tables(frame, scan)),
        scan.restart_interval, len(cmap), cmap, scan.ss, scan.se, scan.al,
        None if band_in is None
        else torch.from_numpy(np.ascontiguousarray(band_in, np.int16)))


def _against_interpret(monkeypatch, data, corrupt=None):
    """Run the reference's decode_progressive_device with its Pallas kernel
    in interpret mode; at every scan, run the port's plain K3 on the same
    inputs. `corrupt(scan_no, kind, words)` may edit a scan's words before
    both see them. Returns [(kind, out equal, err equal, port err)]."""
    real = pe.decode_prog_scan_device
    seen = []

    def both(frame, scan, words, seg_units, interpret=False, band_in=None):
        if corrupt is not None:
            words = corrupt(len(seen), ek.prog_scan_kind(scan), words)
        out, err = real(frame, scan, words, seg_units, True, band_in)
        out_t, err_t = _port_scan(frame, scan, words, seg_units, band_in)
        err_j = np.asarray(err).reshape(-1)
        seen.append((ek.prog_scan_kind(scan),
                     np.array_equal(np.asarray(out), out_t.numpy()),
                     np.array_equal(err_j, err_t.numpy()), err_t.numpy()))
        return out, err

    monkeypatch.setattr(pe, "decode_prog_scan_device", both)
    frame = parse_jpeg_structure(data)
    try:
        ref_decode_progressive_device(frame, data, interpret=True)
    except ValueError as e:
        assert corrupt is not None, e
    return seen


@pytest.mark.parametrize("stream", ["spectral_420", "full_420", "full_gray"])
def test_plain_k3_bit_exact_vs_pallas_interpret(photo, monkeypatch, stream):
    if stream == "spectral_420":
        data = oracle.jpeg_encode_spectral(photo, 88, "420", split=5,
                                           restart_interval=6)
        kinds = {"dc", "ac"}
    elif stream == "full_420":
        data = oracle.jpeg_encode(photo, 88, "420", progressive=True,
                                  restart_interval=6)
        kinds = {"dc", "ac", "dcref", "acref"}
    else:
        data = oracle.jpeg_encode(photo[:, :, 0], 85, "gray",
                                  progressive=True, restart_interval=5)
        kinds = {"dc", "ac", "dcref", "acref"}
    seen = _against_interpret(monkeypatch, data)
    assert {k for k, *_ in seen} == kinds
    for kind, out_eq, err_eq, err in seen:
        assert out_eq and err_eq, kind
        assert not err.any()


@pytest.mark.parametrize("target", ["dc", "ac"])
def test_corrupted_lane_matches_pallas_interpret(photo, monkeypatch, target):
    """0xFFFFFFFF words (no Huffman code is sixteen 1 bits) in one column of
    the first scan of the target kind: out and err still equal."""
    data = oracle.jpeg_encode(photo, 88, "420", progressive=True,
                              restart_interval=6)

    def corrupt(n, kind, words):
        if kind != target:
            return words
        words = words.copy()
        words[1:5, 3] = 0xFFFFFFFF
        return words

    seen = _against_interpret(monkeypatch, data, corrupt)
    assert seen[-1][0] == target
    kind, out_eq, err_eq, err = seen[-1]
    assert out_eq and err_eq
    assert err[3] == 1


def _check_prog(data):
    """The port's route on the CPU equals the host entropy decoder."""
    frame = parse_jpeg_structure(data)
    planes = decode_progressive_device(frame, data, "cpu")
    host = _entropy_decode(frame, data)
    assert len(planes) == len(host)
    for z, h in zip(planes, host):
        nat = torch.zeros_like(z)
        nat[:, :, ZIGZAG_NAT] = z
        np.testing.assert_array_equal(nat.numpy(), h)


@pytest.mark.parametrize("ss,split,ri", [
    ("420", 5, 6), ("444", 5, 3), ("420", 20, 12), ("422", 9, 4),
])
def test_progressive_spectral_scans(photo, ss, split, ri):
    _check_prog(oracle.jpeg_encode_spectral(photo, 88, ss, split=split,
                                            restart_interval=ri))


def test_progressive_gray(photo):
    _check_prog(oracle.jpeg_encode_spectral(photo[:, :, 0], 90, "gray",
                                            split=8, restart_interval=5))


@pytest.mark.parametrize("q,ss,ri", [
    (88, "420", 6), (75, "444", 4), (92, "422", 9),
])
def test_progressive_refinement_scans(photo, q, ss, ri):
    data = oracle.jpeg_encode(photo, q, ss, progressive=True,
                              restart_interval=ri)
    assert any(s.ah != 0 for s in parse_jpeg_structure(data).scans)
    _check_prog(data)


def test_progressive_refinement_gray(photo):
    _check_prog(oracle.jpeg_encode(photo[:, :, 0], 85, "gray",
                                   progressive=True, restart_interval=5))


def _randomized_params():
    """The reference battery's six seeded trials, in its draw order."""
    rng = np.random.default_rng(123)
    out = []
    for trial in range(6):
        h = int(rng.integers(40, 200))
        w = int(rng.integers(40, 200))
        q = int(rng.integers(50, 96))
        ss = ["420", "422", "444", "gray"][trial % 4]
        ri = int(rng.integers(3, 12))
        out.append((trial, h, w, q, ss, ri))
    return out


@pytest.mark.parametrize("trial,h,w,q,ss,ri", _randomized_params())
def test_progressive_refinement_randomized(trial, h, w, q, ss, ri):
    img = make_photo(h, w, seed=1000 + trial)
    src = img[:, :, 0] if ss == "gray" else img
    _check_prog(oracle.jpeg_encode(src, q, ss, progressive=True,
                                   restart_interval=ri))


@pytest.mark.parametrize("ss,q,ri", [("420", 88, 6), ("444", 80, 7),
                                     ("gray", 85, 5)])
def test_route_images_match_reference_decoder(photo, ss, q, ri):
    """K3 then the port's pixel stage: within 1 of the JAX package's
    Decoder (host entropy route), exact with bitexact on both sides."""
    src = photo[:, :, 0] if ss == "gray" else photo
    data = oracle.jpeg_encode(src, q, ss, progressive=True,
                              restart_interval=ri)
    img = jb.decode_progressive(data, "cpu")
    want = np.asarray(ref.Decoder().decode(data))
    assert img.dtype == torch.uint8 and tuple(img.shape) == want.shape
    assert int(np.abs(img.numpy().astype(int) - want.astype(int)).max()) <= 1
    img = jb.decode_progressive(data, "cpu", bitexact=True)
    want = np.asarray(ref.Decoder(
        options="tpu_jpeg_hybrid_decoder:bitexact=true").decode(data))
    np.testing.assert_array_equal(img.numpy(), want)


def test_scope_no_restart_markers_raises(photo):
    data = oracle.jpeg_encode(photo, 85, "420", progressive=True)
    with pytest.raises(ValueError, match="restart markers"):
        decode_progressive_device(parse_jpeg_structure(data), data, "cpu")


def test_scope_arithmetic_progressive_raises(photo):
    """SOF10 (arithmetic-coded progressive) has no Huffman tables: the
    port refuses it with ValueError before any kernel runs."""
    data = oracle.jpeg_encode_arith(photo, 85, "420", progressive=True,
                                    restart_interval=4)
    frame = parse_jpeg_structure(data)
    assert frame.marker == 0xCA
    with pytest.raises(ValueError, match="SOF2"):
        decode_progressive_device(frame, data, "cpu")


def test_scope_baseline_raises(photo):
    data = oracle.jpeg_encode(photo, 85, "420", restart_interval=9)
    with pytest.raises(ValueError):
        decode_progressive_device(parse_jpeg_structure(data), data, "cpu")


def test_scope_bad_spectral_band_raises(photo):
    data = oracle.jpeg_encode_spectral(photo, 88, "420", split=5,
                                       restart_interval=6)
    frame = parse_jpeg_structure(data)
    scan = next(s for s in frame.scans if s.ss > 0)
    scan.se = scan.ss - 1
    with pytest.raises(ValueError, match="spectral band"):
        decode_progressive_device(frame, data, "cpu")


def test_corrupt_stream_raises(photo):
    data = bytearray(oracle.jpeg_encode(photo, 88, "420", progressive=True,
                                        restart_interval=6))
    s0 = parse_jpeg_structure(bytes(data)).scans[0].data_start
    data[s0 + 10:s0 + 18] = b"\xff\xd3" * 4  # stray RSTs: wrong segment count
    with pytest.raises(ValueError, match="split into"):
        decode_progressive_device(parse_jpeg_structure(bytes(data)),
                                  bytes(data), "cpu")


def test_oversized_segment_raises(photo, monkeypatch):
    """The word matrix cap of the dri route holds here too."""
    from nvimagecodec_tpu_torch.codecs.jpeg import device_entropy as de

    data = oracle.jpeg_encode(photo, 88, "420", progressive=True,
                              restart_interval=6)
    monkeypatch.setattr(de, "MAX_WORD_BYTES", 1024)
    with pytest.raises(ValueError, match="too long"):
        decode_progressive_device(parse_jpeg_structure(data), data, "cpu")


def test_flagged_lane_raises(photo, monkeypatch):
    data = oracle.jpeg_encode(photo, 88, "420", progressive=True,
                              restart_interval=6)
    real = ek.decode_prog_scan_into
    from nvimagecodec_tpu_torch.codecs.jpeg import device_entropy as de

    def flag_one(*args):
        err = real(*args).clone()
        err[1] = 1
        return err

    monkeypatch.setattr(de, "decode_prog_scan_into", flag_one)
    with pytest.raises(ValueError, match="kernel flagged error"):
        decode_progressive_device(parse_jpeg_structure(data), data, "cpu")


def test_scan_tables_layout(photo):
    data = oracle.jpeg_encode(photo, 88, "420", progressive=True,
                              restart_interval=6)
    frame = parse_jpeg_structure(data)
    by_kind = {}
    for scan in frame.scans:
        by_kind.setdefault(ek.prog_scan_kind(scan), scan)
    dc = ek.prog_scan_tables(frame, by_kind["dc"])
    assert dc.dtype == np.int32 and dc.shape[0] == 3
    dcref = ek.prog_scan_tables(frame, by_kind["dcref"])
    assert dcref.shape == (1, 35) and (dcref[0, :17] == -1).all()
    assert not dcref[0, 17:].any()
    ac = ek.prog_scan_tables(frame, by_kind["ac"])
    t = by_kind["ac"].ac_huff[by_kind["ac"].ac_tables[0]]
    assert ac.shape == (1, 34 + len(t.values))
    np.testing.assert_array_equal(ac[0, 34:], t.values)


def test_cpu_wrapper_uses_plain_version(photo):
    data = oracle.jpeg_encode_spectral(photo, 88, "420", split=5,
                                       restart_interval=6)
    before = ek.decode_prog_scan_into.launches
    _check_prog(data)
    assert ek.decode_prog_scan_into.launches == before


def test_wrapper_refuses_other_devices():
    def args(device):
        return (torch.zeros((4, 128), dtype=torch.int32, device=device),
                torch.zeros((6, 128), dtype=torch.int32, device=device),
                torch.zeros((1, 35), dtype=torch.int32, device=device),
                torch.zeros((1, 512), dtype=torch.int16, device=device),
                [torch.zeros((2, 2, 64), dtype=torch.int16, device=device)])

    with pytest.raises(ValueError, match="unsupported device"):
        ek.decode_prog_scan_into("dc", *args("meta"), 1, [(1, 1)], 2, 0,
                                 None, 0, 0, 0)
    with pytest.raises(ValueError, match="unknown kind"):
        ek.decode_prog_scan_into("zz", *args("meta"), 1, [(1, 1)], 2, 0,
                                 None, 0, 0, 0)
    with pytest.raises(ValueError, match="bad band"):  # an AC kind at ss = 0
        ek.decode_prog_scan_into("acref", *args("cpu"), 1, [(1, 1)], 2, 0,
                                 (2, 2), 0, 63, 0)
