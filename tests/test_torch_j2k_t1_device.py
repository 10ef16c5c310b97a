"""JPEG 2000 Tier-1 on the card (ops/j2k_t1.py, csrc/j2k_t1.cu).

On the CPU: the rule that sends a tile's code-blocks to the card, one case a
condition; the code-block table against the native batch decoder's rows and
the addresses `BlockBatch` computes for the same tile; malformed rows
raising the native decoder's message before any launch; the kernel's decode
core, compiled for the host, against the native decoder; and the whole
route through the table on the CPU (its plain version) against the host
route. A CPU decode never takes the route.

On the card (`gpu` marker; they skip without one): the kernel's
coefficients against the native decoder's, bit for bit, on every block of
OpenJPEG-written streams and of synthetic blocks in every part-1 style; a
1024x1024 decode against its source pixels and the host route; the streams
the rule keeps on the host; and no synchronisation over a decode.

    python -m pytest tests/test_torch_j2k_t1_device.py -m gpu -q
"""
import ctypes
import os
import shutil
import struct
import subprocess
import warnings

import numpy as np
import pytest
import torch

import nvimagecodec_tpu_torch as port
from nvimagecodec_tpu_torch.codecs.jpeg2000 import core
from nvimagecodec_tpu_torch.codecs.jpeg2000.t1_bridge import (BlockBatch,
                                                             EncodeBatch)
from nvimagecodec_tpu_torch.core import trace
from nvimagecodec_tpu_torch.ops import j2k_t1
from util import make_photo

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
CUDA = torch.device("cuda")
FORCED = "cuda_jpeg2k_hybrid_decoder:device_pixel_stage=true"
# part-1 code-block styles: BYPASS, RESET, TERMALL, CAUSAL, SEGSYM, and
# combinations (ERTERM is the encoder's choice; its segments read as any)
STYLES = [0, 0x01, 0x02, 0x04, 0x08, 0x20, 0x05, 0x0A, 0x25, 0x2F]


def _openjpeg(px):
    """A lossless codestream OpenJPEG writes (Pillow), as the benchmark's
    `j2k_lossless_1024` cell makes them; skips where Pillow lacks it."""
    pil = pytest.importorskip("PIL")
    from PIL import features

    if not features.check("jpg_2000"):
        pytest.skip("Pillow has no JPEG 2000 (OpenJPEG)")
    del pil
    from benchmark import j2k_streams

    return j2k_streams.encode(px)


def _on_card_rule(monkeypatch):
    """Evaluates the route rule as for a CUDA device while decoding on the
    CPU (the table then decodes through its plain version); returns the
    rule's answers."""
    real = core.tier1_on_device
    said = []

    def rule(device, *args):
        said.append(real(CUDA, *args))
        return said[-1]

    monkeypatch.setattr(core, "tier1_on_device", rule)
    return said


def _no_launch(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("decode_codeblocks was called")

    monkeypatch.setattr(j2k_t1, "decode_codeblocks", refuse)


# ----------------------------------------------------------------- the rule
BASE = dict(reversible=True, ht=False, rgn=False, mesh=False,
            cblk_area=4096)


@pytest.mark.parametrize("change,want", [
    ({}, True),
    ({"device": CPU}, False),
    ({"device": None}, False),
    ({"reversible": False}, False),
    ({"ht": True}, False),
    ({"rgn": True}, False),
    ({"mesh": True}, False),
    ({"cblk_area": 8192}, False),
], ids=["cuda", "cpu", "host_route", "irreversible", "ht", "rgn", "mesh",
        "large_blocks"])
def test_route_rule_one_condition_at_a_time(change, want):
    kw = {"device": CUDA, **BASE, **change}
    device = kw.pop("device")
    assert core.tier1_on_device(device, **kw) is want


# -------------------------------------------------------------- the table
def _stream(kind, px):
    if kind == "openjpeg":
        return _openjpeg(px)
    kw = {"grid": dict(tile_size=64, levels=3), "termall": dict(
        mode_switches=0x25, num_layers=2), "plain": {}}[kind]
    return core.encode_j2k(px, reversible=True, stream_type="j2k",
                           **{"levels": 4, **kw})


@pytest.mark.parametrize("kind", ["openjpeg", "plain", "grid", "termall"])
def test_table_rows_are_the_native_batch_rows_and_addresses(kind,
                                                            monkeypatch):
    """Decoding a tile, the table holds the native batch decoder's row of
    every block (segment, w, h, band | style, bit-planes, passes) and, as
    its destination, the address the host Tier-1's BlockBatch decodes it
    to (as an offset into the flat buffer) with its row stride."""
    px = make_photo(128, 192, seed=7)
    data = _stream(kind, px)
    # the host route: every tile's batch and destinations
    batches = []
    real_run_into = BlockBatch.run_into

    def spy(self, nthreads=0):
        batches.append(self)
        return real_run_into(self, nthreads)

    monkeypatch.setattr(BlockBatch, "run_into", spy)
    job = core._decode_host_stages(data, 0, CPU, 0, None, False)
    base = job.stage.flat.data_ptr()
    want_rows = []
    for batch in batches:
        meta = np.asarray(batch._meta["T1"], np.int64).reshape(
            -1, j2k_t1.META)
        dests = np.asarray(batch._dest["T1"], np.int64).reshape(-1, 3)
        for m, (addr, off, stride) in zip(meta, dests):
            want_rows.append((m, stride, (addr + off * 4 - base) // 4))
    # the device route's table
    _on_card_rule(monkeypatch)
    tables = []
    real_end = j2k_t1.BlockTable.end_tile

    def end_spy(self):
        tables.append(self)
        return real_end(self)

    monkeypatch.setattr(j2k_t1.BlockTable, "end_tile", end_spy)
    bases = []  # where each tile's data starts in the table's data
    real_add_tile = j2k_t1.BlockTable.add_tile

    def add_tile_spy(self, tdata):
        bases.append((len(self), self._size))
        return real_add_tile(self, tdata)

    monkeypatch.setattr(j2k_t1.BlockTable, "add_tile", add_tile_spy)
    job2 = core._decode_host_stages(data, 0, CPU, 0, None, False)
    assert job2.stage.flat is None and job2.stage.t1 is not None
    rows = tables[-1].rows()
    assert len(rows) == len(want_rows) > 0
    assert len(bases) == len(batches)
    # a batch's segment offsets count from its tile's data
    ends = [first for first, _b in bases[1:]] + [len(rows)]
    for (first, base), end in zip(bases, ends):
        rows[first:end, 0] -= base
    for row, (m, stride, dest) in zip(rows, want_rows):
        assert row[:7].tolist() == m.tolist()
        assert (row[7], row[8]) == (stride, dest)


def test_staged_buffer_holds_the_table_longest_first_then_the_data():
    t = j2k_t1.BlockTable()
    t.add_tile(b"abcdefgh")
    t.add(((2, 3), 4, 4, 1, 5, 13, 0, 0, 0), (0, 4))
    t.add((b"XYZW!", 64, 64, 3, 9, 25, 0, 0, 0), ((1 << 33) + 5, 64))
    t.add(((0, 1), 1, 1, 0, 1, 1, 0, 0, 0), (16, 1))
    assert t.end_tile() == 3
    buf, lay = t.staged()
    assert lay.rows == 3 and lay.data_start % 16 == 0
    assert lay.flag_words == (16 + 2) * 66 and lay.mag_words == 4096
    tab = buf[:3 * j2k_t1.ROW * 4].view(torch.int32).view(3, j2k_t1.ROW)
    assert tab[:, 1].tolist() == [5, 3, 1]  # longest segment first
    assert tab[0, 8:].tolist() == [5, 2]  # the destination, low and high
    data = bytes(buf[lay.data_start:].numpy())
    assert data == b"abcdefghXYZW!"
    assert tab[0, 0] == 8 and data[tab[1, 0]:tab[1, 0] + 3] == b"cde"


# ------------------------------------------------------ malformed rows
def _blob(lens, data=b""):
    return struct.pack(f"<{1 + len(lens)}i", len(lens), *lens) + data


@pytest.mark.parametrize("kw,seg", [
    ({"w": 0}, b"\x00"),
    ({"h": 4097}, b"\x00"),
    ({"nbps": 32}, b"\x00"),
    ({"nbps": -1}, b"\x00"),
    ({"style": 0x04}, b"\x01\x00"),
    ({"style": 0x04}, _blob([])),
    ({"style": 0x01}, _blob([1] * 113, b"\x00" * 113)),
    ({"style": 0x04}, _blob([3], b"\x00\x00")),
    ({"style": 0x04}, _blob([-1], b"")),
], ids=["w0", "h4097", "nbps32", "nbps-1", "blob_short", "blob_no_segs",
        "blob_113_segs", "blob_length_past_end", "blob_negative_length"])
def test_malformed_rows_raise_the_native_decoders_message(kw, seg):
    """A row the native decoder refuses raises, at the end of its tile, the
    ValueError BlockBatch raises for the same block."""
    args = {"w": 8, "h": 8, "band": 0, "nbps": 4, "passes": 10, "style": 0,
            **kw}
    good = b"\x12\x34\x56"
    t = j2k_t1.BlockTable()
    t.add_tile(good)
    first = ((0, 3), 8, 8, 0, 4, 10, 0)
    block = (seg, args["w"], args["h"], args["band"], args["nbps"],
             args["passes"], args["style"])
    t.add(first + (0, 0), (0, 8))
    t.add(block + (0, 0), (64, max(8, args["w"])))
    with pytest.raises(ValueError) as got:
        t.end_tile()
    assert str(got.value) == "J2K T1 block decode failed rc=1 (block 1 of 2)"
    b = BlockBatch(base=good)
    out = np.zeros((64, 64), np.int32)
    b.add_t1(first + (0, 0), (out.ctypes.data, 64))
    b.add_t1(block + (8, 0), (out.ctypes.data, 64))
    with pytest.raises(ValueError) as host:
        b.run_into(1)
    assert str(host.value) == str(got.value)


def test_segment_outside_its_tile_raises():
    t = j2k_t1.BlockTable()
    t.add_tile(b"\x00" * 10)
    t.add(((8, 3), 4, 4, 0, 3, 7, 0, 0, 0), (0, 4))
    with pytest.raises(ValueError, match=r"rc=1 \(block 0 of 1\)"):
        t.end_tile()


def _bad_qcd(data):
    """The stream with every band's exponent 31 and 7 guard bits: blocks
    of more than 31 magnitude bit-planes, which the native decoder
    refuses."""
    i = data.index(b"\xff\x5c")
    (ln,) = struct.unpack_from(">H", data, i + 2)
    body = bytes([7 << 5]) + bytes([31 << 3]) * (ln - 3)
    return data[:i + 4] + body + data[i + 2 + ln:]


def test_malformed_stream_raises_before_any_launch(monkeypatch):
    """On the device route a stream with a block the native decoder
    refuses raises that decoder's ValueError from the host stages, as the
    host route does, and nothing is launched."""
    px = make_photo(64, 64, seed=3)
    data = _bad_qcd(core.encode_j2k(px, reversible=True, levels=2,
                                    stream_type="j2k"))
    with pytest.raises(ValueError, match="J2K T1 block decode failed") as h:
        core.decode_j2k(data, device=CPU)
    said = _on_card_rule(monkeypatch)
    _no_launch(monkeypatch)
    with pytest.raises(ValueError) as d:
        core.decode_j2k(data, device=CPU)
    assert said == [True] and str(d.value) == str(h.value)


# ------------------------------------ the kernel's core, built for the host
_HARNESS = r"""
#include "j2k_t1.cu"
#include <vector>
// the kernel's per-block steps, one lane
extern "C" int host_t1(const int32_t* table, int n, const uint8_t* data,
                       int32_t* out) {
  Tables tb;
  build_tables(tb, 0, 1);
  uint64_t ctx[kNumCtx];
  for (int b = 0; b < n; b++) {
    const int32_t* row = table + kRowInts * b;
    const int w = row[2], h = row[3];
    std::vector<uint32_t> F((((h + 3) >> 2) + 2) * (w + 2), 0);
    std::vector<int32_t> mag(w * h, 0);
    BlockDec t;
    t.w = w; t.h = h; t.F = F.data(); t.mag = mag.data(); t.ctx = ctx;
    t.mqt = tb.mq; t.zc = tb.zc[band_class(row[4] & 0xFF)]; t.sc = tb.sc;
    decode_block(t, row[4] >> 8, data + row[0], row[1], row[5], row[6]);
    int32_t* o = out + ((int64_t)(uint32_t)row[8] | ((int64_t)row[9] << 32));
    for (int i = 0; i < w * h; i++)
      o[(int64_t)(i / w) * row[7] + i % w] = from_sign_mag(mag[i]);
  }
  return 0;
}
"""


@pytest.fixture(scope="module")
def kernel_core(tmp_path_factory):
    """csrc/j2k_t1.cu's decode core (everything but the __global__ kernel
    and its launch) built for the host with a one-lane driver."""
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("needs a C++ compiler")
    d = tmp_path_factory.mktemp("t1core")
    (d / "harness.cpp").write_text(_HARNESS)
    so = d / "libt1core.so"
    subprocess.run([cxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-I",
                    os.path.join(ROOT, "nvimagecodec_tpu_torch", "csrc"),
                    str(d / "harness.cpp"), "-o", str(so)], check=True)
    return ctypes.CDLL(str(so))


def _synthetic_table(styles, seed, edge_rows=True):
    """Blocks of seeded Laplacian coefficients, coded by the port's
    EncodeBatch in `styles` (cycled): 64x64 in each band, 1-row, 1-column,
    odd sizes, a 1024x4 and a 4x1024, a block at 30 bit-planes; and rows
    no encoder writes: an empty segment, no passes, 31 bit-planes of noise.
    Returns the table and the flat size."""
    rng = np.random.default_rng(seed)
    shapes = [(64, 64, 0, 30.0), (64, 64, 1, 4.0), (64, 64, 2, 90.0),
              (64, 64, 3, 300.0), (1, 1, 2, 3.0), (1, 64, 1, 9.0),
              (64, 1, 3, 9.0), (7, 13, 2, 50.0), (33, 17, 1, 1000.0),
              (4, 1024, 0, 20.0), (1024, 4, 2, 20.0), (16, 16, 0, None)]
    t = j2k_t1.BlockTable()
    t.add_tile(b"")
    total = 0
    for k, (h, w, band, amp) in enumerate(shapes):
        sty = styles[k % len(styles)]
        if amp is None:  # one coefficient at the top bit-plane
            blk = np.zeros((h, w), np.int32)
            blk[h // 2, w // 3] = -((1 << 30) - 1)
        else:
            blk = rng.laplace(0, amp, (h, w)).astype(np.int32)
        eb = EncodeBatch(False)
        eb.add(0, blk, band, style=sty)
        ((_, res),) = list(eb.run(1))
        data, nbps, npasses = res[:3]
        if npasses == 0:  # all zero: not included, as T2 leaves it
            continue
        if sty & 0x05:
            ends = res[3]
            lens = [e - p for p, e in zip([0] + ends[:-1], ends)]
            data = _blob(lens, data)
        t.add((data, w, h, band, nbps, npasses, sty, 0, 0), (total, w))
        total += w * h
    if edge_rows:
        for seg, nbps, passes, sty in (
                (b"", 6, 16, 0), (b"\x55", 3, 0, 0),
                (rng.integers(0, 256, 600, np.uint8).tobytes(), 31, 91, 0),
                (_blob([0, 2], b"\xff\x7f"), 5, 13, 0x04)):
            t.add((seg, 32, 32, 3, nbps, passes, sty, 0, 0), (total, 32))
            total += 32 * 32
    t.end_tile()
    return t, total


@pytest.mark.parametrize("style", STYLES, ids=[f"{s:#x}" for s in STYLES])
def test_kernel_core_on_the_host_equals_the_native_decoder(kernel_core,
                                                           style):
    t, total = _synthetic_table([style], seed=style)
    buf, lay = t.staged()
    want = torch.zeros(total, dtype=torch.int32)
    j2k_t1.decode_codeblocks(buf, lay, want)  # the plain version
    got = torch.zeros(total, dtype=torch.int32)
    kernel_core.host_t1(ctypes.c_void_p(buf.data_ptr()), lay.rows,
                        ctypes.c_void_p(buf.data_ptr() + lay.data_start),
                        ctypes.c_void_p(got.data_ptr()))
    assert torch.equal(got, want)
    assert want.abs().sum() > 0


# ------------------------------------------- the route through the table
@pytest.mark.parametrize("kind", ["openjpeg", "plain", "grid", "termall"])
def test_route_through_the_table_on_the_cpu_gives_the_host_route(
        kind, monkeypatch):
    """With the rule answering as for a CUDA device, the decode builds the
    table, stages it (no host subband buffer) and decodes it through the
    plain version into the flat buffer: the image equals the host route's
    and the source."""
    px = make_photo(128, 192, seed=11)
    data = _stream(kind, px)
    said = _on_card_rule(monkeypatch)
    trace.start_collect()
    try:
        got = core.decode_j2k(data, device=CPU)
    finally:
        col = trace.stop_collect()
    assert said == [True]
    assert np.array_equal(got.numpy(), px)
    assert np.array_equal(core.decode_j2k(data, device=None), px)
    c = col["counters"]
    # every block went to the table, counted where the rule sends it
    assert c["imgcodec.jpeg2k.codeblocks_device"] == c[
        "imgcodec.jpeg2k.codeblocks"] > 0


def _kept_streams():
    px = make_photo(64, 96, seed=2)
    yield "irreversible", core.encode_j2k(px, reversible=False, levels=3,
                                          stream_type="j2k")
    yield "ht", core.encode_j2k(px, reversible=True, levels=3, ht=True,
                                stream_type="j2k")
    yield "rgn", core.encode_j2k(px, reversible=True, levels=3,
                                 roi=(8, 8, 40, 40), stream_type="j2k")


@pytest.mark.parametrize("name", ["irreversible", "ht", "rgn"])
def test_streams_the_rule_keeps_on_the_host(name, monkeypatch):
    """9/7, HTJ2K and ROI-shifted streams on the device stage: the rule,
    answering as for a CUDA device, keeps their host Tier-1; nothing is
    launched and the image is the host route's."""
    data = dict(_kept_streams())[name]
    said = _on_card_rule(monkeypatch)
    _no_launch(monkeypatch)
    got = core.decode_j2k(data, device=CPU)
    assert said == [False]
    want = core.decode_j2k(data, device=None)
    assert np.abs(got.numpy().astype(int) - want.astype(int)).max() <= (
        0 if name != "irreversible" else 1)


def test_mesh_decode_keeps_the_host_tier1(monkeypatch):
    from nvimagecodec_tpu_torch.parallel.mesh import make_mesh

    px = make_photo(64, 64, seed=4)
    data = core.encode_j2k(px, reversible=True, levels=2, stream_type="j2k")
    said = _on_card_rule(monkeypatch)
    _no_launch(monkeypatch)
    mesh = make_mesh(dp=1, sp=2, devices=[CPU] * 2)
    got = core.decode_j2k(data, device=None, mesh=mesh)
    assert said == [False] and np.array_equal(got.numpy(), px)


def test_cpu_decode_launches_nothing_and_decodes_as_before():
    """Decoder(device="cpu"), with the pixel stage forced and without: no
    launch, no block counted on a card, and the source back."""
    px = make_photo(96, 80, seed=6)
    data = core.encode_j2k(px, reversible=True, levels=3, stream_type="j2k")
    before = j2k_t1.decode_codeblocks.launches
    trace.start_collect()
    try:
        for opts in ("", FORCED):
            (img,) = port.Decoder(device="cpu", options=opts).decode([data])
            assert np.array_equal(np.asarray(img.cpu()), px)
    finally:
        col = trace.stop_collect()
    assert j2k_t1.decode_codeblocks.launches == before
    assert col["counters"].get("imgcodec.jpeg2k.codeblocks_device", 0) == 0
    assert col["counters"]["imgcodec.jpeg2k.codeblocks"] > 0


# ------------------------------------------------------------------ card
@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return CUDA


def _kernel_vs_native(table, total):
    buf, lay = table.staged()
    want = torch.zeros(total, dtype=torch.int32)
    j2k_t1.decode_codeblocks_plain(buf, lay, want)
    got = torch.zeros(total, dtype=torch.int32, device=CUDA)
    before = j2k_t1.decode_codeblocks.launches
    j2k_t1.decode_codeblocks(buf.to(CUDA), lay, got)
    torch.cuda.synchronize()
    assert j2k_t1.decode_codeblocks.launches == before + 1
    return got.cpu(), want


@pytest.mark.gpu
@pytest.mark.parametrize("style", STYLES, ids=[f"{s:#x}" for s in STYLES])
def test_kernel_equals_native_on_synthetic_blocks(cuda, style):
    got, want = _kernel_vs_native(*_synthetic_table([style], seed=style))
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_kernel_equals_native_on_mixed_styles(cuda):
    got, want = _kernel_vs_native(*_synthetic_table(STYLES, seed=99))
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("hw,channels", [((1024, 1024), 3), ((96, 80), 1),
                                         ((256, 256), 3)])
def test_kernel_equals_native_on_openjpeg_streams(cuda, hw, channels,
                                                  monkeypatch):
    """Every code-block of an OpenJPEG stream: the staged table the device
    route builds, through the kernel and through the native decoder."""
    px = make_photo(*hw, seed=hw[0], channels=channels)
    data = _openjpeg(px)
    job = core._decode_host_stages(data, 0, cuda, 0, None, False)
    assert job.stage.flat is None
    buf, lay = job.stage.t1.staged()
    total = job.stage.offs[-1]
    want = torch.zeros(total, dtype=torch.int32)
    j2k_t1.decode_codeblocks_plain(buf, lay, want)
    got = torch.zeros(total, dtype=torch.int32, device=cuda)
    j2k_t1.decode_codeblocks(buf.to(cuda), lay, got)
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["openjpeg", "grid", "termall"])
def test_decode_on_the_card_gives_the_source_and_the_host_route(cuda,
                                                                kind):
    """A 1024x1024 OpenJPEG stream (the benchmark cell's shape), a tile
    grid and a multi-segment stream through Decoder(device="cuda"): Tier-1
    on the card (every block counted there, one launch), the image on the
    card and equal to its source and to the CPU decode."""
    hw = (1024, 1024) if kind == "openjpeg" else (256, 320)
    px = make_photo(*hw, seed=5)
    data = _stream(kind, px)
    dec = port.Decoder(device="cuda", options=FORCED)
    before = j2k_t1.decode_codeblocks.launches
    trace.start_collect()
    try:
        (img,) = dec.decode([data])
        torch.cuda.synchronize()
    finally:
        col = trace.stop_collect()
    assert j2k_t1.decode_codeblocks.launches == before + 1
    c = col["counters"]
    assert c["imgcodec.jpeg2k.codeblocks_device"] == c[
        "imgcodec.jpeg2k.codeblocks"] > 0
    assert img.array.is_cuda
    assert np.array_equal(img.array.cpu().numpy(), px)
    (host,) = port.Decoder(device="cpu").decode([data])
    assert np.array_equal(np.asarray(host.cpu()), px)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["irreversible", "ht", "rgn"])
def test_streams_kept_on_the_host_launch_nothing_on_the_card(cuda, name):
    data = dict(_kept_streams())[name]
    before = j2k_t1.decode_codeblocks.launches
    got = core.decode_j2k(data, device=cuda)
    torch.cuda.synchronize()
    assert j2k_t1.decode_codeblocks.launches == before
    want = core.decode_j2k(data, device=None)
    assert np.abs(got.cpu().numpy().astype(int) - want.astype(int)).max() <= (
        0 if name != "irreversible" else 1)


@pytest.mark.gpu
def test_decode_on_the_card_does_not_synchronise(cuda):
    px = make_photo(512, 512, seed=8)
    data = _openjpeg(px)
    core.decode_j2k(data, device=cuda)  # builds, warms up
    torch.cuda.synchronize()
    before = j2k_t1.decode_codeblocks.launches
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            img = core.decode_j2k(data, device=cuda)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert j2k_t1.decode_codeblocks.launches == before + 1
    assert not [w for w in seen if "synchroniz" in str(w.message)], [
        str(w.message) for w in seen]
    assert np.array_equal(img.cpu().numpy(), px)
