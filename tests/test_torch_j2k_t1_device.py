"""JPEG 2000 Tier-1 on the card (ops/j2k_t1.py, csrc/j2k_t1.cu).

On the CPU: the rule that sends a tile's code-blocks to the card, one case a
condition; the code-block table against the native batch decoder's rows and
the addresses the host Tier-1 decodes it to (tests/test_torch_j2k.py holds
them against rows built from the JAX package's Tier-2); the table's
coefficients against the native_into route's on streams of several layers,
precincts, a tile grid, every part-1 style, PPT and PPM; malformed rows
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
from nvimagecodec_tpu_torch.codecs.jpeg2000.t1_bridge import EncodeBatch
from nvimagecodec_tpu_torch.codecs.jpeg2000.t2 import (_EncCblk,
                                                      plan_layers_seg)
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
def _packed(px, where):
    """The port's 2-layer stream of px with its packet headers moved out of
    the tile data, into two PPT segments of the tile-part header
    (`where="ppt"`, T.800 A.7.5) or two PPM segments of the main header
    ("ppm", A.7.4), the bodies left in place; the headers' lengths are
    recorded from the Python packet writer."""
    from nvimagecodec_tpu_torch.codecs.jpeg2000 import t2 as t2m

    sizes, heads = [], []
    init, write = t2m.PacketEncoder.__init__, t2m.PacketEncoder.write_packet
    flush = t2m.HeaderBitWriter.flush

    def init_py(self, *a, **k):
        init(self, *a, **k)
        self._nctx = None

    def write_rec(self, *a):
        b = write(self, *a)
        sizes.append(len(b))
        return b

    def flush_rec(self):
        out = flush(self)
        heads.append(len(out))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t2m.PacketEncoder, "__init__", init_py)
        mp.setattr(t2m.PacketEncoder, "write_packet", write_rec)
        mp.setattr(t2m.HeaderBitWriter, "flush", flush_rec)
        s = core.encode_j2k(px, reversible=True, levels=3, num_layers=2,
                            stream_type="j2k")
    i = s.find(b"\xff\x90")
    psot = struct.unpack_from(">I", s, i + 6)[0]
    isot = struct.unpack_from(">H", s, i + 4)[0]
    tdata = s[s.find(b"\xff\x93", i) + 2:i + psot]
    headers, bodies, off = bytearray(), bytearray(), 0
    for total, hl in zip(sizes, heads):
        headers += tdata[off:off + hl]
        bodies += tdata[off + hl:off + total]
        off += total
    assert off == len(tdata)
    rec = headers if where == "ppt" else struct.pack(">I", len(headers)) + (
        headers)
    cut = len(rec) // 2
    marker = b"\xff\x61" if where == "ppt" else b"\xff\x60"
    segs = b"".join(marker + struct.pack(">H", 3 + len(part)) + bytes([z])
                    + part for z, part in enumerate((rec[:cut], rec[cut:])))
    body = (segs if where == "ppt" else b"") + b"\xff\x93" + bytes(bodies)
    sot = struct.pack(">HHHIBB", 0xFF90, 10, isot, 12 + len(body), 0, 1)
    return (s[:i] + (segs if where == "ppm" else b"") + sot + body
            + b"\xff\xd9")


# stream -> encode_j2k keywords: several layers, precincts, a uniform tile
# grid, each part-1 style, PPT and PPM
STREAMS = {
    "plain": {},
    "grid": dict(tile_size=64, levels=3),
    "termall": dict(mode_switches=0x25, num_layers=2),
    "layers": dict(num_layers=3),
    "precincts_rpcl": dict(num_layers=2, precincts=(5, 5),
                           prog_order="RPCL"),
    "bypass_layers": dict(mode_switches=0x01, num_layers=3),
    "reset": dict(mode_switches=0x02),
    "termall_layers": dict(mode_switches=0x04, num_layers=3),
    "causal": dict(mode_switches=0x08),
    "segsym": dict(mode_switches=0x20),
}


def _split_first_segment(segments, zero_bps, num_layers):
    """A layer plan (`t2.plan_layers_seg`'s) that puts the first half of a
    block's first codeword segment, passes and bytes, in layer 0 and the
    rest of it with the other segments in layer 1: layer 1's first length
    field then continues a segment begun in another packet."""
    (seg0, n0), rest = segments[0], segments[1:]
    if n0 < 2 or num_layers < 2:
        return plan_layers_seg(segments, zero_bps, num_layers)
    k, cut = n0 // 2, len(seg0) // 2
    later = [(seg0[cut:], n0 - k)] + rest
    layers = [(seg0[:cut], k),
              (b"".join(x for x, _n in later), sum(n for _x, n in later))]
    return _EncCblk(layers + [(b"", 0)] * (num_layers - 2), zero_bps, 0,
                    splits={1: later} if len(later) > 1 else {})


def _stream(kind, px):
    if kind == "openjpeg":
        return _openjpeg(px)
    if kind in ("ppt", "ppm"):
        return _packed(px, kind)
    if kind == "bypass_continued":
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(core, "plan_layers_seg", _split_first_segment)
            return core.encode_j2k(px, reversible=True, stream_type="j2k",
                                   levels=4, mode_switches=0x01,
                                   num_layers=2)
    return core.encode_j2k(px, reversible=True, stream_type="j2k",
                           **{"levels": 4, **STREAMS[kind]})


KINDS = ["openjpeg", *STREAMS, "bypass_continued", "ppt", "ppm"]


def _card_table(data, monkeypatch):
    """The code-block table the device route builds for `data`, with the
    rule answering as for a CUDA device."""
    _on_card_rule(monkeypatch)
    job = core._decode_host_stages(data, 0, CPU, 0, None, False)
    assert job.stage.flat is None and job.stage.t1 is not None
    return job


@pytest.mark.parametrize("kind", KINDS)
def test_table_route_coefficients_equal_the_native_into_route(kind,
                                                              monkeypatch):
    """The subbands the card table decodes to (through its plain version
    on the CPU) equal, bit for bit, those the native decoder writes on the
    native_into route of the same stream."""
    px = make_photo(128, 192, seed=9)
    data = _stream(kind, px)
    real = core.plan_stream
    got = {}
    for site in ("card_table", "native_into"):
        monkeypatch.setattr(core, "plan_stream", lambda *a, **k: real(
            *a, **k)._replace(tier1=site))
        job = core._decode_host_stages(data, 0, CPU, 0, None, False)
        assert (job.stage.t1 is not None) == (site == "card_table")
        LL, bands = job.stage.upload(CPU)
        got[site] = [LL] + [b for lvl in bands for b in lvl]
    for a, b in zip(got["card_table"], got["native_into"]):
        assert torch.equal(a, b)
    assert any(bool(a.any()) for a in got["native_into"])


@pytest.mark.parametrize("kind", ["openjpeg", "plain", "grid", "termall"])
def test_table_rows_are_the_native_batch_rows_and_addresses(kind,
                                                            monkeypatch):
    """Decoding a tile, the table holds the native batch decoder's row of
    every block (segment, w, h, band | style, bit-planes, passes) and, as
    its destination, the address the host Tier-1 decodes it to (as an
    offset into the flat buffer) with its row stride."""
    px = make_photo(128, 192, seed=7)
    data = _stream(kind, px)
    # the host route: every tile's part-1 batch and destinations
    batches = []
    real_batch = j2k_t1.decode_batch_into

    def spy(kind, data, meta, bases, offsets, strides, *a, **k):
        batches.append((np.asarray(meta), np.asarray(offsets) * 4
                        + np.asarray(bases, np.int64), np.asarray(strides)))
        return real_batch(kind, data, meta, bases, offsets, strides, *a,
                          **k)

    monkeypatch.setattr(j2k_t1, "decode_batch_into", spy)
    job = core._decode_host_stages(data, 0, CPU, 0, None, False)
    monkeypatch.setattr(j2k_t1, "decode_batch_into", real_batch)
    base = job.stage.flat.data_ptr()
    # the device route's table, and where each tile's data starts in it
    bases = []
    real_add_tile = j2k_t1.BlockTable.add_tile

    def add_tile_spy(self, rows, parts, bad):
        bases.append((len(self), self.size))
        return real_add_tile(self, rows, parts, bad)

    monkeypatch.setattr(j2k_t1.BlockTable, "add_tile", add_tile_spy)
    rows = _card_table(data, monkeypatch).stage.t1.rows().astype(np.int64)
    assert len(bases) == len(batches)
    want = np.concatenate([m for m, _a, _s in batches])
    assert len(rows) == len(want) > 0
    # a batch's segment offsets count from its tile's data
    ends = [first for first, _b in bases[1:]] + [len(rows)]
    for (first, b), end in zip(bases, ends):
        rows[first:end, 0] -= b
    assert np.array_equal(rows[:, :7], want)
    addrs = np.concatenate([a for _m, a, _s in batches])
    strides = np.concatenate([st for _m, _a, st in batches])
    assert np.array_equal(rows[:, 7], strides)
    assert np.array_equal(j2k_t1.row_dest(rows[:, 8].astype(np.int32),
                                          rows[:, 9].astype(np.int32)),
                          (addrs - base) // 4)


def test_tier2_layout_is_made_once_for_streams_written_alike(monkeypatch):
    """Tier-2's layout of a tile (geometry and packet order) is made once
    for streams whose main headers are alike and then reused, made anew
    for another header, and not kept for PPM streams (their main header
    holds every packet header); every image is still its source."""
    made = []
    real = core.tile_layout

    def spy(*a):
        made.append(1)
        return real(*a)

    monkeypatch.setattr(core, "tile_layout", spy)
    monkeypatch.setattr(core, "_LAYOUTS", {})
    pxs = [make_photo(64, 96, seed=s) for s in (1, 2)]
    for px in pxs:  # two images, one header
        data = core.encode_j2k(px, reversible=True, levels=3,
                               stream_type="j2k")
        assert np.array_equal(core.decode_j2k(data, device=None), px)
    assert len(made) == 1 and len(core._LAYOUTS) == 1
    other = core.encode_j2k(pxs[0], reversible=True, levels=2,
                            stream_type="j2k")
    assert np.array_equal(core.decode_j2k(other, device=None), pxs[0])
    assert len(made) == 2 and len(core._LAYOUTS) == 2
    for _ in range(2):
        assert np.array_equal(
            core.decode_j2k(_packed(pxs[1], "ppm"), device=None), pxs[1])
    assert len(made) == 4 and len(core._LAYOUTS) == 2


def test_staged_buffer_holds_the_table_longest_first_then_the_data():
    t = j2k_t1.BlockTable()
    rows = np.asarray([
        j2k_t1.t1_row(2, 3, 4, 4, 1, 5, 13, 0) + (4, 0, 0),
        j2k_t1.t1_row(8, 5, 64, 64, 3, 9, 25, 0) + (64, 5, 2),
        j2k_t1.t1_row(0, 1, 1, 1, 0, 1, 1, 0) + (1, 16, 0)], np.int32)
    data = (b"abcdefgh", b"XYZW!")
    assert t.add_tile(rows, data, j2k_t1.check_rows(rows, b"".join(data))) \
        == 3
    assert t.size == 13
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
    """A row the native decoder refuses is found by the native rows check
    (the one Tier-2's rows pass applies) and raises, as the table takes
    the tile, the ValueError the native batch decoder raises for the same
    block."""
    args = {"w": 8, "h": 8, "band": 0, "nbps": 4, "passes": 10, "style": 0,
            **kw}
    good = b"\x12\x34\x56"
    rows = np.asarray([
        j2k_t1.t1_row(0, 3, 8, 8, 0, 4, 10, 0) + (8, 0, 0),
        j2k_t1.t1_row(3, len(seg), args["w"], args["h"], args["band"],
                      args["nbps"], args["passes"], args["style"])
        + (max(8, args["w"]), 64, 0)], np.int32)
    bad = j2k_t1.check_rows(rows, good + seg)
    assert bad == 1
    t = j2k_t1.BlockTable()
    with pytest.raises(ValueError) as got:
        t.add_tile(rows, (good, seg), bad)
    assert str(got.value) == "J2K T1 block decode failed rc=1 (block 1 of 2)"
    assert len(t) == 0
    out = np.zeros((64, 64), np.int32)
    with pytest.raises(ValueError) as host:
        j2k_t1.decode_batch_into("T1", good + seg, rows[:, :j2k_t1.META],
                                 out.ctypes.data, [0, 8], rows[:, 7], 1)
    assert str(host.value) == str(got.value)


def test_segment_outside_its_tile_raises():
    rows = np.asarray([j2k_t1.t1_row(8, 3, 4, 4, 0, 3, 7, 0) + (4, 0, 0)],
                      np.int32)
    bad = j2k_t1.check_rows(rows, b"\x00" * 10)
    assert bad == 0
    with pytest.raises(ValueError, match=r"rc=1 \(block 0 of 1\)"):
        j2k_t1.BlockTable().add_tile(rows, (b"\x00" * 10,), bad)


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
    rows, segs = [], []
    total = size = 0

    def add(seg, w, h, band, nbps, passes, sty):
        nonlocal total, size
        rows.append(j2k_t1.t1_row(size, len(seg), w, h, band, nbps, passes,
                                  sty) + (w, total, 0))
        segs.append(seg)
        size += len(seg)
        total += w * h

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
        add(data, w, h, band, nbps, npasses, sty)
    if edge_rows:
        for seg, nbps, passes, sty in (
                (b"", 6, 16, 0), (b"\x55", 3, 0, 0),
                (rng.integers(0, 256, 600, np.uint8).tobytes(), 31, 91, 0),
                (_blob([0, 2], b"\xff\x7f"), 5, 13, 0x04)):
            add(seg, 32, 32, 3, nbps, passes, sty)
    rows = np.asarray(rows, np.int32)
    t = j2k_t1.BlockTable()
    t.add_tile(rows, segs, j2k_t1.check_rows(rows, b"".join(segs)))
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
