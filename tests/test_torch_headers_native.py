"""The port's header parse, a native marker walk a batch
(`headers.parse_jpeg_batch`, native/jpeg_headers.cpp), against the JAX
package's Python walk: the same frame, field by field, for every kind of
stream the codecs take, and the same streams failing, each alone."""
import dataclasses

import numpy as np
import pytest

import oracle
from nvimagecodec_tpu.codecs.jpeg import headers as ref_headers
from nvimagecodec_tpu_torch.codecs.jpeg import batch as jb
from nvimagecodec_tpu_torch.codecs.jpeg import headers
from nvimagecodec_tpu_torch.core import trace
from nvimagecodec_tpu_torch.core.interfaces import DecodeParams
from test_jpeg_lossless import encode_lossless_jpeg
from util import make_photo

KEPT_MESSAGES = ("not a JPEG", "SOS before SOF", "JPEG: no frame header")


def plain(x):
    """Dataclasses, arrays and containers as plain values."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, np.ndarray):
        return (str(x.dtype), x.shape, x.tolist())
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, np.integer):
        return x.item()
    return x


def ref_parse(data):
    """(plain frame, None) or (None, error text) from the JAX package."""
    try:
        return plain(ref_headers.parse_jpeg_structure(data)), None
    except Exception as e:  # any malformed stream
        return None, str(e)


def port_parse(data):
    try:
        return plain(headers.parse_jpeg_structure(data)), None
    except ValueError as e:
        return None, str(e)


def assert_same(data):
    """The port parses `data` as the JAX package does, alone and in a batch;
    returns the JAX package's (frame, error)."""
    want = ref_parse(data)
    got = port_parse(data)
    assert (got[0] is None) == (want[0] is None), (want[1], got[1])
    assert got[0] == want[0]
    if want[1] in KEPT_MESSAGES:
        assert got[1] == want[1]
    (frame, err), = headers.parse_jpeg_batch([data])
    assert (plain(frame) if frame is not None else None, err) == got
    return want


def _jpeg(ss="420", seed=0, h=40, w=56, **kw):
    img = make_photo(h, w, seed=seed)
    if ss == "gray":
        return oracle.jpeg_encode(img[:, :, 0], 85, **kw)
    return oracle.jpeg_encode(img, 85, ss, **kw)


def header_segments(data):
    """[(offset, marker, total length)] of the marker segments before the
    first SOS of a well-formed stream, SOS included."""
    out, pos = [], 2
    while True:
        marker = data[pos + 1]
        n = 2 + int.from_bytes(data[pos + 2:pos + 4], "big")
        out.append((pos, marker, n))
        if marker == 0xDA:
            return out
        pos += n


def rewrite(data, fn):
    """`data` with each header segment (marker, payload) replaced by the
    bytes fn(marker, payload) gives, or kept where it gives None."""
    segs = header_segments(data)
    body = bytearray(data[:2])
    for pos, marker, n in segs:
        new = fn(marker, data[pos + 4:pos + n])
        body += data[pos:pos + n] if new is None else new
    return bytes(body + data[segs[-1][0] + segs[-1][2]:])


def seg(marker, payload):
    return bytes([0xFF, marker]) + (len(payload) + 2).to_bytes(2, "big") + \
        payload


def dqt16(marker, payload):
    """A DQT segment's tables in 16-bit precision (Pq = 1)."""
    if marker != 0xDB:
        return None
    out, p = bytearray(), 0
    while p < len(payload):
        out.append(0x10 | (payload[p] & 0xF))
        for v in payload[p + 1:p + 65]:
            out += (v * 3).to_bytes(2, "big")
        p += 65
    return seg(0xDB, bytes(out))


def with_fill(marker, payload):
    """Each header segment after runs of 0xFF fill bytes."""
    return b"\xff" * (1 + marker % 3) + seg(marker, payload)


def with_adobe(transform):
    app14 = seg(0xEE, b"Adobe" + bytes([0, 100, 0, 0, 0, 0, transform]))

    def fn(marker, payload):
        return app14 + seg(marker, payload) if marker == 0xDB else None
    return fn


def streams():
    """(name, bytes) of every kind of stream the port's codecs parse."""
    out = [(f"baseline_{ss}", _jpeg(ss)) for ss in
           ("420", "422", "444", "gray")]
    out.append(("baseline_420_odd", _jpeg("420", h=37, w=51, seed=3)))
    out.append(("optimized", _jpeg("420", optimize=True)))
    out.append(("dqt16", rewrite(_jpeg("420", seed=1), dqt16)))
    out.append(("progressive", _jpeg("420", progressive=True)))
    out.append(("progressive_dri",
                _jpeg("444", progressive=True, restart_interval=2)))
    out.append(("dri", _jpeg("420", restart_interval=3)))
    out.append(("dri_gray", _jpeg("gray", restart_interval=1)))
    out.append(("adobe", rewrite(_jpeg("444"), with_adobe(1))))
    out.append(("adobe_cut", rewrite(
        _jpeg("444"), lambda m, p: seg(0xEE, b"Adobe!") + seg(m, p)
        if m == 0xDB else None)))
    out.append(("fill", rewrite(_jpeg("420", restart_interval=2),
                                with_fill)))
    out.append(("arithmetic", oracle.jpeg_encode_arith(
        make_photo(40, 56, seed=2), 90, "420")))
    out.append(("arithmetic_progressive", oracle.jpeg_encode_arith(
        make_photo(40, 56, seed=2), 90, "444", progressive=True)))
    out.append(("lossless", encode_lossless_jpeg(
        make_photo(12, 17, seed=4), predictor=4)))
    out.append(("lossless_dri", encode_lossless_jpeg(
        make_photo(12, 17, seed=4)[..., 0], predictor=1,
        restart_interval=17)))
    return out


STREAMS = dict(streams())


@pytest.mark.parametrize("name", list(STREAMS))
def test_frame_equals_reference(name):
    frame, err = assert_same(STREAMS[name])
    assert err is None and frame["scans"]


def test_progressive_tables_are_snapshots_of_their_scan():
    """libjpeg's progressive streams define tables between scans: each scan
    keeps the tables as they stood when it began, like the JAX package."""
    frame = headers.parse_jpeg_structure(STREAMS["progressive"])
    snaps = [(sorted(s.dc_huff), sorted(s.ac_huff)) for s in frame.scans]
    assert len(set(map(str, snaps))) > 1
    assert frame.scans[0].ac_huff == {}


def test_kinds_reach_their_fields():
    f = {k: headers.parse_jpeg_structure(v) for k, v in STREAMS.items()}
    for tq, q in f["baseline_420"].quant.items():
        assert f["dqt16"].quant[tq].tolist() == (3 * q).tolist()
    assert f["dqt16"].quant[0].dtype == np.int32
    assert f["adobe"].adobe_transform == 1
    assert f["adobe_cut"].adobe_transform is None
    assert f["baseline_444"].adobe_transform is None
    assert f["dri"].restart_interval == 3
    assert f["dri"].scans[0].restart_interval == 3
    assert f["arithmetic"].marker == 0xC9
    assert f["lossless"].marker == 0xC3 and f["lossless"].is_lossless
    assert len(f["progressive"].scans) > 1
    # the walk skips the fill bytes: only the offsets move
    plain_dri = _jpeg("420", restart_interval=2)
    nofill = headers.parse_jpeg_structure(plain_dri)
    fill = sum(1 + m % 3 for _p, m, _n in header_segments(plain_dri))
    assert plain(f["fill"].quant) == plain(nofill.quant)
    assert plain(f["fill"].ac_huff) == plain(nofill.ac_huff)
    for a, b in zip(f["fill"].scans, nofill.scans):
        assert (a.data_start - b.data_start, a.data_end - b.data_end) == (
            fill, fill)
    for k, v in STREAMS.items():
        s = f[k].scans[-1]
        assert v[s.data_end:s.data_end + 2] == b"\xff\xd9", k


def _truncations(data):
    cuts = sorted({0, 1, 2, 3, 4, 5} | set(range(6, 700, 7)) |
                  {len(data) // 2, len(data) - 3, len(data) - 1})
    return [data[:c] for c in cuts if c < len(data)]


@pytest.mark.parametrize("name", ["baseline_420", "progressive", "dri",
                                  "arithmetic", "lossless", "fill",
                                  "adobe", "dqt16"])
def test_truncated_streams_fail_as_reference(name):
    failed = 0
    for cut in _truncations(STREAMS[name]):
        failed += assert_same(cut)[1] is not None
    assert failed > 0


@pytest.mark.parametrize("seed", range(6))
def test_corrupt_headers_fail_as_reference(seed):
    """Bytes of the header segments and around the scan's end set to
    random values: the same streams parse, with the same frames."""
    rng = np.random.default_rng(seed)
    base = list(STREAMS.values())[seed % len(STREAMS)]
    segs = header_segments(base)
    head = segs[-1][0] + segs[-1][2]
    # markers, lengths and the first bytes of every segment, most often
    soft = sorted({p + k for p, _m, _n in segs for k in range(1, 10)})
    outcomes = set()
    for _ in range(60):
        data = bytearray(base)
        for _ in range(int(rng.integers(1, 4))):
            u = rng.random()
            at = int(rng.choice(soft)) if u < 0.5 else \
                int(rng.integers(2, head)) if u < 0.8 else \
                int(rng.integers(head, len(data)))
            data[at] = int(rng.choice([0x00, 0xFF, 0xD0, 0xD9, 0xDA, 0xC0,
                                       0xDB, rng.integers(0, 256)]))
        outcomes.add(assert_same(bytes(data))[1] is None)
    assert outcomes == {True, False}


@pytest.mark.parametrize("case", ["empty", "short", "not_soi", "no_frame",
                                  "sos_before_sof", "sof_cut", "dqt_cut",
                                  "dri_cut", "sos_cut", "sos_component",
                                  "two_frames", "ff_fill_end", "stray_rst"])
def test_malformed_streams_fail_as_reference(case):
    good = STREAMS["baseline_420"]
    segs = {m: (p, n) for p, m, n in header_segments(good)}

    def drop(marker):
        p, n = segs[marker]
        return good[:p] + good[p + n:]

    def cut_seg(marker, keep):
        p, n = segs[marker]
        return good[:p + 2] + (keep + 2).to_bytes(2, "big") + \
            good[p + 4:p + 4 + keep] + good[p + n:]

    sof_p, sof_n = segs[0xC0]
    data = {
        "empty": b"",
        "short": b"\xff\xd8\xff",
        "not_soi": b"\x00" + good[1:],
        "no_frame": b"\xff\xd8\xff\xd9",
        "sos_before_sof": drop(0xC0),
        "sof_cut": cut_seg(0xC0, 10),
        "dqt_cut": cut_seg(0xDB, 40),
        "dri_cut": good[:2] + seg(0xDD, b"\x01") + good[2:],
        "sos_cut": cut_seg(0xDA, 5),
        "sos_component": good.replace(b"\xff\xda\x00\x0c\x03\x01",
                                      b"\xff\xda\x00\x0c\x03\x63"),
        "two_frames": good[:-2] + good[sof_p:sof_p + sof_n] + good[-2:],
        "ff_fill_end": good[:-2] + b"\xff" * 5,
        "stray_rst": good[:sof_p] + b"\xff\xd3\xff\xd8" + good[sof_p:],
    }[case]
    frame, err = assert_same(data)
    if case in ("two_frames", "ff_fill_end", "stray_rst"):
        assert err is None
        if case == "two_frames":  # a second SOF starts the frame afresh
            assert frame["scans"] == []
    else:
        assert frame is None


@pytest.mark.parametrize("words", [1, 7, 64])
def test_records_longer_than_their_room_are_walked_again(monkeypatch, words):
    datas = [STREAMS[k] for k in ("progressive", "baseline_420", "dri",
                                  "progressive_dri")]
    want = [plain(headers.parse_jpeg_structure(d)) for d in datas]
    monkeypatch.setattr(headers, "_RECORD_WORDS", words)
    got = headers.parse_jpeg_batch(datas)
    assert [(plain(f), e) for f, e in got] == [(w, None) for w in want]


def test_batch_fails_the_corrupt_stream_alone():
    datas = [_jpeg("420", seed=s) for s in range(6)]
    datas[2] = datas[2][:30]
    datas[4] = None
    got = headers.parse_jpeg_batch(datas)
    assert [e is None for _, e in got] == [True, True, False, True, False,
                                           True]
    res = jb.decode_batch_cuda(datas, DecodeParams(), device="cpu",
                               device_entropy=False)
    for k, r in enumerate(res):
        assert (r.array is None) == (k in (2, 4))
    alone = jb.decode_batch_cuda([datas[1]], DecodeParams(), device="cpu",
                                 device_entropy=False)
    assert np.array_equal(res[1].array.numpy(), alone[0].array.numpy())


@pytest.mark.parametrize("n", [1, 5, 40])
def test_native_stream_counter_counts_the_streams(n):
    datas = [_jpeg("420", seed=s % 3) for s in range(n)]
    trace.start_collect()
    try:
        res = jb.decode_batch_cuda(datas, DecodeParams(), device="cpu",
                                   device_entropy=False)
    finally:
        got = trace.stop_collect()
    assert all(r.array is not None for r in res)
    assert got["counters"]["imgcodec.jpeg.parse_native_streams"] == n


class _SpyPool:
    """An executor that notes the name of every function given to it."""

    def __init__(self, pool):
        self.pool, self.names = pool, []

    def submit(self, fn, *args, **kwargs):
        self.names.append(fn.__name__)
        return self.pool.submit(fn, *args, **kwargs)

    def map(self, fn, *iterables, **kwargs):
        self.names.append(fn.__name__)
        return self.pool.map(fn, *iterables, **kwargs)


def test_parse_submits_nothing_to_the_entropy_pool(monkeypatch):
    """40 streams: only the host entropy decode's `fill` reaches the pool."""
    datas = [_jpeg("420", seed=s % 4) for s in range(40)]
    spy = _SpyPool(jb._shared_pool("entropy", 2))
    monkeypatch.setitem(jb._EXECS, "entropy", spy)
    res = jb.decode_batch_cuda(datas, DecodeParams(), device="cpu",
                               device_entropy=False)
    assert all(r.array is not None for r in res)
    assert spy.names and set(spy.names) == {"fill"}


def test_threads_sharing_the_table_caches_get_their_own_frames(monkeypatch):
    """More threads than cores parse at once while the caches fill and
    empty (room for two segments): every frame is the one parsed alone,
    and no two frames share a table."""
    import sys
    import threading

    datas = [STREAMS[k] for k in ("baseline_420", "dqt16", "progressive",
                                  "optimized", "arithmetic", "lossless")]
    want = [plain(headers.parse_jpeg_structure(d)) for d in datas]
    monkeypatch.setattr(headers, "_CACHE_MAX", 2)
    errors, got = [], []

    def work():
        try:
            for _ in range(20):
                got.append(headers.parse_jpeg_batch(datas))
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=work) for _ in range(16)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in ts) and not errors
    assert len(got) == 16 * 20
    for out in got:
        assert [(plain(f), e) for f, e in out] == [(w, None) for w in want]
    a, b = got[0][0][0], got[1][0][0]
    assert a.quant[0] is not b.quant[0]
    assert a.dc_huff[0] is not b.dc_huff[0]
