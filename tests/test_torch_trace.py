"""The port's span collector (`core/trace.py`) on the CPU: a record per span
with parent and batch ids across threads, CPU and self time, pool work
charged to its span, nothing but the NVTX pair while collection is off, and
the layers' spans on the decode and encode paths."""
import os
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import nvimagecodec_tpu_torch as port
from nvimagecodec_tpu_torch.codecs.jpeg import batch as jb
from nvimagecodec_tpu_torch.codecs.jpeg import batch_encode as be
from nvimagecodec_tpu_torch.core import trace
from nvimagecodec_tpu_torch.core.interfaces import DecodeParams
from nvimagecodec_tpu_torch.ops.resize import resize
from nvimagecodec_tpu_torch.pipeline import decode_batches
from util import make_photo

PKG = os.path.dirname(port.__file__)


@pytest.fixture
def collect():
    """Collection on for the test; `got()` stops it and returns the
    result once."""
    trace.start_collect()
    out = {}

    def got():
        if "d" not in out:
            out["d"] = trace.stop_collect()
        return out["d"]

    yield got
    got()


def busy(cpu_s: float) -> None:
    """Burn `cpu_s` of this thread's CPU time."""
    end = time.thread_time_ns() + int(cpu_s * 1e9)
    while time.thread_time_ns() < end:
        pass


def by_name(events):
    out = {}
    for e in events:
        out.setdefault(e["name"], []).append(e)
    return out


def test_parent_and_batch_of_nested_spans(collect):
    with trace.span("root"):
        with trace.span("mid"):
            with trace.span("leaf"):
                pass
    with trace.span("other"):
        pass
    ev = {e["name"]: e for e in collect()["events"]}
    assert ev["root"]["parent"] is None
    assert ev["mid"]["parent"] == ev["root"]["id"]
    assert ev["leaf"]["parent"] == ev["mid"]["id"]
    assert {ev[k]["batch"] for k in ("root", "mid", "leaf")} == \
        {ev["root"]["id"]}
    # a second request is a batch of its own
    assert ev["other"]["batch"] == ev["other"]["id"] != ev["root"]["id"]
    assert len({e["id"] for e in ev.values()}) == 4
    for e in ev.values():
        assert e["start_ns"] <= e["end_ns"]
        assert e["thread"] == threading.get_ident()


@pytest.mark.parametrize("hops", [1, 2])
def test_parent_and_batch_across_bound_pool_tasks(collect, hops):
    """A task submitted through `bind` sees the submitter's span as its
    parent, on another thread, through as many pools as it crosses."""
    pools = [ThreadPoolExecutor(2) for _ in range(hops)]

    def task(k):
        with trace.span(f"hop{k}"):
            if k + 1 < hops:
                return pools[k + 1].submit(trace.bind(task), k + 1).result()
            return threading.get_ident()

    try:
        with trace.span("root"):
            far = pools[0].submit(trace.bind(task), 0).result(timeout=30)
    finally:
        for p in pools:
            p.shutdown()
    ev = {e["name"]: e for e in collect()["events"]}
    root = ev["root"]
    parent = root
    for k in range(hops):
        e = ev[f"hop{k}"]
        assert e["parent"] == parent["id"] and e["batch"] == root["id"]
        assert e["thread"] != root["thread"]
        parent = e
    assert parent["thread"] == far


def test_unbound_pool_task_is_a_root(collect):
    with ThreadPoolExecutor(1) as pool, trace.span("root"):
        pool.submit(lambda: trace.span("loose").__enter__().__exit__(
            None, None, None)).result(timeout=30)
    ev = {e["name"]: e for e in collect()["events"]}
    assert ev["loose"]["parent"] is None
    assert ev["loose"]["batch"] == ev["loose"]["id"]


@pytest.mark.parametrize("work,counted", [("busy", True), ("sleep", False)])
def test_cpu_time_counts_work_not_waits(collect, work, counted):
    with trace.span("x"):
        if work == "busy":
            busy(0.05)
        else:
            time.sleep(0.05)
    got = collect()
    cpu, wall = got["counters"]["x.cpu_s"], got["spans"]["x"]
    assert wall >= 0.05
    if counted:
        assert 0.05 <= cpu <= wall + 0.01
    else:
        assert cpu < 0.02


def test_charges_from_pool_threads_add_to_the_span(collect):
    def task(_k):
        with trace.charge("work"):
            busy(0.02)

    with ThreadPoolExecutor(4) as pool:
        with trace.span("work"):
            list(pool.map(trace.bind(task), range(4)))
        with trace.span("unbound"):
            # no span of that name in the task's context: charged by name
            list(pool.map(lambda k: task(k), range(2)))
    got = collect()
    ev = by_name(got["events"])
    own = ev["work"][0]["cpu_ns"] * 1e-9
    assert own < 0.04  # the caller waited
    assert got["counters"]["work.cpu_s"] >= own + 6 * 0.02
    # no record of a charge
    assert set(ev) == {"work", "unbound"}


def test_inline_charge_is_not_counted_twice(collect):
    """A pool task that runs on the span's own thread is in the span's own
    CPU time already."""
    with trace.span("x"):
        with trace.charge("x"):
            busy(0.05)
    got = collect()
    assert 0.05 <= got["counters"]["x.cpu_s"] < 0.09


@pytest.mark.parametrize("where", ["child_away", "charge_under_child"])
def test_cpu_under_a_span_goes_up_to_it(collect, where):
    """A root's CPU takes in the work of every span and charge under it:
    a child span on another thread, or a pool charge to a child on the
    root's own thread."""
    def away():
        with trace.span("child"):
            busy(0.03)

    def charged():
        with trace.charge("child"):
            busy(0.03)

    with ThreadPoolExecutor(1) as pool, trace.span("root"):
        if where == "child_away":
            pool.submit(trace.bind(away)).result(timeout=30)
        else:
            with trace.span("child"):
                pool.submit(trace.bind(charged)).result(timeout=30)
    got = collect()
    child = got["counters"]["child.cpu_s"]
    root = got["counters"]["root.cpu_s"]
    own = by_name(got["events"])["root"][0]["cpu_ns"] * 1e-9
    assert child >= 0.03
    assert root >= child
    assert own < 0.02 and root - own >= 0.03


def test_self_time_is_wall_less_children_on_the_thread(collect):
    def remote():
        with trace.span("remote"):
            time.sleep(0.02)

    with ThreadPoolExecutor(1) as pool, trace.span("outer"):
        time.sleep(0.01)
        with trace.span("inner"):
            time.sleep(0.02)
            with trace.span("innermost"):
                time.sleep(0.01)
        with trace.span("inner2"):
            pass
        # a child on another thread takes nothing from the self time
        pool.submit(trace.bind(remote)).result(timeout=30)
    got = collect()
    sp, c = got["spans"], got["counters"]
    assert c["outer.self_s"] == pytest.approx(
        sp["outer"] - sp["inner"] - sp["inner2"], abs=1e-9)
    assert c["inner.self_s"] == pytest.approx(
        sp["inner"] - sp["innermost"], abs=1e-9)
    assert c["innermost.self_s"] == pytest.approx(sp["innermost"], abs=1e-9)
    assert c["outer.self_s"] >= 0.03  # its own sleep and the remote wait
    assert c["remote.self_s"] == pytest.approx(sp["remote"], abs=1e-9)


def test_spans_keep_their_wall_time_meaning(collect):
    """"spans" is the wall time of each name summed over its records, as
    before the records existed."""
    def task(_k):
        with trace.span("w"):
            time.sleep(0.01)

    with ThreadPoolExecutor(3) as pool:
        list(pool.map(trace.bind(task), range(3)))
    got = collect()
    ev = by_name(got["events"])["w"]
    assert len(ev) == 3
    assert got["spans"]["w"] == pytest.approx(
        sum(e["end_ns"] - e["start_ns"] for e in ev) * 1e-9)
    assert got["spans"]["w"] >= 0.03


class _NoClock:
    def __getattr__(self, name):
        raise AssertionError(f"time.{name} read with collection off")


def test_off_makes_no_record_and_reads_no_clock(monkeypatch):
    assert trace._COLLECT is None
    monkeypatch.setattr(trace, "time", _NoClock())
    fn = lambda: 7  # noqa: E731
    assert trace.bind(fn) is fn
    with trace.span("x"):
        with trace.charge("x"):
            pass
    monkeypatch.undo()
    assert trace.stop_collect() == {"spans": {}, "counters": {},
                                    "events": []}


def test_a_span_open_across_stop_is_dropped():
    trace.start_collect()
    s = trace.span("across")
    s.__enter__()
    first = trace.stop_collect()
    trace.start_collect()
    s.__exit__(None, None, None)
    second = trace.stop_collect()
    assert "across" not in first["spans"] and "across" not in second["spans"]
    assert not second["events"]


class _FakeNvtx:
    def __init__(self):
        self.calls = []

    def range_push(self, msg):
        self.calls.append(("push", msg))

    def range_pop(self):
        self.calls.append(("pop",))


@pytest.mark.parametrize("collecting", [False, True])
def test_nvtx_ranges_come_in_pairs(monkeypatch, collecting):
    """Push and pop through the `torch.cuda.nvtx` attribute, one pair a
    span, an exception included: what the benchmark's range hook counts on."""
    fake = _FakeNvtx()
    monkeypatch.setattr(torch.cuda, "nvtx", fake)
    monkeypatch.setattr(trace, "_NVTX", [True])
    if collecting:
        trace.start_collect()
    try:
        with trace.span("a"):
            with trace.span("b"):
                pass
            with pytest.raises(ValueError):
                with trace.span("c"):
                    raise ValueError("inside")
    finally:
        got = trace.stop_collect()
    assert fake.calls == [("push", "a"), ("push", "b"), ("pop",),
                          ("push", "c"), ("pop",), ("pop",)]
    assert bool(got["events"]) == collecting


def test_collector_under_contention():
    """Many threads opening spans and charging at once, with a short switch
    interval: every record and every charge is kept."""
    nthreads, per = 16, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    trace.start_collect()
    try:
        def task(_k):
            for _ in range(per):
                with trace.span("s"):
                    with trace.charge("s"):
                        pass
                trace.add_count("n", 1)

        with ThreadPoolExecutor(nthreads) as pool:
            list(pool.map(trace.bind(task), range(nthreads)))
    finally:
        sys.setswitchinterval(old)
        got = trace.stop_collect()
    assert len(got["events"]) == nthreads * per
    assert got["counters"]["n"] == nthreads * per
    assert len({e["id"] for e in got["events"]}) == nthreads * per


def test_no_stderr_printer_is_left():
    for root, _dirs, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(root, f)) as fh:
                    assert "TPUIMGCODEC_TRACE" not in fh.read(), f


# -- the layers' spans on the CPU --------------------------------------------

DECODE_SPANS = ["imgcodec.jpeg.parse", "imgcodec.jpeg.staging",
                "imgcodec.jpeg.host_entropy", "imgcodec.jpeg.upload",
                "imgcodec.jpeg.pixel_stage", "imgcodec.jpeg.idct",
                "imgcodec.jpeg.upsample_color"]
ENCODE_SPANS = ["imgcodec.jpeg.encode_device_stage",
                "imgcodec.jpeg.encode_stack", "imgcodec.jpeg.encode_pixels",
                "imgcodec.jpeg.encode_d2h_wait",
                "imgcodec.jpeg.encode_host_entropy"]
NBATCH = 40  # over 32: the host entropy decode goes to the entropy pool


@pytest.fixture(scope="module")
def streams():
    imgs = [make_photo(48, 64, seed=s) for s in range(NBATCH)]
    return [r.data for r in be.encode_batch_cuda(imgs, None, "cpu")]


@pytest.fixture(scope="module")
def codec_run(streams):
    """One host-route decode and one encode of its images (half of them
    as numpy arrays, which the encode gathers on its pool), traced."""
    trace.start_collect()
    try:
        res = jb.decode_batch_cuda(streams, DecodeParams(), device="cpu",
                                   device_entropy=False)
        imgs = [r.array if k % 2 else r.array.numpy()
                for k, r in enumerate(res)]
        enc = be.encode_batch_cuda(imgs, None, "cpu")
    finally:
        got = trace.stop_collect()
    assert all(r.array is not None for r in res)
    assert all(r.data for r in enc)
    return got


@pytest.mark.parametrize("name", DECODE_SPANS + ENCODE_SPANS)
def test_layer_spans_and_their_counters(codec_run, name):
    got = codec_run
    assert got["spans"].get(name, 0) > 0, name
    assert got["counters"][name + ".cpu_s"] > 0
    assert 0 <= got["counters"][name + ".self_s"] <= got["spans"][name]


@pytest.mark.parametrize("parent,children", [
    ("imgcodec.jpeg.pixel_stage",
     ("imgcodec.jpeg.idct", "imgcodec.jpeg.upsample_color")),
    ("imgcodec.jpeg.encode_device_stage",
     ("imgcodec.jpeg.encode_stack", "imgcodec.jpeg.encode_pixels",
      "imgcodec.jpeg.encode_d2h_wait"))])
def test_stage_children(codec_run, parent, children):
    ev = by_name(codec_run["events"])
    pids = {e["id"] for e in ev[parent]}
    for c in children:
        assert all(e["parent"] in pids for e in ev[c]), c
    sp = codec_run["spans"]
    assert codec_run["counters"][parent + ".self_s"] == pytest.approx(
        sp[parent] - sum(sp[c] for c in children), abs=1e-9)


@pytest.mark.parametrize("name", ["imgcodec.jpeg.parse",
                                  "imgcodec.jpeg.host_entropy",
                                  "imgcodec.jpeg.encode_stack",
                                  "imgcodec.jpeg.encode_host_entropy"])
def test_pool_work_is_charged_to_its_layer(codec_run, name):
    """The calling thread waits inside these spans while the pool works:
    the charges put the pool's CPU time above the caller's own. The parse
    is one native walk on the calling thread: no pool works for it, and
    its CPU time is the caller's own."""
    own = sum(e["cpu_ns"] for e in by_name(codec_run["events"])[name])
    if name == "imgcodec.jpeg.parse":
        assert codec_run["counters"][name + ".cpu_s"] == pytest.approx(
            own * 1e-9, abs=1e-9)
        return
    assert codec_run["counters"][name + ".cpu_s"] > own * 1e-9


def test_pipeline_batch_is_the_root_across_threads():
    """decode_batches' root span reaches the decoder's spans through the
    prefetch thread and the scheduler's pool; a resize gets its own span."""
    batches = [[make_photo(48, 64, seed=s) for s in range(b, b + 3)]
               for b in (0, 3)]
    data = [[r.data for r in be.encode_batch_cuda(b, None, "cpu")]
            for b in batches]
    trace.start_collect()
    try:
        outs = list(decode_batches(data, decoder=port.Decoder(device="cpu"),
                                   depth=2))
        resize(torch.stack([o.array for o in outs[0]]), 24, 32)
    finally:
        got = trace.stop_collect()
    ev = by_name(got["events"])
    roots = ev["imgcodec.pipeline.batch"]
    assert len(roots) == 2
    assert all(r["parent"] is None for r in roots)
    root_ids = {r["id"] for r in roots}
    byid = {e["id"]: e for e in got["events"]}
    for name in ("imgcodec.decode.cuda_jpeg_hybrid_decoder",
                 "imgcodec.jpeg.parse", "imgcodec.jpeg.pixel_stage"):
        for e in ev[name]:
            assert e["batch"] in root_ids, name
    for e in ev["imgcodec.decode.cuda_jpeg_hybrid_decoder"]:
        root = byid[e["batch"]]
        assert e["thread"] != root["thread"]
    # each batch's spans keep to their own root
    assert {e["batch"] for e in ev["imgcodec.jpeg.parse"]} == root_ids
    assert got["spans"]["imgcodec.resize"] > 0
    assert ev["imgcodec.resize"][0]["parent"] is None
    # the root's CPU takes in its decode on the scheduler's threads
    dec = "imgcodec.decode.cuda_jpeg_hybrid_decoder"
    assert got["counters"]["imgcodec.pipeline.batch.cpu_s"] >= \
        got["counters"][dec + ".cpu_s"] >= \
        got["counters"]["imgcodec.jpeg.host_entropy.cpu_s"]
    assert 0 <= got["counters"][dec + ".self_s"] < got["spans"][dec]
    assert np.isfinite(got["counters"]["imgcodec.resize.cpu_s"])
