"""BENCHMARK.json and the files it names: everything found by name, each
name within the contract's letters and lengths."""
import json
import os
import re

import pytest

from benchmark import run, tracing, work
from benchmark.tests.conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))


def test_cells_find_their_files():
    for w in BENCH["workloads"]:
        _w, traffic, config = run.cell_of(BENCH, w["name"])
        assert config["name"] == w["config"]
        for key in ("entry", "check"):
            assert os.path.exists(os.path.join(
                ROOT, "benchmark", key + ("ies" if key == "entry" else "s"),
                f"{traffic[key]}.py")) or traffic[key]
        assert len(w["why"]) <= 200 and NAME.match(w["name"])


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_files_agree(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    if m["name"] == "setup_s":
        return
    mod = run.load_file(os.path.join(ROOT, "benchmark", "metrics",
                                     f"{m['name']}.py"), "m")
    assert mod.UNIT == m["unit"] and mod.SOURCE == m["source"]
    for cell in m.get("workloads", []):
        assert cell in {w["name"] for w in BENCH["workloads"]}


def test_configs_name_their_files():
    for c in BENCH["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert c["file"].startswith("benchmark/")


def test_blocks_of_a_frame():
    assert work.blocks(375, 500) == 24 * 32 * 6
    assert work.blocks(224, 224) == 14 * 14 * 6
    ops, nbytes = work.transform_work([(375, 500)], "420")
    assert ops == 4608 * 2048 and nbytes == 4608 * 64 * 3


def test_roofline_share_is_least_time_over_time():
    peak = work.peaks("NVIDIA H100 80GB HBM3")
    assert peak is not None
    pct = work.roofline_pct(0.0, 3.35e12, 2.0, "NVIDIA H100 80GB HBM3")
    assert pct == pytest.approx(50.0)
    assert work.roofline_pct(1.0, 1.0, 1.0, "no such card") is None


def test_union_and_gaps():
    iv = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0)]
    assert tracing.union_length(iv) == 4.0
    assert tracing.gaps(iv, 0.0, 10.0) == [(3.0, 5.0), (6.0, 10.0)]


def test_summary_of_a_trace():
    ev = [{"ph": "X", "name": tracing.WINDOW_NAME, "cat": "user_annotation",
           "ts": 0, "dur": 100},
          {"ph": "X", "name": "idct_blocks_kernel(short const*, int)",
           "cat": "kernel", "ts": 10, "dur": 20},
          {"ph": "X", "name": "k2", "cat": "kernel", "ts": 20, "dur": 20},
          {"ph": "X", "name": "Memcpy HtoD", "cat": "gpu_memcpy",
           "ts": 90, "dur": 20},
          {"ph": "X", "name": "imgcodec.jpeg.parse",
           "cat": "user_annotation", "ts": 40, "dur": 45}]
    s = tracing.summarise(ev)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx(40e-6)
    assert s["kernels_s"]["idct_blocks_kernel"] == pytest.approx(20e-6)
    idle = dict(s["idle_gaps"])
    # a gap goes to the span that covers most of it
    assert idle["imgcodec.jpeg.parse"] == pytest.approx(50e-6)
    assert idle["no program span"] == pytest.approx(10e-6)


def test_host_spans_label_the_gaps():
    ev = [{"ph": "X", "name": tracing.WINDOW_NAME, "cat": "user_annotation",
           "ts": 1000, "dur": 100},
          {"ph": "X", "name": "k", "cat": "kernel", "ts": 1000, "dur": 50}]
    # the window began at 2.0 s on the host clock: a span 2.00006 to
    # 2.0001 s covers the gap from 1050 to 1100 us of the trace
    s = tracing.summarise(ev, [(2.00005, 2.0001, "imgcodec.jpeg.parse")],
                          2.0)
    assert dict(s["idle_gaps"]) == {"imgcodec.jpeg.parse":
                                    pytest.approx(50e-6)}


def test_kernel_names():
    assert tracing.kernel_name("void at::native::(anonymous namespace)::"
                               "cat_kernel<int>(int*)") == \
        "at::native::cat_kernel"
    assert tracing.kernel_name("idct_blocks_kernel(short const*, int)") == \
        "idct_blocks_kernel"
    assert tracing.kernel_name("<unknown>") == "<unknown>"


def test_the_innermost_span_labels_a_gap():
    ev = [{"ph": "X", "name": tracing.WINDOW_NAME, "cat": "user_annotation",
           "ts": 0, "dur": 100},
          {"ph": "X", "name": "k", "cat": "kernel", "ts": 0, "dur": 50}]
    spans = [(0.0, 100e-6, "outer"), (40e-6, 100e-6, "inner"),
             (50e-6, 55e-6, "brief")]
    s = tracing.summarise(ev, spans, 0.0)
    assert dict(s["idle_gaps"]) == {"inner": pytest.approx(50e-6)}


def test_every_gap_of_a_window_is_labelled():
    ev = [{"ph": "X", "name": tracing.WINDOW_NAME, "cat": "user_annotation",
           "ts": 0, "dur": 100}]
    ev += [{"ph": "X", "name": "k", "cat": "kernel", "ts": t, "dur": 10}
           for t in (0, 30, 60)]
    spans = [(0.0, 100e-6, "outer"), (10e-6, 30e-6, "first"),
             (40e-6, 60e-6, "second")]
    s = tracing.summarise(ev, spans, 0.0)
    assert dict(s["idle_gaps"]) == {"first": pytest.approx(20e-6),
                                    "second": pytest.approx(20e-6),
                                    "outer": pytest.approx(30e-6)}
