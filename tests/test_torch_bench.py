"""bench_torch.py on the CPU: the whole bench at its --quick size with the
kernels' plain versions (every configuration present and correct, labelled
"platform": "cpu", a last line under 2000 characters), its refusal to run
on "cuda" without a card, its statistics, its order of passes, its trimming
of the last line and its dri corpus."""
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_corpus
from util import make_photo

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "bench_torch.py")
CONFIGS = {
    "jpeg_idx": ["decode_images_per_s"],
    "jpeg_dri": ["decode_images_per_s"],
    "jpeg_host": ["decode_images_per_s"],
    "jpeg_prog": ["prog_device_images_per_s", "prog_host_images_per_s"],
    "jpeg_encode": [f"{where}_{route}_route_images_per_s"
                    for where in ("card", "host")
                    for route in ("device", "host")],
    "transcode": ["images_per_s"],
    "j2k": ["decode_device_stage_images_per_s",
            "decode_host_stage_images_per_s"],
}


def _bench():
    spec = importlib.util.spec_from_file_location("bench_torch", BENCH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


bench = _bench()


def _run(*argv, timeout):
    return subprocess.run([sys.executable, BENCH, *argv], capture_output=True,
                          text=True, timeout=timeout, cwd=ROOT)


def test_quick_run_on_the_cpu():
    r = _run("--device", "cpu", "--quick", timeout=180)
    assert r.returncode == 0, r.stderr[-3000:]
    line = r.stdout.strip().splitlines()[-1]
    assert len(line) < 2000
    got = json.loads(line)
    assert got["correct"] is True and got["failures"] == 0
    assert got["attempted"] > 0 and got["failed"] == []
    assert got["device"]["platform"] == "cpu"
    assert "NVIDIA" not in line and "H100" not in line
    assert got["idle"] == {"jpeg_idx": "not measured",
                           "jpeg_encode": "not measured"}
    assert got["kernels"] == "not measured" and "kernels" in got["skipped"]
    for config, metrics in CONFIGS.items():
        assert set(metrics) <= set(got[config]), config
        for m in metrics:
            med, q1, q3, n = got[config][m]
            assert n == 4 and 0 < q1 <= med <= q3, (config, m)
    # every section's own line, above the last, names its platform
    sections = [json.loads(x.split(" ", 1)[1])
                for x in r.stdout.splitlines()[:-1] if x.startswith("[")]
    assert {s["config"] for s in sections} == set(CONFIGS)
    assert all(s["platform"] == "cpu" and s["correct"] for s in sections)
    routes = {s["config"]: s.get("routes") for s in sections}
    assert routes["jpeg_idx"] == {"idx": 32, "dri": 0, "host": 0,
                                  "reissued": 0}
    assert routes["jpeg_dri"]["dri"] == 32
    assert routes["jpeg_host"]["host"] == 32


@pytest.mark.parametrize("argv", [[], ["--device", "cuda", "--quick"],
                                  ["--section", "jpeg_idx"]])
def test_cuda_without_a_card_exits_nonzero(argv):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the run would measure it")
    r = _run(*argv, timeout=120)
    assert r.returncode == 2
    assert r.stdout.strip() == ""
    assert "no CUDA device" in r.stderr


@pytest.mark.parametrize("xs", [[3.0], [2.0, 1.0], [5, 1, 4, 2, 3],
                                [1601.3, 1650.2, 1702.9, 1588.1, 1620.0,
                                 1699.9, 1710.1, 1600.5, 1633.3, 1666.6]])
def test_quartiles_match_numpy(xs):
    med, q1, q3, n = bench.quartiles(xs)
    assert n == len(xs)
    np.testing.assert_allclose([med, q1, q3],
                               np.percentile(xs, [50, 25, 75]), rtol=1e-12)


def test_quartiles_of_nothing_raise():
    with pytest.raises(ValueError):
        bench.quartiles([])


def test_turns_alternate_a_b_b_a():
    assert bench.turns(["A", "B"], 4) == ["A", "B", "B", "A"] * 2
    assert bench.turns(["A", "B", "C"], 2) == ["A", "B", "C", "C", "B",
                                               "A"]
    assert bench.turns(["A"], 10) == ["A"] * 10
    with pytest.raises(ValueError):
        bench.turns(["A", "B"], 3)
    order = []
    rates = bench.run_turns({"A": lambda: order.append("A") or 1.0,
                             "B": lambda: order.append("B") or 2.0}, 2)
    assert order == ["A", "B", "B", "A"]
    assert rates == {"A": [1.0, 1.0], "B": [2.0, 2.0]}


def _card_record(name, metrics, spans, counters):
    return {"config": name, "attempted": 512, "failures": 0, "correct": True,
            "skipped": {}, "passes": {m: [1601.3, 1650.2] * 5
                                      for m in metrics},
            "ms_per_batch": {s: 123.456 for s in spans},
            "bytes_per_batch": {c: 150994944.0 for c in counters}}


def test_last_line_of_a_card_run_fits_and_trims_only_when_it_must():
    records = {name: _card_record(name, metrics,
                                  ["parse", "index_scan", "device_entropy",
                                   "pixel_stage", "device_wait"],
                                  ["h2d_bytes", "d2h_bytes"])
               for name, metrics in CONFIGS.items()}
    records["jpeg_idx"]["idle"] = {"busy_ms": 10.66, "wall_ms": 124.1,
                                   "share": 0.914}
    records["kernels"] = {
        "config": "kernels", "attempted": 0, "failures": 0, "correct": True,
        "skipped": {}, "passes": {},
        "kernels": {k: {"ms": 0.28712, "bound_ms": 0.14423,
                        "bound_by": "operations"}
                    for k in bench.KERNEL_PATHS}}
    device = {"platform": "gpu", "name": "NVIDIA H100 80GB HBM3",
              "power_limit": "700.00 W", "count": 1}
    out = bench.summary(device, 0, 41.2, records, [], {})
    line = bench.last_line(out)
    got = json.loads(line)
    assert len(line) < 2000 and got["correct"] is True
    assert "trimmed" not in got
    for config, metrics in CONFIGS.items():
        assert got[config][metrics[0]] == [1626, 1601, 1650, 10]
    assert got["kernels"]["K1"] == [0.287, 0.144, "o", 0]
    # a line that would be too long loses per-layer detail, named under
    # "trimmed", the later configurations first
    out = bench.summary(device, 0, 41.2, records, [], {
        "libjpeg_turbo": "x" * 200})
    got = json.loads(bench.last_line(out))
    assert got["trimmed"][0] == "j2k.MB"
    assert "ms" in got["jpeg_idx"]


def test_failed_section_makes_the_run_incorrect():
    out = bench.summary({"platform": "cpu"}, 0, 0.0, {}, ["j2k"], {})
    assert out["correct"] is False and out["failed"] == ["j2k"]


@pytest.mark.parametrize("seed", [0, 5])
def test_dri_corpus_equals_the_committed_streams(seed):
    """The bench makes its restart-marker streams with the port's encoder;
    they are the bytes tests/torch_corpus committed."""
    photo = make_photo(torch_corpus.DRI_H, torch_corpus.DRI_W, seed=seed)
    got = bench.encode_dri(photo, torch_corpus.DRI_Q, torch_corpus.DRI_RI)
    assert got == torch_corpus.dri_streams()[seed]
