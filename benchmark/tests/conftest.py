"""The benchmark's own tests: CPU runs at tiny sizes with the kernels'
plain versions, and `gpu` tests that need the card (they decide inside a
fixture whether there is one, never at import).

    python -m pytest benchmark/tests -q            # here, on the CPU
    python -m pytest benchmark/tests -q -m gpu     # on the card
"""
import glob
import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
CELLS = [w["name"] for w in BENCH["workloads"]]
# every traffic file, those BENCHMARK.json does not name yet included
TRAFFIC = sorted(os.path.basename(p)[:-5] for p in glob.glob(
    os.path.join(ROOT, "benchmark", "traffic", "*.json")))


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "gpu: needs a CUDA device (skips without one)")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def bench_all() -> dict:
    """BENCHMARK.json with a one-chip cell for every traffic file."""
    b = json.loads(json.dumps(BENCH))
    for name in TRAFFIC:
        if name not in CELLS:
            t = json.load(open(os.path.join(ROOT, "benchmark", "traffic",
                                            f"{name}.json")))
            b["workloads"].append({"name": name, "config": t["config"],
                                   "traffic": name, "chips": 1, "why": "-"})
    return b


# tiny traffic: the same code paths at CPU sizes
TINY = {"corpus": {"photos": 4, "photo_size": [48, 64], "streams": 8,
                   "geometry": [[48, 64, 1.0]]},
        "batch": 16, "warmup_batches": 1, "sample_every": 1, "judge_max": 4}
MIXED = dict(TINY, corpus={
    "photos": 4, "photo_size": [64, 64], "streams": 32,
    "geometry": [[48, 64, 0.5], [64, 48, 0.3]], "random_share": 0.2,
    "random_range": [20, 64]})
THUMB = dict(TINY, resize={"height": 24, "width": 32, "interp": "bilinear"})


def tiny(name: str) -> dict:
    if "mixed" in name:
        return MIXED
    return THUMB if "thumb" in name else TINY
