"""On the card: a short run of every cell through the command's own path,
correct and with every metric the cell reports.

    python -m pytest benchmark/tests -q -m gpu
"""
import json
import os

import pytest

from benchmark import run
from benchmark.tests.conftest import ROOT

BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_a_short_run_is_correct(cell, cuda):
    result = run.run_cell(cell, 2 ** 31 + 3, 3.0, False)
    assert result["correct"] is True, result["checks"]
    assert result["device"]["kind"]
    want = {m["name"] for m in run.metrics_for(BENCH, cell, False)}
    assert want <= set(result["metrics"])
