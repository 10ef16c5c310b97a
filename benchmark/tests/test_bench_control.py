"""The control (the plain reference in TF32, in the program's place) fails
a number of every check at a size a test run holds, while the program's
CPU path passes at that size (test_bench_harness). At the cells' own sizes
the control runs on the card machine:

    python3 benchmark/control.py --workload CELL --seeds a,b,c
"""
import pytest

from benchmark.control import control_numbers
from benchmark.tests.conftest import TRAFFIC, bench_all

SMALL = {"corpus": {"photos": 2, "photo_size": [120, 160], "streams": 4,
                    "geometry": [[120, 160, 1.0]], "random_share": 0.0},
         "batch": 16, "sample_every": 1, "judge_max": 4}


@pytest.mark.parametrize("name", TRAFFIC)
def test_the_control_fails_a_number(name):
    small = dict(SMALL, resize={"height": 64, "width": 64,
                                "interp": "bilinear"}) \
        if "thumb" in name else SMALL
    got = control_numbers(name, 2 ** 31 + 17, 4, overrides=small, workers=1,
                          bench=bench_all())
    assert got["judged"] >= 1
    assert got["failed_one"], got
