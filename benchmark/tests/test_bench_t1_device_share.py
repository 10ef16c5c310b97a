"""The reader of the share of code-blocks whose Tier-1 runs on the card:
the value from a made-up run, and no value where the program has no such
counter (a program that predates it) or decoded no code-block."""
import os
from types import SimpleNamespace

import pytest

from benchmark import run
from benchmark.tests.conftest import ROOT

K = "imgcodec.jpeg2k."


def reader():
    return run.load_file(os.path.join(
        ROOT, "benchmark", "metrics", "j2k.t1_device_block_share.py"), "m")


@pytest.mark.parametrize("counters,want", [
    ({K + "codeblocks": 1536, K + "codeblocks_device": 1536}, 100.0),
    ({K + "codeblocks": 1536, K + "codeblocks_device": 384}, 25.0),
    ({K + "codeblocks": 1536, K + "codeblocks_device": 0}, 0.0),
    ({K + "codeblocks": 1536}, None),
    ({K + "codeblocks_device": 0}, None),
    ({}, None),
], ids=["all", "a_quarter", "none", "no_device_counter", "no_blocks",
        "no_counters"])
def test_share_reader(counters, want):
    got = reader().read(SimpleNamespace(counters=counters, pulled=[]))
    assert got == (None if want is None else pytest.approx(want))
