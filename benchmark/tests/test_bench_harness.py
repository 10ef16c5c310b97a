"""Every cell end to end at a tiny size on the CPU (the kernels' plain
versions), its last line, and the faults that must make `correct` false."""
import json
import subprocess
import sys

import pytest
import torch

from benchmark import run
from benchmark.tests.conftest import (BENCH, CELLS, ROOT, TRAFFIC,
                                      bench_all, tiny)

KEYS = {"correct", "attempted", "failed", "metrics", "device"}
SEED = 2 ** 31 + 977


def run_tiny(name, trace=False, seconds=4.0, seed=SEED):
    return run.run_cell(name, seed, seconds, trace, device="cpu",
                        overrides=tiny(name), gen_workers=1,
                        bench=bench_all())


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_end_to_end(cell, trace, capsys):
    result = run_tiny(cell, trace)
    run.report(result)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert KEYS <= set(line)
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert line["device"]["platform"] == "cpu"
    names = set(line["metrics"])
    if trace:
        # the pipeline waits for device events, which a CPU run has none of
        spans = {m["name"] for m in run.metrics_for(BENCH, cell, True)
                 if m["source"] == "program_span"
                 and not m["name"].startswith("pipeline.")}
        assert spans and spans <= names
        assert "setup_s" not in names
    else:
        assert {m["name"] for m in run.metrics_for(BENCH, cell, False)} \
            <= names
    # each number compared is on its own line, last on stderr
    last = err.strip().splitlines()[-len(line["checks"]):]
    assert all(ln.startswith("check ") and "limit" in ln for ln in last)


@pytest.mark.parametrize("name", [t for t in TRAFFIC if t not in CELLS])
def test_traffic_kept_for_later_cells_runs(name):
    """Traffic files BENCHMARK.json does not name yet run end to end at the
    tiny size, and those on the program's host route are correct there.
    Those on its default route are not judged here: on this corpus the
    native index scan's fault (PERF.md, Open questions) makes them read
    `correct: false` until the program is fixed."""
    result = run_tiny(name, seconds=2.0)
    assert KEYS <= set(result)
    assert result["attempted"] > 0 and result["failed"] == 0
    _w, traffic, _c = run.cell_of(bench_all(), name)
    if "device_entropy=false" in traffic.get("decoder_options", ""):
        assert result["correct"] is True, result["checks"]


def test_same_seed_same_work():
    a = run_tiny("decode_mixed_host", seconds=1.0)
    b = run_tiny("decode_mixed_host", seconds=1.0)
    assert a["checks"] == b["checks"]


@pytest.fixture
def one_sample_off(monkeypatch):
    """Every decoded image leaves the pixel stage with one sample off by
    40: an answer altered where it is produced."""
    from nvimagecodec_tpu_torch.codecs.jpeg import batch

    real = batch._pixel_stage

    def altered(*a, **k):
        img = real(*a, **k).clone()
        img[..., 0, 0, 0] = (img[..., 0, 0, 0].int() + 40).clamp(0, 255).to(
            img.dtype)
        return img

    monkeypatch.setattr(batch, "_pixel_stage", altered)


@pytest.mark.parametrize("name", ["decode_uniform_host",
                                  "decode_mixed_host"])
def test_an_altered_answer_is_not_correct(name, one_sample_off):
    assert run_tiny(name)["correct"] is False


@pytest.mark.parametrize("name", ["transcode_full_host",
                                  "transcode_thumb224_host"])
def test_an_altered_coefficient_is_not_correct(name, monkeypatch):
    """A transcode's answer is its coefficients: one off by 2 in every
    block, where the encoder produces them."""
    from nvimagecodec_tpu_torch.codecs.jpeg import encode

    real = encode.fdct_quant_blocks

    def altered(x, M):
        out = real(x, M).clone()
        out[..., 3] += 2
        return out

    monkeypatch.setattr(encode, "fdct_quant_blocks", altered)
    result = run_tiny(name)
    assert result["correct"] is False
    assert result["checks"]["coefs_outside"]["value"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_a_dropped_image_is_not_correct(name, monkeypatch):
    """Half of each batch left out: failed counts them."""
    from nvimagecodec_tpu_torch import api

    real = api.Decoder.decode

    def half(self, data, *a, **k):
        outs = real(self, data, *a, **k)
        return [o if i % 2 == 0 else None for i, o in enumerate(outs)]

    monkeypatch.setattr(api.Decoder, "decode", half)
    result = run_tiny(name)
    assert result["failed"] > 0 and result["correct"] is False


def test_no_card_exits_2_without_a_result():
    """The command itself refuses a machine with no CUDA device."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 2
    assert r.stdout.strip() == ""
