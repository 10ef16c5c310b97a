"""No module a run loads has the top-level name jax, jaxlib, flax or
nvimagecodec_tpu (compared whole: the program's own name begins with the
JAX package's), and none comes from the repository's tests, tools or
scripts."""
import json
import subprocess
import sys

from benchmark import run
from benchmark.tests.conftest import ROOT

PROBE = r"""
import json, sys
sys.path.insert(0, {root!r})
from benchmark import run
from benchmark.tests.conftest import TRAFFIC, bench_all, tiny
for name in TRAFFIC:
    run.run_cell(name, 5, 2.0, name == "decode_mixed_host", device="cpu",
                 overrides=tiny(name), gen_workers=1, bench=bench_all())
print(json.dumps({{"top": sorted({{m.split(".")[0] for m in sys.modules}}),
                  "files": sorted({{getattr(m, "__file__", None) or ""
                                   for m in list(sys.modules.values())}})}}))
"""


def test_a_run_loads_no_jax_and_no_helper():
    r = subprocess.run([sys.executable, "-c", PROBE.format(root=ROOT)],
                       cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert "nvimagecodec_tpu_torch" in got["top"]
    assert not set(got["top"]) & set(run.FORBIDDEN_MODULES)
    for f in got["files"]:
        for bad in run.FORBIDDEN_FILES:
            assert not f.startswith(f"{ROOT}/{bad}"), f


def test_whole_name_comparison(monkeypatch):
    monkeypatch.setitem(sys.modules, "nvimagecodec_tpu_torch_extra",
                        sys.modules[__name__])
    assert run.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "nvimagecodec_tpu.core",
                        sys.modules[__name__])
    assert run.loaded_forbidden() == ["nvimagecodec_tpu"]


PLANTED = r"""
import shutil, sys
sys.path.insert(0, {root!r})
sys.path.insert(0, {tmp!r})
from benchmark import run
from benchmark.tests.conftest import bench_all, tiny
metrics = {tmp!r} + "/metrics"
shutil.copytree(run.METRICS, metrics)
with open(metrics + "/planted.py", "w") as f:
    f.write("import jax\nUNIT = 's'\nSOURCE = 'host_clock'\n"
            "def read(run):\n    return 1.0\n")
run.METRICS = metrics
bench = bench_all()
cell = bench["workloads"][0]["name"]
bench["end_to_end"].append({{"name": "planted", "unit": "s",
                            "better": "lower", "bound": 0.25,
                            "source": "host_clock", "workloads": [cell]}})
sys.exit(run.main(["--workload", cell, "--seed", "7", "--seconds", "1",
                   "--trace", "0"], device="cpu", overrides=tiny(cell),
                  gen_workers=1, bench=bench))
"""


def test_a_metric_reader_that_loads_jax_fails_the_run(tmp_path):
    """The look for JAX comes after the judge and every metric reader: a
    reader that imports `jax` (here a stand-in module) ends the run with
    exit code 3 and no result."""
    (tmp_path / "jax").mkdir()
    (tmp_path / "jax" / "__init__.py").write_text("")
    r = subprocess.run([sys.executable, "-c",
                        PLANTED.format(root=ROOT, tmp=str(tmp_path))],
                       cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert r.returncode == 3, r.stderr[-3000:]
    assert r.stdout.strip() == ""
    assert "jax" in r.stderr
