"""The CUDA port stands alone: no file of it imports the JAX package or jax
(walked statically, file by file), and with both blocked by an import hook a
fresh interpreter still decodes and encodes through it on the CPU."""
import ast
import glob
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("nvimagecodec_tpu", "jax", "jaxlib")

FILES = sorted(
    os.path.relpath(p, ROOT) for p in
    glob.glob(os.path.join(ROOT, "nvimagecodec_tpu_torch", "**", "*.py"),
              recursive=True)
) + ["chip_smoke.py", "bench_torch.py", "tools/profile_torch_decode.py",
     "tools/profile_torch_encode.py", "tools/bench_idct.py",
     "tools/bench_fdct.py",
     "tools/bench_entropy.py", "tools/fp32_peak.py",
     "tools/profile_torch_j2k.py", "tests/test_torch_j2k_t1_device.py"]


def _imported_roots(tree: ast.AST):
    """Top-level package of every absolute import in `tree`, and of every
    string handed to `importlib.import_module` / `__import__`."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module.split(".")[0], node.lineno
        elif isinstance(node, ast.Call):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else getattr(
                fn, "id", "")
            if name in ("import_module", "__import__") and node.args:
                arg = node.args[0]
                if isinstance(arg, ast.Constant) and isinstance(arg.value,
                                                                str):
                    yield arg.value.split(".")[0], node.lineno


@pytest.mark.parametrize("path", FILES)
def test_file_imports_nothing_of_the_jax_package(path):
    with open(os.path.join(ROOT, path)) as f:
        tree = ast.parse(f.read(), path)
    bad = [(root, line) for root, line in _imported_roots(tree)
           if root in BLOCKED]
    assert not bad, f"{path} imports {bad}"


def test_port_has_its_own_host_layer():
    """The copied host modules sit under the JAX package's relative paths."""
    for rel in ["core/scheduler.py", "core/registry.py", "core/promise.py",
                "parsers/jpeg.py", "parsers/tiff.py",
                "codecs/jpeg/headers.py", "codecs/jpeg/native.py",
                "codecs/jpeg/encode.py", "codecs/png.py", "codecs/tiff.py",
                "codecs/webp.py", "codecs/system_codecs.py",
                "native/__init__.py", "native/jpeg_entropy.cpp",
                "native/opj_bridge.py", "ops/dwt.py",
                "codecs/jpeg2000/__init__.py", "codecs/jpeg2000/core.py",
                "codecs/jpeg2000/codestream.py", "codecs/jpeg2000/t2.py",
                "codecs/jpeg2000/t1_bridge.py", "codecs/jpeg2000/tagtree.py",
                "native/j2k_t1.cpp", "native/j2k_ht.cpp", "native/j2k_t2.cpp",
                "native/j2k_block_batch.cpp", "native/j2k_idwt.cpp",
                "native/j2k_finish.cpp", "native/j2k_ht_tables.inc",
                "core/plugin_framework.py", "parallel/__init__.py",
                "parallel/mesh.py", "parallel/tiles.py",
                "parallel/multihost.py"]:
        assert os.path.exists(os.path.join(ROOT, "nvimagecodec_tpu", rel))
        assert os.path.exists(os.path.join(ROOT, "nvimagecodec_tpu_torch",
                                           rel)), rel


J2K_FILES = [f for f in FILES if "jpeg2000" in f or f.endswith("ops/dwt.py")]


@pytest.mark.parametrize("path", J2K_FILES)
def test_j2k_files_carry_no_jax_route_switch(path):
    """The J2K stack of the port has no `use_jax`, no TIC_J2K_* environment
    switch and none of jax's sharding: the caller's device decides, and a
    `mesh` is the port's own list of torch devices (parallel/mesh.py)."""
    assert len(J2K_FILES) == 7
    with open(os.path.join(ROOT, path)) as f:
        text = f.read()
    for word in ("use_jax", "TIC_J2K_", "jax.", "jnp.", "device_put",
                 "NamedSharding", "PartitionSpec", "shard_map", "ppermute"):
        assert word not in text, (path, word)
    tree = ast.parse(text, path)
    names = {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)} | {
        a.arg for n in ast.walk(tree) if isinstance(n, ast.arguments)
        for a in n.args + n.kwonlyargs}
    assert "use_jax" not in names, path


_BLOCKER = r"""
import importlib.abc
import sys

BLOCKED = {blocked!r}


class _Block(importlib.abc.MetaPathFinder):
    # any import of the JAX package or of jax raises
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked import of " + name)
        return None


sys.meta_path.insert(0, _Block())
sys.path[:0] = [{root!r}, {tests!r}]
"""

# the scripts get the blocker's source too, for the processes they start
_PRELUDE = r"""{blocker}
PRELUDE_BLOCK = {blocker!r}
import numpy as np
import torch
import oracle
import nvimagecodec_tpu_torch as port
from nvimagecodec_tpu_torch.codecs.jpeg import batch as jb
from util import make_photo

try:
    import nvimagecodec_tpu
except ImportError:
    pass
else:
    raise AssertionError("the import hook does not block")

imgs = [make_photo(64, 80, seed=s) for s in range(16)]


def close(a, b, bar=8.0):
    d = np.abs(np.asarray(a).astype(int) - np.asarray(b).astype(int))
    assert d.mean() < bar, d.mean()


def routes(before):
    return {{k: jb.ROUTES[k] - before[k] for k in before if
             jb.ROUTES[k] != before[k]}}
"""

_SCRIPTS = {
    "jpeg_routes": r"""
params = port.EncodeParams(quality=85,
                           chroma_subsampling=port.ChromaSubsampling.CSS_420)
jpgs = port.Encoder(device="cpu").encode(imgs, "jpeg", params)
dec = port.Decoder(device="cpu")
before = dict(jb.ROUTES)
for im, src in zip(dec.decode(jpgs), imgs):
    close(im, src)
assert routes(before) == {"idx": 16}, routes(before)
dri = [oracle.jpeg_encode(im, 85, "420", restart_interval=5) for im in imgs]
before = dict(jb.ROUTES)
for im, src in zip(dec.decode(dri), imgs):
    close(im, src)
assert routes(before) == {"dri": 16}, routes(before)
before = dict(jb.ROUTES)
for im, src in zip(dec.decode(jpgs[:3]), imgs):  # under the minimum bucket
    close(im, src)
assert routes(before) == {"host": 3}, routes(before)
cpu_only = port.Decoder(device="cpu",
                        backends=[port.Backend(port.BackendKind.CPU_ONLY)])
before = dict(jb.ROUTES)
close(cpu_only.decode(jpgs[0]), imgs[0])
assert routes(before) == {}, routes(before)
""",
    "progressive_and_host_codecs": r"""
prog = oracle.jpeg_encode(imgs[0], 85, "420", progressive=True,
                          restart_interval=5)
close(jb.decode_progressive(prog, "cpu").numpy(), imgs[0])
close(port.Decoder(device="cpu").decode(prog), imgs[0])
enc, dec = port.Encoder(), port.Decoder(device="cpu")
streams = {
    "png": oracle.png_encode(imgs[1]),
    "tiff": oracle.tiff_encode(imgs[1]),
    "bmp": enc.encode(imgs[1], "bmp"),
    "pnm": enc.encode(imgs[1], "pnm"),
}
for codec, data in streams.items():
    cs = port.CodeStream(data)
    assert cs.codec_name == codec, (codec, cs.codec_name)
    got = dec.decode(data)
    assert np.array_equal(np.asarray(got), imgs[1]), codec
webp = oracle.webp_encode_rgb(imgs[1], 80.0)
assert port.CodeStream(webp).codec_name == "webp"
close(dec.decode(webp), imgs[1])
""",
    "jpeg2000": r"""
from nvimagecodec_tpu_torch.codecs.jpeg2000 import core as j2k
enc = port.Encoder(device="cpu")
lossless = port.EncodeParams(jpeg2k=port.Jpeg2kEncodeParams(reversible=True))
jp2 = enc.encode(imgs[3], "jp2", lossless)
ht = enc.encode(imgs[3], "j2k", port.EncodeParams(
    jpeg2k=port.Jpeg2kEncodeParams(reversible=True, ht=True,
                                   stream_type="j2k")))
lossy = enc.encode(imgs[3], "jp2", port.EncodeParams(quality=80))
assert port.CodeStream(jp2).codec_name == "jpeg2k"
for opt in ("true", "false"):
    dec = port.Decoder(device="cpu", options=(
        "cuda_jpeg2k_hybrid_decoder:device_pixel_stage=" + opt))
    before = dict(j2k.ROUTES)
    a, b, c = dec.decode([jp2, ht, lossy])
    assert np.array_equal(np.asarray(a), imgs[3])
    assert np.array_equal(np.asarray(b), imgs[3])
    close(c, imgs[3], 4.0)
    took = {k: j2k.ROUTES[k] - before[k] for k in before}
    assert took == ({"device": 3, "device_tiles": 0, "host": 0}
                    if opt == "true" else
                    {"device": 0, "device_tiles": 0, "host": 3}), took
""",
    "encode": r"""
enc, dec = port.Encoder(device="cpu"), port.Decoder(device="cpu")
for css in (port.ChromaSubsampling.CSS_444, port.ChromaSubsampling.CSS_420):
    params = port.EncodeParams(quality=90, chroma_subsampling=css)
    data = enc.encode(imgs[2], "jpeg", params)
    assert data[:2] == b"\xff\xd8" and data[-2:] == b"\xff\xd9"
    close(oracle.jpeg_decode(data), imgs[2], 6.0)  # libjpeg reads it
    close(dec.decode(data), imgs[2], 6.0)
png = enc.encode(imgs[2], "png")
assert np.array_equal(np.asarray(dec.decode(png)), imgs[2])
assert np.array_equal(oracle.png_decode(png), imgs[2])
""",
    "transcode": r"""
import os
import subprocess
import tempfile
from nvimagecodec_tpu_torch.codecs.jpeg import batch_encode as be
from nvimagecodec_tpu_torch.ops.resize import resize
from nvimagecodec_tpu_torch.pipeline import decode_batches
params = port.EncodeParams(quality=85,
                           chroma_subsampling=port.ChromaSubsampling.CSS_420)
enc, dec = port.Encoder(device="cpu"), port.Decoder(device="cpu")
jpgs = enc.encode(imgs, "jpeg", params)
before = dict(be.ROUTES)
n = 0
for batch in decode_batches([jpgs[:8], jpgs[8:]], decoder=dec, depth=2):
    small = [resize(im.array, 32, 40, "bilinear") for im in batch]
    for data, t in zip(enc.encode(small, "jpeg", params), small):
        close(oracle.jpeg_decode(data), t.numpy(), 6.0)
        n += 1
assert n == 16 and be.ROUTES["device"] - before["device"] == 16
with tempfile.TemporaryDirectory() as d:
    src = os.path.join(d, "a.jpg")
    with open(src, "wb") as f:
        f.write(jpgs[0])
    # the child inherits no import hook: it gets the blocking prelude too
    child = PRELUDE_BLOCK + (
        "from nvimagecodec_tpu_torch.cli import main\n"
        "import sys\n"
        "rc = main(sys.argv[1:])\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in BLOCKED]\n"
        "raise SystemExit(rc)\n")
    for argv in (["imtrans", "-i", src, "-c", "png", "-o",
                  os.path.join(d, "a.png")],
                 ["improc", "-i", src, "--resize", "40x32", "-c", "jpeg",
                  "-o", os.path.join(d, "r.jpg")]):
        r = subprocess.run([sys.executable, "-c", child, *argv, "--device",
                            "cpu"], capture_output=True, text=True)
        assert r.returncode == 0, r.stderr[-2000:]
    close(dec.decode(open(os.path.join(d, "a.png"), "rb").read()), imgs[0])
    assert dec.decode(open(os.path.join(d, "r.jpg"), "rb").read()).shape \
        == (32, 40, 3)
""",
}

_EPILOGUE = r"""
loaded = [m for m in sys.modules
          if m.split(".")[0] in {blocked!r} and sys.modules[m] is not None]
assert not loaded, loaded
print("ALONE-OK")
"""


@pytest.mark.parametrize("what", sorted(_SCRIPTS))
def test_port_runs_with_the_jax_package_blocked(what):
    fmt = dict(blocked=set(BLOCKED), root=ROOT,
               tests=os.path.join(ROOT, "tests"))
    fmt["blocker"] = _BLOCKER.format(**fmt)
    code = (_PRELUDE.format(**fmt) + _SCRIPTS[what]
            + _EPILOGUE.format(**fmt))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, env=env, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "ALONE-OK" in r.stdout
