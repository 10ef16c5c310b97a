"""The CUDA port runs where jax cannot be imported: in a fresh interpreter
with `sys.modules['jax'] = None`, it imports, decodes a JPEG bucket on the
CPU through the idx route and a restart-marker bucket through the dri
route, decodes a progressive stream through the progressive route, and
encodes and decodes a PNG, and loads no module of the JAX package."""
import os
import subprocess
import sys

_SCRIPT = r"""
import sys
sys.modules["jax"] = None  # any import of jax now raises ImportError
sys.path[:0] = [{root!r}, {tests!r}]
import numpy as np
import nvimagecodec_tpu_torch as port
from nvimagecodec_tpu_torch.codecs.jpeg import batch as jb
from util import make_photo

imgs = [make_photo(64, 80, seed=s) for s in range(16)]
params = port.EncodeParams(quality=85,
                           chroma_subsampling=port.ChromaSubsampling.CSS_420)
jpgs = port.Encoder(device="cpu").encode(imgs, "jpeg", params)
out = port.Decoder(device="cpu").decode(jpgs)
assert jb.ROUTES["idx"] == 16, jb.ROUTES
for im, src in zip(out, imgs):
    assert im.shape == (64, 80, 3)
    assert np.abs(np.asarray(im).astype(int) - src.astype(int)).mean() < 8

import oracle
from nvimagecodec_tpu_torch.codecs.jpeg.headers import parse_jpeg_structure
from nvimagecodec_tpu_torch.codecs.jpeg.device_entropy import (
    decode_progressive_device)
jb._MIN_BATCH = 4
dri = [oracle.jpeg_encode(im, 85, "420", restart_interval=5)
       for im in imgs[:4]]
out = port.Decoder(device="cpu").decode(dri)
assert jb.ROUTES["dri"] == 4, jb.ROUTES
for im, src in zip(out, imgs):
    assert np.abs(np.asarray(im).astype(int) - src.astype(int)).mean() < 8
prog = oracle.jpeg_encode(imgs[0], 85, "420", progressive=True,
                          restart_interval=5)
planes = decode_progressive_device(parse_jpeg_structure(prog), prog, "cpu")
assert [tuple(p.shape) for p in planes] == [(8, 10, 64), (4, 5, 64),
                                            (4, 5, 64)]
img = jb.decode_progressive(prog, "cpu")
assert np.abs(img.numpy().astype(int) - imgs[0].astype(int)).mean() < 8
png = port.Encoder().encode(imgs[0], "png")
back = port.Decoder(device="cpu").decode(png)
assert np.array_equal(np.asarray(back), imgs[0])
assert not any(m.split(".")[0] in ("jax", "nvimagecodec_tpu")
               for m in sys.modules if sys.modules[m] is not None)
print("NOJAX-OK")
"""


def test_port_runs_without_jax():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = _SCRIPT.format(root=root, tests=os.path.join(root, "tests"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, env=env, cwd=root)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "NOJAX-OK" in r.stdout
