"""The port's command line (`python -m nvimagecodec_tpu_torch.cli`) with
`--device cpu`: the three cases of tests/test_cli_transcode.py against it,
and its output files against the JAX package's CLI on the same inputs (equal
bytes for png → bmp and for `improc --resize`, whose chains are lossless)."""
import argparse
import hashlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import oracle
import nvimagecodec_tpu_torch as port
from nvimagecodec_tpu.ops.resize import resize_bilinear
from nvimagecodec_tpu_torch import cli as port_cli
from util import make_photo, psnr

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(module, *argv, ok=True):
    env = dict(os.environ)
    env.setdefault("JAX_PLATFORMS", "cpu")
    r = subprocess.run([sys.executable, "-m", module, *argv],
                       capture_output=True, text=True, env=env, cwd=ROOT,
                       timeout=600)
    if ok:
        assert r.returncode == 0, r.stderr
    return r


def _port(*argv, **kw):
    return _run("nvimagecodec_tpu_torch.cli", *argv, "--device", "cpu", **kw)


def _ref(*argv):
    return _run("nvimagecodec_tpu.cli", *argv)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    img = make_photo(60, 80, seed=3)
    (d / "a.jpg").write_bytes(oracle.jpeg_encode(img, 90, "420"))
    (d / "b.png").write_bytes(oracle.png_encode(img))
    return d, img


def test_transcode_to_bmp_pixel_exact_for_png(corpus, tmp_path):
    d, img = corpus
    out = tmp_path / "out"
    _port("imtrans", "-i", str(d / "b.png"), "-c", "bmp", "-o",
          str(out / "b.bmp"))
    back = np.asarray(port.Decoder(device="cpu").read(str(out / "b.bmp")))
    assert np.array_equal(back, img)  # png → bmp is a lossless chain
    _ref("imtrans", "-i", str(d / "b.png"), "-c", "bmp", "-o",
         str(out / "ref.bmp"))
    assert (out / "b.bmp").read_bytes() == (out / "ref.bmp").read_bytes()


def test_transcode_deterministic_md5(corpus, tmp_path):
    d, _ = corpus
    sums = []
    for trial in range(2):
        out = tmp_path / f"out{trial}"
        r = _port("imtrans", "-i", str(d), "-c", "pnm", "-o", str(out))
        assert r.stdout.startswith("processed 2/2 images; decode ")
        sums.append({f: hashlib.md5((out / f).read_bytes()).hexdigest()
                     for f in sorted(os.listdir(out))})
    assert sums[0] == sums[1]
    assert set(sums[0]) == {"a.ppm", "b.ppm"}


def test_improc_resize(corpus, tmp_path):
    d, img = corpus
    out = tmp_path / "r.bmp"
    _port("improc", "-i", str(d / "b.png"), "--resize", "40x30", "-c", "bmp",
          "-o", str(out))
    back = np.asarray(port.Decoder(device="cpu").read(str(out)))
    assert back.shape == (30, 40, 3)
    assert np.array_equal(back, resize_bilinear(img, 30, 40))
    _ref("improc", "-i", str(d / "b.png"), "--resize", "40x30", "-c", "bmp",
         "-o", str(tmp_path / "ref.bmp"))
    assert out.read_bytes() == (tmp_path / "ref.bmp").read_bytes()


@pytest.mark.parametrize("interp", ["bicubic", "lanczos"])
def test_improc_crop_and_filtered_resize_equal_reference(corpus, tmp_path,
                                                         interp):
    d, _ = corpus
    args = ["improc", "-i", str(d / "b.png"), "--crop", "3,4,50,40",
            "--resize", "64x48", "--interp", interp, "-c", "png", "-o"]
    _port(*args, str(tmp_path / "p.png"))
    _ref(*args, str(tmp_path / "r.png"))
    a = oracle.png_decode((tmp_path / "p.png").read_bytes())
    assert a.shape == (48, 64, 3)
    assert np.array_equal(a, oracle.png_decode(
        (tmp_path / "r.png").read_bytes()))


def test_jpeg_to_jpeg_transcode_decodes(corpus, tmp_path):
    d, img = corpus
    r = _port("imtrans", "-i", str(d / "a.jpg"), "-c", "jpeg", "-q", "90",
              "--chroma_subsampling", "420", "-v", "-o",
              str(tmp_path / "t.jpg"))
    assert "a.jpg -> " in r.stdout and " B)" in r.stdout
    back = oracle.jpeg_decode((tmp_path / "t.jpg").read_bytes())
    assert psnr(img, back) > 30


def test_jpeg2000_output_fails_per_image(corpus, tmp_path):
    """No JPEG2000 encoder in the port yet: [encode-fail], exit code 1."""
    d, _ = corpus
    r = _port("imtrans", "-i", str(d / "b.png"), "-c", "jp2", "-o",
              str(tmp_path / "x.jp2"), ok=False)
    assert r.returncode == 1
    assert "[encode-fail]" in r.stderr and "processed 0/1" in r.stdout
    assert not (tmp_path / "x.jp2").exists()
    assert "encode-fail" in _port("imtrans", "--help", "-i", "x").stdout


def test_undecodable_input_is_reported(tmp_path):
    (tmp_path / "junk.jpg").write_bytes(b"\xff\xd8 not a jpeg at all")
    r = _port("imtrans", "-i", str(tmp_path / "junk.jpg"), "-c", "bmp", "-o",
              str(tmp_path / "o.bmp"), ok=False)
    assert r.returncode == 1 and "[fail]" in r.stderr


def test_main_in_process_and_device_default(corpus, tmp_path, capsys):
    d, img = corpus
    rc = port_cli.main(["improc", "-i", str(d / "a.jpg"), "--resize",
                        "32x24", "-c", "jpeg", "-o", str(tmp_path / "s.jpg"),
                        "--device", "cpu", "-v"])
    assert rc == 0
    assert "(24, 32, 3)" in capsys.readouterr().out
    back = port.Decoder(device="cpu").read(str(tmp_path / "s.jpg"))
    assert back.shape == (24, 32, 3)
    # every entry point runs on the card unless asked otherwise
    p = argparse.ArgumentParser()
    port_cli._add_common(p)
    assert p.parse_args(["-i", "x"]).device == "cuda"


def test_list_devices_goes_through_torch(capsys):
    assert port_cli.main(["imtrans", "-i", "x", "--list-devices"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == torch.cuda.device_count()
