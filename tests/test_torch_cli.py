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


def test_jpeg2000_output_reversible_decodes_back_exactly(corpus, tmp_path):
    """`-c jp2 --reversible` writes a file that decodes back to the input's
    pixels, and whose bytes are the JAX package's CLI's."""
    d, img = corpus
    args = ["imtrans", "-i", str(d / "b.png"), "-c", "jp2", "--reversible",
            "-o"]
    r = _port(*args, str(tmp_path / "x.jp2"))
    assert "processed 1/1" in r.stdout and "[encode-fail]" not in r.stderr
    data = (tmp_path / "x.jp2").read_bytes()
    assert data[4:8] == b"jP  "
    back = port.Decoder(device="cpu").decode(data)
    assert np.array_equal(np.asarray(back), img)
    _ref(*args, str(tmp_path / "r.jp2"))
    assert data == (tmp_path / "r.jp2").read_bytes()
    assert "encode-fail" not in _port("imtrans", "--help", "-i", "x").stdout


@pytest.mark.parametrize("codec,ext", [("j2k", ".j2k"), ("jpeg2k", ".j2k"),
                                       ("jp2", ".jp2")])
def test_jpeg2000_lossy_output_per_codec_name(corpus, tmp_path, codec, ext):
    """Every name of the codec encodes; a directory output takes the
    codec's extension; the stream type follows the name."""
    d, img = corpus
    out = tmp_path / "out"
    out.mkdir()
    _port("imtrans", "-i", str(d / "a.jpg"), "-c", codec, "-q", "80",
          "--num_decomps", "3", "--block_size", "32", "-o", str(out))
    data = (out / ("a" + ext)).read_bytes()
    assert (data[:4] == b"\xff\x4f\xff\x51") == (codec != "jp2")
    back = np.asarray(port.Decoder(device="cpu").decode(data))
    assert back.shape == img.shape and psnr(img, back) > 28


def test_jpeg2000_transcode_chain_and_improc(corpus, tmp_path):
    """png -> jp2 (lossless) -> bmp gives the png's pixels back; improc
    resizes a jp2 input and writes jp2; both equal the JAX package's CLI."""
    d, img = corpus
    _port("imtrans", "-i", str(d / "b.png"), "-c", "jp2", "--reversible",
          "-o", str(tmp_path / "b.jp2"))
    _port("imtrans", "-i", str(tmp_path / "b.jp2"), "-c", "bmp", "-o",
          str(tmp_path / "b.bmp"))
    back = port.Decoder(device="cpu").decode(
        (tmp_path / "b.bmp").read_bytes())
    assert np.array_equal(np.asarray(back), img)
    args = ["improc", "-i", str(tmp_path / "b.jp2"), "--resize", "40x30",
            "-c", "jp2", "--reversible", "-o"]
    _port(*args, str(tmp_path / "p.jp2"))
    _ref(*args, str(tmp_path / "r.jp2"))
    assert ((tmp_path / "p.jp2").read_bytes()
            == (tmp_path / "r.jp2").read_bytes())
    small = np.asarray(port.Decoder(device="cpu").decode(
        (tmp_path / "p.jp2").read_bytes()))
    assert small.shape == (30, 40, 3)


def test_jpeg2000_md5_deterministic(corpus, tmp_path):
    """Two runs write the same bytes (the transcode determinism check of
    tests/test_cli_transcode.py, for the J2K encoder)."""
    d, _ = corpus
    sums = []
    for i in range(2):
        o = tmp_path / f"o{i}.j2k"
        _port("imtrans", "-i", str(d / "b.png"), "-c", "j2k", "-q", "70",
              "-o", str(o))
        sums.append(hashlib.md5(o.read_bytes()).hexdigest())
    assert sums[0] == sums[1]


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
