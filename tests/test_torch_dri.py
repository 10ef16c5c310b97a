"""The CUDA port's dri route on the CPU: a bucket of restart-marker baseline
streams decodes through K2 (its plain version here), one restart interval
per lane, with pixels equal to the host route's and within 1 of the JAX
package's Decoder. A sample whose restart structure is malformed goes to the
host route alone; a sample K2 flags is decoded again on the host route and
counted as re-issued."""
import numpy as np
import pytest
import torch

import oracle
import nvimagecodec_tpu as ref
import nvimagecodec_tpu_torch as port
from nvimagecodec_tpu_torch.codecs.jpeg.headers import parse_jpeg_structure
from nvimagecodec_tpu_torch.codecs.jpeg import batch as jb
from nvimagecodec_tpu_torch.codecs.jpeg import device_entropy as de
from util import make_photo

BUCKET = 4


@pytest.fixture(autouse=True)
def small_buckets(monkeypatch):
    monkeypatch.setattr(jb, "_MIN_BATCH", BUCKET)


def _dri_jpgs(n, ss="420", q=85, rows=1, h=96, w=144):
    """n streams whose restart interval is `rows` MCU rows."""
    imgs = [make_photo(h, w, seed=s) for s in range(n)]
    src = [im[:, :, 0] for im in imgs] if ss == "gray" else imgs
    f = parse_jpeg_structure(oracle.jpeg_encode(src[0], q, ss))
    ri = rows * -(-f.width // (8 * f.hmax))
    return [oracle.jpeg_encode(im, q, ss, restart_interval=ri) for im in src]


def _routes(before):
    return {k: jb.ROUTES[k] - before[k] for k in before}


def _diff(a, b) -> int:
    return int(np.abs(np.asarray(a).astype(int)
                      - np.asarray(b).astype(int)).max())


@pytest.mark.parametrize("ss,rows", [("420", 1), ("422", 1), ("444", 2),
                                     ("440", 1), ("411", 1), ("410", 1),
                                     ("gray", 1)])
def test_dri_route_equals_host_route(ss, rows):
    datas = _dri_jpgs(BUCKET, ss, rows=rows)
    params = port.DecodeParams()
    before = dict(jb.ROUTES)
    dri = jb.decode_batch_cuda(datas, params, "cpu")
    assert _routes(before) == {"idx": 0, "dri": BUCKET, "host": 0,
                               "reissued": 0}
    host = jb.decode_batch_cuda(datas, params, "cpu", device_entropy=False)
    for a, b in zip(dri, host):
        assert torch.equal(a.array, b.array)


def test_decoder_takes_dri_route_and_matches_reference():
    datas = _dri_jpgs(BUCKET)
    before = dict(jb.ROUTES)
    out = port.Decoder(device="cpu").decode(datas)
    assert _routes(before)["dri"] == BUCKET
    for a, b in zip(out, ref.Decoder().decode(datas)):
        assert _diff(a, b) <= 1
    opt = "bitexact=true"
    out = port.Decoder(device="cpu",
                       options=f"cuda_jpeg_hybrid_decoder:{opt}").decode(datas)
    want = ref.Decoder(options=f"tpu_jpeg_hybrid_decoder:{opt}").decode(datas)
    for a, b in zip(out, want):
        assert _diff(a, b) == 0


def test_stray_restart_markers_fail_or_reroute_alone():
    datas = _dri_jpgs(BUCKET + 1)
    bad = bytearray(datas[2])
    s0 = parse_jpeg_structure(datas[2]).scans[0].data_start
    bad[s0 + 40:s0 + 48] = b"\xff\xd1" * 4  # stray RSTs break segment count
    datas[2] = bytes(bad)
    before = dict(jb.ROUTES)
    out = port.Decoder(device="cpu").decode(datas)
    routes = _routes(before)
    assert routes["dri"] == BUCKET and routes["reissued"] == 0
    want = ref.Decoder().decode(datas)
    for j, (a, b) in enumerate(zip(out, want)):
        if j != 2:
            assert _diff(a, b) <= 1
    # the malformed sample went to the host route, which decodes or fails it
    assert routes["host"] + (out[2] is None) == 1


def test_flagged_sample_is_reissued_to_host_route(monkeypatch):
    datas = _dri_jpgs(BUCKET)
    nsegs = jb.route_plan(parse_jpeg_structure(datas[0]))[3]
    real = jb.decode_segments_into

    def flag_second_image(*args):
        out, err = real(*args)
        err = err.clone()
        err[nsegs + 1] = 1
        return out, err

    monkeypatch.setattr(jb, "decode_segments_into", flag_second_image)
    before = dict(jb.ROUTES)
    out = port.Decoder(device="cpu").decode(datas)
    assert _routes(before)["reissued"] == 1
    assert _routes(before)["host"] == 1
    for a, b in zip(out, ref.Decoder().decode(datas)):
        assert _diff(a, b) <= 1


def test_corrupt_payload_is_flagged_and_reissued():
    """Garbage inside one restart interval keeps the segment count, so only
    K2's flags catch it; the sample alone is re-decoded on the host route."""
    datas = _dri_jpgs(BUCKET)
    bad = bytearray(datas[1])
    s0 = parse_jpeg_structure(datas[1]).scans[0].data_start
    bad[s0 + 2:s0 + 10] = b"\xfe" * 8
    datas[1] = bytes(bad)
    before = dict(jb.ROUTES)
    out = port.Decoder(device="cpu").decode(datas)
    assert _routes(before)["reissued"] == 1
    want = ref.Decoder().decode(datas)
    for j, (a, b) in enumerate(zip(out, want)):
        if j != 1:
            assert _diff(a, b) <= 1


def test_split_grows_word_rows(monkeypatch):
    """A first guess too small for a segment doubles until it fits."""
    datas = _dri_jpgs(BUCKET)
    frames = dict(enumerate(parse_jpeg_structure(d) for d in datas))
    raws = dict(enumerate(datas))
    nsegs = jb.route_plan(frames[0])[3]
    good = list(range(BUCKET))
    bad, words, side = jb.split_dri(good, frames, raws, nsegs,
                                    torch.device("cpu"))
    monkeypatch.setattr(de, "words_estimate", lambda nbytes, nsegs: 2)
    bad2, words2, side2 = jb.split_dri(good, frames, raws, nsegs,
                                       torch.device("cpu"))
    assert not bad and not bad2
    W = words.shape[0]
    assert words2.shape[0] >= 4 and words2.shape[0] & (words2.shape[0] - 1) == 0
    n = min(W, words2.shape[0])
    assert torch.equal(words[:n], words2[:n])
    assert not words[n:].any() and not words2[n:].any()
    assert torch.equal(side, side2)
    assert (side[0, :BUCKET * nsegs] > 0).all() and not side[1:].any()


def test_split_declines_oversized_bucket(monkeypatch):
    datas = _dri_jpgs(BUCKET)
    frames = dict(enumerate(parse_jpeg_structure(d) for d in datas))
    nsegs = jb.route_plan(frames[0])[3]
    monkeypatch.setattr(de, "MAX_WORD_BYTES", 1024)
    assert jb.split_dri(list(range(BUCKET)), frames, dict(enumerate(datas)),
                        nsegs, torch.device("cpu")) is None
    before = dict(jb.ROUTES)
    out = port.Decoder(device="cpu").decode(datas)
    assert _routes(before)["host"] == BUCKET and all(o is not None
                                                     for o in out)


def test_words_estimate_is_reference_guess():
    # twice the mean segment and 16 more, in rows of 16 words
    assert de.words_estimate(4000, 10) == 224
    assert de.words_estimate(40000, 10) == 2016
    assert de.words_estimate(100, 10) == 32
