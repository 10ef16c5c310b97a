"""The committed streams of tests/torch_corpus, which the card checks read
as bytes, are what `make_corpus.py` makes from their photos, and take the
routes the card checks drive them through."""
import pytest

import oracle
import torch_corpus as tc
from nvimagecodec_tpu_torch.codecs.jpeg.headers import parse_jpeg_structure
from nvimagecodec_tpu_torch.codecs.jpeg import batch as jb
from util import make_photo


@pytest.mark.parametrize("seed", tc.DRI_SEEDS)
def test_dri_stream_is_reproducible(seed):
    want = tc.encode_dri(make_photo(tc.DRI_H, tc.DRI_W, seed=seed),
                         tc.DRI_Q, tc.DRI_RI)
    assert tc.dri_streams()[seed] == want
    frame = parse_jpeg_structure(want)
    kind, _key, R, nsegs = jb.route_plan(frame)
    assert (kind, R, nsegs) == ("dri", tc.DRI_RI, 24)


@pytest.mark.parametrize("seed", tc.PROG_SEEDS)
def test_progressive_stream_is_reproducible(seed):
    want = oracle.jpeg_encode(make_photo(tc.PROG_H, tc.PROG_W, seed=seed),
                              tc.PROG_Q, "420", progressive=True,
                              restart_interval=tc.PROG_RI)
    assert tc.progressive_streams()[seed] == want
    frame = parse_jpeg_structure(want)
    assert frame.marker == 0xC2 and len(frame.scans) == 10
    assert all(s.restart_interval == tc.PROG_RI for s in frame.scans)
