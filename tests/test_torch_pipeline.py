"""The port's input pipeline (`pipeline.decode_batches`) on the CPU: at every
depth the batches equal an unpipelined decode exactly and the reference's
pipeline within 1 (the JPEG decode bar); failed samples are dropped or kept;
a corrupt stream fails alone; a device-stage error reaches the consumer."""
import time

import numpy as np
import pytest
import torch

import oracle
import nvimagecodec_tpu as ref
import nvimagecodec_tpu_torch as port
from nvimagecodec_tpu.pipeline import decode_batches as ref_decode_batches
from nvimagecodec_tpu_torch.codecs.jpeg import batch as jb
from nvimagecodec_tpu_torch.core import trace
from nvimagecodec_tpu_torch.pipeline import decode_batches
from util import make_photo

NBATCH, BATCH = 5, 4


@pytest.fixture(scope="module")
def batches():
    return [[oracle.jpeg_encode(make_photo(48, 64, seed=b * BATCH + j), 85,
                                "420") for j in range(BATCH)]
            for b in range(NBATCH)]


@pytest.fixture(scope="module")
def unpipelined(batches):
    dec = port.Decoder(device="cpu")
    return [dec.decode(b) for b in batches]


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_depth_equals_unpipelined_decode(batches, unpipelined, depth):
    dec = port.Decoder(device="cpu")
    got = list(decode_batches(iter(batches), decoder=dec, depth=depth))
    assert len(got) == NBATCH
    for mine, want in zip(got, unpipelined):  # in order
        assert len(mine) == BATCH
        for a, b in zip(mine, want):
            assert isinstance(a, port.Image)
            assert torch.equal(a.array, b.array)  # exact


def _reference_decode(batch):
    """The reference's decode of `batch`, as it gives it twice running. On
    a loaded machine the reference's JPEG decoder now and then hands out a
    whole batch that is not its own (about one decode in a thousand, off by
    over 100, with none of the port's code in the process)."""
    dec = ref.Decoder()
    last = [np.asarray(x).astype(int) for x in dec.decode(batch)]
    for _ in range(4):
        again = [np.asarray(x).astype(int) for x in dec.decode(batch)]
        if all(np.array_equal(x, y) for x, y in zip(last, again)):
            return again
        last = again
    raise AssertionError("the reference's decode does not settle")


def test_matches_reference_pipeline(batches):
    mine = decode_batches(batches, decoder=port.Decoder(device="cpu"))
    theirs = ref_decode_batches(batches, decoder=ref.Decoder())
    for batch, a_batch, b_batch in zip(batches, mine, theirs):
        for a, b, c in zip(a_batch, b_batch, _reference_decode(batch)):
            a, b = np.asarray(a).astype(int), np.asarray(b).astype(int)
            assert np.abs(a - c).max() <= 1  # the float decode's bar
            # and the pipeline's image, wherever it is the reference's own
            if np.array_equal(b, c):
                assert np.abs(a - b).max() <= 1


@pytest.mark.parametrize("depth", [1, 2])
def test_drop_failed_and_a_corrupt_stream(batches, unpipelined, depth):
    bad = [list(b) for b in batches[:3]]
    bad[1][2] = b"\xff\xd8\xff\xe0 not a jpeg"
    bad[2][0] = b"nothing an image parser knows"
    dec = port.Decoder(device="cpu")
    dropped = list(decode_batches(bad, decoder=dec, depth=depth))
    assert [len(b) for b in dropped] == [4, 3, 3]
    kept = list(decode_batches(bad, decoder=dec, drop_failed=False,
                               depth=depth))
    assert [[o is None for o in b] for b in kept] == [
        [False] * 4, [False, False, True, False], [True] + [False] * 3]
    for got, want, skip in zip(kept, unpipelined, (None, 2, 0)):
        for j, (a, b) in enumerate(zip(got, want)):
            if j != skip:
                assert torch.equal(a.array, b.array)
    assert torch.equal(dropped[1][2].array, unpipelined[1][3].array)


def test_params_reach_the_decoder(batches):
    p = port.DecodeParams(color_spec=port.ColorSpec.GRAY)
    out = next(iter(decode_batches(batches[:1], params=p,
                                   decoder=port.Decoder(device="cpu"))))
    assert all(o.shape == (48, 64) for o in out)


def test_empty_input_and_depth_below_one(batches, unpipelined):
    dec = port.Decoder(device="cpu")
    assert list(decode_batches([], decoder=dec)) == []
    got = list(decode_batches(batches[:1], decoder=dec, depth=0))
    assert torch.equal(got[0][0].array, unpipelined[0][0].array)


def test_prefetch_runs_ahead_of_the_consumer(batches):
    """With depth 2 the second batch is submitted before the first is
    yielded; with depth 1 nothing runs ahead."""
    class Counting(port.Decoder):
        calls = 0

        def decode(self, src, params=None):
            Counting.calls += 1
            return super().decode(src, params)

    for depth, ahead in ((1, 1), (2, 2), (3, 3)):
        Counting.calls = 0
        dec = Counting(device="cpu")
        gen = decode_batches(batches, decoder=dec, depth=depth)
        next(gen)
        deadline = time.time() + 30
        while Counting.calls < ahead and time.time() < deadline:
            time.sleep(0.01)
        assert Counting.calls == ahead
        gen.close()


def test_device_stage_error_reaches_the_consumer(batches, monkeypatch):
    def broken(*a, **k):
        raise RuntimeError("K1 idct launch: CUDA error 98")

    monkeypatch.setattr(jb, "idct_planes", broken)
    for depth in (1, 2):
        with pytest.raises(RuntimeError, match="CUDA error"):
            list(decode_batches(batches, decoder=port.Decoder(device="cpu"),
                                depth=depth))


def test_no_device_wait_span_on_the_cpu(batches):
    """The wait is on a CUDA event; a CPU decode is complete when it
    returns."""
    trace.start_collect()
    try:
        list(decode_batches(batches[:2], decoder=port.Decoder(device="cpu")))
    finally:
        got = trace.stop_collect()
    assert "imgcodec.pipeline.device_wait" not in got["spans"]
    assert got["spans"].get("imgcodec.jpeg.parse", 0) > 0


def test_launch_counts_are_exact_across_threads():
    """`decode_batches` calls the decoder from several threads, so the kernel
    wrappers count their launches under a lock: no increment is lost."""
    import sys
    from concurrent.futures import ThreadPoolExecutor

    from nvimagecodec_tpu_torch import _build

    def wrapper():
        pass

    wrapper.launches = 0
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(8) as pool:
            list(pool.map(lambda _: [_build.count_launch(wrapper)
                                     for _ in range(2000)], range(8)))
    finally:
        sys.setswitchinterval(old)
    assert wrapper.launches == 16000
