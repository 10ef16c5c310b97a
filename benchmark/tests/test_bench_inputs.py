"""Inputs come from the seed and the benchmark's own encoder, never from
the program."""
import hashlib

from benchmark import corpus
from benchmark.tests.conftest import MIXED


def digest(streams):
    h = hashlib.sha256()
    for s in streams:
        h.update(s)
    return h.hexdigest()


PARAMS = dict(MIXED["corpus"], quality=[75, 95],
              subsampling="420", optimized_share=0.5, texture_std=20,
              noise_std=5)


def test_same_seed_same_streams():
    _s, a = corpus.make_streams(PARAMS, 2 ** 31 + 5, workers=1)
    _s, b = corpus.make_streams(PARAMS, 2 ** 31 + 5, workers=1)
    _s, c = corpus.make_streams(PARAMS, 2 ** 31 + 6, workers=1)
    assert digest(a) == digest(b) != digest(c)


def test_worker_processes_give_the_same_streams():
    _s, a = corpus.make_streams(PARAMS, 11, workers=1)
    _s, b = corpus.make_streams(PARAMS, 11, workers=2)
    assert digest(a) == digest(b)


def test_inputs_do_not_move_with_the_program_encoder(monkeypatch):
    import nvimagecodec_tpu_torch as nic
    from nvimagecodec_tpu_torch.codecs.jpeg import encode

    _s, before = corpus.make_streams(PARAMS, 3, workers=1)

    def broken(*a, **k):
        raise AssertionError("the program's encoder made an input")

    monkeypatch.setattr(nic.Encoder, "encode", broken)
    monkeypatch.setattr(encode, "encode_pixels", broken)
    monkeypatch.setattr(encode, "fdct_quant_blocks", broken)
    _s, after = corpus.make_streams(PARAMS, 3, workers=1)
    assert digest(before) == digest(after)


def test_the_mix_is_the_same_for_every_seed():
    full = {"photos": 4, "photo_size": [500, 500], "streams": 512,
            "geometry": [[375, 500, 0.35], [500, 375, 0.10],
                         [333, 500, 0.20], [500, 333, 0.05],
                         [500, 500, 0.05], [281, 500, 0.05]],
            "random_share": 0.20, "random_range": [200, 500],
            "quality": [75, 80, 85, 90, 95], "optimized_share": 0.5}
    for seed in (1, 2 ** 31 + 1):
        specs = corpus.plan(full, seed)
        assert sum(s.optimized for s in specs) == 256
        assert sum((s.height, s.width) == (375, 500) for s in specs) >= 179
        assert {q: sum(s.quality == q for s in specs)
                for q in full["quality"]} == {75: 103, 80: 103, 85: 102,
                                              90: 102, 95: 102}
