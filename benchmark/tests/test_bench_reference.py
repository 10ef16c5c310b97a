"""The plain reference codec against the benchmark's own corpus, and
against PIL where this machine has it."""
import io

import numpy as np
import pytest

from benchmark import corpus
from benchmark.photo import textured_photo
from benchmark.reference import jpeg
from benchmark.reference.resize import bilinear


@pytest.fixture(scope="module")
def photo():
    return textured_photo(75, 101, 5, 20, 5)


@pytest.mark.parametrize("optimized", [False, True])
@pytest.mark.parametrize("quality", [75, 95])
def test_entropy_round_trip(photo, optimized, quality):
    data, frame, coefs = jpeg.encode(photo, quality, "420", optimized)
    back = jpeg.entropy_decode(jpeg.parse(data))
    assert all(np.array_equal(a, b) for a, b in zip(coefs, back))


def test_optimized_tables_are_shorter(photo):
    std, _f, _c = jpeg.encode(photo, 85, "420", False)
    opt, _f, _c = jpeg.encode(photo, 85, "420", True)
    assert len(opt) < len(std)
    frame = jpeg.parse(opt)
    for counts, values in frame.huffman.values():
        assert sum(counts) == len(values) and len(values) <= 256


def test_decode_is_close_to_the_source():
    from benchmark.photo import make_photo

    photo = make_photo(75, 101, seed=3)
    data, _f, _c = jpeg.encode(photo, 95, "420", False)
    img = jpeg.decode(data)
    assert img.shape == photo.shape
    err = np.abs(img.astype(int) - photo.astype(int)).mean()
    assert err < 3


def test_corpus_streams_decode(photo):
    params = {"photos": 2, "photo_size": [40, 48], "streams": 6,
              "geometry": [[40, 48, 0.5], [33, 47, 0.5]],
              "quality": [75, 90], "subsampling": "420",
              "optimized_share": 0.5, "texture_std": 20, "noise_std": 5}
    specs, streams = corpus.make_streams(params, 7, workers=1)
    assert sorted({s.optimized for s in specs}) == [False, True]
    for s, data in zip(specs, streams):
        assert jpeg.decode(data).shape == (s.height, s.width, 3)


def _pil():
    return pytest.importorskip("PIL.Image")


@pytest.mark.parametrize("optimized", [False, True])
def test_pil_reads_the_benchmark_streams(photo, optimized):
    Image = _pil()
    data, _f, _c = jpeg.encode(photo, 85, "420", optimized)
    theirs = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    ours = jpeg.decode(data)
    # libjpeg's integer IDCT against the float one: within 4, the
    # reference library's own tolerance
    assert np.abs(theirs.astype(int) - ours.astype(int)).max() <= 4


def test_reference_reads_pil_streams(photo):
    Image = _pil()
    buf = io.BytesIO()
    Image.fromarray(photo).save(buf, "JPEG", quality=85, subsampling=2)
    data = buf.getvalue()
    theirs = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    ours = jpeg.decode(data)
    assert np.abs(theirs.astype(int) - ours.astype(int)).max() <= 4


def test_tf32_rounding():
    x = np.array([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10, -1.0 - 2 ** -11],
                 np.float32)
    got = jpeg.round_tf32(x)
    assert got.tolist() == [1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -10,
                            -1.0 - 2 ** -10]


def test_bilinear_matches_the_program_on_the_cpu():
    torch = pytest.importorskip("torch")
    from nvimagecodec_tpu_torch.ops.resize import resize

    img = textured_photo(75, 101, 9, 20, 5)
    ours = bilinear(img, 32, 40)
    theirs = resize(torch.from_numpy(img), 32, 40, "bilinear").numpy()
    assert np.abs(ours.astype(int) - theirs.astype(int)).max() <= 1


@pytest.mark.parametrize("quality", [75, 95])
def test_bounds_hold_the_float64_and_float32_decodes(photo, quality):
    data, _f, coefs = jpeg.encode(photo, quality, "420", False)
    frame = jpeg.parse(data)
    lo, hi = jpeg.decode_bounds(frame, coefs)
    for img in (jpeg.decode(data), _decode_float32(frame, coefs)):
        assert ((img >= lo) & (img <= hi)).all()
    assert (lo != hi).mean() < 0.01
    assert ((jpeg.decode(data, "tf32") < lo)
            | (jpeg.decode(data, "tf32") > hi)).any()


def _decode_float32(frame, coefs):
    """The reference decode with its product in float32, summed in
    another order than NumPy's."""
    real = jpeg.product
    try:
        jpeg.product = lambda a, m, p: np.stack(
            [(a.astype(np.float32)[..., k:k + 1]
              * m.astype(np.float32).T[k]) for k in range(63, -1, -1)],
            0).sum(0, dtype=np.float32)
        return jpeg.decode_pixels(frame, coefs)
    finally:
        jpeg.product = real


def test_encode_bounds_hold_the_float64_encode(photo):
    fr = jpeg.layout(photo.shape[0], photo.shape[1], "420", 75)
    want = jpeg.encode_coefficients(photo, fr)
    for c, (lo, hi) in zip(want, jpeg.encode_bounds(photo, photo, fr)):
        assert ((c >= lo) & (c <= hi)).all()
        assert (lo != hi).mean() < 0.01


def test_resize_bounds_hold_the_resize(photo):
    from benchmark.reference.resize import bilinear_bounds

    lo, hi = bilinear_bounds(photo, photo, 32, 40)
    out = bilinear(photo, 32, 40)
    assert ((out >= lo) & (out <= hi)).all() and (lo != hi).mean() < 0.01
