"""The port's resize ops (nvimagecodec_tpu_torch/ops/resize.py) on CPU tensors
against the JAX package's numpy path on the same seeded arrays: 2-D, 3-D and
batched, uint8 / uint16 / float32.

Tolerances. The port gathers with the reference's indices and combines in
the reference's order of operations, in float32 on both sides, so on the CPU
every filter is held to EXACT equality with the numpy path (bilinear and the
separable filters alike). Against the reference's jax path and against the
dense per-pixel evaluation of the same kernels the bar is the reference's
own: within 1 (tests/test_convert.py:164-250, whose cases follow here)."""
import numpy as np
import pytest
import torch

from nvimagecodec_tpu.ops import resize as ref
from nvimagecodec_tpu_torch.ops import resize as port

SHAPES = {"2d": (37, 53), "3d": (37, 53, 3), "batched": (2, 29, 31, 3),
          "batched_planes": (2, 3, 20, 31)}
DTYPES = {"uint8": np.uint8, "uint16": np.uint16, "float32": np.float32}


def _array(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    if dtype == np.float32:
        return (rng.random(shape) * 255).astype(np.float32)
    return rng.integers(0, np.iinfo(dtype).max + 1, shape).astype(dtype)


@pytest.mark.parametrize("interp", ["bilinear", "bicubic", "lanczos"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("layout", sorted(SHAPES))
def test_resize_equals_reference_numpy(layout, dtype, interp):
    a = _array(SHAPES[layout], DTYPES[dtype], seed=len(layout) + len(interp))
    t = torch.from_numpy(a)
    hw = a.shape[-3:-1] if a.ndim >= 3 else a.shape
    for out_h, out_w in [(24, 80), (64, 17), hw]:  # down, up, mixed, same
        want = ref.resize(a, out_h, out_w, interp)
        got = port.resize(t, out_h, out_w, interp)
        assert got.dtype == t.dtype and got.device == t.device
        assert tuple(got.shape) == want.shape
        np.testing.assert_array_equal(got.numpy(), want)  # exact, see above


@pytest.mark.parametrize("fn", ["resize_bilinear", "resize_bicubic",
                                "resize_lanczos"])
def test_named_functions_equal_reference(fn):
    a = _array((41, 29, 3), np.uint8, seed=11)
    want = getattr(ref, fn)(a, 50, 50)
    got = getattr(port, fn)(torch.from_numpy(a), 50, 50)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("layout", sorted(SHAPES))
def test_crop_rotate_flip_equal_reference(layout, dtype):
    a = _array(SHAPES[layout], DTYPES[dtype], seed=3)
    t = torch.from_numpy(a)
    np.testing.assert_array_equal(port.crop(t, 3, 4, 10, 9).numpy(),
                                  ref.crop(a, 3, 4, 10, 9))
    for k in range(-1, 5):
        np.testing.assert_array_equal(port.rotate90(t, k).numpy(),
                                      ref.rotate90(a, k))
    for h, v in [(True, False), (False, True), (True, True), (False, False)]:
        np.testing.assert_array_equal(port.flip(t, h, v).numpy(),
                                      ref.flip(a, h, v))


def test_helpers_are_the_reference_helpers():
    t = np.linspace(-5, 5, 201)
    np.testing.assert_array_equal(port._cubic_kernel(t), ref._cubic_kernel(t))
    np.testing.assert_array_equal(port._lanczos_kernel(t),
                                  ref._lanczos_kernel(t))
    for taps, kern in ((4, "_cubic_kernel"), (8, "_lanczos_kernel")):
        for n_in, n_out in [(37, 24), (16, 16), (5, 40)]:
            a = ref._axis_weights(n_in, n_out, taps, getattr(ref, kern))
            b = port._axis_weights(n_in, n_out, taps, getattr(port, kern))
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])


def test_unknown_interpolation_raises():
    with pytest.raises(ValueError, match="unknown interpolation"):
        port.resize(torch.zeros(4, 4), 2, 2, "nearest")


# ----------------------- the cases of tests/test_convert.py:164-250, ported

def _dense_ref(img, out_h, out_w, kernel, taps):
    """Independent dense per-pixel evaluation of the same kernel."""
    h, w = img.shape[:2]
    iy, wy = ref._axis_weights(h, out_h, taps, kernel)
    ix, wx = ref._axis_weights(w, out_w, taps, kernel)
    tmp = np.einsum("ok,ko...->o...", wy, img.astype(np.float32)[iy.T])
    out = np.einsum("ok,ako->ao", wx, tmp[:, ix.T])
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


def test_bicubic_matches_dense():
    img = np.random.default_rng(5).integers(0, 256, (37, 53), np.uint8)
    got = port.resize_bicubic(torch.from_numpy(img), 24, 80).numpy()
    want = _dense_ref(img, 24, 80, ref._cubic_kernel, 4)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_lanczos_matches_dense():
    img = np.random.default_rng(6).integers(0, 256, (41, 29), np.uint8)
    got = port.resize_lanczos(torch.from_numpy(img), 64, 64).numpy()
    want = _dense_ref(img, 64, 64, ref._lanczos_kernel, 8)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_invariances():
    # constant image stays constant under any filter
    const = torch.full((20, 30, 3), 77, dtype=torch.uint8)
    for fn in (port.resize_bicubic, port.resize_lanczos):
        assert bool((fn(const, 33, 17) == 77).all())
    # identity-size bicubic is exact (weights collapse to a delta)
    img = torch.from_numpy(
        np.random.default_rng(7).integers(0, 256, (16, 16, 3), np.uint8))
    assert torch.equal(port.resize_bicubic(img, 16, 16), img)
    # rotate/flip roundtrips
    assert torch.equal(port.rotate90(port.rotate90(img, 1), 3), img)
    assert torch.equal(port.flip(port.flip(img, horizontal=True),
                                 horizontal=True), img)
    # dispatch
    assert tuple(port.resize(img, 8, 8, "lanczos").shape) == (8, 8, 3)


def test_matches_reference_jax_path():
    """The reference's own bar between its jax and numpy paths: within 1."""
    import jax.numpy as jnp

    img = np.random.default_rng(8).integers(0, 256, (24, 31, 3), np.uint8)
    mine = port.resize_bicubic(torch.from_numpy(img), 40, 18).numpy()
    theirs = np.asarray(ref.resize_bicubic(jnp.asarray(img), 40, 18))
    assert np.abs(mine.astype(int) - theirs.astype(int)).max() <= 1


def test_taps_are_uploaded_once_per_size_and_device():
    port._axis_weights_on.cache_clear()
    img = torch.zeros(2, 19, 23, 3, dtype=torch.uint8)
    port.resize_lanczos(img, 11, 13)
    port.resize_lanczos(img[0], 11, 13)
    info = port._axis_weights_on.cache_info()
    assert info.misses == 2 and info.hits == 2  # one entry an axis
