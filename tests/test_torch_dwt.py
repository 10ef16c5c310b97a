"""The port's torch DWT (nvimagecodec_tpu_torch/ops/dwt.py) against the JAX
package's numpy path (nvimagecodec_tpu/ops/dwt.py picks numpy for numpy
input) on the same inputs, made from a seed.

Tolerances: 5/3 is int32 and bit-exact in both directions; 9/7 in float64
is bit-exact on the CPU (every lift is the same multiply and the same add in
the same order); 9/7 in float32 is within 1e-3 relative to the float64
result's scale."""
import numpy as np
import pytest
import torch

from nvimagecodec_tpu.ops import dwt as ref_dwt
from nvimagecodec_tpu_torch.ops import dwt as port_dwt

SIZES = [(1, 1), (1, 2), (2, 1), (2, 2), (1, 7), (3, 5), (17, 31), (64, 48),
         (33, 1), (100, 150)]
ORIGINS = [(0, 0), (1, 0), (0, 1), (3, 5), (7, 2)]


def _input(shape, reversible, seed, dtype=None):
    rng = np.random.default_rng(seed)
    x = rng.integers(-500, 500, size=shape)
    return x.astype(dtype or (np.int32 if reversible else np.float64))


def _np(bands):
    return [tuple(b.numpy() for b in lvl) for lvl in bands]


def _t(bands):
    return [tuple(torch.from_numpy(b) for b in lvl) for lvl in bands]


@pytest.mark.parametrize("origin", ORIGINS)
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("reversible", [True, False])
def test_dwt2d_and_idwt2d_equal_reference(reversible, size, origin):
    for levels in (1, 2, 3):
        x = _input(size, reversible, seed=levels)
        LLr, br = ref_dwt.dwt2d(x, levels, reversible, origin)
        LLp, bp = port_dwt.dwt2d(torch.from_numpy(x), levels, reversible,
                                 origin)
        assert LLp.numpy().dtype == LLr.dtype
        assert np.array_equal(LLr, LLp.numpy())
        for a, b in zip(br, _np(bp)):
            for u, v in zip(a, b):
                assert u.shape == v.shape and u.dtype == v.dtype
                assert np.array_equal(u, v)
        # synthesis from the REFERENCE's subbands: exact again
        yr = ref_dwt.idwt2d(LLr, br, size, reversible, origin)
        yp = port_dwt.idwt2d(torch.from_numpy(LLr), _t(br), size, reversible,
                             origin)
        assert np.array_equal(yr, yp.numpy())
        if reversible:
            assert np.array_equal(yp.numpy(), x)  # perfect reconstruction


@pytest.mark.parametrize("lead", [(3,), (2, 3), (4, 1)])
@pytest.mark.parametrize("reversible", [True, False])
def test_leading_axes_are_a_batch(reversible, lead):
    x = _input(lead + (21, 30), reversible, seed=5)
    origin, levels = (1, 3), 2
    LL, bands = port_dwt.dwt2d(torch.from_numpy(x), levels, reversible,
                               origin)
    LLr, br = ref_dwt.dwt2d(x, levels, reversible, origin)
    assert np.array_equal(LL.numpy(), LLr)
    # each slice alone gives the same numbers as the batch
    flat = x.reshape((-1,) + x.shape[-2:])
    for i in range(flat.shape[0]):
        LLi, bi = port_dwt.dwt2d(torch.from_numpy(flat[i]), levels,
                                 reversible, origin)
        assert np.array_equal(
            LLi.numpy(), LL.numpy().reshape((-1,) + LLi.shape)[i])
    y = port_dwt.idwt2d(LL, bands, (21, 30), reversible, origin)
    assert y.shape == x.shape
    assert np.array_equal(
        y.numpy(), ref_dwt.idwt2d(LLr, br, (21, 30), reversible, origin))


@pytest.mark.parametrize("parity", [0, 1])
@pytest.mark.parametrize("n", [1, 2, 3, 8, 9])
@pytest.mark.parametrize("reversible", [True, False])
def test_one_axis_lifts_equal_reference(reversible, n, parity):
    """Lengths 1 and 2 and both parities, on either axis: the empty band of
    a one-sample segment included."""
    fr, ir = ((ref_dwt._fwd_lift_53, ref_dwt._inv_lift_53) if reversible
              else (ref_dwt._fwd_lift_97, ref_dwt._inv_lift_97))
    fp, ip = ((port_dwt._fwd_lift_53, port_dwt._inv_lift_53) if reversible
              else (port_dwt._fwd_lift_97, port_dwt._inv_lift_97))
    for axis, shape in ((-1, (4, n)), (-2, (n, 4))):
        x = _input(shape, reversible, seed=n)
        Lr, Hr = fr(x, axis, parity)
        Lp, Hp = fp(torch.from_numpy(x), axis, parity)
        assert Lp.shape == Lr.shape and Hp.shape == Hr.shape
        assert np.array_equal(Lr, Lp.numpy())
        assert np.array_equal(Hr, Hp.numpy())
        back = ip(Lp, Hp, axis, n, parity)
        assert np.array_equal(back.numpy(), ir(Lr, Hr, axis, n, parity))


@pytest.mark.parametrize("size,origin", [((64, 48), (0, 0)),
                                         ((37, 53), (3, 5)),
                                         ((100, 150), (1, 0))])
def test_float32_97_within_envelope(size, origin):
    """The device stage runs 9/7 in float32: within 1e-3 of the float64
    result, relative to its largest magnitude."""
    x = _input(size, False, seed=11)
    levels = 3
    LL64, b64 = ref_dwt.dwt2d(x, levels, False, origin)
    LL32, b32 = port_dwt.dwt2d(torch.from_numpy(x.astype(np.float32)),
                               levels, False, origin)
    assert LL32.dtype == torch.float32
    scale = max(np.abs(LL64).max(), 1.0)
    assert np.abs(LL32.numpy() - LL64).max() <= 1e-3 * scale
    for a, b in zip(b64, _np(b32)):
        for u, v in zip(a, b):
            assert v.dtype == np.float32
            assert np.abs(u - v).max() <= 1e-3 * scale
    y64 = ref_dwt.idwt2d(LL64, b64, size, False, origin)
    y32 = port_dwt.idwt2d(
        torch.from_numpy(LL64.astype(np.float32)),
        _t([tuple(u.astype(np.float32) for u in lvl) for lvl in b64]),
        size, False, origin)
    assert np.abs(y32.numpy() - y64).max() <= 1e-3 * np.abs(y64).max()
    assert np.abs(y32.numpy() - x).max() <= 1e-3 * np.abs(x).max()


@pytest.mark.parametrize("origin", ORIGINS)
def test_subband_dims_and_level_parity_equal_reference(origin):
    for (h, w) in SIZES:
        for levels in range(5):
            assert (port_dwt.subband_dims(h, w, levels, origin)
                    == ref_dwt.subband_dims(h, w, levels, origin))
    for s in range(6):
        assert (port_dwt._level_parity(origin, s)
                == ref_dwt._level_parity(origin, s))


def test_constants_equal_reference():
    for name in ("ALPHA", "BETA", "GAMMA", "DELTA", "K"):
        assert getattr(port_dwt, name) == getattr(ref_dwt, name)


def test_noncontiguous_and_strided_input():
    """Views (a transposed plane, a slice of a larger one) give what their
    contiguous copies give."""
    base = _input((40, 60), True, seed=3)
    view = torch.from_numpy(base).t()[3:34, 2:39]
    LLv, bv = port_dwt.dwt2d(view, 2, True, (1, 1))
    LLc, bc = port_dwt.dwt2d(view.contiguous(), 2, True, (1, 1))
    assert torch.equal(LLv, LLc)
    for a, b in zip(bv, bc):
        for u, v in zip(a, b):
            assert torch.equal(u, v)
    assert torch.equal(port_dwt.idwt2d(LLv, bv, (31, 37), True, (1, 1)),
                       view)


def test_module_has_no_sharded_synthesis():
    """The plain synthesis knows no mesh: row sharding is
    `idwt2d_rows_sharded` alone, and on a one-device mesh it gives the
    plain synthesis's image in one row block."""
    import inspect

    from nvimagecodec_tpu_torch.parallel.mesh import make_mesh

    for fn in (port_dwt.idwt2d, port_dwt.idwt2d_level, port_dwt.dwt2d):
        assert "mesh" not in inspect.signature(fn).parameters
    x = torch.from_numpy(np.random.default_rng(4).integers(
        -500, 500, (3, 32, 24)).astype(np.int32))
    LL, bands = port_dwt.dwt2d(x, 2, True)
    blocks = port_dwt.idwt2d_rows_sharded(
        LL, bands, (32, 24), True, make_mesh(1, 1, [torch.device("cpu")]))
    assert len(blocks) == 1
    assert torch.equal(blocks[0], port_dwt.idwt2d(LL, bands, (32, 24), True))
