"""The port's multi-device layer on the CPU: meshes of a repeated
`torch.device("cpu")`, one twin of each test of tests/test_parallel.py.
Every sharded result equals the port's unsharded one and the JAX package's
sharded one on the conftest's 8 virtual devices, from the same inputs:
exactly for JPEG (bitexact, the integer IDCT, where the two packages' float
IDCTs may differ by 1) and the 5/3 transform, within 1e-3 for 9/7."""
import numpy as np
import pytest
import torch

import jax
import oracle
import nvimagecodec_tpu as ref
import nvimagecodec_tpu_torch as port
from nvimagecodec_tpu.parallel.mesh import make_mesh as ref_make_mesh
from nvimagecodec_tpu_torch.codecs.jpeg import batch as jb
from nvimagecodec_tpu_torch.core.scheduler import GenericEncoder
from nvimagecodec_tpu_torch.ops import dwt as port_dwt
from nvimagecodec_tpu_torch.parallel import mesh as pmesh
from nvimagecodec_tpu_torch.parallel import multihost, tiles
from util import make_photo

CPU = torch.device("cpu")
BITEXACT = "bitexact=true"


def cpu_mesh(dp, sp=1):
    return pmesh.make_mesh(dp=dp, sp=sp, devices=[CPU] * 8)


def _settled(fn):
    """The JAX package's JPEG decode as it gives it twice running (on a
    loaded machine its decoder now and then hands out a batch that is not
    its own; ROADMAP queue 3)."""
    last = fn()
    for _ in range(4):
        again = fn()
        if all(np.array_equal(a, b) for a, b in zip(last, again)):
            return again
        last = again
    raise AssertionError("the reference's decode does not settle")


def _arrays(images):
    return [np.asarray(im.array if isinstance(im, port.Image) else im)
            for im in images]


def test_make_mesh_shapes_and_axis_devices():
    m = cpu_mesh(2, 4)
    assert m.shape == {"dp": 2, "sp": 4} and m.axis_names == ("dp", "sp")
    assert m.shape.get("dp", 1) == 2 and len(m.flat_devices()) == 8
    assert m.axis_devices("dp") == [CPU, CPU]
    assert len(m.axis_devices("sp")) == 4 and m.first_device == CPU
    assert pmesh.make_mesh(sp=2, devices=[CPU] * 7).shape == {"dp": 3,
                                                              "sp": 2}
    with pytest.raises(ValueError):
        pmesh.make_mesh(dp=3, sp=3, devices=[CPU] * 8)
    x = torch.arange(10 * 4 * 6).reshape(10, 4, 6)
    parts = pmesh.batch_sharding(x, cpu_mesh(4))
    assert [p.shape[0] for p in parts] == [3, 3, 2, 2]
    assert torch.equal(torch.cat(parts), x)
    planes = pmesh.plane_sharding(x, cpu_mesh(2, 2))
    assert len(planes) == 4 and torch.equal(
        torch.cat([torch.cat(planes[0:2], 1), torch.cat(planes[2:4], 1)]), x)
    assert all(torch.equal(r, x) for r in pmesh.replicated(x, cpu_mesh(2)))


def test_make_mesh_never_picks_the_cpu_by_detection(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmesh.make_mesh()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert pmesh.make_mesh().flat_devices() == [torch.device("cuda", 0),
                                                torch.device("cuda", 1)]


def test_dp_sharded_pixel_stage():
    from jax.sharding import NamedSharding, PartitionSpec as P

    from nvimagecodec_tpu.codecs.jpeg import encode as ref_encode
    from nvimagecodec_tpu.codecs.jpeg.pixel import decode_pixels as ref_dp
    from nvimagecodec_tpu.core.types import ChromaSubsampling as RefCss
    from nvimagecodec_tpu_torch.codecs.jpeg import encode as port_encode
    from nvimagecodec_tpu_torch.codecs.jpeg.pixel import decode_pixels

    # the same coefficients for both packages: the JAX package's numpy
    # encode of 8 photos
    imgs = np.stack([make_photo(48, 64, seed=s) for s in range(8)])
    rframe = ref_encode.build_encode_frame(48, 64, 3, 90, RefCss.CSS_420)
    rcoefs = [np.asarray(c) for c in ref_encode.encode_pixels(imgs, rframe)]
    frame = port_encode.build_encode_frame(
        48, 64, 3, 90, port.ChromaSubsampling.CSS_420)
    coefs = [torch.from_numpy(c.astype(np.int16)) for c in rcoefs]
    parts = [pmesh.batch_sharding(c, cpu_mesh(4)) for c in coefs]
    got = torch.cat([decode_pixels(frame, [p[k] for p in parts],
                                   bitexact=True) for k in range(4)])
    assert got.shape == (8, 48, 64, 3)
    assert torch.equal(got, decode_pixels(frame, coefs, bitexact=True))

    mesh = ref_make_mesh(dp=4, sp=2)
    shard = NamedSharding(mesh, P("dp"))
    fn = jax.jit(lambda y, cb, cr: ref_dp(rframe, [y, cb, cr], use_jax=True,
                                          bitexact=True),
                 out_shardings=shard)
    want = fn(*[jax.device_put(c, shard) for c in rcoefs])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sp_tile_pipeline_with_halo_exchange():
    from nvimagecodec_tpu.ops import dwt as ref_dwt
    from nvimagecodec_tpu.parallel.tiles import (
        idwt_tiles_sharded as ref_tiles_sharded,
    )

    tiles.dryrun_tile_exchange(cpu_mesh(2, 4))
    x = np.random.default_rng(5).integers(-128, 128, (8, 16, 16)).astype(
        np.int32)
    LL, bands = port_dwt.dwt2d(torch.from_numpy(x), 2, True)
    got = tiles.idwt_tiles_sharded(LL, bands, (16, 16), True, cpu_mesh(2, 4))
    assert [t.shape[0] for t in got] == [2, 2, 2, 2]
    rLL, rbands = ref_dwt.dwt2d(x, 2, reversible=True)
    want = ref_tiles_sharded(rLL, rbands, (16, 16), True,
                             ref_make_mesh(dp=2, sp=4))
    np.testing.assert_array_equal(torch.cat(got).numpy(), np.asarray(want))
    np.testing.assert_array_equal(torch.cat(got).numpy(), x)


@pytest.mark.parametrize("levels", [3, 5])
def test_idwt_rows_sharded_bit_exact(levels):
    """Row-sharded inverse DWT over sp=8 with halo rows copied between the
    shards reconstructs the forward transform exactly (levels=5 runs its two
    coarsest levels replicated and hands off with a row slice); 9/7 stays
    within 1e-3 of the unsharded float path."""
    mesh = cpu_mesh(1, 8)
    rng = np.random.default_rng(1)
    for shape in ((64, 48), (3, 64, 48)):
        x = rng.integers(-4000, 4000, shape).astype(np.int32)
        LL, bands = port_dwt.dwt2d(torch.from_numpy(x), levels, True)
        blocks = port_dwt.idwt2d_rows_sharded(LL, bands, shape[-2:], True,
                                              mesh)
        assert len(blocks) == 8
        np.testing.assert_array_equal(torch.cat(blocks, dim=-2).numpy(), x)
    x = rng.integers(0, 255, (64, 48)).astype(np.float32)
    LL, bands = port_dwt.dwt2d(torch.from_numpy(x), levels, False)
    got = torch.cat(port_dwt.idwt2d_rows_sharded(LL, bands, (64, 48), False,
                                                 mesh), dim=-2)
    want = port_dwt.idwt2d(LL, bands, (64, 48), False)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-3)


@pytest.mark.parametrize("reversible", [True, False])
def test_idwt_rows_sharded_matches_reference(reversible):
    """The same inputs through the JAX package's row-sharded synthesis over
    its 8 virtual devices: 5/3 exact, 9/7 within 1e-3."""
    from nvimagecodec_tpu.ops import dwt as ref_dwt

    rng = np.random.default_rng(6)
    x = (rng.integers(-4000, 4000, (32, 24)).astype(np.int32) if reversible
         else rng.integers(0, 255, (32, 24)).astype(np.float32))
    LL, bands = port_dwt.dwt2d(torch.from_numpy(x), 2, reversible)
    got = torch.cat(port_dwt.idwt2d_rows_sharded(
        LL, bands, (32, 24), reversible, cpu_mesh(1, 8)), dim=-2).numpy()
    rLL, rbands = ref_dwt.dwt2d(x, 2, reversible=reversible)
    want = np.asarray(ref_dwt.idwt2d_rows_sharded(
        rLL, rbands, (32, 24), reversible, ref_make_mesh(dp=1, sp=8)))
    if reversible:
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, x)
    else:
        np.testing.assert_allclose(got, want, atol=1e-3)


def test_idwt_rows_sharded_uneven_takes_the_replicated_fallback():
    x = torch.from_numpy(np.random.default_rng(2).integers(
        -99, 99, (50, 30)).astype(np.int32))
    LL, bands = port_dwt.dwt2d(x, 2, True)
    blocks = port_dwt.idwt2d_rows_sharded(LL, bands, (50, 30), True,
                                          cpu_mesh(1, 8))
    assert len(blocks) == 1 and torch.equal(blocks[0], x)


def _photo_jpgs(n=8, h=40, w=56, **kw):
    return [oracle.jpeg_encode(make_photo(h, w, seed=s), 88, "420", **kw)
            for s in range(n)]


@pytest.mark.parametrize("dp,n", [(8, 16), (4, 10)])
def test_decoder_mesh_jpeg_dp_bit_exact(dp, n):
    """Decoder(mesh=...): each JPEG bucket splits over "dp" (a batch of 10
    over dp=4 gives shards of 3, 3, 2, 2) and equals the one-device decode
    exactly, and, with bitexact, the JAX package's sharded decode. The
    route is the unsharded decode's: idx for the 16 images over dp=8 (shards
    of 2), the host route for the 10."""
    jpgs = (_photo_jpgs() * 2)[:n]
    want = port.Decoder(device="cpu").decode(jpgs)
    before = dict(jb.ROUTES)
    got = port.Decoder(device="cpu", mesh=cpu_mesh(dp)).decode(jpgs)
    route = "idx" if n >= jb._MIN_BATCH else "host"
    assert {k: jb.ROUTES[k] - before[k] for k in before} == dict(
        dict.fromkeys(before, 0), **{route: n})
    for a, b in zip(want, got):
        assert torch.equal(a.array, b.array)
    opt = f"cuda_jpeg_hybrid_decoder:{BITEXACT}"
    mine = port.Decoder(device="cpu", options=opt,
                        mesh=cpu_mesh(dp)).decode(jpgs)
    theirs = _settled(lambda: _arrays(ref.Decoder(
        options=f"tpu_jpeg_hybrid_decoder:{BITEXACT}",
        mesh=ref_make_mesh(dp=dp, sp=1)).decode(jpgs)))
    for a, b in zip(_arrays(mine), theirs):
        np.testing.assert_array_equal(a, b)


def test_decode_j2k_mesh_tiles_and_rows_bit_exact():
    """decode_j2k(mesh=...): a uniform 4x4 tile grid splits its tiles over
    "sp", a single tile its inverse DWT's rows; both equal the unsharded
    decode and the JAX package's sharded decode (5/3)."""
    from nvimagecodec_tpu.codecs.jpeg2000 import core as ref_core
    from nvimagecodec_tpu_torch.codecs.jpeg2000 import core as port_core
    from nvimagecodec_tpu_torch.core import trace

    img = make_photo(64, 64, seed=3)
    rmesh = ref_make_mesh(dp=1, sp=4)
    tiled = port_core.encode_j2k(img, reversible=True, levels=2, tile_size=16)
    single = port_core.encode_j2k(img, reversible=True, levels=2)
    for data, counter in ((tiled, "tile_shards"), (single, "row_shards")):
        want = port_core.decode_j2k(data, device=None)
        np.testing.assert_array_equal(want, img)
        for sp in (2, 4, 8):
            trace.start_collect()
            got = port_core.decode_j2k(data, device=None,
                                       mesh=cpu_mesh(1, sp))
            seen = trace.stop_collect()["counters"]
            assert seen.get(f"imgcodec.jpeg2k.{counter}") == sp
            assert isinstance(got, torch.Tensor) and got.device == CPU
            np.testing.assert_array_equal(got.numpy(), want)
            if sp == 4:
                np.testing.assert_array_equal(got.numpy(), np.asarray(
                    ref_core.decode_j2k(data, mesh=rmesh)))


def test_decoder_mesh_j2k_and_9_7_rows():
    """Through Decoder(mesh=): the J2K plugin hands its mesh to decode_j2k
    for an image its device-stage rule takes (forced here: on the CPU the
    rule keeps every image on the host), not for one the rule keeps on the
    host, nor for an ROI request; 9/7 rows over sp=4 stay within 1 of the
    host path."""
    from nvimagecodec_tpu_torch.codecs.jpeg2000 import core as port_core
    from nvimagecodec_tpu_torch.core import trace

    img = make_photo(64, 64, seed=4)
    rev = port_core.encode_j2k(img, reversible=True, levels=3)
    irr = port_core.encode_j2k(img, reversible=False, quality=85, levels=3)
    trace.start_collect()
    host = port.Decoder(device="cpu", mesh=cpu_mesh(2, 4)).decode(rev)
    assert "imgcodec.jpeg2k.row_shards" not in trace.stop_collect()[
        "counters"]
    assert torch.equal(torch.as_tensor(host.array), torch.from_numpy(img))
    dec = port.Decoder(device="cpu", mesh=cpu_mesh(2, 4), options=(
        "cuda_jpeg2k_hybrid_decoder:device_pixel_stage=true"))
    trace.start_collect()
    got = dec.decode([rev, irr])
    seen = trace.stop_collect()["counters"]
    assert seen.get("imgcodec.jpeg2k.row_shards") == 8
    assert torch.equal(got[0].array, torch.from_numpy(img))
    host = port_core.decode_j2k(irr, device=None)
    assert int((got[1].array.int() - torch.from_numpy(host).int())
               .abs().max()) <= 1
    roi = port.DecodeParams(region=port.Region(8, 8, 40, 48),
                            enable_roi=True)
    trace.start_collect()
    part = dec.decode(rev, roi)
    assert "imgcodec.jpeg2k.row_shards" not in trace.stop_collect()[
        "counters"]
    assert torch.equal(part.array, torch.from_numpy(img[8:40, 8:48]))


def test_pipeline_decode_batches_sharded():
    from nvimagecodec_tpu_torch.pipeline import decode_batches

    imgs = [make_photo(32, 48, seed=s) for s in range(8)]
    pngs = [oracle.png_encode(i) for i in imgs]
    got = list(decode_batches(iter([pngs, pngs[:6]]), mesh=cpu_mesh(4),
                              decoder=port.Decoder(device="cpu")))
    assert len(got) == 2
    assert [t.shape[0] for t in got[0]] == [2, 2, 2, 2]
    assert [t.shape[0] for t in got[1]] == [2, 2, 1, 1]  # uneven
    for g, n in zip(got, (8, 6)):
        assert all(t.device == CPU for t in g)
        assert torch.equal(torch.cat(g), torch.from_numpy(np.stack(imgs[:n])))


def test_multihost_stream_sharding_balance():
    from nvimagecodec_tpu.parallel.multihost import (
        shard_streams as ref_shard_streams,
    )

    rng = np.random.default_rng(0)
    streams = [bytes(int(rng.integers(10, 5000))) for _ in range(37)]
    shards = multihost.shard_streams(streams, 4)
    assert sorted(i for s in shards for i in s) == list(range(37))
    loads = [sum(len(streams[i]) for i in s) for s in shards]
    assert max(loads) < 1.5 * min(loads)  # largest-first deal balances
    assert shards == ref_shard_streams(streams, 4)


def test_multihost_global_batch_single_process():
    multihost.initialize()  # no-op for one process
    local = torch.arange(8 * 4 * 6 * 3, dtype=torch.uint8).reshape(8, 4, 6, 3)
    arr = multihost.global_batch(local)
    assert arr.shape == (8, 4, 6, 3)
    assert torch.equal(arr, local)


def test_decoder_mesh_dp_device_entropy_composes(monkeypatch):
    """Restart-interval streams with Decoder(mesh=): the 16-image bucket
    takes K2's route as it does unsharded, and the route runs on every dp
    shard (no quiet fallback to the host route, though each shard holds
    fewer images than the route's floor); the output is bit-exact vs the
    one-device decode, and vs the JAX package's sharded decode with
    bitexact."""
    f0 = jb.parse_jpeg_structure(_photo_jpgs(1, 48, 64)[0])
    ri = -(-f0.width // (8 * f0.hmax))  # one MCU row per restart segment
    jpgs = _photo_jpgs(4, 48, 64, restart_interval=ri) * 4
    assert len(jpgs) == jb._MIN_BATCH
    want = port.Decoder(device="cpu").decode(jpgs)

    calls, launches = [], []
    orig = jb._try_device_entropy
    orig_k2 = jb.decode_segments_into

    def spy(idxs, *a, **kw):
        r = orig(idxs, *a, **kw)
        calls.append((len(idxs), r is not None and len(r) < len(idxs)))
        return r

    def k2_spy(*a, **kw):
        launches.append(a[8])  # the shard's image count
        return orig_k2(*a, **kw)

    monkeypatch.setattr(jb, "_try_device_entropy", spy)
    monkeypatch.setattr(jb, "decode_segments_into", k2_spy)
    before = dict(jb.ROUTES)
    got = port.Decoder(device="cpu", mesh=cpu_mesh(4)).decode(jpgs)
    # the bucket took the device route with all its images, 4 on each shard
    assert calls == [(16, True)], calls
    assert launches == [4, 4, 4, 4], launches
    assert jb.ROUTES["dri"] - before["dri"] == 16
    assert jb.ROUTES["host"] == before["host"]
    for a, b in zip(want, got):
        assert torch.equal(a.array, b.array)
    mine = port.Decoder(device="cpu", mesh=cpu_mesh(4), options=(
        f"cuda_jpeg_hybrid_decoder:{BITEXACT}")).decode(jpgs)
    theirs = _settled(lambda: _arrays(ref.Decoder(
        options=f"tpu_jpeg_hybrid_decoder:{BITEXACT}",
        mesh=ref_make_mesh(dp=4, sp=1)).decode(jpgs)))
    for a, b in zip(_arrays(mine), theirs):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dp", [2, 3])
def test_generic_encoder_mesh_gives_the_unsharded_bytes(dp):
    """GenericEncoder(mesh=): every bucket splits over "dp" (10 images of
    two shapes, uneven shards) and each stream is the unsharded encode's and
    the JAX package's host encode's; and the JAX package's sharded encode's
    wherever that one gives its own unsharded bytes (its XLA product may
    round a coefficient another way for another shard shape)."""
    from nvimagecodec_tpu.core.registry import global_registry as ref_reg
    from nvimagecodec_tpu.core.scheduler import GenericEncoder as RefGE

    params = port.EncodeParams(
        quality=85, chroma_subsampling=port.ChromaSubsampling.CSS_420)
    imgs = ([make_photo(48, 64, seed=s) for s in range(6)]
            + [make_photo(40, 56, seed=s) for s in range(4)])
    tensors = [torch.from_numpy(i) for i in imgs]
    enc = GenericEncoder(registry=port.port_registry(), mesh=cpu_mesh(dp),
                         options="cuda_jpeg_hybrid_encoder:device=cpu")
    got = [r.data for r in enc.encode_batch(tensors, [None] * 10, "jpeg",
                                            params)]
    assert got == port.Encoder(device="cpu").encode(tensors, "jpeg", params)
    rparams = ref.EncodeParams(
        quality=85, chroma_subsampling=ref.ChromaSubsampling.CSS_420)
    theirs = ref.Encoder().encode(imgs, "jpeg", rparams)
    assert got == theirs
    sharded = [r.data for r in RefGE(
        registry=ref_reg(), mesh=ref_make_mesh(dp=dp, sp=1)).encode_batch(
            imgs, [None] * 10, "jpeg", rparams)]
    assert all(a == b for a, b, c in zip(got, sharded, theirs) if b == c)
