"""The CUDA port's public Decoder/Encoder on the CPU against the JAX
package's, on the same streams: within 1 (exact with bitexact=true) for
JPEG, equal for the host codecs. Also the idx route (taken, and equal to the
host route), failed samples, interop exports, and that a device-stage error
raises instead of failing over to a CPU decoder."""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import oracle
import nvimagecodec_tpu as ref
import nvimagecodec_tpu_torch as port
from nvimagecodec_tpu_torch.codecs.jpeg import JpegCpuDecoder
from nvimagecodec_tpu_torch.codecs.jpeg import batch as jb
from util import add_exif_orientation, make_photo

BUCKET = 16  # the idx route's minimum bucket


def _jpgs(n, ss="420", q=85, h=96, w=144):
    return [oracle.jpeg_encode(make_photo(h, w, seed=s), q, ss)
            for s in range(n)]


def _diff(a, b) -> int:
    a = np.asarray(a).astype(np.int64)
    b = np.asarray(b).astype(np.int64)
    assert a.shape == b.shape
    return int(np.abs(a - b).max())


@pytest.fixture(scope="module")
def bucket():
    return _jpgs(BUCKET)


def test_idx_route_matches_reference(bucket):
    before = dict(jb.ROUTES)
    out = port.Decoder(device="cpu").decode(bucket)
    assert jb.ROUTES["idx"] - before["idx"] == BUCKET
    assert jb.ROUTES["host"] == before["host"]
    want = ref.Decoder().decode(bucket)
    for a, b in zip(out, want):
        assert isinstance(a.array, torch.Tensor) and a.device.type == "cpu"
        assert _diff(a, b) <= 1


def test_idx_route_bitexact_matches_reference(bucket):
    opt = "bitexact=true"
    out = port.Decoder(device="cpu",
                       options=f"cuda_jpeg_hybrid_decoder:{opt}").decode(bucket)
    want = ref.Decoder(options=f"tpu_jpeg_hybrid_decoder:{opt}").decode(bucket)
    for a, b in zip(out, want):
        assert _diff(a, b) == 0


def test_idx_route_equals_host_route(bucket):
    params = port.DecodeParams()
    idx = jb.decode_batch_cuda(bucket, params, "cpu")
    before = jb.ROUTES["host"]
    host = jb.decode_batch_cuda(bucket, params, "cpu", device_entropy=False)
    assert jb.ROUTES["host"] - before == BUCKET
    for a, b in zip(idx, host):
        assert torch.equal(a.array, b.array)


@pytest.mark.parametrize("ss", ["422", "444", "440", "411", "410", "gray"])
def test_host_route_chroma_matches_reference(ss):
    imgs = [make_photo(64, 88, seed=s) for s in range(3)]
    datas = [oracle.jpeg_encode(im[:, :, 0], 85) if ss == "gray"
             else oracle.jpeg_encode(im, 85, ss) for im in imgs]
    out = port.Decoder(device="cpu").decode(datas)
    want = ref.Decoder().decode(datas)
    for a, b in zip(out, want):
        assert _diff(a, b) <= 1


def test_bucket_image_rows_are_views(bucket):
    out = port.Decoder(device="cpu").decode(bucket)
    base = out[0].array.untyped_storage().data_ptr()
    assert all(o.array.untyped_storage().data_ptr() == base for o in out)


def test_mixed_batch_with_corrupt_sample():
    datas = _jpgs(3, "444") + [b"\xff\xd8\xff\xe0garbage", b"not an image"]
    datas.insert(1, oracle.png_encode(make_photo(40, 50, seed=4)))
    out = port.Decoder(device="cpu").decode(datas)
    want = ref.Decoder().decode(datas)
    assert [o is None for o in out] == [w is None for w in want]
    assert out[4] is None and out[5] is None
    for a, b in zip(out, want):
        if a is not None:
            assert _diff(a, b) <= 1


def test_corrupt_entropy_in_bucket_fails_alone(bucket):
    datas = list(bucket)
    bad = bytearray(datas[5])
    bad[len(bad) // 2:len(bad) // 2 + 64] = b"\xff\xd9" * 32
    datas[5] = bytes(bad)
    out = port.Decoder(device="cpu").decode(datas)
    want = ref.Decoder().decode(datas)
    for j, (a, b) in enumerate(zip(out, want)):
        if j != 5:
            assert _diff(a, b) <= 1


@pytest.mark.parametrize("fmt", ["png", "tiff", "webp", "bmp", "pnm"])
def test_host_codecs_match_reference(fmt):
    img = make_photo(40, 56, seed=9)
    data = {
        "png": lambda: oracle.png_encode(img),
        "tiff": lambda: oracle.tiff_encode(img),
        "webp": lambda: oracle.webp_encode_rgb(img, 80.0),
        "bmp": lambda: port.Encoder().encode(img, "bmp"),
        "pnm": lambda: port.Encoder().encode(img, "pnm"),
    }[fmt]()
    a = port.Decoder(device="cpu").decode(data)
    b = ref.Decoder().decode(data)
    assert a.buffer_kind == "strided_host"
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_encode_matches_reference():
    img = make_photo(48, 64, seed=2)
    for codec in ("png", "jpeg", "bmp"):
        assert port.Encoder(device="cpu").encode(img, codec) == \
            ref.Encoder().encode(img, codec)


def test_interop_exports(bucket):
    img = port.Decoder(device="cpu").decode(bucket[0])
    t = torch.from_dlpack(img)
    assert t.data_ptr() == img.array.data_ptr()
    a = np.asarray(img)
    assert a.shape == (96, 144, 3) and a.dtype == np.uint8
    assert np.asarray(port.as_image(a)).ctypes.data == a.ctypes.data
    assert img.__array_interface__["shape"] == (96, 144, 3)
    assert img.cpu() is img and img.dtype == np.uint8


@pytest.mark.parametrize("orientation", [2, 3, 6, 8])
def test_exif_orientation_matches_reference(orientation):
    data = add_exif_orientation(_jpgs(1, "444", h=40, w=56)[0], orientation)
    a = port.Decoder(device="cpu").decode(data)
    b = ref.Decoder().decode(data)
    assert _diff(a, b) <= 1


def test_roi_gray_and_convert_match_reference():
    data = _jpgs(1, "420", h=64, w=80)[0]
    region = port.Region(8, 16, 40, 72)
    cases = [
        port.DecodeParams(enable_roi=True, region=region),
        port.DecodeParams(color_spec=port.ColorSpec.GRAY),
        port.DecodeParams(sample_format=port.SampleFormat.P_RGB),
        port.DecodeParams(sample_format=port.SampleFormat.I_BGR,
                          sample_type=port.SampleDataType.FLOAT32),
        port.DecodeParams(sample_type=port.SampleDataType.UINT16),
    ]
    for p in cases:
        a = port.Decoder(device="cpu").decode(data, p)
        b = ref.Decoder().decode(data, p)
        assert a.shape == tuple(np.asarray(b).shape)
        assert a.dtype == np.asarray(b).dtype
        tol = 1 / 255 + 1e-6 if a.dtype == np.float32 else 257
        assert np.abs(np.asarray(a).astype(np.float64)
                      - np.asarray(b).astype(np.float64)).max() <= tol


@pytest.mark.parametrize("entry", ["decode", "decode_one", "decode_async",
                                   "user_executor", "mixed_batch"])
def test_device_stage_error_raises(bucket, entry, monkeypatch):
    """A kernel failure surfaces from every entry point (the pool, the
    inline single-sample path, a user executor), and no sample is
    re-decoded by cpu_jpeg_decoder."""
    def broken(*a, **k):
        raise RuntimeError("K1 idct launch: CUDA error 98")

    cpu_calls = []
    monkeypatch.setattr(jb, "idct_planes", broken)
    monkeypatch.setattr(JpegCpuDecoder, "decode_batch",
                        lambda self, *a: cpu_calls.append(a))
    if entry in ("decode", "decode_one"):
        with pytest.raises(RuntimeError, match="CUDA error"):
            port.Decoder(device="cpu").decode(
                bucket if entry == "decode" else bucket[0])
    elif entry == "decode_async":
        fut = port.Decoder(device="cpu").decode_async(bucket)
        with pytest.raises(RuntimeError, match="CUDA error"):
            fut.wait_all(timeout=60)
    elif entry == "user_executor":
        with ThreadPoolExecutor(2) as pool:
            dec = port.Decoder(device="cpu", executor=pool)
            with pytest.raises(RuntimeError, match="CUDA error"):
                dec.decode(bucket)
            fut = dec.decode_async(bucket)
            with pytest.raises(RuntimeError, match="CUDA error"):
                fut.wait_new(timeout=60)
    else:
        png = oracle.png_encode(make_photo(20, 24, seed=1))
        with pytest.raises(RuntimeError, match="CUDA error"):
            port.Decoder(device="cpu").decode([png] + list(bucket))
    assert cpu_calls == []


def test_flagged_lanes_are_reissued_to_host_route(bucket, monkeypatch):
    real = jb.decode_segments_into

    def flag_first_image(*args):
        out, err = real(*args)
        err = err.clone()
        err[0] = 1
        return out, err

    monkeypatch.setattr(jb, "decode_segments_into", flag_first_image)
    before = dict(jb.ROUTES)
    out = port.Decoder(device="cpu").decode(bucket)
    assert jb.ROUTES["reissued"] - before["reissued"] == 1
    assert jb.ROUTES["host"] - before["host"] == 1
    want = ref.Decoder().decode(bucket)
    for a, b in zip(out, want):
        assert _diff(a, b) <= 1


@pytest.mark.parametrize("restart, route", [(0, "idx"), (9, "dri")])
def test_device_entropy_option_keeps_every_sample_on_the_host_route(
        restart, route, monkeypatch):
    """`cuda_jpeg_hybrid_decoder:device_entropy=false` is the JAX package's
    TIC_NO_DEVICE_ENTROPY: every sample of a bucket the idx route (no
    restart markers) or the dri route (one restart interval a row of 9
    MCUs) takes by default is counted under the host route, and the images
    equal the default decode's and are within 1 of the reference's host
    route."""
    jpgs = [oracle.jpeg_encode(make_photo(96, 144, seed=s), 85, "420",
                               restart_interval=restart)
            for s in range(BUCKET)]
    before = dict(jb.ROUTES)
    default = port.Decoder(device="cpu").decode(jpgs)
    assert jb.ROUTES[route] - before[route] == BUCKET
    before = dict(jb.ROUTES)
    out = port.Decoder(
        device="cpu",
        options="cuda_jpeg_hybrid_decoder:device_entropy=false").decode(jpgs)
    took = {k: jb.ROUTES[k] - before[k] for k in before}
    assert took == {"idx": 0, "dri": 0, "host": BUCKET, "reissued": 0}
    monkeypatch.setenv("TIC_NO_DEVICE_ENTROPY", "1")
    want = ref.Decoder().decode(jpgs)
    for a, b, c in zip(out, default, want):
        assert torch.equal(a.array, b.array)
        assert _diff(a, c) <= 1


@pytest.mark.parametrize("args, error", [
    ({"max_mb": "64"}, TypeError), ({"max_mb": -1}, ValueError),
    ({"per_key_cap": 1.5}, TypeError), ({"per_key_cap": -2}, ValueError),
    ({"alloc": 3}, TypeError)])
def test_configure_host_pool_checks_its_arguments(args, error):
    with pytest.raises(error, match="configure_host_pool"):
        port.configure_host_pool(**args)


def test_configure_host_pool_and_its_options_change_nothing(bucket):
    """The port has no host pool: configure_host_pool takes the reference's
    arguments and does nothing, and the JPEG plugin takes the reference's
    pool options and ignores them."""
    default = port.Decoder(device="cpu").decode(bucket)

    def alloc(shape, dtype):
        return np.empty(shape, dtype)

    assert port.configure_host_pool(max_mb=128, per_key_cap=3,
                                    alloc=alloc) is None
    assert port.configure_host_pool() is None
    out = port.Decoder(device="cpu", options=(
        "cuda_jpeg_hybrid_decoder:host_pool_mb=64 "
        "cuda_jpeg_hybrid_decoder:host_pool_per_key_cap=2")).decode(bucket)
    for a, b in zip(out, default):
        assert torch.equal(a.array, b.array)


def test_gpu_backend_kind_filters_host_rungs():
    data = oracle.png_encode(make_photo(20, 24, seed=1))
    gpu_only = [port.Backend(port.BackendKind.HYBRID_CPU_GPU)]
    assert port.Decoder(device="cpu", backends=gpu_only).decode(data) is None
    cpu_only = [port.Backend(port.BackendKind.CPU_ONLY)]
    assert port.Decoder(device="cpu", backends=cpu_only).decode(data) \
        is not None
