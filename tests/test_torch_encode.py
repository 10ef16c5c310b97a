"""The port's JPEG encode path on the CPU against the JAX package's, on the
same seeded photos: the pixel stage (`encode_pixels`), the batched encoder
(`encode_batch_cuda`, device and host routes) and the public `Encoder`.

Both packages build the frame (quantisation tables, sampling factors) and
the folded fDCT matrix from the same `EncodeParams`; the tests assert that
they agree before they compare outputs.

Tolerances, each the reference's own:
- `encode_pixels` on CPU tensors against the reference's numpy path: EXACT
  (integer colour and downsampling, the same float32 product and rounding);
  against the reference's jax path: at most 1 on fewer than 1% of entries
  (tests/test_jpeg_encode.py:84-89);
- streams of the device route against the reference Encoder's: both decode
  under libjpeg (the oracle), decoded pixels within 2 of each other
  (tests/test_jpeg_encode.py:183-197);
- the host route (`device_stage=false`): the reference's bytes."""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import oracle
import nvimagecodec_tpu as ref
import nvimagecodec_tpu_torch as port
from nvimagecodec_tpu.codecs.jpeg import encode as ref_encode
from nvimagecodec_tpu.ops.dct import quant_dct_matrix as ref_quant_dct_matrix
from nvimagecodec_tpu_torch.codecs.jpeg import JpegCpuEncoder, _can_encode
from nvimagecodec_tpu_torch.codecs.jpeg import batch_encode as be
from nvimagecodec_tpu_torch.codecs.jpeg import encode as port_encode
from nvimagecodec_tpu_torch.core import trace
from nvimagecodec_tpu_torch.image import Image
from nvimagecodec_tpu_torch.ops.dct import quant_dct_matrix
from util import make_photo, psnr

CSS = ["444", "422", "420", "440", "411", "gray"]
HOST_ROUTE = "cuda_jpeg_hybrid_encoder:device_stage=false"


def _deep(img):
    """8-bit photo → 12-bit samples in uint16."""
    return (img.astype(np.uint16) << 4) | (img >> 4)


def _frames(h, w, nchan, quality, css, precision=8):
    """The same frame from both packages, checked equal."""
    a = ref_encode.build_encode_frame(
        h, w, nchan, quality, ref_encode._resolve_css(
            ref.EncodeParams(chroma_subsampling=css), nchan), precision)
    b = port_encode.build_encode_frame(
        h, w, nchan, quality, port_encode._resolve_css(
            port.EncodeParams(chroma_subsampling=css), nchan), precision)
    assert (a.marker, a.precision, a.height, a.width) == \
        (b.marker, b.precision, b.height, b.width)
    assert [(c.comp_id, c.h, c.v, c.tq) for c in a.components] == \
        [(c.comp_id, c.h, c.v, c.tq) for c in b.components]
    assert a.quant.keys() == b.quant.keys()
    for k in a.quant:
        np.testing.assert_array_equal(a.quant[k], b.quant[k])
        np.testing.assert_array_equal(ref_quant_dct_matrix(a.quant[k]),
                                      quant_dct_matrix(b.quant[k]))
    return a, b


def _photo(css, h=57, w=83, seed=5, deep=False):
    img = make_photo(h, w, seed=seed)
    if css == "gray":
        img = img[:, :, 0]
    return _deep(img) if deep else img


@pytest.mark.parametrize("deep", [False, True], ids=["uint8", "uint16"])
@pytest.mark.parametrize("css", CSS)
def test_encode_pixels_matches_reference(css, deep):
    img = _photo(css, deep=deep)
    nchan = 1 if img.ndim == 2 else 3
    fa, fb = _frames(img.shape[0], img.shape[1], nchan, 85,
                     None if css == "gray" else css, 12 if deep else 8)
    want = ref_encode.encode_pixels(img, fa, use_jax=False)
    want_jax = ref_encode.encode_pixels(img, fa, use_jax=True)
    for source in (img, torch.from_numpy(img)):
        got = port_encode.encode_pixels(source, fb, device="cpu")
        for g, w, wj in zip(got, want, want_jax):
            assert g.dtype == torch.int32 and g.device.type == "cpu"
            np.testing.assert_array_equal(g.numpy(), w)  # exact
            diff = np.abs(g.numpy().astype(int) - np.asarray(wj).astype(int))
            assert diff.max() <= 1 and (diff > 0).mean() < 0.01


def test_encode_pixels_batched_equals_per_image():
    imgs = np.stack([make_photo(40, 56, seed=s) for s in range(3)])
    _, frame = _frames(40, 56, 3, 80, "420")
    both = port_encode.encode_pixels(imgs, frame)
    for j in range(3):
        for a, b in zip(both, port_encode.encode_pixels(imgs[j], frame)):
            assert torch.equal(a[j], b)


def test_quant_matrix_is_cached_per_table_and_device():
    _, frame = _frames(16, 16, 3, 77, "420")
    a = port_encode.quant_matrix(frame.quant[0], "cpu")
    assert port_encode.quant_matrix(frame.quant[0].copy(), "cpu") is a
    assert port_encode.quant_matrix(frame.quant[1], "cpu") is not a
    np.testing.assert_array_equal(a.numpy(), quant_dct_matrix(frame.quant[0]))


@pytest.mark.parametrize("css", CSS)
def test_encoder_device_route_matches_reference(css, monkeypatch):
    monkeypatch.setenv("TIC_ENCODE_DEVICE", "1")
    imgs = [_photo(css, 64, 80, seed=s) for s in range(3)]
    kw = dict(quality=90,
              chroma_subsampling=None if css == "gray" else css)
    before = dict(be.ROUTES)
    mine = port.Encoder(device="cpu").encode(imgs, "jpeg",
                                             port.EncodeParams(**kw))
    assert be.ROUTES["device"] - before["device"] == 3
    assert be.ROUTES["host"] == before["host"]
    theirs = ref.Encoder().encode(imgs, "jpeg", ref.EncodeParams(**kw))
    for img, a, b in zip(imgs, mine, theirs):
        da = oracle.jpeg_decode(a).astype(int)
        db = oracle.jpeg_decode(b).astype(int)
        assert np.abs(da - db).max() <= 2  # quantizer boundary effects
        assert psnr(img, da.squeeze()) > 33


def test_encoder_device_route_equals_host_encoder_bytes():
    """On the CPU the batched pixel stage is the host encoder's: the same
    bytes as `encode_jpeg`, and so as the JAX package's host encoder."""
    imgs = [make_photo(57, 83, seed=s) for s in range(2)]
    p = dict(quality=75, chroma_subsampling="420")
    mine = port.Encoder(device="cpu").encode(imgs, "jpeg",
                                             port.EncodeParams(**p))
    for img, data in zip(imgs, mine):
        assert data == ref_encode.encode_jpeg(img, ref.EncodeParams(**p))


def test_encoder_takes_tensors_images_and_arrays_alike():
    img = make_photo(48, 64, seed=2)
    enc = port.Encoder(device="cpu")
    p = port.EncodeParams(quality=85, chroma_subsampling="422")
    want = enc.encode(img, "jpeg", p)
    t = torch.from_numpy(img)
    assert enc.encode(t, "jpeg", p) == want
    assert enc.encode(Image(t), "jpeg", p) == want
    assert enc.encode([img, t, Image(img)], "jpeg", p) == [want] * 3
    assert enc.encode(t[:, :, :1].contiguous(), "jpeg", p) == \
        enc.encode(img[:, :, 0], "jpeg", p)  # [H, W, 1] is gray


def test_encoder_does_not_copy_jpeg_input_to_the_host(monkeypatch):
    """A tensor goes to the JPEG plugin as it is; only the host codecs get
    numpy arrays."""
    seen = []

    def no_cpu(self):
        seen.append("cpu")
        return self

    monkeypatch.setattr(Image, "cpu", no_cpu)
    t = torch.from_numpy(make_photo(32, 40, seed=1))
    enc = port.Encoder(device="cpu")
    assert enc.encode(t, "jpeg")[:2] == b"\xff\xd8"
    assert seen == []
    assert enc.encode(t, "bmp")[:2] == b"BM"
    assert seen == ["cpu"]


def test_can_encode_reads_no_pixels():
    """A tensor on a device without storage (as a stand-in for one on the
    card) is judged from shape and dtype alone."""
    ok = port.ProcessingStatus.SUCCESS
    meta = torch.empty(8, 8, 3, dtype=torch.uint8, device="meta")
    with pytest.raises(Exception):
        np.asarray(meta)
    got = _can_encode([meta, torch.empty(8, 8, 4, dtype=torch.uint8,
                                         device="meta"),
                       torch.empty(8, 8, dtype=torch.float32, device="meta"),
                       np.zeros((8, 8, 1), np.uint16)])
    assert [bool(s & ok) for s in got] == [True, False, False, True]


def test_twelve_bit_batch_roundtrips():
    imgs = [_deep(make_photo(40, 56, seed=s)) for s in range(2)]
    p = dict(quality=95, chroma_subsampling="420")
    mine = port.Encoder(device="cpu").encode(
        [imgs[0], torch.from_numpy(imgs[1])], "jpeg", port.EncodeParams(**p))
    for img, data in zip(imgs, mine):
        assert data == ref_encode.encode_jpeg(img, ref.EncodeParams(**p))
        back = port.Decoder(device="cpu").decode(
            data, port.DecodeParams(allow_any_depth=True))
        assert back.dtype == np.uint16
        assert psnr(img >> 4, np.asarray(back) >> 4) > 33


def test_host_route_gives_the_reference_bytes(monkeypatch):
    """`device_stage=false` is the reference's host route (fused native
    encoder): the stream of the reference's own host-route test, byte for
    byte (tests/test_jpeg_encode.py
    test_fused_encoder_via_encoder_api_host_route)."""
    monkeypatch.setenv("TIC_ENCODE_DEVICE", "0")
    img = make_photo(81, 123, seed=6)
    kw = dict(quality=88, chroma_subsampling="420")
    want = ref.Encoder().encode(img, codec="jpeg",
                                params=ref.EncodeParams(**kw))
    before = dict(be.ROUTES)
    enc = port.Encoder(device="cpu", options=HOST_ROUTE)
    got = enc.encode(img, "jpeg", port.EncodeParams(**kw))
    assert got == want
    assert be.ROUTES["host"] - before["host"] == 1
    assert be.ROUTES["device"] == before["device"]
    assert psnr(img, oracle.jpeg_decode(got)) > 33
    assert psnr(img, np.asarray(port.Decoder(device="cpu").decode(got))) > 33


@pytest.mark.parametrize("case", ["gray", "444", "optimized", "uint16",
                                  "tensor"])
def test_host_route_fallbacks_match_reference(case, monkeypatch):
    """What the fused native encoder does not cover goes to the native pixel
    stage or to `encode_jpeg`, as in the reference: the same bytes."""
    monkeypatch.setenv("TIC_ENCODE_DEVICE", "0")
    img = make_photo(45, 67, seed=8)
    kw = dict(quality=80, chroma_subsampling="420")
    jp = {}
    if case == "gray":
        img = img[:, :, 0].copy()
        kw.pop("chroma_subsampling")
    elif case == "444":
        kw["chroma_subsampling"] = "444"
    elif case == "optimized":
        jp = dict(optimized_huffman=True)
    elif case == "uint16":
        img = _deep(img)
    want = ref.Encoder().encode(img, "jpeg", ref.EncodeParams(
        jpeg=ref.JpegEncodeParams(**jp), **kw))
    src = torch.from_numpy(img) if case == "tensor" else img
    got = port.Encoder(device="cpu", options=HOST_ROUTE).encode(
        src, "jpeg", port.EncodeParams(jpeg=port.JpegEncodeParams(**jp),
                                       **kw))
    assert got is not None and got == want


def test_mixed_batch_with_a_bad_dtype_gives_one_none():
    imgs = [make_photo(40, 56, seed=1), make_photo(24, 32, seed=2),
            make_photo(40, 56, seed=3).astype(np.float32),
            make_photo(40, 56, seed=4)[:, :, 0], make_photo(40, 56, seed=5)]
    p = port.EncodeParams(quality=85, chroma_subsampling="420")
    out = port.Encoder(device="cpu").encode(imgs, "jpeg", p)
    assert [d is None for d in out] == [False, False, True, False, False]
    for img, data in zip(imgs, out):
        if data is not None:
            assert data == port_encode.encode_jpeg(img, p)
            assert oracle.jpeg_decode(data).squeeze().shape == img.shape


def test_batch_encoder_fails_bad_samples_alone():
    imgs = [make_photo(16, 24, seed=1), np.zeros((8, 8, 4), np.uint8),
            np.zeros((2, 8, 8, 3), np.uint8), np.zeros((8, 8), np.int32)]
    out = be.encode_batch_cuda(imgs, port.EncodeParams(), "cpu")
    ok = [bool(r.status & port.ProcessingStatus.SUCCESS) for r in out]
    assert ok == [True, False, False, False]
    assert "shape" in out[1].error and "shape" in out[2].error
    assert "dtype" in out[3].error


def test_optimized_huffman_smaller_same_pixels():
    img = make_photo(121, 203, seed=9)
    enc = port.Encoder(device="cpu")
    kw = dict(quality=90, chroma_subsampling="420")
    d0 = enc.encode(img, "jpeg", port.EncodeParams(**kw))
    d1 = enc.encode(img, "jpeg", port.EncodeParams(
        jpeg=port.JpegEncodeParams(optimized_huffman=True), **kw))
    assert len(d1) < len(d0)
    assert np.array_equal(oracle.jpeg_decode(d0), oracle.jpeg_decode(d1))
    assert d1 == ref_encode.encode_jpeg(img, ref.EncodeParams(
        jpeg=ref.JpegEncodeParams(optimized_huffman=True), **kw))


def test_progressive_takes_the_per_sample_host_path():
    imgs = [make_photo(64, 80, seed=3), make_photo(64, 80, seed=4)[:, :, 0]]
    jp = dict(progressive=True)
    before = dict(be.ROUTES)
    out = port.Encoder(device="cpu").encode(
        [torch.from_numpy(i) for i in imgs], "jpeg", port.EncodeParams(
            quality=88, jpeg=port.JpegEncodeParams(**jp)))
    assert be.ROUTES["progressive"] - before["progressive"] == 2
    assert be.ROUTES["device"] == before["device"]
    for img, data in zip(imgs, out):
        assert data == ref_encode.encode_jpeg(img, ref.EncodeParams(
            quality=88, jpeg=ref.JpegEncodeParams(**jp)))
        base = port_encode.encode_jpeg(img, port.EncodeParams(quality=88))
        assert np.array_equal(oracle.jpeg_decode(data),
                              oracle.jpeg_decode(base))


def test_device_pixel_stage_option_of_the_cpu_encoder():
    """cpu_jpeg_encoder:device_pixel_stage=true runs `encode_pixels` on the
    encoder's device (here the CPU, so the bytes are the host encoder's)."""
    img = make_photo(64, 80, seed=4)
    p = port.EncodeParams(quality=90, chroma_subsampling="420")
    cpu_only = [port.Backend(port.BackendKind.CPU_ONLY)]
    before = dict(be.ROUTES)
    d1 = port.Encoder(device="cpu", backends=cpu_only,
                      options="cpu_jpeg_encoder:device_pixel_stage=true"
                      ).encode(img, "jpeg", p)
    d2 = port.Encoder(device="cpu", backends=cpu_only).encode(img, "jpeg", p)
    assert be.ROUTES == before  # the hybrid encoder was filtered out
    assert d1 == d2
    a = np.asarray(port.Decoder(device="cpu").decode(d1)).astype(int)
    b = np.asarray(ref.Decoder().decode(d2)).astype(int)
    assert np.abs(a - b).max() <= 2


def test_gpu_backend_only_has_no_cpu_rung_for_a_rejected_sample():
    hybrid = [port.Backend(port.BackendKind.HYBRID_CPU_GPU)]
    enc = port.Encoder(device="cpu", backends=hybrid)
    assert enc.encode(np.zeros((8, 8, 3), np.float32), "jpeg") is None
    assert enc.encode(make_photo(16, 16, seed=0), "jpeg") is not None
    assert enc.encode(make_photo(16, 16, seed=0), "png") is None


@pytest.mark.parametrize("entry", ["encode", "encode_one", "encode_async",
                                   "get", "user_executor", "mixed_batch"])
def test_device_stage_error_raises(entry, monkeypatch):
    """An exception out of the device encode stage surfaces from every entry
    point, and cpu_jpeg_encoder answers for no sample of that batch."""
    def broken(*a, **k):
        raise RuntimeError("encode stage: CUDA error 700")

    cpu_calls = []
    monkeypatch.setattr(be, "encode_pixels", broken)
    monkeypatch.setattr(JpegCpuEncoder, "encode_batch",
                        lambda self, *a: cpu_calls.append(a))
    imgs = [make_photo(24, 32, seed=s) for s in range(4)]
    enc = port.Encoder(device="cpu")
    if entry in ("encode", "encode_one"):
        with pytest.raises(RuntimeError, match="CUDA error"):
            enc.encode(imgs if entry == "encode" else imgs[0], "jpeg")
    elif entry in ("encode_async", "get"):
        fut = enc._generic.encode_batch_async(imgs, [None] * 4, "jpeg")
        with pytest.raises(RuntimeError, match="CUDA error"):
            fut.wait_all(timeout=60) if entry == "encode_async" \
                else fut.get(2, timeout=60)
    elif entry == "user_executor":
        with ThreadPoolExecutor(2) as pool:
            with pytest.raises(RuntimeError, match="CUDA error"):
                port.Encoder(device="cpu", executor=pool).encode(imgs, "jpeg")
    else:  # a sample the GPU plugin rejects rides along: still no answer
        with pytest.raises(RuntimeError, match="CUDA error"):
            enc.encode(imgs + [np.zeros((8, 8, 3), np.float32)], "jpeg")
    assert cpu_calls == []


def test_rejected_sample_still_falls_through_to_the_cpu_encoder(monkeypatch):
    """`can_encode` rejections walk the chain as in the reference."""
    from nvimagecodec_tpu_torch.codecs.jpeg import JpegHybridCudaEncoder

    monkeypatch.setattr(
        JpegHybridCudaEncoder, "can_encode",
        lambda self, imgs, infos, params: [
            port.ProcessingStatus.FAIL] * len(imgs))
    img = make_photo(24, 32, seed=1)
    before = dict(be.ROUTES)
    data = port.Encoder(device="cpu").encode([img, img], "jpeg")
    assert be.ROUTES == before
    assert data == [port_encode.encode_jpeg(img)] * 2


def test_per_sample_host_failure_falls_through(monkeypatch):
    """A sample the hybrid encoder accepted and whose host stage then fails
    falls through to its own failure, a None, and not to cpu_jpeg_encoder:
    that one would copy the image to the host and encode it again unseen.
    Its neighbours keep their streams and no exception is raised."""
    real = be._finish_one
    calls, cpu_batches = [], []

    def flaky(frame, coefs, jp, tail=None):
        calls.append(1)
        if len(calls) == 2:
            raise ValueError("entropy stage failed for this sample")
        return real(frame, coefs, jp, tail)

    monkeypatch.setattr(be, "_finish_one", flaky)
    monkeypatch.setattr(JpegCpuEncoder, "encode_batch",
                        lambda self, *a: cpu_batches.append(a))
    imgs = [make_photo(24, 32, seed=s) for s in range(3)]
    before = dict(be.ROUTES)
    out = port.Encoder(device="cpu").encode(imgs, "jpeg")
    assert len(calls) == 3 and cpu_batches == []
    assert be.ROUTES["device"] - before["device"] == 2
    want = [port_encode.encode_jpeg(i) for i in imgs]
    assert [o is None for o in out].count(True) == 1
    assert all(o is None or o == w for o, w in zip(out, want))


def test_bucket_tail_gives_the_per_sample_bytes():
    """Header, tables and native arguments shared across a bucket change no
    byte of a stream."""
    img = make_photo(40, 56, seed=6)
    params = port.EncodeParams(quality=85, chroma_subsampling="420")
    frame = be.bucket_frame(img.shape, params, 8)
    coefs = [c.to(torch.int16).numpy()
             for c in port_encode.encode_pixels(img, frame)]
    jp = port.JpegEncodeParams()
    alone = be._finish_one(frame, coefs, jp)
    assert be._finish_one(frame, coefs, jp, be._standard_tail(frame)) == alone
    assert alone == port_encode.encode_jpeg(img, params)


def test_tf32_is_refused_on_a_cuda_device():
    """TF32 no longer touches the encode: the card's fDCT+quant product is
    `fdct_quant_blocks`, no matmul, so the encode no longer refuses
    allow_tf32. With it on, the device route runs and gives the JAX
    package's bytes (the card's half is in test_torch_gpu.py)."""
    old = torch.backends.cuda.matmul.allow_tf32
    imgs = [make_photo(16, 16, seed=0), make_photo(40, 56, seed=1)]
    params = port.EncodeParams(quality=85, chroma_subsampling="420")
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = [r.data for r in be.encode_batch_cuda(imgs, params, "cpu")]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    assert not old  # PyTorch's default
    rparams = ref.EncodeParams(quality=85, chroma_subsampling="420")
    assert got == ref.Encoder().encode(imgs, "jpeg", rparams)


def test_spans_of_the_device_route():
    trace.start_collect()
    try:
        port.Encoder(device="cpu").encode(
            [make_photo(24, 32, seed=s) for s in range(2)], "jpeg")
    finally:
        got = trace.stop_collect()
    for name in ("imgcodec.jpeg.encode_device_stage",
                 "imgcodec.jpeg.encode_host_entropy",
                 "imgcodec.encode.cuda_jpeg_hybrid_encoder"):
        assert got["spans"].get(name, 0) > 0, name
    # nothing crosses a bus on the CPU
    assert "imgcodec.jpeg.d2h_bytes" not in got["counters"]


def test_write_and_read_back(tmp_path):
    img = make_photo(50, 70, seed=11)
    enc, dec = port.Encoder(device="cpu"), port.Decoder(device="cpu")
    p = tmp_path / "x.jpg"
    enc.write(p, torch.from_numpy(img))
    assert psnr(img, np.asarray(dec.read(str(p)))) > 38
    with pytest.raises(ValueError, match="cannot infer codec"):
        enc.write(tmp_path / "x.unknown", img)


def test_package_exports_follow_the_reference():
    missing = [n for n in ref.__all__ if not hasattr(port, n)]
    assert missing == []
    assert port.global_registry() is port.port_registry()


def test_cpu_encoder_names_a_device_only_for_its_device_pixel_stage():
    """cpu_jpeg_encoder is the CPU_ONLY plugin: it holds no device until the
    option device_pixel_stage asks for the pixel stage on one."""
    plugin = JpegCpuEncoder()
    assert plugin.device is None
    plugin.set_options({"device": "cpu"})
    assert plugin.device is None and not plugin.device_pixel_stage
    plugin.set_options({"device_pixel_stage": "true", "device": "cpu"})
    assert plugin.device == torch.device("cpu")


@pytest.mark.parametrize("css", ["420", "444", "gray"])
def test_encode_pixels_runs_the_fdct_plain_version_on_the_cpu(css,
                                                              monkeypatch):
    """On the CPU, `fdct_quant_blocks` inside `encode_pixels` takes its plain
    version (`torch.matmul`, no kernel launch) once per component, so the
    coefficients stay the JAX package's numpy path's and the bytes its host
    encoder's."""
    from nvimagecodec_tpu_torch.ops import kernels

    calls = []
    real = kernels.fdct_quant_blocks_plain

    def spy(x, M):
        calls.append(tuple(x.shape))
        return real(x, M)

    monkeypatch.setattr(kernels, "fdct_quant_blocks_plain", spy)
    img = _photo(css)
    nchan = 1 if img.ndim == 2 else 3
    fa, fb = _frames(img.shape[0], img.shape[1], nchan, 85,
                     None if css == "gray" else css)
    before = kernels.fdct_quant_blocks.launches
    got = port_encode.encode_pixels(img, fb, device="cpu")
    assert len(calls) == nchan and all(s[-1] == 64 for s in calls)
    assert kernels.fdct_quant_blocks.launches == before
    for g, w in zip(got, ref_encode.encode_pixels(img, fa, use_jax=False)):
        np.testing.assert_array_equal(g.numpy(), w)
    p = dict(quality=85, chroma_subsampling=None if css == "gray" else css)
    assert (port_encode.encode_jpeg(img, port.EncodeParams(**p))
            == ref_encode.encode_jpeg(img, ref.EncodeParams(**p)))


def test_fdct_plain_version_rounds_half_away_from_zero():
    from nvimagecodec_tpu_torch.ops import kernels

    x = torch.zeros(2, 64)
    x[0, :6] = torch.tensor([2.5, -2.5, 0.49, -0.49, -0.5, 7.0])
    got = kernels.fdct_quant_blocks(x, torch.eye(64))
    assert got.dtype == torch.int32
    assert got[0, :6].tolist() == [3, -3, 0, 0, -1, 7]
    assert not got[1].any()


def test_fdct_wrapper_refuses_other_devices():
    from nvimagecodec_tpu_torch.ops import kernels

    with pytest.raises(ValueError):
        kernels.fdct_quant_blocks(torch.zeros(4, 64, device="meta"),
                                  torch.eye(64, device="meta"))
