"""Command-line tools: `imtrans` (transcoder) and `improc` (decode →
crop/resize → encode pipeline).

The port of nvimagecodec_tpu/cli.py, the counterparts of the modelled
library's sample apps (example/nvimtrans/main.cpp:144-779 +
command_line_params.h — flags -i/-o/-c/-q/--psnr/--chroma_subsampling/
--reversible/--num_decomps/--block_size/--optimized_huffman/
--ignore_orientation/-b batch/-v, per-phase timing;
example/nvimproc/main.cpp:29-48 — decode, crop, resize, encode). Same flags
and output, plus `--device` (default cuda): JPEG decodes and encodes there,
JPEG2000 runs its pixel stage there when decoding, `improc` crops and
resizes there, and a decoded image goes to the encoder as the tensor it is.
JPEG2000 output (-c jp2|j2k|jpeg2k) is encoded on the host.

Usage:
    python -m nvimagecodec_tpu_torch.cli imtrans -i in.jpg -c bmp -o out_dir/
    python -m nvimagecodec_tpu_torch.cli improc -i in.jpg --resize 256x256 \\
        -c jpeg -o out/ --device cpu
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from typing import List


def _collect_inputs(path: str) -> List[str]:
    if os.path.isdir(path):
        return sorted(
            os.path.join(path, f)
            for f in os.listdir(path)
            if not f.startswith(".")
        )
    return [path]


def _build_encode_params(args):
    from .core.interfaces import (
        EncodeParams,
        Jpeg2kEncodeParams,
        JpegEncodeParams,
    )

    return EncodeParams(
        quality=args.quality,
        target_psnr=args.psnr,
        chroma_subsampling=args.chroma_subsampling,
        jpeg=JpegEncodeParams(
            progressive=args.jpeg_encoding == "progressive",
            optimized_huffman=args.optimized_huffman,
        ),
        jpeg2k=Jpeg2kEncodeParams(
            reversible=args.reversible,
            num_resolutions=args.num_decomps + 1,
            code_block_w=args.block_size,
            code_block_h=args.block_size,
            stream_type="jp2" if args.output_codec == "jp2" else "j2k",
        ),
    )


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("-i", "--input", required=True, help="input file or dir")
    p.add_argument("-o", "--output", default=".", help="output file or dir")
    p.add_argument("-c", "--output_codec", default="bmp",
                   help="bmp|pnm|png|tiff|jpeg|jpeg2k|jp2|j2k")
    p.add_argument("-q", "--quality", type=float, default=95)
    p.add_argument("--psnr", type=float, default=50)
    p.add_argument("--chroma_subsampling", default=None,
                   help="444|422|420|440|411|410|gray")
    p.add_argument("--reversible", action="store_true")
    p.add_argument("--num_decomps", type=int, default=5)
    p.add_argument("--block_size", type=int, default=64)
    p.add_argument("--optimized_huffman", action="store_true")
    p.add_argument("--jpeg_encoding", default="baseline",
                   choices=["baseline", "progressive"])
    p.add_argument("--ignore_orientation", action="store_true")
    p.add_argument("-b", "--batch_size", type=int, default=16)
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device of the JPEG codec and of crop/resize "
                        "(default cuda; cpu runs everything on the host)")
    p.add_argument("-l", "--list-devices", action="store_true",
                   help="print available accelerator devices and exit")


_EXT = {"bmp": ".bmp", "pnm": ".ppm", "jpeg": ".jpg", "jpg": ".jpg",
        "png": ".png", "tiff": ".tif", "tif": ".tif",
        "jpeg2k": ".j2k", "j2k": ".j2k", "jp2": ".jp2"}


def cmd_imtrans(args) -> int:
    from . import Decoder, Encoder
    from .core.interfaces import DecodeParams

    dec = Decoder(device=args.device)
    enc = Encoder(device=args.device)
    dparams = DecodeParams(apply_exif_orientation=not args.ignore_orientation)
    eparams = _build_encode_params(args)
    inputs = _collect_inputs(args.input)
    out_is_dir = os.path.isdir(args.output) or len(inputs) > 1
    if out_is_dir:
        os.makedirs(args.output, exist_ok=True)

    total_decode = total_encode = 0.0
    failures = 0
    for i in range(0, len(inputs), args.batch_size):
        batch = inputs[i : i + args.batch_size]
        t0 = time.perf_counter()
        imgs = dec.read(batch if len(batch) > 1 else batch[0], dparams)
        if not isinstance(imgs, list):
            imgs = [imgs]
        total_decode += time.perf_counter() - t0
        t0 = time.perf_counter()
        for path, img in zip(batch, imgs):
            if img is None:
                print(f"[fail] {path}", file=sys.stderr)
                failures += 1
                continue
            base = os.path.splitext(os.path.basename(path))[0]
            ext = _EXT.get(args.output_codec, "." + args.output_codec)
            out_path = (
                os.path.join(args.output, base + ext)
                if out_is_dir
                else args.output
            )
            data = enc.encode(img, args.output_codec, eparams)
            if data is None:
                print(f"[encode-fail] {path}", file=sys.stderr)
                failures += 1
                continue
            parent = os.path.dirname(out_path)
            if parent:
                os.makedirs(parent, exist_ok=True)
            with open(out_path, "wb") as f:
                f.write(data)
            if args.verbose:
                print(f"{path} -> {out_path} ({len(data)} B)")
        total_encode += time.perf_counter() - t0

    n = len(inputs) - failures
    print(f"processed {n}/{len(inputs)} images; "
          f"decode {total_decode:.3f}s, encode {total_encode:.3f}s")
    return 1 if failures else 0


def cmd_improc(args) -> int:
    from . import Decoder, Encoder
    from .core.interfaces import DecodeParams
    from .ops.resize import crop as _crop
    from .ops.resize import resize as _resize

    dec = Decoder(device=args.device)
    enc = Encoder(device=args.device)
    eparams = _build_encode_params(args)
    inputs = _collect_inputs(args.input)
    if os.path.isdir(args.output) or len(inputs) > 1:
        os.makedirs(args.output, exist_ok=True)

    crop = None
    if args.crop:
        x, y, w, h = (int(v) for v in args.crop.replace("x", ",").split(","))
        crop = (x, y, w, h)
    resize = None
    if args.resize:
        w, h = (int(v) for v in args.resize.split("x"))
        resize = (h, w)

    for path in inputs:
        img = dec.read(path, DecodeParams())
        if img is None:
            print(f"[fail] {path}", file=sys.stderr)
            continue
        # a host codec's image joins the JPEG ones on the decoder's device
        a = img.array.to(dec.device)
        if crop:
            a = _crop(a, *crop)
        if resize:
            a = _resize(a, resize[0], resize[1], interp=args.interp)
        base = os.path.splitext(os.path.basename(path))[0]
        ext = _EXT.get(args.output_codec, "." + args.output_codec)
        out_path = (
            os.path.join(args.output, base + ext)
            if os.path.isdir(args.output)
            else args.output
        )
        data = enc.encode(a, args.output_codec, eparams)
        if data is None:
            print(f"[encode-fail] {path}", file=sys.stderr)
            continue
        with open(out_path, "wb") as f:
            f.write(data)
        if args.verbose:
            print(f"{path} -> {out_path} ({tuple(a.shape)})")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="nvimagecodec_tpu_torch.cli")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p1 = sub.add_parser("imtrans", help="transcode images (nvimtrans analog)")
    _add_common(p1)
    p2 = sub.add_parser("improc", help="decode→crop/resize→encode (nvimproc)")
    _add_common(p2)
    p2.add_argument("--crop", default=None, help="x,y,w,h")
    p2.add_argument("--resize", default=None, help="WxH")
    p2.add_argument("--interp", default="bilinear",
                    choices=["bilinear", "bicubic", "lanczos"],
                    help="resize interpolation (CV-CUDA mode analog)")
    args = ap.parse_args(argv)
    if getattr(args, "list_devices", False):
        import torch

        for d in range(torch.cuda.device_count()):
            print(f"cuda:{d} {torch.cuda.get_device_name(d)}")
        return 0
    if args.cmd == "imtrans":
        return cmd_imtrans(args)
    return cmd_improc(args)


if __name__ == "__main__":
    raise SystemExit(main())
