"""Entry "transcode": the transcoding service's path.

`pipeline.decode_batches(..., decoder=Decoder(device=..., options=
<traffic decoder_options>), depth=<traffic depth>)` on the card, then,
where the traffic gives `resize` {"height", "width", "interp"}, one stacked
`ops.resize.resize` of the batch on the card, then `Encoder(device=...)
.encode(images, "jpeg", params)` with the traffic's `encode` {"quality",
"subsampling", "optimized_huffman"}. A batch is done when its bytes are in
hand.
"""
from __future__ import annotations

_CSS = {"420": "CSS_420", "422": "CSS_422", "444": "CSS_444"}


class Entry:
    def __init__(self, traffic: dict, device):
        import nvimagecodec_tpu_torch as nic

        enc = traffic["encode"]
        self.decoder = nic.Decoder(
            device=device, options=traffic.get("decoder_options", ""))
        self.encoder = nic.Encoder(device=device)
        self.params = nic.EncodeParams(
            quality=enc["quality"],
            chroma_subsampling=getattr(nic.ChromaSubsampling,
                                       _CSS[enc["subsampling"]]),
            jpeg=nic.JpegEncodeParams(
                optimized_huffman=bool(enc["optimized_huffman"])))
        self.resize = traffic.get("resize")
        self.depth = int(traffic["depth"])

    def run(self, batches):
        """One list of output streams a batch, None where a sample failed."""
        import torch

        from nvimagecodec_tpu_torch.ops.resize import resize
        from nvimagecodec_tpu_torch.pipeline import decode_batches

        for outs in decode_batches(batches, decoder=self.decoder,
                                   drop_failed=False, depth=self.depth):
            good = [k for k, o in enumerate(outs) if o is not None]
            imgs = [outs[k].array for k in good]
            if imgs and self.resize:
                r = self.resize
                imgs = list(resize(torch.stack(imgs), r["height"],
                                   r["width"], r["interp"]))
            data = self.encoder.encode(imgs, "jpeg", self.params) if imgs \
                else []
            result = [None] * len(outs)
            for k, d in zip(good, data):
                result[k] = d
            yield result

    @staticmethod
    def keep(out):
        return out
