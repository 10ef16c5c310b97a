"""Entry "j2k_dci_decode": a digital-cinema server or a QC tool decoding
the picture track of a 2K DCP, frame after frame.

The pool's JPEG streams stand for the track's pictures: on first sight of
one (the warm-up hands every stream of the pool over once) the entry makes
its Profile-3 codestream (dci_streams.convert, in worker processes) and
keeps it under the JPEG stream's identity; the pool's workers end once
every stream has one, so nothing is converted in the window. Then
`pipeline.decode_batches(batches, DecodeParams(allow_any_depth=True),
decoder=Decoder(device=..., options=<traffic decoder_options>),
depth=<traffic depth>)`: every batch decoded to 12-bit X'Y'Z' frames
(uint16), complete in device memory.
"""
from __future__ import annotations

from benchmark import dci_streams


class Entry:
    def __init__(self, traffic: dict, device):
        import nvimagecodec_tpu_torch as nic

        self.decoder = nic.Decoder(
            device=device, options=traffic.get("decoder_options", ""))
        self.params = nic.DecodeParams(allow_any_depth=True)
        self.depth = int(traffic["depth"])
        self.device = device
        self.pool_size = int(traffic["corpus"]["streams"])
        self.codestreams = {}  # JPEG stream -> its DCI codestream
        self.converter = dci_streams.Converter(min(self.pool_size, 8))

    def _codestreams(self, batches):
        for batch in batches:
            new = [s for s in dict.fromkeys(batch)
                   if s not in self.codestreams]
            if new:
                self.codestreams.update(zip(new, self.converter.map(new)))
                if len(self.codestreams) >= self.pool_size:
                    self.converter.close()
            yield [self.codestreams[s] for s in batch]

    def run(self, batches):
        """One list of outputs a batch, None where a sample failed."""
        from nvimagecodec_tpu_torch.pipeline import decode_batches

        yield from decode_batches(self._codestreams(batches), self.params,
                                  decoder=self.decoder, drop_failed=False,
                                  depth=self.depth)

    def keep(self, out):
        """For the judge: a host copy of one output, and whether it is off
        the device of a CUDA run."""
        a = out.array
        return (a.cpu().numpy(),
                self.device.type == "cuda" and a.device.type != "cuda")
