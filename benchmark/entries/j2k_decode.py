"""Entry "j2k_decode": a training loader reading a lossless JPEG 2000
store.

The pool's JPEG streams stand for the store's images: on first sight of
one (the warm-up hands every stream of the pool over once) the entry makes
its lossless J2K codestream (j2k_streams.convert, in worker processes) and
keeps it under the JPEG stream's identity; the pool's workers end once
every stream has one, so nothing is converted in the window. Then, as the
"decode" entry: `pipeline.decode_batches(batches, decoder=Decoder(device=
..., options=<traffic decoder_options>), depth=<traffic depth>)`, every
batch decoded to RGB images complete in device memory.
"""
from __future__ import annotations

from benchmark import j2k_streams


class Entry:
    def __init__(self, traffic: dict, device):
        import nvimagecodec_tpu_torch as nic

        self.decoder = nic.Decoder(
            device=device, options=traffic.get("decoder_options", ""))
        self.depth = int(traffic["depth"])
        self.device = device
        self.pool_size = int(traffic["corpus"]["streams"])
        self.codestreams = {}  # JPEG stream -> its J2K codestream
        self.converter = j2k_streams.Converter(min(self.pool_size, 8))

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

        yield from decode_batches(self._codestreams(batches),
                                  decoder=self.decoder, drop_failed=False,
                                  depth=self.depth)

    def keep(self, out):
        """For the judge: a host copy of one output, and whether it is off
        the device of a CUDA run."""
        a = out.array
        return (a.cpu().numpy(),
                self.device.type == "cuda" and a.device.type != "cuda")
