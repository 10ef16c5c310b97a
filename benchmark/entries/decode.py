"""Entry "decode": the training loader's path.

`pipeline.decode_batches(batches, decoder=Decoder(device=..., options=
<traffic decoder_options>), depth=<traffic depth>)`: every batch of streams
comes out as decoded RGB images, complete in device memory, in the order
the batches went in.
"""
from __future__ import annotations


class Entry:
    def __init__(self, traffic: dict, device):
        import nvimagecodec_tpu_torch as nic

        self.decoder = nic.Decoder(
            device=device, options=traffic.get("decoder_options", ""))
        self.depth = int(traffic["depth"])

    def run(self, batches):
        """One list of outputs a batch, None where a sample failed."""
        from nvimagecodec_tpu_torch.pipeline import decode_batches

        yield from decode_batches(batches, decoder=self.decoder,
                                  drop_failed=False, depth=self.depth)

    @staticmethod
    def keep(out):
        """A host copy of one output, for the judge."""
        return out.array.cpu().numpy()
