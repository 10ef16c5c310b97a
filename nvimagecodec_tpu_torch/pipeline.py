"""Input-pipeline integration: decode batches straight onto the device.

The port of nvimagecodec_tpu/pipeline.py. The production
consumption pattern of an image codec on an accelerator is a training or
serving input pipeline: encoded bytes stream in on the host, decoded pixel
batches come out as device tensors, with the decode of batch N+1 overlapping
the consumer's work on batch N (the 2-page pipeline analog,
extensions/nvjpeg/cuda_decoder.cpp:425-427).
"""
from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Iterator, Optional, Sequence

import torch

from .api import Decoder
from .core.interfaces import DecodeParams
from .core.trace import span
from .parallel.mesh import shard_bounds


def decode_batches(
    stream_batches: Iterable[Sequence[bytes]],
    params: Optional[DecodeParams] = None,
    decoder: Optional[Decoder] = None,
    drop_failed: bool = True,
    depth: int = 2,
    mesh=None,
) -> Iterator[list]:
    """Yield one list of decoded images per input batch of encoded byte
    strings, pipelined `depth` batches deep: decode() calls for upcoming
    batches run on prefetch threads, so batch N's device work and the
    consumer's use of it overlap batch N+1's host stages (header parse,
    index scan, host entropy decode). Completion is forced one batch late,
    like the modelled library's 2-page host/GPU pipeline
    (extensions/nvjpeg/cuda_decoder.cpp:425-427).

    A decode enqueues its device work on the current CUDA stream of the
    thread that runs it, here a prefetch thread (PyTorch's default stream
    unless that thread set another), which need not be the consumer's. So
    each batch records one event after its last enqueue, and the generator
    waits for that event on the host before it yields the batch. What a
    consumer may assume: every tensor of a yielded batch is complete in
    device memory and may be read from any stream without further
    synchronisation. Failed samples are dropped, or kept as None with
    drop_failed=False. `decoder` defaults to `Decoder()`, on the card, or to
    `Decoder(mesh=mesh)`.

    With a mesh (parallel.mesh.Mesh) and outputs of one shape, a batch comes
    out as a list of `dp` stacked tensors instead: the batch's contiguous
    shards, in order, each on its "dp" device, so that `torch.cat` of them on
    one device is the unsharded stack. Each device that holds a shard or
    decoded an image records its own event, and all are waited for.

    With depth > 1, `decoder.decode` is called from `depth` threads at the
    same time, so a decoder given here must be safe for that. The port's
    `Decoder` is: its caches are filled by single dictionary reads and
    writes (at worst a value is built twice), and the route counters and the
    kernel wrappers' launch counts are updated under locks."""
    dec = decoder or Decoder(mesh=mesh)
    params = params or DecodeParams()

    def _one(batch):
        with span("imgcodec.pipeline.batch"):
            outs = dec.decode(list(batch), params)
            if drop_failed:
                outs = [o for o in outs if o is not None]
            devices = {dec.device}
            devices.update(o.array.device for o in outs if o is not None)
            if mesh is not None and outs and None not in outs and len(
                    {tuple(o.shape) for o in outs}) == 1:
                outs = _shard_stack([o.array for o in outs], mesh)
                devices.update(t.device for t in outs)
            # each stream is in order: its event completes after the batch's
            # work on that device
            events = []
            for d in devices:
                if d.type == "cuda":
                    event = torch.cuda.Event()
                    event.record(torch.cuda.current_stream(d))
                    events.append(event)
            return outs, events

    def _force(done):
        outs, events = done
        if events:
            with span("imgcodec.pipeline.device_wait"):
                for event in events:
                    event.synchronize()
        return outs

    depth = max(1, depth)
    if depth == 1:
        for batch in stream_batches:
            yield _force(_one(batch))
        return

    ex = ThreadPoolExecutor(max_workers=depth,
                            thread_name_prefix="tic-pipeline")
    try:
        futs: deque = deque()
        it = iter(stream_batches)
        done = False
        while True:
            while not done and len(futs) < depth:
                try:
                    futs.append(ex.submit(_one, next(it)))
                except StopIteration:
                    done = True
            if not futs:
                break
            yield _force(futs.popleft().result())
    finally:
        ex.shutdown(wait=False)


def _shard_stack(arrays, mesh) -> list:
    """Same-shape images as `dp` stacked tensors: contiguous shards of the
    batch in order, each on its "dp" device (an empty shard gives an empty
    stack)."""
    devs = mesh.axis_devices("dp")
    return [torch.stack([a.to(d, non_blocking=True) for a in arrays[lo:hi]])
            if hi > lo else
            torch.empty((0,) + tuple(arrays[0].shape), dtype=arrays[0].dtype,
                        device=d)
            for (lo, hi), d in zip(shard_bounds(len(arrays), len(devs)), devs)]
