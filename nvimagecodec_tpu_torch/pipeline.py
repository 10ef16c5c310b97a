"""Input-pipeline integration: decode batches straight onto the device.

The port of nvimagecodec_tpu/pipeline.py (without `mesh`). The production
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


def decode_batches(
    stream_batches: Iterable[Sequence[bytes]],
    params: Optional[DecodeParams] = None,
    decoder: Optional[Decoder] = None,
    drop_failed: bool = True,
    depth: int = 2,
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
    drop_failed=False. `decoder` defaults to `Decoder()`, on the card.

    With depth > 1, `decoder.decode` is called from `depth` threads at the
    same time, so a decoder given here must be safe for that. The port's
    `Decoder` is: its caches are filled by single dictionary reads and
    writes (at worst a value is built twice), and the route counters and the
    kernel wrappers' launch counts are updated under locks."""
    dec = decoder or Decoder()
    params = params or DecodeParams()
    device = dec.device

    def _one(batch):
        outs = dec.decode(list(batch), params)
        if drop_failed:
            outs = [o for o in outs if o is not None]
        event = None
        if device.type == "cuda":
            # the stream is in order: this event completes after the whole
            # batch
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(device))
        return outs, event

    def _force(done):
        outs, event = done
        if event is not None:
            with span("imgcodec.pipeline.device_wait"):
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
