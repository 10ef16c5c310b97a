"""Two processes joined by torch.distributed (gloo) on the CPU, the twin of
tests/test_multihost.py: each process decodes its share of the streams with
`Decoder(device="cpu")` of the port, `multihost.global_batch` views the
shares as one global batch, and an all_reduce of the int64 sum equals the
photos' sum, for a BMP batch and for the two ROI halves of a J2K tile grid.
"""
import os
import socket
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = textwrap.dedent("""
    import sys
    sys.path[:0] = [%(repo)r, %(repo)r + "/tests"]
    import numpy as np
    import torch
    import torch.distributed as dist

    pid = int(sys.argv[1])
    port = sys.argv[2]

    from nvimagecodec_tpu_torch.parallel import multihost
    multihost.initialize("127.0.0.1:" + port, 2, pid, backend="gloo")
    multihost.initialize("127.0.0.1:" + port, 2, pid, backend="gloo")
    assert dist.get_world_size() == 2, dist.get_world_size()

    import nvimagecodec_tpu_torch as nic
    from nvimagecodec_tpu_torch.codecs.bmp import encode_bmp

    # every process sees the same global stream list; shard_streams deals
    # this process its share, which it decodes alone
    rng = np.random.default_rng(0)
    photos = [(rng.random((8, 12, 3)) * 255).astype(np.uint8)
              for _ in range(4)]
    streams = [encode_bmp(p) for p in photos]
    mine = multihost.shard_streams(streams, 2)[pid]
    outs = nic.Decoder(device="cpu").decode([streams[i] for i in mine])
    local = torch.stack([o.array for o in outs])

    arr = multihost.global_batch(local)
    assert tuple(arr.shape) == (4, 8, 12, 3), arr.shape
    assert torch.equal(arr.to_local(), local)
    # the collective: the global sum equals the sum over the ORIGINAL
    # photos whichever process decoded which
    total = local.to(torch.int64).sum()
    dist.all_reduce(total)
    expect = sum(int(p.astype(np.int64).sum()) for p in photos)
    assert int(total) == expect, (int(total), expect)
    got = arr.full_tensor()
    assert sorted(int(g.to(torch.int64).sum()) for g in got) == sorted(
        int(p.astype(np.int64).sum()) for p in photos)

    # a 2x2-tile J2K image: each process decodes only its tile row through
    # the true-ROI path, and the halves form the global image by rows
    from nvimagecodec_tpu_torch.codecs.jpeg2000.core import (
        decode_j2k, encode_j2k)
    from nvimagecodec_tpu_torch.core.types import Region

    big = (rng.random((128, 128, 3)) * 255).astype(np.uint8)
    j2k = encode_j2k(big, reversible=True, tile_size=64, levels=2)
    half = Region(start_y=pid * 64, start_x=0, end_y=(pid + 1) * 64,
                  end_x=128)
    mine_px = torch.from_numpy(np.asarray(decode_j2k(j2k, device=None,
                                                     region=half)))
    assert tuple(mine_px.shape) == (64, 128, 3)
    arr2 = multihost.global_batch(mine_px)
    assert tuple(arr2.shape) == (128, 128, 3)
    total2 = mine_px.to(torch.int64).sum()
    dist.all_reduce(total2)
    assert int(total2) == int(big.astype(np.int64).sum())
    assert torch.equal(arr2.full_tensor(), torch.from_numpy(big))
    dist.destroy_process_group()
    print("HOST", pid, "OK", flush=True)
""")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_decode_and_global_batch():
    port = _free_port()
    script = _WORKER % {"repo": REPO}
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", script, str(i), str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=90)
            outs.append(out)
    finally:
        for p in procs:  # a process still running after the bound is killed
            if p.poll() is None:
                p.kill()
                p.communicate()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i} failed:\n{out[-2000:]}"
        assert f"HOST {i} OK" in out, out[-2000:]
