#!/usr/bin/env python3
"""Can two ranks share one NVIDIA card? The question behind a multi-rank
run of the sharded paths on a one-card machine.

    python3 tools/probe_shared_card.py

NCCL refuses two ranks on one device, so the probe tries the other
backend: two spawned processes, both on CUDA device 0, joined in a gloo
group through a FileStore (a 60 s collective timeout, so a stuck rank
cannot hold the card), build a (1, 2) DTensor mesh and run a column- then
row-parallel product forward and backward on CUDA tensors (all-gather,
reduce-scatter and all-reduce underneath), held to the same product on
one rank. Prints the card's name and power limit, then `shared: yes` or
`shared: no` with the failing rank's last words. Imports nothing of JAX;
needs a CUDA device (no kernel is built).
"""
from __future__ import annotations

import datetime
import subprocess
import sys
import tempfile


def probe(rank: int, world: int, workdir: str) -> None:
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/store",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    try:
        mesh = init_device_mesh("cuda", (1, 2),
                                mesh_dim_names=("data", "model"))
        gen = torch.Generator(device="cuda").manual_seed(0)
        x = torch.randn(8, 64, device="cuda", generator=gen)
        w1 = torch.randn(64, 128, device="cuda", generator=gen)
        w2 = torch.randn(128, 64, device="cuda", generator=gen)

        def placed(t, pl):
            return distribute_tensor(t, mesh, pl, src_data_rank=None) \
                .requires_grad_(True)

        dx = placed(x, [Shard(0), Replicate()])
        d1 = placed(w1, [Replicate(), Shard(1)])
        d2 = placed(w2, [Replicate(), Shard(0)])
        y = (torch.relu(dx @ d1) @ d2).sum()
        y.backward()
        want = (torch.relu(x @ w1) @ w2).sum()
        if not torch.allclose(y.full_tensor(), want, rtol=1e-4, atol=1e-3):
            raise RuntimeError(f"sharded sum {float(y.full_tensor())} vs "
                               f"{float(want)}")
        d1.grad.full_tensor()
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()


def main() -> int:
    import torch
    import torch.multiprocessing as mp
    if not torch.cuda.is_available():
        print("probe_shared_card: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    with tempfile.TemporaryDirectory() as d:
        try:
            mp.spawn(probe, args=(2, d), nprocs=2, join=True)
            print("shared: yes")
        except Exception as e:
            print("shared: no:", " ".join(str(e).split())[-600:])
    return 0


if __name__ == "__main__":
    sys.exit(main())
