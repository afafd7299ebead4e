#!/usr/bin/env python3
"""Where a merged train step of the recurrent families goes, on one NVIDIA
card: mamba2-2.7b (64 layers) and zamba2-7b (81 layers) at full size,
bf16, FourierFT n = 1000, alpha = 300 (mamba2 on its default wx/wo_ssm,
zamba2 on wq, wv, wx and wo_ssm), remat full, B 1 x S 2048, TF32 off.

    python3 tools/profile_ssm_step.py

For each model: the wall ms of each of five steps (host clock around a
synchronised step), then one more step under `torch.profiler` (CPU and
CUDA): its wall time, the device time of every kernel summed (the busy
share is their sum over the wall time), the kernels by device time, the
device time of the scan, the causal conv, flash, the K1/K2 harness and
the loss (each function wrapped in a `record_function` range by this
script; a range's device time is that of the kernels its forward
launched, backward kernels are counted apart by name), and the host
operators by self CPU time.

Prints the card's name and power limit first. Imports nothing of JAX;
needs the repository's `src/` and nvcc (the K1/K2 library is built).
"""
from __future__ import annotations

import functools
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("mamba2-2.7b", "zamba2-7b")
STEPS, SEQ, REMAT = 5, 2048, "full"
# functions timed by range: (module, attribute, label)
RANGES = (("repro_torch.models.mamba2", "ssd_chunked", "ssd_scan"),
          ("repro_torch.models.mamba2", "conv1d_causal", "conv1d"),
          ("repro_torch.models.attention", "flash_attention", "flash"),
          ("repro_torch.kernels.ops", "fourier_deltaw_forward", "k1_harness"),
          ("repro_torch.models.common", "cross_entropy", "loss"))


def _labelled(fn, label):
    import torch

    @functools.wraps(fn)
    def run(*a, **kw):
        with torch.profiler.record_function(label):
            return fn(*a, **kw)
    return run


def _device_us(ev) -> float:
    return getattr(ev, "device_time_total",
                   getattr(ev, "cuda_time_total", 0.0))


def _self_device_us(ev) -> float:
    return getattr(ev, "self_device_time_total",
                   getattr(ev, "self_cuda_time_total", 0.0))


def profile_arch(arch: str) -> None:
    import importlib

    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import configs
    from repro_torch.configs.base import PEFTConfig, TrainConfig
    from repro_torch.data import SyntheticLM
    from repro_torch.models import build
    from repro_torch.train import step as train_step

    for mod, attr, label in RANGES:
        m = importlib.import_module(mod)
        setattr(m, attr, _labelled(getattr(m, attr), label))
    # the modules that imported a wrapped name directly
    from repro_torch.models import ssm_lm, transformer, zamba2
    from repro_torch.models import common
    for m in (ssm_lm, zamba2, transformer):
        if hasattr(m, "cross_entropy"):
            m.cross_entropy = common.cross_entropy

    dev = torch.device("cuda")
    cfg = configs.get(arch)
    targets = (("wq", "wv", "wx", "wo_ssm") if cfg.family == "hybrid"
               else ("wq", "wv"))
    model = build(cfg, PEFTConfig(n=1000, alpha=300.0,
                                  target_modules=targets), remat=REMAT)
    params = model.init(0, dev)
    state, frozen = train_step.state_from_params(model, params)
    tcfg = TrainConfig(learning_rate=1e-2, total_steps=STEPS + 1,
                       warmup_steps=1)
    step = train_step.make_train_step(model, tcfg)
    data = SyntheticLM(vocab=cfg.vocab, batch=1, seq=SEQ, seed=0,
                       task_seed=7)
    batches = [{k: t.to(dev) for k, t in data.batch_at(i).items()}
               for i in range(STEPS + 1)]
    walls = []
    for b in batches[:STEPS]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, frozen, b)
        float(metrics["loss"])
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    print(f"[{arch}] {cfg.num_layers} layers, B 1 x S {SEQ}, remat {REMAT}:"
          f" step wall ms {[round(w, 1) for w in walls]}, peak "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, frozen, batches[STEPS])
        float(metrics["loss"])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    evs = prof.key_averages()
    labels = tuple(label for _, _, label in RANGES)
    # the ranges' own device-side annotations span their kernels (gaps
    # included): they are not kernels
    kernels = [ev for ev in evs if _self_device_us(ev) > 0
               and ev.device_type == torch.autograd.DeviceType.CUDA
               and ev.key not in labels]
    busy = sum(_self_device_us(ev) for ev in kernels) / 1e3
    n_kernels = sum(ev.count for ev in kernels)
    print(f"[{arch}] profiled step: {wall:.1f} ms wall, {busy:.1f} ms of "
          f"device time in {n_kernels} kernels (busy {busy / wall:.1%})")
    for ev in sorted(kernels, key=lambda e: -_self_device_us(e))[:15]:
        print(f"[{arch}]   kernel {_self_device_us(ev) / 1e3:9.2f} ms "
              f"x{ev.count:6d}  {ev.key[:90]}")
    for label in labels:
        hit = [ev for ev in evs if ev.key == label and ev.device_type
               == torch.autograd.DeviceType.CPU]
        if hit:
            ev = hit[0]
            print(f"[{arch}]   range {label}: {ev.count} calls, device "
                  f"{_device_us(ev) / 1e3:.2f} ms (forward launches), cpu "
                  f"{ev.cpu_time_total / 1e3:.2f} ms")
    cpu_ops = [ev for ev in evs if ev.device_type ==
               torch.autograd.DeviceType.CPU and ev.key not in labels]
    for ev in sorted(cpu_ops, key=lambda e: -e.self_cpu_time_total)[:12]:
        print(f"[{arch}]   host {ev.self_cpu_time_total / 1e3:9.2f} ms "
              f"self x{ev.count:6d}  {ev.key[:70]}")
    del state, frozen, params, model
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("profile_ssm_step: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    from repro_torch.kernels import build as kbuild
    kbuild.build_all()
    for arch in ARCHS:
        profile_arch(arch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
