"""Fault-tolerant training loop (the JAX package's `train/loop.py`).

Periodic async checkpointing with atomic publish and keep-k retention,
auto-resume from the latest checkpoint, SIGTERM-safe preemption
(checkpoint-then-exit), anomaly accounting (the skip itself happens inside
the train step), and a per-step wall-time EWMA with straggler logging.
Each step reads one value back to the host, its loss, as the JAX loop does.

Data is step-keyed (stateless), so resume replays nothing. Batches are
moved to the device of the state's step counter. In mesh mode every rank
makes the same global batch and places it by `batch_sharding` (each keeps
its shard), and a restored state is re-placed onto `state_sharding`
(elastic resume onto another mesh).
"""
from __future__ import annotations

import signal
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from repro_torch.checkpoint import manager as ckpt
from repro_torch.configs.base import TrainConfig
from repro_torch.dist import sharding as shd
from repro_torch.dist.dtensor import to_plain
from repro_torch.tree import tree_map


@dataclass
class LoopReport:
    steps_run: int = 0
    final_loss: float = float("nan")
    losses: List[float] = field(default_factory=list)
    step_s: List[float] = field(default_factory=list)   # wall time per step
    anomalies: int = 0
    slow_steps: int = 0
    resumed_from: Optional[int] = None
    preempted: bool = False


def run(train_step: Callable, state: Dict, frozen: Dict, data,
        tcfg: TrainConfig, *, ckpt_dir: Optional[str] = None,
        ckpt_every: int = 0, keep: int = 3, resume: bool = True,
        log_every: int = 50, straggler_factor: float = 3.0,
        mesh=None, batch_sharding=None, state_sharding=None,
        log_fn: Callable[[str], None] = print) -> tuple[Dict, LoopReport]:
    """Run steps from the state's step to `tcfg.total_steps`. Returns the
    final state and a `LoopReport`. mesh / batch_sharding /
    state_sharding: mesh mode (the placements from train/step.py's
    make_sharded_train_step and shard_train_state)."""
    report = LoopReport()
    device = state["step"].device
    mgr = None
    if ckpt_dir and ckpt_every:
        mgr = ckpt.CheckpointManager(ckpt_dir, keep=keep)
        if resume and ckpt.available_steps(ckpt_dir):
            raw, at = ckpt.restore(ckpt_dir, device=device)
            # keep fresh subtrees the checkpoint lacks, drop saved ones the
            # state no longer carries
            raw = {k: raw.get(k, state[k]) for k in state}
            state = tree_map(lambda x, a: a.to(device=x.device,
                                               dtype=x.dtype), state, raw)
            if state_sharding is not None:
                state = shd.distribute(state, state_sharding, mesh)
            report.resumed_from = at
            log_fn(f"[loop] resumed from step {at}")

    preempt = {"flag": False}

    def _on_term(signum, frame):
        preempt["flag"] = True

    old_handler = signal.signal(signal.SIGTERM, _on_term)
    ewma = None
    try:
        start = int(to_plain(state["step"]))
        for step in range(start, tcfg.total_steps):
            t0 = time.perf_counter()
            batch = data.batch_at(step)
            batch = {k: v.to(device, non_blocking=True)
                     for k, v in batch.items()}
            if batch_sharding is not None:
                batch = shd.distribute(batch, batch_sharding, mesh)
            state, metrics = train_step(state, frozen, batch)
            loss = float(to_plain(metrics["loss"]))
            dt = time.perf_counter() - t0
            ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
            if dt > straggler_factor * ewma and step > start + 5:
                report.slow_steps += 1
                log_fn(f"[loop] straggler step {step}: {dt:.3f}s vs "
                       f"ewma {ewma:.3f}s")
            report.losses.append(loss)
            report.step_s.append(dt)
            report.steps_run += 1
            if log_every and step % log_every == 0:
                log_fn(f"[loop] step {step} loss {loss:.4f} "
                       f"({dt*1e3:.1f} ms)")
            if mgr and ckpt_every and (step + 1) % ckpt_every == 0:
                mgr.save(step + 1, state)
            if preempt["flag"]:
                log_fn(f"[loop] SIGTERM at step {step}: checkpointing "
                       "and exiting cleanly")
                if mgr:
                    mgr.save(step + 1, state)
                report.preempted = True
                break
        if mgr and report.steps_run and not report.preempted:
            # the final state
            mgr.save(int(to_plain(state["step"])), state)
        report.final_loss = report.losses[-1] if report.losses else float("nan")
        report.anomalies = int(to_plain(state["anomalies"]))
        return state, report
    finally:
        signal.signal(signal.SIGTERM, old_handler)
        if mgr:
            mgr.close()
