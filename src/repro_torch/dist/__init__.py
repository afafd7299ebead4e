"""Distributed-execution layer of the port (the JAX package's `dist`).

- `sharding`    — named-sharding rule engine mapping parameter / optimizer /
                  batch / KV-cache trees onto a (pod, data, model) mesh,
                  with optional FSDP over `data`; `place` distributes a
                  tree onto a DeviceMesh as DTensors.
- `cost_model`  — alpha-beta cluster cost model (H100 data-sheet rates) and
                  the abstract `MeshSpec`.
- `plan`        — sharding plans (the JAX package's plan JSON) and plan
                  sources (rules, plan tables, `resolve`).
- `planner`     — per-leaf placement search against the cost model, and
                  its CLI gate.
- `compression` — int8 error-feedback gradient compression
                  (`TrainConfig.grad_compression = "int8_ef"`).
- `opstats`     — per-device flops / bytes / collective traffic by kind of
                  one traced step (the counterpart of `hlo.py`).
- `dtensor`     — the DTensor boundary of the kernels (ΔW shards, K3 on
                  local heads) and of the ops that need a redistribute.
"""
from repro_torch.dist import (compression, cost_model, dtensor, opstats,
                              plan, planner, sharding)

__all__ = ["compression", "cost_model", "dtensor", "opstats", "plan",
           "planner", "sharding"]
