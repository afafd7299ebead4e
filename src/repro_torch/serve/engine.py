"""Serving engine: merged-adapter deployment (the paper's zero-inference-
latency property), prefill + greedy decoding over slotted requests, and a
multi-tenant adapter bank — the JAX package's `serve/engine.py` without its
mesh and sharding plan (later slices).

`merge_for_serving` folds every mergeable ΔW into the base weights once,
through the kernel registry: on the card the hand-written ΔW kernel does
the folding. After that the served model has method `none` and its graph is
the unadapted model's.

`AdapterBank` holds K resident factored adapters over one base: per method
group the trainable leaves live in (K+1, L, ...) tensors whose last row is
a reserved all-zero row. `Request.adapter_id` selects a resident row; every
prefill and decode call gathers each request's rows once (outside the
layer loop) and applies them through each group's `bank_apply`, with no
per-request merge. Methods mix in one batch because every request gathers
a row from every group and the factored contribution is linear in the
trainables (the zero row contributes exactly zero). LRU load/evict against
adapter-only checkpoints (checkpoint/adapters.py) serves many tenants at
n·(2+L) stored numbers each: the paper's economics end to end.

The Engine batches in lockstep: `generate` (one padded batch) and
`generate_requests` (Request objects in chunks of `batch_slots`, each
request stopping at its budget or EOS). `Engine.generate` is the serial
reference the continuous scheduler (serve/scheduler/runtime.py) is held
against.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import PEFTConfig, ShapeConfig
from repro_torch.core import adapter as adapter_api
from repro_torch.core import peft as peft_mod
from repro_torch.core.adapter import torch_dtype
from repro_torch.devices import resolve_device, to_device, tree_to
from repro_torch.models.registry import (Model, add_time_dim, build,
                                         resolve_default_targets)


def _stays_factored(method, name: str) -> bool:
    """Whether site `name` is applied factored even when its method's
    weights are merged: the method cannot merge, or the site lies outside
    the layer stack (zamba2's shared block)."""
    return not method.mergeable or not name.startswith("layers/")


@torch.no_grad()
def merge_for_serving(model: Model, params: Dict) -> Tuple[Model, Dict]:
    """Fold every mergeable layer-stack ΔW into the base. Leftover adapters
    (non-`layers/` sites, or methods with `mergeable=False`) stay under
    their true method — the rebuilt model keeps the original PEFTConfig
    whenever anything is left over. Runs without autograd: merged weights
    built from trained coefficients (which require grad) hold no graph."""
    peft = model.peft
    method = model.method
    if not method.has_site_params or not params.get("peft"):
        return model, params
    base = dict(params["base"])
    layers = dict(base["layers"])
    leftover = {}
    site_by_name = {s.name: s for s in model.sites}
    for name, ad in params["peft"].items():
        if _stays_factored(method, name):
            leftover[name] = ad
            continue
        method.merge_site(layers, name.split("/")[-1], ad, site_by_name[name],
                          peft)
    base["layers"] = layers
    merged_model = build(model.cfg,
                         peft if leftover else peft.replace(method="none"))
    return merged_model, {"base": base, "peft": leftover}


@dataclass
class Request:
    prompt: torch.Tensor               # (S,) int
    max_new: int = 16
    adapter_id: Optional[str] = None   # resident AdapterBank tenant (or base)
    out: Optional[List[int]] = None
    priority: str = "batch"            # interactive | batch | best_effort


class BankFullError(RuntimeError):
    """Raised by AdapterBank.load when the bank is at capacity and every
    resident tenant is pinned (in use by a live request): the caller must
    defer the load until a pinned tenant's requests drain."""


class AdapterBank:
    """K resident factored adapters over one base model, on one device.

    `profiles` maps method name -> PEFTConfig: one bank group per method the
    deployment serves (the tenants of a group share the frozen aux, i.e. the
    entries of one entry seed, enforced at load). Per group:

        params[m]["sites"][site][leaf]  (K+1, L, ...)  trainable, zero-init
        params[m]["aux"][site][leaf]    the shared frozen aux (entries) and
                                        the tables built from it once
                                        (`AdapterMethod.frozen_tables`)

    Row K is the reserved zero row: requests that do not use method m
    gather it and contribute exactly zero. Slots are global across groups:
    loading a tenant zeroes its slot row in the group of the slot's previous
    occupant, then writes its own method's leaves. Eviction is LRU.

    `host_tier` (a `serve.tiering.HostAdapterTier`, set by a tiering
    scheduler): evicted rows spill there and `load_from_host` reloads them
    without a checkpoint read."""

    def __init__(self, model: Model, profiles: Dict[str, PEFTConfig],
                 capacity: int, checkpoint_dir: Optional[str] = None,
                 device=None):
        if capacity < 1:
            raise ValueError("AdapterBank needs capacity >= 1")
        self.device = resolve_device(device)
        self.capacity = capacity
        self.zero_row = capacity
        self.checkpoint_dir = checkpoint_dir
        self._cfg = model.cfg
        self.profiles: Dict[str, PEFTConfig] = {}
        self._bank_sites: Dict[str, List] = {}
        self.params: Dict[str, Dict] = {}
        # bytes of the frozen tables the groups built once (FourierFT: four
        # f32 (d, n) tables per site shape; dct: two)
        self.table_bytes = 0
        gen = torch.Generator(device=self.device)
        gen.manual_seed(0)        # draws only shapes: every row starts zero
        for mname, prof in profiles.items():
            method = adapter_api.resolve(mname)
            if mname not in adapter_api.registered_methods(
                    site_params_only=True):
                raise ValueError(f"method {mname!r} has no adapter state")
            if prof.method != mname:
                prof = prof.replace(method=mname)
            prof = resolve_default_targets(prof, model.cfg)
            sites = [s for s in model.sites
                     if s.name.startswith("layers/")
                     and s.name.split("/")[-1] in prof.target_modules]
            if not sites:
                raise ValueError(f"profile {mname!r} targets no bank-eligible "
                                 f"(layers/*) site of {model.cfg.name}")
            self.profiles[mname] = prof
            self._bank_sites[mname] = sites
            trainable = set(method.trainable_leaves(prof))
            group = {"sites": {}, "aux": {}}
            for site in sites:
                ad = method.init_site(gen, site, prof, self.device)
                group["sites"][site.name] = {
                    k: torch.zeros((capacity + 1,) + tuple(v.shape),
                                   dtype=v.dtype, device=self.device)
                    for k, v in ad.items() if k in trainable}
                aux = {k: v for k, v in ad.items() if k not in trainable}
                tables = method.frozen_tables(aux, site.d_in, site.d_out)
                self.table_bytes += sum(t.numel() * t.element_size()
                                        for t in tables.values())
                aux.update(tables)
                if aux:
                    group["aux"][site.name] = aux
            self.params[mname] = group
        # adapter_id -> (method name, slot); insertion order = LRU order
        self._resident: "OrderedDict[str, Tuple[str, int]]" = OrderedDict()
        self._free = list(range(capacity))
        self.host_tier = None
        self.loads = 0                 # successful loads, for the counters

    # ---- residency --------------------------------------------------------
    @property
    def resident_ids(self) -> Tuple[str, ...]:
        return tuple(self._resident)

    # config fields with no effect on the served math; everything NOT
    # listed must match the group profile (fail closed: a new method knob is
    # compared by default). kernel_backend only selects which registered
    # implementation computes the same math.
    _PROFILE_IRRELEVANT = ("strategy", "kernel_backend", "use_pallas",
                           "train_head", "param_dtype")

    def _profile_key(self, peft: PEFTConfig) -> tuple:
        d = dataclasses.asdict(peft)
        for k in self._PROFILE_IRRELEVANT:
            d.pop(k)
        return tuple(sorted(d.items()))

    def matches(self, peft: PEFTConfig) -> bool:
        """Whether a tenant of config `peft` can join its method's group."""
        prof = self.profiles.get(peft.method)
        peft = resolve_default_targets(peft, self._cfg)
        return prof is not None and \
            self._profile_key(peft) == self._profile_key(prof)

    def _snapshot_to_host(self, adapter_id: str, mname: str,
                          slot: int) -> None:
        """Spill one tenant's trainable rows to the host tier before the
        slot is cleared. `v[slot]` is a view of the row that
        `_clear_group_slot` zeroes next, so each row is cloned first: the
        tier's copy to the host (on its side stream on the card) reads the
        clone, which nothing overwrites."""
        if self.host_tier is None:
            return
        tree = {site: {leaf: v[slot].clone() for leaf, v in leaves.items()}
                for site, leaves in self.params[mname]["sites"].items()}
        self.host_tier.put(adapter_id, mname, tree)

    def _clear_group_slot(self, mname: str, slot: int) -> None:
        """Zero one slot row in one method group. Only the occupant's own
        group can hold non-zero rows (loads write exactly one group; freed
        slots are cleared on evict), so clearing stays O(one group)."""
        for leaves in self.params[mname]["sites"].values():
            for v in leaves.values():
                v[slot].zero_()

    def load(self, adapter_id: str, adapters: Dict, peft: PEFTConfig,
             pinned: Sequence[str] = ()) -> int:
        """Make `adapter_id` resident (LRU-evicting if full). `adapters` is a
        {site: {leaf: tensor or array}} tree: the trainable leaves are
        written into the slot row; frozen leaves present are checked
        against the group's shared aux (one bank group = one entry seed).

        pinned: tenant ids that must NOT be evicted (live requests gather
        their rows mid-stream). The LRU victim is the least recently used
        UNPINNED resident; if every resident is pinned, BankFullError."""
        if peft.method not in self.profiles:
            raise KeyError(f"no bank group for method {peft.method!r}; "
                           f"groups: {sorted(self.profiles)}")
        prof = self.profiles[peft.method]
        peft = resolve_default_targets(peft, self._cfg)
        if self._profile_key(peft) != self._profile_key(prof):
            raise ValueError(
                f"adapter {adapter_id!r} config {self._profile_key(peft)} "
                f"does not match bank group {self._profile_key(prof)}")
        method = adapter_api.resolve(peft.method)
        group = self.params[peft.method]
        known = {s.name for s in self._bank_sites[peft.method]}
        stray = set(adapters) - known
        if stray:
            raise ValueError(
                f"adapter {adapter_id!r} carries sites {sorted(stray)} "
                f"outside the bank group's {sorted(known)}: serving it "
                "would silently drop them")
        # validate EVERYTHING before touching bank state: a failed load must
        # not leak a slot or wipe the tenant it would have evicted
        trainable = set(method.trainable_leaves(prof))
        writes = []
        for site in self._bank_sites[peft.method]:
            ad = adapters.get(site.name)
            if ad is None:
                continue                       # stays zero at this site
            missing = trainable - set(ad)
            if missing:                        # fail closed: a partial site
                raise ValueError(              # would silently serve wrong
                    f"{adapter_id!r} {site.name} is missing trainable "
                    f"leaves {sorted(missing)}")
            for leaf, v in ad.items():
                v = torch.as_tensor(v)
                if leaf in trainable:
                    rows = group["sites"][site.name][leaf]
                    if tuple(v.shape) != tuple(rows.shape[1:]):
                        raise ValueError(
                            f"{adapter_id!r} {site.name}/{leaf}: shape "
                            f"{tuple(v.shape)} != bank row "
                            f"{tuple(rows.shape[1:])}")
                    writes.append((site.name, leaf, v))
                else:
                    shared = group["aux"].get(site.name, {}).get(leaf)
                    # repro: allow(host-sync-in-loop) — a load, not a step
                    ref = None if shared is None else shared.cpu()
                    # repro: allow(host-sync-in-loop) — the same check
                    if ref is None or not torch.equal(v.cpu(), ref):
                        raise ValueError(
                            f"{adapter_id!r} frozen leaf {site.name}/{leaf} "
                            "differs from the bank group's shared aux "
                            "(adapters in one group must share entry seed)")
        if adapter_id in self._resident:
            prev_m, slot = self._resident.pop(adapter_id)
            self._clear_group_slot(prev_m, slot)
        elif self._free:
            slot = self._free.pop(0)           # zero by construction
        else:
            victim = next((a for a in self._resident if a not in pinned),
                          None)                # LRU order, skipping pinned
            if victim is None:
                raise BankFullError(
                    f"bank is full ({self.capacity} slots) and every "
                    f"resident tenant is pinned; cannot admit "
                    f"{adapter_id!r} until a pinned tenant drains")
            prev_m, slot = self._resident.pop(victim)
            self._snapshot_to_host(victim, prev_m, slot)
            self._clear_group_slot(prev_m, slot)
        for site_name, leaf, v in writes:
            rows = group["sites"][site_name][leaf]
            rows[slot].copy_(v.to(device=rows.device, dtype=rows.dtype))
        self._resident[adapter_id] = (peft.method, slot)
        self.loads += 1
        if self.host_tier is not None:
            # any successful load supersedes a host copy (it would serve
            # stale rows if the tenant re-trained); eviction re-spills
            self.host_tier.drop(adapter_id)
        return slot

    def load_from_checkpoint(self, adapter_id: str,
                             directory: Optional[str] = None,
                             pinned: Sequence[str] = ()) -> int:
        """LRU reload path: import an adapter-only export (trainables +
        config manifest) and make it resident."""
        from repro_torch.checkpoint import adapters as adapter_ckpt
        directory = directory or self.checkpoint_dir
        if directory is None:
            raise ValueError("no checkpoint directory configured")
        tree, peft = adapter_ckpt.import_adapter(directory, adapter_id,
                                                 device=self.device)
        return self.load(adapter_id, tree, peft, pinned=pinned)

    def evict(self, adapter_id: str) -> None:
        mname, slot = self._resident.pop(adapter_id)
        self._snapshot_to_host(adapter_id, mname, slot)
        self._clear_group_slot(mname, slot)
        self._free.append(slot)

    def load_from_host(self, adapter_id: str,
                       pinned: Sequence[str] = ()) -> Optional[int]:
        """Make `adapter_id` resident from the host tier, or return None on
        a host miss — the caller then falls back to `load_from_checkpoint`.
        Goes through `load()`, so every validation (profile match, shapes,
        pinned-victim selection) applies to host reloads as to checkpoint
        loads."""
        if self.host_tier is None:
            return None
        hit = self.host_tier.get(adapter_id)
        if hit is None:
            return None
        method, tree = hit
        return self.load(adapter_id, tree, self.profiles[method],
                         pinned=pinned)

    def touch(self, adapter_id: str) -> None:
        self._resident.move_to_end(adapter_id)

    def slot_rows(self, adapter_ids: Sequence[Optional[str]],
                  batch: int) -> Dict[str, torch.Tensor]:
        """Per-method gather rows (B,) int64 on the bank's device for a
        batch: requests without an adapter, or of another method, point at
        the reserved zero row."""
        if len(adapter_ids) > batch:
            raise ValueError(f"{len(adapter_ids)} adapter_ids for a "
                             f"{batch}-slot batch")
        missing = {a for a in adapter_ids
                   if a is not None and a not in self._resident}
        if missing:     # validate before touching: failed calls leave LRU as-is
            raise KeyError(f"adapters {sorted(missing)} are not resident; "
                           f"call load()/load_from_checkpoint() first")
        names = sorted(self.profiles)
        rows = np.full((len(names), batch), self.zero_row, np.int64)
        for i, aid in enumerate(adapter_ids):
            if aid is None:
                continue
            mname, slot = self._resident[aid]
            rows[names.index(mname), i] = slot
            self.touch(aid)
        dev = to_device(rows, self.device)     # one queued host-to-device copy
        return {m: dev[g] for g, m in enumerate(names)}


class Engine:
    """Slot-based batched greedy decoding over one model and its params.

    device: where the engine runs — `cuda` unless the caller passes one
    (`device="cpu"` runs the plain PyTorch versions); with no argument and
    no CUDA device the constructor raises. Params are moved there.

    merge: fold every mergeable ΔW into the base once (the default). With
    merge=False the adapters stay as they are: a factored or non-mergeable
    method then applies per call, its frozen tables built once here.

    bank: an AdapterBank on the same device; it enables per-request
    `adapter_id`s. The bank's rows enter every call as params["bank"] and
    the per-request gather rows as batch["adapter_slots"]. The engine
    serves a copy of the model that carries the bank's profiles: the
    caller's Model is never changed.

    mesh: a DeviceMesh (launch/mesh.py) — the params are placed per the
    plan's state specs (FSDP off) and merged on the mesh (each rank's ΔW
    shard from K1 on local tensors), and every cache per `cache_specs`
    (the dense cache and the paged pool alike), so every call runs on
    DTensors. Every rank runs the same requests; next tokens come back
    whole on every rank. `plan`: a dist.plan.PlanSource or a
    `--sharding-plan` string (rules by default), resolved on the mesh.
    Without a mesh, or on the abstract one-device mesh, nothing is placed
    and the plan is not resolved (`plan_source` is rules)."""

    def __init__(self, model: Model, params: Dict, batch_slots: int,
                 max_len: int, merge: bool = True,
                 bank: Optional[AdapterBank] = None, device=None,
                 mesh=None, plan=None):
        self.device = resolve_device(device)
        if bank is not None and bank.device != self.device:
            raise ValueError(f"the bank lives on {bank.device}, the engine "
                             f"on {self.device}")
        params = tree_to(params, self.device)
        from repro_torch.dist import plan as plan_mod
        from repro_torch.dist import sharding as shd
        self.mesh = mesh if shd.is_device_mesh(mesh) else None
        self.shape = ShapeConfig("serve", max_len, batch_slots, "decode")
        # without a mesh placement is the identity: no plan to resolve
        self.plan_source = plan_mod.RulesSource()
        if self.mesh is not None:
            self.plan_source = plan if isinstance(
                plan, plan_mod.PlanSource) else plan_mod.resolve(
                    plan, model=model, shape=self.shape, workload="decode",
                    mesh=self.mesh)
            params = shd.place(params, self.plan_source.state_specs(
                params, self.mesh, model.cfg, False), self.mesh)
        # the kernel each targeted (site, op), and each bank group's
        # bank_apply, resolves to on this device — a site a CUDA kernel
        # cannot take raises here, before any work
        profiles = dict(bank.profiles) if bank is not None else None
        self.kernel_policy = dataclasses.replace(
            model, bank_profiles=profiles).kernel_policy(
                self.device).validate()
        if merge:
            model, params = merge_for_serving(model, params)
        # the sites every call applies factored: all of them under the
        # factored strategy, else those `_stays_factored` names
        factored = {name: ad for name, ad in params.get("peft", {}).items()
                    if model.peft.strategy != "merged"
                    or _stays_factored(model.method, name)}
        if factored:
            params = {**params, "peft": {
                **params["peft"], **peft_mod.with_frozen_tables(
                    factored, model.sites, model.peft)}}
        if bank is not None:
            model = dataclasses.replace(model, bank_profiles=profiles)
        self.model, self.params = model, params
        self.bank = bank
        self.batch = batch_slots
        self.max_len = max_len

    def commit_tokens(self, arr) -> torch.Tensor:
        """A host-built token array as an int32 tensor on the engine's
        device."""
        return to_device(arr, self.device, torch.int32)

    def _fresh_cache(self, per_slot: bool = False, paged: bool = False,
                     page_size: int = 16, n_pages: Optional[int] = None):
        return self.place_cache(self.model.init_cache(
            self.batch, self.max_len, torch_dtype(self.model.cfg.dtype),
            self.device, per_slot=per_slot, paged=paged,
            page_size=page_size, n_pages=n_pages))

    def place_cache(self, cache: Dict, batch: Optional[int] = None) -> Dict:
        """A cache placed on the engine's mesh by the plan's cache specs
        (`batch` rows: the engine's slot count by default); as it is
        without a mesh."""
        if self.mesh is None:
            return cache
        from repro_torch.dist import sharding as shd
        shape = self.shape if batch is None else ShapeConfig(
            "serve", self.max_len, batch, "decode")
        return shd.place(cache, self.plan_source.cache_specs(
            cache, self.mesh, self.model.cfg, shape), self.mesh)

    def _batch_extra(self, adapter_ids: Optional[Sequence[Optional[str]]],
                     batch: Optional[int] = None) -> Tuple[Dict, Dict]:
        """(params with the bank's rows, per-call batch extras) for one
        call's per-request adapter ids, None-padded to `batch` rows (the
        engine's slot count by default). Shared by generate,
        generate_requests and the continuous scheduler, so the three
        cannot diverge on bank wiring."""
        B = self.batch if batch is None else batch
        params = self.params
        extra: Dict = {}
        if self.bank is not None:
            ids = list(adapter_ids or [])
            ids += [None] * (B - len(ids))
            extra["adapter_slots"] = self.bank.slot_rows(ids, B)
            params = {**params, "bank": self.bank.params}
        elif adapter_ids is not None and any(a is not None
                                             for a in adapter_ids):
            raise ValueError("adapter_ids given but the engine has no bank")
        return params, extra

    def _padded_tokens(self, prompts: Sequence) -> torch.Tensor:
        """(batch_slots, longest prompt[, CB]) int32, each prompt
        left-aligned."""
        plen = max(int(p.shape[0]) for p in prompts)
        toks = torch.zeros((self.batch, plen) + tuple(prompts[0].shape[1:]),
                           dtype=torch.int32, device=self.device)
        for i, p in enumerate(prompts):
            toks[i, :p.shape[0]] = torch.as_tensor(p, device=self.device)
        return toks

    @torch.no_grad()
    def generate(self, prompts: Sequence, max_new: int = 16,
                 adapter_ids: Optional[Sequence[Optional[str]]] = None
                 ) -> List[torch.Tensor]:
        """Greedy-decode a batch of prompts (padded to the longest; the
        padded prefill keeps every slot's KV cache consistent). Returns one
        (max_new,) int32 tensor per prompt; codebook prompts (S, CB) give
        (max_new, CB) streams.

        adapter_ids: per-prompt bank tenant (None = the bare base); the
        whole heterogeneous batch runs through the same calls."""
        if not prompts:
            raise ValueError("generate() needs at least one prompt")
        if max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {max_new}")
        if any(int(p.shape[0]) < 1 for p in prompts):
            raise ValueError("generate() got an empty (length-0) prompt")
        if len(prompts) > self.batch:
            raise ValueError(f"{len(prompts)} prompts for {self.batch} slots")
        if adapter_ids is not None and len(adapter_ids) != len(prompts):
            # fail closed: a None-padded tail would serve those prompts
            # unadapted under the caller's nose
            raise ValueError(f"{len(adapter_ids)} adapter_ids for "
                             f"{len(prompts)} prompts")
        params, extra = self._batch_extra(adapter_ids)
        plen = max(int(p.shape[0]) for p in prompts)
        # the last generated token is never written: the deepest cache read
        # is plen + max_new - 1 (the scheduler's slots.py invariant)
        if plen + max_new - 1 > self.max_len:
            raise ValueError(
                f"prompt ({plen}) + max_new ({max_new}) needs "
                f"{plen + max_new - 1} cache positions, exceeding "
                f"max_len ({self.max_len})")
        last, cache = self.model.prefill(
            params, self._fresh_cache(),
            {"tokens": self._padded_tokens(prompts), **extra})
        outs = [last]
        cur = add_time_dim(last)
        for _ in range(max_new - 1):
            nxt, cache = self.model.decode_step(params, cache,
                                                {"tokens": cur, **extra})
            outs.append(nxt)
            cur = add_time_dim(nxt)
        gen = torch.stack(outs, dim=1)               # (B, max_new[, CB])
        return [gen[i] for i in range(len(prompts))]

    def generate_requests(self, requests: List[Request],
                          eos_id: Optional[int] = None) -> List[Request]:
        """Request-object front end: FCFS lockstep chunks of `batch_slots`
        requests of any tenants (any count; chunks run one after another).

        Each request completes through the scheduler's SlotManager (budget
        exhausted, or `eos_id` emitted, the EOS token included): a finished
        request stops contributing tokens, and a chunk's decode loop exits
        as soon as EVERY slot is done instead of always paying
        max(r.max_new) steps. Lockstep chunks cannot recycle a freed slot
        mid-flight; serve/scheduler's ContinuousScheduler does."""
        if not requests:
            return requests
        for r in requests:
            if r.max_new < 1:
                raise ValueError(f"request max_new must be >= 1, "
                                 f"got {r.max_new}")
            if int(r.prompt.shape[0]) < 1:
                raise ValueError("request with an empty (length-0) prompt")
        # every chunk's capacity bound is checked UP FRONT: an infeasible
        # late request must fail before an earlier chunk fills its .out
        for at in range(0, len(requests), self.batch):
            chunk = requests[at:at + self.batch]
            plen = max(int(r.prompt.shape[0]) for r in chunk)
            worst = max(r.max_new for r in chunk)
            if plen + worst - 1 > self.max_len:
                raise ValueError(
                    f"lockstep chunk at {at}: prompt ({plen}) + max_new "
                    f"({worst}) needs {plen + worst - 1} cache positions, "
                    f"exceeding max_len ({self.max_len})")
        for at in range(0, len(requests), self.batch):
            self._lockstep_chunk(requests[at:at + self.batch], eos_id)
        return requests

    @torch.no_grad()
    def _lockstep_chunk(self, chunk: List[Request],
                        eos_id: Optional[int]) -> None:
        # lazy: scheduler.queue imports Request from this module
        from repro_torch.serve.scheduler.slots import SlotManager
        params, extra = self._batch_extra([r.adapter_id for r in chunk])
        last, cache = self.model.prefill(
            params, self._fresh_cache(),
            {"tokens": self._padded_tokens([r.prompt for r in chunk]),
             **extra})
        sm = SlotManager(len(chunk), eos_id=eos_id)
        for i, r in enumerate(chunk):
            sm.acquire(i, budget=r.max_new, adapter_id=r.adapter_id)
        taken = [0] * len(chunk)
        history = []

        def note(tokens):
            history.append(tokens)
            # EOS needs the token values on the host (one sync per step);
            # budget-only completion needs none
            vals = tokens.tolist() if eos_id is not None else None
            for i in sm.active_slots():
                taken[i] += 1
                if sm.note_token(i, vals[i] if vals is not None else None):
                    sm.release(i)

        note(last)
        cur = add_time_dim(last)
        while sm.any_active():
            nxt, cache = self.model.decode_step(params, cache,
                                                {"tokens": cur, **extra})
            note(nxt)
            cur = add_time_dim(nxt)
        gen = torch.stack(history, dim=1).cpu()          # the one drain
        for i, r in enumerate(chunk):
            r.out = gen[i, :taken[i]].tolist()
