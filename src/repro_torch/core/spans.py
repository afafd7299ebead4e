"""Named ranges of the train path on the profiler's clock.

`span(name)` opens a host range named `repro_torch/<name>` while a
`torch.profiler` session records, so the range lands in the same Kineto
trace as the device's kernels, on one clock. While no session records it
is one check of the profiler's own flag and a shared null context: no
dispatcher call, no allocation, no sync. The profiler the caller starts is
the switch and the sink; the ranges change no arithmetic.

A range is a `RecordFunction` of function scope (the one inductor opens
around its kernels), not `torch.profiler.record_function`'s user scope:
Kineto copies user-scope ranges onto the device's timeline as
`gpu_user_annotation` events, which a reduction of the device's trace by
kind cannot tell from kernels on every torch release.

The backward runs where no forward range is open (the autograd engine's
own thread on the card). `Span.backward(*outs)` carries a range over: each
autograd node the range created on the way to `outs` (its sequence number
at or past the one the range opened at and below the one at the call, on
the thread's own count, which is how the profiler links a backward node to
its forward op) opens the same range while it runs.

    with span("attention/direct") as sp:
        out = direct_attention(q, k, v)
        sp.backward(out)

The train path's ranges, each read by one per-layer metric of the
benchmark (`perfbench/metrics/`):

- `step`: the call of the train step (`train/step.py`);
- `adapter`: the merge of every site, forward and backward
  (`models/transformer.py::_effective`, around `apply_peft_to_layers`),
  and each factored or bank apply (`make_linear`: the hybrid's shared
  sites);
- `layer`: one decoder layer's body, which `torch.utils.checkpoint`
  re-enters when it recomputes in the backward (`models/transformer.py`);
  in published Zamba2 each mamba layer and each shared-block application
  (`models/zamba2.py`);
- `attention/<path>`: the attention core, forward and backward
  (`models/attention.py::attention`; path `fused`, `direct`, `flash`,
  `chunked`);
- `ssd`: the mamba2 SSD scan, forward and backward
  (`models/mamba2.py::_mixer`, around `ssd_scan`: the kernel on the card,
  `ssd_chunked` elsewhere);
- `shared`: one application of published Zamba2's shared block, from the
  concat to its own linear, forward and backward
  (`models/zamba2.py::_application`).
"""
from __future__ import annotations

import torch
from torch._C import _profiler as _kineto
from torch.autograd import profiler as _profiler

PREFIX = "repro_torch/"


class _Null:
    """The context `span` returns while nothing records."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def backward(self, *outs) -> None:
        pass


_NULL = _Null()


def span(name: str):
    """A `repro_torch/<name>` range while a profiler records, else a shared
    null context."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return Span(PREFIX + name)


class Span:
    __slots__ = ("name", "_range", "_seq0")

    def __init__(self, name: str):
        self.name = name
        self._range = None
        self._seq0 = None

    def __enter__(self):
        self._range = _kineto._RecordFunctionFast(self.name)
        self._range.__enter__()
        if torch.is_grad_enabled():
            # the number the next autograd node made on this thread takes
            self._seq0 = torch._C._autograd._get_sequence_nr()
        return self

    def __exit__(self, *exc):
        self._range.__exit__(*exc)
        return False

    def backward(self, *outs) -> None:
        """Open this range around every backward node that the range
        created on the way to `outs` (tensors, or dicts and sequences of
        them)."""
        if self._seq0 is None:
            return
        seq1 = torch._C._autograd._get_sequence_nr()
        for node in _nodes_since(outs, self._seq0, seq1):
            _open_while_running(node, self.name)


def _grad_fns(x, out: list) -> None:
    if isinstance(x, torch.Tensor):
        if x.grad_fn is not None:
            out.append(x.grad_fn)
    elif isinstance(x, dict):
        for v in x.values():
            _grad_fns(v, out)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _grad_fns(v, out)


def _nodes_since(outs, seq0: int, seq1: int) -> list:
    """The autograd nodes reachable from `outs` whose sequence number lies
    in [seq0, seq1): made on this thread since the range opened. The
    counter is per thread, so the bound above matters where the range runs
    on another thread than the graph it reads: remat's recompute runs on
    the autograd engine's thread on the card, and its inputs' nodes, made
    by the forward's thread, carry numbers that thread's count gave them.
    A leaf's node (AccumulateGrad, the largest number) falls above any
    bound."""
    todo: list = []
    _grad_fns(outs, todo)
    seen, nodes = set(), []
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        if not seq0 <= node._sequence_nr() < seq1:
            continue
        nodes.append(node)
        todo.extend(fn for fn, _ in node.next_functions)
    return nodes


def _open_while_running(node, name: str) -> None:
    opened = []

    def pre(grad_outputs):
        rf = _kineto._RecordFunctionFast(name)
        rf.__enter__()
        opened.append(rf)

    def post(grad_inputs, grad_outputs):
        if opened:
            opened.pop().__exit__(None, None, None)

    node.register_prehook(pre)
    node.register_hook(post)
