"""Source lint for the port's torch hazards (the JAX package's
`src/repro/analysis/ast_lint.py`, with torch rules beside its rule ids).

Rules (finding rule ids in parens):

- host-sync      — a device→host transfer point ANYWHERE:
                   `.item()`, `.tolist()`, `.cpu()`, `.to("cpu")` and
                   `.numpy()` on any
                   receiver not known to live on the host (a numpy call, or
                   a name bound to one or to an earlier transfer's result);
                   `int`/`float`/`bool`/`np.asarray`/`np.array` of a device
                   expression; `torch.cuda.synchronize()` and any
                   `.synchronize()` (a stream's or an event's). Intended drain
                   points carry a `# repro: allow(host-sync)` suppression or
                   a justified baseline entry; everything else is a
                   candidate per-step stall.
- host-sync-in-loop — the same pattern lexically inside a `for`/`while`
                   body: one transfer per iteration instead of one per
                   drain.
- tracer-bool    — Python truthiness (`if`/`while`/`assert`/a conditional
                   expression/`not`/`and`/`or`) or an `int()`/`float()`/
                   `bool()` of a device expression inside code that runs
                   under capture or autograd, where it forces a sync that
                   breaks capture: the `forward`/`backward`/`setup_context`
                   of a `torch.autograd.Function` subclass, a function
                   decorated with or passed to `torch.compile`,
                   `torch.cuda.make_graphed_callables` or `torch.vmap`
                   (`torch.func.vmap`), the body of a `with
                   torch.cuda.graph(...)` block, and anything nested in one.
- rng-global     — the counterpart of `rng-in-jit`: `torch.manual_seed`,
                   `torch.cuda.manual_seed[_all]`, or `torch.rand`/
                   `rand_like`/`randn`/`randn_like`/`randint`/`randint_like`/
                   `randperm`/`normal`/`bernoulli`/`multinomial` and the
                   in-place `.normal_`/`.uniform_`/`.bernoulli_`/`.random_`/
                   `.exponential_` without `generator=`: the global stream
                   makes a result depend on whatever drew before it. The
                   port's rule is explicit generators.

A "device expression" is (a) a call whose dotted callee starts with
`torch.` (not `torch.cuda.`, `torch.backends.` and the other namespaces or
constructors that return host objects: `_HOST_TORCH`) or `F.`; (b) a
tensor method: a method call on a device expression, or one of the
tensor-only methods (`.to`, `.cuda`, `.contiguous`, `.detach`, `.clone`,
...); (c) an attribute, subscript, arithmetic or comparison over one,
except metadata (`.shape`, `.dtype`, `.device`, `.ndim`, `.numel()`,
`.size()`, `.dim()`, `.data_ptr()`, ...); or (d) a local name whose latest
assignment was such an expression (one hop, bare names only — documented
limitation; `analysis.dispatch_lint` counts what actually syncs at run
time).

Suppressions: `# repro: allow(rule[, rule…])` on the finding's line or the
line directly above suppresses those rules for that line only.
"""
from __future__ import annotations

import ast
import os
import re
from typing import Dict, Iterable, List, Optional, Set

from repro_torch.analysis.report import Finding

RULES = ("tracer-bool", "host-sync", "host-sync-in-loop", "rng-global")

_ALLOW_RE = re.compile(r"#\s*repro:\s*allow\(([^)]*)\)")

_DEVICE_PREFIXES = ("torch.", "F.", "torch.nn.functional.")
# torch namespaces and callables whose results live on the host
_HOST_TORCH_PREFIXES = ("torch.cuda.", "torch.backends.", "torch.utils.",
                        "torch.distributed.", "torch.profiler.",
                        "torch.autograd.", "torch.jit.", "torch.testing.",
                        "torch._C.")
_HOST_TORCH = {
    "torch.device", "torch.Generator", "torch.is_tensor", "torch.finfo",
    "torch.iinfo", "torch.get_default_dtype", "torch.dtype", "torch.no_grad",
    "torch.inference_mode", "torch.enable_grad", "torch.is_grad_enabled",
    "torch.Size", "torch.promote_types", "torch.set_grad_enabled",
    "torch.compile", "torch.manual_seed", "torch.equal",
    "torch.is_floating_point",
}
# methods that hand the host a tensor's values
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
# methods only tensors have (a numpy array has none of them)
_TENSOR_ONLY_METHODS = {
    "to", "cuda", "contiguous", "detach", "clone", "float", "half",
    "bfloat16", "long", "unsqueeze", "masked_fill", "masked_fill_",
    "index_select", "index_copy_", "softmax", "permute", "new_zeros",
    "new_full", "new_empty", "new_ones", "type_as", "expand",
}
# metadata: reading it never waits for the device
_META_ATTRS = {"shape", "dtype", "device", "ndim", "is_cuda", "layout",
               "requires_grad", "grad_fn", "is_leaf"}
_META_METHODS = {"numel", "size", "dim", "data_ptr", "element_size",
                 "stride", "is_contiguous", "get_device", "nelement",
                 "storage_offset"}
# callees that force a device->host transfer of their argument
_SYNC_CALLEES = {"np.asarray", "np.array", "numpy.asarray", "numpy.array",
                 "int", "float", "bool"}
_COERCIONS = {"int", "float", "bool"}
# capture/transform entry points: a function passed to one runs captured
_CAPTURING_CALLEES = {"torch.compile", "torch.cuda.make_graphed_callables",
                      "torch.vmap", "torch.func.vmap"}
_CAPTURE_BLOCKS = {"torch.cuda.graph"}
_FUNCTION_BASES = {"torch.autograd.Function", "autograd.Function",
                   "Function"}
_FUNCTION_METHODS = {"forward", "backward", "setup_context", "jvp", "vjp"}
_RNG_CALLS = {"torch.rand", "torch.rand_like", "torch.randn",
              "torch.randn_like", "torch.randint", "torch.randint_like",
              "torch.randperm", "torch.normal", "torch.bernoulli",
              "torch.multinomial"}
_RNG_METHODS = {"normal_", "uniform_", "bernoulli_", "random_",
                "exponential_"}
_GLOBAL_SEEDS = {"torch.manual_seed", "torch.cuda.manual_seed",
                 "torch.cuda.manual_seed_all", "torch.seed"}


def _dotted(node: ast.AST) -> Optional[str]:
    """'torch.stack' for Attribute chains, 'int' for bare Names."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _device_callee(name: Optional[str]) -> bool:
    return bool(name) and name.startswith(_DEVICE_PREFIXES) \
        and not name.startswith(_HOST_TORCH_PREFIXES) \
        and name not in _HOST_TORCH


def _to_cpu(node: ast.Call) -> bool:
    """`x.to("cpu", ...)` / `x.to(device="cpu")`: a `.cpu()` spelled out."""
    if not (isinstance(node.func, ast.Attribute) and node.func.attr == "to"):
        return False
    args = list(node.args[:1]) + [kw.value for kw in node.keywords
                                   if kw.arg == "device"]
    return any(isinstance(a, ast.Constant) and a.value == "cpu"
               for a in args)


def _allow_lines(src: str) -> Dict[int, Set[str]]:
    """{line number: {allowed rules}} from `# repro: allow(...)` comments."""
    out: Dict[int, Set[str]] = {}
    for i, line in enumerate(src.splitlines(), start=1):
        m = _ALLOW_RE.search(line)
        if m:
            out[i] = {r.strip() for r in m.group(1).split(",") if r.strip()}
    return out


def _decorated_capturing(fn: ast.AST) -> bool:
    for dec in getattr(fn, "decorator_list", []):
        name = _dotted(dec.func if isinstance(dec, ast.Call) else dec)
        if name in _CAPTURING_CALLEES:
            return True
    return False


class _Linter(ast.NodeVisitor):
    def __init__(self, filename: str, allow: Dict[int, Set[str]]):
        self.filename = filename
        self.allow = allow
        self.findings: List[Finding] = []
        self._emitted: Set[tuple] = set()
        self.capture_depth = 0
        self.loop_depth = 0
        # names bound to a device / host expression by their latest
        # assignment; scoped per function (saved/restored around defs)
        self.device_names: Set[str] = set()
        self.host_names: Set[str] = set()
        # defs passed to capturing callees or living on an autograd
        # Function (a first pass over the module, so order does not matter)
        self.capture_defs: Set[ast.AST] = set()

    # ---- expressions -------------------------------------------------------
    def _device(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Call):
            func = node.func
            if isinstance(func, ast.Attribute):
                if func.attr in _META_METHODS or func.attr in _SYNC_METHODS \
                        or _to_cpu(node):
                    return False
                if _device_callee(_dotted(func)):
                    return True
                if func.attr in _TENSOR_ONLY_METHODS:
                    return True
                return self._device(func.value)
            return _device_callee(_dotted(func))
        if isinstance(node, ast.Name):
            return node.id in self.device_names
        if isinstance(node, ast.Attribute):
            return node.attr not in _META_ATTRS and self._device(node.value)
        if isinstance(node, ast.Subscript):
            return self._device(node.value)
        if isinstance(node, ast.BinOp):
            return self._device(node.left) or self._device(node.right)
        if isinstance(node, ast.UnaryOp):
            return self._device(node.operand)
        if isinstance(node, ast.Compare):
            return self._device(node.left) or any(
                self._device(c) for c in node.comparators)
        return False

    def _host(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Call):
            name = _dotted(node.func)
            if name and name.split(".")[0] in ("np", "numpy"):
                return True
            if _to_cpu(node):
                return True
            # a method of a host value stays on the host unless it moves
            return isinstance(node.func, ast.Attribute) and (
                node.func.attr in _SYNC_METHODS
                or (node.func.attr not in ("to", "cuda")
                    and self._host(node.func.value)))
        if isinstance(node, ast.Name):
            return node.id in self.host_names
        if isinstance(node, (ast.Attribute, ast.Subscript)):
            return self._host(node.value)
        return isinstance(node, (ast.List, ast.Tuple, ast.Constant))

    # ---- reporting ----------------------------------------------------------
    def _emit(self, rule: str, node: ast.AST, message: str) -> None:
        line = getattr(node, "lineno", 0)
        for probe in (line, line - 1):
            if rule in self.allow.get(probe, ()):  # inline suppression
                return
        if (rule, line) in self._emitted:
            return
        self._emitted.add((rule, line))
        self.findings.append(Finding(
            "ast", rule, f"{self.filename}:{line}", message))

    def _sync(self, node: ast.AST, what: str) -> None:
        if self.loop_depth > 0:
            self._emit("host-sync-in-loop", node,
                       f"{what} forces a device→host transfer on every loop "
                       "iteration — accumulate on device, drain once")
        else:
            self._emit("host-sync", node,
                       f"{what} is a device→host sync point")

    # ---- capture-scope bookkeeping -----------------------------------------
    def _collect_capture_defs(self, tree: ast.AST) -> None:
        names: Set[str] = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) \
                    and _dotted(node.func) in _CAPTURING_CALLEES:
                for arg in list(node.args) + [kw.value
                                              for kw in node.keywords]:
                    name = _dotted(arg)
                    if name and "." not in name:
                        names.add(name)
                    if isinstance(arg, ast.Lambda):
                        self.capture_defs.add(arg)
            if isinstance(node, ast.ClassDef) and any(
                    _dotted(b) in _FUNCTION_BASES for b in node.bases):
                for item in node.body:
                    if isinstance(item, ast.FunctionDef) \
                            and item.name in _FUNCTION_METHODS:
                        self.capture_defs.add(item)
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node.name in names:
                self.capture_defs.add(node)

    def lint(self, tree: ast.AST) -> List[Finding]:
        self._collect_capture_defs(tree)
        self.visit(tree)
        return self.findings

    # ---- visitors -----------------------------------------------------------
    def _visit_fn(self, node) -> None:
        captured = (self.capture_depth > 0 or node in self.capture_defs
                    or _decorated_capturing(node))
        saved = self.device_names, self.host_names, self.loop_depth
        self.device_names, self.host_names, self.loop_depth = set(), set(), 0
        self.capture_depth += 1 if captured else 0
        self.generic_visit(node)
        self.capture_depth -= 1 if captured else 0
        self.device_names, self.host_names, self.loop_depth = saved

    visit_FunctionDef = _visit_fn
    visit_AsyncFunctionDef = _visit_fn

    def visit_Lambda(self, node: ast.Lambda) -> None:
        captured = self.capture_depth > 0 or node in self.capture_defs
        self.capture_depth += 1 if captured else 0
        self.generic_visit(node)
        self.capture_depth -= 1 if captured else 0

    def visit_With(self, node: ast.With) -> None:
        captured = any(
            isinstance(item.context_expr, ast.Call)
            and _dotted(item.context_expr.func) in _CAPTURE_BLOCKS
            for item in node.items)
        self.capture_depth += 1 if captured else 0
        self.generic_visit(node)
        self.capture_depth -= 1 if captured else 0

    def _bind(self, targets, value) -> None:
        # bare names only (recursing through tuple/list unpacking): an
        # attribute target like `self.x = torch.f(...)` must NOT mark `self`
        names: List[str] = []

        def collect(t):
            if isinstance(t, ast.Name):
                names.append(t.id)
            elif isinstance(t, (ast.Tuple, ast.List)):
                for e in t.elts:
                    collect(e)
        for tgt in targets:
            collect(tgt)
        device = value is not None and self._device(value)
        host = value is not None and not device and self._host(value)
        for name in names:
            (self.device_names.add if device
             else self.device_names.discard)(name)
            (self.host_names.add if host else self.host_names.discard)(name)

    def visit_Assign(self, node: ast.Assign) -> None:
        self.generic_visit(node)
        self._bind(node.targets, node.value)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        self.generic_visit(node)
        self._bind([node.target], node.value)

    def _loop(self, node) -> None:
        if isinstance(node, ast.While):
            self._check_truthiness(node.test)
            self.visit(node.test)
        else:
            self.visit(node.iter)
            self._bind([node.target], None)
        self.loop_depth += 1
        for stmt in node.body + node.orelse:
            self.visit(stmt)
        self.loop_depth -= 1

    visit_For = _loop
    visit_AsyncFor = _loop
    visit_While = _loop

    def visit_If(self, node: ast.If) -> None:
        self._check_truthiness(node.test)
        self.generic_visit(node)

    def visit_IfExp(self, node: ast.IfExp) -> None:
        self._check_truthiness(node.test)
        self.generic_visit(node)

    def visit_Assert(self, node: ast.Assert) -> None:
        self._check_truthiness(node.test)
        self.generic_visit(node)

    def visit_BoolOp(self, node: ast.BoolOp) -> None:
        for v in node.values:
            self._check_truthiness(v)
        self.generic_visit(node)

    def visit_UnaryOp(self, node: ast.UnaryOp) -> None:
        if isinstance(node.op, ast.Not):
            self._check_truthiness(node.operand)
        self.generic_visit(node)

    def _check_truthiness(self, test: ast.AST) -> None:
        if self.capture_depth > 0 and self._device(test):
            self._emit("tracer-bool", test,
                       "Python truthiness on a device value under capture/"
                       "autograd — it syncs and breaks capture; use "
                       "torch.where, or hoist out of the captured code")

    def visit_Call(self, node: ast.Call) -> None:
        callee = _dotted(node.func)
        kws = {kw.arg for kw in node.keywords}
        if callee in _GLOBAL_SEEDS:
            self._emit("rng-global", node,
                       f"{callee}() seeds the global stream — pass an "
                       "explicit torch.Generator instead")
        elif (callee in _RNG_CALLS or (
                isinstance(node.func, ast.Attribute)
                and node.func.attr in _RNG_METHODS)) \
                and "generator" not in kws:
            what = callee or f".{node.func.attr}"
            self._emit("rng-global", node,
                       f"{what}(...) without generator= draws from the "
                       "global stream — pass an explicit torch.Generator")
        if callee == "torch.cuda.synchronize":
            self._sync(node, "torch.cuda.synchronize()")
        elif isinstance(node.func, ast.Attribute) \
                and node.func.attr == "synchronize":
            self._sync(node, f"{callee or '.synchronize'}()")
        elif isinstance(node.func, ast.Attribute) \
                and node.func.attr in _SYNC_METHODS \
                and not node.args and not self._host(node.func.value):
            self._sync(node, f".{node.func.attr}()")
        elif _to_cpu(node) and not self._host(node.func.value):
            self._sync(node, '.to("cpu")')
        elif callee in _SYNC_CALLEES and node.args \
                and self._device(node.args[0]):
            if callee in _COERCIONS and self.capture_depth > 0:
                self._emit("tracer-bool", node,
                           f"{callee}() on a device value under capture/"
                           "autograd")
            else:
                self._sync(node, f"{callee}(...) of a device expression")
        self.generic_visit(node)


def lint_source(src: str, filename: str = "<string>") -> List[Finding]:
    tree = ast.parse(src, filename=filename)
    return _Linter(filename, _allow_lines(src)).lint(tree)


def lint_file(path: str, root: Optional[str] = None) -> List[Finding]:
    with open(path) as f:
        src = f.read()
    rel = os.path.relpath(path, root) if root else path
    return lint_source(src, rel)


def lint_package() -> List[Finding]:
    """Lint the whole `repro_torch` package, paths from its parent (the
    keys the committed baseline holds)."""
    import repro_torch
    pkg = os.path.dirname(os.path.abspath(repro_torch.__file__))
    return lint_paths([pkg], root=os.path.dirname(pkg))


def lint_paths(paths: Iterable[str],
               root: Optional[str] = None) -> List[Finding]:
    """Lint every .py under the given files/directories (sorted, stable)."""
    files: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for dirpath, _, names in os.walk(p):
                files += [os.path.join(dirpath, n) for n in names
                          if n.endswith(".py")]
        elif p.endswith(".py"):
            files.append(p)
    out: List[Finding] = []
    for f in sorted(files):
        out += lint_file(f, root=root)
    return out
