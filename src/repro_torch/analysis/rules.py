"""The AST rule catalog (DESIGN.md §14), ported from
``repro.analysis.rules`` to read the port's own source.

A rule is an object with

  * ``id``        — stable kebab-case identifier (``# lint: disable=<id>``),
  * ``severity``  — ``error`` findings fail the gate,
  * ``anchor``    — where the invariant is documented or held: a
    ``DESIGN.md §N`` section, or ``repro_torch/<module>.py:<name>``, the
    port's function that keeps it,
  * ``doc``       — one-line description,
  * ``fix``       — the suggested fix every finding carries,
  * ``visit(tree, path, lines) -> [Finding]``.

Rules read the parsed AST, not text, so aliasing (``import time as t``),
``from``-imports and formatting cannot slip past the gate. Scoping is by
repo-relative posix path prefix; the engine never scans ``tests/``.

The catalog has three groups:

  * the reference's rules that read any Python, their scope moved from
    ``src/repro/`` to ``src/repro_torch/``: ``raw-clock``,
    ``global-random`` (its JAX-key half becomes torch samplers without a
    ``generator=``), ``bare-except``, ``mutable-default``;
  * counterparts of the reference's JAX rules where the port has the same
    seam: ``conv-chain``, ``stream-scale``, ``backend-literal`` (for
    ``interpret-literal``) and ``collective-conv`` (for
    ``shard-map-conv``);
  * the port's own standing rules: ``reference-import``,
    ``topk-routing``, ``host-divisor``, ``unsorted-walk``, ``tf32`` and
    ``module-seam``.

Not ported: ``string-dispatch`` (the port has no ``path=`` string seam:
``ExecPolicy(backend=)`` is its only dispatch choice, which
``backend-literal`` covers), and ``LEGACY_TIME_RE`` with the
``scripts/check_dispatch.py`` shim, which are the JAX gate's history.
"""
from __future__ import annotations

import ast
import re
from typing import Protocol, runtime_checkable

from repro_torch.analysis.findings import Finding, Severity

__all__ = ["Rule", "BaseRule", "all_rules", "rule_by_id", "register",
           "CLOCK_FNS"]

CLOCK_FNS = ("monotonic", "sleep", "time", "perf_counter")

_PORT = "src/repro_torch/"
_SMOKE = "chip_smoke.py"


@runtime_checkable
class Rule(Protocol):
    """The rule protocol the engine drives."""

    id: str
    severity: Severity
    anchor: str
    doc: str
    fix: str

    def applies(self, path: str) -> bool: ...

    def visit(self, tree: ast.AST, path: str,
              lines: list[str]) -> list[Finding]: ...


_RULES: list["BaseRule"] = []


def register(cls):
    _RULES.append(cls())
    return cls


def all_rules() -> tuple["BaseRule", ...]:
    return tuple(_RULES)


def rule_by_id(rule_id: str) -> "BaseRule":
    for rule in _RULES:
        if rule.id == rule_id:
            return rule
    raise KeyError(f"no lint rule {rule_id!r}; known: "
                   f"{[r.id for r in _RULES]}")


# ---------------------------------------------------------------------------
# shared AST helpers

def _dotted(node: ast.AST) -> str:
    """Dotted name of an expression (``a.b.c``), or '' when not a plain
    name chain."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _call_name(call: ast.Call) -> str:
    return _dotted(call.func)


def _calls(tree: ast.AST) -> list[ast.Call]:
    return [n for n in ast.walk(tree) if isinstance(n, ast.Call)]


def _import_names(tree: ast.AST) -> dict[str, str]:
    """{local name: the dotted module or object an import in the file
    (any scope) binds it to}: ``import a.b as m`` -> m: a.b, ``import
    a.b`` -> a: a, ``from a import b as c`` -> c: a.b."""
    out: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.asname:
                    out[alias.asname] = alias.name
                else:
                    top = alias.name.split(".")[0]
                    out[top] = top
        elif isinstance(node, ast.ImportFrom):
            base = "." * node.level + (node.module or "")
            for alias in node.names:
                if alias.name != "*":
                    out[alias.asname or alias.name] = f"{base}.{alias.name}"
    return out


def _resolved(node: ast.AST, names: dict[str, str]) -> str:
    """``_dotted(node)`` with its first part replaced by what an import
    binds it to (``t.randn`` after ``import torch as t`` -> torch.randn)."""
    dotted = _dotted(node)
    head, _, rest = dotted.partition(".")
    full = names.get(head, head)
    return f"{full}.{rest}" if rest and full else full


def _kwarg(call: ast.Call, name: str):
    """(present, value node) of keyword ``name``; a ``**mapping`` counts
    as present (it may carry it)."""
    for kw in call.keywords:
        if kw.arg == name or kw.arg is None:
            return True, kw.value
    return False, None


class BaseRule:
    """Common scoping + finding construction. Subclasses set the class
    attributes and implement ``check``."""

    id: str = ""
    severity: Severity = Severity.ERROR
    anchor: str = "DESIGN.md §14"
    doc: str = ""
    fix: str = ""
    # path scoping (repo-relative posix). ``only_prefixes=None`` means the
    # rule runs on every scanned file; exemptions are checked either way.
    only_prefixes: tuple[str, ...] | None = None
    exempt_prefixes: tuple[str, ...] = ()
    exempt_files: tuple[str, ...] = ()

    def applies(self, path: str) -> bool:
        if path in self.exempt_files or path.startswith(self.exempt_prefixes):
            return False
        if self.only_prefixes is None:
            return True
        return path.startswith(self.only_prefixes)

    def finding(self, path: str, line: int, message: str,
                lines: list[str], fix: str | None = None) -> Finding:
        snippet = lines[line - 1].strip() if 0 < line <= len(lines) else ""
        return Finding(path=path, line=line, rule=self.id,
                       severity=self.severity, message=message,
                       fix=self.fix if fix is None else fix,
                       snippet=snippet)

    def visit(self, tree: ast.AST, path: str,
              lines: list[str]) -> list[Finding]:
        return self.check(tree, path, lines)

    def check(self, tree: ast.AST, path: str,
              lines: list[str]) -> list[Finding]:  # pragma: no cover
        raise NotImplementedError


# ---------------------------------------------------------------------------
# counterparts of the reference's dispatch rules

_CONV = re.compile(r"\A(conv2d\w*|fused_conv\w*|_conv)\Z")
_CONV_OPS = ("conv2d", "fused_conv_block")


def _conv_lines(tree: ast.AST) -> set[int]:
    """Lines of a conv call (by name) or a conv op-name literal."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and \
                _CONV.match(_call_name(node).rsplit(".", 1)[-1]):
            out.add(node.lineno)
        elif isinstance(node, ast.Constant) and node.value in _CONV_OPS:
            out.add(node.lineno)
    return out


@register
class BackendLiteralRule(BaseRule):
    """Hard-coded ``backend=`` literal given to ``ExecPolicy(...)`` or
    ``dispatch(...)`` outside the registry and kernels (DESIGN.md §7):
    the port's counterpart of ``interpret-literal``. A plain backend
    pinned on the main path is a fallback that hides the kernel."""

    id = "backend-literal"
    doc = ("hard-coded backend= literal to ExecPolicy/dispatch outside "
           "repro_torch.ops/kernels — the registry picks by device")
    anchor = "DESIGN.md §7"
    fix = ("let the registry select by device priority, or pass the "
           "backend in from the caller")
    exempt_prefixes = (_PORT + "ops/", _PORT + "kernels/")

    def check(self, tree, path, lines):
        out = []
        for call in _calls(tree):
            if _call_name(call).rsplit(".", 1)[-1] not in ("ExecPolicy",
                                                           "dispatch"):
                continue
            for kw in call.keywords:
                if kw.arg == "backend" and isinstance(kw.value, ast.Constant) \
                        and isinstance(kw.value.value, str):
                    out.append(self.finding(
                        path, kw.value.lineno,
                        f"hard-coded backend={kw.value.value!r} literal",
                        lines))
        return out


@register
class ConvChainRule(BaseRule):
    """Hand-rolled conv→relu→pool chain outside the graph compiler
    (DESIGN.md §8): the unfused pipeline ``fused_conv_block`` replaces."""

    id = "conv-chain"
    doc = ("hand-rolled conv2d_apply -> relu -> pool chain outside "
           "graph/models/kernels")
    anchor = "DESIGN.md §8"
    fix = ("compile the model (PaperCNN.compile / repro_torch.graph) or "
           "call fused_conv_block")
    exempt_prefixes = (_PORT + "graph/", _PORT + "models/",
                       _PORT + "kernels/")
    WINDOW = 4                      # lines after the conv call to scan

    def check(self, tree, path, lines):
        conv, relu, pool = [], set(), set()
        for call in _calls(tree):
            name = _call_name(call).rsplit(".", 1)[-1]
            if name == "conv2d_apply":
                conv.append(call.lineno)
            elif name == "relu":
                relu.add(call.lineno)
            elif name in ("maxpool2", "max_pool2d", "reduce_window"):
                pool.add(call.lineno)
        out = []
        for ln in conv:
            window = range(ln, ln + 1 + self.WINDOW)
            if any(r in window for r in relu) and \
                    any(p in window for p in pool):
                out.append(self.finding(
                    path, ln, "hand-rolled conv->relu->pool chain", lines))
        return out


@register
class CollectiveConvRule(BaseRule):
    """A ``torch.distributed`` collective beside a conv dispatch outside
    ``core/parallelism.py`` (DESIGN.md §9): the port's counterpart of
    ``shard-map-conv``. Channel-parallel convs go through the placement
    pass, not ad-hoc collectives."""

    id = "collective-conv"
    doc = ("hand-rolled collective around a conv outside "
           "core.parallelism/graph")
    anchor = "DESIGN.md §9"
    fix = ("compile with mesh= so the placement pass routes the stage "
           "through core.parallelism")
    exempt_prefixes = (_PORT + "graph/",)
    exempt_files = (_PORT + "core/parallelism.py",)
    WINDOW = 15                     # lines around the collective to scan
    _COLLECTIVE = re.compile(
        r"\A(all_reduce|all_gather\w*|reduce_scatter\w*|all_to_all\w*)\Z")

    def check(self, tree, path, lines):
        coll = [c.lineno for c in _calls(tree)
                if self._COLLECTIVE.match(_call_name(c).rsplit(".", 1)[-1])]
        conv = _conv_lines(tree)
        out = []
        for ln in coll:
            lo, hi = ln - self.WINDOW, ln + self.WINDOW
            if any(lo <= c <= hi for c in conv):
                out.append(self.finding(
                    path, ln, "hand-rolled collective around a conv",
                    lines))
        return out


@register
class RawClockRule(BaseRule):
    """Raw ``time`` module use in the serving layer (DESIGN.md §11): all
    serving-layer timing goes through the injectable Clock seam so the
    whole stack runs under virtual time in tests. Tracks imports:
    ``import time as t`` + ``t.monotonic()`` and ``from time import
    monotonic`` are both findings."""

    id = "raw-clock"
    doc = ("raw time.* (incl. aliased/from-imports) in serve/ outside the "
           "Clock seam")
    anchor = "DESIGN.md §11"
    fix = "inject repro_torch.serve.clock.Clock (VirtualClock in tests)"
    only_prefixes = (_PORT + "serve/",)
    exempt_files = (_PORT + "serve/clock.py",)

    def check(self, tree, path, lines):
        out = []
        aliases = {"time"}          # names that resolve to the time module
        from_names: set[str] = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    if alias.name == "time":
                        aliases.add(alias.asname or alias.name)
                        out.append(self.finding(
                            path, node.lineno,
                            f"import of the time module"
                            + (f" (aliased as "
                               f"{alias.asname!r})" if alias.asname else ""),
                            lines))
            elif isinstance(node, ast.ImportFrom) and node.module == "time":
                for alias in node.names:
                    if alias.name in CLOCK_FNS or alias.name == "*":
                        from_names.add(alias.asname or alias.name)
                        out.append(self.finding(
                            path, node.lineno,
                            f"from-import of time.{alias.name}", lines))
        for call in _calls(tree):
            func = call.func
            if isinstance(func, ast.Attribute) \
                    and isinstance(func.value, ast.Name) \
                    and func.value.id in aliases \
                    and func.attr in CLOCK_FNS:
                out.append(self.finding(
                    path, call.lineno,
                    f"raw {func.value.id}.{func.attr}() in the serving "
                    f"layer", lines))
            elif isinstance(func, ast.Name) and func.id in from_names:
                out.append(self.finding(
                    path, call.lineno,
                    f"raw {func.id}() (from-imported clock) in the "
                    f"serving layer", lines))
        return out


@register
class StreamScaleRule(BaseRule):
    """Direct conv dispatch with a ≥220 spatial literal in its
    neighborhood (DESIGN.md §13): large images go through compiled plans
    whose placement pass bands them, never ad-hoc full-frame dispatch."""

    id = "stream-scale"
    doc = "full-image conv dispatch at streaming scale (>=220 literal)"
    anchor = "DESIGN.md §13"
    fix = ("compile the model (stream placement bands over-budget "
           "stages) or use repro_torch.stream executors")
    exempt_prefixes = (_PORT + "stream/", _PORT + "graph/",
                       _PORT + "kernels/", _PORT + "ops/")
    WINDOW = 8                      # lines around the conv call to scan
    _CONV_NAMES = ("conv2d", "fused_conv_block", "conv2d_window",
                   "fused_conv_window")

    def check(self, tree, path, lines):
        conv, dims = [], set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Call):
                name = _call_name(node).rsplit(".", 1)[-1]
                if name in self._CONV_NAMES:
                    conv.append(node.lineno)
                elif name == "dispatch" and node.args \
                        and isinstance(node.args[0], ast.Constant) \
                        and node.args[0].value in _CONV_OPS:
                    conv.append(node.lineno)
            elif isinstance(node, ast.Constant) \
                    and type(node.value) is int and node.value >= 220:
                dims.add(node.lineno)
        out = []
        for ln in conv:
            lo, hi = ln - self.WINDOW, ln + self.WINDOW
            if any(lo <= d <= hi for d in dims):
                out.append(self.finding(
                    path, ln,
                    "full-image conv dispatch at streaming scale", lines))
        return out


# ---------------------------------------------------------------------------
# the reference's rules that read any Python

@register
class GlobalRandomRule(BaseRule):
    """Unthreaded randomness in library code: the module-global numpy RNG
    and torch's global generator (hidden state, irreproducible across
    processes): a torch sampler called without ``generator=``, and
    ``torch.manual_seed`` (seeding belongs to the caller, who threads a
    ``torch.Generator`` down explicitly)."""

    id = "global-random"
    doc = ("np.random global-RNG call, torch sampler without generator=, "
           "or a global torch seed, in src/repro_torch")
    anchor = "DESIGN.md §14"
    fix = ("use np.random.RandomState(seed)/default_rng(seed), or thread "
           "a torch.Generator down from the caller (generator=g)")
    only_prefixes = (_PORT,)
    _NP_OK = ("RandomState", "default_rng", "Generator", "SeedSequence")
    _SAMPLERS = ("rand", "randn", "randint", "randperm", "normal",
                 "bernoulli", "multinomial", "poisson", "rand_like",
                 "randn_like", "randint_like")
    _INPLACE = ("normal_", "uniform_", "bernoulli_", "exponential_",
                "geometric_", "log_normal_", "cauchy_", "random_",
                "trunc_normal_", "kaiming_normal_", "kaiming_uniform_",
                "xavier_normal_", "xavier_uniform_", "orthogonal_")
    _SEEDS = ("torch.manual_seed", "torch.seed", "torch.random.manual_seed",
              "torch.random.seed", "torch.cuda.manual_seed",
              "torch.cuda.manual_seed_all", "torch.cuda.seed",
              "torch.cuda.seed_all")

    def check(self, tree, path, lines):
        out = []
        names = _import_names(tree)
        for call in _calls(tree):
            name = _call_name(call)
            full = _resolved(call.func, names)
            fn = name.rsplit(".", 1)[-1] if name else ""
            if name.startswith(("np.random.", "numpy.random.")):
                if fn not in self._NP_OK:
                    out.append(self.finding(
                        path, call.lineno,
                        f"module-global numpy RNG call {name}()", lines))
            elif full in self._SEEDS:
                out.append(self.finding(
                    path, call.lineno,
                    f"global torch seed {name}() in library code", lines))
            elif (full.startswith("torch.") and fn in self._SAMPLERS
                  or isinstance(call.func, ast.Attribute)
                  and call.func.attr in self._INPLACE) \
                    and not _kwarg(call, "generator")[0]:
                out.append(self.finding(
                    path, call.lineno,
                    f"torch sampler {name or fn}() draws from the global "
                    f"generator (no generator=)", lines))
        return out


@register
class BareExceptRule(BaseRule):
    """Bare ``except:`` in library code — the serve/artifact fallback
    ladders must name what they catch, or they swallow
    KeyboardInterrupt/SystemExit and real bugs alike."""

    id = "bare-except"
    doc = "bare except: handler in src/repro_torch"
    anchor = "DESIGN.md §12"
    fix = "name the exception types the fallback ladder handles"
    only_prefixes = (_PORT,)

    def check(self, tree, path, lines):
        return [self.finding(path, node.lineno,
                             "bare except: swallows everything incl. "
                             "KeyboardInterrupt", lines)
                for node in ast.walk(tree)
                if isinstance(node, ast.ExceptHandler) and node.type is None]


@register
class MutableDefaultRule(BaseRule):
    """Mutable default arguments in config code — a shared mutable
    default aliases across every config instance."""

    id = "mutable-default"
    doc = "mutable default argument in src/repro_torch/configs"
    anchor = "DESIGN.md §14"
    fix = "default to None (or a tuple/frozen value) and build inside"
    only_prefixes = (_PORT + "configs/",)
    _MUTABLE_CALLS = ("list", "dict", "set", "defaultdict", "OrderedDict")

    def _is_mutable(self, node) -> bool:
        if isinstance(node, (ast.List, ast.Dict, ast.Set, ast.ListComp,
                             ast.DictComp, ast.SetComp)):
            return True
        return isinstance(node, ast.Call) and \
            _call_name(node).rsplit(".", 1)[-1] in self._MUTABLE_CALLS

    def check(self, tree, path, lines):
        out = []
        for node in ast.walk(tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                     ast.Lambda)):
                continue
            args = node.args
            for default in (*args.defaults, *args.kw_defaults):
                if default is not None and self._is_mutable(default):
                    name = getattr(node, "name", "<lambda>")
                    out.append(self.finding(
                        path, default.lineno,
                        f"mutable default argument on {name}()", lines))
        return out


# ---------------------------------------------------------------------------
# the port's own rules

_REFERENCE_PACKAGES = ("jax", "jaxlib", "repro")


def _is_reference(module: str) -> bool:
    return module.split(".")[0] in _REFERENCE_PACKAGES


@register
class ReferenceImportRule(BaseRule):
    """The port imports nothing of JAX or of the JAX package (PR 11): it
    takes the reference's weights only as numpy, through the bridge, and
    keeps its own copy of whatever else it needs."""

    id = "reference-import"
    doc = "import of jax/jaxlib or of the JAX package repro in the port"
    anchor = "repro_torch/bridge.py:params_from_numpy"
    fix = ("keep a torch copy in repro_torch; reference data crosses as "
           "numpy (repro_torch.bridge), and only tests import both")
    only_prefixes = (_PORT, _SMOKE)

    def check(self, tree, path, lines):
        out = []
        names = _import_names(tree)
        for node in ast.walk(tree):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            elif isinstance(node, ast.Call) and node.args \
                    and _resolved(node.func, names) in (
                        "importlib.import_module", "__import__") \
                    and isinstance(node.args[0], ast.Constant) \
                    and isinstance(node.args[0].value, str):
                mods = [node.args[0].value]
            for mod in mods:
                if _is_reference(mod):
                    out.append(self.finding(
                        path, node.lineno,
                        f"the port imports {mod!r}, which is the "
                        f"reference's", lines))
        return out


@register
class TopkRoutingRule(BaseRule):
    """``torch.topk`` orders ties otherwise than ``jax.lax.top_k`` (PR
    18): the port takes the top k through a stable descending sort, so
    ties go to the lowest index."""

    id = "topk-routing"
    doc = "torch.topk / .topk( in src/repro_torch (ties not lowest-first)"
    anchor = "repro_torch/models/moe.py:_top_k"
    fix = ("torch.sort(x, descending=True, stable=True)[..., :k] "
           "(repro_torch.models.moe._top_k)")
    only_prefixes = (_PORT,)

    def check(self, tree, path, lines):
        names = _import_names(tree)
        out = []
        for call in _calls(tree):
            f = call.func
            if isinstance(f, ast.Attribute) and f.attr == "topk" or \
                    isinstance(f, ast.Name) and names.get(f.id) == \
                    "torch.topk":
                out.append(self.finding(
                    path, call.lineno,
                    "top-k through topk: ties are not taken lowest index "
                    "first", lines))
        return out


_HOST_TYPES = ("int", "float")


def _host_annotation(ann) -> bool:
    """``int``/``float``, alone or with ``None`` (``float | None``)."""
    if isinstance(ann, ast.Name):
        return ann.id in _HOST_TYPES
    if isinstance(ann, ast.BinOp) and isinstance(ann.op, ast.BitOr):
        sides = (ann.left, ann.right)
        return any(_host_annotation(s) for s in sides) and all(
            _host_annotation(s) or isinstance(s, ast.Constant)
            and s.value is None for s in sides)
    return False


def _scope_nodes(fn: ast.AST):
    """Every node of a function (or module) body, nested functions and
    classes excluded (they are scopes of their own); lambdas included."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
            stack.extend(ast.iter_child_nodes(node))


@register
class HostDivisorRule(BaseRule):
    """A true division of a device value by a host number (PR 17): CUDA
    turns ``t / 3`` into a multiplication by the reciprocal, which is not
    the reference's division. The port divides by a 0-d device tensor
    (``_const``), bitwise at power-of-two divisors and true division at
    the rest.

    A host number is a numeric literal; a call of ``len``, ``int``,
    ``float``, ``math.*``, ``np.*`` or ``time.*``; a parameter annotated
    ``int`` or ``float``; a name every assignment of which in the same
    function is one of those; or arithmetic and conditional expressions
    of them. A division is a finding when its divisor is a host number
    and its dividend is not (host arithmetic stays on the host).
    Attribute reads (``x.shape[-1]``, ``cfg.n``) are not traced."""

    id = "host-divisor"
    doc = ("true division of a device value by a host scalar in "
           "models/optim/train/sharding")
    anchor = "repro_torch/models/common.py:_const"
    fix = "divide by _const(n, x) (repro_torch.models.common), a 0-d tensor"
    only_prefixes = tuple(_PORT + d + "/" for d in ("models", "optim",
                                                    "train", "sharding"))
    _HOST_CALLS = ("len", "int", "float")
    _HOST_MODULES = ("math.", "numpy.", "time.")

    def _is_host(self, e, host: set[str], names: dict[str, str]) -> bool:
        if isinstance(e, ast.Constant):
            return type(e.value) in (int, float)
        if isinstance(e, ast.Name):
            return e.id in host
        if isinstance(e, ast.UnaryOp):
            return self._is_host(e.operand, host, names)
        if isinstance(e, ast.BinOp):
            return self._is_host(e.left, host, names) and \
                self._is_host(e.right, host, names)
        if isinstance(e, ast.IfExp):
            return self._is_host(e.body, host, names) and \
                self._is_host(e.orelse, host, names)
        if isinstance(e, ast.Call):
            if isinstance(e.func, ast.Name) and e.func.id not in names:
                return e.func.id in self._HOST_CALLS
            return _resolved(e.func, names).startswith(self._HOST_MODULES)
        return False

    def _host_names(self, fn, nodes, names) -> set[str]:
        """The names that hold host numbers in one scope (a fixed point:
        a name is host once every assignment to it is)."""
        # every binding of a name in the scope: an expression, True for
        # a parameter annotated int/float, None for one not traced
        assigned: dict[str, list] = {}
        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            a = fn.args
            for arg in (*a.posonlyargs, *a.args, *a.kwonlyargs,
                        *(v for v in (a.vararg, a.kwarg) if v)):
                assigned[arg.arg] = [
                    arg.annotation is not None
                    and _host_annotation(arg.annotation) or None]
        for node in nodes:
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        assigned.setdefault(t.id, []).append(node.value)
                    else:           # unpacking: not traced
                        for n in ast.walk(t):
                            if isinstance(n, ast.Name):
                                assigned.setdefault(n.id, []).append(None)
            elif isinstance(node, (ast.AnnAssign, ast.AugAssign)) and \
                    isinstance(node.target, ast.Name):
                assigned.setdefault(node.target.id, []).append(node.value)
            elif isinstance(node, (ast.For, ast.AsyncFor, ast.comprehension,
                                   ast.withitem, ast.NamedExpr)):
                target = getattr(node, "target", None) or getattr(
                    node, "optional_vars", None)
                for n in ast.walk(target) if target is not None else ():
                    if isinstance(n, ast.Name):
                        assigned.setdefault(n.id, []).append(None)
        host: set[str] = set()
        changed = True
        while changed:
            changed = False
            for name, values in assigned.items():
                if name not in host and all(
                        v is True or isinstance(v, ast.AST)
                        and self._is_host(v, host, names) for v in values):
                    host.add(name)
                    changed = True
        return host

    def check(self, tree, path, lines):
        names = _import_names(tree)
        out = []
        scopes = [tree] + [n for n in ast.walk(tree) if isinstance(
            n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        for fn in scopes:
            nodes = list(_scope_nodes(fn))
            host = self._host_names(fn, nodes, names)
            for node in nodes:
                if isinstance(node, ast.BinOp) and isinstance(node.op,
                                                              ast.Div):
                    num, den = node.left, node.right
                elif isinstance(node, ast.AugAssign) and isinstance(
                        node.op, ast.Div):
                    num, den = node.target, node.value
                else:
                    continue
                if self._is_host(den, host, names) and \
                        not self._is_host(num, host, names):
                    out.append(self.finding(
                        path, node.lineno,
                        f"division by the host number "
                        f"{ast.unparse(den)!r}", lines))
        return out


_WALKS = ("items", "keys", "values")
_ORDER_KEEPING = ("enumerate", "zip", "list", "tuple", "reversed")


def _unsorted_walk(it) -> str:
    """The ``.items()``/``.keys()``/``.values()`` an iterable walks in
    insertion order (through enumerate/zip/list/tuple/reversed), or ''."""
    if not isinstance(it, ast.Call):
        return ""
    f = it.func
    if isinstance(f, ast.Attribute) and f.attr in _WALKS and not it.args:
        return f".{f.attr}()"
    if isinstance(f, ast.Name) and f.id in _ORDER_KEEPING:
        for a in it.args:
            hit = _unsorted_walk(a)
            if hit:
                return hit
    return ""


@register
class UnsortedWalkRule(BaseRule):
    """A param tree or dict walked in insertion order where the order
    reaches a sum or a flat list (PR 20): the reference walks pytrees in
    sorted key order, so the port does too (``core/tree.py``). Dict
    comprehensions keep the mapping and are exempt."""

    id = "unsorted-walk"
    doc = ("for loop / list, set or generator comprehension over "
           ".items()/.keys()/.values() not wrapped in sorted()")
    anchor = "repro_torch/core/tree.py:tree_items"
    fix = ("walk sorted(d.items()) / sorted(d), or the repro_torch.core.tree "
           "helpers")
    only_prefixes = (_PORT + "core/tree.py", _PORT + "optim/",
                     _PORT + "train/", _PORT + "checkpoint/",
                     _PORT + "bridge.py", _PORT + "sharding/")

    def check(self, tree, path, lines):
        out = []
        for node in ast.walk(tree):
            if isinstance(node, (ast.For, ast.AsyncFor)):
                iters = [node.iter]
            elif isinstance(node, (ast.ListComp, ast.SetComp,
                                   ast.GeneratorExp)):
                iters = [g.iter for g in node.generators]
            else:
                continue
            for it in iters:
                hit = _unsorted_walk(it)
                if hit:
                    out.append(self.finding(
                        path, it.lineno,
                        f"walk over {hit} in insertion order", lines))
        return out


@register
class Tf32Rule(BaseRule):
    """No TF32 in an fp32 contraction: the reference pins fp32 matmul
    precision, and a TF32 router matmul flips experts (PR 18)."""

    id = "tf32"
    doc = ("allow_tf32 = True, a float32 matmul precision other than "
           "'highest', or tl.dot without input_precision='ieee'")
    anchor = "repro_torch/models/moe.py:_route"
    fix = ("keep allow_tf32 False and the precision 'highest'; pass "
           "input_precision='ieee' to tl.dot")

    def check(self, tree, path, lines):
        names = _import_names(tree)
        out = []
        for node in ast.walk(tree):
            if isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                v = node.value
                for t in targets:
                    if not isinstance(t, ast.Attribute) or \
                            not isinstance(v, ast.Constant):
                        continue
                    if t.attr == "allow_tf32" and v.value is True or \
                            t.attr == "fp32_precision" and \
                            v.value not in ("ieee", None):
                        out.append(self.finding(
                            path, node.lineno,
                            f"{t.attr} = {v.value!r} lets fp32 "
                            f"contractions run in TF32", lines))
            elif isinstance(node, ast.Call):
                full = _resolved(node.func, names)
                for kw in node.keywords:
                    if kw.arg == "allow_tf32" and \
                            isinstance(kw.value, ast.Constant) and \
                            kw.value.value is True:
                        out.append(self.finding(
                            path, node.lineno, "allow_tf32=True", lines))
                if full.endswith("set_float32_matmul_precision"):
                    arg = node.args[0] if node.args else \
                        _kwarg(node, "precision")[1]
                    if not (isinstance(arg, ast.Constant)
                            and arg.value == "highest"):
                        out.append(self.finding(
                            path, node.lineno,
                            "float32 matmul precision set other than "
                            "'highest'", lines))
                elif full == "triton.language.dot" or \
                        _dotted(node.func) == "tl.dot":
                    present, v = _kwarg(node, "input_precision")
                    if not (present and isinstance(v, ast.Constant)
                            and v.value == "ieee"):
                        out.append(self.finding(
                            path, node.lineno,
                            "tl.dot without input_precision='ieee' runs "
                            "fp32 in TF32", lines))
        return out


@register
class ModuleSeamRule(BaseRule):
    """No module-level seams (PR 25): an assignment to, or ``setattr`` on,
    an attribute of a name an import binds (``import a.b as m; m.f =
    ...``), or of any of the port's modules however deep (``repro_torch.
    ops.autotune._measure = ...``), rebinds that module for every caller
    in the process (a third-party module's nested settings, such as
    ``torch.backends.cudnn.allow_tf32``, are not seams). Planted
    faults and probes go through parameters or a context
    (``moe.routing_trace``), counts through the module's own counter."""

    id = "module-seam"
    doc = "assignment to / setattr on an imported module's attribute"
    anchor = "repro_torch/models/moe.py:routing_trace"
    fix = ("pass the behaviour in as a parameter or a context, or read the "
           "module's own counter")
    only_prefixes = (_PORT, _SMOKE)

    def check(self, tree, path, lines):
        names = _import_names(tree)
        out = []

        def seam(node, target):
            if isinstance(target, (ast.Tuple, ast.List)):
                for t in target.elts:
                    seam(node, t)
            elif isinstance(target, ast.Attribute) and (
                    isinstance(target.value, ast.Name)
                    and target.value.id in names
                    or _dotted(target).split(".")[0] in names
                    and _resolved(target, names).startswith("repro_torch.")):
                out.append(self.finding(
                    path, node.lineno,
                    f"rebinds {_dotted(target) or target.attr}, an "
                    f"imported module's attribute", lines))

        for node in ast.walk(tree):
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    seam(node, t)
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                seam(node, node.target)
            elif isinstance(node, ast.Call) and \
                    _dotted(node.func) in ("setattr", "delattr") and \
                    node.args and isinstance(node.args[0], ast.Name) and \
                    node.args[0].id in names:
                out.append(self.finding(
                    path, node.lineno,
                    f"{_dotted(node.func)} on {node.args[0].id}, an "
                    f"imported module", lines))
        return out
