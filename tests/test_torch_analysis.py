"""repro_torch.analysis (DESIGN.md §14): the port's AST lint engine held
against the reference's ``repro.analysis`` on the CPU.

Four groups:

  * parity: the reference's known-bad fixture tree (``tests/fixtures/
    lint/``), copied with ``src/repro`` renamed ``src/repro_torch``,
    gives the port's engine the reference's findings for every rule both
    catalogs share, line for line, rendered alike;
  * the port's own rules and the counterparts, each on a fixture written
    here whose must-flag lines end in ``# FLAG``;
  * planted faults in copies of real port files: each gives exactly its
    named finding, and the copy before the plant none;
  * the real tree and ``python -m repro_torch.analysis``.
"""
import ast
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys
import textwrap
from collections import Counter

import pytest

import repro.analysis as ref
from repro_torch.analysis import (DEFAULT_SCAN_DIRS, Finding, LintEngine,
                                  Severity, all_rules, findings_to_json,
                                  format_findings, lint_tree, rule_by_id)
from repro_torch.analysis.__main__ import main
from repro_torch.analysis.engine import parse_suppressions

HERE = pathlib.Path(__file__).parent
ROOT = HERE.parent
FIXTURES = HERE / "fixtures" / "lint"
PKG = "src/<pkg>/"

# findings that only one engine gives on the fixture tree, and why
REFERENCE_ONLY = {
    # the port has no path= string seam (ExecPolicy(backend=) only)
    ("benchmarks/bad_dispatch.py", 5, "string-dispatch"),
    # interpret= is a Pallas switch; backend-literal reads backend=
    ("benchmarks/bad_dispatch.py", 6, "interpret-literal"),
    # shard_map is JAX's; collective-conv reads torch collectives
    # (test_collective_conv_twin_of_bad_shard flags the torch twin)
    ("benchmarks/bad_shard.py", 5, "shard-map-conv"),
    # a jax sampler fed an inline PRNGKey; the port's global-random
    # reads torch samplers without generator=
    (PKG + "util/bad_random.py", 8, "global-random"),
}
PORT_ONLY = {
    # the fixture imports jax, which no port module may
    (PKG + "util/bad_random.py", 2, "reference-import"),
}
CATALOG = {"raw-clock", "global-random", "bare-except", "mutable-default",
           "conv-chain", "stream-scale", "backend-literal",
           "collective-conv", "reference-import", "topk-routing",
           "host-divisor", "unsorted-walk", "tf32", "module-seam"}


@pytest.fixture(scope="module")
def port_fixtures(tmp_path_factory):
    """The reference's fixture tree with src/repro renamed src/repro_torch."""
    root = tmp_path_factory.mktemp("lint")
    shutil.copytree(FIXTURES / "benchmarks", root / "benchmarks")
    shutil.copytree(FIXTURES / "src" / "repro", root / "src" / "repro_torch")
    return root


def _ref_findings():
    return ref.LintEngine(FIXTURES).lint_dirs(("src/repro", "benchmarks"))


def _port_findings(root):
    return LintEngine(root).lint_dirs(("src/repro_torch", "benchmarks"))


def _key(f, prefix):
    path = PKG + f.path[len(prefix):] if f.path.startswith(prefix) \
        else f.path
    return path, f.line, f.rule, str(f.severity)


def _as_port(f) -> Finding:
    return Finding(path=f.path, line=f.line, rule=f.rule,
                   severity=Severity(str(f.severity)), message=f.message,
                   fix=f.fix, snippet=f.snippet)


def _lint(root, rel, text):
    path = root / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(text).lstrip("\n"))
    return LintEngine(root).lint_file(path)


def _flagged(text):
    return {i for i, ln in enumerate(
        textwrap.dedent(text).lstrip("\n").splitlines(), start=1)
        if ln.rstrip().endswith("# FLAG")}


# ------------------------------------------------------------------ parity

class TestParity:
    def test_fixture_findings_match_the_reference(self, port_fixtures):
        want = Counter(_key(f, "src/repro/") for f in _ref_findings())
        got = Counter(_key(f, "src/repro_torch/")
                      for f in _port_findings(port_fixtures))
        ref_only = Counter({k + ("error",): 1 for k in REFERENCE_ONLY})
        port_only = Counter({k + ("error",): 1 for k in PORT_ONLY})
        assert want & ref_only == ref_only      # each exclusion still hits
        assert got & port_only == port_only
        assert got - port_only == want - ref_only
        shared = {r.id for r in all_rules()} & {r.id for r in
                                                ref.all_rules()}
        assert shared == {"raw-clock", "global-random", "bare-except",
                          "mutable-default", "conv-chain", "stream-scale"}
        assert {k[2] for k in got - port_only} <= shared

    def test_render_and_json_match(self, port_fixtures):
        want = _ref_findings()
        got = [_as_port(f) for f in want]
        assert [f.render() for f in got] == [f.render() for f in want]
        assert findings_to_json(got) == ref.findings_to_json(want)
        a = ref.format_findings(want, scanned=11).splitlines()
        b = format_findings(got, scanned=11).splitlines()
        assert a[:-1] == b[:-1]
        assert b[-1] == a[-1].replace("repro.analysis:",
                                      "repro_torch.analysis:", 1)
        assert b[-1].startswith("repro_torch.analysis:") and \
            b[-1].endswith("across 11 files")

    def test_findings_are_structured(self, port_fixtures):
        f = _port_findings(port_fixtures)
        assert f == sorted(f)
        for x in f:
            assert x.severity is Severity.ERROR
            assert x.snippet and x.fix
        doc = json.loads(findings_to_json(f))
        assert doc["errors"] == len(f) and doc["warnings"] == 0

    def test_raw_clock_catches_every_aliased_form(self, port_fixtures):
        f = LintEngine(port_fixtures).lint_file(
            port_fixtures / "src/repro_torch/serve/bad_clock.py")
        assert [(x.rule, x.line) for x in f] == \
            [("raw-clock", n) for n in (3, 4, 8, 9, 10)]

    def test_exempt_clock_file_is_clean(self, port_fixtures):
        assert LintEngine(port_fixtures).lint_file(
            port_fixtures / "src/repro_torch/serve/clock.py") == []

    def test_suppression_lets_only_the_marked_sites_pass(self,
                                                         port_fixtures):
        f = LintEngine(port_fixtures).lint_file(
            port_fixtures / "src/repro_torch/serve/suppressed.py")
        assert [(x.rule, x.line) for x in f] == [("raw-clock", 8)]

    @pytest.mark.parametrize("line, want", [
        ("x()  # lint: disable=raw-clock", {"raw-clock"}),
        ("x()  # lint: disable=a, b (the reason)", {"a", "b"}),
        ("x()  # lint: disable=tf32 (a reason) and more", {"tf32"}),
        ("x()  # no suppression here", None),
    ])
    def test_suppression_comment_carries_a_reason(self, line, want):
        assert parse_suppressions([line]).get(1) == want

    def test_parse_error_is_a_finding(self, tmp_path):
        f = _lint(tmp_path, "src/repro_torch/broken.py", "def f(:\n")
        assert [(x.rule, x.line, x.severity) for x in f] == \
            [("parse-error", 1, Severity.ERROR)]


# ------------------------------------------------- port rules, counterparts

REFERENCE_IMPORT = '''
    import importlib
    import jax  # FLAG
    import jax.numpy as jnp  # FLAG
    from jax import lax  # FLAG
    import jaxlib  # FLAG
    import repro.models.cnn  # FLAG
    from repro.ops import ExecPolicy  # FLAG
    from repro import analysis  # FLAG
    import repro_torch.models.cnn
    from repro_torch.ops import ExecPolicy as Policy
    from . import sibling
    import reprolib


    def late():
        importlib.import_module("repro.serve")  # FLAG
        importlib.import_module("jax.numpy")  # FLAG
        importlib.import_module("repro_torch.serve")
        return __import__("jax")  # FLAG
'''

TOPK = '''
    import torch
    from torch import topk


    def route(p, k):
        a = torch.topk(p, k)  # FLAG
        b = p.topk(k, dim=-1)  # FLAG
        c = topk(p, k)  # FLAG
        d = torch.sort(p, dim=-1, descending=True, stable=True)[1][..., :k]
        return a, b, c, d
'''

HOST_DIVISOR = '''
    import math
    import time

    import numpy as np

    from repro_torch.models.common import _const


    def flagged(x, s, steps: int, cap: float | None, n_data: int, aux):
        a = x.sum() / 3  # FLAG
        n = math.prod(s)
        b = aux / n  # FLAG
        c = x / steps  # FLAG
        d = x / cap  # FLAG
        nd = n_data if n_data > 1 else 1
        e = aux / nd  # FLAG
        x /= len(s)  # FLAG
        f = x / np.float32(2.0)  # FLAG
        g = x / (2 * steps)  # FLAG
        h = x / -1.5  # FLAG
        return a, b, c, d, e, f, g, h


    def kept(x, k, d: int, steps: int, s, t, r: int):
        a = x / _const(k, x)
        b = d / 2
        t0 = time.perf_counter()
        t1 = time.perf_counter()
        c = (t1 - t0) / steps
        n = math.prod(s)
        m = n / 4
        e = x / x.sum()
        f = x // 2
        g = x * 0.5
        h = x / k
        r = t.r
        i = x / r
        return a, b, c, m, e, f, g, h, i
'''

UNSORTED_WALK = '''
    def walks(tree, d):
        total = 0
        for k, v in tree.items():  # FLAG
            total += v
        leaves = [v for v in tree.values()]  # FLAG
        keys = {k for k in d.keys()}  # FLAG
        gen = sum(v for v in d.values())  # FLAG
        for i, (k, v) in enumerate(d.items()):  # FLAG
            total += v
        for k, v in sorted(tree.items()):
            total += v
        ok = [tree[k] for k in sorted(tree)]
        mapped = {k: v * 2 for k, v in tree.items()}
        n = len(d.keys())
        return total, leaves, keys, gen, ok, mapped, n
'''

TF32 = '''
    import torch
    import triton.language as tl


    def setup(flag, conv):
        torch.backends.cuda.matmul.allow_tf32 = True  # FLAG
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.fp32_precision = "tf32"  # FLAG
        torch.backends.cuda.matmul.fp32_precision = "ieee"
        torch.set_float32_matmul_precision("high")  # FLAG
        torch.set_float32_matmul_precision(flag)  # FLAG
        torch.set_float32_matmul_precision("highest")
        conv(allow_tf32=True)  # FLAG
        conv(allow_tf32=False)


    def kernel(a, b):
        x = tl.dot(a, b)  # FLAG
        y = tl.dot(a, b, input_precision="tf32")  # FLAG
        z = tl.dot(a, b, input_precision="ieee")
        return x, y, z
'''

MODULE_SEAM = '''
    import torch
    import repro_torch.models.moe as moe
    import repro_torch.ops.autotune
    from repro_torch.kernels.qmatmul import ops as qm
    from repro_torch.ops import autotune


    def plant(fake, counts):
        moe._slots = fake  # FLAG
        qm.qmatmul, qm.qmatmul_acc = fake, fake  # FLAG
        autotune.TUNE_ITERS += 1  # FLAG
        setattr(moe, "_top_k", fake)  # FLAG
        repro_torch.ops.autotune._measure = fake  # FLAG
        counts.launches = 0
        for mod in (qm,):
            mod.launches = 0
        torch.backends.cudnn.allow_tf32 = False
        with moe.routing_trace() as log:
            before = autotune.measurements
        return before, log
'''

GLOBAL_RANDOM = '''
    import numpy as np
    import torch
    from torch import randn


    def draw(shape, g, x, w, kw):
        a = torch.randn(shape)  # FLAG
        b = torch.randn(shape, generator=g)
        c = randn(shape)  # FLAG
        d = torch.rand_like(x)  # FLAG
        e = torch.randint(0, 9, shape, generator=g)
        w.normal_()  # FLAG
        w.uniform_(-1, 1, generator=g)
        torch.nn.init.kaiming_uniform_(w)  # FLAG
        torch.manual_seed(0)  # FLAG
        g2 = torch.Generator().manual_seed(0)
        f = torch.randperm(9, **kw)
        h = np.random.rand(3)  # FLAG
        i = np.random.default_rng(0).random(3)
        return a, b, c, d, e, f, g2, h, i
'''

BACKEND_LITERAL = '''
    from repro_torch.ops import ExecPolicy
    from repro_torch.ops.registry import dispatch


    def run(x, w, b):
        p = ExecPolicy(backend="torch")  # FLAG
        q = ExecPolicy(backend=b, quant="int8")
        r = ExecPolicy(quant="int8")
        return dispatch("qmatmul", x, w, backend="cuda"), p, q, r  # FLAG
'''

COLLECTIVE_CONV = '''
    import torch.distributed as dist


    def sharded(conv2d_apply, x, w, group):
        y = conv2d_apply(x, w)
        dist.all_reduce(y, group=group)  # FLAG
        return y
''' + "\n" * 16 + '''
    def far(x, out, group):
        dist.all_gather_into_tensor(out, x, group=group)
        return out
'''

# (rule, fixture, a path in its scope, paths out of it)
PORT_RULES = [
    ("reference-import", REFERENCE_IMPORT, "src/repro_torch/util/imp.py",
     ("scripts/imp.py",)),
    ("reference-import", REFERENCE_IMPORT, "chip_smoke.py", ()),
    ("topk-routing", TOPK, "src/repro_torch/models/router.py",
     ("chip_smoke.py",)),
    ("host-divisor", HOST_DIVISOR, "src/repro_torch/models/div.py",
     ("src/repro_torch/serve/div.py", "chip_smoke.py")),
    ("host-divisor", HOST_DIVISOR, "src/repro_torch/sharding/div.py", ()),
    ("unsorted-walk", UNSORTED_WALK, "src/repro_torch/optim/walk.py",
     ("src/repro_torch/models/walk.py",)),
    ("unsorted-walk", UNSORTED_WALK, "src/repro_torch/core/tree.py",
     ("src/repro_torch/core/conv.py",)),
    ("tf32", TF32, "src/repro_torch/ops/prec.py", ()),
    ("tf32", TF32, "chip_smoke.py", ()),
    ("module-seam", MODULE_SEAM, "chip_smoke.py", ("scripts/seam.py",)),
    ("module-seam", MODULE_SEAM, "src/repro_torch/serve/seam.py", ()),
    ("global-random", GLOBAL_RANDOM, "src/repro_torch/util/rng.py",
     ("chip_smoke.py",)),
    ("backend-literal", BACKEND_LITERAL, "src/repro_torch/serve/run.py",
     ("src/repro_torch/ops/run.py", "src/repro_torch/kernels/run.py")),
    ("backend-literal", BACKEND_LITERAL, "chip_smoke.py", ()),
    ("collective-conv", COLLECTIVE_CONV, "src/repro_torch/serve/coll.py",
     ("src/repro_torch/core/parallelism.py",
      "src/repro_torch/graph/coll.py")),
]


@pytest.mark.parametrize(
    "rule, text, path, outside", PORT_RULES,
    ids=[f"{r[0]}@{r[2]}" for r in PORT_RULES])
def test_rule_flags_exactly_its_lines(tmp_path, rule, text, path, outside):
    got = {(f.rule, f.line) for f in _lint(tmp_path, path, text)}
    want = {(rule, n) for n in _flagged(text)}
    assert want and got == want
    for rel in outside:
        assert [f for f in _lint(tmp_path, rel, text)
                if f.rule == rule] == []


def test_collective_conv_twin_of_bad_shard(tmp_path):
    """The reference's bad_shard.py with a torch collective in place of
    shard_map: the port's counterpart flags the line the reference's
    shard-map-conv does."""
    text = (FIXTURES / "benchmarks/bad_shard.py").read_text()
    assert "shard_map" in text
    twin = text.replace("shard_map(lambda a, b: conv2d_apply(a, b), "
                        "mesh=mesh)", "all_reduce(conv2d_apply(x, w))")
    assert twin != text
    ref_line = [f.line for f in _ref_findings()
                if f.rule == "shard-map-conv"]
    got = [(f.rule, f.line) for f in _lint(tmp_path, "benchmarks/b.py",
                                           twin.replace("shard_map,",
                                                        "all_reduce,"))]
    assert got == [("collective-conv", n) for n in ref_line] == \
        [("collective-conv", 5)]


# -------------------------------------------- planted faults in real files

# (file, text replaced, its fault, the fault's marker, the named rule)
PLANTED = [
    ("src/repro_torch/models/moe.py",
     "vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)",
     "vals, idx = torch.topk(probs, k, dim=-1)", "torch.topk(",
     "topk-routing"),
    ("src/repro_torch/models/common.py",
     "x.to(torch.float32) / _const(cap, x)", "x.to(torch.float32) / cap",
     "float32) / cap", "host-divisor"),
    ("src/repro_torch/core/tree.py",
     "return [item for k in sorted(tree)",
     "return [item for k in tree.keys()", "tree.keys()", "unsorted-walk"),
    ("src/repro_torch/ops/impls.py",
     "torch.backends.cuda.matmul.allow_tf32 = False",
     "torch.backends.cuda.matmul.allow_tf32 = True", "allow_tf32 = True",
     "tf32"),
    ("chip_smoke.py",
     "    cfg, params, x = moe_card_vs_cpu_inputs(device)\n",
     "    cfg, params, x = moe_card_vs_cpu_inputs(device)\n"
     "    moe._slots = lambda flat_e, e, cap: (flat_e, flat_e >= 0)\n",
     "moe._slots =", "module-seam"),
    ("src/repro_torch/bridge.py", "import torch\n",
     "import torch\nimport jax\n", "import jax", "reference-import"),
]


@pytest.mark.parametrize("rel, old, new, mark, rule", PLANTED,
                         ids=[p[4] for p in PLANTED])
def test_planted_fault_gives_its_finding(tmp_path, rel, old, new, mark,
                                         rule):
    text = (ROOT / rel).read_text()
    assert text.count(old) == 1, f"{rel} no longer holds {old!r}"
    dest = tmp_path / rel
    dest.parent.mkdir(parents=True, exist_ok=True)
    dest.write_text(text)
    assert LintEngine(tmp_path).lint_file(dest) == []
    planted = text.replace(old, new)
    dest.write_text(planted)
    line = planted[:planted.index(mark)].count("\n") + 1
    got = LintEngine(tmp_path).lint_file(dest)
    assert [(f.path, f.line, f.rule) for f in got] == [(rel, line, rule)]


# ------------------------------------------------ the real tree, the gate

def _anchor_resolves(anchor: str) -> bool:
    m = re.fullmatch(r"DESIGN\.md §(\d+)", anchor)
    if m:
        heads = re.findall(r"^#{1,6}\s*§(\d+)\b",
                           (ROOT / "DESIGN.md").read_text(), re.MULTILINE)
        return m.group(1) in heads
    path, _, name = anchor.partition(":")
    src = ROOT / "src" / path
    if not (path.startswith("repro_torch/") and src.is_file()):
        return False
    return name in {n.name for n in ast.parse(src.read_text()).body
                    if isinstance(n, (ast.FunctionDef, ast.ClassDef))}


def test_rule_catalog():
    rules = all_rules()
    assert {r.id for r in rules} == CATALOG and len(rules) == len(CATALOG)
    for r in rules:
        assert r.doc and r.fix and r.severity is Severity.ERROR, r.id
        assert _anchor_resolves(r.anchor), (r.id, r.anchor)
    assert rule_by_id("raw-clock").anchor == "DESIGN.md §11"
    assert rule_by_id("host-divisor").anchor == \
        "repro_torch/models/common.py:_const"
    with pytest.raises(KeyError):
        rule_by_id("string-dispatch")


def test_real_tree_gate_is_green():
    assert DEFAULT_SCAN_DIRS == ("src/repro_torch", "chip_smoke.py")
    errors = [f for f in lint_tree(ROOT) if f.severity is Severity.ERROR]
    assert errors == [], "\n".join(f.render() for f in errors)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_cli_gate_on_the_real_tree():
    r = subprocess.run([sys.executable, "-m", "repro_torch.analysis"],
                       cwd=ROOT, env=_env(), capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    lines = r.stdout.splitlines()
    assert re.fullmatch(r"repro_torch\.analysis: 0 finding\(s\) \(0 "
                        r"error\(s\), 0 warning\(s\)\) across \d+ files",
                        lines[0]), lines[0]
    assert lines[1:] == [f"verify {n}: ok" for n in (
        "mnist_cnn[none]", "mnist_cnn[qformat]", "mnist_cnn[int8]",
        "highres_cnn[streamed]")]


def test_cli_json_lint_only(capsys):
    assert main(["--root", str(ROOT), "--json", "--lint-only"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc == {"findings": [], "errors": 0, "warnings": 0}


def test_cli_planted_tree_fails(tmp_path, capsys):
    _lint(tmp_path, "src/repro_torch/bad.py", "import jax\n")
    assert main(["--root", str(tmp_path), "--lint-only"]) == 1
    out = capsys.readouterr().out
    assert "src/repro_torch/bad.py:1: [reference-import/error]" in out
    assert main(["--root", str(tmp_path), "--lint-only", "--json"]) == 1
    doc = json.loads(capsys.readouterr().out)
    assert doc["errors"] == 1 and doc["findings"][0]["line"] == 1


def test_analysis_imports_no_reference():
    """The package and its verify step import neither JAX nor the JAX
    package (checked through sys.modules in a fresh interpreter)."""
    code = ("import json, sys\n"
            "from repro_torch.analysis.__main__ import main\n"
            "rc = main(['--verify-only'])\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "print(json.dumps(bad))\n"
            "sys.exit(rc)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert json.loads(r.stdout.splitlines()[-1]) == []
