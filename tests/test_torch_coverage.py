"""No module or export of the JAX package is left without a counterpart in
the port.

The check walks ``src/repro`` and ``src/repro_torch`` with ``ast`` and
imports neither. Every reference module has a port module at the same
relative path, or stands in ``NOT_PORTED``. In every reference module,
each name in ``__all__`` and each public top-level function and class is
defined or imported in the port module (a lazy ``_EXPORTS`` map counts),
or reaches its counterpart through ``RENAMED``, or stands in
``NOT_PORTED``. Every lint rule id of the reference has a port rule of
the same id, a renamed one, or an entry. ``NOT_PORTED`` is held to
ROADMAP.md's "Not ported, by choice" list, bullet for bullet, and every
entry and rename must still name something real, so neither list goes
stale. A planted module, export or function in a temporary copy of the
reference tree must fail the check.

Separately, the package-level re-exports resolve to their submodules'
objects, and importing ``repro_torch`` and each subpackage first, in a
fresh interpreter, meets no import cycle.
"""
import ast
import functools
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
REF = ROOT / "src" / "repro"
PORT = ROOT / "src" / "repro_torch"

# Each entry is one bullet of ROADMAP.md's "Not ported, by choice"
# (``roadmap``: text that bullet holds), with what it leaves out:
# reference modules, names by reference module, lint rule ids.
NOT_PORTED = [
    {"roadmap": "`repro/ops/compat.py`",
     "why": "the legacy path=/quant= string shim; ExecPolicy(backend=) is "
            "the port's one dispatch choice",
     "modules": ["ops/compat.py"],
     "names": {"ops/__init__.py": ["PATH_TO_BACKEND", "policy_from_legacy"]}},
    {"roadmap": "`repro/sharding/compat.py`",
     "why": "a jax-version shim for shard_map",
     "modules": ["sharding/compat.py"]},
    {"roadmap": "The Pallas bodies",
     "why": "csrc/ replaces them: each kernel is a CUDA C++ kernel",
     "modules": ["kernels/addtree/kernel.py", "kernels/conv_window/kernel.py",
                 "kernels/fused_cwp/kernel.py", "kernels/qmatmul/kernel.py"]},
    {"roadmap": "The Pallas helpers `default_interpret`",
     "why": "interpret-mode detection and BlockSpec sizes against a TPU's "
            "VMEM; a CUDA kernel has no interpret mode and takes ragged "
            "tiles",
     "names": {"ops/policy.py": ["default_interpret"],
               "ops/__init__.py": ["default_interpret"],
               "ops/tiling.py": ["largest_divisor", "padded_block"]}},
    {"roadmap": "pre-versioned (list) tuning-cache files",
     "why": "a file format, not a module or a name: TuningCache.load warns "
            "and loads nothing from one"},
    {"roadmap": "`repro/launch/hlo_stats.py`",
     "why": "both parse XLA's HLO; launch/op_stats.py counts on meta",
     "modules": ["launch/hlo_stats.py"],
     "names": {"launch/roofline.py": ["CollectiveStats",
                                      "parse_collective_bytes"]}},
    {"roadmap": "The lint rule `string-dispatch`",
     "why": "the port has no path= string seam; backend-literal covers "
            "ExecPolicy(backend=)",
     "names": {"analysis/rules.py": ["StringDispatchRule"]},
     "rules": ["string-dispatch"]},
    {"roadmap": "`LEGACY_TIME_RE`",
     "why": "the JAX gate's regex, which the AST rules replaced",
     "names": {"analysis/rules.py": ["LEGACY_TIME_RE"]}},
    {"roadmap": "XLA's AOT calls",
     "why": "a CUDA graph lives in its process only; an artifact records "
            "the kernel build instead",
     "names": {"artifact/aot.py": ["AOTMismatchError", "serialize_compiled",
                                   "deserialize_compiled"],
               "artifact/__init__.py": ["AOTMismatchError",
                                        "serialize_compiled",
                                        "deserialize_compiled"]}},
]

# (reference module, name) -> (port module, name) for a counterpart that
# the port names otherwise or keeps elsewhere
RENAMED = {
    ("artifact/aot.py", "aot_compile"): ("artifact/aot.py", "capture_graph"),
    ("artifact/aot.py", "cached_executable"): ("artifact/aot.py",
                                               "cached_graph"),
    ("artifact/aot.py", "cache_executable"): ("artifact/aot.py",
                                              "cache_graph"),
    ("artifact/aot.py", "clear_executable_cache"): ("artifact/aot.py",
                                                    "clear_graph_cache"),
    ("artifact/__init__.py", "aot_compile"): ("artifact/__init__.py",
                                              "capture_graph"),
    ("artifact/__init__.py", "clear_executable_cache"): (
        "artifact/__init__.py", "clear_graph_cache"),
    ("analysis/rules.py", "InterpretLiteralRule"): ("analysis/rules.py",
                                                    "BackendLiteralRule"),
    ("analysis/rules.py", "ShardMapConvRule"): ("analysis/rules.py",
                                                "CollectiveConvRule"),
    ("kernels/conv_window/ops.py", "conv2d_window"): (
        "kernels/conv_window/ops.py", "conv_window"),
    ("kernels/fused_cwp/ops.py", "fused_conv_window"): (
        "kernels/fused_cwp/ops.py", "fused_cwp"),
    ("kernels/fused_cwp/ref.py", "fused_conv_block_ref"): (
        "kernels/fused_cwp/ref.py", "fused_cwp_ref"),
    ("kernels/fused_cwp/__init__.py", "fused_conv_window"): (
        "kernels/fused_cwp/__init__.py", "fused_cwp"),
    ("kernels/fused_cwp/__init__.py", "fused_conv_block_ref"): (
        "kernels/fused_cwp/__init__.py", "fused_cwp_ref"),
    # the reference's is the op pinned to its Pallas backend
    ("kernels/qmatmul/ops.py", "qdense"): ("ops/impls.py", "qdense"),
    ("launch/dryrun.py", "lower_cell"): ("launch/dryrun.py", "build_cell"),
    ("launch/train.py", "build_mesh"): ("launch/mesh.py", "build_mesh"),
    # conv_window and fused_cwp are one CUDA template
    ("ops/tiling.py", "choose_conv_blocks"): ("ops/tiling.py",
                                              "choose_fused_blocks"),
    ("ops/tiling.py", "choose_tree_rows"): ("ops/tiling.py",
                                            "choose_tree_blocks"),
}

RULES_RENAMED = {"interpret-literal": "backend-literal",
                 "shard-map-conv": "collective-conv"}


# ------------------------------------------------------------- the walk

def _top_level(tree: ast.Module):
    """The module's top-level statements, those under a top-level ``if``
    or ``try`` included."""
    for node in tree.body:
        if isinstance(node, (ast.If, ast.Try)):
            yield from (n for n in ast.walk(node) if isinstance(n, ast.stmt))
        else:
            yield node


def _literal_names(value, tables: dict) -> list[str] | None:
    """The strings of a list/tuple literal, ``*table`` entries spliced in,
    or of ``sorted(table)``; None for anything else."""
    if isinstance(value, (ast.List, ast.Tuple)):
        out = []
        for e in value.elts:
            if isinstance(e, ast.Constant) and isinstance(e.value, str):
                out.append(e.value)
            elif (isinstance(e, ast.Starred) and isinstance(e.value, ast.Name)
                  and e.value.id in tables):
                out.extend(tables[e.value.id])
            else:
                return None
        return out
    if (isinstance(value, ast.Call) and isinstance(value.func, ast.Name)
            and value.func.id == "sorted" and len(value.args) == 1
            and isinstance(value.args[0], ast.Name)
            and value.args[0].id in tables):
        return sorted(tables[value.args[0].id])
    return None


def module_info(path: Path) -> dict:
    """A module's names: ``defined`` (top-level defs, classes, assigned
    names, imports and a lazy ``_EXPORTS`` map's keys), ``public`` (its
    public top-level functions and classes), ``all`` (``__all__`` or
    None) and ``rules`` (class-level ``id = "..."`` strings)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    defined, public, rules = set(), set(), set()
    tables: dict[str, list[str]] = {}
    exports = None
    for node in _top_level(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            defined.add(node.name)
            if not node.name.startswith("_") and node in tree.body:
                public.add(node.name)
            if isinstance(node, ast.ClassDef):
                for st in node.body:
                    if (isinstance(st, ast.Assign) and len(st.targets) == 1
                            and isinstance(st.targets[0], ast.Name)
                            and st.targets[0].id == "id"
                            and isinstance(st.value, ast.Constant)):
                        rules.add(st.value.value)
        elif isinstance(node, ast.Assign):
            for target in node.targets:
                defined.update(n.id for n in ast.walk(target)
                               if isinstance(n, ast.Name))
            if len(node.targets) != 1 or not isinstance(node.targets[0],
                                                        ast.Name):
                continue
            name = node.targets[0].id
            if isinstance(node.value, ast.Dict):
                tables[name] = [k.value for k in node.value.keys
                                if isinstance(k, ast.Constant)]
            elif name == "__all__":
                exports = _literal_names(node.value, tables)
                assert exports is not None, f"{path}: __all__ is not a literal"
            else:
                names = _literal_names(node.value, tables)
                if names is not None:
                    tables[name] = names
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            defined.add(node.target.id)
        elif isinstance(node, ast.Import):
            defined.update((a.asname or a.name).split(".")[0]
                           for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            defined.update(a.asname or a.name for a in node.names)
    defined.update(tables.get("_EXPORTS", ()))
    return {"defined": defined, "public": public, "all": exports,
            "rules": rules}


def modules(root: Path) -> list[str]:
    return sorted(p.relative_to(root).as_posix() for p in root.rglob("*.py"))


def gaps(ref: Path, port: Path, not_ported=NOT_PORTED,
         renamed=RENAMED) -> list[str]:
    """Everything of ``ref`` with no counterpart in ``port``, no rename
    and no entry, as one line each; empty when the port is whole."""
    skip_mods = {m for e in not_ported for m in e.get("modules", ())}
    skip_names = {(mod, n) for e in not_ported
                  for mod, names in e.get("names", {}).items()
                  for n in names}
    out = []
    infos: dict[tuple[Path, str], dict] = {}

    def info(root, rel):
        if (root, rel) not in infos:
            infos[root, rel] = module_info(root / rel)
        return infos[root, rel]

    for rel in modules(ref):
        if rel in skip_mods:
            continue
        if not (port / rel).is_file():
            out.append(f"module {rel}: no port module")
            continue
        r, p = info(ref, rel), info(port, rel)
        for name in sorted(set(r["all"] or ()) | r["public"]):
            if (rel, name) in skip_names or name in p["defined"]:
                continue
            target = renamed.get((rel, name))
            if target is None:
                out.append(f"name {rel}:{name}: not in the port module")
            elif not ((port / target[0]).is_file()
                      and target[1] in info(port, target[0])["defined"]):
                out.append(f"name {rel}:{name}: renamed to "
                           f"{target[0]}:{target[1]}, which is missing")
    ref_rules = set().union(*(info(ref, m)["rules"] for m in modules(ref)
                              if m.startswith("analysis/")))
    port_rules = set().union(*(info(port, m)["rules"] for m in modules(port)
                               if m.startswith("analysis/")))
    skip_rules = {r for e in not_ported for r in e.get("rules", ())}
    for rule in sorted(ref_rules - skip_rules):
        if RULES_RENAMED.get(rule, rule) not in port_rules:
            out.append(f"lint rule {rule}: no port rule")
    return out


# ---------------------------------------------------------------- tests

@functools.lru_cache(maxsize=1)
def _tree_gaps() -> tuple[str, ...]:
    return tuple(gaps(REF, PORT))


@pytest.mark.parametrize("rel", modules(REF))
def test_reference_module_has_its_counterpart(rel):
    """One reference module: its port module, every ``__all__`` name and
    every public top-level function and class (or the entry or rename
    that stands for it)."""
    mine = [g for g in _tree_gaps() if g.split(":")[0].split()[-1] == rel]
    assert not mine, "\n".join(mine)


def test_every_lint_rule_has_a_port_rule():
    assert not [g for g in _tree_gaps() if g.startswith("lint rule")]


def _roadmap_bullets() -> list[str]:
    text = (ROOT / "ROADMAP.md").read_text()
    section = text.split("*Not ported, by choice:*", 1)[1]
    section = section.split("\n\n", 1)[0]
    bullets = []
    for line in section.strip().splitlines():
        if line.startswith("- "):
            bullets.append(line[2:])
        else:
            bullets[-1] += " " + line.strip()
    return bullets


def test_not_ported_list_matches_the_roadmap():
    """Bullet for bullet: each entry's text stands in exactly one bullet,
    and each bullet holds exactly one entry's."""
    bullets = _roadmap_bullets()
    assert len(bullets) == len(NOT_PORTED)
    for entry in NOT_PORTED:
        hits = [b for b in bullets if entry["roadmap"] in b]
        assert len(hits) == 1, (entry["roadmap"], hits)
        assert entry["why"]
    for b in bullets:
        assert sum(e["roadmap"] in b for e in NOT_PORTED) == 1, b


def test_entries_and_renames_name_what_exists():
    """No stale entry: a not-ported module or name exists in the reference
    and not in the port; a renamed name exists in the reference, and the
    port keeps no copy under the old name."""
    for entry in NOT_PORTED:
        for rel in entry.get("modules", ()):
            assert (REF / rel).is_file() and not (PORT / rel).exists(), rel
        for rel, names in entry.get("names", {}).items():
            r = module_info(REF / rel)
            p = module_info(PORT / rel) if (PORT / rel).is_file() else None
            for n in names:
                assert n in r["defined"], (rel, n)
                assert p is None or n not in p["defined"], (rel, n)
        for rule in entry.get("rules", ()):
            assert rule in module_info(REF / "analysis/rules.py")["rules"]
    for (rel, name), (prel, pname) in RENAMED.items():
        assert name in module_info(REF / rel)["defined"], (rel, name)
        assert name not in module_info(PORT / rel)["defined"], (rel, name)
        assert pname in module_info(PORT / prel)["defined"], (prel, pname)


def _copy_tree(src: Path, dst: Path) -> None:
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns(
        "__pycache__", "*.pyc", "*.cu", "*.cuh", "*.h"))


def _plant_module(ref: Path) -> str:
    (ref / "serve/planted.py").write_text(
        '__all__ = ["Planted"]\n\n\nclass Planted:\n    pass\n')
    return "module serve/planted.py: no port module"


def _plant_export(ref: Path) -> str:
    path = ref / "serve/clock.py"
    head, tail = path.read_text().split("__all__ = [", 1)
    path.write_text(head + '__all__ = ["Sundial", ' + tail)
    return "name serve/clock.py:Sundial: not in the port module"


def _plant_function(ref: Path) -> str:
    path = ref / "serve/clock.py"
    path.write_text(path.read_text() + "\n\ndef sundial():\n    return 0\n")
    return "name serve/clock.py:sundial: not in the port module"


def _plant_rule(ref: Path) -> str:
    path = ref / "analysis/rules.py"
    path.write_text(path.read_text()
                    + '\n\nclass _Planted:\n    id = "planted-rule"\n')
    return "lint rule planted-rule: no port rule"


PLANTS = {"module": _plant_module, "export": _plant_export,
          "function": _plant_function, "rule": _plant_rule}


@pytest.mark.parametrize("kind", sorted(PLANTS))
def test_a_planted_reference_item_fails(tmp_path, kind):
    """The tree as it stands is whole; a module, an ``__all__`` name, a
    public function or a lint rule planted in a copy of the reference is
    reported, and nothing else is."""
    ref, port = tmp_path / "repro", tmp_path / "repro_torch"
    _copy_tree(REF, ref)
    _copy_tree(PORT, port)
    assert gaps(ref, port) == []
    want = PLANTS[kind](ref)
    assert gaps(ref, port) == [want]


def test_a_stale_rename_fails(tmp_path):
    """A rename whose port name is gone is reported, not trusted."""
    ref, port = tmp_path / "repro", tmp_path / "repro_torch"
    _copy_tree(REF, ref)
    _copy_tree(PORT, port)
    ops = port / "kernels/fused_cwp/ref.py"
    ops.write_text(ops.read_text().replace("def fused_cwp_ref(",
                                           "def fused_cwp_plain("))
    assert "name kernels/fused_cwp/ref.py:fused_conv_block_ref: renamed to " \
           "kernels/fused_cwp/ref.py:fused_cwp_ref, which is missing" \
           in gaps(ref, port)


# ------------------------------------------- re-exports and import cycles

REEXPORTS = {
    "repro_torch.graph": ("ir", "trace", "passes", "plan"),
    "repro_torch.core": ("addtree", "conv", "parallelism", "quantize",
                         "window"),
    "repro_torch.ops": ("policy", "registry", "impls", "tiling", "autotune"),
    "repro_torch.kernels.fused_cwp": ("ops", "ref"),
    "repro_torch.serve": ("cache", "clock", "engine", "frontend", "queue",
                          "request", "scheduler", "stats", "steps",
                          "vision"),
}


@pytest.mark.parametrize("package", sorted(REEXPORTS))
def test_package_reexports_are_the_submodules_objects(package):
    import importlib
    pkg = importlib.import_module(package)
    subs = [importlib.import_module(f"{package}.{s}")
            for s in REEXPORTS[package]]
    for name in pkg.__all__:
        owners = [s for s in subs if name in vars(s)]
        assert owners, f"{package}.{name}: in no submodule"
        assert getattr(pkg, name) is getattr(owners[0], name), name


CYCLE_PROBE = """
import importlib, sys
packages = sys.argv[1:]
for first in packages:
    for m in [m for m in sys.modules
              if m == "repro_torch" or m.startswith("repro_torch.")]:
        del sys.modules[m]
    importlib.import_module(first)
    for m in packages:
        importlib.import_module(m)
    print("ok", first)
"""


def test_no_import_cycle_whichever_package_comes_first():
    """In one fresh interpreter: for each package, every ``repro_torch``
    module dropped, that package imported first, then all the others."""
    packages = ["repro_torch"] + sorted(
        "repro_torch." + p.parent.relative_to(PORT).as_posix()
        .replace("/", ".")
        for p in PORT.rglob("__init__.py") if p.parent != PORT)
    assert "repro_torch.kernels.fused_cwp" in packages
    res = subprocess.run(
        [sys.executable, "-c", CYCLE_PROBE, *packages],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.split() == [w for p in packages for w in ("ok", p)]
    assert "jax" not in res.stderr
