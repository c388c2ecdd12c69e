"""The benchmark's plain reference against the program's CPU plan, and the
import rules of the benchmark's sources.

The reference (``chipbench.reference``) restates the int8 datapath from
the raw weights; the program's compiled, fused and (for the highres_cnn
fixture) banded plan on the CPU's plain backends must give the same
logits bit for bit, since both sum integer codes exactly under the same
fp32 roundings.
"""
import ast
import json
from pathlib import Path

import pytest
import torch

from chipbench import harness, reference
from chipbench.reference import cnn as ref_cnn

BENCH = Path(harness.__file__).resolve().parent
# the benchmark's configurations, and the banded fixture of the tests
CONFIGS = {p.stem: json.loads(p.read_text()) for p in sorted(
    [*(BENCH / "configs").glob("*.json"),
     BENCH / "tests" / "data" / "highres_cnn_int8.json"])}


def _inputs(cfg, seed, batch):
    gen = torch.Generator().manual_seed(seed)
    params = harness.make_params(cfg, gen, "cpu")
    return params, harness.make_images(cfg, gen, 1, batch, "cpu")[0]


@pytest.mark.parametrize("name,batch,seed", [
    ("mnist_cnn_int8", 3, 0), ("mnist_cnn_int8", 8, 2**31 + 11),
    ("highres_cnn_int8", 2, 5)])
def test_reference_matches_the_programs_cpu_plan(name, batch, seed):
    cfg = CONFIGS[name]
    params, x = _inputs(cfg, seed, batch)
    bound = harness.compile_bound(cfg, params, batch)
    with torch.inference_mode():
        got = bound(x)
        want = reference.forward(params, x, cfg)
    assert got.dtype == want.dtype == torch.float32
    assert torch.equal(got, want)


def test_highres_plan_is_banded():
    """The reference covers highres_cnn's banded blocks: the program's
    plan at the default stream budget streams blocks 0 and 1."""
    cfg = CONFIGS["highres_cnn_int8"]
    params, _ = _inputs(cfg, 0, 1)
    bound = harness.compile_bound(cfg, params, 1)
    tiled = [getattr(n, "tiling", None) is not None
             for n in bound.plan.graph
             if type(n).__name__ == "FusedConvBlockNode"]
    assert tiled == [True, True, False, False]


@pytest.mark.parametrize("dim", [None, -1, 0])
def test_quantize_matches_the_programs_int8(dim):
    from repro_torch.core.quantize import quantize_int8
    x = torch.randn(5, 33, generator=torch.Generator().manual_seed(1)) * 3
    codes, scale = reference.quantize(x, 127, dim)
    q = quantize_int8(x, axis=dim)
    assert torch.equal(codes.to(torch.int8), q.codes)
    assert torch.equal(scale, q.scale)


def test_conv_sums_are_exact_integers():
    """The float64 sum rounded back equals an int64 sum of the codes."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randint(-127, 128, (2, 15, 13, 13), generator=gen)
    w = torch.randint(-127, 128, (20, 15, 6, 6), generator=gen)
    got = ref_cnn._exact(torch.nn.functional.conv2d(x.double(), w.double()))
    cols = torch.nn.functional.unfold(x.double(), 6).round().long()
    want = (w.reshape(20, -1) @ cols).reshape(2, 20, 8, 8)
    assert torch.equal(got, want.to(torch.float32))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_the_4bit_control_differs(name):
    cfg = CONFIGS[name]
    params, x = _inputs(cfg, 7, 2)
    gap = harness.compare_logits(reference.forward(params, x, cfg, bits=4),
                                 reference.forward(params, x, cfg))["gap"]
    assert gap > 1e-3


def _top_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(node.args[0].value.split(".")[0])
    return names


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(BENCH)))
def test_no_jax_or_reference_package_import(path):
    """Top-level names compared whole: ``repro_torch`` is the program,
    ``repro`` the JAX package."""
    assert not _top_imports(path) & {"jax", "jaxlib", "flax", "repro"}


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert _top_imports(path) <= {"__future__", "torch", "chipbench"}
    assert "repro_torch" not in path.read_text()


def test_import_check_reads_top_level_names_whole(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import repro_torch.serve\nfrom repro.core import x\n"
                   "import jax.numpy as jnp\n")
    assert _top_imports(src) == {"repro_torch", "repro", "jax"}
