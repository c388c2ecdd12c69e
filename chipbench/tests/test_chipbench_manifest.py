"""``BENCHMARK.json`` against the benchmark's contract, and the harness's
lookup by name: a configuration, a traffic mix and a per-layer metric that
a later change adds as files of their own are found without an edit to
any file that is already there."""
import hashlib
import json
import re
import shutil
from pathlib import Path

import pytest

from chipbench import harness

ROOT = harness.ROOT
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
PATH = re.compile(r"[A-Za-z0-9_./-]{1,200}")


def _names():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in MANIFEST[group]:
            yield entry["name"]
    for w in MANIFEST["workloads"]:
        yield w["config"]
        yield w["traffic"]
    for c in MANIFEST["configs"]:
        yield from c["reduced"]


def test_keys_and_shape():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert isinstance(MANIFEST["run_seconds"], int)
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in MANIFEST["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MANIFEST["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("name", sorted(set(_names())))
def test_names_use_the_allowed_characters(name):
    assert NAME.fullmatch(name), name


@pytest.mark.parametrize("metric", MANIFEST["end_to_end"]
                         + MANIFEST["per_layer"], ids=lambda m: m["name"])
def test_units_and_directions(metric):
    assert UNIT.fullmatch(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in ("device_trace", "program_span",
                                "program_counter", "host_clock")


def test_lines_without_tabs_or_newlines():
    texts = [*MANIFEST["command"], *(w["why"] for w in MANIFEST["workloads"]),
             *(c["why"] for c in MANIFEST["configs"]),
             *(c["source"] for c in MANIFEST["configs"]),
             *(m["layer"] for m in MANIFEST["per_layer"])]
    for t in texts:
        assert 1 <= len(t) <= 200 and "\t" not in t and "\n" not in t, t


def test_names_are_unique_and_references_resolve():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in MANIFEST[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in MANIFEST["end_to_end"]
               + MANIFEST["per_layer"]]
    assert len(metrics) == len(set(metrics))
    cells = {w["name"] for w in MANIFEST["workloads"]}
    e2e = {m["name"] for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
    used = {w["config"] for w in MANIFEST["workloads"]}
    assert used == {c["name"] for c in MANIFEST["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_paths_hold_the_command_and_every_file():
    paths = MANIFEST["paths"]
    for p in paths:
        assert PATH.fullmatch(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    for c in MANIFEST["configs"]:
        assert any(c["file"].startswith(p + "/") for p in paths)
        assert (ROOT / c["file"]).is_file()
    files = [c["file"] for c in MANIFEST["configs"]]
    assert len(files) == len(set(files))
    assert MANIFEST["command"][1].split("/")[0] in paths


@pytest.mark.parametrize("cell", MANIFEST["workloads"],
                         ids=lambda w: w["name"])
def test_every_cell_resolves(cell):
    found = harness.find_cell(MANIFEST, cell["name"])
    assert found.traffic["kind"] in harness.KINDS
    assert {m["name"] for m in MANIFEST["end_to_end"]} == {"images_per_s",
                                                           "setup_s"}
    assert found.metrics
    for name in found.metrics:
        assert callable(harness.load_metric(name).read)


@pytest.mark.parametrize("name", sorted(p.stem for p in (
    ROOT / "chipbench" / "configs").glob("*.json")))
def test_config_shapes_are_the_programs(name):
    """The weights the harness makes have the shapes the port's model
    takes, and the configuration's file names its published source."""
    cfg = json.loads((ROOT / "chipbench" / "configs" / f"{name}.json")
                     .read_text())
    model = harness.build_model(cfg)
    want = model.init(0, device="cpu")

    def leaves(tree, path=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, path + (k,))
            else:
                yield path + (k,), tuple(v.shape)

    assert dict(leaves(want)) == harness.param_shapes(cfg)
    assert cfg["source"].startswith("https://")


def _digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*")) if p.is_file()}


def test_new_files_are_found_without_editing_existing_ones(tmp_path):
    shutil.copytree(ROOT / "chipbench", tmp_path / "chipbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(tmp_path / "chipbench")
    bench = tmp_path / "chipbench"
    cfg = json.loads((bench / "configs" / "mnist_cnn_int8.json").read_text())
    cfg["name"] = "mnist_cnn_int8_wide"
    cfg["program"]["fields"]["conv1_c"] = 16
    cfg["layers"][0]["out_channels"] = 16
    (bench / "configs" / "mnist_cnn_int8_wide.json").write_text(
        json.dumps(cfg))
    (bench / "traffic" / "resident_b6.json").write_text(json.dumps({
        "kind": "resident", "batch": 6, "ring": 2}))
    (bench / "metrics" / "replays_traced.py").write_text(
        "def read(ctx):\n    return ctx.trace.replays\n")
    manifest = json.loads(json.dumps(MANIFEST))
    manifest["configs"].append({
        "name": "mnist_cnn_int8_wide", "source": "https://example.org/x",
        "file": "chipbench/configs/mnist_cnn_int8_wide.json",
        "reduced": [], "why": "a test"})
    manifest["workloads"].append({
        "name": "mnist_cnn_int8_wide.resident_b6",
        "config": "mnist_cnn_int8_wide", "traffic": "resident_b6",
        "chips": 1, "why": "a test"})
    manifest["per_layer"].append({
        "name": "replays_traced", "unit": "batches", "better": "higher",
        "source": "device_trace", "layer": "device", "moves": "images_per_s",
        "workloads": ["mnist_cnn_int8_wide.resident_b6"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))

    cell = harness.find_cell(harness.load_manifest(tmp_path),
                             "mnist_cnn_int8_wide.resident_b6", tmp_path)
    assert cell.config["layers"][0]["out_channels"] == 16
    assert cell.traffic["batch"] == 6
    assert cell.metrics == ["replays_traced"]
    out = harness.run_cell(cell, seed=3, seconds=0.05, trace=True,
                           device="cpu", root=tmp_path)
    assert out["correct"]
    assert out["metrics"]["replays_traced"]["value"] >= 2
    after = _digest(bench)
    assert all(after[k] == v for k, v in before.items())
