"""The yardstick's counts against the figures they were set from, and the
bound's arithmetic."""
import json
from pathlib import Path

import pytest

from chipbench import counts, harness

BENCH = Path(harness.__file__).resolve().parent


def _cfg(name):
    """A configuration of the benchmark, or the tests' highres fixture."""
    path = BENCH / "configs" / f"{name}.json"
    if not path.is_file():
        path = BENCH / "tests" / "data" / f"{name}.json"
    return json.loads(path.read_text())


@pytest.mark.parametrize("name,mop,macs", [
    ("mnist_cnn_int8", 1.57132, [91_260, 691_200, 3_200]),
    ("highres_cnn_int8", 120.582912,
     [29_040_000, 13_436_928, 12_460_032, 5_308_416, 46_080])])
def test_ops_per_image(name, mop, macs):
    cfg = _cfg(name)
    assert [s.macs for s in counts.stages(cfg)] == macs
    assert counts.ops_per_image(cfg) == round(mop * 1e6)


@pytest.mark.parametrize("name", ["mnist_cnn_int8", "highres_cnn_int8"])
def test_ops_agree_with_the_programs_model(name):
    cfg = _cfg(name)
    model = harness.build_model(cfg)
    assert counts.ops_per_image(cfg) == model.cfg.flops_per_image()


def test_bytes_are_the_least_work():
    s = counts.stages(_cfg("mnist_cnn_int8"))
    # conv1: 784 input codes, 15 x 13 x 13 pooled codes out, 135 weight
    # codes and 15 fp32 biases
    assert (s[0].in_bytes, s[0].out_bytes, s[0].weight_bytes) == \
        (784, 2535, 135 + 60)
    # fc: 320 codes in, 10 fp32 logits out, 3,200 weight codes, 10 biases
    assert (s[2].in_bytes, s[2].out_bytes, s[2].weight_bytes) == \
        (320, 40, 3200 + 40)


def test_bound_is_the_larger_of_bytes_and_operations():
    st = counts.Stage("conv_block", macs=10**6, in_bytes=100, out_bytes=100,
                      weight_bytes=0)
    by_ops = 2 * 10**6 * 8 / counts.INT8_OPS_PER_S
    by_bytes = 200 * 8 / counts.HBM_BYTES_PER_S
    assert counts.stage_bound_seconds(st, 8) == max(by_ops, by_bytes)
    cfg = _cfg("highres_cnn_int8")
    small, big = (counts.bound_seconds(cfg, b, "conv_block")
                  for b in (8, 64))
    assert 0 < small < big


def test_odd_conv_maps_are_refused():
    cfg = dict(_cfg("mnist_cnn_int8"), input=[1, 27, 27])
    with pytest.raises(ValueError, match="not even"):
        counts.stages(cfg)
