"""The harness driven through whole runs on the CPU, past its look for a
card: sound runs come out correct; the control (the reference in the
4-bit format put in the program's place) and a timed path broken
underneath come out not correct. Also the command's refusals."""
import json
import subprocess
import sys

import pytest
import torch

from chipbench import harness, run

SMALL = {"mnist_cnn_int8.resident_b4096": dict(batch=8, ring=2),
         "mnist_cnn_int8.resident_b64": dict(batch=4, ring=3),
         "highres_cnn_int8.resident_b64": dict(batch=2, ring=2)}
DATA = harness.HERE / "tests" / "data"


def _cell(name, **over):
    """A cell of the manifest, or a study's pair of a configuration (of
    the manifest or the tests' fixtures) and a traffic file, built as an
    explicit ``Cell``; ``over`` shrinks its traffic."""
    manifest = harness.load_manifest()
    if any(w["name"] == name for w in manifest["workloads"]):
        cell = harness.find_cell(manifest, name)
    else:
        config, traffic = name.split(".")
        cfg = harness.HERE / "configs" / f"{config}.json"
        cell = harness.Cell(
            name=name,
            config=json.loads((cfg if cfg.is_file()
                               else DATA / f"{config}.json").read_text()),
            traffic=json.loads((harness.HERE / "traffic"
                                / f"{traffic}.json").read_text()))
    cell.traffic = dict(cell.traffic, **over)
    return cell


def _run(cell, **kw):
    kw.setdefault("seed", 2**31 + 17)
    return harness.run_cell(cell, seconds=0.1, trace=False, device="cpu",
                            **kw)


@pytest.mark.parametrize("name", sorted(SMALL))
def test_a_sound_run_is_correct(name):
    out = _run(_cell(name, **SMALL[name]))
    assert out["correct"] and out["failed"] == 0
    assert out["check"]["logit_gap"] == {"value": 0.0, "limit": 0.0}
    assert list(out)[-1] == "check"
    assert set(out["metrics"]) == {"images_per_s", "setup_s"}


def test_a_traced_run_reports_per_layer_metrics():
    out = harness.run_cell(_cell("mnist_cnn_int8.resident_b4096",
                                 batch=8, ring=2),
                           seed=5, seconds=0.1, trace=True, device="cpu")
    assert out["correct"]
    # the CPU has no device trace: the readers of device metrics find
    # nothing and their metrics are left out
    assert set(out["metrics"]) == {"host_us_per_replay", "mfu"}
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert out["device"]["window_s"] > 0


def test_the_control_is_not_correct():
    out = _run(_cell("mnist_cnn_int8.resident_b4096", batch=8, ring=2),
               control=True)
    assert not out["correct"]
    assert out["check"]["logit_gap"]["value"] > 1e-3
    assert out["failed"] == out["check"]["rows_off"]["value"] > 0


class _Stale(harness.EagerReplay):
    """A replay that computes once and then returns its state unchanged."""

    def run(self, batch):
        if self.out is None:
            return super().run(batch)
        return self.out


class _HalfBatch(harness.EagerReplay):
    """A replay that leaves the second half of the batch out."""

    def run(self, batch):
        k = batch.shape[0] // 2
        self.out = torch.zeros(batch.shape[0], 10)
        self.out[:k] = self.bound(batch[:k])
        return self.out


class _Altered(harness.EagerReplay):
    """A replay whose answer is altered where it is produced: one logit
    of the first image moves by one step of its last bit."""

    def run(self, batch):
        out = super().run(batch).clone()
        out[0, 0] = torch.nextafter(out[0, 0], torch.tensor(float("inf")))
        self.out = out
        return out


@pytest.mark.parametrize("fault", [_Stale, _HalfBatch, _Altered],
                         ids=lambda f: f.__name__.strip("_"))
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    monkeypatch.setattr(harness, "capture", fault)
    out = _run(_cell("mnist_cnn_int8.resident_b4096", batch=8, ring=2))
    assert not out["correct"]
    assert out["failed"] > 0


@pytest.mark.parametrize("control", [False, True])
def test_served_closed_loop(control):
    cell = _cell("mnist_cnn_int8.served_closed_b64", clients=8, batch=4,
                 pool=16, warmup_s=0.05)
    out = harness.run_cell(cell, seed=9, seconds=1.0, trace=False,
                           device="cpu", control=control)
    assert out["correct"] is not control, out
    assert out["metrics"]["images_per_s"]["value"] > 0
    assert out["metrics"]["latency_p95_ms"]["value"] > 0


def test_open_loop_schedule_is_seeded_and_bursts_keep_the_mean():
    from chipbench import served
    t = {"rate": 2000.0}
    a = served.schedule(t, 2**31 + 3, 5.0)
    assert a == served.schedule(t, 2**31 + 3, 5.0)
    assert all(0 <= x < 5.0 for x in a) and a == sorted(a)
    assert abs(len(a) / 5.0 - 2000) < 150
    burst = dict(t, burst={"period_s": 0.1, "duty": 0.2, "factor": 5.0})
    b = served.schedule(burst, 7, 5.0)
    assert abs(len(b) / 5.0 - 2000) < 200
    inside = sum(1 for x in b if x % 0.1 < 0.02)
    assert inside > 2.5 * (len(b) - inside) * 0.2 / 0.8


def test_only_listed_cells_resolve():
    with pytest.raises(KeyError, match="no workload"):
        harness.find_cell(harness.load_manifest(),
                          "mnist_cnn_int8.served_closed_b64")


class _Clock:
    """A clock that a step advances: ``dt(n)`` seconds for step ``n``."""

    def __init__(self, dt):
        self.t, self.dt = 0.0, dt

    def perf_counter(self):
        return self.t

    def step(self, n):
        self.t += self.dt(n)


@pytest.mark.parametrize("rise_at,waited", [(5000, (6.0, 8.0)),
                                             (2500, (4.0, 6.0)),
                                             (None, (110.0, 110.1))])
def test_the_window_waits_for_the_steady_rate(rise_at, waited,
                                              monkeypatch):
    """The wait ends two seconds after the rate rises by 3%, also where it
    rises among the first seconds, or once the context is 120 s old where
    it never rises (here it was 10 s old when the wait began)."""
    clock = _Clock(lambda n: 1e-3 / 1.03 if rise_at and n >= rise_at
                   else 1e-3)
    monkeypatch.setattr(harness, "time", clock)
    n = harness.await_steady(clock.step, 1, t_context=-10.0)
    assert waited[0] <= clock.t <= waited[1]
    # the index of the next step: one a millisecond, or a little more
    assert 1000 * clock.t <= n <= 1030 * clock.t + 2


def test_one_slow_second_is_no_step(monkeypatch):
    """A second 2% slow, then the rate as before: no rise."""
    clock = _Clock(lambda n: 1.02e-3 if 10_000 <= n < 11_000 else 1e-3)
    monkeypatch.setattr(harness, "time", clock)
    harness.await_steady(clock.step, 1, t_context=0.0, max_age=30.0)
    assert clock.t >= 30.0


def test_a_noisy_rate_does_not_open_the_window(monkeypatch):
    clock = _Clock(lambda n: 1e-3 * (1.005 if n // 700 % 2 else 0.995))
    monkeypatch.setattr(harness, "time", clock)
    harness.await_steady(clock.step, 1, t_context=0.0, max_age=20.0)
    assert clock.t >= 20.0


def test_banned_modules_compare_top_level_names_whole():
    assert run.banned_modules(["repro_torch", "repro_torch.serve", "torch",
                               "jaxtyping", "reprox"]) == []
    assert run.banned_modules(["repro.core", "jax.numpy", "flax",
                               "jaxlib"]) == ["flax", "jax", "jaxlib",
                                              "repro"]


def test_the_command_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    proc = subprocess.run(
        [sys.executable, str(harness.HERE / "run.py"), "--workload",
         "mnist_cnn_int8.resident_b64", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=harness.ROOT)
    assert proc.returncode != 0
    assert proc.stdout == ""


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
def test_a_short_run_on_the_card_is_correct(card):
    proc = subprocess.run(
        [sys.executable, str(harness.HERE / "run.py"), "--workload",
         "mnist_cnn_int8.resident_b64", "--seed", "2147483659",
         "--seconds", "1", "--trace", "1"], capture_output=True, text=True,
        timeout=1200, cwd=harness.ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"]
    assert out["device"]["busy_s"] > 0
