"""Served traffic: requests through the program's serving stack,
``repro_torch.serve``'s ``Frontend`` over ``VisionAdapter`` over
``VisionEngine``, on the wall clock.

Two kinds, each a traffic file's ``kind``:

* ``served_closed``: ``clients`` callers, each with one request
  outstanding, sending the next the moment the last completes;
* ``served_open``: arrivals on a seeded schedule (Poisson at ``rate`` a
  second, optionally modulated into bursts), sent whether or not earlier
  ones completed; a request the front-end's full queue refuses is shed and
  counts as failed.

Every request is timed from its scheduled send, not from the moment the
front-end stamped it, so a request that fell due during an engine step
carries that wait. Images are made on the card from the seed and copied
to the host once, as the payloads a client sends. The logits of a seeded
sample of the served batches are held to the reference, each batch as the
engine ran it (the activation scales are the padded batch's own).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from chipbench import harness

__all__ = ["open_loop_schedule", "schedule", "percentile", "Recorder",
           "run"]

# seconds of the mix driven under the profiler after the window
TRACE_S = 1.0


def open_loop_schedule(seed: int, n: int, rate: float) -> list[float]:
    """``n`` Poisson arrival times at ``rate`` a second."""
    rng = np.random.RandomState(seed)
    return [float(t) for t in np.cumsum(rng.exponential(1.0 / rate, size=n))]


def schedule(traffic: dict, seed: int, seconds: float) -> list[float]:
    """The arrival times of an open-loop mix inside [0, seconds). With
    ``burst`` ({"period_s", "duty", "factor"}) the Poisson process at the
    mean ``rate`` is thinned into bursts: the first ``duty`` of every
    period runs ``factor`` times the rate of the rest."""
    rate = float(traffic["rate"])
    burst = traffic.get("burst")
    peak = rate
    if burst:
        duty, factor = float(burst["duty"]), float(burst["factor"])
        low = rate / (duty * factor + 1.0 - duty)
        peak = low * factor
    n = int(peak * seconds * 1.5) + 16
    times = [t for t in open_loop_schedule(seed % 2**32, n, peak)
             if t < seconds]
    if not burst:
        return times
    keep = np.random.RandomState((seed + 1) % 2**32).random_sample(len(times))
    period = float(burst["period_s"])
    return [t for t, u in zip(times, keep)
            if (t % period) < duty * period or u < 1.0 / factor]


def percentile(values: list[float], q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]); 0.0 for no values."""
    if not values:
        return 0.0
    ordered = sorted(values)
    rank = max(1, -(-len(ordered) * q // 100))
    return ordered[int(rank) - 1]


class Recorder:
    """The ``VisionAdapter`` as the front-end sees it, recording which
    requests each engine step served and which the front-end drained."""

    kind = "vision"
    forms_buckets = True

    def __init__(self, adapter):
        self.adapter = adapter
        self.pending: list[int] = []
        self.batches: list[list[int]] = []
        self.finished: list[int] = []

    @property
    def stats(self):
        return self.adapter.stats

    @property
    def preferred_batch(self) -> int:
        return self.adapter.preferred_batch

    def free_lanes(self) -> int:
        return self.adapter.free_lanes()

    def inject(self, req) -> None:
        self.adapter.inject(req)
        self.pending.append(req.rid)

    def step(self) -> None:
        if self.pending:
            self.batches.append(self.pending)
            self.pending = []
        with torch.profiler.record_function("engine.step"):
            self.adapter.step()

    def drain(self):
        out = self.adapter.drain()
        self.finished += [rid for rid, _ in out]
        return out

    def has_inflight(self) -> bool:
        return self.adapter.has_inflight()


class _Load:
    """One stretch of offered load and what became of it."""

    def __init__(self, fe, rec, pool: int, t0: float):
        self.fe, self.rec, self.pool, self.t0 = fe, rec, pool, t0
        self.due: dict[int, float] = {}      # rid -> scheduled send
        self.image: dict[int, int] = {}      # rid -> pool index
        self.latency: dict[int, float] = {}  # rid -> seconds from due
        self.shed = 0
        self.late: list[float] = []          # send lateness, open loop
        self.sent = 0

    def send(self, payloads, due: float) -> int | None:
        from repro_torch.serve import QueueFullError
        idx = self.sent % self.pool
        self.sent += 1
        try:
            rid = self.fe.submit(payloads[idx])
        except QueueFullError:
            self.shed += 1
            return None
        self.due[rid], self.image[rid] = due, idx
        return rid

    def collect(self) -> list[int]:
        done = self.rec.finished
        self.rec.finished = []
        for rid in done:
            self.latency[rid] = self.fe.requests[rid].finish_t - self.due[rid]
        return done


def _drive(kind, traffic, fe, rec, payloads, seconds, seed) -> tuple:
    """Offer the mix for ``seconds``, then serve what is left. Returns
    (the load, the window's length, images completed inside it)."""
    clock = fe.clock
    t0 = clock.now()
    load = _Load(fe, rec, len(payloads), t0)
    end = t0 + seconds
    in_window = 0
    if kind == "served_closed":
        for _ in range(int(traffic["clients"])):
            load.send(payloads, t0)
        while clock.now() < end:
            with torch.profiler.record_function("frontend.step"):
                fe.step(flush=True)
            now = clock.now()
            for _ in load.collect():
                in_window += now < end
                if now < end:
                    load.send(payloads, now)
    else:
        arrivals = schedule(traffic, seed, seconds)
        i = 0
        while i < len(arrivals) or clock.now() < end:
            now = clock.now()
            while i < len(arrivals) and t0 + arrivals[i] <= now:
                load.late.append(now - (t0 + arrivals[i]))
                load.send(payloads, t0 + arrivals[i])
                i += 1
            with torch.profiler.record_function("frontend.step"):
                ran = fe.step(flush=False)
            in_window += sum(clock.now() < end for _ in load.collect())
            if not ran and i < len(arrivals):
                clock.sleep(t0 + arrivals[i] - clock.now())
            elif not ran and i == len(arrivals):
                clock.sleep(max(0.0, min(end - clock.now(), 1e-3)))
    window_s = clock.now() - t0
    fe.run_until_drained()
    load.collect()
    return load, window_s, in_window


def run(cell, *, seed, seconds, trace, device, t_process, control,
        root) -> dict:
    from repro_torch.serve import (Frontend, FrontendConfig, VisionAdapter,
                                   VisionEngine, VisionEngineConfig)
    cfg, trf = cell.config, cell.traffic
    kind = trf["kind"]
    gen = torch.Generator(device=device).manual_seed(seed)
    params = harness.make_params(cfg, gen, device)
    pool = harness.make_images(cfg, gen, 1, int(trf["pool"]), device)[0]
    payloads = list(pool.cpu().numpy())
    buckets = trf.get("buckets")
    engine = VisionEngine(
        harness.build_model(cfg), params,
        VisionEngineConfig(batch=int(trf["batch"]),
                           policy=harness.policy(cfg), fuse=cfg["fuse"],
                           buckets=buckets, device=str(device),
                           autotune=cfg["autotune"]))
    rec = Recorder(VisionAdapter(engine))
    fe = Frontend(rec, FrontendConfig(max_queue=int(trf["max_queue"]),
                                      topup=bool(trf.get("topup", True))))
    harness.sync(device)
    # set-up ends at boot, which built and captured every bucket
    setup_s = time.perf_counter() - t_process
    # warm-up: the mix itself, briefly
    _drive(kind, trf, fe, rec, payloads, float(trf["warmup_s"]), seed)
    harness.sync(device)
    rec.batches.clear()
    load, window_s, images = _drive(kind, trf, fe, rec, payloads, seconds,
                                    seed)
    batches = list(rec.batches)
    out = {"correct": False, "attempted": load.sent, "failed": 0}
    lat = list(load.latency.values())
    metrics = {
        "images_per_s": {"value": images / window_s, "unit": "images/s"},
        "setup_s": {"value": setup_s, "unit": "s"},
        "latency_p50_ms": {"value": 1e3 * percentile(lat, 50), "unit": "ms"},
        "latency_p95_ms": {"value": 1e3 * percentile(lat, 95), "unit": "ms"},
        "latency_p99_ms": {"value": 1e3 * percentile(lat, 99), "unit": "ms"},
        "mean_batch": {"value": (sum(map(len, batches)) / len(batches)
                                 if batches else 0.0), "unit": "images"}}
    if load.late:
        metrics["send_late_max_ms"] = {"value": 1e3 * max(load.late),
                                       "unit": "ms"}
    dev = harness.device_doc(device, cell.chips)
    if trace:
        from chipbench.trace import profile
        stretch = {}

        def drive():
            stretch["load"] = _drive(kind, trf, fe, rec, payloads,
                                     TRACE_S, seed + 1)

        tr = profile(drive, device, root / harness.TRACE_DIR
                     / f"{cell.name}.json", host=True)
        metrics.update(host_split(tr))
        ctx = harness.Context(cfg, trf, int(trf["batch"]), trace=tr)
        idle = harness.load_metric("device_idle_share", root).read(ctx)
        if idle is not None:
            metrics["device_idle_share"] = {"value": idle, "unit": "%"}
        dev["busy_s"], dev["window_s"] = tr.busy_s, tr.window_s
        out["breakdown"] = tr.breakdown()
    check, off = _check(cfg, params, pool, engine, fe, load, batches, seed,
                        control)
    out["failed"] = load.shed + (load.sent - load.shed - len(lat)) + off
    out["correct"] = all(c["value"] <= c["limit"] for c in check.values())
    out["metrics"] = metrics
    out["device"] = dev
    out["check"] = check
    return out


def host_split(tr) -> dict:
    """Host seconds of the traced stretch by what the serving stack was
    doing: copying the batch in (the static input's ``copy_`` and the pad
    lanes' ``zero_``), launching the graph, copying the logits out (which
    waits for the device), the rest of ``VisionEngine.step`` (``np.stack``
    and its Python), the front-end around it, and the sending loop
    outside."""
    host = tr.host_ops

    def spans(name):
        return [o for o in host if o.name == name]

    def inside(o, outer):
        return any(p.ts <= o.ts and o.ts + o.dur <= p.ts + p.dur
                   for p in outer)

    def total(ops):
        return sum(o.dur for o in ops) * 1e-6

    fronts = spans("frontend.step")
    steps = [o for o in spans("engine.step") if inside(o, fronts)]
    to_copy = [o for o in spans("aten::_to_copy") if inside(o, steps)]
    h2d = [o for o in spans("aten::copy_")
           if inside(o, steps) and not inside(o, to_copy)]
    zero = [o for o in spans("aten::zero_") if inside(o, steps)]
    launch = [o for o in spans("cudaGraphLaunch") if inside(o, steps)]
    parts = {"h2d": total(h2d), "pad_zero": total(zero),
             "replay_launch": total(launch), "d2h_and_wait": total(to_copy)}
    parts["stack_and_engine_python"] = total(steps) - sum(parts.values())
    parts["frontend"] = total(fronts) - total(steps)
    parts["sender"] = tr.window_s - total(fronts)
    n = max(1, len(steps))
    out = {f"host_ms_per_step.{k}": {"value": 1e3 * v / n, "unit": "ms"}
           for k, v in parts.items()}
    out["engine_steps_traced"] = {"value": len(steps), "unit": "steps"}
    return out


CHECK_BATCHES = 32


def _check(cfg, params, pool, engine, fe, load, batches, seed, control):
    """A seeded sample of the window's batches, the largest among them,
    each rerun by the reference as the engine ran it (zero pad lanes up
    to its bucket) and compared row by row with the served logits."""
    rng = np.random.RandomState((seed + 2) % 2**32)
    picked = set()
    if batches:
        picked.add(max(range(len(batches)), key=lambda i: len(batches[i])))
        extra = rng.permutation(len(batches))[:CHECK_BATCHES - 1]
        picked.update(int(i) for i in extra)
    gap, off = 0.0, 0
    for i in sorted(picked):
        if any(r not in fe.results for r in batches[i]):
            continue            # never answered: the caller counts it
        k = len(batches[i])
        bucket = engine._bucket_for(k)
        x = torch.zeros((bucket, *cfg["input"]), device=pool.device)
        x[:k] = pool[[load.image[r] for r in batches[i]]]
        want = harness.reference_logits(params, x, cfg, 8)[:k]
        got = (harness.reference_logits(params, x, cfg, 4)[:k] if control
               else torch.as_tensor(np.stack([fe.results[r]["logits"]
                                              for r in batches[i]]),
                                    device=pool.device))
        c = harness.compare_logits(got, want)
        gap, off = max(gap, c["gap"]), off + c["rows_off"]
    return ({"logit_gap": {"value": gap, "limit": harness.LOGIT_GAP_LIMIT},
             "rows_off": {"value": off, "limit": 0}}, off)
