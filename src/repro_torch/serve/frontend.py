"""Serving front-end over both engines (DESIGN.md §11).

Port of ``repro.serve.frontend``:

* **``SchedulerCore``** — a bounded queue of ``ServeRequest`` with arrival
  timestamps (via the Clock seam, ``repro_torch.serve.clock``). A full
  queue refuses the submit with the typed ``QueueFullError``. Dispatch is
  earliest-deadline-first with FCFS among equal deadlines.
* **``LMAdapter``** / **``VisionAdapter``** — the facade each engine
  exposes: free lanes, inject, step, drain finished. The LM engine's
  free lanes are its free KV slots (injecting IS topping up the
  in-flight batch — continuous batching); the vision engine forms a
  fresh bucket every step.
* **``Frontend``** — the serving loop: drain completions, pick dispatches
  under the SLO top-up policy (hold a partial bucket while the earliest
  deadline still affords another step), run one engine step, account
  per-request latency into the engine's ``ServeStats``.
* **``OpenLoopDriver``** — replays a predetermined arrival schedule
  (e.g. a seeded Poisson process) against a front-end: submit what has
  arrived, step, and otherwise advance the clock to the next arrival.
  Under a ``VirtualClock`` with a configured ``step_cost_s`` this is a
  deterministic discrete-event simulation of the whole serving stack.
  A request's ``arrival_t`` is stamped when the driver submits it, which
  is between engine steps: on a wall clock the latency leaves out the
  wait of an arrival that fell due during a step, as the reference's does.
"""
from __future__ import annotations

import enum
import math
from dataclasses import dataclass, field
from typing import Any

from repro_torch.serve.clock import Clock, MonotonicClock
from repro_torch.serve.queue import QueueFullError
from repro_torch.serve.stats import ServeStats

__all__ = ["QueueFullError", "ServeRequestState", "ServeRequest",
           "SchedulerCore", "FrontendConfig", "Frontend",
           "LMAdapter", "VisionAdapter", "OpenLoopDriver"]


class ServeRequestState(enum.Enum):
    QUEUED = "queued"            # accepted into the front-end queue
    DISPATCHED = "dispatched"    # handed to the engine
    DONE = "done"                # result delivered


@dataclass
class ServeRequest:
    """One request-level unit of work flowing through the front-end."""

    rid: int
    payload: Any                     # token array (LM) | image (vision)
    arrival_t: float                 # clock timestamp at submit
    deadline_t: float                # math.inf when no SLO applies
    options: dict = field(default_factory=dict)   # e.g. max_new_tokens

    state: ServeRequestState = ServeRequestState.QUEUED
    dispatch_t: float | None = None
    finish_t: float | None = None
    result: Any = None

    @property
    def seq(self) -> int:
        """FCFS tiebreak among equal deadlines: rids are issued in
        arrival order."""
        return self.rid

    @property
    def latency_s(self) -> float | None:
        if self.finish_t is None:
            return None
        return self.finish_t - self.arrival_t

    @property
    def missed_deadline(self) -> bool:
        return self.finish_t is not None and self.finish_t > self.deadline_t


class SchedulerCore:
    """Bounded EDF+FCFS intake queue, shared by every engine adapter.

    Invariants: a submit either lands in the queue or raises
    ``QueueFullError`` — nothing is dropped after acceptance; ``pick``
    removes in exact ``(deadline, seq)`` order, so equal-deadline
    requests dispatch FCFS; ``requeue`` restores a request with its
    original seq, preserving its place in that order (evict-to-queue,
    not evict-to-drop).
    """

    def __init__(self, clock: Clock, max_queue: int | None = None):
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.clock = clock
        self.max_queue = max_queue
        self._q: list[ServeRequest] = []
        self._next_rid = 0

    def __len__(self) -> int:
        return len(self._q)

    def __bool__(self) -> bool:
        return bool(self._q)

    def submit(self, payload, deadline_t: float = math.inf,
               **options) -> ServeRequest:
        if self.max_queue is not None and len(self._q) >= self.max_queue:
            raise QueueFullError(len(self._q), self.max_queue)
        req = ServeRequest(rid=self._next_rid, payload=payload,
                           arrival_t=self.clock.now(),
                           deadline_t=deadline_t, options=dict(options))
        self._next_rid += 1
        self._q.append(req)
        return req

    def pick(self, k: int) -> list[ServeRequest]:
        """Remove and return up to ``k`` requests in (deadline, seq)
        order — EDF with FCFS among ties."""
        if k <= 0 or not self._q:
            return []
        order = sorted(self._q, key=lambda r: (r.deadline_t, r.seq))
        chosen = order[:k]
        keep = {id(r) for r in chosen}
        self._q = [r for r in self._q if id(r) not in keep]
        return chosen

    def requeue(self, requests: list[ServeRequest]) -> None:
        """Evict-to-queue: picked-but-uninjectable requests go back with
        their original seq (their dispatch order is unchanged)."""
        for r in requests:
            r.state = ServeRequestState.QUEUED
        self._q.extend(requests)

    def earliest_deadline_t(self) -> float:
        return min((r.deadline_t for r in self._q), default=math.inf)


# ---------------------------------------------------------------- adapters

class LMAdapter:
    """Facade over ``repro_torch.serve.engine.Engine``. Free lanes are
    free KV slots; injecting into one IS topping up the in-flight decode
    batch (continuous batching), so the front-end never holds LM
    requests."""

    kind = "lm"
    forms_buckets = False

    def __init__(self, engine):
        self.engine = engine
        self._rid_by_uid: dict[int, int] = {}
        self._drained = 0            # prefix of engine.finished consumed

    @property
    def stats(self) -> ServeStats:
        return self.engine.stats

    @property
    def preferred_batch(self) -> int:
        return self.engine.config.capacity

    def free_lanes(self) -> int:
        return self.engine.scheduler.free_slots

    def inject(self, req: ServeRequest) -> None:
        uid = self.engine.add_request(
            req.payload, req.options["max_new_tokens"],
            eos_token=req.options.get("eos_token"))
        self._rid_by_uid[uid] = req.rid

    def step(self) -> None:
        self.engine.step()

    def drain(self) -> list[tuple[int, Any]]:
        done = self.engine.finished[self._drained:]
        self._drained = len(self.engine.finished)
        return [(self._rid_by_uid.pop(r.uid), r) for r in done]

    def has_inflight(self) -> bool:
        return self.engine.scheduler.num_running > 0 or bool(self.engine.queue)


class VisionAdapter:
    """Facade over ``repro_torch.serve.vision.VisionEngine``. Every engine step
    forms one bucket-shaped batch, so the whole batch width is free each
    step — which is exactly why the top-up policy applies here: a
    dispatched partial batch pays pad lanes forever, a held one may fill."""

    kind = "vision"
    forms_buckets = True

    def __init__(self, engine):
        self.engine = engine
        self._rid_by_uid: dict[int, int] = {}

    @property
    def stats(self) -> ServeStats:
        return self.engine.stats

    @property
    def preferred_batch(self) -> int:
        return self.engine.config.batch

    def free_lanes(self) -> int:
        return self.engine.config.batch

    def inject(self, req: ServeRequest) -> None:
        uid = self.engine.submit(req.payload)
        self._rid_by_uid[uid] = req.rid

    def step(self) -> None:
        self.engine.step()

    def drain(self) -> list[tuple[int, Any]]:
        out = []
        for uid in [u for u in self._rid_by_uid if u in self.engine.results]:
            out.append((self._rid_by_uid.pop(uid),
                        self.engine.results.pop(uid)))
        return out

    def has_inflight(self) -> bool:
        return self.engine.has_work()


# ---------------------------------------------------------------- frontend

@dataclass(frozen=True)
class FrontendConfig:
    max_queue: int = 64              # intake bound (QueueFullError beyond)
    slo_s: float | None = None       # default per-request deadline budget
    topup: bool = True               # hold partial buckets for top-up
    # virtual service model: charge this much clock time per engine step
    # (VirtualClock tests/simulations). None = real time passes naturally.
    step_cost_s: float | None = None


class Frontend:
    """The unified serving loop: one intake, one SLO policy, any engine.

    ``submit`` timestamps and queues (or refuses — ``QueueFullError``);
    ``step`` drains completions, dispatches under the policy, and runs
    one engine step; ``run_until_drained`` serves everything queued.
    Request accounting (latency, misses, goodput window) lands in the
    engine's own ``ServeStats``, so one object describes the stack.
    """

    def __init__(self, adapter, config: FrontendConfig = FrontendConfig(),
                 clock: Clock | None = None):
        self.adapter = adapter
        self.config = config
        self.clock = clock if clock is not None else MonotonicClock()
        self.core = SchedulerCore(self.clock, config.max_queue)
        self.stats: ServeStats = adapter.stats
        self.results: dict[int, Any] = {}
        self.requests: dict[int, ServeRequest] = {}
        self._step_est: float | None = config.step_cost_s

    # ---------- intake ----------
    def submit(self, payload, *, slo_s: float | None = None,
               **options) -> int:
        """Queue one request; returns its rid. A full queue raises
        ``QueueFullError`` (after counting the rejection) — backpressure
        is the caller's signal, not the caller's hang."""
        budget = slo_s if slo_s is not None else self.config.slo_s
        deadline = math.inf if budget is None else self.clock.now() + budget
        try:
            req = self.core.submit(payload, deadline_t=deadline, **options)
        except QueueFullError:
            self.stats.rejected += 1
            raise
        self.stats.submitted += 1
        if self.stats.first_t is None:
            self.stats.first_t = req.arrival_t
        self.requests[req.rid] = req
        return req.rid

    # ---------- policy ----------
    def _should_hold(self, queued: int, flush: bool) -> bool:
        """Top-up policy: hold a partial bucket while waiting is safe.

        Only bucket-forming engines hold (the LM engine's free slots are
        refilled immediately — that IS the top-up). A partial bucket is
        held while the earliest queued deadline still affords dispatching
        one service step later (2× the step estimate of slack); ``flush``
        (no more arrivals are coming) always dispatches.
        """
        if flush or not self.config.topup:
            return False
        if not getattr(self.adapter, "forms_buckets", False):
            return False
        if queued >= self.adapter.preferred_batch:
            return False                     # full bucket: go
        est = self._step_est if self._step_est is not None else 0.0
        slack = self.core.earliest_deadline_t() - self.clock.now()
        return slack > 2.0 * est

    # ---------- serving ----------
    def _drain_finished(self) -> None:
        now = self.clock.now()
        for rid, result in self.adapter.drain():
            req = self.requests[rid]
            req.state = ServeRequestState.DONE
            req.finish_t = now
            req.result = result
            self.results[rid] = result
            self.stats.completed += 1
            self.stats.latencies.append(req.latency_s)
            if req.missed_deadline:
                self.stats.deadline_misses += 1
            self.stats.last_t = now

    def step(self, flush: bool = True) -> bool:
        """One scheduling iteration: drain, dispatch, engine step.
        Returns True if an engine step ran (False = held or idle).
        ``flush=False`` tells the policy more arrivals may come (open-loop
        drivers); the default serves everything it can immediately."""
        self._drain_finished()
        queued = len(self.core)
        if queued and not self._should_hold(queued, flush):
            picked = self.core.pick(
                min(queued, self.adapter.free_lanes()))
            back = []
            for req in picked:
                try:
                    self.adapter.inject(req)
                except QueueFullError:       # engine-side backpressure:
                    back.append(req)         # evict-to-queue, never drop
                    continue
                req.state = ServeRequestState.DISPATCHED
                req.dispatch_t = self.clock.now()
            if back:
                self.core.requeue(back)
        if not self.adapter.has_inflight():
            return False
        t0 = self.clock.now()
        self.adapter.step()
        if self.config.step_cost_s is not None:
            # virtual service model: the charge happens outside the
            # engine's own timed region, so credit it into the unified
            # stats here (real-clock runs leave step_cost_s None)
            self.clock.sleep(self.config.step_cost_s)
            self.stats.wall_s += self.config.step_cost_s
        dt = self.clock.now() - t0
        if dt > 0:                           # EWMA service-time estimate
            self._step_est = dt if self._step_est is None \
                else 0.5 * self._step_est + 0.5 * dt
        self._drain_finished()
        return True

    def run_until_drained(self, max_steps: int | None = None
                          ) -> dict[int, Any]:
        """Serve until queue and engine are empty; returns {rid: result}.
        A stalled adapter raises instead of spinning forever."""
        steps = 0
        while self.has_work():
            ran = self.step(flush=True)
            if not ran and self.has_work():
                raise RuntimeError(
                    "frontend stalled: work queued but the engine "
                    "dispatched nothing (adapter reports no free lanes "
                    "and nothing in flight)")
            steps += 1
            if max_steps is not None and steps > max_steps:
                raise RuntimeError(f"frontend exceeded max_steps="
                                   f"{max_steps} with work remaining")
        return self.results

    def has_work(self) -> bool:
        return bool(self.core) or self.adapter.has_inflight()


# ---------------------------------------------------------------- driver

class OpenLoopDriver:
    """Replay a fixed arrival schedule against a front-end (open loop:
    arrivals do not wait for completions).

    ``arrivals`` is a list of ``(t, payload, options)`` (clock-relative
    seconds), sorted stably by ``t``. Queue-full rejections are counted
    (typed, via ``ServeStats.rejected``) and the arrival is shed — open
    loop load does not retry. Returns the front-end's results dict.
    """

    def __init__(self, frontend: Frontend,
                 arrivals: list[tuple[float, Any, dict]]):
        self.frontend = frontend
        self.arrivals = sorted(arrivals, key=lambda a: a[0])
        self.shed: list[float] = []          # arrival times refused at intake

    def run(self, max_steps: int | None = None) -> dict[int, Any]:
        fe = self.frontend
        clock = fe.clock
        t_start = clock.now()
        i, n = 0, len(self.arrivals)
        steps = 0
        while i < n or fe.has_work():
            now = clock.now() - t_start
            while i < n and self.arrivals[i][0] <= now:
                t, payload, options = self.arrivals[i]
                try:
                    fe.submit(payload, **options)
                except QueueFullError:
                    self.shed.append(t)
                i += 1
            ran = fe.step(flush=(i == n))
            if not ran:
                if i < n:                    # idle: jump to the next arrival
                    clock.sleep(self.arrivals[i][0] - (clock.now() - t_start))
                elif fe.has_work():
                    raise RuntimeError("open-loop driver stalled with "
                                       "work remaining")
            steps += 1
            if max_steps is not None and steps > max_steps:
                raise RuntimeError(f"open-loop driver exceeded "
                                   f"max_steps={max_steps}")
        return fe.results
