"""Continuous-batching serve engine (DESIGN.md §6); port of
``repro.serve.engine``.

Composes the step factories (``make_prefill_step`` /
``make_decode_step``) into a prefill-then-decode loop over a fixed ring
of KV slots with in-flight batch refill:

    while queue or running:
        admit()    # prefill queued requests into free slots (batch 1,
                   #   scattered into the slot cache)
        decode()   # ONE batched decode step over all capacity lanes with
                   #   per-slot positions; finished slots freed and
                   #   refillable on the very next iteration

The decode step always runs at the full slot batch (inactive lanes carry
token 0 at position 0 and are ignored host-side), so its shapes are fixed
whatever the occupancy. Every step runs on ``EngineConfig.device``, the
card unless the caller asks for the CPU.

The steps are compiled as the reference's ``jax.jit`` compiles them
(``serve/graphs.py``): the decode step is one ``StepGraph`` over static
``tokens`` and ``pos`` (C,) buffers and the slot cache's own leaves,
which it writes in place (a state the model returns anew is copied into
them); each prompt length has its batch-1 prefill ``StepGraph`` over a
static (1, length) token buffer and a batch-1 cache, at most
``MAX_PREFILL_GRAPHS`` of them, the least recently used evicted (and
captured again when its length comes back). On the card every step is a
replay of its CUDA graph, all of an engine's graphs in one memory pool:
one runs at a time, so a replay may overwrite the pool memory another
graph's outputs live in. Only the sampled tokens live there, and the
engine reads them before it replays anything else; a prefill's cache is
a static buffer allocated outside the pool, written by its own graph
alone, and scattered into its slot right after that graph's replay. On
the CPU the same objects call the steps on the same buffers. The serving weights are cast
to the compute dtype once, at build (``serve/weights.py``).
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.ops import ExecPolicy
from repro_torch.serve.cache import (SlotKVCache, _quantize_leaves,
                                     dequantize_leaves)
from repro_torch.serve.clock import Clock, MonotonicClock
from repro_torch.serve.graphs import StepGraph, graph_launches, tree_tensors
from repro_torch.serve.queue import RequestQueue
from repro_torch.serve.request import Request
from repro_torch.serve.scheduler import Scheduler
from repro_torch.serve.stats import ServeStats
from repro_torch.serve.steps import make_decode_step, make_prefill_step
from repro_torch.serve.weights import cast_serving_params

__all__ = ["EngineConfig", "EngineStats", "Engine", "MAX_PREFILL_GRAPHS",
           "engine_decode_step"]

# prefill graphs an engine holds at once, one a prompt length (the
# reference's jit keeps one executable a length, unbounded)
MAX_PREFILL_GRAPHS = 8


@dataclass(frozen=True)
class EngineConfig:
    capacity: int = 8                 # KV slots == max in-flight sequences
    max_seq: int = 256                # per-slot sequence budget
    kv_quant: str | None = None       # "none" | "int8"; None → from policy
    eos_token: int | None = None
    # bound on the engine's internal admission queue: add_request raises
    # the typed QueueFullError beyond it (backpressure, DESIGN.md §11).
    # None = unbounded (the front-end does its own bounding).
    max_queue: int | None = None
    # compute policy active around prefill/decode (repro_torch.ops,
    # DESIGN.md §7): backend preference, compute quant, tiling overrides
    policy: ExecPolicy = field(default_factory=ExecPolicy)
    device: str = DEFAULT_DEVICE
    # on the card each step replays its CUDA graph; False runs the same
    # steps eagerly on the same static buffers (the reference under
    # jax.disable_jit), for comparisons: never a fallback
    graphs: bool = True

    @property
    def cache_quant(self) -> str:
        """KV-cache storage quant: an explicit ``kv_quant`` wins;
        otherwise an int8 compute policy also stores the cache in int8."""
        if self.kv_quant is not None:
            return self.kv_quant
        return "int8" if self.policy.quant == "int8" else "none"


@dataclass
class EngineStats(ServeStats):
    """LM view of ``ServeStats`` (DESIGN.md §11): ``items`` counts tokens
    (prompt tokens prefilled + tokens decoded), ``lane_steps`` counts
    active decode lanes (== decode tokens), ``pad_lanes`` idle slots in
    issued decode steps."""

    prefills: int = 0
    prefill_tokens: int = 0

    @property
    def decode_tokens(self) -> int:
        """Tokens produced by active lanes == real decode lanes issued."""
        return self.lane_steps

    @property
    def decode_lane_steps(self) -> int:
        """capacity × decode steps (work issued, live or idle)."""
        return self.lane_steps + self.pad_lanes

    @property
    def tokens_per_s(self) -> float:
        return self.items_per_s

    @property
    def decode_utilization(self) -> float:
        """Fraction of issued decode lanes that produced a kept token."""
        return self.lane_utilization


def engine_decode_step(model, config: EngineConfig, ctx=None,
                       sample: bool = True):
    """The engine's decode step over its cache state: (params, tokens,
    pos, *state) -> (next tokens, or logits without ``sample``; *the new
    state). Under an int8 cache the state is (codes, scales) and the
    whole cache round-trips through the model dtype every step, in the
    reference's order; otherwise it is the model's cache tree."""
    decode = make_decode_step(model, ctx, sample=sample,
                              policy=config.policy)
    if config.cache_quant != "int8":
        return decode
    dtype = model.cfg.dtype

    def decode_int8(params, tokens, pos, codes, scales):
        cache = dequantize_leaves(codes, scales, dtype)
        out, cache = decode(params, tokens, pos, cache)
        codes, scales = _quantize_leaves(cache)
        return out, codes, scales

    return decode_int8


def _decode_static(decode, kv: SlotKVCache):
    """The decode step over the static buffers: the next tokens, the new
    cache written into the slot cache's own leaves."""

    def step(params, tokens, pos, state):
        out = decode(params, tokens, pos, *state)
        kv.set_device_state(*out[1:])
        return out[0]

    return step


def _prefill_static(prefill):
    """A batch-1 prefill over the static buffers, from a zero cache
    (``init_cache``'s), which it fills in place."""

    def step(params, tokens, cache):
        for leaf in tree_tensors(cache):
            leaf.zero_()
        return prefill(params, {"tokens": tokens}, cache)[0]

    return step


class Engine:
    """Continuous-batching engine over one model + params.

    The model exposes the cache protocol: ``init_cache(batch, max_seq,
    device=)`` (batch at leaf axis 1, all zeros), ``prefill``, and a
    ``decode_step`` taking per-row (B,) positions. ``donate``: the caller
    hands ``params`` over (the reference's ``donate_argnums``), and the
    engine empties it as it moves and casts the weights.
    """

    def __init__(self, model, params: Any,
                 config: EngineConfig = EngineConfig(), ctx=None,
                 clock: Clock | None = None, *, donate: bool = False):
        self.model = model
        self.config = config
        self.device = resolve_device(config.device)
        self.params = cast_serving_params(model, params, self.device,
                                          donate=donate)
        self.clock = clock if clock is not None else MonotonicClock()
        self.queue = RequestQueue(maxlen=config.max_queue)
        self.scheduler = Scheduler(config.capacity)
        self.kv = SlotKVCache(model, config.capacity, config.max_seq,
                              quant=config.cache_quant, device=self.device)
        self.stats = EngineStats()
        self.finished: list[Request] = []
        self._uid = 0
        self._last_token = np.zeros((config.capacity,), np.int32)

        self._prefill = make_prefill_step(model, ctx, policy=config.policy)
        self._decode = engine_decode_step(model, config, ctx)

        # the compiled steps (serve/graphs.py): one pool for all of them
        self._pool = torch.cuda.graph_pool_handle() \
            if self.device.type == "cuda" else None
        self._tokens = torch.zeros((config.capacity,), dtype=torch.int32,
                                   device=self.device)
        self._pos = torch.zeros((config.capacity,), dtype=torch.int32,
                                device=self.device)
        # the step functions close over what they run, not the engine:
        # no reference cycle keeps a dropped engine's graphs alive
        self._decode_static = _decode_static(self._decode, self.kv)
        self._prefill_static = _prefill_static(self._prefill)
        state = self.kv.device_state()
        self._decode_graph = StepGraph(
            self._decode_static,
            {"params": self.params, "tokens": self._tokens,
             "pos": self._pos, "state": state},
            state=state, device=self.device, pool=self._pool,
            policy=config.policy, compiled=config.graphs, name="decode")
        self._prefill_graphs: OrderedDict[int, StepGraph] = OrderedDict()
        self.evicted: list[StepGraph] = []      # their calls still count
        self.captures: dict[int, int] = {}      # prompt length -> builds

    def _prefill_graph(self, length: int) -> StepGraph:
        """The prefill graph of ``length``, built (on the card: captured
        at its first call) if it is not held, the least recently used one
        evicted past MAX_PREFILL_GRAPHS."""
        graph = self._prefill_graphs.get(length)
        if graph is not None:
            self._prefill_graphs.move_to_end(length)
            return graph
        while len(self._prefill_graphs) >= MAX_PREFILL_GRAPHS:
            _, old = self._prefill_graphs.popitem(last=False)
            old.release()
            self.evicted.append(old)
        graph = self._prefill_graphs[length] = self._new_prefill(length)
        return graph

    def _new_prefill(self, length: int) -> StepGraph:
        """A prefill graph of ``length`` over fresh static buffers."""
        self.captures[length] = self.captures.get(length, 0) + 1
        return StepGraph(
            self._prefill_static,
            {"params": self.params,
             "tokens": torch.zeros((1, length), dtype=torch.int32,
                                   device=self.device),
             "cache": self.model.init_cache(1, length, device=self.device)},
            device=self.device, pool=self._pool, policy=self.config.policy,
            compiled=self.config.graphs, name=f"prefill[{length}]")

    def graphs(self) -> list[StepGraph]:
        """Every step graph the engine has built, evicted ones included."""
        return [self._decode_graph, *self.evicted,
                *self._prefill_graphs.values()]

    def graph_launches(self) -> dict[str, int]:
        """Kernel launches the engine's graph replays made: each graph's
        captured launches × its replays."""
        return graph_launches(self.graphs())

    # ---------- request intake ----------
    def add_request(self, prompt, max_new_tokens: int,
                    eos_token: int | None = None) -> int:
        uid = self._uid
        self._uid += 1
        req = Request(uid=uid, prompt=np.asarray(prompt, np.int32),
                      max_new_tokens=max_new_tokens,
                      eos_token=(self.config.eos_token
                                 if eos_token is None else eos_token))
        req.enqueue_step = self.stats.steps
        self.queue.add(req)
        return uid

    # ---------- phases ----------
    def warm_prefill(self, length: int) -> None:
        """Compile the batch-1 prefill of ``length`` tokens (the
        reference's "compile and discard"): on the card its graph is
        captured now, so a timed region pays no first-call cost. Nothing
        is replayed and no slot is written."""
        graph = self._prefill_graph(length)
        if graph.compiled and not graph.captured:
            graph.capture()

    def warm_decode(self) -> None:
        """Capture the decode step's graph now (on the card; the slot
        cache is put back as it was)."""
        if self._decode_graph.compiled and not self._decode_graph.captured:
            self._decode_graph.capture()

    def _admit(self) -> None:
        admitted = self.scheduler.admit(self.queue,
                                        max_prompt_len=self.config.max_seq)
        for req in self.scheduler.drain_rejected():
            req.finish_step = self.stats.steps
            self.finished.append(req)
        for req in admitted:
            req.admit_step = self.stats.steps
            p = req.prompt_len
            graph = self._prefill_graph(p)
            tok = graph(tokens=torch.from_numpy(req.prompt[None, :]))
            # read the replay's outputs before any other replay
            self.kv.write_prefill(req.slot, graph.inputs["cache"], p)
            first = int(tok[0])
            req.generated.append(first)
            self._last_token[req.slot] = first
            self.stats.prefills += 1
            self.stats.prefill_tokens += p
            self.stats.items += p
            self._maybe_finish(req.slot)

    def _decode_all(self) -> None:
        if self.scheduler.num_running == 0:
            return
        tok = self._decode_graph(tokens=torch.from_numpy(self._last_token),
                                 pos=torch.from_numpy(self.kv.positions()))
        tok_host = tok.cpu().numpy()
        active = self.scheduler.num_running
        self.stats.lane_steps += active                      # kept tokens
        self.stats.pad_lanes += self.config.capacity - active  # idle slots
        self.stats.items += active
        for slot, req in self.scheduler.running().items():
            t = int(tok_host[slot])
            req.generated.append(t)
            self._last_token[slot] = t
            self.kv.advance(slot)
            self._maybe_finish(slot)

    def _maybe_finish(self, slot: int) -> None:
        req = self.scheduler.request_in(slot)
        if req is None:
            return
        # slot budget: the next decode would write past max_seq — evict
        if not req.is_done() and self.kv.remaining(slot) <= 0:
            req.truncated = True
        if req.is_done():
            req.finish_step = self.stats.steps
            self.kv.free(slot)
            self._last_token[slot] = 0
            self.finished.append(self.scheduler.evict(slot))

    # ---------- driving ----------
    def step(self) -> int:
        """One engine iteration: admit into free slots, then one batched
        decode step. Returns the number of requests finished so far."""
        t0 = self.clock.now()
        self._admit()
        # occupancy of the decode about to run — recorded before the
        # decode's own evictions so finished-this-step slots still count
        self.scheduler.tick()
        self._decode_all()
        self.stats.steps += 1
        self.stats.wall_s += self.clock.now() - t0
        return len(self.finished)

    def run(self) -> list[Request]:
        """Drain the queue completely; returns all finished requests in
        finish order."""
        while self.queue or self.scheduler.num_running:
            self.step()
        return self.finished

    def has_work(self) -> bool:
        return bool(self.queue) or self.scheduler.num_running > 0
