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
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.ops import ExecPolicy
from repro_torch.serve.cache import (SlotKVCache, _quantize_leaves,
                                     _tree_map, dequantize_leaves)
from repro_torch.serve.clock import Clock, MonotonicClock
from repro_torch.serve.queue import RequestQueue
from repro_torch.serve.request import Request
from repro_torch.serve.scheduler import Scheduler
from repro_torch.serve.stats import ServeStats
from repro_torch.serve.steps import make_decode_step, make_prefill_step

__all__ = ["EngineConfig", "EngineStats", "Engine"]


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


class Engine:
    """Continuous-batching engine over one model + params.

    The model exposes the cache protocol: ``init_cache(batch, max_seq,
    device=)`` (batch at leaf axis 1), ``prefill``, and a
    ``decode_step`` taking per-row (B,) positions.
    """

    def __init__(self, model, params: Any,
                 config: EngineConfig = EngineConfig(), ctx=None,
                 clock: Clock | None = None):
        self.model = model
        self.config = config
        self.device = resolve_device(config.device)
        self.params = _tree_map(lambda t: t.to(self.device), params)
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
        decode = make_decode_step(model, ctx, policy=config.policy)
        if config.cache_quant == "int8":
            dtype = model.cfg.dtype

            def decode_int8(params, tokens, pos, codes, scales):
                # the whole cache round-trips through the model dtype
                # every step, in the reference's order
                cache = dequantize_leaves(codes, scales, dtype)
                tok, cache = decode(params, tokens, pos, cache)
                codes, scales = _quantize_leaves(cache)
                return tok, codes, scales

            self._decode = decode_int8
        else:
            self._decode = decode

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
        """Run (and discard) one batch-1 prefill of ``length`` tokens, so
        a timed region pays no first-call cost (the kernel build on the
        card)."""
        cache0 = self.model.init_cache(1, length, device=self.device)
        tok, _ = self._prefill(
            self.params,
            {"tokens": torch.zeros((1, length), dtype=torch.int32,
                                   device=self.device)}, cache0)
        tok.cpu()

    def _admit(self) -> None:
        admitted = self.scheduler.admit(self.queue,
                                        max_prompt_len=self.config.max_seq)
        for req in self.scheduler.drain_rejected():
            req.finish_step = self.stats.steps
            self.finished.append(req)
        for req in admitted:
            req.admit_step = self.stats.steps
            p = req.prompt_len
            cache0 = self.model.init_cache(1, p, device=self.device)
            tok, cache0 = self._prefill(
                self.params,
                {"tokens": torch.as_tensor(req.prompt[None, :],
                                           device=self.device)}, cache0)
            self.kv.write_prefill(req.slot, cache0, p)
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
        tokens = torch.as_tensor(self._last_token, device=self.device)
        pos = torch.as_tensor(self.kv.positions(), device=self.device)
        out = self._decode(self.params, tokens, pos, *self.kv.device_state())
        tok, state = out[0], out[1:]
        self.kv.set_device_state(*state)
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
