"""RWKV-6 language model (rwkv6-1.6b): embed + LN0 + stacked blocks +
an untied head; port of ``repro.models.rwkv_lm``.

Attention-free: the serving "KV cache" is each layer's O(1) recurrent
state {wkv, shift_t, shift_c}, constant in sequence length, stacked on a
leading layer dim with batch at axis 1 (so ``SlotKVCache`` carries it
unchanged) and written in place. A prefill overwrites a row's whole
state, so a reused slot keeps nothing of its previous tenant. The
decode step is position-free. ``loss`` runs the blocks with no state
(each under an activation checkpoint unless ``remat`` is ``"none"``) and
the chunked cross entropy over the untied head. ``axes`` and
``cache_axes`` are the logical axes of the params and the state; the
forward on a mesh raises (ROADMAP §A.10).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models.common import (chunked_cross_entropy, dense_init,
                                       layer_norm, layer_views, remat,
                                       stacked_init)
from repro_torch.models.rwkv6 import (RWKV6Config, rwkv6_apply, rwkv6_axes,
                                      rwkv6_init,
                                      rwkv6_state_shape)
from repro_torch.models.transformer import stack_axes
from repro_torch.sharding.logical import A, ShardingCtx, refuse_mesh, shard

__all__ = ["RWKVLMConfig", "RWKVLM"]


@dataclass(frozen=True)
class RWKVLMConfig:
    name: str
    n_layers: int
    d_model: int
    d_ff: int
    vocab: int
    head_dim: int = 64
    chunk: int = 64
    dtype: Any = torch.bfloat16
    remat: str = "full"            # training: "none" | "full"

    @property
    def block_cfg(self) -> RWKV6Config:
        return RWKV6Config(d_model=self.d_model, d_ff=self.d_ff,
                           head_dim=self.head_dim, chunk=self.chunk)

    def param_count(self) -> int:
        """The reference's formula, approximation and all: it counts 13
        vectors of d a layer and both vocab matrices."""
        d, f = self.d_model, self.d_ff
        r = self.block_cfg.lora_rank
        per_layer = 5 * d * d + 2 * d * r + d * f * 2 + 13 * d  # approx
        return self.n_layers * per_layer + 2 * self.vocab * d

    active_param_count = param_count


class RWKVLM:
    """Functional RWKV LM: params are a dict of tensors, and no method
    keeps state (the cache is the caller's, written in place)."""

    def __init__(self, cfg: RWKVLMConfig):
        self.cfg = cfg

    def init(self, seed: int | torch.Generator = 0, *,
             device: str | torch.device = DEFAULT_DEVICE) -> dict:
        """Random fp32 params from ``seed`` on ``device``, drawn as
        ``TransformerLM.init`` draws them; the stacked layers are drawn
        one at a time."""
        dev = resolve_device(device)
        gen = seed if isinstance(seed, torch.Generator) \
            else torch.Generator(device=dev).manual_seed(int(seed))
        cfg = self.cfg
        d = cfg.d_model
        return {
            "embedding": dense_init(gen, (cfg.vocab, d), d, dev),
            "ln0": torch.ones((d,), device=dev),
            "ln0_b": torch.zeros((d,), device=dev),
            "layers": stacked_init(
                lambda g: rwkv6_init(g, cfg.block_cfg, dev), gen,
                cfg.n_layers),
            "final_norm": torch.ones((d,), device=dev),
            "final_norm_b": torch.zeros((d,), device=dev),
            "lm_head": dense_init(gen, (d, cfg.vocab), d, dev),
        }

    def axes(self) -> dict:
        return {"embedding": A("vocab", "embed"), "ln0": A(None),
                "ln0_b": A(None),
                "layers": stack_axes(rwkv6_axes(self.cfg.block_cfg)),
                "final_norm": A(None), "final_norm_b": A(None),
                "lm_head": A("embed", "vocab")}

    def cache_axes(self) -> dict:
        return {"wkv": A("layers", "batch", "ssm_heads", None, None),
                "shift_t": A("layers", "batch", None),
                "shift_c": A("layers", "batch", None)}

    def _run(self, params: dict, x: torch.Tensor, ctx: ShardingCtx | None,
             cache: dict | None) -> torch.Tensor:
        """Every block in order; block ``i`` reads its state from row
        ``i`` of ``cache`` and writes its new state there. With no cache
        (training) each block starts from zero state, writes nothing and
        runs under ``remat``."""
        cfg = self.cfg
        layers = layer_views(params["layers"])
        if cache is None:
            for p in layers:
                x = remat(cfg.remat, lambda x, p: rwkv6_apply(
                    p, x, cfg.block_cfg, ctx, None)[0], x, p)
            return x
        for i, p in enumerate(layers):
            x, new = rwkv6_apply(p, x,
                                 self.cfg.block_cfg, ctx,
                                 {k: v[i] for k, v in cache.items()})
            for k, v in new.items():
                cache[k][i].copy_(v)
        return x

    def _embed(self, params: dict, tokens: torch.Tensor) -> torch.Tensor:
        x = params["embedding"][tokens.long()].to(self.cfg.dtype)
        return layer_norm(x, params["ln0"], params["ln0_b"])

    def _logits(self, params: dict, x: torch.Tensor,
                ctx: ShardingCtx | None) -> torch.Tensor:
        x = layer_norm(x, params["final_norm"], params["final_norm_b"])
        logits = torch.einsum("btd,dv->btv", x,
                              params["lm_head"].to(x.dtype))
        return shard(logits.to(torch.float32), ctx,
                     "batch", "act_seq", "act_vocab")

    # ---------- public: train ----------
    def loss(self, params: dict, batch: dict,
             ctx: ShardingCtx | None = None
             ) -> tuple[torch.Tensor, dict]:
        """batch: tokens (B,T) (a whole number of WKV chunks), labels
        (B,T), optional loss_mask -> (ce, {"ce"})."""
        refuse_mesh(ctx, "the RWKV-6 LM")
        x = shard(self._embed(params, batch["tokens"]), ctx, "batch",
                  "act_seq", "act_embed")
        x = self._run(params, x, ctx, None)
        x = layer_norm(x, params["final_norm"], params["final_norm_b"])
        ce = chunked_cross_entropy(x, params["lm_head"], batch["labels"],
                                   transpose_weight=True,
                                   mask=batch.get("loss_mask"))
        return ce, {"ce": ce}

    # ---------- public: serve ----------
    def init_cache(self, batch: int, max_seq: int, *,
                   device: str | torch.device = DEFAULT_DEVICE) -> dict:
        """max_seq unused: the RWKV state is O(1) in sequence length."""
        cfg = self.cfg
        dev = resolve_device(device)
        shapes = rwkv6_state_shape(cfg.block_cfg, batch)
        return {k: torch.zeros((cfg.n_layers, *v), dtype=cfg.dtype,
                               device=dev)
                for k, v in shapes.items()}

    def prefill(self, params: dict, batch: dict, cache: dict,
                ctx: ShardingCtx | None = None
                ) -> tuple[torch.Tensor, dict]:
        """Run the prompt (a whole number of WKV chunks, or 1 token,
        which takes the recurrent path) from the state in ``cache``,
        writing the new state in place; returns (last-token logits (B, V)
        fp32, cache)."""
        refuse_mesh(ctx, "the RWKV-6 LM")
        x = self._embed(params, batch["tokens"])
        x = self._run(params, x, ctx, cache)
        logits = self._logits(params, x[:, -1:, :], ctx)
        return logits[:, 0, :], cache

    def decode_step(self, params: dict, tokens: torch.Tensor, pos,
                    cache: dict, ctx: ShardingCtx | None = None
                    ) -> tuple[torch.Tensor, dict]:
        """tokens (B,) -> (logits (B, V) fp32, cache written in place).
        ``pos`` is unused: the recurrence is position-free."""
        del pos
        refuse_mesh(ctx, "the RWKV-6 LM")
        x = self._embed(params, tokens[:, None])
        x = self._run(params, x, ctx, cache)
        logits = self._logits(params, x, ctx)
        return logits[:, 0, :], cache

    def param_count(self) -> int:
        return self.cfg.param_count()
