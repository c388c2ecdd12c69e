"""Zamba2-style hybrid: a Mamba2 backbone and a SHARED attention block
[arXiv:2411.15242]; port of ``repro.models.hybrid``.

Structure: ``n_layers`` Mamba2 blocks; after every ``shared_interval``
blocks, one shared transformer block (attention + MLP, the SAME
parameters at every call) runs on concat(hidden, embedding output)
projected back to d_model, Zamba's parameter-sharing trick. The
reference scans over groups of ``shared_interval`` Mamba layers plus one
shared-block call, then over a tail of the remaining layers with no
shared block after them; here both scans are Python loops over views of
the stacked layers.

Serving state, in one ``init_cache`` tree (batch at axis 1 of every
leaf, so ``SlotKVCache`` carries it unchanged):

* ``mamba``: each layer's O(1) recurrent state, ``ssm`` (L, B, H, P, N)
  and the conv ring ``conv`` (L, B, K-1, C), in layer order (the groups'
  layers, then the tail's). A prefill overwrites a row's whole state from
  the chunked scan's final state, so a reused slot keeps nothing of its
  previous tenant;
* ``attn``: the shared block's K/V, one slice per call of it, (G, B, S,
  KV, hd).

Both are written in place, as the transformer's KV cache is. Prompts
must be a whole number of SSD chunks (``mamba_chunk``).

Simplification kept from the reference: ONE shared block (the release
alternates two; DESIGN.md §5). ``loss`` runs the layers with no cache
(nothing is written) and, unless ``remat`` is ``"none"``, each Mamba
layer and each shared-block call under an activation checkpoint.
``axes`` and ``cache_axes`` are the logical axes of the params and the
cache. On a mesh the params and the cache are DTensors laid out by them:
each layer's params are gathered over the FSDP axes before use, the
Mamba layers run on each rank's heads (``mamba2_mesh``) and write their
state into the part of the cache the rank holds, the shared block is
the transformer's attention and MLP on DTensors (under int8 its MLP's
matmuls are ``qmatmul`` launches on the rank's shards), and the logits
are formed as the transformer's are.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.core.tree import tree_map
from repro_torch.models.common import (chunked_cross_entropy, decode_q_pos,
                                       dense_init, layer_views, remat,
                                       rms_norm, stacked_init)
from repro_torch.models.layers import (AttnConfig, MLPConfig, attention,
                                       attn_axes, mlp_axes,
                                       attn_init, mlp_apply, mlp_init)
from repro_torch.models.mamba2 import (Mamba2Config, mamba2_apply,
                                       mamba2_axes,
                                       mamba2_decode_step, mamba2_init,
                                       mamba2_mesh, mamba2_state_shape)
from repro_torch.models.transformer import embed_tokens, stack_axes
from repro_torch.sharding.logical import (A, ShardingCtx, gathered,
                                          matmul_rows, on_mesh, shard,
                                          write_part)

__all__ = ["HybridConfig", "HybridLM"]


@dataclass(frozen=True)
class HybridConfig:
    name: str
    n_layers: int                  # total mamba2 layers
    d_model: int
    n_heads: int                   # shared attention block
    n_kv_heads: int
    d_ff: int                      # shared block MLP
    vocab: int
    d_state: int = 64
    shared_interval: int = 6
    mamba_chunk: int = 128
    ssd_bf16: bool = False
    dtype: Any = torch.bfloat16
    remat: str = "full"            # training: "none" | "full"

    @property
    def n_groups(self) -> int:
        return self.n_layers // self.shared_interval

    @property
    def n_tail(self) -> int:
        return self.n_layers % self.shared_interval

    @property
    def mamba_cfg(self) -> Mamba2Config:
        return Mamba2Config(d_model=self.d_model, d_state=self.d_state,
                            chunk=self.mamba_chunk, ssd_bf16=self.ssd_bf16)

    @property
    def attn_cfg(self) -> AttnConfig:
        return AttnConfig(d_model=self.d_model, n_heads=self.n_heads,
                          n_kv_heads=self.n_kv_heads,
                          head_dim=self.d_model // self.n_heads)

    @property
    def mlp_cfg(self) -> MLPConfig:
        return MLPConfig(d_model=self.d_model, d_ff=self.d_ff, act="gelu")

    def param_count(self) -> int:
        m = self.mamba_cfg
        per_mamba = (self.d_model * (2 * m.d_inner + 2 * m.d_state
                                     + m.n_heads)
                     + m.d_conv * m.conv_dim + m.d_inner * self.d_model
                     + 3 * m.n_heads + m.d_inner)
        shared = (2 * self.d_model * self.d_model  # concat proj
                  + 4 * self.d_model * self.d_model  # attn (MHA)
                  + 3 * self.d_model * self.d_ff + 4 * self.d_model)
        return (self.n_layers * per_mamba + shared
                + self.vocab * self.d_model + self.d_model)

    active_param_count = param_count


class HybridLM:
    """Functional hybrid LM: params are a dict of tensors, and no method
    keeps state (the cache is the caller's, written in place)."""

    def __init__(self, cfg: HybridConfig):
        self.cfg = cfg

    # ---------- params ----------
    def _mamba_layer_init(self, gen: torch.Generator,
                          dev: torch.device) -> dict:
        return {"mamba": mamba2_init(gen, self.cfg.mamba_cfg, dev),
                "ln": torch.ones((self.cfg.d_model,), device=dev)}

    def init(self, seed: int | torch.Generator = 0, *,
             device: str | torch.device = DEFAULT_DEVICE) -> dict:
        """Random fp32 params from ``seed`` on ``device``, drawn as
        ``TransformerLM.init`` draws them (an int seeds a generator on
        ``device`` itself; a CPU generator gives the same values on any
        device). The stacked Mamba layers are drawn one at a time."""
        dev = resolve_device(device)
        gen = seed if isinstance(seed, torch.Generator) \
            else torch.Generator(device=dev).manual_seed(int(seed))
        cfg = self.cfg
        d = cfg.d_model
        return {
            "embedding": dense_init(gen, (cfg.vocab, d), d, dev),
            "mamba_layers": stacked_init(
                lambda g: self._mamba_layer_init(g, dev), gen, cfg.n_layers),
            "shared": {
                "concat_proj": dense_init(gen, (2 * d, d), 2 * d, dev),
                "attn": attn_init(gen, cfg.attn_cfg, dev),
                "mlp": mlp_init(gen, cfg.mlp_cfg, dev),
                "ln1": torch.ones((d,), device=dev),
                "ln2": torch.ones((d,), device=dev),
            },
            "final_norm": torch.ones((d,), device=dev),
        }

    # ---------- blocks ----------
    def _shared_block(self, p: dict, x: torch.Tensor, x0: torch.Tensor,
                      ctx: ShardingCtx | None, *, q_pos, cache_kv,
                      cache_index) -> torch.Tensor:
        """Shared attention + MLP on concat(hidden, embedding output)."""
        cfg = self.cfg
        p = tree_map(gathered, p)
        h = torch.cat([x, x0], dim=-1)
        h = matmul_rows(h, p["concat_proj"]) if on_mesh(ctx) \
            else torch.matmul(h, p["concat_proj"].to(x.dtype))
        hn = rms_norm(h, p["ln1"])
        attn_out, _ = attention(p["attn"], hn, cfg.attn_cfg, ctx,
                                q_pos=q_pos, causal=True, cache_kv=cache_kv,
                                cache_index=cache_index)
        h = h + attn_out
        h = h + mlp_apply(p["mlp"], rms_norm(h, p["ln2"]), cfg.mlp_cfg, ctx)
        return x + h

    def _mamba_layer(self, p: dict, i: int, x: torch.Tensor,
                     ctx: ShardingCtx | None, states: dict | None,
                     decode: bool) -> torch.Tensor:
        """Mamba layer ``i`` (params ``p``) on ``x``; its new recurrent
        state is written into row ``i`` of ``states`` (a prefill's from
        the chunked scan, a decode step's from the state it read there).
        ``states`` None (training) writes nothing and runs under
        ``remat``."""
        cfg = self.cfg
        if states is None:
            def layer(x, p):
                p = tree_map(gathered, p)
                h = rms_norm(x, p["ln"])
                return x + mamba2_apply(p["mamba"], h, cfg.mamba_cfg, ctx)
            return remat(cfg.remat, layer, x, p)
        p = tree_map(gathered, p)
        h = rms_norm(x, p["ln"])
        if on_mesh(ctx):
            out, new = mamba2_mesh(
                p["mamba"], h, cfg.mamba_cfg, ctx,
                {k: v[i] for k, v in states.items()} if decode else None,
                True)
            for k, (block, offset) in new.items():
                write_part(states[k][i], block, offset)
            return x + out
        if decode:
            out, new = mamba2_decode_step(
                p["mamba"], h[:, 0, :], {k: v[i] for k, v in states.items()},
                cfg.mamba_cfg, ctx)
            out = out[:, None, :]
        else:
            out, new = mamba2_apply(p["mamba"], h, cfg.mamba_cfg, ctx,
                                    return_state=True)
        for k, v in new.items():
            states[k][i].copy_(v)
        return x + out

    def _run(self, params: dict, x: torch.Tensor, ctx: ShardingCtx | None,
             *, q_pos: torch.Tensor, cache: dict | None, cache_index,
             decode: bool) -> torch.Tensor:
        """Groups of [interval × mamba] + the shared block, then the tail.
        Group ``g``'s shared-block call reads and writes the attention
        cache's slice ``g``; with no cache (training) nothing is written
        and each call runs under ``remat``."""
        cfg = self.cfg
        si = cfg.shared_interval
        x0 = x
        states = None if cache is None else cache["mamba"]
        layers = layer_views(params["mamba_layers"])
        for g in range(cfg.n_groups):
            for i in range(g * si, (g + 1) * si):
                x = self._mamba_layer(layers[i], i, x, ctx, states, decode)
            if cache is None:
                x = remat(cfg.remat, lambda x, p: self._shared_block(
                    p, x, x0, ctx, q_pos=q_pos, cache_kv=None,
                    cache_index=None), x, params["shared"])
                continue
            kv = cache["attn"]
            x = self._shared_block(params["shared"], x, x0, ctx,
                                   q_pos=q_pos,
                                   cache_kv=(kv["k"][g], kv["v"][g]),
                                   cache_index=cache_index)
        for i in range(cfg.n_groups * si, cfg.n_layers):
            x = self._mamba_layer(layers[i], i, x, ctx, states, decode)
        return x

    def axes(self) -> dict:
        cfg = self.cfg
        return {
            "embedding": A("vocab", "embed"),
            "mamba_layers": stack_axes({"mamba": mamba2_axes(cfg.mamba_cfg),
                                        "ln": A(None)}),
            "shared": {
                "concat_proj": A("embed", None),
                "attn": attn_axes(cfg.attn_cfg),
                "mlp": mlp_axes(cfg.mlp_cfg),
                "ln1": A(None), "ln2": A(None),
            },
            "final_norm": A(None),
        }

    def cache_axes(self) -> dict:
        return {
            "mamba": {"ssm": A("layers", "batch", "ssm_heads", None, None),
                      "conv": A("layers", "batch", None, "ssm_inner")},
            "attn": {"k": A("layers", "batch", "kv_seq", "kv_heads", None),
                     "v": A("layers", "batch", "kv_seq", "kv_heads", None)},
        }

    def _embed(self, params: dict, tokens: torch.Tensor,
               ctx: ShardingCtx | None) -> torch.Tensor:
        """The embedding rows of ``tokens``; on a mesh laid out as the
        activations (its lookup's sum over the vocab shards reduced, so
        that the shared blocks' ``x0`` is whole)."""
        if not on_mesh(ctx):
            return params["embedding"][tokens.long()].to(self.cfg.dtype)
        x = embed_tokens(params["embedding"], tokens, ctx)
        return shard(x.to(self.cfg.dtype), ctx, "batch", "act_seq",
                     "act_embed")

    def _logits(self, params: dict, x: torch.Tensor,
                ctx: ShardingCtx | None) -> torch.Tensor:
        x = rms_norm(x, params["final_norm"])
        # on a mesh the rows are joined first, as the transformer's are
        x = gathered(x, None)
        logits = torch.einsum("bsd,vd->bsv", x,
                              gathered(params["embedding"]).to(x.dtype))
        return shard(logits.to(torch.float32), ctx,
                     "batch", "act_seq", "act_vocab")

    # ---------- public: train ----------
    def loss(self, params: dict, batch: dict,
             ctx: ShardingCtx | None = None
             ) -> tuple[torch.Tensor, dict]:
        """batch: tokens (B,S) (a whole number of SSD chunks), labels
        (B,S), optional loss_mask -> (ce, {"ce"}); the tied embedding is
        the head."""
        if on_mesh(ctx):
            # one gather of the tied table for the lookup and the CE
            params = {**params, "embedding": gathered(params["embedding"],
                                                      None)}
        x = shard(self._embed(params, batch["tokens"], ctx), ctx, "batch",
                  "act_seq", "act_embed")
        b, s = x.shape[:2]
        q_pos = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
        x = self._run(params, x, ctx, q_pos=q_pos, cache=None,
                      cache_index=None, decode=False)
        x = rms_norm(x, params["final_norm"])
        mask = batch.get("loss_mask")
        ce = chunked_cross_entropy(
            x, params["embedding"],
            shard(batch["labels"], ctx, "batch", "act_seq"),
            mask=None if mask is None else shard(mask, ctx, "batch",
                                                 "act_seq"))
        return ce, {"ce": ce}

    # ---------- public: serve ----------
    def init_cache(self, batch: int, max_seq: int, *,
                   device: str | torch.device = DEFAULT_DEVICE) -> dict:
        cfg = self.cfg
        dev = resolve_device(device)
        st = mamba2_state_shape(cfg.mamba_cfg, batch)
        kv = (cfg.n_groups, batch, max_seq, cfg.n_kv_heads,
              cfg.attn_cfg.head_dim)
        zeros = lambda shp: torch.zeros(shp, dtype=cfg.dtype,  # noqa: E731
                                        device=dev)
        return {"mamba": {k: zeros((cfg.n_layers, *v))
                          for k, v in st.items()},
                "attn": {"k": zeros(kv), "v": zeros(kv)}}

    def prefill(self, params: dict, batch: dict, cache: dict,
                ctx: ShardingCtx | None = None
                ) -> tuple[torch.Tensor, dict]:
        """Run the prompt (a whole number of SSD chunks), write every
        Mamba layer's final state and the shared block's K/V (from
        position 0) into ``cache`` in place; returns (last-token logits
        (B, V) fp32, cache)."""
        x = self._embed(params, batch["tokens"], ctx)
        b, s = x.shape[:2]
        q_pos = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
        x = self._run(params, x, ctx, q_pos=q_pos, cache=cache,
                      cache_index=0, decode=False)
        logits = self._logits(params, x[:, -1:, :], ctx)
        return logits[:, 0, :], cache

    def decode_step(self, params: dict, tokens: torch.Tensor, pos,
                    cache: dict, ctx: ShardingCtx | None = None
                    ) -> tuple[torch.Tensor, dict]:
        """tokens (B,) int, pos a scalar or per-slot (B,) (the shared
        attention's positions; the Mamba layers are position-free) ->
        (logits (B, V) fp32, cache written in place)."""
        x = self._embed(params, tokens[:, None], ctx)
        if torch.is_tensor(pos):
            pos = pos.to(device=x.device, dtype=torch.int32)
        q_pos = decode_q_pos(pos, x.shape[0]).to(x.device)
        x = self._run(params, x, ctx, q_pos=q_pos, cache=cache,
                      cache_index=pos, decode=True)
        logits = self._logits(params, x, ctx)
        return logits[:, 0, :], cache

    def param_count(self) -> int:
        return self.cfg.param_count()
