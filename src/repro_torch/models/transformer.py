"""Decoder-only transformer LM, config-assembled (port of
``repro.models.transformer``).

One config class covers the reference's whole family: dbrx (MoE top-4),
llama4-scout (MoE top-1 + a shared expert), qwen1.5 (QKV bias),
command-r (parallel block, LayerNorm), qwen3 (qk_norm), gemma2
(local/global alternation, softcaps, sandwich norms, embed scaling) and
the internvl2 backbone (vision-prefix embeddings). ``loss`` is the
training loss: the chunked (or full) cross entropy plus the MoE aux loss
summed over layers, which serving discards.

Layers are stacked on a leading L dim as in the reference, whose
``lax.scan`` over them becomes a Python loop over views of the stacked
tensors here (their gradients accumulate into the stacks); each layer's
slice of the KV cache is written in place. ``remat`` other than
``"none"`` checkpoints each layer under autograd (``common.remat``).

``axes`` and ``cache_axes`` are the logical axes of the params and the
cache (``repro_torch.sharding``). With a ``ShardingCtx`` on a mesh the
params and the cache are DTensors laid out by them (``distribute_tree``)
and the forward runs on DTensors: each layer's params are gathered over
the FSDP axes before use (ZeRO-3; a reduce-scatter of their gradients
under autograd), the token ids, labels and positions, global on every
rank, are sliced to the activations' layout where they meet them, and
the logits come back vocab-sharded (``whole`` joins them). The MoE
layer raises on a mesh (expert parallelism, ROADMAP §A.10).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models.common import (chunked_cross_entropy,
                                       cross_entropy_loss, decode_q_pos,
                                       dense_init, layer_norm, layer_views,
                                       remat, rms_norm, softcap,
                                       stacked_init)
from repro_torch.core.tree import tree_map
from repro_torch.models.layers import (AttnConfig, MLPConfig, attention,
                                       attn_axes, attn_init, mlp_apply,
                                       mlp_axes, mlp_init)
from repro_torch.models.moe import MoEConfig, moe_apply, moe_axes, moe_init
from repro_torch.sharding.logical import (A, ShardingCtx, gathered,
                                          on_mesh, shard)

__all__ = ["LMConfig", "TransformerLM", "stack_axes", "embed_tokens"]


def stack_axes(ax):
    """A layer's axes tree with the stacked ``layers`` dim prepended to
    every annotation."""
    if isinstance(ax, dict):
        return {k: stack_axes(v) for k, v in ax.items()}
    return A("layers", *ax.names)


def embed_tokens(table: torch.Tensor, tokens: torch.Tensor,
                 ctx: ShardingCtx | None) -> torch.Tensor:
    """Rows ``tokens`` of ``table`` (V, D). On a mesh the ids are laid
    out as the batch and the table gathered over its FSDP axes; each
    vocab shard looks up the ids it holds (the others read zeros): one
    nonzero term a sum, so the reduce over the vocab shards is exact.
    Under autograd each rank looks its own ids up in the whole table on
    local tensors instead (DTensor has no backward for the vocab-sharded
    lookup), the table's gradient partial over the ids' shards."""
    if not on_mesh(ctx):
        return table[tokens.long()]
    ids = shard(tokens.long(), ctx, "batch", "act_seq")
    if not (torch.is_grad_enabled() and table.requires_grad):
        return torch.nn.functional.embedding(ids, gathered(table))
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh = ctx.mesh
    part = [Partial() if p.is_shard() else Replicate()
            for p in ids.placements]
    rows = gathered(table, None).to_local(grad_placements=part)
    return DTensor.from_local(rows[ids.to_local()], mesh, ids.placements,
                              run_check=False)


@dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None          # default d_model // n_heads
    act: str = "silu"
    gated: bool = True
    qkv_bias: bool = False
    qk_norm: bool = False
    attn_softcap: float | None = None
    final_softcap: float | None = None
    rope_theta: float = 10000.0
    norm: str = "rmsnorm"                # "rmsnorm" | "layernorm"
    norm_plus_one: bool = False          # gemma (1+w) RMSNorm
    sandwich_norm: bool = False          # gemma2 post-norms
    parallel_block: bool = False         # command-r: attn ∥ mlp
    sliding_window: int | None = None
    local_global: bool = False           # alternate local/global (gemma2)
    moe: MoEConfig | None = None
    tie_embeddings: bool = True
    embed_scale: bool = False            # gemma: × sqrt(d_model)
    vision_prefix: bool = False          # internvl: embeds prepended
    chunked_ce: bool = True              # the loss's vocab-chunked CE
    dtype: Any = torch.bfloat16
    remat: str = "full"                  # training: "none" | "full"

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def attn_cfg(self) -> AttnConfig:
        return AttnConfig(
            d_model=self.d_model, n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads, head_dim=self.hd,
            qkv_bias=self.qkv_bias, qk_norm=self.qk_norm,
            attn_softcap=self.attn_softcap, rope_theta=self.rope_theta)

    @property
    def mlp_cfg(self) -> MLPConfig:
        return MLPConfig(d_model=self.d_model, d_ff=self.d_ff, act=self.act,
                         gated=self.gated)

    def param_count(self) -> int:
        """Analytic parameter count (embedding included once if tied;
        QKV biases are not counted, as in the reference)."""
        d, hd = self.d_model, self.hd
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) \
            + self.n_heads * hd * d
        if self.moe is not None:
            m = self.moe
            ff_mults = 3 if m.gated else 2
            ffn = m.n_experts * ff_mults * d * m.d_ff + d * m.n_experts
            ffn += (ff_mults * d * m.d_ff * m.n_shared) if m.n_shared else 0
        else:
            ffn = (3 if self.gated else 2) * d * self.d_ff
        per_layer = attn + ffn + 2 * d
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * per_layer + emb + d

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k + shared experts only)."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        m = self.moe
        ff_mults = 3 if m.gated else 2
        attn = d * self.hd * (self.n_heads + 2 * self.n_kv_heads) \
            + self.n_heads * self.hd * d
        ffn = (m.top_k + m.n_shared) * ff_mults * d * m.d_ff + d * m.n_experts
        per_layer = attn + ffn + 2 * d
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * per_layer + emb + d


class TransformerLM:
    """Functional decoder-only LM: params are a dict of tensors, and no
    method keeps state (the KV cache is the caller's, written in place).
    """

    def __init__(self, cfg: LMConfig):
        self.cfg = cfg

    # ---------- params ----------
    def _layer_init(self, gen: torch.Generator, dev: torch.device) -> dict:
        cfg = self.cfg
        d = cfg.d_model
        fill = torch.zeros if cfg.norm_plus_one else torch.ones
        p = {"attn": attn_init(gen, cfg.attn_cfg, dev),
             "ln1": fill((d,), device=dev),
             "ln2": fill((d,), device=dev)}
        if cfg.moe is not None:
            p["moe"] = moe_init(gen, cfg.moe, dev)
        else:
            p["mlp"] = mlp_init(gen, cfg.mlp_cfg, dev)
        if cfg.sandwich_norm:
            p["ln1_post"] = torch.zeros((d,), device=dev)
            p["ln2_post"] = torch.zeros((d,), device=dev)
        if cfg.norm == "layernorm":
            p["ln1_bias"] = torch.zeros((d,), device=dev)
            p["ln2_bias"] = torch.zeros((d,), device=dev)
        return p

    def init(self, seed: int | torch.Generator = 0, *,
             device: str | torch.device = DEFAULT_DEVICE) -> dict:
        """Random fp32 params from ``seed`` on ``device``. An int seeds a
        generator on ``device`` itself (so a full-size model is drawn on
        the card), which makes the weights depend on the device: one int
        seed gives different values on the CPU and on the card. Pass a
        CPU ``torch.Generator`` to draw the same values for any device."""
        dev = resolve_device(device)
        gen = seed if isinstance(seed, torch.Generator) \
            else torch.Generator(device=dev).manual_seed(int(seed))
        cfg = self.cfg
        params = {
            "embedding": dense_init(gen, (cfg.vocab, cfg.d_model),
                                    cfg.d_model, dev),
            "layers": stacked_init(lambda g: self._layer_init(g, dev), gen,
                                   cfg.n_layers),
            "final_norm": (torch.zeros if cfg.norm_plus_one
                           else torch.ones)((cfg.d_model,), device=dev),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab),
                                           cfg.d_model, dev)
        return params

    def axes(self) -> dict:
        cfg = self.cfg
        layer_ax: dict = {"attn": attn_axes(cfg.attn_cfg),
                          "ln1": A(None), "ln2": A(None)}
        if cfg.moe is not None:
            layer_ax["moe"] = moe_axes(cfg.moe)
        else:
            layer_ax["mlp"] = mlp_axes(cfg.mlp_cfg)
        if cfg.sandwich_norm:
            layer_ax["ln1_post"] = A(None)
            layer_ax["ln2_post"] = A(None)
        if cfg.norm == "layernorm":
            layer_ax["ln1_bias"] = A(None)
            layer_ax["ln2_bias"] = A(None)
        ax = {"embedding": A("vocab", "embed"),
              "layers": stack_axes(layer_ax),
              "final_norm": A(None)}
        if not cfg.tie_embeddings:
            ax["lm_head"] = A("embed", "vocab")
        return ax

    # ---------- building blocks ----------
    def _norm(self, x, w, p, bias_name):
        if self.cfg.norm == "layernorm":
            return layer_norm(x, w, p.get(bias_name))
        return rms_norm(x, w, plus_one=self.cfg.norm_plus_one)

    def _block(self, p: dict, x: torch.Tensor, ctx: ShardingCtx | None, *,
               q_pos: torch.Tensor, window_active, cache_kv, cache_index):
        """One transformer block. Returns (x, cache_kv written, the MoE
        aux loss () fp32, or None without experts)."""
        cfg = self.cfg
        h = self._norm(x, p["ln1"], p, "ln1_bias")
        attn_out, new_kv = attention(
            p["attn"], h, cfg.attn_cfg, ctx, q_pos=q_pos, causal=True,
            window=cfg.sliding_window, window_active=window_active,
            cache_kv=cache_kv, cache_index=cache_index)
        if cfg.sandwich_norm:
            attn_out = rms_norm(attn_out, p["ln1_post"],
                                plus_one=cfg.norm_plus_one)
        aux = None
        if cfg.parallel_block:
            # command-r: mlp on the same normed input, one residual add
            mlp_out = mlp_apply(p["mlp"], h, cfg.mlp_cfg, ctx)
            return x + attn_out + mlp_out, new_kv, aux
        x = x + attn_out
        h2 = self._norm(x, p["ln2"], p, "ln2_bias")
        if cfg.moe is not None:
            ffn_out, aux = moe_apply(p["moe"], h2, cfg.moe, ctx)
        else:
            ffn_out = mlp_apply(p["mlp"], h2, cfg.mlp_cfg, ctx)
        if cfg.sandwich_norm:
            ffn_out = rms_norm(ffn_out, p["ln2_post"],
                               plus_one=cfg.norm_plus_one)
        return x + ffn_out, new_kv, aux

    def _layer_flags(self) -> torch.Tensor | None:
        cfg = self.cfg
        if cfg.local_global:
            # even layers local (sliding window), odd layers global
            return torch.arange(cfg.n_layers) % 2 == 0
        if cfg.sliding_window is not None:
            return torch.ones((cfg.n_layers,), dtype=torch.bool)
        return None

    def _run_layers(self, params: dict, x: torch.Tensor,
                    ctx: ShardingCtx | None, *, q_pos: torch.Tensor,
                    cache: dict | None, cache_index) -> tuple:
        """Run the stacked layers in order; returns (x, the MoE aux losses
        summed () fp32, or None without experts, cache). cache: {"k",
        "v"}: (L, B, S, KV, hd) or None (training: each layer then runs
        under ``remat``); layer i reads and writes the views
        ``cache["k"][i]``, ``cache["v"][i]`` in place."""
        flags = self._layer_flags()
        flags = [False] * self.cfg.n_layers if flags is None \
            else flags.tolist()
        aux_sum = None
        layers = layer_views(params["layers"])
        for i, flag in enumerate(flags):
            cache_kv = None if cache is None \
                else (cache["k"][i], cache["v"][i])

            def block(x, p, flag=flag, cache_kv=cache_kv):
                x, _, aux = self._block(
                    tree_map(gathered, p), x, ctx, q_pos=q_pos,
                    window_active=flag, cache_kv=cache_kv,
                    cache_index=cache_index)
                return x, aux

            x, aux = remat(self.cfg.remat if cache is None else "none",
                           block, x, layers[i])
            if aux is not None:
                aux_sum = aux if aux_sum is None else aux_sum + aux
        return x, aux_sum, cache

    # ---------- embedding / logits ----------
    def _embed(self, params: dict, tokens: torch.Tensor,
               ctx: ShardingCtx | None,
               vision_embeds: torch.Tensor | None = None) -> torch.Tensor:
        cfg = self.cfg
        x = embed_tokens(params["embedding"], tokens, ctx).to(cfg.dtype)
        if cfg.embed_scale:
            x = x * torch.tensor(cfg.d_model, dtype=cfg.dtype) ** 0.5
        if cfg.vision_prefix and vision_embeds is not None:
            # on a mesh the lookup's partial sum over the vocab shards is
            # reduced before the join (DTensor's cat cannot carry it)
            x = shard(x, ctx, "batch", "act_seq", "act_embed")
            vis = shard(vision_embeds.to(cfg.dtype), ctx, "batch",
                        "act_seq", "act_embed")
            x = torch.cat([vis, x], dim=1)
        return shard(x, ctx, "batch", "act_seq", "act_embed")

    def _logits(self, params: dict, x: torch.Tensor,
                ctx: ShardingCtx | None) -> torch.Tensor:
        cfg = self.cfg
        x = self._norm(x, params["final_norm"], params, "final_norm_bias")
        # on a mesh the rows are joined first: the vocab contraction then
        # runs at the unsharded row count (the CPU's BLAS rounds a 1- or
        # 2-row product with a transposed weight another way)
        x = shard(x, ctx, None, "act_seq", "act_embed")
        if cfg.tie_embeddings:
            logits = torch.einsum("bsd,vd->bsv", x,
                                  gathered(params["embedding"]).to(x.dtype))
        else:
            logits = torch.einsum("bsd,dv->bsv", x,
                                  gathered(params["lm_head"]).to(x.dtype))
        logits = softcap(logits.to(torch.float32), cfg.final_softcap)
        return shard(logits, ctx, "batch", "act_seq", "act_vocab")

    # ---------- public: train ----------
    def loss(self, params: dict, batch: dict,
             ctx: ShardingCtx | None = None
             ) -> tuple[torch.Tensor, dict]:
        """batch: tokens (B,S), labels (B,S), optional loss_mask (B,S),
        optional vision_embeds (B,P,D), whose positions are sliced off
        before the loss. Returns (ce + aux, {"ce", "aux"})."""
        cfg = self.cfg
        vis = batch.get("vision_embeds")
        if on_mesh(ctx) and cfg.tie_embeddings:
            # one gather of the tied table for the lookup and the CE (and
            # one reduce of its gradient)
            params = {**params, "embedding": gathered(params["embedding"],
                                                      None)}
        x = self._embed(params, batch["tokens"], ctx, vis)
        labels = shard(batch["labels"], ctx, "batch", "act_seq")
        mask = batch.get("loss_mask")
        if mask is not None:
            mask = shard(mask, ctx, "batch", "act_seq")
        b, s = x.shape[:2]
        q_pos = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
        x, aux, _ = self._run_layers(params, x, ctx, q_pos=q_pos,
                                     cache=None, cache_index=None)
        if aux is None:
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if cfg.chunked_ce:
            if vis is not None:
                x = x[:, vis.shape[1]:, :]
            x = self._norm(x, params["final_norm"], params,
                           "final_norm_bias")
            w = params["embedding"] if cfg.tie_embeddings \
                else params["lm_head"]
            ce = chunked_cross_entropy(
                x, w, labels,
                transpose_weight=not cfg.tie_embeddings,
                final_softcap=cfg.final_softcap, mask=mask)
        else:
            logits = self._logits(params, x, ctx)
            if vis is not None:
                logits = logits[:, vis.shape[1]:, :]
            ce = cross_entropy_loss(logits, labels, mask)
        ce = shard(ce, ctx)     # a mesh's partial sums, reduced
        return ce + aux, {"ce": ce, "aux": aux}

    # ---------- public: serve ----------
    def init_cache(self, batch: int, max_seq: int, *,
                   device: str | torch.device = DEFAULT_DEVICE) -> dict:
        cfg = self.cfg
        shp = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.hd)
        dev = resolve_device(device)
        return {"k": torch.zeros(shp, dtype=cfg.dtype, device=dev),
                "v": torch.zeros(shp, dtype=cfg.dtype, device=dev)}

    def cache_axes(self) -> dict:
        return {"k": A("layers", "batch", "kv_seq", "kv_heads", None),
                "v": A("layers", "batch", "kv_seq", "kv_heads", None)}

    def prefill(self, params: dict, batch: dict, cache: dict,
                ctx: ShardingCtx | None = None
                ) -> tuple[torch.Tensor, dict]:
        """Run the prompt, fill the cache (in place, from position 0);
        returns (last-token logits (B, V) fp32, cache)."""
        tokens = batch["tokens"]
        x = self._embed(params, tokens, ctx, batch.get("vision_embeds"))
        b, s = x.shape[:2]
        q_pos = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
        x, _, cache = self._run_layers(params, x, ctx, q_pos=q_pos,
                                       cache=cache, cache_index=0)
        logits = self._logits(params, x[:, -1:, :], ctx)
        return logits[:, 0, :], cache

    def decode_step(self, params: dict, tokens: torch.Tensor, pos,
                    cache: dict, ctx: ShardingCtx | None = None
                    ) -> tuple[torch.Tensor, dict]:
        """tokens (B,) int, pos a scalar or per-slot (B,) ->
        (logits (B, V) fp32, cache written in place)."""
        x = self._embed(params, tokens[:, None], ctx)
        if torch.is_tensor(pos):
            pos = pos.to(device=x.device, dtype=torch.int32)
        q_pos = decode_q_pos(pos, x.shape[0]).to(x.device)
        x, _, cache = self._run_layers(params, x, ctx, q_pos=q_pos,
                                       cache=cache, cache_index=pos)
        logits = self._logits(params, x, ctx)
        return logits[:, 0, :], cache

    def param_count(self) -> int:
        return self.cfg.param_count()
