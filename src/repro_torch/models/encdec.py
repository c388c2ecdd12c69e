"""Encoder–decoder transformer (the seamless-m4t backbone); port of
``repro.models.encdec``.

The speech/text frontends are stubs, as in the reference: the encoder
takes precomputed frame embeddings (B, T_enc, D). The decoder runs
causal self-attention and cross-attention to the encoder output.

Serving state, in one ``init_cache`` tree (batch at axis 1 of every
leaf): ``self``, each decoder layer's self-attention K/V (L, B, S, KV,
hd), written in place as the transformer's cache is; ``cross``, each
layer's K/V of the encoder output (L, B, T_enc, KV, hd), computed once by
``prefill`` (``_cross_kv``) and written into the cache, which must then
be ``init_cache(..., enc_seq=T_enc)`` long. The serving ``Engine`` feeds
a prefill only ``tokens``, never ``frames``, so it does not serve this
model (nor does the reference's); ``prefill`` and ``decode_step`` are
called directly.

Layers are stacked on a leading L dim; the reference's ``lax.scan`` and
``vmap`` over them become Python loops over views of the stacks. Under
autograd each layer runs under ``remat`` unless it is ``"none"``.
``axes`` and ``cache_axes`` are the logical axes of the params and the
cache. On a mesh both are DTensors laid out by them: each layer's params
are gathered over the FSDP axes before use, the encoder's and decoder's
attention and MLP are the transformer's on DTensors (the cross K/V of
``enc_out`` computed on each rank's heads and laid out as the cache's),
and the logits are formed as the transformer's are.
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
from repro_torch.models.transformer import embed_tokens, stack_axes
from repro_torch.sharding.logical import (A, ShardingCtx, gathered,
                                          local_part, on_mesh, redistribute,
                                          shard)

__all__ = ["EncDecConfig", "EncDecLM"]


@dataclass(frozen=True)
class EncDecConfig:
    name: str
    n_enc_layers: int
    n_dec_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    act: str = "gelu"
    gated: bool = False
    dtype: Any = torch.bfloat16
    remat: str = "full"            # training: "none" | "full"

    @property
    def hd(self) -> int:
        return self.d_model // self.n_heads

    @property
    def attn_cfg(self) -> AttnConfig:
        return AttnConfig(d_model=self.d_model, n_heads=self.n_heads,
                          n_kv_heads=self.n_kv_heads, head_dim=self.hd)

    @property
    def mlp_cfg(self) -> MLPConfig:
        return MLPConfig(d_model=self.d_model, d_ff=self.d_ff, act=self.act,
                         gated=self.gated)

    def param_count(self) -> int:
        """The reference's formula: attention as 4·d² (MHA), the norms,
        and the tied embedding once."""
        d = self.d_model
        attn = 4 * d * d
        mlp = (3 if self.gated else 2) * d * self.d_ff
        enc = self.n_enc_layers * (attn + mlp + 2 * d)
        dec = self.n_dec_layers * (2 * attn + mlp + 3 * d)
        return enc + dec + self.vocab * d + 2 * d

    active_param_count = param_count


class EncDecLM:
    """Functional encoder-decoder LM: params are a dict of tensors, and no
    method keeps state (the cache is the caller's, written in place)."""

    def __init__(self, cfg: EncDecConfig):
        self.cfg = cfg

    # ---------- params ----------
    def _enc_layer_init(self, gen: torch.Generator,
                        dev: torch.device) -> dict:
        cfg = self.cfg
        return {"attn": attn_init(gen, cfg.attn_cfg, dev),
                "mlp": mlp_init(gen, cfg.mlp_cfg, dev),
                "ln1": torch.ones((cfg.d_model,), device=dev),
                "ln2": torch.ones((cfg.d_model,), device=dev)}

    def _dec_layer_init(self, gen: torch.Generator,
                        dev: torch.device) -> dict:
        cfg = self.cfg
        return {"self_attn": attn_init(gen, cfg.attn_cfg, dev),
                "cross_attn": attn_init(gen, cfg.attn_cfg, dev),
                "mlp": mlp_init(gen, cfg.mlp_cfg, dev),
                "ln1": torch.ones((cfg.d_model,), device=dev),
                "ln2": torch.ones((cfg.d_model,), device=dev),
                "ln3": torch.ones((cfg.d_model,), device=dev)}

    def init(self, seed: int | torch.Generator = 0, *,
             device: str | torch.device = DEFAULT_DEVICE) -> dict:
        """Random fp32 params from ``seed`` on ``device``, drawn as
        ``TransformerLM.init`` draws them (an int seeds a generator on
        ``device`` itself; a CPU generator gives the same values on any
        device). The stacked layers are drawn one at a time."""
        dev = resolve_device(device)
        gen = seed if isinstance(seed, torch.Generator) \
            else torch.Generator(device=dev).manual_seed(int(seed))
        cfg = self.cfg
        d = cfg.d_model
        return {
            "embedding": dense_init(gen, (cfg.vocab, d), d, dev),
            "enc_layers": stacked_init(
                lambda g: self._enc_layer_init(g, dev), gen,
                cfg.n_enc_layers),
            "dec_layers": stacked_init(
                lambda g: self._dec_layer_init(g, dev), gen,
                cfg.n_dec_layers),
            "enc_norm": torch.ones((d,), device=dev),
            "final_norm": torch.ones((d,), device=dev),
        }

    def axes(self) -> dict:
        cfg = self.cfg
        enc_ax = {"attn": attn_axes(cfg.attn_cfg),
                  "mlp": mlp_axes(cfg.mlp_cfg),
                  "ln1": A(None), "ln2": A(None)}
        dec_ax = {"self_attn": attn_axes(cfg.attn_cfg),
                  "cross_attn": attn_axes(cfg.attn_cfg),
                  "mlp": mlp_axes(cfg.mlp_cfg),
                  "ln1": A(None), "ln2": A(None), "ln3": A(None)}
        return {"embedding": A("vocab", "embed"),
                "enc_layers": stack_axes(enc_ax),
                "dec_layers": stack_axes(dec_ax),
                "enc_norm": A(None), "final_norm": A(None)}

    def cache_axes(self) -> dict:
        kvax = {"k": A("layers", "batch", "kv_seq", "kv_heads", None),
                "v": A("layers", "batch", "kv_seq", "kv_heads", None)}
        return {"self": dict(kvax), "cross": dict(kvax)}

    # ---------- encoder ----------
    def encode(self, params: dict, frames: torch.Tensor,
               ctx: ShardingCtx | None = None) -> torch.Tensor:
        """frames: (B, T_enc, D) stub embeddings -> encoder output, in the
        model dtype: bidirectional self-attention and the MLP a layer."""
        cfg = self.cfg
        x = shard(frames.to(cfg.dtype), ctx, "batch", "act_seq",
                  "act_embed")
        b, t = x.shape[:2]
        pos = torch.arange(t, dtype=torch.int32,
                           device=x.device).expand(b, t)

        def layer(x, p):
            p = tree_map(gathered, p)
            h = rms_norm(x, p["ln1"])
            a, _ = attention(p["attn"], h, cfg.attn_cfg, ctx, q_pos=pos,
                             causal=False)
            x = x + a
            h = rms_norm(x, p["ln2"])
            return x + mlp_apply(p["mlp"], h, cfg.mlp_cfg, ctx)

        for p in layer_views(params["enc_layers"]):
            x = remat(cfg.remat, layer, x, p)
        return rms_norm(x, params["enc_norm"])

    # ---------- decoder ----------
    def _decode_layers(self, params: dict, x: torch.Tensor,
                       enc_out: torch.Tensor | None,
                       ctx: ShardingCtx | None, *, q_pos,
                       self_cache: dict | None, cross_kv: dict | None,
                       cache_index) -> torch.Tensor:
        """Every decoder layer in order. Layer i reads and writes the
        self cache's views ``self_cache[k][i]`` in place, and attends to
        ``cross_kv``'s slice i, or, without it (training), to K/V it
        projects from ``enc_out``; with no self cache each layer runs
        under ``remat``."""
        cfg = self.cfg

        def layer(x, p, sc, ckv):
            p = tree_map(gathered, p)
            h = rms_norm(x, p["ln1"])
            a, _ = attention(p["self_attn"], h, cfg.attn_cfg, ctx,
                             q_pos=q_pos, causal=True, cache_kv=sc,
                             cache_index=cache_index)
            x = x + a
            h = rms_norm(x, p["ln2"])
            if ckv is not None:
                c, _ = attention(p["cross_attn"], h, cfg.attn_cfg, ctx,
                                 q_pos=q_pos, causal=False,
                                 precomputed_kv=ckv)
            else:
                c, _ = attention(p["cross_attn"], h, cfg.attn_cfg, ctx,
                                 q_pos=q_pos, causal=False, kv_x=enc_out)
            x = x + c
            h = rms_norm(x, p["ln3"])
            return x + mlp_apply(p["mlp"], h, cfg.mlp_cfg, ctx)

        for i, p in enumerate(layer_views(params["dec_layers"])):
            sc = None if self_cache is None \
                else (self_cache["k"][i], self_cache["v"][i])
            ckv = None if cross_kv is None \
                else (cross_kv["k"][i], cross_kv["v"][i])
            x = remat(cfg.remat if self_cache is None else "none",
                      lambda x, p, sc=sc, ckv=ckv: layer(x, p, sc, ckv),
                      x, p)
        return x

    def _cross_kv(self, params: dict, enc_out: torch.Tensor) -> dict:
        """Each decoder layer's cross K/V of the encoder output:
        {"k", "v"}: [(B, T_enc, KV, hd)] a layer in ``enc_out``'s dtype
        (on a mesh DTensors, each rank's heads computed from the layer's
        weights gathered over the FSDP axes)."""
        layers = params["dec_layers"]["cross_attn"]
        dt = enc_out.dtype
        return {name: [
            torch.einsum("btd,dhk->bthk", enc_out, gathered(w[i]).to(dt))
            for i in range(self.cfg.n_dec_layers)]
            for name, w in (("k", layers["wk"]), ("v", layers["wv"]))}

    def _embed(self, params: dict, tokens: torch.Tensor,
               ctx: ShardingCtx | None) -> torch.Tensor:
        if not on_mesh(ctx):
            return params["embedding"][tokens.long()].to(self.cfg.dtype)
        return shard(embed_tokens(params["embedding"], tokens, ctx
                                  ).to(self.cfg.dtype), ctx, "batch",
                     "act_seq", "act_embed")

    def _logits(self, params: dict, x: torch.Tensor,
                ctx: ShardingCtx | None) -> torch.Tensor:
        x = rms_norm(x, params["final_norm"])
        # on a mesh the rows are joined first, as the transformer's are
        x = gathered(x, None)
        logits = torch.einsum("bsd,vd->bsv", x,
                              gathered(params["embedding"]).to(x.dtype))
        return shard(logits.to(torch.float32), ctx,
                     "batch", "act_seq", "act_vocab")

    # ---------- public ----------
    def loss(self, params: dict, batch: dict,
             ctx: ShardingCtx | None = None
             ) -> tuple[torch.Tensor, dict]:
        """batch: frames (B,T_enc,D), tokens (B,T_dec), labels (B,T_dec),
        optional loss_mask -> (ce, {"ce"}); the tied embedding is the
        head."""
        if on_mesh(ctx):
            # one gather of the tied table for the lookup and the CE
            params = {**params, "embedding": gathered(params["embedding"],
                                                      None)}
        enc_out = self.encode(params, batch["frames"], ctx)
        x = shard(self._embed(params, batch["tokens"], ctx), ctx, "batch",
                  "act_seq", "act_embed")
        b, s = x.shape[:2]
        pos = torch.arange(s, dtype=torch.int32,
                           device=x.device).expand(b, s)
        x = self._decode_layers(params, x, enc_out, ctx, q_pos=pos,
                                self_cache=None, cross_kv=None,
                                cache_index=None)
        x = rms_norm(x, params["final_norm"])
        mask = batch.get("loss_mask")
        ce = chunked_cross_entropy(
            x, params["embedding"],
            shard(batch["labels"], ctx, "batch", "act_seq"),
            mask=None if mask is None else shard(mask, ctx, "batch",
                                                 "act_seq"))
        return ce, {"ce": ce}

    def init_cache(self, batch: int, max_seq: int,
                   enc_seq: int | None = None, *,
                   device: str | torch.device = DEFAULT_DEVICE) -> dict:
        """max_seq: the decoder self cache's length; enc_seq: the cross
        K/V's (default max_seq, as in the reference), which a prefill
        must fill exactly."""
        cfg = self.cfg
        dev = resolve_device(device)
        enc_seq = enc_seq or max_seq
        l, kv, hd = cfg.n_dec_layers, cfg.n_kv_heads, cfg.hd

        def zeros(s):
            return torch.zeros((l, batch, s, kv, hd), dtype=cfg.dtype,
                               device=dev)
        return {"self": {"k": zeros(max_seq), "v": zeros(max_seq)},
                "cross": {"k": zeros(enc_seq), "v": zeros(enc_seq)}}

    def prefill(self, params: dict, batch: dict, cache: dict,
                ctx: ShardingCtx | None = None
                ) -> tuple[torch.Tensor, dict]:
        """batch: frames (B,T_enc,D), tokens (B,T_dec). Encodes the
        frames, writes the cross K/V (cast to the cache's dtype) and the
        self cache from position 0 in place; returns (last-token logits
        (B, V) fp32, cache)."""
        if "frames" not in batch:
            raise KeyError("frames: EncDecLM.prefill needs the encoder's "
                           "input frames (B, T_enc, D) beside the tokens")
        enc_out = self.encode(params, batch["frames"], ctx)
        cross = self._cross_kv(params, enc_out)
        for name, kvs in cross.items():
            dst = cache["cross"][name]
            if (len(kvs), *kvs[0].shape) != tuple(dst.shape):
                raise ValueError(
                    f"cross K/V of shape {(len(kvs), *kvs[0].shape)} for a "
                    f"cache of {tuple(dst.shape)}: build the cache with "
                    f"init_cache(..., enc_seq={enc_out.shape[1]})")
            for i, kv in enumerate(kvs):
                if on_mesh(ctx):   # to the layout of the cache's part
                    local_part(dst[i])[0].copy_(
                        redistribute(kv, dst[i].placements).to_local())
                else:
                    dst[i].copy_(kv)
        x = self._embed(params, batch["tokens"], ctx)
        b, s = x.shape[:2]
        pos = torch.arange(s, dtype=torch.int32,
                           device=x.device).expand(b, s)
        x = self._decode_layers(params, x, enc_out, ctx, q_pos=pos,
                                self_cache=cache["self"],
                                cross_kv=cache["cross"], cache_index=0)
        logits = self._logits(params, x[:, -1:, :], ctx)
        return logits[:, 0, :], cache

    def decode_step(self, params: dict, tokens: torch.Tensor, pos,
                    cache: dict, ctx: ShardingCtx | None = None
                    ) -> tuple[torch.Tensor, dict]:
        """tokens (B,) int, pos a scalar or per-row (B,) -> (logits (B, V)
        fp32, cache: its self K/V written in place)."""
        x = self._embed(params, tokens[:, None], ctx)
        if torch.is_tensor(pos):
            pos = pos.to(device=x.device, dtype=torch.int32)
        q_pos = decode_q_pos(pos, x.shape[0]).to(x.device)
        x = self._decode_layers(params, x, None, ctx, q_pos=q_pos,
                                self_cache=cache["self"],
                                cross_kv=cache["cross"], cache_index=pos)
        logits = self._logits(params, x, ctx)
        return logits[:, 0, :], cache

    def param_count(self) -> int:
        return self.cfg.param_count()
