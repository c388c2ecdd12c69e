"""Serving weights cast to the compute dtype once, at ``Engine`` build.

The models keep fp32 weights and cast each one where it is read, as the
reference's ``.astype(x.dtype)`` does: in bf16 that is a cast of every
weight in every step (19.0 ms of a zamba2-7b decode step's 41.3 ms busy
on an NVIDIA H100, PERF.md §5). A cast is elementwise, so casting a leaf once
is exact where *every* serving read of it is ``.to(compute dtype)``:
the same bf16 values reach the same ops. A leaf read in fp32 anywhere
stays fp32. The sets below name, per family, the leaves whose every read
in ``prefill`` and ``decode_step`` is that cast (key paths of the
params tree; stacked layers under ``layers`` / ``mamba_layers``):

* dense: the embedding (gathered, then cast; the tied head casts it
  whole) and ``lm_head``; attention's ``wq``, ``wk``, ``wv``, ``wo``
  and the QKV biases; the MLP's ``wi``, ``wg``, ``wo`` (under int8 the
  cast weight is what ``dense`` quantizes). fp32: the norms (``ln*``,
  ``final_norm``, ``q_norm``/``k_norm``: ``rms_norm`` upcasts them).
* moe: dense's, with the experts' ``wi``, ``wg``, ``wo`` and the shared
  expert's in place of the MLP. fp32: the router, which routing reads in
  fp32 (``models/moe.py`` ``_route``; the reference upcasts it too):
  cast once it would round, and move the routing weights and experts.
* hybrid (zamba2): the embedding; each Mamba2 layer's ``in_proj``,
  ``conv_w``, ``conv_b``, ``out_proj``; the shared block's
  ``concat_proj``, attention and MLP matrices. fp32: ``A_log``,
  ``dt_bias``, ``D``, the norms.
* rwkv: the embedding and ``lm_head``; each block's token-shift mixes
  (``mix``, ``cmix``) and ``wr``, ``wk``, ``wv``, ``wg``, ``wo``, ``ck``,
  ``cv``, ``cr``. fp32: the decay LoRA (``w_lora_a``, ``w_lora_b``,
  ``w0``), the bonus ``u``, the layer and group norms.

This is not training's ``cast_params_once`` (``train/steps.py``), which
mirrors the reference's cast of every ≥ 2-D matrix in a train step.
"""
from __future__ import annotations

import torch

__all__ = ["SERVE_CAST", "model_family", "cast_serving_params"]

_ATTN = tuple(("attn", k) for k in ("wq", "wk", "wv", "wo"))
_QKV_BIAS = tuple(("attn", k) for k in ("bq", "bk", "bv"))
_MLP = tuple(("mlp", k) for k in ("wi", "wg", "wo"))
_EXPERTS = tuple(("moe", k) for k in ("wi", "wg", "wo", "shared_wi",
                                       "shared_wg", "shared_wo"))

SERVE_CAST: dict[str, frozenset[tuple[str, ...]]] = {
    "dense": frozenset({("embedding",), ("lm_head",)}
                       | {("layers",) + p
                          for p in _ATTN + _QKV_BIAS + _MLP}),
    "moe": frozenset({("embedding",), ("lm_head",)}
                     | {("layers",) + p
                        for p in _ATTN + _QKV_BIAS + _EXPERTS}),
    "hybrid": frozenset(
        {("embedding",), ("shared", "concat_proj")}
        | {("mamba_layers", "mamba", k)
           for k in ("in_proj", "conv_w", "conv_b", "out_proj")}
        | {("shared",) + p for p in _ATTN + _MLP}),
    "rwkv": frozenset(
        {("embedding",), ("lm_head",)}
        | {("layers", k) for k in ("mix", "cmix", "wr", "wk", "wv", "wg",
                                   "wo", "ck", "cv", "cr")}),
}


def model_family(model) -> str | None:
    """``model``'s row of SERVE_CAST, or None for a model the engine
    has no cast set for (its weights then stay as given)."""
    from repro_torch.models.hybrid import HybridLM
    from repro_torch.models.rwkv_lm import RWKVLM
    from repro_torch.models.transformer import TransformerLM
    if isinstance(model, TransformerLM):
        return "moe" if model.cfg.moe is not None else "dense"
    if isinstance(model, HybridLM):
        return "hybrid"
    if isinstance(model, RWKVLM):
        return "rwkv"
    return None


def cast_serving_params(model, params: dict, device, *,
                        donate: bool = False) -> dict:
    """A params tree on ``device`` whose leaves in the model family's
    cast set are cast to the model's compute dtype, one leaf at a time;
    the other leaves as given. ``donate``: the caller hands ``params``
    over, and each leaf is removed from it once moved, so an fp32 tree
    is never held whole beside its cast copy."""
    dtype = getattr(model.cfg, "dtype", None)
    paths = SERVE_CAST.get(model_family(model), frozenset())

    def walk(tree: dict, prefix: tuple) -> dict:
        out = {}
        for k in list(tree):
            v = tree[k]
            path = prefix + (k,)
            if isinstance(v, dict):
                out[k] = walk(v, path)
            else:
                v = v.to(device)
                if (path in paths and dtype is not None
                        and v.is_floating_point()):
                    v = v.to(dtype)
                out[k] = v
            if donate:
                del tree[k]
            del v
        return out

    with torch.no_grad():
        return walk(params, ())
