"""``ArchSpec``: one assigned architecture = model constructor + per-shape
specs (port of ``repro.configs.base``).

Shapes (LM family, assigned):
  train_4k     seq 4096,   global_batch 256  -> runs train_step
  prefill_32k  seq 32768,  global_batch 32   -> runs the prefill serve step
  decode_32k   seq 32768,  global_batch 128  -> runs the decode serve step
                                               (1 new token, KV cache = seq)
  long_500k    seq 524288, global_batch 1    -> decode; ONLY for sub-quadratic
                                               archs (zamba2, rwkv6) — others
                                               skip with a reason string.

Where the reference's specs are ``jax.ShapeDtypeStruct``s, the port's
are tensors on the ``meta`` device: shapes and dtypes, no storage, which
the port's steps run on as they are (the dry run, ``launch/dryrun.py``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.sharding.logical import A

__all__ = ["SHAPES", "ArchSpec", "lm_inputs"]

# shape id -> (kind, seq_len, global_batch)
SHAPES: dict[str, tuple[str, int, int]] = {
    "train_4k": ("train", 4_096, 256),
    "prefill_32k": ("prefill", 32_768, 32),
    "decode_32k": ("decode", 32_768, 128),
    "long_500k": ("decode", 524_288, 1),
}

_I32 = torch.int32


def _spec(shape: tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _tok(b: int, s: int) -> torch.Tensor:
    return _spec((b, s), _I32)


def lm_inputs(kind: str, seq: int, batch: int, *,
              vision_patches: int = 0, d_model: int = 0,
              frames: bool = False, dec_frac: int = 4,
              dtype: torch.dtype = torch.bfloat16):
    """Standard LM input specs (meta tensors) + logical axes for one
    shape cell.

    vision_patches > 0: VLM — (batch, P, d_model) embeddings prepended, text
    tokens shortened so total seq stays `seq`.
    frames=True: enc-dec — encoder gets (batch, seq, d_model) stub frame
    embeddings, decoder tokens are seq // dec_frac (min 128).
    """
    if frames:
        s_dec = max(seq // dec_frac, 128)
        if kind == "train":
            specs = {"frames": _spec((batch, seq, d_model), dtype),
                     "tokens": _tok(batch, s_dec),
                     "labels": _tok(batch, s_dec)}
            axes = {"frames": A("batch", "act_seq", None),
                    "tokens": A("batch", "act_seq"),
                    "labels": A("batch", "act_seq")}
        elif kind == "prefill":
            specs = {"frames": _spec((batch, seq, d_model), dtype),
                     "tokens": _tok(batch, s_dec)}
            axes = {"frames": A("batch", "act_seq", None),
                    "tokens": A("batch", "act_seq")}
        else:
            specs = {"tokens": _spec((batch,), _I32),
                     "pos": _spec((), _I32)}
            axes = {"tokens": A("batch"), "pos": A()}
        return specs, axes

    if vision_patches and kind in ("train", "prefill"):
        s_text = seq - vision_patches
        specs = {"tokens": _tok(batch, s_text),
                 "vision_embeds": _spec((batch, vision_patches, d_model),
                                        dtype)}
        axes = {"tokens": A("batch", "act_seq"),
                "vision_embeds": A("batch", "act_seq", None)}
        if kind == "train":
            specs["labels"] = _tok(batch, s_text)
            axes["labels"] = A("batch", "act_seq")
        return specs, axes

    if kind == "train":
        return ({"tokens": _tok(batch, seq), "labels": _tok(batch, seq)},
                {"tokens": A("batch", "act_seq"),
                 "labels": A("batch", "act_seq")})
    if kind == "prefill":
        return ({"tokens": _tok(batch, seq)},
                {"tokens": A("batch", "act_seq")})
    # decode
    return ({"tokens": _spec((batch,), _I32), "pos": _spec((), _I32)},
            {"tokens": A("batch"), "pos": A()})


@dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str                       # cnn|dense|moe|vlm|audio|hybrid|ssm
    build: Callable[[], Any]          # -> model instance
    source: str                       # provenance note
    notes: str = ""
    vision_patches: int = 0           # vlm: patch embeddings prepended
    frames: bool = False              # enc-dec: the encoder takes frames
    dec_frac: int = 4                 # enc-dec: decoder tokens = seq / this
    subquadratic: bool = False        # O(1)-state decode: runs long_500k
    cache_seq_divisor: int = 1        # enc-dec: self cache = seq // this

    def model(self):
        return self.build()

    def skip_reason(self, shape_id: str) -> str | None:
        if shape_id == "long_500k" and not self.subquadratic:
            return ("full-attention arch: 500k decode needs a quadratic-"
                    "memory KV pass per global layer — skipped per task "
                    "spec (see DESIGN.md §5)")
        return None

    def input_specs(self, shape_id: str):
        """-> (kind, specs dict, axes dict, seq, batch)."""
        kind, seq, batch = SHAPES[shape_id]
        m = self.model()
        d = getattr(m.cfg, "d_model", 0)
        specs, axes = lm_inputs(kind, seq, batch,
                                vision_patches=self.vision_patches,
                                d_model=d, frames=self.frames,
                                dec_frac=self.dec_frac,
                                dtype=getattr(m.cfg, "dtype", torch.bfloat16))
        return kind, specs, axes, seq, batch

    def cache_specs(self, shape_id: str):
        """(the serve cache of a prefill or decode cell as meta tensors,
        its logical axes). The axes are None until the models'
        ``cache_axes()`` are ported (the LM half of ROADMAP §A.10)."""
        kind, seq, batch = SHAPES[shape_id]
        m = self.model()
        if self.frames:
            s_dec = max(seq // self.dec_frac, 128)
            cache = m.init_cache(batch, s_dec, enc_seq=seq, device="meta")
        else:
            cache = m.init_cache(batch, seq, device="meta")
        return cache, None
