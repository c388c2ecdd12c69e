"""Training launcher helpers (port of ``repro.launch.train``, the part the
serving launcher uses): ``reduced_config``. The training loop, its mesh
and its checkpoints wait for ROADMAP §A.12 and §A.10."""
from __future__ import annotations

import dataclasses

__all__ = ["reduced_config"]


def reduced_config(model):
    """A small same-family model: 2 layers, d_model 64, 4 heads, d_ff 128,
    vocab 2,048, and an MoE config cut to 4 experts of d_ff 128 with
    top-k at most 2 — what ``--reduced`` serves, so the whole loop runs
    on the CPU."""
    from repro_torch.models.transformer import LMConfig
    cfg = model.cfg
    if isinstance(cfg, LMConfig):
        moe = cfg.moe
        if moe is not None:
            moe = dataclasses.replace(moe, d_model=64, d_ff=128, n_experts=4,
                                      top_k=min(moe.top_k, 2))
        small = dataclasses.replace(
            cfg, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
            head_dim=None, d_ff=128, vocab=2048, moe=moe,
            sliding_window=64 if cfg.sliding_window else None, remat="none")
        return type(model)(small)
    raise SystemExit(f"--reduced supports LM archs; got {type(cfg)}")
