"""AdamW, its schedules and global-norm clipping (port of ``repro.optim``)."""
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.clip import clip_by_global_norm, global_norm
from repro_torch.optim.schedule import cosine_schedule, linear_warmup

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_schedule",
           "linear_warmup", "global_norm", "clip_by_global_norm"]
