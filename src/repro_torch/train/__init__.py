"""The training step (port of ``repro.train``): gradients, microbatched
accumulation and the AdamW update; ``train.mnist`` runs the paper's
experiment."""
from repro_torch.train.steps import loss_and_grads, make_train_step

__all__ = ["loss_and_grads", "make_train_step"]
