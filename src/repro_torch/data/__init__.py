"""Deterministic, checkpointable synthetic data (port of ``repro.data``)."""
from repro_torch.data.pipeline import (SyntheticMNIST, SyntheticTextConfig,
                                       SyntheticTextIterator, shard_batch)

__all__ = ["SyntheticTextConfig", "SyntheticTextIterator", "SyntheticMNIST",
           "shard_batch"]
