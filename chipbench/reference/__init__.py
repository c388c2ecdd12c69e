"""The benchmark's plain reference: a frozen PyTorch statement of what the
program must compute, which imports nothing of the program."""
from chipbench.reference.cnn import forward, quantize

__all__ = ["forward", "quantize"]
