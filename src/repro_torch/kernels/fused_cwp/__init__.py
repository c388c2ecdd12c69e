"""fused_cwp: plain version (ref.py), CUDA wrapper (ops.py)."""
