"""conv_window: plain version (ref.py), CUDA wrapper (ops.py)."""
