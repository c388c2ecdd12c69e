"""addtree: plain version (ref.py), CUDA wrapper (ops.py)."""
