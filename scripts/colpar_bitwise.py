#!/usr/bin/env python3
"""Whether a column-parallel bf16 product is bitwise to the whole one on
the card: ``x @ w[:, cols]`` against the same columns of ``x @ w``, at
the LMs' projection shapes (K, N) split in two, for a decode step's and
a prefill's row counts M, with cuBLAS's reduced-precision split-K
reduction allowed and not.

    python3 scripts/colpar_bitwise.py

Prints one JSON line a (reduction flag, M, shape): the largest |diff| of
each half. A nonzero reading means cuBLAS took another kernel (split K)
for the half-width product. Needs a CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import json
import subprocess
import sys

# (name, K, N): zamba2-7b's packed Mamba2 in_proj, its shared attention's
# q (32 heads of 112), its logits; qwen1.5-0.5b's and dbrx-132b's q
SHAPES = [("zamba2 in_proj", 3584, 14576), ("zamba2 attention q", 3584, 3584),
          ("zamba2 logits", 3584, 32000), ("qwen1.5 attention q", 1024, 1024),
          ("dbrx attention q", 6144, 6144)]
ROWS = (4, 8, 2048)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"card": smi, "torch": torch.__version__}))
    g = torch.Generator(device="cuda").manual_seed(0)
    for flag in (True, False):
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction \
            = flag
        for m in ROWS:
            for name, k, n in SHAPES:
                x = torch.randn(m, k, generator=g, device="cuda").bfloat16()
                w = torch.randn(k, n, generator=g, device="cuda").bfloat16()
                full = (x @ w).float()
                c = n // 2
                diffs = [float(((x @ w[:, j * c:(j + 1) * c].contiguous())
                                .float() - full[:, j * c:(j + 1) * c])
                               .abs().max()) for j in range(2)]
                print(json.dumps({"reduced_precision_reduction": flag,
                                  "M": m, "shape": name, "K": k, "N": n,
                                  "half_max_abs": diffs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
