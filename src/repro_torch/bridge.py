"""JAX-to-PyTorch parameter bridge.

``params_from_numpy(tree, device)`` turns a params tree whose leaves are
numpy arrays — a JAX ``init`` output converted to numpy by the caller —
into the port's params in the same nested layout: the CNNs' conv weights
(M, N, Kh, Kw), biases (M,), ``fc_w`` (K, N), and the LM's
layer-stacked tree (``embedding``, ``layers/{attn, mlp, ln1, ln2}``,
``final_norm``, ``lm_head`` when untied), an MoE model's experts in
place of ``mlp`` (``layers/moe/{router, wi, wg, wo}`` and, with shared
experts, ``shared_{wi, wg, wo}``) and gemma2's ``ln*_post`` and
command-r's ``ln*_bias`` norms; the Mamba2 hybrid's
``mamba_layers/{mamba/{in_proj, conv_w, conv_b, A_log, D, dt_bias,
norm, out_proj}, ln}`` and ``shared/{concat_proj, attn, mlp, ln1,
ln2}``; and the RWKV-6 LM's ``ln0``/``ln0_b``, ``layers/{ln1, mix, w0,
w_lora_a, u, wr, ..., ck, cv, cr}``, ``final_norm``/``final_norm_b`` and
its untied ``lm_head``; the encoder-decoder's ``enc_layers/{attn, mlp,
ln1, ln2}``, ``dec_layers/{self_attn, cross_attn, mlp, ln1, ln2, ln3}``,
``enc_norm`` and ``final_norm``; and an AdamW state ``{m, v, step}``.
Any nested dict of float leaves comes through key for key. Both
packages then compute the same function, which is how the tests hold
one against the other. Nothing here imports JAX.

A bfloat16 leaf (numpy's view of a JAX bf16 array, dtype name
``bfloat16``) becomes a ``torch.bfloat16`` tensor with the same values:
bf16 → fp32 → bf16 is exact. Every other float leaf becomes float32,
and a 0-d integer leaf (AdamW's ``step`` counter) an int32 scalar; an
integer array is no parameter and raises.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["params_from_numpy"]


def params_from_numpy(tree, device: str | torch.device) -> dict | torch.Tensor:
    """Nested dicts of float arrays -> the same dicts of tensors on
    ``device``: bfloat16 leaves as bfloat16, other floats as float32,
    0-d integers as int32."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, dev) for k, v in tree.items()}
    arr = np.asarray(tree)
    bf16 = arr.dtype.name == "bfloat16"
    if np.issubdtype(arr.dtype, np.integer) and arr.ndim == 0:
        return torch.from_numpy(np.array(arr, np.int32)).to(dev)
    if not (bf16 or np.issubdtype(arr.dtype, np.floating)):
        raise TypeError(f"params leaf of dtype {arr.dtype} and shape "
                        f"{arr.shape}; expected a float array or a 0-d "
                        f"integer")
    t = torch.from_numpy(np.array(arr, np.float32))
    return (t.to(torch.bfloat16) if bf16 else t).to(dev)
