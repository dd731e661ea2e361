"""int8 gradient compression with error feedback (port of
``repro.train.grad_compress``).

Gradients are quantized to int8 (a per-leaf absmax scale) and dequantized,
and the quantization error is fed back into the next step's gradient
(error feedback keeps Adam's convergence). In the reference the Q -> DQ
pair lets XLA all-reduce the int8 form; on one card nothing is reduced,
and the pair models the accuracy contract. ``torch.round`` rounds half to
even, as ``jnp.round`` does.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

Tensor = torch.Tensor


def quantize_int8(x: Tensor) -> Tuple[Tensor, Tensor]:
    scale = torch.clamp_min(torch.max(torch.abs(x)), 1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: Tensor, scale: Tensor) -> Tensor:
    return q.to(torch.float32) * scale


@torch.no_grad()
def compress_decompress(grads: Dict[str, Tensor],
                        error_feedback: Dict[str, Tensor]):
    """int8 Q -> DQ with error feedback. Returns (grads, new_ef), new dicts
    with the same keys."""
    out_g, out_e = {}, {}
    for name, g in grads.items():
        e = error_feedback[name]
        g32 = g.to(torch.float32) + e.to(torch.float32)
        q, s = quantize_int8(g32)
        dq = dequantize_int8(q, s)
        out_g[name] = dq.to(g.dtype)
        out_e[name] = (g32 - dq).to(e.dtype)
    return out_g, out_e
