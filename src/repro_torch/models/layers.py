"""Dense building blocks: norms, RoPE, MLPs, embeddings (port of
``repro.models.layers``).

Function style as in the reference: ``init_*(generator, ...) -> dict of
tensors``, ``apply(params, x)``, where ``params`` is any mapping of names
to tensors (a dict, or a ``models.transformer.ParamTree``). Parameters are
stored fp32 (master copy); compute casts to the activation dtype at use.
Initialisation draws from an explicit ``torch.Generator`` on the device
the tensors are made on; its numbers are not JAX's, so tests that compare
the two packages bring the JAX weights across (``convert``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def truncated_normal(g: Optional[torch.Generator], shape, stddev,
                     device=None) -> Tensor:
    """``stddev * truncated_normal(-2, 2)``: torch's bounds are absolute."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    if t.device.type == "meta":
        return t
    return torch.nn.init.trunc_normal_(t, std=stddev, a=-2.0 * stddev,
                                       b=2.0 * stddev, generator=g)


def he_init(g, shape, fan_in, device=None) -> Tensor:
    return truncated_normal(g, shape, (2.0 / max(fan_in, 1)) ** 0.5, device)


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------

def init_rmsnorm(d: int, device=None):
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


def rmsnorm(params, x: Tensor, eps: float = 1e-6) -> Tensor:
    dt = x.dtype
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"]).to(dt)


def init_groupnorm(d: int, device=None):
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device),
            "bias": torch.zeros((d,), dtype=torch.float32, device=device)}


def groupnorm(params, x: Tensor, groups: int, eps: float = 1e-5) -> Tensor:
    """GroupNorm over the last dim (RWKV6 per-head wkv normalization)."""
    dt = x.dtype
    d = x.shape[-1]
    xg = x.to(torch.float32).reshape(x.shape[:-1] + (groups, d // groups))
    mean = torch.mean(xg, dim=-1, keepdim=True)
    var = torch.var(xg, dim=-1, keepdim=True, correction=0)
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    return (y * params["scale"] + params["bias"]).to(dt)


# --------------------------------------------------------------------------
# rotary position embedding
# --------------------------------------------------------------------------

def rope(x: Tensor, positions: Tensor, theta: float = 1e4) -> Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., :, None, None].to(torch.float32) * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# gated MLPs
# --------------------------------------------------------------------------

def init_mlp(g, d_model: int, d_ff: int, device=None):
    return {
        "w_gate": he_init(g, (d_model, d_ff), d_model, device),
        "w_up": he_init(g, (d_model, d_ff), d_model, device),
        "w_down": he_init(g, (d_ff, d_model), d_ff, device),
    }


def mlp(params, x: Tensor, act: str = "swiglu") -> Tensor:
    dt = x.dtype
    wg = params["w_gate"].to(dt)
    wu = params["w_up"].to(dt)
    wd = params["w_down"].to(dt)
    gate = x @ wg
    # jax.nn.gelu defaults to the tanh approximation
    gate = F.silu(gate) if act == "swiglu" else F.gelu(gate,
                                                       approximate="tanh")
    return (gate * (x @ wu)) @ wd


# --------------------------------------------------------------------------
# embeddings / logits
# --------------------------------------------------------------------------

def init_embedding(g, vocab: int, d_model: int, device=None):
    return {"table": truncated_normal(g, (vocab, d_model), 0.02, device)}


def embed(params, tokens: Tensor, dtype) -> Tensor:
    return params["table"].to(dtype)[tokens]


def logits(params, x: Tensor, tied_table: Optional[Tensor] = None) -> Tensor:
    """Final projection with fp32 accumulation for the softmax: the
    operands are rounded to x's dtype, then multiplied in fp32 (a bf16
    matmul would round its output to bf16)."""
    table = tied_table if tied_table is not None else params["table"]
    table = table.to(x.dtype).to(torch.float32)
    return x.to(torch.float32) @ table.T


def init_unembed(g, vocab: int, d_model: int, device=None):
    return {"table": truncated_normal(g, (vocab, d_model), 0.02, device)}
