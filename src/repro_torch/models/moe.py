"""Mixture-of-Experts layer: token-choice top-k routing with capacity (port
of ``repro.models.moe``).

``moe`` is the reference's single-device ``_moe_gspmd`` path: a
global-capacity dispatch of the B*S tokens into an (E, C, D) buffer, the
expert FFNs as batched products over the expert axis (``torch.bmm``, as the
reference leaves its ``einsum`` to XLA outside any Pallas kernel), and a
weighted combine. The reference's ``_moe_shard_map`` (GShard local groups
with an all-to-all over a 'model' mesh axis) is not ported: it needs a 2-D
(data, model) mesh, which the port does not have (ROADMAP.md queue 1 item
4), so ``moe`` always takes the single-device path.

Dispatch order is the reference's: an entry's rank within its expert is a
cumsum over the token-major, k-minor flattening of the top-k experts, so
the same entries are dropped when an expert receives more than C. A
dropped entry is clamped to rank C - 1 and scattered as zeros with an
accumulating ``index_put_``, the reference's ``.at[].add``: it adds 0 to
the kept token at C - 1 and never overwrites it, on the CPU and on the card
alike. The router runs in fp32 (no TF32): routing is discrete, and a
near-tie of two experts' probabilities can flip a top-k set between two
computations that differ in the last bits.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L

Tensor = torch.Tensor


class MoEConfig(NamedTuple):
    d_model: int
    d_ff: int
    num_experts: int
    experts_per_token: int
    capacity_factor: float = 1.25
    act: str = "swiglu"
    router_aux_weight: float = 0.01


def init_moe(g, cfg: MoEConfig, device=None):
    e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    return {
        "router": L.truncated_normal(g, (d, e), 0.02, device),
        "expert_gate": L.he_init(g, (e, d, f), d, device),
        "expert_up": L.he_init(g, (e, d, f), d, device),
        "expert_down": L.he_init(g, (e, f, d), f, device),
    }


def capacity(n_tokens: int, cfg: MoEConfig) -> int:
    """Slots per expert for ``n_tokens`` routed tokens: k/E of them times
    the capacity factor, rounded up to a multiple of 4, at least 4."""
    c = int(n_tokens * cfg.experts_per_token * cfg.capacity_factor
            / cfg.num_experts)
    return max(4, -(-c // 4) * 4)


def _router(params, cfg: MoEConfig, xt: Tensor):
    """(probs (N, E), top_p (N, k) renormalised, top_e (N, k)), in fp32,
    the top-k sorted by probability."""
    logits = xt.to(torch.float32) @ params["router"].to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, cfg.experts_per_token, dim=-1,
                              sorted=True)
    top_p = top_p / torch.sum(top_p, dim=-1, keepdim=True)
    return probs, top_p, top_e


def _one_hot(idx: Tensor, n: int) -> Tensor:
    """``F.one_hot(idx, n)`` as the card runs it, int64 zeros and a scatter
    of ones, on every device: on meta ``F.one_hot`` compares against an
    arange instead, so the dry run (``launch.op_analysis``) would walk other
    ops there than the card runs."""
    out = torch.zeros(idx.shape + (n,), dtype=torch.int64, device=idx.device)
    return out.scatter_(-1, idx.unsqueeze(-1), 1)


def _aux_loss(cfg: MoEConfig, probs: Tensor, top_e: Tensor) -> Tensor:
    """Switch-style load-balancing loss (fp32 scalar)."""
    me = torch.mean(probs, dim=0)
    ce = torch.mean(torch.sum(_one_hot(top_e, cfg.num_experts).to(
        torch.float32), dim=1), dim=0)
    return cfg.router_aux_weight * cfg.num_experts * torch.sum(me * ce)


def _local_dispatch(xt: Tensor, top_e: Tensor, top_p: Tensor, e: int,
                    c: int):
    """Scatter n tokens into an (E, c, D) buffer; returns the buffer plus
    (flat_e, flat_pos, keep, flat_p) for the combine."""
    n, d = xt.shape
    k = top_e.shape[-1]
    flat_e = top_e.reshape(-1)
    flat_p = top_p.reshape(-1)
    # rank within expert: the reference's cumsum over the entries, run
    # along the contiguous axis of the (E, N*k) transpose (on the card a
    # scan over the outer axis of (N*k, E) takes 23 ms at olmoe's 65,536
    # entries, this one 0.24 ms: tools/moe_dispatch.py)
    onehot = _one_hot(flat_e, e).T.contiguous()
    ranks = torch.cumsum(onehot, dim=1) - onehot
    flat_pos = ranks[flat_e, torch.arange(n * k, device=xt.device)]
    keep = flat_pos < c
    flat_pos = torch.clamp_max(flat_pos, c - 1)
    tok_idx = torch.arange(n, device=xt.device).repeat_interleave(k)
    src = torch.where(keep[:, None], xt[tok_idx], 0).to(xt.dtype)
    xb = xt.new_zeros((e, c, d)).index_put_((flat_e, flat_pos), src,
                                            accumulate=True)
    return xb, (flat_e, flat_pos, keep, flat_p)


def _experts(params, cfg: MoEConfig, xb: Tensor) -> Tensor:
    """The expert FFNs over the (E, C, D) buffer, in its dtype."""
    dt = xb.dtype
    h = torch.bmm(xb, params["expert_gate"].to(dt))
    # jax.nn.gelu defaults to the tanh approximation
    h = F.silu(h) if cfg.act == "swiglu" else F.gelu(h, approximate="tanh")
    h = h * torch.bmm(xb, params["expert_up"].to(dt))
    return torch.bmm(h, params["expert_down"].to(dt))       # (E, C, D)


def _combine(yb: Tensor, route, n: int, k: int) -> Tensor:
    """Each token's kept expert outputs, weighted by its renormalised
    probabilities and summed over k: (n, D)."""
    flat_e, flat_pos, keep, flat_p = route
    gathered = yb[flat_e, flat_pos]                          # (N*k, D)
    weighted = gathered * (flat_p * keep)[:, None].to(yb.dtype)
    return torch.sum(weighted.reshape(n, k, -1), dim=1)


def moe(params, cfg: MoEConfig, x: Tensor):
    """x: (B, S, D) -> (y: (B, S, D), aux_loss: scalar fp32). Capacity is
    computed from all B*S tokens, so the rows of a batch compete for it."""
    b, s, d = x.shape
    n = b * s
    c = capacity(n, cfg)
    xt = x.reshape(n, d)
    probs, top_p, top_e = _router(params, cfg, xt)
    aux = _aux_loss(cfg, probs, top_e)
    xb, route = _local_dispatch(xt, top_e, top_p, cfg.num_experts, c)
    yb = _experts(params, cfg, xb)
    y = _combine(yb, route, n, cfg.experts_per_token)
    return y.reshape(b, s, d), aux
