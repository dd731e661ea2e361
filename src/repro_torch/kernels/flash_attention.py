"""Fused causal attention with GQA/MQA and an optional sliding window: the
CUDA kernels of ``csrc/flash_attention.cu`` (which replace the TPU kernel
``repro.kernels.flash_attention.flash_attention_pallas``) and their plain
PyTorch version. bf16 inputs go to the tensor-core kernel (wgmma, TMA), fp32
inputs to the kernel on the fp32 cores: a route by type, not a fallback.

    q (B, H, Sq, hd); k, v (B, KV, Skv, hd), H % KV == 0; query head h reads
    kv head h // (H / KV). Positions count from 0 in q and in kv alike; kv
    position j is visible to q position i when j <= i and, for window > 0,
    i - j < window. The scores are hd^-0.5 q.k in fp32; masked scores get
    p = 0, the output is acc / max(l, 1e-20) in q's dtype. The bf16 kernel
    rounds p to bf16 for the p.v product (the plain version does not).

Unlike the TPU kernel, neither version needs Sq or Skv to be a multiple of a
block: the kernel masks its ragged edges itself.

``flash_attention`` runs the plain version for CPU tensors and launches the
kernel for CUDA tensors; it never falls back from one to the other.
``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

Tensor = torch.Tensor

HEAD_DIMS = (16, 32, 64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: number of CUDA kernel launches so far (CPU calls do not count)
launches = 0


def flash_attention_plain(q: Tensor, k: Tensor, v: Tensor,
                          window: int = 0) -> Tensor:
    """The plain version: the whole (Sq, Skv) score matrix in fp32, as
    ``_naive_attn`` of the reference's kernel tests, with the kernel's rule
    for rows that see nothing (p = 0, output 0)."""
    b, h, sq, hd = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    grp = h // kvh
    kf = k.to(torch.float32).repeat_interleave(grp, dim=1)
    vf = v.to(torch.float32).repeat_interleave(grp, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32) * hd ** -0.5, kf)
    qp = torch.arange(sq, device=q.device)[:, None]
    kp = torch.arange(skv, device=q.device)[None, :]
    ok = kp <= qp
    if window > 0:
        ok &= (qp - kp) < window
    s = torch.where(ok, s, -1e30)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.where(ok, torch.exp(s - m), 0.0)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vf)
    out = out / torch.clamp_min(p.sum(dim=-1, keepdim=True), 1e-20)
    return out.to(q.dtype)


_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_float]
             + [ctypes.c_longlong] * 12 + [ctypes.c_int, ctypes.c_void_p])


def _check(q: Tensor, k: Tensor, v: Tensor, window: int):
    dev = q.device
    for name, x in (("k", k), ("v", v)):
        if x.device != dev:
            raise ValueError(f"flash_attention: q on {dev}, {name} on "
                             f"{x.device}")
    if dev.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {dev}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} must be "
                         "(B, heads, S, hd)")
    b, h, _, hd = q.shape
    kvh = k.shape[1]
    if (k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd
            or kvh < 1 or h % kvh):
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not "
                         "match (H % KV == 0, same B and hd, k and v alike)")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k, v are {q.dtype}, {k.dtype}, "
                        f"{v.dtype}; the kernel takes all float32 or all "
                        "bfloat16")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: hd={hd} is not one of "
                         f"{HEAD_DIMS}")
    if any(x.stride(3) != 1 for x in (q, k, v)):
        raise ValueError("flash_attention: the hd axis of q, k and v must "
                         "be contiguous (stride 1)")
    if window < 0:
        raise ValueError(f"flash_attention: window={window} < 0")
    if b > 65535 or h > 65535:
        raise ValueError(f"flash_attention: B={b} or H={h} > 65535")
    if q.dtype == torch.bfloat16:
        for name, x in (("q", q), ("k", k), ("v", v)):
            if x.data_ptr() % 16 or any(st % 8 for st in _tma_strides(x)):
                raise ValueError(
                    f"flash_attention: bf16 {name} with strides "
                    f"{tuple(x.stride())} at a {x.data_ptr() % 16}-byte "
                    "offset; the tensor-core kernel loads by TMA, which "
                    "needs a 16-byte aligned start and strides that are "
                    "multiples of 8 elements")


def _tma_strides(x: Tensor):
    """x's (B, heads, S) strides, a size-1 axis given its contiguous stride
    (its own stride is never used and may be anything)."""
    out, inner = [], x.shape[3]
    for ax in (2, 1, 0):
        out.append(x.stride(ax) if x.shape[ax] > 1 else inner)
        inner *= x.shape[ax]
    return out[::-1]


def flash_attention(q: Tensor, k: Tensor, v: Tensor,
                    window: int = 0) -> Tensor:
    """q (B, H, Sq, hd); k, v (B, KV, Skv, hd); any strides with the hd axis
    contiguous. Returns (B, H, Sq, hd) in q's dtype, laid out as q is (so a
    (B, S, H, hd) tensor seen as (B, H, S, hd) gives the same view back)."""
    global launches
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, window)
    _check(q, k, v, window)
    b, h, sq, hd = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if b == 0 or h == 0 or sq == 0:
        return out
    if skv == 0:
        return out.zero_()
    fn = _build.function("flash_attention", "flash_attention_launch",
                         _ARGTYPES)
    dev = q.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    strides = [s for x in (q, k, v, out) for s in _tma_strides(x)]
    launches += 1
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             _DTYPES[q.dtype], b, h, kvh, sq, skv, hd, window, hd ** -0.5,
             *strides, dev.index or 0, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    return out
