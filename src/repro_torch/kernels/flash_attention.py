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

Training: when q, k or v requires a gradient (and grad mode is on),
``flash_attention`` goes through ``FlashAttention``, a
``torch.autograd.Function``. Its forward also writes the fp32 row
log-sum-exp lse_i = ln sum_j exp(s_ij) (B, H, Sq); its backward is the
hand-written ``csrc/flash_attention_bwd.cu`` (FlashAttention-2's backward:
a delta pass, dK/dV per kv block, dQ per q block, no float atomics; bf16 on
the tensor cores with P and dS split into two bf16 parts, fp32 on the fp32
cores, routed by type as the forward), and ``flash_attention_bwd_plain``
beside it is its plain version. Serving (no gradient) takes the path
without lse, unchanged.

``flash_attention`` runs the plain versions for CPU tensors and launches the
kernels for CUDA tensors; it never falls back from one to the other.
``launches`` counts forward kernel launches and ``bwd_launches`` backward
ones (one per backward call, which enqueues four kernels). Inside a cost
walk (``launch.op_analysis``) each launch is charged its ``kernels.work``,
and meta tensors take a branch that makes the kernels' outputs and
workspaces, empty, and charges the launch it stands for; outside a walk
meta tensors raise like any device without a kernel.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, work

Tensor = torch.Tensor

HEAD_DIMS = (16, 32, 64, 128, 256)
# the bf16 backward's D and lse2 rows are padded to a multiple of its dQ
# kernel's q block (csrc/flash_attention_bwd.cu, kRowPad)
_ROW_PAD = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: number of CUDA forward kernel launches so far (CPU calls do not count)
launches = 0
#: number of CUDA backward launches so far (one per backward call)
bwd_launches = 0


def _visible(sq: int, skv: int, window: int, device) -> Tensor:
    """(Sq, Skv) mask of the kv positions each q position sees."""
    qp = torch.arange(sq, device=device)[:, None]
    kp = torch.arange(skv, device=device)[None, :]
    ok = kp <= qp
    if window > 0:
        ok &= (qp - kp) < window
    return ok


def flash_attention_fwd_plain(q: Tensor, k: Tensor, v: Tensor,
                              window: int = 0):
    """The plain version: the whole (Sq, Skv) score matrix in fp32, as
    ``_naive_attn`` of the reference's kernel tests, with the kernel's rule
    for rows that see nothing (p = 0, output 0). Returns (out in q's dtype,
    the fp32 row log-sum-exp (B, H, Sq), -inf where a row sees nothing)."""
    b, h, sq, hd = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    grp = h // kvh
    kf = k.to(torch.float32).repeat_interleave(grp, dim=1)
    vf = v.to(torch.float32).repeat_interleave(grp, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32) * hd ** -0.5, kf)
    ok = _visible(sq, skv, window, q.device)
    s = torch.where(ok, s, -1e30)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.where(ok, torch.exp(s - m), 0.0)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vf)
    l = p.sum(dim=-1, keepdim=True)
    out = out / torch.clamp_min(l, 1e-20)
    lse = (m + torch.log(l))[..., 0]
    return out.to(q.dtype), lse


def flash_attention_plain(q: Tensor, k: Tensor, v: Tensor,
                          window: int = 0) -> Tensor:
    """``flash_attention_fwd_plain``'s output alone."""
    return flash_attention_fwd_plain(q, k, v, window)[0]


def flash_attention_bwd_plain(q: Tensor, k: Tensor, v: Tensor, o: Tensor,
                              lse: Tensor, do: Tensor, window: int = 0):
    """The plain backward, the kernel's formulas on whole matrices in fp32:
    p = exp(scale q.k - lse) where visible, D = rowsum(dO o), dS = p (dO.v -
    D); dQ = scale dS k, dK = scale dS^T q and dV = p^T dO, the last two
    summed over the query heads of each kv head. Returns (dq, dk, dv) in
    q's, k's and v's dtypes."""
    b, h, sq, hd = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    grp = h // kvh
    scale = hd ** -0.5
    f32 = torch.float32
    qf, of, dof = q.to(f32), o.to(f32), do.to(f32)
    kf = k.to(f32).repeat_interleave(grp, dim=1)
    vf = v.to(f32).repeat_interleave(grp, dim=1)
    ok = _visible(sq, skv, window, q.device)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    p = torch.where(ok, torch.exp(s - lse.to(f32)[..., None]), 0.0)
    dd = (dof * of).sum(dim=-1)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    ds = p * (dp - dd[..., None])
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    dk = dk.reshape(b, kvh, grp, skv, hd).sum(dim=2)
    dv = dv.reshape(b, kvh, grp, skv, hd).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_float]
             + [ctypes.c_longlong] * 12 + [ctypes.c_int, ctypes.c_void_p])
_BWD_ARGTYPES = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 8
                 + [ctypes.c_float] + [ctypes.c_longlong] * 15
                 + [ctypes.c_int, ctypes.c_void_p])


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
        _check_tma("flash_attention", q, k, v)


def _tma_strides(x: Tensor):
    """x's (B, heads, S) strides, a size-1 axis given its contiguous stride
    (its own stride is never used and may be anything)."""
    out, inner = [], x.shape[3]
    for ax in (2, 1, 0):
        out.append(x.stride(ax) if x.shape[ax] > 1 else inner)
        inner *= x.shape[ax]
    return out[::-1]


def _tma_loadable(x: Tensor) -> bool:
    """TMA's rule for a bf16 (B, heads, S, hd) view: the hd axis contiguous,
    a 16-byte aligned start, strides that are multiples of 8 elements."""
    return (x.stride(3) == 1 and x.data_ptr() % 16 == 0
            and not any(st % 8 for st in _tma_strides(x)))


def _check_tma(what: str, q: Tensor, k: Tensor, v: Tensor):
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not _tma_loadable(x):
            raise ValueError(
                f"{what}: bf16 {name} with strides {tuple(x.stride())} at a "
                f"{x.data_ptr() % 16}-byte offset; the tensor-core kernels "
                "load by TMA, which needs a 16-byte aligned start and "
                "strides that are multiples of 8 elements")


def _forward(q: Tensor, k: Tensor, v: Tensor, window: int, with_lse: bool):
    """The forward kernel on CUDA tensors: (out, lse or None)."""
    global launches
    _check(q, k, v, window)
    b, h, sq, hd = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if b == 0 or h == 0 or sq == 0:
        return out, lse
    if skv == 0:
        if lse is not None:
            lse.fill_(-float("inf"))
        return out.zero_(), lse
    fn = _build.function("flash_attention", "flash_attention_launch",
                         _ARGTYPES)
    index, stream = _build.stream(q.device)
    strides = [s for x in (q, k, v, out) for s in _tma_strides(x)]
    launches += 1
    work.charge("flash_attention", b, h, kvh, sq, skv, hd, window,
                q.element_size(), with_lse=with_lse)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             None if lse is None else lse.data_ptr(), _DTYPES[q.dtype], b, h,
             kvh, sq, skv, hd, window, hd ** -0.5, *strides, index, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    return out, lse


def _backward(q: Tensor, k: Tensor, v: Tensor, o: Tensor, lse: Tensor,
              do: Tensor, window: int):
    """The backward kernels on CUDA tensors: (dq, dk, dv), contiguous. bf16
    goes to the tensor-core kernels, which load q, k, v and dO by TMA: q, k
    or v that TMA cannot load is refused (ValueError), dO is copied to a
    contiguous tensor first."""
    global bwd_launches
    bf16 = q.dtype == torch.bfloat16
    if bf16:
        _check_tma("flash_attention backward", q, k, v)
        if not _tma_loadable(do):
            do = do.contiguous()
            if not _tma_loadable(do):          # a contiguous view off 16 B
                do = do.clone()
    elif do.stride(3) != 1:
        do = do.contiguous()
    b, h, sq, hd = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    dq = torch.empty((b, h, sq, hd), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, kvh, skv, hd), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, kvh, skv, hd), dtype=v.dtype, device=q.device)
    if b == 0 or h == 0 or sq == 0 or skv == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    f32 = dict(dtype=torch.float32, device=q.device)
    # bf16: D and lse2 = lse log2(e) padded to a multiple of _ROW_PAD rows
    rows = -(-sq // _ROW_PAD) * _ROW_PAD if bf16 else sq
    dd = torch.empty((b, h, rows), **f32)
    lse2 = torch.empty((b, h, rows), **f32) if bf16 else None
    dk_part = torch.empty((b, h, skv, hd), **f32)
    dv_part = torch.empty((b, h, skv, hd), **f32)
    fn = _build.function("flash_attention_bwd", "flash_attention_bwd_launch",
                         _BWD_ARGTYPES)
    index, stream = _build.stream(q.device)
    strides = [s for x in (q, k, v, o, do) for s in _tma_strides(x)]
    bwd_launches += 1
    work.charge("flash_attention_bwd", b, h, kvh, sq, skv, hd, window,
                q.element_size())
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             do.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
             dv.data_ptr(), dd.data_ptr(),
             None if lse2 is None else lse2.data_ptr(), dk_part.data_ptr(),
             dv_part.data_ptr(), _DTYPES[q.dtype], b, h, kvh, sq, skv, hd,
             window, hd ** -0.5, *strides, index, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention backward launch failed: CUDA "
                           f"error {err}")
    return dq, dk, dv


def _on_meta(what: str, *xs: Tensor):
    """The meta branch's gate: every tensor on meta, and a cost walk open
    (outside one there is no kernel for meta tensors)."""
    if any(x.device.type != "meta" for x in xs):
        raise ValueError(f"{what}: q on meta, another input on "
                         f"{[x.device.type for x in xs]}")
    if not work.active():
        raise ValueError(f"{what}: no kernel for device meta outside a "
                         "cost walk (launch.op_analysis)")


def _meta_forward(q: Tensor, k: Tensor, v: Tensor, window: int,
                  with_lse: bool):
    """The forward on meta tensors, inside a cost walk: ``_forward``'s
    outputs, empty, and one launch's work charged. Nothing runs."""
    _on_meta("flash_attention", q, k, v)
    b, h, sq, hd = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if b and h and sq and skv:
        work.charge("flash_attention", b, h, kvh, sq, skv, hd, window,
                    q.element_size(), with_lse=with_lse)
    return out, lse


def _meta_backward(q: Tensor, k: Tensor, v: Tensor, o: Tensor, lse: Tensor,
                   do: Tensor, window: int):
    """The backward on meta tensors, inside a cost walk: ``_backward``'s
    outputs and workspaces (D, lse2, the per-query-head dK and dV parts),
    empty, and one launch's work charged. Nothing runs."""
    _on_meta("flash_attention backward", q, k, v, o, lse, do)
    bf16 = q.dtype == torch.bfloat16
    copy = not _tma_loadable(do) if bf16 else do.stride(3) != 1
    if copy:
        do = do.contiguous()
    b, h, sq, hd = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    dq = torch.empty((b, h, sq, hd), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, kvh, skv, hd), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, kvh, skv, hd), dtype=v.dtype, device=q.device)
    if not (b and h and sq and skv):
        return dq, dk, dv
    f32 = dict(dtype=torch.float32, device=q.device)
    rows = -(-sq // _ROW_PAD) * _ROW_PAD if bf16 else sq
    scratch = [torch.empty((b, h, rows), **f32),
               torch.empty((b, h, skv, hd), **f32),
               torch.empty((b, h, skv, hd), **f32)]
    if bf16:
        scratch.append(torch.empty((b, h, rows), **f32))
    work.charge("flash_attention_bwd", b, h, kvh, sq, skv, hd, window,
                q.element_size())
    del scratch
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """``flash_attention`` with a gradient: plain forward and backward for
    CPU tensors, the kernels for CUDA tensors (their meta branches inside a
    cost walk)."""

    @staticmethod
    def forward(ctx, q, k, v, window):
        if q.device.type == "cpu":
            out, lse = flash_attention_fwd_plain(q, k, v, window)
        elif q.device.type == "meta":
            out, lse = _meta_forward(q, k, v, window, with_lse=True)
        else:
            out, lse = _forward(q, k, v, window, with_lse=True)
        ctx.window = window
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        if q.device.type == "cpu":
            grads = flash_attention_bwd_plain(q, k, v, out, lse, do,
                                              ctx.window)
        elif q.device.type == "meta":
            grads = _meta_backward(q, k, v, out, lse, do, ctx.window)
        else:
            grads = _backward(q, k, v, out, lse, do, ctx.window)
        return (*grads, None)


def flash_attention(q: Tensor, k: Tensor, v: Tensor,
                    window: int = 0) -> Tensor:
    """q (B, H, Sq, hd); k, v (B, KV, Skv, hd); any strides with the hd axis
    contiguous. Returns (B, H, Sq, hd) in q's dtype, laid out as q is (so a
    (B, S, H, hd) tensor seen as (B, H, S, hd) gives the same view back).
    Differentiable (``FlashAttention``) when an input requires a
    gradient."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, window)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, window)
    if q.device.type == "meta":
        return _meta_forward(q, k, v, window, with_lse=False)[0]
    return _forward(q, k, v, window, with_lse=False)[0]
