"""WKV recurrence (RWKV6): the CUDA kernel ``csrc/ssm_scan.cu`` (which
replaces the TPU kernel ``repro.kernels.ssm_scan.ssm_scan_pallas``) and
its plain PyTorch version.

    S_t = diag(w_t) S_{t-1} + k_t^T v_t              (state: dk x dv)
    y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)

Beyond the TPU kernel, which starts from a zero state and keeps its final
state to itself, both versions take an initial state ``s0`` and return the
final state, the contract of ``core.linear_attn.wkv_chunked`` that the
model's prefill and chunked prefill need. With ``s0 = None`` and the final
state dropped it is ``ssm_scan_pallas``. Neither version clamps ``w``: the
caller does, as ``wkv_chunked`` does.

Training: when an input requires a gradient (and grad mode is on),
``ssm_scan`` goes through ``SSMScan``, a ``torch.autograd.Function`` whose
backward is the hand-written ``csrc/ssm_scan_bwd.cu`` (dr, dw, dk, dv, du
and ds0 from dy and the final state's gradient; it recomputes the states
from checkpoints every 6 steps instead of undoing steps, which would
divide by w, and launches one thread-block cluster per row, whose CTAs add
their column sums through distributed shared memory), with
``ssm_scan_bwd_plain`` beside it as its plain version.

``ssm_scan`` runs the plain versions for CPU tensors and launches the
kernels for CUDA tensors; it never falls back from one to the other.
``launches`` counts forward kernel launches and ``bwd_launches`` backward
ones (one per backward call, which enqueues one kernel, or two with u).
Inside a cost walk (``launch.op_analysis``) each launch is charged its
``kernels.work``, and meta tensors take a branch that makes the kernels'
outputs and workspaces, empty, and charges the launch it stands for;
outside a walk meta tensors raise like any device without a kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.core.linear_attn import wkv_steps
from repro_torch.kernels import _build, work

Tensor = torch.Tensor

DK_MAX = 64
DV_MAX = 128

#: number of CUDA forward kernel launches so far (CPU calls do not count)
launches = 0
#: number of CUDA backward launches so far (one per backward call)
bwd_launches = 0
# the backward kernel's tiling: value columns per CTA, steps per checkpoint,
# and floats per CTA checkpoint (64 lanes x a 4 x 4 state tile)
_BWD_COLS, _BWD_CHUNK, _BWD_CKPT = 16, 6, 1024


def ssm_scan_plain(r: Tensor, w: Tensor, k: Tensor, v: Tensor,
                   u: Optional[Tensor] = None, s0: Optional[Tensor] = None
                   ) -> Tuple[Tensor, Tensor]:
    """The plain version: ``ref.ssm_scan_ref``'s step loop in fp32
    (``core.linear_attn.wkv_steps``), with the initial state ``s0`` (B, dk,
    dv) and the final state returned."""
    return wkv_steps(r, w, k, v, u, s0)


def ssm_scan_bwd_plain(r: Tensor, w: Tensor, k: Tensor, v: Tensor,
                       u: Optional[Tensor], s0: Optional[Tensor],
                       dy: Optional[Tensor], ds_final: Optional[Tensor]):
    """The plain backward, the kernel's recurrence one step at a time in
    fp32: the states S_{t-1} kept from a forward pass, then, walking t
    down with G = dL/dS_t (from ``ds_final``, or zero),

        dr_t = (S_{t-1} + diag(u) k_t^T v_t) dy_t^T
        dk_t = (G + diag(r_t u) 1 dy_t) v_t^T,  dv_t = k_t (G + ...)
        dw_t = rowsum(G (.) S_{t-1}),  du += r_t k_t (dy_t . v_t)
        G <- diag(w_t) G + r_t^T dy_t

    Returns (dr, dw, dk, dv, du or None, ds0 or None), fp32."""
    b, t, dk = r.shape
    dv = v.shape[-1]
    f32 = torch.float32
    r, w, k, v = (z.to(f32) for z in (r, w, k, v))
    uu = r.new_zeros((dk,)) if u is None else u.to(f32)
    dy = r.new_zeros((b, t, dv)) if dy is None else dy.to(f32)
    s = r.new_zeros((b, dk, dv)) if s0 is None else s0.to(f32)
    states = []
    for i in range(t):
        states.append(s)
        s = w[:, i, :, None] * s + k[:, i, :, None] * v[:, i, None, :]
    g = (r.new_zeros((b, dk, dv)) if ds_final is None
         else ds_final.to(f32).clone())
    dr, dw, dkk = (torch.empty_like(r) for _ in range(3))
    dvv = torch.empty_like(v)
    du = r.new_zeros((dk,))
    for i in reversed(range(t)):
        sp = states[i]
        ri, wi, ki, vi, di = r[:, i], w[:, i], k[:, i], v[:, i], dy[:, i]
        gb = g + (ri * uu)[:, :, None] * di[:, None, :]
        dr[:, i] = ((sp + (uu * ki)[:, :, None] * vi[:, None, :])
                    * di[:, None, :]).sum(-1)
        dkk[:, i] = (gb * vi[:, None, :]).sum(-1)
        dvv[:, i] = (gb * ki[:, :, None]).sum(1)
        dw[:, i] = (g * sp).sum(-1)
        du += (ri * ki * (di * vi).sum(-1, keepdim=True)).sum(0)
        g = wi[:, :, None] * g + ri[:, :, None] * di[:, None, :]
    return (dr, dw, dkk, dvv, None if u is None else du,
            None if s0 is None else g)


_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_OCC_ARGTYPES = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 3


def _prepare(r, w, k, v, u, s0):
    """Checks for the kernels; the inputs as contiguous fp32."""
    dev = r.device
    others = [("w", w), ("k", k), ("v", v), ("u", u), ("s0", s0)]
    for name, x in others:
        if x is not None and x.device != dev:
            raise ValueError(f"ssm_scan: r on {dev}, {name} on {x.device}")
    if dev.type != "cuda":
        raise ValueError(f"ssm_scan: no kernel for device {dev}")
    if r.dim() != 3 or v.dim() != 3:
        raise ValueError(f"ssm_scan: r {tuple(r.shape)} and v "
                         f"{tuple(v.shape)} must be (B, T, d)")
    b, t, dk = r.shape
    dv = v.shape[-1]
    if (tuple(w.shape) != (b, t, dk) or tuple(k.shape) != (b, t, dk)
            or tuple(v.shape[:2]) != (b, t)):
        raise ValueError(f"ssm_scan: shapes r {tuple(r.shape)}, w "
                         f"{tuple(w.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} do not match")
    if u is not None and tuple(u.shape) != (dk,):
        raise ValueError(f"ssm_scan: u {tuple(u.shape)} is not ({dk},)")
    if s0 is not None and tuple(s0.shape) != (b, dk, dv):
        raise ValueError(f"ssm_scan: s0 {tuple(s0.shape)} is not "
                         f"({b}, {dk}, {dv})")
    if not 1 <= dk <= DK_MAX:
        raise ValueError(f"ssm_scan: dk={dk} outside [1, {DK_MAX}]")
    if not 1 <= dv <= DV_MAX:
        raise ValueError(f"ssm_scan: dv={dv} outside [1, {DV_MAX}]")
    f32 = [None if x is None else x.to(torch.float32)
           for x in (r, w, k, v, u, s0)]
    if not all(x is None or x.is_contiguous() for x in f32):
        raise ValueError("ssm_scan: inputs must be contiguous")
    return f32


def _forward(r, w, k, v, u, s0) -> Tuple[Tensor, Tensor]:
    """The forward kernel on prepared CUDA tensors."""
    global launches
    dev = r.device
    b, t, dk = r.shape
    dv = v.shape[-1]
    y = torch.empty((b, t, dv), dtype=torch.float32, device=dev)
    s_final = torch.empty((b, dk, dv), dtype=torch.float32, device=dev)
    if b == 0:
        return y, s_final
    fn = _build.function("ssm_scan", "ssm_scan_launch", _ARGTYPES)
    index, stream = _build.stream(dev)
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    launches += 1
    work.charge("ssm_scan", b, t, dk, dv, u is not None, s0 is not None)
    err = fn(ptr(r), ptr(w), ptr(k), ptr(v), ptr(u), ptr(s0), y.data_ptr(),
             s_final.data_ptr(), b, t, dk, dv, index, stream)
    if err != 0:
        raise RuntimeError(f"ssm_scan kernel launch failed: CUDA error {err}")
    return y, s_final


def bwd_scratch_floats(b: int, t: int, dv: int) -> int:
    """fp32 checkpoints the backward kernel keeps: one 4 x 4 tile per lane
    of each of its b * ceil(dv / 16) CTAs every 6 steps."""
    return b * -(-dv // _BWD_COLS) * -(-t // _BWD_CHUNK) * _BWD_CKPT


def bwd_occupancy(b: int, dv: int, device=None) -> dict:
    """What the backward's cluster launch at (b, dv) gets on the card: its
    grid, cluster size and shared memory per CTA, the clusters the device
    holds at once (cudaOccupancyMaxActiveClusters) and so the CTAs per SM
    and whether the grid is resident in one wave."""
    dev = torch.device("cuda" if device is None else device)
    index, _ = _build.stream(dev)
    fn = _build.function("ssm_scan_bwd", "ssm_scan_bwd_occupancy",
                         _OCC_ARGTYPES)
    clusters, size, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = fn(b, dv, index, ctypes.byref(clusters), ctypes.byref(size),
             ctypes.byref(smem))
    if err != 0:
        raise RuntimeError(f"ssm_scan backward occupancy query failed: CUDA "
                           f"error {err}")
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    grid = b * size.value
    return {"grid": grid, "cluster": size.value,
            "smem_bytes": smem.value, "max_active_clusters": clusters.value,
            "ctas_per_sm": clusters.value * size.value / sms,
            "one_wave": clusters.value * size.value >= grid}


def _backward(r, w, k, v, u, s0, dy, ds_final):
    """The backward kernels on prepared CUDA tensors: (dr, dw, dk, dv, du or
    None, ds0 or None), fp32."""
    global bwd_launches
    dev = r.device
    b, t, dk = r.shape
    dv = v.shape[-1]
    f32 = dict(dtype=torch.float32, device=dev)
    dy = (torch.zeros((b, t, dv), **f32) if dy is None
          else dy.to(torch.float32).contiguous())
    if ds_final is not None:
        ds_final = ds_final.to(torch.float32).contiguous()
    dr, dw, dkk = (torch.empty((b, t, dk), **f32) for _ in range(3))
    dvv = torch.empty((b, t, dv), **f32)
    du = torch.empty((dk,), **f32) if u is not None else None
    ds0 = torch.empty((b, dk, dv), **f32) if s0 is not None else None
    if b == 0 or t == 0:
        for x in (dr, dw, dkk, dvv, du):
            if x is not None:
                x.zero_()
        if ds0 is not None:
            ds0.copy_(torch.zeros_like(ds0) if ds_final is None
                      else ds_final)
        return dr, dw, dkk, dvv, du, ds0
    ckpt = torch.empty((bwd_scratch_floats(b, t, dv),), **f32)
    du_part = torch.empty((b * dk,), **f32) if u is not None else None
    fn = _build.function("ssm_scan_bwd", "ssm_scan_bwd_launch", _BWD_ARGTYPES)
    index, stream = _build.stream(dev)
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    bwd_launches += 1
    work.charge("ssm_scan_bwd", b, t, dk, dv, u is not None, s0 is not None,
                ds_final is not None)
    err = fn(ptr(r), ptr(w), ptr(k), ptr(v), ptr(u), ptr(s0), ptr(dy),
             ptr(ds_final), ptr(dr), ptr(dw), ptr(dkk), ptr(dvv), ptr(du),
             ptr(ds0), ptr(ckpt), ptr(du_part), b, t, dk, dv, index, stream)
    if err != 0:
        raise RuntimeError(f"ssm_scan backward launch failed: CUDA error "
                           f"{err}")
    return dr, dw, dkk, dvv, du, ds0


def _meta_prepare(r, w, k, v, u, s0):
    """The meta branch's gate and ``_prepare``'s conversions: every input
    on meta, a cost walk open (outside one there is no kernel for meta
    tensors), the inputs as fp32."""
    ins = (r, w, k, v, u, s0)
    if any(x is not None and x.device.type != "meta" for x in ins):
        raise ValueError("ssm_scan: r on meta, another input on "
                         f"{[x.device.type for x in ins if x is not None]}")
    if not work.active():
        raise ValueError("ssm_scan: no kernel for device meta outside a "
                         "cost walk (launch.op_analysis)")
    return [None if x is None else x.to(torch.float32) for x in ins]


def _meta_forward(r, w, k, v, u, s0) -> Tuple[Tensor, Tensor]:
    """The forward on prepared meta tensors, inside a cost walk:
    ``_forward``'s outputs, empty, and one launch's work charged."""
    b, t, dk = r.shape
    dv = v.shape[-1]
    y = torch.empty((b, t, dv), dtype=torch.float32, device=r.device)
    s_final = torch.empty((b, dk, dv), dtype=torch.float32, device=r.device)
    if b:
        work.charge("ssm_scan", b, t, dk, dv, u is not None, s0 is not None)
    return y, s_final


def _meta_backward(r, w, k, v, u, s0, dy, ds_final):
    """The backward on prepared meta tensors, inside a cost walk:
    ``_backward``'s outputs and workspaces (dy's zeros, the checkpoints,
    du's partials), empty, and one launch's work charged."""
    b, t, dk = r.shape
    dv = v.shape[-1]
    f32 = dict(dtype=torch.float32, device=r.device)
    dy = (torch.zeros((b, t, dv), **f32) if dy is None
          else dy.to(torch.float32).contiguous())
    if ds_final is not None:
        ds_final = ds_final.to(torch.float32).contiguous()
    dr, dw, dkk = (torch.empty((b, t, dk), **f32) for _ in range(3))
    dvv = torch.empty((b, t, dv), **f32)
    du = torch.empty((dk,), **f32) if u is not None else None
    ds0 = torch.empty((b, dk, dv), **f32) if s0 is not None else None
    if b and t:
        ckpt = torch.empty((bwd_scratch_floats(b, t, dv),), **f32)
        du_part = torch.empty((b * dk,), **f32) if u is not None else None
        work.charge("ssm_scan_bwd", b, t, dk, dv, u is not None,
                    s0 is not None, ds_final is not None)
        del ckpt, du_part
    return dr, dw, dkk, dvv, du, ds0


class SSMScan(torch.autograd.Function):
    """``ssm_scan`` with a gradient: plain forward and backward for CPU
    tensors, the kernels for CUDA tensors (their meta branches inside a cost
    walk)."""

    @staticmethod
    def forward(ctx, r, w, k, v, u, s0):
        ctx.set_materialize_grads(False)
        ctx.dtypes = [None if x is None else x.dtype
                      for x in (r, w, k, v, u, s0)]
        if r.device.type == "cpu":
            ins = (r, w, k, v, u, s0)
            y, s_final = ssm_scan_plain(*ins)
        elif r.device.type == "meta":
            ins = _meta_prepare(r, w, k, v, u, s0)
            y, s_final = _meta_forward(*ins)
        else:
            ins = _prepare(r, w, k, v, u, s0)
            y, s_final = _forward(*ins)
        ctx.has = [x is not None for x in ins]
        ctx.save_for_backward(*(x for x in ins if x is not None))
        return y, s_final

    @staticmethod
    def backward(ctx, dy, ds_final):
        saved = iter(ctx.saved_tensors)
        ins = [next(saved) if h else None for h in ctx.has]
        if ins[0].device.type == "cpu":
            grads = ssm_scan_bwd_plain(*ins, dy, ds_final)
        elif ins[0].device.type == "meta":
            grads = _meta_backward(*ins, dy, ds_final)
        else:
            grads = _backward(*ins, dy, ds_final)
        # grads come as (dr, dw, dk, dv, du, ds0); inputs are (r, w, k, v,
        # u, s0)
        return tuple(None if g is None or not need else g.to(dt)
                     for g, need, dt in zip(grads, ctx.needs_input_grad,
                                            ctx.dtypes))


def ssm_scan(r: Tensor, w: Tensor, k: Tensor, v: Tensor,
             u: Optional[Tensor] = None, s0: Optional[Tensor] = None
             ) -> Tuple[Tensor, Tensor]:
    """r, w, k (B, T, dk), v (B, T, dv), u (dk,) or None (no bonus), s0
    (B, dk, dv) or None (zero state). B folds batch and heads.

    Returns (y (B, T, dv) fp32, s_final (B, dk, dv) fp32). Differentiable
    (``SSMScan``) when an input requires a gradient.
    """
    ins = (r, w, k, v, u, s0)
    if torch.is_grad_enabled() and any(x is not None and x.requires_grad
                                       for x in ins):
        return SSMScan.apply(*ins)
    if r.device.type == "cpu":
        return ssm_scan_plain(*ins)
    if r.device.type == "meta":
        return _meta_forward(*_meta_prepare(*ins))
    return _forward(*_prepare(*ins))
