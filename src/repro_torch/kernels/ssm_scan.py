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

``ssm_scan`` runs the plain version for CPU tensors and launches the kernel
for CUDA tensors; it never falls back from one to the other. ``launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.core.linear_attn import wkv_steps
from repro_torch.kernels import _build

Tensor = torch.Tensor

DK_MAX = 64
DV_MAX = 128

#: number of CUDA kernel launches so far (CPU calls do not count)
launches = 0


def ssm_scan_plain(r: Tensor, w: Tensor, k: Tensor, v: Tensor,
                   u: Optional[Tensor] = None, s0: Optional[Tensor] = None
                   ) -> Tuple[Tensor, Tensor]:
    """The plain version: ``ref.ssm_scan_ref``'s step loop in fp32
    (``core.linear_attn.wkv_steps``), with the initial state ``s0`` (B, dk,
    dv) and the final state returned."""
    return wkv_steps(r, w, k, v, u, s0)


_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def ssm_scan(r: Tensor, w: Tensor, k: Tensor, v: Tensor,
             u: Optional[Tensor] = None, s0: Optional[Tensor] = None
             ) -> Tuple[Tensor, Tensor]:
    """r, w, k (B, T, dk), v (B, T, dv), u (dk,) or None (no bonus), s0
    (B, dk, dv) or None (zero state). B folds batch and heads.

    Returns (y (B, T, dv) fp32, s_final (B, dk, dv) fp32).
    """
    global launches
    if r.device.type == "cpu":
        return ssm_scan_plain(r, w, k, v, u, s0)
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
    r, w, k, v, u, s0 = f32
    y = torch.empty((b, t, dv), dtype=torch.float32, device=dev)
    s_final = torch.empty((b, dk, dv), dtype=torch.float32, device=dev)
    if b == 0:
        return y, s_final
    fn = _build.function("ssm_scan", "ssm_scan_launch", _ARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    launches += 1
    err = fn(ptr(r), ptr(w), ptr(k), ptr(v), ptr(u), ptr(s0), y.data_ptr(),
             s_final.data_ptr(), b, t, dk, dv, dev.index or 0, stream)
    if err != 0:
        raise RuntimeError(f"ssm_scan kernel launch failed: CUDA error {err}")
    return y, s_final
