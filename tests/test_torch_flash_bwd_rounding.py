"""The rounding of the bf16 tensor-core backward of ``flash_attention``
(csrc/flash_attention_bwd.cu, ``dkdv_tc_kernel`` and ``dq_tc_kernel``),
modelled on the CPU and held to ``flash_attention_bwd_plain`` within the
bf16 tolerance that the card's checks hold the kernels to (rtol = atol =
1e-2, ``FLASH_TOL`` in chip_smoke.py and tests/test_torch_kernels_cuda.py).

The kernels take bf16 q, k, v, o and dO; S = q.k and dP = dO.v are fp32
sums of bf16 products, P = exp(scale S - lse) and dS = P (dP - D) are fp32.
The second products (dV = P^T dO, dK = scale dS^T q, dQ = scale dS k) take
P and dS as the A operands of bf16 tensor-core products, so they must be
bf16. Rounding each once to bf16, the usual design, misses the gate at the
gate's own shapes: emulated on the CPU over three seeds, the worst error
reached 0.85-1.16 of the limit for dV at (1, 8, 1, 1537, 1537, 256) and (1,
40, 8, 1000, 1000, 128), and 1.006 for dK. So the kernels split each of P
and dS into a bf16 high part and a bf16 low part (hi = bf16(x), lo = bf16(x
- hi)) and run each second product twice on the same B tile, every sum in
fp32, the outputs rounded once to bf16: the worst ratio then fell to
0.34-0.44. This test models that arithmetic (it does not run the kernels:
the card holds them to the plain version at the gate's shapes) at three of
those shapes cut to CPU time, for three seeds: the worst ratio here is
0.46 (dV, GQA 5:1); with ``_split`` returning (bf16(x), 0), a single
rounding, the same cases reach 1.07.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as KF

TOL = 1e-2          # FLASH_TOL["bfloat16"], rtol = atol


def _split(x):
    """x as the sum of two bf16 parts, each back in fp32."""
    hi = x.to(torch.bfloat16).to(torch.float32)
    return hi, (x - hi).to(torch.bfloat16).to(torch.float32)


def _model_bwd(q, k, v, o, lse, do, window):
    """(dq, dk, dv) in bf16, as the tensor-core kernels round them."""
    b, h, sq, hd = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    grp = h // kvh
    scale = hd ** -0.5
    f32 = torch.float32
    qf, of, dof = q.to(f32), o.to(f32), do.to(f32)
    kf = k.to(f32).repeat_interleave(grp, dim=1)
    vf = v.to(f32).repeat_interleave(grp, dim=1)
    ok = KF._visible(sq, skv, window, q.device)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    p = torch.where(ok, torch.exp(s - lse[..., None]), 0.0)
    dd = (dof * of).sum(dim=-1)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    ds = p * (dp - dd[..., None])
    p_hi, p_lo = _split(p)
    ds_hi, ds_lo = _split(ds)
    dv = (torch.einsum("bhqk,bhqd->bhkd", p_hi, dof)
          + torch.einsum("bhqk,bhqd->bhkd", p_lo, dof))
    dk = (torch.einsum("bhqk,bhqd->bhkd", ds_hi, qf)
          + torch.einsum("bhqk,bhqd->bhkd", ds_lo, qf)) * scale
    dq = (torch.einsum("bhqk,bhkd->bhqd", ds_hi, kf)
          + torch.einsum("bhqk,bhkd->bhqd", ds_lo, kf)) * scale
    dk = dk.reshape(b, kvh, grp, skv, hd).sum(dim=2)
    dv = dv.reshape(b, kvh, grp, skv, hd).sum(dim=2)
    bf = torch.bfloat16
    return dq.to(bf), dk.to(bf), dv.to(bf)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("b,h,kvh,sq,skv,hd,window", [
    (1, 2, 1, 1537, 1537, 256, 0),   # hd 256 MQA, ragged (gemma-2b's heads)
    (1, 10, 2, 600, 600, 128, 0),    # hd 128 GQA 5:1, ragged
    (1, 4, 2, 333, 200, 64, 50)])    # Sq > Skv, window: rows that see nothing
def test_split_rounding_meets_the_bf16_gate(b, h, kvh, sq, skv, hd, window,
                                            seed):
    rng = np.random.default_rng(seed)
    bf = torch.bfloat16
    q, k, v, do = (torch.as_tensor(rng.normal(size=s).astype(np.float32))
                   .to(bf) for s in ((b, h, sq, hd), (b, kvh, skv, hd),
                                     (b, kvh, skv, hd), (b, h, sq, hd)))
    o, lse = KF.flash_attention_fwd_plain(q, k, v, window)
    got = _model_bwd(q, k, v, o, lse, do, window)
    want = KF.flash_attention_bwd_plain(q, k, v, o, lse, do, window)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == bf and a.shape == w.shape
        af, wf = a.to(torch.float32), w.to(torch.float32)
        ratio = float(((af - wf).abs() / (TOL + TOL * wf.abs())).max())
        assert ratio <= 1.0, f"{name}: {ratio:.3f} of the bf16 gate"
    if window:
        # rows that see nothing: zero gradient in the model too
        seen = KF._visible(sq, skv, window, q.device).any(dim=1)
        assert not bool(seen.all())
        assert bool((got[0][:, :, ~seen] == 0).all())
