"""Roofline terms of one call on one NVIDIA H100 SXM (port of
``repro.launch.roofline``).

Three terms per (arch x shape) cell, in seconds per step:

    compute    = flops / PEAK_FLOPS
    memory     = bytes / HBM_BW
    collective = collective bytes / NVLINK_BW     (0 on one card)

``flops`` and ``bytes`` come from the op walk (``launch.op_analysis``),
the kernels' share from ``kernels.work``. The compute term takes every
operation at the dense bf16 tensor-core peak, as the reference takes its
chip's one peak, so it is a lower bound; ``kernel_bound_s`` bounds one
kernel launch by the peak of its inputs' type instead. The reference's
``collective_bytes`` parses HLO, which the port does not have; the
collective term waits for more than one card (``ROADMAP.md``, queue 1
item 4).
"""

from __future__ import annotations

from typing import Dict

PEAK_FLOPS = 989e12          # H100 SXM data sheet: dense bf16 tensor cores
PEAK_FLOPS_FP32 = 67e12      # H100 SXM data sheet: fp32 outside tensor cores
HBM_BW = 3.35e12             # H100 SXM data sheet: HBM3 bytes/s
NVLINK_BW = 450e9            # H100 SXM data sheet: NVLink 4, bytes/s a direction


def roofline_terms(flops_per_device: float, bytes_per_device: float,
                   coll_bytes_per_device: float) -> Dict[str, float]:
    compute = flops_per_device / PEAK_FLOPS
    memory = bytes_per_device / HBM_BW
    collective = coll_bytes_per_device / NVLINK_BW
    terms = {"compute_s": compute, "memory_s": memory,
             "collective_s": collective}
    dominant = max(terms, key=terms.get)
    bound = max(compute, memory, collective)
    terms["dominant"] = dominant.replace("_s", "")
    terms["step_lower_bound_s"] = bound
    # roofline fraction: how much of the bound is useful tensor-core time
    terms["compute_fraction_of_bound"] = compute / bound if bound else 0.0
    return terms


def model_flops(n_active_params: int, tokens: int,
                kind: str = "train") -> float:
    """6*N*D for train (fwd+bwd); 2*N*D for inference forward."""
    mult = 6.0 if kind == "train" else 2.0
    return mult * n_active_params * tokens


def kernel_bound_s(flops: float, n_bytes: float,
                   tensor_cores: bool = False) -> float:
    """One kernel launch's least time: the larger of its bytes over HBM and
    its operations over the peak of its inputs' type (bf16 on the tensor
    cores, else fp32)."""
    peak = PEAK_FLOPS if tensor_cores else PEAK_FLOPS_FP32
    return max(n_bytes / HBM_BW, flops / peak)


def summarize(cost, n_active_params: int, tokens: int, kind: str) -> Dict:
    """The roofline summary of an ``op_analysis.ModuleCost``, under the
    reference's keys (its ``hlo_`` counts are the walk's counts here; the
    walk multiplies no loop trip counts, since eager runs every trip, so
    there is no ``while_trip_counts``)."""
    terms = roofline_terms(cost.flops, cost.bytes, cost.collective_bytes)
    return {
        "hlo_flops_per_device": cost.flops,
        "hlo_bytes_per_device": cost.bytes,
        "collective_bytes_per_device": cost.collective_bytes,
        "collective_breakdown": {k: float(v)
                                 for k, v in cost.collectives.items()},
        "model_flops_global": model_flops(n_active_params, tokens, kind),
        **terms,
    }
