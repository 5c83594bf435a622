"""The analytic roofline of one fused tick (the reference's
``repro.roofline.analysis.tick_step_roofline``) at the H100's constants.

The reference divides by a TPU v5e's HBM rate and bf16 peak; the port's
kernels run on an H100 SXM, so the defaults here are its HBM3 rate and its
float32 (non-tensor-core) peak, the ``chip_smoke.py`` table's.  Both are
keywords: with the v5e's values the dict equals the reference's.
"""
from __future__ import annotations

#: H100 SXM HBM3 bandwidth, bytes/s.
HBM_BW = 3.35e12
#: H100 SXM float32 peak without tensor cores, op/s (the draw's arithmetic
#: is float32 compares, adds and divides).
PEAK_FLOPS = 67e12


def tick_step_roofline(s: int, j: int, w: int, dtype_bytes: int = 4, *,
                       hbm_bw: float = HBM_BW,
                       peak_flops: float = PEAK_FLOPS) -> dict:
    """Roofline of one fused tick-step launch at ``[S, J]`` x ``W``.

    Traffic, each array once: the share table, queue counts and the
    ``[S, J, W]`` ring window in, free and u in, and sel, valid,
    demand_any, qcount' and pops out:

        bytes = S·J·(3 + W)·b + S·W·2·b + S·(3·W + 2·J)·b

    Work: per draw a masked renormalisation, prefix sum and segment count
    over J slots (~8 ops a slot) plus the pop (~4), so ops = S·W·J·12.
    The budget is the larger of the two times."""
    bytes_in = s * j * (3 + w) * dtype_bytes + s * w * 2 * dtype_bytes
    bytes_out = s * (3 * w + 2 * j) * dtype_bytes
    bytes_total = bytes_in + bytes_out
    flops = s * w * j * 12.0
    memory_s = bytes_total / hbm_bw
    compute_s = flops / peak_flops
    return {
        "s": s, "j": j, "w": w,
        "bytes": bytes_total,
        "flops": flops,
        "intensity_flops_per_byte": flops / bytes_total,
        "memory_s": memory_s,
        "compute_s": compute_s,
        "bound": "memory" if memory_s >= compute_s else "compute",
        "budget_us": max(memory_s, compute_s) * 1e6,
    }
