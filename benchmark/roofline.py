"""Peaks of the card and the work of the normal-matrix assembly, for the
roofline metrics.

The assembly M = X diag(s) X' + diag(e) of one LP's f32 stage is counted
on the LP's own unpadded dims (m rows, n columns): m(m+1)/2 * n
multiply-adds for the lower triangle, X, s and e read once and the lower
triangle of M written once, in float32.  Padding, and the lanes of a
batch that have stopped, are work no implementation needs, so they are
never counted.  The least time is the larger of the operations over the
card's dense TF32 peak (no float32-accurate method on the card beats it)
and the bytes over its memory bandwidth.
"""

from __future__ import annotations

# published dense peaks (NVIDIA's H100 data sheet, SXM part, no sparsity)
PEAKS = {
    "NVIDIA H100 80GB HBM3": dict(tf32_flops=495e12, hbm_bytes_s=3.35e12),
}
KERNEL = "scaled_syrk_kernel"


def peaks(kind: str) -> dict | None:
    return PEAKS.get(kind)


def assembly_madds(m: int, n: int) -> int:
    return m * (m + 1) // 2 * n


def assembly_bytes(m: int, n: int) -> int:
    return 4 * (m * n + n + m + m * (m + 1) // 2)


def assembly_bound_s(m: int, n: int, peak: dict) -> float:
    """The least time of one assembly on a card of these peaks."""
    return max(2 * assembly_madds(m, n) / peak["tf32_flops"],
               assembly_bytes(m, n) / peak["hbm_bytes_s"])


def kernel_share(run) -> float | None:
    """The assemblies the traced requests' LPs needed in their f32 stages,
    at the card's least time, over the device time of the assembly kernel
    in the trace, in %; None without a trace, a known card, a launch or a
    count."""
    peak = peaks(run.card)
    if run.trace is None or peak is None:
        return None
    device_s = sum(s for name, s in run.trace["ops"].items() if KERNEL in name)
    if device_s <= 0:
        return None
    need = 0.0
    for rq in run.requests:
        if not rq["traced"]:
            continue
        for (m, n), its in zip(rq["shapes"], rq["f32_iterations"]):
            if its is None:
                return None
            need += its * assembly_bound_s(m, n, peak)
    return 100.0 * need / device_s
