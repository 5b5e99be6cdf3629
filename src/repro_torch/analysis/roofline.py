"""Analytic roofline bounds (port of part of ``repro.analysis.roofline``).

A kernel's least time on the card is the larger of two terms:

    t_compute = operations / peak operation rate
    t_memory  = device-memory bytes / memory rate

:func:`filter_mlp_roofline` counts the stacked filter-inference kernels'
operations and bytes from their shapes, with the reference's counts for
both variants, so the port's filter benchmark pins each timing to the same
bound the reference's does.  The device is one NVIDIA H100 SXM at its
700 W limit: 67 TFLOP/s float32 outside the tensor cores, 495 TFLOP/s
TF32 on them (dense), and 3.35 TB/s HBM3 (NVIDIA's data sheet).  The
filter counts stay against the float32 rate, as the reference's pinned
bound does; ``tf32_flops`` is for the kernels that run their products as
split-TF32 passes on the tensor cores (``chip_smoke.py``'s second bound).  Filter inference
moves nothing between cards, so the reference's link term is left out, and
so is its reader of compiled XLA artifacts (``roofline_from_compiled``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from ..core.filters import WEIGHT_BYTES_PER_EL


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    name: str
    peak_flops: float          # float32 operations/s on the CUDA cores
    hbm_bw: float              # bytes/s
    tf32_flops: float          # TF32 operations/s on the tensor cores


H100 = HardwareSpec("nvidia-h100-sxm", peak_flops=67e12, hbm_bw=3.35e12,
                    tf32_flops=495e12)

#: the TPU kernels' query tile and filter group, which the counts follow
BQ, BF = 128, 8


def mlp_operations(n_filters: int, n_queries: int, length: int,
                   hidden: int) -> int:
    """F·Q·(2·m·h + 2·h): the multiply-adds of both layers for every filter
    and query.  The bias adds, the relu and the epilogue are left out (under
    1% when m, h ≥ 128)."""
    return n_filters * n_queries * (2 * length * hidden + 2 * hidden)


@dataclasses.dataclass
class RooflineTerms:
    flops_per_device: float
    hbm_bytes_per_device: float
    t_compute: float
    t_memory: float

    @property
    def dominant(self) -> str:
        return "compute" if self.t_compute >= self.t_memory else "memory"

    @property
    def bound_time(self) -> float:
        return max(self.t_compute, self.t_memory)

    def as_dict(self) -> Dict[str, float]:
        d = dataclasses.asdict(self)
        d.update(dominant=self.dominant, bound_time=self.bound_time)
        return d


def filter_mlp_roofline(n_filters: int, n_queries: int, length: int,
                        hidden: int, *, variant: str = "fused",
                        weight_dtype: str = "float32") -> RooflineTerms:
    """Analytic bound on the H100 for the stacked filter-inference kernels,
    counted as the reference counts them (the TPU kernels' tiling ``BQ``,
    ``BF``):

    * weights — every filter's parameter block once per query tile,
      ``ceil(Q/BQ) · F · (m·h + h)`` weight elements at the payload width
      plus the float32 bias/stat vectors;
    * queries — the per-filter variant reads the query tile once per
      filter (F·Q·m·4 bytes), the fused one once per group of ``BF``;
    * output — F·Q·4 bytes once; the per-filter composition adds three
      read+write passes over the (F, Q) block (y_std, y_mean, offsets).

    Operations: :func:`mlp_operations`, plus the fused variant's group-sum
    matmul (2·h·BF per filter and query).
    """
    m, h = length, hidden
    F, Q = n_filters, n_queries
    wb = WEIGHT_BYTES_PER_EL[weight_dtype]
    n_scales = 2 if weight_dtype == "int8" else 0
    tiles = -(-Q // BQ)
    flops = mlp_operations(F, Q, m, h)
    per_filter = (m * h + h) * wb + h * 4 + (4 + n_scales) * 4
    weight_bytes = tiles * F * per_filter
    out_bytes = F * Q * 4
    if variant == "fused":
        flops += F * Q * 2 * h * BF
        query_bytes = -(-F // BF) * Q * m * 4
        epilogue_bytes = 0
    elif variant == "per_filter":
        query_bytes = F * Q * m * 4
        epilogue_bytes = 3 * 2 * F * Q * 4
    else:
        raise ValueError(f"unknown variant {variant!r}")
    hbm = weight_bytes + query_bytes + out_bytes + epilogue_bytes
    return RooflineTerms(
        flops_per_device=float(flops),
        hbm_bytes_per_device=float(hbm),
        t_compute=flops / H100.peak_flops,
        t_memory=hbm / H100.hbm_bw,
    )
