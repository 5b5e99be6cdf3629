"""ctypes bindings of the hand-written l2_scan CUDA kernels.

Source: ``src/repro_torch/csrc/l2_scan.cu`` (the file says which TPU kernels
it replaces and what bounds it on an H100).  Each wrapper checks its inputs,
allocates its output with ``torch.empty``, launches on the current stream
without synchronising, raises if the launch reports a CUDA error, and adds
one to its entry of :data:`LAUNCHES`.
"""
from __future__ import annotations

import ctypes

import torch

from .. import common

#: launches per kernel; ``chip_smoke.py`` zeroes them before the main path
LAUNCHES = {"pairwise_l2": 0, "slab_l2": 0}

_SIGNATURES = {
    "pairwise_l2": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
    + [ctypes.c_void_p],
    "slab_l2": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
}
_MAX_GRID_Z = 65535


def pairwise_l2_cuda(queries: torch.Tensor,
                     series: torch.Tensor) -> torch.Tensor:
    """(Q, m) × (B, m) float32 on one card → (Q, B) distances."""
    dev = queries.device
    common.require(queries, "queries", torch.float32, 2, dev)
    common.require(series, "series", torch.float32, 2, dev)
    Q, m = queries.shape
    B = series.shape[0]
    if series.shape[1] != m:
        raise ValueError(f"series width {series.shape[1]} != query width {m}")
    out = torch.empty((Q, B), dtype=torch.float32, device=dev)
    lib = common.load("l2_scan", _SIGNATURES)
    err = lib.pairwise_l2(common.ptr(queries), common.ptr(series),
                          common.ptr(out), Q, B, m,
                          common.stream_ptr(queries))
    common.check(err, "pairwise_l2")
    LAUNCHES["pairwise_l2"] += 1
    return out


def slab_l2_cuda(queries: torch.Tensor, slabs: torch.Tensor) -> torch.Tensor:
    """(F, Nq, m) × (F, R, m) float32 on one card → (F, Nq, R) distances."""
    dev = queries.device
    common.require(queries, "queries", torch.float32, 3, dev)
    common.require(slabs, "slabs", torch.float32, 3, dev)
    F, Nq, m = queries.shape
    if slabs.shape[0] != F or slabs.shape[2] != m:
        raise ValueError(f"slabs {tuple(slabs.shape)} do not match queries "
                         f"{tuple(queries.shape)}")
    if F > _MAX_GRID_Z:
        raise ValueError(f"slab_l2 takes at most {_MAX_GRID_Z} slabs per "
                         f"launch, got {F}")
    R = slabs.shape[1]
    out = torch.empty((F, Nq, R), dtype=torch.float32, device=dev)
    lib = common.load("l2_scan", _SIGNATURES)
    err = lib.slab_l2(common.ptr(queries), common.ptr(slabs),
                      common.ptr(out), F, Nq, R, m,
                      common.stream_ptr(queries))
    common.check(err, "slab_l2")
    LAUNCHES["slab_l2"] += 1
    return out
