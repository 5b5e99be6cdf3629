"""ctypes binding of the hand-written fused filter-MLP CUDA kernel.

Source: ``src/repro_torch/csrc/filter_mlp.cu`` (the file says which TPU
kernel it replaces and what bounds it on an H100).  The wrapper checks its
inputs, allocates the output with ``torch.empty``, launches on the current
stream without synchronising, raises if the launch reports a CUDA error,
and adds one to :data:`LAUNCHES`.
"""
from __future__ import annotations

import ctypes

import torch

from .. import common

#: launches per kernel; ``chip_smoke.py`` zeroes them before the main path
LAUNCHES = {"fused_filter_mlp": 0}

_SIGNATURES = {
    "fused_filter_mlp": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
    + [ctypes.c_void_p],
}


def fused_filter_mlp_cuda(queries: torch.Tensor, w1: torch.Tensor,
                          b1: torch.Tensor, w2: torch.Tensor,
                          b2: torch.Tensor, y_mean: torch.Tensor,
                          y_std: torch.Tensor,
                          offsets: torch.Tensor) -> torch.Tensor:
    """float32 stacked filters on one card → (F, Q) adjusted predictions."""
    dev = queries.device
    common.require(queries, "queries", torch.float32, 2, dev)
    common.require(w1, "w1", torch.float32, 3, dev)
    F, m, h = w1.shape
    Q = queries.shape[0]
    if queries.shape[1] != m:
        raise ValueError(f"queries width {queries.shape[1]} != filter "
                         f"input width {m}")
    for name, t, shape in (("b1", b1, (F, h)), ("w2", w2, (F, h)),
                           ("b2", b2, (F,)), ("y_mean", y_mean, (F,)),
                           ("y_std", y_std, (F,)), ("offsets", offsets, (F,))):
        common.require(t, name, torch.float32, len(shape), dev)
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
    out = torch.empty((F, Q), dtype=torch.float32, device=dev)
    lib = common.load("filter_mlp", _SIGNATURES)
    err = lib.fused_filter_mlp(
        common.ptr(queries), common.ptr(w1), common.ptr(b1), common.ptr(w2),
        common.ptr(b2), common.ptr(y_mean), common.ptr(y_std),
        common.ptr(offsets), common.ptr(out), F, Q, m, h,
        common.stream_ptr(queries))
    common.check(err, "fused_filter_mlp")
    LAUNCHES["fused_filter_mlp"] += 1
    return out
