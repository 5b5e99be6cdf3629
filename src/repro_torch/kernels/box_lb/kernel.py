"""ctypes binding of the hand-written box lower-bound CUDA kernel.

Source: ``src/repro_torch/csrc/box_lb.cu`` (the file says which TPU kernel
it replaces and what bounds it on an H100).  The wrapper checks its inputs,
allocates the output with ``torch.empty``, launches on the current stream
without synchronising, raises if the launch reports a CUDA error, and adds
one to :data:`LAUNCHES`.
"""
from __future__ import annotations

import ctypes

import torch

from .. import common

#: launches per kernel; ``chip_smoke.py`` zeroes them before the main path
LAUNCHES = {"box_lb": 0}

_SIGNATURES = {
    "box_lb": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
}


def box_lb_cuda(q: torch.Tensor, lo: torch.Tensor,
                hi: torch.Tensor) -> torch.Tensor:
    """(Q, d) points against (L, d) boxes, float32 on one card, any d ≥ 1
    → (Q, L)."""
    dev = q.device
    common.require(q, "q", torch.float32, 2, dev)
    common.require(lo, "lo", torch.float32, 2, dev)
    common.require(hi, "hi", torch.float32, 2, dev)
    Q, d = q.shape
    L = lo.shape[0]
    if lo.shape[1] != d or tuple(hi.shape) != tuple(lo.shape):
        raise ValueError(f"boxes {tuple(lo.shape)}/{tuple(hi.shape)} do not "
                         f"match points {tuple(q.shape)}")
    if d < 1:
        raise ValueError(f"box_lb takes at least one dimension, got {d}")
    out = torch.empty((Q, L), dtype=torch.float32, device=dev)
    lib = common.load("box_lb", _SIGNATURES)
    err = lib.box_lb(common.ptr(q), common.ptr(lo), common.ptr(hi),
                     common.ptr(out), Q, L, d, common.stream_ptr(q))
    common.check(err, "box_lb")
    LAUNCHES["box_lb"] += 1
    return out
