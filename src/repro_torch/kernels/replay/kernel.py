"""ctypes binding of the hand-written cascade-replay CUDA kernel.

Source: ``src/repro_torch/csrc/replay.cu`` (the file says what it computes,
what bounds it on an H100 and how it walks a row).  The wrapper checks its
inputs, allocates the outputs with ``torch.empty``, launches on the current
stream without synchronising, raises if the launch reports a CUDA error,
and adds one to :data:`LAUNCHES`.  Every k is served by the one launch.
"""
from __future__ import annotations

import ctypes

import torch

from .. import common

#: launches per kernel; ``chip_smoke.py`` zeroes them before the main path
LAUNCHES = {"replay": 0}

_SIGNATURES = {
    "replay": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong]
    + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
}


def _require_leaf_block(t: torch.Tensor, name: str, dtype: torch.dtype,
                        device: torch.device) -> None:
    """(Q, L, kk) with each row's (L, kk) block contiguous; rows may lie
    apart (the engine passes a slice of a larger buffer)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != 3:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected 3 "
                         "dims")
    _, L, kk = t.shape
    if (kk > 1 and t.stride(2) != 1) or (L > 1 and t.stride(1) != kk):
        raise ValueError(f"{name}'s rows must each be contiguous")


def replay_cascade_cuda(leaf_d: torch.Tensor, leaf_i: torch.Tensor,
                        d_lb: torch.Tensor, d_F: torch.Tensor,
                        order: torch.Tensor, k: int):
    """The cascade replay on one card: leaf_d (Q, L, kk) float32, leaf_i
    (Q, L, kk) int64 with leaf_d's strides, d_lb and d_F (Q, L) float32,
    order (Q, L) int64 with entries in [0, L) → (topk_d (Q, k), topk_i
    (Q, k), n_searched, n_pruned_lb, n_pruned_filter (Q,) int32)."""
    dev = leaf_d.device
    _require_leaf_block(leaf_d, "leaf_d", torch.float32, dev)
    _require_leaf_block(leaf_i, "leaf_i", torch.int64, dev)
    common.require(d_lb, "d_lb", torch.float32, 2, dev)
    common.require(d_F, "d_F", torch.float32, 2, dev)
    common.require(order, "order", torch.int64, 2, dev)
    Q, L, kk = leaf_d.shape
    if leaf_i.shape != leaf_d.shape or leaf_i.stride() != leaf_d.stride():
        raise ValueError(f"leaf_i {tuple(leaf_i.shape)} does not lie as "
                         f"leaf_d {tuple(leaf_d.shape)} does")
    for name, t in (("d_lb", d_lb), ("d_F", d_F), ("order", order)):
        if tuple(t.shape) != (Q, L):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{(Q, L)}")
    if k < 1:
        raise ValueError(f"k must be at least 1, got {k}")
    topk_d = torch.empty((Q, k), dtype=torch.float32, device=dev)
    topk_i = torch.empty((Q, k), dtype=torch.int64, device=dev)
    counts = torch.empty((3, Q), dtype=torch.int32, device=dev)
    lib = common.load("replay", _SIGNATURES)
    err = lib.replay(common.ptr(leaf_d), common.ptr(leaf_i),
                     leaf_d.stride(0), common.ptr(d_lb), common.ptr(d_F),
                     common.ptr(order), common.ptr(topk_d),
                     common.ptr(topk_i), common.ptr(counts[0]),
                     common.ptr(counts[1]), common.ptr(counts[2]), Q, L, kk,
                     k, common.stream_ptr(leaf_d))
    common.check(err, "replay")
    LAUNCHES["replay"] += 1
    return topk_d, topk_i, counts[0], counts[1], counts[2]
