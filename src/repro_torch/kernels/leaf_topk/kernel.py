"""ctypes binding of the hand-written candidate-pass CUDA kernel.

Source: ``src/repro_torch/csrc/leaf_topk.cu`` (the file says what it
computes, what bounds it on an H100 and how a warp scores a pair).  The
wrapper checks its inputs, launches on the current stream without
synchronising, raises if the launch reports a CUDA error, and adds one to
:data:`LAUNCHES`.  It writes into the caller's output rows in place (the
engine's summaries), as the plain version (``ref.leaf_topk``) does.
"""
from __future__ import annotations

import ctypes

import torch

from .. import common
from .ref import IMPLS

#: launches per kernel; ``chip_smoke.py`` zeroes them before the main path
LAUNCHES = {"leaf_topk": 0}

_SIGNATURES = {
    "leaf_topk": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
    + [ctypes.c_longlong] + [ctypes.c_int] * 2 + [ctypes.c_void_p],
}


def leaf_topk_cuda(series: torch.Tensor, leaf_start: torch.Tensor,
                   leaf_size: torch.Tensor, queries: torch.Tensor,
                   leaves: torch.Tensor, counts: torch.Tensor, kk: int,
                   max_leaf: int, dist_impl: str, out_d: torch.Tensor,
                   out_i: torch.Tensor, scatter: bool):
    """The candidate pass on one card, one launch: series (N, m) float32,
    leaf_start and leaf_size (L,) int64, queries (Q, m) float32, leaves
    (Q, C) int64 (query q's survivors are ``leaves[q, :counts[q]]``, ids
    in [0, L], L padding), counts (Q,) int64; out_d (Q, S, kk) float32 and
    out_i (Q, S, kk) int64, S > L when ``scatter`` (rows by leaf id, row L
    the engine's scratch row) else S >= C (rows by slot).  ``max_leaf`` is
    the plain version's slab width; the kernel reads each leaf's own size.
    The warps take the slots in the order :func:`leaf_major` gives them.
    Returns (out_d, out_i)."""
    dev = queries.device
    common.require(series, "series", torch.float32, 2, dev)
    common.require(leaf_start, "leaf_start", torch.int64, 1, dev)
    common.require(leaf_size, "leaf_size", torch.int64, 1, dev)
    common.require(queries, "queries", torch.float32, 2, dev)
    common.require(leaves, "leaves", torch.int64, 2, dev)
    common.require(counts, "counts", torch.int64, 1, dev)
    common.require(out_d, "out_d", torch.float32, 3, dev)
    common.require(out_i, "out_i", torch.int64, 3, dev)
    Q, m = queries.shape
    C = leaves.shape[1]
    L = leaf_start.shape[0]
    if series.shape[1] != m:
        raise ValueError(f"series rows have {series.shape[1]} values, "
                         f"queries {m}")
    if tuple(leaf_size.shape) != (L,):
        raise ValueError(f"leaf_size has shape {tuple(leaf_size.shape)}, "
                         f"expected {(L,)}")
    if leaves.shape[0] != Q or tuple(counts.shape) != (Q,):
        raise ValueError(f"leaves {tuple(leaves.shape)} and counts "
                         f"{tuple(counts.shape)} do not have {Q} rows")
    if dist_impl not in IMPLS:
        raise ValueError(f"unknown candidate-pass impl {dist_impl!r}; the "
                         f"kernel takes {IMPLS}")
    if kk < 1:
        raise ValueError(f"kk must be at least 1, got {kk}")
    rows = L + 1 if scatter else C
    if (out_d.shape[0] != Q or out_d.shape[1] < rows
            or out_d.shape[2] != kk):
        raise ValueError(f"out_d has shape {tuple(out_d.shape)}, expected "
                         f"({Q}, >= {rows}, {kk})")
    if out_i.shape != out_d.shape:
        raise ValueError(f"out_i {tuple(out_i.shape)} is not shaped as "
                         f"out_d {tuple(out_d.shape)}")
    lib = common.load("leaf_topk", _SIGNATURES)
    pair_order = leaf_major(leaves, counts, L)
    err = lib.leaf_topk(common.ptr(series), common.ptr(leaf_start),
                        common.ptr(leaf_size), common.ptr(queries),
                        common.ptr(leaves), common.ptr(counts),
                        common.ptr(pair_order),
                        common.ptr(out_d), common.ptr(out_i), Q, C, L, m, kk,
                        out_d.shape[1], int(bool(scatter)),
                        int(dist_impl == "matmul"), common.stream_ptr(queries))
    common.check(err, "leaf_topk")
    LAUNCHES["leaf_topk"] += 1
    return out_d, out_i


def leaf_major(leaves: torch.Tensor, counts: torch.Tensor,
               L: int) -> torch.Tensor:
    """The order the kernel's warps take the flat slots q·C + c in: every
    slot to compute (below its query's count, leaf id in [0, L)) in
    ascending leaf id (stable: queries in order within a leaf), then every
    other slot, whatever id it holds.  A warp stops at its first slot with
    nothing to compute, so the order must put those last.  The keys are
    sorted as int32, half the radix passes of int64."""
    slot = torch.arange(leaves.shape[1], device=leaves.device)
    todo = (slot < counts[:, None]) & (leaves >= 0) & (leaves < L)
    return torch.argsort(torch.where(todo, leaves, L).flatten().int(),
                         stable=True)
