"""ctypes binding of the hand-written single-query early-walk CUDA kernel.

Source: ``src/repro_torch/csrc/early_walk.cu``.  It replaces no Pallas
kernel: the reference runs the walk as a jitted ``lax.while_loop``
(``src/repro/core/search.py:327`` ``_search_early_core``).  Its bytes
bound is each visited position's order entry, bound and prediction and
every searched leaf's rows (``ref.bound_bytes``).  A persistent grid, one
block a SM launched cooperatively: scorer warps claim (leaf, 64 rows) items
in visit order, pre-test them against the walker's published bsf and
write each kept item's k smallest distances into a ring in global memory;
one walker warp walks the ring 32 leaves at a time in visit order and
merges only the leaves that can enter the top-k.  The wrapper checks its
inputs, allocates the outputs and the ring with ``torch.empty`` (its
counts and least values with ``torch.zeros``), launches on the current
stream without synchronising, raises if the launch reports a CUDA error,
and adds one to :data:`LAUNCHES`.  Every k and m is served by the one
launch.
"""
from __future__ import annotations

import ctypes

import torch

from .. import common
from . import ref

#: launches per kernel; ``chip_smoke.py`` zeroes them before the main path
LAUNCHES = {"early_walk": 0}

#: the largest k whose top-k lives in registers (``REG_MAX_K``)
REG_MAX_K = 32
#: control words before the ring's counts (``CTL``)
CTL = 8

_SIGNATURES = {
    "early_walk": [ctypes.c_void_p] * 13 + [ctypes.c_int] * 6
    + [ctypes.c_void_p],
    "early_walk_layout": [ctypes.c_int] * 2 + [ctypes.c_void_p],
}


def vectorized(series: torch.Tensor, q: torch.Tensor) -> bool:
    """16-byte loads: m % 4 == 0 and the series and the query 16-byte
    aligned."""
    return (q.shape[0] % 4 == 0 and series.data_ptr() % 16 == 0
            and q.data_ptr() % 16 == 0)


def layout(k: int, vec: bool) -> dict:
    """The launch the C entry makes for k: blocks, threads a block,
    registers a thread (``cudaFuncGetAttributes``) and ring slots."""
    lib = common.load("early_walk", _SIGNATURES)
    out = (ctypes.c_int * 4)()
    common.check(lib.early_walk_layout(k, int(vec), out),
                 "early_walk_layout")
    return dict(zip(("blocks", "threads", "registers", "ring"), out))


def early_walk_cuda(series: torch.Tensor, leaf_start: torch.Tensor,
                    leaf_size: torch.Tensor, q: torch.Tensor,
                    d_lb: torch.Tensor, d_F: torch.Tensor,
                    order: torch.Tensor, k: int, max_leaf: int):
    """The walk on one card: series (N, m) float32, leaf_start and
    leaf_size (L,) int64, q (m,) float32, d_lb and d_F (L,) float32, order
    (L,) int64 with entries in [0, L); ``max_leaf`` sizes the items
    (``ref.items_per_leaf``; a larger leaf is still read whole) → (topk_d
    (k,) float32, topk_i (k,) int64, n_searched, n_visited,
    n_pruned_filter 0-d int32)."""
    dev = q.device
    common.require(series, "series", torch.float32, 2, dev)
    common.require(leaf_start, "leaf_start", torch.int64, 1, dev)
    common.require(leaf_size, "leaf_size", torch.int64, 1, dev)
    common.require(q, "q", torch.float32, 1, dev)
    common.require(d_lb, "d_lb", torch.float32, 1, dev)
    common.require(d_F, "d_F", torch.float32, 1, dev)
    common.require(order, "order", torch.int64, 1, dev)
    L, m = leaf_start.shape[0], q.shape[0]
    if series.shape[1] != m:
        raise ValueError(f"series rows have {series.shape[1]} values, the "
                         f"query {m}")
    for name, t in (("leaf_size", leaf_size), ("d_lb", d_lb), ("d_F", d_F),
                    ("order", order)):
        if t.shape[0] != L:
            raise ValueError(f"{name} has {t.shape[0]} entries, expected "
                             f"{L}")
    if k < 1:
        raise ValueError(f"k must be at least 1, got {k}")
    rows, per = ref.items_per_leaf(max_leaf)
    topk_d = torch.empty(k, dtype=torch.float32, device=dev)
    topk_i = torch.empty(k, dtype=torch.int64, device=dev)
    counts = torch.empty(3, dtype=torch.int32, device=dev)
    ctl = torch.zeros(CTL + 2 * ref.RING, dtype=torch.int32, device=dev)
    ring_f = torch.empty(ref.RING * (2 + k), dtype=torch.float32, device=dev)
    ring_i = torch.empty(ref.RING * k, dtype=torch.int64, device=dev)
    lib = common.load("early_walk", _SIGNATURES)
    err = lib.early_walk(*(common.ptr(t) for t in (
        series, leaf_start, leaf_size, q, d_lb, d_F, order, topk_d, topk_i,
        counts, ctl, ring_f, ring_i)), L, m, k, rows, per,
        int(vectorized(series, q)), common.stream_ptr(q))
    common.check(err, "early_walk")
    LAUNCHES["early_walk"] += 1
    return topk_d, topk_i, counts[0], counts[1], counts[2]
