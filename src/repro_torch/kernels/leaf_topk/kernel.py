"""ctypes binding of the hand-written candidate-pass CUDA kernel.

Source: ``src/repro_torch/csrc/leaf_topk.cu`` (the file says what it
computes, what bounds it on an H100 and how each instance works).  The
wrapper checks its inputs, picks the instance by the call's shapes alone
(:func:`instance`: the staged ``wgmma`` instance for the batch's survivor
pass, the ``warp`` instance for every other call), launches on the current
stream without synchronising, raises if the launch reports a CUDA error, and
adds one to :data:`LAUNCHES` and to the instance's count in
:data:`INSTANCE_LAUNCHES`.  It writes into the caller's output rows in place
(the engine's summaries), as the plain version (``ref.leaf_topk``) does.
"""
from __future__ import annotations

import ctypes

import torch

from .. import common
from .ref import IMPLS

#: launches per kernel; ``chip_smoke.py`` zeroes them before the main path
LAUNCHES = {"leaf_topk": 0}
#: the same launches by instance (:func:`instance`)
INSTANCE_LAUNCHES = {"wgmma": 0, "warp": 0}

#: queries an item of the staged instance (one wgmma m64 tile)
GROUP = 64
#: the largest kk the staged instance takes (its lists' room)
WGMMA_MAX_KK = 32

_SIGNATURES = {
    "leaf_topk": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
    + [ctypes.c_longlong] + [ctypes.c_int] * 2 + [ctypes.c_void_p],
    "leaf_topk_wgmma": [ctypes.c_void_p, ctypes.c_longlong]
    + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_longlong]
    + [ctypes.c_void_p],
    "leaf_topk_wgmma_smem": [ctypes.c_int, ctypes.c_void_p],
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
    The ``wgmma`` instance takes its items from :func:`item_table`, the
    ``warp`` instance the slots in the order :func:`leaf_major` gives them.
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
    which = instance(series, queries, kk, dist_impl, scatter)
    if which == "wgmma":
        table = item_table(leaves, counts, L)
        err = lib.leaf_topk_wgmma(
            common.ptr(series), series.shape[0], common.ptr(leaf_start),
            common.ptr(leaf_size), common.ptr(queries),
            *(common.ptr(t) for t in table), common.ptr(out_d),
            common.ptr(out_i), Q, C, L, m, kk, out_d.shape[1],
            common.stream_ptr(queries))
    else:
        pair_order = leaf_major(leaves, counts, L)
        err = lib.leaf_topk(common.ptr(series), common.ptr(leaf_start),
                            common.ptr(leaf_size), common.ptr(queries),
                            common.ptr(leaves), common.ptr(counts),
                            common.ptr(pair_order), common.ptr(out_d),
                            common.ptr(out_i), Q, C, L, m, kk, out_d.shape[1],
                            int(bool(scatter)), int(dist_impl == "matmul"),
                            common.stream_ptr(queries))
    common.check(err, f"leaf_topk ({which})")
    LAUNCHES["leaf_topk"] += 1
    INSTANCE_LAUNCHES[which] += 1
    return out_d, out_i


def instance(series: torch.Tensor, queries: torch.Tensor, kk: int,
             dist_impl: str, scatter: bool) -> str:
    """The instance a call takes, by its shapes alone: ``"wgmma"`` (leaf
    rows staged by TMA, split-TF32 wgmma) for the survivor pass
    (``scatter``) in the ``matmul`` form with m % 4 == 0 and 16-byte-aligned
    series and queries (TMA's stride and address rules), kk <= 32 (its
    lists' room) and fewer than 2^31 − 128 series rows (TMA's int32 row
    coordinate); ``"warp"`` (a warp a pair) for every other call: the
    probe, the ``direct`` form, m % 4 != 0, kk > 32."""
    m = queries.shape[1]
    staged = (bool(scatter) and dist_impl == "matmul" and m % 4 == 0
              and kk <= WGMMA_MAX_KK
              and series.data_ptr() % 16 == 0
              and queries.data_ptr() % 16 == 0
              and 0 < series.shape[0] <= 2 ** 31 - 1 - 128)
    return "wgmma" if staged else "warp"


def wgmma_smem(kk: int) -> dict:
    """The staged instance's dynamic shared memory a block (bytes) and its
    ring's stages at ``kk`` (from the source's constants)."""
    lib = common.load("leaf_topk", _SIGNATURES)
    out = (ctypes.c_int * 2)()
    lib.leaf_topk_wgmma_smem(kk, ctypes.cast(out, ctypes.c_void_p))
    return {"bytes": out[0], "stages": out[1]}


def _keys(leaves: torch.Tensor, counts: torch.Tensor, L: int) -> torch.Tensor:
    """Each flat slot's leaf id where it is a slot to compute (below its
    query's count, id in [0, L)), else L; int32 (half the radix passes of
    int64)."""
    slot = torch.arange(leaves.shape[1], device=leaves.device)
    todo = (slot < counts[:, None]) & (leaves >= 0) & (leaves < L)
    return torch.where(todo, leaves, L).flatten().int()


def item_table(leaves: torch.Tensor, counts: torch.Tensor, L: int) -> tuple:
    """The staged instance's items, made on the slots' device with no host
    sync: ``pair_order`` (Q·C,) the flat slots q·C + c, the slots to compute
    first in ascending leaf id (stable: queries ascending within a leaf),
    then every other slot; ``bounds`` (L + 1,) int64, each leaf's first
    entry in that order (``bounds[L]``: the slots to compute); ``item_end``
    (L,) int64, the running count of each leaf's groups of :data:`GROUP`
    queries; ``item_leaf`` int64, each item's leaf: item i is leaf l = the
    first with ``item_end[l] > i`` and its pairs ``bounds[l] + GROUP·(i −
    item_end[l − 1])`` onwards, at most GROUP of them.  The items number
    ``item_end[L − 1]``, which only the card reads: item_leaf has room for
    the most there can be, L + Q·C / GROUP, and holds L past the last.  (``searchsorted`` over the sorted keys gives the leaves'
    first entries; ``torch.bincount`` would read its input's largest value
    back to the host.)"""
    keys, pair_order = torch.sort(_keys(leaves, counts, L), stable=True)
    dev = keys.device
    bounds = torch.searchsorted(
        keys, torch.arange(L + 1, dtype=torch.int32, device=dev))
    item_end = torch.cumsum(torch.div(bounds[1:] - bounds[:-1] + GROUP - 1,
                                      GROUP, rounding_mode="floor"), 0)
    most = L + -(-keys.numel() // GROUP)
    item_leaf = torch.searchsorted(item_end, torch.arange(most, device=dev),
                                   right=True)
    return pair_order, bounds, item_end, item_leaf


def leaf_major(leaves: torch.Tensor, counts: torch.Tensor,
               L: int) -> torch.Tensor:
    """The order the kernel's warps take the flat slots q·C + c in: every
    slot to compute (below its query's count, leaf id in [0, L)) in
    ascending leaf id (stable: queries in order within a leaf), then every
    other slot, whatever id it holds.  A warp stops at its first slot with
    nothing to compute, so the order must put those last."""
    return torch.argsort(_keys(leaves, counts, L), stable=True)
