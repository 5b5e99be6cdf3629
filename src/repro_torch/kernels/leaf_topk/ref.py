"""Plain PyTorch version of the candidate-pass kernel.

``leaf_topk`` is the function ``csrc/leaf_topk.cu`` computes, with the
kernel wrapper's signature: the engine runs it for CPU tensors and
``chip_smoke.py`` holds the kernel against it on the card.  It is the
reference's ``_bucket_leaf_topk`` (``src/repro/core/engine.py:271``) as the
port ran it before the kernel: the queries bucketed by survivor count
(powers of two), each bucket's survivor slabs gathered in chunks, scored by
``gathered_leaf_l2``, masked past each leaf's size, and the kk smallest of
each kept by a stable sort (``l2_scan.ops.leaf_topk``); the results land in
the caller's output rows.

``leaf_topk_split_tf32`` emulates the staged (``wgmma``) instance's
arithmetic on the CPU for the tests; no path runs it.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..common import CHUNK_BYTES, next_pow2, pow2_chunk
from ..filter_train.ref import x_lo
from ..l2_scan import ops as l2_ops
from ..l2_scan.ref import split_tf32, tensor_core_steps, tf32_truncate

_INF = float("inf")

#: the distance forms the kernel takes
IMPLS = ("matmul", "direct")
#: k8 steps a stage of the staged instance (32 columns), summed from zero on
#: the tensor cores before the float32 total
STAGE_STEPS = 4


def buckets(counts: np.ndarray, width: int) -> Dict[int, List[int]]:
    """Queries by survivor count rounded up to a power of two (at least 1,
    at most ``width``): {bucket width: query indices}."""
    out: Dict[int, List[int]] = {}
    for qi, c in enumerate(np.asarray(counts).tolist()):
        out.setdefault(min(next_pow2(max(int(c), 1)), width), []).append(qi)
    return out


def slots_topk(series, leaf_start, leaf_size, queries_b, leaf_b, kk,
               max_leaf, chunk, dist_impl) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """Per-slot kk smallest distances for a bucket of per-query survivor
    lists.  leaf_b: (Qb, C) leaf ids, invalid slots == L.  Returns
    (vals (Qb, C, kk), ids (Qb, C, kk)) with +inf/−1 in invalid slots."""
    Qb, C = leaf_b.shape
    L = leaf_start.shape[0]
    dev = queries_b.device
    row_ids = torch.arange(max_leaf, device=dev)
    vals_out = torch.empty((Qb, C, kk), device=dev)
    ids_out = torch.empty((Qb, C, kk), dtype=torch.int64, device=dev)
    for c0 in range(0, C, chunk):
        lf = leaf_b[:, c0:c0 + chunk]
        safe = torch.clamp_max(lf, L - 1)
        sizes = torch.where(lf < L, leaf_size[safe], 0)
        rows = leaf_start[safe][..., None] + row_ids             # (Qb, c, R)
        d = l2_ops.gathered_leaf_l2(queries_b, series[rows], dist_impl)
        d = torch.where(row_ids < sizes[..., None], d, _INF)
        vals, ids = l2_ops.leaf_topk(d, rows, kk)
        vals_out[:, c0:c0 + chunk] = vals
        ids_out[:, c0:c0 + chunk] = torch.where(torch.isfinite(vals), ids, -1)
    return vals_out, ids_out


def leaf_topk(series: torch.Tensor, leaf_start: torch.Tensor,
              leaf_size: torch.Tensor, queries: torch.Tensor,
              leaves: torch.Tensor, counts: torch.Tensor, kk: int,
              max_leaf: int, dist_impl: str, out_d: torch.Tensor,
              out_i: torch.Tensor, scatter: bool
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The candidate pass: query q's survivors are ``leaves[q, :counts[q]]``
    (ids == L are padding); each pair's kk smallest distances and row ids
    are written to ``out_d[q, r]`` / ``out_i[q, r]``, r the leaf id
    (``scatter``; out then has a scratch row L, which padding slots write
    +inf/−1 to) or the slot.  Rows of ``out`` no pair names are left as they
    are.  Returns (out_d, out_i)."""
    Q, C = leaves.shape
    L = leaf_start.shape[0]
    m = queries.shape[1]
    dev = queries.device
    for width, qis in sorted(buckets(counts.cpu().numpy(), C).items()):
        qidx = torch.as_tensor(qis, device=dev)
        past = torch.arange(width, device=dev) >= counts[qidx, None]
        leaf = torch.where(past, L, leaves[qidx, :width])
        chunk = pow2_chunk(len(qis) * max_leaf * m * 4, next_pow2(width),
                           CHUNK_BYTES)
        vals, ids = slots_topk(series, leaf_start, leaf_size, queries[qidx],
                               leaf, kk, max_leaf, chunk, dist_impl)
        rows = (leaf if scatter
                else torch.arange(width, device=dev)[None].expand_as(leaf))
        out_d[qidx[:, None], rows] = vals
        out_i[qidx[:, None], rows] = ids
    return out_d, out_i


def leaf_topk_split_tf32(series: torch.Tensor, leaf_start: torch.Tensor,
                         leaf_size: torch.Tensor, queries: torch.Tensor,
                         leaves: torch.Tensor, counts: torch.Tensor, kk: int,
                         max_leaf: int, dist_impl: str, out_d: torch.Tensor,
                         out_i: torch.Tensor, scatter: bool
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`leaf_topk` in the ``matmul`` form as the staged instance
    computes it: q·s on the tensor cores, the query split into hi
    (``tf32_round``) and lo (the truncated rest), the row read as its
    trunc(x) and its lo = x − trunc(x) (``filter_train.ref.x_lo``, read
    truncated in turn), three products a k8 step (lo·x_hi, hi·x_lo,
    hi·x_hi), each step's sum rounded toward zero, each 32-column stage
    summed from zero and added to a float32 total (``tensor_core_steps``
    with ``flush_every=STAGE_STEPS``); |q|² and |s|² in float32; then
    sqrt(max((|q|² + |s|²) − 2 q·s, 0)) and each pair's kk smallest, ties
    to the lower row.  Only the slots to compute are written (below their
    count, id in [0, L)).  Returns (out_d, out_i)."""
    if dist_impl != "matmul":
        raise ValueError("the staged instance computes the matmul form")
    q = queries.float()
    s = series.float()
    a_hi, a_lo = split_tf32(q)
    s_hi, s_lo = tf32_truncate(s).T, tf32_truncate(x_lo(s)).T
    dot = tensor_core_steps([(a_lo, s_hi), (a_hi, s_lo), (a_hi, s_hi)],
                            flush_every=STAGE_STEPS)
    d = torch.sqrt(torch.clamp_min(((q * q).sum(-1)[:, None]
                                    + (s * s).sum(-1)[None, :]) - 2.0 * dot,
                                   0.0))
    L = leaf_start.shape[0]
    slot = torch.arange(leaves.shape[1])
    todo = (slot < counts[:, None]) & (leaves >= 0) & (leaves < L)
    qi, ci = todo.nonzero(as_tuple=True)
    lf = leaves[qi, ci]
    row_ids = torch.arange(max(max_leaf, kk))
    rows = leaf_start[lf][:, None] + row_ids
    vals = torch.where(row_ids < leaf_size[lf][:, None],
                       d[qi[:, None], rows.clamp_max(s.shape[0] - 1)], _INF)
    vals, ids = l2_ops.leaf_topk(vals, rows, kk)
    dest = lf if scatter else ci
    out_d[qi, dest] = vals
    out_i[qi, dest] = torch.where(torch.isfinite(vals), ids, -1)
    return out_d, out_i
