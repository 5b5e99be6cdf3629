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
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..common import CHUNK_BYTES, next_pow2, pow2_chunk
from ..l2_scan import ops as l2_ops

_INF = float("inf")

#: the distance forms the kernel takes
IMPLS = ("matmul", "direct")


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
