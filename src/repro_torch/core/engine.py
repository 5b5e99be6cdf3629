"""Batched top-k search engine and the build's leaf-slab sweeps (port of the
search half of ``repro.core.engine``).

Two strategies over identical semantics, as in the reference:

* ``strategy="scan"`` — the masked sequential cascade: every leaf's
  distances are computed and masked.
* ``strategy="compact"`` (the default) — probe each query's best-lb leaf to
  seed a best-so-far ``bsf0``, keep only leaves with ``d_lb ≤ bsf0`` and
  ``d_F ≤ bsf0`` (a superset of what the cascade scans), score the
  survivors in one batched candidate pass per survivor-count bucket, keep
  each leaf's k smallest distances, and replay the exact cascade over those
  summaries (:func:`replay_cascade`).  Under ``dist_impl="direct"`` the two
  strategies agree bitwise; ``matmul`` and ``pairwise`` (each bucket's
  survivor union scored all-pairs by the pairwise CUDA kernel) agree to
  float tolerance.

The cascade is a ``lax.scan`` over the L visit positions in the reference.
Here :func:`replay_cascade` runs it on the card as one launch of the
hand-written replay kernel (``kernels/replay``, one warp walks one row),
and on the CPU as that kernel's plain version, a Python loop over the
positions vectorised over the rows; the two agree bitwise.  The probe's
leaf-0 values are written verbatim into the replay's summaries, so the
replay's bsf after its first merge equals ``bsf0`` bitwise, which is what
makes the survivor mask a true superset.  ``strategy="scan"`` keeps its
own loop over the positions (it scores every leaf; the oracle, not the
main path).

``nn_distance_all_leaves`` / ``nn_distance_own_leaf`` are the build's
training-target sweeps over padded leaf slabs, through the pairwise and slab
CUDA kernels on the card.  Chunk widths target a larger working set than the
reference's 4 MiB: chunking does not change results, and on the card a
wider chunk means fewer, fuller launches.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..kernels.common import on_cpu
from ..kernels.l2_scan import ops as l2_ops
from ..kernels.replay import kernel as replay_kernel
from ..kernels.replay import ref as replay_ref

_INF = float("inf")

# gathered working set per chunk (bytes of f32 rows); on the card the
# compact candidate pass takes 1 GiB: its chunk loop, a dozen launches a
# chunk, made most of a batch's launches at 256 MiB
_CHUNK_BYTES = 256 << 20
_CARD_CANDIDATE_CHUNK_BYTES = 1 << 30


@dataclasses.dataclass
class EngineResult:
    topk_d: torch.Tensor           # (Q, k)
    topk_i: torch.Tensor           # (Q, k) row ids into the flat series (−1 pad)
    n_searched: torch.Tensor       # (Q,) cascade accounting (paper metric)
    n_pruned_lb: torch.Tensor      # (Q,)
    n_pruned_filter: torch.Tensor  # (Q,)
    n_computed: torch.Tensor       # (Q,) leaves distance-computed (≥ n_searched)


def _next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def _pow2_chunk(per_leaf_bytes: int, cap: int,
                budget: int = _CHUNK_BYTES) -> int:
    """Power-of-two chunk keeping ``chunk · per_leaf_bytes`` near
    ``budget`` (capped at ``cap``)."""
    chunk = max(budget // max(per_leaf_bytes, 1), 1)
    return min(1 << (int(chunk).bit_length() - 1), cap)


# ---------------------------------------------------------------------------
# strategy="scan"
# ---------------------------------------------------------------------------


def _scan_cascade(series, leaf_start, leaf_size, queries, d_lb, d_F, k,
                  max_leaf):
    Q, L = d_lb.shape
    dev = queries.device
    order = torch.argsort(d_lb, dim=1, stable=True)
    lb_ord = torch.gather(d_lb, 1, order)
    dF_ord = torch.gather(d_F, 1, order)
    row_ids = torch.arange(max_leaf, device=dev)
    topk_d, topk_i = replay_ref.init_topk(Q, k, dev)
    plb_hist = torch.zeros((L, Q), dtype=torch.bool, device=dev)
    pf_hist = torch.zeros((L, Q), dtype=torch.bool, device=dev)
    for p in range(L):
        leaf = order[:, p]
        bsf = topk_d[:, -1]
        p_lb = lb_ord[:, p] > bsf
        p_f = ~p_lb & (dF_ord[:, p] > bsf)
        pruned = p_lb | p_f
        rows = leaf_start[leaf][:, None] + row_ids               # (Q, R)
        d = l2_ops.gathered_leaf_l2(queries, series[rows][:, None],
                                    "direct")[:, 0]              # (Q, R)
        keep = (row_ids < leaf_size[leaf][:, None]) & ~pruned[:, None]
        d = torch.where(keep, d, _INF)
        topk_d, topk_i = replay_ref.merge_topk(topk_d, topk_i, d, rows, k)
        plb_hist[p] = p_lb
        pf_hist[p] = p_f
    return replay_ref.counted(topk_d, topk_i, plb_hist, pf_hist)


# ---------------------------------------------------------------------------
# strategy="compact"
# ---------------------------------------------------------------------------


def _bucket_leaf_topk(series, leaf_start, leaf_size, queries_b, leaf_b, kk,
                      max_leaf, chunk, dist_impl):
    """Per-leaf k smallest distances for a bucket of per-query survivor
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


def _union_leaf_topk(series, leaf_start, leaf_size, queries_b, leaf_u, kk,
                     max_leaf, chunk):
    """Per-leaf k smallest distances over a bucket's shared survivor union:
    every query against every union leaf, one pairwise-kernel launch per
    chunk.  Returns (vals (Qb, U, kk), ids (Qb, U, kk))."""
    Qb = queries_b.shape[0]
    U = leaf_u.shape[0]
    dev = queries_b.device
    vals_out = torch.empty((Qb, U, kk), device=dev)
    ids_out = torch.empty((Qb, U, kk), dtype=torch.int64, device=dev)
    for c0 in range(0, U, chunk):
        slabs, rows, valid = l2_ops.gather_leaf_slabs(
            series, leaf_start, leaf_size, leaf_u[c0:c0 + chunk], max_leaf)
        d = l2_ops.shared_slab_l2(queries_b, slabs, "pairwise")  # (Qb, c, R)
        d = torch.where(valid[None], d, _INF)
        vals, ids = l2_ops.leaf_topk(d, rows[None].expand_as(d), kk)
        vals_out[:, c0:c0 + chunk] = vals
        ids_out[:, c0:c0 + chunk] = torch.where(torch.isfinite(vals), ids, -1)
    return vals_out, ids_out


def replay_cascade(leaf_d: torch.Tensor, leaf_i: torch.Tensor,
                   d_lb: torch.Tensor, d_F: torch.Tensor,
                   order: torch.Tensor, k: int):
    """Exact sequential-cascade replay over per-leaf top-k summaries.

    leaf_d/leaf_i: (Q, L, kk) each leaf's kk smallest distances and row ids;
    order: (Q, L) visit order.  Returns (topk_d (Q, k), topk_i (Q, k),
    n_searched, n_pruned_lb, n_pruned_filter).  The one copy of the
    cascade's decision logic: compact search runs it over gathered
    candidate summaries, calibration (``conformal.simulate_search``) with
    k=1 over the precollected d_L matrices.  CUDA tensors go to the replay
    kernel in one launch; CPU tensors to its plain version
    (``kernels/replay/ref.py``), which it equals bitwise.
    """
    if on_cpu(leaf_d, leaf_i, d_lb, d_F, order):
        return replay_ref.replay_cascade(leaf_d, leaf_i, d_lb, d_F, order, k)
    return replay_kernel.replay_cascade_cuda(
        leaf_d, leaf_i, d_lb.contiguous(), d_F.contiguous(),
        order.contiguous(), k)


def _compact_cascade(series, leaf_start, leaf_size, queries, d_lb, d_F, k,
                     max_leaf, dist_impl):
    Q, m = queries.shape
    L = leaf_start.shape[0]
    dev = queries.device
    kk = min(k, max_leaf)
    order = torch.argsort(d_lb, dim=1, stable=True)              # (Q, L)
    budget = (_CARD_CANDIDATE_CHUNK_BYTES if dev.type == "cuda"
              else _CHUNK_BYTES)

    # -- phase 1: probe the best-lb leaf, mask survivors --------------------
    probe_impl = "matmul" if dist_impl == "pairwise" else dist_impl
    leaf0 = order[:, :1]
    p_vals, p_ids = _bucket_leaf_topk(series, leaf_start, leaf_size, queries,
                                      leaf0, kk, max_leaf, 1, probe_impl)
    bsf0 = (p_vals[:, 0, k - 1] if k <= kk
            else torch.full((Q,), _INF, device=dev))
    mask = (d_lb <= bsf0[:, None]) & (d_F <= bsf0[:, None])
    ar = torch.arange(Q, device=dev)
    mask[ar, leaf0[:, 0]] = True

    # -- phase 2: bucket queries by survivor count, compact leaf lists ------
    counts = mask.sum(dim=1).cpu().numpy()
    computed = counts.astype(np.int32)
    # leaf row L is a scratch row: invalid slots aim their scatters at it,
    # and it is sliced off before the replay.
    leaf_d = torch.full((Q, L + 1, kk), _INF, device=dev)
    leaf_i = torch.full((Q, L + 1, kk), -1, dtype=torch.int64, device=dev)
    # survivors first, in ascending-lb order (a stable sort of the flags)
    mask_ord = torch.gather(mask, 1, order)
    sel_all = torch.argsort((~mask_ord).to(torch.uint8), dim=1, stable=True)

    buckets: dict[int, list[int]] = {}
    for qi, c in enumerate(counts):
        buckets.setdefault(min(_next_pow2(max(int(c), 1)), L), []).append(qi)

    for C, qis in sorted(buckets.items()):
        qidx = torch.as_tensor(qis, device=dev)
        sel = sel_all[qidx, :C]                                  # (Qb, C)
        valid = torch.gather(mask_ord[qidx], 1, sel)
        leaf = torch.where(valid, torch.gather(order[qidx], 1, sel), L)
        Qb = len(qis)
        if dist_impl == "pairwise":
            # union the bucket's survivors into one shared slab for the
            # pairwise kernel; leaves that are not a query's survivors ride
            # along but are pruned by its replay (their d_lb/d_F exceed its
            # bsf0, and bsf only decreases).
            leaf_np = leaf.cpu().numpy()
            uni = np.unique(leaf_np[leaf_np < L])
            if uni.size == 0:
                continue
            computed[qis] = uni.size
            chunk = _pow2_chunk((max_leaf * m + Qb * max_leaf) * 4,
                                _next_pow2(uni.size), budget)
            leaf_u = torch.as_tensor(uni, device=dev)
            vals, ids = _union_leaf_topk(series, leaf_start, leaf_size,
                                         queries[qidx], leaf_u, kk, max_leaf,
                                         chunk)
            leaf_sc = leaf_u[None, :].expand(Qb, -1)
        else:
            chunk = _pow2_chunk(Qb * max_leaf * m * 4, _next_pow2(C),
                                budget)
            vals, ids = _bucket_leaf_topk(series, leaf_start, leaf_size,
                                          queries[qidx], leaf, kk, max_leaf,
                                          chunk, dist_impl)
            leaf_sc = leaf
        leaf_d[qidx[:, None], leaf_sc] = vals
        leaf_i[qidx[:, None], leaf_sc] = ids

    leaf_d, leaf_i = leaf_d[:, :L], leaf_i[:, :L]        # drop the scratch row
    # reuse the probe's leaf-0 values verbatim (see the module docstring)
    leaf_d[ar, leaf0[:, 0]] = p_vals[:, 0]
    leaf_i[ar, leaf0[:, 0]] = p_ids[:, 0]

    # -- phase 3: exact cascade replay over the per-leaf summaries ----------
    out = replay_cascade(leaf_d, leaf_i, d_lb, d_F, order, k)
    return out + (torch.as_tensor(computed, device=dev),)


def run_cascade(series: torch.Tensor, leaf_start: torch.Tensor,
                leaf_size: torch.Tensor, queries: torch.Tensor,
                d_lb: torch.Tensor, d_F: torch.Tensor, *, k: int,
                max_leaf: int, strategy: str = "auto",
                dist_impl: Optional[str] = None) -> EngineResult:
    """Batched top-k leaf-cascade search over precomputed pruning inputs.

    series (n + max_leaf, m) leaf-sorted and padded; leaf_start/leaf_size
    (L,); queries (Q, m); d_lb (Q, L) lower bounds; d_F (Q, L) adjusted
    filter predictions (−inf never prunes).  strategy: "compact" (default
    via "auto") or "scan".  dist_impl: "direct" | "matmul" | "pairwise" |
    None (``matmul`` on the card, ``direct`` on the CPU).
    """
    if strategy == "auto":
        strategy = "compact"
    if strategy == "scan":
        td, ti, n_s, n_plb, n_pf = _scan_cascade(
            series, leaf_start, leaf_size, queries, d_lb, d_F, k, max_leaf)
        n_c = torch.full((queries.shape[0],), leaf_start.shape[0],
                         dtype=torch.int32, device=queries.device)
    elif strategy == "compact":
        dist_impl = dist_impl or l2_ops.default_gathered_impl(queries.device)
        td, ti, n_s, n_plb, n_pf, n_c = _compact_cascade(
            series, leaf_start, leaf_size, queries, d_lb, d_F, k, max_leaf,
            dist_impl)
    else:
        raise ValueError(f"unknown engine strategy {strategy!r}")
    return EngineResult(td, ti, n_s, n_plb, n_pf, n_c)


# ---------------------------------------------------------------------------
# leaf-slab build passes (training-data collection)
# ---------------------------------------------------------------------------


def nn_distance_all_leaves(series: torch.Tensor, leaf_start: torch.Tensor,
                           leaf_size: torch.Tensor, queries: torch.Tensor, *,
                           max_leaf: int, dist_impl: Optional[str] = None
                           ) -> torch.Tensor:
    """Min distance from every query to every leaf → (Q, L): leaves stream
    through in chunks, each scored by ``shared_slab_l2`` (the pairwise
    kernel on the card) and masked-min reduced."""
    Q, m = queries.shape
    L = leaf_start.shape[0]
    dev = queries.device
    dist_impl = dist_impl or l2_ops.default_slab_impl(dev)
    chunk = _pow2_chunk((Q * max_leaf + max_leaf * m) * 4, _next_pow2(L))
    out = torch.empty((Q, L), device=dev)
    for c0 in range(0, L, chunk):
        ids = torch.arange(c0, min(c0 + chunk, L), device=dev)
        slabs, _, valid = l2_ops.gather_leaf_slabs(
            series, leaf_start, leaf_size, ids, max_leaf)
        d = l2_ops.shared_slab_l2(queries, slabs, dist_impl)   # (Q, c, R)
        out[:, c0:c0 + chunk] = torch.where(valid[None], d, _INF).amin(-1)
    return out


def nn_distance_own_leaf(series: torch.Tensor, leaf_start: torch.Tensor,
                         leaf_size: torch.Tensor, local_queries: torch.Tensor,
                         leaf_ids: torch.Tensor, *, max_leaf: int,
                         dist_impl: Optional[str] = None) -> torch.Tensor:
    """Min distance of each leaf's own query batch to that leaf → (F, nq):
    the selected leaves' slabs are gathered in chunks and scored by
    ``slab_l2`` (the slab kernel on the card)."""
    F, nq, m = local_queries.shape
    dev = local_queries.device
    dist_impl = dist_impl or l2_ops.default_slab_impl(dev)
    chunk = _pow2_chunk((nq * max_leaf + max_leaf * m + nq * m) * 4,
                        _next_pow2(max(F, 1)))
    out = torch.empty((F, nq), device=dev)
    for c0 in range(0, F, chunk):
        slabs, _, valid = l2_ops.gather_leaf_slabs(
            series, leaf_start, leaf_size, leaf_ids[c0:c0 + chunk], max_leaf)
        d = l2_ops.slab_l2(local_queries[c0:c0 + chunk], slabs, dist_impl)
        out[c0:c0 + chunk] = l2_ops.slab_masked_min(d, valid)[0]
    return out
