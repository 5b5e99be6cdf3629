"""Batched top-k search engine and the build's leaf-slab sweeps (port of the
search half of ``repro.core.engine``).

Two strategies over identical semantics, as in the reference:

* ``strategy="scan"`` — the masked sequential cascade: every leaf's
  distances are computed and masked.
* ``strategy="compact"`` (the default) — probe each query's best-lb leaf to
  seed a best-so-far ``bsf0``, keep only leaves with ``d_lb ≤ bsf0`` and
  ``d_F ≤ bsf0`` (a superset of what the cascade scans), score every
  query's survivors in one candidate pass, keep each leaf's k smallest
  distances, and replay the exact cascade over those summaries
  (:func:`replay_cascade`).  Under ``dist_impl="direct"`` the two
  strategies agree bitwise; ``matmul`` and ``pairwise`` (each survivor-count
  bucket's union scored all-pairs by the pairwise CUDA kernel) agree to
  float tolerance.

The candidate pass is the reference's jitted ``_bucket_leaf_topk``.  Here
:func:`_bucket_leaf_topk` takes each query's survivor list (ascending lb)
and count (:func:`survivor_lists`, the same arguments on both devices) and
runs on the card as one launch of the hand-written candidate-pass kernel
(``kernels/leaf_topk``): the survivor pass on its staged instance (each
leaf's rows staged once by TMA for up to 64 of the queries that keep it,
the products on split-TF32 ``wgmma``), the probe, which is the same call
with one leaf a query, on its warp instance (one warp a (query, leaf)
pair, rows read straight from the series); on the CPU as that kernel's
plain version, the port's earlier bucketed torch code.  The default card
path has no host sync before the replay.

The cascade is a ``lax.scan`` over the L visit positions in the reference.
Here :func:`replay_cascade` runs it on the card as one launch of the
hand-written replay kernel (``kernels/replay``: producer warps pre-test
a row's positions into a shared-memory ring, one walker warp walks it),
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

from ..kernels.common import CHUNK_BYTES, next_pow2, on_cpu, pow2_chunk
from ..kernels.l2_scan import ops as l2_ops
from ..kernels.leaf_topk import kernel as leaf_topk_kernel
from ..kernels.leaf_topk import ref as leaf_topk_ref
from ..kernels.replay import kernel as replay_kernel
from ..kernels.replay import ref as replay_ref

_INF = float("inf")

# the pairwise candidate pass's working set per chunk on the card: its
# chunk loop, a dozen launches a chunk, made most of a batch's launches at
# the plain passes' 256 MiB
_CARD_CANDIDATE_CHUNK_BYTES = 1 << 30


@dataclasses.dataclass
class EngineResult:
    topk_d: torch.Tensor           # (Q, k)
    topk_i: torch.Tensor           # (Q, k) row ids into the flat series (−1 pad)
    n_searched: torch.Tensor       # (Q,) cascade accounting (paper metric)
    n_pruned_lb: torch.Tensor      # (Q,)
    n_pruned_filter: torch.Tensor  # (Q,)
    n_computed: torch.Tensor       # (Q,) leaves distance-computed (≥ n_searched)


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


def _bucket_leaf_topk(series, leaf_start, leaf_size, queries, leaves, counts,
                      kk, max_leaf, dist_impl, out_d, out_i, scatter):
    """The candidate pass: query q's survivors are ``leaves[q, :counts[q]]``
    (leaf id L is padding); each (query, leaf) pair's kk smallest distances
    and row ids (+inf/−1 past the leaf's size) go to ``out_d``/``out_i``
    row (q, leaf) when ``scatter``, else row (q, slot).  CUDA tensors go
    to the candidate-pass kernel in one launch; CPU tensors to its plain
    version (``kernels/leaf_topk/ref.py``)."""
    args = (series, leaf_start, leaf_size, queries.contiguous(), leaves,
            counts, kk, max_leaf, dist_impl, out_d, out_i, scatter)
    if on_cpu(series, leaf_start, leaf_size, queries, leaves, counts, out_d,
              out_i):
        return leaf_topk_ref.leaf_topk(*args)
    return leaf_topk_kernel.leaf_topk_cuda(*args)


def survivor_lists(mask: torch.Tensor, order: torch.Tensor):
    """The candidate pass's arguments from the survivor mask (Q, L) and the
    visit order (Q, L): each query's survivor leaves in ascending-lb order,
    then L (leaves (Q, L) int64), and their counts (Q,) int64."""
    L = mask.shape[1]
    mask_ord = torch.gather(mask, 1, order)
    # survivors first, in ascending-lb order (a stable sort of the flags)
    sel = torch.argsort((~mask_ord).to(torch.uint8), dim=1, stable=True)
    leaves = torch.where(torch.gather(mask_ord, 1, sel),
                         torch.gather(order, 1, sel), L)
    return leaves, mask.sum(dim=1)


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


def _union_pass(series, leaf_start, leaf_size, queries, leaves, counts, kk,
                max_leaf, leaf_d, leaf_i):
    """``dist_impl="pairwise"``: per survivor-count bucket, the union of its
    queries' survivors scored all-pairs by the pairwise kernel and written
    to the summaries.  Leaves that are not a query's survivors ride along
    but are pruned by its replay (their d_lb/d_F exceed its bsf0, and bsf
    only decreases).  Returns the leaves computed per query (Q,) int32."""
    Q, m = queries.shape
    L = leaf_start.shape[0]
    dev = queries.device
    budget = (_CARD_CANDIDATE_CHUNK_BYTES if dev.type == "cuda"
              else CHUNK_BYTES)
    counts = counts.cpu().numpy()
    computed = counts.astype(np.int32)
    for C, qis in sorted(leaf_topk_ref.buckets(counts, L).items()):
        qidx = torch.as_tensor(qis, device=dev)
        leaf_np = leaves[qidx, :C].cpu().numpy()
        uni = np.unique(leaf_np[leaf_np < L])
        if uni.size == 0:
            continue
        computed[qis] = uni.size
        chunk = pow2_chunk((max_leaf * m + len(qis) * max_leaf) * 4,
                           next_pow2(uni.size), budget)
        leaf_u = torch.as_tensor(uni, device=dev)
        vals, ids = _union_leaf_topk(series, leaf_start, leaf_size,
                                     queries[qidx], leaf_u, kk, max_leaf,
                                     chunk)
        leaf_d[qidx[:, None], leaf_u[None, :]] = vals
        leaf_i[qidx[:, None], leaf_u[None, :]] = ids
    return torch.as_tensor(computed, device=dev)


def _compact_cascade(series, leaf_start, leaf_size, queries, d_lb, d_F, k,
                     max_leaf, dist_impl):
    Q = queries.shape[0]
    L = leaf_start.shape[0]
    dev = queries.device
    kk = min(k, max_leaf)
    order = torch.argsort(d_lb, dim=1, stable=True)              # (Q, L)

    # -- phase 1: probe the best-lb leaf, mask survivors --------------------
    probe_impl = "matmul" if dist_impl == "pairwise" else dist_impl
    leaf0 = order[:, :1].contiguous()
    p_vals = torch.full((Q, 1, kk), _INF, device=dev)
    p_ids = torch.full((Q, 1, kk), -1, dtype=torch.int64, device=dev)
    _bucket_leaf_topk(series, leaf_start, leaf_size, queries, leaf0,
                      torch.ones(Q, dtype=torch.int64, device=dev), kk,
                      max_leaf, probe_impl, p_vals, p_ids, False)
    bsf0 = (p_vals[:, 0, k - 1] if k <= kk
            else torch.full((Q,), _INF, device=dev))
    mask = (d_lb <= bsf0[:, None]) & (d_F <= bsf0[:, None])
    ar = torch.arange(Q, device=dev)
    mask[ar, leaf0[:, 0]] = True

    # -- phase 2: score every query's survivors -----------------------------
    leaves, counts = survivor_lists(mask, order)
    # leaf row L is a scratch row: padding slots may aim their writes at it,
    # and it is sliced off before the replay.
    leaf_d = torch.full((Q, L + 1, kk), _INF, device=dev)
    leaf_i = torch.full((Q, L + 1, kk), -1, dtype=torch.int64, device=dev)
    if dist_impl == "pairwise":
        computed = _union_pass(series, leaf_start, leaf_size, queries, leaves,
                               counts, kk, max_leaf, leaf_d, leaf_i)
    else:
        _bucket_leaf_topk(series, leaf_start, leaf_size, queries, leaves,
                          counts, kk, max_leaf, dist_impl, leaf_d, leaf_i,
                          True)
        computed = counts.to(torch.int32)

    leaf_d, leaf_i = leaf_d[:, :L], leaf_i[:, :L]        # drop the scratch row
    # reuse the probe's leaf-0 values verbatim (see the module docstring)
    leaf_d[ar, leaf0[:, 0]] = p_vals[:, 0]
    leaf_i[ar, leaf0[:, 0]] = p_ids[:, 0]

    # -- phase 3: exact cascade replay over the per-leaf summaries ----------
    out = replay_cascade(leaf_d, leaf_i, d_lb, d_F, order, k)
    return out + (computed,)


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
    chunk = pow2_chunk((Q * max_leaf + max_leaf * m) * 4, next_pow2(L))
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
    chunk = pow2_chunk((nq * max_leaf + max_leaf * m + nq * m) * 4,
                       next_pow2(max(F, 1)))
    out = torch.empty((F, nq), device=dev)
    for c0 in range(0, F, chunk):
        slabs, _, valid = l2_ops.gather_leaf_slabs(
            series, leaf_start, leaf_size, leaf_ids[c0:c0 + chunk], max_leaf)
        d = l2_ops.slab_l2(local_queries[c0:c0 + chunk], slabs, dist_impl)
        out[c0:c0 + chunk] = l2_ops.slab_masked_min(d, valid)[0]
    return out
