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

``run_cascade`` takes the reference's prune-only bound ``bsf_ub`` (the lb
test against min(bsf, ub), never the filter test or the merge, so exact
answers are bitwise those of an unbounded run) and its ``trace`` and
``audit`` flags: a per-query :class:`~repro_torch.obs.trace.CascadeTrace`
and a per-leaf :class:`~repro_torch.obs.audit.FilterAudit`, attributed at
the stage where each prune happened (each scan position; the compact
strategy's survivor mask), with answers and counters bitwise the same
either way.  The compact strategy's trace is mask-stage, so its replay
runs the kernel's untraced instance (with the bound where one is given);
``replay_cascade(trace=True)`` gives the replay stage's own box/seed split.

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
from ..obs import audit as obs_audit
from ..obs.audit import AuditParts, FilterAudit
from ..obs.trace import CascadeTrace

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
    trace: Optional[CascadeTrace] = None  # run_cascade(trace=True)
    audit: Optional[FilterAudit] = None   # run_cascade(audit=True)


# ---------------------------------------------------------------------------
# strategy="scan"
# ---------------------------------------------------------------------------


def _scan_cascade(series, leaf_start, leaf_size, queries, d_lb, d_F, k,
                  max_leaf, ub=None, trace=False, audit=False):
    """The masked sequential cascade: (topk_d, topk_i, n_s, n_plb, n_pf),
    then, with ``trace``, its CascadeTrace (box and seed split of each
    position's lb test, the rows of every searched leaf) and, with
    ``audit``, its AuditParts (each position's planes and the leaf's
    nearest distance where searched, put in leaf order)."""
    Q, L = d_lb.shape
    dev = queries.device
    order = torch.argsort(d_lb, dim=1, stable=True)
    lb_ord = torch.gather(d_lb, 1, order)
    dF_ord = torch.gather(d_F, 1, order)
    row_ids = torch.arange(max_leaf, device=dev)
    topk_d, topk_i = replay_ref.init_topk(Q, k, dev)
    plb_hist = torch.zeros((L, Q), dtype=torch.bool, device=dev)
    pf_hist = torch.zeros((L, Q), dtype=torch.bool, device=dev)
    box_hist = torch.zeros((L, Q), dtype=torch.bool, device=dev)
    nn_hist = torch.full((L, Q), _INF, device=dev) if audit else None
    n_rows = torch.zeros(Q, dtype=torch.int32, device=dev)
    for p in range(L):
        leaf = order[:, p]
        bsf = topk_d[:, -1]
        p_box = lb_ord[:, p] > bsf
        # ub tightens the lb test only; the filter test keeps the witnessed
        # bsf, whose trajectory the conformal offsets were calibrated on
        p_lb = p_box if ub is None else lb_ord[:, p] > torch.minimum(bsf, ub)
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
        box_hist[p] = p_box
        if trace:
            n_rows += torch.where(pruned, 0, leaf_size[leaf]).to(torch.int32)
        if audit:
            nn_hist[p] = d.amin(dim=1)
    out = replay_ref.counted(topk_d, topk_i, plb_hist, pf_hist)
    seed_hist = plb_hist & ~box_hist
    if trace:
        zeros = torch.zeros(Q, dtype=torch.int32, device=dev)
        out += (CascadeTrace(box_hist.sum(dim=0, dtype=torch.int32),
                             seed_hist.sum(dim=0, dtype=torch.int32), out[4],
                             zeros, out[2], zeros, n_rows),)
    if audit:
        def leaf_order(hist):                  # (L, Q) visit order → (Q, L)
            return torch.empty_like(hist.T).scatter_(1, order, hist.T)
        kept = leaf_order(~(plb_hist | pf_hist))
        out += (AuditParts(leaf_order(box_hist), leaf_order(seed_hist),
                           leaf_order(pf_hist), kept, kept,
                           leaf_order(nn_hist)),)
    return out


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
                   order: torch.Tensor, k: int,
                   bsf_ub: Optional[torch.Tensor] = None,
                   trace: bool = False):
    """Exact sequential-cascade replay over per-leaf top-k summaries.

    leaf_d/leaf_i: (Q, L, kk) each leaf's kk smallest distances and row ids;
    order: (Q, L) visit order; bsf_ub: optional (Q,) prune-only bound (the
    lb test against min(bsf, ub)).  Returns (topk_d (Q, k), topk_i (Q, k),
    n_searched, n_pruned_lb, n_pruned_filter) and, with ``trace``, the
    replay stage's (n_box, n_seed) split of n_pruned_lb.  The one copy of
    the cascade's decision logic: compact search runs it over gathered
    candidate summaries, calibration (``conformal.simulate_search``) with
    k=1 over the precollected d_L matrices.  CUDA tensors go to the replay
    kernel in one launch (its plain, bound or traced instance); CPU
    tensors to its plain version (``kernels/replay/ref.py``), which it
    equals bitwise.
    """
    if on_cpu(leaf_d, leaf_i, d_lb, d_F, order):
        return replay_ref.replay_cascade(leaf_d, leaf_i, d_lb, d_F, order, k,
                                         bsf_ub=bsf_ub, trace=trace)
    return replay_kernel.replay_cascade_cuda(
        leaf_d, leaf_i, d_lb.contiguous(), d_F.contiguous(),
        order.contiguous(), k, bsf_ub=bsf_ub, trace=trace)


def _union_pass(series, leaf_start, leaf_size, queries, leaves, counts, kk,
                max_leaf, leaf_d, leaf_i, dist_rows=None, probe_rows=None):
    """``dist_impl="pairwise"``: per survivor-count bucket, the union of its
    queries' survivors scored all-pairs by the pairwise kernel and written
    to the summaries.  Leaves that are not a query's survivors ride along
    but are pruned by its replay (their d_lb/d_F exceed its bsf0, and bsf
    only decreases).  Returns the leaves computed per query (Q,) int32.
    Given the trace's ``dist_rows`` (Q,), a bucket's queries get their
    probe's rows (``probe_rows``) and the whole union's there."""
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
        if dist_rows is not None:
            dist_rows[qidx] = probe_rows[qidx] + leaf_size[leaf_u].sum().to(
                torch.int32)
        vals, ids = _union_leaf_topk(series, leaf_start, leaf_size,
                                     queries[qidx], leaf_u, kk, max_leaf,
                                     chunk)
        leaf_d[qidx[:, None], leaf_u[None, :]] = vals
        leaf_i[qidx[:, None], leaf_u[None, :]] = ids
    return torch.as_tensor(computed, device=dev)


def _mask_partition(mask, d_lb, bsf0, bsf0m):
    """The compact strategy's non-survivors split by the first bound that
    excluded them: box (d_lb > bsf0), seed (only min(bsf0, ub) excluded
    it), filter (the rest: d_F > bsf0).  Three (Q, L) bool planes."""
    not_m = ~mask
    p_box = not_m & (d_lb > bsf0[:, None])
    p_seed = not_m & ~p_box & (d_lb > bsf0m[:, None])
    return p_box, p_seed, not_m & ~p_box & ~p_seed


def _compact_trace_stats(mask, d_lb, bsf0, bsf0m, leaf_size, leaf0):
    """The compact strategy's mask-stage CascadeTrace: the partition of
    :func:`_mask_partition`, the probe in ``probed``, and the rows paid:
    the probe's and every survivor's (the probe leaf is scored again in
    the pass)."""
    Q = mask.shape[0]
    p_box, p_seed, p_filt = _mask_partition(mask, d_lb, bsf0, bsf0m)
    sizes = leaf_size.to(torch.int32)
    dist_rows = (sizes[leaf0[:, 0]]
                 + torch.where(mask, sizes[None, :], 0).sum(dim=1,
                                                            dtype=torch.int32))
    return CascadeTrace(
        pruned_box=p_box.sum(dim=1, dtype=torch.int32),
        pruned_seed=p_seed.sum(dim=1, dtype=torch.int32),
        pruned_filter=p_filt.sum(dim=1, dtype=torch.int32),
        probed=torch.ones(Q, dtype=torch.int32, device=mask.device),
        survivors=mask.sum(dim=1, dtype=torch.int32) - 1,
        overflow=torch.zeros(Q, dtype=torch.int32, device=mask.device),
        distances=dist_rows)


def _compact_audit_parts(mask, d_lb, bsf0, bsf0m, leaf_nn):
    """The compact strategy's audit planes: the partition of
    :func:`_mask_partition`, ``kept`` the survivor mask (the probe leaf
    included), ``scored`` every leaf with a finite summary (``kept`` for
    the per-query passes, a superset under the pairwise union)."""
    return AuditParts(*_mask_partition(mask, d_lb, bsf0, bsf0m), mask,
                      torch.isfinite(leaf_nn), leaf_nn)


def _compact_cascade(series, leaf_start, leaf_size, queries, d_lb, d_F, k,
                     max_leaf, dist_impl, bsf_ub=None, trace=False,
                     audit=False):
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
    # the replay's lb threshold never exceeds min(bsf0, ub) after its first
    # merge, so masking d_lb against it keeps the superset; d_F masks
    # against bsf0 alone, as the replay's filter test never sees ub
    bsf0m = bsf0 if bsf_ub is None else torch.minimum(bsf0, bsf_ub)
    mask = (d_lb <= bsf0m[:, None]) & (d_F <= bsf0[:, None])
    ar = torch.arange(Q, device=dev)
    mask[ar, leaf0[:, 0]] = True
    aux = (_compact_trace_stats(mask, d_lb, bsf0, bsf0m, leaf_size, leaf0)
           if trace else None)

    # -- phase 2: score every query's survivors -----------------------------
    leaves, counts = survivor_lists(mask, order)
    # leaf row L is a scratch row: padding slots may aim their writes at it,
    # and it is sliced off before the replay.
    leaf_d = torch.full((Q, L + 1, kk), _INF, device=dev)
    leaf_i = torch.full((Q, L + 1, kk), -1, dtype=torch.int64, device=dev)
    if dist_impl == "pairwise":
        union_rows = None if aux is None else aux.distances.clone()
        computed = _union_pass(
            series, leaf_start, leaf_size, queries, leaves, counts, kk,
            max_leaf, leaf_d, leaf_i, union_rows,
            None if aux is None else leaf_size.to(torch.int32)[leaf0[:, 0]])
        if aux is not None:
            aux = aux._replace(distances=union_rows)
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
    out = replay_cascade(leaf_d, leaf_i, d_lb, d_F, order, k, bsf_ub=bsf_ub)
    out += (computed,)
    if trace:
        out += (aux,)
    if audit:
        # slot 0 is each scored leaf's exact nearest distance (the probe
        # leaf's written verbatim above), +inf where never scored
        out += (_compact_audit_parts(mask, d_lb, bsf0, bsf0m,
                                     leaf_d[:, :, 0]),)
    return out


def run_cascade(series: torch.Tensor, leaf_start: torch.Tensor,
                leaf_size: torch.Tensor, queries: torch.Tensor,
                d_lb: torch.Tensor, d_F: torch.Tensor, *, k: int,
                max_leaf: int, strategy: str = "auto",
                dist_impl: Optional[str] = None, bsf_ub=None,
                trace: bool = False, audit: bool = False) -> EngineResult:
    """Batched top-k leaf-cascade search over precomputed pruning inputs.

    series (n + max_leaf, m) leaf-sorted and padded; leaf_start/leaf_size
    (L,); queries (Q, m); d_lb (Q, L) lower bounds; d_F (Q, L) adjusted
    filter predictions (−inf never prunes).  strategy: "compact" (default
    via "auto") or "scan".  dist_impl: "direct" | "matmul" | "pairwise" |
    None (``matmul`` on the card, ``direct`` on the CPU).

    bsf_ub: optional (Q,) prune-only upper bound on each query's true k-th
    nearest distance.  It tightens the lower-bound prune to min(bsf, ub)
    and never enters the filter test (the conformal offsets are calibrated
    on the unbounded bsf) or the merge: exact answers are bitwise those of
    an unbounded run, and only ``searched``/``computed`` shrink; +inf
    entries change nothing.  trace: also return a per-query
    :class:`~repro_torch.obs.trace.CascadeTrace` on ``.trace``.  audit:
    also return a per-leaf :class:`~repro_torch.obs.audit.FilterAudit` on
    ``.audit``.  Answers and counters are bitwise the same with either
    flag on or off (``repro_torch.obs`` gives their semantics).
    """
    if strategy == "auto":
        strategy = "compact"
    ub = (None if bsf_ub is None else torch.as_tensor(
        bsf_ub, dtype=torch.float32, device=queries.device).contiguous())
    if strategy == "scan":
        out = _scan_cascade(series, leaf_start, leaf_size, queries, d_lb,
                            d_F, k, max_leaf, ub, trace, audit)
        n_c = torch.full((queries.shape[0],), leaf_start.shape[0],
                         dtype=torch.int32, device=queries.device)
        out = out[:5] + (n_c,) + out[5:]
    elif strategy == "compact":
        dist_impl = dist_impl or l2_ops.default_gathered_impl(queries.device)
        out = _compact_cascade(series, leaf_start, leaf_size, queries, d_lb,
                               d_F, k, max_leaf, dist_impl, ub, trace, audit)
    else:
        raise ValueError(f"unknown engine strategy {strategy!r}")
    rest = list(out[6:])
    aux = rest.pop(0) if trace else None
    fa = (obs_audit.reduce_parts(rest.pop(0), d_F, leaf_size) if audit
          else None)
    return EngineResult(*out[:6], aux, fa)


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


# ---------------------------------------------------------------------------
# survivor capacity (numpy only): the serving telemetry's suggestion
# ---------------------------------------------------------------------------


def default_max_survivors(n_leaves: int) -> int:
    """Default fixed survivor capacity of a fixed-width compaction: an
    eighth of the leaf slots, rounded up to a power of two, clamped to
    ``next_pow2(n_leaves)``.  :func:`tuned_max_survivors` replaces this
    static guess with a percentile of observed survivor counts."""
    return min(next_pow2(max(n_leaves // 8, 1)), next_pow2(n_leaves))


def tuned_max_survivors(survivor_counts, n_leaves: int,
                        pct: float = 99.0, min_samples: int = 0) -> int:
    """Survivor capacity from observed per-query survivor counts.

    The ``pct``-th percentile of the counts, rounded up to a power of two
    (the rounding is the drift headroom), clamped to [1,
    next_pow2(n_leaves)]; with no observations, :func:`default_max_survivors`.
    Below ``min_samples`` observations the percentile means little, so the
    estimate is floored at the static default: a few easy early queries
    may raise the capacity, never lower it.
    """
    counts = np.asarray(survivor_counts)
    if counts.size == 0:
        return default_max_survivors(n_leaves)
    cap = int(np.ceil(np.percentile(counts, pct)))
    cap = min(next_pow2(max(cap, 1)), next_pow2(n_leaves))
    if counts.size < max(int(min_samples), 0):
        cap = max(cap, default_max_survivors(n_leaves))
    return cap
