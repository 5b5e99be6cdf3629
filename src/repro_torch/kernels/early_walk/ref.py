"""Plain PyTorch versions of the single-query early-termination walk.

``early_walk`` is the function the early-walk CUDA kernel computes: the
reference's jitted ``_search_early_core`` (``src/repro/core/search.py:327``)
as a Python loop over the visit order, one leaf at a time.
``search.search_early`` runs it for CPU tensors, and ``chip_smoke.py``
holds the kernel against it, bitwise, on the card: the top-k values and
ids and all three counters.

``row_distances`` is the kernel's distance of a row to the query, summed
in the kernel's fixed order, so the plain walk and the kernel agree bit for
bit.

``walk_emulated`` is the same walk as the kernel computes it: scorers
claim (leaf, row range) items in visit order, pre-test them against a bsf
that lags the walk, and write each kept item's k smallest values into a
ring of fixed capacity that fills and wraps; a walker takes up to
:data:`BATCH` leaves at a time, re-tests them against its own bsf and
merges only the leaves that can enter the top-k.  The tests hold it bitwise
against :func:`early_walk`; no path runs it.

``bound_bytes`` is the least a call must move on its data.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..replay.ref import merge_topk

_INF = float("inf")

#: lanes of a warp, and the consecutive elements of a row a lane takes at a
#: time (one 16-byte load): element j of a row is summed by lane
#: (j // VEC) % LANES
LANES, VEC = 32, 4
SPAN = LANES * VEC
#: ring slots (``RING`` in csrc/early_walk.cu): items the scorers may run
#: ahead of the walker, RING // items_per_leaf leaves
RING = 2048
#: leaves the walker takes at a time (one per lane)
BATCH = 32
#: a leaf's rows an item covers, while a leaf takes at most MAX_ITEMS
ITEM_ROWS, MAX_ITEMS = 64, 32


def items_per_leaf(max_leaf: int) -> tuple:
    """(rows an item covers, items a leaf) for leaves of at most
    ``max_leaf`` rows: ITEM_ROWS rows an item and a power of two of items
    up to 32 (so the ring's RING items hold whole leaves); beyond, 32 items
    of ceil(max_leaf / 32) rows.  A leaf's last item also takes
    any rows past the others (a leaf larger than ``max_leaf``)."""
    per = -(-max(int(max_leaf), 1) // ITEM_ROWS)
    if per <= MAX_ITEMS:
        return ITEM_ROWS, 1 << (per - 1).bit_length()
    return -(-int(max_leaf) // MAX_ITEMS), MAX_ITEMS


def row_distances(rows: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """sqrt(Σ(s − q)²) of each row of ``rows`` (..., m) to ``q`` (m,), in
    the kernel's order: each difference and square rounded on its own (no
    fused multiply-add); lane l of 32 sums, one after another, the squares
    of the elements j with (j // 4) % 32 == l in increasing j; the 32 lane
    sums are then added by halving (lane i + lane i + 16, then + 8, + 4,
    + 2, + 1); the square root is rounded once."""
    m = q.shape[-1]
    diff = rows - q
    sq = diff * diff
    chunks = -(-m // SPAN)
    sq = torch.nn.functional.pad(sq, (0, chunks * SPAN - m))
    sq = sq.reshape(*rows.shape[:-1], chunks, LANES, VEC)
    acc = torch.zeros(rows.shape[:-1] + (LANES,), dtype=rows.dtype,
                      device=rows.device)
    for c in range(chunks):
        for e in range(VEC):
            acc = acc + sq[..., c, :, e]       # + 0.0 past m: exact
    while acc.shape[-1] > 1:
        h = acc.shape[-1] // 2
        acc = acc[..., :h] + acc[..., h:]
    return torch.sqrt(acc[..., 0])


def _counts(dev, *values):
    return tuple(torch.tensor(v, dtype=torch.int32, device=dev)
                 for v in values)


def early_walk(series: torch.Tensor, leaf_start: torch.Tensor,
               leaf_size: torch.Tensor, q: torch.Tensor, d_lb: torch.Tensor,
               d_F: torch.Tensor, order: torch.Tensor, k: int,
               stats: Optional[dict] = None):
    """The single-query walk: series (N, m) float32 leaf-sorted, leaf_start
    and leaf_size (L,) int64, q (m,), d_lb and d_F (L,) float32, order (L,)
    int64, the visit order.  With bsf the running top-k's k-th value: stop
    at the first position whose bound is not <= bsf; a position with d_F >
    bsf is filter-pruned; otherwise the leaf's rows' distances
    (:func:`row_distances`) merge into the top-k (a stable sort of the
    running top-k and the rows, ties to the running top-k, then the lower
    row).  Returns (topk_d (k,) float32, topk_i (k,) int64 sorted-row ids,
    -1 where empty, n_searched, n_visited, n_pruned_filter), the counters
    0-d int32; pruned by the bound = L − n_visited.  ``stats``, where
    given, gets the searched leaves (``"searched"``) in visit order."""
    dev = series.device
    L = order.shape[0]
    lbs, fs, o = d_lb.tolist(), d_F.tolist(), order.tolist()
    starts, sizes = leaf_start.tolist(), leaf_size.tolist()
    topk_d = torch.full((1, k), _INF, device=dev)
    topk_i = torch.full((1, k), -1, dtype=torch.int64, device=dev)
    bsf = _INF
    n_s = n_pf = p = 0
    searched = []
    while p < L and lbs[o[p]] <= bsf:
        leaf = o[p]
        if fs[leaf] > bsf:
            n_pf += 1
        else:
            n_s += 1
            searched.append(leaf)
            start, size = starts[leaf], sizes[leaf]
            if size > 0:
                d = row_distances(series[start:start + size], q)
                topk_d, topk_i = merge_topk(
                    topk_d, topk_i, d[None],
                    torch.arange(start, start + size, device=dev)[None], k)
                bsf = topk_d[0, -1].item()
        p += 1
    if stats is not None:
        stats["searched"] = searched
    return (topk_d[0], topk_i[0]) + _counts(dev, n_s, p, n_pf)


class _Walker:
    """The kernel's walker warp: the running top-k (ascending; an entry
    goes after every entry <= it and pushes out the last) and its counts."""

    def __init__(self, k: int):
        self.td, self.ti = [_INF] * k, [-1] * k
        self.n_s = self.n_pf = 0

    @property
    def bsf(self) -> float:
        return self.td[-1]

    def merge(self, summary) -> None:
        """An item's values and ids, ascending, each entering while it lies
        below the bsf."""
        for v, i in summary:
            if not v < self.td[-1]:
                return
            pos = sum(d <= v for d in self.td)
            self.td.insert(pos, v)
            self.ti.insert(pos, i)
            self.td.pop()
            self.ti.pop()

    def step(self, leaves: list) -> tuple:
        """The kernel's step over ``leaves`` (each (lb, f, least value of
        its kept items, their summaries in row order), one a lane): the
        candidates at the step's bsf whose least value lies below it are
        merged one by one, item by item, each leaf decided from the bsf
        just before it; returns (leaves taken, stopped)."""
        nr = len(leaves)
        bsf0 = self.bsf
        go = [j for j, (lb, f, vmin, _) in enumerate(leaves)
              if lb <= bsf0 and not f > bsf0 and vmin < bsf0]
        seen = [bsf0] * nr                # the bsf just before each leaf
        last, stop_at = -1, nr
        for j in go + [nr]:
            hi = min(j, nr - 1)
            stops = [i for i in range(last + 1, hi + 1)
                     if not leaves[i][0] <= seen[i]]
            if stops:
                stop_at = stops[0]
                break
            if j >= nr:
                break
            if not leaves[j][1] > self.bsf:
                for summary in leaves[j][3]:
                    self.merge(summary)
            seen[j + 1:] = [self.bsf] * (nr - j - 1)
            last = j
        for i in range(stop_at):
            if leaves[i][1] > seen[i]:
                self.n_pf += 1
            else:
                self.n_s += 1
        return stop_at, stop_at < nr


def walk_emulated(series: torch.Tensor, leaf_start: torch.Tensor,
                  leaf_size: torch.Tensor, q: torch.Tensor,
                  d_lb: torch.Tensor, d_F: torch.Tensor, order: torch.Tensor,
                  k: int, *, max_leaf: int, lag: int = 0, ring: int = RING,
                  stats: Optional[dict] = None):
    """:func:`early_walk` as the kernel computes it.

    A leaf is ``per`` items of ``rows`` rows (:func:`items_per_leaf`), item
    t = leaf position t // per, rows (t % per) · rows onward; the ring holds
    ``ring`` items, ``ring // per`` leaves.  Scorers claim items in order
    while the ring has room for their leaf and read the bsf the walker
    published ``lag`` steps ago: an item whose bound is not <= it ends the
    walk for certain (no later leaf is claimed), one whose prediction
    exceeds it is never searched; any other item's rows are scored and its
    values below that bsf kept, its k smallest (ties to the lower row) with
    their least; then the item is tested again at the bsf published ``lag``
    − 1 steps ago and dropped (no values) where that decides it.  Each step
    the walker takes up to BATCH leaves whose items are all written
    (:meth:`_Walker.step`) and publishes its bsf.  ``stats``, where given,
    gets the items scored (``"scored"``) and the ring's wraps
    (``"wraps"``)."""
    rows, per = items_per_leaf(max_leaf)
    if ring < per or ring % per:
        raise ValueError(f"a ring of {ring} items cannot hold leaves of "
                         f"{per}")
    leaf_slots = ring // per
    L = order.shape[0]
    items = L * per
    lbs, fs, o = d_lb.tolist(), d_F.tolist(), order.tolist()
    starts, sizes = leaf_start.tolist(), leaf_size.tolist()
    walker = _Walker(k)
    published = [_INF]
    slots = [(-1, 0.0, 0.0, -_INF, [])] * ring    # stale until written
    head = nxt = scored = 0                       # head: leaves walked
    limit = L
    stopped = False

    def stale(back: int) -> float:
        return published[max(len(published) - 1 - back, 0)]

    while not stopped and head < L:
        while (nxt < items and nxt // per - head < leaf_slots
               and nxt // per <= limit):
            t = nxt
            nxt += 1
            p, c = divmod(t, per)
            leaf = o[p]
            lb, f = lbs[leaf], fs[leaf]
            cap = stale(lag)
            stop = not lb <= cap
            keep = not stop and not f > cap
            summary = []
            if keep:
                start, size = starts[leaf], sizes[leaf]
                r0 = min(c * rows, size)
                r1 = size if c == per - 1 else min(size, r0 + rows)
                if r1 > r0:
                    scored += 1
                    d = row_distances(series[start + r0:start + r1],
                                      q).tolist()
                    summary = sorted(((v, start + r0 + r)
                                      for r, v in enumerate(d) if v < cap),
                                     key=lambda e: e[0])[:k]
                fresh = stale(max(lag - 1, 0))
                if not lb <= fresh or f > fresh:
                    stop, keep = not lb <= fresh, False
            if stop:
                limit = min(limit, p)
            vmin = summary[0][0] if keep and summary else _INF
            slots[t % ring] = (t, lb, f, vmin, summary if keep else [])
        leaves = []
        while len(leaves) < min(BATCH, L - head):
            p = head + len(leaves)
            its = [slots[(p * per + c) % ring] for c in range(per)]
            if any(it[0] != p * per + c for c, it in enumerate(its)):
                break
            leaves.append((its[0][1], its[0][2], min(it[3] for it in its),
                           [it[4] for it in its]))
        if not leaves:
            raise AssertionError("the walker waits on a leaf no scorer "
                                 "will finish")
        taken, stopped = walker.step(leaves)
        head += taken
        published.append(walker.bsf)
    if stats is not None:
        stats["scored"] = scored
        stats["wraps"] = nxt // ring
    dev = series.device
    return (torch.tensor(walker.td, dtype=torch.float32, device=dev),
            torch.tensor(walker.ti, dtype=torch.int64, device=dev)) + \
        _counts(dev, walker.n_s, head, walker.n_pf)


def bound_bytes(leaf_size: torch.Tensor, searched, n_visited: int, m: int,
                k: int) -> int:
    """The least bytes a walk must move on its data: the order entry and
    bound (8 + 4) of each visited position and of the one that ends the
    walk, the prediction (4) of each visited position, the rows (m · 4
    bytes each) of every searched leaf (``searched``: the leaves, as
    :func:`early_walk`'s ``stats`` gives them), the query, and the outputs
    (the top-k's values and ids, three counters)."""
    L = leaf_size.shape[0]
    idx = torch.as_tensor(list(searched), dtype=torch.int64,
                          device=leaf_size.device)
    rows = int(leaf_size[idx].sum()) if idx.numel() else 0
    return (12 * min(int(n_visited) + 1, L) + 4 * int(n_visited)
            + 4 * m * rows + 4 * m + 12 * k + 12)
