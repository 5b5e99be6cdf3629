"""Plain PyTorch versions of the cascade replay.

``replay_cascade`` is the function the replay CUDA kernel computes: the
engine runs it for CPU tensors and ``chip_smoke.py`` holds the kernel
against it, bitwise, on the card.  It is the sequential cascade as a Python
loop over the L visit positions, vectorised over the rows (the reference's
``lax.scan`` inside a ``vmap``).

``replay_chunked`` is the same function walked as the kernel walks it:
producers pre-test each chunk of positions against a bsf that lags the
walk, drop the positions whose bound exceeds it, and write the others in
visit order into a ring of fixed capacity that fills and wraps; a walker
takes up to :data:`CHUNK` entries at a time, re-tests them against its own
bsf and merges, one by one, only the leaves that can enter the top-k.  The
tests hold it bitwise against the loop; no path runs it.

``chain_lengths`` counts, per row, what sets the kernel's time: the ring
entries no bsf can drop and the leaves that enter the top-k;
``bound_bytes`` is the least the replay must move on a call's data.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

_INF = float("inf")

#: positions a producer warp pre-tests at once and entries the walker takes
#: at once (one per lane of a warp)
CHUNK = 32
#: ring entries a row (``RING`` in csrc/replay.cu)
RING = 256
#: leaf slots a ring entry carries (``PRE``): for a larger kk the walk reads
#: a searched leaf's slots from the leaf summaries instead
PRE = 8


def init_topk(Q: int, k: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    return (torch.full((Q, k), _INF, device=device),
            torch.full((Q, k), -1, dtype=torch.int64, device=device))


def merge_topk(topk_d, topk_i, vals, ids, k):
    """k smallest of (running top-k ∪ new candidates), ties toward the
    running top-k and then the lower position (``lax.top_k``'s order)."""
    alld = torch.cat([topk_d, vals], dim=1)
    alli = torch.cat([topk_i, ids], dim=1)
    srt, arg = torch.sort(alld, dim=1, stable=True)
    return srt[:, :k], torch.gather(alli, 1, arg[:, :k])


def counted(topk_d, topk_i, plb_hist, pf_hist):
    n_plb = plb_hist.sum(dim=0, dtype=torch.int32)
    n_pf = pf_hist.sum(dim=0, dtype=torch.int32)
    n_s = plb_hist.shape[0] - n_plb - n_pf          # the two are disjoint
    return topk_d, topk_i, n_s, n_plb, n_pf


def replay_cascade(leaf_d: torch.Tensor, leaf_i: torch.Tensor,
                   d_lb: torch.Tensor, d_F: torch.Tensor,
                   order: torch.Tensor, k: int):
    """Exact sequential-cascade replay over per-leaf top-k summaries.

    leaf_d/leaf_i: (Q, L, kk) each leaf's kk distances and row ids; d_lb,
    d_F: (Q, L); order: (Q, L) visit order.  At each position, with bsf the
    running k-th distance: lb-pruned if d_lb > bsf, else filter-pruned if
    d_F > bsf, else the leaf's values merge into the running top-k.
    Returns (topk_d (Q, k), topk_i (Q, k), n_searched, n_pruned_lb,
    n_pruned_filter)."""
    Q, L, kk = leaf_d.shape
    dev = leaf_d.device
    lb_ord = torch.gather(d_lb, 1, order)
    dF_ord = torch.gather(d_F, 1, order)
    idx = order[:, :, None].expand(Q, L, kk)
    ld_ord = torch.gather(leaf_d, 1, idx)
    li_ord = torch.gather(leaf_i, 1, idx)
    topk_d, topk_i = init_topk(Q, k, dev)
    plb_hist = torch.zeros((L, Q), dtype=torch.bool, device=dev)
    pf_hist = torch.zeros((L, Q), dtype=torch.bool, device=dev)
    for p in range(L):
        bsf = topk_d[:, -1]
        p_lb = lb_ord[:, p] > bsf
        p_f = ~p_lb & (dF_ord[:, p] > bsf)
        vals = torch.where((p_lb | p_f)[:, None], _INF, ld_ord[:, p])
        topk_d, topk_i = merge_topk(topk_d, topk_i, vals, li_ord[:, p], k)
        plb_hist[p] = p_lb
        pf_hist[p] = p_f
    return counted(topk_d, topk_i, plb_hist, pf_hist)


def _leaf_min(vals: torch.Tensor) -> torch.Tensor:
    """The least of each leaf's values over its last axis, NaN ignored
    (``fminf``'s rule); +inf for a leaf of only NaN or no values."""
    vals = torch.where(torch.isnan(vals), _INF, vals)
    if vals.shape[-1] == 0:
        return torch.full(vals.shape[:-1], _INF, dtype=vals.dtype,
                          device=vals.device)
    return vals.amin(dim=-1)


def chain_lengths(leaf_d: torch.Tensor, d_lb: torch.Tensor,
                  d_F: torch.Tensor, order: torch.Tensor, k: int):
    """Per row, (the ring entries no bsf can drop, the leaves whose values
    enter the top-k, the searched leaves), each int32 (Q,): the positions
    not lb-pruned by the bsf just before them (n_s + n_pf), the searched
    positions with a value below it, and n_s.  The kernel's ring takes at
    least the first (stale pre-tests keep more), and its walker merges at
    least the second one by one: the serial chain that sets the time of a
    row."""
    Q, L, kk = leaf_d.shape
    lb_ord = torch.gather(d_lb, 1, order)
    dF_ord = torch.gather(d_F, 1, order)
    ld_ord = torch.gather(leaf_d, 1, order[:, :, None].expand(Q, L, kk))
    vmin = _leaf_min(ld_ord)
    topk_d, _ = init_topk(Q, k, leaf_d.device)
    entries = torch.zeros(Q, dtype=torch.int32, device=leaf_d.device)
    entering = torch.zeros_like(entries)
    searched_n = torch.zeros_like(entries)
    for p in range(L):
        bsf = topk_d[:, -1]
        p_lb = lb_ord[:, p] > bsf
        searched = ~p_lb & ~(dF_ord[:, p] > bsf)
        entries += ~p_lb
        searched_n += searched
        entering += searched & (vmin[:, p] < bsf)
        vals = torch.where(searched[:, None], ld_ord[:, p], _INF)
        topk_d = torch.sort(torch.cat([topk_d, vals], dim=1),
                            dim=1).values[:, :k]
    return entries, entering, searched_n


def bound_bytes(leaf_d: torch.Tensor, d_lb: torch.Tensor,
                d_F: torch.Tensor, order: torch.Tensor, k: int) -> int:
    """The least bytes a replay call must move on its data: every
    position's order entry and bound (8 + 4), the prediction of each
    position its bound does not prune (4), each searched leaf's kk values
    (4 each) and each entering leaf's kk ids (8 each), and the outputs (the
    top-k's values and ids, three counters a row)."""
    Q, L, kk = leaf_d.shape
    entries, entering, searched = chain_lengths(leaf_d, d_lb, d_F, order, k)
    return (12 * Q * L + 4 * int(entries.sum()) + 4 * kk * int(searched.sum())
            + 8 * kk * int(entering.sum()) + Q * (12 * k + 12))


class _Row:
    """One row of the kernel's walk: the walker's top-k and counts, the
    ring (a slot keeps what an older entry left in it until a newer entry
    overwrites it; the leaf slots are written only for leaves that may
    enter the top-k, so a walk that read another's would merge the stale
    values planted here), and the bsf the producers see."""

    def __init__(self, k: int, kk: int, chunk: int, capacity: int):
        self.td, self.ti = [_INF] * k, [-1] * k
        self.kk, self.chunk, self.cap = kk, chunk, capacity
        slots = [(-_INF, -2)] * kk
        self.ring = [(0.0, 0.0, 0.0, 0, slots)] * capacity
        self.head = self.tail = 0
        self.plb = self.pf = self.walked = 0
        self.published = _INF

    def merge(self, slots) -> None:
        """A searched leaf's slots, in slot order, each entering while it
        lies below the bsf (after every entry <= it, dropping the last)."""
        for v, i in slots:
            if v < self.td[-1]:
                pos = sum(d <= v for d in self.td)
                self.td.insert(pos, v)
                self.ti.insert(pos, i)
                self.td.pop()
                self.ti.pop()

    def step(self, leaves) -> None:
        """The walker takes up to ``chunk`` entries: each is a candidate if
        neither its bound nor its prediction exceeds the bsf at the step's
        start; of the candidates, those with a value below that bsf are
        walked one by one, each re-tested against the current bsf; then
        every entry is classified from the bsf just before it."""
        n = min(self.tail - self.head, self.chunk)
        ents = [self.ring[(self.head + x) % self.cap] for x in range(n)]
        bsf0 = self.td[-1]
        seen = [bsf0] * n
        for j, (lb, f, vmin, o, slots) in enumerate(ents):
            if lb > bsf0 or f > bsf0 or not vmin < bsf0:
                continue
            if not lb > self.td[-1] and not f > self.td[-1]:
                self.walked += 1
                self.merge(slots[:self.kk] if self.kk <= PRE
                           else leaves[o])
            seen[j + 1:] = [self.td[-1]] * (n - j - 1)
        for (lb, f, _, _, _), b in zip(ents, seen):
            self.plb += lb > b
            self.pf += not lb > b and f > b
        self.head += n
        self.published = self.td[-1]

    def commit(self, entries: list, leaves) -> None:
        """A chunk's kept entries, in visit order; the walker takes steps
        while the ring has no room for them."""
        while self.tail + len(entries) - self.head > self.cap:
            self.step(leaves)
        for entry in entries:
            e = self.tail % self.cap
            if entry[4] is None:                      # slots not loaded
                entry = entry[:4] + (self.ring[e][4],)
            self.ring[e] = entry
            self.tail += 1


def replay_chunked(leaf_d: torch.Tensor, leaf_i: torch.Tensor,
                   d_lb: torch.Tensor, d_F: torch.Tensor,
                   order: torch.Tensor, k: int, chunk: int = CHUNK,
                   lag: int = 0, capacity: int = RING,
                   stats: Optional[dict] = None):
    """:func:`replay_cascade` as the kernel computes it.

    The producers take the row ``chunk`` positions at a time, in visit
    order.  Before chunk c the walker has taken every entry of the chunks
    up to c − 1 − ``lag`` (and may be further on): the bsf it last
    published, bsf_stale, lags the walk by ``lag`` chunks.  bsf never
    rises, so a position whose bound exceeds bsf_stale is lb-pruned for
    certain: it is counted and dropped.  Every other position enters the
    ring (``capacity`` entries; the walker steps when it is full) with its
    bound, its prediction and, for kk <= :data:`PRE`, its leaf's least value
    (NaN ignored; +inf where the prediction exceeds bsf_stale, which the
    walker's bsf never undercuts) and, where that lies below bsf_stale,
    its slots.  For a larger kk a candidate's least value is −inf and a
    searched leaf's slots are read from ``leaf_d``.  The walker's steps are
    :meth:`_Row.step`.  ``stats``, where given, gets per row the ring's
    entries (``"entries"``) and the leaves the walker merged (``"walked"``).
    """
    if capacity < chunk:
        raise ValueError(f"a ring of {capacity} entries cannot take a "
                         f"chunk of {chunk}")
    Q, L, kk = leaf_d.shape
    topk_d, topk_i = init_topk(Q, k, leaf_d.device)
    n_plb = torch.zeros(Q, dtype=torch.int32)
    n_pf = torch.zeros(Q, dtype=torch.int32)
    for r in range(Q):
        vals, ids = leaf_d[r].tolist(), leaf_i[r].tolist()
        leaves = [list(zip(v, i)) for v, i in zip(vals, ids)]
        lbs, fs = d_lb[r].tolist(), d_F[r].tolist()
        row = _Row(k, kk, chunk, capacity)
        ends, dropped = [], 0
        for c, p0 in enumerate(range(0, L, chunk)):
            if c - 1 - lag >= 0:
                while row.head < ends[c - 1 - lag]:
                    row.step(leaves)
            stale = row.published
            entries = []
            for o in order[r, p0:p0 + chunk].tolist():
                lb, f = lbs[o], fs[o]
                if lb > stale:
                    dropped += 1
                    continue
                cand = not f > stale
                if kk > PRE:
                    entries.append((lb, f, -_INF if cand else _INF, o, None))
                    continue
                vmin = min((v for v in vals[o] if v == v), default=_INF)
                if not cand:
                    vmin = _INF
                entries.append((lb, f, vmin, o,
                                leaves[o] if vmin < stale else None))
            row.commit(entries, leaves)
            ends.append(row.tail)
        while row.head < row.tail:
            row.step(leaves)
        topk_d[r] = torch.tensor(row.td, dtype=topk_d.dtype)
        topk_i[r] = torch.tensor(row.ti, dtype=topk_i.dtype)
        n_plb[r] = row.plb + dropped
        n_pf[r] = row.pf
        if stats is not None:
            stats.setdefault("entries", []).append(row.tail)
            stats.setdefault("walked", []).append(row.walked)
    return topk_d, topk_i, L - n_plb - n_pf, n_plb, n_pf
