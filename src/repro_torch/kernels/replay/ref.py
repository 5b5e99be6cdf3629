"""Plain PyTorch versions of the cascade replay.

``replay_cascade`` is the function the replay CUDA kernel computes: the
engine runs it for CPU tensors and ``chip_smoke.py`` holds the kernel
against it, bitwise, on the card.  It is the sequential cascade as a Python
loop over the L visit positions, vectorised over the rows (the reference's
``lax.scan`` inside a ``vmap``).

``replay_chunked`` is the same function walked as the kernel walks it (one
row at a time, :data:`CHUNK` positions at once): a lane-parallel pre-test
against the bsf at the chunk's start, the candidates walked one by one with
their leaf values inserted into the running top-k, and every other position
classified from the bsf just before it.  The tests hold it bitwise against
the loop; no path runs it.
"""
from __future__ import annotations

from typing import Tuple

import torch

_INF = float("inf")

#: positions the kernel pre-tests at once (one per lane of a warp)
CHUNK = 32


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


def _insert(td: torch.Tensor, ti: torch.Tensor, v: torch.Tensor,
            i: torch.Tensor) -> None:
    """Insert v (< td[-1]) after every running entry ≤ v, dropping the
    last: the stable merge's order, one leaf slot at a time."""
    pos = int((td <= v).sum())
    td[pos + 1:] = td[pos:-1].clone()
    ti[pos + 1:] = ti[pos:-1].clone()
    td[pos], ti[pos] = v, i


def replay_chunked(leaf_d: torch.Tensor, leaf_i: torch.Tensor,
                   d_lb: torch.Tensor, d_F: torch.Tensor,
                   order: torch.Tensor, k: int, chunk: int = CHUNK):
    """:func:`replay_cascade` as the kernel computes it.

    bsf never rises, so a position pruned at the chunk's starting bsf0
    stays pruned whatever happens before it in the chunk: only the others
    (d_lb ≤ bsf0 and d_F ≤ bsf0, the candidates) are walked, in order,
    each tested against the current bsf; a searched leaf's slots enter the
    top-k one by one while they lie below the bsf (a NaN or +inf slot never
    does).  Then every position of the chunk is classified from the bsf
    just before it (the bsf after the chunk's last candidate before it):
    lb-pruned if d_lb exceeds it, else filter-pruned if d_F does."""
    Q, L, kk = leaf_d.shape
    topk_d, topk_i = init_topk(Q, k, leaf_d.device)
    n_plb = torch.zeros(Q, dtype=torch.int32)
    n_pf = torch.zeros(Q, dtype=torch.int32)
    for r in range(Q):
        td, ti = topk_d[r], topk_i[r]
        for p0 in range(0, L, chunk):
            o = order[r, p0:p0 + chunk]
            lb, f = d_lb[r, o], d_F[r, o]
            bsf0 = td[-1].clone()
            cand = ~(lb > bsf0) & ~(f > bsf0)
            seen = bsf0.expand(o.shape[0]).clone()   # bsf before each slot
            for j in torch.nonzero(cand).flatten().tolist():
                if not lb[j] > td[-1] and not f[j] > td[-1]:
                    for s in range(kk):
                        v = leaf_d[r, o[j], s]
                        if v < td[-1]:
                            _insert(td, ti, v, leaf_i[r, o[j], s])
                seen[j + 1:] = td[-1]
            p_lb = lb > seen
            n_plb[r] += int(p_lb.sum())
            n_pf[r] += int((~p_lb & (f > seen)).sum())
    return topk_d, topk_i, L - n_plb - n_pf, n_plb, n_pf
