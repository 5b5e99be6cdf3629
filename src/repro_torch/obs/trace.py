"""Per-query cascade accounting: the ``CascadeTrace`` record (port of
``repro.obs.trace``).

The engine's counters answer the paper's searched-leaf accounting.
``CascadeTrace`` answers which bound saved which compute, per query:

* ``strategy="scan"`` — the cascade's own test at each position decides.
  A leaf is ``pruned_box`` when its lower bound exceeds the witnessed bsf,
  ``pruned_seed`` when only the prune-only bound ``bsf_ub`` excluded it
  (``lb ≤ bsf`` but ``lb > min(bsf, ub)``), ``pruned_filter`` when the
  adjusted prediction ``d_F`` exceeded the bsf.  ``probed == 0`` and
  ``survivors == n_searched``.
* ``strategy="compact"`` — the survivor mask decides which leaves are
  ever scored.  ``pruned_box``: ``d_lb > bsf0`` (the probe's bsf);
  ``pruned_seed``: ``bsf0 ≥ d_lb > min(bsf0, bsf_ub)``; ``pruned_filter``:
  the rest (``d_F > bsf0``).  The probe leaf counts in ``probed`` (1 a
  query), not in ``survivors``.

The accounting identity, per query, for both strategies::

    pruned_box + pruned_seed + pruned_filter == n_leaves − survivors − probed

``distances`` counts the exact distance rows the engine paid for a query:
the probe's rows and every scored candidate row on the compact strategy
(under ``dist_impl="pairwise"`` the rows of the bucket's whole union),
the rows of every searched leaf on the scan strategy.

``replay_cascade(trace=True)`` gives the replay-stage box/seed split of
its own ``n_pruned_lb`` counter; it is not folded into the trace, since
the replay runs over summaries already scored.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class CascadeTrace(NamedTuple):
    """Per-query cascade accounting, every field a (Q,) int32 tensor."""

    pruned_box: torch.Tensor      # leaves excluded by the box lower bound
    pruned_seed: torch.Tensor     # leaves excluded only by the bsf_ub bound
    pruned_filter: torch.Tensor   # leaves excluded by the learned filter
    probed: torch.Tensor          # probe passes paid
    survivors: torch.Tensor       # leaves entering the candidate pass
    overflow: torch.Tensor        # 1 ⇒ capacity overflow (distributed form)
    distances: torch.Tensor       # exact distance rows computed


def zero_trace(n_queries: int, device=None) -> CascadeTrace:
    """All-zero trace for ``n_queries`` queries."""
    z = torch.zeros((n_queries,), dtype=torch.int32, device=device)
    return CascadeTrace(*(z,) * len(CascadeTrace._fields))


def combine(a: CascadeTrace, b: CascadeTrace) -> CascadeTrace:
    """Field-wise sum: merge the traces of two batches or shards."""
    return CascadeTrace(*(x + y for x, y in zip(a, b)))


def select(cond, a: CascadeTrace, b: CascadeTrace) -> CascadeTrace:
    """Per-query ``where(cond, a, b)`` across every field."""
    c = torch.as_tensor(cond, device=a.pruned_box.device)
    return CascadeTrace(*(torch.where(c, x, y) for x, y in zip(a, b)))


def to_numpy(trace: CascadeTrace) -> dict:
    """Host-side dict of int64 numpy arrays (field name → (Q,))."""
    return {name: np.asarray(torch.as_tensor(val).cpu(), dtype=np.int64)
            for name, val in zip(trace._fields, trace)}


def accounting_residual(trace: CascadeTrace, n_leaves: int) -> torch.Tensor:
    """``n_leaves − survivors − probed − Σ pruned_*``: zero per query when
    the attribution partitions the leaves exactly."""
    pruned = trace.pruned_box + trace.pruned_seed + trace.pruned_filter
    return (n_leaves - trace.survivors - trace.probed - pruned).to(
        torch.int32)
