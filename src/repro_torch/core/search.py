"""LeaFi-enhanced batched search, paper Alg. 2 (port of the batched half of
``repro.core.search``).

Lower bounds and filter predictions for all leaves are computed up front
(neither depends on the best-so-far), then the pruning cascade runs through
:mod:`repro_torch.core.engine`.  ``quality_target=None`` (or
``use_filters=False``) disables the filters and the search is exact.
``search_early`` and ``search_batched_grouped`` are ROADMAP queue A.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from . import bounds as bounds_mod
from . import conformal, engine, filters
from .flat_index import FlatIndex
from ..kernels.common import Device, resolve_device

_INF = float("inf")


@dataclasses.dataclass
class SearchResult:
    dists: np.ndarray            # (Q, k)
    ids: np.ndarray              # (Q, k) original series ids
    searched: np.ndarray         # (Q,) leaves actually scanned
    pruned_lb: np.ndarray        # (Q,) leaves pruned by summarization LB
    pruned_filter: np.ndarray    # (Q,) leaves pruned by learned filters
    n_leaves: int
    # leaves the engine paid distance compute for (== n_leaves on the scan
    # strategy; the survivor superset, or the bucket's survivor union under
    # dist_impl="pairwise", on the compact strategy)
    computed: Optional[np.ndarray] = None

    @property
    def pruning_ratio(self) -> np.ndarray:
        return 1.0 - self.searched / self.n_leaves


@dataclasses.dataclass
class PendingSearch:
    """A dispatched batched search whose device work may still be running.

    ``done`` is a CUDA event recorded after the engine's last launch (None
    on the CPU); :meth:`result` waits on it and copies to the host.
    """
    raw: engine.EngineResult
    order: np.ndarray
    n_series: int
    n_leaves: int
    done: Optional[torch.cuda.Event] = None

    def synchronize(self) -> "PendingSearch":
        if self.done is not None:
            self.done.synchronize()
        return self

    def result(self) -> SearchResult:
        """Materialize to a :class:`SearchResult` (waits for the device)."""
        self.synchronize()
        r = self.raw
        ids_sorted = r.topk_i.cpu().numpy()
        orig = np.where(ids_sorted >= 0, self.order[
            np.clip(ids_sorted, 0, self.n_series - 1)], -1)
        return SearchResult(
            dists=r.topk_d.cpu().numpy(), ids=orig,
            searched=r.n_searched.cpu().numpy(),
            pruned_lb=r.n_pruned_lb.cpu().numpy(),
            pruned_filter=r.n_pruned_filter.cpu().numpy(),
            n_leaves=self.n_leaves, computed=r.n_computed.cpu().numpy())


def predictions_for_all_leaves(index: FlatIndex,
                               filter_params: Optional[Dict[str,
                                                            torch.Tensor]],
                               leaf_ids: np.ndarray, queries: torch.Tensor,
                               offsets: Optional[np.ndarray]) -> torch.Tensor:
    """(Q, L) conformal-adjusted filter lower bounds; −inf ⇒ never prunes.

    ``offsets`` is one (F,) vector shared by the batch, which goes into the
    fused kernel's epilogue, or (Q, F) per-query rows, subtracted from the
    kernel's unadjusted output.
    """
    L = index.n_leaves
    Q = queries.shape[0]
    dev = queries.device
    if filter_params is None or len(leaf_ids) == 0:
        return torch.full((Q, L), -_INF, device=dev)
    off = (None if offsets is None
           else torch.as_tensor(np.asarray(offsets, np.float32), device=dev))
    if off is None or off.dim() == 1:
        preds = filters.apply_mlp_offset(filter_params, queries, off)  # (F, Q)
    else:
        preds = filters.apply_mlp_offset(filter_params, queries) - off.T
    full = torch.full((L, Q), -_INF, device=dev)
    full[torch.as_tensor(np.asarray(leaf_ids), device=dev)] = preds
    return full.T


def search_batched_async(index: FlatIndex, queries, *, k: int = 1,
                         filter_params=None,
                         leaf_ids: Optional[np.ndarray] = None,
                         tuner: Optional[conformal.AutoTuner] = None,
                         quality_target=None, use_filters: bool = True,
                         strategy: str = "auto",
                         dist_impl: Optional[str] = None,
                         device: Device = None) -> PendingSearch:
    """Dispatch a batched LeaFi search; same arguments as
    :func:`search_batched`.  The compact strategy syncs the host once for
    its survivor buckets; the rest is enqueued and ``.result()`` waits."""
    dev = resolve_device(device)
    if index.device != dev:
        raise ValueError(f"the index lives on {index.device}, the search "
                         f"was asked to run on {dev}")
    q = torch.atleast_2d(torch.as_tensor(np.asarray(queries, np.float32),
                                         device=dev))
    if quality_target is not None:
        nd = np.ndim(quality_target)
        if nd > 1:
            raise ValueError(
                "quality_target must be a scalar or a (Q,) per-query "
                f"array, got shape {np.shape(quality_target)}")
        if nd == 1 and np.shape(quality_target)[0] != q.shape[0]:
            raise ValueError(
                f"per-query quality_target has {np.shape(quality_target)[0]} "
                f"entries for {q.shape[0]} queries")
    d_lb = bounds_mod.lower_bounds(index, q)                       # (Q, L)
    offsets = None
    if use_filters and filter_params is not None and tuner is not None \
            and quality_target is not None:
        offsets = tuner.offsets(quality_target)        # (F,) or (Q, F)
    if use_filters and filter_params is not None:
        d_F = predictions_for_all_leaves(index, filter_params, leaf_ids, q,
                                         offsets)
    else:
        d_F = torch.full(d_lb.shape, -_INF, device=dev)
    res = engine.run_cascade(
        index.series, index.leaf_start, index.leaf_size, q, d_lb, d_F,
        k=k, max_leaf=index.max_leaf_size, strategy=strategy,
        dist_impl=dist_impl)
    done = None
    if dev.type == "cuda":
        done = torch.cuda.Event()
        done.record()
    return PendingSearch(raw=res, order=index.order.cpu().numpy(),
                         n_series=index.n_series, n_leaves=index.n_leaves,
                         done=done)


def search_batched(index: FlatIndex, queries, *, k: int = 1,
                   filter_params=None, leaf_ids: Optional[np.ndarray] = None,
                   tuner: Optional[conformal.AutoTuner] = None,
                   quality_target=None, use_filters: bool = True,
                   strategy: str = "auto", dist_impl: Optional[str] = None,
                   device: Device = None) -> SearchResult:
    """Batched LeaFi search; exact when filters are disabled.

    ``quality_target`` is one target for the batch or an array of Q
    per-query targets (lowered to (Q, F) offset rows).  ``strategy`` is
    "compact" (the "auto" default) or "scan"; ``dist_impl`` selects the
    candidate pass (see :func:`engine.run_cascade`).  ``device=None`` means
    the card; the index must live there.
    """
    return search_batched_async(
        index, queries, k=k, filter_params=filter_params, leaf_ids=leaf_ids,
        tuner=tuner, quality_target=quality_target, use_filters=use_filters,
        strategy=strategy, dist_impl=dist_impl, device=device).result()
