"""Host-side DSTree builder (port of ``repro.core.tree.build_dstree``).

Index building is a one-off, data-dependent, pointer-chasing procedure; it
runs in numpy on the host, as in the reference, and emits a
:class:`FlatIndex` of CPU tensors for the caller to move to the card.
Recursive binary splits on EAPCA segment statistics: split the segment whose
mean or std range is widest, at the median.  The iSAX builder is ROADMAP
queue A.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from . import summaries
from .flat_index import FlatIndex


@dataclasses.dataclass
class _Node:
    ids: np.ndarray                       # indices into the collection
    children: Optional[List["_Node"]] = None

    @property
    def is_leaf(self) -> bool:
        return self.children is None


def _segment_stats(series: np.ndarray, n_segments: int) -> np.ndarray:
    return summaries.segment_stats(torch.from_numpy(series),
                                   n_segments).numpy()


def build_dstree(series: np.ndarray, leaf_capacity: int = 256,
                 n_segments: int = 8) -> FlatIndex:
    """Z-normalize ``series`` (n, m) and split it into leaves of at most
    ``leaf_capacity`` series (a degenerate split halves the node)."""
    series = summaries.znormalize(torch.from_numpy(
        np.ascontiguousarray(series, np.float32))).numpy()
    n, m = series.shape
    stats = _segment_stats(series, n_segments)                 # (n, s, 2)

    root = _Node(ids=np.arange(n))
    stack = [root]
    while stack:
        node = stack.pop()
        if len(node.ids) <= leaf_capacity:
            continue
        st = stats[node.ids]                                  # (k, s, 2)
        # pick the (segment, statistic) with the widest range: splitting
        # there maximally tightens the children's EAPCA boxes.
        rng = st.max(axis=0) - st.min(axis=0)                 # (s, 2)
        seg, which = np.unravel_index(np.argmax(rng), rng.shape)
        vals = st[:, seg, which]
        pivot = np.median(vals)
        left = vals <= pivot
        # guard: degenerate split (all values equal) → split by halves.
        if left.all() or (~left).all():
            order = np.argsort(vals, kind="stable")
            left = np.zeros(len(vals), bool)
            left[order[: len(order) // 2]] = True
        lo = _Node(ids=node.ids[left])
        hi = _Node(ids=node.ids[~left])
        node.children = [lo, hi]
        node.ids = np.empty(0, np.int64)
        stack += [lo, hi]

    return _flatten(series, stats, _collect_leaves(root), n_segments)


def _collect_leaves(root: _Node) -> List[_Node]:
    out: List[_Node] = []
    stack = [root]
    while stack:
        node = stack.pop()
        if node.is_leaf:
            if len(node.ids):
                out.append(node)
        else:
            stack += node.children
    # deterministic ordering (largest leaves first)
    out.sort(key=lambda nd: (-len(nd.ids), int(nd.ids[0])))
    return out


def _flatten(series: np.ndarray, stats: np.ndarray, leaves: List[_Node],
             n_segments: int) -> FlatIndex:
    n, m = series.shape
    order = np.concatenate([lf.ids for lf in leaves]).astype(np.int64)
    sizes = np.asarray([len(lf.ids) for lf in leaves], np.int64)
    starts = np.concatenate([[0], np.cumsum(sizes[:-1])]).astype(np.int64)
    max_leaf = int(sizes.max())
    # pad the sorted array so a max_leaf-row window from any leaf start is
    # in bounds; padded rows are masked with +inf by every distance pass.
    sorted_series = np.concatenate(
        [series[order], np.zeros((max_leaf, m), np.float32)], axis=0)
    boxes = np.stack([summaries.eapca_node_box(stats[lf.ids])
                      for lf in leaves])                      # (L, s, 4)
    seg_len = np.full(n_segments, -(-m // n_segments), np.int32)
    return FlatIndex(
        kind="dstree",
        series=torch.from_numpy(sorted_series),
        order=torch.from_numpy(order),
        leaf_start=torch.from_numpy(starts),
        leaf_size=torch.from_numpy(sizes),
        max_leaf_size=max_leaf,
        n_series=n,
        length=m,
        payload={"eapca_box": torch.from_numpy(boxes),
                 "seg_len": torch.from_numpy(seg_len)},
    )
