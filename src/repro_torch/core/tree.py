"""Host-side tree builders for the two backbones (port of
``repro.core.tree``).

Index building is a one-off, data-dependent, pointer-chasing procedure; it
runs in numpy on the host, as in the reference, and emits a
:class:`FlatIndex` of CPU tensors for the caller to move to the card.

* ``build_dstree``: recursive binary splits on EAPCA segment statistics
  (split the segment whose mean or std range is widest, at the median).
* ``build_isax``: a prefix trie over SAX words; the root's children bucket
  the series on the top bit of every dimension, and a node splits by
  promoting one more bit of the least-refined dimension that separates its
  series (iSAX2/MESSI style).  A node no promotion can split stays an
  oversized leaf.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from . import summaries
from .flat_index import FlatIndex

#: default iSAX cardinality bits per dimension at the deepest promotion
MAX_CARD_BITS = 8


@dataclasses.dataclass
class _Node:
    ids: np.ndarray                       # indices into the collection
    children: Optional[List["_Node"]] = None
    sax_word: Optional[np.ndarray] = None   # isax: (l,) symbols at node card
    sax_bits: Optional[np.ndarray] = None   # isax: (l,) cardinality bits

    @property
    def is_leaf(self) -> bool:
        return self.children is None


def _segment_stats(series: np.ndarray, n_segments: int) -> np.ndarray:
    return summaries.segment_stats(torch.from_numpy(series),
                                   n_segments).numpy()


def _prepare(series: np.ndarray, znorm: bool) -> torch.Tensor:
    """The collection as float32, z-normalized unless ``znorm`` is False."""
    out = torch.from_numpy(np.ascontiguousarray(series, np.float32))
    return summaries.znormalize(out) if znorm else out


def build_dstree(series: np.ndarray, leaf_capacity: int = 256,
                 n_segments: int = 8, znorm: bool = True) -> FlatIndex:
    """Split ``series`` (n, m), z-normalized unless ``znorm`` is False, into
    leaves of at most ``leaf_capacity`` series (a degenerate split halves
    the node)."""
    series = _prepare(series, znorm).numpy()
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

    leaves = _collect_leaves(root)
    boxes = np.stack([summaries.eapca_node_box(stats[lf.ids])
                      for lf in leaves])                      # (L, s, 4)
    seg_len = np.full(n_segments, -(-m // n_segments), np.int32)
    return _flatten(series, leaves, "dstree", {"eapca_box": boxes,
                                               "seg_len": seg_len})


def build_isax(series: np.ndarray, leaf_capacity: int = 256,
               word_len: int = 8, max_card_bits: int = MAX_CARD_BITS,
               znorm: bool = True) -> FlatIndex:
    """Index the SAX words of ``word_len`` dimensions of ``series`` (n, m),
    z-normalized unless ``znorm`` is False, in a trie with leaves of at most
    ``leaf_capacity`` series, unless ``max_card_bits`` bits per dimension
    cannot separate them."""
    series = _prepare(series, znorm)
    paa = summaries.paa(series, word_len)                     # (n, l)
    series = series.numpy()
    # symbols at the maximum cardinality; a node's symbol at b bits is the
    # top b bits of the max-cardinality symbol (cardinality promotion)
    sym_max = summaries.sax_from_paa(paa, max_card_bits).numpy()

    # root children: one bit on every dimension; ids stay ascending
    top = sym_max >> (max_card_bits - 1)
    words, inverse = np.unique(top, axis=0, return_inverse=True)
    inverse = inverse.reshape(-1)
    by_word = np.argsort(inverse, kind="stable")
    cuts = np.cumsum(np.bincount(inverse, minlength=len(words)))[:-1]
    root = _Node(ids=np.empty(0, np.int64), children=[])
    for w, ids in zip(words, np.split(by_word, cuts)):
        root.children.append(_Node(ids=ids, sax_word=w.astype(np.int32),
                                   sax_bits=np.ones(word_len, np.int64)))
    stack = list(root.children)
    while stack:
        node = stack.pop()
        if len(node.ids) <= leaf_capacity:
            continue
        # promote the dimension with the fewest bits whose next bit
        # separates the node's series
        split_dim, bit = -1, None
        for d in np.argsort(node.sax_bits, kind="stable"):
            if node.sax_bits[d] >= max_card_bits:
                continue
            b = node.sax_bits[d] + 1
            bit = (sym_max[node.ids, d] >> (max_card_bits - b)) & 1
            if 0 < bit.sum() < len(bit):
                split_dim = int(d)
                break
        if split_dim < 0:                 # cannot separate: oversized leaf
            continue
        bits = node.sax_bits.copy()
        bits[split_dim] += 1
        node.children = []
        for side in (0, 1):
            ids = node.ids[bit == side]
            word = (sym_max[ids[0]] >> (max_card_bits - bits)).astype(
                np.int32)
            child = _Node(ids=ids, sax_word=word, sax_bits=bits.copy())
            node.children.append(child)
            stack.append(child)
        node.ids = np.empty(0, np.int64)

    leaves = _collect_leaves(root)
    words = np.stack([lf.sax_word for lf in leaves]).astype(np.int32)
    bits = np.stack([lf.sax_bits for lf in leaves]).astype(np.int32)
    return _flatten(series, leaves, "isax", {
        "sax_word": words, "sax_bits": bits,
        "sax_edges": summaries.sax_symbol_edges(words, bits)})


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


def _flatten(series: np.ndarray, leaves: List[_Node], kind: str,
             payload: dict) -> FlatIndex:
    n, m = series.shape
    order = np.concatenate([lf.ids for lf in leaves]).astype(np.int64)
    sizes = np.asarray([len(lf.ids) for lf in leaves], np.int64)
    starts = np.concatenate([[0], np.cumsum(sizes[:-1])]).astype(np.int64)
    max_leaf = int(sizes.max())
    # pad the sorted array so a max_leaf-row window from any leaf start is
    # in bounds; padded rows are masked with +inf by every distance pass.
    sorted_series = np.concatenate(
        [series[order], np.zeros((max_leaf, m), np.float32)], axis=0)
    return FlatIndex(
        kind=kind,
        series=torch.from_numpy(sorted_series),
        order=torch.from_numpy(order),
        leaf_start=torch.from_numpy(starts),
        leaf_size=torch.from_numpy(sizes),
        max_leaf_size=max_leaf,
        n_series=n,
        length=m,
        payload={k: torch.from_numpy(v) for k, v in payload.items()},
    )
