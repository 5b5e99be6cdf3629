"""Flattened, array-based index (port of ``repro.core.flat_index``).

The tree builder emits this structure on the host; ``.to(device)`` moves it
to the card, where lower bounds, training-target sweeps, calibration and
search consume it.  Leaf offsets and ids are int64 so they index tensors
directly.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch


@dataclasses.dataclass
class FlatIndex:
    kind: str                          # "dstree" | "isax"
    series: torch.Tensor               # (n + max_leaf, m) leaf-sorted, padded
    order: torch.Tensor                # (n,) original id of sorted row i
    leaf_start: torch.Tensor           # (L,) int64
    leaf_size: torch.Tensor            # (L,) int64
    max_leaf_size: int
    n_series: int
    length: int
    payload: Dict[str, torch.Tensor]   # summarization arrays per kind

    @property
    def n_leaves(self) -> int:
        return int(self.leaf_size.shape[0])

    @property
    def device(self) -> torch.device:
        return self.series.device

    def to(self, device) -> "FlatIndex":
        """The same index with every tensor on ``device``."""
        return dataclasses.replace(
            self, series=self.series.to(device), order=self.order.to(device),
            leaf_start=self.leaf_start.to(device),
            leaf_size=self.leaf_size.to(device),
            payload={k: v.to(device) for k, v in self.payload.items()})
