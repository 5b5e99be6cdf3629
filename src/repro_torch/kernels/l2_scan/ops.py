"""Wrappers around the l2_scan kernels: impl selection, gathers, masking.

The port of ``repro.kernels.l2_scan.ops``.  For CPU tensors the plain
versions in ``ref.py`` run; for CUDA tensors the ``pairwise`` impl launches
the hand-written kernel (``kernel.py``) or raises — it never falls back.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import kernel, ref
from ..common import on_cpu as _on_cpu

_INF = float("inf")


def pairwise_l2(queries: torch.Tensor, series: torch.Tensor) -> torch.Tensor:
    """(Q, m) × (B, m) → (Q, B) euclidean distances via the pairwise kernel
    (its plain matmul-decomposed version for CPU tensors)."""
    q = queries.float().contiguous()
    s = series.float().contiguous()
    if _on_cpu(q, s):
        return ref.pairwise_l2_matmul(q, s)
    return kernel.pairwise_l2_cuda(q, s)


def masked_min_l2(queries: torch.Tensor, slab: torch.Tensor,
                  valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-query (min distance, argmin row) over the valid rows of a slab."""
    d = torch.where(valid[None, :], pairwise_l2(queries, slab), _INF)
    return d.min(dim=1)


def default_gathered_impl(device: torch.device) -> str:
    """``matmul`` on the card (the reference's TPU default), ``direct`` on
    the CPU, where it is bitwise-stable against the sequential scan."""
    return "matmul" if torch.device(device).type == "cuda" else "direct"


def gathered_leaf_l2(queries: torch.Tensor, slabs: torch.Tensor,
                     impl: Optional[str] = None) -> torch.Tensor:
    """(N, m) queries × (N, C, R, m) per-query gathered slabs → (N, C, R)."""
    impl = impl or default_gathered_impl(queries.device)
    q = queries.float()
    s = slabs.float()
    if impl == "direct":
        diff = s - q[:, None, None, :]
        return torch.sqrt((diff * diff).sum(-1))
    if impl == "matmul":
        qn = (q * q).sum(-1)
        sn = (s * s).sum(-1)
        N, C, R, m = s.shape
        dot = torch.bmm(s.reshape(N, C * R, m), q[:, :, None]).reshape(N, C, R)
        return torch.sqrt(torch.clamp_min(qn[:, None, None] + sn - 2.0 * dot,
                                          0.0))
    raise ValueError(f"unknown gathered-l2 impl {impl!r}")


def leaf_topk(dists: torch.Tensor, rows: torch.Tensor,
              k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-leaf k smallest distances and their row ids → ((N,C,k), (N,C,k)).

    Ties break toward the lower row, as ``lax.top_k`` does in the reference:
    a stable ascending sort keeps equal values in row order.
    """
    vals, arg = torch.sort(dists, dim=-1, stable=True)
    return vals[..., :k], torch.gather(rows, -1, arg[..., :k])


def gather_leaf_slabs(series: torch.Tensor, leaf_start: torch.Tensor,
                      leaf_size: torch.Tensor, leaf_ids: torch.Tensor,
                      max_leaf: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Padded slabs for a batch of leaves → (slabs (F, R, m), rows (F, R)
    global row ids, valid (F, R)).  Leaf ids == L are padding: their gather
    is clamped to a real leaf and their valid mask is all False."""
    L = leaf_start.shape[0]
    ok = leaf_ids < L
    safe = torch.clamp_max(leaf_ids, L - 1)
    sizes = torch.where(ok, leaf_size[safe], 0)
    ar = torch.arange(max_leaf, device=series.device)
    rows = leaf_start[safe][:, None] + ar[None, :]
    return series[rows], rows, ar[None, :] < sizes[:, None]


def default_slab_impl(device: torch.device) -> str:
    """``pairwise`` (the hand-written kernels) on the card, ``matmul`` on
    the CPU — the reference's TPU and off-TPU defaults."""
    return "pairwise" if torch.device(device).type == "cuda" else "matmul"


def slab_l2(queries: torch.Tensor, slabs: torch.Tensor,
            impl: Optional[str] = None) -> torch.Tensor:
    """Each slab's own query batch against the slab: (F, Nq, m) × (F, R, m)
    → (F, Nq, R).  ``pairwise`` launches the slab kernel on the card."""
    impl = impl or default_slab_impl(queries.device)
    q = queries.float()
    s = slabs.float()
    if impl == "direct":
        diff = q[:, :, None, :] - s[:, None, :, :]
        return torch.sqrt((diff * diff).sum(-1))
    if impl == "matmul":
        return ref.slab_l2_matmul(q, s)
    if impl == "pairwise":
        q, s = q.contiguous(), s.contiguous()
        if _on_cpu(q, s):
            return ref.slab_l2_matmul(q, s)
        return kernel.slab_l2_cuda(q, s)
    raise ValueError(f"unknown slab-l2 impl {impl!r}")


def shared_slab_l2(queries: torch.Tensor, slabs: torch.Tensor,
                   impl: Optional[str] = None) -> torch.Tensor:
    """A shared query batch against every slab: (Q, m) × (C, R, m) →
    (Q, C, R).  ``pairwise`` flattens the slabs into one (C·R, m) block for
    the pairwise kernel."""
    impl = impl or default_slab_impl(queries.device)
    q = queries.float()
    s = slabs.float()
    C, R, m = s.shape
    if impl == "direct":
        diff = q[:, None, None, :] - s[None, :, :, :]
        return torch.sqrt((diff * diff).sum(-1))
    if impl == "matmul":
        qn = (q * q).sum(-1)
        sn = (s * s).sum(-1)
        dot = (q @ s.reshape(C * R, m).T).reshape(-1, C, R)
        return torch.sqrt(torch.clamp_min(
            qn[:, None, None] + sn[None, :, :] - 2.0 * dot, 0.0))
    if impl == "pairwise":
        return pairwise_l2(q, s.reshape(C * R, m)).reshape(q.shape[0], C, R)
    raise ValueError(f"unknown slab-l2 impl {impl!r}")


def slab_masked_min(dists: torch.Tensor, valid: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked min over slab rows → (min (F, Nq), argmin (F, Nq))."""
    return torch.where(valid[:, None, :], dists, _INF).min(dim=-1)


# the direct-form plain version, for callers that compare both paths
reference = ref.pairwise_l2
