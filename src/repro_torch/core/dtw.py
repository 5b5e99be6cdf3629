"""Dynamic time warping (port of ``repro.core.dtw``; the paper's §3: "LeaFi
works for any distance measure supported by the backbone index, including
Euclidean and DTW").

* ``dtw`` — Sakoe–Chiba-banded DTW.  For CPU tensors the plain version in
  ``kernels/dtw/ref.py`` runs; for CUDA tensors the hand-written kernel
  (``csrc/dtw.cu``) launches or the call raises.  Both are bitwise equal
  to the reference's float32 DP.
* ``keogh_envelope`` — the band's sliding min and max (a max pool and the
  max pool of the negation: exact, as the reference's masked window).
* ``lb_keogh`` and ``lb_keogh_leaves`` — the LB_Keogh lower bound,
  point-wise and at node level.  Both are box distances, so both go
  through the box lower-bound kernel (``kernels/box_lb``): the points are
  x against q's envelope, or the query against the leaves' envelopes.  Its
  sums run in another order than the reference's (within 1e-6), and it
  counts a non-finite term as 0.

Each function takes the reference's shapes alone or under ``jax.vmap``: a
single series (m,) or a batch (Q, m) / (N, m), float32, all on one device.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as nnf

from ..kernels.box_lb import ops as box_lb_ops
from ..kernels.common import on_cpu
from ..kernels.dtw import kernel as dtw_kernel
from ..kernels.dtw import ref as dtw_ref


def _rows(t: torch.Tensor, name: str, device: torch.device) -> torch.Tensor:
    """``t`` (m,) or (n, m) float32 on ``device`` as (n, m)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} has dtype {t.dtype}, expected float32")
    if t.dim() not in (1, 2) or t.shape[-1] == 0:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected (m,) "
                         "or (n, m) with m >= 1")
    return t if t.dim() == 2 else t[None]


def _pairs(q: torch.Tensor, x: torch.Tensor, band: int) -> tuple:
    q2 = _rows(q, "q", q.device)
    x2 = _rows(x, "x", q.device)
    if x2.shape[1] != q2.shape[1]:
        raise ValueError(f"series of length {x2.shape[1]} against queries "
                         f"of length {q2.shape[1]}")
    if int(band) < 0:
        raise ValueError(f"the band must be >= 0, got {band}")
    return q2, x2


def _shaped(out: torch.Tensor, q: torch.Tensor,
            x: torch.Tensor) -> torch.Tensor:
    """(Q, N) as the reference gives it: 0-d, (N,), (Q,) or (Q, N)."""
    if q.dim() == 1:
        out = out[0]
    return out[..., 0] if x.dim() == 1 else out


def dtw(q: torch.Tensor, x: torch.Tensor, band: int = 8) -> torch.Tensor:
    """Banded DTW distance of q (m,) or (Q, m) against x (m,) or (N, m) →
    0-d, (N,), (Q,) or (Q, N)."""
    q2, x2 = _pairs(q, x, band)
    if on_cpu(q2, x2):
        out = dtw_ref.dtw(q2, x2, int(band))
    else:
        out = dtw_kernel.dtw_cuda(q2.contiguous(), x2.contiguous(), int(band))
    return _shaped(out, q, x)


def keogh_envelope(q: torch.Tensor,
                   band: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lower and upper envelope of q (..., m) under the band: L_i = min and
    U_i = max of q[i − r .. i + r] within the series."""
    if q.dtype != torch.float32:
        raise TypeError(f"q has dtype {q.dtype}, expected float32")
    if q.dim() < 1 or q.shape[-1] == 0:
        raise ValueError(f"q has shape {tuple(q.shape)}, expected (..., m) "
                         "with m >= 1")
    if int(band) < 0:
        raise ValueError(f"the band must be >= 0, got {band}")
    m = q.shape[-1]
    r = dtw_ref.effective_band(m, int(band))
    flat = q.reshape(-1, 1, m)
    upper = nnf.max_pool1d(flat, 2 * r + 1, stride=1, padding=r)
    lower = -nnf.max_pool1d(-flat, 2 * r + 1, stride=1, padding=r)
    return lower.reshape(q.shape), upper.reshape(q.shape)


def lb_keogh(q: torch.Tensor, x: torch.Tensor, band: int = 8) -> torch.Tensor:
    """LB_Keogh(q, x): the distance from x to q's envelope, a lower bound
    of ``dtw(q, x, band)``; shapes as ``dtw``."""
    q2, x2 = _pairs(q, x, band)
    lower, upper = keogh_envelope(q2, band)
    out = box_lb_ops.box_lb(x2, lower, upper).t().contiguous()   # (Q, N)
    return _shaped(out, q, x)


def lb_keogh_leaves(query: torch.Tensor, env_lo: torch.Tensor,
                    env_hi: torch.Tensor) -> torch.Tensor:
    """Node-level LB_Keogh: the query (m,) or (Q, m) against each leaf's
    envelope box (L, m) (min L / max U of its members' envelopes) →
    (L,) or (Q, L), a lower bound of the DTW to any member."""
    q2 = _rows(query, "query", query.device)
    lo = _rows(env_lo, "env_lo", query.device)
    hi = _rows(env_hi, "env_hi", query.device)
    if env_lo.dim() != 2 or lo.shape != hi.shape or lo.shape[1] != \
            q2.shape[1]:
        raise ValueError(f"envelopes {tuple(env_lo.shape)}/"
                         f"{tuple(env_hi.shape)} do not match the query "
                         f"{tuple(query.shape)}")
    out = box_lb_ops.box_lb(q2, lo, hi)
    return out[0] if query.dim() == 1 else out
