"""Plain PyTorch versions of stacked per-leaf filter-MLP inference.

``filter_predict_destd`` is the function the fused CUDA kernel computes; the
wrapper in ``ops.py`` runs it for CPU tensors and ``chip_smoke.py`` holds
the kernel against it on the card.  ``filter_predict_destd_split_tf32`` is
the same function with the layer-1 products taken as the fused kernel's
tile design takes them on the tensor cores (split TF32, emulated on the
CPU), and ``filter_predict_split_tf32`` the raw ``filter_predict`` so (the
``filter_mlp`` kernel's tile design); the tests hold their error to the
card's limit, and no path runs them.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..l2_scan.ref import split_tf32_matmul


def filter_predict(w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                   b2: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """w1 (F,m,h), b1 (F,h), w2 (F,h), b2 (F,) × queries (Q,m) → (F,Q)."""
    hidden = torch.relu(torch.matmul(queries.float(), w1.float())
                        + b1[:, None, :])                  # (F, Q, h)
    return torch.bmm(hidden, w2.float()[:, :, None])[:, :, 0] + b2[:, None]


def dequantize_weights(w1: torch.Tensor, w2: torch.Tensor,
                       w1_scale: Optional[torch.Tensor] = None,
                       w2_scale: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Effective float32 weights: int8 payloads times their per-filter
    scales, bf16 payloads upcast, float32 passed through."""
    if w1_scale is not None:
        w1 = w1.float() * w1_scale[:, None, None]
    if w2_scale is not None:
        w2 = w2.float() * w2_scale[:, None]
    return w1.float(), w2.float()


def filter_predict_destd(w1, b1, w2, b2, y_mean, y_std, queries,
                         offsets=None, w1_scale=None, w2_scale=None
                         ) -> torch.Tensor:
    """De-standardized (and offset-adjusted) predictions → (F, Q): raw z,
    then z·y_std + y_mean, then −offsets (the fused kernel's op order)."""
    w1f, w2f = dequantize_weights(w1, w2, w1_scale, w2_scale)
    z = filter_predict(w1f, b1, w2f, b2, queries)
    out = z * y_std[:, None] + y_mean[:, None]
    if offsets is not None:
        out = out - offsets[:, None]
    return out


def _split_tf32_z(w1, b1, w2f, b2, queries, w1_scale=None) -> torch.Tensor:
    """The tile design's raw z → (F, Q): q·w1 as split-TF32 steps (three
    products for float32 weights, two for bf16 and int8, which are exact in
    TF32), × s1 (int8), + b1, relu, × w2 (already × s2), summed over h,
    + b2."""
    pre = split_tf32_matmul(queries, w1.float(),
                            b_exact=w1.dtype != torch.float32)  # (F, Q, h)
    if w1_scale is not None:
        pre = pre * w1_scale[:, None, None]
    return (torch.relu(pre + b1[:, None, :]) * w2f[:, None, :]).sum(-1) \
        + b2[:, None]


def filter_predict_split_tf32(w1, b1, w2, b2, queries) -> torch.Tensor:
    """:func:`filter_predict` as the ``filter_mlp`` kernel's tile design
    computes it: the fused kernel's float32 body, raw epilogue."""
    return _split_tf32_z(w1, b1, w2.float(), b2, queries)


def filter_predict_destd_split_tf32(w1, b1, w2, b2, y_mean, y_std, queries,
                                    offsets=None, w1_scale=None,
                                    w2_scale=None) -> torch.Tensor:
    """:func:`filter_predict_destd` as the fused kernel's tile design
    computes it: q·w1 as split-TF32 steps (three products for float32
    weights, two for bf16 and int8, which are exact in TF32), then × s1
    (int8), + b1, relu, × w2 (× s2), summed over h, + b2, × y_std + y_mean
    − offsets."""
    w2f = w2.float() if w2_scale is None else w2.float() * w2_scale[:, None]
    z = _split_tf32_z(w1, b1, w2f, b2, queries, w1_scale)
    out = z * y_std[:, None] + y_mean[:, None]
    if offsets is not None:
        out = out - offsets[:, None]
    return out
