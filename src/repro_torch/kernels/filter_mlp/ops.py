"""Wrapper for fused filter-MLP inference (port of
``repro.kernels.filter_mlp.ops.filter_predict_fused``).

For CPU tensors the plain composition in ``ref.py`` runs; for CUDA tensors
the hand-written fused kernel launches (its float32, bfloat16 or int8
variant, by ``w1.dtype``) or the call raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import kernel, ref
from ..common import on_cpu as _on_cpu


def filter_predict_fused(w1: torch.Tensor, b1: torch.Tensor,
                         w2: torch.Tensor, b2: torch.Tensor,
                         y_mean: torch.Tensor, y_std: torch.Tensor,
                         queries: torch.Tensor,
                         offsets: Optional[torch.Tensor] = None,
                         w1_scale: Optional[torch.Tensor] = None,
                         w2_scale: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """De-standardized, offset-adjusted predictions → (F, Q) float32."""
    if _on_cpu(queries, w1):
        return ref.filter_predict_destd(w1, b1, w2, b2, y_mean, y_std,
                                        queries, offsets, w1_scale, w2_scale)
    F = w1.shape[0]
    off = (torch.zeros(F, dtype=torch.float32, device=w1.device)
           if offsets is None else offsets.float().contiguous())
    scales = [None if s is None else s.float().contiguous()
              for s in (w1_scale, w2_scale)]
    return kernel.fused_filter_mlp_cuda(
        queries.float().contiguous(), w1.contiguous(),
        b1.float().contiguous(), w2.contiguous(),
        b2.float().contiguous(), y_mean.float().contiguous(),
        y_std.float().contiguous(), off, *scales)


reference = ref.filter_predict
fused_reference = ref.filter_predict_destd
