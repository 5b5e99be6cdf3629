"""Learned MLP filters (port of the MLP half of ``repro.core.filters``).

Parameters are stacked on a leading filter axis F, so every filter trains
and infers in one batched call.  Predictions are de-standardized with
per-filter target statistics.  The weight matrices of a trained stack can
be compressed to bfloat16 or int8 for inference; the fused filter kernel has
a variant for each payload.  The CNN/RNN ablation filters are ROADMAP
queue A.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from ..kernels.filter_mlp import ops as mlp_ops
from ..kernels.filter_mlp import ref as mlp_ref

Params = Dict[str, torch.Tensor]

#: weight-matrix bytes per element by payload dtype (biases/stats stay f32)
WEIGHT_BYTES_PER_EL = {"float32": 4, "bfloat16": 2, "int8": 1}


def init_mlp(n_filters: int, length: int, hidden: Optional[int] = None, *,
             generator: torch.Generator, device) -> Params:
    """He-normal layer weights, zero biases, identity target statistics."""
    hidden = hidden or length
    w1 = torch.randn((n_filters, length, hidden), generator=generator,
                     device=device) * math.sqrt(2.0 / length)
    w2 = torch.randn((n_filters, hidden), generator=generator,
                     device=device) * math.sqrt(2.0 / hidden)
    return {
        "w1": w1,
        "b1": torch.zeros((n_filters, hidden), device=device),
        "w2": w2,
        "b2": torch.zeros((n_filters,), device=device),
        "y_mean": torch.zeros((n_filters,), device=device),
        "y_std": torch.ones((n_filters,), device=device),
    }


def apply_mlp_offset(params: Params, queries: torch.Tensor,
                     offsets: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(Q, m) → (F, Q) de-standardized predictions minus per-filter offsets:
    one launch of the fused filter kernel on the card."""
    return mlp_ops.filter_predict_fused(
        params["w1"], params["b1"], params["w2"], params["b2"],
        params["y_mean"], params["y_std"], queries, offsets,
        params.get("w1_scale"), params.get("w2_scale"))


def apply_mlp_raw(params: Params, queries: torch.Tensor) -> torch.Tensor:
    """Raw (standardized-space) predictions → (F, Q): training's validation
    pass; the ``filter_mlp`` kernel on the card."""
    return mlp_ops.filter_predict(params["w1"], params["b1"], params["w2"],
                                  params["b2"], queries)


def quantize_mlp(params: Params, weight_dtype: str = "float32") -> Params:
    """Weight payload for inference: the weight matrices in float32,
    bfloat16 (round to nearest even) or int8 with one symmetric
    max-abs/127 scale per filter per layer (``w1_scale``/``w2_scale``, (F,)
    float32, rounded half to even and clamped to ±127).  Biases and target
    statistics stay float32.  A quantized input is dequantized first."""
    out = {k: v for k, v in params.items()
           if k not in ("w1_scale", "w2_scale")}
    w1, w2 = params["w1"], params["w2"]
    if w1.dtype != torch.float32:
        w1, w2 = mlp_ref.dequantize_weights(
            w1, w2, params.get("w1_scale"), params.get("w2_scale"))
    if weight_dtype == "float32":
        out["w1"], out["w2"] = w1, w2
    elif weight_dtype == "bfloat16":
        out["w1"], out["w2"] = w1.to(torch.bfloat16), w2.to(torch.bfloat16)
    elif weight_dtype == "int8":
        s1 = w1.abs().amax(dim=(1, 2)) / 127.0 + 1e-12
        s2 = w2.abs().amax(dim=1) / 127.0 + 1e-12
        out["w1"] = torch.clamp(torch.round(w1 / s1[:, None, None]),
                                -127, 127).to(torch.int8)
        out["w2"] = torch.clamp(torch.round(w2 / s2[:, None]),
                                -127, 127).to(torch.int8)
        out["w1_scale"], out["w2_scale"] = s1, s2
    else:
        raise ValueError(f"unknown weight_dtype {weight_dtype!r}")
    return out


def mlp_weight_dtype(params: Params) -> str:
    """Weight payload of an MLP stack: "float32", "bfloat16" or "int8"."""
    return {torch.float32: "float32", torch.bfloat16: "bfloat16",
            torch.int8: "int8"}[params["w1"].dtype]


def mlp_param_bytes(length: int, hidden: Optional[int] = None,
                    weight_dtype: str = "float32") -> int:
    """Per-filter memory footprint w (the knapsack item weight, Eq. 1):
    w1 and w2 at the payload width; b1, b2, y_mean, y_std in float32; int8
    adds two float32 scales."""
    hidden = hidden or length
    wb = WEIGHT_BYTES_PER_EL[weight_dtype]
    n_weight = length * hidden + hidden            # w1 + w2
    n_f32 = hidden + 1 + 2                         # b1 + b2 + y_mean/y_std
    n_scales = 2 if weight_dtype == "int8" else 0
    return wb * n_weight + 4 * (n_f32 + n_scales)
