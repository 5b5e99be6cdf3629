"""Learned filters (port of ``repro.core.filters``): the MLP, and the 2-layer
CNN and 2-block LSTM of the paper's filter-model ablation (Table 1, Fig.
12).

Parameters are stacked on a leading filter axis F, so every filter trains
and infers in one batched call.  Predictions are de-standardized with
per-filter target statistics.  The weight matrices of a trained MLP stack
can be compressed to bfloat16 or int8 for inference; the fused filter
kernel has a variant for each payload.  The CNN and LSTM keep the
reference's layouts (c1/c2 in WIO, gates in i, f, g, o order) and float32
weights; each runs as one launch of its own kernel on the card
(``kernels/filter_cnn``, ``kernels/filter_rnn``).  :data:`APPLY` and
:data:`INIT` map a filter type to its functions.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch

from ..kernels.filter_cnn import kernel as cnn_kernel
from ..kernels.filter_mlp import ops as mlp_ops
from ..kernels.filter_mlp import ref as mlp_ref
from ..kernels.filter_rnn import kernel as rnn_kernel

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


# ---------------------------------------------------------------------------
# CNN / LSTM variants (Table 1 & Fig. 12 ablation)
# ---------------------------------------------------------------------------


def _randn(shape, scale: float, generator: torch.Generator,
           device) -> torch.Tensor:
    return torch.randn(shape, generator=generator, device=device) * scale


def _stats(n_filters: int, device) -> Params:
    return {"b": torch.zeros((n_filters,), device=device),
            "y_mean": torch.zeros((n_filters,), device=device),
            "y_std": torch.ones((n_filters,), device=device)}


def init_cnn(n_filters: int, length: int, channels: Optional[int] = None,
             ksize: int = 3, *, generator: torch.Generator,
             device) -> Params:
    """He-normal convolutions c1 (F, K, 1, C) and c2 (F, K, C, C) in the
    reference's WIO layout, a head w (F, C), zero bias, identity target
    statistics; C = ``channels`` or the series length."""
    channels = channels or length
    return {
        "c1": _randn((n_filters, ksize, 1, channels),
                     math.sqrt(2.0 / ksize), generator, device),
        "c2": _randn((n_filters, ksize, channels, channels),
                     math.sqrt(2.0 / (ksize * channels)), generator, device),
        "w": _randn((n_filters, channels), math.sqrt(1.0 / channels),
                    generator, device),
        **_stats(n_filters, device),
    }


def apply_cnn(params: Params, queries: torch.Tensor) -> torch.Tensor:
    """2-conv-layer filter: (Q, m) → (F, Q) de-standardized predictions:
    "SAME" conv → relu → "SAME" conv → relu → mean over positions → · w +
    b; one launch of the CNN kernel on the card."""
    return cnn_kernel.cnn_filter(queries, params["c1"], params["c2"],
                                 params["w"], params["b"], params["y_mean"],
                                 params["y_std"])


def init_rnn(n_filters: int, length: int, hidden: int = 64, *,
             generator: torch.Generator, device) -> Params:
    """Two bias-free LSTM layers (wi1 (F, 1, 4h); wh1, wi2, wh2 (F, h, 4h))
    and a head w (F, h), all normal with scale √(1/h); zero bias, identity
    target statistics.  ``length`` is accepted for :data:`INIT`'s one
    signature."""
    del length
    s = math.sqrt(1.0 / hidden)
    shapes = {"wi1": (n_filters, 1, 4 * hidden),
              "wh1": (n_filters, hidden, 4 * hidden),
              "wi2": (n_filters, hidden, 4 * hidden),
              "wh2": (n_filters, hidden, 4 * hidden),
              "w": (n_filters, hidden)}
    out = {k: _randn(shape, s, generator, device)
           for k, shape in shapes.items()}
    return {**out, **_stats(n_filters, device)}


def apply_rnn(params: Params, queries: torch.Tensor) -> torch.Tensor:
    """2-LSTM-block filter: (Q, m) → (F, Q) de-standardized predictions
    from layer 2's last hidden state; one launch of the LSTM kernel on the
    card."""
    return rnn_kernel.lstm_filter(queries, params["wi1"], params["wh1"],
                                  params["wi2"], params["wh2"], params["w"],
                                  params["b"], params["y_mean"],
                                  params["y_std"])


def filter_type_of(params: Params) -> str:
    """The backbone a parameter dict holds: "cnn" (``c1``), "rnn"
    (``wi1``) or "mlp"."""
    if "c1" in params:
        return "cnn"
    if "wi1" in params:
        return "rnn"
    return "mlp"


#: de-standardized (F, Q) predictions of each filter type, without offsets
APPLY: Dict[str, Callable[[Params, torch.Tensor], torch.Tensor]] = {
    "mlp": lambda params, queries: apply_mlp_offset(params, queries),
    "cnn": apply_cnn,
    "rnn": apply_rnn,
}
#: initial parameters of each filter type
INIT = {"mlp": init_mlp, "cnn": init_cnn, "rnn": init_rnn}
