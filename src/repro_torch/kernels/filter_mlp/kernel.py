"""ctypes bindings of the hand-written filter-MLP CUDA kernels.

Source: ``src/repro_torch/csrc/filter_mlp.cu`` (the file says which TPU
kernels it replaces and what bounds them on an H100).  The fused kernel has
one entry point per weight payload (float32, bfloat16, int8 with
per-filter scales); ``filter_mlp`` is the raw per-filter sweep (float32).
Each wrapper checks its inputs, allocates the output with ``torch.empty``,
launches on the current stream without synchronising, raises if the launch
reports a CUDA error, and adds one to its entry of :data:`LAUNCHES`.

Every entry, ``filter_mlp`` too, takes one of two designs inside the C
entry, by the query count (:func:`regime`): a weight-streaming block per
filter for a few queries (``search_early`` asks for one), tensor-core
tiles of 128 queries otherwise; ``filter_mlp`` is the float32 instance
with the raw epilogue.  One call is one launch either way.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import common

#: launches per kernel; ``chip_smoke.py`` zeroes them before the main path
LAUNCHES = {"fused_filter_mlp": 0, "fused_filter_mlp_bf16": 0,
            "fused_filter_mlp_int8": 0, "filter_mlp": 0}

#: C entry point (and launch counter) per weight payload
ENTRY = {torch.float32: "fused_filter_mlp",
         torch.bfloat16: "fused_filter_mlp_bf16",
         torch.int8: "fused_filter_mlp_int8"}

#: the largest query count the fused entries send to the stream design
#: (``FILTER_MLP_STREAM_MAX_Q`` in ``csrc/filter_mlp.cu``; measured on an
#: H100 with ``repro_torch.bench.fused_designs``, PERF.md)
STREAM_MAX_Q = 12


def regime(n_queries: int) -> str:
    """The filter kernels' design for ``n_queries`` queries: ``"stream"``
    (w1 streamed once per 4 queries) or ``"tile"`` (128-query tiles on the
    tensor cores)."""
    return "stream" if n_queries <= STREAM_MAX_Q else "tile"


_SIGNATURES = {
    "fused_filter_mlp": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
    + [ctypes.c_void_p],
    "fused_filter_mlp_bf16": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
    + [ctypes.c_void_p],
    "fused_filter_mlp_int8": [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4
    + [ctypes.c_void_p],
    "filter_mlp": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
    + [ctypes.c_void_p],
}


def fused_filter_mlp_cuda(queries: torch.Tensor, w1: torch.Tensor,
                          b1: torch.Tensor, w2: torch.Tensor,
                          b2: torch.Tensor, y_mean: torch.Tensor,
                          y_std: torch.Tensor, offsets: torch.Tensor,
                          w1_scale: Optional[torch.Tensor] = None,
                          w2_scale: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Stacked filters on one card → (F, Q) adjusted predictions.  w1/w2
    are float32, bfloat16 or int8; int8 takes (F,) float32 scales."""
    dev = queries.device
    if w1.dtype not in ENTRY:
        raise TypeError(f"w1 has dtype {w1.dtype}; the kernel takes "
                        f"{sorted(str(d) for d in ENTRY)}")
    entry = ENTRY[w1.dtype]
    scaled = w1.dtype == torch.int8
    if scaled != (w1_scale is not None and w2_scale is not None):
        raise ValueError("int8 weights take w1_scale and w2_scale, and "
                         "float weights take neither")
    common.require(queries, "queries", torch.float32, 2, dev)
    common.require(w1, "w1", w1.dtype, 3, dev)
    F, m, h = w1.shape
    Q = queries.shape[0]
    if queries.shape[1] != m:
        raise ValueError(f"queries width {queries.shape[1]} != filter "
                         f"input width {m}")
    checks = [("b1", b1, torch.float32, (F, h)),
              ("w2", w2, w1.dtype, (F, h)),
              ("b2", b2, torch.float32, (F,)),
              ("y_mean", y_mean, torch.float32, (F,)),
              ("y_std", y_std, torch.float32, (F,)),
              ("offsets", offsets, torch.float32, (F,))]
    if scaled:
        checks += [("w1_scale", w1_scale, torch.float32, (F,)),
                   ("w2_scale", w2_scale, torch.float32, (F,))]
    for name, t, dtype, shape in checks:
        common.require(t, name, dtype, len(shape), dev)
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
    out = torch.empty((F, Q), dtype=torch.float32, device=dev)
    lib = common.load("filter_mlp", _SIGNATURES)
    if scaled:
        args = (common.ptr(queries), common.ptr(w1), common.ptr(w1_scale),
                common.ptr(b1), common.ptr(w2), common.ptr(w2_scale))
    else:
        args = (common.ptr(queries), common.ptr(w1), common.ptr(b1),
                common.ptr(w2))
    err = getattr(lib, entry)(
        *args, common.ptr(b2), common.ptr(y_mean), common.ptr(y_std),
        common.ptr(offsets), common.ptr(out), F, Q, m, h,
        common.stream_ptr(queries))
    common.check(err, entry)
    LAUNCHES[entry] += 1
    return out


def filter_mlp_cuda(queries: torch.Tensor, w1: torch.Tensor,
                    b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor
                    ) -> torch.Tensor:
    """Stacked float32 filters on one card → (F, Q) raw predictions
    relu(q·w1 + b1)·w2 + b2 (no statistics, no offsets)."""
    dev = queries.device
    common.require(queries, "queries", torch.float32, 2, dev)
    common.require(w1, "w1", torch.float32, 3, dev)
    F, m, h = w1.shape
    Q = queries.shape[0]
    if queries.shape[1] != m:
        raise ValueError(f"queries width {queries.shape[1]} != filter "
                         f"input width {m}")
    for name, t, shape in (("b1", b1, (F, h)), ("w2", w2, (F, h)),
                           ("b2", b2, (F,))):
        common.require(t, name, torch.float32, len(shape), dev)
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
    out = torch.empty((F, Q), dtype=torch.float32, device=dev)
    lib = common.load("filter_mlp", _SIGNATURES)
    err = lib.filter_mlp(common.ptr(queries), common.ptr(w1), common.ptr(b1),
                         common.ptr(w2), common.ptr(b2), common.ptr(out),
                         F, Q, m, h, common.stream_ptr(queries))
    common.check(err, "filter_mlp")
    LAUNCHES["filter_mlp"] += 1
    return out
