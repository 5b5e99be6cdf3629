"""ctypes binding of the hand-written LSTM filter CUDA kernel.

Source: ``src/repro_torch/csrc/filter_rnn.cu``.  It replaces no Pallas
kernel: the reference computes the LSTM filters in XLA
(``src/repro/core/filters.py:233`` ``apply_rnn``, a ``lax.scan`` a layer).
Operations bound it (3·h·4h multiply-adds a step).  A block per (filter,
query tile) runs all m steps of both layers.  Three instances, by (h, Q)
(:func:`instance`, :func:`layout`): at h = 32 and 64, **few** for Q <=
:data:`FEW_MAX_Q` (a block per (filter, query) holds the three h × 4h
weights in registers, a thread two units' gates over 16 inputs, the
slices reduced by shuffles; layer 1's step t + 1 beside layer 2's step t,
one barrier a step) and **many** beyond (a block per (filter, 16
queries), the weights in shared memory read once a step for all 16
queries, a thread one unit's gates over 32 inputs); any other h the
**generic** instance (a thread one unit's four gates for four queries; the
weights in shared memory where they fit, read through L2 otherwise, the
state in a global scratch row where even it does not fit).
:func:`lstm_filter` checks its inputs, allocates the output (and any
scratch) with ``torch.empty``, launches on the current stream without
synchronising, raises if the launch reports a CUDA error, and adds one to
:data:`LAUNCHES`.
"""
from __future__ import annotations

import ctypes

import torch

from .. import common
from . import ref

#: launches per kernel; ``chip_smoke.py`` zeroes them before the main path
LAUNCHES = {"filter_rnn": 0}

_SIGNATURES = {
    "lstm_filter": [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4
    + [ctypes.c_void_p],
    "lstm_filter_layout": [ctypes.c_int] * 3 + [ctypes.c_void_p],
}

#: the few-query instance serves Q up to this (``FEW_MAX_Q`` in the
#: source); the many-query instance's queries a block (``QB``)
FEW_MAX_Q = 8
MANY_QUERIES = 16
#: the widths with a few- and a many-query instance
TUNED_H = (32, 64)
INSTANCES = ("generic", "few", "many")

_LAYOUT = ("instance", "threads", "queries_a_block", "weights_in_smem",
           "weight_registers", "state_in_smem", "smem_bytes", "registers",
           "scratch_floats", "few_max_q")


def instance(h: int, Q: int) -> str:
    """The instance the C entry takes for hidden width h and Q queries."""
    if h in TUNED_H:
        return "few" if Q <= FEW_MAX_Q else "many"
    return "generic"


def layout(F: int, Q: int, h: int) -> dict:
    """The launch the C entry makes for (F, Q, h): its instance, threads
    and queries a block, where the weights and the state live, dynamic
    shared memory, registers a thread, the scratch it needs and the
    few-query instance's largest Q."""
    lib = common.load("filter_rnn", _SIGNATURES)
    out = (ctypes.c_longlong * len(_LAYOUT))()
    common.check(lib.lstm_filter_layout(F, Q, h, out), "lstm_filter_layout")
    got = dict(zip(_LAYOUT, out))
    got["instance"] = INSTANCES[got["instance"]]
    return got


def lstm_filter_cuda(queries: torch.Tensor, wi1: torch.Tensor,
                     wh1: torch.Tensor, wi2: torch.Tensor, wh2: torch.Tensor,
                     w: torch.Tensor, b: torch.Tensor, y_mean: torch.Tensor,
                     y_std: torch.Tensor) -> torch.Tensor:
    """The LSTM backbone on one card: queries (Q, m), wi1 (F, 1, 4h),
    wh1/wi2/wh2 (F, h, 4h), w (F, h), b/y_mean/y_std (F,), all float32 →
    (F, Q)."""
    dev = queries.device
    common.require(queries, "queries", torch.float32, 2, dev)
    for name, t in (("wi1", wi1), ("wh1", wh1), ("wi2", wi2), ("wh2", wh2)):
        common.require(t, name, torch.float32, 3, dev)
    common.require(w, "w", torch.float32, 2, dev)
    F, h = w.shape
    Q, m = queries.shape
    if tuple(wi1.shape) != (F, 1, 4 * h) or any(
            tuple(t.shape) != (F, h, 4 * h) for t in (wh1, wi2, wh2)):
        raise ValueError(f"wi1 {tuple(wi1.shape)}, wh1 {tuple(wh1.shape)}, "
                         f"wi2 {tuple(wi2.shape)}, wh2 {tuple(wh2.shape)} "
                         f"and w {tuple(w.shape)} do not form an LSTM stack")
    for name, t in (("b", b), ("y_mean", y_mean), ("y_std", y_std)):
        common.require(t, name, torch.float32, 1, dev)
        if t.shape[0] != F:
            raise ValueError(f"{name} has {t.shape[0]} entries, expected {F}")
    out = torch.empty((F, Q), dtype=torch.float32, device=dev)
    if F == 0 or Q == 0:
        return out
    if m == 0 or h == 0:
        raise ValueError("the queries have no positions or the LSTM no "
                         "units")
    n_scratch = layout(F, Q, h)["scratch_floats"]
    scratch = (torch.empty(n_scratch, dtype=torch.float32, device=dev)
               if n_scratch else None)
    lib = common.load("filter_rnn", _SIGNATURES)
    err = lib.lstm_filter(*(common.ptr(t) for t in (
        queries, wi1, wh1, wi2, wh2, w, b, y_mean, y_std, out)),
        None if scratch is None else common.ptr(scratch), F, Q, m, h,
        common.stream_ptr(queries))
    common.check(err, "lstm_filter")
    LAUNCHES["filter_rnn"] += 1
    return out


def lstm_filter(queries, wi1, wh1, wi2, wh2, w, b, y_mean,
                y_std) -> torch.Tensor:
    """(F, Q) predictions: the plain version for CPU tensors, the kernel
    for CUDA ones (no fallback)."""
    args = (queries, wi1, wh1, wi2, wh2, w, b, y_mean, y_std)
    if common.on_cpu(queries, wh1):
        return ref.lstm_filter(*args)
    return lstm_filter_cuda(*(t.float().contiguous() for t in args))
