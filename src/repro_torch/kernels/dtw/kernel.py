"""ctypes binding of the hand-written banded DTW CUDA kernel.

Source: ``src/repro_torch/csrc/dtw.cu``.  It replaces no Pallas kernel: the
reference computes DTW as a jitted ``lax.scan`` over rows
(``src/repro/core/dtw.py:29`` ``dtw``).  Operations bound it (six float32
operations an in-band cell, none of which fuses).  One thread a (query,
series) pair; for the bands of ``BANDS`` the band's frame and the series'
window live in registers, any other band keeps its frame in a scratch
buffer this wrapper allocates.  :func:`dtw_cuda` checks its inputs,
allocates the output and the scratch with ``torch.empty``, launches on the
current stream without synchronising, raises if the launch reports a CUDA
error, and adds one to :data:`LAUNCHES`.
"""
from __future__ import annotations

import ctypes

import torch

from .. import common
from . import ref

#: launches per kernel; ``chip_smoke.py`` zeroes them before the main path
LAUNCHES = {"dtw": 0}

#: the bands with an instance of their own (``DTW_BANDS`` in the source):
#: the frame and the window in registers; any other band takes the generic
#: instance, its frame in a scratch buffer
BANDS = (2, 3, 4, 6, 8)

_SIGNATURES = {
    "dtw": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    "dtw_scratch_floats": [ctypes.c_int] * 4
    + [ctypes.POINTER(ctypes.c_longlong)],
}


def instance(m: int, band: int) -> str:
    """The kernel instance a call of series length ``m`` takes."""
    r = ref.effective_band(m, band)
    return f"band {r} in registers" if r in BANDS else \
        f"any band (r = {r}), frame in scratch"


def dtw_cuda(q: torch.Tensor, x: torch.Tensor, band: int) -> torch.Tensor:
    """Banded DTW of every pair on one card: q (Q, m), x (N, m), float32
    → (Q, N)."""
    dev = q.device
    common.require(q, "q", torch.float32, 2, dev)
    common.require(x, "x", torch.float32, 2, dev)
    Q, m = q.shape
    N = x.shape[0]
    if x.shape[1] != m:
        raise ValueError(f"series {tuple(x.shape)} do not match queries "
                         f"{tuple(q.shape)}")
    if m < 1 or band < 0:
        raise ValueError(f"DTW takes m >= 1 and a band >= 0, got m = {m}, "
                         f"band {band}")
    out = torch.empty((Q, N), dtype=torch.float32, device=dev)
    if Q == 0 or N == 0:
        return out
    lib = common.load("dtw", _SIGNATURES)
    floats = ctypes.c_longlong(0)
    common.check(lib.dtw_scratch_floats(Q, N, m, band, ctypes.byref(floats)),
                 "dtw_scratch_floats")
    scratch = torch.empty(max(floats.value, 1), dtype=torch.float32,
                          device=dev)
    err = lib.dtw(common.ptr(q), common.ptr(x), common.ptr(out),
                  common.ptr(scratch), Q, N, m, band, common.stream_ptr(q))
    common.check(err, "dtw")
    LAUNCHES["dtw"] += 1
    return out
