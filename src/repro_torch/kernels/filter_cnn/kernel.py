"""ctypes binding of the hand-written CNN filter CUDA kernel.

Source: ``src/repro_torch/csrc/filter_cnn.cu``.  It replaces no Pallas
kernel: the reference computes the CNN filters in XLA
(``src/repro/core/filters.py:176`` ``apply_cnn``).  Operations bound it
(conv 2's m·C·K·C multiply-adds a (filter, query) pair).  A block per
(filter, query tile) whose queries, each followed by K − 1 zero columns,
fill :data:`ROWS` columns; conv 2 on split-TF32 ``wgmma`` (m64n256k8: A =
c2 split in registers from a tile staged as c2 stores it, B = conv 1's
output, written by a producer warpgroup K-major without swizzle, one tile
a chunk of :data:`STAGE_CHANNELS` input channels serving every shift by
its descriptor's start), :data:`PASS_CHANNELS` output channels a pass;
conv 1 once per (row, channel) a pass for all shifts; the epilogue reduces
in a fixed order.  :func:`cnn_filter` checks its inputs,
allocates the output with ``torch.empty``, launches on the current stream
without synchronising, raises if the launch reports a CUDA error, and adds
one to :data:`LAUNCHES`.  Every K, C, m, F and Q is served by the one
launch; :func:`layout` reports it.
"""
from __future__ import annotations

import ctypes

import torch

from .. import common
from . import ref

#: launches per kernel; ``chip_smoke.py`` zeroes them before the main path
LAUNCHES = {"filter_cnn": 0}

#: the source's tile: D's columns, output channels a pass, input channels
#: a chunk, shifts a B tile serves (``ROWS``, ``OW``, ``TK``, ``KT`` in
#: ``csrc/filter_cnn.cu``)
ROWS, PASS_CHANNELS, STAGE_CHANNELS, TILE_SHIFTS = 256, 128, 32, 33

_SIGNATURES = {
    "cnn_filter": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
    + [ctypes.c_void_p],
    "cnn_filter_layout": [ctypes.c_int] * 6 + [ctypes.c_void_p],
}

_LAYOUT = ("queries_a_block", "columns_a_tile", "channels_a_pass",
           "b_tiles_a_block", "c2_stages_a_block", "c2_by_cp_async16",
           "smem_bytes", "registers", "c2_bytes_staged")


def queries_a_block(m: int, K: int) -> int:
    """Queries a block serves: as many as fit in :data:`ROWS` columns,
    m + K − 1 apart (each followed by its K − 1 zero columns), the last
    one's m inside; one at m > ROWS (in column tiles of ROWS)."""
    return (ROWS - m) // (m + K - 1) + 1 if m <= ROWS else 1


def layout(F: int, Q: int, m: int, K: int, C: int,
           c2_aligned: bool = True) -> dict:
    """The launch the C entry makes for (F, Q, m, K, C): queries a block,
    columns a tile, channels a pass, B tiles and c2 stages a block,
    whether c2 is staged by 16-byte ``cp.async`` (C % 4 == 0 and a 16-byte
    aligned c2), dynamic shared memory, registers a thread at launch and
    the c2 bytes staged."""
    lib = common.load("filter_cnn", _SIGNATURES)
    out = (ctypes.c_longlong * len(_LAYOUT))()
    common.check(lib.cnn_filter_layout(F, Q, m, K, C, int(c2_aligned), out),
                 "cnn_filter_layout")
    return dict(zip(_LAYOUT, out))


def cnn_filter_cuda(queries: torch.Tensor, c1: torch.Tensor,
                    c2: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    y_mean: torch.Tensor,
                    y_std: torch.Tensor) -> torch.Tensor:
    """The CNN backbone on one card: queries (Q, m), c1 (F, K, 1, C), c2
    (F, K, C, C), w (F, C), b/y_mean/y_std (F,), all float32 → (F, Q)."""
    dev = queries.device
    common.require(queries, "queries", torch.float32, 2, dev)
    common.require(c1, "c1", torch.float32, 4, dev)
    common.require(c2, "c2", torch.float32, 4, dev)
    common.require(w, "w", torch.float32, 2, dev)
    F, K, one, C = c1.shape
    Q, m = queries.shape
    if one != 1 or tuple(c2.shape) != (F, K, C, C) \
            or tuple(w.shape) != (F, C):
        raise ValueError(f"c1 {tuple(c1.shape)}, c2 {tuple(c2.shape)} and "
                         f"w {tuple(w.shape)} do not form a CNN stack")
    for name, t in (("b", b), ("y_mean", y_mean), ("y_std", y_std)):
        common.require(t, name, torch.float32, 1, dev)
        if t.shape[0] != F:
            raise ValueError(f"{name} has {t.shape[0]} entries, expected {F}")
    out = torch.empty((F, Q), dtype=torch.float32, device=dev)
    if F == 0 or Q == 0:
        return out
    if m == 0:
        raise ValueError("the queries have no positions")
    lib = common.load("filter_cnn", _SIGNATURES)
    err = lib.cnn_filter(*(common.ptr(t) for t in (
        queries, c1, c2, w, b, y_mean, y_std, out)), F, Q, m, K, C,
        common.stream_ptr(queries))
    common.check(err, "cnn_filter")
    LAUNCHES["filter_cnn"] += 1
    return out


def cnn_filter(queries, c1, c2, w, b, y_mean, y_std) -> torch.Tensor:
    """(F, Q) predictions: the plain version for CPU tensors, the kernel
    for CUDA ones (no fallback)."""
    args = (queries, c1, c2, w, b, y_mean, y_std)
    if common.on_cpu(queries, c1, c2):
        return ref.cnn_filter(*args)
    return cnn_filter_cuda(*(t.float().contiguous() for t in args))
