"""ctypes bindings of the hand-written filter-training CUDA kernels.

Source: ``src/repro_torch/csrc/filter_train.cu`` (the file says what the
two kernels compute, what bounds them on an H100 and how they are laid
out).  ``train_forward`` returns ∂loss/∂pred of one step; ``train_backward_
sgd`` takes it and updates the parameters and their velocities in place,
one launch per 160-row tile of the step (``ref.row_tiles``: one at the
default batch of 128).  Both also take the rows' low parts (``ref.x_lo``,
made once a training: ``TrainInputs.xg_lo`` / ``xl_lo``); the raw rows
serve as the high parts.  Each wrapper checks its inputs, allocates its
output with ``torch.empty``, launches on the current stream without
synchronising, raises if the launch reports a CUDA error, and adds its
launches to its entry of :data:`LAUNCHES`.  The
step's row indices are views of the drawn (n_steps, batch) index tensors,
read by the kernels through their pointer: a step slices them with no
launch.  No ``ops.py``: the CPU path is ``ref.autograd_step``, chosen by
``core.filter_training.sgd_step``.
"""
from __future__ import annotations

import ctypes

import torch

from .. import common
from . import ref

#: launches per kernel; ``chip_smoke.py`` zeroes them before the main path
LAUNCHES = {"train_forward": 0, "train_backward_sgd": 0}

_SIGNATURES = {
    "train_forward": [ctypes.c_void_p] * 15 + [ctypes.c_int] * 7
    + [ctypes.c_float] * 2 + [ctypes.c_void_p],
    "train_backward_sgd": [ctypes.c_void_p] * 15 + [ctypes.c_int] * 7
    + [ctypes.c_float] * 2 + [ctypes.c_void_p],
    "train_smem": [ctypes.c_void_p],
}


def _check_shapes(named: dict, dev: torch.device) -> None:
    for name, (t, dtype, shape) in named.items():
        common.require(t, name, dtype, len(shape), dev)
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")


def _rows(xg, xl, ig, il, w1, dev, xg_lo, xl_lo) -> tuple:
    """Checks the step's rows and their low parts against ``w1`` → (F, m,
    h, n_g, n_l, bg, bl)."""
    common.require(w1, "w1", torch.float32, 3, dev)
    F, m, h = w1.shape
    common.require(xg, "xg", torch.float32, 2, dev)
    common.require(xl, "xl", torch.float32, 3, dev)
    common.require(ig, "ig", torch.int64, 1, dev)
    common.require(il, "il", torch.int64, 1, dev)
    n_g, n_l = xg.shape[0], xl.shape[1]
    bg, bl = ig.shape[0], il.shape[0]
    if xg_lo is None or xl_lo is None:
        raise ValueError("the kernels read the rows' low parts: pass xg_lo "
                         "and xl_lo (ref.x_lo, made once a training)")
    _check_shapes({"xg": (xg, torch.float32, (n_g, m)),
                   "xl": (xl, torch.float32, (F, n_l, m)),
                   "xg_lo": (xg_lo, torch.float32, (n_g, m)),
                   "xl_lo": (xl_lo, torch.float32, (F, n_l, m))}, dev)
    if bg < 1 or bl < 1:
        raise ValueError(f"a step takes at least one global and one local "
                         f"row, got {bg} global and {bl} local")
    return F, m, h, n_g, n_l, bg, bl


def train_forward_cuda(w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                       b2: torch.Tensor, xg: torch.Tensor, xl: torch.Tensor,
                       ig: torch.Tensor, il: torch.Tensor, ygz: torch.Tensor,
                       ylz: torch.Tensor, vg: torch.Tensor, vl: torch.Tensor,
                       w_g: float, xg_lo: torch.Tensor,
                       xl_lo: torch.Tensor) -> torch.Tensor:
    """The forward pass of one step on one card → ∂loss/∂pred (F, bg + bl)
    float32, the global rows first."""
    dev = w1.device
    F, m, h, n_g, n_l, bg, bl = _rows(xg, xl, ig, il, w1, dev, xg_lo, xl_lo)
    _check_shapes({"b1": (b1, torch.float32, (F, h)),
                   "w2": (w2, torch.float32, (F, h)),
                   "b2": (b2, torch.float32, (F,)),
                   "ygz": (ygz, torch.float32, (F, n_g)),
                   "ylz": (ylz, torch.float32, (F, n_l)),
                   "vg": (vg, torch.float32, (n_g,)),
                   "vl": (vl, torch.float32, (n_l,))}, dev)
    dpred = torch.empty((F, bg + bl), dtype=torch.float32, device=dev)
    lib = common.load("filter_train", _SIGNATURES)
    err = lib.train_forward(
        *(common.ptr(t) for t in (w1, b1, w2, b2, xg, xl, ig, il, ygz, ylz,
                                  vg, vl, dpred, xg_lo, xl_lo)),
        F, m, h, n_g, n_l, bg, bl, 2 * w_g / (F * bg),
        2 * (1 - w_g) / (F * bl), common.stream_ptr(w1))
    common.check(err, "train_forward")
    LAUNCHES["train_forward"] += 1
    return dpred


def train_backward_sgd_cuda(w1: torch.Tensor, b1: torch.Tensor,
                            w2: torch.Tensor, b2: torch.Tensor,
                            v_w1: torch.Tensor, v_b1: torch.Tensor,
                            v_w2: torch.Tensor, v_b2: torch.Tensor,
                            xg: torch.Tensor, xl: torch.Tensor,
                            ig: torch.Tensor, il: torch.Tensor,
                            dpred: torch.Tensor, lr: float,
                            momentum: float, xg_lo: torch.Tensor,
                            xl_lo: torch.Tensor) -> None:
    """The backward pass and the SGD-with-momentum update of one step on
    one card: w1, b1, w2, b2 and their velocities updated in place."""
    dev = w1.device
    F, m, h, n_g, n_l, bg, bl = _rows(xg, xl, ig, il, w1, dev, xg_lo, xl_lo)
    _check_shapes({"b1": (b1, torch.float32, (F, h)),
                   "w2": (w2, torch.float32, (F, h)),
                   "b2": (b2, torch.float32, (F,)),
                   "v_w1": (v_w1, torch.float32, (F, m, h)),
                   "v_b1": (v_b1, torch.float32, (F, h)),
                   "v_w2": (v_w2, torch.float32, (F, h)),
                   "v_b2": (v_b2, torch.float32, (F,)),
                   "dpred": (dpred, torch.float32, (F, bg + bl))}, dev)
    lib = common.load("filter_train", _SIGNATURES)
    err = lib.train_backward_sgd(
        *(common.ptr(t) for t in (w1, b1, w2, b2, v_w1, v_b1, v_w2, v_b2, xg,
                                  xl, ig, il, dpred, xg_lo, xl_lo)),
        F, m, h, n_l, n_g, bg, bl, lr, momentum, common.stream_ptr(w1))
    common.check(err, "train_backward_sgd")
    LAUNCHES["train_backward_sgd"] += ref.row_tiles(bg, bl)


def kernel_smem() -> dict:
    """Each training kernel's dynamic shared memory a block (bytes), as the
    source sizes it; builds the library."""
    lib = common.load("filter_train", _SIGNATURES)
    out = (ctypes.c_int * 2)()
    common.check(lib.train_smem(out), "train_smem")
    return {"train_forward_kernel": out[0],
            "train_backward_sgd_kernel": out[1]}
