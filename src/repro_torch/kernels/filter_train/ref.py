"""Plain PyTorch versions of one filter-training step.

One step trains every filter at once on a minibatch of ``bg`` global rows
(``xg[ig]``, shared by all filters) and ``bl`` local rows (``xl[f, il]``,
each filter's own), standardized targets ``ygz``/``ylz`` and validation
masks ``vg``/``vl`` (a masked row is computed but adds nothing to the
loss), with the loss ``w_g·mean(err_g) + (1 − w_g)·mean(err_l)`` of the
reference (``src/repro/core/filter_training.py:288``; the means run over
F·bg and F·bl elements) and then SGD with momentum, ``v ← μ·v + g``, ``p ←
p − lr·v``, in the order of the reference's ``_sgd_step``.

* :func:`autograd_step` — the step as the port took it before the
  training kernels: autograd of the loss, then the update.  The CPU path
  of ``core.filter_training`` runs it.
* :func:`train_forward` and :func:`train_backward_sgd` — the two
  functions the CUDA kernels compute (``csrc/filter_train.cu``): the
  forward pass's ∂loss/∂pred, then the explicit gradients and the update
  in place.  ``chip_smoke.py`` holds the kernels against them on the card;
  :func:`train_step_manual` is the two together.
* :func:`x_lo` — the rows' low parts, lo = x − trunc(x) (exact), made
  once a training and carried in :class:`TrainInputs` (``xg_lo``,
  ``xl_lo``).  The kernels read the raw rows as the high part (the tensor
  cores drop a float32 operand's 13 low bits, so x_hi = trunc(x)) and lo
  beside them: they split no X element.
* :func:`train_forward_split_tf32` and :func:`train_backward_sgd_split_tf32`
  — the same with the products as the kernels take them on the tensor
  cores (``l2_scan/ref.tensor_core_steps``): x·w1 as three split-TF32
  passes summed over all of m (w1_lo·x_hi, w1_hi·x_lo, w1_hi·x_hi; the
  tensor cores read x and lo with their 13 low bits dropped), and g_w1 as
  w2 ⊙ Σ_r (x·dpred)[r]·M[r] with M the relu mask (exact in TF32): y = x·dpred
  split, y_lo·M and y_hi·M per step, each 80-row half of a ``TILE_ROWS``
  tile summed in two 40-row stages (the stages in float32), the halves
  added, one tile at a time into the velocities.  The tests hold their
  error to the card's limits; no path runs them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from ..filter_mlp import ref as mlp_ref
from ..l2_scan.ref import split_tf32, tensor_core_steps, tf32_truncate

Params = Dict[str, torch.Tensor]

#: the parameters SGD updates (the target statistics stay fixed)
TRAINABLE = ("w1", "b1", "w2", "b2")

#: the training kernels' row tile (``ROWS`` in ``csrc/filter_train.cu``): a
#: step of more rows, a batch above 128, takes its tiles one after another
TILE_ROWS = 160
#: the backward kernel's w1 gradient: each consumer warpgroup's rows of a
#: tile (``WG_ROWS``), in stages of ``GRAD_STAGE`` rows (``GK`` k8 steps)
WG_ROWS = 80
GRAD_STAGE = 40


def row_tiles(bg: int, bl: int) -> int:
    """The row tiles of a step of ``bg`` global and ``bl`` local rows: the
    backward kernel's launches for it."""
    return -(-(bg + bl) // TILE_ROWS)


@dataclasses.dataclass
class TrainInputs:
    """What every step reads besides the parameters and the row indices."""
    xg: torch.Tensor      # (n_g, m) global queries, shared by the filters
    ygz: torch.Tensor     # (F, n_g) standardized targets
    xl: torch.Tensor      # (F, n_l, m) each filter's local queries
    ylz: torch.Tensor     # (F, n_l)
    vg: torch.Tensor      # (n_g,) 1 on validation rows
    vl: torch.Tensor      # (n_l,)
    w_g: float            # n_g / (n_g + n_l)
    #: the rows' low parts (:func:`x_lo`), which the kernels read beside
    #: ``xg`` and ``xl``: same shapes; ``None`` on the CPU path
    xg_lo: Optional[torch.Tensor] = None
    xl_lo: Optional[torch.Tensor] = None


def x_lo(x: torch.Tensor) -> torch.Tensor:
    """x − trunc(x), with trunc(x) = x with its 13 low bits dropped (the
    TF32 value the tensor cores read of x): exact in float32, so trunc(x)
    + lo == x.  Made in its output: no temporary of x's size."""
    x = x.float().contiguous()
    lo = torch.empty_like(x)
    torch.bitwise_and(x.view(torch.int32), ~0x1FFF, out=lo.view(torch.int32))
    return torch.sub(x, lo, out=lo)


def split_inputs(inp: TrainInputs) -> TrainInputs:
    """``inp`` with the rows' low parts made (once a training)."""
    return dataclasses.replace(inp, xg_lo=x_lo(inp.xg), xl_lo=x_lo(inp.xl))


# ---------------------------------------------------------------------------
# autograd (the CPU path)
# ---------------------------------------------------------------------------


def local_predict(tp: Params, x: torch.Tensor) -> torch.Tensor:
    """Each filter on its own query batch: x (F, b, m) → (F, b)."""
    hidden = torch.relu(torch.bmm(x, tp["w1"]) + tp["b1"][:, None, :])
    return torch.bmm(hidden, tp["w2"][:, :, None])[:, :, 0] + tp["b2"][:, None]


def minibatch_loss(tp: Params, inp: TrainInputs, ig: torch.Tensor,
                   il: torch.Tensor) -> torch.Tensor:
    pred_g = mlp_ref.filter_predict(tp["w1"], tp["b1"], tp["w2"], tp["b2"],
                                    inp.xg[ig])                   # (F, bg)
    err_g = (pred_g - inp.ygz[:, ig]) ** 2 * (1 - inp.vg[None, ig])
    pred_l = local_predict(tp, inp.xl[:, il])                     # (F, bl)
    err_l = (pred_l - inp.ylz[:, il]) ** 2 * (1 - inp.vl[None, il])
    return inp.w_g * err_g.mean() + (1 - inp.w_g) * err_l.mean()


def autograd_step(tp: Params, vel: Params, inp: TrainInputs,
                  ig: torch.Tensor, il: torch.Tensor, lr: float,
                  momentum: float) -> None:
    """One step in place: autograd of :func:`minibatch_loss`, then
    ``v ← μ·v + g``, ``p ← p − lr·v`` for each trainable tensor."""
    leaves = {k: tp[k].detach().requires_grad_(True) for k in TRAINABLE}
    minibatch_loss(leaves, inp, ig, il).backward()
    with torch.no_grad():
        for k in TRAINABLE:
            vel[k].mul_(momentum).add_(leaves[k].grad)
            tp[k].sub_(lr * vel[k])


# ---------------------------------------------------------------------------
# what the kernels compute
# ---------------------------------------------------------------------------


def _rows(xg, xl, ig, il) -> torch.Tensor:
    """A step's rows per filter: (F, bg + bl, m), the global rows first."""
    F = xl.shape[0]
    return torch.cat([xg[ig].expand(F, -1, -1), xl[:, il]], dim=1)


def _dpred(pred, ygz, ylz, vg, vl, ig, il, w_g) -> torch.Tensor:
    """∂loss/∂pred: 2·(pred − y)·(1 − mask)·w / count, per row."""
    F, bg, bl = pred.shape[0], ig.shape[0], il.shape[0]
    y = torch.cat([ygz[:, ig], ylz[:, il]], dim=1)
    keep = 1 - torch.cat([vg[ig], vl[il]])
    coef = torch.cat([torch.full((bg,), 2 * w_g / (F * bg)),
                      torch.full((bl,), 2 * (1 - w_g) / (F * bl))]).to(pred)
    return (pred - y) * keep * coef


def train_forward(w1, b1, w2, b2, xg, xl, ig, il, ygz, ylz, vg, vl,
                  w_g: float) -> torch.Tensor:
    """The forward pass of one step → ∂loss/∂pred (F, bg + bl)."""
    pre = torch.bmm(_rows(xg, xl, ig, il), w1) + b1[:, None, :]
    pred = torch.bmm(torch.relu(pre), w2[:, :, None])[:, :, 0] + b2[:, None]
    return _dpred(pred, ygz, ylz, vg, vl, ig, il, w_g)


def _sgd(params, vels, grads, lr: float, momentum: float) -> None:
    with torch.no_grad():
        for p, v, g in zip(params, vels, grads):
            v.mul_(momentum).add_(g)
            p.sub_(lr * v)


def _gradients(x, pre, w2, dpred, gw1_matmul):
    """(g_w1, g_b1, g_w2, g_b2) from the rows, the layer-1 sums and
    ∂loss/∂pred."""
    dpre = dpred[:, :, None] * w2[:, None, :] * (pre > 0)
    g_w2 = (torch.relu(pre) * dpred[:, :, None]).sum(1)
    return (gw1_matmul(x.transpose(1, 2), dpre), dpre.sum(1), g_w2,
            dpred.sum(1))


def train_backward_sgd(w1, b1, w2, b2, v_w1, v_b1, v_w2, v_b2, xg, xl, ig,
                       il, dpred, lr: float, momentum: float) -> None:
    """The backward pass and the update of one step, in place: the
    layer-1 sums recomputed, ``dpre = (dpred ⊗ w2) ⊙ [pre > 0]``, ``g_w1 =
    Xᵀ·dpre``, ``g_b1 = Σ dpre``, ``g_w2 = Hᵀ·dpred``, ``g_b2 = Σ dpred``,
    then SGD with momentum on the four tensors."""
    x = _rows(xg, xl, ig, il)
    pre = torch.bmm(x, w1) + b1[:, None, :]
    grads = _gradients(x, pre, w2, dpred, torch.bmm)
    _sgd((w1, b1, w2, b2), (v_w1, v_b1, v_w2, v_b2), grads, lr, momentum)


def train_step_manual(tp: Params, vel: Params, inp: TrainInputs,
                      ig: torch.Tensor, il: torch.Tensor, lr: float,
                      momentum: float) -> None:
    """:func:`autograd_step` with the explicit gradients the kernels take:
    :func:`train_forward`, then :func:`train_backward_sgd`."""
    dpred = train_forward(tp["w1"], tp["b1"], tp["w2"], tp["b2"], inp.xg,
                          inp.xl, ig, il, inp.ygz, inp.ylz, inp.vg, inp.vl,
                          inp.w_g)
    train_backward_sgd(*(tp[k] for k in TRAINABLE),
                       *(vel[k] for k in TRAINABLE), inp.xg, inp.xl, ig, il,
                       dpred, lr, momentum)


# ---------------------------------------------------------------------------
# the kernels' tensor-core arithmetic, emulated
# ---------------------------------------------------------------------------


def _halves(xg, xl, ig, il, xg_lo, xl_lo) -> tuple:
    """The step's rows' TF32 halves as the kernels' tensor cores read
    them: the raw rows and their lo parts (:func:`x_lo`, made here when not
    given), each with its 13 low bits dropped."""
    xg_lo = x_lo(xg) if xg_lo is None else xg_lo
    xl_lo = x_lo(xl) if xl_lo is None else xl_lo
    return (tf32_truncate(_rows(xg, xl, ig, il)),
            tf32_truncate(_rows(xg_lo, xl_lo, ig, il)))


def _pre_split_tf32(x_hi, x_lo, w1, b1) -> torch.Tensor:
    """Layer 1 as both kernels take it: w1_lo·x_hi, w1_hi·x_lo, w1_hi·x_hi
    per k8 step, all of m into one accumulator."""
    w_hi, w_lo = split_tf32(w1)
    return tensor_core_steps([(x_hi, w_lo), (x_lo, w_hi), (x_hi, w_hi)]) \
        + b1[:, None, :]


def train_forward_split_tf32(w1, b1, w2, b2, xg, xl, ig, il, ygz, ylz, vg,
                             vl, w_g: float, xg_lo=None,
                             xl_lo=None) -> torch.Tensor:
    """:func:`train_forward` with x·w1 as the kernel's split-TF32 steps on
    the rows and their lo parts (made here when not given)."""
    pre = _pre_split_tf32(*_halves(xg, xl, ig, il, xg_lo, xl_lo), w1, b1)
    pred = (torch.relu(pre) * w2[:, None, :]).sum(-1) + b2[:, None]
    return _dpred(pred, ygz, ylz, vg, vl, ig, il, w_g)


def _gw1_split_tf32(x, pre, w2, dpred) -> torch.Tensor:
    """g_w1 of one row tile as the backward kernel takes it: y = x·dpred
    split, y_lo·M and y_hi·M per k8 step (M = [pre > 0], exact in TF32),
    each ``WG_ROWS`` half of the tile (zero rows past its end) summed in
    ``GRAD_STAGE``-row stages and the stages in float32, the halves added
    (rows 0-79 first), then times w2."""
    F, r, m = x.shape
    pad = TILE_ROWS - r
    y = torch.nn.functional.pad(x * dpred[:, :, None], (0, 0, 0, pad))
    mask = torch.nn.functional.pad((pre > 0).float(), (0, 0, 0, pad))
    y_hi, y_lo = split_tf32(y.transpose(1, 2))              # (F, m, rows)
    halves = []
    for h0 in range(0, TILE_ROWS, WG_ROWS):
        part = torch.zeros((F, m, mask.shape[-1]))
        for s0 in range(h0, h0 + WG_ROWS, GRAD_STAGE):
            rs = slice(s0, s0 + GRAD_STAGE)
            part = part + tensor_core_steps([(y_lo[..., rs], mask[:, rs]),
                                             (y_hi[..., rs], mask[:, rs])])
        halves.append(part)
    return w2[:, None, :] * (halves[0] + halves[1])


def train_backward_sgd_split_tf32(w1, b1, w2, b2, v_w1, v_b1, v_w2, v_b2,
                                  xg, xl, ig, il, dpred, lr: float,
                                  momentum: float, xg_lo=None,
                                  xl_lo=None) -> None:
    """:func:`train_backward_sgd` with layer 1 as the kernels' split-TF32
    steps (:func:`train_forward_split_tf32`'s), g_w1 as
    :func:`_gw1_split_tf32`, and the gradients summed into their velocities
    one ``TILE_ROWS``-row tile at a time (``v ← μ·v + g`` of the first tile,
    ``v += g`` of each later one; one tile is :func:`_sgd`)."""
    x = _rows(xg, xl, ig, il)
    pre = _pre_split_tf32(*_halves(xg, xl, ig, il, xg_lo, xl_lo), w1, b1)
    tiles = []
    for r in range(0, x.shape[1], TILE_ROWS):
        rs = slice(r, r + TILE_ROWS)
        _, g_b1, g_w2, g_b2 = _gradients(x[:, rs], pre[:, rs], w2,
                                         dpred[:, rs], torch.bmm)
        tiles.append((_gw1_split_tf32(x[:, rs], pre[:, rs], w2, dpred[:, rs]),
                      g_b1, g_w2, g_b2))
    params, vels = (w1, b1, w2, b2), (v_w1, v_b1, v_w2, v_b2)
    with torch.no_grad():
        for i, grads in enumerate(tiles):
            for v, g in zip(vels, grads):
                (v.mul_(momentum) if i == 0 else v).add_(g)
        for p, v in zip(params, vels):
            p.sub_(lr * v)
