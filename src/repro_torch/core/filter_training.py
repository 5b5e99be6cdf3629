"""Training-data generation (paper §4.3) and batched filter training (port
of ``repro.core.filter_training``).

Two-fold query generation — *global* queries (noisy samples of the whole
collection, searched against every leaf) and *local* queries (noisy samples
of each selected leaf, searched against their own leaf only) — with both
target passes on the engine's leaf-slab sweeps.  Training runs every filter
at once: parameters are stacked on a leading F axis and one SGD-with-
momentum step updates them all (the reference vmaps its step).  On the card
a step is two hand-written kernels (``csrc/filter_train.cu``) and the
validation pass the ``filter_mlp`` kernel; on the CPU a step is autograd of
the reference's loss.

Random draws come from a ``torch.Generator``.  The functions also take
pre-drawn inputs (queries, initial parameters, per-step minibatch indices),
so a test can feed them the reference's draws.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import bounds as bounds_mod
from . import engine, filters, summaries
from .flat_index import FlatIndex
from ..kernels.common import on_cpu
from ..kernels.filter_train import kernel as train_kernel
from ..kernels.filter_train import ref as train_ref


# ---------------------------------------------------------------------------
# Query generation (paper §5.1 protocol: uniform samples + gaussian noise)
# ---------------------------------------------------------------------------


def make_noisy_queries(series: torch.Tensor, n_queries: int,
                       generator: torch.Generator, noise_low: float = 0.1,
                       noise_high: float = 0.4) -> torch.Tensor:
    """Sample series uniformly, add N(0, noise²) with noise ~ U[low, high],
    z-normalize → (n_queries, m)."""
    n, m = series.shape
    dev = series.device
    idx = torch.randint(0, n, (n_queries,), generator=generator, device=dev)
    lvl = noise_low + (noise_high - noise_low) * torch.rand(
        (n_queries, 1), generator=generator, device=dev)
    noise = torch.randn((n_queries, m), generator=generator, device=dev)
    return summaries.znormalize(series[idx] + lvl * noise)


def make_local_queries(index: FlatIndex, leaf_ids: torch.Tensor,
                       n_per_leaf: int, generator: torch.Generator,
                       noise_low: float = 0.1,
                       noise_high: float = 0.4) -> torch.Tensor:
    """(F, n_per_leaf, m) noisy samples drawn from each selected leaf."""
    F = leaf_ids.shape[0]
    dev = index.device
    sizes = index.leaf_size[leaf_ids]
    u = torch.rand((F, n_per_leaf), generator=generator, device=dev)
    rows = torch.minimum((u * sizes[:, None]).long(), sizes[:, None] - 1)
    rows = rows + index.leaf_start[leaf_ids][:, None]
    lvl = noise_low + (noise_high - noise_low) * torch.rand(
        (F, n_per_leaf, 1), generator=generator, device=dev)
    noise = torch.randn((F, n_per_leaf, index.length), generator=generator,
                        device=dev)
    return summaries.znormalize(index.series[rows] + lvl * noise)


# ---------------------------------------------------------------------------
# Target collection ("two-pass" search, array form)
# ---------------------------------------------------------------------------


def nodewise_nn_distances(index: FlatIndex, queries: torch.Tensor,
                          dist_impl: Optional[str] = None) -> torch.Tensor:
    """d_L for every (query, leaf): (Q, L)."""
    return engine.nn_distance_all_leaves(
        index.series, index.leaf_start, index.leaf_size,
        torch.atleast_2d(queries), max_leaf=index.max_leaf_size,
        dist_impl=dist_impl)


def local_nn_distances(index: FlatIndex, local_queries: torch.Tensor,
                       leaf_ids: torch.Tensor,
                       dist_impl: Optional[str] = None) -> torch.Tensor:
    """d_L of each local query against its own leaf only: (F, n_loc)."""
    return engine.nn_distance_own_leaf(
        index.series, index.leaf_start, index.leaf_size, local_queries,
        leaf_ids, max_leaf=index.max_leaf_size, dist_impl=dist_impl)


@dataclasses.dataclass
class TrainingData:
    """Everything Alg. 1 collects before filter training (on the device)."""
    global_queries: torch.Tensor      # (n_g, m)
    global_d_L: torch.Tensor          # (n_g, L)  node-wise NN distances
    global_d_lb: torch.Tensor         # (n_g, L)  summarization lower bounds
    local_queries: torch.Tensor       # (F, n_l, m)
    local_d_L: torch.Tensor           # (F, n_l)
    leaf_ids: np.ndarray              # (F,) leaves with filters


def collect_training_data(index: FlatIndex, leaf_ids: np.ndarray,
                          n_global: int, n_local: int,
                          generator: Optional[torch.Generator] = None, *,
                          noise_low: float = 0.1, noise_high: float = 0.4,
                          dist_impl: Optional[str] = None,
                          global_queries: Optional[torch.Tensor] = None,
                          local_queries: Optional[torch.Tensor] = None
                          ) -> TrainingData:
    """Alg. 1 steps 2–3.  ``global_queries`` / ``local_queries`` replace the
    generator's draws when given."""
    dev = index.device
    ids = torch.as_tensor(np.asarray(leaf_ids), device=dev)
    gq = (make_noisy_queries(index.series[: index.n_series], n_global,
                             generator, noise_low, noise_high)
          if global_queries is None else global_queries.to(dev))
    d_L = nodewise_nn_distances(index, gq, dist_impl)
    d_lb = bounds_mod.lower_bounds(index, gq)
    lq = (make_local_queries(index, ids, n_local, generator, noise_low,
                             noise_high)
          if local_queries is None else local_queries.to(dev))
    ld = local_nn_distances(index, lq, ids, dist_impl)
    return TrainingData(gq, d_L, d_lb, lq, ld, np.asarray(leaf_ids))


# ---------------------------------------------------------------------------
# batched SGD training
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    epochs: int = 300
    batch: int = 128
    lr: float = 1e-2
    momentum: float = 0.9
    val_fraction: float = 0.2          # paper: train/val split 4:1
    hidden: int | None = None
    seed: int = 0


def sgd_step(tp: Dict[str, torch.Tensor], vel: Dict[str, torch.Tensor],
             inp: train_ref.TrainInputs, ig: torch.Tensor, il: torch.Tensor,
             lr: float, momentum: float) -> None:
    """One SGD-with-momentum step of every filter, in place.  For CPU
    tensors autograd of the reference's loss (``filter_train/ref.py``);
    for CUDA tensors the two training kernels: ``train_forward`` (the
    forward pass → ∂loss/∂pred), then ``train_backward_sgd`` (gradients
    and update in one pass, parameters and velocities in place), which
    read the rows' low parts ``inp`` carries (``train_ref.split_inputs``,
    once a training) beside the rows."""
    if on_cpu(tp["w1"]):
        train_ref.autograd_step(tp, vel, inp, ig, il, lr, momentum)
        return
    params = [tp[k] for k in train_ref.TRAINABLE]
    dpred = train_kernel.train_forward_cuda(
        *params, inp.xg, inp.xl, ig, il, inp.ygz, inp.ylz, inp.vg, inp.vl,
        inp.w_g, inp.xg_lo, inp.xl_lo)
    train_kernel.train_backward_sgd_cuda(
        *params, *(vel[k] for k in train_ref.TRAINABLE), inp.xg, inp.xl, ig,
        il, dpred, lr, momentum, inp.xg_lo, inp.xl_lo)


def _val_loss(tp, inp: train_ref.TrainInputs) -> torch.Tensor:
    pred_g = filters.apply_mlp_raw(tp, inp.xg)
    err = ((pred_g - inp.ygz) ** 2 * inp.vg[None, :]).sum(dim=1)
    return err / torch.clamp_min(inp.vg.sum(), 1)                # (F,)


def train_filters(index: FlatIndex, data: TrainingData,
                  cfg: TrainConfig = TrainConfig(),
                  generator: Optional[torch.Generator] = None, *,
                  init_params: Optional[Dict[str, torch.Tensor]] = None,
                  batch_indices: Optional[Tuple[torch.Tensor,
                                                torch.Tensor]] = None
                  ) -> Tuple[Dict[str, torch.Tensor], Dict[str, np.ndarray]]:
    """Train one MLP filter per selected leaf; returns (params, report).

    Mirrors the reference step for step: per-filter target standardization,
    SGD with momentum (v ← μv + g, p ← p − lr·v; :func:`sgd_step`), lr /10
    at 60% and 85% of the steps, a validation pass every ``n_steps // 20``
    steps keeping each filter's best parameters.  ``init_params`` and
    ``batch_indices`` ((n_steps, batch) global and (n_steps, batch // 4)
    local row indices) replace the generator's draws when given.
    """
    dev = index.device
    F = len(data.leaf_ids)
    params = (filters.init_mlp(F, index.length, cfg.hidden,
                               generator=generator, device=dev)
              if init_params is None
              else {k: v.to(dev) for k, v in init_params.items()})

    ids = torch.as_tensor(np.asarray(data.leaf_ids), device=dev)
    yg = data.global_d_L[:, ids].T                              # (F, n_g)
    yl = data.local_d_L                                         # (F, n_l)
    # per-filter target standardization over the filter's own target mix
    y_all = torch.cat([yg, yl], dim=1)
    y_mean = y_all.mean(dim=1)
    centered = y_all - y_mean[:, None]
    y_std = torch.sqrt((centered * centered).mean(dim=1)) + 1e-6
    params["y_mean"], params["y_std"] = y_mean, y_std
    ygz = (yg - y_mean[:, None]) / y_std[:, None]
    ylz = (yl - y_mean[:, None]) / y_std[:, None]

    n_g, n_l = yg.shape[1], yl.shape[1]
    rng = np.random.default_rng(cfg.seed)
    vg = np.zeros(n_g, np.float32)
    vg[rng.choice(n_g, int(n_g * cfg.val_fraction), replace=False)] = 1
    vl = np.zeros(n_l, np.float32)
    vl[rng.choice(n_l, max(int(n_l * cfg.val_fraction), 1), replace=False)] = 1
    vg, vl = torch.from_numpy(vg).to(dev), torch.from_numpy(vl).to(dev)

    n_steps = cfg.epochs * max((n_g + n_l) // cfg.batch, 1)
    w_g = n_g / (n_g + n_l)
    if batch_indices is None:
        ig_all = torch.randint(0, n_g, (n_steps, cfg.batch),
                               generator=generator, device=dev)
        il_all = torch.randint(0, n_l, (n_steps, max(cfg.batch // 4, 1)),
                               generator=generator, device=dev)
    else:
        ig_all, il_all = (t.to(dev).contiguous() for t in batch_indices)

    inp = train_ref.TrainInputs(
        data.global_queries.contiguous(), ygz.contiguous(),
        data.local_queries.contiguous(), ylz.contiguous(), vg, vl, w_g)
    if not on_cpu(inp.xg):
        # the rows' low parts the kernels read, once; freed with ``inp``
        inp = train_ref.split_inputs(inp)
    tp = {k: params[k].detach().clone() for k in train_ref.TRAINABLE}
    vel = {k: torch.zeros_like(tp[k]) for k in train_ref.TRAINABLE}
    best = {k: params[k].detach().clone() for k in train_ref.TRAINABLE}
    best_val = torch.full((F,), float("inf"), device=dev)
    eval_every = max(n_steps // 20, 1)

    for i in range(n_steps):
        lr = cfg.lr * (1.0 if i < 0.6 * n_steps
                       else 0.1 if i < 0.85 * n_steps else 0.01)
        # the step's rows are views of the drawn index tensors: no launch
        sgd_step(tp, vel, inp, ig_all[i], il_all[i], lr, cfg.momentum)
        if i % eval_every == 0:
            val = _val_loss(tp, inp)
            improved = val < best_val
            for k in train_ref.TRAINABLE:
                keep = improved.reshape((F,) + (1,) * (tp[k].dim() - 1))
                best[k] = torch.where(keep, tp[k], best[k])
            best_val = torch.minimum(val, best_val)

    params.update(best)
    report = {"val_rmse_z": torch.sqrt(best_val).cpu().numpy()}
    return params, report
