"""LeaFi-enhanced index building, paper Alg. 1 (port of
``repro.core.build``: DSTree and iSAX backbones, MLP filters with float32,
bfloat16 or int8 weight payloads; an index's search also takes CNN or LSTM
filters trained elsewhere, ``LeaFiConfig.filter_type``).

    1. build the backbone tree on the host, move it to the card  [tree.py]
    2. select leaves for filter insertion                        [selection.py]
    3. generate global + local training data, collect targets    [filter_training.py]
    4. train all filters (batched SGD)                           [filter_training.py]
    5. fit conformal auto-tuners on the calibration split        [conformal.py]

Steps 3 and 5 run the pairwise, slab, box lower-bound and fused filter
kernels on the card.  ``build_report`` keeps each phase's wall time (host
clock around a device synchronize).  :func:`requantize_leafi` swaps a built
index's weight payload and refits the tuners on the stored calibration
split.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch

from . import conformal, filter_training, filters, search, selection, tree
from .flat_index import FlatIndex
from ..kernels.common import Device, resolve_device


@dataclasses.dataclass
class LeaFiConfig:
    backbone: str = "dstree"          # "dstree" | "isax"
    leaf_capacity: int = 256
    n_segments: int = 8               # dstree EAPCA segments
    word_len: int = 8                 # isax word length
    # training data sizes; the paper uses n_q = 2000 with n_g/n_l = 3
    n_global: int = 600
    n_local: int = 200
    calib_fraction: float = 0.3       # calibration split of the global set
    # selection (Alg. 3); t_F/t_S default from the paper's Deep measurement
    a: float = 2.0
    t_filter_over_t_series: float = 279.0
    filter_memory_budget_bytes: int = 6 << 30
    hidden: Optional[int] = None
    # weight payload for inference: "float32" | "bfloat16" | "int8" (the
    # fused filter kernel's three variants)
    weight_dtype: str = "float32"
    # filter backbone search applies: "mlp" | "cnn" | "rnn"; the build
    # trains MLPs only
    filter_type: str = "mlp"
    train: filter_training.TrainConfig = dataclasses.field(
        default_factory=filter_training.TrainConfig)
    seed: int = 0


@dataclasses.dataclass
class CalibSplit:
    """The conformal calibration split (queries and replay inputs)."""
    queries: torch.Tensor             # (n_cal, m)
    d_lb: torch.Tensor                # (n_cal, L) summarization lower bounds
    d_L: torch.Tensor                 # (n_cal, L) node-wise NN distances


@dataclasses.dataclass
class LeaFiIndex:
    index: FlatIndex
    filter_params: Optional[Dict[str, torch.Tensor]]
    leaf_ids: np.ndarray                      # leaves carrying filters
    tuner: Optional[conformal.AutoTuner]
    config: LeaFiConfig
    build_report: Dict[str, float]
    calib: Optional[CalibSplit] = None

    def search(self, queries, k: int = 1,
               quality_target: Optional[float] = 0.99,
               use_filters: bool = True, device: Device = None,
               **kw) -> search.SearchResult:
        """quality_target=None or use_filters=False ⇒ exact search.
        ``device=None`` means the card; the index must live there.  The
        filter type is the config's unless ``kw`` names one."""
        kw.setdefault("filter_type", self.config.filter_type)
        return search.search_batched(
            self.index, queries, k=k, filter_params=self.filter_params,
            leaf_ids=self.leaf_ids, tuner=self.tuner,
            quality_target=quality_target,
            use_filters=use_filters and quality_target is not None,
            device=device, **kw)

    def search_exact(self, queries, k: int = 1, device: Device = None,
                     **kw) -> search.SearchResult:
        return self.search(queries, k=k, use_filters=False,
                           quality_target=None, device=device, **kw)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def build_leafi(series: np.ndarray, config: LeaFiConfig = LeaFiConfig(), *,
                device: Device = None) -> LeaFiIndex:
    """Alg. 1: LeaFi-enhanced index building, on the card unless
    ``device="cpu"``.  Random draws come from a generator seeded with
    ``config.seed`` on the build device."""
    if config.filter_type != "mlp":
        raise NotImplementedError(
            "build-side filter training is MLP-only (the paper's default); "
            "the CNN and LSTM backbones are reachable from search "
            "(filters.APPLY) with parameters trained elsewhere")
    dev = resolve_device(device)
    if config.backbone not in ("dstree", "isax"):
        raise ValueError(f"unknown backbone {config.backbone!r}")
    if config.weight_dtype not in filters.WEIGHT_BYTES_PER_EL:
        raise ValueError(f"unknown weight_dtype {config.weight_dtype!r}")
    generator = torch.Generator(device=dev).manual_seed(config.seed)
    report: Dict[str, float] = {}

    # 0. backbone index (host), moved to the device
    t0 = time.perf_counter()
    if config.backbone == "dstree":
        index = tree.build_dstree(series, config.leaf_capacity,
                                  config.n_segments)
    else:
        index = tree.build_isax(series, config.leaf_capacity,
                                config.word_len)
    index = index.to(dev)
    _sync(dev)
    report["t_index_build"] = time.perf_counter() - t0

    # 1. SelectLeafNode (Alg. 3)
    hidden = config.hidden or index.length
    fbytes = filters.mlp_param_bytes(index.length, hidden,
                                     config.weight_dtype)
    leaf_ids = selection.select_leaves(
        index.leaf_size.cpu().numpy(),
        t_filter=config.t_filter_over_t_series, t_series=1.0, a=config.a,
        filter_bytes=fbytes,
        memory_budget_bytes=config.filter_memory_budget_bytes)
    report["n_filters"] = float(len(leaf_ids))
    report["n_leaves"] = float(index.n_leaves)
    if len(leaf_ids) == 0:
        return LeaFiIndex(index, None, leaf_ids, None, config, report)

    # 2-3. training data (global + local, two-pass collection)
    t0 = time.perf_counter()
    data = filter_training.collect_training_data(
        index, leaf_ids, config.n_global, config.n_local, generator)
    _sync(dev)
    report["t_collect"] = time.perf_counter() - t0

    # 4. TrainFilters on the proper-training split
    n_cal = max(int(config.n_global * config.calib_fraction), 8)
    train_data = dataclasses.replace(
        data, global_queries=data.global_queries[:-n_cal],
        global_d_L=data.global_d_L[:-n_cal],
        global_d_lb=data.global_d_lb[:-n_cal])
    t0 = time.perf_counter()
    cfg_train = dataclasses.replace(config.train, hidden=config.hidden)
    params, train_report = filter_training.train_filters(
        index, train_data, cfg_train, generator)
    _sync(dev)
    report["t_train"] = time.perf_counter() - t0
    report["val_rmse_z"] = float(train_report["val_rmse_z"].mean())

    # 4b. weight payload — before calibration, so the offsets are fit on
    # the predictions search will see
    params = filters.quantize_mlp(params, config.weight_dtype)

    # 5. FitAutoTuners on the calibration split (Alg. 4)
    t0 = time.perf_counter()
    calib = CalibSplit(queries=data.global_queries[-n_cal:],
                       d_lb=data.global_d_lb[-n_cal:],
                       d_L=data.global_d_L[-n_cal:])
    d_pred_cal = search.predictions_for_all_leaves(
        index, params, leaf_ids, calib.queries, offsets=None)
    tuner, cal_report = conformal.fit_autotuners(
        calib.d_lb, d_pred_cal, calib.d_L, leaf_ids)
    _sync(dev)
    report["t_calibrate"] = time.perf_counter() - t0
    report["calib_best_quality"] = float(cal_report["rank_quality"].max())
    return LeaFiIndex(index, params, leaf_ids, tuner, config, report, calib)


def requantize_leafi(lfi: LeaFiIndex, weight_dtype: str, *,
                     device: Device = None) -> LeaFiIndex:
    """The same index with its filter weights in another payload dtype and
    its tuners refit on the stored calibration split, so the offsets absorb
    the quantization error.  The backbone tensors are shared, not copied.
    ``device=None`` means the card; the index must live there."""
    dev = resolve_device(device)
    if lfi.index.device != dev:
        raise ValueError(f"the index lives on {lfi.index.device}, the "
                         f"requantization was asked to run on {dev}")
    cfg = dataclasses.replace(lfi.config, weight_dtype=weight_dtype)
    if lfi.filter_params is None:
        return dataclasses.replace(lfi, config=cfg)
    if lfi.calib is None:
        raise ValueError("the index carries no calibration split: rebuild "
                         "it with build_leafi to requantize it")
    params = filters.quantize_mlp(lfi.filter_params, weight_dtype)
    d_pred = search.predictions_for_all_leaves(
        lfi.index, params, lfi.leaf_ids, lfi.calib.queries, offsets=None,
        filter_type=lfi.config.filter_type)
    tuner, _ = conformal.fit_autotuners(lfi.calib.d_lb, d_pred,
                                        lfi.calib.d_L, lfi.leaf_ids)
    return dataclasses.replace(lfi, filter_params=params, tuner=tuner,
                               config=cfg)
