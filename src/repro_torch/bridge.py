"""Carry a LeaFi index built by the JAX reference across to the port.

:func:`leafi_from_arrays` takes the reference index's state as plain numpy
arrays — the ``FlatIndex`` fields and payload, the filter-parameter dict,
``leaf_ids``, the ``AutoTuner`` knots and, optionally, the calibration
split — and returns the port's :class:`~repro_torch.core.build.LeaFiIndex`
on a device.  It imports nothing of the reference: the caller turns the
reference's arrays into numpy (``np.asarray``) first.  Filter weights keep
their payload: float32, int8, or bfloat16 (a numpy extension dtype named
``"bfloat16"``, carried bit for bit).  CNN (``c1``, ``c2``, ``w``, …) and
LSTM (``wi1``, ``wh1``, ``wi2``, ``wh2``, ``w``, …) stacks are carried in
float32, and the config's ``filter_type`` follows their keys.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from .core.build import CalibSplit, LeaFiConfig, LeaFiIndex
from .core.conformal import AutoTuner
from .core.filters import filter_type_of, mlp_weight_dtype
from .core.flat_index import FlatIndex
from .kernels.common import Device, resolve_device


def _tensor(a, device: torch.device, widen: bool = False) -> torch.Tensor:
    """A numpy array as a tensor of its own dtype (``widen``: integers as
    int64, for the index's row offsets and ids)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16" and a.dtype.itemsize == 2:
        return torch.from_numpy(np.array(a.view(np.int16), order="C")).view(
            torch.bfloat16).to(device)
    if widen and a.dtype.kind in "iu":
        a = a.astype(np.int64)
    return torch.from_numpy(np.array(a, order="C")).to(device)


def leafi_from_arrays(index: Mapping, filter_params: Optional[Mapping],
                      leaf_ids, tuner: Optional[Mapping], *,
                      calib: Optional[Mapping] = None,
                      device: Device = None) -> LeaFiIndex:
    """The port's LeaFiIndex from the reference's state as numpy arrays.

    index: ``kind``, ``series``, ``order``, ``leaf_start``, ``leaf_size``,
    ``max_leaf_size``, ``n_series``, ``length`` and ``payload`` (a dict of
    arrays); filter_params: ``w1``, ``b1``, ``w2``, ``b2``, ``y_mean``,
    ``y_std`` and, for int8 weights, ``w1_scale``/``w2_scale`` (or None for
    an index without filters), or a CNN or LSTM stack (``filters.INIT``'s
    keys); tuner: ``knots_q``, ``knots_o``, ``slopes``, ``max_offset`` (or
    None); calib: ``queries``, ``d_lb``, ``d_L`` (or None).  The config's
    backbone, word length or segment count, filter type and weight payload
    follow the arrays.
    """
    dev = resolve_device(device)
    kind = str(index["kind"])
    flat = FlatIndex(
        kind=kind,
        series=_tensor(index["series"], dev),
        order=_tensor(index["order"], dev, widen=True),
        leaf_start=_tensor(index["leaf_start"], dev, widen=True),
        leaf_size=_tensor(index["leaf_size"], dev, widen=True),
        max_leaf_size=int(index["max_leaf_size"]),
        n_series=int(index["n_series"]),
        length=int(index["length"]),
        payload={k: _tensor(v, dev) for k, v in index["payload"].items()})
    config = LeaFiConfig(backbone=kind)
    if kind == "isax":
        config.word_len = int(flat.payload["sax_word"].shape[1])
    else:
        config.n_segments = int(flat.payload["eapca_box"].shape[1])
    params: Optional[Dict[str, torch.Tensor]] = None
    if filter_params is not None:
        params = {k: _tensor(v, dev) for k, v in filter_params.items()}
        config.filter_type = filter_type_of(params)
        if config.filter_type == "mlp":
            config.weight_dtype = mlp_weight_dtype(params)
        else:
            params = {k: v.float() for k, v in params.items()}
    at = None
    if tuner is not None:
        at = AutoTuner(knots_q=np.asarray(tuner["knots_q"]),
                       knots_o=np.asarray(tuner["knots_o"]),
                       slopes=np.asarray(tuner["slopes"]),
                       max_offset=np.asarray(tuner["max_offset"]))
    split = None
    if calib is not None:
        split = CalibSplit(**{f.name: _tensor(calib[f.name], dev)
                              for f in dataclasses.fields(CalibSplit)})
    return LeaFiIndex(index=flat, filter_params=params,
                      leaf_ids=np.asarray(leaf_ids, np.int64), tuner=at,
                      config=config, build_report={}, calib=split)
