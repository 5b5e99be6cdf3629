"""Carry a LeaFi index built by the JAX reference across to the port.

:func:`leafi_from_arrays` takes the reference index's state as plain numpy
arrays — the ``FlatIndex`` fields and payload, the filter-parameter dict,
``leaf_ids`` and the ``AutoTuner`` knots — and returns the port's
:class:`~repro_torch.core.build.LeaFiIndex` on a device.  It imports
nothing of the reference: the caller turns the reference's arrays into
numpy (``np.asarray``) first.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from .core.build import LeaFiConfig, LeaFiIndex
from .core.conformal import AutoTuner
from .core.flat_index import FlatIndex
from .kernels.common import Device, resolve_device


def _tensor(a, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.kind in "iu":
        a = a.astype(np.int64)
    elif a.dtype != np.float32:
        raise NotImplementedError(
            f"{a.dtype} arrays: the port carries float32 payloads only "
            "(bf16/int8 filter weights are ROADMAP queue B row 1b)")
    return torch.from_numpy(np.array(a, order="C")).to(device)


def leafi_from_arrays(index: Mapping, filter_params: Optional[Mapping],
                      leaf_ids, tuner: Optional[Mapping], *,
                      device: Device = None) -> LeaFiIndex:
    """The port's LeaFiIndex from the reference's state as numpy arrays.

    index: ``kind``, ``series``, ``order``, ``leaf_start``, ``leaf_size``,
    ``max_leaf_size``, ``n_series``, ``length`` and ``payload`` (a dict of
    arrays); filter_params: ``w1``, ``b1``, ``w2``, ``b2``, ``y_mean``,
    ``y_std`` (or None for an index without filters); tuner: ``knots_q``,
    ``knots_o``, ``slopes``, ``max_offset`` (or None).
    """
    dev = resolve_device(device)
    flat = FlatIndex(
        kind=str(index["kind"]),
        series=_tensor(index["series"], dev),
        order=_tensor(index["order"], dev),
        leaf_start=_tensor(index["leaf_start"], dev),
        leaf_size=_tensor(index["leaf_size"], dev),
        max_leaf_size=int(index["max_leaf_size"]),
        n_series=int(index["n_series"]),
        length=int(index["length"]),
        payload={k: _tensor(v, dev) for k, v in index["payload"].items()})
    params: Optional[Dict[str, torch.Tensor]] = None
    if filter_params is not None:
        params = {k: _tensor(v, dev) for k, v in filter_params.items()}
    at = None
    if tuner is not None:
        at = AutoTuner(knots_q=np.asarray(tuner["knots_q"]),
                       knots_o=np.asarray(tuner["knots_o"]),
                       slopes=np.asarray(tuner["slopes"]),
                       max_offset=np.asarray(tuner["max_offset"]))
    return LeaFiIndex(index=flat, filter_params=params,
                      leaf_ids=np.asarray(leaf_ids, np.int64), tuner=at,
                      config=LeaFiConfig(), build_report={})
