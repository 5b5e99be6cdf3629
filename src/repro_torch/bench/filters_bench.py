"""Filter-inference kernel suite: the per-filter sweep against the fused
kernel (port of ``benchmarks/filters_bench.py``).

Sweeps filter count × weight payload × implementation on one (Q, m, h)
shape and pins each time against the analytic three-term bound
(:func:`repro_torch.analysis.roofline.filter_mlp_roofline`, H100 by
default).  The per-filter case is the raw ``filter_mlp`` kernel followed by
the three broadcast passes (y_std, y_mean, offsets) as plain torch; the
fused cases run the fused kernel's float32, bfloat16 and int8 variants.
Before timing, every path is held against the dequantized plain version at
the smallest filter count.  :func:`timed` reads CUDA events around ``repeat``
calls after a warm-up call on the card, so it measures the device's time
for the enqueued work; on the CPU (the tests) it reads the host clock, and
that number is the CPU's.

    python -m repro_torch.bench.filters_bench [--out PATH]     # one card
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from ..analysis import roofline
from ..core import filters
from ..kernels.common import Device, resolve_device
from ..kernels.filter_mlp import ops as mlp_ops
from ..kernels.filter_mlp import ref as mlp_ref

F_VALUES = (64, 256, 1024, 4096)
DTYPES = ("float32", "bfloat16", "int8")


def timed(fn: Callable[[], torch.Tensor], device: torch.device,
          repeat: int = 5) -> Tuple[torch.Tensor, float]:
    """(last output, seconds per call) of ``fn`` after one warm-up call."""
    out = fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(repeat):
            out = fn()
        return out, (time.perf_counter() - t0) / repeat
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeat):
        out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end) / 1e3 / repeat


def _make_stack(F: int, m: int, h: int, rng, device) -> Dict[str, torch.Tensor]:
    """The reference suite's draws, in its order, as float32 tensors."""
    draws = {
        "w1": rng.standard_normal((F, m, h)) * 0.2,
        "b1": rng.standard_normal((F, h)) * 0.1,
        "w2": rng.standard_normal((F, h)) * 0.2,
        "b2": rng.standard_normal((F,)),
        "y_mean": rng.standard_normal((F,)),
        "y_std": np.abs(rng.standard_normal((F,))) + 0.5,
    }
    return {k: torch.as_tensor(v.astype(np.float32), device=device)
            for k, v in draws.items()}


def _offsets(F: int, rng, device) -> torch.Tensor:
    return torch.as_tensor(
        np.abs(rng.standard_normal((F,))).astype(np.float32), device=device)


def _per_filter_call(p, queries, off):
    """The per-filter kernel and three broadcast passes."""
    z = mlp_ops.filter_predict(p["w1"], p["b1"], p["w2"], p["b2"], queries)
    return z * p["y_std"][:, None] + p["y_mean"][:, None] - off[:, None]


def _fused_call(p, queries, off):
    return mlp_ops.filter_predict_fused(
        p["w1"], p["b1"], p["w2"], p["b2"], p["y_mean"], p["y_std"],
        queries, off, p.get("w1_scale"), p.get("w2_scale"))


def _max_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max())


def bench_filters(f_values=F_VALUES, q: int = 128, m: int = 128,
                  h: int = 128, *, device: Device = None
                  ) -> Tuple[List[str], Dict]:
    """CSV rows and the JSON payload (the reference's keys: ``config``,
    ``parity_max_abs_err``, ``results``, ``fused_speedup_f32``)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    queries = torch.as_tensor(rng.standard_normal((q, m)).astype(np.float32),
                              device=dev)
    rows: List[str] = []
    results: List[Dict] = []

    # parity at the smallest size: every timed path against the dequantized
    # plain version
    F0 = int(f_values[0])
    p0 = _make_stack(F0, m, h, rng, dev)
    off0 = _offsets(F0, rng, dev)
    parity = {}
    for dt in DTYPES:
        pq = filters.quantize_mlp(p0, dt)
        want = mlp_ref.filter_predict_destd(
            pq["w1"], pq["b1"], pq["w2"], pq["b2"], pq["y_mean"],
            pq["y_std"], queries, off0, pq.get("w1_scale"),
            pq.get("w2_scale"))
        parity[f"fused_{dt}"] = _max_err(_fused_call(pq, queries, off0),
                                         want)
    parity["per_filter_float32"] = _max_err(
        _per_filter_call(p0, queries, off0),
        mlp_ref.filter_predict_destd(
            p0["w1"], p0["b1"], p0["w2"], p0["b2"], p0["y_mean"],
            p0["y_std"], queries, off0))
    del p0

    for F in f_values:
        F = int(F)
        p = _make_stack(F, m, h, rng, dev)
        off = _offsets(F, rng, dev)
        cases = [("per_filter", "float32",
                  lambda p=p: _per_filter_call(p, queries, off))]
        for dt in DTYPES:
            pq = filters.quantize_mlp(p, dt)
            cases.append(("fused", dt,
                          lambda pq=pq: _fused_call(pq, queries, off)))
        for impl, dt, fn in cases:
            _, sec = timed(fn, dev)
            rl = roofline.filter_mlp_roofline(F, q, m, h, variant=impl,
                                              weight_dtype=dt)
            rows.append(f"filters/{impl}/{dt}/F{F},{sec * 1e6:.1f},"
                        f"bound_us={rl.bound_time * 1e6:.1f}")
            results.append({
                "F": F, "Q": q, "m": m, "h": h, "impl": impl,
                "weight_dtype": dt, "device": str(dev),
                "us_per_call": sec * 1e6, "roofline": rl.as_dict(),
            })
        del p, cases

    summary = {}
    for F in f_values:
        F = int(F)
        pf = next(r for r in results
                  if r["F"] == F and r["impl"] == "per_filter")
        fu = next(r for r in results if r["F"] == F and r["impl"] == "fused"
                  and r["weight_dtype"] == "float32")
        summary[str(F)] = {
            "measured_speedup": pf["us_per_call"] / fu["us_per_call"],
            "bound_speedup": (pf["roofline"]["bound_time"]
                              / fu["roofline"]["bound_time"]),
        }
    payload = {
        "config": {"f_values": [int(F) for F in f_values], "Q": q, "m": m,
                   "h": h, "bq": roofline.BQ, "bf": roofline.BF,
                   "hw": roofline.H100.name,
                   "device": (torch.cuda.get_device_name(dev)
                              if dev.type == "cuda" else str(dev))},
        "parity_max_abs_err": parity,
        "results": results,
        "fused_speedup_f32": summary,
    }
    return rows, payload


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/bench/filters_bench.json",
                    help="where to write the JSON payload")
    args = ap.parse_args(argv)
    rows, payload = bench_filters()
    for r in rows:
        print(r)
    d = os.path.dirname(args.out)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(payload, f, indent=1, default=float)
    print(f"# → {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
