"""The fused filter kernel's two designs against each other, by query count.

``csrc/filter_mlp.cu`` sends calls of up to ``FILTER_MLP_STREAM_MAX_Q``
queries to its weight-streaming design and larger ones to its tensor-core
tile design.  This script builds two scratch copies of that source into
``build/kernels/``, one with the limit at 0 (every call tiled) and one with
it above any Q (every call streamed), and for each weight payload and query
count holds both against the plain version, within ``chip_smoke.py``'s limit
for the fused kernel, and times them with CUDA events: the measurement
behind the limit.  The product library, its wrappers and their launch
counters are not used.

    python -m repro_torch.bench.fused_designs [--out PATH]     # one card
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..core import filters
from ..kernels import common
from ..kernels.filter_mlp import kernel as mlp_kernel
from ..kernels.filter_mlp import ref as mlp_ref
from .filters_bench import _make_stack, _offsets

#: the scratch copies' limits: every call tiled, every call streamed
LIMITS = {"tile": 0, "stream": 1 << 30}
Q_VALUES = (1, 2, 4, 8, 10, 12, 14, 16, 24, 32, 64)
DTYPES = ("float32", "bfloat16", "int8")
#: chip_smoke.py's limit for the fused entries: ATOL + RTOL * max|plain|
ATOL, RTOL = 1e-4, 1e-5


def variant(design: str) -> tuple:
    """(library path, nvcc command) of the scratch copy of
    ``csrc/filter_mlp.cu`` that sends every call to ``design``."""
    limit = LIMITS[design]
    product = common._lib_path("filter_mlp")
    out = product.with_name(f"{product.stem}-{design}.so")
    cmd = [common._nvcc(), *common.NVCC_FLAGS,
           f"-DFILTER_MLP_STREAM_MAX_Q={limit}", "-o", str(out),
           str(common.CSRC / "filter_mlp.cu")]
    return out, cmd


def build_variants() -> Dict[str, ctypes.CDLL]:
    """Both scratch copies, one nvcc each, started together."""
    common.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = []
    for design in LIMITS:
        out, cmd = variant(design)
        running.append((design, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    libs = {}
    for design, out, proc in running:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the {design} copy:\n{log}")
        lib = ctypes.CDLL(str(out))
        for fn, argtypes in mlp_kernel._SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[design] = lib
    return libs


def _call(lib: ctypes.CDLL, queries: torch.Tensor, p: Dict,
          off: torch.Tensor) -> torch.Tensor:
    """One fused call through a scratch copy (inputs as the wrapper takes
    them: contiguous, on one card)."""
    w1 = p["w1"]
    F, m, h = w1.shape
    Q = queries.shape[0]
    out = torch.empty((F, Q), dtype=torch.float32, device=queries.device)
    ptr = common.ptr
    if w1.dtype == torch.int8:
        head = (ptr(queries), ptr(w1), ptr(p["w1_scale"]), ptr(p["b1"]),
                ptr(p["w2"]), ptr(p["w2_scale"]))
    else:
        head = (ptr(queries), ptr(w1), ptr(p["b1"]), ptr(p["w2"]))
    entry = mlp_kernel.ENTRY[w1.dtype]
    err = getattr(lib, entry)(
        *head, ptr(p["b2"]), ptr(p["y_mean"]), ptr(p["y_std"]), ptr(off),
        ptr(out), F, Q, m, h, common.stream_ptr(queries))
    common.check(err, f"{entry} (scratch copy)")
    return out


def _time_ms(fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def crossover(q_values: Sequence[int], stream_ms: Sequence[float],
              tile_ms: Sequence[float]):
    """The largest Q up to which the stream design is never slower, or
    None when it is slower from the first Q."""
    last = None
    for q, s, t in zip(q_values, stream_ms, tile_ms):
        if s > t:
            break
        last = q
    return last


def bench_designs(F: int = 6488, m: int = 256, h: int = 256,
                  q_values: Sequence[int] = Q_VALUES) -> Dict:
    dev = common.resolve_device("cuda")
    libs = build_variants()
    rng = np.random.default_rng(0)
    queries = torch.as_tensor(
        rng.standard_normal((max(q_values), m)).astype(np.float32),
        device=dev)
    p32 = _make_stack(F, m, h, rng, dev)
    off = _offsets(F, rng, dev)
    results: List[Dict] = []
    for dt in DTYPES:
        p = filters.quantize_mlp(p32, dt)
        row = {"weight_dtype": dt, "Q": list(q_values), "stream_ms": [],
               "tile_ms": [], "stream_err": [], "tile_err": [],
               "tolerance": []}
        for n_q in q_values:
            q = queries[:n_q].contiguous()
            want = mlp_ref.filter_predict_destd(
                p["w1"], p["b1"], p["w2"], p["b2"], p["y_mean"],
                p["y_std"], q, off, p.get("w1_scale"), p.get("w2_scale"))
            tol = ATOL + RTOL * want.abs().max().item()
            row["tolerance"].append(tol)
            for design in ("stream", "tile"):
                got = _call(libs[design], q, p, off)
                err = (got - want).abs().max().item()
                assert np.isfinite(err) and err <= tol, (
                    f"{dt} {design} design at Q={n_q}: error {err:.3g} "
                    f"above {tol:.3g}")
                row[f"{design}_err"].append(err)
                row[f"{design}_ms"].append(_time_ms(
                    lambda lib=libs[design], q=q: _call(lib, q, p, off)))
        row["stream_faster_up_to"] = crossover(q_values, row["stream_ms"],
                                               row["tile_ms"])
        results.append(row)
        del p
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        card = torch.cuda.get_device_name(dev) + ", power limit not read"
    return {"config": {"F": F, "m": m, "h": h, "card": card,
                       "stream_max_q": mlp_kernel.STREAM_MAX_Q},
            "results": results}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/bench/fused_designs.json",
                    help="where to write the JSON payload")
    args = ap.parse_args(argv)
    payload = bench_designs()
    print(f"# {payload['config']}")
    for row in payload["results"]:
        print(f"fused_designs/{row['weight_dtype']} (ms; stream / tile): "
              + ", ".join(f"Q={q} {s:.4f} / {t:.4f}" for q, s, t in zip(
                  row["Q"], row["stream_ms"], row["tile_ms"]))
              + f"; stream never slower up to Q = "
              f"{row['stream_faster_up_to']}; max errors stream "
              f"{max(row['stream_err']):.3g}, tile {max(row['tile_err']):.3g}")
    d = os.path.dirname(args.out)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(payload, f, indent=1)
    print(f"# → {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
