"""The LSTM filter kernel's few- and many-query instances against each other.

``csrc/filter_rnn.cu`` sends calls at h = 32 and 64 of up to
``LSTM_FEW_MAX_Q`` queries to its few-query instance (a block per (filter,
query), the weights in registers) and larger ones to its many-query
instance (a block per (filter, 16 queries), the weights read once a step
from shared memory).  This script builds two scratch copies of that source
into ``build/kernels/``, one with the limit at 0 (every call on the
many-query instance) and one with it above any Q (every call on the
few-query one), and for each query count holds both against the plain
version, within ``chip_smoke.py``'s limit for the LSTM (1e-6 x
max|plain|), and times them with CUDA events: the measurement behind the
limit.  The product library, its wrapper and its launch counter are not
used.

    python -m repro_torch.bench.lstm_designs [--out PATH]     # one card
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import subprocess
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..kernels import common
from ..kernels.filter_rnn import kernel as rnn_kernel
from ..kernels.filter_rnn import ref as rnn_ref
from .fused_designs import _time_ms, crossover

#: the scratch copies' limits: every call on the many-query instance, every
#: call on the few-query instance
LIMITS = {"many": 0, "few": 1 << 30}
Q_VALUES = (1, 2, 4, 6, 8, 10, 12, 16, 24, 32)
#: chip_smoke.py's limit for the LSTM: RTOL * max|plain|
RTOL = 1e-6


def variant(design: str) -> tuple:
    """(library path, nvcc command) of the scratch copy of
    ``csrc/filter_rnn.cu`` that sends every h = 32, 64 call to ``design``."""
    product = common._lib_path("filter_rnn")
    out = product.with_name(f"{product.stem}-{design}.so")
    cmd = [common._nvcc(), *common.NVCC_FLAGS,
           f"-DLSTM_FEW_MAX_Q={LIMITS[design]}", "-o", str(out),
           str(common.CSRC / "filter_rnn.cu")]
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
        for fn, argtypes in rnn_kernel._SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[design] = lib
    return libs


def _call(lib: ctypes.CDLL, args) -> torch.Tensor:
    """One call through a scratch copy (h = 32 or 64: no scratch)."""
    q = args[0]
    F, h = args[5].shape
    Q, m = q.shape
    out = torch.empty((F, Q), dtype=torch.float32, device=q.device)
    err = lib.lstm_filter(*(common.ptr(t) for t in args), common.ptr(out),
                          None, F, Q, m, h, common.stream_ptr(q))
    common.check(err, "lstm_filter (scratch copy)")
    return out


def make_stack(F: int, m: int, h: int, n_q: int, seed: int = 0) -> tuple:
    """Queries and an LSTM stack at the reference's init scale (numpy
    seed), with random biases and target statistics."""
    dev = common.resolve_device("cuda")
    rng = np.random.default_rng(seed)

    def randn(*shape, scale=1.0):
        return torch.as_tensor((rng.standard_normal(shape) * scale).astype(
            np.float32), device=dev)
    s = math.sqrt(1 / h)
    return (randn(n_q, m), randn(F, 1, 4 * h, scale=s),
            randn(F, h, 4 * h, scale=s), randn(F, h, 4 * h, scale=s),
            randn(F, h, 4 * h, scale=s), randn(F, h, scale=s), randn(F),
            randn(F) + 10.0,
            torch.as_tensor(rng.uniform(0.5, 2.0, F).astype(np.float32),
                            device=dev))


def bench_designs(F: int = 4096, m: int = 256, h: int = 64,
                  q_values: Sequence[int] = Q_VALUES) -> Dict:
    libs = build_variants()
    stack = make_stack(F, m, h, max(q_values))
    row: Dict[str, List] = {"Q": list(q_values), "few_ms": [],
                            "many_ms": [], "few_err": [], "many_err": [],
                            "tolerance": []}
    for n_q in q_values:
        args = (stack[0][:n_q].contiguous(),) + stack[1:]
        want = rnn_ref.lstm_filter(*args)
        tol = RTOL * want.abs().max().item()
        row["tolerance"].append(tol)
        for design in ("few", "many"):
            got = _call(libs[design], args)
            err = (got - want).abs().max().item()
            assert np.isfinite(err) and err <= tol, (
                f"{design} instance at Q={n_q}: error {err:.3g} above "
                f"{tol:.3g}")
            row[f"{design}_err"].append(err)
            row[f"{design}_ms"].append(_time_ms(
                lambda lib=libs[design], a=args: _call(lib, a), reps=5))
    row["few_faster_up_to"] = crossover(q_values, row["few_ms"],
                                        row["many_ms"])
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        card = torch.cuda.get_device_name(0) + ", power limit not read"
    return {"config": {"F": F, "m": m, "h": h, "card": card,
                       "few_max_q": rnn_kernel.FEW_MAX_Q}, "results": row}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/bench/lstm_designs.json",
                    help="where to write the JSON payload")
    args = ap.parse_args(argv)
    payload = bench_designs()
    row = payload["results"]
    print(f"# {payload['config']}")
    print("lstm_designs (ms; few / many): " + ", ".join(
        f"Q={q} {a:.4f} / {b:.4f}" for q, a, b in zip(
            row["Q"], row["few_ms"], row["many_ms"]))
        + f"; few never slower up to Q = {row['few_faster_up_to']}; max "
        f"errors few {max(row['few_err']):.3g}, many "
        f"{max(row['many_err']):.3g}")
    d = os.path.dirname(args.out)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(payload, f, indent=1)
    print(f"# → {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
