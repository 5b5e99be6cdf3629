"""The CNN and LSTM filter kernels of this tree beside another tree's, in
turns on one card.

Builds ``csrc/filter_cnn.cu`` and ``csrc/filter_rnn.cu`` of this tree (the
product library) and of another source directory (``--other``, e.g. the
``csrc`` of an older checkout unpacked with ``git archive``) into
``build/kernels/``, then at the main path's shapes (the calibration call,
F = 4096 filters x 180 queries, and ``search_early``'s single query; m =
256, channels 256 and ksize 3, hidden 64; random stacks at the reference's
init scales, numpy seed 0) holds every library against the plain version
within ``chip_smoke.py``'s limits and times it from a CUDA graph in the
order other, this, this, other.  Both sources must keep the C entries
``cnn_filter`` and ``lstm_filter``.  The wrappers and their launch
counters are not used.

    python -m repro_torch.bench.backbone_sources --other PATH [--out PATH]
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import math
import os
import pathlib
import subprocess
from typing import Dict

import numpy as np
import torch

from ..kernels import common
from ..kernels.filter_cnn import kernel as cnn_kernel
from ..kernels.filter_cnn import ref as cnn_ref
from ..kernels.filter_rnn import kernel as rnn_kernel
from ..kernels.filter_rnn import ref as rnn_ref
from .lstm_designs import make_stack

#: kernel: (its library's C signatures, the plain version, limit (atol,
#: rtol) as chip_smoke.py's)
KERNELS = {"filter_cnn": (cnn_kernel._SIGNATURES, cnn_ref.cnn_filter,
                          (1e-4, 1e-5)),
           "filter_rnn": (rnn_kernel._SIGNATURES, rnn_ref.lstm_filter,
                          (0.0, 1e-6))}
#: the shapes timed: (label, F, Q)
SHAPES = (("calibration", 4096, 180), ("Q=1", 4096, 1))


def build_other(src: pathlib.Path) -> Dict[str, ctypes.CDLL]:
    """The other tree's two sources, one nvcc each, started together."""
    common.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = []
    for name in KERNELS:
        path = src / f"{name}.cu"
        tag = hashlib.sha1(path.read_bytes()).hexdigest()[:12]
        out = common.BUILD_DIR / f"lib{name}-other-{tag}.so"
        cmd = [common._nvcc(), *common.NVCC_FLAGS, "-I", str(src), "-o",
               str(out), str(path)]
        running.append((name, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    libs = {}
    for name, out, proc in running:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}/{name}.cu:\n{log}")
        libs[name] = _bind(ctypes.CDLL(str(out)), name, ("cnn_filter",
                                                         "lstm_filter"))
    return libs


def _bind(lib: ctypes.CDLL, name: str, entries) -> ctypes.CDLL:
    for fn, argtypes in KERNELS[name][0].items():
        if fn in entries:
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
    return lib


def cnn_stack(F: int, Q: int, m: int = 256, C: int = 256, K: int = 3,
              seed: int = 0) -> tuple:
    dev = common.resolve_device("cuda")
    rng = np.random.default_rng(seed)

    def randn(*shape, scale=1.0):
        return torch.as_tensor((rng.standard_normal(shape) * scale).astype(
            np.float32), device=dev)
    return (randn(Q, m), randn(F, K, 1, C, scale=math.sqrt(2 / K)),
            randn(F, K, C, C, scale=math.sqrt(2 / (K * C))),
            randn(F, C, scale=math.sqrt(1 / C)), randn(F), randn(F) + 10.0,
            torch.as_tensor(rng.uniform(0.5, 2.0, F).astype(np.float32),
                            device=dev))


def _call(lib: ctypes.CDLL, name: str, args) -> torch.Tensor:
    q = args[0]
    Q, m = q.shape
    F = args[1].shape[0]
    out = torch.empty((F, Q), dtype=torch.float32, device=q.device)
    ptrs = [common.ptr(t) for t in args]
    if name == "filter_cnn":
        _, K, _, C = args[1].shape
        err = lib.cnn_filter(*ptrs, common.ptr(out), F, Q, m, K, C,
                             common.stream_ptr(q))
    else:
        h = args[5].shape[1]
        err = lib.lstm_filter(*ptrs, common.ptr(out), None, F, Q, m, h,
                              common.stream_ptr(q))
    common.check(err, name)
    return out


def _graph_ms(fn, reps: int) -> float:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(other: pathlib.Path) -> Dict:
    libs = {"other": build_other(other), "this": {}}
    common.build(list(KERNELS))
    for name in KERNELS:
        libs["this"][name] = _bind(ctypes.CDLL(str(common._lib_path(name))),
                                   name, ("cnn_filter", "lstm_filter"))
    rows = []
    for name, (_, plain, (atol, rtol)) in KERNELS.items():
        for label, F, Q in SHAPES:
            args = (cnn_stack(F, Q) if name == "filter_cnn"
                    else make_stack(F, 256, 64, Q))
            want = plain(*args)
            tol = atol + rtol * want.abs().max().item()
            row = {"kernel": name, "call": label, "F": F, "Q": Q,
                   "tolerance": tol, "order": [], "ms": []}
            for tree in ("other", "this"):
                err = (_call(libs[tree][name], name, args)
                       - want).abs().max().item()
                assert np.isfinite(err) and err <= tol, (
                    f"{tree} {name} at {label}: error {err:.3g} above "
                    f"{tol:.3g}")
                row[f"{tree}_err"] = err
            reps = 1 if Q > 1 else 5
            for tree in ("other", "this", "this", "other"):
                row["order"].append(tree)
                row["ms"].append(_graph_ms(
                    lambda lib=libs[tree][name], a=args: _call(lib, name, a),
                    reps))
            rows.append(row)
            del args, want
            torch.cuda.empty_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30).stdout.strip().splitlines()[0]
    return {"config": {"other": str(other), "card": card}, "rows": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True,
                    help="another tree's csrc directory")
    ap.add_argument("--out", default="build/bench/backbone_sources.json",
                    help="where to write the JSON payload")
    args = ap.parse_args(argv)
    payload = compare(pathlib.Path(args.other))
    print(f"# {payload['config']}")
    for row in payload["rows"]:
        print(f"backbone_sources/{row['kernel']} {row['call']} (F={row['F']}"
              f", Q={row['Q']}; ms from a graph, in turns): " + ", ".join(
                  f"{t} {ms:.4f}" for t, ms in zip(row["order"], row["ms"]))
              + f"; max errors other {row['other_err']:.3g}, this "
              f"{row['this_err']:.3g} (limit {row['tolerance']:.3g})")
    d = os.path.dirname(args.out)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(payload, f, indent=1)
    print(f"# → {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
