"""The replay kernel beside other replay sources, at the paths' own calls.

``csrc/replay.cu`` gives each row a block of a walker warp and seven
producer warps.  This script builds, with ``--other PATH``, any other
replay source with the same C entry (another block layout, the parent's
source) into ``build/kernels/``, one nvcc each, beside the product.  It
builds the DSTree and the iSAX index of ``chip_smoke.py`` (RandWalk 1M x
256, numpy seed 0, 256 queries, seed 42) and captures, on each,
calibration's largest replay call during the build and the replay calls
of a batch at k = 5, exact and at target 0.99.  At each call it checks
every other source bitwise against the product's wrapper (which
``chip_smoke.py`` holds against the plain loop), prints the row's chain
(``ref.chain_lengths``) and the bytes bound (``ref.bound_bytes``), and
times the product and each other source from a CUDA graph, in the order
product, others, others reversed, product.  The launch counters are not
used.

    python -m repro_torch.bench.replay_layouts [--other PATH] [--out PATH]
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import pathlib
import re
import subprocess
import time
from typing import Dict, List

import numpy as np
import torch

from ..analysis import roofline
from ..core import build, engine, filter_training
from ..data.series import make_query_set, randwalk
from ..kernels import common
from ..kernels.replay import kernel as replay_kernel
from ..kernels.replay import ref as replay_ref
from .leaf_topk_lists import _graph_ms

#: the batches whose replay is measured: (k, quality target)
BATCHES = ((5, None), (5, 0.99))
LIBS = ("l2_scan", "filter_mlp", "box_lb", "replay", "filter_train",
        "leaf_topk")


def _copy(name: str, source: pathlib.Path) -> tuple:
    """(library path, nvcc command) of a build of another source, which
    may include the product's headers."""
    out = common.BUILD_DIR / f"libreplay-{name}.so"
    cmd = [common._nvcc(), *common.NVCC_FLAGS, "-Xptxas", "-v",
           "-I", str(common.CSRC), "-o", str(out), str(source)]
    return out, cmd


def _registers(log: str) -> List[str]:
    """ptxas's register and spill lines of each replay kernel in ``log``."""
    return [line.split(":", 1)[-1].strip() for line in log.splitlines()
            if re.search(r"registers|spill stores", line)]


def build_copies(others=()) -> tuple:
    """The product and the other sources (named by their file's stem), one
    nvcc each, started together with the product libraries; returns
    (libraries by name, ptxas lines by name)."""
    common.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for path in map(pathlib.Path, others):
        if path.stem in jobs or path.stem == "product":
            raise ValueError(f"two sources named {path.stem}")
        jobs[path.stem] = _copy(path.stem, path)
    running = {name: (out, subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for name, (out, cmd) in jobs.items()}
    logs = common.build(LIBS)
    libs = {"product": common.load("replay", replay_kernel._SIGNATURES)}
    ptxas = {"product": _registers(logs.get("replay", ""))}
    for name, (out, proc) in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the {name} copy:\n{log}")
        lib = ctypes.CDLL(str(out))
        lib.replay.argtypes = replay_kernel._SIGNATURES["replay"]
        lib.replay.restype = ctypes.c_int
        libs[name] = lib
        ptxas[name] = _registers(log)
    return libs, ptxas


def _call(lib: ctypes.CDLL, args: tuple) -> tuple:
    """One launch through a library's C entry, as the wrapper makes it."""
    leaf_d, leaf_i, d_lb, d_F, order, k = args
    Q, L, kk = leaf_d.shape
    dev = leaf_d.device
    topk_d = torch.empty((Q, k), dtype=torch.float32, device=dev)
    topk_i = torch.empty((Q, k), dtype=torch.int64, device=dev)
    counts = torch.empty((3, Q), dtype=torch.int32, device=dev)
    ptr = common.ptr
    err = lib.replay(ptr(leaf_d), ptr(leaf_i), leaf_d.stride(0), ptr(d_lb),
                     ptr(d_F), ptr(order), ptr(topk_d), ptr(topk_i),
                     ptr(counts[0]), ptr(counts[1]), ptr(counts[2]), Q, L,
                     kk, k, common.stream_ptr(leaf_d))
    common.check(err, "replay (scratch copy)")
    return topk_d, topk_i, counts[0], counts[1], counts[2]


def _kernel_args(args: tuple) -> tuple:
    """The engine's replay arguments as the kernel takes them."""
    return args[:2] + tuple(t.contiguous() for t in args[2:5]) + args[5:]


def _replay_calls(backbone: str, series: np.ndarray, queries: np.ndarray,
                  dev) -> List[tuple]:
    """(label, arguments) of calibration's largest replay call during a
    ``backbone`` build as ``chip_smoke.py`` makes it, and of the replay of
    each batch of :data:`BATCHES` on that index."""
    cfg = build.LeaFiConfig(
        backbone=backbone, leaf_capacity=256, t_filter_over_t_series=20.0,
        n_global=600, n_local=200,
        train=filter_training.TrainConfig(epochs=300),
        **({"word_len": 8} if backbone == "isax" else {}))
    run = engine.replay_cascade
    got: list = []

    def record(leaf_d, leaf_i, d_lb, d_F, order, k):
        got.append((leaf_d, leaf_i, d_lb, d_F, order, k))
        return run(leaf_d, leaf_i, d_lb, d_F, order, k)
    engine.replay_cascade = record
    try:
        t0 = time.perf_counter()
        lfi = build.build_leafi(series, cfg, device=dev)
        if torch.device(dev).type == "cuda":
            torch.cuda.synchronize()
        print(f"# {backbone} built in {time.perf_counter() - t0:.2f} s",
              flush=True)
        calls = [(f"{backbone} calibration",
                  max(got, key=lambda a: a[2].numel()))]
        for k, target in BATCHES:
            got.clear()
            lfi.search(queries, k=k, quality_target=target, device=dev)
            name = "exact" if target is None else str(target)
            calls.append((f"{backbone} batch k={k} {name}", got[0]))
    finally:
        engine.replay_cascade = run
    del lfi
    return [(label, _kernel_args(args)) for label, args in calls]


def bench_layouts(others=(), n: int = 1_000_000, m: int = 256,
                  n_queries: int = 256) -> Dict:
    dev = common.resolve_device("cuda")
    libs, ptxas = build_copies(others)
    names = list(libs)
    order = names + names[::-1]
    series = randwalk(n, m, seed=0)
    queries = make_query_set(series, n_queries, noise=0.2, seed=42)
    results = []
    for backbone in ("dstree", "isax"):
        for label, args in _replay_calls(backbone, series, queries, dev):
            want = replay_kernel.replay_cascade_cuda(*args)
            entries, entering, _ = replay_ref.chain_lengths(
                args[0], args[2], args[3], args[4], args[5])
            nbytes = replay_ref.bound_bytes(args[0], args[2], args[3],
                                            args[4], args[5])
            row = {"call": label, "Q": args[0].shape[0],
                   "L": args[0].shape[1], "kk": args[0].shape[2],
                   "k": args[5],
                   "bound_ms": nbytes / roofline.H100.hbm_bw * 1e3,
                   "ring_entries_least": [entries.float().mean().item(),
                                          int(entries.max())],
                   "entering": [entering.float().mean().item(),
                                int(entering.max())],
                   "ms": {}}
            for name in order:
                got = _call(libs[name], args)
                torch.cuda.synchronize()
                assert all(torch.equal(g, w) for g, w in zip(got, want)), \
                    f"{label}: {name} differs from the product's wrapper"
                t = _graph_ms(lambda lib=libs[name]: _call(lib, args))
                row["ms"].setdefault(name, []).append(t)
            results.append(row)
            print(f"replay_layouts/{label} (Q={row['Q']}, L={row['L']}, "
                  f"kk={row['kk']}, k={row['k']}; bound "
                  f"{row['bound_ms']:.4f} ms; ring entries no bsf can drop "
                  f"mean {row['ring_entries_least'][0]:.1f}, largest "
                  f"{row['ring_entries_least'][1]}; entering the top-k mean "
                  f"{row['entering'][0]:.2f}, largest {row['entering'][1]}"
                  "; ms from a graph, first and second round): " + ", ".join(
                      f"{name} {ts[0]:.4f} / {ts[-1]:.4f}"
                      for name, ts in row["ms"].items()), flush=True)
        torch.cuda.empty_cache()
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        card = torch.cuda.get_device_name(dev) + ", power limit not read"
    return {"config": {"n": n, "m": m, "queries": n_queries, "card": card,
                       "others": [str(p) for p in others]},
            "ptxas": ptxas, "results": results}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", action="append", default=[],
                    help="another replay source to time beside the product")
    ap.add_argument("--out", default="build/bench/replay_layouts.json",
                    help="where to write the JSON payload")
    args = ap.parse_args(argv)
    payload = bench_layouts(args.other)
    print(f"# {payload['config']}")
    for name, lines in payload["ptxas"].items():
        for line in lines:
            print(f"# ptxas, {name}: {line}")
    d = os.path.dirname(args.out)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(payload, f, indent=1)
    print(f"# → {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
