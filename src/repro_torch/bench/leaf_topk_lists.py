"""The staged candidate-pass instance's register lists, by their length.

``csrc/leaf_topk.cu``'s staged instance (``leaf_topk_wgmma_kernel``) keeps
each lane's top-kk lists in registers during a tile for kk <= 8, in an
instance for each kk with lists of exactly kk entries; beyond, in shared
memory.  A scratch copy built with ``-DLEAF_TOPK_ONE_LIST=n`` has one
instance of n-entry lists, the entries past kk masked, for every kk <= n.
This script builds the copies with n = 8, 5 and 1 into ``build/kernels/``,
builds the DSTree and the iSAX index of ``chip_smoke.py`` (RandWalk 1M x
256, numpy seed 0, 256 queries, seed 42), captures the survivor pass of a
batch at k = 1 and 5, exact and at target 0.99, on each, and at each call
checks every copy bitwise against the product library's wrapper (which
``chip_smoke.py`` holds against the plain version) and times the product's
kernel and each copy's from a CUDA graph, in the order product, 8, 5, 1, 1,
5, 8, product: the measurement behind the product's exact-length lists.
The item table is made once a call by the wrapper's ``item_table`` and is
not timed.  The launch counters are not used.

    python -m repro_torch.bench.leaf_topk_lists [--out PATH]     # one card
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import time
from typing import Dict, List

import numpy as np
import torch

from ..core import build, engine, filter_training
from ..data.series import make_query_set, randwalk
from ..kernels import common
from ..kernels.leaf_topk import kernel as leaf_kernel

#: the scratch copies' register-list lengths
LENGTHS = (8, 5, 1)
#: the timing rounds' order: the product library, then the copies
ORDER = ("product", *LENGTHS, *LENGTHS[::-1], "product")
#: the batches whose survivor pass is measured: (k, quality target)
BATCHES = ((5, None), (5, 0.99), (1, None), (1, 0.99))
LIBS = ("l2_scan", "filter_mlp", "box_lb", "replay", "filter_train",
        "leaf_topk")


def variant(length: int) -> tuple:
    """(library path, nvcc command) of the scratch copy of
    ``csrc/leaf_topk.cu`` whose register lists are ``length`` long."""
    product = common._lib_path("leaf_topk")
    out = product.with_name(f"{product.stem}-reg{length}.so")
    cmd = [common._nvcc(), *common.NVCC_FLAGS, "-Xptxas", "-v",
           f"-DLEAF_TOPK_ONE_LIST={length}", "-o", str(out),
           str(common.CSRC / "leaf_topk.cu")]
    return out, cmd


def _registers(log: str) -> Dict[str, str]:
    """ptxas's register and spill line of each staged instance in ``log``."""
    found, name = {}, None
    for line in log.splitlines():
        hit = re.search(r"Compiling entry function '(\w*leaf_topk_wgmma\w*)'",
                        line)
        if hit:
            name = hit.group(1)
        elif name and "spill stores" in line:
            found[name] = line.split(":", 1)[-1].strip()
        elif name and "Used" in line and "registers" in line:
            found[name] = "; ".join(
                (found.get(name, ""), line.split(":", 1)[-1].strip()))
            name = None
    return found


def build_variants() -> tuple:
    """The scratch copies, one nvcc each, started together with the
    product libraries; returns (libraries by name: the product and each
    copy's length, ptxas lines by length)."""
    common.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = []
    for length in LENGTHS:
        out, cmd = variant(length)
        running.append((length, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    common.build(LIBS)
    libs = {"product": common.load("leaf_topk", leaf_kernel._SIGNATURES)}
    ptxas = {}
    for length, out, proc in running:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the {length}-entry copy:"
                               f"\n{log}")
        lib = ctypes.CDLL(str(out))
        for fn, argtypes in leaf_kernel._SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[length] = lib
        ptxas[length] = _registers(log)
    return libs, ptxas


def _call(lib: ctypes.CDLL, args: tuple, table: tuple, out_d: torch.Tensor,
          out_i: torch.Tensor) -> None:
    """One staged launch through a scratch copy, on the wrapper's
    arguments and its item table."""
    series, leaf_start, leaf_size, queries, leaves = args[:5]
    kk = args[6]
    Q, m = queries.shape
    ptr = common.ptr
    err = lib.leaf_topk_wgmma(
        ptr(series), series.shape[0], ptr(leaf_start), ptr(leaf_size),
        ptr(queries), *(ptr(t) for t in table), ptr(out_d), ptr(out_i), Q,
        leaves.shape[1], leaf_start.shape[0], m, kk, out_d.shape[1],
        common.stream_ptr(queries))
    common.check(err, "leaf_topk_wgmma (scratch copy)")


def _graph_ms(fn, reps: int = 20) -> float:
    """Per-call device time of ``reps`` calls captured in one CUDA graph."""
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


def _survivor_calls(backbone: str, series: np.ndarray,
                    queries: np.ndarray, dev) -> List[tuple]:
    """(label, arguments) of the survivor pass of each batch of
    :data:`BATCHES` on a ``backbone`` index built as ``chip_smoke.py``
    builds it."""
    cfg = build.LeaFiConfig(
        backbone=backbone, leaf_capacity=256, t_filter_over_t_series=20.0,
        n_global=600, n_local=200,
        train=filter_training.TrainConfig(epochs=300),
        **({"word_len": 8} if backbone == "isax" else {}))
    t0 = time.perf_counter()
    lfi = build.build_leafi(series, cfg, device=dev)
    torch.cuda.synchronize()
    print(f"# {backbone} built in {time.perf_counter() - t0:.2f} s",
          flush=True)
    calls = []
    run_pass = engine._bucket_leaf_topk
    for k, target in BATCHES:
        got = []
        engine._bucket_leaf_topk = \
            lambda *a, got=got: (a[11] and got.append(a)) or run_pass(*a)
        try:
            lfi.search(queries, k=k, quality_target=target, device=dev)
        finally:
            engine._bucket_leaf_topk = run_pass
        name = "exact" if target is None else str(target)
        calls.append((f"{backbone} k={k} {name}", got[0]))
    del lfi
    return calls


def _pairs(args: tuple) -> int:
    leaves, counts = args[4], args[5]
    L = args[1].shape[0]
    slot = torch.arange(leaves.shape[1], device=leaves.device)
    return int(((slot < counts[:, None]) & (leaves >= 0)
                & (leaves < L)).sum())


def bench_lists(n: int = 1_000_000, m: int = 256,
                n_queries: int = 256) -> Dict:
    dev = common.resolve_device("cuda")
    libs, ptxas = build_variants()
    series = randwalk(n, m, seed=0)
    queries = make_query_set(series, n_queries, noise=0.2, seed=42)
    results = []
    for backbone in ("dstree", "isax"):
        for label, args in _survivor_calls(backbone, series, queries, dev):
            leaves, counts, kk = args[4], args[5], args[6]
            assert leaf_kernel.instance(args[0], args[3], kk, args[8],
                                        args[11]) == "wgmma", label
            want_d = torch.full_like(args[9], float("inf"))
            want_i = torch.full_like(args[10], -1)
            leaf_kernel.leaf_topk_cuda(*args[:9], want_d, want_i, True)
            table = leaf_kernel.item_table(leaves, counts,
                                           args[1].shape[0])
            row = {"call": label, "kk": kk, "pairs": _pairs(args), "ms": {}}
            for name in ORDER:
                out_d = torch.full_like(want_d, float("inf"))
                out_i = torch.full_like(want_i, -1)
                _call(libs[name], args, table, out_d, out_i)
                torch.cuda.synchronize()
                assert torch.equal(out_d, want_d) and torch.equal(
                    out_i, want_i), f"{label}: {name} differs from the " \
                    "product's wrapper"
                t = _graph_ms(lambda lib=libs[name], d=out_d, i=out_i:
                              _call(lib, args, table, d, i))
                row["ms"].setdefault(str(name), []).append(t)
            results.append(row)
            print(f"leaf_topk_lists/{label} kk={kk} ({row['pairs']} pairs; "
                  "ms from a graph, first and second round): " + ", ".join(
                      f"{name}{'' if name == 'product' else ' entries'} "
                      f"{ts[0]:.4f} / {ts[1]:.4f}"
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
                       "lengths": list(LENGTHS)},
            "ptxas": {str(k): v for k, v in ptxas.items()},
            "results": results}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/bench/leaf_topk_lists.json",
                    help="where to write the JSON payload")
    args = ap.parse_args(argv)
    payload = bench_lists()
    print(f"# {payload['config']}")
    for length, lines in payload["ptxas"].items():
        for name, line in lines.items():
            print(f"# ptxas, {length}-entry copy, {name}: {line}")
    d = os.path.dirname(args.out)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(payload, f, indent=1)
    print(f"# → {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
