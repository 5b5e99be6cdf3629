#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA card and check them.

    python3 chip_smoke.py            # needs one CUDA card, nvcc and numpy

1. Prints the card's name and power limit (``nvidia-smi``) and builds the
   hand-written kernels from ``src/repro_torch/csrc`` (one nvcc per source,
   all started together).
2. DSTree, end to end through the port's entry points: RandWalk 1,000,000 ×
   256 (numpy seed 0) → ``build_leafi(LeaFiConfig(backbone="dstree",
   leaf_capacity=256, t_filter_over_t_series=20.0))`` → 256 queries at
   exact, 0.99, 0.95 and per-query targets, k = 1 and 5, with the default
   candidate pass and with ``dist_impl="pairwise"``.  Prints phase times,
   pruning, searched leaves, recall against exact search and wall time per
   batch; asserts that exact search equals a brute-force scan over the
   pairwise kernel for 64 queries, and that every kernel of the path was
   launched (the launch counters are zeroed just before the build and read
   just after the last search).
3. Breaks one DSTree search batch (k = 5, target 0.99) down by layer, and
   profiles it for the device's busy time and idle share.
4. iSAX, end to end on the same collection: ``build_leafi(LeaFiConfig(
   backbone="isax", word_len=8, leaf_capacity=256,
   t_filter_over_t_series=20.0))`` with float32 filter weights, then
   ``requantize_leafi`` to bfloat16 and int8; for each payload 256 queries
   at the four targets, k = 1 and 5.  Prints phase times, L, F, the largest
   leaf, peak memory, and per batch pruning, recall and wall time; asserts
   exact == brute force and that all six kernels launched (counters zeroed
   just before the build, read after the last search).  Prints each
   index's recall@1 at target 0.99 on its own calibration split (DSTree's
   too) beside the tuner's quality knots.  Then the same layer breakdown
   for one iSAX batch.
5. Holds each kernel against its plain PyTorch version on the card, on the
   largest inputs the main paths gave it, and times kernel (through its
   wrapper, and replayed from a CUDA graph without the host-side enqueue),
   plain version and (for the distance kernels) ``torch.cdist``, beside
   the least time the card could take (f32 CUDA-core peak, HBM rate).
6. Prints ``{"kernels": [...]}`` and, as the last line,
   ``{"ok": true, "device": {...}}``.  Any failure raises and exits
   non-zero before that line; so does a machine without a CUDA card.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# published peaks of one H100 SXM at its 700 W limit: f32 outside the
# tensor cores, HBM3 bandwidth
F32_FLOPS = 67e12
HBM_BYTES = 3.35e12

KERNELS = {
    # name: (source, TPU kernel it replaces, tolerance (atol, rtol), reason);
    # the limits are a few times the f32 reading, below what a TF32 run of
    # the plain version errs by (printed beside each check)
    "pairwise_l2": ("src/repro_torch/csrc/l2_scan.cu",
                    "src/repro/kernels/l2_scan/kernel.py:42",
                    (1e-4, 1e-5), "f32 sums of |q|^2+|s|^2-2q.s in another "
                    "order; |q|^2 = m = 256 for z-normalized series"),
    "slab_l2": ("src/repro_torch/csrc/l2_scan.cu",
                "src/repro/kernels/l2_scan/kernel.py:94",
                (1e-4, 1e-5), "as pairwise_l2"),
    "fused_filter_mlp": ("src/repro_torch/csrc/filter_mlp.cu",
                         "src/repro/kernels/filter_mlp/kernel.py:157",
                         (1e-4, 1e-5), "f32 sums over m and h in another "
                         "order"),
    "fused_filter_mlp_bf16": ("src/repro_torch/csrc/filter_mlp.cu",
                              "src/repro/kernels/filter_mlp/kernel.py:157",
                              (1e-4, 1e-5), "bf16 weights upcast exactly; "
                              "f32 sums in another order"),
    "fused_filter_mlp_int8": ("src/repro_torch/csrc/filter_mlp.cu",
                              "src/repro/kernels/filter_mlp/kernel.py:157",
                              (1e-4, 1e-5), "int8 weights upcast exactly; "
                              "the scales fold in after the sums instead "
                              "of before (one more f32 rounding)"),
    "box_lb": ("src/repro_torch/csrc/box_lb.cu",
               "src/repro/kernels/box_lb/kernel.py:31",
               (1e-4, 1e-5), "f32 sum over d in another order"),
}
#: the kernels each path launches
DSTREE_KERNELS = ("pairwise_l2", "slab_l2", "fused_filter_mlp", "box_lb")
ISAX_KERNELS = tuple(KERNELS)
PAYLOADS = ("float32", "bfloat16", "int8")
TARGETS = ("exact", "0.99", "0.95", "per-query")


def log(*args) -> None:
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def _counter_tables():
    from repro_torch.kernels.box_lb import kernel as box_kernel
    from repro_torch.kernels.filter_mlp import kernel as mlp_kernel
    from repro_torch.kernels.l2_scan import kernel as l2_kernel
    return (l2_kernel.LAUNCHES, mlp_kernel.LAUNCHES, box_kernel.LAUNCHES)


def _launch_counters():
    return {k: v for table in _counter_tables() for k, v in table.items()}


def _zero_counters() -> None:
    for table in _counter_tables():
        for name in table:
            table[name] = 0


@contextlib.contextmanager
def capture_largest_inputs(captured: dict):
    """Record, per kernel, the arguments of its largest call (by output
    elements) while the main path runs; the wrappers themselves, and their
    launch counts, are unchanged."""
    from repro_torch.kernels.box_lb import kernel as box_kernel
    from repro_torch.kernels.filter_mlp import kernel as mlp_kernel
    from repro_torch.kernels.l2_scan import kernel as l2_kernel
    targets = [(l2_kernel, "pairwise_l2_cuda", lambda a: "pairwise_l2"),
               (l2_kernel, "slab_l2_cuda", lambda a: "slab_l2"),
               (mlp_kernel, "fused_filter_mlp_cuda",
                lambda a: mlp_kernel.ENTRY[a[1].dtype]),
               (box_kernel, "box_lb_cuda", lambda a: "box_lb")]
    saved = []
    for mod, attr, naming in targets:
        fn = getattr(mod, attr)

        def wrapped(*args, _fn=fn, _naming=naming):
            out = _fn(*args)
            name = _naming(args)
            if out.numel() > captured.get(name, (0, None))[0]:
                captured[name] = (out.numel(), args)
            return out
        saved.append((mod, attr, fn))
        setattr(mod, attr, wrapped)
    try:
        yield captured
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def _sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _recall(ids: np.ndarray, exact_ids: np.ndarray) -> float:
    k = ids.shape[1]
    hits = [len(set(a) & set(b)) for a, b in zip(ids.tolist(),
                                                 exact_ids.tolist())]
    return float(np.mean(hits)) / k


def _brute_force_check(lfi, queries: np.ndarray, exact_results,
                       n_brute: int, label: str) -> None:
    """Exact search (k = 5) equals a brute-force scan over the pairwise
    kernel for the first ``n_brute`` queries."""
    import torch
    from repro_torch.kernels.l2_scan import ops as l2_ops
    idx = lfi.index
    qb = torch.as_tensor(queries[:n_brute], device=idx.device)
    d = l2_ops.pairwise_l2(qb, idx.series[: idx.n_series])
    bd, brow = torch.sort(d, dim=1, stable=True)
    bd, brow = bd[:, :5].cpu().numpy(), brow[:, :5].cpu().numpy()
    bids = idx.order.cpu().numpy()[brow]
    for ex in exact_results:
        np.testing.assert_allclose(ex.dists[:n_brute], bd, rtol=1e-4,
                                   atol=1e-3)
        assert (np.sort(ex.ids[:n_brute], 1) == np.sort(bids, 1)).all(), \
            f"{label}exact search disagrees with brute force"
    log(f"{label}exact search == brute force on {n_brute} queries (k=5, "
        f"{len(exact_results)} exact run(s))")


def _check_launches(launches: dict, expected, label: str,
                    on_card: bool) -> None:
    """Print the path's launch counts; on the card, every kernel of the
    path must have launched."""
    log(f"launches on the {label} path: " + json.dumps(launches))
    missing = [k for k in expected if launches.get(k, 0) <= 0]
    assert not (on_card and missing), \
        f"kernels never launched on the {label} path: {missing}"


def _search_line(prefix: str, r, exact, wall: float, n_queries: int) -> str:
    return (f"{prefix}: pruning={r.pruning_ratio.mean():.4f} "
            f"searched={r.searched.mean():.1f}/{r.n_leaves} "
            f"pruned_lb={r.pruned_lb.mean():.1f} "
            f"pruned_filter={r.pruned_filter.mean():.1f} "
            f"computed={r.computed.mean():.1f} "
            f"recall={_recall(r.ids, exact.ids):.4f} "
            f"wall={wall * 1e3:.1f} ms/batch "
            f"({n_queries / wall:.1f} queries/s)")


def _tail_probability(n: int, misses: int, target: float) -> float:
    """P(at least ``misses`` of ``n`` queries miss) if each query finds its
    nearest neighbour with probability ``target``."""
    p = 1.0 - target
    return sum(math.comb(n, i) * p ** i * (1 - p) ** (n - i)
               for i in range(misses, n + 1))


def _calib_recall_line(label: str, lfi, device, target: float = 0.99
                       ) -> float:
    """recall@1 at ``target`` on the index's own calibration split (the
    queries its tuners were fit on), and the quality knots either side."""
    q = lfi.calib.queries.cpu().numpy()
    exact = lfi.search_exact(q, device=device).dists[:, 0]
    got = lfi.search(q, quality_target=target, device=device).dists[:, 0]
    hit = got <= exact * (1 + 1e-5) + 1e-6
    misses = int((~hit).sum())
    knots = lfi.tuner.knots_q
    i = int(np.searchsorted(knots, target, side="right"))
    below = f"{knots[i - 1]:.6f}" if i > 0 else "none"
    above = f"{knots[i]:.6f}" if i < len(knots) else "none"
    log(f"{label}calibration split at target {target}: recall@1 "
        f"{hit.mean():.4f} ({misses} of {len(hit)} missed, P(>= that | "
        f"{target}) = {_tail_probability(len(hit), misses, target):.3f}); "
        f"{len(knots)} quality knots, {below} .. {above} around {target}")
    return float(hit.mean())


def _build_lines(label: str, lfi, t_build: float, on_card: bool) -> None:
    import torch
    rep = lfi.build_report
    log(f"{label}build: {t_build:.2f} s; " + ", ".join(
        f"{k}={v:.4g}" for k, v in rep.items()))
    log(f"{label}index: L={lfi.index.n_leaves} leaves, "
        f"F={len(lfi.leaf_ids)} filters, max leaf {lfi.index.max_leaf_size}")
    if on_card:
        log(f"{label}peak device memory after build: "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


def _query_setup(series: np.ndarray, n_queries: int):
    from repro_torch.data.series import make_query_set
    queries = make_query_set(series, n_queries, noise=0.2, seed=42)
    per_query = np.random.default_rng(1).choice([0.9, 0.95, 0.99], n_queries)
    return queries, dict(zip(TARGETS, (None, 0.99, 0.95, per_query)))


def make_series(n: int = 1_000_000, m: int = 256) -> np.ndarray:
    from repro_torch.data.series import randwalk
    t0 = time.perf_counter()
    series = randwalk(n, m, seed=0)
    log(f"data: RandWalk {n} x {m} ({series.nbytes / 1e9:.3f} GB) in "
        f"{time.perf_counter() - t0:.2f} s")
    return series


def run_end_to_end(*, n: int = 1_000_000, m: int = 256,
                   n_queries: int = 256, n_brute: int = 64,
                   leaf_capacity: int = 256, n_global: int = 600,
                   n_local: int = 200, epochs: int = 300,
                   device: str = "cuda", captured: dict | None = None,
                   series: np.ndarray | None = None) -> dict:
    """Build a DSTree index and answer query batches through the port's
    entry points; asserts exact == brute force and (on the card) that every
    kernel of the path launched.  Returns the launch counts and results."""
    import torch
    from repro_torch.core import build, filter_training

    series = make_series(n, m) if series is None else series
    cfg = build.LeaFiConfig(
        backbone="dstree", leaf_capacity=leaf_capacity,
        t_filter_over_t_series=20.0, n_global=n_global, n_local=n_local,
        train=filter_training.TrainConfig(epochs=epochs))
    queries, targets = _query_setup(series, n_queries)

    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    captured = {} if captured is None else captured
    _zero_counters()
    with capture_largest_inputs(captured):
        t0 = time.perf_counter()
        lfi = build.build_leafi(series, cfg, device=device)
        _sync(device)
        _build_lines("", lfi, time.perf_counter() - t0, on_card)

        results = {}
        lfi.search(queries, k=1, quality_target=None, device=device)  # warm
        for impl in (None, "pairwise"):
            for k in (1, 5):
                for name, target in targets.items():
                    _sync(device)
                    t0 = time.perf_counter()
                    r = lfi.search(queries, k=k, quality_target=target,
                                   device=device, dist_impl=impl)
                    _sync(device)
                    wall = time.perf_counter() - t0
                    results[(impl or "default", k, name)] = (r, wall)
    launches = _launch_counters()

    for (impl, k, name), (r, wall) in results.items():
        exact = results[(impl, k, "exact")][0]
        assert r.dists.shape == (n_queries, k), r.dists.shape
        assert np.isfinite(r.dists).all(), f"non-finite dists {impl} {k}"
        log(_search_line(f"search impl={impl:8s} k={k} target={name:9s}", r,
                         exact, wall, n_queries))
    _calib_recall_line("dstree ", lfi, device)

    _brute_force_check(lfi, queries, [results[(impl, 5, "exact")][0]
                                      for impl in ("default", "pairwise")],
                       n_brute, "")
    _check_launches(launches, DSTREE_KERNELS, "DSTree", on_card)
    return {"launches": launches, "results": results, "lfi": lfi,
            "queries": queries}


def run_isax(*, n: int = 1_000_000, m: int = 256, n_queries: int = 256,
             n_brute: int = 64, leaf_capacity: int = 256,
             n_global: int = 600, n_local: int = 200, epochs: int = 300,
             device: str = "cuda", captured: dict | None = None,
             series: np.ndarray | None = None) -> dict:
    """Build an iSAX index with float32 filters, requantize it to bfloat16
    and int8, and answer query batches with each payload; asserts exact ==
    brute force and (on the card) that all six kernels launched."""
    import torch
    from repro_torch.core import build, filter_training

    series = make_series(n, m) if series is None else series
    cfg = build.LeaFiConfig(
        backbone="isax", word_len=8, leaf_capacity=leaf_capacity,
        t_filter_over_t_series=20.0, n_global=n_global, n_local=n_local,
        train=filter_training.TrainConfig(epochs=epochs))
    queries, targets = _query_setup(series, n_queries)

    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    captured = {} if captured is None else captured
    _zero_counters()
    with capture_largest_inputs(captured):
        t0 = time.perf_counter()
        lfi = build.build_leafi(series, cfg, device=device)
        _sync(device)
        _build_lines("isax ", lfi, time.perf_counter() - t0, on_card)
        sizes = lfi.index.leaf_size.cpu().numpy()
        log(f"isax leaves: {int((sizes > leaf_capacity).sum())} above "
            f"capacity {leaf_capacity}; median size {np.median(sizes):.0f}")
        indexes = {"float32": lfi}
        for payload in PAYLOADS[1:]:
            t0 = time.perf_counter()
            indexes[payload] = build.requantize_leafi(lfi, payload,
                                                      device=device)
            _sync(device)
            log(f"isax requantize to {payload}: "
                f"{time.perf_counter() - t0:.2f} s")

        results = {}
        lfi.search(queries, k=1, quality_target=None, device=device)  # warm
        for payload, index in indexes.items():
            for k in (1, 5):
                for name, target in targets.items():
                    _sync(device)
                    t0 = time.perf_counter()
                    r = index.search(queries, k=k, quality_target=target,
                                     device=device)
                    _sync(device)
                    results[(payload, k, name)] = (
                        r, time.perf_counter() - t0)
    launches = _launch_counters()

    for (payload, k, name), (r, wall) in results.items():
        exact = results[(payload, k, "exact")][0]
        ref32 = results[("float32", k, name)][0]
        assert r.dists.shape == (n_queries, k), r.dists.shape
        assert np.isfinite(r.dists).all(), f"non-finite dists {payload} {k}"
        d_pruning = r.pruning_ratio.mean() - ref32.pruning_ratio.mean()
        same = float((r.ids == ref32.ids).all(1).mean())
        log(_search_line(f"isax payload={payload:8s} k={k} "
                         f"target={name:9s}", r, exact, wall, n_queries)
            + f" vs float32: pruning {d_pruning:+.4f}, same ids {same:.4f}")
    for payload, index in indexes.items():
        _calib_recall_line(f"isax payload={payload:8s} ", index, device)

    _brute_force_check(lfi, queries, [results[(p, 5, "exact")][0]
                                      for p in PAYLOADS],
                       n_brute, "isax ")
    _check_launches(launches, ISAX_KERNELS, "iSAX", on_card)
    return {"launches": launches, "results": results, "lfi": lfi,
            "queries": queries}


def search_breakdown(lfi, queries: np.ndarray, k: int = 5,
                     target: float = 0.99, reps: int = 5,
                     label: str = "") -> dict:
    """Where one search batch's time goes (default impl): host clock around
    a device synchronize for each layer, the layers timed in turn within
    each of ``reps`` rounds (host-side noise hits them alike), medians;
    then one profiled batch for the device's busy time and kernel count."""
    import torch
    from repro_torch.core import bounds, engine, search

    idx = lfi.index
    dev = idx.device
    q = torch.as_tensor(queries, device=dev)
    d_lb = bounds.lower_bounds(idx, q)
    offsets = lfi.tuner.offsets(target)
    d_F = search.predictions_for_all_leaves(idx, lfi.filter_params,
                                            lfi.leaf_ids, q, offsets)
    # the replay alone over summaries of the engine's shapes: a fixed loop
    # over all L visit positions, so its cost does not depend on the values
    Q, L = d_lb.shape
    kk = min(k, idx.max_leaf_size)
    leaf_d = torch.sort(torch.rand((Q, L, kk), device=dev), dim=-1).values
    leaf_i = torch.zeros((Q, L, kk), dtype=torch.int64, device=dev)
    order = torch.argsort(d_lb, dim=1, stable=True)
    layers = {
        "search": lambda: lfi.search(queries, k=k, quality_target=target,
                                     device=dev),
        "lower_bounds": lambda: bounds.lower_bounds(idx, q),
        "predictions": lambda: search.predictions_for_all_leaves(
            idx, lfi.filter_params, lfi.leaf_ids, q, offsets),
        "engine": lambda: engine.run_cascade(
            idx.series, idx.leaf_start, idx.leaf_size, q, d_lb, d_F, k=k,
            max_leaf=idx.max_leaf_size),
        "replay": lambda: engine.replay_cascade(leaf_d, leaf_i, d_lb, d_F,
                                                order, k),
    }
    times: dict = {name: [] for name in layers}
    for _ in range(reps):
        for name, fn in layers.items():
            _sync(dev)
            t0 = time.perf_counter()
            fn()
            _sync(dev)
            times[name].append((time.perf_counter() - t0) * 1e3)
    ms = {name: float(np.median(v)) for name, v in times.items()}
    log(f"{label}breakdown k={k} target={target} (median of {reps} rounds, ms): "
        f"search {ms['search']:.1f} [runs "
        f"{', '.join(f'{t:.0f}' for t in times['search'])}] = lower bounds "
        f"{ms['lower_bounds']:.2f} + filter predictions "
        f"{ms['predictions']:.2f} + engine {ms['engine']:.1f} [runs "
        f"{', '.join(f'{t:.0f}' for t in times['engine'])}] (of which the "
        f"cascade replay over L={L} positions {ms['replay']:.1f}) + rest")

    from torch.profiler import ProfilerActivity, profile
    _sync(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        lfi.search(queries, k=k, quality_target=target, device=dev)
        _sync(dev)
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    by_name: dict = {}
    for e in kernels:                     # template arguments dropped
        short = e.name.removeprefix("void ").split("<")[0].split("(")[0]
        by_name[short] = by_name.get(short, 0.0) \
            + e.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    if kernels:
        log(f"{label}profiled search: wall {wall:.1f} ms under the profiler, "
            f"{len(kernels)} kernel launches, device busy {busy:.1f} ms: "
            f"idle share {1 - busy / wall:.3f} of the profiled batch, "
            f"{1 - busy / ms['search']:.3f} of the unprofiled median; top "
            f"kernels (ms): " + "; ".join(f"{name} {t:.2f}"
                                          for name, t in top))
    else:
        log(f"{label}profiled search: the profiler recorded no kernel events; "
            "device busy time not measured")
    return {**ms, "profiled_wall_ms": wall,
            "device_busy_ms": busy if kernels else None,
            "kernel_launches": len(kernels)}


def _time_ms(fn, reps: int = 20) -> float:
    import torch
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


def _graph_ms(fn, reps: int = 20) -> float:
    """Per-call device time of ``reps`` calls captured in one CUDA graph:
    the replay launches them back to back, so unlike ``_time_ms`` no
    host-side work (checks, ctypes) sits between two kernels."""
    import torch
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


def _bound(name: str, args) -> tuple:
    """(least ms, "bytes"|"operations") for one call: every input read once,
    every output written once, against the f32 and HBM peaks."""
    if name == "pairwise_l2":
        q, s = args
        Q, m = q.shape
        B = s.shape[0]
        flops = 2 * Q * B * m + 2 * (Q + B) * m + 4 * Q * B
        nbytes = 4 * (Q * m + B * m + Q * B)
    elif name == "slab_l2":
        q, s = args
        F, Nq, m = q.shape
        R = s.shape[1]
        flops = F * (2 * Nq * R * m + 2 * (Nq + R) * m + 4 * Nq * R)
        nbytes = 4 * F * (Nq * m + R * m + Nq * R)
    elif name == "box_lb":
        q, lo, _ = args
        Q, d = q.shape
        L = lo.shape[0]
        flops = Q * L * (6 * d + 1)      # 2 sub, 2 max, mul, add; sqrt
        nbytes = 4 * (Q * d + 2 * L * d + Q * L)
    else:                                 # the fused filter MLP, any payload
        q, w1 = args[0], args[1]
        Q = q.shape[0]
        F, m, h = w1.shape
        flops = F * Q * (2 * m * h + 4 * h + 4)
        n_scales = 2 if w1.dtype.itemsize == 1 else 0
        nbytes = (w1.dtype.itemsize * F * (m * h + h)
                  + 4 * (Q * m + F * (h + 4 + n_scales) + F * Q))
    t_ops, t_bytes = flops / F32_FLOPS, nbytes / HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _plain_mlp(q, w1, b1, w2, b2, ym, ys, off, s1=None, s2=None):
    from repro_torch.kernels.filter_mlp import ref as mlp_ref
    return mlp_ref.filter_predict_destd(w1, b1, w2, b2, ym, ys, q, off, s1,
                                        s2)


def check_kernels(captured: dict, launches: dict, power: str) -> list:
    """Each kernel against its plain version on the main paths' inputs."""
    import torch
    from repro_torch.kernels.box_lb import kernel as box_kernel
    from repro_torch.kernels.box_lb import ref as box_ref
    from repro_torch.kernels.filter_mlp import kernel as mlp_kernel
    from repro_torch.kernels.l2_scan import kernel as l2_kernel
    from repro_torch.kernels.l2_scan import ref as l2_ref

    mlp = mlp_kernel.fused_filter_mlp_cuda
    kernel_fn = {"pairwise_l2": l2_kernel.pairwise_l2_cuda,
                 "slab_l2": l2_kernel.slab_l2_cuda,
                 "fused_filter_mlp": mlp, "fused_filter_mlp_bf16": mlp,
                 "fused_filter_mlp_int8": mlp,
                 "box_lb": box_kernel.box_lb_cuda}
    plain_fn = {"pairwise_l2": l2_ref.pairwise_l2_matmul,
                "slab_l2": l2_ref.slab_l2_matmul,
                "fused_filter_mlp": _plain_mlp,
                "fused_filter_mlp_bf16": _plain_mlp,
                "fused_filter_mlp_int8": _plain_mlp,
                "box_lb": box_ref.box_lb}
    library_fn = {"pairwise_l2": torch.cdist, "slab_l2": torch.cdist}
    rows = []
    for name, (source, replaces, (atol, rtol), why) in KERNELS.items():
        if name not in captured:
            raise AssertionError(f"{name}: never called on the main path")
        args = captured[name][1]
        got = kernel_fn[name](*args)
        torch.cuda.synchronize()
        want = plain_fn[name](*args)
        torch.cuda.synchronize()
        assert got.shape == want.shape, (got.shape, want.shape)
        diff = (got - want).abs()
        err = diff.max().item()
        rel = (diff / (want.abs() + 1e-6)).max().item()
        tol = atol + rtol * want.abs().max().item()
        shapes = " x ".join(str(tuple(a.shape)) for a in args[:2])
        log(f"kernel {name} at {shapes}: max_abs_err={err:.3g} "
            f"max_rel_err={rel:.3g} (tolerance {tol:.3g} absolute = "
            f"{atol:g} + {rtol:g} x max|plain|: {why})")
        if name != "box_lb":              # its plain version has no matmul
            # what the same check reads for a TF32 run of the plain version
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                tf32_err = (plain_fn[name](*args) - want).abs().max().item()
                torch.cuda.synchronize()
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
            log(f"kernel {name}: a TF32 run of the plain version errs by "
                f"{tf32_err:.3g}, which the limit "
                f"{'rejects' if tf32_err > tol else 'would accept'}")
        assert np.isfinite(err) and err <= tol, f"{name} disagrees"
        ms = _time_ms(lambda f=kernel_fn[name], a=args: f(*a))
        graph_ms = _graph_ms(lambda f=kernel_fn[name], a=args: f(*a))
        plain_ms = _time_ms(lambda f=plain_fn[name], a=args: f(*a))
        lib = library_fn.get(name)
        library_ms = (None if lib is None
                      else _time_ms(lambda f=lib, a=args: f(*a)))
        bound_ms, bound_by = _bound(name, args)
        log(f"kernel {name}: {ms:.4f} ms through the wrapper, "
            f"{graph_ms:.4f} ms replayed from a CUDA graph (no host-side "
            f"enqueue), plain {plain_ms:.4f} ms, library "
            f"{library_ms if library_ms is None else f'{library_ms:.4f}'} "
            f"ms, bound {bound_ms:.4f} ms by {bound_by} (peaks at 700 W; "
            f"card limit {power})")
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": library_ms})
    return rows


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 2
    from repro_torch.kernels import common

    # full f32 everywhere: the reference accumulates in f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(card)
    power = card.split(",")[-1].strip()
    t0 = time.perf_counter()
    logs = common.build(["l2_scan", "filter_mlp", "box_lb"])
    log(f"kernels built in {time.perf_counter() - t0:.2f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    captured: dict = {}
    series = make_series()
    e2e = run_end_to_end(device="cuda", captured=captured, series=series)
    search_breakdown(e2e["lfi"], e2e["queries"])
    e2e_launches = e2e["launches"]
    del e2e                               # the DSTree index leaves the card
    isax = run_isax(device="cuda", captured=captured, series=series)
    search_breakdown(isax["lfi"], isax["queries"], reps=3, label="isax ")
    launches = {name: e2e_launches.get(name, 0) + isax["launches"][name]
                for name in KERNELS}
    log("launches on both paths: " + json.dumps(launches))
    rows = check_kernels(captured, launches, power)
    log(card)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
