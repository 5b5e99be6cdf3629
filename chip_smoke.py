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
4. Single-query early-termination search (``search_early``, paper Alg. 2 as
   written) on the same DSTree index for 32 of its queries, k = 1 and 5,
   exact and at target 0.99: per-query wall time (median, p90), searched
   leaves, pruning and recall beside the batched path's figures for the
   same queries; asserts exact ``search_early`` == brute force and that
   ``box_lb`` and ``fused_filter_mlp`` launched.
5. The grouped per-target search (``search_batched_grouped``) on the 256
   per-query-target queries, k = 1 and 5, beside the vectorised per-query
   batch: recall, pruning, the share of identical ids; asserts the
   reference's serving tolerances between the two.
6. The filter-inference suite (``repro_torch.bench.filters_bench``) at its
   own sweep (F = 64 .. 4096, Q = 128, m = h = 128), then once at the DSTree
   index's shape (its F, Q = 256, m = h = 256): the per-filter
   ``filter_mlp`` kernel beside the fused kernel's three payloads, each
   against its roofline bound; asserts that all four launched.
7. iSAX, end to end on the same collection: ``build_leafi(LeaFiConfig(
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
8. Holds each kernel against its plain PyTorch version on the card, on the
   largest inputs the main paths gave it (and, for the fused filter
   kernel, also on its smallest-Q call: ``search_early``'s single query,
   which takes the weight-streaming design), and times kernel (through its
   wrapper, and replayed from a CUDA graph without the host-side enqueue),
   plain version and (for the distance kernels) ``torch.cdist``, beside
   the least time the card could take: float32 CUDA-core peak and HBM
   rate for every kernel, and for the split-TF32 kernels also the split
   design's bound (its passes x the products at the TF32 tensor-core peak)
   and the function's one-pass TF32 bound.  Holds ``pairwise_l2`` and the
   fused entries, untimed, also at ragged shapes no path gives them
   (partial tiles, m % 4 != 0, h not a multiple of a 16-byte vector), and
   the fused entries on their largest call's weights at the Q on either
   side of the stream design's limit, so every instance of both designs
   is held.  The build's ``-Xptxas -v`` lines (registers, shared memory,
   spills) are printed per kernel; the redesigned kernels must not spill.
9. Prints ``{"kernels": [...]}`` and, as the last line,
   ``{"ok": true, "device": {...}}``.  Any failure raises and exits
   non-zero before that line; so does a machine without a CUDA card.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

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
    "filter_mlp": ("src/repro_torch/csrc/filter_mlp.cu",
                   "src/repro/kernels/filter_mlp/kernel.py:66",
                   (1e-4, 1e-5), "f32 sums over m and h in another order"),
}
#: design of each kernel, and the tensor-core passes of the split-TF32 ones
#: (products per float32 multiply-add; bf16/int8 weights are exact in TF32)
DESIGN = {
    "pairwise_l2": ("split-TF32 mma.sync, 128x128 tile, 3-stage cp.async", 3),
    "slab_l2": ("f32 SIMT, 64x64 tile", None),
    "fused_filter_mlp": ("split-TF32 mma.sync 128-query tiles; f32 weight "
                         "stream for a few queries", 3),
    "fused_filter_mlp_bf16": ("split-TF32 mma.sync 128-query tiles; f32 "
                              "weight stream for a few queries", 2),
    "fused_filter_mlp_int8": ("split-TF32 mma.sync 128-query tiles; f32 "
                              "weight stream for a few queries", 2),
    "box_lb": ("f32 SIMT", None),
    "filter_mlp": ("f32 SIMT, 64-query tile", None),
}
#: the redesigned kernels, whose ptxas report must show no spills
SPLIT_KERNELS = ("l2_tf32x3_kernel", "mlp_tile_kernel", "mlp_stream_kernel")
#: the kernels each path launches
DSTREE_KERNELS = ("pairwise_l2", "slab_l2", "fused_filter_mlp", "box_lb")
ISAX_KERNELS = ("pairwise_l2", "slab_l2", "fused_filter_mlp",
                "fused_filter_mlp_bf16", "fused_filter_mlp_int8", "box_lb")
SEARCH_KERNELS = ("box_lb", "fused_filter_mlp")     # early and grouped
SUITE_KERNELS = ("filter_mlp", "fused_filter_mlp", "fused_filter_mlp_bf16",
                 "fused_filter_mlp_int8")
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
    elements) while the main path runs, and for the fused filter entries
    also those of the call with the fewest queries (under ``<name>@min_q``);
    the wrappers themselves, and their launch counts, are unchanged."""
    from repro_torch.kernels.box_lb import kernel as box_kernel
    from repro_torch.kernels.filter_mlp import kernel as mlp_kernel
    from repro_torch.kernels.l2_scan import kernel as l2_kernel
    targets = [(l2_kernel, "pairwise_l2_cuda", lambda a: "pairwise_l2"),
               (l2_kernel, "slab_l2_cuda", lambda a: "slab_l2"),
               (mlp_kernel, "fused_filter_mlp_cuda",
                lambda a: mlp_kernel.ENTRY[a[1].dtype]),
               (mlp_kernel, "filter_mlp_cuda", lambda a: "filter_mlp"),
               (box_kernel, "box_lb_cuda", lambda a: "box_lb")]
    saved = []
    for mod, attr, naming in targets:
        fn = getattr(mod, attr)

        def wrapped(*args, _fn=fn, _naming=naming):
            out = _fn(*args)
            name = _naming(args)
            if out.numel() > captured.get(name, (0, None))[0]:
                captured[name] = (out.numel(), args)
            if name.startswith("fused_filter_mlp"):
                n_q = args[0].shape[0]
                if n_q < captured.get(f"{name}@min_q", (math.inf, None))[0]:
                    captured[f"{name}@min_q"] = (n_q, args)
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
    """Exact search (each result's k) equals a brute-force scan over the
    pairwise kernel for the first ``n_brute`` queries."""
    import torch
    from repro_torch.kernels.l2_scan import ops as l2_ops
    idx = lfi.index
    ks = sorted({ex.dists.shape[1] for ex in exact_results})
    qb = torch.as_tensor(queries[:n_brute], device=idx.device)
    d = l2_ops.pairwise_l2(qb, idx.series[: idx.n_series])
    bd, brow = torch.sort(d, dim=1, stable=True)
    bd, brow = bd[:, :ks[-1]].cpu().numpy(), brow[:, :ks[-1]].cpu().numpy()
    bids = idx.order.cpu().numpy()[brow]
    for ex in exact_results:
        k = ex.dists.shape[1]
        np.testing.assert_allclose(ex.dists[:n_brute], bd[:, :k], rtol=1e-4,
                                   atol=1e-3)
        assert (np.sort(ex.ids[:n_brute], 1)
                == np.sort(bids[:, :k], 1)).all(), \
            f"{label}exact search disagrees with brute force"
    log(f"{label}exact search == brute force on {n_brute} queries "
        f"(k={'/'.join(map(str, ks))}, {len(exact_results)} exact run(s))")


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
            "queries": queries, "targets": targets}


def _stack_results(rs, n_leaves: int):
    """One SearchResult from single-query ones, in order."""
    from repro_torch.core import search
    cat = {name: np.concatenate([getattr(r, name) for r in rs])
           for name in ("dists", "ids", "searched", "pruned_lb",
                        "pruned_filter")}
    return search.SearchResult(n_leaves=n_leaves, **cat)


def run_early(lfi, queries: np.ndarray, batched: dict, *, n_early: int = 32,
              device: str = "cuda", captured: dict | None = None) -> dict:
    """``search_early`` for the first ``n_early`` queries, k = 1 and 5,
    exact (filters off) and at target 0.99, beside the batched path's
    figures for the same queries (``batched``: ``run_end_to_end``'s
    results); asserts exact == brute force and (on the card) that the
    lower-bound and fused filter kernels launched."""
    import torch
    from repro_torch.core import search
    idx = lfi.index
    n_batch = len(queries)
    kw = dict(filter_params=lfi.filter_params, leaf_ids=lfi.leaf_ids,
              tuner=lfi.tuner, device=device)
    on_card = torch.device(device).type == "cuda"
    for target in (None, 0.99):                                     # warm
        search.search_early(idx, queries[0], quality_target=target,
                            use_filters=target is not None, **kw)
    results = {}
    captured = {} if captured is None else captured
    _zero_counters()
    with capture_largest_inputs(captured):
        for k in (1, 5):
            for name, target in (("exact", None), ("0.99", 0.99)):
                rs, walls = [], []
                for i in range(n_early):
                    _sync(device)
                    t0 = time.perf_counter()
                    rs.append(search.search_early(
                        idx, queries[i], k=k, quality_target=target,
                        use_filters=target is not None, **kw))
                    _sync(device)
                    walls.append(time.perf_counter() - t0)
                results[(k, name)] = (_stack_results(rs, idx.n_leaves),
                                      np.asarray(walls))
    launches = _launch_counters()

    for (k, name), (r, walls) in results.items():
        exact = results[(k, "exact")][0]
        b, b_wall = batched[("default", k, name)]
        b_exact = batched[("default", k, "exact")][0]
        assert r.dists.shape == (n_early, k), r.dists.shape
        assert np.isfinite(r.dists).all(), f"non-finite dists k={k} {name}"
        log(f"search_early k={k} target={name:5s}: per query wall median "
            f"{np.median(walls) * 1e3:.2f} ms, p90 "
            f"{np.percentile(walls, 90) * 1e3:.2f} ms; searched="
            f"{r.searched.mean():.1f}/{r.n_leaves} pruned_lb="
            f"{r.pruned_lb.mean():.1f} pruned_filter="
            f"{r.pruned_filter.mean():.1f} pruning="
            f"{r.pruning_ratio.mean():.4f} recall={_recall(r.ids, exact.ids):.4f}"
            f" | batched, same {n_early} queries: per-query share "
            f"{b_wall / n_batch * 1e3:.2f} ms of a {n_batch}-query batch, "
            f"searched={b.searched[:n_early].mean():.1f} pruning="
            f"{b.pruning_ratio[:n_early].mean():.4f} recall="
            f"{_recall(b.ids[:n_early], b_exact.ids[:n_early]):.4f}")
    _brute_force_check(lfi, queries, [results[(k, "exact")][0]
                                      for k in (1, 5)],
                       n_early, "search_early ")
    _check_launches(launches, SEARCH_KERNELS, "search_early", on_card)
    return {"launches": launches, "results": results}


def run_grouped(lfi, queries: np.ndarray, targets: dict, batched: dict, *,
                device: str = "cuda") -> dict:
    """``search_batched_grouped`` on the per-query-target batch, k = 1 and
    5, beside the vectorised per-query batch from ``batched``; asserts the
    reference's serving tolerances between the two and (on the card) that
    the lower-bound and fused filter kernels launched."""
    import torch
    from repro_torch.core import search
    on_card = torch.device(device).type == "cuda"
    per_query = targets["per-query"]
    results = {}
    _zero_counters()
    for k in (1, 5):
        _sync(device)
        t0 = time.perf_counter()
        r = search.search_batched_grouped(
            lfi.index, queries, per_query, k=k,
            filter_params=lfi.filter_params, leaf_ids=lfi.leaf_ids,
            tuner=lfi.tuner, device=device)
        _sync(device)
        results[k] = (r, time.perf_counter() - t0)
    launches = _launch_counters()

    n = len(queries)
    for k, (grp, wall) in results.items():
        vec, vec_wall = batched[("default", k, "per-query")]
        exact = batched[("default", k, "exact")][0]
        assert grp.dists.shape == (n, k), grp.dists.shape
        same = float((grp.ids == vec.ids).all(1).mean())
        neq = float((grp.ids != vec.ids).mean())
        log(_search_line(f"grouped    k={k} target=per-query", grp, exact,
                         wall, n)
            + f" | vectorised: pruning={vec.pruning_ratio.mean():.4f} "
            f"recall={_recall(vec.ids, exact.ids):.4f} wall="
            f"{vec_wall * 1e3:.1f} ms; identical ids on {same:.4f} of the "
            f"queries, {neq:.4f} of the ids differ")
        np.testing.assert_allclose(vec.dists, grp.dists, rtol=1e-5,
                                   atol=1e-6)
        assert np.abs(vec.searched - grp.searched).max() <= 2
        assert neq <= 0.02, f"{neq} of the ids differ beyond ties"
    _check_launches(launches, SEARCH_KERNELS, "grouped", on_card)
    return {"launches": launches, "results": results}


def run_filter_suite(n_filters: int, *, sweep: dict | None = None,
                     main_shape: tuple = (256, 256, 256),
                     device: str = "cuda", captured: dict | None = None
                     ) -> dict:
    """The filter-inference suite at its own sweep (``sweep``: arguments of
    ``bench_filters``, its defaults if None), then once at the main path's
    shape (``n_filters``, Q, m, h = ``main_shape``); prints each payload's
    rows, parity errors and fused-over-per-filter speedups and asserts (on
    the card) that all four filter kernels launched."""
    import torch
    from repro_torch.bench import filters_bench
    on_card = torch.device(device).type == "cuda"
    q, m, h = main_shape
    captured = {} if captured is None else captured
    payloads = []
    _zero_counters()
    with capture_largest_inputs(captured):
        for label, args in (("sweep", sweep or {}),
                            ("main shape", dict(f_values=(n_filters,), q=q,
                                                m=m, h=h))):
            t0 = time.perf_counter()
            rows, payload = filters_bench.bench_filters(**args,
                                                        device=device)
            cfg = payload["config"]
            log(f"filter suite, {label} (F={cfg['f_values']}, Q={cfg['Q']}, "
                f"m={cfg['m']}, h={cfg['h']}, {cfg['device']}) in "
                f"{time.perf_counter() - t0:.2f} s: name,us_per_call,derived")
            for row in rows:
                log(f"  {row}")
            log(f"filter suite, {label}: parity_max_abs_err "
                + json.dumps(payload["parity_max_abs_err"]))
            log(f"filter suite, {label}: fused_speedup_f32 "
                + json.dumps(payload["fused_speedup_f32"]))
            assert all(np.isfinite(v) for v in
                       payload["parity_max_abs_err"].values())
            payloads.append(payload)
    launches = _launch_counters()
    _check_launches(launches, SUITE_KERNELS, "filter suite", on_card)
    return {"launches": launches, "payloads": payloads}


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


def _bound(name: str, args, passes: int | None = None) -> tuple:
    """(least ms, "bytes"|"operations") for one call: every input read once,
    every output written once, against the H100's HBM rate and its float32
    CUDA-core peak, or, given ``passes``, ``passes`` times the operations
    at its TF32 tensor-core peak: with the split design's passes (3, or 2
    for bf16/int8 weights) the bound of that design, with 1 the function's
    own bound on the tensor cores (``repro_torch.analysis.roofline.H100``).  The filter kernels count
    ``roofline.mlp_operations``, the bound the filter suite uses too."""
    from repro_torch.analysis import roofline
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
    elif name == "filter_mlp":           # raw z
        q, w1 = args[0], args[1]
        Q = q.shape[0]
        F, m, h = w1.shape
        flops = roofline.mlp_operations(F, Q, m, h)
        nbytes = 4 * (F * (m * h + 2 * h + 1) + Q * m + F * Q)
    else:                                 # the fused filter MLP, any payload
        q, w1 = args[0], args[1]
        Q = q.shape[0]
        F, m, h = w1.shape
        flops = roofline.mlp_operations(F, Q, m, h)
        n_scales = 2 if w1.dtype.itemsize == 1 else 0
        nbytes = (w1.dtype.itemsize * F * (m * h + h)
                  + 4 * (Q * m + F * (h + 4 + n_scales) + F * Q))
    t_ops = (flops / roofline.H100.peak_flops if passes is None
             else passes * flops / roofline.H100.tf32_flops)
    t_bytes = nbytes / roofline.H100.hbm_bw
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _plain_mlp(q, w1, b1, w2, b2, ym, ys, off, s1=None, s2=None):
    from repro_torch.kernels.filter_mlp import ref as mlp_ref
    return mlp_ref.filter_predict_destd(w1, b1, w2, b2, ym, ys, q, off, s1,
                                        s2)


def _plain_raw_mlp(q, w1, b1, w2, b2):
    from repro_torch.kernels.filter_mlp import ref as mlp_ref
    return mlp_ref.filter_predict(w1, b1, w2, b2, q)


def _kernel_tables():
    """(kernel wrapper, plain version, library call or None) per kernel."""
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
                 "box_lb": box_kernel.box_lb_cuda,
                 "filter_mlp": mlp_kernel.filter_mlp_cuda}
    plain_fn = {"pairwise_l2": l2_ref.pairwise_l2_matmul,
                "slab_l2": l2_ref.slab_l2_matmul,
                "fused_filter_mlp": _plain_mlp,
                "fused_filter_mlp_bf16": _plain_mlp,
                "fused_filter_mlp_int8": _plain_mlp,
                "box_lb": box_ref.box_lb,
                "filter_mlp": _plain_raw_mlp}
    library_fn = {"pairwise_l2": torch.cdist, "slab_l2": torch.cdist}
    return kernel_fn, plain_fn, library_fn


def _hold(name: str, args, label: str) -> dict:
    """One kernel call against its plain version, asserted within the
    kernel's limit."""
    import torch
    _, _, (atol, rtol), why = KERNELS[name]
    kernel_fn, plain_fn, _ = _kernel_tables()
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
    log(f"kernel {label} at {shapes}: max_abs_err={err:.3g} "
        f"max_rel_err={rel:.3g} (tolerance {tol:.3g} absolute = "
        f"{atol:g} + {rtol:g} x max|plain|: {why})")
    assert np.isfinite(err) and err <= tol, f"{label} disagrees"
    return {"shapes": shapes, "max_abs_err": err, "tolerance": tol}


def _check_call(name: str, args, label: str, power: str) -> dict:
    """One kernel call held against its plain version, then timed beside
    its bounds."""
    import torch
    held = _hold(name, args, label)
    kernel_fn, plain_fn, library_fn = _kernel_tables()
    if name != "box_lb" and label == name:  # its plain version has no matmul
        # what the same check reads for a TF32 run of the plain version
        want = plain_fn[name](*args)
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            tf32_err = (plain_fn[name](*args) - want).abs().max().item()
            torch.cuda.synchronize()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        log(f"kernel {name}: a TF32 run of the plain version errs by "
            f"{tf32_err:.3g}, which the limit "
            f"{'rejects' if tf32_err > held['tolerance'] else 'would accept'}")
    ms = _time_ms(lambda f=kernel_fn[name], a=args: f(*a))
    graph_ms = _graph_ms(lambda f=kernel_fn[name], a=args: f(*a))
    plain_ms = _time_ms(lambda f=plain_fn[name], a=args: f(*a))
    lib = library_fn.get(name)
    library_ms = (None if lib is None
                  else _time_ms(lambda f=lib, a=args: f(*a)))
    design, passes = DESIGN[name]
    bound_ms, bound_by = _bound(name, args)
    split_ms, split_by, tf32_ms, tf32_by = (
        (None,) * 4 if passes is None
        else _bound(name, args, passes) + _bound(name, args, 1))
    tc = ("" if passes is None else
          f", split design's bound ({passes} TF32 passes) {split_ms:.4f} ms "
          f"by {split_by}, one-pass TF32 bound {tf32_ms:.4f} ms by {tf32_by}")
    log(f"kernel {label} [{design}]: {ms:.4f} ms through the wrapper, "
        f"{graph_ms:.4f} ms replayed from a CUDA graph (no host-side "
        f"enqueue), plain {plain_ms:.4f} ms, library "
        f"{library_ms if library_ms is None else f'{library_ms:.4f}'} "
        f"ms, f32 CUDA-core bound {bound_ms:.4f} ms by {bound_by}{tc} "
        f"(peaks at 700 W; card limit {power})")
    return {**held, "ms": ms, "graph_ms": graph_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "split_bound_ms": split_ms, "split_bound_by": split_by,
            "tf32_bound_ms": tf32_ms, "tf32_bound_by": tf32_by,
            "library_ms": library_ms}


#: (Q, B, m) of pairwise_l2's ragged held calls: partial tiles, odd B and
#: m % 4 != 0 (the unvectorised staging)
RAGGED_L2 = ((130, 1001, 33), (7, 129, 256))


def ragged_calls(device: str = "cuda") -> dict:
    """Per kernel, argument tuples at shapes no main path gives it (numpy
    seed 1; the filter weights drawn as the filter suite draws them)."""
    import torch
    from repro_torch.bench.filters_bench import _make_stack, _offsets
    from repro_torch.core import filters
    from repro_torch.kernels.filter_mlp import kernel as mlp_kernel
    rng = np.random.default_rng(1)

    def randn(*shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                               device=device)
    calls = {"pairwise_l2": [(randn(q, m), randn(b, m))
                             for q, b, m in RAGGED_L2]}
    # (F, Q, m, h) of the fused entries: both designs, partial query tiles,
    # m % 4 != 0 and h not a multiple of a payload's 16-byte vector
    limit = mlp_kernel.STREAM_MAX_Q
    for F, n_q, m, h in ((7, 3, 40, 300), (9, 200, 33, 20),
                         (4, limit, 17, 37), (5, limit + 1, 17, 37)):
        q = randn(n_q, m)
        p32 = _make_stack(F, m, h, rng, device)
        off = _offsets(F, rng, device)
        for dt in ("float32", "bfloat16", "int8"):
            p = filters.quantize_mlp(p32, dt)
            calls.setdefault(mlp_kernel.ENTRY[p["w1"].dtype], []).append(
                (q, p["w1"], p["b1"], p["w2"], p["b2"], p["y_mean"],
                 p["y_std"], off, p.get("w1_scale"), p.get("w2_scale")))
    return calls


def check_kernels(captured: dict, launches: dict, power: str) -> list:
    """Each kernel against its plain version on the main paths' inputs; the
    fused entries also on their call with the fewest queries and on their
    largest call's weights at the Q on either side of the stream design's
    limit; the split-TF32 kernels also at ragged shapes (untimed)."""
    from repro_torch.kernels.filter_mlp import kernel as mlp_kernel
    ragged = ragged_calls()
    rows = []
    for name, (source, replaces, _, _) in KERNELS.items():
        if name not in captured:
            raise AssertionError(f"{name}: never called on the main path")
        args = captured[name][1]
        res = _check_call(name, args, name, power)
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": launches[name],
               **{k: res[k] for k in ("max_abs_err", "ms", "plain_ms",
                                      "bound_ms", "bound_by", "library_ms",
                                      "split_bound_ms", "split_bound_by",
                                      "tf32_bound_ms", "tf32_bound_by")},
               "design": DESIGN[name][0], "graph_ms": res["graph_ms"]}
        held = list(ragged.get(name, []))
        if f"{name}@min_q" in captured:
            small = captured[f"{name}@min_q"][1]
            n_q = small[0].shape[0]
            row["smallest_q_call"] = {
                "Q": n_q, "design": mlp_kernel.regime(n_q),
                **_check_call(name, small, f"{name} (Q={n_q}, "
                              f"{mlp_kernel.regime(n_q)} design)", power)}
            limit = mlp_kernel.STREAM_MAX_Q
            held += [(args[0][:n].contiguous(),) + tuple(args[1:])
                     for n in (1, limit, limit + 1)]
        if held:
            row["held_calls"] = []
            for call in held:
                label = name
                if name in mlp_kernel.LAUNCHES:
                    n_q = call[0].shape[0]
                    label = (f"{name} (Q={n_q}, {mlp_kernel.regime(n_q)} "
                             f"design)")
                row["held_calls"].append(_hold(name, call, f"{label}, held"))
        rows.append(row)
    return rows


def _ptxas_report(logs: dict) -> None:
    """Print each kernel's registers, shared memory and spills from the
    build's ``-Xptxas -v`` output; the redesigned kernels must not spill."""
    for lib, text in logs.items():
        if not text:
            log(f"  {lib}: already built, no ptxas report")
        func = "?"
        for line in text.splitlines():
            entry = re.search(r"Compiling entry function '(\w+)'", line)
            if entry:
                func = entry.group(1)
                continue
            if "registers" in line or "spill" in line:
                log(f"  {lib}: {func}: "
                    f"{line.removeprefix('ptxas info    :').strip()}")
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                              r"spill loads", line)
            if spill and any(k in func for k in SPLIT_KERNELS):
                assert spill.groups() == ("0", "0"), f"{func} spills: {line}"


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 2
    from repro_torch.kernels import common

    # full f32 everywhere: the reference accumulates in f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = card_line()
    log(card)
    power = card.split(",")[-1].strip()
    t0 = time.perf_counter()
    logs = common.build(["l2_scan", "filter_mlp", "box_lb"])
    log(f"kernels built in {time.perf_counter() - t0:.2f} s")
    _ptxas_report(logs)

    captured: dict = {}
    phases: dict = {}

    def phase(name, fn, *args, **kw):
        t = time.perf_counter()
        out = fn(*args, **kw)
        phases[name] = round(time.perf_counter() - t, 2)
        return out

    series = make_series()
    e2e = phase("dstree", run_end_to_end, device="cuda", captured=captured,
                series=series)
    phase("dstree breakdown", search_breakdown, e2e["lfi"], e2e["queries"])
    paths = [e2e["launches"]]
    paths.append(phase("search_early", run_early, e2e["lfi"],
                       e2e["queries"], e2e["results"], device="cuda",
                       captured=captured)["launches"])
    paths.append(phase("grouped", run_grouped, e2e["lfi"], e2e["queries"],
                       e2e["targets"], e2e["results"],
                       device="cuda")["launches"])
    n_filters = len(e2e["lfi"].leaf_ids)
    del e2e                               # the DSTree index leaves the card
    paths.append(phase("filter suite", run_filter_suite, n_filters,
                       device="cuda", captured=captured)["launches"])
    isax = phase("isax", run_isax, device="cuda", captured=captured,
                 series=series)
    phase("isax breakdown", search_breakdown, isax["lfi"], isax["queries"],
          reps=3, label="isax ")
    paths.append(isax["launches"])
    launches = {name: sum(p.get(name, 0) for p in paths) for name in KERNELS}
    log("launches on all paths: " + json.dumps(launches))
    rows = phase("kernel checks", check_kernels, captured, launches, power)
    log(f"phase wall times (s): {json.dumps(phases)}; script "
        f"{time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
