"""The single-query early walk: the port's plain walk against the JAX
package's ``_search_early_core``, the kernel's fixed-order row distance,
the kernel's scorer/walker protocol (emulated on the CPU by
``kernels/early_walk/ref.walk_emulated``) against the plain walk, the
bound, the wrapper's refusals and ``chip_smoke.py``'s held calls.

Inputs are made with numpy from a seed.  Against the JAX package the inputs
are tie-free (its distances are summed in another order): ids and all
three counters exact, distances within rtol 1e-5.  The emulation and the
plain walk share the distance, so they are held bitwise, ties included.
"""
import importlib.util
import inspect
import math
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import search as j_search
from repro_torch.core import search as t_search
from repro_torch.kernels import common
from repro_torch.kernels.early_walk import kernel as walk_kernel
from repro_torch.kernels.early_walk import ref
from _hypothesis_compat import given, settings, st
from _torch_threads import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(seed: int, L: int, m: int, max_leaf: int, *, filters: bool,
            small: bool = False, levels: bool = False):
    """numpy (series, leaf_start, leaf_size, q, d_lb, d_F, order): leaves of
    0 .. max_leaf rows (with ``small``, a third of them empty and a third
    below 5 rows), series padded by max_leaf rows as the reference slices
    them, bounds a random share of each leaf's nearest distance, the order
    a stable argsort of the bounds.  ``levels`` puts the series, the query
    and the bounds on coarse grids (ties everywhere)."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(0, max_leaf + 1, L)
    if small:
        pick = rng.random(L)
        sizes = np.where(pick < 1 / 3, 0, np.where(
            pick < 2 / 3, rng.integers(1, 5, L), sizes))
    sizes[rng.integers(L)] = max_leaf
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    n = int(sizes.sum())
    series = rng.standard_normal((n + max_leaf, m)).astype(np.float32)
    q = rng.standard_normal(m).astype(np.float32)
    if levels:
        series, q = np.round(series), np.round(q)
    d = np.sqrt(((series[:n].astype(np.float64) - q) ** 2).sum(1))
    mins = np.full(L, np.inf)
    np.minimum.at(mins, np.repeat(np.arange(L), sizes), d)
    mins = np.where(sizes > 0, mins, rng.uniform(0, 2 * math.sqrt(m), L))
    d_lb = (mins * rng.uniform(0, 1, L)).astype(np.float32)
    if levels:
        d_lb = np.round(d_lb)
    d_F = (mins * rng.uniform(0.8, 1.3, L)).astype(np.float32)
    if not filters:
        d_F[:] = -np.inf
    order = np.argsort(d_lb, kind="stable")
    return (series, starts.astype(np.int64), sizes.astype(np.int64), q,
            d_lb, d_F, order)


def _torch(arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _assert_bitwise(got, want):
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == w.dtype and torch.equal(g, w), (g, w)


@pytest.mark.parametrize("k", [1, 5, 33])
@pytest.mark.parametrize("filters", [False, True], ids=["off", "on"])
@pytest.mark.parametrize("small", [False, True], ids=["any", "small"])
def test_plain_walk_matches_reference(k, filters, small):
    """The port's plain walk against the JAX package's jitted walk on the
    same tie-free inputs, with empty leaves and leaves smaller than k."""
    for seed in range(3):
        arrays = _inputs(100 * k + seed, 48, 12, 20, filters=filters,
                         small=small)
        td, ti, n_s, n_plb, n_pf = j_search._search_early_core(
            *(jnp.asarray(a) for a in arrays), k=k, max_leaf=20)
        got = ref.early_walk(*_torch(arrays[:-1]),
                             torch.from_numpy(arrays[-1]), k)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(ti))
        assert int(got[2]) == int(n_s)
        assert 48 - int(got[3]) == int(n_plb)
        assert int(got[4]) == int(n_pf)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(td),
                                   rtol=1e-5)
        assert got[1].dtype == torch.int64 and got[2].dtype == torch.int32
        if not filters:
            assert int(n_pf) == 0


def test_plain_walk_reaches_every_branch():
    """Across the parametrized inputs the walk stops early, filter-prunes,
    searches empty leaves and leaves smaller than k."""
    stops = pruned = empty = 0
    for seed in range(3):
        arrays = _torch(_inputs(500 + seed, 48, 12, 20, filters=True,
                                small=True))
        stats = {}
        out = ref.early_walk(*arrays, 5, stats=stats)
        stops += int(out[3]) < 48
        pruned += int(out[4])
        empty += int((arrays[2][stats["searched"]] < 5).sum())
    assert stops and pruned and empty


@pytest.mark.parametrize("m", [1, 7, 65, 96, 128, 256, 300])
def test_row_distance_fixed_order(m):
    """The kernel's summation order agrees with torch's own sum within 2
    ulp, and is what its docstring says, term by term."""
    rng = np.random.default_rng(m)
    rows = torch.from_numpy(rng.standard_normal((50, m)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal(m).astype(np.float32))
    got = ref.row_distances(rows, q)
    want = torch.sqrt(((rows - q) ** 2).sum(-1))
    ulp = torch.nextafter(want, torch.full_like(want, math.inf)) - want
    assert ((got - want).abs() <= 2 * ulp).all()
    # by hand: lane l adds the squares of j with (j // 4) % 32 == l in
    # increasing j, then the lanes are added by halving
    for r in range(3):
        lanes = [np.float32(0)] * 32
        for j in range(m):
            t = np.float32(rows[r, j]) - np.float32(q[j])
            lanes[(j // 4) % 32] = np.float32(lanes[(j // 4) % 32]
                                              + np.float32(t * t))
        while len(lanes) > 1:
            h = len(lanes) // 2
            lanes = [np.float32(a + b) for a, b in zip(lanes[:h], lanes[h:])]
        assert np.sqrt(lanes[0]).view(np.int32) == \
            got[r].numpy().view(np.int32)


def test_items_per_leaf():
    """64-row items, a power of two of them up to 32 a leaf, then 32 items
    of ceil(max_leaf / 32) rows."""
    assert ref.items_per_leaf(0) == (64, 1)
    assert ref.items_per_leaf(64) == (64, 1)
    assert ref.items_per_leaf(65) == (64, 2)
    assert ref.items_per_leaf(245) == (64, 4)
    assert ref.items_per_leaf(256) == (64, 4)
    assert ref.items_per_leaf(1000) == (64, 16)
    assert ref.items_per_leaf(2048) == (64, 32)
    assert ref.items_per_leaf(2049) == (65, 32)


#: (lag, ring) of the emulated protocol: the freshest published bsf and the
#: kernel's ring; a bsf three and eight steps stale in rings that fill and
#: wrap; a walker that never publishes in time (every pre-test at +inf)
WALKS = [(0, ref.RING), (3, 32), (8, 64), (10 ** 9, 32)]


@pytest.mark.parametrize("lag, ring", WALKS)
def test_emulated_protocol_equals_plain_walk(lag, ring):
    """The kernel's protocol (scorers claiming (leaf, rows) items in visit
    order and pre-testing them against a bsf that lags by ``lag`` steps,
    dropping an item a fresher bsf decides, a ring of ``ring`` slots, the
    walker's lane-parallel re-test and one-by-one merges, each leaf decided
    from the bsf just before it), emulated, equals the plain walk bitwise,
    ties included."""
    @settings(max_examples=20, deadline=None)
    @given(seed=st.integers(0, 2 ** 31 - 1), L=st.integers(1, 70),
           max_leaf=st.sampled_from([0, 3, 20, 100, 300]),
           k=st.sampled_from([1, 2, 5, 32, 33]),
           filters=st.sampled_from([False, True]),
           levels=st.sampled_from([False, True]))
    def check(seed, L, max_leaf, k, filters, levels):
        arrays = _torch(_inputs(seed, L, 9, max_leaf, filters=filters,
                                small=seed % 2 == 0, levels=levels))
        want = ref.early_walk(*arrays, k)
        got = ref.walk_emulated(*arrays, k, max_leaf=max_leaf, lag=lag,
                                ring=ring)
        _assert_bitwise(got, want)
    check()


@pytest.mark.parametrize("lag", [0, 2, 10 ** 9])
def test_emulated_ring_fills_and_wraps(lag):
    """Many leaves through a 32-slot ring: the scorers wrap it many times,
    waiting for the walker, and the result is still the plain walk's."""
    arrays = _torch(_inputs(7, 300, 8, 100, filters=True, levels=True))
    arrays = arrays[:4] + (arrays[4] * 0,) + arrays[5:]   # visit every leaf
    stats = {}
    want = ref.early_walk(*arrays, 5)
    got = ref.walk_emulated(*arrays, 5, max_leaf=100, lag=lag, ring=32,
                            stats=stats)
    _assert_bitwise(got, want)
    assert stats["wraps"] >= 10 and int(want[3]) == 300


def test_emulation_on_chip_smoke_held_calls():
    """``chip_smoke.py``'s held calls cover the kernel's edges (k = 1, 5,
    32, 33 and 257; m = 65, 96, 128; a leaf of 1,000 rows;
    empty leaves and leaves smaller than k; tied rows and tied bounds;
    d_F at +-inf; a call with no filter-pruned leaf, one whose walk stops
    right after its first leaf), and the emulated protocol is the plain
    walk there, bitwise."""
    smoke = _load_smoke()
    calls = smoke.early_walk_calls(device="cpu")
    ks, ms, leaves = set(), set(), 0
    seen = set()
    for call, (L, m, max_leaf, k, kind) in zip(calls, smoke.RAGGED_EARLY):
        series, starts, sizes, q, d_lb, d_F, order, k2, max2 = call
        assert (k2, max2, q.shape[0], starts.shape[0]) == (k, max_leaf, m, L)
        ks.add(k)
        ms.add(m)
        leaves = max(leaves, int(sizes.max()))
        stats = {}
        want = ref.early_walk(*call[:-1], stats=stats)
        got = ref.walk_emulated(*call[:-1], max_leaf=max_leaf, lag=2,
                                ring=64)
        _assert_bitwise(got, want)
        searched = sizes[stats["searched"]]
        if (searched == 0).any() and ((searched > 0) & (searched < k)).any():
            seen.add("small")
        if int(want[4]) == 0 and int(want[2]) > 1:
            seen.add("no filter-pruned")
        if int(want[3]) == 1:
            seen.add("first")
        if torch.isinf(d_F).any() and (d_F == -math.inf).any():
            seen.add("inf")
        if d_lb.unique().numel() < L // 2:
            seen.add("tied bounds")
        dist = ref.row_distances(series[:int(sizes.sum())], q)
        if dist.unique().numel() < dist.numel():
            seen.add("tied rows")
    assert {1, 5, 32, 33, 257} <= ks and {65, 96, 128} <= ms
    assert leaves == 1000
    assert seen == {"small", "no filter-pruned", "first", "inf",
                    "tied bounds", "tied rows"}


def test_bound_bytes_counts_what_the_walk_needs():
    """``ref.bound_bytes`` against a count by hand."""
    arrays = _torch(_inputs(3, 40, 16, 10, filters=True, small=True))
    stats = {}
    out = ref.early_walk(*arrays, 5, stats=stats)
    n_vis = int(out[3])
    rows = sum(int(arrays[2][leaf]) for leaf in stats["searched"])
    by_hand = (12 * min(n_vis + 1, 40) + 4 * n_vis + 4 * 16 * rows + 4 * 16
               + 12 * 5 + 12)
    assert ref.bound_bytes(arrays[2], stats["searched"], n_vis, 16, 5) \
        == by_hand
    assert 0 < n_vis < 40 and rows > 0
    # a walk over every leaf reads no stopping position
    assert ref.bound_bytes(arrays[2], [], 40, 16, 1) == \
        12 * 40 + 4 * 40 + 4 * 16 + 12 + 12


def test_kernel_wrapper_checks_before_it_builds():
    """The wrapper refuses misplaced or mistyped tensors before it builds
    anything, and a tensor off the CPU goes to the kernel (here, without
    nvcc or a card, that raises): no fallback to the plain walk."""
    arrays = list(_torch(_inputs(1, 20, 8, 10, filters=True)))
    bad = [(5, arrays[5].double(), TypeError),
           (6, arrays[6].int(), TypeError),
           (4, arrays[4][:10], ValueError),
           (3, arrays[3][:5], ValueError),
           (0, arrays[0].t(), ValueError),
           (3, torch.empty(8, device="meta"), ValueError)]
    for i, t, err in bad:
        args = list(arrays)
        args[i] = t
        with pytest.raises(err):
            walk_kernel.early_walk_cuda(*args, 5, 10)
    with pytest.raises(ValueError, match="k must"):
        walk_kernel.early_walk_cuda(*arrays, 0, 10)
    meta = [a.to("meta") for a in arrays]
    with pytest.raises(RuntimeError):
        walk_kernel.early_walk_cuda(*meta, 5, 10)
    assert walk_kernel.LAUNCHES == {"early_walk": 0}


def test_c_entry_matches_the_binding():
    """The C entries and their arguments match the binding; the source
    names what it replaces, its ring, control words and top-k limit are
    the wrapper's and the emulation's, it launches cooperatively, and it
    sums with the rounded intrinsics only (no contracted a*a + s)."""
    text = (common.CSRC / "early_walk.cu").read_text()
    entries = re.findall(r'extern "C" int (\w+)\(([^)]*)\)', text)
    assert [name for name, _ in entries] == ["early_walk",
                                             "early_walk_layout"]
    for name, params in entries:
        assert len(params.split(",")) == len(walk_kernel._SIGNATURES[name])
    assert "src/repro/core/search.py:327" in text
    assert re.search(rf"constexpr int RING = {ref.RING};", text)
    assert re.search(rf"constexpr int CTL = {walk_kernel.CTL};", text)
    assert re.search(rf"constexpr int REG_MAX_K = "
                     rf"{walk_kernel.REG_MAX_K};", text)
    assert "cudaLaunchAttributeCooperative" in text
    body = text[text.index("__device__ __forceinline__ float term("):
                text.index("__device__ __forceinline__ float least(")]
    assert "__fsub_rn" in body and "__fmul_rn" in body
    assert "__fadd_rn" in body and "__fsqrt_rn" in body
    assert not re.search(r"acc\[g\] \+=|\* t\b|sqrtf", body)
    assert "__shfl_xor_sync(FULL, acc[g], off)" in body


def test_search_early_card_path_copies_once():
    """``search_early`` makes its one host copy at the end: no
    ``.item()``, ``.numpy()`` before it, no merge of the replay's plain
    version; it launches the walk wrapper for tensors off the CPU."""
    src = inspect.getsource(t_search.search_early)
    body = src[src.index('"""', src.index('"""') + 3):]
    assert body.count(".cpu()") == 1
    head = body[:body.index(".cpu()")]
    for name in (".item()", ".numpy()", "merge_topk", "tolist"):
        assert name not in head
    assert "walk_kernel.early_walk_cuda" in body
    assert "walk_ref.early_walk" in body
    assert not hasattr(t_search, "_leaf_distances")
    assert not hasattr(t_search, "_EARLY_CHUNK")


def test_chip_smoke_early_phases_on_cpu(capsys):
    """``search_early``'s phases as ``chip_smoke.py`` drives them (under the
    iSAX phase's label too) and its breakdown, at a tiny size on the CPU,
    where no kernel launches and no walk call is captured."""
    smoke = _load_smoke()
    out = smoke.run_end_to_end(n=2000, m=64, n_queries=16, n_brute=8,
                               leaf_capacity=64, n_global=60, n_local=16,
                               epochs=3, device="cpu")
    captured: dict = {}
    early = smoke.run_early(out["lfi"], out["queries"], out["results"],
                            n_early=4, device="cpu", captured=captured,
                            label="isax ")
    assert early["launches"]["early_walk"] == 0 and not captured
    parts = smoke.early_breakdown(out["lfi"], out["queries"], n_early=3,
                                  device="cpu")
    assert set(parts) == {"exact", "0.99"}
    for name, steps in parts.items():
        assert list(steps) == list(smoke.EARLY_STEPS) + ["sum", "whole call"]
        assert min(steps.values()) >= 0
    printed = capsys.readouterr().out
    assert "isax search_early exact search == brute force on 4 queries" \
        in printed
    assert "isax search_early k=5 target=0.99" in printed
    assert "search_early breakdown k=5 target=0.99 (ms, medians over 3" \
        in printed
    assert "early_walk" in smoke.SEARCH_KERNELS
    assert "early_walk" not in smoke.GROUPED_KERNELS
    assert "early_walk_kernel" in smoke.SPLIT_KERNELS
    assert smoke.KERNELS["early_walk"][2] == (0.0, 0.0)
