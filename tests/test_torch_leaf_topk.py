"""The candidate pass: the port's plain version (``kernels/leaf_topk/ref.py``,
what the CUDA kernel ``csrc/leaf_topk.cu`` computes and is held against on
the card) against the JAX package's ``_bucket_leaf_topk``, and the engine's
argument builder (``engine.survivor_lists``) against the survivor lists the
reference's buckets pass.

Tolerance: distances within 1e-4 + 1e-5·|d| (f32 sums over m in another
order; the kernels' limit), ids exact on tie-free rows, and where rows are
repeated within a leaf (exact ties) too: both sides put the lower row first.
+inf and id −1 must sit at the same places.
"""
import importlib.util
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bounds
from repro.core import engine as j_engine
from repro.core import tree
from repro_torch.core import engine
from repro_torch.core import tree as t_tree
from repro_torch.kernels.leaf_topk import kernel as leaf_kernel
from repro_torch.kernels.leaf_topk import ref
from _torch_threads import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
ATOL, RTOL = 1e-4, 1e-5


def _load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _index(seed: int, L: int, max_leaf: int, m: int, Q: int, C: int):
    """numpy (series, leaf_start, leaf_size, queries, leaves): ragged leaves
    (one of size 1, one of max_leaf), z-normalized random-walk rows padded
    by max_leaf, queries near rows; per query C distinct survivor leaves
    with padding (id L) in some slots."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, max_leaf + 1, L)
    sizes[0], sizes[-1] = 1, max_leaf
    start = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    n = int(sizes.sum())
    x = rng.standard_normal((n + max_leaf, m)).cumsum(-1)
    x = ((x - x.mean(-1, keepdims=True)) / x.std(-1, keepdims=True))
    q = x[rng.integers(0, n, Q)] + 0.2 * rng.standard_normal((Q, m))
    leaves = np.stack([rng.choice(L, C, replace=False) for _ in range(Q)])
    leaves[rng.random((Q, C)) < 0.2] = L
    return (x.astype(np.float32), start, sizes.astype(np.int64),
            q.astype(np.float32), leaves.astype(np.int64))


def _reference(arrays, kk, max_leaf, impl):
    """The JAX package's pass over every slot: (vals, ids) (Q, C, kk)."""
    series, start, sizes, q, leaves = arrays
    vals, ids = j_engine._bucket_leaf_topk(
        jnp.asarray(series), jnp.asarray(start), jnp.asarray(sizes),
        jnp.asarray(q), jnp.asarray(leaves), kk=kk, max_leaf=max_leaf,
        chunk=leaves.shape[1], dist_impl=impl)
    return np.array(vals), np.asarray(ids).astype(np.int64)


def _port(arrays, kk, max_leaf, impl, *, scatter, counts=None):
    series, start, sizes, q, leaves = (torch.from_numpy(a) for a in arrays)
    Q, C = leaves.shape
    rows = start.shape[0] + 1 if scatter else C
    counts = torch.full((Q,), C) if counts is None else counts
    out_d = torch.full((Q, rows, kk), np.inf)
    out_i = torch.full((Q, rows, kk), -1, dtype=torch.int64)
    ref.leaf_topk(series, start, sizes, q, leaves, counts, kk, max_leaf,
                  impl, out_d, out_i, scatter)
    return out_d.numpy(), out_i.numpy()


def _assert_close(got_d, got_i, want_d, want_i):
    fin = np.isfinite(want_d)
    np.testing.assert_array_equal(np.isfinite(got_d), fin)
    np.testing.assert_allclose(got_d[fin], want_d[fin], rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got_i, want_i)
    assert (want_i[~fin] == -1).all()


@pytest.mark.parametrize("m", [7, 96])
@pytest.mark.parametrize("kk", [1, 5, 33])
@pytest.mark.parametrize("impl", ["direct", "matmul"])
def test_plain_pass_matches_reference(impl, kk, m):
    """Ragged leaves (sizes 1 .. 300, max_leaf above 256), padding slots,
    both distance forms: the port's plain pass by slot equals the JAX
    package's pass within the tolerance, ids exactly."""
    arrays = _index(kk * 7 + m, L=12, max_leaf=300, m=m, Q=6, C=8)
    want_d, want_i = _reference(arrays, kk, 300, impl)
    got_d, got_i = _port(arrays, kk, 300, impl, scatter=False)
    assert np.isfinite(want_d).any() and (~np.isfinite(want_d)).any()
    _assert_close(got_d, got_i, want_d, want_i)


@pytest.mark.parametrize("impl", ["direct", "matmul"])
def test_scatter_writes_each_leaf_row(impl):
    """``scatter``: each slot's kk values land in the row of its leaf id
    (padding slots in the scratch row L); rows no slot names stay +inf/−1."""
    arrays = _index(3, L=20, max_leaf=64, m=32, Q=5, C=6)
    L, kk = 20, 5
    want_d, want_i = _reference(arrays, kk, 64, impl)
    got_d, got_i = _port(arrays, kk, 64, impl, scatter=True)
    exp_d = np.full(got_d.shape, np.inf, np.float32)
    exp_i = np.full(got_i.shape, -1, np.int64)
    leaves = arrays[4]
    for q in range(leaves.shape[0]):
        exp_d[q, leaves[q]] = want_d[q]
        exp_i[q, leaves[q]] = want_i[q]
    _assert_close(got_d[:, :L], got_i[:, :L], exp_d[:, :L], exp_i[:, :L])


def test_counts_bound_each_list():
    """Slots past a query's count are not computed, whatever leaf id they
    hold; a count of 0 writes nothing."""
    arrays = _index(5, L=16, max_leaf=40, m=16, Q=4, C=8)
    arrays[4][arrays[4] == 16] = 0                 # no padding: all valid
    counts = torch.tensor([8, 3, 0, 1])
    got_d, got_i = _port(arrays, 2, 40, "direct", scatter=False,
                         counts=counts)
    want_d, want_i = _reference(arrays, 2, 40, "direct")
    for q, c in enumerate(counts.tolist()):
        _assert_close(got_d[q, :c], got_i[q, :c], want_d[q, :c],
                      want_i[q, :c])
        assert np.isinf(got_d[q, c:]).all() and (got_i[q, c:] == -1).all()


def test_buckets_round_counts_up_to_powers_of_two():
    got = ref.buckets(np.array([0, 1, 3, 4, 5, 9, 600]), 512)
    assert got == {1: [0, 1], 4: [2, 3], 8: [4], 16: [5], 512: [6]}


@pytest.fixture(scope="module")
def indexes(randwalk_small):
    S = randwalk_small[:2000]
    return tree.build_dstree(S, leaf_capacity=64), \
        t_tree.build_dstree(S, leaf_capacity=64)


@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("k", [1, 5])
def test_survivor_lists_match_reference_buckets(indexes, queries_small,
                                                monkeypatch, k, filtered):
    """The arguments the engine hands the pass on both devices (survivor
    lists in ascending-lb order, L past each count, and the counts) hold
    the same leaves in the same order as the lists the reference's
    survivor buckets pass its ``_bucket_leaf_topk``, query by query."""
    ref_index, index = indexes
    q = queries_small[:16]
    d_lb = np.array(bounds.lower_bounds(ref_index, jnp.asarray(q)))
    d_F = np.full(d_lb.shape, -np.inf, np.float32)
    if filtered:
        noise = np.random.default_rng(0).standard_normal(d_lb.shape)
        d_F = (d_lb * (1.4 + 0.4 * noise) + 2.0).astype(np.float32)
    L = index.n_leaves

    seen = []
    run = j_engine._bucket_leaf_topk

    def record(series, leaf_start, leaf_size, queries_b, leaf_b, **kw):
        seen.append((np.asarray(queries_b), np.asarray(leaf_b)))
        return run(series, leaf_start, leaf_size, queries_b, leaf_b, **kw)
    monkeypatch.setattr(j_engine, "_bucket_leaf_topk", record)
    j_engine.run_cascade(
        jnp.asarray(index.series.numpy()), jnp.asarray(index.leaf_start),
        jnp.asarray(index.leaf_size), jnp.asarray(q), jnp.asarray(d_lb),
        jnp.asarray(d_F), k=k, max_leaf=index.max_leaf_size,
        strategy="compact", dist_impl="direct")

    built = []
    run_port = engine.survivor_lists
    monkeypatch.setattr(engine, "survivor_lists",
                        lambda *a: built.append(run_port(*a)) or built[-1])
    engine.run_cascade(index.series, index.leaf_start, index.leaf_size,
                       torch.from_numpy(q), torch.from_numpy(d_lb),
                       torch.from_numpy(d_F), k=k,
                       max_leaf=index.max_leaf_size, dist_impl="direct")
    leaves, counts = (a.numpy() for a in built[0])
    assert leaves.shape == (16, L)

    covered = set()
    for queries_b, leaf_b in seen[1:]:               # seen[0]: the probe
        for row, lst in zip(queries_b, leaf_b):
            if (lst == L).all():
                continue                              # a padded query row
            qi = int(np.flatnonzero((q == row).all(1))[0])
            want = lst[lst < L]
            np.testing.assert_array_equal(leaves[qi, :counts[qi]], want)
            assert (leaves[qi, counts[qi]:] == L).all()
            covered.add(qi)
    assert covered == set(range(16))


def test_leaf_major_order_puts_the_pairs_first_by_leaf():
    """The kernel's pair order (``leaf_major``): every slot to compute
    (below its count, id in [0, L)) ahead of the others, in ascending leaf
    id, queries in order within a leaf; a permutation of all Q·C slots.
    Real ids past a count sort with the padding."""
    leaves = torch.tensor([[3, 0, 5, 1], [0, 3, 5, 2], [2, 4, 0, 5]])
    counts = torch.tensor([2, 3, 1])
    order = leaf_kernel.leaf_major(leaves, counts, 5)
    assert sorted(order.tolist()) == list(range(12))
    assert order[:5].tolist() == [1, 4, 8, 0, 5]
    assert order[5:].tolist() == [2, 3, 6, 7, 9, 10, 11]


def _warp_walk(order: torch.Tensor, leaves, counts, L: int,
               n_warps: int) -> list:
    """The slots the kernel's warps score, walked as ``leaf_topk_kernel``
    walks them: warp w takes the order's entries w, w + n_warps, ... and
    stops at its first slot with nothing to compute."""
    Q, C = leaves.shape
    done = []
    for w in range(n_warps):
        for p in range(w, Q * C, n_warps):
            flat = int(order[p])
            q, c = divmod(flat, C)
            leaf = int(leaves[q, c]) if c < int(counts[q]) else L
            if leaf < 0 or leaf >= L:
                break
            done.append(flat)
    return sorted(done)


@pytest.mark.parametrize("n_warps", [1, 3, 8, 64])
def test_warps_score_every_slot_to_compute_once(n_warps):
    """With the wrapper's order, the warps' walk (stopping at the first
    slot with nothing to compute) scores exactly the slots below their
    counts whose ids lie in [0, L), each once, whatever the lists hold past
    their counts (real ids, padding, negative ids)."""
    rng = np.random.default_rng(n_warps)
    Q, C, L = 9, 7, 11
    leaves = torch.from_numpy(rng.integers(-1, L + 1, (Q, C)))
    counts = torch.from_numpy(rng.integers(0, C + 1, Q))
    counts[0], counts[1] = 0, C
    order = leaf_kernel.leaf_major(leaves, counts, L)
    want = [q * C + c for q in range(Q) for c in range(C)
            if c < counts[q] and 0 <= leaves[q, c] < L]
    assert _warp_walk(order, leaves, counts, L, n_warps) == want


@pytest.mark.parametrize("bad, err", [
    (dict(dist_impl="pairwise"), ValueError),
    (dict(kk=4), ValueError),
    (dict(counts=torch.ones(3, dtype=torch.int32)), TypeError),
    (dict(scatter=True), ValueError),
    (dict(leaf_size=torch.ones(7, dtype=torch.int64)), ValueError),
])
def test_wrapper_refuses_before_any_launch(bad, err):
    """The kernel wrapper checks its arguments before it builds or
    launches anything (here, where no kernel can build)."""
    arrays = _index(1, L=8, max_leaf=16, m=8, Q=3, C=4)
    series, start, sizes, q, leaves = (torch.from_numpy(a) for a in arrays)
    args = dict(series=series, leaf_start=start, leaf_size=sizes, queries=q,
                leaves=leaves, counts=torch.full((3,), 4), kk=2, max_leaf=16,
                dist_impl="matmul", out_d=torch.zeros((3, 4, 2)),
                out_i=torch.zeros((3, 4, 2), dtype=torch.int64),
                scatter=False)
    args.update(bad)
    with pytest.raises(err):
        leaf_kernel.leaf_topk_cuda(**args)


# ---------------------------------------------------------------------------
# chip_smoke.py's candidate-pass checks, rehearsed on the CPU
# ---------------------------------------------------------------------------


def test_chip_smoke_holds_and_counts_the_pass():
    """chip_smoke.py builds the pass's source, holds it with the kernels'
    limit, counts its launches on the DSTree, iSAX and grouped paths (not
    search_early's, whose walk does not reach it) and rejects a spill of
    either instance; the profile's name of the staged instance drops its
    namespaces."""
    smoke = _load_smoke()
    source, replaces, tol, _ = smoke.KERNELS["leaf_topk"]
    assert (ROOT / source).exists() and tol == (ATOL, RTOL)
    assert replaces.startswith("no Pallas kernel")
    assert "src/repro/core/engine.py:271" in replaces
    assert smoke.DESIGN["leaf_topk"][1] is None
    assert "leaf_topk_kernel" in smoke.SPLIT_KERNELS
    assert "leaf_topk_wgmma_kernel" in smoke.SPLIT_KERNELS
    assert smoke._kernel_name(
        "void (anonymous namespace)::staged::leaf_topk_wgmma_kernel<5>("
        "CUtensorMap_st, (anonymous namespace)::staged::Args)") \
        == "leaf_topk_wgmma_kernel"
    for path in (smoke.DSTREE_KERNELS, smoke.ISAX_KERNELS,
                 smoke.GROUPED_KERNELS):
        assert "leaf_topk" in path
    assert "leaf_topk" not in smoke.SEARCH_KERNELS
    text = (ROOT / source).read_text()
    assert "src/repro/core/engine.py:271" in text
    assert "leaf_topk_wgmma_kernel" in text
    assert '"leaf_topk"]' in (ROOT / "chip_smoke.py").read_text()


@pytest.mark.parametrize("n", range(6))
@pytest.mark.parametrize("impl", ["matmul", "direct"])
def test_chip_smoke_held_calls_match_reference(impl, n):
    """Each of chip_smoke.py's ragged held calls (kk = 1 .. 257, max leaf
    7 .. 1000, m = 65 .. 256, Q = 1, empty lists, padding inside the
    count, repeated rows, the probe's form): the plain version the card
    holds the kernel to agrees with the JAX package's pass under the hold
    the card applies (``_leaf_topk_errors``: distances within the limit,
    ids equal except at near-ties; the repeated rows' exact ties go to the
    lower row on both sides)."""
    smoke = _load_smoke()
    call = smoke._leaf_topk_fresh(smoke.leaf_topk_calls("cpu")[n], impl)
    series, start, sizes, q, leaves, counts, kk, max_leaf = call[:8]
    scatter = call[11]
    L = start.shape[0]
    slot = torch.arange(leaves.shape[1])
    lists = torch.where(slot < counts[:, None], leaves, L).numpy()
    want_d, want_i = _reference((series.numpy(), start.numpy(),
                                 sizes.numpy(), q.numpy(), lists), kk,
                                max_leaf, impl)
    got = ref.leaf_topk(*call)
    if scatter:
        exp_d = np.full(got[0].shape, np.inf, np.float32)
        exp_i = np.full(got[1].shape, -1, np.int64)
        for qi in range(lists.shape[0]):
            exp_d[qi, lists[qi]] = want_d[qi]
            exp_i[qi, lists[qi]] = want_i[qi]
        exp_d[:, L], exp_i[:, L] = np.inf, -1       # the scratch row
        want_d, want_i = exp_d, exp_i
    errs = smoke._leaf_topk_errors(
        call, got, (torch.from_numpy(want_d), torch.from_numpy(want_i)))
    assert errs["ok"], errs
    assert errs["id_diff"] <= 1e-4 * want_i.size


def _planted(kind: str):
    """chip_smoke's first ragged call, its plain outputs, and a copy with
    one fault planted (or, for ``tie``, an allowed swap)."""
    smoke = _load_smoke()
    call = smoke.leaf_topk_calls("cpu")[0]
    want = ref.leaf_topk(*smoke._leaf_topk_fresh(call))
    got_d, got_i = (t.clone() for t in want)
    series, start, sizes, q = call[:4]
    fin = torch.isfinite(want[0][0])
    rows = torch.nonzero(fin.all(-1))[:, 0]
    r = int(rows[0])
    leaf_rows = torch.arange(int(start[r]), int(start[r] + sizes[r]))
    d = torch.sqrt(torch.clamp_min((q[0] ** 2).sum() + (series[leaf_rows] ** 2)
                                   .sum(1) - 2 * series[leaf_rows] @ q[0], 0))
    if kind == "tie":
        # a row a hair (below the limit) from the plain version's 2nd place
        j = 1
        alt = leaf_rows[torch.argsort((d - want[0][0, r, j]).abs())[1]]
        got_i[0, r, j] = alt
        got_d[0, r, j] = want[0][0, r, j]
        d_alt = float(d[alt - start[r]])
        return smoke, call, (got_d, got_i), want, abs(
            d_alt - float(want[0][0, r, j]))
    if kind == "swap":                 # two distinct ranks' ids exchanged
        got_i[0, r, [0, 4]] = got_i[0, r, [4, 0]]
    elif kind == "value":
        got_d[0, r, 0] += 1e-2
    elif kind == "other_leaf":         # a row of another leaf
        got_i[0, r, 2] = int(start[r] + sizes[r])
    elif kind == "repeat":
        got_i[0, r, 3] = got_i[0, r, 2]
    elif kind == "inf":
        got_d[0, r, 4], got_i[0, r, 4] = np.inf, -1
    return smoke, call, (got_d, got_i), want, None


@pytest.mark.parametrize("kind", ["swap", "value", "other_leaf", "repeat",
                                  "inf"])
def test_chip_smoke_hold_rejects_planted_faults(kind):
    smoke, call, got, want, _ = _planted(kind)
    errs = smoke._leaf_topk_errors(call, got, want)
    assert not errs["ok"], errs


def test_chip_smoke_hold_admits_near_ties_only():
    """A different row at a rank is admitted when its plain-form distance
    lies within the limit of the plain version's at that rank, and counted;
    the same swap with the limit cut below that gap is rejected."""
    smoke, call, got, want, gap = _planted("tie")
    errs = smoke._leaf_topk_errors(call, got, want)
    tol = errs["tolerance"]
    if gap <= tol:
        assert errs["ok"] and errs["id_diff"] == 1 and errs["near_ties"] == 1
    else:
        assert not errs["ok"] and errs["near_ties"] == 0


def test_chip_smoke_leaf_topk_bound():
    """The pass's bound counts this call's survivors: the distinct rows
    once (or each pair's rows, ``per_pair``), 2m operations a pair's row
    and 2m a distinct row under matmul, at the float32 peak or, given
    passes, that many times at the TF32 tensor-core peak."""
    from repro_torch.analysis import roofline
    smoke = _load_smoke()
    call = smoke.leaf_topk_calls("cpu")[2]
    _, start, sizes, q, leaves, counts, kk = call[:7]
    Q, m = q.shape
    lf = [int(x) for i in range(Q) for x in leaves[i, :counts[i]]
          if x < start.shape[0]]
    pair_rows = int(sum(int(sizes[x]) for x in lf))
    distinct = int(sum(int(sizes[x]) for x in set(lf)))
    assert smoke._leaf_topk_work(call) == (len(lf), pair_rows, distinct)
    small = (4 * Q * m + 8 * leaves.numel() + 8 * Q + 16 * start.shape[0]
             + 12 * kk * len(lf))
    flops = 2 * m * (pair_rows + distinct)
    for per_pair, rows, passes in ((False, distinct, None),
                                   (True, pair_rows, None),
                                   (False, distinct, 3), (False, distinct, 1)):
        ms, by = smoke._leaf_topk_bound(call, per_pair=per_pair,
                                        passes=passes)
        t_ops = (flops / roofline.H100.peak_flops if passes is None
                 else passes * flops / roofline.H100.tf32_flops)
        t_bytes = (4 * m * rows + small) / roofline.H100.hbm_bw
        assert ms == pytest.approx(max(t_ops, t_bytes) * 1e3)
        assert by == ("operations" if t_ops >= t_bytes else "bytes")
    assert smoke._bound("leaf_topk", call) == smoke._leaf_topk_bound(call)
    assert (smoke._bound("leaf_topk", call, 3)
            == smoke._leaf_topk_bound(call, passes=3))


def test_chip_smoke_captures_the_pass_and_the_probe(indexes, queries_small,
                                                    monkeypatch):
    """The capture keeps the largest batch call of the pass (by list slots
    x kk: a k = 5 call outranks a k = 1 one) and the probe's apart, and
    under ``max_q`` only calls of that many queries at most; the wrapper's
    counter counts every launch."""
    smoke = _load_smoke()
    _, index = indexes
    monkeypatch.setattr(leaf_kernel, "leaf_topk_cuda", ref.leaf_topk)
    monkeypatch.setattr(engine, "_bucket_leaf_topk",
                        lambda *a: leaf_kernel.leaf_topk_cuda(*a))
    q = torch.from_numpy(queries_small[:8])
    d_lb = torch.zeros((8, index.n_leaves))
    d_F = torch.full(d_lb.shape, -np.inf)
    captured: dict = {}
    with smoke.capture_largest_inputs(captured):
        for k in (1, 5):
            engine.run_cascade(index.series, index.leaf_start,
                               index.leaf_size, q, d_lb, d_F, k=k,
                               max_leaf=index.max_leaf_size)
    assert set(captured) == {"leaf_topk", "leaf_topk@probe"}
    assert captured["leaf_topk"][1][6] == 5 and captured["leaf_topk"][1][11]
    assert captured["leaf_topk@probe"][1][4].shape == (8, 1)
    # ``max_q`` reads the pass's queries (its fourth argument), not the
    # series: 8 queries are kept under 8 and dropped under 4
    for max_q, keys in ((8, {"leaf_topk", "leaf_topk@probe"}), (4, set())):
        some: dict = {}
        with smoke.capture_largest_inputs(some, max_q=max_q):
            engine.run_cascade(index.series, index.leaf_start,
                               index.leaf_size, q, d_lb, d_F, k=5,
                               max_leaf=index.max_leaf_size)
        assert set(some) == keys, max_q
    assert leaf_kernel.leaf_topk_cuda is ref.leaf_topk


# ---------------------------------------------------------------------------
# the staged (wgmma) instance: its item table, its choice, its arithmetic
# ---------------------------------------------------------------------------


def _lists(case: str, rng):
    """(leaves, counts, L) survivor lists for an item-table case."""
    G = leaf_kernel.GROUP
    if case == "random":            # padding (id L) and real ids past counts
        Q, C, L = 23, 9, 13
        leaves = rng.integers(0, L + 1, (Q, C))
        counts = rng.integers(0, C + 1, Q)
    elif case == "empty":           # every list empty
        Q, C, L = 5, 4, 6
        leaves = np.full((Q, C), L)
        counts = np.zeros(Q, np.int64)
    elif case == "zero_counts":     # real ids, but counts of 0 for most
        Q, C, L = 9, 5, 7
        leaves = np.stack([rng.permutation(L)[:C] for _ in range(Q)])
        counts = np.where(np.arange(Q) % 3 == 0, C, 0)
    elif case == "kept_by_all":     # leaf 2 in every list
        Q, C, L = 40, 6, 10
        leaves = np.stack([np.r_[2, rng.choice([x for x in range(L)
                                                if x != 2], C - 1, False)]
                           for _ in range(Q)])
        counts = np.full(Q, C)
    else:                           # "over_group": leaves kept by > G queries
        Q, C, L = 3 * G + 5, 3, 4
        leaves = np.stack([rng.permutation(L)[:C] for _ in range(Q)])
        counts = rng.integers(1, C + 1, Q)
    return (torch.as_tensor(leaves, dtype=torch.int64),
            torch.as_tensor(counts, dtype=torch.int64), L)


def _decode_items(pair_order, bounds, item_end, item_leaf, C: int,
                  group: int) -> list:
    """The items as the staged kernel finds them: item i's leaf from
    item_leaf, its queries from bounds and the order."""
    items = []
    n = int(item_end[-1]) if len(item_end) else 0
    assert n <= item_leaf.numel()
    for i in range(n):
        leaf = int(item_leaf[i])
        assert item_end[leaf] > i and (leaf == 0 or item_end[leaf - 1] <= i)
        first = int(item_end[leaf - 1]) if leaf else 0
        pair0 = int(bounds[leaf]) + group * (i - first)
        nq = min(group, int(bounds[leaf + 1]) - pair0)
        slots = pair_order[pair0:pair0 + nq].tolist()
        items.append((leaf, slots, [s // C for s in slots]))
    return items


@pytest.mark.parametrize("case", ["random", "empty", "zero_counts",
                                  "kept_by_all", "over_group"])
def test_item_table_covers_every_slot_once(case):
    """The staged instance's items (``kernel.item_table``, decoded as the
    kernel decodes them; item_leaf names each item's leaf, and L past the
    last): every slot to compute (below its count, id in
    [0, L)) lies in exactly one item and no other slot in any; a leaf kept
    by n_q queries has ceil(n_q / G) items; no item crosses leaves; the
    queries of an item are ascending."""
    G = leaf_kernel.GROUP
    leaves, counts, L = _lists(case, np.random.default_rng(len(case)))
    Q, C = leaves.shape
    pair_order, bounds, item_end, item_leaf = leaf_kernel.item_table(
        leaves, counts, L)
    assert bounds.dtype == item_end.dtype == item_leaf.dtype == torch.int64
    assert bounds.shape == (L + 1,) and item_end.shape == (L,)
    n = int(item_end[-1]) if L else 0
    assert (item_leaf[n:] == L).all()
    assert sorted(pair_order.tolist()) == list(range(Q * C))
    want = sorted(q * C + c for q in range(Q) for c in range(C)
                  if c < counts[q] and 0 <= leaves[q, c] < L)
    items = _decode_items(pair_order, bounds, item_end, item_leaf, C, G)
    got = sorted(s for _, slots, _ in items for s in slots)
    assert got == want
    n_q = np.bincount([int(leaves.flatten()[s]) for s in want],
                      minlength=L)
    per_leaf = np.bincount([leaf for leaf, _, _ in items], minlength=L)
    np.testing.assert_array_equal(per_leaf, -(-n_q // G))
    for leaf, slots, queries in items:
        assert 1 <= len(slots) <= G
        assert all(int(leaves.flatten()[s]) == leaf for s in slots)
        assert queries == sorted(queries)
    if case == "kept_by_all":
        assert per_leaf[2] == 1 and n_q[2] == Q
    if case == "over_group":
        assert (per_leaf[n_q > G] >= 2).all() and (n_q > G).any()


@pytest.mark.parametrize("what, want", [
    (dict(), "wgmma"),                       # the batch's survivor pass
    (dict(kk=32), "wgmma"),
    (dict(m=96), "wgmma"),
    (dict(scatter=False), "warp"),           # the probe
    (dict(dist_impl="direct"), "warp"),
    (dict(m=65), "warp"),                    # m % 4 != 0: no TMA map
    (dict(kk=33), "warp"),                   # beyond the lists' room
    (dict(offset=1), "warp"),                # series not 16-byte aligned
])
def test_instance_follows_the_call_shapes(what, want):
    """``kernel.instance`` picks the staged instance for the survivor pass
    in the matmul form with m % 4 == 0, aligned rows and queries and kk <=
    32, and the warp instance for every other call."""
    m = what.get("m", 256)
    base = torch.zeros(4 * 64 * m + 16)
    off = what.get("offset", 0)
    series = base[off:off + 64 * m].view(64, m)
    queries = torch.zeros((3, m))
    got = leaf_kernel.instance(series, queries, what.get("kk", 5),
                               what.get("dist_impl", "matmul"),
                               what.get("scatter", True))
    assert got == want


@pytest.fixture(scope="module")
def ref_trees(randwalk_small):
    S = randwalk_small[:2000]
    return {"dstree": tree.build_dstree(S, leaf_capacity=64),
            "isax": tree.build_isax(S, leaf_capacity=64)}


@pytest.mark.parametrize("kk", [1, 5, 32])
@pytest.mark.parametrize("backbone", ["dstree", "isax"])
def test_split_tf32_emulation_matches_reference(ref_trees, queries_small,
                                                backbone, kk):
    """The staged instance's arithmetic, emulated (``ref.
    leaf_topk_split_tf32``: the query split, the rows' trunc and lo, three
    TF32 products a k8 step rounded toward zero, each 32-column stage
    summed from zero into a float32 total), on a reference-built index and
    survivor lists the engine builds from the reference's bounds: within
    the card's hold (``_leaf_topk_errors``: 1e-4 + 1e-5·max|plain|, ids
    equal except at near-ties) of the JAX package's matmul pass."""
    smoke = _load_smoke()
    idx = ref_trees[backbone]
    q = queries_small[:16]
    d_lb = np.array(bounds.lower_bounds(idx, jnp.asarray(q)))
    L = d_lb.shape[1]
    mask = torch.from_numpy(d_lb <= np.quantile(d_lb, 0.4, axis=1,
                                                keepdims=True))
    order = torch.argsort(torch.from_numpy(d_lb), dim=1, stable=True)
    leaves, counts = engine.survivor_lists(mask, order)
    series = torch.from_numpy(np.asarray(idx.series))
    start = torch.from_numpy(np.asarray(idx.leaf_start)).long()
    sizes = torch.from_numpy(np.asarray(idx.leaf_size)).long()
    kk = min(kk, idx.max_leaf_size)
    call = (series, start, sizes, torch.from_numpy(q), leaves, counts, kk,
            idx.max_leaf_size, "matmul",
            torch.full((16, L + 1, kk), np.inf),
            torch.full((16, L + 1, kk), -1, dtype=torch.int64), True)
    assert smoke._leaf_topk_instance(call) == "wgmma"
    slot = torch.arange(L)
    lists = torch.where(slot < counts[:, None], leaves, L).numpy()
    want_d, want_i = _reference((series.numpy(), start.numpy(),
                                 sizes.numpy(), q, lists), kk,
                                idx.max_leaf_size, "matmul")
    exp_d = np.full((16, L + 1, kk), np.inf, np.float32)
    exp_i = np.full((16, L + 1, kk), -1, np.int64)
    for qi in range(16):
        exp_d[qi, lists[qi]] = want_d[qi]
        exp_i[qi, lists[qi]] = want_i[qi]
    exp_d[:, L], exp_i[:, L] = np.inf, -1
    got = ref.leaf_topk_split_tf32(*call)
    errs = smoke._leaf_topk_errors(
        call, got, (torch.from_numpy(exp_d), torch.from_numpy(exp_i)))
    assert errs["ok"], errs
    assert int(counts.sum()) > 16 and np.isfinite(exp_d).any()


#: chip_smoke.py's held calls of the staged instance
N_STAGED = 9


def test_chip_smoke_holds_every_staged_instance():
    """The staged kernel's instances (``leaf_topk.cu``: register lists of
    exactly kk entries for each kk <= REG_LIST, shared-memory lists beyond)
    are each held by a call of ``RAGGED_STAGED``, an empty leaf among
    them."""
    smoke = _load_smoke()
    src = (ROOT / "src/repro_torch/csrc/leaf_topk.cu").read_text()
    reg_list = int(re.search(r"constexpr int REG_LIST = (\d+);",
                             src).group(1))
    kks = {spec[2] for spec in smoke.RAGGED_STAGED}
    assert set(range(1, reg_list + 1)) <= kks
    assert max(kks) == leaf_kernel.WGMMA_MAX_KK
    assert any(0 in spec[3] and spec[4][spec[3].index(0)] > 0
               for spec in smoke.RAGGED_STAGED)
    assert len(smoke.RAGGED_STAGED) == N_STAGED


@pytest.mark.parametrize("n", range(N_STAGED))
def test_chip_smoke_staged_calls(n):
    """chip_smoke.py's held calls of the staged instance (a leaf kept by 1,
    65 and all 256 queries, leaves of 0 .. 1000 rows, m = 64, 96, 128, 256,
    kk = 1 .. 8 and 32, empty lists, padding slots): each takes the wgmma
    instance; the plain version the card holds it to agrees with the JAX
    package's pass, and the emulated arithmetic with the plain version,
    under the card's hold."""
    smoke = _load_smoke()
    call = smoke.staged_leaf_topk_calls("cpu")[n]
    series, start, sizes, q, leaves, counts, kk, max_leaf = call[:8]
    assert smoke._leaf_topk_instance(call) == "wgmma"
    L = start.shape[0]
    slot = torch.arange(leaves.shape[1])
    lists = torch.where(slot < counts[:, None], leaves, L).numpy()
    Q = lists.shape[0]
    kept = np.bincount(lists[lists < L], minlength=L)
    keep, n_empty = smoke.RAGGED_STAGED[n][4:]
    np.testing.assert_array_equal(kept, keep)
    assert (counts == 0).sum() >= n_empty
    want_d, want_i = _reference((series.numpy(), start.numpy(),
                                 sizes.numpy(), q.numpy(), lists), kk,
                                max_leaf, "matmul")
    exp_d = np.full((Q, L + 1, kk), np.inf, np.float32)
    exp_i = np.full((Q, L + 1, kk), -1, np.int64)
    for qi in range(Q):
        exp_d[qi, lists[qi]] = want_d[qi]
        exp_i[qi, lists[qi]] = want_i[qi]
    exp_d[:, L], exp_i[:, L] = np.inf, -1
    plain = ref.leaf_topk(*smoke._leaf_topk_fresh(call))
    errs = smoke._leaf_topk_errors(
        call, plain, (torch.from_numpy(exp_d), torch.from_numpy(exp_i)))
    assert errs["ok"], errs
    emulated = ref.leaf_topk_split_tf32(*smoke._leaf_topk_fresh(call))
    errs = smoke._leaf_topk_errors(call, emulated, plain)
    assert errs["ok"], errs
