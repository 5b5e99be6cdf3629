"""The cascade replay: the port's plain loop against the JAX package's
``_replay_cascade``, and the replay kernel's chunked walk (emulated on the
CPU by ``kernels/replay/ref.replay_chunked``) against the plain loop.

The replay only compares and selects, so every comparison here is exact:
the top-k distances bit for bit, the ids and all three counters equal (and
with ``trace=True`` the box/seed split of the lb-pruned count too, with and
without the prune-only bound ``bsf_ub``).
The inputs are made adversarial from a numpy seed: values drawn from a few
levels (ties everywhere), +-inf among the bounds, predictions and leaf
values, shuffled visit orders, k = 1, 5, 33 and kk < k; NaN too where the
port is compared with itself (the JAX package's top_k orders NaN another
way than torch.sort, and neither caller passes one).
"""
import ctypes
import importlib.util
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as j_engine
from repro_torch.core import conformal, engine
from repro_torch.kernels import common
from repro_torch.kernels.replay import kernel as replay_kernel
from repro_torch.kernels.replay import ref
from _hypothesis_compat import given, settings, st
from _torch_threads import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
LEVELS = np.float32([0.25, 0.5, 1.0, 1.5, 2.0, 3.0])


def _load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(seed: int, Q: int, L: int, kk: int, *, shuffled: bool,
            specials=(np.inf, -np.inf), sorted_leaves: bool = True):
    """numpy (leaf_d, leaf_i, d_lb, d_F, order): levels with ties, each
    special value at 3% of the entries of every float array."""
    rng = np.random.default_rng(seed)
    leaf_d = rng.choice(LEVELS, (Q, L, kk))
    if sorted_leaves:
        leaf_d = np.sort(leaf_d, axis=-1)
    d_lb = rng.choice(LEVELS, (Q, L)) * np.float32(0.8)
    d_F = rng.choice(LEVELS, (Q, L)) * np.float32(0.9)
    for a in (leaf_d, d_lb, d_F):
        for v in specials:
            a[rng.random(a.shape) < 0.03] = v
    leaf_i = rng.integers(0, 1 << 30, (Q, L, kk))
    order = (np.stack([rng.permutation(L) for _ in range(Q)]) if shuffled
             else np.argsort(d_lb, axis=1, kind="stable"))
    return leaf_d.astype(np.float32), leaf_i, d_lb, d_F, order


def _torch(arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _assert_bitwise(got, want):
    """topk_d bit for bit; ids and counters equal (as int64)."""
    got = [np.asarray(g) for g in got]
    want = [np.asarray(w) for w in want]
    np.testing.assert_array_equal(got[0].view(np.int32),
                                  want[0].astype(np.float32).view(np.int32))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.astype(np.int64),
                                      w.astype(np.int64))


@pytest.mark.parametrize("k, kk, shuffled, sorted_leaves", [
    (1, 1, False, True),        # calibration's shape
    (5, 5, False, True),        # a batch's
    (5, 5, True, False),
    (5, 2, True, True),         # kk < k
    (33, 7, False, True),       # beyond the kernel's register top-k
    (33, 40, True, False),
])
def test_plain_replay_matches_reference(k, kk, shuffled, sorted_leaves):
    """The port's plain loop (kernels/replay/ref.py) against the JAX
    package's ``_replay_cascade`` on tied, infinite and reordered input."""
    arrays = _inputs(k * 100 + kk, 6, 150, kk, shuffled=shuffled,
                     sorted_leaves=sorted_leaves)
    want = j_engine._replay_cascade(*(jnp.asarray(a) for a in arrays), k=k)
    got = ref.replay_cascade(*_torch(arrays), k)
    _assert_bitwise([g.numpy() for g in got], want)
    assert int(got[2].sum()) > 0 and int(got[3].sum()) > 0


def _bound(seed: int, Q: int, nan: bool = True) -> torch.Tensor:
    """A (Q,) bound from the levels (so it undercuts the bsf at some
    positions and not at others), +inf on some rows and, with ``nan``, NaN
    on some (nothing lb-pruned there: ``jnp.minimum``'s NaN)."""
    rng = np.random.default_rng(seed)
    ub = rng.choice(LEVELS[:4] * np.float32(0.8), Q)
    special = rng.random(Q)
    ub[special < 0.15] = np.inf
    if nan:
        ub[special > 0.9] = np.nan
    return torch.from_numpy(ub.astype(np.float32))


@pytest.mark.parametrize("k, kk, shuffled, sorted_leaves", [
    (1, 1, False, True),
    (5, 5, False, True),
    (5, 5, True, False),
    (5, 2, True, True),
    (33, 7, False, True),
    (33, 40, True, False),
])
def test_plain_replay_with_bound_and_trace_matches_reference(
        k, kk, shuffled, sorted_leaves):
    """The plain loop with ``bsf_ub`` and ``trace=True`` against the JAX
    package's ``_replay_cascade(bsf_ub=..., trace=True)``: the top-k, all
    five counters; without the bound the seed count is zero and the box
    count the lb-pruned one; the untraced outputs are the traced ones'
    first five."""
    arrays = _inputs(k * 100 + kk, 6, 150, kk, shuffled=shuffled,
                     sorted_leaves=sorted_leaves)
    ub = _bound(k + kk, 6, nan=False)
    want = j_engine._replay_cascade(*(jnp.asarray(a) for a in arrays), k=k,
                                    bsf_ub=jnp.asarray(ub.numpy()),
                                    trace=True)
    t = _torch(arrays)
    got = ref.replay_cascade(*t, k, bsf_ub=ub, trace=True)
    assert len(got) == len(want) == 7
    _assert_bitwise([g.numpy() for g in got], want)
    assert int(got[5].sum()) > 0
    if shuffled:        # in lb order the bsf falls first, seldom below ub
        assert int(got[6].sum()) > 0
    untraced = ref.replay_cascade(*t, k, bsf_ub=ub)
    _assert_bitwise([g.numpy() for g in untraced], [g.numpy()
                                                    for g in got[:5]])
    plain = ref.replay_cascade(*t, k, trace=True)
    want_plain = j_engine._replay_cascade(*(jnp.asarray(a) for a in arrays),
                                          k=k, trace=True)
    _assert_bitwise([g.numpy() for g in plain], want_plain)
    assert int(plain[6].sum()) == 0 and torch.equal(plain[5], plain[3])


#: (lag, capacity) of the emulated walk: the freshest pre-test bsf and the
#: kernel's ring; a bsf one and four chunks stale in smaller rings; and a
#: walker that moves only when the ring is full (the most stale pre-tests,
#: a ring that fills and wraps every chunk)
WALKS = [(0, ref.RING), (1, 45), (4, 32), (10 ** 9, 32)]


@pytest.mark.parametrize("lag, capacity", WALKS)
def test_chunked_walk_equals_plain_loop(lag, capacity):
    """The kernel's walk (the producers' pre-test against a bsf that lags
    by ``lag`` chunks, a ring of ``capacity`` entries, the walker's
    lane-parallel re-test and its one-by-one merges of the leaves that can
    enter the top-k, classification from the bsf before each position),
    emulated, equals the plain loop bitwise, NaN included."""
    @settings(max_examples=25, deadline=None)
    @given(seed=st.integers(0, 2 ** 31 - 1), Q=st.integers(1, 3),
           L=st.integers(1, 90), kk=st.integers(0, 10),
           k=st.sampled_from([1, 2, 5, 32, 33]),
           chunk=st.sampled_from([1, 3, 32]),
           shuffled=st.sampled_from([False, True]))
    def check(seed, Q, L, kk, k, chunk, shuffled):
        arrays = _torch(_inputs(seed, Q, L, kk, shuffled=shuffled,
                                specials=(np.inf, -np.inf, np.nan),
                                sorted_leaves=seed % 2 == 0))
        want = ref.replay_cascade(*arrays, k)
        got = ref.replay_chunked(*arrays, k, chunk=chunk, lag=lag,
                                 capacity=capacity)
        _assert_bitwise([g.numpy() for g in got], [w.numpy() for w in want])
    check()


@pytest.mark.parametrize("lag, capacity", WALKS)
def test_chunked_walk_with_bound_and_trace_equals_plain_loop(lag, capacity):
    """The kernel's walk with the bound (the producers' drop and the
    walker's tests against min(bsf, ub)) and with the trace (the producers
    drop only certain box prunes; the positions only the bound prunes for
    certain enter the ring, and the walker splits box from seed), emulated,
    equals the plain loop bitwise, NaN (in the bound too) included."""
    @settings(max_examples=25, deadline=None)
    @given(seed=st.integers(0, 2 ** 31 - 1), Q=st.integers(1, 3),
           L=st.integers(1, 90), kk=st.integers(0, 10),
           k=st.sampled_from([1, 2, 5, 32, 33]),
           chunk=st.sampled_from([1, 3, 32]),
           shuffled=st.sampled_from([False, True]),
           trace=st.sampled_from([False, True]))
    def check(seed, Q, L, kk, k, chunk, shuffled, trace):
        arrays = _torch(_inputs(seed, Q, L, kk, shuffled=shuffled,
                                specials=(np.inf, -np.inf, np.nan),
                                sorted_leaves=seed % 2 == 0))
        ub = _bound(seed, Q)
        want = ref.replay_cascade(*arrays, k, bsf_ub=ub, trace=trace)
        got = ref.replay_chunked(*arrays, k, bsf_ub=ub, trace=trace,
                                 chunk=chunk, lag=lag, capacity=capacity)
        _assert_bitwise([g.numpy() for g in got], [w.numpy() for w in want])
    check()


def test_chunked_walk_traced_without_a_bound():
    """``trace=True`` without a bound (the traced instance's ub = +inf):
    the emulated walk's box count is its lb-pruned count, its seed count
    zero, both as the plain loop's."""
    arrays = _torch(_inputs(12, 3, 200, 5, shuffled=True,
                            specials=(np.inf, -np.inf, np.nan)))
    want = ref.replay_cascade(*arrays, 5, trace=True)
    got = ref.replay_chunked(*arrays, 5, trace=True, lag=2, capacity=64)
    _assert_bitwise([g.numpy() for g in got], [w.numpy() for w in want])
    assert torch.equal(got[5], got[3]) and not got[6].any()


def _late_inputs(seed: int, Q: int, L: int, kk: int):
    """Leaves above every bound and prediction except those visited in the
    last tenth of each row: the bsf falls only there."""
    leaf_d, leaf_i, d_lb, d_F, order = _inputs(
        seed, Q, L, kk, shuffled=seed % 2 == 1,
        specials=(np.inf, -np.inf, np.nan))
    late = order[:, L - L // 10:]
    rows = np.arange(Q)[:, None]
    high = np.where(leaf_d == -np.inf, 9.0, leaf_d + 9.0).astype(np.float32)
    high[rows, late] = leaf_d[rows, late]
    return high, leaf_i, d_lb, d_F, order


@pytest.mark.parametrize("lag, capacity", [(0, ref.RING), (10 ** 9, 32),
                                           (10 ** 9, ref.RING)])
@pytest.mark.parametrize("k, kk", [(1, 1), (5, 5), (33, 9)])
def test_chunked_walk_when_the_bsf_falls_late(lag, capacity, k, kk):
    """The bsf falls only in the last tenth of each row.  With a stale
    pre-test the ring takes positions that the current bsf prunes (more
    entries than any bsf can keep, ``chain_lengths``), and the lb/filter
    split of the late positions is decided by the bsf just before each
    one: still bitwise the plain loop, both prunings counted."""
    arrays = _torch(_late_inputs(11 * k + kk, 4, 400, kk))
    want = ref.replay_cascade(*arrays, k)
    stats: dict = {}
    got = ref.replay_chunked(*arrays, k, lag=lag, capacity=capacity,
                             stats=stats)
    _assert_bitwise([g.numpy() for g in got], [w.numpy() for w in want])
    assert (want[3] > 0).all() and (want[4] > 0).all()
    least, _, _ = ref.chain_lengths(arrays[0], arrays[2], arrays[3],
                                    arrays[4], k)
    entries = torch.tensor(stats["entries"], dtype=torch.int32)
    assert (entries >= least).all()
    if lag == 0:
        # the freshest bsf lags one walker step: a few entries more at most
        assert (entries <= least + 2 * ref.CHUNK).all()
    else:
        assert (entries > least).all()


@pytest.mark.parametrize("lag, capacity", [(0, ref.RING), (10 ** 9, 32)])
def test_chunked_walk_on_chip_smoke_held_calls_with_bound(lag, capacity):
    """chip_smoke.py's held replay calls with ``chip_smoke.replay_bound``'s
    bound (a row's own bound drawn, +inf rows, a NaN row): the emulated
    walk, untraced and traced, equals the plain loop on the first 24 rows
    of each; the bound prunes seed positions somewhere."""
    smoke = _load_smoke()
    seeds = 0
    for c in smoke.replay_calls(device="cpu"):
        ub = smoke.replay_bound(c)
        assert ub.shape == (c[0].shape[0],) and ub.dtype == torch.float32
        assert torch.isinf(ub).any()
        if c[0].shape[0] > 8:
            assert torch.isnan(ub[1])
        c = tuple(t[:24] for t in c[:5]) + (c[5],)
        for trace in (False, True):
            want = ref.replay_cascade(*c, bsf_ub=ub[:24], trace=trace)
            got = ref.replay_chunked(*c, bsf_ub=ub[:24], trace=trace,
                                     lag=lag, capacity=capacity)
            assert all(smoke._bitwise_equal(g, w) for g, w in zip(got, want))
        seeds += int(want[6].sum())
    assert seeds > 0


def test_chain_lengths_count_the_walk():
    """``chain_lengths``: the ring entries no bsf can drop are the positions
    not lb-pruned (n_s + n_pf of the plain loop), the searched leaves n_s,
    and the leaves entering the top-k are the searched positions with a
    value below the bsf just before them, counted one position at a time
    here."""
    arrays = _torch(_inputs(7, 3, 120, 4, shuffled=True,
                            specials=(np.inf, -np.inf, np.nan)))
    leaf_d, leaf_i, d_lb, d_F, order = arrays
    entries, entering, searched = ref.chain_lengths(leaf_d, d_lb, d_F,
                                                    order, 5)
    _, _, n_s, n_plb, n_pf = ref.replay_cascade(*arrays, 5)
    assert torch.equal(entries, n_s + n_pf)
    assert torch.equal(searched, n_s)
    for r in range(3):
        count = 0
        td = [float("inf")] * 5
        for o in order[r].tolist():
            bsf = td[-1]
            if d_lb[r, o] > bsf or d_F[r, o] > bsf:
                continue
            vals = [v for v in leaf_d[r, o].tolist() if v == v]
            count += bool(vals) and min(vals) < bsf
            td = sorted(td + vals)[:5]
        assert int(entering[r]) == count
    assert int(entering.sum()) > 0


@pytest.mark.parametrize("lag, capacity", [(0, ref.RING), (3, 64),
                                           (10 ** 9, 32)])
def test_chunked_walk_on_chip_smoke_held_calls(lag, capacity):
    """chip_smoke.py's held replay calls cover what the card must hold
    (k = 1, 5, 32, 33, 257; kk above 8 and 32 and below k; Q = 1 and a
    calibration-shaped Q = 4096 at k = kk = 1; sorted and shuffled orders;
    +-inf and NaN everywhere; rows apart; a row where every position is
    kept and rows whose bsf falls late), and the emulated walk equals the
    plain loop on every one of them (on the first 64 rows of the larger
    ones)."""
    smoke = _load_smoke()
    calls = smoke.replay_calls(device="cpu")
    ks = {c[5] for c in calls}
    kks = {c[0].shape[2] for c in calls}
    assert {1, 5, 32, 33, 257} <= ks
    assert max(kks) > 32 and any(8 < kk < 32 for kk in kks)
    assert any(c[0].shape[2] < c[5] for c in calls)
    assert min(c[0].shape[0] for c in calls) == 1
    assert max(c[0].shape[0] for c in calls) >= 4096   # calibration-like
    assert any(c[0].shape[1] % 64 for c in calls)
    assert any(not c[0].is_contiguous() for c in calls)
    values = {spec[5] for spec in smoke.RAGGED_REPLAY}
    assert values == {"levels", "kept", "late"}
    for c, spec in zip(calls, smoke.RAGGED_REPLAY):
        for t in c[:4]:
            if t.is_floating_point():
                assert torch.isnan(t).any() and torch.isinf(t).any()
        c = tuple(t[:64] for t in c[:5]) + (c[5],)
        want = ref.replay_cascade(*c)
        got = ref.replay_chunked(*c, lag=lag, capacity=capacity)
        assert all(smoke._bitwise_equal(g, w) for g, w in zip(got, want))
        assert int(want[2].sum()) > 0
        if spec[5] == "kept":             # no position is ever dropped
            assert int(want[3].sum()) == 0
        if spec[5] == "late":
            assert int(want[3].sum()) > 0 and int(want[4].sum()) > 0


def test_engine_replay_runs_the_plain_loop_on_the_cpu():
    """``engine.replay_cascade`` keeps its signature: CPU tensors take the
    plain loop (bitwise), with the bound and the trace too, and the kernel
    is not launched."""
    arrays = _torch(_inputs(3, 4, 70, 5, shuffled=True))
    before = dict(replay_kernel.LAUNCHES)
    got = engine.replay_cascade(*arrays, k=5)
    want = ref.replay_cascade(*arrays, 5)
    _assert_bitwise([g.numpy() for g in got], [w.numpy() for w in want])
    ub = _bound(3, 4)
    got = engine.replay_cascade(*arrays, k=5, bsf_ub=ub, trace=True)
    want = ref.replay_cascade(*arrays, 5, bsf_ub=ub, trace=True)
    assert len(got) == 7
    _assert_bitwise([g.numpy() for g in got], [w.numpy() for w in want])
    assert replay_kernel.LAUNCHES == before == {"replay": 0}
    assert replay_kernel.MODE_LAUNCHES == {"plain": 0, "bound": 0,
                                           "traced": 0}


def test_calibration_replay_matches_reference_loop():
    """``conformal.simulate_search`` (k = 1 over J stacked operating points)
    equals one plain replay per operating point."""
    rng = np.random.default_rng(5)
    Q, L = 9, 40
    d_lb = torch.from_numpy(rng.choice(LEVELS, (Q, L)))
    d_L = d_lb + torch.from_numpy(rng.choice(LEVELS, (Q, L)))
    d_pred = d_L + torch.from_numpy(rng.standard_normal((Q, L))
                                    .astype(np.float32))
    offsets = torch.from_numpy(np.abs(rng.standard_normal((3, L)))
                               .astype(np.float32))
    bsf, n_s = conformal.simulate_search(d_lb, d_pred, offsets, d_L)
    order = torch.argsort(d_lb, dim=1, stable=True)
    for j in range(3):
        td, _, s, _, _ = ref.replay_cascade(
            d_L[..., None], torch.zeros((Q, L, 1), dtype=torch.int64), d_lb,
            d_pred - offsets[j], order, 1)
        assert torch.equal(bsf[j], td[:, 0]) and torch.equal(n_s[j], s)


def test_kernel_wrapper_checks_before_it_builds():
    """The wrapper takes the engine's row-strided leaf blocks and refuses
    what the kernel does not take, before it builds anything."""
    leaf_d, leaf_i, d_lb, d_F, order = _torch(_inputs(1, 3, 20, 4,
                                                      shuffled=False))
    wide_d = torch.zeros((3, 21, 4))
    wide_i = torch.zeros((3, 21, 4), dtype=torch.int64)
    replay_kernel._require_leaf_block(wide_d[:, :20], "leaf_d",
                                      torch.float32, torch.device("cpu"))
    with pytest.raises(ValueError, match="contiguous"):
        replay_kernel._require_leaf_block(
            leaf_d.transpose(1, 2).contiguous().transpose(1, 2), "leaf_d",
            torch.float32, torch.device("cpu"))
    bad = [((leaf_d, leaf_i, d_lb, d_F, order.int(), 5), TypeError),
           ((leaf_d.double(), leaf_i, d_lb, d_F, order, 5), TypeError),
           ((leaf_d, leaf_i, d_lb[:, :5], d_F, order, 5), ValueError),
           ((wide_d[:, :20], wide_i[:, :20].contiguous(), d_lb, d_F, order,
             5), ValueError),
           ((leaf_d, leaf_i, d_lb, d_F, order, 0), ValueError)]
    for args, err in bad:
        with pytest.raises(err):
            replay_kernel.replay_cascade_cuda(*args)
    good = (leaf_d, leaf_i, d_lb, d_F, order, 5)
    for ub, err in ((torch.zeros(2), ValueError),
                    (torch.zeros(3, dtype=torch.float64), TypeError),
                    (torch.zeros((3, 1)), ValueError),
                    (torch.zeros(6)[::2], ValueError)):
        with pytest.raises(err):
            replay_kernel.replay_cascade_cuda(*good, bsf_ub=ub)
    assert replay_kernel.LAUNCHES == {"replay": 0}
    assert [replay_kernel.mode(ub, t) for ub, t in
            ((None, False), (torch.zeros(3), False), (None, True),
             (torch.zeros(3), True))] == ["plain", "bound", "traced",
                                          "traced"]


def test_c_entry_matches_the_binding():
    """One C entry, ``replay``, with the binding's 19 arguments (the bound
    after the order, the trace's two counters after the three); the source
    names what it replaces; the walker's step is the emulation's chunk, the
    ring's capacity and an entry's slots are the emulation's, the launch
    is a block a row (256 blocks at a batch's 256 rows: every SM of an
    H100's 132 holds one), ``kernel.instance`` names the instance the C
    entry picks by k and kk, and ``kernel.mode`` the plain, bound or
    traced one it picks by the pointers it is given."""
    text = (common.CSRC / "replay.cu").read_text()
    entries = re.findall(r'extern "C" int (\w+)\(([^)]*)\)', text)
    assert [name for name, _ in entries] == ["replay"]
    params = [p.split()[-1].strip("*") for p in entries[0][1].split(",")]
    assert len(params) == len(replay_kernel._SIGNATURES["replay"]) == 19
    assert params[6] == "bsf_ub" and params[12:14] == ["n_box", "n_seed"]
    sig = replay_kernel._SIGNATURES["replay"]
    assert sig[6] is ctypes.c_void_p and sig[12:14] == [ctypes.c_void_p] * 2
    assert "if (a.box) return launch_mode<REG, NS, TRACED>(a, st);" in text
    assert "if (a.ub) return launch_mode<REG, NS, BOUND>(a, st);" in text
    assert "return launch_mode<REG, NS, PLAIN>(a, st);" in text
    assert "constexpr int PLAIN = 0, BOUND = 1, TRACED = 2;" in text
    assert 'asm("min.NaN.f32' in text
    assert "src/repro/core/engine.py:307" in text
    assert re.search(r"constexpr int REG_MAX_K = 32;", text)
    assert "32 * SUB" in text and ref.CHUNK == 32
    assert re.search(rf"constexpr int RING = {ref.RING};", text)
    assert re.search(rf"constexpr int PRE = {ref.PRE};", text)
    assert "kern<<<a.Q, THREADS, smem, st>>>" in text
    assert re.search(rf"constexpr int REG_MAX_K = "
                     rf"{replay_kernel.REG_MAX_K};", text)
    assert "if (a.kk <= 1) return launch<REG, 1>(a, st);" in text
    assert "if (a.kk <= PRE) return launch<REG, PRE>(a, st);" in text
    assert "k <= REG_MAX_K ? launch_kk<true>(a, st)" in text
    assert [replay_kernel.instance(kk, k) for kk, k in
            ((1, 1), (5, 32), (8, 33), (9, 5))] == [
        "top-k in registers; leaf slots a ring entry: 1",
        "top-k in registers; leaf slots a ring entry: 8",
        "top-k in the output row; leaf slots a ring entry: 8",
        "top-k in registers; leaf slots a ring entry: 0"]
    # the walker's loop reads the ring, never the arrays the producers load
    walk = text[text.index("__device__ __forceinline__ int2 walk("):
                text.index("// producer `first`")]
    assert "int4 walk_bound(" in walk           # the bound's walker too
    for name in ("__ldg(lbr", "__ldg(fr", "__ldg(ord", "__ldg(ldr"):
        assert name not in walk


def test_chip_smoke_holds_and_counts_the_replay():
    """chip_smoke.py builds the replay source, holds it bitwise, counts its
    launches on the DSTree, iSAX and grouped paths (not search_early's),
    rejects a spill in it, and bounds it by bytes."""
    smoke = _load_smoke()
    source, replaces, tol, _ = smoke.KERNELS["replay"]
    assert (ROOT / source).exists() and tol == (0.0, 0.0)
    assert replaces.startswith("no Pallas kernel")
    assert "replay" in smoke.DESIGN and smoke.DESIGN["replay"][1] is None
    design = smoke.DESIGN["replay"][0]
    assert "walker" in design and "ring" in design and "1 + 7" in design
    assert "replay_kernel" in smoke.SPLIT_KERNELS
    for path in (smoke.DSTREE_KERNELS, smoke.ISAX_KERNELS,
                 smoke.GROUPED_KERNELS):
        assert "replay" in path
    assert "replay" not in smoke.SEARCH_KERNELS
    call = smoke.replay_calls(device="cpu")[1]
    leaf_d, _, d_lb, d_F, order, k = call
    ms, by = smoke._bound("replay", call)
    from repro_torch.analysis import roofline
    assert by == "bytes"
    assert ms == ref.bound_bytes(leaf_d, d_lb, d_F, order, k) \
        / roofline.H100.hbm_bw * 1e3


def test_chain_lengths_and_bound_bytes_with_a_bound():
    """With ``bsf_ub`` the ring entries no bsf can drop are the positions
    the bound does not lb-prune either (n_s + n_pf of the bounded loop),
    and the bytes add each row's bound and, traced, its two counters."""
    arrays = _torch(_inputs(8, 5, 140, 4, shuffled=True,
                            specials=(np.inf, -np.inf, np.nan)))
    leaf_d, leaf_i, d_lb, d_F, order = arrays
    ub = _bound(8, 5)
    _, _, n_s, n_plb, n_pf = ref.replay_cascade(*arrays, 5, bsf_ub=ub)
    entries, entering, searched = ref.chain_lengths(leaf_d, d_lb, d_F,
                                                    order, 5, bsf_ub=ub)
    assert torch.equal(entries, n_s + n_pf) and torch.equal(searched, n_s)
    Q, L, kk = leaf_d.shape
    base = (12 * Q * L + 4 * int(entries.sum()) + 4 * kk * int(n_s.sum())
            + 8 * kk * int(entering.sum()) + Q * (12 * 5 + 12))
    assert ref.bound_bytes(leaf_d, d_lb, d_F, order, 5,
                           bsf_ub=ub) == base + 4 * Q
    assert ref.bound_bytes(leaf_d, d_lb, d_F, order, 5, bsf_ub=ub,
                           trace=True) == base + 12 * Q
    unbounded, _, _ = ref.chain_lengths(leaf_d, d_lb, d_F, order, 5)
    assert int(entries.sum()) < int(unbounded.sum())


def test_bound_bytes_counts_what_the_data_needs():
    """``ref.bound_bytes``: 12 bytes a position (order entry and bound), 4
    for the prediction of each position its bound does not prune, kk
    values of each searched leaf, kk ids of each entering leaf, and the
    outputs; below the 16 bytes a position of reading every prediction
    where the bounds prune."""
    arrays = _torch(_inputs(9, 3, 150, 4, shuffled=False,
                            specials=(np.inf, -np.inf, np.nan)))
    leaf_d, leaf_i, d_lb, d_F, order = arrays
    Q, L, kk = leaf_d.shape
    k = 5
    _, _, n_s, n_plb, n_pf = ref.replay_cascade(*arrays, k)
    _, entering, _ = ref.chain_lengths(leaf_d, d_lb, d_F, order, k)
    want = (12 * Q * L + 4 * int((n_s + n_pf).sum())
            + 4 * kk * int(n_s.sum()) + 8 * kk * int(entering.sum())
            + Q * (12 * k + 12))
    got = ref.bound_bytes(leaf_d, d_lb, d_F, order, k)
    assert got == want
    assert int(n_plb.sum()) > 0 and got < want + 4 * int(n_plb.sum())


def test_chip_smoke_captures_batch_and_calibration_calls(monkeypatch):
    """The capture keeps the largest batch call (by rows x positions x k,
    so k = 5 outranks k = 1) and, apart, the largest call made inside
    ``conformal.simulate_search``."""
    smoke = _load_smoke()
    monkeypatch.setattr(replay_kernel, "replay_cascade_cuda",
                        ref.replay_cascade)

    def through_kernel(leaf_d, leaf_i, d_lb, d_F, order, k):
        return replay_kernel.replay_cascade_cuda(leaf_d, leaf_i, d_lb, d_F,
                                                 order, k)
    monkeypatch.setattr(engine, "replay_cascade", through_kernel)
    captured: dict = {}
    arrays = _torch(_inputs(2, 4, 30, 5, shuffled=False))
    with smoke.capture_largest_inputs(captured):
        engine.replay_cascade(*arrays, 1)
        engine.replay_cascade(*arrays, 5)
        conformal.simulate_search(arrays[2], arrays[3], torch.zeros((2, 30)),
                                  arrays[0][..., 0])
    assert set(captured) == {"replay", "replay@calibration"}
    assert captured["replay"][1][5] == 5
    assert captured["replay@calibration"][1][2].shape == (8, 30)
    assert conformal.simulate_search.__name__ == "simulate_search"


def test_chip_smoke_capture_keeps_plain_replay_calls(monkeypatch):
    """The engine calls the replay with its keywords (``bsf_ub=None``):
    the capture keeps such a plain call, and passes a bound or traced
    call through unrecorded."""
    smoke = _load_smoke()
    monkeypatch.setattr(replay_kernel, "replay_cascade_cuda",
                        ref.replay_cascade)
    arrays = _torch(_inputs(4, 3, 30, 5, shuffled=False))
    captured: dict = {}
    with smoke.capture_largest_inputs(captured):
        replay_kernel.replay_cascade_cuda(*arrays, 1, bsf_ub=_bound(4, 3),
                                          trace=True)
        replay_kernel.replay_cascade_cuda(*arrays, 5, bsf_ub=_bound(4, 3))
        assert "replay" not in captured
        replay_kernel.replay_cascade_cuda(*arrays, 1, bsf_ub=None,
                                          trace=False)
    assert captured["replay"][1][5] == 1


def test_chip_smoke_capture_keeps_bound_calls_when_asked(monkeypatch):
    """With ``bound=True`` (the serving phase's capture) the largest call
    through the bound instance is kept apart as ``replay@bound``, with its
    bound; a traced call still passes through unrecorded, and with
    ``max_q`` so does a call of more rows."""
    smoke = _load_smoke()
    monkeypatch.setattr(replay_kernel, "replay_cascade_cuda",
                        ref.replay_cascade)
    arrays = _torch(_inputs(4, 3, 30, 5, shuffled=False))
    ub = _bound(4, 3)
    captured: dict = {}
    with smoke.capture_largest_inputs(captured, bound=True):
        replay_kernel.replay_cascade_cuda(*arrays, 1, bsf_ub=ub)
        replay_kernel.replay_cascade_cuda(*arrays, 5, bsf_ub=ub)
        replay_kernel.replay_cascade_cuda(*arrays, 5, bsf_ub=ub, trace=True)
        replay_kernel.replay_cascade_cuda(*arrays, 1, bsf_ub=None)
    assert set(captured) == {"replay", "replay@bound"}
    args, got_ub = captured["replay@bound"][1]
    assert args[5] == 5 and got_ub is ub
    assert captured["replay"][1][5] == 1
    # with max_q below the call's rows, nothing is kept
    few: dict = {}
    with smoke.capture_largest_inputs(few, bound=True, max_q=2):
        replay_kernel.replay_cascade_cuda(*arrays, 5, bsf_ub=ub)
        replay_kernel.replay_cascade_cuda(*arrays, 1, bsf_ub=None)
    assert not few


def test_replay_layouts_reads_either_entry(tmp_path):
    """``bench/replay_layouts.py`` binds the product's 19-argument entry and
    an older source's 16-argument one (no bound, no trace counters), and
    refuses any other."""
    from repro_torch.bench import replay_layouts
    text = (common.CSRC / "replay.cu").read_text()
    assert replay_layouts._signature(common.CSRC / "replay.cu") \
        == replay_kernel._SIGNATURES["replay"]
    old = tmp_path / "old.cu"
    old.write_text(
        'extern "C" int replay(const void* leaf_d, const void* leaf_i,\n'
        '    long long row_stride, const void* d_lb, const void* d_F,\n'
        '    const void* order, void* topk_d, void* topk_i, void* n_s,\n'
        '    void* n_plb, void* n_pf, int Q, int L, int kk, int k,\n'
        '    void* stream) {}\n')
    assert replay_layouts._signature(old) == replay_layouts._OLD_SIGNATURE
    assert len(replay_layouts._OLD_SIGNATURE) == 16
    bad = tmp_path / "bad.cu"
    bad.write_text(text.replace("void* stream)", "int extra, void* stream)"))
    with pytest.raises(ValueError, match="20 arguments"):
        replay_layouts._signature(bad)
