"""The engine's shard-safe pieces and the seeded replay against the JAX
package's, in one process on the CPU (the leaf-sharded search's collectives
are ``tests/test_torch_distributed.py``'s).

* ``replay_cascade(bsf0=, leaf_valid=)``: the port's plain loop against the
  reference's ``replay_cascade`` bitwise (top-k, ids, every counter) at k =
  1 and 5, with ``bsf_ub`` and ``trace``, +inf seed rows (where folding the
  validity into d_lb = +inf would count otherwise), ±inf and NaN bounds and
  predictions, and an all-invalid row; the kernel's walk, emulated
  (``ref.replay_chunked``) with the seed and the mask, against the loop,
  NaN leaf values too; ``chain_lengths``, ``bound_bytes``, the wrapper and
  the source's seeded instances.
* ``probe_best_leaf``, ``masked_bsf_scan`` and ``compact_bsf_cascade`` on
  the shards of reference-built DSTree and iSAX indexes (each shard padded
  with three empty slots; trained filters, a synthetic checkerboard of
  filter prunes, and a blank shard of padding only), default capacity and
  capacity 1 (every query overflows into the scan), with and without a
  prune-only bound: ids, counters, trace and audit planes exact, distances
  within 4 ulps (the port sums each row's float32 squares in another
  order than XLA; a distance is never held bitwise across the two
  frameworks; the largest gap seen is 2 ulps).  Inside the port, compact equals scan bitwise under
  ``direct``.
* ``shard_leafi``'s arrays equal the reference's exactly, and
  ``_shard_pruning_inputs`` (box bound and the fused filter MLP's plain
  version) within the fused kernel's limit, 1e-4 + 1e-5·max.
"""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import build, distributed as j_dist, engine as j_engine
from repro.core import filter_training
from repro.core.summaries import znormalize
from repro.serving.session import save_index
from repro_torch.core import distributed, engine
from repro_torch.kernels import common
from repro_torch.kernels.replay import kernel as replay_kernel
from repro_torch.kernels.replay import ref
from repro_torch.serving.session import load_index
from _torch_threads import one_torch_thread  # noqa: F401

LEVELS = np.float32([0.25, 0.5, 1.0, 1.5, 2.0, 3.0])
VARIANTS = ("trained", "synthetic", "blank")

# the reference's pieces compiled once per shape and flags (eagerly, each
# call of a lax.scan compiles anew)
_J_PROBE = jax.jit(j_engine.probe_best_leaf, static_argnums=(5,))
_J_SCAN = jax.jit(j_engine.masked_bsf_scan, static_argnums=(6,),
                  static_argnames=("trace", "audit"))
_J_COMPACT = jax.jit(j_engine.compact_bsf_cascade, static_argnums=(6,),
                     static_argnames=("max_survivors", "dist_impl", "trace",
                                      "audit"))


# ---------------------------------------------------------------------------
# the seeded replay
# ---------------------------------------------------------------------------


def _replay_inputs(seed, Q, L, kk, specials=(np.inf, -np.inf)):
    """numpy (leaf_d, leaf_i, d_lb, d_F, order, bsf0, leaf_valid): levels
    with ties, each special value at 3% of the bounds and predictions
    (+inf at 3% of the leaf values), seeds from the levels with +inf rows
    and rows no leaf value beats, a third of the leaves invalid."""
    rng = np.random.default_rng(seed)
    leaf_d = np.sort(rng.choice(LEVELS, (Q, L, kk)), axis=-1)
    d_lb = rng.choice(LEVELS, (Q, L)) * np.float32(0.8)
    d_F = rng.choice(LEVELS, (Q, L)) * np.float32(0.9)
    for a in (d_lb, d_F):
        for v in specials:
            a[rng.random(a.shape) < 0.03] = v
    leaf_d[rng.random(leaf_d.shape) < 0.03] = np.inf
    bsf0 = rng.choice(LEVELS, Q) * np.float32(1.2)
    bsf0[::3] = np.inf
    bsf0[1::3] = 0.2              # below every leaf value: it stays
    valid = rng.random(L) > 0.33
    order = np.argsort(d_lb, axis=1, kind="stable")
    return (leaf_d.astype(np.float32), rng.integers(0, 1 << 30, (Q, L, kk)),
            d_lb.astype(np.float32), d_F.astype(np.float32), order,
            bsf0.astype(np.float32), valid)


def _bound(seed, Q):
    rng = np.random.default_rng(seed + 1)
    ub = (rng.choice(LEVELS, Q) * np.float32(0.7)).astype(np.float32)
    ub[1::4] = np.inf
    return ub


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x.astype(np.int64)


def _assert_bitwise(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g), _bits(w))


def _replay_both(arrays, k, bound, trace):
    leaf_d, leaf_i, d_lb, d_F, order, bsf0, valid = arrays
    ub = _bound(k, d_lb.shape[0]) if bound else None
    want = j_engine.replay_cascade(
        jnp.asarray(leaf_d), jnp.asarray(leaf_i), jnp.asarray(d_lb),
        jnp.asarray(d_F), jnp.asarray(order), k=k, bsf0=jnp.asarray(bsf0),
        leaf_valid=jnp.asarray(valid),
        bsf_ub=None if ub is None else jnp.asarray(ub), trace=trace)
    got = ref.replay_cascade(*map(_t, arrays[:5]), k,
                             bsf_ub=None if ub is None else _t(ub),
                             trace=trace, bsf0=_t(bsf0),
                             leaf_valid=_t(valid))
    return [g.numpy() for g in got], [np.asarray(w) for w in want]


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("bound", [False, True])
@pytest.mark.parametrize("k, kk", [(1, 1), (5, 5), (5, 2)])
def test_seeded_replay_matches_reference(k, kk, bound, trace):
    """The seed as a phantom candidate (id −1) in the first place, the
    invalid leaves lb-pruned (box in the trace), ±inf and NaN bounds and
    predictions, +inf seed rows: bitwise the reference's."""
    arrays = _replay_inputs(7 * k + kk, 9, 120, kk,
                            specials=(np.inf, -np.inf, np.nan))
    got, want = _replay_both(arrays, k, bound, trace)
    _assert_bitwise(got, want)
    seeded = np.isfinite(arrays[5])
    if k == 1:   # a seed that nothing beats stays, with its phantom id
        kept = got[0][:, 0] == arrays[5]
        assert (got[1][kept & seeded, 0] == -1).all() and kept.any()


def test_validity_is_not_an_infinite_bound():
    """On +inf seed rows an invalid leaf with d_lb = +inf would be searched
    (+inf > +inf is false): the mask prunes it, and the counts differ from
    a run that folds the validity into the bounds.  An all-invalid mask
    prunes every position (box), seeds or not."""
    leaf_d, leaf_i, d_lb, d_F, order, bsf0, valid = _replay_inputs(
        3, 6, 64, 1)
    bsf0[:] = np.inf
    k = 1
    got, want = _replay_both((leaf_d, leaf_i, d_lb, d_F, order, bsf0, valid),
                             k, False, True)
    _assert_bitwise(got, want)
    folded = ref.replay_cascade(
        _t(leaf_d), _t(leaf_i),
        _t(np.where(valid[None], d_lb, np.inf).astype(np.float32)), _t(d_F),
        _t(order), k, trace=True, bsf0=_t(bsf0))
    assert not np.array_equal(folded[2].numpy(), got[2])
    none = np.zeros_like(valid)
    got, want = _replay_both((leaf_d, leaf_i, d_lb, d_F, order, bsf0, none),
                             k, True, True)
    _assert_bitwise(got, want)
    assert (got[3] == 64).all() and (got[5] == 64).all()
    assert (got[2] == 0).all() and (got[1] == -1).all()


@pytest.mark.parametrize("lag, capacity", [(0, ref.RING), (1, 45), (4, 32),
                                           (10 ** 9, 32)])
@pytest.mark.parametrize("k, kk", [(1, 1), (5, 5), (33, 9)])
def test_seeded_chunked_walk_equals_plain_loop(lag, capacity, k, kk):
    """The kernel's walk, emulated, with the seed (the walker's first
    top-k and the producers' first bsf) and the mask (the producers drop
    an invalid leaf), with and without the bound and the trace, NaN leaf
    values too: bitwise the plain loop."""
    for seed in range(3):
        arrays = _replay_inputs(seed * 31 + k, 3, 150, kk,
                                specials=(np.inf, -np.inf, np.nan))
        leaf_d = arrays[0].copy()
        leaf_d[np.random.default_rng(seed).random(leaf_d.shape) < 0.02] = \
            np.nan
        ts = list(map(_t, (leaf_d,) + arrays[1:]))
        for bound, trace in ((False, False), (True, False), (True, True)):
            ub = _t(_bound(seed, 3)) if bound else None
            kw = dict(bsf_ub=ub, trace=trace, bsf0=ts[5], leaf_valid=ts[6])
            want = ref.replay_cascade(*ts[:5], k, **kw)
            got = ref.replay_chunked(*ts[:5], k, lag=lag, capacity=capacity,
                                     **kw)
            _assert_bitwise([g.numpy() for g in got],
                            [w.numpy() for w in want])


def test_seeded_chain_lengths_and_bound_bytes():
    """``chain_lengths`` with a seed and a mask counts what the loop
    does: entries are the valid positions not lb-pruned, searched its n_s;
    ``bound_bytes`` adds the seed's 4 bytes a row and the mask's byte a
    leaf."""
    arrays = list(map(_t, _replay_inputs(5, 4, 80, 5)))
    leaf_d, _, d_lb, d_F, order, bsf0, valid = arrays
    out = ref.replay_cascade(*arrays[:5], 5, bsf0=bsf0, leaf_valid=valid)
    entries, entering, searched = ref.chain_lengths(
        leaf_d, d_lb, d_F, order, 5, bsf0=bsf0, leaf_valid=valid)
    assert torch.equal(searched, out[2])
    assert torch.equal(entries, out[2] + out[4])
    assert (entering <= searched).all()
    assert (entries <= int(valid.sum())).all()
    plain = ref.bound_bytes(leaf_d, d_lb, d_F, order, 5)
    seeded = ref.bound_bytes(leaf_d, d_lb, d_F, order, 5, bsf0=bsf0,
                             leaf_valid=valid)
    e2, n2, s2 = ref.chain_lengths(leaf_d, d_lb, d_F, order, 5)
    Q, L, kk = leaf_d.shape
    diff = (4 * int((entries - e2).sum()) + 4 * kk * int((searched - s2)
                                                          .sum())
            + 8 * kk * int((entering - n2).sum()) + 4 * Q + L)
    assert seeded - plain == diff


def test_engine_replay_takes_the_seed_on_the_cpu():
    """``engine.replay_cascade`` passes the seed and the mask to the plain
    loop for CPU tensors; the kernel is not launched."""
    arrays = list(map(_t, _replay_inputs(2, 3, 50, 5)))
    before = dict(replay_kernel.MODE_LAUNCHES)
    got = engine.replay_cascade(*arrays[:5], k=5, bsf0=arrays[5],
                                leaf_valid=arrays[6], trace=True)
    want = ref.replay_cascade(*arrays[:5], 5, trace=True, bsf0=arrays[5],
                              leaf_valid=arrays[6])
    _assert_bitwise([g.numpy() for g in got], [w.numpy() for w in want])
    assert replay_kernel.MODE_LAUNCHES == before
    assert all(v == 0 for v in replay_kernel.MODE_LAUNCHES.values())


def test_wrapper_refuses_a_bad_seed_or_mask():
    """The wrapper checks the seed ((Q,) float32) and the mask ((L,) bool)
    before it builds, and names the seeded instances."""
    leaf_d, leaf_i, d_lb, d_F, order, bsf0, valid = map(
        _t, _replay_inputs(1, 3, 20, 4))
    good = (leaf_d, leaf_i, d_lb, d_F, order, 5)
    for kw, err in (({"bsf0": bsf0[:2]}, ValueError),
                    ({"bsf0": bsf0.double()}, TypeError),
                    ({"leaf_valid": valid.to(torch.uint8)}, TypeError),
                    ({"leaf_valid": valid[:5]}, ValueError),
                    ({"leaf_valid": torch.ones((20, 1), dtype=torch.bool)},
                     ValueError)):
        with pytest.raises(err):
            replay_kernel.replay_cascade_cuda(*good, **kw)
    assert replay_kernel.LAUNCHES == {"replay": 0}
    assert [replay_kernel.mode(ub, t, s) for ub, t, s in
            ((None, False, True), (bsf0, False, True), (None, True, True),
             (None, False, False))] == ["seeded", "seeded+bound",
                                        "seeded+traced", "plain"]
    assert set(replay_kernel.MODE_LAUNCHES) == {
        "plain", "bound", "traced", "seeded", "seeded+bound",
        "seeded+traced"}


def test_source_threads_the_seed_through_a_seeded_instance():
    """The C entry takes the seed and the mask after the bound (21
    arguments, the binding's); a SEED instance of each mode, picked when
    either pointer is given; the plain walker is the one PLAIN ran; the
    seed is inserted as id −1 and starts the ring's bsf for k = 1; the
    producers drop an invalid leaf."""
    text = (common.CSRC / "replay.cu").read_text()
    params = re.search(r'extern "C" int replay\(([^)]*)\)', text).group(1)
    names = [p.split()[-1].strip("*") for p in params.split(",")]
    assert len(names) == len(replay_kernel._SIGNATURES["replay"]) == 21
    assert names[6:9] == ["bsf_ub", "bsf0", "leaf_valid"]
    assert "if (a.seed || a.valid) return launch_kk<REG, true>(a, st);" \
        in text
    assert "return launch_kk<REG, false>(a, st);" in text
    assert "const int2 p = walk<REG, NS>(ring, top, ldr, lir, kk, n_steps, " \
        "lane);" in text
    assert "top.insert(seed, -1)" in text
    assert "ring.bsf = k == 1 ? seed : INFINITY;" in text
    assert "inv[c] ||" in text


# ---------------------------------------------------------------------------
# the engine's shard-safe pieces on reference-built shards
# ---------------------------------------------------------------------------


def _pad_leaves(sh, extra):
    """Every shard gains ``extra`` padding slots (size 0, (−inf, +inf)
    boxes)."""
    def pad2(a, cv=0):
        a = np.asarray(a)
        w = [(0, 0), (0, extra)] + [(0, 0)] * (a.ndim - 2)
        return np.pad(a, w, constant_values=cv)
    return dataclasses.replace(
        sh, leaf_start=pad2(sh.leaf_start), leaf_size=pad2(sh.leaf_size),
        lb_lo=pad2(sh.lb_lo, -np.inf), lb_hi=pad2(sh.lb_hi, np.inf),
        w1=pad2(sh.w1), b1=pad2(sh.b1), w2=pad2(sh.w2), b2=pad2(sh.b2),
        y_mean=pad2(sh.y_mean), y_std=pad2(sh.y_std, 1.0),
        offsets=pad2(sh.offsets), has_filter=pad2(sh.has_filter, False),
        leaf_global=None)


def _synthetic(sh):
    """Zeroed MLPs and a checkerboard of real leaves filter-pruned by a
    huge bias (the reference test's synthetic filters)."""
    valid = np.asarray(sh.leaf_size) > 0
    prune = valid & ((np.indices(valid.shape).sum(0) % 2) == 0)
    return dataclasses.replace(
        sh, w1=np.zeros_like(sh.w1), b1=np.zeros_like(sh.b1),
        w2=np.zeros_like(sh.w2),
        b2=np.where(prune, np.float32(1e30), 0.0).astype(np.float32),
        y_mean=np.zeros_like(sh.y_mean), y_std=np.ones_like(sh.y_std),
        offsets=np.zeros_like(sh.offsets), has_filter=prune)


def _blank(sh):
    """Shard 1 becomes all padding."""
    size, lo, hi, hf = (np.array(sh.leaf_size), np.array(sh.lb_lo),
                        np.array(sh.lb_hi), np.array(sh.has_filter))
    size[1], lo[1], hi[1], hf[1] = 0, -np.inf, np.inf, False
    return dataclasses.replace(sh, leaf_size=size, lb_lo=lo, lb_hi=hi,
                               has_filter=hf)


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """Per backbone: the reference's index, the port's (loaded from the
    reference's checkpoint), 16 queries, and the padded 2-shard
    variants."""
    rng = np.random.default_rng(0)
    S = rng.standard_normal((3000, 64), dtype=np.float32).cumsum(axis=1)
    out = {}
    for backbone in ("dstree", "isax"):
        cfg = build.LeaFiConfig(backbone=backbone, leaf_capacity=64,
                                n_global=120, n_local=24,
                                t_filter_over_t_series=10.0,
                                train=filter_training.TrainConfig(epochs=20))
        lfi = build.build_leafi(S, cfg)
        path = str(tmp_path_factory.mktemp(backbone) / "ckpt")
        save_index(path, lfi)
        Q = np.asarray(znormalize(
            S[rng.integers(0, len(S), 16)]
            + 0.3 * rng.standard_normal((16, 64)).astype(np.float32)),
            np.float32)
        sh = j_dist.shard_leafi(lfi, 2, quality_target=0.99)
        sh = dataclasses.replace(sh, **{
            f.name: np.asarray(getattr(sh, f.name))
            for f in dataclasses.fields(sh)
            if not isinstance(getattr(sh, f.name), (int, str))})
        padded = _pad_leaves(sh, 3)
        synth = _synthetic(padded)
        out[backbone] = {"lfi": lfi, "port": load_index(path, device="cpu"),
                         "queries": Q, "sharded": sh,
                         "variants": {"trained": padded, "synthetic": synth,
                                      "blank": _blank(synth)}}
    return out


def _shard_inputs(built, backbone, variant):
    """Per shard, the reference's (lb, d_F) at the queries, numpy; and the
    global seed: the least of the reference's per-shard probes (made once
    per backbone and variant)."""
    cache = built[backbone].setdefault("inputs", {})
    if variant not in cache:
        cache[variant] = _make_shard_inputs(
            built[backbone]["variants"][variant], built[backbone]["queries"])
    return cache[variant]


def _make_shard_inputs(sh, Q):
    qc = np.asarray(sh.query_coords(jnp.asarray(Q)))
    lbs, dfs, probes = [], [], []
    for s in range(sh.leaf_size.shape[0]):
        lb, d_F = j_dist._shard_pruning_inputs(
            sh.lb_lo[s], sh.lb_hi[s], sh.w1[s], sh.b1[s], sh.w2[s],
            sh.b2[s], sh.y_mean[s], sh.y_std[s], sh.offsets[s],
            sh.has_filter[s], jnp.asarray(sh.leaf_size[s]), jnp.asarray(Q),
            jnp.asarray(qc))
        lbs.append(np.asarray(lb))
        dfs.append(np.asarray(d_F))
        probes.append(np.asarray(_J_PROBE(
            jnp.asarray(sh.series[s]), jnp.asarray(sh.leaf_start[s]),
            jnp.asarray(sh.leaf_size[s]), lb, jnp.asarray(Q), sh.max_leaf)))
    return lbs, dfs, probes, np.min(np.stack(probes), axis=0)


def _layout(sh, s):
    """Shard s's (series, leaf_start, leaf_size) for each package."""
    arrs = (sh.series[s], sh.leaf_start[s], sh.leaf_size[s])
    return (tuple(map(jnp.asarray, arrs)),
            (_t(arrs[0]), _t(arrs[1]).long(), _t(arrs[2]).long()))


def _close_dists(got, want):
    """Cross-framework distances: the same infinities, the finite ones
    within 4 ulps (float32 row sums in another order; 2 seen)."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_array_max_ulp(got[fin].astype(np.float32),
                                    want[fin].astype(np.float32), maxulp=4)


def _exact_ints(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g).astype(np.int64),
                                      np.asarray(w).astype(np.int64))


def _compare_parts(got, want):
    """AuditParts: the bool planes exactly, leaf_nn to the distance
    tolerance."""
    for name, g, w in zip(got._fields, got, want):
        if name == "leaf_nn":
            _close_dists(g.numpy(), w)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=name)


def _ub(want_bsf):
    """A prune-only bound from the scan's answers: just above them on odd
    rows (a valid bound), 0.9 of them on even rows (below the answer, so
    that the bound prunes what the bsf keeps: seed prunes)."""
    b = np.asarray(want_bsf, np.float32)
    scale = np.where(np.arange(b.shape[0]) % 2, np.float32(1 + 1e-6),
                     np.float32(0.9))
    return np.where(np.isfinite(b), b * scale + (scale > 1) * 1e-6,
                    np.inf).astype(np.float32)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("backbone", ["dstree", "isax"])
def test_probe_best_leaf_matches_reference(built, backbone, variant):
    """Each shard's probe (padding lb forced to +inf before the argmin):
    finite wherever the shard has a leaf, +inf on the blank shard."""
    sh = built[backbone]["variants"][variant]
    Q = built[backbone]["queries"]
    lbs, _, probes, bsf0 = _shard_inputs(built, backbone, variant)
    for s in range(2):
        _, port = _layout(sh, s)
        got = engine.probe_best_leaf(*port, _t(lbs[s]), _t(Q), sh.max_leaf)
        _close_dists(got.numpy(), probes[s])
    assert np.isfinite(bsf0).all()
    if variant == "blank":
        assert np.isinf(probes[1]).all()


@pytest.mark.parametrize("bound", [False, True])
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("backbone", ["dstree", "isax"])
def test_masked_bsf_scan_matches_reference(built, backbone, variant, bound):
    """Per shard from the global seed, traced and audited: the counters
    and the audit's planes exactly, the bsf and leaf distances within the
    distance tolerance; untraced, the same answers."""
    sh = built[backbone]["variants"][variant]
    Q = built[backbone]["queries"]
    lbs, dfs, _, bsf0 = _shard_inputs(built, backbone, variant)
    for s in range(2):
        ref_l, port = _layout(sh, s)
        base = _J_SCAN(*ref_l, jnp.asarray(lbs[s]), jnp.asarray(dfs[s]),
                       jnp.asarray(Q), sh.max_leaf, jnp.asarray(bsf0))
        ub = _ub(base[0]) if bound else None
        want = _J_SCAN(
            *ref_l, jnp.asarray(lbs[s]), jnp.asarray(dfs[s]),
            jnp.asarray(Q), sh.max_leaf, jnp.asarray(bsf0),
            bsf_ub=None if ub is None else jnp.asarray(ub), audit=True)
        got = engine.masked_bsf_scan(
            *port, _t(lbs[s]), _t(dfs[s]), _t(Q), sh.max_leaf, _t(bsf0),
            bsf_ub=None if ub is None else _t(ub), audit=True)
        _close_dists(got[0].numpy(), want[0])
        _exact_ints((got[1],) + tuple(got[2]), (want[1],) + tuple(want[2]))
        _compare_parts(got[3], want[3])
        plain = engine.masked_bsf_scan(
            *port, _t(lbs[s]), _t(dfs[s]), _t(Q), sh.max_leaf, _t(bsf0),
            bsf_ub=None if ub is None else _t(ub))
        _assert_bitwise([p.numpy() for p in plain],
                        [g.numpy() for g in got[:2]])
        if bound:
            assert int(got[2][1].sum()) > 0 or variant == "blank"


@pytest.mark.parametrize("bound", [False, True])
@pytest.mark.parametrize("cap", [None, 1, 3])
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("backbone", ["dstree", "isax"])
def test_compact_bsf_cascade_matches_reference(built, backbone, variant,
                                               cap, bound):
    """The fixed-capacity compaction (capacity 1: every query with more
    than one survivor takes the scan; capacity 3: some queries do and some
    do not, the scan's rows put back among the pass's), traced and
    audited: answers,
    counters, the trace (``overflow`` and ``distances`` included) and the
    audit planes as the reference's; untraced the same answers; and,
    inside the port, bitwise the masked scan's under ``direct``."""
    sh = built[backbone]["variants"][variant]
    Q = built[backbone]["queries"]
    lbs, dfs, _, bsf0 = _shard_inputs(built, backbone, variant)
    n_overflow = 0
    for s in range(2):
        ref_l, port = _layout(sh, s)
        jargs = (*ref_l, jnp.asarray(lbs[s]), jnp.asarray(dfs[s]),
                 jnp.asarray(Q), sh.max_leaf, jnp.asarray(bsf0))
        targs = (*port, _t(lbs[s]), _t(dfs[s]), _t(Q), sh.max_leaf,
                 _t(bsf0))
        ub = _ub(_J_SCAN(*jargs)[0]) if bound else None
        want = _J_COMPACT(
            *jargs, max_survivors=cap, dist_impl="direct",
            bsf_ub=None if ub is None else jnp.asarray(ub), trace=True,
            audit=True)
        got = engine.compact_bsf_cascade(
            *targs, max_survivors=cap, dist_impl="direct",
            bsf_ub=None if ub is None else _t(ub), trace=True, audit=True)
        _close_dists(got[0].numpy(), want[0])
        _exact_ints((got[1],) + tuple(got[2]), (want[1],) + tuple(want[2]))
        _compare_parts(got[3], want[3])
        n_overflow += int(got[2].overflow.sum())
        plain = engine.compact_bsf_cascade(
            *targs, max_survivors=cap, dist_impl="direct",
            bsf_ub=None if ub is None else _t(ub))
        scan = engine.masked_bsf_scan(*targs,
                                      bsf_ub=None if ub is None else _t(ub))
        _assert_bitwise([p.numpy() for p in plain],
                        [g.numpy() for g in got[:2]])
        _assert_bitwise([p.numpy() for p in plain],
                        [x.numpy() for x in scan])
    if cap == 1 and variant != "blank":
        assert n_overflow > 0
    if cap == 3 and variant != "blank":
        assert 0 < n_overflow < 2 * len(Q), n_overflow


@pytest.mark.parametrize("backbone", ["dstree", "isax"])
def test_shard_leafi_equals_reference(built, backbone):
    """The port's sharding of the index carried from the reference's
    checkpoint: every array equal, in value and dtype, ``leaf_global``
    too; the slots cover every leaf once."""
    want = built[backbone]["sharded"]
    got = distributed.shard_leafi(built[backbone]["port"], 2,
                                  quality_target=0.99, device="cpu")
    for f in dataclasses.fields(want):
        w, g = getattr(want, f.name), getattr(got, f.name)
        if f.name == "device":
            continue
        if isinstance(w, (int, str)):
            assert g == w, f.name
        else:
            assert g.dtype == w.dtype and g.shape == w.shape, f.name
            np.testing.assert_array_equal(g, w, err_msg=f.name)
    L = built[backbone]["lfi"].index.n_leaves
    real = got.leaf_size > 0
    assert sorted(got.leaf_global[real].tolist()) == list(range(L))
    assert (got.leaf_global[~real] == L).all()


@pytest.mark.parametrize("per_query", [False, True])
@pytest.mark.parametrize("backbone", ["dstree", "isax"])
def test_shard_pruning_inputs_match_reference(built, backbone, per_query):
    """Each shard's (Q, P) inputs: the lower bounds (padding +inf) within
    1e-5, the predictions within the fused kernel's limit, 1e-4 + 1e-5 ·
    max, −inf on every slot without a filter; with per-query offset rows
    gathered through ``leaf_global`` as the reference's per-query body."""
    from repro.core import conformal as j_conformal
    d = built[backbone]
    lfi, sh = d["lfi"], d["sharded"]
    Q = d["queries"]
    L = lfi.index.n_leaves
    targets = np.asarray([0.9, 0.95, 0.99])[np.arange(16) % 3]
    qoff = np.asarray(j_conformal.scatter_offsets(
        lfi.tuner, lfi.leaf_ids, L, targets), np.float32)
    port = distributed.shard_leafi(d["port"], 2, quality_target=0.99,
                                   device="cpu")
    qc = np.asarray(sh.query_coords(jnp.asarray(Q)))
    for s in range(2):
        off = (qoff[:, np.minimum(sh.leaf_global[s], L - 1)] if per_query
               else sh.offsets[s])
        lb, d_F = map(np.asarray, j_dist._shard_pruning_inputs(
            sh.lb_lo[s], sh.lb_hi[s], sh.w1[s], sh.b1[s], sh.w2[s],
            sh.b2[s], sh.y_mean[s], sh.y_std[s], jnp.asarray(off),
            sh.has_filter[s], jnp.asarray(sh.leaf_size[s]), jnp.asarray(Q),
            jnp.asarray(qc)))
        local = port.local(s)
        got_qc = local.query_coords(_t(Q))
        np.testing.assert_allclose(got_qc.numpy(), qc, rtol=1e-6, atol=1e-6)
        g_lb, g_F = distributed._shard_pruning_inputs(
            local, _t(Q), got_qc, _t(qoff) if per_query else None)
        np.testing.assert_array_equal(np.isinf(g_lb.numpy()), np.isinf(lb))
        fin = np.isfinite(lb)
        np.testing.assert_allclose(g_lb.numpy()[fin], lb[fin], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_array_equal(np.isfinite(g_F.numpy()),
                                      np.isfinite(d_F))
        fin = np.isfinite(d_F)
        assert fin.sum() == 16 * int(sh.has_filter[s].sum())
        limit = 1e-4 + 1e-5 * np.abs(d_F[fin]).max()
        assert np.abs(g_F.numpy()[fin] - d_F[fin]).max() <= limit
