"""The cascade replay: the port's plain loop against the JAX package's
``_replay_cascade``, and the replay kernel's chunked walk (emulated on the
CPU by ``kernels/replay/ref.replay_chunked``) against the plain loop.

The replay only compares and selects, so every comparison here is exact:
the top-k distances bit for bit, the ids and all three counters equal.
The inputs are made adversarial from a numpy seed: values drawn from a few
levels (ties everywhere), +-inf among the bounds, predictions and leaf
values, shuffled visit orders, k = 1, 5, 33 and kk < k; NaN too where the
port is compared with itself (the JAX package's top_k orders NaN another
way than torch.sort, and neither caller passes one).
"""
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


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1), Q=st.integers(1, 3),
       L=st.integers(1, 90), kk=st.integers(1, 6),
       k=st.sampled_from([1, 2, 5, 32, 33]),
       chunk=st.sampled_from([1, 3, 32]),
       shuffled=st.sampled_from([False, True]))
def test_chunked_walk_equals_plain_loop(seed, Q, L, kk, k, chunk, shuffled):
    """The kernel's walk (pre-test against the chunk's bsf, candidates one
    by one, classification from the bsf before each position), emulated,
    equals the plain loop bitwise, NaN included."""
    arrays = _torch(_inputs(seed, Q, L, kk, shuffled=shuffled,
                            specials=(np.inf, -np.inf, np.nan),
                            sorted_leaves=seed % 2 == 0))
    want = ref.replay_cascade(*arrays, k)
    got = ref.replay_chunked(*arrays, k, chunk=chunk)
    _assert_bitwise([g.numpy() for g in got], [w.numpy() for w in want])


def test_chunked_walk_on_chip_smoke_held_calls():
    """chip_smoke.py's held replay calls cover what the card must hold
    (k = 1, 5, 32, 33, 257; kk above 32 and below k; Q = 1; sorted and
    shuffled orders; +-inf and NaN everywhere; rows apart), and the
    emulated walk equals the plain loop on every one of them."""
    smoke = _load_smoke()
    calls = smoke.replay_calls(device="cpu")
    ks = {c[5] for c in calls}
    kks = {c[0].shape[2] for c in calls}
    assert {1, 5, 32, 33, 257} <= ks
    assert max(kks) > 32 and any(c[0].shape[2] < c[5] for c in calls)
    assert min(c[0].shape[0] for c in calls) == 1
    assert any(c[0].shape[1] % 128 for c in calls)
    assert any(not c[0].is_contiguous() for c in calls)
    for c in calls:
        for t in c[:4]:
            if t.is_floating_point():
                assert torch.isnan(t).any() and torch.isinf(t).any()
        want = ref.replay_cascade(*c)
        got = ref.replay_chunked(*c)
        assert all(smoke._bitwise_equal(g, w) for g, w in zip(got, want))
        assert int(want[2].sum()) > 0


def test_engine_replay_runs_the_plain_loop_on_the_cpu():
    """``engine.replay_cascade`` keeps its signature: CPU tensors take the
    plain loop (bitwise), and the kernel is not launched."""
    arrays = _torch(_inputs(3, 4, 70, 5, shuffled=True))
    before = dict(replay_kernel.LAUNCHES)
    got = engine.replay_cascade(*arrays, k=5)
    want = ref.replay_cascade(*arrays, 5)
    _assert_bitwise([g.numpy() for g in got], [w.numpy() for w in want])
    assert replay_kernel.LAUNCHES == before == {"replay": 0}


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
    assert replay_kernel.LAUNCHES == {"replay": 0}


def test_c_entry_matches_the_binding():
    """One C entry, ``replay``, with the binding's 16 arguments; the source
    names what it replaces; the kernel's step is the emulation's chunk."""
    text = (common.CSRC / "replay.cu").read_text()
    entries = re.findall(r'extern "C" int (\w+)\(([^)]*)\)', text)
    assert [name for name, _ in entries] == ["replay"]
    assert len(entries[0][1].split(",")) == len(
        replay_kernel._SIGNATURES["replay"]) == 16
    assert "src/repro/core/engine.py:307" in text
    assert re.search(r"constexpr int REG_MAX_K = 32;", text)
    assert "32 * SUB" in text and ref.CHUNK == 32


def test_chip_smoke_holds_and_counts_the_replay():
    """chip_smoke.py builds the replay source, holds it bitwise, counts its
    launches on the DSTree, iSAX and grouped paths (not search_early's),
    rejects a spill in it, and bounds it by bytes."""
    smoke = _load_smoke()
    source, replaces, tol, _ = smoke.KERNELS["replay"]
    assert (ROOT / source).exists() and tol == (0.0, 0.0)
    assert replaces.startswith("no Pallas kernel")
    assert "replay" in smoke.DESIGN and smoke.DESIGN["replay"][1] is None
    assert "replay_kernel" in smoke.SPLIT_KERNELS
    for path in (smoke.DSTREE_KERNELS, smoke.ISAX_KERNELS,
                 smoke.GROUPED_KERNELS):
        assert "replay" in path
    assert "replay" not in smoke.SEARCH_KERNELS
    call = smoke.replay_calls(device="cpu")[1]
    leaf_d, _, d_lb, _, _, k = call
    Q, L, kk = leaf_d.shape
    searched = int(ref.replay_cascade(*call)[2].sum())
    ms, by = smoke._bound("replay", call)
    from repro_torch.analysis import roofline
    assert by == "bytes"
    assert ms == (16 * Q * L + 4 * kk * searched + Q * (12 * k + 12)) \
        / roofline.H100.hbm_bw * 1e3


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
