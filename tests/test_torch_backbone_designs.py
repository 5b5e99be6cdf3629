"""The CPU rehearsal of the CNN and LSTM filter kernels' designs.

No kernel runs here.  The kernels' arithmetic is emulated on the CPU and
held, at the widths the card runs (``chip_smoke.FILTER_TYPES``: m = C =
256, ksize 3; hidden 64, m = 256) and at ragged shapes, within
``chip_smoke.py``'s unchanged limits against the plain versions (the CPU
path and the card's hold) and against the JAX package's ``apply_cnn`` and
``apply_rnn``:

* ``filter_cnn.ref.cnn_filter_split_tf32``: conv 2 as the kernel's split-TF32
  ``wgmma`` products in its operand roles (A = c2 split in registers, B =
  conv 1's output as the tensor cores read it), in its stage order, every
  k8 step rounded toward zero into one accumulator (the kernel's flush
  rule: none), with ``l2_scan.ref``'s emulation;
* ``filter_rnn.ref.lstm_filter_sliced``: the gates summed in the order of
  the kernel's few- and many-query instances (their slices' chains of
  fused multiply-adds, then the shuffle tree).

Beside them: the slices cover each input once, in the kernel's thread
layout; the instance chosen by (h, Q) and the tile constants equal the
source's; ``chip_smoke.py``'s ragged held calls reach every instance,
both sides of the few-query limit and the CNN's partial passes and tiles;
the CNN's split bound."""
import math
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import filters
from repro_torch.kernels.filter_cnn import kernel as cnn_kernel
from repro_torch.kernels.filter_cnn import ref as cnn_ref
from repro_torch.kernels.filter_rnn import kernel as rnn_kernel
from repro_torch.kernels.filter_rnn import ref as rnn_ref
from test_torch_isolation import _load_smoke
from _torch_threads import one_torch_thread  # noqa: F401

CSRC = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch" \
    / "csrc"


def _limit(name: str, want: torch.Tensor) -> float:
    """``chip_smoke.py``'s limit for the kernel: atol + rtol·max|plain|."""
    atol, rtol = _load_smoke().KERNELS[name][2]
    return atol + rtol * want.abs().max().item()


def _cnn_stack(F, Q, m, C, K, seed=0):
    """Queries and a CNN stack at the reference's init scales (numpy
    seed), random biases and target statistics: numpy arrays."""
    rng = np.random.default_rng(seed)

    def randn(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    return {"q": randn(Q, m), "c1": randn(F, K, 1, C, scale=math.sqrt(2 / K)),
            "c2": randn(F, K, C, C, scale=math.sqrt(2 / (K * C))),
            "w": randn(F, C, scale=math.sqrt(1 / C)), "b": randn(F),
            "y_mean": randn(F) + 10.0,
            "y_std": rng.uniform(0.5, 2.0, F).astype(np.float32)}


def _rnn_stack(F, Q, m, h, seed=0):
    rng = np.random.default_rng(seed)
    s = math.sqrt(1 / h)

    def randn(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    return {"q": randn(Q, m), "wi1": randn(F, 1, 4 * h, scale=s),
            "wh1": randn(F, h, 4 * h, scale=s),
            "wi2": randn(F, h, 4 * h, scale=s),
            "wh2": randn(F, h, 4 * h, scale=s), "w": randn(F, h, scale=s),
            "b": randn(F), "y_mean": randn(F) + 10.0,
            "y_std": rng.uniform(0.5, 2.0, F).astype(np.float32)}


CNN_ARGS = ("q", "c1", "c2", "w", "b", "y_mean", "y_std")
RNN_ARGS = ("q", "wi1", "wh1", "wi2", "wh2", "w", "b", "y_mean", "y_std")


def _torch_args(p, names):
    return tuple(torch.from_numpy(p[k]) for k in names)


def _reference(ftype, p):
    params = {k: jnp.asarray(v) for k, v in p.items() if k != "q"}
    return torch.from_numpy(np.array(filters.APPLY[ftype](
        params, jnp.asarray(p["q"]))))


# ---------------------------------------------------------------------------
# the CNN: split-TF32 wgmma emulated
# ---------------------------------------------------------------------------

#: (F, Q, m, channels, ksize): the card's width at Q = 1 and 3, and a
#: ragged shape (C not a multiple of the 32-channel stage or the 128-channel
#: pass, ksize 5, m = 33: 7 queries a tile)
CNN_CASES = [(2, 1, 256, 256, 3), (2, 3, 256, 256, 3), (1, 9, 33, 100, 5)]


@pytest.mark.parametrize("F,Q,m,C,K", CNN_CASES,
                         ids=[f"F{c[0]}-Q{c[1]}-m{c[2]}-C{c[3]}-K{c[4]}"
                              for c in CNN_CASES])
def test_cnn_split_tf32_holds_row_n(F, Q, m, C, K):
    """The kernel's arithmetic, emulated, within row N's limit (1e-4 +
    1e-5·max|plain|) of the plain version and of the JAX package's
    ``apply_cnn``; and nearer the plain version than a one-pass TF32 run
    of the same products is (the reason for three passes)."""
    p = _cnn_stack(F, Q, m, C, K)
    args = _torch_args(p, CNN_ARGS)
    got = cnn_ref.cnn_filter_split_tf32(*args)
    plain = cnn_ref.cnn_filter(*args)
    ref = _reference("cnn", p)
    assert got.shape == (F, Q) and torch.isfinite(got).all()
    err = (got - plain).abs().max().item()
    assert err <= _limit("filter_cnn", plain), err
    assert (got - ref).abs().max().item() <= _limit("filter_cnn", ref)
    if m == 256:
        # one TF32 pass: the hi parts of both operands alone
        from repro_torch.kernels.l2_scan.ref import tf32_round
        one = cnn_ref.cnn_filter(args[0], args[1], tf32_round(args[2]),
                                 *args[3:])
        assert err < (one - plain).abs().max().item()


def test_cnn_emulation_order_is_the_kernels():
    """The emulation's reduction runs over the kernel's stages: on integer
    data (exact in TF32 and in every partial sum) it equals the plain
    version exactly, whatever the order, so an index slip shows."""
    rng = np.random.default_rng(5)
    F, Q, m, C, K = 2, 2, 40, 70, 3
    q = torch.from_numpy(rng.integers(-2, 3, (Q, m)).astype(np.float32))
    c1 = torch.from_numpy(rng.integers(-2, 3, (F, K, 1, C)).astype(
        np.float32))
    c2 = torch.from_numpy(rng.integers(-2, 3, (F, K, C, C)).astype(
        np.float32))
    w = torch.from_numpy(rng.integers(-2, 3, (F, C)).astype(np.float32))
    head = (torch.zeros(F), torch.zeros(F), torch.ones(F))
    got = cnn_ref.cnn_filter_split_tf32(q, c1, c2, w, *head)
    want = cnn_ref.cnn_filter(q, c1, c2, w, *head)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6)


def test_cnn_tile_constants_match_the_source():
    src = (CSRC / "filter_cnn.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])
    assert (const("ROWS"), const("OW"), const("TK"), const("KT")) == (
        cnn_kernel.ROWS, cnn_kernel.PASS_CHANNELS, cnn_kernel.STAGE_CHANNELS,
        cnn_kernel.TILE_SHIFTS)
    lines = cnn_kernel.ROWS + cnn_kernel.TILE_SHIFTS - 1
    b_tiles = const("BSTAGES") * 2 * lines * cnn_kernel.STAGE_CHANNELS * 4
    c2_tiles = const("CSTAGES") * cnn_kernel.STAGE_CHANNELS * (
        cnn_kernel.PASS_CHANNELS + 8) * 4
    assert b_tiles + c2_tiles + const("XS_MAX") * 4 < 232448
    assert "wgmma_n256" in src and "desc_noswz" in src
    assert "m64n256k8" in (CSRC / "hopper.cuh").read_text()


def test_cnn_queries_a_block():
    """A block's queries fill 256 columns, each followed by its K − 1 zero
    columns, the last one's m columns inside; one query at m > 256."""
    assert [cnn_kernel.queries_a_block(m, 3) for m in (1, 33, 96, 256, 300)] \
        == [86, 7, 2, 1, 1]
    assert cnn_kernel.queries_a_block(33, 5) == 7
    for m, K in ((1, 3), (33, 5), (96, 2), (100, 1), (256, 3)):
        qt = cnn_kernel.queries_a_block(m, K)
        assert (qt - 1) * (m + K - 1) + m <= cnn_kernel.ROWS
        assert qt * (m + K - 1) + m > cnn_kernel.ROWS


# ---------------------------------------------------------------------------
# the LSTM: the instances' sum orders
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("design", ["few", "many"])
@pytest.mark.parametrize("h", [32, 64])
def test_slices_cover_each_input_once(design, h):
    """Each layer's inputs split over the kernel's threads: few, 16 a slice
    (S = h/16 for layer 1, h/8 for layer 2, as 4 float4 groups is + S·j);
    many, 32 a slice (S = h/32, h/16; input is + S·j)."""
    width = 16 if design == "few" else 32
    for n_in in (h, 2 * h):
        sl = rnn_ref.slices(design, n_in, h)
        assert len(sl) == n_in // width
        assert all(len(s) == width for s in sl)
        assert sorted(i for s in sl for i in s) == list(range(n_in))
        S = len(sl)
        if design == "few":
            assert sl[S - 1][:4] == [4 * (S - 1) + r for r in range(4)]
            assert sl[0][4] == 4 * S
        else:
            assert sl[1][:2] == [1, 1 + S] if S > 1 else sl[0][:2] == [0, 1]
    with pytest.raises(ValueError):
        rnn_ref.slices("few", 100, 100)


@pytest.mark.parametrize("design", ["few", "many"])
def test_lstm_sliced_holds_row_l(design):
    """The gates summed in the instance's order, at the card's width (h =
    64, m = 256), within row L's limit (1e-6·max|plain|) of the plain
    version and of the JAX package's ``apply_rnn``; the raw z (identity
    statistics) within 1e-5 of its own largest value of the plain's."""
    p = _rnn_stack(2, 3, 256, 64)
    args = _torch_args(p, RNN_ARGS)
    got = rnn_ref.lstm_filter_sliced(*args, design=design)
    plain = rnn_ref.lstm_filter(*args)
    ref = _reference("rnn", p)
    assert got.shape == (2, 3) and torch.isfinite(got).all()
    assert (got - plain).abs().max().item() <= _limit("filter_rnn", plain)
    assert (got - ref).abs().max().item() <= _limit("filter_rnn", ref)
    raw = args[:6] + (args[6], torch.zeros(2), torch.ones(2))
    z_got = rnn_ref.lstm_filter_sliced(*raw, design=design)
    z_plain = rnn_ref.lstm_filter(*raw)
    assert (z_got - z_plain).abs().max().item() \
        <= 1e-5 * z_plain.abs().max().item()


@pytest.mark.parametrize("design", ["few", "many"])
def test_lstm_sliced_at_h32(design):
    p = _rnn_stack(3, 5, 40, 32, seed=1)
    args = _torch_args(p, RNN_ARGS)
    got = rnn_ref.lstm_filter_sliced(*args, design=design)
    plain = rnn_ref.lstm_filter(*args)
    assert (got - plain).abs().max().item() <= _limit("filter_rnn", plain)


def test_lstm_tree_is_the_shuffles():
    """The slices meet as the kernel's shuffles add them: P[:d] + P[d:]
    for d = S/2 .. 1 (lane is adds its partner is ^ d)."""
    parts = torch.tensor([1.0, 2.0 ** 24, 1.0, -(2.0 ** 24)])
    # (1 + 1) + (2^24 - 2^24): 2, where a running sum would give 0 or 1
    assert rnn_ref._tree(parts).item() == 2.0


def test_lstm_instances_match_the_source():
    src = (CSRC / "filter_rnn.cu").read_text()
    assert int(re.search(r"#define LSTM_FEW_MAX_Q (\d+)", src)[1]) \
        == rnn_kernel.FEW_MAX_Q
    assert int(re.search(r"constexpr int QB = (\d+);", src)[1]) \
        == rnn_kernel.MANY_QUERIES
    assert "h == 32 || h == 64" in src
    for h in (32, 64):
        assert rnn_kernel.instance(h, 1) == "few"
        assert rnn_kernel.instance(h, rnn_kernel.FEW_MAX_Q) == "few"
        assert rnn_kernel.instance(h, rnn_kernel.FEW_MAX_Q + 1) == "many"
        assert rnn_kernel.instance(h, 180) == "many"
    for h in (16, 100, 2500):
        assert rnn_kernel.instance(h, 1) == "generic"


# ---------------------------------------------------------------------------
# chip_smoke.py's rows N and L
# ---------------------------------------------------------------------------

def test_chip_smoke_held_calls_reach_every_instance():
    smoke = _load_smoke()
    lstm = {rnn_kernel.instance(h, Q) + f"-h{h}"
            for F, Q, m, h in smoke.RAGGED_RNN}
    assert {"few-h32", "few-h64", "many-h32", "many-h64"} <= lstm
    assert {"generic-h100", "generic-h2500"} <= lstm
    limit = rnn_kernel.FEW_MAX_Q
    for h in (32, 64):
        qs = {Q for F, Q, m, hh in smoke.RAGGED_RNN if hh == h}
        assert {limit, limit + 1} <= qs, (h, qs)
    cnn = smoke.RAGGED_CNN
    assert {K for *_, K in cnn} >= {1, 2, 5}
    assert any(C % cnn_kernel.PASS_CHANNELS and C > cnn_kernel.PASS_CHANNELS
               for *_, C, K in cnn)
    assert any(C % 4 for *_, C, K in cnn)
    assert any(m == 33 for F, Q, m, C, K in cnn)
    assert any(m > cnn_kernel.ROWS for F, Q, m, C, K in cnn)
    for name in ("cnn_filter_kernel", "lstm_few_kernel", "lstm_many_kernel",
                 "lstm_generic_kernel"):
        assert name in smoke.SPLIT_KERNELS


def test_chip_smoke_cnn_split_bound():
    """Row N's bound beside the f32 one: three TF32 passes at 495 TFLOP/s,
    ~0.452 s at the calibration call and ~2.51 ms at Q = 1; the LSTM keeps
    float32 FMA (no passes)."""
    smoke = _load_smoke()
    assert smoke.DESIGN["filter_cnn"][1] == 3
    assert smoke.DESIGN["filter_rnn"][1] is None
    q, c1 = torch.zeros(180, 256), torch.zeros(4096, 3, 1, 256)
    ms, by = smoke._bound("filter_cnn", (q, c1), 3)
    assert by == "operations" and 450 < ms < 455
    ms, _ = smoke._bound("filter_cnn", (q[:1], c1), 3)
    assert 2.50 < ms < 2.53


@pytest.mark.parametrize("entry", ["cnn", "rnn"])
def test_layout_entries_need_the_card(entry):
    """The launch reports read the built library: without CUDA they raise
    instead of guessing (the wrappers' refusals are
    ``test_torch_filter_types.py``'s)."""
    with pytest.raises(RuntimeError):
        if entry == "cnn":
            cnn_kernel.layout(4096, 180, 256, 3, 256)
        else:
            rnn_kernel.layout(4096, 1, 64)
