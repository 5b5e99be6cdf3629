"""Filter training's step as the port's kernels take it, and the paper's
dataset generators, against the JAX package on the CPU.

``kernels/filter_train/ref.py`` holds the arithmetic of the two training
kernels (``csrc/filter_train.cu``): explicit gradients (``train_step_
manual``), and the same with the products as split-TF32 tensor-core steps.
The tests hold the explicit step to autograd of the reference's loss, the
emulated step to ``chip_smoke.py``'s limits at the DSTree build's widths,
``train_filters`` to the reference's ``_train_filters_jit`` at another
hidden width, and the port's numpy generators to the reference's bitwise.
The CUDA kernels themselves run only on the card (``chip_smoke.py``).
"""
import importlib.util
import pathlib
import re

import jax
import numpy as np
import pytest
import torch

from repro.core import filter_training, filters
from repro.data import series as j_series
from repro_torch.core import filter_training as t_training
from repro_torch.data import series as t_series
from repro_torch.kernels.filter_train import kernel as train_kernel
from repro_torch.kernels.filter_train import ref as train_ref
from repro_torch.kernels.l2_scan import ref as l2_ref
from repro_torch.kernels.l2_scan.ref import tf32_round
from _torch_threads import one_torch_thread  # noqa: F401
# the default width's collection and the reference's minibatch draws
from test_torch_build import _reference_batch_indices, collected  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _step_state(F, m, h, n_g, n_l, bg, bl, seed=0):
    """Parameters, zero velocities, inputs and one step's row indices
    (numpy seed): z-normalized random-walk rows, He-normal weights and
    nonzero biases, 20% of the rows masked; the indices repeat (drawn with
    replacement from a few rows) and include masked rows."""
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))

    def rows(*shape):
        x = rng.standard_normal(shape).cumsum(-1)
        return (x - x.mean(-1, keepdims=True)) / x.std(-1, keepdims=True)
    tp = {"w1": t(rng.standard_normal((F, m, h)) * np.sqrt(2 / m)),
          "b1": t(rng.standard_normal((F, h)) * 0.1),
          "w2": t(rng.standard_normal((F, h)) * np.sqrt(2 / h)),
          "b2": t(rng.standard_normal(F) * 0.1)}
    vel = {k: torch.zeros_like(v) for k, v in tp.items()}
    vg, vl = t(rng.random(n_g) < 0.2), t(rng.random(n_l) < 0.2)
    vg[0], vl[0] = 1.0, 1.0
    inp = train_ref.TrainInputs(
        t(rows(n_g, m)), t(rng.standard_normal((F, n_g))), t(rows(F, n_l, m)),
        t(rng.standard_normal((F, n_l))), vg, vl, n_g / (n_g + n_l))
    ig = torch.from_numpy(rng.integers(0, n_g, bg))
    il = torch.from_numpy(rng.integers(0, n_l, bl))
    ig[:2], il[:2] = 0, 0                    # repeated, and masked
    return tp, vel, inp, ig, il


def _copy(d):
    return {k: v.clone() for k, v in d.items()}


@pytest.mark.parametrize("m,h", [(24, 24), (24, 40)], ids=["h=m", "h!=m"])
def test_manual_step_matches_autograd(m, h):
    """The explicit gradients the kernels take (dpred, then dpre, Xᵀ·dpre,
    Σ dpre, Hᵀ·dpred, Σ dpred) equal autograd of the reference's loss: from
    zero velocities one step's velocities are the gradients; a second step
    carries momentum.  Within 1e-6 of each tensor's largest value."""
    tp, vel, inp, ig, il = _step_state(5, m, h, 16, 6, 16, 4)
    assert len(set(ig.tolist())) < len(ig)
    got_tp, got_vel = _copy(tp), _copy(vel)
    want_tp, want_vel = _copy(tp), _copy(vel)
    for lr in (1e-2, 1e-3):
        train_ref.train_step_manual(got_tp, got_vel, inp, ig, il, lr, 0.9)
        train_ref.autograd_step(want_tp, want_vel, inp, ig, il, lr, 0.9)
        for k in train_ref.TRAINABLE:
            for got, want in ((got_vel[k], want_vel[k]),
                              (got_tp[k], want_tp[k])):
                scale = float(want.abs().max())
                assert scale > 0
                np.testing.assert_allclose(got.numpy(), want.numpy(),
                                           rtol=1e-6, atol=1e-6 * scale,
                                           err_msg=k)


def test_split_tf32_step_within_the_chip_limit():
    """The training kernels' tensor-core arithmetic, emulated, at the
    DSTree build's widths (m = h = 256, 128 + 32 rows, F = 16): dpred and
    every updated parameter and velocity within the limits ``chip_smoke.py``
    holds the kernels to against the plain step; a one-pass TF32 step
    misses them."""
    smoke = _load_smoke()
    tp, vel, inp, ig, il = _step_state(16, 256, 256, 420, 200, 128, 32)
    vel = {k: torch.randn(v.shape, generator=torch.Generator().manual_seed(1))
           * 1e-3 for k, v in vel.items()}
    fwd = (*(tp[k] for k in train_ref.TRAINABLE), inp.xg, inp.xl, ig, il,
           inp.ygz, inp.ylz, inp.vg, inp.vl, inp.w_g)
    plain = train_ref.train_forward(*fwd)
    errs = smoke._errors("train_forward",
                         [train_ref.train_forward_split_tf32(*fwd)], [plain])
    assert all(map(smoke._within, errs)), errs
    bwd = (*(tp[k] for k in train_ref.TRAINABLE),
           *(vel[k] for k in train_ref.TRAINABLE), inp.xg, inp.xl, ig, il,
           plain, 1e-2, 0.9)
    want = smoke._outputs("train_backward_sgd", train_ref.train_backward_sgd,
                          bwd)
    got = smoke._outputs("train_backward_sgd",
                         train_ref.train_backward_sgd_split_tf32, bwd)
    errs = smoke._errors("train_backward_sgd", got, want, bwd)
    assert all(map(smoke._within, errs)), errs
    assert all(e["own_update"] for e in errs[:4])
    assert all(e["beyond"] == 0 for e in errs[4:])

    def tf32_bmm(a, b):
        return torch.bmm(tf32_round(a), tf32_round(b))
    x = train_ref._rows(inp.xg, inp.xl, ig, il)
    pre = tf32_bmm(x, tp["w1"]) + tp["b1"][:, None, :]
    state = [t.clone() for t in bwd[:8]]
    train_ref._sgd(state[:4], state[4:], train_ref._gradients(
        x, pre, tp["w2"], plain, tf32_bmm), 1e-2, 0.9)
    assert not all(map(smoke._within,
                       smoke._errors("train_backward_sgd", state, want, bwd)))


def _planted(fault: str, state: list, old: list, lr: float, momentum: float):
    """``state`` (w1, b1, w2, b2 and their velocities after a sound step
    from ``old``) with one fault planted in the update."""
    w1, b1, w2, _, v_w1, _, v_w2, _ = state
    if fault == "w1 update skipped":
        w1.copy_(old[0])
    elif fault == "w1 update sign-flipped":
        w1.copy_(old[0] + lr * v_w1)
    elif fault == "w1 update halved":
        w1.copy_(old[0] - (lr / 2) * v_w1)
    elif fault == "b1 update skipped":
        b1.copy_(old[1])
    elif fault == "w1 gradient of one chunk dropped":
        # filter 1's lanes 128..255: v = μ·v alone, then p - lr·v as usual
        v_w1[1, :, 128:] = momentum * old[4][1, :, 128:]
        w1.copy_(old[0] - lr * v_w1)
    elif fault == "w2 gradient halved":
        v_w2.copy_(momentum * old[6] + (v_w2 - momentum * old[6]) / 2)
        w2.copy_(old[2] - lr * v_w2)


@pytest.mark.parametrize("fault", [
    "w1 update skipped", "w1 update sign-flipped", "w1 update halved",
    "b1 update skipped", "w1 gradient of one chunk dropped",
    "w2 gradient halved"])
def test_training_hold_fails_a_wrong_update(fault):
    """``chip_smoke.py``'s hold of ``train_backward_sgd`` (``_errors``)
    accepts the kernels' split-TF32 arithmetic, emulated, and rejects an
    update with one planted fault, however small the parameter's step
    against the parameter: at lr = 1e-3 one step of w1 is about 1e-4 of
    max|w1|, less than an absolute 1e-4 + 1e-5·max|w1| would allow."""
    smoke = _load_smoke()
    tp, vel, inp, ig, il = _step_state(3, 64, 256, 60, 20, 32, 8)
    gen = torch.Generator().manual_seed(2)
    vel = {k: torch.randn(v.shape, generator=gen) * 1e-3
           for k, v in vel.items()}
    params = tuple(tp[k] for k in train_ref.TRAINABLE)
    dpred = train_ref.train_forward(*params, inp.xg, inp.xl, ig, il, inp.ygz,
                                    inp.ylz, inp.vg, inp.vl, inp.w_g)
    lr, momentum = 1e-3, 0.9
    bwd = (*params, *(vel[k] for k in train_ref.TRAINABLE), inp.xg, inp.xl,
           ig, il, dpred, lr, momentum)
    want = smoke._outputs("train_backward_sgd", train_ref.train_backward_sgd,
                          bwd)
    sound = smoke._outputs("train_backward_sgd",
                           train_ref.train_backward_sgd_split_tf32, bwd)
    assert all(map(smoke._within,
                   smoke._errors("train_backward_sgd", sound, want, bwd)))
    step = float((want[0] - bwd[0]).abs().max())
    assert step < 1e-3 * float(want[0].abs().max())
    _planted(fault, sound, list(bwd[:8]), lr, momentum)
    errs = smoke._errors("train_backward_sgd", sound, want, bwd)
    assert not all(map(smoke._within, errs)), fault


def test_training_hold_admits_a_relu_flip_only_at_a_sum_near_zero():
    """The room ``_errors`` gives v_w1 and v_b1 beyond their limit: a relu
    flip of one row at a lane whose layer-1 sum is within rounding of 0
    (made so through b1) moves that lane's velocities by dpred·w2·x and
    dpred·w2, and the hold accepts it; the same move at a lane without
    such a sum is rejected."""
    smoke = _load_smoke()
    tp, vel, inp, ig, il = _step_state(3, 64, 256, 60, 20, 32, 8)
    x = train_ref._rows(inp.xg, inp.xl, ig, il)
    keep = 1 - torch.cat([inp.vg[ig], inp.vl[il]])
    f, r = 1, int(torch.nonzero(keep)[0])
    near, far = 200, 100
    tp["b1"][f, near] = -(x[f, r] @ tp["w1"][f, :, near])
    params = tuple(tp[k] for k in train_ref.TRAINABLE)
    dpred = train_ref.train_forward(*params, inp.xg, inp.xl, ig, il, inp.ygz,
                                    inp.ylz, inp.vg, inp.vl, inp.w_g)
    lr = 1e-3
    bwd = (*params, *(vel[k] for k in train_ref.TRAINABLE), inp.xg, inp.xl,
           ig, il, dpred, lr, 0.9)
    want = smoke._outputs("train_backward_sgd", train_ref.train_backward_sgd,
                          bwd)
    move = dpred[f, r] * tp["w2"][f]
    assert float(move[near].abs()) > 0
    for lane, admitted in ((near, True), (far, False)):
        got = [t.clone() for t in want]
        got[4][f, :, lane] += move[lane] * x[f, r]
        got[5][f, lane] += move[lane]
        for i in (0, 1):
            got[i].copy_(bwd[i] - lr * got[i + 4])
        errs = smoke._errors("train_backward_sgd", got, want, bwd)
        assert all(map(smoke._within, errs)) == admitted, (lane, errs)
        if admitted:
            assert errs[4]["beyond"] > 0 and errs[5]["beyond"] == 1


def test_train_filters_matches_reference_at_hidden_16(collected):
    """``train_filters`` on the CPU (autograd steps through ``sgd_step``)
    against the reference's ``_train_filters_jit`` with a hidden width of
    16 (m = 96): the reference's initial weights and draws injected."""
    ref_index, index, data, got = collected
    assert len(data.leaf_ids) > 4
    cfg = filter_training.TrainConfig(epochs=4, hidden=16)
    key = jax.random.PRNGKey(5)
    want, want_rep = filter_training.train_filters(ref_index, data, cfg, key)
    init = filters.init_mlp(key, len(data.leaf_ids), ref_index.length, 16)
    assert init["w1"].shape[2] == 16
    n_g, n_l = data.global_d_L.shape[0], data.local_d_L.shape[1]
    params, rep = t_training.train_filters(
        index, got, t_training.TrainConfig(epochs=4, hidden=16),
        init_params={k: torch.from_numpy(np.array(v))
                     for k, v in init.items()},
        batch_indices=_reference_batch_indices(cfg, n_g, n_l))
    for k in ("w1", "b1", "w2", "b2", "y_mean", "y_std"):
        np.testing.assert_allclose(params[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    np.testing.assert_allclose(rep["val_rmse_z"], want_rep["val_rmse_z"],
                               rtol=1e-4, atol=1e-4)


def _kernel_args(dev="cpu"):
    """The wrappers' tensor arguments: the forward's 12 and the backward's
    13 leading ones, each followed by the rows' low parts."""
    tp, vel, inp, ig, il = _step_state(3, 16, 16, 20, 8, 8, 2)
    inp = train_ref.split_inputs(inp)
    fwd = [*(tp[k] for k in train_ref.TRAINABLE), inp.xg, inp.xl, ig, il,
           inp.ygz, inp.ylz, inp.vg, inp.vl, inp.xg_lo, inp.xl_lo]
    bwd = [*(tp[k] for k in train_ref.TRAINABLE),
           *(vel[k] for k in train_ref.TRAINABLE), inp.xg, inp.xl, ig, il,
           torch.zeros((3, 10)), inp.xg_lo, inp.xl_lo]
    return [a.to(dev) for a in fwd], [a.to(dev) for a in bwd]


def _forward(args):
    return train_kernel.train_forward_cuda(*args[:12], 0.5, *args[12:])


def _backward(args):
    return train_kernel.train_backward_sgd_cuda(*args[:13], 1e-2, 0.9,
                                                *args[13:])


def test_wrappers_raise_on_mixed_devices_dtypes_and_shapes():
    """The wrappers refuse, before any launch, tensors on another device
    than w1's (the rows' low parts too), of another dtype, of another
    shape (the low parts' too), missing low parts, or a step without
    local rows; given tensors off the CPU, ``sgd_step`` goes to the kernels
    (here, without CUDA, that raises) and never to autograd, and refuses
    inputs that carry no low parts."""
    fwd_cpu, bwd_cpu = _kernel_args()
    fwd, bwd = _kernel_args("meta")
    cases = []
    for i, name in ((4, "xg"), (6, "ig"), (9, "ylz"), (12, "xg_lo"),
                    (13, "xl_lo")):
        mixed = list(fwd)
        mixed[i] = fwd_cpu[i]
        cases.append((mixed, ValueError, f"{name} is on cpu"))
    wrong = list(fwd)
    wrong[6] = fwd[6].int()
    cases.append((wrong, TypeError, "ig has dtype"))
    wrong = list(fwd)
    wrong[1] = fwd[1][:, :8].contiguous()
    cases.append((wrong, ValueError, r"b1 has shape \(3, 8\)"))
    wrong = list(fwd)
    wrong[7] = torch.zeros(0, dtype=torch.int64, device="meta")
    cases.append((wrong, ValueError, "at least one global and one local"))
    wrong = list(fwd)
    wrong[12] = fwd[12][0].contiguous()
    cases.append((wrong, ValueError, r"xg_lo has shape \(16,\), expected "
                  "2 dims"))
    wrong = list(fwd)
    wrong[13] = fwd[13][:2].contiguous()
    cases.append((wrong, ValueError, r"xl_lo has shape \(2, 8, 16\), "
                  r"expected \(3, 8, 16\)"))
    wrong = list(fwd)
    wrong[12] = None
    cases.append((wrong, ValueError, "low parts"))
    for args, err, match in cases:
        with pytest.raises(err, match=match):
            _forward(args)
    mixed = list(bwd)
    mixed[5] = bwd_cpu[5]
    with pytest.raises(ValueError, match="v_b1 is on cpu"):
        _backward(mixed)
    wrong = list(bwd)
    wrong[12] = bwd[12][:, :4].contiguous()
    with pytest.raises(ValueError, match=r"dpred has shape \(3, 4\)"):
        _backward(wrong)
    for i, name in ((13, "xg_lo"), (14, "xl_lo")):
        mixed = list(bwd)
        mixed[i] = bwd_cpu[i]
        with pytest.raises(ValueError, match=f"{name} is on cpu"):
            _backward(mixed)
    wrong = list(bwd)
    wrong[14] = None
    with pytest.raises(ValueError, match="low parts"):
        _backward(wrong)
    tp, vel, inp, ig, il = _step_state(3, 16, 16, 20, 8, 8, 2)
    meta = {k: v.to("meta") for k, v in tp.items()}
    vmeta = {k: v.to("meta") for k, v in vel.items()}
    inp_meta = train_ref.TrainInputs(
        *(getattr(inp, f).to("meta") for f in ("xg", "ygz", "xl", "ylz",
                                                 "vg", "vl")), inp.w_g)
    with pytest.raises(ValueError, match="low parts"):
        t_training.sgd_step(meta, vmeta, inp_meta, ig.to("meta"),
                            il.to("meta"), 1e-2, 0.9)
    inp_meta = train_ref.split_inputs(inp_meta)
    assert inp_meta.xg_lo.shape == (20, 16)
    with pytest.raises(RuntimeError):
        t_training.sgd_step(meta, vmeta, inp_meta, ig.to("meta"),
                            il.to("meta"), 1e-2, 0.9)


GENERATORS = ("randwalk", "seismic", "astro", "deep", "sift")


@pytest.mark.parametrize("name", GENERATORS)
def test_generators_bitwise_equal_to_reference(name):
    """The port's numpy generators, directly and through
    ``make_series_dataset``, at n = 3000 and each default length."""
    assert set(t_series.SERIES_GENERATORS) == set(GENERATORS)
    assert t_series.DEFAULT_LENGTHS == j_series.DEFAULT_LENGTHS
    m = t_series.DEFAULT_LENGTHS[name]
    want = j_series.SERIES_GENERATORS[name](3000, m, 4)
    got = t_series.SERIES_GENERATORS[name](3000, m, 4)
    assert got.dtype == want.dtype and got.shape == (3000, m)
    assert np.array_equal(got, want)
    assert np.array_equal(t_series.make_series_dataset(name, 3000),
                          j_series.make_series_dataset(name, 3000))


def test_chip_smoke_training_tables():
    """The training kernels' rows: source, the step they replace, limits,
    designs and the no-spill list; every build's launch list names them
    and the validation pass's ``filter_mlp``."""
    smoke = _load_smoke()
    for name in ("train_forward", "train_backward_sgd"):
        source, replaces, _, _ = smoke.KERNELS[name]
        assert source == "src/repro_torch/csrc/filter_train.cu"
        assert "src/repro/core/filter_training.py:274" in replaces
        assert smoke.DESIGN[name][1] == (3 if name == "train_forward"
                                         else 2.5)
        assert f"{name}_kernel" in smoke.SPLIT_KERNELS
        assert name in train_kernel.LAUNCHES
    assert smoke.KERNELS["train_forward"][2] == (0.0, 2e-5)
    assert smoke.KERNELS["train_backward_sgd"][2] == (0.0, 2e-5)
    assert smoke.FLIP_PRE == 3e-5
    assert (smoke.STEPS_DZ_LIMIT, smoke.TRAINING_RMSE_LIMIT,
            smoke.TRAINING_DZ_LIMIT) == (5e-5, 6e-7, 4e-4)
    for path in (smoke.DSTREE_KERNELS, smoke.ISAX_KERNELS):
        assert set(smoke.BUILD_KERNELS) <= set(path)
    assert set(smoke.BUILD_KERNELS) == {"train_forward",
                                        "train_backward_sgd", "filter_mlp"}
    text = (ROOT / "src/repro_torch/csrc/filter_train.cu").read_text()
    assert "src/repro/core/filter_training.py:274" in text
    # the row tile: its rows, each consumer warpgroup's, the w1 gradient's
    # stage
    const = {k: int(re.search(rf"constexpr int {k} = (\d+);", text).group(1))
             for k in ("ROWS", "CONSUMERS", "GK")}
    assert const["ROWS"] == train_ref.TILE_ROWS
    assert const["ROWS"] // const["CONSUMERS"] == train_ref.WG_ROWS
    assert 8 * const["GK"] == train_ref.GRAD_STAGE
    assert "constexpr int WG_ROWS = ROWS / CONSUMERS;" in text
    assert [train_ref.row_tiles(bg, bl) for bg, bl in
            ((128, 32), (4, 1), (200, 50), (256, 64), (512, 128))] == [
                1, 1, 2, 2, 4]
    assert set(train_kernel._SIGNATURES) == {"train_forward",
                                             "train_backward_sgd",
                                             "train_smem"}
    for entry in train_kernel._SIGNATURES:
        assert f'extern "C" int {entry}(' in text


def test_chip_smoke_train_ragged_calls_within_the_limits():
    """The training kernels' untimed held calls cover F = 1, 2 and 3, m = h
    = 96, 128 and 65, h != m and batches 128, 8, 4 (one local row), 256 (two
    row tiles) and 200 (a partial second tile), with repeated indices; the
    emulated kernels are within the limits at each."""
    smoke = _load_smoke()
    calls = smoke.train_calls(device="cpu")
    shapes = {(c[0].shape[0], c[0].shape[1], c[0].shape[2], c[6].shape[0],
               c[7].shape[0]) for c in calls["train_forward"]}
    assert {F for F, *_ in shapes} == {1, 2, 3}
    assert {(m, h) for _, m, h, _, _ in shapes} >= {(96, 96), (128, 128),
                                                    (65, 65), (256, 128)}
    assert {(bg, bl) for *_, bg, bl in shapes} == {
        (128, 32), (8, 2), (4, 1), (256, 64), (200, 50)}
    assert {bg + bl > train_ref.TILE_ROWS for *_, bg, bl in shapes} == {
        True, False}
    assert all(len(set(c[6].tolist())) < c[6].shape[0]
               for c in calls["train_forward"] if c[6].shape[0] == 128)
    _, plain_fn, _ = smoke._kernel_tables()
    for fwd, bwd in zip(calls["train_forward"],
                        calls["train_backward_sgd"]):
        plain = train_ref.train_forward(*fwd[:-2])
        torch.testing.assert_close(plain_fn["train_forward"](*fwd), plain,
                                   rtol=0, atol=0)
        torch.testing.assert_close(bwd[12], plain, rtol=0, atol=0)
        assert all(map(smoke._within, smoke._errors(
            "train_forward", [train_ref.train_forward_split_tf32(*fwd)],
            [plain])))
        want = smoke._outputs("train_backward_sgd",
                              plain_fn["train_backward_sgd"], bwd)
        got = smoke._outputs("train_backward_sgd",
                             train_ref.train_backward_sgd_split_tf32, bwd)
        assert all(map(smoke._within, smoke._errors("train_backward_sgd",
                                                    got, want, bwd)))


def test_chip_smoke_training_bounds():
    """The training kernels' bounds: the layer-1 and layer-2 operations
    over the step's rows (twice, plus the update, for the backward pass)
    and the bytes of the parameters (read, or read and written with their
    velocities), the distinct gathered rows, the targets and dpred."""
    from repro_torch.analysis import roofline
    smoke = _load_smoke()
    F, m, h = 4096, 256, 256
    w1, v = torch.zeros((F, m, h)), torch.zeros((F, h))
    xg, xl = torch.zeros((420, m)), torch.zeros((F, 200, m))
    ig, il = torch.arange(128), torch.arange(32)
    fwd = (w1, v, v, v[:, 0], xg, xl, ig, il)
    ms, by = smoke._bound("train_forward", fwd, 3)
    assert by == "operations"
    assert ms == pytest.approx(3 * roofline.mlp_operations(F, 160, m, h)
                               / roofline.H100.tf32_flops * 1e3)
    bwd = (w1, v, v, v[:, 0], w1, v, v, v[:, 0], xg, xl, ig, il)
    ms, by = smoke._bound("train_backward_sgd", bwd)
    n_params = F * (m * h + 2 * h + 1)
    nbytes = 4 * (4 * n_params + m * (128 + F * 32) + F * 160) + 8 * 160
    assert by == "operations"
    assert ms == pytest.approx(
        (2 * roofline.mlp_operations(F, 160, m, h) + 4 * F * m * h)
        / roofline.H100.peak_flops * 1e3)
    ms, by = smoke._bound("train_backward_sgd", bwd, 3)
    assert by == "bytes"
    assert ms == pytest.approx(nbytes / roofline.H100.hbm_bw * 1e3)


def test_chip_smoke_captures_one_training_step(monkeypatch):
    """During a build the training kernels' ``TRAIN_CAPTURE_CALL``-th
    calls are kept with the state they were given cloned: the parameters
    (shared by the two calls of the step) and the velocities, which the
    later steps update in place; the largest build's call wins.  The rows'
    low parts are not kept (they die with their training) and are made
    anew from the kept rows for the holds."""
    smoke = _load_smoke()
    monkeypatch.setattr(train_kernel, "train_forward_cuda",
                        lambda *a: torch.zeros(a[0].shape[0], 10))

    def backward(*a):
        for t in a[:8]:
            t.add_(1.0)
    monkeypatch.setattr(train_kernel, "train_backward_sgd_cuda", backward)
    fwd, bwd = _kernel_args()
    bwd[:4] = fwd[:4]
    captured: dict = {}
    with smoke.capture_largest_inputs(captured):
        for step in range(smoke.TRAIN_CAPTURE_CALL + 3):
            _forward(fwd)
            _backward(bwd)
    assert set(captured) == {"train_forward", "train_backward_sgd"}
    size, f_args = captured["train_forward"]
    assert size == 3 * 10
    _, b_args = captured["train_backward_sgd"]
    assert all(a is b for a, b in zip(f_args[:4], b_args[:4]))
    for got, live in zip(b_args[:8], bwd[:8]):
        assert got is not live
        # the state of the captured step: 9 updates before it, 13 in all
        torch.testing.assert_close(got, live - 4.0)
    assert b_args[8] is bwd[8]
    for args, live in ((f_args, fwd), (b_args, bwd)):
        assert args[-2:] == (None, None)
        made = smoke._with_lo(args)
        assert len(made) == len(args)
        for got, want in zip(made[-2:], live[-2:]):
            assert got is not want and torch.equal(got, want)


def test_chip_smoke_training_phases_rehearsal_on_cpu(capsys):
    """The training profile, the training holds and the datasets phase, as
    chip_smoke.py drives them, at a tiny size on the CPU (the step there is
    autograd either way, so the holds compare it with itself)."""
    smoke = _load_smoke()
    out = smoke.run_end_to_end(n=2000, m=64, n_queries=8, n_brute=8,
                               leaf_capacity=64, n_global=60, n_local=16,
                               epochs=20, device="cpu")
    prof = smoke.training_profile(out["lfi"], "dstree ", skip=4, window=4)
    state = prof.pop("state")
    assert state["step"] == 4 and len(state["draws"]) == 4
    held = smoke.hold_training(state, "dstree ")
    assert held["steps"] == 4 and held["max_dz"] == held["max_dz_tf32"] == 0.0
    assert set(held["one_step"]) == {p + k for p in ("", "v_")
                                     for k in train_ref.TRAINABLE}
    datasets = smoke.run_datasets(n=3000, n_queries=8, leaf_capacity=64,
                                  n_global=60, n_local=16, epochs=3,
                                  device="cpu")
    assert set(datasets) == {"deep", "sift"}
    for name, got in datasets.items():
        assert got["lfi"].index.length == t_series.DEFAULT_LENGTHS[name]
        assert got["val_rmse_z"][0] == got["val_rmse_z"][1] == got["val_rmse_z"][2]
        assert got["max_dz"] == (0.0, 0.0)
        assert set(got["launches"]) == set(smoke._launch_counters())
    printed = capsys.readouterr().out
    assert "dstree training, one step from step 4" in printed
    assert "dstree training, 4 steps from the same state" in printed
    for name in ("deep", "sift"):
        assert f"{name} exact search == brute force on 8 queries" in printed
        assert f"{name} training, kernels vs the plain step" in printed
        assert f"{name} training: 3 steps, 3 validation passes" in printed


def test_x_halves_are_made_once_and_sum_to_the_rows():
    """The rows' TF32 halves the kernels read: hi is the raw row as the
    tensor cores read it (13 low bits dropped), lo = x − hi is the one copy
    made (once a training, by ``split_inputs``, which touches nothing
    else), hi + lo == x bitwise, and the emulation reads both as the tensor
    cores do; ``chip_smoke.py``'s held calls carry exactly these low parts
    of their rows."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(np.concatenate([
        rng.standard_normal(4000), rng.standard_normal(1000) * 1e-30,
        rng.standard_normal(1000) * 1e30]).astype(np.float32)).reshape(6, 1000)
    lo = train_ref.x_lo(x)
    hi = l2_ref.tf32_truncate(x)
    assert lo.shape == x.shape and lo.dtype == torch.float32
    assert torch.equal(hi + lo, x) and torch.equal(x - lo, hi)
    assert (hi.view(torch.int32) & 0x1FFF).eq(0).all()
    assert (lo * x >= 0).all() and (lo.abs() < x.abs() * 2.0 ** -10).all()
    tp, vel, inp, ig, il = _step_state(2, 24, 16, 20, 8, 8, 2)
    split = train_ref.split_inputs(inp)
    assert inp.xg_lo is None and inp.xl_lo is None
    assert split.xg is inp.xg and split.xl is inp.xl
    assert torch.equal(split.xg_lo, train_ref.x_lo(inp.xg))
    assert torch.equal(split.xl_lo, train_ref.x_lo(inp.xl))
    got_hi, got_lo = train_ref._halves(inp.xg, inp.xl, ig, il, split.xg_lo,
                                       split.xl_lo)
    rows = train_ref._rows(inp.xg, inp.xl, ig, il)
    assert torch.equal(got_hi, l2_ref.tf32_truncate(rows))
    assert torch.equal(got_lo, l2_ref.tf32_truncate(rows - got_hi))
    again = train_ref._halves(inp.xg, inp.xl, ig, il, None, None)
    assert torch.equal(again[0], got_hi) and torch.equal(again[1], got_lo)
    smoke = _load_smoke()
    calls = smoke.train_calls(device="cpu")
    for fwd, bwd in zip(calls["train_forward"], calls["train_backward_sgd"]):
        for x_, lo_ in ((fwd[4], fwd[13]), (fwd[5], fwd[14])):
            assert torch.equal(lo_, train_ref.x_lo(x_))
        assert all(a is b for a, b in zip(fwd[13:], bwd[15:]))


def test_split_tf32_step_follows_the_kernels_orientation():
    """The emulated layer 1 takes w1's split in registers (w1_lo·x_hi,
    w1_hi·x_lo, w1_hi·x_hi) and the emulated w1 gradient factors through
    the relu mask (w2 ⊙ Σ (x·dpred)·M, 40-row stages per 80-row half): on
    small integers, where every rounding is exact, both equal the plain
    products; and a batch of 200 rows (a partial second tile) pads the
    tile with zero rows that add nothing."""
    F, m, h, R = 2, 24, 16, 160
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.integers(-3, 4, (F, R, m)).astype(np.float32))
    w1 = torch.from_numpy(rng.integers(-3, 4, (F, m, h)).astype(np.float32))
    b1 = torch.zeros((F, h))
    hi, lo = l2_ref.split_tf32(x)
    pre = train_ref._pre_split_tf32(hi, lo, w1, b1)
    assert torch.equal(pre, torch.bmm(x, w1))
    w2 = torch.from_numpy(rng.integers(-2, 3, (F, h)).astype(np.float32))
    dpred = torch.from_numpy(rng.integers(-2, 3, (F, R)).astype(np.float32))
    want = torch.bmm(x.transpose(1, 2),
                     dpred[:, :, None] * w2[:, None, :] * (pre > 0))
    got = train_ref._gw1_split_tf32(x, pre, w2, dpred)
    assert torch.equal(got, want)
    part = train_ref._gw1_split_tf32(x[:, :90], pre[:, :90], w2,
                                     dpred[:, :90])
    assert torch.equal(part, torch.bmm(
        x[:, :90].transpose(1, 2),
        dpred[:, :90, None] * w2[:, None, :] * (pre[:, :90] > 0)))


def test_chip_smoke_tc_rounding_cases_tell_the_roundings_apart():
    """The rounding probe's crafted cases: under the assumed rounding (one
    rounding a k8 step, toward zero; 13 low operand bits dropped) each
    gives another result than rounding to nearest or keeping every bit, in
    both signs and for products in one or both halves of the step; the
    layouts case is exact under any rounding."""
    smoke = _load_smoke()
    names, A, B, C = smoke.tc_rounding_cases()
    assert A.shape == (len(names), 64, 8) and B.shape == (len(names), 8, 8)
    want = smoke.tc_rounding_expected(A, B, C)
    near = smoke.tc_rounding_expected(A, B, C, "nearest")
    full = smoke.tc_rounding_expected(A, B, C, "full")
    for i, name in enumerate(names):
        if name.startswith("layouts"):
            exact = C[i].astype(np.float64) + A[i].astype(np.float64) @ B[i]
            assert np.array_equal(want[i], exact.astype(np.float32))
            assert np.array_equal(near[i], want[i])
            continue
        other = near if "rounded" in name or "one rounding" in name else full
        assert not np.array_equal(want[i], other[i]), name
    step = names.index("one rounding a step (k = 0, 1)")
    assert want[step, 0, 0] == np.nextafter(np.float32(1), np.float32(2))
    assert [n for n in names if "13 low bits" in n] == [
        "B's 13 low bits dropped (shared memory)",
        "A's 13 low bits dropped (registers)"]
    assert "tc_rounding_kernel" in smoke.SPLIT_KERNELS
