"""The port's build pieces against the JAX package's, fed the reference's
random draws (CPU): training-target collection, filter training and the
conformal fit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import conformal, filter_training, filters, selection, tree
from repro_torch.core import conformal as t_conformal
from repro_torch.core import filter_training as t_training
from repro_torch.core import tree as t_tree
from _torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def collected(randwalk_small):
    S = randwalk_small[:1500]
    ref_index = tree.build_dstree(S, leaf_capacity=64)
    index = t_tree.build_dstree(S, leaf_capacity=64)
    leaf_ids = selection.select_leaves(
        np.asarray(ref_index.leaf_size), t_filter=10.0, t_series=1.0, a=2.0,
        filter_bytes=filters.mlp_param_bytes(96), memory_budget_bytes=6 << 30)
    data = filter_training.collect_training_data(
        ref_index, leaf_ids, 260, 32, jax.random.PRNGKey(3),
        dist_impl="direct")
    got = t_training.collect_training_data(
        index, leaf_ids, 260, 32, dist_impl="direct",
        global_queries=torch.from_numpy(np.array(data.global_queries)),
        local_queries=torch.from_numpy(np.array(data.local_queries)))
    return ref_index, index, data, got


def test_collection_targets_match_reference(collected):
    _, index, want, got = collected
    assert len(want.leaf_ids) > 4
    for name in ("global_d_L", "global_d_lb", "local_d_L"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    np.testing.assert_array_equal(got.leaf_ids, want.leaf_ids)
    # the default sweeps use the kernels' |q|^2 + |s|^2 - 2 q.s form, which
    # cancels for near neighbours (|q|^2 = m = 96 here): 1e-4 absolute
    fast = t_training.collect_training_data(
        index, want.leaf_ids, 260, 32, global_queries=got.global_queries,
        local_queries=got.local_queries)
    for name in ("global_d_L", "local_d_L"):
        np.testing.assert_allclose(getattr(fast, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-5, atol=1e-4, err_msg=name)


def _reference_batch_indices(cfg, n_g, n_l):
    """The per-step minibatch rows the reference's jitted SGD draws
    (filter_training._train_filters_jit), regenerated with jax.random."""
    n_steps = cfg.epochs * max((n_g + n_l) // cfg.batch, 1)
    keys = jax.random.split(jax.random.PRNGKey(cfg.seed), n_steps)

    def draw(key):
        kg, kl = jax.random.split(key)
        return (jax.random.randint(kg, (cfg.batch,), 0, n_g),
                jax.random.randint(kl, (max(cfg.batch // 4, 1),), 0, n_l))

    ig, il = jax.vmap(draw)(keys)
    return torch.from_numpy(np.array(ig)).long(), \
        torch.from_numpy(np.array(il)).long()


def test_train_filters_matches_reference(collected):
    ref_index, index, data, got = collected
    cfg = filter_training.TrainConfig(epochs=4)
    key = jax.random.PRNGKey(5)
    want, want_rep = filter_training.train_filters(ref_index, data, cfg, key)
    init = filters.init_mlp(key, len(data.leaf_ids), ref_index.length)
    n_g, n_l = data.global_d_L.shape[0], data.local_d_L.shape[1]
    params, rep = t_training.train_filters(
        index, got, t_training.TrainConfig(epochs=4),
        init_params={k: torch.from_numpy(np.array(v))
                     for k, v in init.items()},
        batch_indices=_reference_batch_indices(cfg, n_g, n_l))
    for k in ("w1", "b1", "w2", "b2", "y_mean", "y_std"):
        np.testing.assert_allclose(params[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    np.testing.assert_allclose(rep["val_rmse_z"], want_rep["val_rmse_z"],
                               rtol=1e-4, atol=1e-4)


def test_fit_autotuners_matches_reference(collected):
    _, _, data, _ = collected
    ids = data.leaf_ids
    d_lb = np.array(data.global_d_lb)
    d_L = np.array(data.global_d_L)
    noise = np.random.default_rng(9).standard_normal(d_L.shape)
    d_pred = np.full(d_L.shape, -np.inf, np.float32)
    d_pred[:, ids] = (d_L[:, ids] * (1.0 + 0.3 * noise[:, ids])).astype(
        np.float32)
    want, want_rep = conformal.fit_autotuners(d_lb, d_pred, d_L, ids)
    got, got_rep = t_conformal.fit_autotuners(
        torch.from_numpy(d_lb), torch.from_numpy(d_pred),
        torch.from_numpy(d_L), ids)
    np.testing.assert_array_equal(got.knots_q, want.knots_q)
    np.testing.assert_array_equal(got_rep["rank_quality"],
                                  want_rep["rank_quality"])
    np.testing.assert_array_equal(got_rep["rank_pruning"],
                                  want_rep["rank_pruning"])
    np.testing.assert_allclose(got.knots_o, want.knots_o, rtol=1e-6)
    np.testing.assert_allclose(got.slopes, want.slopes, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(got.max_offset, want.max_offset)
    for t in (0.9, 0.95, 0.99, np.array([0.9, 0.99, 0.5])):
        np.testing.assert_array_equal(got.offsets(t), want.offsets(t))
        np.testing.assert_array_equal(
            t_conformal.scatter_offsets(got, ids, d_L.shape[1], t),
            conformal.scatter_offsets(want, ids, d_L.shape[1], t))


def test_simulate_search_matches_reference(collected):
    _, _, data, _ = collected
    d_lb, d_L = np.array(data.global_d_lb), np.array(data.global_d_L)
    d_pred = (d_L * 0.9).astype(np.float32)
    offsets = np.linspace(0, 2, d_L.shape[1]).astype(np.float32)
    wb, ws = conformal.simulate_search(jnp.asarray(d_lb), jnp.asarray(d_pred),
                                       jnp.asarray(offsets), jnp.asarray(d_L))
    gb, gs = t_conformal.simulate_search(
        torch.from_numpy(d_lb), torch.from_numpy(d_pred),
        torch.from_numpy(offsets), torch.from_numpy(d_L))
    np.testing.assert_array_equal(gb.numpy(), np.asarray(wb))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    np.testing.assert_array_equal(
        t_conformal.recall_at_1(gb, torch.from_numpy(d_L.min(1))).numpy(),
        np.asarray(conformal.recall_at_1(wb, jnp.asarray(d_L.min(1)))))
