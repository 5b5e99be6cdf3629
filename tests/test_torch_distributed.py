"""The port's leaf-sharded search (``repro_torch.core.distributed``) across
processes, against the JAX package's ``shard_map`` search on the same
index and queries.

One reference subprocess (4 host devices, as ``tests/test_distributed.py``
runs it) builds a DSTree and an iSAX LeaFi index, saves each with the
reference's ``save_index`` and writes its 2 x 2-mesh outputs: both shard
strategies traced and audited at the build's target, and the per-query
form at mixed targets, at +inf offset rows (exact) and with a warm bound.
Then one ``gloo`` world of 4 spawned ranks (a 2 x 2 mesh) loads those
checkpoints through the port's ``load_index`` and makes the same calls
(``tests/_torch_dist_worker.py search``), and a world of 2 serves a seeded
trace through the ``DistributedExecutor`` and runs ``launch/serve.py
--dist`` (``… serve``).

Last, ``chip_smoke.run_distribution`` is rehearsed on the CPU at a tiny
size.

Across the two programs the answers hold to the reference tests' limits:
nearest distances within rtol 2e-6, searched counts within ``SLACK`` = 8
(a prune threshold within an ulp of the bsf may resolve either way across
differently computed inputs); the traces' accounting identities and the
audits' layout and padding slots exactly.  Inside the port: a traced and
audited call answers as the plain one does, and serial serving equals
pipelined bitwise.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLACK = 8
#: the indexes' leaf capacity
MAX_LEAF = 64
BACKBONES = ("dstree", "isax")
STRATEGIES = ("scan", "compact")

REF_CODE = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, "src")
import numpy as np, jax, jax.numpy as jnp
from repro.core import build, conformal, distributed, filter_training
from repro.core.summaries import znormalize
from repro.serving.session import save_index

out = sys.argv[1]
rng = np.random.default_rng(0)
S = rng.standard_normal((3000, 64), dtype=np.float32).cumsum(axis=1)
mesh = distributed.make_search_mesh(2, 2)
pool = znormalize(S[rng.integers(0, len(S), 32)]
                  + 0.3 * rng.standard_normal((32, 64)).astype(np.float32))
np.save(os.path.join(out, "pool.npy"), np.asarray(pool, np.float32))
for backbone in ("dstree", "isax"):
    cfg = build.LeaFiConfig(backbone=backbone, leaf_capacity=64,
                            n_global=120, n_local=24,
                            t_filter_over_t_series=10.0,
                            train=filter_training.TrainConfig(epochs=20))
    lfi = build.build_leafi(S, cfg)
    save_index(os.path.join(out, backbone + "_ckpt"), lfi)
    L = lfi.index.n_leaves
    Q = np.asarray(znormalize(
        S[rng.integers(0, len(S), 16)]
        + 0.3 * rng.standard_normal((16, 64)).astype(np.float32)),
        np.float32)
    targets = np.asarray([0.9, 0.95, 0.99])[rng.integers(0, 3, 16)]
    sharded = distributed.shard_leafi(lfi, n_shards=2, quality_target=0.99)
    res = {"queries": Q, "targets": targets,
           "leaf_size": np.asarray(sharded.leaf_size),
           "leaf_global": np.asarray(sharded.leaf_global),
           "qoff": np.asarray(conformal.scatter_offsets(
               lfi.tuner, lfi.leaf_ids, L, targets), np.float32),
           "inf_rows": np.full((16, L), np.inf, np.float32),
           "inf_ub": np.full(16, np.inf, np.float32)}
    Qj = jnp.asarray(Q)
    for strategy in ("scan", "compact"):
        run, *_ = distributed.make_distributed_search(
            mesh, sharded, strategy=strategy, trace=True, audit=True)
        pq, *_ = distributed.make_distributed_search(
            mesh, sharded, strategy=strategy, per_query_offsets=True)
        with mesh:
            nn, tot, tr, fa = run(Qj)
            res[strategy + "_nn"], res[strategy + "_tot"] = nn, tot
            for name, v in zip(tr._fields, tr):
                res[strategy + "_trace_" + name] = v
            for name, v in zip(fa._fields, fa):
                res[strategy + "_audit_" + name] = v
            for tag, off in (("pq", "qoff"), ("exact", "inf_rows")):
                nn, tot = pq(Qj, jnp.asarray(res[off]),
                             jnp.asarray(res["inf_ub"]))
                res[strategy + "_" + tag + "_nn"] = nn
                res[strategy + "_" + tag + "_tot"] = tot
            ex = np.asarray(res[strategy + "_exact_nn"])
            res["ub"] = (ex * (1 + 1e-6) + 1e-6).astype(np.float32)
            nn, tot = pq(Qj, jnp.asarray(res["inf_rows"]),
                         jnp.asarray(res["ub"]))
            res[strategy + "_warm_nn"], res[strategy + "_warm_tot"] = nn, tot
    np.savez(os.path.join(out, backbone + "_ref.npz"),
             **{k: np.asarray(v) for k, v in res.items()})
print("REF_OK")
"""


def _run(cmd, timeout):
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout,
                       cwd=ROOT)
    return r, r.stdout[-3000:] + r.stderr[-6000:]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's outputs and checkpoints, then the port's two worlds
    on them: {"ref": {backbone: npz}, "port": {backbone: npz}, "serve":
    json, "dir": path}."""
    out = str(tmp_path_factory.mktemp("dist"))
    r, tail = _run([sys.executable, "-c", REF_CODE, out], 900)
    assert "REF_OK" in r.stdout, tail
    for job in ("search", "serve"):
        r, tail = _run([sys.executable,
                        os.path.join(ROOT, "tests", "_torch_dist_worker.py"),
                        job, out], 600)
        assert r.returncode == 0, tail
    with open(os.path.join(out, "serve.json")) as fh:
        served = json.load(fh)
    return {"ref": {b: dict(np.load(os.path.join(out, f"{b}_ref.npz")))
                    for b in BACKBONES},
            "port": {b: dict(np.load(os.path.join(out, f"{b}_port.npz")))
                     for b in BACKBONES},
            "serve": served, "dir": out}


def _close(got_nn, want_nn, got_tot, want_tot, tag):
    np.testing.assert_allclose(got_nn, want_nn, rtol=2e-6, err_msg=tag)
    gap = np.abs(got_tot.astype(int) - want_tot.astype(int)).max()
    assert gap <= SLACK, (tag, got_tot, want_tot)


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("backbone", BACKBONES)
def test_sharded_answers_match_reference(runs, backbone, strategy):
    """Traced and audited at the build's target: nn and the summed
    searched counts against the reference's 2 x 2 mesh; the plain call
    answers bitwise as the traced one."""
    ref, port = runs["ref"][backbone], runs["port"][backbone]
    s = strategy
    _close(port[f"{s}_nn"], ref[f"{s}_nn"], port[f"{s}_tot"],
           ref[f"{s}_tot"], (backbone, s))
    assert np.isfinite(port[f"{s}_nn"]).all()
    np.testing.assert_array_equal(port[f"{s}_plain_nn"], port[f"{s}_nn"])
    np.testing.assert_array_equal(port[f"{s}_plain_tot"], port[f"{s}_tot"])


@pytest.mark.parametrize("backbone", BACKBONES)
def test_sharded_strategies_agree(runs, backbone):
    port = runs["port"][backbone]
    _close(port["compact_nn"], port["scan_nn"], port["compact_tot"],
           port["scan_tot"], backbone)


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("backbone", BACKBONES)
def test_sharded_per_query_offsets_match_reference(runs, backbone,
                                                   strategy):
    """Mixed per-query targets, +inf offset rows (exact) and a warm bound
    from the exact answers: each against the reference's, the warm bound
    changing no answer and searching no more leaves."""
    ref, port = runs["ref"][backbone], runs["port"][backbone]
    for tag in ("pq", "exact", "warm"):
        key = f"{strategy}_{tag}"
        _close(port[f"{key}_nn"], ref[f"{key}_nn"], port[f"{key}_tot"],
               ref[f"{key}_tot"], (backbone, key))
    np.testing.assert_allclose(port[f"{strategy}_warm_nn"],
                               port[f"{strategy}_exact_nn"], rtol=2e-6)
    assert port[f"{strategy}_warm_tot"].sum() <= \
        port[f"{strategy}_exact_tot"].sum()


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("backbone", BACKBONES)
def test_sharded_trace_accounting(runs, backbone, strategy):
    """The summed trace: probed == S, Σ pruned == S·P − survivors (the
    same identity the reference's satisfies), every query paying rows;
    each count within ``SLACK`` of the reference's, the rows within
    ``SLACK`` leaves of ``MAX_LEAF`` rows."""
    ref, port = runs["ref"][backbone], runs["port"][backbone]
    n_shards, n_slots = ref["leaf_size"].shape
    pre = f"{strategy}_trace_"
    tr = {k[len(pre):]: v for k, v in port.items() if k.startswith(pre)}
    pruned = tr["pruned_box"] + tr["pruned_seed"] + tr["pruned_filter"]
    np.testing.assert_array_equal(pruned, n_shards * n_slots
                                  - tr["survivors"])
    np.testing.assert_array_equal(tr["probed"], np.full(16, n_shards))
    assert (tr["distances"] > 0).all()
    for name, v in tr.items():
        limit = SLACK * (MAX_LEAF if name == "distances" else 1)
        gap = np.abs(v.astype(int) - ref[pre + name].astype(int)).max()
        assert gap <= limit, (name, v, ref[pre + name])


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("backbone", BACKBONES)
def test_sharded_audit_layout(runs, backbone, strategy):
    """The audit in the (S, P) shard-slot layout: every slot partitions
    the 16 queries, the padding slots are empty, the residual histogram
    sums to the count; the counters within ``SLACK`` of the reference's
    in all, the float fields within 1e-5 of each field's largest value
    (float32 sums over the queries in another order)."""
    from repro_torch.obs import audit as obs_audit
    ref, port = runs["ref"][backbone], runs["port"][backbone]
    pre = f"{strategy}_audit_"
    fa = {k[len(pre):]: v for k, v in port.items() if k.startswith(pre)}
    shape = ref["leaf_size"].shape
    assert fa["kept"].shape == shape
    assert fa["resid_buckets"].shape == shape + (obs_audit.N_BUCKETS,)
    parts = fa["pruned_box"] + fa["pruned_seed"] + fa["pruned_filter"] \
        + fa["kept"]
    np.testing.assert_array_equal(parts, np.full(shape, 16))
    pad = ref["leaf_size"] == 0
    assert not fa["kept"][pad].any() and not fa["scored"][pad].any()
    np.testing.assert_array_equal(fa["resid_buckets"].sum(-1),
                                  fa["resid_count"])
    assert (fa["violations"] <= fa["resid_count"]).all()
    for name, v in fa.items():
        want = ref[pre + name]
        assert v.shape == want.shape and v.dtype.kind == want.dtype.kind, \
            name
        if v.dtype.kind == "f":
            fin = np.isfinite(want)
            np.testing.assert_array_equal(np.isfinite(v), fin, err_msg=name)
            scale = max(np.abs(want[fin]).max(initial=0.0), 1.0)
            np.testing.assert_allclose(v[fin], want[fin], rtol=0,
                                       atol=1e-5 * scale, err_msg=name)
        else:
            assert np.abs(v.astype(int) - want.astype(int)).sum() <= \
                SLACK, name


def test_executor_serial_equals_pipelined(runs):
    """The DistributedExecutor session on a 1 x 2 world: the same batch
    log and bitwise the same completions serially and with pipeline=2."""
    served = runs["serve"]
    assert served["batches"][0] == served["batches"][1]
    assert served["results"][0] == served["results"][1]
    assert len(served["results"][0]) == 48


def test_executor_matches_single_host_session(runs):
    """Its answers within 2e-5 relative of the single-host session's on
    the same trace."""
    served = runs["serve"]
    for rid, want in served["single"].items():
        got = served["results"][0][rid]
        assert abs(got["dist"] - want["dist"]) <= \
            2e-5 * max(abs(want["dist"]), 1.0), (rid, got, want)


def test_serve_main_dist_on_two_ranks(runs):
    """``launch/serve.py --dist --backend gloo`` on a world of 2: rank 0
    answers every request on one host and again through the executor, and
    compares the two strategies."""
    served = runs["serve"]
    assert served["main_n_requests"] == served["main_dist_n_requests"] == 32
    with open(os.path.join(runs["dir"], "serve_main.log")) as fh:
        log = fh.read()
    assert "[dist x2]" in log
    assert "serve[dist/scan   ]" in log and "serve[dist/compact]" in log


REHEARSAL = """
import json, sys
sys.path.insert(0, sys.argv[2])
import torch
torch.set_num_threads(1)
import chip_smoke as c
out = c.run_end_to_end(n=2000, m=64, n_queries=16, n_brute=8,
                       leaf_capacity=64, n_global=60, n_local=16, epochs=3,
                       device="cpu")
r = c.run_distribution(out["lfi"], out["queries"], out["targets"],
                       out["results"], device="cpu", n_requests=48,
                       n_serve=32, batch=8, scratch=sys.argv[1],
                       out_dir=sys.argv[1])
print("DIST_PHASE_OK " + json.dumps(sorted(r["gaps"]),
                                    separators=(",", ":")))
"""


def test_chip_smoke_distribution_phase_rehearsal_on_cpu(tmp_path):
    """``chip_smoke.run_distribution`` as the card runs it (4 spawned gloo
    ranks: the 1 x 4 and 2 x 2 meshes, the executor, ``serve.main
    --dist``; the in-process oracles and holds), at a tiny size on the
    CPU, where nothing launches and the nccl run and the seeded kernel's
    holds, which need the card, are left out."""
    r, tail = _run([sys.executable, "-c", REHEARSAL, str(tmp_path), ROOT],
                   600)
    assert "DIST_PHASE_OK" in r.stdout, tail
    line = next(ln for ln in r.stdout.splitlines()
                if ln.startswith("DIST_PHASE_OK"))
    gaps = json.loads(line.split(" ", 1)[1])
    assert "2x2/compact/0.99" in gaps and "1x4/scan/per-query" in gaps
    assert "the executor served 48 requests serially and with " \
        "pipeline=2" in r.stdout
    assert "recall@1 at 0.99" in r.stdout
    assert not os.path.exists(tmp_path / "distribution")


def _load_smoke():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_chip_smoke_files_the_ranks_kernel_calls(monkeypatch, tmp_path):
    """A distribution rank's capture as ``chip_smoke._dist_rank`` makes it:
    the largest call of each kernel of the path (the probe's apart) saved
    with its tensors on the host, loaded back beside the other paths'
    calls as ``<kernel>@distribution`` with equal arguments, and
    ``_phase_calls`` (``check_kernels``) holding each under the phase's
    label."""
    import torch
    from repro_torch.kernels.box_lb import kernel as box_kernel
    from repro_torch.kernels.filter_mlp import kernel as mlp_kernel
    from repro_torch.kernels.leaf_topk import kernel as leaf_kernel
    smoke = _load_smoke()
    monkeypatch.setattr(box_kernel, "box_lb_cuda", lambda q, lo, hi: (
        torch.zeros(q.shape[0], lo.shape[0])))
    monkeypatch.setattr(mlp_kernel, "fused_filter_mlp_cuda",
                        lambda q, w1, *a, **kw: torch.zeros(w1.shape[0],
                                                            q.shape[0]))
    monkeypatch.setattr(leaf_kernel, "leaf_topk_cuda", lambda *a: None)
    rng = np.random.default_rng(0)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32))
    calls: dict = {}
    with smoke.capture_largest_inputs(calls):
        for n in (4, 16, 8):
            box_kernel.box_lb_cuda(t(n, 8), t(10, 8), t(10, 8))
            mlp_kernel.fused_filter_mlp_cuda(t(n, 8), t(3, 8, 5), t(3, 5),
                                             t(3, 5), t(3), t(3), t(3),
                                             t(3, n))
            for scatter, slots in ((True, 3), (False, 1)):
                leaf_kernel.leaf_topk_cuda(
                    t(50, 8), torch.arange(10) * 5, torch.full((10,), 5),
                    t(n, 8), torch.zeros(n, slots, dtype=torch.int64),
                    torch.ones(n, dtype=torch.int64), 1, 5, "direct",
                    t(n, 11, 1), torch.zeros(n, 11, 1, dtype=torch.int64),
                    scatter)
    path = str(tmp_path / "dist_calls.pt")
    smoke._save_phase_calls(calls, path)
    captured = {"box_lb": (1, "main")}
    keys = smoke._load_phase_calls(path, captured, "distribution", "cpu")
    assert keys == sorted(smoke.DIST_CALL_KEYS)
    assert captured["box_lb"] == (1, "main")
    for key in keys:
        size, args = captured[f"{key}@distribution"]
        assert size == calls[key][0]
        assert len(args) == len(calls[key][1])
        for g, w in zip(args, calls[key][1]):
            if torch.is_tensor(w):
                assert torch.equal(g, w)
            else:
                assert g == w
        q = args[3 if key.startswith("leaf_topk") else 0]
        assert q.shape[0] == 16, key
    seen = []
    monkeypatch.setattr(smoke, "_check_call", lambda name, args, label,
                        power: seen.append(label) or {"label": label})
    assert set(smoke._phase_calls("leaf_topk", captured, "700 W",
                                  "distribution")) == {"largest", "probe"}
    smoke._phase_calls("box_lb", captured, "700 W", "distribution")
    assert seen == [
        "leaf_topk (the distribution phase's largest call)",
        "leaf_topk (the distribution phase's probe call)",
        "box_lb (the distribution phase's largest call)"]
    assert smoke._phase_calls("box_lb", captured, "700 W") == {}
