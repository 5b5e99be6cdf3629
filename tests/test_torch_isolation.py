"""The port stands alone: no module of ``repro_torch`` and no line of
``chip_smoke.py`` imports JAX or the JAX package, nor ``msgpack`` or
``ml_dtypes``, which the card machine lacks; the entry points run on
the card unless asked for the CPU (here, without a card, they raise); a
wrapper given a non-CPU tensor launches its kernel or raises; and
``chip_smoke.py``'s end-to-end function runs on the CPU at a tiny size,
while the script itself fails without a card."""
import ast
import importlib.util
import json
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
SMOKE = REPO / "chip_smoke.py"


def _port_files():
    return sorted(PORT.rglob("*.py")) + [SMOKE]


def _forbidden(name: str) -> bool:
    root = name.split(".")[0]
    return (root == "jax" or root.startswith("jax")
            or root in ("repro", "msgpack", "ml_dtypes"))


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                bad.append(node.module)
    assert not bad, f"{path.name} imports {bad}"


def test_importing_every_port_module_loads_no_jax():
    code = (
        "import json, pkgutil, importlib, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "print(json.dumps({'n': len(names), 'mods': sorted(sys.modules)}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=REPO,
                         env={"PYTHONPATH": str(REPO / "src"),
                              "PATH": "/usr/bin:/bin"})
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["n"] >= 20
    leaked = [m for m in got["mods"] if _forbidden(m)]
    assert not leaked, leaked


def _tiny_index():
    from repro_torch import bridge
    from repro_torch.core import tree
    S = np.random.default_rng(0).standard_normal((300, 16)).astype(
        np.float32).cumsum(1)
    idx = tree.build_dstree(S, leaf_capacity=32)
    return S, bridge.leafi_from_arrays(
        index={"kind": idx.kind, "series": idx.series.numpy(),
               "order": idx.order.numpy(),
               "leaf_start": idx.leaf_start.numpy(),
               "leaf_size": idx.leaf_size.numpy(),
               "max_leaf_size": idx.max_leaf_size,
               "n_series": idx.n_series, "length": idx.length,
               "payload": {k: v.numpy() for k, v in idx.payload.items()}},
        filter_params=None, leaf_ids=np.zeros(0, np.int64), tuner=None,
        device="cpu")


def test_entry_points_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    from repro_torch import bridge
    from repro_torch.core import build, search
    S, lfi = _tiny_index()
    with pytest.raises(RuntimeError, match="CUDA"):
        build.build_leafi(S, build.LeaFiConfig(leaf_capacity=32))
    with pytest.raises(RuntimeError, match="CUDA"):
        search.search_batched(lfi.index, S[:2])
    with pytest.raises(RuntimeError, match="CUDA"):
        lfi.search(S[:2])
    with pytest.raises(RuntimeError, match="CUDA"):
        bridge.leafi_from_arrays({}, None, [], None)
    with pytest.raises(RuntimeError, match="CUDA"):
        build.requantize_leafi(lfi, "int8")
    from repro_torch.launch import serve
    from repro_torch.serving import ServingSession, load_index, save_index
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingSession(lfi)
    save_index(str(tmp_path / "idx"), lfi)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_index(str(tmp_path / "idx"))
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "leafi", "--ckpt", str(tmp_path / "idx"),
                    "--requests", "4"])
    # asked for the CPU, the same calls run
    assert lfi.search(S[:2], device="cpu").ids.shape == (2, 1)
    assert load_index(str(tmp_path / "idx"), device="cpu").index.n_series \
        == lfi.index.n_series
    assert ServingSession(lfi, device="cpu").search_exact(S[:2]).ids.shape \
        == (2, 1)


def test_serve_entry_point_cold_starts_on_the_cpu(tmp_path, capsys):
    """``launch.serve.main`` with ``--device cpu`` cold-starts from a small
    checkpoint written by the JAX package (a DSTree index without filters)
    and answers every request of its trace; the LM archs and ``--dist``
    exit naming the ROADMAP items they wait for."""
    from repro.core import build as ref_build
    from repro.core import tree as ref_tree
    from repro.serving import save_index as ref_save_index
    from repro_torch.launch import serve
    S = np.random.default_rng(0).standard_normal((400, 32)).astype(
        np.float32).cumsum(1)
    ref = ref_build.LeaFiIndex(
        index=ref_tree.build_dstree(S, leaf_capacity=32), filter_params=None,
        leaf_ids=np.zeros(0, np.int64), tuner=None,
        config=ref_build.LeaFiConfig(leaf_capacity=32), build_report={})
    ckpt = str(tmp_path / "ref_ckpt")
    ref_save_index(ckpt, ref)
    report = serve.main(["--arch", "leafi", "--device", "cpu", "--ckpt",
                         ckpt, "--requests", "32", "--batch", "8", "--rate",
                         "400", "--warm-start", "--shadow-rate", "0.25",
                         "--explain", "3", "--summary"])
    assert report["n_requests"] == 32
    assert sorted(report["completions"]) == list(range(32))
    assert sum(c["n"] for c in report["recall_by_target"].values()) == 32
    printed = capsys.readouterr().out
    assert f"cold start from {ckpt}" in printed
    assert "served 32 requests in" in printed
    with pytest.raises(SystemExit, match="ROADMAP A10"):
        serve.main(["--arch", "mixtral-8x7b", "--device", "cpu"])
    with pytest.raises(SystemExit, match="ROADMAP A10"):
        serve.main([])
    with pytest.raises(SystemExit, match="ROADMAP A8"):
        serve.main(["--arch", "leafi", "--dist", "--device", "cpu"])


def test_wrappers_never_fall_back_off_the_cpu():
    """A tensor that does not lie on the CPU goes to the CUDA kernel: on a
    machine without CUDA that raises instead of running the plain version,
    for every kernel and every filter payload."""
    from repro_torch.core import engine
    from repro_torch.kernels.box_lb import ops as box_ops
    from repro_torch.kernels.filter_mlp import ops as mlp_ops
    from repro_torch.kernels.l2_scan import ops as l2_ops
    q = torch.empty((4, 8), device="meta")
    with pytest.raises(RuntimeError):
        l2_ops.pairwise_l2(q, q)
    with pytest.raises(RuntimeError):
        l2_ops.slab_l2(q[None], q[None], "pairwise")
    with pytest.raises(RuntimeError):
        box_ops.box_lb(q, q, q)
    with pytest.raises(RuntimeError):
        box_ops.sax_lb(q, torch.empty((3, 8, 2), device="meta"), length=64)
    with pytest.raises(RuntimeError):
        box_ops.eapca_lb(torch.empty((4, 4, 2), device="meta"),
                         torch.empty((3, 4, 4), device="meta"),
                         torch.empty((4,), device="meta"))
    w1 = torch.empty((2, 8, 8), device="meta")
    v = torch.empty((2, 8), device="meta")
    s = torch.empty((2,), device="meta")
    with pytest.raises(RuntimeError):
        mlp_ops.filter_predict_fused(w1, v, v, s, s, s, q)
    with pytest.raises(RuntimeError):
        mlp_ops.filter_predict_fused(w1.bfloat16(), v, v.bfloat16(), s, s, s,
                                     q)
    with pytest.raises(RuntimeError):
        mlp_ops.filter_predict_fused(w1.to(torch.int8), v, v.to(torch.int8),
                                     s, s, s, q, None, s, s)
    # the candidate pass, as the engine dispatches it
    i64 = dict(dtype=torch.int64, device="meta")
    with pytest.raises(RuntimeError):
        engine._bucket_leaf_topk(q, torch.empty(3, **i64),
                                 torch.empty(3, **i64), q,
                                 torch.empty((4, 3), **i64),
                                 torch.empty(4, **i64), 2, 8, "matmul",
                                 torch.empty((4, 4, 2), device="meta"),
                                 torch.empty((4, 4, 2), **i64), True)
    # int8 weights without their scales are refused before any launch
    with pytest.raises(ValueError, match="scale"):
        mlp_ops.filter_predict_fused(w1.to(torch.int8), v, v.to(torch.int8),
                                     s, s, s, q)


def _load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", SMOKE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_end_to_end_rehearsal_on_cpu(capsys):
    smoke = _load_smoke()
    out = smoke.run_end_to_end(n=2000, m=64, n_queries=16, n_brute=8,
                               leaf_capacity=64, n_global=60, n_local=16,
                               epochs=3, device="cpu")
    assert len(out["results"]) == 16
    assert set(out["launches"]) == {"pairwise_l2", "slab_l2",
                                    "fused_filter_mlp",
                                    "fused_filter_mlp_bf16",
                                    "fused_filter_mlp_int8", "box_lb",
                                    "filter_mlp", "replay", "train_forward",
                                    "train_backward_sgd", "leaf_topk",
                                    "early_walk", "filter_cnn",
                                    "filter_rnn", "dtw"}
    parts = smoke.search_breakdown(out["lfi"], out["queries"], reps=1)
    assert parts["search"] > 0 and parts["replay"] > 0
    steps = smoke.collect_breakdown(out["lfi"], "dstree ")
    assert set(steps) == {
        "global queries", "nodewise_nn_distances",
        "nodewise_nn_distances/gather", "nodewise_nn_distances/pairwise_l2",
        "nodewise_nn_distances/rest", "lower bounds", "local queries",
        "local_nn_distances", "local_nn_distances/gather",
        "local_nn_distances/slab_l2", "local_nn_distances/masked min",
        "local_nn_distances/rest", "timed call", "plain call"}
    assert min(steps.values()) >= 0 and steps["nodewise_nn_distances"] \
        <= steps["timed call"]
    isax = smoke.run_isax(n=2000, m=64, n_queries=16, n_brute=8,
                          leaf_capacity=64, n_global=60, n_local=16,
                          epochs=3, device="cpu")
    assert isax["lfi"].index.kind == "isax"
    assert set(isax["results"]) == {(p, k, t) for p in smoke.PAYLOADS
                                    for k in (1, 5) for t in smoke.TARGETS}
    assert set(isax["launches"]) == set(out["launches"])
    printed = capsys.readouterr().out
    assert "exact search == brute force on 8 queries" in printed
    assert "target=per-query" in printed
    assert "breakdown k=5 target=0.99" in printed
    assert "isax exact search == brute force on 8 queries" in printed
    assert "dstree t_collect breakdown (ms, warm" in printed
    for payload in smoke.PAYLOADS:
        assert f"isax payload={payload}" in printed


def test_chip_smoke_new_phases_rehearsal_on_cpu(capsys):
    """search_early, the grouped search and the filter suite, each as
    chip_smoke.py drives them, at a tiny size on the CPU."""
    smoke = _load_smoke()
    out = smoke.run_end_to_end(n=2000, m=64, n_queries=16, n_brute=8,
                               leaf_capacity=64, n_global=60, n_local=16,
                               epochs=3, device="cpu")
    early = smoke.run_early(out["lfi"], out["queries"], out["results"],
                            n_early=4, device="cpu")
    assert set(early["results"]) == {(k, t) for k in (1, 5)
                                     for t in ("exact", "0.99")}
    grouped = smoke.run_grouped(out["lfi"], out["queries"], out["targets"],
                                out["results"], device="cpu")
    assert set(grouped["results"]) == {1, 5}
    captured: dict = {}
    suite = smoke.run_filter_suite(
        len(out["lfi"].leaf_ids), sweep=dict(f_values=(3, 6), q=8, m=16,
                                             h=16),
        main_shape=(16, 64, 64), device="cpu", captured=captured)
    assert [p["config"]["f_values"] for p in suite["payloads"]] == \
        [[3, 6], [len(out["lfi"].leaf_ids)]]
    assert not captured                  # no kernel is launched on the CPU
    for launches in (early["launches"], grouped["launches"],
                     suite["launches"]):
        assert set(launches) == set(out["launches"])
    printed = capsys.readouterr().out
    assert "search_early exact search == brute force on 4 queries (k=1/5" \
        in printed
    for k in (1, 5):
        for t in ("exact", "0.99 "):
            assert f"search_early k={k} target={t}" in printed
        assert f"grouped    k={k} target=per-query" in printed
    assert "filter suite, main shape" in printed
    assert "filters/per_filter/float32/F6" in printed
    assert set(smoke.SUITE_KERNELS) | set(smoke.SEARCH_KERNELS) \
        <= set(smoke.KERNELS)


def test_chip_smoke_wide_dstree_and_training_profile_on_cpu(capsys):
    """The d = 128 DSTree phase and the training profile, each as
    chip_smoke.py drives them, at a tiny size on the CPU (where the
    profiler sees no device and the wrappers launch nothing)."""
    smoke = _load_smoke()
    wide = smoke.run_wide_dstree(n=1500, m=256, n_segments=64, n_queries=8,
                                 epochs=20, device="cpu")
    assert set(wide["launches"]) == set(smoke.KERNELS)
    prof = wide["profiled_build"]
    assert set(prof["spans_s"]) == set(smoke.BUILD_SPANS)
    assert prof["wall_s"] > 0 and not any(prof["kernels"].values())
    out = smoke.run_end_to_end(n=2000, m=64, n_queries=8, n_brute=8,
                               leaf_capacity=64, n_global=60, n_local=16,
                               epochs=20, device="cpu")
    prof = smoke.training_profile(out["lfi"], "dstree ", skip=4, window=4)
    assert prof["steps_in_build"] == 20 * ((42 + 16) // 128 or 1)
    assert prof["wall_ms_per_step"] > 0 and prof["launches_per_step"] == 0
    assert prof["device_busy_ms_per_step"] is None
    printed = capsys.readouterr().out
    assert "dstree d=128 exact search == brute force on 8 queries" in printed
    assert "dstree d=128 build spans (name, depth, lane, duration, args)" \
        in printed
    assert "dstree d=128 profiled build: wall" in printed
    assert "every span one user_annotation" in printed
    assert "dstree training profile (F=" in printed


def test_new_modules_are_checked():
    """The import checks above reach the port's analysis, bench, obs,
    checkpoint, serving and launch modules."""
    names = {str(p.relative_to(PORT)) for p in _port_files() if PORT in
             p.parents}
    for mod in ("analysis/roofline.py", "bench/filters_bench.py",
                "kernels/filter_train/kernel.py",
                "kernels/filter_train/ref.py", "data/series.py",
                "kernels/leaf_topk/kernel.py", "kernels/leaf_topk/ref.py",
                "kernels/early_walk/kernel.py", "kernels/early_walk/ref.py",
                "core/baselines.py", "core/selection.py",
                "kernels/filter_cnn/kernel.py", "kernels/filter_cnn/ref.py",
                "kernels/filter_rnn/kernel.py", "kernels/filter_rnn/ref.py",
                "kernels/dtw/kernel.py", "kernels/dtw/ref.py", "core/dtw.py",
                "bench/lstm_designs.py", "bench/backbone_sources.py",
                "obs/__init__.py", "obs/trace.py", "obs/audit.py",
                "obs/metrics.py", "obs/spans.py", "obs/export.py",
                "obs/health.py", "obs/explain.py",
                "checkpoint/__init__.py", "checkpoint/_msgpack.py",
                "checkpoint/manager.py", "serving/__init__.py",
                "serving/batcher.py", "serving/session.py",
                "serving/shadow.py", "serving/telemetry.py",
                "serving/warmstart.py", "launch/__init__.py",
                "launch/serve.py"):
        assert mod in names


def test_spans_pass_through_is_torch_not_jax():
    """The span recorder annotates through ``torch.profiler`` and names no
    JAX anywhere in its source, docstrings included; the package exports
    every name of the reference's ``repro.obs``."""
    text = (PORT / "obs" / "spans.py").read_text()
    assert "jax" not in text.lower()
    assert "from torch.profiler import record_function" in text
    from repro_torch import obs
    ref = REPO / "src" / "repro" / "obs" / "__init__.py"
    tree = ast.parse(ref.read_text())
    names = next(ast.literal_eval(node.value) for node in tree.body
                 if isinstance(node, ast.Assign)
                 and node.targets[0].id == "__all__")
    assert set(names) <= set(obs.__all__)
    for name in names:
        assert hasattr(obs, name), name


def test_serving_exports_the_references_names():
    """``repro_torch.serving`` exports every name the reference's
    ``repro.serving`` imports into its package, except
    ``DistributedExecutor``, which waits for the distributed search."""
    from repro_torch import serving
    ref = REPO / "src" / "repro" / "serving" / "__init__.py"
    names = {a.asname or a.name for node in ast.parse(ref.read_text()).body
             if isinstance(node, ast.ImportFrom) for a in node.names}
    assert "DistributedExecutor" in names
    for name in names - {"DistributedExecutor"}:
        assert hasattr(serving, name), name
    assert not hasattr(serving, "DistributedExecutor")


def test_chip_smoke_bounds_use_the_roofline_module():
    """The kernel checks' bounds take the H100's peaks and the filter
    kernels' operation count from ``analysis/roofline.py``."""
    from repro_torch.analysis import roofline
    smoke = _load_smoke()
    q, w1 = torch.zeros((256, 256)), torch.zeros((4096, 256, 256))
    for name in ("filter_mlp", "fused_filter_mlp"):
        ms, by = smoke._bound(name, (q, w1))
        assert by == "operations"
        assert ms == roofline.mlp_operations(4096, 256, 256, 256) \
            / roofline.H100.peak_flops * 1e3


@pytest.mark.parametrize("alone", [False, True], ids=["repo", "alone"])
def test_chip_smoke_script_fails_without_a_card(tmp_path, alone):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    script = SMOKE
    if alone:                         # chip_smoke.py and nothing of the repo
        script = tmp_path / "chip_smoke.py"
        shutil.copy(SMOKE, script)
    proc = subprocess.run([sys.executable, str(script)], capture_output=True,
                          text=True, cwd=script.parent, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
