"""The split-TF32 products of the port's tensor-core kernels, rehearsed on
the CPU, and what stays fixed around the redesigned kernels.

``pairwise_l2`` and the fused filter kernel's tile design take their
products on the tensor cores as split TF32 (``csrc/tf32x3.cuh``).  The CUDA
kernels run only on the card; their arithmetic is emulated here
(``kernels/l2_scan/ref.py`` ``split_tf32_matmul``: TF32 rounding by bit
operations, one m16n8k8 step per 8-deep slice, each step's sum rounded
toward zero) and held, at the main paths' widths, to the same limits that
``chip_smoke.py`` holds the kernels to on the card: against the port's
float32 plain version and against the JAX package's function on the same
numpy inputs.  A one-pass TF32 product misses those limits, which the
tests show too.
"""
import ctypes
import importlib.util
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import filters as j_filters
from repro.kernels.filter_mlp import ops as j_mlp_ops
from repro.kernels.l2_scan import ops as j_l2_ops
from repro_torch.kernels import common
from repro_torch.kernels.box_lb import kernel as box_kernel
from repro_torch.kernels.filter_mlp import kernel as mlp_kernel
from repro_torch.kernels.filter_mlp import ref as mlp_ref
from repro_torch.kernels.l2_scan import kernel as l2_kernel
from repro_torch.kernels.l2_scan import ref as l2_ref
from _torch_threads import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _chip_limits() -> dict:
    """``chip_smoke.py``'s limits (atol, rtol) by kernel."""
    return {name: row[2] for name, row in _load_smoke().KERNELS.items()}


def _limit(name: str, plain: np.ndarray) -> float:
    atol, rtol = _chip_limits()[name]
    return atol + rtol * float(np.abs(plain).max())


def _znorm(x: np.ndarray) -> np.ndarray:
    mu = x.mean(1, keepdims=True)
    sd = x.std(1, keepdims=True)
    return ((x - mu) / sd).astype(np.float32)


def _series_and_queries(n: int, n_queries: int, m: int = 256):
    """z-normalized random-walk rows (numpy seed 0) and noisy copies of
    some of them at the build's noise levels (0.1 .. 0.4), z-normalized."""
    rng = np.random.default_rng(0)
    series = _znorm(rng.standard_normal((n, m)).cumsum(1))
    rows = rng.integers(0, n, n_queries)
    level = rng.uniform(0.1, 0.4, (n_queries, 1))
    queries = _znorm(series[rows] + level * rng.standard_normal((n_queries,
                                                                  m)))
    return series, queries


def test_chip_limits_are_unchanged():
    """The rehearsal below uses chip_smoke.py's limits; they are the first
    port's float32 limits for every kernel."""
    limits = _chip_limits()
    assert set(limits) == {"pairwise_l2", "slab_l2", "fused_filter_mlp",
                           "fused_filter_mlp_bf16", "fused_filter_mlp_int8",
                           "box_lb", "filter_mlp"}
    assert set(limits.values()) == {(1e-4, 1e-5)}


def test_tf32_round_is_cvt_rna():
    """Nearest with ties away from zero, symmetric in the sign, and exact
    for values with at most 11 significant bits (bf16 and int8 payloads)."""
    ulp = 2.0 ** -10
    x = torch.tensor([1.0, 1 + ulp / 2, 1 + ulp / 2 - 2 ** -23, 1 + ulp / 4,
                      1 + 3 * ulp / 4, 3.14159265, 0.0, 2.0 ** -130])
    want = torch.tensor([1.0, 1 + ulp, 1.0, 1.0, 1 + ulp, 3.140625, 0.0,
                         2.0 ** -130])
    torch.testing.assert_close(l2_ref.tf32_round(x), want, rtol=0, atol=0)
    torch.testing.assert_close(l2_ref.tf32_round(-x), -want, rtol=0, atol=0)
    rng = np.random.default_rng(0)
    bf16 = torch.from_numpy(rng.standard_normal(4096).astype(np.float32)
                            ).bfloat16().float()
    int8 = torch.arange(-128, 128, dtype=torch.float32)
    for exact in (bf16, int8):
        torch.testing.assert_close(l2_ref.tf32_round(exact), exact, rtol=0,
                                   atol=0)


@pytest.mark.parametrize("b_exact", [False, True])
def test_split_tf32_matmul_is_exact_on_small_integers(b_exact):
    """Integers below 2^11 are exact in TF32 and their products and sums in
    float32: the emulation returns the exact product, with either split."""
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.integers(-100, 100, (2, 9, 37)).astype(
        np.float32))
    b = torch.from_numpy(rng.integers(-100, 100, (37, 11)).astype(np.float32))
    got = l2_ref.split_tf32_matmul(a, b, b_exact=b_exact)
    assert got.shape == (2, 9, 11)
    torch.testing.assert_close(got, (a.double() @ b.double()).float(),
                               rtol=0, atol=0)


def test_pairwise_split_tf32_within_the_chip_limit():
    """600 × 4096 × 256, the build's query count and width: within
    ``pairwise_l2``'s card limit of both the port's plain version and the
    JAX package's, where a one-pass TF32 product is not."""
    series, queries = _series_and_queries(4096, 600)
    q, s = torch.from_numpy(queries), torch.from_numpy(series)
    got = l2_ref.pairwise_l2_split_tf32(q, s).numpy()
    plain = l2_ref.pairwise_l2_matmul(q, s).numpy()
    jax_ref = np.asarray(j_l2_ops.pairwise_l2(jnp.asarray(queries),
                                              jnp.asarray(series)))
    limit = _limit("pairwise_l2", plain)
    assert np.abs(got - plain).max() <= limit
    assert np.abs(got - jax_ref).max() <= limit
    one_pass = torch.sqrt(torch.clamp_min(
        (q * q).sum(-1)[:, None] + (s * s).sum(-1)[None, :]
        - 2.0 * (l2_ref.tf32_round(q) @ l2_ref.tf32_round(s).T), 0.0))
    assert np.abs(one_pass.numpy() - plain).max() > 4 * limit


def _suite_stack(F: int, m: int, h: int):
    """The filter suite's draws (numpy seed 0, its order and scales)."""
    rng = np.random.default_rng(0)
    draws = [rng.standard_normal((F, m, h)) * 0.2,
             rng.standard_normal((F, h)) * 0.1,
             rng.standard_normal((F, h)) * 0.2, rng.standard_normal((F,)),
             rng.standard_normal((F,)),
             np.abs(rng.standard_normal((F,))) + 0.5,
             np.abs(rng.standard_normal((F,)))]
    return [d.astype(np.float32) for d in draws]


def _from_jax(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


@pytest.mark.parametrize("n_queries", [256, 1])
@pytest.mark.parametrize("payload,entry", [
    ("float32", "fused_filter_mlp"), ("bfloat16", "fused_filter_mlp_bf16"),
    ("int8", "fused_filter_mlp_int8")])
def test_fused_split_tf32_within_the_chip_limit(payload, entry, n_queries):
    """F = 64 filters at m = h = 256 (the search's widths), the payload
    quantized by the JAX package: the tile design's split products
    (three for float32 weights, two for bf16/int8) are within the card
    limit of the port's plain version and of the JAX package's."""
    w1, b1, w2, b2, ym, ys, off = _suite_stack(64, 256, 256)
    _, queries = _series_and_queries(4096, n_queries)
    if payload == "float32":
        jw = {"w1": jnp.asarray(w1), "w2": jnp.asarray(w2)}
    else:
        jw = j_filters.quantize_mlp({"w1": jnp.asarray(w1),
                                     "w2": jnp.asarray(w2)}, payload)
    s1, s2 = jw.get("w1_scale"), jw.get("w2_scale")
    jax_ref = np.asarray(j_mlp_ops.filter_predict_fused(
        jw["w1"], jnp.asarray(b1), jw["w2"], jnp.asarray(b2),
        jnp.asarray(ym), jnp.asarray(ys), jnp.asarray(queries),
        jnp.asarray(off), s1, s2))
    t = [torch.from_numpy(a) for a in (b1, b2, ym, ys, queries, off)]
    tw1, tw2 = _from_jax(jw["w1"]), _from_jax(jw["w2"])
    ts = [None if x is None else _from_jax(x) for x in (s1, s2)]
    args = (tw1, t[0], tw2, t[1], t[2], t[3], t[4], t[5], *ts)
    got = mlp_ref.filter_predict_destd_split_tf32(*args).numpy()
    plain = mlp_ref.filter_predict_destd(*args).numpy()
    assert got.shape == (64, n_queries)
    limit = _limit(entry, plain)
    assert np.abs(got - plain).max() <= limit
    assert np.abs(got - jax_ref).max() <= limit


def test_regime_follows_the_query_count():
    """search_early's single query streams the weights; batches take the
    tensor-core tiles.  The Python helper and the C entry share the limit."""
    limit = mlp_kernel.STREAM_MAX_Q
    assert limit >= 1
    assert [mlp_kernel.regime(q) for q in (1, limit, limit + 1, 128, 256)] \
        == ["stream", "stream", "tile", "tile", "tile"]
    source = (common.CSRC / "filter_mlp.cu").read_text()
    assert re.findall(r"#define FILTER_MLP_STREAM_MAX_Q (\d+)", source) \
        == [str(limit)]


def test_entries_and_counters_are_unchanged():
    """The redesign keeps every C entry's name and argument list, the
    payload → entry table and the launch counters."""
    assert mlp_kernel.ENTRY == {torch.float32: "fused_filter_mlp",
                                torch.bfloat16: "fused_filter_mlp_bf16",
                                torch.int8: "fused_filter_mlp_int8"}
    assert set(mlp_kernel.LAUNCHES) == {
        "fused_filter_mlp", "fused_filter_mlp_bf16", "fused_filter_mlp_int8",
        "filter_mlp"}
    assert set(l2_kernel.LAUNCHES) == {"pairwise_l2", "slab_l2"}
    assert set(box_kernel.LAUNCHES) == {"box_lb"}
    ptr, num = ctypes.c_void_p, ctypes.c_int
    sig = {**mlp_kernel._SIGNATURES, **l2_kernel._SIGNATURES}
    assert sig["fused_filter_mlp"] == [ptr] * 9 + [num] * 4 + [ptr]
    assert sig["fused_filter_mlp_bf16"] == [ptr] * 9 + [num] * 4 + [ptr]
    assert sig["fused_filter_mlp_int8"] == [ptr] * 11 + [num] * 4 + [ptr]
    assert sig["filter_mlp"] == [ptr] * 6 + [num] * 4 + [ptr]
    assert sig["pairwise_l2"] == [ptr] * 3 + [num] * 3 + [ptr]
    assert sig["slab_l2"] == [ptr] * 3 + [num] * 4 + [ptr]
    for name, src in (("filter_mlp", "filter_mlp.cu"),
                      ("l2_scan", "l2_scan.cu")):
        text = (common.CSRC / src).read_text()
        entries = re.findall(r'extern "C" int (\w+)\(', text)
        assert set(entries) <= set(sig), name


def test_library_hash_follows_included_headers(tmp_path, monkeypatch):
    """An edited header that a source includes (directly or through another
    header) changes the library's file name, so it is rebuilt; a header it
    does not include leaves the name alone.  No nvcc is needed."""
    (tmp_path / "k.cu").write_text('#include <cuda_runtime.h>\n'
                                   '#include "a.cuh"\nint k;\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text('// b\n')
    (tmp_path / "other.cuh").write_text('// other\n')
    monkeypatch.setattr(common, "CSRC", tmp_path)
    assert [p.name for p in common._sources("k")] == ["k.cu", "a.cuh",
                                                       "b.cuh"]
    before = common._lib_path("k")
    assert before.parent == common.BUILD_DIR
    (tmp_path / "other.cuh").write_text('// other, edited\n')
    assert common._lib_path("k") == before
    (tmp_path / "b.cuh").write_text('// b, edited\n')
    after = common._lib_path("k")
    assert after != before and after.name.startswith("libk-")
    # the port's own sources: both redesigned kernels include the header
    monkeypatch.setattr(common, "CSRC", ROOT / "src/repro_torch/csrc")
    for name in ("l2_scan", "filter_mlp"):
        assert [p.name for p in common._sources(name)] == [f"{name}.cu",
                                                            "tf32x3.cuh"]


def test_chip_smoke_tensor_core_bound():
    """The split-TF32 kernels' second bound: passes × operations at the TF32
    peak against the same bytes; the float32 bound is unchanged."""
    from repro_torch.analysis import roofline
    smoke = _load_smoke()
    q, s = torch.zeros((600, 256)), torch.zeros((65536, 256))
    flops = 2 * 600 * 65536 * 256 + 2 * (600 + 65536) * 256 + 4 * 600 * 65536
    nbytes = 4 * (600 * 256 + 65536 * 256 + 600 * 65536)
    assert smoke._bound("pairwise_l2", (q, s)) == (
        flops / roofline.H100.peak_flops * 1e3, "operations")
    ms, by = smoke._bound("pairwise_l2", (q, s), 3)
    assert by == "operations"
    assert ms == 3 * flops / roofline.H100.tf32_flops * 1e3
    # the function's own one-pass bound on the tensor cores: its 225 MB
    ms, by = smoke._bound("pairwise_l2", (q, s), 1)
    assert by == "bytes"
    assert ms == nbytes / roofline.H100.hbm_bw * 1e3
    # search_early's single query is bound by the weight bytes either way
    q1, w1 = torch.zeros((1, 256)), torch.zeros((4096, 256, 256))
    assert smoke._bound("fused_filter_mlp", (q1, w1))[1] == "bytes"
    assert smoke._bound("fused_filter_mlp", (q1, w1), 3)[1] == "bytes"
    assert {name for name, (_, passes) in smoke.DESIGN.items() if passes} \
        == {"pairwise_l2", "fused_filter_mlp", "fused_filter_mlp_bf16",
            "fused_filter_mlp_int8"}
    assert set(smoke.DESIGN) == set(smoke.KERNELS)


def test_chip_smoke_captures_the_fewest_queries(monkeypatch):
    """Beside each kernel's largest call, the fused entries keep the call
    with the fewest queries (search_early's single query on the card)."""
    smoke = _load_smoke()
    monkeypatch.setattr(mlp_kernel, "fused_filter_mlp_cuda",
                        lambda q, w1, *rest: torch.zeros(w1.shape[0],
                                                         q.shape[0]))
    w1 = torch.zeros((4, 8, 8))
    captured: dict = {}
    with smoke.capture_largest_inputs(captured):
        for n_q in (5, 1, 9, 1):
            mlp_kernel.fused_filter_mlp_cuda(torch.zeros((n_q, 8)), w1)
    assert captured["fused_filter_mlp"][0] == 4 * 9
    assert captured["fused_filter_mlp@min_q"][0] == 1
    assert captured["fused_filter_mlp@min_q"][1][0].shape == (1, 8)
    assert set(captured) == {"fused_filter_mlp", "fused_filter_mlp@min_q"}


def test_chip_smoke_ptxas_report_rejects_spills_of_the_new_kernels(capsys):
    """The build's ptxas lines are printed per kernel; a spill in a
    redesigned kernel fails the run, one in an earlier kernel does not."""
    smoke = _load_smoke()

    def report(func, stores):
        return (f"ptxas info    : Compiling entry function '{func}' for "
                f"'sm_90a'\nptxas info    : Function properties for {func}\n"
                f"    0 bytes stack frame, {stores} bytes spill stores, "
                f"{stores} bytes spill loads\nptxas info    : Used 168 "
                f"registers, 110592 bytes smem, 400 bytes cmem[0]\n")
    new = "_ZN12_GLOBAL__N_116mlp_tile_kernelIfEEvPKf"
    old = "_ZN12_GLOBAL__N_110mlp_kernelIfLb0EEEvPKf"
    smoke._ptxas_report({"filter_mlp": report(new, 0) + report(old, 8),
                         "box_lb": ""})
    printed = capsys.readouterr().out
    assert f"filter_mlp: {new}: Used 168 registers" in printed
    assert "box_lb: already built" in printed
    with pytest.raises(AssertionError, match="spills"):
        smoke._ptxas_report({"l2_scan": report(
            "_ZN12_GLOBAL__N_116l2_tf32x3_kernelEPKf", 16)})


def test_chip_smoke_ragged_calls_reach_every_staging_path():
    """The untimed held calls cover what the main paths do not: both fused
    designs for every payload, partial query tiles, m % 4 != 0 and h not a
    multiple of a payload's 16-byte vector; pairwise_l2 with odd B and
    m % 4 != 0.  Their split-TF32 emulation is within the card's limits."""
    smoke = _load_smoke()
    calls = smoke.ragged_calls(device="cpu")
    assert set(calls) == {"pairwise_l2", *mlp_kernel.ENTRY.values()}
    assert any(q.shape[1] % 4 and b.shape[0] % 2
               for q, b in calls["pairwise_l2"])
    assert any(q.shape[0] % 128 for q, _ in calls["pairwise_l2"])
    for q, b in calls["pairwise_l2"]:
        plain = l2_ref.pairwise_l2_matmul(q, b).numpy()
        got = l2_ref.pairwise_l2_split_tf32(q, b).numpy()
        assert np.abs(got - plain).max() <= _limit("pairwise_l2", plain)
    for entry in mlp_kernel.ENTRY.values():
        vec = 16 // {"fused_filter_mlp": 4, "fused_filter_mlp_bf16": 2,
                     "fused_filter_mlp_int8": 1}[entry]
        shapes = [(call[0].shape[0],) + tuple(call[1].shape[1:])
                  for call in calls[entry]]
        assert {mlp_kernel.regime(n_q) for n_q, _, _ in shapes} \
            == {"stream", "tile"}
        assert any(n_q > 128 and n_q % 128 for n_q, _, _ in shapes)
        assert any(m % 4 for _, m, _ in shapes)
        assert any(h % vec for _, _, h in shapes)
        for call in calls[entry]:
            q, w1, b1, w2, b2, ym, ys, off, s1, s2 = call
            assert (s1 is not None) == (w1.dtype == torch.int8)
            args = (w1, b1, w2, b2, ym, ys, q, off, s1, s2)
            plain = mlp_ref.filter_predict_destd(*args).numpy()
            got = mlp_ref.filter_predict_destd_split_tf32(*args).numpy()
            assert np.abs(got - plain).max() <= _limit(entry, plain)


def test_fused_designs_bench_builds_scratch_copies():
    """The designs bench compiles two copies of the fused source with the
    stream limit set by -D (0: every call tiled; above any Q: every call
    streamed) beside, not over, the product library.  No nvcc is needed."""
    from repro_torch.bench import fused_designs
    product = common._lib_path("filter_mlp")
    paths = set()
    for design, limit in (("tile", 0), ("stream", 1 << 30)):
        out, cmd = fused_designs.variant(design)
        assert out.parent == product.parent and out != product
        assert f"-DFILTER_MLP_STREAM_MAX_Q={limit}" in cmd
        assert cmd[-1] == str(common.CSRC / "filter_mlp.cu")
        assert cmd[cmd.index("-o") + 1] == str(out)
        paths.add(out)
    assert len(paths) == 2
    assert (fused_designs.ATOL, fused_designs.RTOL) == _chip_limits()[
        "fused_filter_mlp"]


@pytest.mark.parametrize("stream, tile, want", [
    ((1.0, 1.0, 2.0, 5.0), (3.0, 1.5, 1.9, 2.0), 2),
    ((1.0, 1.0, 1.0, 1.0), (2.0, 2.0, 2.0, 2.0), 8),
    ((3.0, 1.0, 1.0, 1.0), (2.0, 2.0, 2.0, 2.0), None),
    ((1.0, 3.0, 1.0, 1.0), (2.0, 2.0, 2.0, 2.0), 1),
])
def test_fused_designs_crossover(stream, tile, want):
    """The limit read from the sweep: the largest Q up to which the stream
    design is never slower than the tile design."""
    from repro_torch.bench import fused_designs
    assert fused_designs.crossover((1, 2, 4, 8), stream, tile) == want
