"""Recall at a 0.99 quality target on the iSAX backbone: the reference and
the port side by side, on the CPU.

For one configuration and one collection this reads three indexes:

* ``reference``: the JAX package's own build, searched by the JAX package;
* ``carried``: that index carried across by ``repro_torch.bridge`` (with its
  calibration split) and searched by the port;
* ``port``: the port's own build (its own random draws), searched by the
  port;

each at float32 and after ``requantize_leafi`` to bfloat16 and int8.  A
reading is recall@1 at target 0.99 on the index's own calibration split
and on fresh queries, the pruning, and the tuner's quality knots either
side of 0.99.  The tests run it at a small size and hold ``carried`` to
``reference`` exactly, so a recall below the target that both show is not
the port's.  Run the file as a script for a larger collection, e.g.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_recall_witness.py \\
        --n 100000 --m 256 --leaf-capacity 256 --n-global 600 --n-local 200 \\
        --epochs 300 --t-ratio 20

which prints one line per index and payload and a JSON object at the end.
"""
import argparse
import json
import math
import sys
import time

import numpy as np
import pytest

from repro.core import build, filter_training
from repro.data.series import make_query_set
from repro_torch.core import build as t_build
from repro_torch.core import filter_training as t_training
from test_torch_isax import carry
from _torch_threads import one_torch_thread  # noqa: F401

PAYLOADS = ["float32", "bfloat16", "int8"]
TARGET = 0.99


def config(mod, training, *, leaf_capacity, n_global, n_local, epochs,
           t_ratio):
    return mod.LeaFiConfig(backbone="isax", leaf_capacity=leaf_capacity,
                           n_global=n_global, n_local=n_local,
                           t_filter_over_t_series=t_ratio,
                           train=training.TrainConfig(epochs=epochs))


def tail_probability(n: int, misses: int, target: float = TARGET) -> float:
    """P(at least ``misses`` of ``n`` queries miss) if each hits with
    probability ``target``: how surprising a reading is under the target."""
    p = 1.0 - target
    return sum(math.comb(n, i) * p ** i * (1 - p) ** (n - i)
               for i in range(misses, n + 1))


def reading(lfi, queries, search_kw) -> dict:
    """recall@1 at TARGET on the calibration split and on ``queries``."""
    out = {}
    for split, q in (("calib", np.asarray(lfi.calib.queries)),
                     ("queries", queries)):
        exact = np.asarray(lfi.search_exact(q, **search_kw).dists)[:, 0]
        res = lfi.search(q, quality_target=TARGET, **search_kw)
        got = np.asarray(res.dists)[:, 0]
        hit = got <= exact * (1 + 1e-5) + 1e-6
        out[split] = {"n": int(len(hit)), "recall": float(hit.mean()),
                      "misses": int((~hit).sum()),
                      "pruning": float(1 - np.asarray(res.searched).mean()
                                       / res.n_leaves)}
    knots = np.asarray(lfi.tuner.knots_q)
    i = int(np.searchsorted(knots, TARGET, side="right"))
    out["knots"] = {"K": int(len(knots)),
                    "below": float(knots[i - 1]) if i > 0 else None,
                    "above": float(knots[i]) if i < len(knots) else None}
    return out


def readings(series, queries, cfg: dict) -> dict:
    """{"reference" | "carried" | "port": {payload: reading}}."""
    out = {"reference": {}, "carried": {}, "port": {}}
    ref32 = build.build_leafi(series, config(build, filter_training, **cfg))
    port32 = t_build.build_leafi(series, config(t_build, t_training, **cfg),
                                 device="cpu")
    for payload in PAYLOADS:
        ref, port = ref32, port32
        if payload != "float32":
            ref = build.requantize_leafi(ref32, payload)
            port = t_build.requantize_leafi(port32, payload, device="cpu")
        out["reference"][payload] = reading(ref, queries, {})
        out["carried"][payload] = reading(carry(ref, with_calib=True),
                                          queries, {"device": "cpu"})
        out["port"][payload] = reading(port, queries, {"device": "cpu"})
    return out


@pytest.fixture(scope="module")
def witnessed(randwalk_small):
    queries = make_query_set(randwalk_small, 64, noise=0.2, seed=42)
    return readings(randwalk_small, queries, dict(
        leaf_capacity=64, n_global=200, n_local=50, epochs=40, t_ratio=10.0))


@pytest.mark.parametrize("payload", PAYLOADS)
def test_carried_recall_equals_the_reference(witnessed, payload):
    """The port answers a reference-built index with the reference's recall
    at 0.99, on the calibration split and on fresh queries, from the same
    tuner knots."""
    assert witnessed["carried"][payload] == witnessed["reference"][payload]


@pytest.mark.parametrize("payload", PAYLOADS)
def test_port_build_reading_is_complete(witnessed, payload):
    got = witnessed["port"][payload]
    for split in ("calib", "queries"):
        assert 0.0 <= got[split]["recall"] <= 1.0
        assert got[split]["pruning"] > 0.0        # the filters prune
    assert got["knots"]["K"] > 1
    assert got["calib"]["n"] == witnessed["reference"][payload]["calib"]["n"]


def test_tail_probability():
    assert tail_probability(10, 0) == 1.0
    assert tail_probability(1, 1) == pytest.approx(0.01)
    assert tail_probability(256, 4) == pytest.approx(
        1 - sum(math.comb(256, i) * 0.01 ** i * 0.99 ** (256 - i)
                for i in range(4)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--m", type=int, default=256)
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--leaf-capacity", type=int, default=256)
    ap.add_argument("--n-global", type=int, default=600)
    ap.add_argument("--n-local", type=int, default=200)
    ap.add_argument("--epochs", type=int, default=300)
    ap.add_argument("--t-ratio", type=float, default=20.0)
    args = ap.parse_args(argv)
    from repro_torch.data.series import randwalk
    series = randwalk(args.n, args.m, seed=0)
    queries = make_query_set(series, args.queries, noise=0.2, seed=42)
    t0 = time.perf_counter()
    out = readings(series, queries, dict(
        leaf_capacity=args.leaf_capacity, n_global=args.n_global,
        n_local=args.n_local, epochs=args.epochs, t_ratio=args.t_ratio))
    for side, rows in out.items():
        for payload, r in rows.items():
            parts = [f"{side:9s} {payload:8s}"]
            for split in ("calib", "queries"):
                s = r[split]
                parts.append(
                    f"{split} recall {s['recall']:.4f} ({s['misses']} of "
                    f"{s['n']} missed, P(>= that | {TARGET}) = "
                    f"{tail_probability(s['n'], s['misses']):.3f}) "
                    f"pruning {s['pruning']:.4f}")
            parts.append(f"knots K={r['knots']['K']} around {TARGET}: "
                         f"{r['knots']['below']} .. {r['knots']['above']}")
            print("  ".join(parts))
    print(f"args {vars(args)} in {time.perf_counter() - t0:.1f} s")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
