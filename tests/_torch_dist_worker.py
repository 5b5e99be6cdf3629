"""Rank processes for ``tests/test_torch_distributed.py``: a world of
spawned ``gloo`` ranks on the CPU, one process each, initialised through a
``file://`` store in the run's directory.

    python tests/_torch_dist_worker.py search DIR     # 4 ranks, a 2 x 2 mesh
    python tests/_torch_dist_worker.py serve DIR      # 2 ranks, a 1 x 2 mesh

``search`` loads each backbone's checkpoint (``DIR/<backbone>_ckpt``,
written by the JAX package) through the port's ``load_index`` and runs
``make_distributed_search`` on the inputs of ``DIR/<backbone>_ref.npz``:
both strategies traced and audited at the build's target, and with
per-query offsets (mixed targets, +inf rows, a warm bound); rank 0 writes
``DIR/<backbone>_port.npz``.  ``serve`` serves one seeded trace through a
``DistributedExecutor`` session serially and with ``pipeline=2``, the
single-host session beside, then ``launch/serve.py --dist``; rank 0
writes ``DIR/serve.json`` and ``DIR/serve_main.log``.  A rank that fails
fails the run (``torch.multiprocessing.spawn`` raises its exception).
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import sys

import numpy as np
import torch
import torch.multiprocessing as mp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

#: a rank's collectives raise after this long without their peers
TIMEOUT_S = 120.0
#: the serving trace: rate, requests, targets, seed, the batcher's cap
TRACE = dict(rate=800.0, n_requests=48, targets=(0.9, 0.99), ks=(1,),
             seed=3)
MAX_BATCH = 8


def _service(b) -> float:
    return 1e-3 * max(b.bucket / MAX_BATCH, 0.25)


def _search(rank: int, out: str) -> None:
    from repro_torch.core import distributed
    from repro_torch.serving.session import load_index
    mesh = distributed.make_search_mesh(2, 2, device="cpu",
                                        timeout_s=TIMEOUT_S)
    for backbone in ("dstree", "isax"):
        ref = np.load(os.path.join(out, f"{backbone}_ref.npz"))
        lfi = load_index(os.path.join(out, f"{backbone}_ckpt"), device="cpu")
        sharded = distributed.shard_leafi(lfi, 2, quality_target=0.99,
                                          device="cpu")
        q = torch.from_numpy(ref["queries"])
        got = {}
        for strategy in ("scan", "compact"):
            run = distributed.make_distributed_search(
                mesh, sharded, strategy=strategy, trace=True, audit=True,
                device="cpu")
            nn, tot, tr, fa = run(q)
            got[f"{strategy}_nn"], got[f"{strategy}_tot"] = nn, tot
            for name, v in zip(tr._fields, tr):
                got[f"{strategy}_trace_{name}"] = v
            for name, v in zip(fa._fields, fa):
                got[f"{strategy}_audit_{name}"] = v
            plain = distributed.make_distributed_search(
                mesh, sharded, strategy=strategy, device="cpu")
            got[f"{strategy}_plain_nn"], got[f"{strategy}_plain_tot"] = \
                plain(q)
            pq = distributed.make_distributed_search(
                mesh, sharded, strategy=strategy, per_query_offsets=True,
                device="cpu")
            for tag, off, ub in (("pq", "qoff", "inf_ub"),
                                 ("exact", "inf_rows", "inf_ub"),
                                 ("warm", "inf_rows", "ub")):
                got[f"{strategy}_{tag}_nn"], got[f"{strategy}_{tag}_tot"] = \
                    pq(q, torch.from_numpy(ref[off]), torch.from_numpy(ref[ub]))
        if rank == 0:
            np.savez(os.path.join(out, f"{backbone}_port.npz"),
                     **{k: v.numpy() for k, v in got.items()})


def _strip(log: list) -> list:
    host = ("wall", "dispatch_s", "harvest_s", "t_disp", "t_done")
    return [{k: v for k, v in b.items() if k not in host} for b in log]


def _serve(rank: int, out: str) -> None:
    from repro_torch import serving
    from repro_torch.core import distributed
    from repro_torch.launch import serve
    from repro_torch.serving.session import load_index
    ckpt = os.path.join(out, "dstree_ckpt")
    lfi = load_index(ckpt, device="cpu")
    mesh = distributed.make_search_mesh(1, 2, device="cpu",
                                        timeout_s=TIMEOUT_S)
    pool = np.load(os.path.join(out, "pool.npy"))
    trace = serving.poisson_trace(pool, **TRACE)
    reports = {}
    for pipeline in (0, 2):
        ex = serving.DistributedExecutor(lfi, mesh, device="cpu")
        if rank:
            ex.follow()
            continue
        s = serving.ServingSession(lfi, warm_start=True, executor=ex,
                                   device="cpu")
        try:
            s.warmup(max_batch=MAX_BATCH, ks=(1,), queries=pool)
            reports[pipeline] = s.serve(
                trace, batcher=serving.MicroBatcher(max_batch=MAX_BATCH,
                                                    max_wait=0.004),
                service_time=_service, pipeline=pipeline)
        finally:
            ex.close()
    argv = ["--arch", "leafi", "--dist", "--backend", "gloo", "--device",
            "cpu", "--ckpt", ckpt, "--k", "1", "--requests", "32",
            "--batch", "8", "--rate", "800", "--targets", "0.9,0.99"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main_report = serve.main(argv)
    if rank:
        return
    single = serving.ServingSession(lfi, device="cpu")
    single.warmup(max_batch=MAX_BATCH, ks=(1,), queries=pool)
    rs = single.serve(trace, batcher=serving.MicroBatcher(
        max_batch=MAX_BATCH, max_wait=0.004), service_time=_service)
    with open(os.path.join(out, "serve_main.log"), "w") as fh:
        fh.write(buf.getvalue())

    def results(r):
        return {str(rid): c["result"] for rid, c in r["completions"].items()}
    payload = {
        "batches": [_strip(reports[p]["batches"]) for p in (0, 2)],
        "results": [results(reports[p]) for p in (0, 2)],
        "single": results(rs),
        "main_n_requests": main_report["n_requests"],
        "main_dist_n_requests": main_report["dist"]["n_requests"],
    }
    with open(os.path.join(out, "serve.json"), "w") as fh:
        json.dump(payload, fh)


def _rank(rank: int, world: int, job: str, out: str) -> None:
    from repro_torch.core import distributed
    torch.set_num_threads(2)
    distributed.init_process_group(
        "gloo", rank, world, "file://" + os.path.join(out, f"{job}_store"),
        timeout_s=TIMEOUT_S)
    try:
        (_search if job == "search" else _serve)(rank, out)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    job, out = sys.argv[1], sys.argv[2]
    world = 4 if job == "search" else 2
    mp.start_processes(_rank, args=(world, job, out), nprocs=world,
                       join=True, start_method="spawn")
