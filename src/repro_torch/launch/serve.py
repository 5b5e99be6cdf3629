"""LeaFi retrieval serving on the port (port of ``repro.launch.serve
--arch leafi``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch leafi \
        --batch 32 --requests 256 --rate 200 --targets 0.9,0.95,0.99 \
        --ckpt /path/to/leafi_ckpt [--device cpu]

A thin front end over :mod:`repro_torch.serving`: it cold-starts a
:class:`~repro_torch.serving.session.ServingSession` from a checkpoint
(written by either package), or builds a smoke-sized index and checkpoints
it when ``--ckpt`` names no committed checkpoint, warms the per-(bucket, k)
shapes, and drives a seeded Poisson open-loop trace of heterogeneous
requests (mixed per-query quality targets) through the dynamic
micro-batcher, reporting p50/p95/p99 latency, throughput, pruning and
per-target-group achieved recall.  It runs on the card unless
``--device cpu`` is given.

Filter-health observability: ``--shadow-rate R`` re-executes a
deterministic fraction R of requests through the exact search off the
critical path (true recall + per-miss leaf/bound attribution);
``--health-dump PATH`` writes the windowed per-leaf scoreboard JSON;
``--metrics-dump PATH`` the serving registry (Prometheus text when PATH
ends in ``.prom``); ``--trace-dump PATH`` a Chrome trace of the run's
spans and batches; ``--explain RID`` prints one request's
bound-attribution report.

The leaf-sharded search, one process a rank::

    PYTHONPATH=src torchrun --nproc-per-node=N -m repro_torch.launch.serve \
        --arch leafi --dist --backend nccl --ckpt DIR --k 1

Rank r shards onto ``cuda:(r % device_count)``: one card a rank under
``nccl``; several ranks on one card need ``--backend gloo`` (NCCL refuses
two ranks on one device, and the backend is never switched for the
caller).  Rank 0 serves as above, then re-serves the same trace through a
:class:`~repro_torch.serving.session.DistributedExecutor` on a 1 × N mesh
(with ``--k 1``) and compares the two shard strategies on one batch; the
other ranks load the index from ``--ckpt`` (which N > 1 needs) and follow.
Only rank 0 prints.  Without ``torchrun`` (no ``RANK`` in the
environment) ``--dist`` runs a world of one rank.

Not here yet: the token-model archs (the LM substrate, ROADMAP A10); they
exit with a message.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


def _print_serve_report(report: dict, label: str = "") -> None:
    tag = f" [{label}]" if label else ""
    if report["n_requests"] == 0:
        # zero completions (e.g. an empty trace): throughput/makespan are
        # absent and every windowed stat is NaN — report that, don't crash
        print(f"served{tag} 0 requests in {report['n_batches']} batches "
              f"(no completions)")
        return
    print(f"served{tag} {report['n_requests']} requests in "
          f"{report['n_batches']} batches "
          f"(padding {report['padding_fraction']:.1%}): "
          f"{report['throughput_qps']:.1f} qps, latency "
          f"p50 {report['p50']*1e3:.1f}ms / p95 {report['p95']*1e3:.1f}ms "
          f"/ p99 {report['p99']*1e3:.1f}ms, pruning "
          f"{report['pruning_ratio']:.3f}")
    for t, rec in report["recall_by_target"].items():
        print(f"  target {t:.3f}: achieved recall {rec['recall']:.3f} "
              f"(n={rec['n']})")


def serve_leafi(args, mesh=None) -> dict:
    """Open-loop micro-batched serving over the LeaFi engine; returns the
    serve report.  With ``mesh`` (``--dist``, on rank 0) the other ranks
    wait for the checkpoint, and the trace is then served again through
    the leaf-sharded search (:func:`serve_leafi_dist_trace`, under the
    report's ``"dist"``)."""
    from ..core import build, filter_training
    from ..core.summaries import znormalize
    from ..kernels.common import resolve_device
    from ..obs import SpanRecorder, export as obs_export, set_recorder
    from ..serving import MicroBatcher, ServingSession, poisson_trace

    device = resolve_device(args.device)
    recorder = None
    if args.trace_dump:
        # isolated capture: build + serve spans land here, not in the
        # process default recorder
        recorder = SpanRecorder()
        set_recorder(recorder)

    targets = tuple(float(t) for t in args.targets.split(","))
    # per-leaf health needs the engine's audit stream; shadow/health/explain
    # all imply it (results stay bitwise identical with it on)
    audit = bool(args.shadow_rate > 0 or args.health_dump
                 or args.explain is not None)
    session_kw = dict(strategy=args.strategy, warm_start=args.warm_start,
                      audit=audit, shadow_rate=args.shadow_rate,
                      shadow_seed=args.seed, device=device)
    if args.ckpt and os.path.exists(os.path.join(args.ckpt, "DONE")):
        t0 = time.perf_counter()
        session = ServingSession.from_checkpoint(args.ckpt, **session_kw)
        print(f"cold start from {args.ckpt}: "
              f"{time.perf_counter() - t0:.2f}s "
              f"({session.lfi.index.n_series} series, "
              f"{len(session.lfi.leaf_ids)} filters)")
    else:
        rng = np.random.default_rng(args.seed)
        n, m = 20_000, 128
        S = rng.standard_normal((n, m), dtype=np.float32).cumsum(axis=1)
        print(f"building LeaFi index over {n}x{m} series...")
        lfi = build.build_leafi(S, build.LeaFiConfig(
            backbone="dstree", leaf_capacity=256, n_global=200, n_local=60,
            t_filter_over_t_series=20.0,
            train=filter_training.TrainConfig(epochs=40)), device=device)
        session = ServingSession(lfi, **session_kw)
        if args.ckpt:
            session.save(args.ckpt)
            print(f"checkpointed index to {args.ckpt} "
                  f"(next start is a cold start)")
    if mesh is not None:
        dist.barrier()                 # the other ranks may load it now

    idx = session.lfi.index
    rng = np.random.default_rng(args.seed + 1)
    rows = torch.as_tensor(rng.integers(0, idx.n_series, 256),
                           device=idx.device)
    noise = rng.standard_normal((256, idx.length)).astype(np.float32)
    pool = znormalize(idx.series[rows].cpu()
                      + 0.3 * torch.from_numpy(noise)).numpy()

    n_warm = session.warmup(max_batch=args.batch, ks=(args.k,),
                            queries=pool, targets=targets)
    print(f"warmed {n_warm} (bucket, k) shapes [strategy={args.strategy}]")

    trace = poisson_trace(pool, rate=args.rate, n_requests=args.requests,
                          targets=targets, ks=(args.k,), seed=args.seed)
    exact = session.search_exact(np.stack([r.query for r in trace]))
    oracle = {r.rid: float(exact.dists[i, 0])
              for i, r in enumerate(trace)}

    service_time = None
    if args.pipeline:
        # pipelined serving needs an injected virtual clock (the host can't
        # time overlapped execution): model per-batch cost from one timed
        # warm full-bucket search, scaled by bucket fill.
        q = pool[np.arange(args.batch) % len(pool)]
        t = np.asarray(targets)[np.arange(args.batch) % len(targets)]
        t0 = time.perf_counter()
        session._search_async(q, t, args.k).result()
        model_s = time.perf_counter() - t0
        service_time = lambda b: model_s * max(b.bucket / args.batch, 0.25)  # noqa: E731
        print(f"pipeline depth {args.pipeline}: service model "
              f"{model_s*1e3:.1f}ms/full batch")

    report = session.serve(
        trace, batcher=MicroBatcher(max_batch=args.batch,
                                    max_wait=args.max_wait_ms / 1e3),
        recall_oracle=oracle, service_time=service_time,
        pipeline=args.pipeline)
    _print_serve_report(report)

    if "shadow" in report:
        sh = report["shadow"]
        print(f"shadow audit: {sh['n_shadowed']} queries re-executed "
              f"exactly (rate {args.shadow_rate:g}), true recall "
              f"{sh['recall_mean']:.3f}, {len(sh['misses'])} lost true "
              f"neighbor(s)")
        for m in sh["misses"][:5]:
            print(f"  rid {m['rid']}: neighbor #{m['id']} at "
                  f"{m['dist']:.4f} lost to leaf {m['leaf']} "
                  f"({m['bound']} bound)")
    flagged = session.telemetry.filters_needing_attention()
    if audit and flagged:
        print(f"filters needing attention ({len(flagged)} leaves):")
        for r in flagged[:5]:
            print(f"  leaf {r.leaf}: {','.join(r.reasons)} "
                  f"(violation rate {r.violation_rate:.3f}, worst "
                  f"residual {r.resid_min:.3f}, shadow misses "
                  f"{r.shadow_misses})")

    if args.health_dump:
        with open(args.health_dump, "w") as fh:
            json.dump(session.telemetry.health.snapshot(), fh, indent=2,
                      default=float)
        print(f"health scoreboard dumped to {args.health_dump}")

    if args.explain is not None:
        from ..obs import explain as obs_explain
        from ..serving import explain_query
        match = [r for r in trace if r.rid == args.explain] or [trace[0]]
        r = match[0]
        ctx = explain_query(session, r.query, target=r.quality_target,
                            k=r.k, rid=r.rid)
        print(obs_explain.render_text(ctx))

    if mesh is not None:
        if args.k == 1:
            report["dist"] = serve_leafi_dist_trace(session.lfi, trace, args,
                                                    oracle, mesh)
        else:
            print("(--dist trace serving needs --k 1; the distributed "
                  "exchange reduces a single nn distance)")
        serve_leafi_distributed(session.lfi, mesh, args,
                                pool[:args.batch], session.telemetry)

    if args.summary:
        print("telemetry summary:")
        print(json.dumps(session.telemetry.summary(), indent=2,
                         default=float))

    if args.metrics_dump:
        obs_export.write_metrics(args.metrics_dump,
                                 session.telemetry.registry)
        fmt = ("prometheus" if args.metrics_dump.endswith(".prom")
               else "jsonl")
        print(f"metrics dumped to {args.metrics_dump} ({fmt})")
    if args.trace_dump:
        set_recorder(None)
        obs_export.write_chrome_trace(args.trace_dump,
                                      spans=recorder.drain(),
                                      batch_log=report["batches"])
        print(f"chrome trace dumped to {args.trace_dump} "
              f"(open in https://ui.perfetto.dev)")
    return report


def serve_leafi_dist_trace(lfi, trace, args, oracle, mesh) -> dict:
    """On rank 0: serve the same open-loop trace through a
    :class:`~repro_torch.serving.session.DistributedExecutor` over
    ``mesh`` (per-query conformal offset rows through the sharded search;
    pipelined when ``--pipeline``), the other ranks following; returns
    the report."""
    from ..serving import DistributedExecutor, MicroBatcher, ServingSession
    executor = DistributedExecutor(lfi, mesh, strategy=args.strategy,
                                   device=args.device)
    session = ServingSession(lfi, strategy=args.strategy,
                             warm_start=args.warm_start, executor=executor,
                             device=executor.device)
    targets = tuple(float(t) for t in args.targets.split(","))
    try:
        session.warmup(max_batch=args.batch, ks=(1,), targets=targets)
        service_time = None
        if args.pipeline:
            q = lfi.index.series[:args.batch].cpu().numpy()
            t = np.asarray(targets)[np.arange(args.batch) % len(targets)]
            t0 = time.perf_counter()
            session._search_async(q, t, 1).synchronize().result()
            model_s = time.perf_counter() - t0
            service_time = lambda b: model_s * max(b.bucket / args.batch, 0.25)  # noqa: E731
        report = session.serve(
            trace, batcher=MicroBatcher(max_batch=args.batch,
                                        max_wait=args.max_wait_ms / 1e3),
            recall_oracle=oracle, service_time=service_time,
            pipeline=args.pipeline)
    finally:
        executor.close()
    _print_serve_report(report, label=f"dist x{mesh.size()}")
    return report


def serve_leafi_distributed(lfi, mesh, args, q: Optional[np.ndarray] = None,
                            telemetry=None) -> None:
    """On every rank: one batch of 1-NN queries (rank 0's ``q``,
    broadcast) through the sharded search with each shard strategy, the
    masked scan and the survivor compaction, timed (rank 0 prints).  The
    compaction's capacity is rank 0's telemetry's suggestion where it has
    observed survivors (counted on the unsharded leaves, so generous),
    else the static default."""
    from ..core import distributed, engine
    from ..kernels.common import resolve_device
    dev = resolve_device(args.device)
    sharded = distributed.shard_leafi(lfi, mesh.shape[1], device=dev)
    P = sharded.leaf_size.shape[1]
    lead = dist.get_rank() == 0
    head = torch.zeros(2, dtype=torch.int64, device=dev)
    if lead:
        head[0] = q.shape[0]
        if telemetry is not None and telemetry.survivors:
            head[1] = telemetry.suggest_max_survivors(P)
    dist.broadcast(head, src=0)
    B, tuned = (int(x) for x in head.tolist())
    qt = (torch.as_tensor(q, dtype=torch.float32, device=dev) if lead
          else torch.empty((B, lfi.index.length), device=dev))
    dist.broadcast(qt, src=0)
    if lead:
        print(f"distributed serve: {mesh.size()} shard(s), {P} leaf "
              "slots/shard" + (
                  f", max_survivors {tuned} (telemetry-tuned; static "
                  f"default {engine.default_max_survivors(P)})" if tuned
                  else ""))
    for strategy in ("scan", "compact"):
        run = distributed.make_distributed_search(
            mesh, sharded, strategy=strategy,
            max_survivors=tuned if strategy == "compact" and tuned else None,
            device=dev)
        run(qt)                                    # warm
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        nn, total = run(qt)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        if lead:
            print(f"serve[dist/{strategy:7s}] {B} queries 1-NN: "
                  f"{dt*1e3:.1f}ms  total searched "
                  f"{total.float().mean().item():.1f} leaves/query")


def _follow_dist(args, mesh) -> None:
    """A rank other than 0 under ``--dist``: once rank 0 has its index
    checkpointed, load it on the host, follow its distributed trace, then
    the strategy comparison."""
    from ..serving import DistributedExecutor
    from ..serving.session import load_index
    dist.barrier()
    lfi = load_index(args.ckpt, device="cpu")
    if args.k == 1:
        DistributedExecutor(lfi, mesh, strategy=args.strategy,
                            device=args.device).follow()
    serve_leafi_distributed(lfi, mesh, args)


def serve_dist(args) -> Optional[dict]:
    """``--dist``: join the running process group, or start one (from
    ``torchrun``'s environment, else a world of one rank through a
    ``file://`` store in a temporary directory), make a 1 × N mesh over its
    ranks and serve (rank 0) or follow (the rest); returns rank 0's
    report.  A group it started it also destroys."""
    from ..core import distributed
    from ..launch.mesh import make_host_mesh
    started = not dist.is_initialized()
    with tempfile.TemporaryDirectory() as tmp:
        if started:
            if "RANK" in os.environ:
                rank = int(os.environ["RANK"])
                world = int(os.environ["WORLD_SIZE"])
                init = "env://"
            else:
                rank, world, init = 0, 1, "file://" + os.path.join(tmp,
                                                                   "store")
            if args.device != "cpu":
                local = int(os.environ.get("LOCAL_RANK", rank))
                torch.cuda.set_device(local % max(torch.cuda.device_count(),
                                                  1))
            distributed.init_process_group(args.backend, rank, world, init)
        try:
            if dist.get_world_size() > 1 and not args.ckpt:
                raise SystemExit("--dist over several ranks needs --ckpt: "
                                 "the other ranks load rank 0's index from "
                                 "it")
            mesh = make_host_mesh(model=dist.get_world_size(),
                                  device=args.device)
            if dist.get_rank() == 0:
                return serve_leafi(args, mesh=mesh)
            _follow_dist(args, mesh)
            return None
        finally:
            if started:
                dist.destroy_process_group()


def main(argv: Optional[Sequence[str]] = None) -> Optional[dict]:
    """The reference's flags and defaults for ``--arch leafi`` (its
    token-model flags ``--smoke``, ``--prompt-len`` and ``--gen`` wait with
    those archs), plus ``--device``; returns the serve report."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="codeqwen1.5-7b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--strategy", default="compact",
                    choices=("scan", "compact"),
                    help="engine execution plan for --arch leafi")
    ap.add_argument("--k", type=int, default=5,
                    help="neighbours per request (--arch leafi)")
    ap.add_argument("--requests", type=int, default=128,
                    help="open-loop trace length (--arch leafi)")
    ap.add_argument("--rate", type=float, default=200.0,
                    help="Poisson arrival rate, req/s (--arch leafi)")
    ap.add_argument("--targets", default="0.9,0.95,0.99",
                    help="comma-separated per-request quality targets")
    ap.add_argument("--max-wait-ms", type=float, default=20.0,
                    help="micro-batcher deadline-flush wait")
    ap.add_argument("--ckpt", default=None,
                    help="index checkpoint dir: loads if present, "
                         "else builds and saves (--arch leafi)")
    ap.add_argument("--dist", action="store_true",
                    help="also serve through the leaf-sharded search, one "
                         "rank a process (launch with torchrun "
                         "--nproc-per-node=N; with --k 1 the full trace is "
                         "re-served through the distributed executor)")
    ap.add_argument("--backend", default="nccl", choices=("nccl", "gloo"),
                    help="--dist's torch.distributed backend: nccl for one "
                         "card a rank, gloo for the CPU or for several "
                         "ranks on one card")
    ap.add_argument("--pipeline", type=int, default=0,
                    help="pipelined serving depth (batches in flight; "
                         "0 = serial; --arch leafi)")
    ap.add_argument("--warm-start", action="store_true",
                    help="cross-batch bsf warm-starting (--arch leafi)")
    ap.add_argument("--summary", action="store_true",
                    help="print the session telemetry summary (rolling "
                         "percentiles incl. queue-wait/form/execute phases)")
    ap.add_argument("--metrics-dump", default=None, metavar="PATH",
                    help="dump the serving metrics registry on exit: "
                         "JSON-lines, or Prometheus text exposition when "
                         "PATH ends in .prom (--arch leafi)")
    ap.add_argument("--shadow-rate", type=float, default=0.0,
                    help="fraction of requests re-executed exactly off the "
                         "critical path for true-recall auditing "
                         "(deterministic per-rid sampling; --arch leafi)")
    ap.add_argument("--health-dump", default=None, metavar="PATH",
                    help="dump the per-leaf filter-health scoreboard "
                         "(windowed audit + shadow evidence) as JSON on "
                         "exit (--arch leafi; implies audited serving)")
    ap.add_argument("--explain", type=int, default=None, metavar="RID",
                    help="print a per-query explain report (bound "
                         "attribution, residuals, shadow-truth misses) for "
                         "one request id of the trace (--arch leafi)")
    ap.add_argument("--trace-dump", default=None, metavar="PATH",
                    help="dump a Chrome trace-event JSON of the serve run "
                         "(batch dispatch/in-flight/harvest lanes + host "
                         "spans; open in Perfetto) (--arch leafi)")
    ap.add_argument("--device", default="cuda",
                    help="where the index and the search live: cuda (the "
                         "default) or cpu")
    args = ap.parse_args(argv)

    if args.arch != "leafi":
        raise SystemExit(
            f"--arch {args.arch}: the port serves --arch leafi only; the "
            "token-model archs wait for the LM substrate (ROADMAP A10)")
    if args.dist:
        return serve_dist(args)
    return serve_leafi(args)


if __name__ == "__main__":
    main()
