"""Serving session: a warmed, checkpointable facade over a built LeaFi index
(port of ``repro.serving.session``).

A :class:`ServingSession` owns the three things a long-lived serving process
needs beyond the engine itself:

* **cold start** — the built index (backbone arrays, stacked filter params,
  conformal tuner) round-trips through :mod:`repro_torch.checkpoint` as one
  atomic checkpoint (:func:`save_index` / :func:`load_index`), in the
  reference's layout, so a restart loads instead of re-running Alg. 1's
  build pipeline, and either package loads the other's checkpoints;
* **pre-warm** — :meth:`ServingSession.warmup` drives one dummy search per
  (bucket, k) shape through the session's engine strategy before traffic
  arrives (the first call of a shape on the card builds the kernels and
  grows the allocator's pool; the batcher's pow2 buckets keep that set
  small);
* **execution + accounting** — :meth:`ServingSession.execute` answers one
  :class:`~repro_torch.serving.batcher.MicroBatch` (per-query quality
  targets lowered to (B, F) conformal offset rows), and
  :meth:`ServingSession.serve` drives a whole open-loop trace through the
  micro-batcher, folding latency, pruning, survivor and recall counters
  into the session's :class:`~repro_torch.serving.telemetry.Telemetry`.

Execution is split into an async **dispatch** (enqueue the batch's engine
work on the card; :func:`repro_torch.core.search.search_batched_async`
returns a :class:`~repro_torch.core.search.PendingSearch`) and a blocking
**harvest** (synchronize, then copy the results to the host), so
:meth:`ServingSession.serve` can run *pipelined* (``pipeline=N``): batch
N+1's host-side formation and dispatch overlap batch N's device work.
Cross-batch **bsf warm-starting** (``warm_start=True``) seeds each batch
with prune-only upper bounds derived from recently answered queries
(:mod:`repro_torch.serving.warmstart`); the replay then runs its bound
instance.  :class:`DistributedExecutor` routes the same micro-batches
through the leaf-sharded search (``core/distributed.py``) with per-query
conformal offset rows.  Every entry point runs on the card unless the
caller passes ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .. import bridge, checkpoint
from ..core import build, conformal, search
from ..kernels.common import Device, resolve_device
from ..obs import span
from . import batcher as batcher_mod
from .batcher import MicroBatch, MicroBatcher, Request, _pow2_floor
from .telemetry import (Telemetry, latency_percentiles,
                        observe_recall_cell, recall_summary)
from .warmstart import BsfCache

# ---------------------------------------------------------------------------
# index persistence (cold start)
# ---------------------------------------------------------------------------

#: the config fields a checkpoint keeps, in the reference's order
_CONFIG_FIELDS = ("backbone", "leaf_capacity", "n_segments", "word_len",
                  "n_global", "n_local", "calib_fraction", "a",
                  "t_filter_over_t_series", "filter_memory_budget_bytes",
                  "hidden", "filter_type", "weight_dtype", "seed")

#: index arrays the port holds as int64 and the reference (and so its
#: checkpoints) as int32; ``save_index`` narrows them, ``load_index``
#: widens them again
_INT32_ON_DISK = ("order", "leaf_start", "leaf_size")


def save_index(path: str, lfi: build.LeaFiIndex,
               metadata: Optional[dict] = None) -> None:
    """Checkpoint a built LeaFi index (atomic; see checkpoint.save_pytree).

    Arrays (series, leaf layout, summarization payload, stacked filter
    params, tuner knots, calibration split) go into the tree with the
    reference's paths and dtypes; scalars and structure (kind, sizes,
    config without its training recipe, build report) ride in the
    metadata, so :func:`load_index` needs no template object.
    """
    idx = lfi.index
    tuner = lfi.tuner
    if lfi.filter_params is not None and \
            lfi.filter_params["w1"].dtype == torch.bfloat16:
        # as in the reference, whose np.savez drops the bfloat16 dtype
        raise ValueError(
            "bfloat16 filter weights cannot be checkpointed (np.savez "
            "loses the dtype); save the float32 index and requantize "
            "after load (build.requantize_leafi)")
    if idx.series.shape[0] >= 1 << 31:
        raise ValueError("a checkpoint holds int32 row offsets: at most "
                         f"2**31 - 1 rows, not {idx.series.shape[0]}")
    calib = lfi.calib
    tree = {
        "series": idx.series,
        **{name: getattr(idx, name).to(torch.int32)
           for name in _INT32_ON_DISK},
        "payload": dict(idx.payload),
        "filter_params": (dict(lfi.filter_params)
                          if lfi.filter_params is not None else {}),
        "leaf_ids": np.asarray(lfi.leaf_ids, np.int64),
        "tuner": ({"knots_q": tuner.knots_q, "knots_o": tuner.knots_o,
                   "slopes": tuner.slopes, "max_offset": tuner.max_offset}
                  if tuner is not None else {}),
        "calib": ({"queries": calib.queries, "d_lb": calib.d_lb,
                   "d_L": calib.d_L} if calib is not None else {}),
    }
    meta = {"kind": idx.kind, "max_leaf_size": int(idx.max_leaf_size),
            "n_series": int(idx.n_series), "length": int(idx.length),
            "config": {f: getattr(lfi.config, f) for f in _CONFIG_FIELDS},
            "build_report": {k: float(v)
                             for k, v in lfi.build_report.items()}}
    meta.update(metadata or {})
    checkpoint.save_pytree(path, tree, meta)


def load_index(path: str, device: Device = None) -> build.LeaFiIndex:
    """Rebuild a LeaFiIndex from a :func:`save_index` checkpoint (of either
    package) on ``device`` (``None`` means the card).

    The arrays round-trip verbatim (the int32 leaf layout widened to the
    port's int64), so search over the loaded index equals search over the
    saved one bitwise.
    """
    dev = resolve_device(device)
    flat, meta = checkpoint.load_pytree(path)

    def group(name: str):
        """One top-level entry: a leaf array, or a dict of its children."""
        pre = f"['{name}']"
        if pre in flat:
            return flat[pre]
        return {k[len(pre) + 1:][2:-2]: v
                for k, v in flat.items() if k.startswith(pre + "/")}

    params = group("filter_params") or None
    tuner = group("tuner") or None
    calib = group("calib") or None
    lfi = bridge.leafi_from_arrays(
        index={"kind": meta["kind"], "series": group("series"),
               "order": group("order"), "leaf_start": group("leaf_start"),
               "leaf_size": group("leaf_size"),
               "max_leaf_size": int(meta["max_leaf_size"]),
               "n_series": int(meta["n_series"]),
               "length": int(meta["length"]), "payload": group("payload")},
        filter_params=params, leaf_ids=group("leaf_ids"), tuner=tuner,
        calib=calib, device=dev)
    cfg_kw = {k: meta["config"][k] for k in _CONFIG_FIELDS
              if k in meta.get("config", {})}
    return dataclasses.replace(
        lfi, config=build.LeaFiConfig(**cfg_kw),
        build_report=dict(meta.get("build_report", {})))


# ---------------------------------------------------------------------------
# the session
# ---------------------------------------------------------------------------


def _pow2_buckets(max_batch: int) -> List[int]:
    """Every bucket a MicroBatcher capped at ``max_batch`` can emit."""
    return [1 << i for i in range(_pow2_floor(max_batch).bit_length())]


# ---------------------------------------------------------------------------
# distributed execution backend (the leaf-sharded search)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _DistResult:
    """SearchResult-shaped view of the distributed exchange's outputs.

    The exchange reduces one nearest distance and a summed searched-leaf
    count per query; per-leaf prune attribution and series ids stay
    shard-local, so those fields are absent here.
    """
    dists: np.ndarray            # (Q, 1)
    searched: np.ndarray         # (Q,)
    n_leaves: int
    computed: Optional[np.ndarray] = None
    ids: Optional[np.ndarray] = None
    audit: Optional[dict] = None


@dataclasses.dataclass
class _PendingDist:
    """A distributed batch whose answers are on the device until
    :meth:`result` copies them."""
    nn: torch.Tensor
    n_searched: torch.Tensor
    n_leaves: int

    def synchronize(self) -> "_PendingDist":
        if self.nn.device.type == "cuda":
            torch.cuda.synchronize(self.nn.device)
        return self

    def result(self) -> _DistResult:
        return _DistResult(dists=self.nn.cpu().numpy()[:, None],
                           searched=self.n_searched.cpu().numpy(),
                           n_leaves=self.n_leaves)


#: the leader's broadcast header: (op, rows); op 0 stops the followers
_STOP, _SEARCH = 0, 1


class DistributedExecutor:
    """Routes serving micro-batches through the leaf-sharded search.

    Every rank of ``mesh`` (one process each) builds one: it shards the
    index (:func:`repro_torch.core.distributed.shard_leafi`) and puts its
    own shard on its device (``make_distributed_search`` with
    ``per_query_offsets=True``): each query carries its own (L,) conformal
    offset row (mixed quality targets in one call) and a (Q,) prune-only
    ``bsf_ub`` warm bound.  k = 1 only: the exchange reduces one nearest
    distance per query.

    The reference drives every device from one process.  Here one process
    a rank would form batches by its own measured clock, so the ranks
    would disagree on the batches and their collectives deadlock: rank 0
    leads.  Its session dispatches, and :meth:`dispatch` broadcasts the
    batch (its row count, then the queries, the (B, L) offset rows and
    ``bsf_ub``) to the other ranks, which run :meth:`follow` and search
    the same batch until rank 0's :meth:`close`.  The mesh must cover the
    whole process group.  ``device=None`` means this rank's card.  The
    reference's ``donate`` has no eager counterpart and is not taken.
    """

    def __init__(self, lfi: build.LeaFiIndex, mesh, *,
                 strategy: str = "compact",
                 max_survivors: Optional[int] = None,
                 dist_impl: Optional[str] = None, device: Device = None):
        from ..core import distributed
        self.device = resolve_device(device)
        if mesh.size() != dist.get_world_size():
            raise ValueError(f"a mesh of {mesh.size()} ranks in a world of "
                             f"{dist.get_world_size()}")
        self.lfi = lfi
        self.n_leaves = lfi.index.n_leaves
        self.length = lfi.index.length
        self.sharded = distributed.shard_leafi(lfi, mesh.shape[1],
                                               device=self.device)
        self.run = distributed.make_distributed_search(
            mesh, self.sharded, strategy=strategy,
            max_survivors=max_survivors, dist_impl=dist_impl,
            per_query_offsets=True, device=self.device)
        self.leader = dist.get_rank() == 0

    def _offset_rows(self, targets, B: int) -> np.ndarray:
        """Per-query (B, L) conformal offset rows; +inf rows ⇒ exact search.

        ``d_F = pred − offset``, so a +inf offset drives every filter bound
        to −inf: the filters never fire and the search answers exactly.
        """
        L = self.n_leaves
        if targets is None:
            return np.full((B, L), np.inf, np.float32)
        if self.lfi.tuner is None:
            return np.zeros((B, L), np.float32)
        off = conformal.scatter_offsets(
            self.lfi.tuner, self.lfi.leaf_ids, L,
            np.asarray(targets, np.float64))
        return np.asarray(off, np.float32).reshape(B, L)

    def _broadcast(self, op: int, *arrays) -> list:
        """The header (op, rows), then each array, from rank 0; returns
        the arrays as this rank's tensors (received on the followers)."""
        dev = self.device
        head = torch.tensor([op, arrays[0].shape[0] if arrays else 0],
                            dtype=torch.int64, device=dev)
        dist.broadcast(head, src=0)
        out = []
        for a in arrays:
            t = torch.as_tensor(a, dtype=torch.float32, device=dev)
            dist.broadcast(t, src=0)
            out.append(t)
        return out

    def dispatch(self, queries: np.ndarray, targets, k: int,
                 bsf_ub: Optional[np.ndarray] = None) -> _PendingDist:
        """One batch, on rank 0: broadcast it, then search it with the
        followers."""
        if int(k) != 1:
            raise ValueError("DistributedExecutor serves k=1 only "
                             f"(got k={k})")
        if not self.leader:
            raise RuntimeError("only rank 0 dispatches; the other ranks "
                               "follow")
        q = np.asarray(queries, np.float32)
        ub = (np.full(q.shape[0], np.inf, np.float32) if bsf_ub is None
              else np.asarray(bsf_ub, np.float32))
        args = self._broadcast(_SEARCH, q, self._offset_rows(targets,
                                                             q.shape[0]), ub)
        nn, n_s = self.run(*args)
        return _PendingDist(nn=nn, n_searched=n_s, n_leaves=self.n_leaves)

    def follow(self) -> int:
        """On a rank other than 0: search every batch rank 0 broadcasts,
        until it closes; returns the number of batches."""
        dev, n = self.device, 0
        while True:
            head = torch.empty(2, dtype=torch.int64, device=dev)
            dist.broadcast(head, src=0)
            op, B = (int(x) for x in head.tolist())
            if op == _STOP:
                return n
            args = []
            for shape in ((B, self.length), (B, self.n_leaves), (B,)):
                t = torch.empty(shape, dtype=torch.float32, device=dev)
                dist.broadcast(t, src=0)
                args.append(t)
            self.run(*args)
            n += 1

    def close(self) -> None:
        """On rank 0: release the followers from :meth:`follow`."""
        self._broadcast(_STOP)


@dataclasses.dataclass
class PendingBatch:
    """One dispatched micro-batch awaiting harvest (FIFO, seq-ordered)."""
    pending: object               # search.PendingSearch | _PendingDist
    batch: MicroBatch
    seq: int
    # warm-start seed the batch was dispatched with (None when cold/off);
    # kept so the shadow sampler can attribute seed-bound exclusions
    bsf_ub: Optional[np.ndarray] = None


class ServingSession:
    """A query-serving runtime over one built LeaFi index.

    ``warm_start=True`` enables cross-batch bsf warm-starting: each
    dispatched batch is seeded with prune-only upper bounds from a rolling
    cache of recently answered queries (see
    :mod:`repro_torch.serving.warmstart` for the triangle-inequality bound
    and the exactness argument).  Harvested results are *staged* and only
    committed to the cache ``warm_lag`` batches later, which makes serial
    and pipelined serving (any ``pipeline <= warm_lag + 1``) observe
    identical cache states: the two give the same batch log and results.

    ``audit=True`` threads the engine's per-leaf
    :class:`~repro_torch.obs.audit.FilterAudit` through every served batch
    (results stay bitwise identical) and folds it into the telemetry's
    :class:`~repro_torch.obs.health.LeafHealthBoard`; ``shadow_rate > 0``
    attaches a :class:`~repro_torch.serving.shadow.ShadowSampler` that
    captures a deterministic fraction of requests at harvest for
    off-critical-path exact-scan auditing (``serve`` drains it once per
    trace).  ``device=None`` means the card; the index must live on the
    session's device.

    ``executor`` swaps the single-host engine for a
    :class:`DistributedExecutor` (k = 1; on rank 0): batches flow through
    the leaf-sharded search with per-query conformal offset rows.  Audit
    is then off: the exchange reduces one distance, so there is nothing
    leaf-wise to fold on the host.
    """

    def __init__(self, lfi: build.LeaFiIndex, *, strategy: str = "compact",
                 dist_impl: Optional[str] = None,
                 telemetry: Optional[Telemetry] = None,
                 warm_start: bool = False, warm_lag: int = 1,
                 warm_capacity: int = 256, audit: bool = False,
                 shadow_rate: float = 0.0, shadow_seed: int = 0,
                 executor: Optional[DistributedExecutor] = None,
                 device: Device = None):
        self.device = resolve_device(device)
        self.lfi = lfi
        self.strategy = strategy
        self.dist_impl = dist_impl
        self.telemetry = telemetry if telemetry is not None else Telemetry()
        self.warm_start = bool(warm_start)
        self.warm_lag = int(warm_lag)
        self.warm_cache = BsfCache(capacity=warm_capacity)
        self.executor = executor
        self.audit = bool(audit) and executor is None
        self.shadow = None
        if shadow_rate > 0.0:
            from .shadow import ShadowSampler
            self.shadow = ShadowSampler(self, rate=shadow_rate,
                                        seed=shadow_seed)
        self._seq = 0
        self._warmed: set = set()

    # -- cold start ---------------------------------------------------------

    @classmethod
    def from_checkpoint(cls, path: str, device: Device = None,
                        **kw) -> "ServingSession":
        return cls(load_index(path, device=device), device=device, **kw)

    def save(self, path: str, metadata: Optional[dict] = None) -> None:
        save_index(path, self.lfi, metadata)

    # -- pre-warm -----------------------------------------------------------

    def warmup(self, *, max_batch: int = 64, ks: Sequence[int] = (1,),
               buckets: Optional[Sequence[int]] = None,
               queries: Optional[np.ndarray] = None,
               targets: Sequence[float] = (0.9, 0.99)) -> int:
        """Run one search per (bucket, k) shape before traffic arrives.

        ``queries`` should be representative of live traffic when possible
        (how well they prune sets the survivor shapes the candidate pass
        sees).  Returns the number of (bucket, k) shapes warmed.
        """
        buckets = list(buckets) if buckets is not None \
            else _pow2_buckets(max_batch)
        if queries is None:
            queries = self.lfi.index.series[:max(buckets)].cpu().numpy()
        n = 0
        for k in ks:
            for b in buckets:
                if (b, k) in self._warmed:
                    continue
                q = np.asarray(queries)[np.arange(b) % len(queries)]
                t = np.asarray(targets, np.float64)[np.arange(b)
                                                    % len(targets)]
                self._search_async(q, t, k).result()
                self._warmed.add((b, k))
                n += 1
        return n

    # -- execution ----------------------------------------------------------

    def _search_async(self, queries: np.ndarray, targets, k: int,
                      bsf_ub: Optional[np.ndarray] = None):
        """Dispatch one batch (``.result()`` blocks): through the
        distributed executor where one is attached, else the engine with
        per-query targets lowered to (B, F) offset rows."""
        if self.executor is not None:
            return self.executor.dispatch(queries, targets, k, bsf_ub)
        lfi = self.lfi
        return search.search_batched_async(
            lfi.index, queries, k=k, filter_params=lfi.filter_params,
            leaf_ids=lfi.leaf_ids, tuner=lfi.tuner,
            quality_target=targets, use_filters=targets is not None,
            strategy=self.strategy, dist_impl=self.dist_impl,
            filter_type=lfi.config.filter_type, bsf_ub=bsf_ub,
            audit=self.audit, device=self.device)

    def search(self, queries: np.ndarray,
               quality_targets=None, k: int = 1,
               record: bool = True, **kw) -> search.SearchResult:
        """One batched search; per-query targets lowered to offset rows."""
        lfi = self.lfi
        kw.setdefault("filter_type", lfi.config.filter_type)
        res = search.search_batched(
            lfi.index, queries, k=k, filter_params=lfi.filter_params,
            leaf_ids=lfi.leaf_ids, tuner=lfi.tuner,
            quality_target=quality_targets,
            use_filters=quality_targets is not None,
            strategy=self.strategy, dist_impl=self.dist_impl,
            device=self.device, **kw)
        if record:
            Q = np.atleast_2d(queries).shape[0]
            self.telemetry.record_batch(res, n_valid=Q, bucket=Q)
        return res

    def search_exact(self, queries: np.ndarray,
                     k: int = 1) -> search.SearchResult:
        return self.search(queries, quality_targets=None, k=k, record=False)

    def dispatch(self, batch: MicroBatch) -> PendingBatch:
        """Submit one micro-batch asynchronously (returns once enqueued).

        Order of operations matters for determinism: the warm cache first
        *commits* staged results from batches ``<= seq − 1 − warm_lag``
        (identical in serial and pipelined serving — see the class
        docstring), then seeds this batch's prune-only bounds.  Host-side
        cost (offset lowering + enqueue) is recorded as the ``form``
        latency phase; per-request queue waits (arrival → batch formation,
        virtual clock) ride along.
        """
        t0 = time.perf_counter()
        seq = self._seq
        self._seq += 1
        with span("serve.dispatch", cat="serve", seq=seq,
                  bucket=batch.bucket, n_valid=batch.n_valid, k=batch.k):
            bsf_ub = None
            if self.warm_start:
                self.warm_cache.commit_through(seq - 1 - self.warm_lag)
                bsf_ub = self.warm_cache.seed(batch.queries, batch.k)
            pending = self._search_async(batch.queries, batch.targets,
                                         batch.k, bsf_ub=bsf_ub)
        self.telemetry.record_phases(
            queue_wait=(batch.formed_at - batch.arrivals).tolist(),
            form_s=time.perf_counter() - t0)
        return PendingBatch(pending=pending, batch=batch, seq=seq,
                            bsf_ub=bsf_ub)

    def harvest(self, pb: PendingBatch):
        """Wait for one dispatched batch; fold telemetry + warm staging.

        The ``serve.harvest`` span encloses the wait on the card and the
        copy of the results to the host.
        """
        t0 = time.perf_counter()
        with span("serve.harvest", cat="serve", seq=pb.seq,
                  bucket=pb.batch.bucket, n_valid=pb.batch.n_valid):
            res = pb.pending.synchronize().result()
        self.telemetry.record_phases(exec_s=time.perf_counter() - t0)
        b = pb.batch
        if self.warm_start:
            kth = np.asarray(res.dists)[:b.n_valid, -1]
            self.warm_cache.stage(pb.seq, b.queries[:b.n_valid], kth, b.k)
        self.telemetry.record_batch(res, n_valid=b.n_valid, bucket=b.bucket)
        if res.audit is not None:
            # audit planes cover every bucket slot (padded rows repeat row
            # 0 — real queries for the accounting identity's purposes)
            self.telemetry.record_audit(res.audit, n_queries=b.bucket)
        if self.shadow is not None:
            self.shadow.capture(b, res, bsf_ub=pb.bsf_ub)
        return res

    def execute(self, batch: MicroBatch) -> search.SearchResult:
        """Answer one micro-batch synchronously (dispatch + harvest)."""
        return self.harvest(self.dispatch(batch))

    # -- open-loop serving --------------------------------------------------

    def serve(self, trace: Sequence[Request], *,
              batcher: Optional[MicroBatcher] = None,
              recall_oracle: Optional[Dict[int, float]] = None,
              service_time: Optional[Callable[[MicroBatch], float]] = None,
              pipeline: int = 0) -> dict:
        """Drive a whole arrival trace; returns a *per-trace* report.

        Every number in the report describes this trace alone — the
        session's :attr:`telemetry` keeps the rolling lifetime view across
        traces (and is also fed by this run).  Completions store a
        per-request projection (top-1 distance + searched count), not the
        batch results, so memory stays O(1) per request on long traces.

        ``recall_oracle`` maps rid → exact 1-NN distance; when given, each
        completion is scored against it (the paper's recall@1 rule) and
        folded into the per-target-group recall estimators.
        ``service_time`` replaces measured wall-clock with injected
        per-batch costs (fully deterministic runs).

        ``pipeline=N`` (N ≥ 1) serves through
        :func:`~repro_torch.serving.batcher.run_trace_pipelined` with up to
        N batches in flight — dispatch of batch N+1 overlaps device work of
        batch N.  Requires an injected ``service_time`` (the virtual clock
        cannot be measured while execution overlaps); the batch sequence,
        completion times, and results are identical to the serial loop on
        the same trace.
        """
        batcher = batcher or MicroBatcher()

        def extract(res: search.SearchResult, pos: int) -> dict:
            return {"dist": float(np.asarray(res.dists)[pos, 0]),
                    "searched": float(np.asarray(res.searched)[pos]),
                    "n_leaves": res.n_leaves}

        if pipeline:
            completions, batch_log = batcher_mod.run_trace_pipelined(
                trace, batcher, self.dispatch, self.harvest,
                service_time=service_time, extract=extract,
                max_in_flight=pipeline)
        else:
            completions, batch_log = batcher_mod.run_trace(
                trace, batcher, self.execute, service_time=service_time,
                extract=extract)
        lats: List[float] = []
        searched: List[float] = []
        for c in completions.values():
            self.telemetry.record_latency(c["latency"])
            lats.append(c["latency"])
            searched.append(c["result"]["searched"])
        # score recall with the calibration-time rule (one shared
        # definition: conformal.recall_at_1), vectorized over the trace
        recall: Dict[float, list] = {}
        scored = ([] if recall_oracle is None else
                  [(rid, c) for rid, c in completions.items()
                   if rid in recall_oracle])
        if scored:
            hits = conformal.recall_at_1(
                torch.tensor([c["result"]["dist"] for _, c in scored],
                             dtype=torch.float32),
                torch.tensor([recall_oracle[rid] for rid, _ in scored],
                             dtype=torch.float32)).numpy() > 0
            for (rid, c), hit in zip(scored, hits):
                self.telemetry.observe_recall(c["target"], bool(hit))
                observe_recall_cell(recall, c["target"], bool(hit))
        n_valid = sum(b["n_valid"] for b in batch_log)
        n_slots = sum(b["bucket"] for b in batch_log)
        n_leaves = (next(iter(completions.values()))["result"]["n_leaves"]
                    if completions else 0)
        report = {
            "n_requests": len(completions),
            "n_batches": len(batch_log),
            "padding_fraction": (n_slots - n_valid) / max(n_slots, 1),
            "pruning_ratio": (1.0 - float(np.mean(searched)) / n_leaves
                              if searched and n_leaves else float("nan")),
            "recall_by_target": recall_summary(recall),
        }
        report.update(latency_percentiles(lats))
        if completions:
            first = min(r.arrival for r in trace)
            last = max(c["finish"] for c in completions.values())
            report["throughput_qps"] = len(completions) / max(last - first,
                                                              1e-12)
            report["makespan_s"] = last - first
        report["n_programs_warmed"] = len(self._warmed)
        if self.shadow is not None and self.shadow.pending_count:
            # off the critical path by construction: every completion above
            # is already timed/committed before the exact scans run
            shadow_report = self.shadow.drain()
            self.telemetry.record_shadow(shadow_report)
            report["shadow"] = shadow_report
        report["batches"] = batch_log
        report["completions"] = completions
        return report
