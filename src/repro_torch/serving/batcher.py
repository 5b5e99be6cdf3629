"""Dynamic micro-batching for the LeaFi serving runtime (port of
``repro.serving.batcher``; host code).

Heterogeneous requests (mixed ``k``, mixed per-query ``quality_target``,
open-loop arrivals) drain from an admission queue into shape-bucketed padded
batches:

* requests group by ``k`` first — ``k`` sets the width of every top-k
  the engine keeps, so each k-group owns its own FIFO queue; quality
  targets ride along as *data* (a (B,) array lowered to per-query
  conformal offset rows), never as shape.
* batch sizes pad up to power-of-two buckets capped at ``max_batch``, so
  the engine sees a handful of batch shapes per k (the card's allocator
  keeps their blocks) instead of one per observed batch size.
* flush policy: a k-group flushes when ``max_batch`` requests are pending
  (size flush — emits full buckets) or when its oldest pending request has
  waited ``max_wait`` (deadline flush — emits one partial batch padded to
  the next bucket).  Latency SLOs pick ``max_wait``; throughput picks
  ``max_batch``.

The batcher is pure and clockless: :meth:`MicroBatcher.poll` takes ``now``
explicitly and has no hidden state beyond the queues, so a seeded arrival
trace replays to the identical batch sequence.  :func:`run_trace` is the
matching discrete-event open-loop loop: arrival times are fixed up front
(load does not adapt to service times — the open-loop harness of serving
benchmarks), virtual time advances by measured (or injected) per-batch
service times, and per-request latency is completion − arrival.
:func:`poisson_trace` draws from numpy exactly as the reference does, so
one seed gives one trace in both packages.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..kernels.common import next_pow2

_EPS = 1e-12


def _pow2_floor(n: int) -> int:
    return 1 << (max(int(n), 1).bit_length() - 1)


@dataclasses.dataclass
class Request:
    """One k-NN query admission."""
    rid: int
    query: np.ndarray                 # (m,)
    k: int = 1
    quality_target: float = 0.99
    arrival: float = 0.0              # seconds on the trace's virtual clock
    pool_row: Optional[int] = None    # provenance when drawn from a pool


@dataclasses.dataclass
class MicroBatch:
    """A padded, shape-bucketed batch ready for one engine call."""
    queries: np.ndarray               # (B, m) — rows ≥ n_valid repeat row 0
    targets: np.ndarray               # (B,) per-query quality targets
    k: int
    rids: List[int]                   # (n_valid,) request ids, FIFO order
    arrivals: np.ndarray              # (n_valid,)
    n_valid: int
    formed_at: float

    @property
    def bucket(self) -> int:
        return self.queries.shape[0]


class MicroBatcher:
    """Admission queue + pow2-bucket flush policy (pure, deterministic).

    A non-pow2 ``max_batch`` rounds *down* to a power of two, so emitted
    buckets never exceed the caller's cap and warmup
    (:meth:`~repro_torch.serving.session.ServingSession.warmup`, which
    floors the same way) always covers every bucket this batcher can form.
    """

    def __init__(self, max_batch: int = 64, max_wait: float = 0.02):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.max_batch = _pow2_floor(max_batch)
        self.max_wait = float(max_wait)
        self._queues: Dict[int, deque] = {}

    @property
    def pending(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def submit(self, req: Request) -> None:
        self._queues.setdefault(req.k, deque()).append(req)

    def next_deadline(self) -> float:
        """Earliest instant a deadline flush becomes due (+inf if idle)."""
        heads = [q[0].arrival for q in self._queues.values() if q]
        return min(heads) + self.max_wait if heads else float("inf")

    def _form(self, reqs: Sequence[Request], now: float) -> MicroBatch:
        n = len(reqs)
        B = min(next_pow2(n), self.max_batch)
        queries = np.stack([r.query for r in reqs])
        if B > n:                      # pad with row 0; results are dropped
            queries = np.concatenate(
                [queries, np.broadcast_to(queries[0], (B - n,) +
                                          queries.shape[1:])])
        targets = np.full(B, reqs[0].quality_target, np.float64)
        targets[:n] = [r.quality_target for r in reqs]
        return MicroBatch(queries=queries, targets=targets, k=reqs[0].k,
                          rids=[r.rid for r in reqs],
                          arrivals=np.array([r.arrival for r in reqs]),
                          n_valid=n, formed_at=now)

    def poll(self, now: float) -> List[MicroBatch]:
        """Flush everything due at ``now``; FIFO within each k-group."""
        out: List[MicroBatch] = []
        for k in sorted(self._queues):
            q = self._queues[k]
            while len(q) >= self.max_batch:                  # size flush
                out.append(self._form([q.popleft()
                                       for _ in range(self.max_batch)], now))
            if q and now - q[0].arrival >= self.max_wait - _EPS:
                out.append(self._form([q.popleft()           # deadline flush
                                       for _ in range(len(q))], now))
        return out


# ---------------------------------------------------------------------------
# traffic generation + open-loop discrete-event drive
# ---------------------------------------------------------------------------


def poisson_trace(query_pool: np.ndarray, *, rate: float, n_requests: int,
                  targets: Sequence[float] = (0.9, 0.95, 0.99),
                  target_probs: Optional[Sequence[float]] = None,
                  ks: Sequence[int] = (1,), seed: int = 0,
                  start: float = 0.0) -> List[Request]:
    """Seeded Poisson (open-loop) arrival trace over a query pool.

    Arrival gaps are exponential at ``rate`` req/s; each request draws a
    pool row (recorded as ``pool_row`` so oracles keyed on the pool need no
    reverse lookup), a quality target, and a k uniformly (targets
    optionally weighted).  The trace is a plain list — replayable,
    shuffle-free, and the only source of randomness in a serving run.
    """
    rng = np.random.default_rng(seed)
    arrivals = start + np.cumsum(rng.exponential(1.0 / rate, n_requests))
    rows = rng.integers(0, len(query_pool), n_requests)
    tsel = rng.choice(len(targets), n_requests, p=target_probs)
    ksel = rng.integers(0, len(ks), n_requests)
    return [Request(rid=i, query=np.asarray(query_pool[rows[i]]),
                    k=int(ks[ksel[i]]),
                    quality_target=float(targets[tsel[i]]),
                    arrival=float(arrivals[i]), pool_row=int(rows[i]))
            for i in range(n_requests)]


def run_trace(trace: Sequence[Request], batcher: MicroBatcher,
              execute: Callable[[MicroBatch], object], *,
              service_time: Optional[Callable[[MicroBatch], float]] = None,
              extract: Optional[Callable[[object, int], object]] = None,
              ) -> Tuple[Dict[int, dict], List[dict]]:
    """Drive an open-loop trace through the batcher (discrete-event loop).

    Virtual time advances by per-batch service times — measured wall-clock
    around ``execute`` by default, or injected via ``service_time`` (fixed
    costs make the whole run, batch composition included, deterministic —
    the batcher-policy tests use this).  Arrivals are admitted whenever the
    clock passes them; when nothing is due the clock jumps to the next
    event (arrival or flush deadline), so idle time costs nothing.

    Returns ``(completions, batch_log)``: ``completions[rid]`` has the
    request's ``latency``/``finish``/``target``/``k`` plus the executor's
    per-request payload under ``result`` (row index ``pos``).  By default
    ``result`` is the whole batch return value (shared by every member —
    fine for short traces); pass ``extract(batch_result, pos)`` to store a
    per-request projection instead, keeping completion memory O(1) per
    request on long-lived traces.  ``batch_log``
    records each batch's bucket, fill, members and service time — plus the
    measured ``wall`` seconds around ``execute`` even when ``service_time``
    injects the clock, so a fixed (deterministic) schedule can be replayed
    against real execution costs.
    """
    trace = sorted(trace, key=lambda r: (r.arrival, r.rid))
    completions: Dict[int, dict] = {}
    batch_log: List[dict] = []
    now = trace[0].arrival if trace else 0.0
    i = 0
    while i < len(trace) or batcher.pending:
        while i < len(trace) and trace[i].arrival <= now + _EPS:
            batcher.submit(trace[i])
            i += 1
        batches = batcher.poll(now)
        if not batches:
            nxt = batcher.next_deadline()
            if i < len(trace):
                nxt = min(nxt, trace[i].arrival)
            now = max(now, nxt)
            continue
        for b in batches:
            t0 = time.perf_counter()
            result = execute(b)
            wall = time.perf_counter() - t0
            dt = wall if service_time is None else float(service_time(b))
            now += dt
            batch_log.append({"formed_at": b.formed_at, "finish": now,
                              "bucket": b.bucket, "n_valid": b.n_valid,
                              "k": b.k, "service": dt, "wall": wall,
                              "rids": list(b.rids)})
            for pos, rid in enumerate(b.rids):
                completions[rid] = {
                    "latency": now - float(b.arrivals[pos]),
                    "finish": now, "pos": pos,
                    "target": float(b.targets[pos]), "k": b.k,
                    "result": (result if extract is None
                               else extract(result, pos))}
    return completions, batch_log


def run_trace_pipelined(trace: Sequence[Request], batcher: MicroBatcher,
                        dispatch: Callable[[MicroBatch], object],
                        harvest: Callable[[object], object], *,
                        service_time: Callable[[MicroBatch], float],
                        extract: Optional[Callable[[object, int], object]] = None,
                        max_in_flight: int = 1,
                        program_key: Optional[Callable[[MicroBatch], object]]
                        = None) -> Tuple[Dict[int, dict], List[dict]]:
    """Pipelined variant of :func:`run_trace`: overlap dispatch and execute.

    ``dispatch(batch)`` submits the batch asynchronously (the host returns
    once the card's work is enqueued) and returns a pending handle;
    ``harvest(handle)`` blocks until its results are ready.
    Up to ``max_in_flight`` batches run concurrently, so host-side batch
    formation for batch N+1 overlaps device execution of batch N.

    A batch is harvested (in FIFO dispatch order) before dispatching the
    next one when the pipeline is full **or** when the next batch maps to
    the same program — ``program_key(batch)``, default ``(bucket, k)`` —
    as the reference does, whose donated input buffers make a second
    in-flight batch per program illegal (the batch sequence stays the
    reference's).

    Determinism contract: ``service_time`` is **required** — the virtual
    clock must advance by injected per-batch costs at dispatch, exactly as
    the serial loop advances at execute, so batch composition, completion
    times, and the batch sequence are identical to :func:`run_trace` on the
    same trace.  Measured host timings land in the log instead:
    ``dispatch_s`` (submit cost, also logged as ``wall``), ``harvest_s``
    (residual blocking wait after overlap), and real ``t_disp``/``t_done``
    timestamps for throughput replay.
    """
    if service_time is None:
        raise ValueError("run_trace_pipelined needs an injected service_time"
                         " (the virtual clock cannot be measured while"
                         " execution overlaps dispatch)")
    if max_in_flight < 1:
        raise ValueError("max_in_flight must be >= 1")
    if program_key is None:
        program_key = lambda b: (b.bucket, b.k)      # noqa: E731

    trace = sorted(trace, key=lambda r: (r.arrival, r.rid))
    completions: Dict[int, dict] = {}
    batch_log: List[dict] = []
    inflight: deque = deque()      # (handle, batch, key, log_entry) FIFO

    def _retire():
        handle, b, _key, entry = inflight.popleft()
        t0 = time.perf_counter()
        result = harvest(handle)
        t1 = time.perf_counter()
        entry["harvest_s"] = t1 - t0
        entry["t_done"] = t1
        for pos, rid in enumerate(b.rids):
            completions[rid]["result"] = (result if extract is None
                                          else extract(result, pos))

    now = trace[0].arrival if trace else 0.0
    i = 0
    while i < len(trace) or batcher.pending:
        while i < len(trace) and trace[i].arrival <= now + _EPS:
            batcher.submit(trace[i])
            i += 1
        batches = batcher.poll(now)
        if not batches:
            nxt = batcher.next_deadline()
            if i < len(trace):
                nxt = min(nxt, trace[i].arrival)
            now = max(now, nxt)
            continue
        for b in batches:
            key = program_key(b)
            while inflight and (len(inflight) >= max_in_flight
                                or any(e[2] == key for e in inflight)):
                _retire()
            t0 = time.perf_counter()
            handle = dispatch(b)
            t1 = time.perf_counter()
            dt = float(service_time(b))
            now += dt
            entry = {"formed_at": b.formed_at, "finish": now,
                     "bucket": b.bucket, "n_valid": b.n_valid,
                     "k": b.k, "service": dt, "wall": t1 - t0,
                     "rids": list(b.rids), "dispatch_s": t1 - t0,
                     "t_disp": t1, "harvest_s": None, "t_done": None}
            batch_log.append(entry)
            inflight.append((handle, b, key, entry))
            for pos, rid in enumerate(b.rids):
                completions[rid] = {
                    "latency": now - float(b.arrivals[pos]),
                    "finish": now, "pos": pos,
                    "target": float(b.targets[pos]), "k": b.k,
                    "result": None}
    while inflight:
        _retire()
    return completions, batch_log
