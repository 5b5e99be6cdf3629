"""Leaf-sharded LeaFi search over ``torch.distributed`` (port of
``repro.core.distributed``).

The index is partitioned by leaves across the ``model`` dimension of a
(data, model) device mesh (round-robin by leaf size for balance, as in
DPiSAX/Odyssey) and query batches split across ``data``.  Search is a
two-phase exchange, run by every rank of the mesh with the same full batch:

  Phase 1 — every shard probes each query's most promising local leaf
            (smallest lower bound); one ``all_reduce(MIN)`` over the model
            group gives the global best-so-far ``bsf0``.
  Phase 2 — every shard runs the LeaFi cascade over its own leaves against
            that ``bsf0``, scoring only survivors; ``all_reduce(MIN)`` over
            the model group gives the answer and ``all_reduce(SUM)`` the
            leaves searched in all.

The collectives carry O(Q) values, whatever the collection's size.  The
reference runs one program over every device of a ``shard_map``; here each
rank is a process that holds its own shard on its own device (several ranks
may share one card under ``gloo``) and calls the returned function with the
same batch.  Only ``all_reduce`` and ``broadcast`` are used, the two
collectives ``gloo`` takes on CUDA tensors as well: a gather over a group
is a reduction of a buffer in which each rank writes its own part.

Per shard, the pruning inputs are the box lower bound and the fused filter
MLP (``kernels/box_lb`` and ``kernels/filter_mlp`` on the card), where the
reference computes both inline with jnp; the cascade is the engine's
``compact_bsf_cascade`` (the default: the candidate-pass kernel and the
replay kernel's seeded instance) or ``masked_bsf_scan``.
"""
from __future__ import annotations

import dataclasses
import datetime
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from . import conformal, engine, summaries
from ..kernels.box_lb import ops as box_lb_ops
from ..kernels.common import Device, resolve_device
from ..kernels.filter_mlp import ops as mlp_ops
from ..obs import audit as obs_audit
from ..obs.audit import FilterAudit
from ..obs.trace import CascadeTrace

_INF = float("inf")

#: collectives that wait longer than this raise (``init_process_group``'s
#: and the mesh groups' timeout unless the caller gives one)
DEFAULT_TIMEOUT_S = 600.0


@dataclasses.dataclass
class ShardedLeaFi:
    """A LeaFi index partitioned into leaf shards: per-shard stacked numpy
    arrays, leading axis the shard, as the reference's (whose arrays these
    equal).  :meth:`local` puts one shard on a device, by default
    ``device``, the one :func:`shard_leafi` was given."""
    series: np.ndarray            # (S, rows_max, m)
    leaf_start: np.ndarray        # (S, P)
    leaf_size: np.ndarray         # (S, P)   0 ⇒ padding leaf
    lb_lo: np.ndarray             # (S, P, d)  box lower edges (pre-scaled)
    lb_hi: np.ndarray             # (S, P, d)
    w1: np.ndarray                # (S, P, m, h)
    b1: np.ndarray                # (S, P, h)
    w2: np.ndarray                # (S, P, h)
    b2: np.ndarray                # (S, P)
    y_mean: np.ndarray            # (S, P)
    y_std: np.ndarray             # (S, P)
    offsets: np.ndarray           # (S, P) conformal offsets at build target
    has_filter: np.ndarray        # (S, P) bool
    max_leaf: int
    length: int
    kind: str
    qscale: np.ndarray            # (d,) query coordinate pre-scale (box LB)
    leaf_global: Optional[np.ndarray] = None   # (S, P) slot → leaf (L: pad)
    device: Optional[torch.device] = None       # where local() puts a shard

    @property
    def n_shards(self) -> int:
        return int(self.leaf_size.shape[0])

    def local(self, shard: int, device: Device = None) -> "LocalShard":
        """Shard ``shard`` on ``device`` (``None``: :attr:`device`, else
        the card): the leaf layout as int64, and of the filter stack only
        the slots that carry a filter."""
        dev = resolve_device(self.device if device is None else device)
        filt = np.flatnonzero(self.has_filter[shard])

        def t(a, dtype=torch.float32):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                   device=dev)
        return LocalShard(
            series=t(self.series[shard]),
            leaf_start=t(self.leaf_start[shard], torch.int64),
            leaf_size=t(self.leaf_size[shard], torch.int64),
            lb_lo=t(self.lb_lo[shard]), lb_hi=t(self.lb_hi[shard]),
            filt=t(filt, torch.int64),
            w1=t(self.w1[shard, filt]), b1=t(self.b1[shard, filt]),
            w2=t(self.w2[shard, filt]), b2=t(self.b2[shard, filt]),
            y_mean=t(self.y_mean[shard, filt]),
            y_std=t(self.y_std[shard, filt]),
            offsets=t(self.offsets[shard, filt]),
            leaf_global=(None if self.leaf_global is None
                         else t(self.leaf_global[shard], torch.int64)),
            qscale=t(self.qscale), max_leaf=self.max_leaf, kind=self.kind)


@dataclasses.dataclass
class LocalShard:
    """One shard on one device.  ``filt`` lists the slots that carry a
    filter, and ``w1`` … ``offsets`` are theirs alone."""
    series: torch.Tensor          # (rows_max, m)
    leaf_start: torch.Tensor      # (P,) int64
    leaf_size: torch.Tensor       # (P,) int64
    lb_lo: torch.Tensor           # (P, d)
    lb_hi: torch.Tensor           # (P, d)
    filt: torch.Tensor            # (F_s,) int64 slots with a filter
    w1: torch.Tensor              # (F_s, m, h)
    b1: torch.Tensor              # (F_s, h)
    w2: torch.Tensor              # (F_s, h)
    b2: torch.Tensor              # (F_s,)
    y_mean: torch.Tensor          # (F_s,)
    y_std: torch.Tensor           # (F_s,)
    offsets: torch.Tensor         # (F_s,) at the build's target
    leaf_global: Optional[torch.Tensor]   # (P,) int64
    qscale: torch.Tensor          # (d,)
    max_leaf: int
    kind: str

    def query_coords(self, queries: torch.Tensor) -> torch.Tensor:
        """Raw queries → pre-scaled box coordinates (see kernels/box_lb)."""
        d = self.lb_lo.shape[-1]
        if self.kind == "dstree":
            st = summaries.segment_stats(queries, d // 2)
            q = torch.cat([st[..., 0], st[..., 1]], -1)
        else:
            q = summaries.paa(queries, d)
        return q * self.qscale


def shard_leafi(lfi, n_shards: int,
                quality_target: Optional[float] = 0.99, *,
                device: Device = None) -> ShardedLeaFi:
    """Partition a built LeaFiIndex (on any device) into ``n_shards`` leaf
    groups, round-robin by descending leaf size, for the search on
    ``device`` (``None``: the card); the arrays are numpy on the host,
    array for array the reference's.  The filters must be MLPs with
    float32 or bfloat16 weights (int8's per-filter scales have no place in
    the stack)."""
    dev = resolve_device(device)
    index = lfi.index
    if lfi.filter_params is not None:
        if lfi.config.filter_type != "mlp":
            raise ValueError("the sharded search runs MLP filters, not "
                             f"{lfi.config.filter_type!r}")
        if "w1_scale" in lfi.filter_params:
            raise ValueError("int8 filter weights cannot be sharded: shard "
                             "the float32 index")
    L = index.n_leaves
    sizes = index.leaf_size.cpu().numpy()
    order = np.argsort(-sizes, kind="stable")
    shard_of = np.empty(L, np.int64)
    shard_of[order] = np.arange(L) % n_shards
    P_max = max(int((shard_of == s).sum()) for s in range(n_shards))

    # pre-scaled box edges (one form for both backbones; cf. kernels/box_lb)
    if index.kind == "dstree":
        box = index.payload["eapca_box"].cpu().numpy()
        w = np.sqrt(index.payload["seg_len"].cpu().numpy().astype(
            np.float32))
        lo = np.concatenate([box[..., 0] * w, box[..., 2] * w], -1)
        hi = np.concatenate([box[..., 1] * w, box[..., 3] * w], -1)
        qscale = np.concatenate([w, w])
    else:
        edges = index.payload["sax_edges"].cpu().numpy()
        wl = edges.shape[1]
        scale = np.sqrt(index.length / wl)
        lo, hi = edges[..., 0] * scale, edges[..., 1] * scale
        qscale = np.full(wl, scale, np.float32)

    m = index.length
    params = ({k: v.float().cpu().numpy() if v.is_floating_point()
               else v.cpu().numpy() for k, v in lfi.filter_params.items()}
              if lfi.filter_params is not None else None)
    h = params["w1"].shape[-1] if params else m
    F_of_leaf = {int(lf): i for i, lf in enumerate(lfi.leaf_ids)}
    offsets_global = conformal.scatter_offsets(
        lfi.tuner, lfi.leaf_ids, L, quality_target) \
        if lfi.tuner is not None else np.zeros(L, np.float32)

    series_np = index.series.cpu().numpy()
    starts_np = index.leaf_start.cpu().numpy()
    rows_max = max(int(sizes[shard_of == s].sum())
                   for s in range(n_shards)) + index.max_leaf_size

    S = n_shards
    out = ShardedLeaFi(
        series=np.zeros((S, rows_max, m), np.float32),
        leaf_start=np.zeros((S, P_max), np.int32),
        leaf_size=np.zeros((S, P_max), np.int32),
        lb_lo=np.full((S, P_max, lo.shape[-1]), -np.inf, np.float32),
        lb_hi=np.full((S, P_max, lo.shape[-1]), np.inf, np.float32),
        w1=np.zeros((S, P_max, m, h), np.float32),
        b1=np.zeros((S, P_max, h), np.float32),
        w2=np.zeros((S, P_max, h), np.float32),
        b2=np.zeros((S, P_max), np.float32),
        y_mean=np.zeros((S, P_max), np.float32),
        y_std=np.ones((S, P_max), np.float32),
        offsets=np.zeros((S, P_max), np.float32),
        has_filter=np.zeros((S, P_max), bool),
        max_leaf=index.max_leaf_size, length=m, kind=index.kind,
        qscale=qscale.astype(np.float32),
        leaf_global=np.full((S, P_max), L, np.int32), device=dev,
    )
    for s in range(n_shards):
        cursor = 0
        for j, lf in enumerate(np.flatnonzero(shard_of == s)):
            out.leaf_global[s, j] = lf
            sz, st = int(sizes[lf]), int(starts_np[lf])
            out.series[s, cursor:cursor + sz] = series_np[st:st + sz]
            out.leaf_start[s, j] = cursor
            out.leaf_size[s, j] = sz
            out.lb_lo[s, j] = lo[lf]
            out.lb_hi[s, j] = hi[lf]
            fi = F_of_leaf.get(int(lf))
            if params is not None and fi is not None:
                for name in ("w1", "b1", "w2", "b2", "y_mean", "y_std"):
                    getattr(out, name)[s, j] = params[name][fi]
                out.offsets[s, j] = offsets_global[lf]
                out.has_filter[s, j] = True
            cursor += sz
    return out


# ---------------------------------------------------------------------------
# the shard-local search body
# ---------------------------------------------------------------------------


def _shard_pruning_inputs(shard: LocalShard, queries: torch.Tensor,
                          qcoords: torch.Tensor,
                          qoffsets: Optional[torch.Tensor] = None):
    """One shard's (Q, P) pruning inputs: the box lower bounds (padding
    slots, whose (−inf, +inf) boxes give 0, forced to +inf so that they
    sort last, never survive and never probe) and the filter predictions
    (−inf where a slot has no filter).  Only the filtered slots go through
    the fused filter kernel: with the baked (P,) offsets in its epilogue,
    or, given global (Q, L) per-query offset rows, without offsets and the
    rows, gathered onto the slots through ``leaf_global``, subtracted
    after (as ``core/search.py`` does)."""
    size = shard.leaf_size
    lb = box_lb_ops.box_lb(qcoords, shard.lb_lo, shard.lb_hi)
    lb = torch.where(size[None, :] > 0, lb, _INF)
    Q, P = lb.shape
    d_F = torch.full((Q, P), -_INF, device=lb.device)
    if shard.filt.numel():
        if qoffsets is None:
            pred = mlp_ops.filter_predict_fused(
                shard.w1, shard.b1, shard.w2, shard.b2, shard.y_mean,
                shard.y_std, queries, shard.offsets)             # (F_s, Q)
        else:
            pred = mlp_ops.filter_predict_fused(
                shard.w1, shard.b1, shard.w2, shard.b2, shard.y_mean,
                shard.y_std, queries)
            pred = pred - qoffsets[:, shard.leaf_global[shard.filt]].T
        d_F[:, shard.filt] = pred.T
    return lb, d_F


def _local_search(shard: LocalShard, lb, d_F, queries, bsf0, *,
                  strategy: str = "compact",
                  max_survivors: Optional[int] = None,
                  dist_impl: Optional[str] = None, bsf_ub=None,
                  trace: bool = False, audit: bool = False):
    """The cascade over one shard's leaves from the global ``bsf0``: the
    engine's ``compact_bsf_cascade`` (default) or ``masked_bsf_scan``.
    Returns (bsf, n_s[, trace][, parts]); the scan's trace is its step
    counters as a :class:`CascadeTrace` (``probed`` 0: the exchange counts
    the probes)."""
    args = (shard.series, shard.leaf_start, shard.leaf_size, lb, d_F,
            queries, shard.max_leaf, bsf0)
    if strategy == "compact":
        return engine.compact_bsf_cascade(
            *args, max_survivors=max_survivors, dist_impl=dist_impl,
            bsf_ub=bsf_ub, trace=trace, audit=audit)
    if strategy != "scan":
        raise ValueError(f"unknown distributed shard strategy {strategy!r}")
    out = engine.masked_bsf_scan(*args, bsf_ub=bsf_ub, trace=trace,
                                 audit=audit)
    rets = out[:2]
    if trace:
        n_box, n_seed, n_pf, n_rows = out[2]
        zq = torch.zeros_like(out[1])
        rets += (CascadeTrace(n_box, n_seed, n_pf, zq, out[1], zq, n_rows),)
    if audit:
        rets += (out[3],)
    return rets


def _all_reduce(t: torch.Tensor, op, group) -> torch.Tensor:
    """``t`` reduced in place over ``group`` (nothing to do for one rank)."""
    if dist.get_world_size(group) > 1:
        dist.all_reduce(t, op=op, group=group)
    return t


def _gather_rows(part: torch.Tensor, index: int, n: int, fill: float, op,
                 group) -> torch.Tensor:
    """``n`` equal parts along dim 0, ours at ``index``: a buffer of
    ``fill`` with ours written in, reduced over ``group`` (where the other
    parts are written)."""
    rows = part.shape[0]
    full = torch.full((n * rows,) + tuple(part.shape[1:]), fill,
                      dtype=part.dtype, device=part.device)
    full[index * rows:(index + 1) * rows] = part
    return _all_reduce(full, op, group)


def _reduce_audit(fa: FilterAudit, fn) -> FilterAudit:
    """Every audit field through ``fn(field, fill, op)``: the counters and
    sums with SUM (fill 0), ``resid_min`` with MIN (fill +inf)."""
    return FilterAudit(*(
        fn(x, _INF, dist.ReduceOp.MIN) if name == "resid_min"
        else fn(x, 0, dist.ReduceOp.SUM)
        for name, x in zip(FilterAudit._fields, fa)))


def make_search_mesh(n_data: int, n_model: int, *, device: Device = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S):
    """A (``data``, ``model``) :class:`~torch.distributed.device_mesh.
    DeviceMesh` over the running process group, whose world size must be
    ``n_data · n_model``.  ``device=None`` means the card: this rank's
    current CUDA device, set to ``rank % device_count`` first when the
    caller has set none; ``"cpu"`` a CPU mesh.  The mesh's groups take the
    default group's backend and ``timeout_s``, so that a collective no
    other rank joins raises instead of waiting."""
    from torch.distributed.device_mesh import init_device_mesh
    dev = resolve_device(device)
    backend = dist.get_backend()
    opts_cls = (dist.ProcessGroupNCCL.Options if backend == "nccl"
                else dist.ProcessGroupGloo._Options)
    opts = opts_cls()
    opts._timeout = datetime.timedelta(seconds=timeout_s)
    return init_device_mesh(
        dev.type, (n_data, n_model), mesh_dim_names=("data", "model"),
        backend_override={"data": (backend, opts),
                          "model": (backend, opts)})


def make_distributed_search(mesh, sharded: ShardedLeaFi, *,
                            strategy: str = "compact",
                            max_survivors: Optional[int] = None,
                            dist_impl: Optional[str] = None,
                            per_query_offsets: bool = False,
                            trace: bool = False, audit: bool = False,
                            device: Device = None):
    """The leaf-sharded search step over ``mesh`` (:func:`make_search_mesh`)
    for the rank that calls it: this rank's shard (its ``model``
    coordinate) goes onto ``device`` (``None``: this rank's card; the
    mesh's device type), and the returned function must be called by
    every rank of the mesh with the same full batch.

    Returns ``fn(queries (Q, m))`` → ``(nn (Q,), total_searched (Q,))``,
    identical on every rank: the global nearest distance and the leaves
    searched over all shards (the sum of the per-shard cascades' counts).
    The queries split over the ``data`` dimension (Q not divisible by its
    size raises, as ``shard_map`` does); the index over ``model``.

    strategy: ``"compact"`` (default, ``engine.compact_bsf_cascade``;
    ``max_survivors`` its capacity, ``dist_impl`` its candidate distance
    form) or ``"scan"`` (``engine.masked_bsf_scan``).

    per_query_offsets: the serving form ``fn(queries (Q, m), qoffsets (Q,
    L), bsf_ub (Q,))``: each query's own per-leaf conformal offsets
    (gathered onto each shard's slots through ``sharded.leaf_global``;
    +inf rows: exact) and a prune-only bound (+inf rows change nothing).

    trace: also a per-query :class:`CascadeTrace` summed over the model
    group: ``probed`` counts one probe per shard, ``distances`` includes
    each probe's rows, and Σ pruned = S·P − survivors.  audit: also a
    :class:`FilterAudit` in the (S, P) shard-slot layout: summed over the
    data group (``resid_min`` by minimum), each model rank's row gathered
    (fold it with ``obs.audit.scatter_global`` and
    ``sharded.leaf_global``).  The outputs are ``(nn, searched[,
    trace][, audit])``, torch tensors on this rank's device.

    The reference's ``donate`` (XLA buffer donation) has no eager
    counterpart and is not taken; it also returns the index arrays and
    partition specs of its ``shard_map``, which do not exist here.
    """
    dev = resolve_device(device)
    if mesh.device_type != dev.type:
        raise ValueError(f"a {mesh.device_type} mesh for a search on {dev}")
    if per_query_offsets and sharded.leaf_global is None:
        raise ValueError("per_query_offsets needs ShardedLeaFi.leaf_global")
    n_data, n_model = mesh.shape
    if sharded.n_shards != n_model:
        raise ValueError(f"{sharded.n_shards} shards on a mesh of "
                         f"{n_model} model ranks")
    di, mi = mesh.get_coordinate()
    model_g, data_g = mesh.get_group("model"), mesh.get_group("data")
    shard = sharded.local(mi, dev)
    MIN, SUM = dist.ReduceOp.MIN, dist.ReduceOp.SUM

    def run(queries, qoffsets=None, bsf_ub=None):
        q = torch.as_tensor(np.asarray(queries, np.float32) if isinstance(
            queries, np.ndarray) else queries, dtype=torch.float32,
            device=dev)
        Q = q.shape[0]
        if Q % n_data:
            raise ValueError(f"{Q} queries do not split over {n_data} data "
                             "ranks")
        Qd = Q // n_data
        rows = slice(di * Qd, (di + 1) * Qd)
        qd = q[rows].contiguous()
        qoff = ub = None
        if per_query_offsets:
            qoff = torch.as_tensor(qoffsets, dtype=torch.float32,
                                   device=dev)[rows]
            ub = torch.as_tensor(bsf_ub, dtype=torch.float32,
                                 device=dev)[rows].contiguous()
        lb, d_F = _shard_pruning_inputs(shard, qd, shard.query_coords(qd),
                                        qoff)
        # phase 1: the best local leaf, then the global bsf
        bsf0 = _all_reduce(engine.probe_best_leaf(
            shard.series, shard.leaf_start, shard.leaf_size, lb, qd,
            shard.max_leaf, dist_impl), MIN, model_g)
        # phase 2: the cascade against it (the warm bound prunes only:
        # never folded into bsf0, which stays a witnessed distance)
        out = _local_search(shard, lb, d_F, qd, bsf0, strategy=strategy,
                            max_survivors=max_survivors,
                            dist_impl=dist_impl, bsf_ub=ub, trace=trace,
                            audit=audit)
        nn = _all_reduce(out[0].clone(), MIN, model_g)
        counts = [out[1].to(torch.int32)]
        rest = list(out[2:])
        if trace:
            tr = rest.pop(0)
            probe_rows = shard.leaf_size[lb.argmin(dim=1)].to(torch.int32)
            tr = tr._replace(probed=tr.probed + 1,
                             distances=tr.distances + probe_rows)
            counts += list(tr)
        counts = _all_reduce(torch.stack(counts), SUM, model_g)
        # the data slices back together: every rank gets the whole batch
        nn = _gather_rows(nn, di, n_data, _INF, MIN, data_g)
        counts = _gather_rows(counts.T.contiguous(), di, n_data, 0, SUM,
                              data_g).T
        rets = (nn, counts[0])
        if trace:
            rets += (CascadeTrace(*counts[1:]),)
        if audit:
            fa = obs_audit.reduce_parts(rest.pop(0), d_F, shard.leaf_size)
            fa = _reduce_audit(fa, lambda x, fill, op: _all_reduce(
                x.clone(), op, data_g))
            fa = _reduce_audit(fa, lambda x, fill, op: _gather_rows(
                x[None], mi, n_model, fill, op, model_g))
            rets += (fa,)
        return rets

    return run


def init_process_group(backend: str, rank: int, world_size: int,
                       init_method: str,
                       timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """``torch.distributed.init_process_group`` with a finite timeout, so
    that a collective no other rank joins raises.  The backend is the
    caller's: ``nccl`` for one card a rank, ``gloo`` for the CPU or for
    several ranks on one card (NCCL refuses two ranks on one device)."""
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))
