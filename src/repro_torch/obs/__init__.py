"""Observability of the cascade (port of part of ``repro.obs``).

* :mod:`repro_torch.obs.trace` — ``CascadeTrace``, the per-query record
  ``engine.run_cascade(trace=True)`` returns: which bound pruned which
  leaf, survivors, probes and the exact distance rows paid.
* :mod:`repro_torch.obs.audit` — ``FilterAudit``, its per-leaf transpose:
  prune counts by bound, work saved, and the residual statistics of each
  filter's adjusted prediction on the leaves the engine scored exactly.

Both are plain tensor code over (Q,) and (Q, L) tensors, on the device
the engine ran on.  The reference's ``health``, ``metrics``, ``spans``,
``export`` and ``explain`` modules (host-side observability) are not
ported yet.
"""
from .audit import (AuditParts, FilterAudit, RESIDUAL_EDGES,
                    accounting_residual_leaf)
from .trace import (CascadeTrace, accounting_residual, combine, select,
                    to_numpy, zero_trace)
from . import audit, trace

__all__ = [
    "CascadeTrace", "accounting_residual", "combine", "select", "to_numpy",
    "zero_trace",
    "AuditParts", "FilterAudit", "RESIDUAL_EDGES",
    "accounting_residual_leaf",
    "audit", "trace",
]
