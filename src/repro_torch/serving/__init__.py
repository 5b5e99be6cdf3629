"""LeaFi serving runtime (port of ``repro.serving``): dynamic
micro-batching over the search engine.

Public API:
    MicroBatcher, Request, MicroBatch      admission queue + flush policy
    poisson_trace, run_trace               open-loop traffic + event drive
    run_trace_pipelined                    overlapped dispatch/execute drive
    ServingSession, save_index, load_index warmed sessions + cold start
    BsfCache                               cross-batch bsf warm-starting
    Telemetry, latency_percentiles         rolling serving counters
    ShadowSampler, explain_query           sampled exact-scan audit + explain
    DistributedExecutor                    micro-batches → leaf-sharded search
"""
from .batcher import (MicroBatch, MicroBatcher, Request,  # noqa: F401
                      poisson_trace, run_trace, run_trace_pipelined)
from .session import (DistributedExecutor, PendingBatch,  # noqa: F401
                      ServingSession, load_index, save_index)
from .shadow import ShadowSampler, explain_query          # noqa: F401
from .telemetry import Telemetry, latency_percentiles     # noqa: F401
from .warmstart import BsfCache                           # noqa: F401
