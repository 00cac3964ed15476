"""The serving layer around the engine (port of ``repro/serving``).

    trace ──► fingerprint ──► result cache ──► (planner) ──► deadline batcher
                                  │ hit                            │ batches
                                  ▼                                ▼
                               response ◄──── worker pool ◄── dispatch queue

* :mod:`~repro_torch.serving.fingerprint` — normalized query keys.
* :mod:`~repro_torch.serving.cache` — LRU and cost-aware Landlord caches.
* :mod:`~repro_torch.serving.batcher` — shape-bucketed and deadline batchers.
* :mod:`~repro_torch.serving.pending` — the in-flight table for coalescing.
* :mod:`~repro_torch.serving.executor` — single-device, doc-sharded
  scatter-gather and mesh executors, with footprint routing.
* :mod:`~repro_torch.serving.server` — the closed- and open-loop serve loop.
"""
from repro_torch.serving.batcher import (
    BucketShape,
    DeadlineBatcher,
    PendingQuery,
    RawBatch,
    ShapeBucketedBatcher,
)
from repro_torch.serving.cache import LandlordCache, LRUCache, make_cache
from repro_torch.serving.executor import (
    ROUTINGS,
    MeshExecutor,
    ShardedExecutor,
    SingleDeviceExecutor,
)
from repro_torch.serving.factory import EXECUTOR_KINDS, make_executor
from repro_torch.serving.fingerprint import query_fingerprint
from repro_torch.serving.pending import PendingEntry, PendingTable
from repro_torch.serving.server import (
    BatchEvent,
    GeoServer,
    QueryResult,
    ServeReport,
)

__all__ = [
    "BucketShape",
    "DeadlineBatcher",
    "PendingQuery",
    "RawBatch",
    "ShapeBucketedBatcher",
    "LRUCache",
    "LandlordCache",
    "make_cache",
    "ROUTINGS",
    "MeshExecutor",
    "ShardedExecutor",
    "SingleDeviceExecutor",
    "EXECUTOR_KINDS",
    "make_executor",
    "query_fingerprint",
    "PendingEntry",
    "PendingTable",
    "BatchEvent",
    "GeoServer",
    "QueryResult",
    "ServeReport",
]
