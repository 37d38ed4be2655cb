"""Continuous-batching serving with slot-isolated recovery (paged KV)."""

from repro_torch.serving.request import Request, RequestQueue, VirtualClock
from repro_torch.serving.engine import ServingEngine, ServingReport
from repro_torch.serving.paged import (AdmissionError, BlockAllocator,
                                       PoolSaturated)

__all__ = ["Request", "RequestQueue", "VirtualClock", "ServingEngine",
           "ServingReport", "AdmissionError", "BlockAllocator",
           "PoolSaturated"]
