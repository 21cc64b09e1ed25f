"""Serving: continuous batching over a paged KV cache with open-loop load
and SLO-aware scheduling (counterpart of ``repro.serving``).

The host-side pieces (request state machine, block allocator, traffic
generation) are copies of the reference's; ``TorchExecutor`` runs the
model on the device through ``repro_torch.models.transformer``; the
end-to-end entry point is ``repro_torch.launch.serve``."""
from .kv_cache import BlockAllocator, OutOfBlocks, blocks_needed, \
    build_block_tables
from .loadgen import SLO, Request, ReqState, bursty_arrivals, make_requests, \
    poisson_arrivals
from .scheduler import Executor, Scheduler, ServeReport, SimExecutor, \
    TorchExecutor, default_compute_model, summarize

__all__ = [
    "BlockAllocator", "OutOfBlocks", "blocks_needed", "build_block_tables",
    "SLO", "Request", "ReqState", "poisson_arrivals", "bursty_arrivals",
    "make_requests", "Executor", "SimExecutor", "TorchExecutor", "Scheduler",
    "ServeReport", "summarize", "default_compute_model",
]
