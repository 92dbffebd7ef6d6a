"""The multi-tenant front door over the serving engine (the port's
``paddle_tpu/inference/frontend/``): live admission while the engine
runs, fair scheduling across tenants with a hard starvation bound,
cancellation and deadlines, explicit backpressure, per-request sampling
and the HTTP ingest.

    from paddle_tpu_torch.inference.frontend import (
        FrontDoor, SamplingParams, Tenant)

    door = FrontDoor(model, tenants=[Tenant("paid", weight=4, tier=0),
                                     Tenant("free", weight=1, tier=1)],
                     max_batch_slots=8, max_len=256, block_size=16)
    with door:
        h = door.submit([1, 2, 3], tenant="paid", max_new_tokens=32,
                        sampling=SamplingParams(top_p=0.9), deadline=2.0)
        for tok in h:           # or: async for tok in h
            ...
        print(h.finish_reason)

The engine runs on ``device`` (default ``"cuda"``), passed through the
door's engine keywords.
"""

from .admission import AdmissionController, AdmissionRejected
from .ingest import IngestServer
from .sampling import SamplingParams
from .scheduler import FairScheduler, FifoScheduler, Scheduler, Tenant
from .server import FrontDoor, RequestHandle

__all__ = [
    "FrontDoor", "RequestHandle", "IngestServer", "SamplingParams",
    "Scheduler", "FifoScheduler", "FairScheduler", "Tenant",
    "AdmissionController", "AdmissionRejected",
]
