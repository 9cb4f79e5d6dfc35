"""Continuous-batching serving over the paged KV pool."""
from repro_torch.serve.engine import Engine  # noqa: F401
from repro_torch.serve.scheduler import (Request, RequestStatus,  # noqa: F401
                                         ScheduledRequest, Scheduler, State)
from repro_torch.serve.server import ContinuousEngine, RequestResult  # noqa: F401
