"""Continuous-batching serving over the paged KV pool."""
from repro_torch.serve.engine import Engine  # noqa: F401
from repro_torch.serve.faults import CrashPoint, FaultInjector  # noqa: F401
from repro_torch.serve.kv_pool import SpillEntry, SpillStore  # noqa: F401
from repro_torch.serve.scheduler import (PRIORITY_BATCH,  # noqa: F401
                                         PRIORITY_INTERACTIVE, Request,
                                         RequestStatus, ScheduledRequest,
                                         Scheduler, State)
from repro_torch.serve.server import ContinuousEngine, RequestResult  # noqa: F401
