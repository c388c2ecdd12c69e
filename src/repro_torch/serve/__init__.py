"""Vision serving stack, ported from ``repro.serve`` (DESIGN.md §11):
the Clock seam, ServeStats, the front-end and the bucketed VisionEngine."""
from repro_torch.serve.clock import Clock, MonotonicClock, VirtualClock
from repro_torch.serve.frontend import (Frontend, FrontendConfig,
                                        SchedulerCore, ServeRequest,
                                        ServeRequestState, VisionAdapter)
from repro_torch.serve.queue import QueueFullError
from repro_torch.serve.stats import ServeStats, percentile
from repro_torch.serve.vision import (VisionEngine, VisionEngineConfig,
                                      VisionStats)

__all__ = ["Clock", "MonotonicClock", "VirtualClock", "Frontend",
           "FrontendConfig", "SchedulerCore", "ServeRequest",
           "ServeRequestState", "VisionAdapter", "QueueFullError",
           "ServeStats", "percentile", "VisionEngine", "VisionEngineConfig",
           "VisionStats"]
