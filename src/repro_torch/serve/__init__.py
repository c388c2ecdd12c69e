"""Serving stack, ported from ``repro.serve``: the Clock seam,
ServeStats, the front-end over both engines (DESIGN.md §11), the
continuous-batching LM engine with its queue, scheduler and slot KV cache
(DESIGN.md §6), and the bucketed VisionEngine (DESIGN.md §8)."""
from repro_torch.serve.cache import SlotKVCache
from repro_torch.serve.clock import Clock, MonotonicClock, VirtualClock
from repro_torch.serve.engine import Engine, EngineConfig, EngineStats
from repro_torch.serve.frontend import (Frontend, FrontendConfig, LMAdapter,
                                        OpenLoopDriver, SchedulerCore,
                                        ServeRequest, ServeRequestState,
                                        VisionAdapter)
from repro_torch.serve.queue import QueueFullError, RequestQueue
from repro_torch.serve.request import Request, RequestState
from repro_torch.serve.scheduler import Scheduler, SchedulerStats
from repro_torch.serve.stats import ServeStats, percentile
from repro_torch.serve.steps import (greedy_sample, make_decode_step,
                                     make_prefill_step)
from repro_torch.serve.vision import (VisionEngine, VisionEngineConfig,
                                      VisionStats)

__all__ = ["SlotKVCache", "Clock", "MonotonicClock", "VirtualClock",
           "Engine", "EngineConfig", "EngineStats", "Frontend",
           "FrontendConfig", "LMAdapter", "OpenLoopDriver",
           "SchedulerCore", "ServeRequest", "ServeRequestState",
           "VisionAdapter", "QueueFullError",
           "RequestQueue", "Request", "RequestState", "Scheduler",
           "SchedulerStats", "ServeStats", "percentile", "greedy_sample",
           "make_decode_step", "make_prefill_step", "VisionEngine",
           "VisionEngineConfig", "VisionStats"]
