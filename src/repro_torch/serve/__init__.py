from repro_torch.serve.engine import ServeEngine, ServeStats
from repro_torch.serve.paged import BlockManager
from repro_torch.serve.scheduler import ContinuousScheduler, ServeRequest

__all__ = ["BlockManager", "ContinuousScheduler", "ServeEngine",
           "ServeRequest", "ServeStats"]
