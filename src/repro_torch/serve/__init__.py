from repro_torch.serve.cache import CachePool
from repro_torch.serve.engine import CACHE_BACKENDS, ServeEngine, ServeStats
from repro_torch.serve.paged import BlockManager
from repro_torch.serve.scheduler import ContinuousScheduler, ServeRequest

__all__ = ["BlockManager", "CACHE_BACKENDS", "CachePool",
           "ContinuousScheduler", "ServeEngine", "ServeRequest",
           "ServeStats"]
