from repro_torch.serve.cache import CachePool
from repro_torch.serve.chaos import (FAULT_KINDS, Fault, FaultInjector,
                                     FaultSchedule)
from repro_torch.serve.elastic import ElasticController, ScalePlan
from repro_torch.serve.engine import CACHE_BACKENDS, ServeEngine, ServeStats
from repro_torch.serve.paged import BlockManager
from repro_torch.serve.replay import ReplayResult, philly_requests, run_replay
from repro_torch.serve.scheduler import (SERVE_POLICIES, ContinuousScheduler,
                                         ServeRequest)
from repro_torch.serve.tenant import (SLOSlack, ServeClassProfile, Tenant,
                                      TenantAllocation, TenantAllocator,
                                      TenantRegistry, TenantShare,
                                      plan_allocation, profile_class,
                                      profiles_from_requests)

__all__ = [
    "BlockManager", "CACHE_BACKENDS", "CachePool", "ContinuousScheduler",
    "ElasticController", "FAULT_KINDS", "Fault", "FaultInjector",
    "FaultSchedule", "ReplayResult", "ScalePlan", "ServeClassProfile",
    "ServeEngine", "ServeRequest", "ServeStats", "SERVE_POLICIES",
    "SLOSlack", "Tenant", "TenantAllocation", "TenantAllocator",
    "TenantRegistry", "TenantShare", "philly_requests", "plan_allocation",
    "profile_class", "profiles_from_requests", "run_replay",
]
