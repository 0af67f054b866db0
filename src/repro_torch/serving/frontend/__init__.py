"""Async multi-tenant serving front-end (futures, coalescing, QoS).

    from repro_torch.serving import FrontEnd, FrontEndSpec, TenantSpec

    eng = ServeEngine(CachingBackend(LocalBackend(fi)), opts)
    fe = FrontEnd(eng, FrontEndSpec(
        coalesce_ms=5.0,
        tenants={"hot": TenantSpec(rate_qps=500, weight=1.0),
                 "gold": TenantSpec(weight=4.0)}))
    resp = await fe.submit(q, flt, tenant="gold", deadline_ms=50)

See ``frontend.FrontEnd`` for the full semantics (coalescing, admission
control / load shedding with structured ``Overloaded``, weighted fair
dequeue, tenant-scoped caches).
"""
from ...core.options import FrontEndSpec, TenantSpec
from .admission import TenantState, TokenBucket, WeightedFairScheduler
from .frontend import FrontEnd, Overloaded

__all__ = ["FrontEnd", "FrontEndSpec", "Overloaded", "TenantSpec",
           "TenantState", "TokenBucket", "WeightedFairScheduler"]
