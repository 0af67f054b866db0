"""The serving stack of the port: ``ServeEngine`` (request queue, batch
assembly on a deadline, routing, latency accounting, live mutations), its
background ``MergeController``, and the asyncio multi-tenant ``FrontEnd``
over it (admission, weighted fair dequeue, coalescing)."""
from ..core.options import FrontEndSpec, TenantSpec
from .engine import Request, Response, ServeEngine
from .frontend import FrontEnd, Overloaded
from .merge import MergeController

__all__ = ["FrontEnd", "FrontEndSpec", "MergeController", "Overloaded",
           "Request", "Response", "ServeEngine", "TenantSpec"]
