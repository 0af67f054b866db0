"""The serving stack of the port: ``ServeEngine`` (request queue, batch
assembly on a deadline, routing, latency accounting, live mutations) and
its background ``MergeController``."""
from .engine import Request, Response, ServeEngine
from .merge import MergeController

__all__ = ["MergeController", "Request", "Response", "ServeEngine"]
