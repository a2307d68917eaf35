"""Serving substrate: batched LM generation (``ServeEngine``),
predicate-based request routing (the paper's engine applied to request
metadata) and the read-only observability HTTP endpoints (:mod:`.httpd`)."""
from .engine import RequestRouter, ServeEngine
from .httpd import ObservabilityServer

__all__ = ["RequestRouter", "ServeEngine", "ObservabilityServer"]
