"""Exception types the port raises (copies of ``ray_tpu/exceptions.py``'s
``RayTpuError`` and ``ServeOverloadedError``; the port imports nothing
from the JAX package)."""

from __future__ import annotations


class RayTpuError(Exception):
    """Base class for all framework errors."""


class ServeOverloadedError(RayTpuError):
    """Serve shed the request at admission instead of queueing it.

    A replica's queue-depth cap was exceeded, so the request was refused
    at the door: the in-flight decode batch keeps its cadence instead of
    collapsing under a backlog it can never drain. ``retry_after_s`` is
    the server's backoff hint.
    """

    def __init__(self, reason: str = "serve overloaded",
                 retry_after_s: float = 1.0):
        self.reason = reason
        self.retry_after_s = float(retry_after_s)
        super().__init__(reason)
