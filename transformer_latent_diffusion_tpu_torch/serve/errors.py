"""Typed serving errors shared by the frontends."""


class QueueFull(RuntimeError):
    """The request queue is at capacity. Raised by the micro-batcher, which
    is not ported yet (ROADMAP item 10); frontends answer it with a 503
    and a Retry-After header."""
