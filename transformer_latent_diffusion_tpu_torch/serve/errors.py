"""Typed serving errors shared by the frontends."""


class QueueFull(RuntimeError):
    """The request queue is at capacity: raised by the micro-batcher
    (`serve/batcher.py`) for a request that would pass its
    `max_queue_imgs`; the WSGI frontend answers it with a 503 and a
    Retry-After header."""
