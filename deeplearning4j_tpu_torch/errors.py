"""Typed failures of the port: the serving tier's, the prefetch
iterator's, the guarded train loop's and the checkpoint reader's.

All of them subclass ``RuntimeError``, so ``except RuntimeError`` call
sites keep working. Each concrete serving class declares its wire semantics as
class attributes: ``http_status`` (the status an HTTP front end answers
with) and ``retryable`` (whether the caller may resubmit the same
request).
"""

from __future__ import annotations

__all__ = ["CheckpointCorruptError", "PrefetchWorkerDiedError",
           "ServingError", "ServeQueueFullError", "ServeStoppedError",
           "ServeDeadlineError", "ServeReplicaDeadError",
           "TrainingDivergedError"]


class TrainingDivergedError(RuntimeError):
    """Raised by the non-finite guard after ``DL4J_TORCH_NANGUARD_PATIENCE``
    consecutive dispatches (a step, or a fused group) each held a step
    whose loss or gradients were not finite and were reverted, so going on
    cannot make progress. The model (its last good parameters: reverted
    steps never touched them) is written to ``DL4J_TORCH_NANGUARD_CKPT``
    before this raises; the message names the path."""


class CheckpointCorruptError(RuntimeError):
    """A checkpoint failed its integrity check on restore: the archive is
    truncated, a payload's CRC-32 disagrees with the manifest written
    beside it, or a required entry is missing. Raised instead of the
    underlying zip, numpy or json error, so that a caller can tell a torn
    or bit-rotted file (fall back to an older checkpoint) from a
    programming error. The atomic write protocol (``utils/atomic_io.py``)
    leaves this reachable only through storage damage or a writer that
    did not use it, never through a crash during a save."""


class PrefetchWorkerDiedError(RuntimeError):
    """The async prefetch worker thread died without emitting its
    end-of-stream sentinel (a hard crash, or the ``kill-worker`` fault).
    The consumer's bounded ``queue.get`` loop sees the dead thread and
    raises this, naming the worker, instead of blocking forever."""


class ServingError(RuntimeError):
    """Base class for serving-tier failures (``serving/``)."""

    http_status = 500
    retryable = False


class ServeQueueFullError(ServingError):
    """``submit()`` found the request queue at its
    ``DL4J_TORCH_SERVE_QUEUE`` capacity: the caller is backpressured and
    should retry later. Nothing was admitted, so it is retryable."""

    http_status = 429
    retryable = True


class ServeStoppedError(ServingError):
    """The front end was stopped (or is draining) while this request was
    queued, or before it was submitted; the request was not served.
    Retryable against another replica or after a restart."""

    http_status = 503
    retryable = True


class ServeDeadlineError(ServingError):
    """The request's deadline expired while it was still queued; it was
    swept before dispatch and cost no device work. Not retryable as is:
    the same budget would expire the same way."""

    http_status = 504
    retryable = False


class ServeReplicaDeadError(ServingError):
    """The replica serving this admitted request died before completing
    it. A router moves a dead replica's not-yet-admitted requests to the
    survivors; an admitted one may already have produced tokens, so under
    at-most-once delivery it fails with this error instead of being run
    again. A fresh submit (a new request) is safe, so it is retryable."""

    http_status = 502
    retryable = True
