"""Serving-path errors (counterpart of ``lightgbm_tpu/serving/errors.py``).

All inherit LightGBMError so callers' except clauses still catch them,
with distinct types for the three rejection reasons the
backpressure/deadline/shutdown semantics need.
"""

from ..utils.log import LightGBMError


class ServingError(LightGBMError):
    """Base class for serving-subsystem failures."""


class QueueFull(ServingError):
    """Backpressure: admitting the request would exceed max_queue_rows.

    Raised AT SUBMIT (reject-with-error) rather than queueing into
    unbounded latency; the caller should shed or retry with backoff.
    """


class DeadlineExceeded(ServingError):
    """The request's deadline expired while it waited in the queue."""


class ServerClosed(ServingError):
    """Submit after close(), or pending work failed by close(drain=False)."""
