"""Serving-path errors (counterpart of ``lightgbm_tpu/serving/errors.py``).

All inherit LightGBMError so callers' except clauses still catch them,
with distinct types for the three rejection reasons the
backpressure/deadline/shutdown semantics need and for a hot-swap
candidate held back by its probe; ``ModelNotFound`` and ``DeviceLost``
are the serving fleet's (``fleet/``).
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


class SwapQuarantined(ServingError):
    """A hot-swap candidate failed its probe batch before promotion (it
    raised, or gave non-finite output) and was NOT promoted; serving goes
    on with the previous model (``registry.ModelRegistry._probe``)."""


class LowPrecisionQuarantined(SwapQuarantined):
    """A bf16/int8 candidate's accuracy delta on the probe batch exceeded
    its declared ``accuracy_budget`` and it was NOT promoted
    (``registry.ModelRegistry._probe_lowprec``).  A subclass of
    SwapQuarantined, so quarantine handlers catch it too."""


class ModelNotFound(ServingError):
    """A fleet request named a model the registry does not hold
    (``fleet/registry.py``): a routing error, not an overload."""


class DeviceLost(ServingError):
    """A serving device of a pod fleet is gone (vanished, wedged or
    declared dead by its health).  Retriable by construction: replicas
    serve bit-identical scores, so the router re-dispatches the request
    to a surviving replica instead of surfacing this to the caller
    (``fleet/router.py``)."""
