"""lightgbm_tpu_torch: the PyTorch/CUDA port of lightgbm_tpu.

It trains and serves models.  ``Dataset`` bins rows on the card
(``ops/csrc/ingest.cu``); ``train`` grows each tree with the
batched-frontier grower, whose histograms and split scans run in
hand-written CUDA kernels (``ops/csrc/fused.cu``); ``Booster.predict``
and ``serve`` route rows through the traversal kernel
(``ops/csrc/traverse.cu``).  On the CPU (``device="cpu"``) every kernel
runs as its plain PyTorch version.  ``Dataset`` takes dense, scipy
sparse and pandas input, text files and binary caches; ``cv``,
``Booster.refit``, continued training (``init_model``) and
``predict(pred_contrib=True)`` are here, and
``lightgbm_tpu_torch.sklearn`` holds the scikit-learn estimators
(imported only where scikit-learn is installed).  A ``serve`` server
hot-swaps models (``swap_model``) and serves bf16 or int8 twins
(``precision=``); the host paths run in the native C++ library
(``native/``) where it builds; ``Fleet`` serves many models behind one
front door that shares the card's memory, and ``PodFleet`` replicates
them over logical devices with failover (``fleet/``); the plotting
functions need matplotlib
(and graphviz for trees) only when called.  ``obs`` holds the tracer,
the process metrics registry, the flight recorder and the SLO watchdog,
under the JAX package's names and environment knobs, with device
profiling, pod telemetry and the bottleneck diagnosis; ``coresident``
runs training refreshes beside serving on one card under a shared
residency ledger.  ``train_many`` (``multi``) trains sweeps, cv folds
and model families as the lanes of group programs, each lane's model
its solo model byte for byte; ``lifecycle`` refreshes a deployed model
and promotes it through a guarded rollout (probe, shadow, canary ramp,
cutover) with rollback on any breached gate.  Configurations outside
the port raise ``NotImplementedError``.

The public names are the JAX package's (``lightgbm_tpu.__all__``); the
scikit-learn estimators are exported where scikit-learn is installed,
as the JAX package exports them (scikit-learn is imported when one of
them is first used).
"""

from . import compat
from .basic import Booster
from .callback import (EarlyStopException, early_stopping, log_evaluation,
                       print_evaluation, record_evaluation, reset_parameter)
from .config import Config
from .dataset import Dataset
from . import obs  # noqa: F401  (tracing, metrics, flight recorder, watchdog)
from . import serving  # noqa: F401  (in-process inference server)
from . import fleet  # noqa: F401  (multi-model serving fleet)
from . import coresident  # noqa: F401  (co-resident train+serve)
from .fleet import Fleet, PodFleet
from .engine import CVBooster, InitModelCompatibilityError, cv, train
from . import multi  # noqa: F401  (the model axis)
from .multi import expand_param_grid, train_many
from . import lifecycle  # noqa: F401  (guarded model lifecycle)
from .lifecycle import LifecycleController
from .plotting import (create_tree_digraph, plot_importance, plot_metric,
                       plot_split_value_histogram, plot_tree)
from .utils.log import LightGBMError

__version__ = "0.2.0"


def serve(model, config=None, device=None, **overrides):
    """A ``serving.Server`` over a Booster or a model-file path (loaded
    on ``device``, the CUDA card by default).  Keyword overrides fill a
    ``serving.ServingConfig`` (e.g. ``max_batch_rows=512``,
    ``precision="int8", accuracy_budget=1e-2``, ``max_programs=32``)."""
    from .serving import Server
    if not isinstance(model, Booster):
        model = Booster(model_file=str(model), device=device)
    return Server(model, config=config, **overrides)


__all__ = ["Booster", "CVBooster", "Config", "Dataset", "EarlyStopException",
           "Fleet", "InitModelCompatibilityError", "LifecycleController",
           "LightGBMError", "PodFleet", "coresident", "cv",
           "create_tree_digraph", "early_stopping", "expand_param_grid",
           "fleet", "lifecycle", "log_evaluation", "multi",
           "obs", "plot_importance", "plot_metric",
           "plot_split_value_histogram", "plot_tree", "print_evaluation",
           "record_evaluation", "reset_parameter", "serve", "serving",
           "train", "train_many", "__version__"]

_SKLEARN_NAMES = ("LGBMModel", "LGBMRegressor", "LGBMClassifier",
                  "LGBMRanker")
if compat.SKLEARN_INSTALLED:
    __all__ += list(_SKLEARN_NAMES)


def __getattr__(name):
    # the estimators import scikit-learn on first use, so that importing
    # the package (the CLI's start among them) does not pay for it
    if name in _SKLEARN_NAMES and compat.SKLEARN_INSTALLED:
        from . import sklearn as _sklearn
        return getattr(_sklearn, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
