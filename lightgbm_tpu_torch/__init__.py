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
(``native/``) where it builds; the plotting functions need matplotlib
(and graphviz for trees) only when called.  Configurations outside the
port raise ``NotImplementedError``.
"""

from .basic import Booster
from .callback import early_stopping, log_evaluation, record_evaluation
from .dataset import Dataset
from .engine import CVBooster, cv, train
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


__all__ = ["Booster", "CVBooster", "Dataset", "LightGBMError", "cv",
           "create_tree_digraph", "early_stopping", "log_evaluation",
           "plot_importance", "plot_metric", "plot_split_value_histogram",
           "plot_tree", "record_evaluation", "serve", "train",
           "__version__"]
