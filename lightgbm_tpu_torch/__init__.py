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
(imported only where scikit-learn is installed).  Configurations
outside the port raise ``NotImplementedError``.
"""

from .basic import Booster
from .callback import early_stopping, log_evaluation, record_evaluation
from .dataset import Dataset
from .engine import CVBooster, cv, train
from .utils.log import LightGBMError

__version__ = "0.2.0"


def serve(model, config=None, device=None, **overrides):
    """A ``serving.Server`` over a Booster or a model-file path (loaded
    on ``device``, the CUDA card by default)."""
    from .serving import Server
    if not isinstance(model, Booster):
        model = Booster(model_file=str(model), device=device)
    return Server(model, config=config, **overrides)


__all__ = ["Booster", "CVBooster", "Dataset", "LightGBMError", "cv",
           "early_stopping", "log_evaluation", "record_evaluation", "serve",
           "train", "__version__"]
