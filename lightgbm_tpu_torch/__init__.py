"""lightgbm_tpu_torch: the PyTorch/CUDA port of lightgbm_tpu.

Today it serves models: a LightGBM-format model text loads into
``Booster``, whose ``predict`` and ``serve`` route rows through a
hand-written CUDA traversal kernel on an NVIDIA Hopper card
(``ops/csrc/traverse.cu``) and through its plain PyTorch version on the
CPU.  Training is not ported yet.
"""

from .basic import Booster
from .utils.log import LightGBMError

__version__ = "0.1.0"


def serve(model, config=None, device=None, **overrides):
    """A ``serving.Server`` over a Booster or a model-file path (loaded
    on ``device``, the CUDA card by default)."""
    from .serving import Server
    if not isinstance(model, Booster):
        model = Booster(model_file=str(model), device=device)
    return Server(model, config=config, **overrides)


__all__ = ["Booster", "LightGBMError", "serve", "__version__"]
