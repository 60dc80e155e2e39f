"""The model axis: B boosters trained as the lanes of group programs
(counterpart of ``lightgbm_tpu/multi/``).

Cross-validation folds, hyperparameter sweeps and per-segment model
families train together: ``train_many`` groups structurally compatible
boosters (``group``), and each group's rounds run as one captured CUDA
graph replayed once a round, every lane's round body in turn
(``batch``, ``grower_rounds.RoundGroup``).  Each extracted booster is
byte-identical in model text to the same config trained alone;
``ops.planner.plan_model_batch`` elects how many lanes a group carries
under the card's memory; ``engine.cv(fused=True)`` steps the folds the
same way (``CVStepper``).
"""

from .batch import BatchedChunkProgram
from .driver import CVStepper, expand_param_grid, train_many
from .group import MultiGroup, group_boosters, structural_key

__all__ = [
    "BatchedChunkProgram", "CVStepper", "MultiGroup",
    "expand_param_grid", "group_boosters", "structural_key",
    "train_many",
]
