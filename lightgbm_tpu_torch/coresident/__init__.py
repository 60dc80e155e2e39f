"""Co-resident train and serve on one card (counterpart of
``lightgbm_tpu/coresident/``).

Training refreshes run on the card that serves traffic, behind the
shared residency ledger (``ops.planner.ResidencyLedger``): training
plans against the bytes serving left, throttles and pauses through the
engine's ``pause_control`` when serving browns out, and shrinks its
world in the replan that drains serving's replicas when a device is
lost.

- :class:`Scheduler`: the brownout-aware refresh driver;
- :class:`PauseControl`: the run / throttle / pause state the engine
  consults;
- :class:`CoresidentConfig`: the brownout policy's knobs;
- :class:`CoresidencyInfeasible`: the refusal where training cannot fit.
"""

from .control import PauseControl
from .scheduler import CoresidencyInfeasible, CoresidentConfig, Scheduler

__all__ = ["Scheduler", "PauseControl", "CoresidentConfig",
           "CoresidencyInfeasible"]
