"""The run / throttle / pause control of co-resident training
(counterpart of ``lightgbm_tpu/coresident/control.py``).

``PauseControl`` is the small thread-safe state machine that
``engine.train(pause_control=...)`` consults at every chunk boundary:

- **run**: train at the negotiated chunk cap;
- **throttle**: keep training, but halve the chunk cap and sleep a
  short host-side delay a consult, so that the serving batcher has the
  card between chunks (the first tier of a brownout);
- **pause**: the engine saves its whole training state to a checkpoint
  bundle and raises ``engine.TrainingPaused`` (the second tier: serving
  keeps the whole card until the breach clears, then the scheduler
  resumes byte-identically from the bundle).

Who flips the states is ``scheduler.py``'s business (it reacts to the
watchdog's breaches); this module is mechanism only, so tests drive it
directly.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional


class PauseControl:
    """Thread-safe run/throttle/pause verdict the engine polls.

    ``consult(i)`` is called by ``engine.train`` at every chunk
    boundary: it first runs the ``on_step`` hook (the scheduler's
    sweep), then applies the current verdict — sleeping
    ``throttle_delay_s`` when throttled, returning ``"pause"`` when a
    pause is ordered.  ``chunk_cap()`` is the engine's macro-chunk
    ceiling under the current state (halved while throttled).
    """

    RUN = "run"
    THROTTLE = "throttle"
    PAUSE = "pause"

    def __init__(self, base_chunk_cap: int = 32,
                 throttle_delay_s: float = 0.0,
                 on_step: Optional[Callable[[int], None]] = None):
        self._on_step = on_step
        self._lock = threading.Lock()
        self._state = self.RUN                      # guarded-by: _lock
        self._base_cap = max(int(base_chunk_cap), 1)  # guarded-by: _lock
        self._throttle_delay_s = float(throttle_delay_s)  # guarded-by: _lock
        self._consults = 0                          # guarded-by: _lock

    # ------------------------------------------------------------ verdicts

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    @property
    def consults(self) -> int:
        with self._lock:
            return self._consults

    def chunk_cap(self) -> int:
        """The engine's macro-chunk ceiling under the current state."""
        with self._lock:
            if self._state == self.THROTTLE:
                return max(self._base_cap // 2, 1)
            return self._base_cap

    def set_base_cap(self, cap: int) -> None:
        """Install the negotiated chunk cap (scheduler: p99 headroom)."""
        with self._lock:
            self._base_cap = max(int(cap), 1)

    def set_throttle_delay(self, delay_s: float) -> None:
        with self._lock:
            self._throttle_delay_s = max(float(delay_s), 0.0)

    def consult(self, iteration: int) -> str:
        """The engine's per-chunk check-in; returns "run" or "pause"."""
        hook = self._on_step
        if hook is not None:
            try:
                hook(iteration)
            except Exception:  # noqa: BLE001 - a broken sweep must not
                pass           # kill training
        with self._lock:
            self._consults += 1
            state = self._state
            delay = self._throttle_delay_s
        if state == self.PAUSE:
            return "pause"
        if state == self.THROTTLE and delay > 0:
            # yield the host (and with it the device dispatch queue) to
            # the serving plane between chunks
            time.sleep(delay)
        return "run"

    # ------------------------------------------------------- transitions

    def request_throttle(self) -> bool:
        """RUN -> THROTTLE; returns whether the state changed."""
        with self._lock:
            if self._state == self.RUN:
                self._state = self.THROTTLE
                return True
            return False

    def request_pause(self) -> bool:
        """Any state -> PAUSE; returns whether the state changed."""
        with self._lock:
            if self._state != self.PAUSE:
                self._state = self.PAUSE
                return True
            return False

    def request_run(self) -> bool:
        """Any state -> RUN (recovery); returns whether it changed."""
        with self._lock:
            if self._state != self.RUN:
                self._state = self.RUN
                return True
            return False
