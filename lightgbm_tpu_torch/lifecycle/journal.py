"""Atomic rollout journal: the crash-safe source of truth for one
guarded promotion (counterpart of ``lightgbm_tpu/lifecycle/journal.py``;
the record format is the JAX package's, so journals read both ways).

Every phase transition of a rollout (verify -> quarantine -> shadow ->
ramp[i] -> cutover -> promoted / rolled_back) is journaled BEFORE the
transition's side effects run, through ``utils.file_io.write_atomic``
(temp sibling + ``os.replace``; the ``open_file`` scheme seam, so a
``chaos://`` journal exercises the crash-mid-write shape).  A restarted
pipeline reads the journal and either finishes the bookkeeping of a
cutover that already committed or rolls back — it can NEVER
double-promote, because the cutover intent (phase ``cutover`` +
candidate digest) is durable before the serving pointer flips and the
fleet's live digest is the commit witness (rollout.py ``resume``).

One journal file per rollout directory; a finished record (``promoted``
/ ``rolled_back``) is left in place as the postmortem record until the
next rollout overwrites it.
"""

from __future__ import annotations

import json
import time
from typing import Optional

from ..utils.file_io import exists, open_file, write_atomic

FORMAT = "lgbt-rollout/1"
JOURNAL_NAME = "rollout.json"

# phase order is load-bearing for resume(): everything before "cutover"
# is side-effect-free on the LIVE serving pointer (the canary is a
# separate fleet entry), so a crash there always rolls back cleanly
PHASES = ("verify", "quarantine", "shadow", "ramp", "cutover")
TERMINAL = ("promoted", "rolled_back")


class RolloutJournalError(RuntimeError):
    """The journal exists but cannot be trusted (unreadable / unknown
    format) — the pipeline refuses to guess rollout state."""


class RolloutJournal:
    """Crash-safe state record for one promotion pipeline."""

    def __init__(self, path: str):
        self.path = str(path)

    # ------------------------------------------------------------- read

    def load(self) -> Optional[dict]:
        """The current record, or None when no rollout was ever
        journaled here.  An unreadable or foreign-format file raises
        ``RolloutJournalError`` — resuming from a corrupt journal must be
        an explicit operator decision, never a silent guess."""
        if not exists(self.path):
            return None
        try:
            with open_file(self.path, "r") as fh:
                rec = json.loads(fh.read())
        except Exception as e:
            raise RolloutJournalError(
                f"rollout journal {self.path}: unreadable ({e})") from e
        if rec.get("format") != FORMAT:
            raise RolloutJournalError(
                f"rollout journal {self.path}: format "
                f"{rec.get('format')!r} != {FORMAT!r}")
        return rec

    def in_progress(self) -> Optional[dict]:
        rec = self.load()
        if rec is not None and rec.get("status") == "in_progress":
            return rec
        return None

    # ------------------------------------------------------------ write

    def _write(self, rec: dict) -> dict:
        rec = dict(rec, format=FORMAT, updated_unix=time.time())
        write_atomic(self.path, json.dumps(rec, indent=1, sort_keys=True))
        return rec

    def begin(self, live_name: str, candidate_bundle: str,
              candidate_digest: str, previous_bundle: Optional[str],
              previous_digest: str, ramp) -> dict:
        """Open a new rollout record (status ``in_progress``, phase
        ``verify``).  Refuses while another rollout is still in progress
        — two concurrent pipelines over one journal would race the
        serving pointer."""
        stale = self.in_progress()
        if stale is not None:
            raise RolloutJournalError(
                f"rollout journal {self.path}: a rollout of candidate "
                f"{stale.get('candidate_bundle')!r} is still in_progress "
                f"(phase {stale.get('phase')!r}); resume() or roll it "
                "back first")
        return self._write({
            "status": "in_progress", "phase": "verify", "ramp_step": -1,
            "live_name": live_name,
            "candidate_bundle": candidate_bundle,
            "candidate_digest": candidate_digest,
            "previous_bundle": previous_bundle,
            "previous_digest": previous_digest,
            "ramp": list(ramp), "gate": None, "evidence": None,
        })

    def phase(self, rec: dict, phase: str, ramp_step: int = -1) -> dict:
        if phase not in PHASES:
            raise ValueError(f"unknown rollout phase {phase!r}")
        return self._write(dict(rec, phase=phase, ramp_step=ramp_step))

    def promoted(self, rec: dict) -> dict:
        return self._write(dict(rec, status="promoted", phase="cutover"))

    def rolled_back(self, rec: dict, gate: str, evidence: dict) -> dict:
        return self._write(dict(rec, status="rolled_back", gate=gate,
                                evidence=evidence))
