"""Checkpoint/resume for long Monte-Carlo sweeps.

A copy of polar_codes_tpu/sim/checkpoint.py, in the same .npz format (one
uint8 array "state" holding the JSON of every job's counters), so a
checkpoint written by either package resumes in the other. After every
chunk the accumulated counters are written next to the output CSV; a
restarted sweep resumes at the first unfinished (job, chunk) pair with the
same random streams (a chunk's generator is seeded from the job's seed and
the chunk index, sim/montecarlo.py).
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Dict, Optional

import numpy as np


class SweepCheckpoint:
    """Counter state for a list of (job-id -> accumulated stats)."""

    def __init__(self, path: str):
        self.path = path
        self.state: Dict[str, dict] = {}
        if os.path.exists(path):
            with np.load(path, allow_pickle=False) as z:
                blob = bytes(z["state"].tobytes())
            self.state = json.loads(blob.decode())

    def job_state(self, job_id: str) -> dict:
        return self.state.get(
            job_id,
            {"chunks_done": 0, "runs": 0, "biterrors": 0, "errors": 0,
             "reported": 0, "times": []},
        )

    def update(self, job_id: str, state: dict):
        self.state[job_id] = state
        self._write()

    def mark_complete(self, job_id: str, result: dict):
        st = self.job_state(job_id)
        st["complete"] = True
        st["result"] = result
        self.state[job_id] = st
        self._write()

    def completed(self, job_id: str) -> Optional[dict]:
        st = self.state.get(job_id)
        if st and st.get("complete"):
            return st["result"]
        return None

    def _write(self):
        blob = np.frombuffer(
            json.dumps(self.state).encode(), dtype=np.uint8
        )
        fd, tmp = tempfile.mkstemp(
            dir=os.path.dirname(os.path.abspath(self.path)) or "."
        )
        os.close(fd)
        np.savez(tmp, state=blob)
        os.replace(tmp + ".npz", self.path)
        if os.path.exists(tmp):
            os.remove(tmp)
