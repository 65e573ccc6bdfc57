"""Per-gap result manifests: checkpoint/resume + elastic recovery.

The reference has no checkpointing (SURVEY.md §5.4 — a crash loses the whole
run). Here every completed gap appends one JSON line
{ref, gap_i, start, end, decision, tags} to <prefix>.mp.manifest.jsonl;
`--resume` replays the manifest and recomputes only missing gaps. Appends are
atomic at line granularity, so a killed run resumes losslessly.
"""
from __future__ import annotations

import json
import os
import threading
from typing import Dict, Optional, Tuple

from ..utils.log import log_info


class ManifestWriter:
    def __init__(self, path: str, append: bool):
        self._path = path
        self._lock = threading.Lock()
        self._f = open(path, "a" if append else "w")

    def record(self, ref: str, gap_i: int, start: int, end: int,
               decision: int, tags: Optional[Dict[str, int]]) -> None:
        line = json.dumps({
            "ref": ref, "gap_i": gap_i, "start": start, "end": end,
            "decision": decision, "tags": tags or {},
        }, separators=(",", ":"))
        with self._lock:
            self._f.write(line + "\n")
            self._f.flush()
            os.fsync(self._f.fileno())

    def close(self) -> None:
        self._f.close()


def load_manifest(path: str) -> Dict[Tuple[str, int], dict]:
    """Returns {(ref, gap_i): entry} for completed gaps; tolerates a torn
    final line from a crashed run."""
    done: Dict[Tuple[str, int], dict] = {}
    if not os.path.exists(path):
        return done
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                e = json.loads(line)
            except json.JSONDecodeError:
                continue  # torn tail line
            done[(e["ref"], e["gap_i"])] = e
    if done:
        log_info("load_manifest", f"resuming: {len(done)} gaps already done in {path}")
    return done
