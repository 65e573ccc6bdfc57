"""Per-gap result manifests: checkpoint/resume + elastic recovery.

The reference has no checkpointing (SURVEY.md §5.4 — a crash loses the whole
run). Here every completed gap appends one JSON line
{ref, gap_i, start, end, decision, tags} to <prefix>.mp.manifest.jsonl;
`--resume` replays the manifest and recomputes only missing gaps. Appends are
atomic at line granularity, so a killed run resumes losslessly.

With several processes (a deliberate difference from the JAX package,
which has every process open the one manifest with "w"), each process
appends its own gaps' lines to a part of its own, <manifest>.rank<r>
(rank_part), while the run works; once the decisions are gathered,
process 0 writes the whole manifest from every process's lines, in
global gap order, and removes the parts (write_merged). A resume at any
number of processes reads the manifest and every part left beside it
(load_manifest_parts).
"""
from __future__ import annotations

import glob
import json
import os
import re
import threading
from typing import Dict, Iterable, List, Optional, Tuple

from ..utils.log import log_info


def manifest_line(ref: str, gap_i: int, start: int, end: int, decision: int,
                  tags: Optional[Dict[str, int]]) -> str:
    """One gap's record as its manifest line (no newline)."""
    return json.dumps({
        "ref": ref, "gap_i": gap_i, "start": start, "end": end,
        "decision": decision, "tags": tags or {},
    }, separators=(",", ":"))


def entry_line(e: dict) -> str:
    """The manifest line of a record read back by load_manifest."""
    return manifest_line(e["ref"], e["gap_i"], e["start"], e["end"],
                         e["decision"], e["tags"])


class ManifestWriter:
    """Appends each record to `path` as it comes (flushed and synced);
    with `keep`, also keeps each line in `kept` under its (ref, gap_i) (a
    process's part, gathered once the run is done)."""

    def __init__(self, path: str, append: bool, keep: bool = False):
        self._path = path
        self._lock = threading.Lock()
        self._f = open(path, "a" if append else "w")
        self.kept: Optional[Dict[Tuple[str, int], str]] = {} if keep else None

    def record(self, ref: str, gap_i: int, start: int, end: int,
               decision: int, tags: Optional[Dict[str, int]]) -> None:
        line = manifest_line(ref, gap_i, start, end, decision, tags)
        with self._lock:
            self._f.write(line + "\n")
            self._f.flush()
            os.fsync(self._f.fileno())
            if self.kept is not None:
                self.kept[(ref, gap_i)] = line

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


def rank_part(path: str, rank: int) -> str:
    """The part of manifest `path` that process `rank` writes while a run
    of several processes works."""
    return f"{path}.rank{rank}"


def rank_parts(path: str) -> List[Tuple[int, str]]:
    """The parts of manifest `path` on disk as (rank, path), by rank,
    whatever number of processes wrote them."""
    found = []
    for p in glob.glob(glob.escape(path) + ".rank*"):
        m = re.fullmatch(r"\.rank(\d+)", p[len(path):])
        if m:
            found.append((int(m.group(1)), p))
    return sorted(found)


def load_manifest_parts(path: str) -> Dict[Tuple[str, int], dict]:
    """load_manifest of the manifest and of every part beside it, the
    manifest first, then the parts by rank (a gap in several keeps the
    last one read: a gap's record is the same in each)."""
    done = load_manifest(path)
    for _, p in rank_parts(path):
        done.update(load_manifest(p))
    return done


def open_manifest(path: str, resume: bool, n_procs: int = 1, rank: int = 0
                  ) -> Tuple[Optional[Dict[Tuple[str, int], dict]],
                             ManifestWriter]:
    """The records a resumed run finds done (None for a fresh run) and the
    writer of this process's records. One process appends to the manifest
    `path` itself (a fresh run truncates it). Of several, each appends to
    its part and keeps its lines for the merge; a resume reads the
    manifest and every part left, and a fresh run's process 0 removes the
    manifest and the parts no process of this run will write over."""
    if n_procs == 1:
        return (load_manifest(path) if resume else None,
                ManifestWriter(path, append=resume))
    done = None
    if resume:
        done = load_manifest_parts(path)
    elif rank == 0:
        if os.path.exists(path):
            os.remove(path)
        for r, p in rank_parts(path):
            if r >= n_procs:
                os.remove(p)
    return done, ManifestWriter(rank_part(path, rank), append=resume,
                                keep=True)


def write_merged(path: str, lines: Iterable[str]) -> int:
    """Write the manifest `path` whole from `lines` (already in their
    order) through a temporary file put in place by os.replace, then remove
    every part beside it. Returns the lines written."""
    tmp = f"{path}.tmp{os.getpid()}"
    n = 0
    with open(tmp, "w") as f:
        for line in lines:
            f.write(line + "\n")
            n += 1
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    for _, p in rank_parts(path):
        os.remove(p)
    return n
