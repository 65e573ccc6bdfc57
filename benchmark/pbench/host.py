"""What each pass of a window cost this process, for the run's log: the
pass's wall, its user and system CPU seconds (all of the process's
threads), its page faults and the port's stage seconds that moved most. A
pass that is slow with as many CPU seconds waited; one that is slow with
more ran on slower or shared cores, or (system seconds, faults) paid the
kernel for its memory.
"""
from __future__ import annotations

import os
import resource
import time
from typing import Dict, List


class PassProbe:
    """mark() after each pass; lines() gives one line a pass."""

    def __init__(self, stage_seconds: Dict[str, float]):
        self.stages = stage_seconds
        self.rows: List[dict] = []
        self._last = self._read()

    def _read(self) -> dict:
        t = os.times()
        ru = resource.getrusage(resource.RUSAGE_SELF)
        return dict(wall=time.perf_counter(), user=t.user, sys=t.system,
                    faults=ru.ru_minflt + ru.ru_majflt,
                    stages=dict(self.stages))

    def mark(self) -> None:
        now, a = self._read(), self._last
        row = {k: now[k] - a[k] for k in ("wall", "user", "sys", "faults")}
        row["stages"] = {k: v - a["stages"].get(k, 0.0)
                         for k, v in now["stages"].items()}
        self.rows.append(row)
        self._last = now

    def lines(self) -> List[str]:
        out = []
        for i, r in enumerate(self.rows):
            top = sorted(r["stages"].items(), key=lambda kv: -kv[1])[:4]
            out.append(f"pass {i}: wall {r['wall']:.3f} s, cpu "
                       f"{r['user'] + r['sys']:.3f} s (sys {r['sys']:.3f}), "
                       f"{r['faults']} faults; " + " ".join(
                           f"{k} {v:.3f}" for k, v in top))
        return out
