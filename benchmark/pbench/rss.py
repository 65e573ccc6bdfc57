"""A process's peak resident set, by the port's rule (frozen copies of
pomfret_tpu_torch/testing.py: proc_status_mib :923, _inherited_peak_mib
:934, peak_rss_mib :950, RssTimeline :600, cut to its peak).

VmHWM where /proc/self/status has it. Where it has none (the card host's
kernel reports VmSize, VmRSS and VmData only), ru_maxrss, but only where
it stands above the peak this process inherited (a process started by
fork and exec from a large one starts there at its parent's peak). Where
neither can tell, the largest VmRSS that a sampler read every 0.1 s.
Import this module first: the inherited peak is read at its import.
"""
from __future__ import annotations

import resource
import threading
from typing import Optional


def proc_status_mib(field: str, status: str = "/proc/self/status") -> float:
    """A memory field of `status` (VmRSS: the resident set now; VmHWM: its
    peak), MiB. Raises where the file or the field is missing."""
    with open(status) as f:
        for line in f:
            if line.startswith(field + ":"):
                return int(line.split()[1]) / 1024
    raise RuntimeError(f"{status} has no {field}")


def _inherited_peak_mib() -> float:
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
    try:
        rss = proc_status_mib("VmRSS")
    except (OSError, RuntimeError):
        return peak
    return peak if peak > rss + 64 else 0.0


INHERITED_PEAK_MIB = _inherited_peak_mib()


def peak_rss_mib() -> Optional[float]:
    """VmHWM, else ru_maxrss above the inherited peak, else None."""
    try:
        return proc_status_mib("VmHWM")
    except (OSError, RuntimeError):
        pass
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
    return peak if peak > INHERITED_PEAK_MIB else None


class RssSampler:
    """VmRSS read every `every` seconds on a thread of its own while the
    `with` block runs; peak_mib the largest read."""

    def __init__(self, every: float = 0.1):
        self.every, self.peak_mib = every, 0.0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _sample(self) -> None:
        try:
            self.peak_mib = max(self.peak_mib, proc_status_mib("VmRSS"))
        except (OSError, RuntimeError):
            pass

    def _run(self) -> None:
        while not self._stop.wait(self.every):
            self._sample()

    def __enter__(self):
        self._sample()
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self._sample()


def run_peak_mib(sampler: RssSampler) -> float:
    """The rule: peak_rss_mib(), where it can tell, else the sampler's."""
    peak = peak_rss_mib()
    return sampler.peak_mib if peak is None else peak
