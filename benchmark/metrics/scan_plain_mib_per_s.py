"""The coverage scan's rate: the plain bytes the port's coverage scan
inflated in the traced window (its counter scan_plain_bytes, utils.stats)
over the seconds of its `coverage_scan` stage, in MiB/s. Nothing where the
window has no reads, or the port keeps no such counter or stage."""
import sys


def read(rec):
    stats = sys.modules.get("pomfret_tpu_torch.utils.stats")
    n = getattr(stats, "COUNTERS", {}).get("scan_plain_bytes")
    s = rec["stage_s"].get("coverage_scan")
    if n is None or not s or not rec["window_reads"]:
        return None
    return n / 2 ** 20 / s
