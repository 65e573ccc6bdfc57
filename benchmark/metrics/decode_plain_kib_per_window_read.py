"""The chromosome decode's inflate a read: the plain bytes the port's
chromosome sources inflated in the traced window (its counter
source_plain_bytes, utils.stats, zeroed with the stage seconds as the
window starts), in KiB, over the window's reads. Nothing where the window
has no reads or the port keeps no such counter."""
import sys


def read(rec):
    stats = sys.modules.get("pomfret_tpu_torch.utils.stats")
    n = getattr(stats, "COUNTERS", {}).get("source_plain_bytes")
    if n is None or not rec["window_reads"]:
        return None
    return n / 1024 / rec["window_reads"]
