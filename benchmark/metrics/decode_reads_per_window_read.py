"""The chromosome decode's amplification: the records the port's
chromosome sources parsed in the traced window, kept or not (its counter
source_records, utils.stats, zeroed with the stage seconds as the window
starts), over the window's reads, in reads a read. Nothing where the
window has no reads or the port keeps no such counter."""
import sys


def read(rec):
    stats = sys.modules.get("pomfret_tpu_torch.utils.stats")
    n = getattr(stats, "COUNTERS", {}).get("source_records")
    if n is None or not rec["window_reads"]:
        return None
    return n / rec["window_reads"]
