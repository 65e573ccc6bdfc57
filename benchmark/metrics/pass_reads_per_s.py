"""The traced window's reads over its seconds, as window_reads_per_s
counts them: the rate read per layer in a cell whose rate spreads too
widely between runs for any bound that an end-to-end metric may have.
Nothing where the window completed no pass."""


def read(rec):
    if not rec["window_reads"] or rec["window_s"] <= 0:
        return None
    return rec["window_reads"] / rec["window_s"]
