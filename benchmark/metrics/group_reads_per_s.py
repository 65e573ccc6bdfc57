"""The group's rate, read per layer: the traced window's reads over its
seconds, where a pass of the group ends with its last rank (run.py times
each pass until every rank has answered). It moves `setup_s`, the cell's
end-to-end metric that holds one whole group pass (the warm pass), which
the ranks' scans and the all-gathers' wait for the slowest rank set as
they set every window pass. Nothing where the window completed no pass."""


def read(rec):
    if not rec["window_reads"] or rec["window_s"] <= 0:
        return None
    return rec["window_reads"] / rec["window_s"]
