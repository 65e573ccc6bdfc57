"""The share of the group's time that its ranks spent scanning the whole
BAM for coverage: the seconds of the port's `coverage_scan` stage
(utils.stats, in the CLI's pipeline), summed over the ranks of the
record's `ranks`, over P times the window's seconds, in %. Every rank
scans on an empty spool, so the group pays P scans a pass. It moves
`setup_s`, the cell's end-to-end metric that holds one whole group pass
(the warm pass), which the scans set as they set every window pass.
Nothing where a rank lacks the stage or the window has no reads."""


def read(rec):
    ranks = rec.get("ranks") or []
    if not ranks or not rec["window_reads"] or rec["window_s"] <= 0:
        return None
    total = 0.0
    for r in ranks:
        s = r["stage_s"].get("coverage_scan")
        if s is None:
            return None
        total += s
    return 100.0 * total / (len(ranks) * rec["window_s"])
