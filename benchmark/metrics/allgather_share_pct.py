"""The share of the group's time that its ranks spent in the all-gathers:
the seconds of the port's `allgather_decisions`, `allgather_tags` and
`allgather_manifest` spans (utils.stats, in parallel/distributed.py; each
holds the wait for the slowest rank), summed over the ranks of the
record's `ranks`, over P times the window's seconds, in %. It moves
`setup_s`, the cell's end-to-end metric that holds one whole group pass
(the warm pass), which the all-gathers set as they set every window pass.
Nothing where a rank lacks one of the spans (one process, or a port
without them) or the window has no reads."""

SPANS = ("allgather_decisions", "allgather_tags", "allgather_manifest")


def read(rec):
    ranks = rec.get("ranks") or []
    if not ranks or not rec["window_reads"] or rec["window_s"] <= 0:
        return None
    total = 0.0
    for r in ranks:
        for name in SPANS:
            s = r["stage_s"].get(name)
            if s is None:
                return None
            total += s
    return 100.0 * total / (len(ranks) * rec["window_s"])
