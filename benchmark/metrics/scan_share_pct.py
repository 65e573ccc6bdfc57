"""The coverage scan's share of the traced window: the seconds the port's
`coverage_scan` stage took (utils.stats, in the CLI's pipeline) over the
window's seconds, in %."""


def read(rec):
    s = rec["stage_s"].get("coverage_scan")
    return None if s is None else 100.0 * s / rec["window_s"]
