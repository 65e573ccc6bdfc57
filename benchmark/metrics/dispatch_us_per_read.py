"""The port's `dispatch` stage (utils.stats: thread-seconds, summed over
the threads that run it) over the traced window's reads, in us a read."""


def read(rec):
    s = rec["stage_s"].get("dispatch")
    if s is None or not rec["window_reads"]:
        return None
    return 1e6 * s / rec["window_reads"]
