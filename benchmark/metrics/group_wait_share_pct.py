"""The share of the traced window in which the port's main thread waited
for its next loaded group of gaps: the seconds of its `group_wait` stage
(utils.stats, in kernels/engine_torch.run_jobs_batched) over the window's
seconds, in %. Nothing where the window has no reads or the port has no
such stage."""


def read(rec):
    s = rec["stage_s"].get("group_wait")
    if s is None or not rec["window_reads"]:
        return None
    return 100.0 * s / rec["window_s"]
