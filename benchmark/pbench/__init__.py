"""The benchmark harness of pomfret_tpu_torch: the maker, the count of the
work, the reference's driver and the comparison, the trace readers and
the peaks (run by benchmark/run.py)."""
