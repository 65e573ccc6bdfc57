"""The loop kernel's share of its roofline: the least time its bytes (the
benchmark's count from each launch's inputs, pbench/roofline.py) could
take at the card's published memory bandwidth, over the device time of its
launches in the trace, in %. Nothing where no launch ran."""


def read(rec):
    lk = rec["loop_kernel"]
    if not lk["launches"] or lk["device_s"] <= 0:
        return None
    return 100.0 * lk["bytes"] / rec["hbm_bytes_per_s"] / lk["device_s"]
