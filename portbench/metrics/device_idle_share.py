"""``device_idle_share``: the share of the profiled pass's wall in which
no operation ran on the device, in percent (torch.profiler, kept in
memory: 100 × (1 − union of the device operations' intervals / the
pass's wall)); nothing without a profiled pass."""


def read(record):
    prof = record.get("profile") or {}
    if not prof.get("window_s"):
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
