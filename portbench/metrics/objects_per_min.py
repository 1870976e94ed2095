"""``objects_per_min``: every object of every pass in the window over the
whole time of those passes (host clock around each ``run_batched`` call,
which ends in a device synchronisation), per minute."""


def read(record):
    t = sum(p["seconds"] for p in record["passes"])
    return 60.0 * record["objects"] * len(record["passes"]) / t
