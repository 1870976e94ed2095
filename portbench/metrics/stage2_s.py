"""``stage2_s``: the mean wall of ``run_batched``'s ``stage2`` mark over the
traced window's passes (each mark ends in a device synchronisation), in
seconds; nothing without timed passes."""


def read(record):
    walls = [p["timings"]["stage2"] for p in record["passes"]
             if p.get("timings") and "stage2" in p["timings"]]
    return sum(walls) / len(walls) if walls else None
