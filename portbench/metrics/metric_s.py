"""``metric_s``: the mean wall of ``run_batched``'s ``metric`` mark over the
traced window's passes (each mark ends in a device synchronisation), in
seconds; nothing without timed passes."""


def read(record):
    walls = [p["timings"]["metric"] for p in record["passes"]
             if p.get("timings") and "metric" in p["timings"]]
    return sum(walls) / len(walls) if walls else None
