"""``reg_fusion_s``: the mean wall of the span ``reg_fusion`` over the
traced window's passes, in seconds.  The span is stage 3's fusion: dedup,
one FPS launch over the batch (K2), the outlier masks; it ends in a device
synchronisation.  Nothing where no pass has the span (a program without
it)."""


def read(record):
    walls = [p["timings"]["reg_fusion"] for p in record["passes"]
             if p.get("timings") and "reg_fusion" in p["timings"]]
    return sum(walls) / len(walls) if walls else None
