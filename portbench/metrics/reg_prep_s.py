"""``reg_prep_s``: the mean wall of the span ``reg_prep`` over the traced
window's passes, in seconds.  The span is stage 3's host preparation: the
completions resampled and, when registering, the pose inputs' voxel
downsamples; it ends in a device synchronisation.  Nothing where no pass
has the span (a program without it)."""


def read(record):
    walls = [p["timings"]["reg_prep"] for p in record["passes"]
             if p.get("timings") and "reg_prep" in p["timings"]]
    return sum(walls) / len(walls) if walls else None
