"""``reg_pose_s``: the mean wall of ``batched_reg``'s ``reg_pose`` mark
(the batched pose optimisation) over the traced window's passes, in
seconds; nothing where no object was registered (the aligned path)."""


def read(record):
    walls = [p["timings"]["reg_pose"] for p in record["passes"]
             if p.get("timings") and "reg_pose" in p["timings"]]
    return sum(walls) / len(walls) if walls else None
