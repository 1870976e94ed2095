"""``pose_step_ms``: the wall of one pose-optimisation Adam step, in
milliseconds: per traced pass, 1000 × the summed walls of the spans
``pose_coarse`` and ``pose_fine`` (each ending in a device
synchronisation) over their summed ``steps`` counters, then the mean over
the window's passes; nothing where no pose phase ran (the aligned path,
or a program without these spans)."""


def read(record):
    per_pass = []
    for p in record["passes"]:
        t = p.get("timings") or {}
        steps = sum(t.get(f"{k}:steps", 0.0) for k in ("pose_coarse",
                                                        "pose_fine"))
        if steps > 0:
            walls = sum(t.get(k, 0.0) for k in ("pose_coarse", "pose_fine"))
            per_pass.append(1000.0 * walls / steps)
    return sum(per_pass) / len(per_pass) if per_pass else None
