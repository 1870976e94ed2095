"""``flux_inpaint_step_ms``: the wall of one FLUX inpainter step, in
milliseconds: per traced pass, 1000 × the summed walls of the ``inpaint``
spans (a paint's VAE encode, its sampler loop and its decode, ending in a
device synchronisation) over their summed ``steps`` counters, then the
mean over the window's passes; nothing where no pass painted."""


def read(record):
    per_pass = []
    for p in record["passes"]:
        t = p.get("timings") or {}
        if t.get("inpaint:steps"):
            per_pass.append(1000.0 * t["inpaint"] / t["inpaint:steps"])
    return sum(per_pass) / len(per_pass) if per_pass else None
