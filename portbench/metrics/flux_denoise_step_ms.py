"""``flux_denoise_step_ms``: the wall of one step of a DiT backend's
generation loop, in milliseconds: per traced pass, 1000 × the summed
walls of the ``denoise`` spans (the depth latents' VAE encode and the
sampler loop over every object of a call, ending in a device
synchronisation) over their summed ``steps`` counters, then the mean over
the window's passes; nothing where no pass generated with a DiT."""


def read(record):
    per_pass = []
    for p in record["passes"]:
        t = p.get("timings") or {}
        if t.get("denoise:steps"):
            per_pass.append(1000.0 * t["denoise"] / t["denoise:steps"])
    return sum(per_pass) / len(per_pass) if per_pass else None
