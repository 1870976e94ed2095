"""``flux_init_s``: the seconds a pass spends materialising the FLUX
backends' weights (the spans ``t5_init``, T5-XXL and CLIP-L, and
``dit_init``, the MMDiT and the VAE, of the inpainter and of the
generator, each ending in a device synchronisation), as the mean over the
traced window's passes; nothing where no pass has these spans."""

SPANS = ("t5_init", "dit_init")


def read(record):
    per_pass = []
    for p in record["passes"]:
        t = p.get("timings") or {}
        if any(s in t for s in SPANS):
            per_pass.append(sum(t.get(s, 0.0) for s in SPANS))
    return sum(per_pass) / len(per_pass) if per_pass else None
