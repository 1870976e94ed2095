"""``stage2_syncs``: the synchronizing CUDA operations the host made inside
``run_batched``'s ``stage2`` span (the counter ``stage2:syncs``: each
``.item()``, device-to-host copy or other operation PyTorch's sync debug
mode reports, the spans' own end-of-span waits not counted), as the mean
count a pass over the traced window's passes; nothing where no pass has the
counter (a program without it)."""


def read(record):
    counts = [p["timings"]["stage2:syncs"] for p in record["passes"]
              if p.get("timings") and "stage2:syncs" in p["timings"]]
    return sum(counts) / len(counts) if counts else None
