"""``peak_mem_gib``: the most device memory the allocator held during the
window (``torch.cuda.max_memory_allocated`` after a reset once the
warm-up pass is done), in GiB; nothing on a run without a device."""


def read(record):
    peak = record["memory"]["window_peak_bytes"]
    return peak / 2 ** 30 if peak else None
