"""``setup_s``: seconds from the start of the process to the start of the
window: imports, the kernels' load (and build, on a checkout's first
run), writing the objects, and the warm-up pass."""


def read(record):
    return record["setup_s"]
