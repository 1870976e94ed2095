"""Frozen plain copy of the port's Redwood path (``genpc_tpu_torch`` at
commit 15bea8d): the modules that ``run_batched`` reaches with the
synthetic backends, each at the same relative path, with every import of
the port pointed at this copy and every hand-written kernel replaced by
its plain form on every device: K1 by ``_nn_plain``, K2 by
``fps_batched_plain``, K3 by ``bid_plain_direct`` (the form the kernel
computes; the port's CPU path takes the matrix form ``bid_plain``), K4
and K5 by ``assemble_plain`` and ``assemble_bwd_points_plain``.  The
runner returns the objects' records beside their scores, has no GT cache
and runs on one device (``parallel/mesh.py`` here is a one-device stub).
Everything else, the card's ordered sums of ``ops/rowsum`` included, is
the port's code as it stood.  Module docstrings are the originals' and
still speak of the kernels that this copy does not launch.

Nothing here imports the port, JAX or a kernel library.
"""
