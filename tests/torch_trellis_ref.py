"""Helpers of the TRELLIS parity tests (test_torch_trellis.py,
test_torch_config5.py): the tiny reference backend's parameter trees
(ref_params, no flax init), the port's backend carrying them, and the
reference's jax.random draws of generate_meshes_batch."""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from torch_models_ref import ref_params

import genpc_tpu.config as jconfig
import genpc_tpu_torch.config as tconfig
from genpc_tpu.models import trellis as jtr
from genpc_tpu_torch.models import trellis as ttr
from genpc_tpu_torch.models import weights as tw

K = jax.random.PRNGKey(0)


def trellis_inits(j):
    """The reference backend's four init functions, keyed as its
    ``_init_params`` keys its trees."""
    tc = j.tc
    s, z = tc.img_size, jnp.zeros
    tok = z((1, (s // tc.patch) ** 2, tc.img_dim))
    ts = z((1,))
    r3 = tc.slat_res ** 3
    return {
        "encoder": lambda: j.encoder.init(K, z((1, s, s, 3))),
        "struct": lambda: j.struct_flow.init(
            K, z((1, tc.struct_res ** 3, 1)), ts, tok),
        "slat": lambda: j.slat_flow.init(
            K, z((1, r3, tc.slat_dim)), ts, tok, extra=z((1, r3, 1))),
        "decoder": lambda: j.decoder.init(K, z((1, r3, tc.slat_dim))),
    }


def trellis_backends(seed=40):
    """The reference's and the port's tiny TRELLIS backends with the same
    weights (the reference's trees from ref_params)."""
    j = jtr.TrellisBackend(jconfig.load_config(model_size="tiny"))
    j._params = {k: ref_params(f, seed + i) for i, (k, f) in
                 enumerate(trellis_inits(j).items())}
    t = ttr.TrellisBackend(tconfig.load_config(device="cpu",
                                               model_size="tiny"))
    t.init_params(tw.from_flax("trellis", j._params, t.net))
    return j, t


def ref_trellis_draws(rng, b, tc):
    """The reference's draws of one generate_meshes_batch call from the
    backend key ``rng``: (the next key, the call's per-object keys,
    structure noise [b, S³, 1], SLAT noise [b, R³, C])."""
    rng, k = jax.random.split(rng)
    keys = jax.random.split(k, b)
    sn, ln = [], []
    for key in keys:
        k1, k2 = jax.random.split(key)
        sn.append(np.asarray(jax.random.normal(k1, (1, tc.struct_res ** 3,
                                                    1))))
        ln.append(np.asarray(jax.random.normal(
            k2, (1, tc.slat_res ** 3, tc.slat_dim))))
    return rng, keys, torch.from_numpy(np.concatenate(sn)), \
        torch.from_numpy(np.concatenate(ln))
