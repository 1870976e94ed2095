"""Parity of the port's FLUX.1-Depth-dev backend
(genpc_tpu_torch/models/dit_depth.py, variant "flux") with the JAX
reference's on the CPU: generate_batch on the reference's jax.random
draws in both precision modes (quant_bits 0; 8 and 4 in
test_torch_flux_quant.py), and release().
Both packages carry the same weights (torch_flux_ref.trees)."""

import numpy as np
import pytest
import torch
import torch_flux_ref as fr
from torch_threads import one_torch_thread  # noqa: F401

from genpc_tpu_torch.models.dit_depth import DiTDepthEdit
from genpc_tpu_torch.tracing import recording


@pytest.mark.parametrize("mode", ["f32", "bf16"])
def test_generate_batch_matches_the_reference(mode):
    """The bf16 backend (quant_bits 0): torch_flux_ref.check_generate_batch;
    test_torch_flux_quant.py holds int8 and int4."""
    fr.check_generate_batch(0, mode)


def test_release_frees_t5_and_clip_l():
    """release() leaves every parameter and buffer of the MMDiT, the VAE,
    T5 (its int4 weights included) and CLIP-L on the meta device (the
    reference's release() keeps FLUX's T5), records its span, and the
    next generate materialises the same seeded weights."""
    b = DiTDepthEdit({"device": "cpu", "model_size": "tiny",
                      "quant_bits": 4, "tower_quant_bits": 4},
                     variant="flux", seed=2)
    depth = np.random.default_rng(1).random((32, 32)).astype(np.float32)
    with recording() as rec:
        a1 = b.generate(depth, "05117", size=fr.SIZE, num_inference_steps=3)
        assert a1.shape == (fr.SIZE, fr.SIZE, 3) and np.isfinite(a1).all()
        w = b.t5.model.encoder.block[0].layer[0].SelfAttention.q.weight.clone()
        assert w.dtype == torch.int8
        b.release()
        for kind in ("dit", "vae", "t5", "clip_l"):
            mod = b.models()[kind]
            assert all(x.is_meta for x in list(mod.parameters())
                       + list(mod.buffers())), kind
        assert not b.t5.ready
        b.generate(depth, "05117", size=fr.SIZE, num_inference_steps=3)
        assert torch.equal(
            b.t5.model.encoder.block[0].layer[0].SelfAttention.q.weight, w)
    assert {s.name for s in rec.spans} == {"t5_init", "encode", "dit_init",
                                           "denoise", "decode", "release"}


def test_full_flux_parameter_count_matches_the_reference():
    """The full FLUX.1-Depth-dev MMDiT (meta device) counts what the
    reference's tree counts by jax.eval_shape, 11,901,604,928, as its int4
    build does at full precision (logical_params); its int4 block
    weights take a quarter of the bf16 bytes."""
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp

    from genpc_tpu.models import weights as jw
    from genpc_tpu.models.dit import DiTConfig as JDiTConfig
    from genpc_tpu.models.dit import MMDiT as JMMDiT
    from genpc_tpu_torch.models.dit import DiTConfig, MMDiT
    from genpc_tpu_torch.models.quant import logical_params, tree_bytes
    jcfg = JDiTConfig.preset("flux")
    lat = jnp.zeros((1, 8, 8, 16))
    tree = jax.eval_shape(lambda: JMMDiT(jcfg).init(
        jax.random.PRNGKey(0), lat, jnp.zeros((1,)),
        jnp.zeros((1, 8, jcfg.text_dim)), pooled=jnp.zeros((1, 768)),
        cond_latents=lat, guidance=jnp.ones((1,))))
    ref = sum(int(np.prod(s)) for s in jw.tree_shapes(
        fnn.meta.unbox(tree)).values())
    b = DiTDepthEdit({"device": "cpu", "model_size": "full"},
                     variant="flux")
    assert b.dit_cfg.quant_bits == b.t5.cfg.quant_bits == 4
    with torch.device("meta"):
        fp = MMDiT(DiTConfig.preset("flux")).to(torch.bfloat16)
    assert sum(p.numel() for p in fp.parameters()) == ref == \
        logical_params(b.model) == 11_901_604_928
    assert tree_bytes(b.model) < 0.27 * tree_bytes(fp)
