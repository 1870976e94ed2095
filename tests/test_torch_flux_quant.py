"""Parity of the port's FLUX.1-Depth-dev backend with its MMDiT and T5
weight-only quantised (int8, int4) with the JAX reference's on the CPU:
generate_batch on the reference's jax.random draws in both precision
modes, both packages on the reference's quantize_tree of the same
weights (torch_flux_ref.check_generate_batch)."""

import pytest
import torch_flux_ref as fr
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("mode", ["f32", "bf16"])
@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_generate_batch_matches_the_reference(bits, mode):
    fr.check_generate_batch(bits, mode)
