"""``flux_pass_mfu``'s closed form (portbench/flux_flops.py) against
``torch.utils.flop_counter.FlopCounterMode``'s count of one MMDiT forward
of the port at the tiny preset, and the FLUX metric readers on records
with and without the FLUX spans."""

import importlib.util
from pathlib import Path

import pytest
import torch
from torch.nn.attention import SDPBackend, sdpa_kernel
from torch.utils.flop_counter import FlopCounterMode
from torch_threads import one_torch_thread  # noqa: F401

from genpc_tpu_torch.models import weights as tw
from genpc_tpu_torch.models.dit import DiTConfig, MMDiT
from portbench import flux_flops

METRICS = Path(__file__).resolve().parents[1] / "portbench" / "metrics"
READERS = ("flux_pass_mfu", "flux_inpaint_step_ms", "flux_denoise_step_ms",
           "flux_init_s")
#: the modules the closed form leaves out inside a block: the AdaLN
#: modulations (one vector a row)
MODULATIONS = ("norm1.linear", "norm1_context.linear", "norm.linear")


def _reader(name):
    spec = importlib.util.spec_from_file_location(f"m_{name}",
                                                  METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_closed_form_counts_what_flop_counter_mode_counts():
    """One forward of the tiny MMDiT over 2 rows of 16 image and 32 text
    positions: the FLOPs FlopCounterMode counts inside the double and
    single blocks, the modulations taken out (embedders and the final
    layer lie outside the blocks), equal the closed form at the tiny
    widths (attention in its plain form, whose two batched products the
    counter sees)."""
    cfg = DiTConfig.preset("tiny")
    with torch.device("meta"):
        m = MMDiT(cfg)
    tw.materialize(m, "cpu", torch.float32, seed=0, prefix="dit")
    b, hw, lt = 2, 8, 32
    lat = torch.randn(b, cfg.in_channels, hw, hw)
    with sdpa_kernel(SDPBackend.MATH), FlopCounterMode(display=False) as fc:
        m(lat, torch.rand(b), torch.randn(b, lt, cfg.text_dim),
          pooled=torch.randn(b, cfg.pooled_dim), cond_latents=lat,
          guidance=torch.ones(b))
    counts = {k: sum(v.values()) for k, v in fc.get_flop_counts().items()}
    blocks = [f"MMDiT.transformer_blocks.{i}"
              for i in range(cfg.double_blocks)] + [
        f"MMDiT.single_transformer_blocks.{i}"
        for i in range(cfg.single_blocks)]
    counted = sum(counts[k] - sum(counts.get(f"{k}.{mod}", 0)
                                  for mod in MODULATIONS) for k in blocks)
    img = (hw // cfg.patch_size) ** 2
    assert counted == flux_flops.mmdit_flops(
        b, b * img, b * lt, hidden=cfg.hidden_dim, blocks=len(blocks))
    # the left-out parts are there, outside the closed form
    assert counts["MMDiT"] > counted


def test_pass_flops_sums_both_sampler_spans():
    """A pass of 3 paints at 256² (256 image, 512 text positions a row)
    and a 3-object generation at 512² (1,024 and 512), 30 steps each."""
    t = {"inpaint:rows": 90.0, "inpaint:img_tokens": 90.0 * 256,
         "inpaint:txt_tokens": 90.0 * 512, "denoise:rows": 90.0,
         "denoise:img_tokens": 90.0 * 1024, "denoise:txt_tokens": 90.0 * 512}
    d, n = 3072, 57

    def step(tokens):
        return n * (24 * d * d * tokens + 4 * d * tokens * tokens)
    assert flux_flops.pass_flops(t) == pytest.approx(
        90 * step(768) + 90 * step(1536), rel=1e-12)
    mfu = _reader("flux_pass_mfu")({"passes": [{"seconds": 30.0,
                                                "timings": t}]})
    assert mfu == pytest.approx(100 * flux_flops.pass_flops(t) / 30.0
                                / 989.4e12)


@pytest.mark.parametrize("name", READERS)
def test_readers_find_nothing_without_flux_spans(name):
    """A traced Redwood pass (no FLUX span or counter) and an untraced
    pass give no value, and raise nothing."""
    redwood = {"stage1": 0.4, "generate": 0.3, "stage3": 5.0,
               "stage3:syncs": 360.0, "pose_coarse:steps": 140.0}
    record = {"passes": [{"seconds": 8.0, "timings": redwood},
                         {"seconds": 8.0, "timings": None}]}
    assert _reader(name)(record) is None
