"""The port's FLUX.1-Depth-dev backends (genpc_tpu_torch/models/dit_depth.py,
variant "flux", and FluxInpainter) against the benchmark's plain fp32
reference (portbench/reference/plain/models/dit_depth.py and flux.py) on
the CPU, at the tiny preset, with int4 MMDiT and T5 weights on both sides
drawn by each from the port's seeds: the weights themselves, one MMDiT
step's velocity, the T5 and CLIP-L encodes, the VAE round trip, one paint
and one generate_batch of 2 objects at 64².  Each comparison runs in the
port's fp32 setting (every layer computing in fp32) and in its bf16
setting (its own compute types), and the reference rounded to fp8 e4m3
must miss the bf16 tolerance on the first-step velocity."""

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from genpc_tpu_torch.models.dit_depth import DiTDepthEdit, FluxInpainter
from genpc_tpu_torch.models.quant import QuantLinear, dequantize_array
from portbench.reference.plain.models import dit_depth as rd
from portbench.reference.plain.models import flux
from portbench.reference.plain.pipeline.artifacts import ObjectArtifacts

CFG = {"device": "cpu", "model_size": "tiny", "quant_bits": 4,
       "tower_quant_bits": 4}
FLAGS = ["00000", "00001"]
SIZE = 64
#: max |port - reference| <= TOL[mode][what] * max |reference|.
#: f32: the same fp32 arithmetic in another summation order (observed up
#: to 3e-6 on the images, 3e-7 on the velocities).  bf16: the port rounds
#: every matmul's and convolution's operands to bf16 (2^-8 relative).  One
#: MMDiT forward keeps that ulp (velocities: observed up to 3.3e-3 of the
#: largest value); T5's unscaled attention logits, from int4 weights of
#: std 1/sqrt(64) at this width, sharpen its softmax (contexts: 3.7e-2;
#: 2.3e-3 with bf16 weights), the VAE encoder reaches 2.0e-2; the bf16 VAE
#: decoder and 30 sampler steps compound it (images: up to 6.8e-2).
TOL = {"f32": {"velocity": 1e-5, "encode": 1e-5, "image": 1e-5},
       "bf16": {"velocity": 1e-2, "encode": 6e-2, "image": 1e-1}}
MODES = ("f32", "bf16")


def _setting(mode, *modules):
    """The port's fp32 setting: every layer of the modules computes in
    fp32 (their ``compute``); bf16 keeps the port's own types."""
    if mode == "f32":
        for mod in modules:
            for m in mod.modules():
                if hasattr(m, "compute"):
                    m.compute = torch.float32


def _close(got, ref, tol) -> float:
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float64)
    ref = np.asarray(ref.detach() if torch.is_tensor(ref) else ref,
                     np.float64)
    assert got.shape == ref.shape
    scale = float(np.abs(ref).max())
    gap = float(np.abs(got - ref).max())
    assert scale > 0 and gap <= tol * scale, (gap, scale, gap / scale)
    return gap / scale


def _port(mode):
    b = DiTDepthEdit(CFG, variant="flux")
    b.ensure_ready()
    _setting(mode, *b.models().values())
    return b


def _depths():
    r = np.random.default_rng(3)
    return [r.random((3, 32, 32)).astype(np.float32) for _ in FLAGS]


@pytest.mark.parametrize("kind", ["dit", "vae", "t5", "clip_l"])
def test_reference_draws_the_ports_weights(kind):
    """Every tensor of the reference's tiny models equals the port's
    (an int4 layer's codes times its scale), bit for bit."""
    b = _port("bf16")
    port = b.models()[kind]
    make = {"dit": lambda: flux.MMDiT(flux.DiTConfig.preset("tiny"), True),
            "vae": lambda: flux.VAE(flux.VAEConfig.preset("tiny")),
            "t5": lambda: flux.T5Encoder(flux.T5Config.preset("tiny"), True),
            "clip_l": lambda: flux.CLIPText(flux.CLIPConfig.preset("tiny"))}
    with torch.device("meta"):
        ref = make[kind]()
    flux.build(ref, "cpu", 0, kind, torch.float32,
               4 if kind in ("dit", "t5") else 0)
    state = port.state_dict()
    quant = {n for n, m in port.named_modules() if isinstance(m, QuantLinear)}
    names = dict(ref.named_parameters())
    assert bool(quant) == (kind in ("dit", "t5"))
    assert set(names) == {k for k in state if not k.endswith(".scale")}
    for name, p in names.items():
        owner = name.rpartition(".")[0]
        want = state[name].float()
        if owner in quant and name.endswith(".weight"):
            want = dequantize_array(state[name], state[f"{owner}.scale"],
                                    torch.float32, 4)
        assert torch.equal(p, want), name


@pytest.mark.parametrize("mode", MODES)
def test_mmdit_velocity_matches_the_reference(mode):
    b = _port(mode)
    ref = rd.DiTDepthEdit(CFG, "flux")
    ref.net.ready()
    g = torch.Generator().manual_seed(5)
    lat = torch.randn(2, 4, 8, 8, generator=g)
    cond = torch.randn(2, 4, 8, 8, generator=g)
    txt = torch.randn(2, 32, 64, generator=g)
    pooled = torch.randn(2, 32, generator=g)
    t = torch.tensor([0.9, 0.3])
    with torch.no_grad():
        got = b.model(lat, t, txt, pooled=pooled, cond_latents=cond,
                      guidance=torch.full_like(t, 10.0))
        want = ref.net.dit(lat, t, txt, pooled, cond, torch.full_like(t, 10.))
    _close(got, want, TOL[mode]["velocity"])


@pytest.mark.parametrize("mode", MODES)
def test_prompt_encodes_match_the_reference(mode):
    """T5 (its context) and CLIP-L (its pooled vector, tiled to the
    MMDiT's pooled width) of two prompts."""
    b = _port(mode)
    prompts = [rd.FLUX_PROMPT.format(category=c) for c in ("chair", "sofa")]
    ctx, pooled = b.encode_flux(prompts)
    ref = rd.DiTDepthEdit(CFG, "flux").net.encode(prompts)
    _close(ctx, torch.cat([c for c, _ in ref]), TOL[mode]["encode"])
    _close(pooled, torch.cat([p for _, p in ref]), TOL[mode]["encode"])


@pytest.mark.parametrize("mode", MODES)
def test_vae_round_trip_matches_the_reference(mode):
    b = _port(mode)
    ref = rd.DiTDepthEdit(CFG, "flux")
    ref.net.ready()
    img = torch.rand(1, 3, SIZE, SIZE,
                     generator=torch.Generator().manual_seed(6)) * 2 - 1
    with torch.no_grad():
        lat = b.vae.encode(img)
        want_lat = ref.net.vae.encode(img)
        got = b.vae.decode(lat)
        want = ref.net.vae.decode(want_lat)
    _close(lat, want_lat, TOL[mode]["encode"])
    _close(got, want, TOL[mode]["image"])


@pytest.mark.parametrize("mode", MODES)
def test_paint_matches_the_reference(mode):
    """One FluxInpainter.paint: the painted depth and the first step's
    velocity, which the reference's object record reads as paint_v0."""
    p = FluxInpainter(CFG)
    p.backend.ensure_ready()
    _setting(mode, *p.backend.models().values())
    r = np.random.default_rng(4)
    raw = r.random((3, SIZE, SIZE)).astype(np.float32)
    hole = (r.random((3, SIZE, SIZE)) > 0.6).astype(np.float32)
    got = p.paint(raw, hole)
    want = rd.FluxInpainter(CFG).paint(raw, hole)
    rec = ObjectArtifacts("00000", depth=want)
    _close(p.first_velocity, rec.paint_v0, TOL[mode]["velocity"])
    _close(got, want, TOL[mode]["image"])


@pytest.mark.parametrize("mode", MODES)
def test_generate_batch_matches_the_reference(mode):
    """generate_batch of 2 objects at 64² (the port denoises them
    together, the reference one at a time): images and first-step
    velocities."""
    b = _port(mode)
    got = b.generate_batch(_depths(), FLAGS, size=SIZE)
    want = rd.DiTDepthEdit(CFG, "flux").generate_batch(_depths(), FLAGS,
                                                       size=SIZE)
    v0 = np.stack([ObjectArtifacts(f, image=w).gen_v0
                   for f, w in zip(FLAGS, want)])
    _close(b.first_velocity, v0, TOL[mode]["velocity"])
    _close(got, np.stack(want), TOL[mode]["image"])


def test_fp8_reference_misses_the_bf16_velocity_tolerance():
    """The reference with every linear layer's and attention's inputs
    rounded to fp8 e4m3 (the control's precision) is further from the
    fp32 reference, on the first-step velocities of a generation and of a
    paint, than the bf16 tolerance the port meets (observed 3.6-3.8e-2 of
    the largest velocity against the port's 3e-3)."""
    low = dict(CFG, reference_precision="fp8_e4m3")
    imgs = rd.DiTDepthEdit(CFG, "flux").generate_batch(_depths(), FLAGS,
                                                       size=SIZE)
    imgs8 = rd.DiTDepthEdit(low, "flux").generate_batch(_depths(), FLAGS,
                                                        size=SIZE)
    r = np.random.default_rng(4)
    raw = r.random((3, SIZE, SIZE)).astype(np.float32)
    hole = (r.random((3, SIZE, SIZE)) > 0.6).astype(np.float32)
    paints = [rd.FluxInpainter(c).paint(raw, hole) for c in (CFG, low)]
    for ref, got in [(ObjectArtifacts(f, image=a).gen_v0,
                      ObjectArtifacts(f, image=b).gen_v0)
                     for f, a, b in zip(FLAGS, imgs, imgs8)] + [
            (ObjectArtifacts("p", depth=paints[0]).paint_v0,
             ObjectArtifacts("p", depth=paints[1]).paint_v0)]:
        gap = np.abs(got - ref).max()
        assert gap > TOL["bf16"]["velocity"] * np.abs(ref).max(), gap
