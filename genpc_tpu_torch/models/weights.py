"""Parameters of the generative models: materialisation, seeded random
weights, the reference's trees carried across, and checkpoint loading
(counterpart of genpc_tpu/models/weights.py).

  * ``materialize`` gives a module built on the meta device its storage
    on a device, in one dtype (fp32 at the test presets, bf16 at full
    size), and with a seed fills it with random weights: norm scales 1,
    biases 0, everything else N(0, 0.02), each tensor drawn on the
    device in its own dtype from a ``torch.Generator`` seeded by a stable
    digest (CRC-32) of its name.  No fp32 copy of a bf16 tree is ever
    made.  The reference folds the salted builtin ``hash()`` into its
    keys (genpc_tpu/models/weights.py:168), so its random weights change
    from one process to the next; these do not.
  * ``from_flax`` turns a reference parameter tree (numpy leaves) into a
    state dict for a port module, through the port's copies of the
    reference's name maps and the layout transposes (conv HWIO -> OIHW,
    dense (in, out) -> (out, in)).
  * A ``quant.QuantLinear`` draws its random weight in the quantised
    form (the reference's ``_int_kernel_init``): a unit normal, rounded at
    3 sigma full scale to the int codes, with the scale 3 / (qmax *
    sqrt(in)) (so the dequantised weight has std 1 / sqrt(in)); its scale
    and bias stay fp32 whatever the module's dtype.  The fp32 draw is one
    tensor at a time.
  * ``load_sdxl_controlnet`` / ``load_clip_towers`` / ``load_instantmesh``
    / ``load_dit`` / ``load_qwen_vl`` / ``load_t5_and_clip_l`` /
    ``load_matting`` read diffusers / HF / InstantMesh / RMBG-2.0
    safetensors checkpoints in the reference's directory layout with a
    reader of the port's own (no ``safetensors`` package needed) and
    load them by name; into a quantised module through
    ``quant.load_quantized`` (checked against the full-precision names
    and shapes, then quantised).  ``load_trellis`` / ``load_sf3d`` /
    ``load_ddnm`` read checkpoints saved from the reference's own
    architectures (named by its flax paths, ``load_saved``).
  * BatchNorm's running statistics are buffers: a random fill sets them
    to mean 0, variance 1.
"""

from __future__ import annotations

import json
import math
import mmap
import os
import re
import struct
import zlib
from collections.abc import Mapping
from typing import Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn

from genpc_tpu_torch.models.layers import NORMS, BatchNorm2dInference
from genpc_tpu_torch.models.quant import (
    QMAX, QuantLinear, dit_block_select, load_quantized, pack_int4,
    t5_block_select, vl_block_select)

# ------------------------------------------------------- materialisation


def _digest(seed: int, prefix: str, name: str) -> int:
    return zlib.crc32(f"{seed}:{prefix}:{name}".encode())


def _generator(device, seed: int, prefix: str, name: str):
    g = torch.Generator(device=device)
    g.manual_seed(_digest(seed, prefix, name))
    return g


@torch.no_grad()
def random_fill(module: nn.Module, seed: int = 0, prefix: str = "") -> None:
    """Norm scales 1, biases 0, other tensors N(0, 0.02) drawn per tensor
    from a generator seeded by the digest of (seed, prefix, name); a
    QuantLinear's weight in its quantised form."""
    for name, m in module.named_modules():
        if isinstance(m, QuantLinear):
            qmax = QMAX[m.bits]
            w = torch.randn(m.out_features, m.in_features,
                            device=m.weight.device,
                            generator=_generator(m.weight.device, seed,
                                                 prefix, f"{name}.weight"))
            q = torch.clamp(torch.round(w * (qmax / 3.0)), -qmax, qmax)
            del w
            m.weight.copy_(pack_int4(q) if m.bits == 4 else q)
            m.scale.fill_(3.0 / (qmax * math.sqrt(m.in_features)))
            if m.bias is not None:
                m.bias.zero_()
    for m in module.modules():
        if isinstance(m, BatchNorm2dInference):
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
    norm_scales = {f"{n}.weight" for n, m in module.named_modules()
                   if isinstance(m, NORMS)}
    for name, p in module.named_parameters():
        if name in norm_scales:
            p.fill_(1.0)
        elif name.endswith("bias"):
            p.zero_()
        else:
            p.normal_(0.0, 0.02,
                      generator=_generator(p.device, seed, prefix, name))


def materialize(module: nn.Module, device: torch.device | str,
                dtype: torch.dtype, seed: int | None = None,
                prefix: str = "") -> nn.Module:
    """Storage for a meta-built module on ``device`` in ``dtype``, for
    inference; random weights when ``seed`` is given."""
    module.to(dtype=dtype)
    for m in module.modules():
        if isinstance(m, QuantLinear):
            m.float()                # its scale and bias stay fp32
    module.to_empty(device=device).requires_grad_(False)
    module.eval()
    if seed is not None:
        random_fill(module, seed, prefix)
    return module


# -------------------------------------------------------- name maps
# Port parameter names are the diffusers / HF checkpoint names; these map
# them to the reference's flax paths (copies of the reference's maps).

def sdxl_unet_name_to_flax(name: str, num_levels: int = 3) -> str:
    """diffusers UNet2DConditionModel name -> reference flax path."""
    n = name
    m = re.match(r"up_blocks\.(\d+)\.(.*)", n)
    if m:
        lvl = num_levels - 1 - int(m.group(1))
        n = f"up_{lvl}.{m.group(2)}"
    n = re.sub(r"^down_blocks\.(\d+)\.", r"core.down_\1.", n)
    n = re.sub(r"^mid_block\.", "core.mid.", n)
    n = re.sub(r"^conv_in\.", "core.conv_in.", n)
    n = re.sub(r"resnets\.(\d+)\.", r"resnets_\1.", n)
    n = re.sub(r"attentions\.(\d+)\.", r"attentions_\1.", n)
    n = re.sub(r"transformer_blocks\.(\d+)\.", r"blocks_\1.", n)
    n = re.sub(r"downsamplers\.0\.conv\.", "downsample.conv.", n)
    n = re.sub(r"upsamplers\.0\.conv\.", "upsample.conv.", n)
    n = re.sub(r"ff\.net\.0\.proj\.", "ff.proj_in.", n)
    n = re.sub(r"ff\.net\.2\.", "ff.proj_out.", n)
    n = re.sub(r"to_out\.0\.", "to_out.", n)
    n = n.replace(".", "/")
    if n.endswith("/weight"):
        leaf = "scale" if re.search(
            r"(^|/)(norm\d?|conv_norm_out|ln\w*)/weight$", n) else "kernel"
        n = n[: -len("weight")] + leaf
    return "params/" + n


def controlnet_name_to_flax(name: str, num_levels: int = 3) -> str:
    """diffusers ControlNetModel name -> reference flax path."""
    n = name
    n = re.sub(r"^controlnet_cond_embedding\.conv_in\.",
               "cond_embedding.conv_in.", n)
    n = re.sub(r"^controlnet_cond_embedding\.blocks\.(\d+)\.",
               r"cond_embedding.blocks_\1.", n)
    n = re.sub(r"^controlnet_cond_embedding\.conv_out\.",
               "cond_embedding.conv_out.", n)
    n = re.sub(r"^controlnet_down_blocks\.(\d+)\.", r"zero_down_\1.conv.", n)
    n = re.sub(r"^controlnet_mid_block\.", "zero_mid.conv.", n)
    if n != name:
        n = n.replace(".", "/")
        return "params/" + re.sub(r"/weight$", "/kernel", n)
    return sdxl_unet_name_to_flax(name, num_levels)


def vae_name_to_flax(name: str, num_levels: int = 4) -> str:
    """diffusers AutoencoderKL name -> reference flax path."""
    n = name
    m = re.match(r"decoder\.up_blocks\.(\d+)\.(.*)", n)
    if m:
        lvl = num_levels - 1 - int(m.group(1))
        rest = m.group(2)
        rest = re.sub(r"^resnets\.(\d+)\.", rf"up_{lvl}_res_\1.", rest)
        rest = re.sub(r"^upsamplers\.0\.", rf"up_{lvl}_us.", rest)
        n = "decoder." + rest
    n = re.sub(r"encoder\.down_blocks\.(\d+)\.resnets\.(\d+)\.",
               r"encoder.down_\1_res_\2.", n)
    n = re.sub(r"encoder\.down_blocks\.(\d+)\.downsamplers\.0\.",
               r"encoder.down_\1_ds.", n)
    n = re.sub(r"mid_block\.resnets\.(\d+)\.", r"mid_res_\1.", n)
    n = re.sub(r"mid_block\.attentions\.0\.", "mid_attn.", n)
    n = n.replace("group_norm.", "norm.")
    n = n.replace("conv_norm_out.", "norm_out.")
    n = n.replace("to_out.0.", "to_out.")
    n = re.sub(r"mid_attn\.(to_q|to_k|to_v|to_out)\.",
               r"mid_attn.attn.\1.", n)
    n = n.replace(".", "/")
    if n.endswith("/weight"):
        leaf = "scale" if re.search(r"(^|/)(norm\w*)/weight$", n) else "kernel"
        n = n[: -len("weight")] + leaf
    return "params/" + n


def clip_name_to_flax(name: str) -> str:
    """HF CLIPTextModel(WithProjection) name -> reference flax path."""
    n = name
    n = re.sub(r"^text_model\.embeddings\.", "", n)
    n = re.sub(r"^text_model\.encoder\.layers\.(\d+)\.", r"layers_\1.", n)
    n = re.sub(r"^text_model\.final_layer_norm\.", "final_layer_norm.", n)
    n = re.sub(r"\.self_attn\.", ".", n)
    n = re.sub(r"\.mlp\.", ".", n)
    n = n.replace(".", "/")
    if n.endswith("/weight"):
        if re.search(r"(^|/)(token_embedding|position_embedding)/weight$",
                     n):
            leaf = "embedding"
        elif re.search(r"(^|/)(layer_norm\d|final_layer_norm)/weight$", n):
            leaf = "scale"
        else:
            leaf = "kernel"
        n = n[: -len("weight")] + leaf
    return "params/" + n


def clip_vision_name_to_flax(name: str) -> str:
    """HF CLIPVisionModelWithProjection name -> reference flax path."""
    n = name
    n = re.sub(r"^vision_model\.embeddings\.", "", n)
    n = re.sub(r"^vision_model\.encoder\.layers\.(\d+)\.", r"layers_\1.", n)
    n = re.sub(r"^vision_model\.", "", n)
    n = re.sub(r"\.self_attn\.", ".", n)
    n = re.sub(r"\.mlp\.", ".", n)
    n = n.replace(".", "/")
    if n.endswith("/weight"):
        if n == "position_embedding/weight":
            leaf = "embedding"
        elif re.search(r"(^|/)(layer_norm\d|pre_layrnorm|post_layernorm)"
                       r"/weight$", n):
            leaf = "scale"
        else:
            leaf = "kernel"
        n = n[: -len("weight")] + leaf
    return "params/" + n


def instantmesh_name_to_flax(name: str) -> str:
    """InstantMesh lrm_generator name (prefix stripped, fused attention
    tensors already split) -> reference flax path."""
    n = name
    n = re.sub(r"^encoder\.model\.embeddings\.cls_token$",
               "encoder_model.cls_token", n)
    n = re.sub(r"^encoder\.model\.embeddings\.position_embeddings$",
               "encoder_model.pos_embed", n)
    n = re.sub(r"^encoder\.model\.embeddings\.patch_embeddings\."
               r"projection\.", "encoder_model.patch_proj.", n)
    m = re.match(r"encoder\.model\.encoder\.layer\.(\d+)\.(.*)", n)
    if m:
        r = m.group(2)
        r = re.sub(r"^attention\.attention\.", "", r)
        r = re.sub(r"^attention\.output\.dense\.", "attn_out.", r)
        r = re.sub(r"^intermediate\.dense\.", "mlp_in.", r)
        r = re.sub(r"^output\.dense\.", "mlp_out.", r)
        r = re.sub(r"^layernorm_before\.", "ln_before.", r)
        r = re.sub(r"^layernorm_after\.", "ln_after.", r)
        r = re.sub(r"^adaLN_modulation\.1\.", "adaln.", r)
        n = f"encoder_model.layer_{m.group(1)}.{r}"
    n = re.sub(r"^encoder\.model\.layernorm\.", "encoder_model.ln.", n)
    n = re.sub(r"^encoder\.model\.pooler\.dense\.",
               "encoder_model.pooler.", n)
    n = re.sub(r"^encoder\.camera_embedder\.0\.",
               "camera_embedder.linear_1.", n)
    n = re.sub(r"^encoder\.camera_embedder\.2\.",
               "camera_embedder.linear_2.", n)
    m = re.match(r"transformer\.layers\.(\d+)\.(.*)", n)
    if m:
        r = m.group(2)
        r = re.sub(r"^cross_attn\.out_proj\.", "cross_out.", r)
        r = re.sub(r"^self_attn\.out_proj\.", "self_out.", r)
        r = re.sub(r"^mlp\.0\.", "mlp_in.", r)
        r = re.sub(r"^mlp\.2\.", "mlp_out.", r)
        n = f"transformer.layers_{m.group(1)}.{r}"
    n = re.sub(r"^synthesizer\.decoder\.(net_\w+)\.(\d+)\.",
               r"synthesizer.\1_\2.", n)
    n = n.replace(".", "/")
    if n.endswith("/weight"):
        leaf = ("scale" if re.search(
            r"(^|/)(ln\w*|norm\d|norm)/weight$", n) else "kernel")
        n = n[: -len("weight")] + leaf
    return "params/" + n


def lrm_name_to_flax(name: str) -> Tuple[str, ...]:
    """Port TriplaneLRM name -> the reference flax path(s) it takes: the
    fused nn.MultiheadAttention tensors (self-attention's in_proj weight
    and bias, the cross-attention's in_proj bias) take the q, k and v
    leaves, concatenated in that order."""
    m = re.match(r"(.*)\.self_attn\.in_proj_(weight|bias)$", name)
    if m:
        return tuple(instantmesh_name_to_flax(
            f"{m.group(1)}.self_{p}.{m.group(2)}") for p in "qkv")
    m = re.match(r"(.*)\.cross_attn\.in_proj_bias$", name)
    if m:
        return tuple(instantmesh_name_to_flax(
            f"{m.group(1)}.cross_{p}.bias") for p in "qkv")
    m = re.match(r"(.*)\.cross_attn\.([qkv])_proj_weight$", name)
    if m:
        return (instantmesh_name_to_flax(
            f"{m.group(1)}.cross_{m.group(2)}.weight"),)
    return (instantmesh_name_to_flax(name),)


def adapter_name_to_flax(name: str) -> str:
    """Port T2IAdapter name -> reference flax path (the same module paths;
    the adapter has no norms)."""
    n = name.replace(".", "/")
    return "params/" + re.sub(r"/weight$", "/kernel", n)


def qwen_name_to_flax(name: str) -> str:
    """diffusers QwenImageTransformer2DModel name -> reference flax path."""
    n = name
    n = re.sub(r"^time_text_embed\.timestep_embedder\.", "time_embed.", n)
    n = re.sub(r"^norm_out\.linear\.", "norm_out_mod.", n)
    m = re.match(r"transformer_blocks\.(\d+)\.(.*)", n)
    if m:
        r = m.group(2)
        r = re.sub(r"^img_mod\.1\.", "img_mod.", r)
        r = re.sub(r"^txt_mod\.1\.", "txt_mod.", r)
        r = re.sub(r"^img_mlp\.net\.0\.proj\.", "img_mlp_in.", r)
        r = re.sub(r"^img_mlp\.net\.2\.", "img_mlp_out.", r)
        r = re.sub(r"^txt_mlp\.net\.0\.proj\.", "txt_mlp_in.", r)
        r = re.sub(r"^txt_mlp\.net\.2\.", "txt_mlp_out.", r)
        n = f"double_{m.group(1)}.{_dit_attn(r)}"
    return _dit_leaf(n)


def flux_name_to_flax(name: str) -> str:
    """diffusers FluxTransformer2DModel name -> reference flax path."""
    n = name
    n = re.sub(r"^x_embedder\.", "img_in.", n)
    n = re.sub(r"^context_embedder\.", "txt_in.", n)
    n = re.sub(r"^time_text_embed\.timestep_embedder\.", "time_embed.", n)
    n = re.sub(r"^time_text_embed\.guidance_embedder\.",
               "guidance_embed.", n)
    n = re.sub(r"^time_text_embed\.text_embedder\.", "pooled_embed.", n)
    n = re.sub(r"^norm_out\.linear\.", "norm_out_mod.", n)
    m = re.match(r"transformer_blocks\.(\d+)\.(.*)", n)
    if m:
        r = m.group(2)
        r = re.sub(r"^norm1\.linear\.", "img_mod.", r)
        r = re.sub(r"^norm1_context\.linear\.", "txt_mod.", r)
        r = re.sub(r"^ff\.net\.0\.proj\.", "img_mlp_in.", r)
        r = re.sub(r"^ff\.net\.2\.", "img_mlp_out.", r)
        r = re.sub(r"^ff_context\.net\.0\.proj\.", "txt_mlp_in.", r)
        r = re.sub(r"^ff_context\.net\.2\.", "txt_mlp_out.", r)
        n = f"double_{m.group(1)}.{_dit_attn(r)}"
    m = re.match(r"single_transformer_blocks\.(\d+)\.(.*)", n)
    if m:
        r = m.group(2)
        r = re.sub(r"^norm\.linear\.", "mod.", r)
        r = re.sub(r"^attn\.", "", r)
        n = f"single_{m.group(1)}.{r}"
    return _dit_leaf(n)


def _dit_attn(r: str) -> str:
    """A double block's attention names, shared by both families."""
    r = re.sub(r"^attn\.to_q\.", "attn_img_q.", r)
    r = re.sub(r"^attn\.to_k\.", "attn_img_k.", r)
    r = re.sub(r"^attn\.to_v\.", "attn_img_v.", r)
    r = re.sub(r"^attn\.add_q_proj\.", "attn_txt_q.", r)
    r = re.sub(r"^attn\.add_k_proj\.", "attn_txt_k.", r)
    r = re.sub(r"^attn\.add_v_proj\.", "attn_txt_v.", r)
    r = re.sub(r"^attn\.to_out\.0\.", "attn_img_out.", r)
    r = re.sub(r"^attn\.to_add_out\.", "attn_txt_out.", r)
    return re.sub(r"^attn\.(norm_q|norm_k|norm_added_q|norm_added_k)\.",
                  r"attn_\1.", r)


def _dit_leaf(n: str) -> str:
    n = n.replace(".", "/")
    if n.endswith("/weight"):
        leaf = ("scale" if re.search(
            r"(^|/)(attn_norm_\w+|norm_q|norm_k|txt_norm)/weight$", n)
            else "kernel")
        n = n[: -len("weight")] + leaf
    return "params/" + n


def qwen_vl_name_to_flax(name: str) -> str:
    """Qwen2_5_VLForConditionalGeneration name (transformers>=4.52:
    ``model.language_model.*`` / ``model.visual.*``) -> reference flax
    path."""
    m = re.match(r"model\.language_model\.(.*)", name)
    if m:
        r = m.group(1)
        r = re.sub(r"^layers\.(\d+)\.", r"layers_\1.", r)
        r = re.sub(r"\.self_attn\.([qkvo])_proj\.", r".\1.", r)
        r = re.sub(r"\.input_layernorm\.", ".attn_norm.", r)
        r = re.sub(r"\.post_attention_layernorm\.", ".mlp_norm.", r)
        r = re.sub(r"\.mlp\.(gate|up|down)_proj\.", r".\1.", r)
        r = r.replace(".", "/")
        if r.endswith("/weight"):
            if r == "embed_tokens/weight":
                leaf = "embedding"
            elif re.search(r"(^|/)(attn_norm|mlp_norm|norm)/weight$", r):
                leaf = "scale"
            else:
                leaf = "kernel"
            r = r[: -len("weight")] + leaf
        return "params/" + r
    m = re.match(r"model\.visual\.(.*)", name)
    if not m:
        raise ValueError(f"not a Qwen2.5-VL tower name: {name!r}")
    r = m.group(1)
    r = re.sub(r"^patch_embed\.proj\.", "patch_proj.", r)
    r = re.sub(r"^blocks\.(\d+)\.", r"blocks_\1.", r)
    r = re.sub(r"\.attn\.", ".", r)
    r = re.sub(r"\.mlp\.(gate|up|down)_proj\.", r".\1.", r)
    r = re.sub(r"^merger\.ln_q\.", "ln_q.", r)
    r = re.sub(r"^merger\.mlp\.0\.", "merger_0.", r)
    r = re.sub(r"^merger\.mlp\.2\.", "merger_2.", r)
    r = r.replace(".", "/")
    if r.endswith("/weight"):
        leaf = ("scale" if re.search(r"(^|/)(norm1|norm2|ln_q)/weight$", r)
                else "kernel")
        r = r[: -len("weight")] + leaf
    return "params/" + r


def t5_name_to_flax(name: str) -> str:
    """HF T5EncoderModel name -> reference flax path (a QuantLinear's
    ``scale`` beside its weight's ``kernel``)."""
    if name == "shared.weight":
        return "params/shared/embedding"
    if name == "encoder.final_layer_norm.weight":
        return "params/final_layer_norm/scale"
    if re.fullmatch(r"encoder\.block\.0\.layer\.0\.SelfAttention\."
                    r"relative_attention_bias\.weight", name):
        return "params/rel_bias"
    m = re.fullmatch(r"encoder\.block\.(\d+)\.layer\.(\d)\.(.*)", name)
    if not m:
        raise ValueError(f"not a T5 encoder name: {name!r}")
    i, layer, r = m.groups()
    if r == "layer_norm.weight":
        return f"params/block_{i}/{('attn_norm', 'ff_norm')[int(layer)]}/" \
            "scale"
    r = re.sub(r"^SelfAttention\.([qkvo])\.", r"attn/\1/", r)
    r = re.sub(r"^DenseReluDense\.(wi_0|wi_1|wo)\.", r"\1/", r)
    return f"params/block_{i}/" + re.sub(r"weight$", "kernel", r)


def birefnet_name_to_flax(name: str) -> str:
    """RMBG-2.0 (BiRefNet) name -> reference flax path; BatchNorm running
    statistics go to the ``batch_stats`` collection."""
    n = name
    n = re.sub(r"^bb\.patch_embed\.proj\.", "bb.patch_embed_proj.", n)
    n = re.sub(r"^bb\.patch_embed\.norm\.", "bb.patch_embed_norm.", n)
    n = re.sub(r"^bb\.layers\.(\d+)\.blocks\.(\d+)\.",
               r"bb.layer_\1_block_\2.", n)
    n = re.sub(r"^bb\.layers\.(\d+)\.downsample\.", r"bb.downsample_\1.", n)
    n = re.sub(r"^bb\.norm(\d)\.", r"bb.out_norm_\1.", n)
    n = re.sub(r"\.mlp\.fc(\d)\.", r".fc\1.", n)
    n = re.sub(r"^squeeze_module\.0\.", "squeeze_module_0.", n)
    n = re.sub(r"^decoder\.decoder_block(\d)\.", r"decoder_block\1.", n)
    n = re.sub(r"^decoder\.lateral_block(\d)\.", r"lateral_block\1.", n)
    n = re.sub(r"^decoder\.gdt_convs_(\d)\.0\.", r"gdt_convs_\1_conv.", n)
    n = re.sub(r"^decoder\.gdt_convs_(\d)\.1\.", r"gdt_convs_\1_bn.", n)
    n = re.sub(r"^decoder\.gdt_convs_attn_(\d)\.0\.",
               r"gdt_convs_attn_\1.", n)
    n = re.sub(r"^decoder\.gdt_convs_pred_(\d)\.0\.",
               r"gdt_convs_pred_\1.", n)
    n = re.sub(r"^decoder\.conv_out1\.0\.", "conv_out1.", n)
    n = n.replace(".", "/")
    if n.endswith("/running_mean"):
        return "batch_stats/" + n[: -len("running_mean")] + "mean"
    if n.endswith("/running_var"):
        return "batch_stats/" + n[: -len("running_var")] + "var"
    if n.endswith("/weight"):
        norm = re.search(r"(^|/)(norm\d?|patch_embed_norm|out_norm_\d|bn_in|"
                         r"bn_out|gdt_convs_\d_bn)/weight$", n)
        n = n[: -len("weight")] + ("scale" if norm else "kernel")
    return "params/" + n


#: the reference's tree of each of TrellisNet's networks
TRELLIS_TREES = {"encoder": "encoder", "struct_flow": "struct",
                 "slat_flow": "slat", "decoder": "decoder"}


def trellis_name_to_flax(name: str) -> str:
    """Port TrellisNet name -> reference flax path (its four trees, each
    ``{'params': ...}``; the transformer blocks' names as the UNet's)."""
    top, rest = name.split(".", 1)
    n = re.sub(r"ff\.net\.0\.proj\.", "ff.proj_in.", rest)
    n = re.sub(r"ff\.net\.2\.", "ff.proj_out.", n)
    n = re.sub(r"to_out\.0\.", "to_out.", n).replace(".", "/")
    if n.endswith("/weight"):
        leaf = "scale" if re.search(r"(^|/)(norm\d|ln)/weight$", n) \
            else "kernel"
        n = n[: -len("weight")] + leaf
    return f"{TRELLIS_TREES[top]}/params/{n}"


#: the HF checkpoint prefixes of the Qwen2.5-VL towers (the newer layout
#: first; ``model.`` alone is the older text prefix)
QWEN_VL_PREFIXES = {"qwen_vl_text": ("model.language_model.", "model."),
                    "qwen_vl_vision": ("model.visual.", "visual.")}


def flax_path(kind: str, name: str, num_levels: int = 0,
              family: str = "qwen"):
    """The reference flax path of a port parameter of a model ``kind``
    (unet, ddnm (the pixel-space UNet), controlnet, vae, adapter, clip_l,
    clip_g, clip_text, clip_vision, dit of the ``family`` qwen or flux,
    qwen_vl_text, qwen_vl_vision, t5, birefnet, trellis), or the tuple of
    paths it takes (lrm, sf3d)."""
    if kind == "birefnet":
        return birefnet_name_to_flax(name)
    if kind == "trellis":
        return trellis_name_to_flax(name)
    if kind == "t5":
        return t5_name_to_flax(name)
    if kind == "dit":
        return (qwen_name_to_flax if family == "qwen"
                else flux_name_to_flax)(name)
    if kind in QWEN_VL_PREFIXES:
        return qwen_vl_name_to_flax(QWEN_VL_PREFIXES[kind][0] + name)
    if kind in ("lrm", "sf3d"):
        return lrm_name_to_flax(name)
    if kind == "clip_vision":
        return clip_vision_name_to_flax(name)
    if kind in ("unet", "ddnm"):
        return sdxl_unet_name_to_flax(name, num_levels)
    if kind == "controlnet":
        return controlnet_name_to_flax(name, num_levels)
    if kind == "vae":
        return vae_name_to_flax(name, num_levels)
    if kind == "adapter":
        return adapter_name_to_flax(name)
    if kind in ("clip_l", "clip_g", "clip_text"):
        return clip_name_to_flax(name)
    raise ValueError(f"unknown model kind {kind!r}")


def _levels(module: nn.Module) -> int:
    cfg = getattr(module, "cfg", None)
    return len(getattr(cfg, "block_out_channels", ()))


def _flatten(tree, prefix=()) -> Iterator[Tuple[Tuple[str, ...], object]]:
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _flatten(v, prefix + (str(k),))
    else:
        yield prefix, tree


def flax_layout(name: str, leaf: np.ndarray) -> np.ndarray:
    """A reference leaf in the port's layout: conv kernels HWIO -> OIHW,
    the triplane deconvolution's HWIO -> ConvTranspose2d's (in, out, kh,
    kw), dense kernels (in, out) -> (out, in), a packed int4 kernel
    (in / 2, out) -> (out, in / 2) (each byte keeps its two inputs, so the
    transpose is the port's packing); others as they are."""
    if name.endswith("/deconv/kernel"):
        return leaf.transpose(2, 3, 0, 1)
    if name.endswith("/kernel_p4"):
        return leaf.T
    if name.endswith("/kernel"):
        return leaf.T if leaf.ndim == 2 else leaf.transpose(3, 2, 0, 1)
    return leaf


def from_flax(kind: str, flax_params, module: nn.Module
              ) -> Dict[str, torch.Tensor]:
    """State dict for ``module`` (a port model of ``kind``) from the
    reference's parameter tree ({'params': ...} with numpy leaves), its
    quantised leaves (an int8 ``kernel`` or a packed ``kernel_p4`` with its
    ``scale``) included.  Raises on a port parameter with no leaf, a shape
    that disagrees, or a leaf no port parameter takes."""
    flat = {"/".join(p): np.asarray(v) for p, v in _flatten(flax_params)}
    levels = _levels(module)
    family = getattr(getattr(module, "cfg", None), "family", "qwen")
    out = {}
    for name, p in module.state_dict().items():
        paths = flax_path(kind, name, levels, family)
        paths = (paths,) if isinstance(paths, str) else paths
        if len(paths) == 1 and paths[0] not in flat \
                and f"{paths[0]}_p4" in flat:
            paths = (f"{paths[0]}_p4",)
        for path in paths:
            if path not in flat:
                raise KeyError(f"[{kind}] {name} -> {path}: no such leaf")
        a = np.concatenate([flax_layout(path, flat.pop(path))
                            for path in paths])
        if name == "patch_embed.proj.weight":   # Conv3D, flattened there
            a = a.reshape(tuple(p.shape))
        if a.shape != tuple(p.shape):
            raise ValueError(f"[{kind}] {name}: shape {a.shape} vs "
                             f"{tuple(p.shape)}")
        out[name] = torch.from_numpy(np.ascontiguousarray(a))
    if flat:
        raise ValueError(f"[{kind}] leaves no port parameter takes: "
                         f"{sorted(flat)[:8]}")
    return out


# ------------------------------------------------------- safetensors

_ST_DTYPES = {"F64": np.float64, "F32": np.float32, "F16": np.float16,
              "BF16": np.uint16, "I64": np.int64, "I32": np.int32,
              "I16": np.int16, "I8": np.int8, "U8": np.uint8,
              "BOOL": np.bool_}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A .safetensors file: an 8-byte little-endian header length, a JSON
    header (dtype, shape, data offsets of each tensor), then the data."""
    out = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        with mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as mm:
            for name, info in header.items():
                if name == "__metadata__":
                    continue
                dt = np.dtype(_ST_DTYPES[info["dtype"]])
                b, e = info["data_offsets"]
                a = np.frombuffer(mm, dtype=dt, count=(e - b) // dt.itemsize,
                                  offset=8 + n + b).copy()
                t = torch.from_numpy(a)
                if info["dtype"] == "BF16":
                    t = t.view(torch.bfloat16)
                out[name] = t.reshape(info["shape"])
    return out


def load_safetensors_dir(path: str) -> Dict[str, torch.Tensor]:
    out = {}
    for fn in sorted(os.listdir(path)):
        if fn.endswith(".safetensors"):
            out.update(read_safetensors(os.path.join(path, fn)))
    return out


def load_sdxl_controlnet(weights_dir: str, unet: nn.Module,
                         controlnet: nn.Module | None = None,
                         vae: nn.Module | None = None) -> None:
    """Load ``<weights_dir>/unet``, ``/controlnet`` (strict: every name,
    every shape) and ``/vae`` where they exist.  The VAE loads non-strict,
    as in the reference: its mid-block attention has no q/k/v bias, which
    a diffusers VAE carries; the misses are printed."""
    for sub, mod in (("unet", unet), ("controlnet", controlnet)):
        p = os.path.join(weights_dir, sub)
        if mod is not None and os.path.isdir(p):
            mod.load_state_dict(load_safetensors_dir(p), strict=True)
    p = os.path.join(weights_dir, "vae")
    if vae is not None and os.path.isdir(p):
        missing, unexpected = vae.load_state_dict(load_safetensors_dir(p),
                                                  strict=False)
        if missing or unexpected:
            print(f"[weights:vae] missing {missing[:5]}, unexpected "
                  f"{unexpected[:5]}")


def load_clip_towers(weights_dir: str, model_l: nn.Module,
                     model_g: nn.Module) -> None:
    """Load ``<weights_dir>/text_encoder`` (CLIP-L) and ``/text_encoder_2``
    (OpenCLIP-G) where they exist, strictly."""
    for sub, mod in (("text_encoder", model_l), ("text_encoder_2", model_g)):
        p = os.path.join(weights_dir, sub)
        if os.path.isdir(p):
            sd = load_safetensors_dir(p)
            sd.pop("text_model.embeddings.position_ids", None)
            mod.load_state_dict(sd, strict=True)


def load_instantmesh(weights_dir: str, backend) -> None:
    """Load the InstantMesh LRM and the zero123plus towers of an
    ``InstantMeshBackend`` where their directories exist, strictly:
    ``<weights_dir>/instantmesh`` (lrm_generator keys, the prefix
    stripped), ``zero123plus_unet``, ``zero123plus_vae``,
    ``zero123plus_text_encoder`` and ``zero123plus_vision_encoder``; and
    the ``ramping_coefficients`` of the first of
    ``zero123plus_config.json``, ``model_index.json`` and
    ``config.json`` that has them."""
    for sub, mod in (("instantmesh", backend.lrm),
                     ("zero123plus_unet", backend.unet),
                     ("zero123plus_vae", backend.vae),
                     ("zero123plus_text_encoder", backend.clip_text),
                     ("zero123plus_vision_encoder", backend.clip_vision)):
        p = os.path.join(weights_dir, sub)
        if not os.path.isdir(p):
            continue
        sd = load_safetensors_dir(p)
        if sub == "instantmesh":
            sd = {k[len("lrm_generator."):] if k.startswith(
                "lrm_generator.") else k: v for k, v in sd.items()}
        sd.pop("text_model.embeddings.position_ids", None)
        sd.pop("vision_model.embeddings.position_ids", None)
        mod.load_state_dict(sd, strict=True)
    for fn in ("zero123plus_config.json", "model_index.json", "config.json"):
        fp = os.path.join(weights_dir, fn)
        if os.path.exists(fp):
            with open(fp) as f:
                ramp = json.load(f).get("ramping_coefficients")
            if ramp is not None:
                # fp32, as the reference loads them, whatever the weights'
                # dtype
                backend.ramping = torch.as_tensor(
                    np.asarray(ramp, np.float32), device=backend.device)
                return


def convert_birefnet(tensors: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """An RMBG-2.0 checkpoint as BiRefNet's state dict: its names are the
    port's; the registered buffers the port computes
    (``relative_position_index``, ``attn_mask``) and the BatchNorm
    counters are dropped, the running statistics kept."""
    return {k: v for k, v in tensors.items()
            if not k.endswith(("relative_position_index", "attn_mask",
                               "num_batches_tracked"))}


def load_matting(weights_dir: str, net: nn.Module) -> None:
    """Load ``<weights_dir>/rmbg`` (the RMBG-2.0 safetensors) into a
    BiRefNet where it exists, strictly."""
    p = os.path.join(weights_dir, "rmbg")
    if os.path.isdir(p):
        net.load_state_dict(convert_birefnet(load_safetensors_dir(p)),
                            strict=True)


def saved_name(path: str) -> str:
    """The tensor name a checkpoint saved from the reference's trees
    gives a flax path: dots for slashes, ``weight`` for ``kernel`` (the
    reference's generic rename table, read backwards)."""
    n = path.replace("/", ".")
    return n[: -len("kernel")] + "weight" if n.endswith(".kernel") else n


def load_saved(kind: str, module: nn.Module,
               tensors: Dict[str, torch.Tensor], strict: bool = True
               ) -> None:
    """Load a checkpoint saved from the reference's architecture of a
    model ``kind`` (TRELLIS, SF3D, the DDNM UNet: torch-layout tensors
    named by ``saved_name`` of their flax paths; a fused port parameter
    takes its paths' tensors concatenated).  ``strict``: raise on a
    missing or a left-over tensor; otherwise print them and load the
    rest (the reference's DDNM load)."""
    levels = _levels(module)
    state, missing, left = {}, [], dict(tensors)
    for name in module.state_dict():
        paths = flax_path(kind, name, levels)
        names = [saved_name(p) for p in
                 ((paths,) if isinstance(paths, str) else paths)]
        if all(n in left for n in names):
            state[name] = torch.cat([left.pop(n) for n in names])
        else:
            missing.append(name)
    if strict and (missing or left):
        raise ValueError(f"[{kind}] missing {missing[:8]}, unexpected "
                         f"{sorted(left)[:8]}")
    if missing or left:
        print(f"[weights:{kind}] missing {missing[:5]}, unexpected "
              f"{sorted(left)[:5]}")
    module.load_state_dict(state, strict=strict)


def load_trellis(weights_dir: str, net: nn.Module) -> None:
    """Load ``<weights_dir>/trellis``, a checkpoint saved from this
    architecture (no public TRELLIS checkpoint fits it), strictly."""
    p = os.path.join(weights_dir, "trellis")
    if os.path.isdir(p):
        load_saved("trellis", net, load_safetensors_dir(p))


def load_sf3d(weights_dir: str, net: nn.Module) -> None:
    """Load ``<weights_dir>/sf3d``, a checkpoint saved from this
    architecture (no public Stable-Fast-3D checkpoint fits it),
    strictly."""
    p = os.path.join(weights_dir, "sf3d")
    if os.path.isdir(p):
        load_saved("sf3d", net, load_safetensors_dir(p))


def load_ddnm(weights_dir: str, unet: nn.Module) -> None:
    """Load ``<weights_dir>/ddnm`` into the DDNM UNet where it exists,
    non-strictly as the reference does (the misses are printed)."""
    p = os.path.join(weights_dir, "ddnm")
    if os.path.isdir(p):
        load_saved("ddnm", unet, load_safetensors_dir(p), strict=False)


def _load(module: nn.Module, state, select) -> None:
    """Strict load: directly into a full-precision module, through
    ``load_quantized`` into one with QuantLinear layers."""
    if any(isinstance(m, QuantLinear) for m in module.modules()):
        load_quantized(module, state, select)
    else:
        module.load_state_dict(state, strict=True)


def load_dit(weights_dir: str, backend, variant: str) -> None:
    """Load ``<weights_dir>/<variant>`` (the diffusers
    QwenImageTransformer2DModel or FluxTransformer2DModel safetensors)
    into ``backend.model`` where it exists, strictly; a quantised MMDiT
    takes the full-precision checkpoint and quantises its block
    matmuls."""
    p = os.path.join(weights_dir, variant)
    if os.path.isdir(p):
        _load(backend.model, load_safetensors_dir(p), dit_block_select)


def load_t5_and_clip_l(weights_dir: str, t5: nn.Module, clip_l: nn.Module
                       ) -> None:
    """Load the FLUX text towers where their directories exist, strictly:
    ``<weights_dir>/text_encoder_2`` (T5-XXL, its tied
    ``encoder.embed_tokens`` duplicate dropped; quantised as ``t5`` is)
    and ``/text_encoder`` (CLIP-L)."""
    p = os.path.join(weights_dir, "text_encoder_2")
    if os.path.isdir(p):
        sd = load_safetensors_dir(p)
        sd.pop("encoder.embed_tokens.weight", None)
        _load(t5, sd, t5_block_select)
    p = os.path.join(weights_dir, "text_encoder")
    if os.path.isdir(p):
        sd = load_safetensors_dir(p)
        sd.pop("text_model.embeddings.position_ids", None)
        clip_l.load_state_dict(sd, strict=True)


def load_qwen_vl(weights_dir: str, text: nn.Module, vision: nn.Module
                 ) -> None:
    """Load ``<weights_dir>/text_encoder`` (Qwen2_5_VLForConditionalGeneration
    safetensors, either prefix layout) into the two towers where it
    exists, strictly (quantised as the towers are); ``lm_head`` (the
    encoder never computes logits) and rotary buffers are dropped."""
    p = os.path.join(weights_dir, "text_encoder")
    if not os.path.isdir(p):
        return
    parts = {kind: {} for kind in QWEN_VL_PREFIXES}
    for k, v in load_safetensors_dir(p).items():
        if k == "lm_head.weight" or "rotary_emb" in k:
            continue
        # the vision prefixes first: "model." also starts "model.visual."
        for kind in ("qwen_vl_vision", "qwen_vl_text"):
            pre = next((x for x in QWEN_VL_PREFIXES[kind]
                        if k.startswith(x)), None)
            if pre is not None:
                parts[kind][k[len(pre):]] = v
                break
        else:
            raise ValueError(f"[qwen_vl] unexpected tensor {k!r}")
    _load(text, parts["qwen_vl_text"], vl_block_select)
    _load(vision, parts["qwen_vl_vision"], vl_block_select)
