"""Weight-only int8/int4 quantisation of the big transformers (counterpart
of genpc_tpu/models/quant.py).

The full-size presets of both DiT backends run, as the reference's
default, with every block matmul quantised: the FLUX and Qwen-Image
MMDiTs, T5-XXL and the Qwen2.5-VL towers.  The scheme is the
reference's, bit for bit:
  * symmetric, per output channel: ``scale = max|w| / qmax`` (qmax 127
    for int8, 7 for int4) floored at 1e-12, ``q = clip(round(w /
    scale))`` with round half to even;
  * int4 packs two signed nibbles into one int8 byte along the input
    dimension: input 2i in the low nibble, 2i+1 in the high one.  A torch
    weight is [out, in], so a packed int4 weight is [out, in / 2] (the
    reference stores its kernel transposed, [in / 2, out]);
  * ``QuantLinear`` keeps the int weight, an fp32 scale [out] and an fp32
    bias, multiplies in the compute type with fp32 accumulation into an
    fp32 product, applies the scale after the product, adds the bias and
    casts to the compute type.

An int4 layer is ``w4_linear``: on the card one launch of kernel K6
(``csrc/w4_gemm.cu``), which reads the packed weight as stored, makes
the codes in registers, multiplies (tensor cores for a bf16 layer, fp32
CUDA cores for an fp32 one) and applies
scale, bias and cast in its epilogue, so no dequantised weight or fp32
product reaches device memory.  On the CPU it is ``w4_linear_plain``,
the reference's XLA sequence in torch: an unpack, a convert, the
product in fp32 from the compute-type operands (the products are exact
in fp32, so only the summation order differs from the kernel), the
scale and bias in fp32.  An int8 layer converts its weight to the
compute type inside ``forward`` (on the card cuBLAS's bf16 GEMM with an
fp32 output, ``torch.mm(..., out_dtype=torch.float32)``).
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from genpc_tpu_torch import _kernels, tracing
from genpc_tpu_torch.models.layers import BF16, F32

#: the largest code of each width (symmetric: -qmax..qmax)
QMAX = {8: 127, 4: 7}


def resolve_quant_bits(bits, full: bool) -> int:
    """The reference's default of a weight-only quantisation setting
    (None: int4 at full size, bf16 below; an explicit value wins); 0, 8
    and 4 build, any other value raises, as the reference's ``_QMAX``
    lookup does."""
    bits = int((4 if full else 0) if bits is None else bits)
    if bits and bits not in QMAX:
        raise ValueError(f"weight-only quantization to {bits} bits: only "
                         f"8 and 4 (or 0 for bf16) exist")
    return bits


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """[out, in] signed 4-bit codes (any int dtype) -> [out, in / 2] int8:
    input 2i in the low nibble, 2i+1 in the high one."""
    if q.shape[-1] % 2:
        raise ValueError(f"odd input dim {tuple(q.shape)} cannot pack int4")
    q = q.to(torch.int32)
    return ((q[..., 0::2] & 0xF) | ((q[..., 1::2] & 0xF) << 4)).to(
        torch.int8)


def unpack_int4(packed: torch.Tensor, dtype: torch.dtype = torch.int8
                ) -> torch.Tensor:
    """Inverse of ``pack_int4``: [out, in / 2] int8 -> [out, in] in
    ``dtype``; an arithmetic shift sign-extends each nibble.  The nibbles
    interleave into a contiguous int8 matrix first, so that the convert
    is one contiguous pass."""
    pairs = torch.stack([(packed << 4) >> 4, packed >> 4], dim=-1)
    return pairs.view(packed.shape[:-1] + (-1,)).to(dtype)


def quantize_array(w: torch.Tensor, bits: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A weight [out, in] -> (q, scale [out] fp32): q int8 [out, in] at 8
    bits, nibble-packed [out, in / 2] at 4; dequant(q, s) = q * s[:, None]."""
    qmax = QMAX[bits]
    w = w.to(F32)
    scale = torch.clamp_min(w.abs().amax(dim=-1) / qmax, 1e-12)
    q = torch.clamp(torch.round(w / scale[:, None]), -qmax, qmax)
    return (pack_int4(q) if bits == 4 else q.to(torch.int8)), scale


def dequantize_array(q: torch.Tensor, scale: torch.Tensor,
                     dtype: torch.dtype = F32, bits: int = 8
                     ) -> torch.Tensor:
    if bits == 4:
        q = unpack_int4(q)
    return q.to(dtype) * scale.to(dtype)[:, None]


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., in] @ w[out, in].T with fp32 accumulation and an fp32
    result, both operands in one compute type."""
    if x.dtype == F32:
        return F.linear(x, w)
    if x.device.type == "cpu":
        return F.linear(x.to(F32), w.to(F32))
    y = torch.mm(x.reshape(-1, x.shape[-1]), w.t(), out_dtype=F32)
    return y.reshape(x.shape[:-1] + (w.shape[0],))


def _scale_bias(y: torch.Tensor, scale: torch.Tensor,
                bias: Optional[torch.Tensor]) -> torch.Tensor:
    """The fp32 epilogue: y * scale, plus bias when there is one."""
    return y * scale if bias is None else torch.addcmul(bias, y, scale)


def w4_linear_plain(x: torch.Tensor, weight: torch.Tensor,
                    scale: torch.Tensor, bias: Optional[torch.Tensor]
                    ) -> torch.Tensor:
    """K6's plain twin: x [..., in] in the compute type, the packed int4
    weight [out, in / 2], fp32 scale and bias [out] -> [..., out] in
    x's dtype; the weight unpacked and converted whole, the product in
    fp32, then scale and bias in fp32."""
    c = x.dtype
    y = matmul_f32(x, unpack_int4(weight, c))
    return _scale_bias(y, scale, bias).to(c)


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index
                                            ).multi_processor_count


def w4_linear(x: torch.Tensor, weight: torch.Tensor, scale: torch.Tensor,
              bias: Optional[torch.Tensor]) -> torch.Tensor:
    """An int4 layer in x's dtype (bf16 or fp32): ``w4_linear_plain`` for
    a CPU tensor, kernel K6 for a CUDA tensor; any other device raises.
    Counts ``quant_w4_plain`` (``tracing.count``) a plain call; K6's
    wrappers count ``quant_w4`` a launch, a CUDA graph's at each replay."""
    if x.device.type == "cpu":
        tracing.count("quant_w4_plain")
        return w4_linear_plain(x, weight, scale, bias)
    if x.device.type != "cuda":
        raise ValueError(f"w4_linear: no kernel for device {x.device}")
    c, k = x.dtype, x.shape[-1]
    n = weight.shape[0]
    if c not in (BF16, F32):
        raise TypeError(f"w4_linear: compute dtype {c} (bf16 or fp32)")
    if weight.dtype != torch.int8 or weight.ndim != 2 or \
            k != 2 * weight.shape[1] or weight.data_ptr() % 4:
        raise ValueError(f"w4_linear: x [..., {k}] against a packed weight "
                         f"{tuple(weight.shape)} {weight.dtype} (4-byte "
                         f"aligned)")
    for name, t in (("weight", weight), ("scale", scale), ("bias", bias)):
        if t is None:
            continue
        if t.device != x.device or not t.is_contiguous() or \
                (name != "weight" and (t.dtype != F32 or t.shape != (n,))):
            raise ValueError(f"w4_linear: {name} {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}, x on {x.device}")
    x2 = x.reshape(-1, k)
    m = x2.shape[0]
    y = torch.empty((m, n), dtype=c, device=x.device)
    if c == F32:
        _w4_gemv(x2.contiguous(), weight, scale, bias, y)
    else:
        _w4_gemm(x2, weight, scale, bias, y)
    return y.reshape(x.shape[:-1] + (n,))


#: K6's tensor-core tiles: the rows of x a block takes (against 128
#: weight rows)
W4_ROW_TILES = (256, 192, 64)


#: the time of a K6 block of 256 and of 192 rows, in rows of the former
#: (the smaller takes longer a row; fitted to its times on an H100)
_W4_TILE_COST = {256: 256, 192: 215}


def w4_row_tile(m: int, n: int, sms: int) -> int:
    """The rows of x a K6 block takes for y [m, n] on a card of ``sms``
    SMs (one block an SM): of 256 and 192 rows, the one whose waves of
    blocks take the least time, unless both give fewer than half the SMs
    a block; then 64 (two blocks an SM)."""
    tiles = -(-n // 128)
    cost = {bm: -(-(-(-m // bm) * tiles) // sms) * c
            for bm, c in _W4_TILE_COST.items()
            if -(-m // bm) * tiles >= sms // 2}
    return min(cost, key=lambda bm: (cost[bm], -bm)) if cost else 64


def _w4_gemm(x: torch.Tensor, weight: torch.Tensor, scale: torch.Tensor,
             bias: Optional[torch.Tensor], y: torch.Tensor,
             bm: Optional[int] = None) -> None:
    """K6's tensor-core path into y [M, N] (bf16), ``bm`` rows of x a
    block (``w4_row_tile`` unless given: tests force each; 64 where the
    weight's rows are not 16-byte aligned, K not a multiple of 32).  TMA
    reads x's rows 16-byte aligned: x goes first into rows of a padded
    pitch where they are not."""
    m, k = x.shape
    n = weight.shape[0]
    ldx = -(-k // 8) * 8
    if ldx != k or not x.is_contiguous() or x.data_ptr() % 16:
        xp = x.new_empty((m, ldx))
        xp[:, :k] = x
        x = xp
    if bm is None:
        dev = x.device.index if x.device.index is not None \
            else torch.cuda.current_device()
        bm = 64 if k % 32 or weight.data_ptr() % 16 else \
            w4_row_tile(m, n, _sm_count(dev))
    with torch.cuda.device(x.device), \
            _kernels.traced(_w4_gemm, (m, n, k)):
        rc = _kernels.lib().genpc_w4_gemm(
            x.data_ptr(), weight.data_ptr(), scale.data_ptr(),
            _kernels.ptr(bias), y.data_ptr(), m, n, k, ldx, bm,
            _kernels.stream(x))
    _kernels.check(rc, "genpc_w4_gemm")


def _w4_gemv(x: torch.Tensor, weight: torch.Tensor, scale: torch.Tensor,
             bias: Optional[torch.Tensor], y: torch.Tensor) -> None:
    """K6's CUDA-core path into y [M, N] (x and y fp32): one row of x a
    block for M = 1, else 4."""
    m, k = x.shape
    n = weight.shape[0]
    mt = 1 if m == 1 else 4
    with torch.cuda.device(x.device), \
            _kernels.traced(_w4_gemv, (m, n, k)):
        rc = _kernels.lib().genpc_w4_gemv(
            x.data_ptr(), weight.data_ptr(), scale.data_ptr(),
            _kernels.ptr(bias), y.data_ptr(), m, n, k, mt,
            _kernels.stream(x))
    _kernels.check(rc, "genpc_w4_gemv")


_w4_gemm.launches, _w4_gemm.trace, _w4_gemm.counter = 0, None, "quant_w4"
_w4_gemv.launches, _w4_gemv.trace, _w4_gemv.counter = 0, None, "quant_w4"


class QuantLinear(nn.Module):
    """A dense layer with an int8 or packed-int4 weight, a per-output
    fp32 scale and an fp32 bias (buffers: the weight is not trained),
    computing in ``compute`` (the counterpart of ``QuantDense``)."""

    def __init__(self, in_features: int, out_features: int, bits: int,
                 bias: bool = True, compute: torch.dtype = BF16):
        super().__init__()
        if bits not in QMAX:
            raise ValueError(f"QuantLinear bits {bits}: 8 or 4")
        if bits == 4 and in_features % 2:
            raise ValueError(f"int4 needs an even input dim, got "
                             f"{in_features}")
        self.in_features, self.out_features = in_features, out_features
        self.bits, self.compute = bits, compute
        cols = in_features // 2 if bits == 4 else in_features
        self.register_buffer("weight", torch.empty(
            out_features, cols, dtype=torch.int8))
        self.register_buffer("scale", torch.empty(out_features, dtype=F32))
        self.register_buffer("bias", torch.empty(out_features, dtype=F32)
                             if bias else None)

    def forward(self, x):
        c = self.compute
        if self.bits == 4:
            return w4_linear(x.to(c), self.weight, self.scale, self.bias)
        y = matmul_f32(x.to(c), self.weight.to(c))
        return _scale_bias(y, self.scale, self.bias).to(c)

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, out_features="
                f"{self.out_features}, bits={self.bits}, bias="
                f"{self.bias is not None}")


# ------------------------------------------------------------ selectors
# Each takes a parameter name of the port module (the checkpoint's) and
# says whether its 2-D weight lies in the quantisation domain; embeddings,
# norms, embedders and output heads stay in full precision.

def dit_block_select(name: str) -> bool:
    """MMDiT: every matmul of the double- and single-stream blocks (the
    attention projections, the MLPs, the AdaLN modulations)."""
    return name.startswith(("transformer_blocks.",
                            "single_transformer_blocks."))


def t5_block_select(name: str) -> bool:
    """T5 encoder: q/k/v/o and wi_0/wi_1/wo of every block, not the
    relative-position bias table that block 0 holds."""
    return (name.startswith("encoder.block.")
            and "relative_attention_bias" not in name)


def vl_block_select(name: str) -> bool:
    """Qwen2.5-VL: the text tower's ``layers.*`` and the vision tower's
    ``blocks.*`` matmuls; the patch embedding and the merger stay."""
    return name.startswith(("layers.", "blocks."))


def _quantized(name: str, t: torch.Tensor, select) -> bool:
    return name.endswith(".weight") and t.ndim == 2 and select(
        name[: -len(".weight")])


def quantize_state(state: Mapping[str, torch.Tensor], bits: int,
                   select: Callable[[str], bool], device=None
                   ) -> Dict[str, torch.Tensor]:
    """A full-precision state dict -> the quantised module's (counterpart
    of ``quantize_tree``): each selected 2-D ``<m>.weight`` becomes its
    int codes and gains ``<m>.scale``; every other tensor passes through
    unchanged.  One tensor is converted at a time, on ``device`` (its own
    by default)."""
    out = {}
    for name, t in state.items():
        if _quantized(name, t, select):
            m = name[: -len(".weight")]
            out[name], out[f"{m}.scale"] = quantize_array(t.to(device),
                                                          bits)
        else:
            out[name] = t
    return out


def fp_template_like(module: nn.Module) -> Dict[str, torch.Size]:
    """The full-precision names and shapes a (possibly quantised) module
    takes from a checkpoint (counterpart of ``fp_template_like``): each
    QuantLinear's weight as [out, in], without its scale."""
    quant = {n for n, m in module.named_modules()
             if isinstance(m, QuantLinear)}
    out = {}
    for name, t in module.state_dict().items():
        owner, _, leaf = name.rpartition(".")
        if owner in quant:
            if leaf == "scale":
                continue
            if leaf == "weight":
                m = module.get_submodule(owner)
                out[name] = torch.Size((m.out_features, m.in_features))
                continue
        out[name] = t.shape
    return out


def load_quantized(module: nn.Module, state: Mapping[str, torch.Tensor],
                   select: Callable[[str], bool]) -> None:
    """Load a full-precision checkpoint ``state`` into a quantised
    ``module``, as the reference does: checked against
    ``fp_template_like`` (every name, every shape), then quantised
    tensor by tensor on the module's device (``quantize_state``) and
    loaded strictly, so a selector that disagrees with the module's
    layers fails."""
    want = fp_template_like(module)
    missing = sorted(set(want) - set(state))
    extra = sorted(set(state) - set(want))
    bad = [k for k in want if k in state
           and tuple(state[k].shape) != tuple(want[k])]
    if missing or extra or bad:
        raise ValueError(f"checkpoint vs {type(module).__name__}: missing "
                         f"{missing[:5]}, unexpected {extra[:5]}, shapes "
                         f"{bad[:5]}")
    bits = next(m.bits for m in module.modules()
                if isinstance(m, QuantLinear))
    dev = next(iter(module.state_dict().values())).device
    module.load_state_dict(quantize_state(state, bits, select, dev),
                           strict=True)


def logical_params(module: nn.Module) -> int:
    """The parameter count of the module at full precision: its
    parameters, plus each QuantLinear's weight and bias as [out, in] and
    [out] (the reference's count of its unquantised tree)."""
    n = sum(p.numel() for p in module.parameters())
    for m in module.modules():
        if isinstance(m, QuantLinear):
            n += m.out_features * (m.in_features + (m.bias is not None))
    return n


def tree_bytes(module: nn.Module) -> int:
    """Bytes of a module's parameters and buffers (a packed int4 weight
    is int8 at half the element count, so the count is exact)."""
    return sum(t.numel() * t.element_size()
               for t in list(module.parameters()) + list(module.buffers()))
