"""``flux_pass_mfu``: the FLUX MMDiT's share of the card's dense bf16
peak over a pass, in percent: the closed-form FLOPs of every paint and
generation step of the pass (``flux_flops.pass_flops``, from the
``inpaint`` and ``denoise`` spans' row and position counters: the
block linears and attention at the published widths; the embedders, the
final layer, the modulations, T5, CLIP-L and the VAE left out) over the
pass's wall and 989.4 TFLOP/s (H100 SXM), as the mean over the traced
window's passes; nothing where no pass has the counters (a program
without them, or a pass without a FLUX backend)."""

from portbench import flux_flops


def read(record):
    shares = []
    for p in record["passes"]:
        flops = flux_flops.pass_flops(p.get("timings") or {})
        if flops:
            shares.append(100.0 * flops / p["seconds"] / flux_flops.BF16_PEAK)
    return sum(shares) / len(shares) if shares else None
