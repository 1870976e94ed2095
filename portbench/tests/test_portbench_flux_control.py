"""On the card: the FLUX check's control (``flux_control.py``: the plain
reference with fp8 e4m3 inputs to every linear layer and attention, the
int4 weights kept) comes out not correct for ``flux_reg3`` at its own
widths and sizes, on three seeds, through a first-step velocity.  About
six minutes a seed (two fp32-sized references of 3 objects).  Skips
without a CUDA device."""

import pytest

import portbench_tiny  # noqa: F401  (the checkout on sys.path)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2 ** 31 + 103, 11, 987654321])
def test_flux_control_is_not_correct(seed, tmp_path):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the reference runs FLUX.1-Depth-"
                    "dev at its published widths")
    from portbench import harness
    from portbench.flux_control import control_numbers
    from portbench.reference import judge
    cell = harness.load_cell("flux_reg3")
    spec = harness.check_spec(cell)
    nums = control_numbers(cell, seed, "cuda", tmp_root=str(tmp_path))
    assert not judge.verdict(spec, nums), nums
    assert any(nums[k] > spec["numbers"][k]["limit"]
               for k in ("paint_v0_gap", "gen_v0_gap")), nums
