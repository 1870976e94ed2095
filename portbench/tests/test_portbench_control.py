"""On the card: the control, the reference in TF32 put in the port's
place, comes out not correct.  It runs the aligned cell's configuration
at its own widths over two objects on three seeds (at the CPU tests'
tiny shapes the symmetry search finds no plane, and TF32 then changes
nothing).  Skips without a CUDA device."""

import pytest

from portbench_tiny import tiny_cell


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2 ** 31 + 101, 7, 123456789])
def test_control_is_not_correct(seed, tmp_path):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: TF32 exists only on the card")
    from portbench import harness
    from portbench.control import control_numbers
    from portbench.reference import judge
    cell = tiny_cell("redwood_aligned13", objects=2, checked=2)
    cell["traffic"]["gt_points"] = 163840
    nums = control_numbers(cell, seed, "cuda", tmp_root=str(tmp_path))
    assert not judge.verdict(harness.check_spec(cell), nums), nums
