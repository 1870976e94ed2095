"""The FLUX cell's check at a tiny size on the host: one pass of the
port's ``run_batched`` with the FLUX inpainter and generator at their
tiny preset (int4 weights, the port's bf16 compute types) held to the
plain fp32 reference by ``checks/flux.json``'s numbers.  Every compared
field is on both records, every number is finite, and the first-step
velocities agree to bf16's rounding (at most 1 % of the largest
velocity; about 0.3 % seen)."""

import math

from portbench_tiny import SEED, TINY, host_k3, tiny_cell


def test_flux_reference_matches_port_on_host(tmp_path, monkeypatch):
    import numpy as np
    import torch
    from portbench import harness
    from portbench.reference import judge
    torch.set_num_threads(4)
    host_k3(monkeypatch)
    cell = tiny_cell("flux_reg3", objects=2, checked=2)
    tiny = dict(TINY, model_size="tiny")
    ent = harness.entry(cell)
    flags = harness.write_inputs(cell, tmp_path / "data", SEED)
    cfg = ent.port_config(harness.cell_overrides(cell, "cpu", tiny))
    with ent.recording() as made:
        scores = ent.run(cfg, flags, str(tmp_path / "data"))
        got = {a.flag: a for a in made}
    ref_scores, ref = harness.reference_records(
        cell, flags, flags, str(tmp_path / "data"), "cpu", overrides=tiny)
    spec = harness.check_spec(cell)
    nums = judge.numbers(spec, got, [scores], ref, ref_scores, "cpu")
    assert all(math.isfinite(v) for v in nums.values()), nums
    for f in flags:
        for num in spec["numbers"].values():
            for field in num.get("fields", ()):
                assert getattr(got[f], field) is not None, field
                assert getattr(ref[f], field) is not None, field
    for key, field in (("paint_v0_gap", "paint_v0"),
                       ("gen_v0_gap", "gen_v0")):
        largest = max(np.abs(getattr(ref[f], field)).max() for f in flags)
        assert nums[key] <= 0.01 * largest, (key, nums[key], largest)
