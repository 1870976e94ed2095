"""The reference against the port's host path at a tiny size, layer by
layer: the depth images, the generated images, the completions, the
fused clouds and the scores of both cells' paths agree exactly, once the
port's host EMD bid takes the form K3 computes on the card."""

import pytest

from portbench_tiny import SEED, TINY, host_k3, tiny_cell


@pytest.mark.parametrize("name", ["redwood_reg13", "redwood_aligned13"])
def test_reference_matches_port_on_host(name, tmp_path, monkeypatch):
    import torch
    from portbench import harness
    from portbench.reference import judge
    torch.set_num_threads(4)
    host_k3(monkeypatch)
    cell = tiny_cell(name, objects=2, checked=2)
    ent = harness.entry(cell)
    flags = harness.write_inputs(cell, tmp_path / "data", SEED)
    cfg = ent.port_config(harness.cell_overrides(cell, "cpu", TINY))
    with ent.recording() as made:
        scores = ent.run(cfg, flags, str(tmp_path / "data"))
        got = {a.flag: a for a in made}
    ref_scores, ref = harness.reference_records(
        cell, flags, flags, str(tmp_path / "data"), "cpu", overrides=TINY)
    spec = harness.check_spec(cell)
    nums = judge.numbers(spec, got, [scores], ref, ref_scores, "cpu")
    assert nums == {k: 0.0 for k in spec["numbers"]}
    # every field the check compares is there
    for f in flags:
        for num in spec["numbers"].values():
            for field in num.get("fields", ()):
                assert getattr(got[f], field) is not None
