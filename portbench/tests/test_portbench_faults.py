"""A run whose timed path is broken underneath comes out not correct.

Each test drives the rest of a run on the host (the harness's look for a
card skipped, tiny shapes), with one fault planted in the port, and sees
``correct`` false; one sound run sees it true.  The faults: a step that
returns its state unchanged (the pose optimisation on the registration
path, the depth fill on the aligned path), half of each object's points
left out of the metric with the mean taken over the rest, and an answer
altered where it is produced (an object's CD); ``portbench/faults.py``
plants them.  One card runs the cells, so there is no exchange between
chips to leave out."""

import pytest

from portbench_tiny import host_k3, run_tiny
from portbench import faults


FAULTS = [("redwood_reg13", "pose_unchanged"),
          ("redwood_aligned13", "fill_unchanged"),
          ("redwood_reg13", "half_the_points"),
          ("redwood_aligned13", "cd_altered")]


@pytest.mark.parametrize("name", ["redwood_reg13", "redwood_aligned13"])
def test_sound_run_is_correct(name, tmp_path, monkeypatch):
    host_k3(monkeypatch)
    run = run_tiny(name, tmp_path, objects=1, checked=1)
    assert run["correct"], run["numbers"]
    assert run["attempted"] >= 1 and run["failed"] == 0


@pytest.mark.parametrize("name,fault", FAULTS,
                         ids=[f"{n}-{f}" for n, f in FAULTS])
def test_fault_is_caught(name, fault, tmp_path, monkeypatch):
    host_k3(monkeypatch)
    faults.FAULTS[fault](monkeypatch.setattr)
    run = run_tiny(name, tmp_path, objects=1, checked=1)
    assert not run["correct"], run["numbers"]
