"""The port's span recorder (``genpc_tpu_torch.tracing``): spans and
counters, what a span costs with nothing on, ``run_batched``'s timings
and the benchmark's readers of them.  The tests marked ``cuda`` need an
NVIDIA GPU and skip without one; the machine with the card has no JAX,
so run them without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_tracing.py
"""

import collections
import contextlib
import importlib.util
import time
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from genpc_tpu_torch import tracing
from genpc_tpu_torch.config import load_config
from genpc_tpu_torch.io.synthetic_data import write_dataset
from genpc_tpu_torch.parallel import batched_runner
from genpc_tpu_torch.tracing import count, recording, span

ROOT = Path(__file__).resolve().parent.parent
STAGES = ("load", "stage1", "generate", "stage2", "stage3", "metric")
REG_STEPS = ("reg_prep", "reg_pose", "reg_coarse", "reg_fine", "reg_refine",
             "reg_fusion")
#: run_batched at toy sizes on the synthetic backends; 36 pose steps give
#: a coarse phase of 25 and a full-resolution phase of 11
TINY = dict(save=False, output_path="/tmp/test_ws", glb_sample_points=256,
            pose_complete_points=64, icp_points=64, pose_iters=36,
            pose_render_size=32, fused_points=128, fine_scale_steps=2,
            control_model="synthetic", rembg_model="synthetic",
            generative_model="synthetic", view_num=16, downsample_num=128,
            res=32, cam_res=32, generate_res=32, input_points=1024,
            inpaint_iters=5, metric_points=128)
FLAGS = ["01184", "05117"]


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        f"metric_{name}", ROOT / "portbench" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _pass(tmp_path, device="cpu", aligned=False, timings=None, **kw):
    cfg = load_config(device=device, trust_aligned_completion=aligned,
                      **dict(TINY, **kw))
    return batched_runner.run_batched(cfg, FLAGS, str(tmp_path),
                                      timings=timings)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """The objects' files; stage 2's symmetry search (its cost at these
    sizes on the host) replaced by one fixed plane."""
    root = tmp_path_factory.mktemp("tracing_data")
    write_dataset(str(root), FLAGS, seed=0, n_gt=2048)
    syn = importlib.import_module("genpc_tpu_torch.models.synthetic")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(syn.SyntheticImage23D, "plan_symmetry_batched",
                   staticmethod(lambda pts, **k: [
                       (np.float32([1, 0, 0]), 0.0)] * len(pts)))
        yield root


@pytest.fixture(scope="module", params=[False, True],
                ids=["registration", "aligned"])
def timed_pass(request, data_dir):
    """(aligned, the timings of one tiny CPU pass, its scores)."""
    timings = {}
    scores = _pass(data_dir, aligned=request.param, timings=timings)
    return request.param, timings, scores


# ------------------------------------------------------------- recorder

def test_spans_nest_and_walls_and_counters_are_inclusive():
    with recording() as rec:
        with span("a"):
            with span("b"):
                time.sleep(0.01)
                count("x", 2)
                count("x")
            with span("c"):
                time.sleep(0.005)
                count("x", 4)
                count("y")
    by = {s.name: s for s in rec.spans}
    assert [s.name for s in rec.spans] == ["b", "c", "a"]
    assert (by["a"].parent, by["b"].parent, by["c"].parent) == (None, "a",
                                                                "a")
    assert (by["b"].path, by["c"].path) == ("a/b", "a/c")
    assert by["a"].seconds >= by["b"].seconds + by["c"].seconds
    assert by["b"].seconds >= 0.01 and by["c"].seconds >= 0.005
    assert by["a"].start_ns <= by["b"].start_ns < by["b"].end_ns \
        <= by["c"].start_ns < by["c"].end_ns <= by["a"].end_ns
    flat = rec.flat()
    assert (flat["a:x"], flat["b:x"], flat["c:x"]) == (7.0, 3.0, 4.0)
    assert (flat["a:y"], flat["c:y"]) == (1.0, 1.0) and "b:y" not in flat
    assert flat["a"] == pytest.approx(by["a"].seconds)
    assert all(isinstance(v, float) for v in flat.values())


def test_a_span_name_sums_and_the_report_is_by_path(capsys):
    with recording() as rec:
        for _ in range(3):
            with span("outer"):
                with span("inner"):
                    count("steps", 5)
    flat = rec.flat()
    assert flat["inner:steps"] == 15.0 and flat["outer:steps"] == 15.0
    assert flat["outer"] == pytest.approx(
        sum(s.seconds for s in rec.spans if s.name == "outer"))
    table = rec.report()
    assert "outer/inner" in table and capsys.readouterr().out.strip() \
        == table.strip()
    row = next(r for r in table.splitlines() if r.startswith("outer/inner"))
    assert row.split()[2] == "3"


def test_a_span_with_nothing_on_records_nothing_and_reads_no_clock(
        monkeypatch):
    # with no recorder and no profiler a span only checks two flags: no
    # clock, no device wait, no record_function, nothing on the stack
    def boom(*a, **k):
        raise AssertionError("called with nothing on")
    monkeypatch.setattr(tracing.time, "time_ns", boom)
    monkeypatch.setattr(tracing.torch.profiler, "record_function", boom)
    monkeypatch.setattr(tracing.torch.cuda, "synchronize", boom)
    monkeypatch.setattr(tracing, "_wait", boom)
    with span("a", sync="cuda"):
        with span("b", sync=torch.device("cuda")):
            count("steps", 3)
        assert tracing._local.stack == []
    monkeypatch.undo()
    with recording() as rec:
        pass
    assert rec.spans == [] and rec.flat() == {}


def test_a_barrier_span_waits_with_nothing_on(monkeypatch):
    waits = []
    monkeypatch.setattr(tracing, "_wait", waits.append)
    with span("stage", sync="cuda:0", barrier=True):
        pass
    with span("step", sync="cuda:0"):
        pass
    assert waits == ["cuda:0"]
    with recording():
        with span("step", sync="cuda:0"):
            pass
    assert waits == ["cuda:0", "cuda:0"]


def test_recorders_nest_and_each_holds_what_ended_inside_it():
    with recording() as outer:
        with span("first"):
            pass
        with recording() as inner:
            with span("second"):
                pass
    assert [s.name for s in outer.spans] == ["first", "second"]
    assert [s.name for s in inner.spans] == ["second"]
    assert tracing._recorders == []


def test_a_span_is_a_profiler_range_around_its_stamps():
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof, \
            recording() as rec:
        with span("probe_span"):
            torch.ones(64).sum()
    ev = [e for e in prof.profiler.kineto_results.events()
          if e.name() == "probe_span"]
    assert len(ev) == 1 and ev[0].is_user_annotation()
    sp = rec.spans[0]
    assert ev[0].start_ns() <= sp.start_ns
    assert sp.end_ns <= ev[0].start_ns() + ev[0].duration_ns()


def test_sync_warnings_count_into_the_open_spans(monkeypatch):
    # the warning plumbing of the sync counter, on the host: PyTorch's
    # sync debug mode stands in as a setter, its warning as warnings.warn
    modes = ["0"]
    monkeypatch.setattr(tracing.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(tracing.torch.cuda, "get_sync_debug_mode",
                        lambda: modes[-1])
    monkeypatch.setattr(tracing.torch.cuda, "set_sync_debug_mode",
                        modes.append)
    monkeypatch.setattr(tracing.torch.cuda, "synchronize", lambda d=None:
                        None)
    with warnings.catch_warnings(record=True) as shown:
        warnings.simplefilter("default")
        with recording() as rec:
            assert modes[-1] == "warn"
            with span("stage"):
                with span("step", sync="cuda"):
                    for _ in range(3):
                        warnings.warn(tracing._SYNC_WARNING)
                with span("quiet"):
                    pass
                warnings.warn("another warning")
        assert [str(w.message) for w in shown] == ["another warning"]
    assert modes[-1] == "0"
    flat = rec.flat()
    assert (flat["stage:syncs"], flat["step:syncs"], flat["quiet:syncs"]) \
        == (3.0, 3.0, 0.0)


# ----------------------------------------------------------- run_batched

def test_run_batched_timings_keep_their_keys_and_meanings(timed_pass):
    aligned, t, _ = timed_pass
    for k in STAGES:
        assert t[k] > 0, k
    # the registration steps lie inside stage 3, as siblings
    steps = [k for k in REG_STEPS if k in t]
    assert sum(t[k] for k in steps) <= t["stage3"]
    if aligned:
        assert steps == ["reg_prep", "reg_fusion"]
        assert not any(k.startswith("pose_") or k == "reg_undo" for k in t)
    else:
        assert steps == list(REG_STEPS)
        assert t["reg_undo"] <= t["reg_refine"]
        assert t["pose_coarse"] + t["pose_fine"] <= t["reg_pose"]
    assert t["fusion_dedup"] + t["fusion_fps"] + t["fusion_outliers"] \
        <= t["reg_fusion"]
    assert t["stage2_matte"] + t["stage2_plan"] + t["stage2_complete"] \
        <= t["stage2"]
    assert all(isinstance(v, float) for v in t.values())


def test_pose_phase_steps_add_up_to_pose_iters(timed_pass):
    aligned, t, _ = timed_pass
    if aligned:
        assert "pose_coarse:steps" not in t and "reg_pose" not in t
        return
    assert (t["pose_coarse:steps"], t["pose_fine:steps"]) == (25.0, 11.0)
    assert t["pose_coarse:steps"] + t["pose_fine:steps"] \
        == TINY["pose_iters"]
    assert t["reg_pose:steps"] == t["stage3:steps"] == TINY["pose_iters"]


def test_a_single_pose_phase_is_pose_fine(data_dir):
    timings = {}
    _pass(data_dir, timings=timings, pose_iters=10)
    assert timings["pose_fine:steps"] == 10.0
    assert "pose_coarse" not in timings


def test_an_untimed_pass_scores_alike_and_an_outer_recorder_sees_it(
        data_dir, timed_pass):
    aligned, timings, timed = timed_pass
    with recording() as rec:
        untimed = _pass(data_dir, aligned=aligned)
    assert timed == untimed
    # an operator's recorder still sees every span of an untimed pass
    assert set(rec.flat()) == set(timings)


# ------------------------------------------------------ benchmark readers

NEW_METRICS = ("pose_step_ms", "reg_prep_s", "reg_fusion_s", "stage2_syncs",
               "stage3_syncs")


@pytest.mark.parametrize("name", NEW_METRICS)
def test_new_metric_reads_its_keys_and_nothing_without_them(name,
                                                            timed_pass):
    aligned, t, _ = timed_pass
    read = _reader(name)
    # the counters of a card's recorder, which counts syncs
    t = dict(t, **{"stage2:syncs": 4.0, "stage3:syncs": 30.0})
    other = {k: v * 3 for k, v in t.items()}
    record = {"passes": [{"seconds": 1.0, "timings": t},
                         {"seconds": 1.0, "timings": other}]}
    want = {
        "pose_step_ms": None if aligned else 1000.0 * (
            t["pose_coarse"] + t["pose_fine"]) / TINY["pose_iters"],
        "reg_prep_s": t["reg_prep"] * 2, "reg_fusion_s": t["reg_fusion"] * 2,
        "stage2_syncs": 8.0, "stage3_syncs": 60.0}[name]
    got = read(record)
    if want is None:
        assert got is None
    else:
        assert got == pytest.approx(want)
    # a pass without the keys (the parent's program, or untimed passes)
    legacy = {k: t[k] for k in STAGES}
    assert read({"passes": [{"seconds": 1.0, "timings": legacy},
                            {"seconds": 1.0, "timings": None}]}) is None


# ------------------------------------------------------------- the card

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_an_item_counts_one_sync_and_a_span_end_none(dev):
    x = torch.ones(1 << 16, device=dev)
    with recording() as rec:
        with span("item"):
            x.sum().item()
        with span("host_copy"):
            x[:8].cpu()
        with span("waits", sync=dev):
            (x * 2).sum()
        with span("barrier", sync=dev, barrier=True):
            (x * 3).sum()
        with span("none"):
            (x * 4).sum()
    flat = rec.flat()
    assert flat["item:syncs"] == 1.0 and flat["host_copy:syncs"] == 1.0
    assert flat["waits:syncs"] == flat["barrier:syncs"] \
        == flat["none:syncs"] == 0.0
    assert torch.cuda.get_sync_debug_mode() == 0


@pytest.mark.cuda
def test_span_stamps_lie_on_the_profiler_clock(dev):
    from torch.profiler import ProfilerActivity, profile
    x = torch.rand(1 << 20, device=dev)
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with recording() as rec:
            for _ in range(3):
                with span("probe_span", sync=dev):
                    for _ in range(20):
                        x = torch.sqrt(x * x + 1.0)
    host = sorted((e for e in prof.profiler.kineto_results.events()
                   if e.name() == "probe_span"
                   and e.device_type() == torch.autograd.DeviceType.CPU),
                  key=lambda e: e.start_ns())
    assert len(host) == len(rec.spans) == 3
    for e, sp in zip(host, rec.spans):
        assert abs(e.start_ns() - sp.start_ns) < 1_000_000
        assert abs(e.start_ns() + e.duration_ns() - sp.end_ns) < 1_000_000


@pytest.mark.cuda
def test_spans_add_no_device_op(dev, data_dir, monkeypatch):
    # a profiled pass with its spans on (their ranges and the recorder)
    # runs the device operations of one with them off
    monkeypatch.syspath_prepend(str(ROOT))
    from portbench import harness
    from torch.profiler import ProfilerActivity, profile, record_function
    _pass(data_dir, device="cuda")                         # warm-up

    def profiled(spans_on):
        timings = {}
        spans = recording() if spans_on else contextlib.nullcontext()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function("portbench.pass"), spans as rec:
                with monkeypatch.context() as mp:
                    if not spans_on:
                        mp.setattr(tracing, "_profiler",
                                   type("off", (), {
                                       "_is_profiler_enabled": False}))
                    _pass(data_dir, device="cuda",
                          timings=timings if spans_on else None)
                torch.cuda.synchronize(dev)
        events = prof.profiler.kineto_results.events()
        ops = collections.Counter(
            e.name() for e in events
            if e.device_type() == torch.autograd.DeviceType.CUDA
            and not e.is_user_annotation() and e.name() != "portbench.pass")
        return (harness.summarize_profile(events, timings), ops,
                rec.spans if spans_on else [])

    off, ops_off, _ = profiled(False)
    on, ops_on, spans = profiled(True)
    names = {sp.name for sp in spans}
    assert {"pose_fine", "fusion_fps"} <= names
    # no span is a device operation, and both passes run as many: a
    # device operation a span brought would add len(spans) of them.  The
    # count is held within that, not exactly: the profiler has read 1-2
    # records fewer in either pass of a pair, in 4 runs of 11 on the card
    assert not names & set(ops_on)
    assert abs(sum(ops_on.values()) - sum(ops_off.values())) < len(spans)
    assert not names & {n for n, _ in on["device_ops"]}
    assert on["busy_s"] == pytest.approx(off["busy_s"], rel=0.25)
