"""BENCHMARK.json against the benchmark's contract, and every file it
names found under ``portbench/``."""

import importlib.util
import json
import re

import pytest

from portbench_tiny import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n\r]{1,200}$")
CELLS = {w["name"]: w for w in BENCH["workloads"]}
E2E = {m["name"]: m for m in BENCH["end_to_end"]}


def _reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", CELLS)


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert (ROOT / p).is_dir() and not p.startswith("/") and ".." not in p
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32 and all(TEXT.match(w) for w in cmd)
    assert (ROOT / cmd[1]).is_file()
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check with 24 cells fits its 43,200 s
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config(conf):
    assert set(conf) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(conf["name"]) and TEXT.match(conf["source"])
    assert TEXT.match(conf["why"])
    assert any(conf["file"].startswith(p + "/") for p in BENCH["paths"])
    data = json.loads((ROOT / conf["file"]).read_text())
    assert data["reduced"] == conf["reduced"]
    assert len(conf["reduced"]) <= 16
    assert all(NAME.match(k) for k in conf["reduced"])
    assert [c["file"] for c in BENCH["configs"]].count(conf["file"]) == 1
    assert any(w["config"] == conf["name"] for w in CELLS.values())


@pytest.mark.parametrize("cell", list(CELLS))
def test_workload(cell):
    w = CELLS[cell]
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell) and NAME.match(w["traffic"])
    assert TEXT.match(w["why"]) and w["chips"] in (1, 4)
    assert any(c["name"] == w["config"] for c in BENCH["configs"])
    traffic = json.loads(
        (ROOT / "portbench" / "traffic" / f"{w['traffic']}.json").read_text())
    assert traffic["objects"] >= 1 and traffic["checked_objects"] >= 1
    # the entry, the input generator and the check it names, by file
    ent = _module("entries", traffic["entry"])
    for call in ("port_config", "run", "recording", "release", "reference"):
        assert callable(getattr(ent, call))
    assert callable(_module("traffic", traffic["generator"]).write)
    from portbench.reference import judge
    spec = judge.load(traffic["check"])
    assert spec["numbers"]
    for name, num in spec["numbers"].items():
        assert NAME.match(name) and num["limit"] >= 0
        assert num.get("fields") or num.get("key")
    pairs = [(x["config"], x["traffic"]) for x in CELLS.values()]
    assert pairs.count((w["config"], w["traffic"])) == 1
    # setup_s, another end-to-end metric, and a per-layer metric
    e2e = [m for m in E2E.values() if _reports(m, cell)]
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert any(_reports(m, cell) for m in BENCH["per_layer"])


def _module(folder: str, name: str):
    path = ROOT / "portbench" / folder / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"m_{folder}_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _loads(name: str):
    return _module("metrics", name).read


@pytest.mark.parametrize("m", BENCH["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end_metric(m):
    assert set(m) <= {"name", "unit", "better", "bound", "source",
                      "workloads"}
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert m["source"] in ("host_clock", "device_trace")
    assert 0.01 <= m["bound"] <= 0.25
    assert callable(_loads(m["name"]))


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric(m):
    assert set(m) <= {"name", "unit", "better", "source", "layer", "moves",
                      "workloads"}
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher") and TEXT.match(m["layer"])
    assert m["source"] in ("device_trace", "program_span", "program_counter",
                           "host_clock")
    assert m["moves"] in E2E
    for cell in m.get("workloads", CELLS):
        assert cell in CELLS and _reports(E2E[m["moves"]], cell)
    if m["name"].endswith("_roofline") or "mfu" in m["name"]:
        assert m["unit"] == "%"
    assert callable(_loads(m["name"]))


def test_names_unique_and_files_named_plainly():
    names = ([m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]],
             list(CELLS), [c["name"] for c in BENCH["configs"]])
    for group in names:
        assert len(group) == len(set(group))
    for p in BENCH["paths"]:
        for f in (ROOT / p).rglob("*"):
            if "__pycache__" in f.parts:
                continue
            rel = f.relative_to(ROOT).as_posix()
            assert re.fullmatch(r"[A-Za-z0-9_./-]+", rel), rel
