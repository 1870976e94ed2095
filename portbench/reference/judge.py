"""The comparison that decides a run's ``correct``.

The plain reference runs the cell's entry again from the benchmark's own
input files (``entries/<entry>.py``: for ``run_batched``, stages 1 to 3
over the whole batch, as the timed path runs them, since an object's
registration may depend on its batch, and the metric over a sample of
the objects drawn from the seed).  The timed path's outputs, the object
records of the window's last pass and every pass's scores, are held to
it by the numbers of the cell's check, ``checks/<check>.json``, each
one of three kinds:

- ``max_abs``: the largest absolute gap of the named record fields over
  every object (infinite where a field is missing or a shape differs);
- ``chamfer``: the Chamfer-L1 distance between the timed path's cloud in
  the named field and the reference's, largest over the objects
  (infinite where the cloud is missing or empty);
- ``score_rel``: the relative gap of the named score of each checked
  object in every pass of the window against the reference's, largest
  over passes and objects.

A number passes when it is at most its ``limit``; a number that is not
finite fails.  PERF.md gives the readings each limit was set from.
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Dict, Iterable, List, Mapping

import numpy as np
import torch

from portbench.reference.plain.ops.chamfer import _nn_plain

CHECKS = Path(__file__).resolve().parent.parent / "checks"
KINDS = ("max_abs", "chamfer", "score_rel")


def load(name: str) -> dict:
    """The check ``checks/<name>.json``: ``numbers`` maps each compared
    number to its ``kind``, its ``fields`` or score ``key``, and its
    ``limit``."""
    spec = json.loads((CHECKS / f"{name}.json").read_text())
    for num in spec["numbers"].values():
        if num["kind"] not in KINDS:
            raise ValueError(f"check {name}: unknown kind {num['kind']!r}")
    return spec


def _max_abs(a, b) -> float:
    if a is None or b is None:
        return math.inf
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape:
        return math.inf
    return float(np.abs(a - b).max()) if a.size else 0.0


def chamfer_l1(a: np.ndarray, b: np.ndarray, device) -> float:
    """Mean nearest-neighbour distance of a into b and of b into a, halved
    (the direct fp32 form, first index on ties)."""
    x = torch.as_tensor(np.asarray(a, np.float32), device=device)[None]
    y = torch.as_tensor(np.asarray(b, np.float32), device=device)[None]
    d1, _ = _nn_plain(x, y)
    d2, _ = _nn_plain(y, x)
    return float((torch.sqrt(torch.clamp_min(d1, 0)).double().mean()
                  + torch.sqrt(torch.clamp_min(d2, 0)).double().mean()) / 2)


def _rel(a: float, b: float) -> float:
    if not (math.isfinite(a) and math.isfinite(b)):
        return math.inf
    return abs(a - b) / max(abs(b), 1e-12)


def _number(num: dict, records, passes, ref_records, ref_scores,
            device) -> float:
    out = 0.0
    if num["kind"] == "score_rel":
        for scores in passes:
            for flag, ref in ref_scores.items():
                got = scores.get(flag, {}).get(num["key"], math.nan)
                out = max(out, _rel(float(got), float(ref[num["key"]])))
        return out
    for flag, ref in ref_records.items():
        got = records.get(flag)
        for field in num["fields"]:
            a = getattr(got, field, None)
            b = getattr(ref, field, None)
            if num["kind"] == "max_abs":
                gap = _max_abs(a, b)
            elif a is None or b is None or len(a) == 0:
                gap = math.inf
            else:
                gap = chamfer_l1(a, b, device)
            out = max(out, gap)
    return out


def numbers(spec: dict, records: Mapping[str, object],
            passes: Iterable[Mapping], ref_records: Mapping[str, object],
            ref_scores: Mapping, device) -> Dict[str, float]:
    """records / ref_records: flag -> object record of the timed path's
    last pass and of the reference, of every object; passes: every pass's
    scores (flag -> {score: value}); ref_scores: the reference's, of the
    checked objects.  Returns each number of the check ``spec``."""
    passes = list(passes)
    return {name: _number(num, records, passes, ref_records, ref_scores,
                          device)
            for name, num in spec["numbers"].items()}


def _ok(spec: dict, name: str, v: float) -> bool:
    return math.isfinite(v) and v <= spec["numbers"][name]["limit"]


def verdict(spec: dict, nums: Mapping[str, float]) -> bool:
    return all(_ok(spec, k, v) for k, v in nums.items())


def report(spec: dict, nums: Mapping[str, float]) -> Dict[str, dict]:
    """Each number beside its limit, for the result line."""
    return {k: {"value": v if math.isfinite(v) else str(v),
                "limit": spec["numbers"][k]["limit"]}
            for k, v in nums.items()}


def lines(spec: dict, nums: Mapping[str, float]) -> List[str]:
    return [f"check {k} {v!r} limit {spec['numbers'][k]['limit']!r} "
            f"{'ok' if _ok(spec, k, v) else 'FAIL'}" for k, v in nums.items()]
