"""Record-and-replay helpers of the port's end-to-end parity tests
(test_torch_per_object.py, test_torch_lidar.py).

The reference's run records what a step returned; the port's run either
replays it without calling its own step (``tape``: model-free stand-ins
whose inputs carry a standing rounding mismatch), or runs its own step
on its own inputs, measures both against the reference's, and goes on
with the reference's result (``held``: the registration steps, whose
rounding-level differences the next step's voxel binning would
otherwise amplify, ROADMAP queue 3).
"""

import numpy as np
import torch

#: transforms of one algorithm on the same inputs, with different
#: roundings of the same sums: 30 ICP iterations twice per scale, where a
#: correspondence that crosses the distance threshold or a near-tied NN
#: moves the result by more than rounding (measured: <= 2.4e-6, and
#: 2.3e-4 on one object's coarse sweep)
REG_STEP_TOL = 1e-3


def native_off(*_a, **_k):
    """Pins the reference's voxel downsample to its numpy algorithm: its
    native helper emits voxels in another order (ROADMAP queue 3)."""
    raise RuntimeError("native voxel helper pinned off")


def tape(fn, recorded):
    """fn recording its results onto an empty list, or replaying a full
    one in call order without calling fn."""
    replay = list(recorded)

    def call(*a, **k):
        if replay:
            return replay.pop(0)
        out = fn(*a, **k)
        recorded.append(out)
        return out
    return call


def arrays(x):
    """The numeric arrays in a step's arguments or result, in order; a
    Python float as the float32 it enters the computation as (the
    reference hands jnp.float32 scalars where the port hands floats)."""
    if isinstance(x, (tuple, list)):
        return [a for v in x for a in arrays(v)]
    if isinstance(x, torch.Tensor):
        return [x.numpy()]
    if x is None or isinstance(x, str):
        return []
    if isinstance(x, float):
        x = np.float32(x)
    return [np.asarray(x, np.float64)]


def max_err(a, b):
    """Max |a - b| over a step's arrays (the port may batch a problem
    that the reference takes alone: shapes [1,...] against [...])."""
    pairs = list(zip(arrays(a), arrays(b)))
    assert pairs and all(x.size == y.size for x, y in pairs)
    return max(float(np.abs(np.asarray(x, np.float64).reshape(y.shape)
                            - y).max()) for x, y in pairs)


def held(name, fn, recorded, errors, convert):
    """fn recording (arguments, result) onto an empty list; with a full
    one, fn runs and (name, argument error, result error) against the
    recorded call goes onto ``errors``, and the recorded result, passed
    through ``convert``, is returned."""
    replay = list(recorded)

    def call(*a, **k):
        out = fn(*a, **k)
        if not replay:
            recorded.append((a, out))
            return out
        ref_a, ref_out = replay.pop(0)
        errors.append((name, max_err(a, ref_a), max_err(out, ref_out)))
        return convert(ref_out)
    return call
