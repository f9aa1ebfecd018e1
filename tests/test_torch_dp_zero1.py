"""ZeRO-1 in the port's ``DistributedTrainer`` against the JAX package's, on
two gloo ranks against ``make_mesh(data=2)``: Adam, Lamb and Lars under
``BucketedAllReduceSync`` and ``TopKCompressedSync`` (and Adam under the
implicit ``SyncAllReduce``), params and scores to 1e-10 after 3 steps.

Each rank holds only its dim-0 slice of every updater leaf whose param the
data axis divides (the MLP's 6x8 kernel and 8-bias; the 8x3 kernel's
dim 0 divides too, the 3-bias's does not), so its updater bytes are the
global bytes less half the sliced ones; the gathered state equals the JAX
trainer's. ZeRO-1 equals the replicated run bit for bit for Adam (the
update is elementwise on identical all-reduced gradients).

Lars and Lamb are held to 1e-8 instead: both packages take their layer
norms in float32 (``_sq_sum``), so a norm summed in another order, or as
slice sums plus an all-reduce under ZeRO-1, moves the trust ratio by a
float32 rounding. The JAX package's own ZeRO-1 and replicated Lamb runs
of these cases differ by up to 3.8e-9 after 3 steps.
"""

import jax
import numpy as np
import pytest

from deeplearning4j_tpu.train import updaters as jupd

from torch_dp_helpers import (STEPS, TOL, batches, check_ranks_equal, jax_fit, max_err, mlp,
                              result, run_world, zip_of)

WORLD = 2
GLOBAL_BATCH = 8
UPDATERS = {"adam": lambda: jupd.Adam(0.05), "lamb": lambda: jupd.Lamb(0.05, weight_decay=0.01),
            "lars": lambda: jupd.Lars(0.5, weight_decay=0.01, trust_coefficient=0.01)}
STRATS = {"bucketed": ("BucketedAllReduceSync", dict(bucket_bytes=256)),
          "topk": ("TopKCompressedSync", dict(density=0.5))}
CASES = {f"{u}_{s}": (u, s) for u in UPDATERS for s in STRATS}
TRUST_TOL = 1e-8  # Lars/Lamb: float32 layer norms (module docstring)


def _cases(d, data):
    out = []
    for name, (u, s) in CASES.items():
        strat, kw = STRATS[s]
        for zero1 in (True, False):
            n = name + ("_z1" if zero1 else "_rep")
            out.append(dict(name=n, zip=zip_of(mlp(UPDATERS[u]()), d, n), data=data, steps=STEPS,
                            strategy=strat, strategy_kwargs=kw, zero1=zero1, updater=True))
    out.append(dict(name="adam_sync_z1", zip=zip_of(mlp(UPDATERS["adam"]()), d, "adam_sync_z1"),
                    data=data, steps=STEPS, strategy="SyncAllReduce", zero1=True, updater=True))
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("dp_zero1"))
    data = f"{d}/data.npz"
    batches(data, STEPS, GLOBAL_BATCH, (6,), 3, seed=2)
    run_world(_cases(d, data), WORLD, d)
    return d


def _xy(d):
    with np.load(f"{d}/data.npz") as z:
        return z["x"], z["y"]


def _opt(r):
    return [r[k] for k in sorted((k for k in r if k.startswith("opt/")),
                                 key=lambda k: int(k.split("/")[1]))]


@pytest.mark.parametrize("name", list(CASES))
def test_zero1_matches_jax(world, name):
    u, s = CASES[name]
    strat, kw = STRATS[s]
    r0 = check_ranks_equal(world, name + "_z1", WORLD)
    x, y = _xy(world)
    t, params, scores = jax_fit(mlp(UPDATERS[u]()), WORLD, x, y, name=strat, kw=kw, zero1=True)
    tol = TOL if u == "adam" else TRUST_TOL
    assert max_err(r0["params"], params) <= tol
    assert max_err(r0["scores"], scores) <= tol
    # the gathered updater state (global shapes) is the JAX trainer's
    jleaves = [np.asarray(v) for v in jax.tree_util.tree_leaves(jax.device_get(t.opt_state))
               if np.ndim(v) > 0 or np.issubdtype(np.asarray(v).dtype, np.floating)]
    pleaves = [v for v in _opt(r0) if v.ndim > 0 or np.issubdtype(v.dtype, np.floating)]
    assert len(pleaves) == len(jleaves)
    for a, b in zip(pleaves, jleaves):
        # the trust-ratio scalars are float32 in both packages: two ulps
        tol = 2.4e-7 if b.dtype == np.float32 else (TOL if u == "adam" else TRUST_TOL)
        assert max_err(a, b) <= tol * max(1.0, float(np.max(np.abs(b))))


@pytest.mark.parametrize("name", list(CASES))
def test_zero1_equals_replicated(world, name):
    z1, rep = result(world, name + "_z1", 0), result(world, name + "_rep", 0)
    if name.startswith("adam"):
        assert np.array_equal(z1["params"], rep["params"])
        assert np.array_equal(z1["scores"], rep["scores"])
    else:  # trust-ratio norms: float32 slice sums + all-reduce
        assert max_err(z1["params"], rep["params"]) <= TRUST_TOL
    # each rank holds half of every sliced leaf: the 6x8 and 8x3 kernels and
    # the 8-bias, with their moments (the 3-bias stays whole)
    assert int(z1["updater_bytes_global"]) == int(rep["updater_bytes"])
    assert int(z1["updater_bytes"]) < int(rep["updater_bytes"])
    moments = 2 if not name.startswith("lars") else 1
    sliced = (6 * 8 + 8 + 8 * 3) * 8 * moments
    assert int(rep["updater_bytes"]) - int(z1["updater_bytes"]) == sliced // 2


def test_zero1_under_the_implicit_path(world):
    r0 = check_ranks_equal(world, "adam_sync_z1", WORLD)
    x, y = _xy(world)
    _, params, scores = jax_fit(mlp(UPDATERS["adam"]()), WORLD, x, y, zero1=True)
    assert max_err(r0["params"], params) <= TOL
    assert max_err(r0["scores"], scores) <= TOL
