"""The port's step with BLOWING and CLOSE_ENERGY against vic_tpu.model.run.

4 cells x 4 daily records of the blowing_close configuration (the light
one with BLOWING and CLOSE_ENERGY on the windy, cold forcing of
entry.blowing_close_forcing) through both packages from the very same
float32 bits: the port's parameters, state and forcing are filled field by
field from vic_tpu's. All 150 OUT_* and all 51 final-state fields at
rtol = atol = 1e-4, the CLOSE_ENERGY pass counts equal, water closure
within 1e-2 mm on both.
"""
import dataclasses
import functools
import os
import sys

import jax
import numpy as np
import pytest
import torch

from vic_tpu.model import run as jax_run
from vic_tpu_torch import kernels, model
from vic_tpu_torch.entry import build_blowing_close
from vic_tpu_torch.prepare import device_params_from_numpy
from vic_tpu_torch.state import state_from_numpy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import make_torch_port_fixture as fixture  # noqa: E402

torch.set_num_threads(1)

N_CELL, N_REC = 4, 4
TOL = 1e-4
WATER_TOL = 1e-2


def fields_of(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


@functools.lru_cache(maxsize=None)
def both_runs():
    gp, params, stack, state = fixture.blowing_close_inputs(N_CELL, N_REC)
    j_final, j_outs = jax.jit(lambda s, f: jax_run(s, f, params, gp))(
        state, stack)
    t_stack = {k: torch.tensor(np.asarray(v)) for k, v in stack.items()
               if k not in ("month", "day_in_year")}
    t_stack.update(month=np.asarray(stack["month"]),
                   day_in_year=np.asarray(stack["day_in_year"]))
    t_final, t_outs = model.run(
        state_from_numpy(fields_of(state), "cpu"), t_stack,
        device_params_from_numpy(fields_of(params), "cpu"), gp)
    return (j_final, {k: np.asarray(v) for k, v in j_outs.items()},
            t_final, {k: v.numpy() for k, v in t_outs.items()})


def test_all_outputs_match():
    _, j_outs, _, t_outs = both_runs()
    assert len(j_outs) == 150
    assert sorted(t_outs) == sorted(j_outs)
    for k, a in j_outs.items():
        b = t_outs[k]
        assert b.shape == a.shape and b.dtype == a.dtype, k
        np.testing.assert_allclose(b, a, rtol=TOL, atol=TOL, err_msg=k)
    np.testing.assert_array_equal(t_outs["OUT_TCANOPY_ITER"],
                                  j_outs["OUT_TCANOPY_ITER"])


def test_final_state_matches():
    j_final, _, t_final, _ = both_runs()
    names = [f.name for f in dataclasses.fields(j_final)]
    assert names == [f.name for f in dataclasses.fields(t_final)]
    for n in names:
        a = np.asarray(getattr(j_final, n))
        b = getattr(t_final, n).numpy()
        assert b.shape == a.shape and b.dtype == a.dtype, n
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=TOL, atol=TOL, err_msg=n)
        else:
            np.testing.assert_array_equal(b, a, err_msg=n)


def test_water_closure_and_the_paths_run():
    """Water closes on both; snow blows somewhere, the canopy air iterates
    more than once and moves off Tair."""
    _, j_outs, _, t_outs = both_runs()
    assert np.abs(j_outs["OUT_WATER_ERROR"]).max() <= WATER_TOL
    assert np.abs(t_outs["OUT_WATER_ERROR"]).max() <= WATER_TOL
    assert np.abs(t_outs["OUT_SUB_BLOWING"]).max() > 0.0
    assert t_outs["OUT_TCANOPY_ITER"].min() > 1
    assert np.abs(t_outs["OUT_TCANOPY"] - t_outs["OUT_AIR_TEMP"]).max() > 1e-3


def test_cpu_blowing_close_step_takes_the_plain_versions():
    gp, params, stack, state, _ = build_blowing_close(2, 1, "cpu")
    kernels.reset_launches()
    model.make_step(params, gp)(state, {k: v[0] for k, v in stack.items()})
    assert kernels.launches == dict.fromkeys(kernels.launches, 0)


def test_blowing_close_step_does_not_write_into_its_inputs():
    gp, params, stack, state, _ = build_blowing_close(3, 2, "cpu")
    before = {k: v.copy() for k, v in state.numpy().items()}
    model.make_step(params, gp)(state, {k: v[0] for k, v in stack.items()})
    for k, v in state.numpy().items():
        np.testing.assert_array_equal(v, before[k], err_msg=k)


@pytest.mark.parametrize("flag", ["blowing", "close_energy"])
def test_refused_on_finite_difference_nodes(flag):
    """On finite-difference nodes BLOWING and CLOSE_ENERGY step (below), with
    LAKES too (the heavy configuration), but LAKES without its lakes'
    parameters is refused there by name."""
    from vic_tpu_torch.entry import build_frozen, frozen_params
    gp = frozen_params(1).replace(**{flag: True, "lakes": True})
    _, params, _, _, extras = build_frozen(1, 1, "cpu")
    with pytest.raises(NotImplementedError,
                       match="lakes without lake_params"):
        model.make_step(params, gp, **extras)


@pytest.mark.parametrize("flag", ["blowing", "close_energy"])
def test_steps_on_finite_difference_nodes(flag):
    """BLOWING and CLOSE_ENERGY, once refused on finite-difference nodes,
    step the frozen configuration at 2 x 2: its 151 outputs, finite."""
    from vic_tpu_torch.entry import build_frozen
    gp, params, stack, state, extras = build_frozen(2, 2, "cpu")
    final, outs = model.run(state, stack, params, gp.replace(**{flag: True}),
                            **extras)
    assert len(outs) == 151
    assert all(bool(torch.isfinite(v).all()) for v in outs.values())
    assert all(np.isfinite(v).all() for v in final.numpy().values()
               if v.dtype.kind == "f")
