"""The port's heavy_nolakes step against vic_tpu.model.run.

4 cells x 4 3-hourly records of the heavy configuration without LAKES
(entry.heavy_nolakes_params: FROZEN_SOIL on 5 finite-difference nodes,
CLOSE_ENERGY, DIST_PRCP, BLOWING, the water-table curves) on the split
forcing of entry.heavy_forcing, through both packages from the very same
float32 bits: the port's parameters, state, forcing and curves are filled
field by field from vic_tpu's, and both step on the same node geometry.
All 155 OUT_* and all 51 final-state fields at rtol = atol = 1e-4 but for
the leaves of ROADMAP.md queue 3 (vic_tpu_torch.testing.heavy_run_failures:
the thaw-edge cells, the residual at the accepted root), the CLOSE_ENERGY
pass counts equal. OUT_WATER_ERROR is held to vic_tpu's cell for cell: the
reference leaves ~0.1 mm on raining cells whose wet fraction mu < 1, all of
it on the glacier lanes, where rain on bare ice enters the glacier's store
at the wet fraction's intensity P/mu.
"""
import dataclasses
import functools
import os
import sys

import jax
import numpy as np
import torch

from vic_tpu.model import run as jax_run
from vic_tpu_torch import kernels, model
from vic_tpu_torch.entry import build_heavy_nolakes, heavy_nolakes_params
from vic_tpu_torch.physics.frozen_soil import build_node_geometry
from vic_tpu_torch.prepare import device_params_from_numpy
from vic_tpu_torch.state import state_from_numpy
from vic_tpu_torch.testing import heavy_run_failures, synthetic_domain

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


def port_inputs(n_cell=N_CELL, n_rec=N_REC):
    """vic_tpu's inputs of the heavy configuration, and the port's
    (state, stack, params, gp, run keywords) filled from them."""
    gp, params, stack, state, jgeom, zwt = fixture.heavy_nolakes_inputs(
        n_cell, n_rec)
    t_stack = {k: torch.tensor(np.asarray(v)) for k, v in stack.items()
               if k not in ("month", "day_in_year")}
    t_stack.update(month=np.asarray(stack["month"]),
                   day_in_year=np.asarray(stack["day_in_year"]))
    t_gp = heavy_nolakes_params(n_rec)
    geom = build_node_geometry(synthetic_domain(n_cell, n_band=2).soil,
                               t_gp).to("cpu")
    extras = dict(geom=geom, zwt_curves={
        k: torch.tensor(np.asarray(v)) for k, v in zwt.items()})
    return ((gp, params, stack, state, jgeom, zwt),
            (state_from_numpy(fields_of(state), "cpu"), t_stack,
             device_params_from_numpy(fields_of(params), "cpu"), t_gp,
             extras))


def as_fixture(final, outs):
    got = {f"out/{k}": np.asarray(v) for k, v in outs.items()}
    got.update({f"state/{k}": np.asarray(v) for k, v in final.items()})
    return got


@functools.lru_cache(maxsize=None)
def both_runs():
    (gp, params, stack, state, jgeom, zwt), (t_state, t_stack, t_params,
                                             t_gp, extras) = port_inputs()
    j_final, j_outs = jax.jit(lambda s, f, z: jax_run(
        s, f, params, gp, geom=jgeom, zwt_curves=z))(state, stack, zwt)
    t_final, t_outs = model.run(t_state, t_stack, t_params, t_gp, **extras)
    return (as_fixture(fields_of(j_final), j_outs),
            as_fixture(t_final.numpy(), {k: v.numpy()
                                         for k, v in t_outs.items()}))


def test_all_outputs_match():
    ref, got = both_runs()
    outs = sorted(k for k in ref if k.startswith("out/"))
    assert len(outs) == 155
    assert sorted(k for k in got if k.startswith("out/")) == outs
    assert heavy_run_failures({k: ref[k] for k in outs}, got, TOL) == []
    np.testing.assert_array_equal(got["out/OUT_TCANOPY_ITER"],
                                  ref["out/OUT_TCANOPY_ITER"])


def test_final_state_matches():
    ref, got = both_runs()
    states = [k for k in ref if k.startswith("state/")]
    assert len(states) == 51
    assert sorted(k for k in got if k.startswith("state/")) == sorted(states)
    rule = {k: ref[k] for k in states + ["out/OUT_FUSION",
                                         "out/OUT_SOIL_TNODE"]}
    assert heavy_run_failures(rule, got, TOL) == []


def test_the_heavy_paths_run():
    """Snow blows, the canopy air iterates more than once, some lanes rain
    on a wet fraction mu < 1 with a dry column apart, the soil freezes, the
    water table is found, and the cold cells close their water balance."""
    ref, got = both_runs()
    assert np.abs(got["out/OUT_SUB_BLOWING"]).max() > 0.0
    assert got["out/OUT_TCANOPY_ITER"].min() > 1
    assert (got["state/mu"] < 1.0).any()
    assert not np.array_equal(got["state/moist"], got["state/moist_dry"])
    assert got["state/ice"].max() > 0.0
    assert (got["out/OUT_ZWTL"] < 0.0).all()
    cold = np.arange(N_CELL) % 2 == 1
    assert np.abs(got["out/OUT_WATER_ERROR"][:, cold]).max() <= WATER_TOL
    assert np.abs(ref["out/OUT_WATER_ERROR"][:, cold]).max() <= WATER_TOL


def test_dist_prcp_water_residual_sits_on_the_glacier_lanes():
    """vic_tpu's closure residual on the raining cells (reproduced by the
    port) is all on the glacier lanes: weighted on the other lanes only, the
    step closes within 1e-3 mm."""
    ref, got = both_runs()
    assert np.abs(ref["out/OUT_WATER_ERROR"]).max() > WATER_TOL
    _, (t_state, t_stack, t_params, t_gp, extras) = port_inputs()
    t_params.weight = torch.where(t_params.is_glacier, 0.0, t_params.weight)
    _, outs = model.run(t_state, t_stack, t_params, t_gp,
                        outvars=["OUT_WATER_ERROR"], **extras)
    assert float(outs["OUT_WATER_ERROR"].abs().max()) <= 1e-3


def test_cpu_heavy_step_takes_the_plain_versions():
    gp, params, stack, state, extras = build_heavy_nolakes(2, 1, "cpu")
    kernels.reset_launches()
    model.make_step(params, gp, **extras)(
        state, {k: v[0] for k, v in stack.items()})
    assert kernels.launches == dict.fromkeys(kernels.launches, 0)


def test_heavy_step_does_not_write_into_its_inputs():
    gp, params, stack, state, extras = build_heavy_nolakes(3, 2, "cpu")
    before = {k: v.copy() for k, v in state.numpy().items()}
    model.make_step(params, gp, **extras)(
        state, {k: v[0] for k, v in stack.items()})
    for k, v in state.numpy().items():
        np.testing.assert_array_equal(v, before[k], err_msg=k)
