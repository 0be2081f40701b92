"""SPATIAL_SNOW, CORRPREC and CONTINUEONERROR in the port against vic_tpu
on CPU.

- `snow.calc_snow_coverage` on the branch cases of
  tests/test_spatial_snow.py (accumulation, deep burial, melt along the
  slope, stored new snow melting off, rain on a melting pack, no change),
  `snow.advected_sensible_heat` over the whole coverage range, the
  snowpack balance with the advected term, and
  `hydrology_misc.correct_precip`, elementwise at 1e-5;
- the spatial_snow configuration (entry.build_spatial_snow's flags and
  spring pack), 4 cells x 4 daily records from the same float32 bits, with
  NaN air temperature in one cell from the third record: both packages
  freeze that cell's state from then on and write OUT_CELL_VALID 0 there;
  every other cell, and every state field, agree at 1e-4.
"""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vic_tpu.model import run as jax_run
from vic_tpu.physics.hydrology_misc import correct_precip as j_correct_precip
from vic_tpu.physics.snow import advected_sensible_heat as j_advected
from vic_tpu.physics.snow import calc_snow_coverage as j_coverage
from vic_tpu.physics.snow import snow_energy_terms as j_snow_energy_terms
from vic_tpu_torch import model
from vic_tpu_torch.physics.hydrology_misc import correct_precip
from vic_tpu_torch.physics.snow import (advected_sensible_heat,
                                        calc_snow_coverage,
                                        snow_energy_terms)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import make_torch_port_fixture as fixture  # noqa: E402

torch.set_num_threads(1)

ELEMENTWISE_TOL = 1e-5
TOL = 1e-4
N_CELL, N_REC = 4, 4
NAN_CELL, NAN_FROM = 1, 2


def t(a):
    return torch.tensor(np.asarray(a))


# tests/test_spatial_snow.py's cases of the reference's branch tree
# (calc_snow_coverage.c:44-150), all m
COVERAGE_BASE = dict(store_snow=False, dfsc=0.10, old_coverage=1.0,
                     swq=0.05, old_swq=0.05, depth=0.2, old_depth=0.2,
                     melt_m=0.0, max_swq=0.0, snowfall_mm=0.0,
                     store_swq=0.0, swq_slope=0.0, store_coverage=1.0)
COVERAGE_CASES = {
    "accumulation_full_cover": dict(snowfall_mm=5.0, old_coverage=0.4,
                                    depth=0.01, swq=0.055, old_swq=0.050),
    "deep_accumulation_erases_memory": dict(
        snowfall_mm=5.0, store_snow=True, store_swq=0.01, depth=0.06),
    "melt_reduces_coverage_along_slope": dict(
        melt_m=0.01, old_depth=0.2, depth=0.03, swq=0.01, old_swq=0.02),
    "melting_thin_new_snow_restores_buried_coverage": dict(
        melt_m=0.005, store_swq=0.004, swq=0.040, old_swq=0.050,
        store_coverage=0.35, old_coverage=1.0, swq_slope=-0.10,
        max_swq=0.3, depth=0.15, old_depth=0.16),
    "rain_on_melting_pack_keeps_coverage": dict(
        melt_m=0.001, swq=0.06, old_swq=0.05, depth=0.25, old_depth=0.2,
        swq_slope=-0.1, max_swq=0.3, old_coverage=0.8),
    "thin_old_pack_melting": dict(melt_m=0.002, old_depth=0.04,
                                  depth=0.03, swq=0.008, old_swq=0.01),
    "no_change": dict(old_coverage=0.55),
}


@pytest.mark.parametrize("case", sorted(COVERAGE_CASES))
def test_calc_snow_coverage_matches_vic_tpu(case):
    kw = dict(COVERAGE_BASE, **COVERAGE_CASES[case])
    arrays = {k: np.asarray([v], bool if isinstance(v, bool)
                            else np.float32) for k, v in kw.items()}
    ref = j_coverage(**{k: jnp.asarray(v) for k, v in arrays.items()})
    got = calc_snow_coverage(**{k: t(v) for k, v in arrays.items()})
    for name in ref._fields:
        a, b = np.asarray(getattr(ref, name)), getattr(got, name).numpy()
        assert a.dtype == b.dtype, name
        np.testing.assert_allclose(b, a, rtol=ELEMENTWISE_TOL,
                                   atol=ELEMENTWISE_TOL, err_msg=name)


def test_advected_sensible_heat_matches_vic_tpu():
    """Every branch of the Marsh et al. scaling (0, 0.2-0.5, 0.5-0.6, above
    0.6, 1) with warm and cold air."""
    cov = np.linspace(0.0, 1.0, 41, dtype=np.float32)
    rng = np.random.default_rng(4)
    args = [rng.uniform(1.1, 1.3, 41), rng.uniform(-5.0, 12.0, 41),
            rng.uniform(-3.0, 2.0, 41), rng.uniform(20.0, 200.0, 41)]
    args = [a.astype(np.float32) for a in args]
    ref = np.asarray(j_advected(jnp.asarray(cov),
                                *map(jnp.asarray, args)))
    got = advected_sensible_heat(t(cov), *map(t, args)).numpy()
    np.testing.assert_allclose(got, ref, rtol=ELEMENTWISE_TOL,
                               atol=ELEMENTWISE_TOL)
    assert got[0] == 0.0 and got[-1] == 0.0 and (got[1:-1] != 0.0).all()


def test_snow_energy_terms_with_coverage_match_vic_tpu():
    rng = np.random.default_rng(9)
    n = 16

    def u(lo, hi):
        return rng.uniform(lo, hi, n).astype(np.float32)
    tair = u(-5.0, 8.0)
    kw = dict(ra=u(40.0, 200.0), z_ref=u(2.0, 10.0), roughness=u(1e-4, 1e-2),
              air_dens=u(1.1, 1.35), vp_air=u(300.0, 900.0),
              longwave_in=u(200.0, 330.0), lv=2.501e6 - 2361.0 * tair,
              pressure=u(80000.0, 95000.0), rain_m=u(0.0, 0.002),
              net_short=u(0.0, 250.0), vpd=u(0.0, 400.0), wind=u(0.5, 8.0),
              old_tsurf=u(-5.0, 0.0), snow_depth=u(0.01, 0.5),
              snow_density=u(150.0, 400.0), surf_water=u(0.0, 0.001),
              surface_swq=u(0.01, 0.125), tair=tair, tgrnd=u(-2.0, 4.0),
              blowing_flux=np.zeros(n, np.float32),
              snow_cover_fract=u(0.0, 1.0))
    ts = u(-8.0, 0.0)
    ts[:2] = 0.0
    ref = j_snow_energy_terms(jnp.asarray(ts), dt=86400.0, displacement=0.0,
                              **{k: jnp.asarray(v) for k, v in kw.items()})
    got = snow_energy_terms(t(ts), dt=86400.0,
                            **{k: t(v) for k, v in kw.items()})
    for name in ref._fields:
        a, b = np.asarray(getattr(ref, name)), getattr(got, name).numpy()
        scale = np.abs(a).max()
        np.testing.assert_allclose(b, a, rtol=ELEMENTWISE_TOL,
                                   atol=ELEMENTWISE_TOL * max(scale, 1.0),
                                   err_msg=name)
    assert np.abs(got.advected_sensible.numpy()).max() > 1.0


def test_correct_precip_matches_vic_tpu():
    rng = np.random.default_rng(6)
    n = 32
    wind = rng.uniform(0.0, 15.0, n).astype(np.float32)
    wind_h = rng.uniform(0.5, 12.0, n).astype(np.float32)   # below 1.01 too
    rough = rng.uniform(0.001, 0.3, n).astype(np.float32)
    snow_rough = rng.uniform(0.0001, 0.01, n).astype(np.float32)
    ref = j_correct_precip(*map(jnp.asarray, (wind, wind_h, rough,
                                              snow_rough)))
    got = correct_precip(*map(t, (wind, wind_h, rough, snow_rough)))
    for name, a, b in zip(("rain", "snow"), ref, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                   rtol=ELEMENTWISE_TOL,
                                   atol=ELEMENTWISE_TOL, err_msg=name)
        assert (b.numpy() > 0.99).all()   # 100/e^4.606 at calm air


@pytest.fixture(scope="module")
def nan_runs():
    """vic_tpu's and the port's spatial_snow runs, with NaN air temperature
    in cell NAN_CELL from record NAN_FROM, from the same float32 bits."""
    jax.config.update("jax_enable_x64", False)
    inputs = list(fixture.spatial_snow_inputs(N_CELL, N_REC))
    stack = dict(inputs[2])
    air = np.asarray(stack["air_temp"]).copy()
    air[NAN_FROM:, NAN_CELL] = np.nan
    stack["air_temp"] = jnp.asarray(air)
    inputs[2] = stack
    gp, params, _, state, _, _ = inputs
    j_final, j_outs = jax.jit(lambda s, f: jax_run(s, f, params, gp))(
        state, stack)
    t_gp, t_params, t_stack, t_state, extras = fixture.port_inputs(inputs,
                                                                   N_CELL)
    t_final, t_outs = model.run(t_state, t_stack, t_params, t_gp, **extras)
    # the state the NaN cell holds: the port's after record NAN_FROM - 1
    before = model.run(t_state, {k: v[:NAN_FROM] for k, v in
                                 t_stack.items()}, t_params, t_gp,
                       **extras)[0]
    return (j_final, {k: np.asarray(v) for k, v in j_outs.items()}, t_final,
            {k: v.numpy() for k, v in t_outs.items()}, before)


def test_continue_on_error_freezes_the_nan_cell_in_both(nan_runs):
    j_final, j_outs, t_final, t_outs, before = nan_runs
    valid = np.ones((N_REC, N_CELL), np.float32)
    valid[NAN_FROM:, NAN_CELL] = 0.0
    np.testing.assert_array_equal(j_outs["OUT_CELL_VALID"], valid)
    np.testing.assert_array_equal(t_outs["OUT_CELL_VALID"], valid)
    assert t_final.cell_valid.tolist() == [c != NAN_CELL
                                           for c in range(N_CELL)]
    # the frozen cell keeps the state it had before its first NaN record;
    # every field agrees with vic_tpu's at 1e-4
    for f in dataclasses.fields(j_final):
        a = np.asarray(getattr(j_final, f.name))
        b = getattr(t_final, f.name).numpy()
        if f.name != "cell_valid":
            np.testing.assert_array_equal(b[NAN_CELL],
                                          getattr(before, f.name).numpy()[
                                              NAN_CELL], err_msg=f.name)
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=TOL, atol=TOL,
                                       err_msg=f.name)
        else:
            np.testing.assert_array_equal(b, a, err_msg=f.name)


def test_continue_on_error_outputs_of_both(nan_runs):
    """Every output of the valid cells at 1e-4; on the NaN cell's invalid
    records, outputs are multiplied by 0: NaN where vic_tpu's are NaN. On
    its [n_cell] outputs XLA-CPU rewrites vic_tpu's x * valid into a
    select and writes 0 (vic_tpu's own eager run writes NaN there, as the
    port does): the port's are 0 or NaN (ROADMAP.md queue 3)."""
    _, j_outs, _, t_outs, _ = nan_runs
    assert sorted(t_outs) == sorted(j_outs)
    cells = [c for c in range(N_CELL) if c != NAN_CELL]
    nan_somewhere = 0
    for k, a in j_outs.items():
        b = t_outs[k]
        assert b.shape == a.shape and b.dtype == a.dtype, k
        np.testing.assert_allclose(b[:, cells], a[:, cells], rtol=TOL,
                                   atol=TOL, err_msg=k)
        np.testing.assert_allclose(b[:NAN_FROM], a[:NAN_FROM], rtol=TOL,
                                   atol=TOL, err_msg=k)
        a_bad, b_bad = a[NAN_FROM:, NAN_CELL], b[NAN_FROM:, NAN_CELL]
        assert np.isnan(b_bad[np.isnan(a_bad)]).all(), k
        ok = np.isnan(b_bad) | (b_bad == 0.0)
        assert ok[~np.isnan(a_bad)].all(), k
        nan_somewhere += int(np.isnan(b_bad).any())
    assert nan_somewhere > 0
