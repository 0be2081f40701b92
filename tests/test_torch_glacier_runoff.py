"""K1 (glacier_brent) and K4 (runoff_hourly), through their plain versions,
against vic_tpu, and the kernels' rows by name (each kernel against its
plain version on the card: tests/test_torch_kernels.py, which runs
without JAX).

- K1's plain version (`glacier.glacier_brent_plain`): the melt test at
  0 C, the Brent's root and flags against vic_tpu's
  `glacier_energy_terms` at 0 C and vic_tpu's own `batched_brent` on the
  same lanes, and every field of the `glacier_ablation` built from it
  (the melt, the temperature, cold content, vapour loss and fallback flag
  and the terms at the accepted temperature) against vic_tpu's
  `glacier_ablation` on the same arguments; each on the arguments the
  port's step hands them in light's first record, blowing_close's fourth
  (CLOSE_ENERGY's first pass), spatial_snow's second (ice melting at 0 C)
  and heavy_nolakes' fourth (3-hourly).
- K4's plain version (`runoff.runoff_step_plain`): every field of
  RunoffResult against vic_tpu's `runoff_step` on light's first record
  (daily), frozen's third (soil ice) and heavy_nolakes' fourth, its dry
  column (3-hourly, DIST_PRCP).

Tolerances: each terms field at rtol 1e-4 and its unit's atol
(vic_tpu_torch.testing.terms_atol: 1e-4 W/m^2, J/m^2 or C, water 1e-8 m
or 1e-5 mm, the residual at the root 1e-3 W/m^2), roots within 1e-4 C,
flags and melt tests equal; K4's fields at 1e-5.
"""
import functools
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vic_tpu.physics.glacier as j_glacier
import vic_tpu.physics.runoff as j_runoff
import vic_tpu_torch.physics.glacier as t_glacier
import vic_tpu_torch.physics.runoff as t_runoff
from vic_tpu.ops.rootfind import batched_brent as j_batched_brent
from vic_tpu_torch import constants as c
from vic_tpu_torch import kernels, model
from vic_tpu_torch.entry import CONFIGS
from vic_tpu_torch.kernels import build
from vic_tpu_torch.testing import TERMS_RTOL, terms_atol

torch.set_num_threads(1)

N_CELL = 4
ROOT_TOL = 1e-4
RUNOFF_TOL = 1e-5
# configuration -> the record whose step gives the arguments
GLACIER_CASES = {"light": 0, "blowing_close": 3, "spatial_snow": 1,
                 "heavy_nolakes": 3}
# configuration -> (record, call of runoff_step in that step's record)
RUNOFF_CASES = {"light": (0, 0), "frozen": (2, 0), "heavy_nolakes": (3, 1)}


def to_j(x):
    if isinstance(x, torch.Tensor):
        return jnp.asarray(x.numpy())
    if isinstance(x, dict):
        return {k: to_j(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(to_j(v) for v in x)
    return x


@functools.lru_cache(maxsize=None)
def step_calls(config, record):
    """{name: [(args, kwargs), ...]} of the calls of the plain K1 and K4
    and of glacier_ablation in the port's CPU step of `config`'s record
    `record`."""
    homes = {"glacier_brent_plain": t_glacier,
             "runoff_step_plain": t_runoff,
             "glacier_ablation": model}
    gp, params, stack, state, extras = CONFIGS[config](N_CELL, record + 1,
                                                       "cpu")
    step = model.make_step(params, gp, **extras)
    for r in range(record):
        state, _ = step(state, {k: v[r] for k, v in stack.items()})
    calls = {name: [] for name in homes}
    originals = {name: getattr(mod, name) for name, mod in homes.items()}

    def wrap(name, fn):
        def wrapper(*a, **k):
            calls[name].append((a, k))
            return fn(*a, **k)
        return wrapper

    for name, mod in homes.items():
        setattr(mod, name, wrap(name, originals[name]))
    try:
        step(state, {k: v[record] for k, v in stack.items()})
    finally:
        for name, mod in homes.items():
            setattr(mod, name, originals[name])
    return calls


def close_fields(got, ref, residual, label, fields=None):
    """The named fields (every tensor field of `got`) against vic_tpu's
    field of the same name, at TERMS_RTOL and the field's own atol."""
    for field in fields or got._fields:
        g = getattr(got, field)
        if not isinstance(g, torch.Tensor):
            continue
        g = g.numpy()
        np.testing.assert_allclose(
            g, np.broadcast_to(np.asarray(getattr(ref, field)), g.shape),
            rtol=TERMS_RTOL, atol=terms_atol(field, residual),
            err_msg=f"{label}: {field}")


# ------------------------------------------------------------------- K1
@pytest.mark.parametrize("config", sorted(GLACIER_CASES))
def test_glacier_brent_plain_matches_vic_tpu(config):
    """The melt test at 0 C and the root and flags on the lanes it solves
    against vic_tpu's glacier_energy_terms and Brent on the same
    arguments; and every field of glacier_ablation's result (melt,
    temperature, cold content, vapour loss, fallback flag and the terms at
    the accepted temperature) against vic_tpu's glacier_ablation on the
    same arguments."""
    calls = step_calls(config, GLACIER_CASES[config])
    (lo, hi, active), kw = calls["glacier_brent_plain"][0]
    got = t_glacier.glacier_brent_plain(lo, hi, active, **kw)

    jin = to_j({k: v for k, v in kw.items()
                if k not in ("max_iter", "max_tries")})

    def terms(t):
        return j_glacier.glacier_energy_terms(t, **jin)

    melt = terms(jnp.zeros(tuple(lo.shape))).rest == 0.0
    res = j_batched_brent(lambda t: terms(t).rest, to_j(lo), to_j(hi),
                          max_iter=kw["max_iter"], max_tries=kw["max_tries"],
                          active=~melt & to_j(active))
    np.testing.assert_array_equal(got.melt_cond.numpy(), np.asarray(melt))
    np.testing.assert_array_equal(got.converged.numpy(),
                                  np.asarray(res.converged))
    np.testing.assert_array_equal(got.bracketed.numpy(),
                                  np.asarray(res.bracketed))
    np.testing.assert_allclose(got.root.numpy(), np.asarray(res.root),
                               rtol=ROOT_TOL, atol=ROOT_TOL)

    (), akw = calls["glacier_ablation"][0]
    port = t_glacier.glacier_ablation(**akw)
    ref = j_glacier.glacier_ablation(**to_j(akw))
    assert port._fields == ref._fields
    np.testing.assert_array_equal(port.fbflag.numpy(),
                                  np.asarray(ref.fbflag))
    np.testing.assert_allclose(port.surf_temp.numpy(),
                               np.asarray(ref.surf_temp), rtol=TERMS_RTOL,
                               atol=ROOT_TOL, err_msg=f"{config}: surf_temp")
    close_fields(port, ref, None, config,
                 ("melt_mm", "cold_content", "vapor_flux"))
    close_fields(port.terms, ref.terms, "rest", f"{config} terms")


def test_glacier_cases_reach_the_melt_test_and_the_solve():
    """spatial_snow's ice melts at 0 C on some lanes; light's is solved on
    others."""
    (lo, hi, active), kw = step_calls("spatial_snow", 1)[
        "glacier_brent_plain"][0]
    assert bool(t_glacier.glacier_brent_plain(lo, hi, active, **kw)
                .melt_cond.any())
    (lo, hi, active), kw = step_calls("light", 0)["glacier_brent_plain"][0]
    assert bool(t_glacier.glacier_brent_plain(lo, hi, active, **kw)
                .bracketed.any())


@pytest.mark.parametrize("fault", ["vapor_flux over ice density",
                                   "vapor_flux without dt"])
def test_terms_rule_fails_planted_glacier_water_faults(fault):
    """K1's water term (vapor_flux, m a step) is held in its own unit: the
    flux divided by ice density where it should be water density on the
    lanes under 1e-3 m, or per second where it should be per step, each
    fails the rule that holds the kernel's terms, though the first lies
    within 1e-4 m, an atol that held every field in one unit (heavy_nolakes'
    3-hourly fluxes, some under 1e-3 m)."""
    (lo, hi, active), kw = step_calls("heavy_nolakes", 3)[
        "glacier_brent_plain"][0]
    good = t_glacier.glacier_brent_plain(lo, hi, active, **kw).terms
    vf = good.vapor_flux
    if "density" in fault:
        bad = torch.where(vf.abs() < 1e-3, vf * c.RHO_W / c.ICE_DENSITY, vf)
        assert float((bad - vf).abs().max()) < 1e-4
    else:
        bad = vf / kw["dt"]
    assert float((bad - vf).abs().max()) > 0.0
    close_fields(good, good, "rest", fault)
    with pytest.raises(AssertionError, match="vapor_flux"):
        close_fields(good._replace(vapor_flux=bad), good, "rest", fault)


# ------------------------------------------------------------------- K4
@pytest.mark.parametrize("config", sorted(RUNOFF_CASES))
def test_runoff_step_plain_matches_vic_tpu(config):
    """Every field of RunoffResult against vic_tpu's runoff_step on the
    arguments the port's step gives it."""
    record, call = RUNOFF_CASES[config]
    a, kw = step_calls(config, record)["runoff_step_plain"][call]
    got = t_runoff.runoff_step_plain(*a, **kw)
    ref = j_runoff.runoff_step(*to_j(tuple(a)), **to_j(kw))
    for field, g in zip(got._fields, got):
        np.testing.assert_allclose(
            g.numpy(), np.asarray(getattr(ref, field)), rtol=RUNOFF_TOL,
            atol=RUNOFF_TOL, err_msg=f"{config}: {field}")
    if config == "frozen":
        assert bool((a[1] > 0.0).any())          # soil ice
    if config == "heavy_nolakes":
        assert a[-1] == 3                        # 3-hourly, the dry column


def test_cpu_step_runs_the_plain_k1_and_k4_once():
    """On the CPU the light step takes glacier_ablation's solve from
    glacier_brent_plain and its runoff from runoff_step_plain, once
    each."""
    calls = step_calls("light", 0)
    assert len(calls["glacier_brent_plain"]) == 1
    assert len(calls["runoff_step_plain"]) == 1


# ------------------------------------------------- the kernels' rows
def _enum(src, name):
    body = re.search(r"enum %s \{([^}]*)\}" % name, src).group(1)
    return [w.strip() for w in body.split(",") if w.strip()]


def _camel(name):
    return "k" + "".join(w[:1].upper() + w[1:] for w in name.split("_"))


def test_glacier_terms_are_the_kernels_rows():
    """K1 writes glacier.GlacierEBTerms' fields and then
    kernels.GLACIER_OUTPUTS in csrc/vic_kernels.cu's GlacierTerm and
    GlacierOut order, and kernels.GLACIER_FLAGS in GlacierFlag's; with the
    Brent's four they are every field of GlacierSolve; its residual's
    terms() forms each of the terms (csrc/pack_residuals.cuh
    GlacierTerms)."""
    k1 = (build.CSRC / "vic_kernels.cu").read_text()
    assert _enum(k1, "GlacierTerm") == [
        _camel(k) for k in t_glacier.GlacierEBTerms._fields] + [
        "kNumGlacierTerms"]
    assert _enum(k1, "GlacierOut")[:-1] == [
        "kMeltMm", "kSurfTemp", "kColdContent", "kVaporLoss"]
    assert len(kernels.GLACIER_OUTPUTS) == 4
    assert _enum(k1, "GlacierFlag") == [
        _camel(k) for k in kernels.GLACIER_FLAGS] + ["kNumGlacierFlags"]
    assert set(t_glacier.GlacierSolve._fields) == {
        "root", "converged", "bracketed", "iterations", "terms",
        *kernels.GLACIER_OUTPUTS, *kernels.GLACIER_FLAGS}
    res = (build.CSRC / "pack_residuals.cuh").read_text()
    body = re.search(r"struct GlacierTerms \{\s*float([^;]*);", res).group(1)
    assert [w.strip() for w in body.split(",")] == list(
        t_glacier.GlacierEBTerms._fields)


def test_runoff_rows_are_the_kernels_rows():
    """K4 reads kernels.RUNOFF_LAYER_INPUTS and RUNOFF_LANE_INPUTS in
    csrc/vic_kernels.cu's RunoffIn order, the names of runoff_step's
    arguments, and writes RunoffResult's fields in RunoffOut's."""
    k4 = (build.CSRC / "vic_kernels.cu").read_text()
    names = kernels.RUNOFF_LAYER_INPUTS + kernels.RUNOFF_LANE_INPUTS
    assert _enum(k4, "RunoffIn") == [_camel(k) for k in names] + [
        "kNumRunoffIn"]
    import inspect
    params = list(inspect.signature(t_runoff.runoff_step).parameters)
    assert sorted(names) == sorted(params[:-1])
    assert _enum(k4, "RunoffOut") == [
        _camel(k) + "Out" for k in t_runoff.RunoffResult._fields] + [
        "kNumRunoffOut"]


def test_glacier_and_runoff_wrappers_refuse_cpu_tensors():
    t = torch.zeros(2, 4)
    lay = torch.zeros(2, 4, 3)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.glacier_brent(t, t, None, dt=86400.0, max_iter=60,
                              max_tries=1,
                              **dict.fromkeys(kernels.GLACIER_INPUTS, t))
    with pytest.raises(ValueError, match="CUDA"):
        kernels.runoff_hourly(lay, lay, lay, t, lay, lay, lay, lay, lay, t,
                              t, t, t, t, 24)
