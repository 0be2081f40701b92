"""The port's own copies of vic_tpu's jax-free modules (constants, config,
timeaxis) say what the originals say: the port imports nothing of vic_tpu,
so these copies are how it shares them."""
import dataclasses

import numpy as np
import pytest

import vic_tpu.config as jconfig
import vic_tpu.constants as jconstants
import vic_tpu.timeaxis as jtimeaxis
import vic_tpu_torch.config as tconfig
import vic_tpu_torch.constants as tconstants
import vic_tpu_torch.timeaxis as ttimeaxis


def public(module):
    return {k: v for k, v in vars(module).items()
            if not k.startswith("_") and not callable(v)
            and not isinstance(v, type(np))}


def test_constants_match_name_by_name():
    ref, got = public(jconstants), public(tconstants)
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        assert type(got[k]) is type(v), k
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v),
                                      err_msg=k)
    for enum in ("GroundFlux", "RainSnowMethod", "SnowAlbedo", "SnowDensity"):
        assert ({m.name: m.value for m in getattr(tconstants, enum)}
                == {m.name: m.value for m in getattr(jconstants, enum)}), enum


def plain(value):
    """A default as plain data: dataclasses and enums of either package
    compare by their fields, names and values."""
    if dataclasses.is_dataclass(value):
        return {f.name: plain(getattr(value, f.name))
                for f in dataclasses.fields(value)}
    if isinstance(value, (list, tuple)):
        return [plain(v) for v in value]
    if isinstance(value, dict):
        return {k: plain(v) for k, v in value.items()}
    if hasattr(value, "name") and hasattr(value, "value"):
        return (type(value).__name__, value.name, value.value)
    return value


def test_global_params_fields_and_defaults_match():
    ref = {f.name: f for f in dataclasses.fields(jconfig.GlobalParams)}
    got = {f.name: f for f in dataclasses.fields(tconfig.GlobalParams)}
    assert list(got) == list(ref)
    a, b = jconfig.GlobalParams(), tconfig.GlobalParams()
    for name in ref:
        assert plain(getattr(b, name)) == plain(getattr(a, name)), name
    # the snow step is clamped to the model step on construction, as
    # vic_tpu's global-file parser clamps it (vic_tpu/config.py:459)
    for kw in (dict(dt=3, snow_step=24), dict(dt=24, snow_step=3)):
        ja, tb = jconfig.GlobalParams(**kw), tconfig.GlobalParams(**kw)
        ja.snow_step = min(ja.snow_step, ja.dt)
        assert (tb.snow_step, tb.nf, tb.nr) == (ja.snow_step, ja.nf,
                                                ja.nr), kw
    assert b.replace(dt=3).dt == 3 and b.dt == a.dt


@pytest.mark.parametrize("start,n_rec,dt", [
    ((1995, 1, 1, 0), 40, 24), ((1996, 2, 27, 0), 30, 24),
    ((2000, 12, 31, 21), 17, 3), ((1999, 6, 15, 6), 9, 6)])
def test_make_time_axis_matches(start, n_rec, dt):
    ref = jtimeaxis.make_time_axis(*start, n_rec, dt)
    got = ttimeaxis.make_time_axis(*start, n_rec, dt)
    for f in dataclasses.fields(ref):
        np.testing.assert_array_equal(np.asarray(getattr(got, f.name)),
                                      np.asarray(getattr(ref, f.name)),
                                      err_msg=f.name)


def test_make_lake_params_matches_field_by_field():
    """The port's numpy copy of the synthetic parabolic basin equals
    vic_tpu's, and lake_params_from_numpy carries either onto a device as
    the same float32 tensors."""
    from vic_tpu.physics.lake import LakeParams, make_lake_params as jmake
    from vic_tpu.testing import synthetic_domain as jdomain
    from vic_tpu_torch.physics.lake import LakeParams as TLakeParams
    from vic_tpu_torch.physics.lake import make_lake_params as tmake
    from vic_tpu_torch.prepare import lake_params_from_numpy
    from vic_tpu_torch.testing import synthetic_domain as tdomain
    ref = jmake(jdomain(n_cell=5).soil, jconfig.GlobalParams())
    got = tmake(tdomain(n_cell=5).soil, tconfig.GlobalParams())
    assert list(got) == [f.name for f in dataclasses.fields(LakeParams)]
    assert [f.name for f in dataclasses.fields(TLakeParams)] == list(got)
    for k in got:
        a, b = np.asarray(getattr(ref, k)), got[k]
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(b, a, err_msg=k)
    from_ref = lake_params_from_numpy(ref, "cpu").numpy()
    for k, v in lake_params_from_numpy(got, "cpu").numpy().items():
        np.testing.assert_array_equal(v, from_ref[k], err_msg=k)
        assert v.dtype == {"has_lake": np.bool_,
                           "numnod": np.int32}.get(k, np.float32), k


def test_initial_lake_state_matches_field_by_field():
    """The cold-start lake state of the port's initial_state equals
    vic_tpu's (initialize_lake.c), every lake_* field."""
    import jax
    import jax.numpy as jnp
    from vic_tpu.physics.lake import make_lake_params as jmake
    from vic_tpu.state import initial_state as jinit
    from vic_tpu.testing import synthetic_domain as jdomain
    from vic_tpu_torch.entry import build_lakes
    gp = jconfig.GlobalParams(dt=24, nlayer=3, snow_band=2, glacier_id=99,
                              lakes=True)
    domain = jdomain(n_cell=5, n_band=2, with_glacier=True)
    lp = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float32)
        if np.asarray(a).dtype.kind == "f" else jnp.asarray(a),
        jmake(domain.soil, gp))
    ref = jinit(domain, gp, lake_params=lp)
    _, _, _, state, _ = build_lakes(5, 1, "cpu")
    got = state.numpy()
    lake_fields = [f.name for f in dataclasses.fields(ref)
                   if f.name.startswith("lake_")]
    assert len(lake_fields) == 14
    for k in lake_fields:
        a = np.asarray(getattr(ref, k))
        assert got[k].dtype == a.dtype, k
        np.testing.assert_array_equal(got[k], a, err_msg=k)
