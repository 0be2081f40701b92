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
