"""The frozen generators equal the program's at the program's seeds."""
import dataclasses

import numpy as np
import pytest

from benchmark import gen
from vic_tpu_torch import testing


def _arrays(obj, prefix=""):
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out.update(_arrays(v, f"{prefix}{f.name}."))
        else:
            out[prefix + f.name] = v
    return out


@pytest.mark.parametrize("n_band,with_glacier,seed",
                         [(2, True, 0), (1, False, 0), (2, True, 11)])
def test_domain_equals_the_programs(n_band, with_glacier, seed):
    ours = _arrays(gen.synthetic_domain(n_cell=40, n_band=n_band,
                                        with_glacier=with_glacier,
                                        seed=seed))
    theirs = _arrays(testing.synthetic_domain(n_cell=40, n_band=n_band,
                                              with_glacier=with_glacier,
                                              seed=seed))
    assert ours.keys() == theirs.keys()
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)


@pytest.mark.parametrize("dt,seed,start_doy", [(24, 3, 1), (24, 3, 182),
                                               (3, 9, 40)])
def test_forcing_equals_the_programs(dt, seed, start_doy):
    ours = gen.synthetic_forcing(7, 33, dt_hours=dt, seed=seed,
                                 start_doy=start_doy)
    theirs = testing.synthetic_forcing(7, 33, dt_hours=dt, seed=seed,
                                       start_doy=start_doy)
    assert ours.keys() == theirs.keys()
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)


def test_seeds_of_a_run():
    assert gen.run_seeds(0) == (0, 3, 7)
    big = 2 ** 31 + 12345
    assert gen.run_seeds(big)[:2] == (big, big + 3)
    assert gen.run_seeds(-1)[0] == 2 ** 64 - 1
    assert gen.day_of_year((1995, 7, 1)) == 182


def test_same_seed_same_inputs():
    cfg = {"domain": {"n_layer": 3, "n_band": 2, "with_glacier": True},
           "global_params": {"dt": 24}}
    traffic = {"n_cell": 20, "block_records": 4, "start": [1995, 1, 1]}
    a = gen.cell_inputs(cfg, traffic, 2 ** 31 + 5)
    b = gen.cell_inputs(cfg, traffic, 2 ** 31 + 5)
    c = gen.cell_inputs(cfg, traffic, 2 ** 31 + 6)
    np.testing.assert_array_equal(a[1]["air_temp"], b[1]["air_temp"])
    assert not np.array_equal(a[1]["air_temp"], c[1]["air_temp"])
    np.testing.assert_array_equal(a[0].soil.elevation, b[0].soil.elevation)
