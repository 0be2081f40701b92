"""The port's run driver with the cell axis split over several devices
(`run_simulation(devices=[...])`, vic_tpu_torch/parallel/sharding.py),
here three CPU devices: light (a glacier tile, 2 bands, a glacier
mass-balance fit inside the run) against vic_tpu's run over a 3-device
mesh of conftest's virtual CPU devices, lakes against the port's own
one-device run, and the configurations whose step stops a loop on a test
over the whole batch (frozen, blowing_close, heavy_nolakes: the shares
vote each such test, vic_tpu_torch/parallel/votes.py) against the port's
one-device run, heavy_nolakes also against vic_tpu's mesh run.

The gate is tests/test_sharding_driver.py's: every output at rtol = atol =
1e-5 (1e-3 on the OUT_*_ERROR residuals), |OUT_WATER_ERROR| <= 1e-2, every
state field at rtol = atol = 1e-5 (integer and flag fields equal). A split
run is held at it against the port's one-device run. Against vic_tpu's
mesh run it is held at the port's bound against vic_tpu
(tests/test_torch_driver.py's rtol = atol = 1e-4): the port's one-device
run already differs from vic_tpu's one-device run by up to 2.1 times the
1e-5 gate (9.7e-5 W/m^2 in one element of OUT_NET_LONG_BAND, a surface
temperature root that differs within the Brent tolerance), as much as the
split run differs from the mesh run, while the split itself moves no
leaf by more than a hundredth of the gate. Against vic_tpu's heavy_nolakes
mesh run the split run is held as tests/test_torch_heavy_model.py holds
the step: at 1e-4 but for the heavy leaves of ROADMAP.md queue 3
(vic_tpu_torch.testing.heavy_run_failures).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import vic_tpu.config as jconfig
import vic_tpu_torch.config as tconfig

torch.set_num_threads(1)

N_CELL = 7          # not a multiple of 3: one clone cell pads each share
N_REC = 6
# the interval starts on 4 January: a fit at the end of record 2, and
# the accumulator zeroed on every device
GMB = dict(glacier_accum_start_year=1994, glacier_accum_start_month=1,
           glacier_accum_start_day=4)
SPLIT = ["cpu"] * 3


def light_gp(cfg, n_rec=N_REC, **kw):
    return cfg.GlobalParams(dt=24, snow_step=24, nlayer=3, startyear=1995,
                            startmonth=1, startday=1, nrecs=n_rec,
                            full_energy=True, glacier_id=99, snow_band=2,
                            **GMB, **kw)


def port_run(gp, n_cell=N_CELL, **kw):
    from vic_tpu_torch.driver import run_simulation
    from vic_tpu_torch.testing import synthetic_domain, synthetic_forcing
    return run_simulation(
        gp, domain=synthetic_domain(n_cell=n_cell, n_band=2,
                                    with_glacier=True),
        forcing=synthetic_forcing(gp.nrecs, n_cell), write_output=False,
        progress=False, **kw)


GATE = 1e-5
VS_VIC_TPU = 1e-4       # tests/test_torch_driver.py's TOL


def assert_gate(ref_outputs, ref_state, res, tol=GATE, closure=True):
    """`res` (the port's RunResult) against outputs and state fields given
    as numpy arrays, at test_sharding_driver's gate (`tol` in place of its
    1e-5). closure=False: with DIST_PRCP the reference's own closure
    residual on raining glacier lanes exceeds 1e-2 mm (ROADMAP.md queue 3),
    and OUT_WATER_ERROR is held against the reference cell for cell
    only."""
    assert sorted(res.outputs) == sorted(ref_outputs)
    for k, a in ref_outputs.items():
        b = res.outputs[k]
        assert b.shape == a.shape, k
        atol = 1e-3 if k.endswith("_ERROR") else tol
        np.testing.assert_allclose(b, a, rtol=tol, atol=atol, err_msg=k)
    if closure:
        assert np.abs(res.outputs["OUT_WATER_ERROR"]).max() <= 1e-2
    for f in dataclasses.fields(res.final_state):
        a = ref_state[f.name]
        b = getattr(res.final_state, f.name)
        assert b.device.type == "cpu" and b.shape == a.shape, f.name
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b.numpy(), a, rtol=tol, atol=tol,
                                       err_msg=f.name)
        else:
            np.testing.assert_array_equal(b.numpy(), a, err_msg=f.name)


def assert_gmb_equal(ref, got, tol=GATE):
    assert [r.date for r in got] == [r.date for r in ref]
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.n_points, r.n_points)
        for k in ("b0", "b1", "b2"):
            np.testing.assert_allclose(getattr(g, k), getattr(r, k),
                                       rtol=tol, atol=1e-9, err_msg=k)


def run_result_arrays(res):
    return ({k: np.asarray(v) for k, v in res.outputs.items()},
            {f: np.asarray(getattr(res.final_state, f))
             for f in res.final_state.__dataclass_fields__})


@pytest.fixture(scope="module")
def vic_tpu_mesh_run():
    """vic_tpu's light run over a 3-device cell mesh (7 cells padded to
    9)."""
    from vic_tpu.driver import run_simulation
    from vic_tpu.testing import synthetic_domain, synthetic_forcing
    assert len(jax.devices()) >= 3
    res = run_simulation(
        light_gp(jconfig), domain=synthetic_domain(
            n_cell=N_CELL, n_band=2, with_glacier=True),
        forcing=dict(synthetic_forcing(N_REC, N_CELL)), write_output=False,
        progress=False, devices=jax.devices()[:3])
    return run_result_arrays(res) + (res.gmb_results,)


@pytest.fixture(scope="module")
def one_device_light():
    res = port_run(light_gp(tconfig), device="cpu")
    return run_result_arrays(res) + (res.gmb_results,)


def test_split_light_matches_vic_tpu_mesh(vic_tpu_mesh_run,
                                         one_device_light):
    outs, state, gmb = vic_tpu_mesh_run
    res = port_run(light_gp(tconfig), devices=SPLIT)
    assert_gate(outs, state, res, tol=VS_VIC_TPU)
    assert [r.date for r in res.gmb_results] == [(1995, 1, 3)]
    assert_gmb_equal(gmb, res.gmb_results, tol=VS_VIC_TPU)
    assert_gate(*one_device_light[:2], res)
    assert_gmb_equal(one_device_light[2], res.gmb_results)
    # the fit zeroed every device's accumulator: the state holds what the
    # three records after it gathered
    assert np.abs(state["glac_cum_mass_balance"]).max() > 0.0


@pytest.mark.parametrize("chunks", [dict(chunk_cells=4),
                                    dict(chunk_cells=4, chunk_recs=2),
                                    dict(chunk_recs=4)])
def test_split_light_in_chunks_matches_one_device(one_device_light,
                                                  chunks):
    """Cell blocks of 4 (the last, of 3 cells, padded to 4 and split over
    3 devices as 6) and record chunks, against the unsplit run."""
    outs, state, gmb = one_device_light
    res = port_run(light_gp(tconfig), devices=SPLIT, **chunks)
    assert_gate(outs, state, res)
    n_block = -(-N_CELL // chunks.get("chunk_cells", N_CELL))
    assert len(res.gmb_results) == n_block
    got_b0 = np.concatenate([r.b0 for r in res.gmb_results])
    np.testing.assert_allclose(got_b0, gmb[0].b0, rtol=1e-5, atol=1e-9)


def test_split_lakes_matches_one_device():
    gp = light_gp(tconfig, n_rec=4, lakes=True)
    one = port_run(gp, device="cpu")
    split = port_run(gp, devices=SPLIT)
    assert_gate(*run_result_arrays(one)[:2], split)
    assert int(split.final_state.lake_volume.shape[0]) == N_CELL
    assert float(split.final_state.lake_volume.min()) > 0.0


# the batch-wide stops' configurations: (records, the forcing's maker)
STOPS = {"frozen": (2, "synthetic_forcing"),
         "blowing_close": (3, "blowing_close_forcing"),
         "heavy_nolakes": (4, "heavy_forcing")}


def stops_run(config, n_rec=None, **kw):
    """`config` (entry.<config>_params, every record one SNOW_STEP) through
    the port's driver on N_CELL cells of the synthetic domain and the
    configuration's forcing."""
    from vic_tpu_torch import entry, testing
    from vic_tpu_torch.driver import run_simulation
    n, forcing = STOPS[config]
    n_rec = n_rec or n
    gp = getattr(entry, f"{config}_params")(n_rec)
    gp = gp.replace(snow_step=gp.dt)
    make = getattr(entry, forcing, None) or getattr(testing, forcing)
    return run_simulation(
        gp, domain=testing.synthetic_domain(n_cell=N_CELL, n_band=2,
                                            with_glacier=True),
        forcing=make(n_rec, N_CELL, dt_hours=gp.dt), write_output=False,
        progress=False, **kw)


def largest_difference(res, ref_outputs, ref_state):
    """The largest |difference| of `res` from reference arrays, over every
    output and float state field."""
    worst = max(float(np.abs(res.outputs[k] - a).max())
                for k, a in ref_outputs.items() if a.size)
    return max([worst] + [
        float(np.abs(getattr(res.final_state, f).numpy() - a).max())
        for f, a in ref_state.items() if a.dtype.kind == "f" and a.size])


@pytest.fixture(scope="module")
def heavy_nolakes_runs():
    """heavy_nolakes (FROZEN_SOIL on 5 nodes, CLOSE_ENERGY, DIST_PRCP,
    BLOWING) at 7 cells x 4 3-hourly records: the port's one-device run and
    its split over three devices (the record chunks of one record, so each
    chunk restarts the share group's votes)."""
    one = stops_run("heavy_nolakes", device="cpu")
    split = stops_run("heavy_nolakes", devices=SPLIT, chunk_recs=1)
    return run_result_arrays(one), split


@pytest.mark.parametrize("config", ["heavy_nolakes", "blowing_close",
                                    "frozen"])
def test_batch_wide_stops_split_matches_one_device(config,
                                                   request):
    """CLOSE_ENERGY (blowing_close, heavy_nolakes) and QUICK_FLUX off
    (frozen, heavy_nolakes) stop loops on tests over the whole batch; split
    over three devices, each share voting every such test with the others,
    the run equals the one-device run at the gate (the largest difference
    printed: CPU ulps, the vector and scalar paths of PyTorch's CPU kernels
    at the shares' sizes)."""
    if config == "heavy_nolakes":
        one, split = request.getfixturevalue("heavy_nolakes_runs")
    else:
        one = run_result_arrays(stops_run(config, device="cpu"))
        split = stops_run(config, devices=SPLIT)
    print(f"{config}: largest |difference| of the split run from the "
          f"one-device run {largest_difference(split, *one)}")
    assert_gate(*one, split, closure=config != "heavy_nolakes")


def heavy_nolakes_gp(cfg, n_rec):
    """entry.heavy_nolakes_params' flags on either package's
    GlobalParams."""
    return cfg.GlobalParams(
        dt=3, snow_step=3, nlayer=3, startyear=1995, startmonth=1,
        startday=1, nrecs=n_rec, full_energy=True, glacier_id=99,
        snow_band=2, frozen_soil=True, implicit=True, quick_flux=False,
        nnode=5, close_energy=True, dist_prcp=True, blowing=True)


def test_split_heavy_nolakes_matches_vic_tpu_mesh(heavy_nolakes_runs):
    """The split heavy_nolakes run against vic_tpu's run of it over a
    3-device mesh, from the same forcing: every output and state field at
    1e-4 but the heavy leaves (testing.heavy_run_failures), wherever the
    port's one-device run holds there. Where that run does not (its own
    bound against vic_tpu), the split run equals it at the gate
    (test_batch_wide_stops_split_matches_one_device). Measured at this
    size: one element each of OUT_SENSIBLE (2.48e-3 W/m^2 on -21.04),
    OUT_SENSIBLE_BAND (4.96e-3 on -7.70) and OUT_ENERGY_ERROR (3.06e-3 on
    1.16) in the last record of a cold cell off the thaw edge, in the
    one-device run and the split alike, the surface temperature 2.5e-5 C
    apart, inside the Brent's tolerance (ROADMAP.md queue 3)."""
    from vic_tpu.driver import run_simulation
    from vic_tpu.testing import synthetic_domain
    from vic_tpu_torch.entry import heavy_forcing
    from vic_tpu_torch.testing import heavy_run_failures
    n_rec = STOPS["heavy_nolakes"][0]
    ref = run_simulation(
        heavy_nolakes_gp(jconfig, n_rec), domain=synthetic_domain(
            n_cell=N_CELL, n_band=2, with_glacier=True),
        forcing=heavy_forcing(n_rec, N_CELL), write_output=False,
        progress=False, devices=jax.devices()[:3])
    outs, state = run_result_arrays(ref)
    (one_outs, one_state), split = heavy_nolakes_runs
    got_outs, got_state = run_result_arrays(split)
    assert sorted(got_outs) == sorted(outs)

    def leaves(o, st):
        return {**{f"out/{k}": v for k, v in o.items()},
                **{f"state/{k}": v for k, v in st.items()}}
    ref = leaves(outs, state)
    own = heavy_run_failures(ref, leaves(one_outs, one_state), VS_VIC_TPU)
    failed = heavy_run_failures(ref, leaves(got_outs, got_state),
                                VS_VIC_TPU)
    print(f"outside 1e-4 and the heavy leaves: the split run {failed}, the "
          f"one-device run {own}")
    assert set(failed) <= set(own), sorted(set(failed) - set(own))


def test_shares_split_and_gather():
    from vic_tpu_torch.cells import pad_cell_tree
    from vic_tpu_torch.parallel.sharding import (gather_cell_axis,
                                                 pad_cells, shard_cell_axis)
    rng = np.random.default_rng(3)
    tree = {"a": torch.as_tensor(rng.normal(size=(7, 2))),
            "f": rng.normal(size=(5, 7)), "k": torch.arange(4)}
    n_run = pad_cells(7, 3)
    padded = pad_cell_tree(pad_cell_tree(tree, 7, n_run - 7), 7, n_run - 7,
                           axis=1)
    shares = shard_cell_axis(padded, n_run, 3)
    assert [s["a"].shape[0] for s in shares] == [3, 3, 3]
    assert all(s["f"].shape == (5, n_run) for s in shares)
    back = gather_cell_axis(shares, 3)
    np.testing.assert_array_equal(back["a"].numpy()[:7], tree["a"].numpy())
    np.testing.assert_array_equal(back["a"].numpy()[7:],
                                  tree["a"].numpy()[[6, 6]])
    assert torch.equal(back["k"], tree["k"])
    fshares = shard_cell_axis(padded, n_run, 3, axis=1)
    fback = gather_cell_axis(fshares, 3, axis=1)
    np.testing.assert_array_equal(fback["f"][:, :7], tree["f"])
    with pytest.raises(ValueError, match="pad them first"):
        shard_cell_axis(tree, 7, 3)
