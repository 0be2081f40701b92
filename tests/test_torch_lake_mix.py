"""The stop rule of the lake kernels' convective mix.

K10 and K11 (csrc/lake.cuh tracer_mix) stop tracer_mixer's red-black
sweeps after the first full sweep in which no pair mixes. That sweep left
the column as it was, so every later sweep would too, and the stopped mix
has the bits of the fixed MIX_SWEEPS sweeps. Here that holds for the port's
`vic_tpu_torch.physics.lake.tracer_mixer` and for vic_tpu's (a lax
fori_loop), each stopped by the version below, on:

- seeded columns about 4 C, the density maximum, so that unstable pairs lie
  on both sides of it;
- the same with NaN layers (a NaN density never mixes);
- columns of 1, 2, 19 and 20 active layers;
- the final lake columns of the lakes fixture
  (tests/fixtures/torch_port/lakes_16x4.npz).

The two packages' fixed sweeps differ in one operation: vic_tpu's XLA on
the CPU contracts the mean's numerator T[k] h[k] + T[k+1] h[k+1] into
fma(T[k], h[k], T[k+1] h[k+1]), where the port (and PyTorch on the card,
and K10 and K11) rounds both products. The port's arithmetic with that one
product fused (`_fused_mixer`, here only) equals vic_tpu's bit for bit on
every case; the port's own mix is held against vic_tpu's at the repo's
rule for lake columns (testing.mixed_column_excess at 1e-4, as
tests/test_torch_lake.py holds tracer_mixer; ROADMAP queue 3).

Only tracer_mixer is compiled in vic_tpu, no step.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vic_tpu.physics import lake as jlake
from vic_tpu_torch import constants
from vic_tpu_torch.entry import build_lakes
from vic_tpu_torch.physics import lake
from vic_tpu_torch.testing import mixed_column_excess

torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "torch_port", "lakes_16x4.npz")
N_LAKE = 64
# depths (m) giving 1, 2, 19 and 20 active layers (lake.make_grid)
DEPTH_OF_LAYERS = {1: 0.5, 2: 0.9, 19: 11.7, 20: 15.0}
FP_TOL = 1e-4       # C, tests/test_torch_lake.py's rule for lake columns
CASES = ("seeded_4c", "nan_layers", "layers_1", "layers_2", "layers_19",
         "layers_20", "lakes_fixture")

_jax_mixer = jax.jit(jlake.tracer_mixer, static_argnames="sweeps")


def _case(name):
    """(temp [n, 20], LayerGrid, cp) of a case, float32 from a seed."""
    rng = np.random.default_rng(16)
    if name == "lakes_fixture":
        fx = np.load(FIXTURE)
        temp = torch.from_numpy(fx["state/lake_temp"])
        lp = build_lakes(temp.shape[0], 1, "cpu")[4]["lake_params"]
        depth = lake.depth_from_volume(
            lp, torch.from_numpy(fx["state/lake_volume"]))
    else:
        lp = build_lakes(N_LAKE, 1, "cpu")[4]["lake_params"]
        if name.startswith("layers_"):
            depth = torch.full((N_LAKE,),
                               DEPTH_OF_LAYERS[int(name.split("_")[1])])
        else:
            depth = torch.from_numpy(
                rng.uniform(0.3, 15.0, N_LAKE).astype(np.float32))
        temp = torch.from_numpy(
            rng.normal(4.0, 0.8, (N_LAKE, lake.MAX_LAKE_NODES))
            .astype(np.float32))
        if name == "nan_layers":
            temp[::5, 3] = float("nan")
            temp[1::7, 0] = float("nan")
    grid = lake.make_grid(lp, depth)
    return temp, grid, lake.specheat(temp)


def _to_jax(grid):
    return jlake.LayerGrid(**{k: jnp.asarray(v.numpy())
                              for k, v in grid._asdict().items()})


def _port(temp, grid, cp, sweeps):
    return lake.tracer_mixer(temp, grid, cp, sweeps=sweeps).numpy()


def _vic(temp, grid, cp, sweeps):
    return np.asarray(_jax_mixer(jnp.asarray(temp.numpy()), _to_jax(grid),
                                 jnp.asarray(cp.numpy()), sweeps=sweeps))


def _fused_mixer(temp, grid, cp, sweeps):
    """The port's tracer_mixer with the mean's numerator formed as
    vic_tpu's XLA forms it on the CPU: fma(T[k], h[k], T[k+1] h[k+1]), the
    float32 product exact in float64 and the sum rounded once."""
    nn = temp.shape[-1]
    s_node = torch.clamp(grid.surface[..., :-1], min=constants.SMALL)
    parity = torch.arange(nn - 1) % 2
    t = temp
    for _ in range(sweeps):
        for par in (0, 1):
            rho = lake.water_density(t)
            heat = grid.z * (1.0e3 + rho) * cp * s_node
            do = ((rho[..., :-1] > rho[..., 1:]) & (parity == par)
                  & grid.mask[..., 1:])
            num = (t[..., :-1].double() * heat[..., :-1].double()
                   + (t[..., 1:] * heat[..., 1:]).double()).float()
            tav = num / torch.clamp(heat[..., :-1] + heat[..., 1:],
                                    min=constants.SMALL)
            t = torch.cat([torch.where(do, tav, t[..., :-1]),
                           t[..., -1:]], -1)
            t = torch.cat([t[..., :1], torch.where(do, tav, t[..., 1:])],
                          -1)
    return t.numpy()


def _stopped(package, temp, grid, cp):
    """The package's tracer_mixer run one sweep at a time, each column
    stopped after its first sweep that mixes no pair: (columns, sweeps run
    per column). A sweep mixes a pair exactly when the column starts it
    with a density-unstable active pair: a pass that mixes nothing leaves
    the column to the next pass."""
    mix, density = ((_port, lambda t: lake.water_density(
        torch.from_numpy(t)).numpy()) if package == "port" else
        (_vic, lambda t: np.asarray(jlake.water_density(jnp.asarray(t)))))
    mask = grid.mask.numpy()
    t = temp.numpy()
    running = np.ones(t.shape[0], bool)
    sweeps = np.zeros(t.shape[0], np.int64)
    for _ in range(lake.MIX_SWEEPS):
        rho = density(t)
        unstable = ((rho[:, :-1] > rho[:, 1:]) & mask[:, 1:]).any(-1)
        sweeps += running
        running &= unstable
        if not running.any():
            break
        t = np.where(running[:, None],
                     mix(torch.from_numpy(t), grid, cp, 1), t)
    return t, sweeps


def _bits_equal(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return a.shape == b.shape and bool(
        ((a.view(np.int32) == b.view(np.int32))
         | (np.isnan(a) & np.isnan(b))).all())


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("package", ["port", "vic_tpu"])
def test_mix_stopped_once_stable_equals_fixed_sweeps(package, case):
    """The stopped mix equals MIX_SWEEPS fixed sweeps bit for bit."""
    temp, grid, cp = _case(case)
    fixed = (_port if package == "port" else _vic)(temp, grid, cp,
                                                   lake.MIX_SWEEPS)
    stopped, sweeps = _stopped(package, temp, grid, cp)
    assert _bits_equal(stopped, fixed)
    assert int(sweeps.min()) >= 1
    if case == "seeded_4c":
        # columns that mix over several sweeps and still stop early
        assert int(sweeps.max()) > 2 and int(sweeps.min()) < lake.MIX_SWEEPS
    if case == "layers_1":
        assert int(sweeps.max()) == 1
    if case == "nan_layers":
        assert bool(np.isnan(fixed).any())


@pytest.mark.parametrize("case", CASES)
def test_port_mix_against_vic_tpu(case):
    """The port's fixed sweeps with vic_tpu's fused product equal vic_tpu's
    bit for bit; the port's own are within the rule for lake columns; both
    mix."""
    temp, grid, cp = _case(case)
    vic = _vic(temp, grid, cp, lake.MIX_SWEEPS)
    assert _bits_equal(_fused_mixer(temp, grid, cp, lake.MIX_SWEEPS), vic)
    port = _port(temp, grid, cp, lake.MIX_SWEEPS)
    assert mixed_column_excess(port, vic, FP_TOL) == []
    if case.startswith("layers_") and case != "layers_1" \
            or case in ("seeded_4c", "nan_layers"):
        assert not _bits_equal(port, temp.numpy())
