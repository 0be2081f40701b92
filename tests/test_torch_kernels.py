"""The CUDA kernels' build, bindings and dispatch.

Without a GPU: building with no nvcc raises, the wrappers refuse CPU
tensors, and the step's call sites take the plain versions on the CPU
without launching anything. With a GPU (the `gpu` marker and the `cuda`
fixture, which skips without one) each kernel is checked against its plain
PyTorch version on the card. This file imports no JAX, so the GPU cases also
run on a host without it (tests/conftest.py imports jax, hence
`--noconftest`):

    python -m pytest --noconftest -q tests/test_torch_kernels.py
"""
import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from vic_tpu_torch import kernels
from vic_tpu_torch import entry
from vic_tpu_torch.entry import (CONFIGS, build_frozen, build_light,
                                 frozen_exp_params, frozen_params)
from vic_tpu_torch.kernels import build
from vic_tpu_torch.model import make_step
from vic_tpu_torch.model import OVER_TOL_F32
from vic_tpu_torch.physics import surface
from vic_tpu_torch.physics.blowing_snow import calc_blowing_snow_plain
from vic_tpu_torch.physics.canopy_air import canopy_air_step_plain
from vic_tpu_torch.physics.canopy_snow import canopy_brent_plain
from vic_tpu_torch.physics.frozen_soil import solve_t_profile_explicit_plain
from vic_tpu_torch.physics.glacier import glacier_brent_plain
from vic_tpu_torch.physics.lake import (depth_from_volume_plain,
                                        lake_ice_brent_plain,
                                        lake_open_water_plain,
                                        water_under_ice_plain)
from vic_tpu_torch.physics.runoff import runoff_hourly_plain
from vic_tpu_torch.physics.snow import snowpack_brent_plain
from vic_tpu_torch.physics.surface import surface_brent_plain

torch.set_num_threads(1)

PLAIN = {"glacier_brent": glacier_brent_plain,
         "snowpack_brent": snowpack_brent_plain,
         "canopy_brent": canopy_brent_plain,
         "runoff_hourly": runoff_hourly_plain,
         "surface_brent": surface_brent_plain,
         "node_sweep": solve_t_profile_explicit_plain,
         "fd_surface_brent": surface_brent_plain,
         "blowing_snow": calc_blowing_snow_plain,
         "canopy_air_step": canopy_air_step_plain,
         "affine_surface_brent": surface_brent_plain}


@pytest.fixture
def cuda():
    """The first CUDA device; the test is skipped where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build(build_dir=tmp_path / "build")
    assert not (tmp_path / "build").exists()


@pytest.mark.parametrize("name", ["glacier_brent", "snowpack_brent",
                                  "canopy_brent"])
def test_brent_wrappers_refuse_cpu_tensors(name):
    t = torch.zeros(4)
    with pytest.raises(ValueError, match="CUDA"):
        getattr(kernels, name)(t, t, t > 0, dt=86400.0, max_iter=60,
                               max_tries=5)


def test_runoff_wrapper_refuses_cpu_tensors():
    lay, lane = torch.zeros(4, 3), torch.zeros(4)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.runoff_hourly(lay, lay, lay, lay, lay, lay, lay, lane, lane,
                              lane, lane, lane, lane, 24)


def test_cpu_step_takes_the_plain_versions():
    gp, params, stack, state, _ = build_light(2, 1, "cpu")
    kernels.reset_launches()
    make_step(params, gp)(state, {k: v[0] for k, v in stack.items()})
    assert kernels.launches == dict.fromkeys(kernels.launches, 0)


def test_cpu_frozen_step_takes_the_plain_versions():
    gp, params, stack, state, extras = build_frozen(2, 1, "cpu")
    geom = extras["geom"]
    kernels.reset_launches()
    make_step(params, gp, geom=geom)(state,
                                     {k: v[0] for k, v in stack.items()})
    assert kernels.launches == dict.fromkeys(kernels.launches, 0)


def test_new_wrappers_refuse_cpu_tensors():
    t = torch.zeros(2, 4)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.surface_brent(t, t, t > 0, max_iter=60, eb_kwargs={})
    gp, _, _, state, extras = build_frozen(2, 1, "cpu")
    geom = extras["geom"]
    nodes = state.node_temp
    with pytest.raises(ValueError, match="CUDA"):
        kernels.node_sweep(nodes, nodes[..., 0], nodes, nodes, nodes, nodes,
                           geom, torch.ones(2, dtype=torch.bool), nlayer=3,
                           dt_sec=86400.0, noflux=False, frozen=True,
                           max_sweeps=10)


def test_slice_three_wrappers_refuse_cpu_tensors():
    t = torch.zeros(2, 4)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.fd_surface_brent(t, t, t > 0, max_iter=60,
                                 eb_kwargs={"fd_solve": lambda ts: None})
    with pytest.raises(ValueError, match="CUDA"):
        kernels.blowing_snow(dt_sec=86400.0, quad_nodes=t[0], log_terms=t[0],
                             tair=t)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.canopy_air_step(it=0, tc=t)


def test_affine_surface_brent_refuses_cpu_tensors():
    t = torch.zeros(2, 4)
    nodes = torch.zeros(2, 4, 5)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.affine_surface_brent(
            t, t, t > 0, max_iter=60,
            eb_kwargs={"fd_interp": (t, nodes, t, nodes)})
    with pytest.raises(ValueError, match="affine two-probe residual only"):
        kernels.affine_surface_brent(t, t, t > 0, max_iter=60, eb_kwargs={})


def test_lane_inputs_are_strided_views_of_the_inputs():
    """Each input goes to a kernel as its own storage with the strides
    csrc/lanes.cuh reads it by: element cell*s0 + hru*s1 (+ l*s2) from the
    data pointer holds lane (cell, hru)'s value, for lane, per-cell,
    scalar, layered, sliced and mask inputs, and nothing is copied."""
    c, h, nl = 3, 4, 2
    rng = np.random.default_rng(0)
    lanes = torch.tensor(rng.normal(size=(c, h)), dtype=torch.float32)
    cell = torch.tensor(rng.normal(size=(c, 1)), dtype=torch.float32)
    layered = torch.tensor(rng.normal(size=(c, 1, nl)), dtype=torch.float32)
    sliced = torch.tensor(rng.normal(size=(c, h, 3)),
                          dtype=torch.float32)[..., 1]
    items = [("lanes", lanes, torch.float32, 0),
             ("cell", cell, torch.float32, 0),
             ("scalar", torch.tensor(2.5), torch.float32, 0),
             ("layered", layered, torch.float32, nl),
             ("sliced", sliced, torch.float32, 0),
             ("mask", cell > 0, torch.bool, 0)]
    views, ptrs, strides = kernels._lane_inputs(items, (c, h),
                                                torch.device("cpu"))
    assert list(ptrs) == [v.data_ptr() for v in views]
    for k, ((name, x, _, n_l), view) in enumerate(zip(items, views)):
        s0, s1, s2 = strides[3 * k:3 * k + 3]
        assert view.untyped_storage().data_ptr() == \
            x.untyped_storage().data_ptr(), name          # not copied
        full = x.expand((c, h) + ((n_l,) if n_l else ()))
        for ci in range(c):
            for hi in range(h):
                for li in range(max(n_l, 1)):
                    off = ci * s0 + hi * s1 + li * s2
                    got = torch.as_strided(
                        view, (1,), (1,), view.storage_offset() + off)
                    want = full[ci, hi, li] if n_l else full[ci, hi]
                    assert torch.equal(got[0], want), (name, ci, hi, li)


def test_make_step_refuses_node_counts_the_sweep_kernel_lacks():
    """On CUDA tensors a node count K6 does not run, above the reference's
    MAX_NODES = 50, is refused by name when the step is built."""
    gp = frozen_params(1).replace(nnode=51)
    _, params, _, _, _ = build_frozen(1, 1, "cpu")
    on_card = SimpleNamespace(alpha=SimpleNamespace(is_cuda=True))
    with pytest.raises(NotImplementedError, match="nnode=51"):
        make_step(params, gp, geom=on_card)


def test_surface_inputs_are_the_kernels_rows():
    """surface_inputs gathers one tensor for each of the kernel's inputs
    (as many as csrc/surface_brent.cuh's enums count) from the keyword
    arguments the light step hands the surface Brent."""
    captured = []
    orig = surface.surface_brent_plain
    surface.surface_brent_plain = lambda *a, **k: (captured.append(k),
                                                   orig(*a, **k))[1]
    try:
        gp, params, stack, state, _ = build_light(2, 1, "cpu")
        make_step(params, gp)(state, {k: v[0] for k, v in stack.items()})
    finally:
        surface.surface_brent_plain = orig
    named = kernels.surface_inputs(captured[0]["eb_kwargs"])
    names = (kernels.SURFACE_INPUTS + kernels.SURFACE_LAYER_INPUTS
             + kernels.SURFACE_MASKS)
    assert sorted(named) == sorted(set(names) - {"active"})
    lanes = state.swq.shape
    for k in kernels.SURFACE_INPUTS:
        assert named[k].dtype == torch.float32 and \
            torch.broadcast_shapes(named[k].shape, lanes) == lanes, k
    header = (build.CSRC / "surface_brent.cuh").read_text()
    for enum, group in (("In", kernels.SURFACE_INPUTS),
                        ("LayerIn", kernels.SURFACE_LAYER_INPUTS),
                        ("Mask", kernels.SURFACE_MASKS)):
        body = re.search(r"enum %s \{([^}]*)\}" % enum, header).group(1)
        rows = [w.strip() for w in body.split(",") if w.strip()]
        assert rows[-1].startswith("kNum") and len(rows) - 1 == len(group)


def test_dry_surface_inputs_are_the_kernels_rows():
    """With DIST_PRCP surface_inputs adds one tensor for each of the dry
    column's inputs (as many as csrc/surface_brent.cuh's DryIn and
    DryLayerIn count), from the dist_prcp step's surface Brent."""
    captured = []
    orig = surface.surface_brent_plain
    surface.surface_brent_plain = lambda *a, **k: (captured.append(k),
                                                   orig(*a, **k))[1]
    try:
        gp, params, stack, state, extras = CONFIGS["dist_prcp"](2, 1, "cpu")
        make_step(params, gp, **extras)(state,
                                        {k: v[0] for k, v in stack.items()})
    finally:
        surface.surface_brent_plain = orig
    named = kernels.surface_inputs(captured[0]["eb_kwargs"])
    names = (kernels.SURFACE_INPUTS + kernels.SURFACE_LAYER_INPUTS
             + kernels.SURFACE_MASKS + kernels.DRY_INPUTS
             + kernels.DRY_LAYER_INPUTS + kernels.DRY_MASKS)
    assert sorted(named) == sorted(set(names) - {"active"})
    nl = named["root"].shape[-1]
    for k in kernels.DRY_LAYER_INPUTS:
        assert named[k].shape[-1] == nl, k
    header = (build.CSRC / "surface_brent.cuh").read_text()
    for enum, group in (("DryIn", kernels.DRY_INPUTS),
                        ("DryLayerIn", kernels.DRY_LAYER_INPUTS)):
        body = re.search(r"enum %s \{([^}]*)\}" % enum, header).group(1)
        rows = [w.strip() for w in body.split(",") if w.strip()]
        assert rows[-1].startswith("kNum") and len(rows) - 1 == len(group)


def test_fusion_inputs_are_the_kernels_rows():
    """FROZEN_SOIL on QUICK_FLUX hands K5 the fusion inputs
    (kernels.FD_SURFACE_INPUTS, as many as csrc/surface_brent.cuh's FdIn
    counts) and the frozen-soil mask, on the frozen_quick step's lanes."""
    captured = []
    orig = surface.surface_brent_plain
    surface.surface_brent_plain = lambda *a, **k: (captured.append(k),
                                                   orig(*a, **k))[1]
    try:
        gp, params, stack, state, extras = CONFIGS["frozen_quick"](2, 1,
                                                                   "cpu")
        make_step(params, gp, **extras)(state,
                                        {k: v[0] for k, v in stack.items()})
    finally:
        surface.surface_brent_plain = orig
    eb = captured[0]["eb_kwargs"]
    assert eb["frozen_soil"] and eb.get("fd_solve") is None
    lanes = state.swq.shape
    for k in kernels.FD_SURFACE_INPUTS:
        assert eb[k].dtype == torch.float32 and \
            torch.broadcast_shapes(eb[k].shape, lanes) == lanes, k
    assert eb["fs_active"].dtype == torch.bool
    header = (build.CSRC / "surface_brent.cuh").read_text()
    body = re.search(r"enum FdIn \{([^}]*)\}", header).group(1)
    rows = [w.strip() for w in body.split(",") if w.strip()]
    assert rows[-1].startswith("kNum") and \
        len(rows) - 1 == len(kernels.FD_SURFACE_INPUTS)


def _captured_args(device, n_cell=64, names=tuple(PLAIN)[:5],
                   config="light", record=0, build=None):
    """The first call of each kernel in `names` in the step of record
    `record` of `config` (or of build(n_cell, n_rec, device)'s
    configuration) on `device`."""
    captured = {}
    originals = {name: getattr(kernels, name) for name in names}

    def wrap(name, fn):
        def wrapper(*args, **kwargs):
            captured.setdefault(name, (args, kwargs))
            return fn(*args, **kwargs)
        return wrapper

    gp, params, stack, state, extras = (build or CONFIGS[config])(
        n_cell, record + 1, device)
    step = make_step(params, gp, **extras)
    for r in range(record):
        state, _ = step(state, {k: v[r] for k, v in stack.items()})
    for name, fn in originals.items():
        setattr(kernels, name, wrap(name, fn))
    try:
        step(state, {k: v[record] for k, v in stack.items()})
    finally:
        for name, fn in originals.items():
            setattr(kernels, name, fn)
    return captured


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["glacier_brent", "snowpack_brent",
                                  "canopy_brent", "surface_brent"])
def test_brent_kernel_matches_plain(cuda, name):
    a, kw = _captured_args(cuda)[name]
    before = kernels.launches[name]
    got = getattr(kernels, name)(*a, **kw)
    ref = PLAIN[name](*a, **kw)
    torch.cuda.synchronize()
    assert kernels.launches[name] == before + 1
    assert torch.equal(got.bracketed, ref.bracketed)
    assert torch.equal(got.converged, ref.converged)
    both = got.converged & ref.converged
    # each run stops inside its final bracket, |c - b| <= 2*tol_i
    tol = 2.0 * (2.0 * torch.finfo(torch.float32).eps * got.root.abs() + 1e-4)
    assert bool(((got.root - ref.root).abs() <= tol)[both].all())
    assert torch.equal(got.root[~got.bracketed], ref.root[~ref.bracketed])


@pytest.mark.gpu
def test_runoff_kernel_matches_plain(cuda):
    a, kw = _captured_args(cuda)["runoff_hourly"]
    got = kernels.runoff_hourly(*a, **kw)
    ref = runoff_hourly_plain(*a, **kw)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_node_sweep_kernel_matches_plain(cuda):
    """K6 on the frozen step's first sweep of its third record (frozen
    nodes, fallbacks): the same sweep count, fallback counts and node
    temperatures within 1e-4 C."""
    a, kw = _captured_args(cuda, names=("node_sweep",), config="frozen",
                           record=2)["node_sweep"]
    before = kernels.launches["node_sweep"]
    got = kernels.node_sweep(*a, **kw)
    ref = solve_t_profile_explicit_plain(*a, **kw)
    torch.cuda.synchronize()
    assert kernels.launches["node_sweep"] == before + 1
    assert int(got.iterations) == ref.iterations
    assert torch.equal(got.fbcount, ref.fbcount)
    assert float((got.temp - ref.temp).abs().max()) <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("nnode", [3, 10, 50])
def test_exp_trans_node_sweep_kernel_matches_plain(cuda, nnode):
    """K6 on EXP_TRANS nodes at 3, 10 (the frozen_exp configuration's
    count) and 50 nodes, on the first sweep call of the frozen_exp step's
    third record with its node count replaced: the same sweep count,
    fallback counts and node temperatures within 1e-4 C."""
    def build_nodes(n_cell, n_rec, device):
        gp = frozen_exp_params(n_rec).replace(nnode=nnode)
        return entry._build(gp, n_cell, n_rec, device)

    a, kw = _captured_args(cuda, names=("node_sweep",), record=2,
                           build=build_nodes)["node_sweep"]
    assert kw["exp_trans"] and a[0].shape[-1] == nnode
    before = kernels.launches["node_sweep"]
    got = kernels.node_sweep(*a, **kw)
    ref = solve_t_profile_explicit_plain(*a, **kw)
    torch.cuda.synchronize()
    assert kernels.launches["node_sweep"] == before + 1
    assert int(got.iterations) == ref.iterations
    assert torch.equal(got.fbcount, ref.fbcount)
    assert float((got.temp - ref.temp).abs().max()) <= 1e-4


@pytest.mark.gpu
def test_surface_brent_kernel_with_fusion_matches_plain(cuda):
    """K5 with FROZEN_SOIL's fusion term, on the frozen_quick step's second
    record (top-layer ice on some lanes): the same flags, roots within the
    final bracket width."""
    a, kw = _captured_args(cuda, names=("surface_brent",),
                           config="frozen_quick", record=1)["surface_brent"]
    eb = kw["eb_kwargs"]
    assert eb["frozen_soil"] and bool((eb["ice0_vol"] > 0).any())
    before = kernels.launches["surface_brent"]
    got = kernels.surface_brent(*a, **kw)
    ref = surface_brent_plain(*a, **kw)
    torch.cuda.synchronize()
    assert kernels.launches["surface_brent"] == before + 1
    assert torch.equal(got.bracketed, ref.bracketed)
    assert torch.equal(got.converged, ref.converged)
    both = got.converged & ref.converged
    tol = 2.0 * (2.0 * torch.finfo(torch.float32).eps * got.root.abs() + 1e-4)
    assert bool(((got.root - ref.root).abs() <= tol)[both].all())
    assert torch.equal(got.root[~got.bracketed], ref.root[~ref.bracketed])


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["glacier_brent", "runoff_hourly"])
def test_cell_inputs_match_their_lane_copies(cuda, name):
    """Every input but the first (which keeps the lanes' shape) made the
    same on the HRUs of a cell: passed as [c, 1] (one row per cell) it
    gives the kernel's result for the same values copied out to every
    lane."""
    a, kw = _captured_args(cuda)[name]

    def cells(x, copy):
        if not isinstance(x, torch.Tensor) or x.dtype != torch.float32 \
                or x.dim() < 2:
            return x
        one = x.narrow(1, 0, 1)
        return one.expand(x.shape).contiguous() if copy else one

    fn = getattr(kernels, name)
    got = fn(a[0], *[cells(x, False) for x in a[1:]],
             **{k: cells(v, False) for k, v in kw.items()})
    ref = fn(a[0], *[cells(x, True) for x in a[1:]],
             **{k: cells(v, True) for k, v in kw.items()})
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


@pytest.mark.gpu
def test_node_sweep_refuses_node_counts_it_lacks(cuda):
    t = torch.zeros(2, 4, 51, device=cuda)
    with pytest.raises(ValueError, match="nnode=51"):
        kernels.node_sweep(t, t[..., 0], t, t, t, t, None,
                           torch.ones(2, dtype=torch.bool, device=cuda),
                           nlayer=3, dt_sec=86400.0, noflux=False,
                           frozen=True, max_sweeps=10)


@pytest.mark.gpu
def test_kernel_wrapper_checks_its_inputs(cuda):
    t = torch.zeros(8, device=cuda)
    inputs = dict.fromkeys(kernels.GLACIER_INPUTS, t)
    with pytest.raises(TypeError, match="dtype"):      # float active mask
        kernels.glacier_brent(t, t, t, dt=86400.0, max_iter=60, max_tries=1,
                              **inputs)
    with pytest.raises(TypeError, match="missing inputs"):
        kernels.glacier_brent(t, t, t > 0, dt=86400.0, max_iter=60,
                              max_tries=1)
    with pytest.raises(ValueError, match="on cpu"):
        kernels.glacier_brent(t, t, t > 0, dt=86400.0, max_iter=60,
                              max_tries=1, **dict(inputs, ra=torch.zeros(8)))


@pytest.mark.gpu
@pytest.mark.parametrize("name,config,record", [
    ("snowpack_brent", "blowing_close", 3),
    ("fd_surface_brent", "frozen", 2)])
def test_slice_three_brent_kernels_match_plain(cuda, name, config, record):
    """K2 with a nonzero blowing flux in its residual, and K7 on the frozen
    step's third record: the same flags, roots within the final bracket
    width."""
    a, kw = _captured_args(cuda, names=(name,), config=config,
                           record=record)[name]
    if name == "snowpack_brent":
        assert bool((kw["blowing_flux"] != 0).any())
    before = kernels.launches[name]
    got = getattr(kernels, name)(*a, **kw)
    ref = PLAIN[name](*a, **kw)
    torch.cuda.synchronize()
    assert kernels.launches[name] == before + 1
    assert torch.equal(got.bracketed, ref.bracketed)
    assert torch.equal(got.converged, ref.converged)
    both = got.converged & ref.converged
    tol = 2.0 * (2.0 * torch.finfo(torch.float32).eps * got.root.abs() + 1e-4)
    assert bool(((got.root - ref.root).abs() <= tol)[both].all())
    assert torch.equal(got.root[~got.bracketed], ref.root[~ref.bracketed])


@pytest.mark.gpu
@pytest.mark.parametrize("name,config,record", [
    ("surface_brent", "dist_prcp", 1),
    ("fd_surface_brent", "heavy_nolakes", 3),
    ("affine_surface_brent", "heavy_nolakes", 3)])
def test_dry_lane_and_affine_brent_kernels_match_plain(cuda, name, config,
                                                       record):
    """K5 and K7 with DIST_PRCP's dry column in their residual, and K14 on
    the affine two-probe residual of a CLOSE_ENERGY pass: the same flags,
    roots within the final bracket width, on lanes raining on a wet
    fraction mu < 1."""
    a, kw = _captured_args(cuda, names=(name,), config=config,
                           record=record)[name]
    eb = kw["eb_kwargs"]
    assert eb["dist_dry"] is not None and bool((eb["mu_wet"] < 1.0).any())
    affine = name == "affine_surface_brent"
    assert (eb.get("fd_interp") is not None) == affine
    before = kernels.launches[name]
    got = getattr(kernels, name)(*a, **kw)
    ref = PLAIN[name](*a, **kw)
    torch.cuda.synchronize()
    assert kernels.launches[name] == before + 1
    assert bool(got.bracketed.any())
    assert torch.equal(got.bracketed, ref.bracketed)
    assert torch.equal(got.converged, ref.converged)
    both = got.converged & ref.converged
    tol = 2.0 * (2.0 * torch.finfo(torch.float32).eps * got.root.abs() + 1e-4)
    assert bool(((got.root - ref.root).abs() <= tol)[both].all())
    assert torch.equal(got.root[~got.bracketed], ref.root[~ref.bracketed])


@pytest.mark.gpu
def test_blowing_snow_kernel_matches_plain(cuda):
    """K8 on the blowing_close step's fourth record: flux and transport at
    rtol 1e-4, atol 1e-9, with snow blowing on some lanes."""
    a, kw = _captured_args(cuda, names=("blowing_snow",),
                           config="blowing_close", record=3)["blowing_snow"]
    got = kernels.blowing_snow(*a, **kw)
    ref = calc_blowing_snow_plain(*a, **kw)
    torch.cuda.synchronize()
    assert int((ref[0] != 0).sum()) > 0
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(),
                                   rtol=1e-4, atol=1e-9)


@pytest.mark.gpu
def test_canopy_air_step_kernel_matches_plain(cuda):
    """K9 on a pass of the blowing_close step's fourth record: tc_next and g
    within 1e-5 C, the same batch maximum and stop decision."""
    a, kw = _captured_args(cuda, names=("canopy_air_step",),
                           config="blowing_close",
                           record=3)["canopy_air_step"]
    got = kernels.canopy_air_step(*a, **kw)
    ref = canopy_air_step_plain(*a, **kw)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(),
                                   rtol=0.0, atol=1e-5)
    assert (float(got[2]) <= OVER_TOL_F32) == (float(ref[2]) <= OVER_TOL_F32)


LAKE_KERNELS = ("lake_open_water", "lake_under_ice", "lake_ice_brent",
                "lake_depth")
# the lake fixed points stop a lake at |change| <= 1e-4 (C, W/m^2): two runs
# stopping one iteration apart may differ by about that much
LAKE_FIXED_POINT_TOL = 2e-4


def test_lake_wrappers_refuse_cpu_tensors():
    from vic_tpu_torch.physics.lake import make_grid
    from vic_tpu_torch.entry import build_lakes
    _, _, _, state, extras = build_lakes(2, 1, "cpu")
    lp = extras["lake_params"]
    t, c = state.lake_temp, state.lake_volume
    grid = make_grid(lp, torch.full_like(c, 5.0))
    with pytest.raises(ValueError, match="CUDA"):
        kernels.lake_depth(lp.z, lp.basin, lp.maxdepth, c)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.lake_ice_brent(c, c, c > 0, dt=86400.0, max_iter=30,
                               max_tries=5,
                               **dict.fromkeys(kernels.ICE_EB_INPUTS, c))
    for name, keys in (("lake_open_water", kernels.OPEN_WATER_INPUTS[2:]),
                       ("lake_under_ice", kernels.UNDER_ICE_INPUTS[2:]
                        + kernels.UNDER_ICE_UNUSED)):
        with pytest.raises(ValueError, match="CUDA"):
            getattr(kernels, name)(temp=t, grid=grid, dt_sec=86400.0,
                                   active=c > 0, **dict.fromkeys(keys, c))


def _lake_args(device, n_cell=64):
    """The lake kernels' first calls in the lakes step's second record,
    where open, partly and fully iced lakes coexist."""
    return _captured_args(device, n_cell, names=LAKE_KERNELS, config="lakes",
                          record=1)


@pytest.mark.gpu
def test_lake_open_water_kernel_matches_plain(cuda):
    """K10: the same converged flags; on converged lakes the column within
    the fixed point's reach and the fluxes within 1e-2 W/m^2."""
    a, kw = _lake_args(cuda)["lake_open_water"]
    assert bool(kw["active"].any())
    before = kernels.launches["lake_open_water"]
    got, t_open = kernels.lake_open_water(**kw)
    ref, t_open_ref = lake_open_water_plain(**kw)
    torch.cuda.synchronize()
    assert kernels.launches["lake_open_water"] == before + 1
    assert torch.equal(got.converged, ref.converged)
    ok = got.converged
    assert float((got.temp - ref.temp).abs()[ok].max()) \
        <= LAKE_FIXED_POINT_TOL
    assert float((t_open - t_open_ref).abs().max()) <= LAKE_FIXED_POINT_TOL
    for k in ("qh", "qle", "lwnet"):
        assert float((getattr(got, k) - getattr(ref, k)).abs().max()) \
            <= 1e-2, k


@pytest.mark.gpu
def test_lake_under_ice_kernel_matches_plain(cuda):
    """K11: the same converged flags, the column and qw within the fixed
    point's reach."""
    a, kw = _lake_args(cuda)["lake_under_ice"]
    assert bool(kw["active"].any())
    got = kernels.lake_under_ice(**kw)
    ref = water_under_ice_plain(**kw)
    torch.cuda.synchronize()
    assert torch.equal(got.converged, ref.converged)
    assert float((got.temp - ref.temp).abs().max()) <= LAKE_FIXED_POINT_TOL
    assert float((got.qw - ref.qw).abs().max()) <= LAKE_FIXED_POINT_TOL


@pytest.mark.gpu
def test_lake_ice_brent_kernel_matches_plain(cuda):
    """K12: the same flags, roots within the final bracket width."""
    a, kw = _lake_args(cuda)["lake_ice_brent"]
    got = kernels.lake_ice_brent(*a, **kw)
    ref = lake_ice_brent_plain(*a, **kw)
    torch.cuda.synchronize()
    assert bool(ref.bracketed.any())
    assert torch.equal(got.bracketed, ref.bracketed)
    assert torch.equal(got.converged, ref.converged)
    both = got.converged & ref.converged
    tol = 2.0 * (2.0 * torch.finfo(torch.float32).eps * got.root.abs() + 1e-4)
    assert bool(((got.root - ref.root).abs() <= tol)[both].all())


@pytest.mark.gpu
def test_lake_depth_kernel_matches_plain(cuda):
    """K13: the bisection's depths bit for bit."""
    a, kw = _lake_args(cuda)["lake_depth"]
    z, basin, maxdepth, volume = a
    got = kernels.lake_depth(*a)
    ref = depth_from_volume_plain(
        SimpleNamespace(z=z, basin=basin, maxdepth=maxdepth), volume)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


def test_ice_residual_fields_are_the_kernels_inputs():
    """csrc/lake_ice_brent.cu's IceResidual reads dt, then
    kernels.ICE_EB_INPUTS in that order (the blowing-snow flux last), and
    its launcher expects as many float inputs."""
    src = (build.CSRC / "lake_ice_brent.cu").read_text()
    body = re.search(r"struct IceResidual \{\s*float([^;]*);", src).group(1)
    fields = [w.strip() for w in body.split(",")]
    assert fields == ["dt"] + list(kernels.ICE_EB_INPUTS)
    assert kernels.ICE_EB_INPUTS[-1] == "blowing_flux"
    launch = re.search(r"launch_brent\(lake_ice_brent_kernel, f, f_stride, "
                       r"nf, (\d+),", src)
    assert int(launch.group(1)) == len(kernels.ICE_EB_INPUTS)


def _heavy_lake_args(device, n_cell=64, record=6):
    """K12's call and K8's call on the lake lanes (its second in a step) in
    the heavy step's seventh record, where lakes carry snow that blows."""
    calls = {"lake_ice_brent": [], "blowing_snow": []}
    originals = {name: getattr(kernels, name) for name in calls}

    def wrap(name, fn):
        def wrapper(*args, **kwargs):
            calls[name].append((args, kwargs))
            return fn(*args, **kwargs)
        return wrapper

    gp, params, stack, state, extras = CONFIGS["heavy"](n_cell, record + 1,
                                                        device)
    step = make_step(params, gp, **extras)
    for r in range(record):
        state, _ = step(state, {k: v[r] for k, v in stack.items()})
    for name, fn in originals.items():
        setattr(kernels, name, wrap(name, fn))
    try:
        step(state, {k: v[record] for k, v in stack.items()})
    finally:
        for name, fn in originals.items():
            setattr(kernels, name, fn)
    return calls["lake_ice_brent"][0], calls["blowing_snow"][1]


@pytest.mark.gpu
def test_lake_ice_brent_kernel_matches_plain_with_blowing_flux(cuda):
    """K12 on the heavy step's lakes, some of them bracketed under a
    blowing-snow flux: the same flags, roots within the final bracket
    width."""
    (a, kw), _ = _heavy_lake_args(cuda)
    got = kernels.lake_ice_brent(*a, **kw)
    ref = lake_ice_brent_plain(*a, **kw)
    torch.cuda.synchronize()
    blown = kw["blowing_flux"].expand(ref.root.shape) != 0.0
    assert bool((blown & ref.bracketed).any())
    assert torch.equal(got.bracketed, ref.bracketed)
    assert torch.equal(got.converged, ref.converged)
    both = got.converged & ref.converged
    tol = 2.0 * (2.0 * torch.finfo(torch.float32).eps * got.root.abs() + 1e-4)
    assert bool(((got.root - ref.root).abs() <= tol)[both].all())


@pytest.mark.gpu
def test_blowing_snow_kernel_matches_plain_on_lake_lanes(cuda):
    """K8 on the heavy step's [n_cell] lake lanes with the frozen-pond
    scalars broadcast: flux and transport within rtol 1e-4, atol 1e-9
    kg/m^2/s, and some snow-covered lake blows."""
    _, (a, kw) = _heavy_lake_args(cuda)
    assert kw["tair"].dim() == 1 and kw["lag_one"].dim() == 0
    before = kernels.launches["blowing_snow"]
    got = kernels.blowing_snow(*a, **kw)
    ref = calc_blowing_snow_plain(*a, **kw)
    torch.cuda.synchronize()
    assert kernels.launches["blowing_snow"] == before + 1
    for g, r in zip(got, ref):
        assert g.shape == kw["tair"].shape
        assert bool(((g - r).abs() <= 1e-9 + 1e-4 * r.abs()).all())
    assert bool(((kw["snowdepth"] > 0.0) & (ref[0] != 0.0)).any())


def test_loop_wrappers_refuse_cpu_tensors():
    """K15-K17 take CUDA tensors only; on the CPU their call sites take the
    plain versions."""
    t = torch.zeros(2, 4)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.mass_release(t, t)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.bisection("glacier", t, t, t > 0, 40, dt=86400.0)
    _, _, _, state, extras = build_frozen(2, 1, "cpu")
    nodes = state.node_temp
    with pytest.raises(ValueError, match="CUDA"):
        kernels.implicit_profile(nodes, nodes[..., 0], nodes, nodes, nodes,
                                 nodes, extras["geom"],
                                 torch.ones(2, dtype=torch.bool),
                                 dt_sec=86400.0, noflux=False, frozen=True)


def test_snowpack_residual_fields_are_the_kernels_inputs():
    """csrc/pack_residuals.cuh's SnowpackResidual reads dt, then
    kernels.SNOWPACK_INPUTS in that order (SPATIAL_SNOW's coverage last)
    and its flag, and the launchers of K2 and K17 expect as many float
    inputs and masks; GlacierResidual reads GLACIER_INPUTS."""
    src = (build.CSRC / "pack_residuals.cuh").read_text()
    body = re.search(r"struct SnowpackResidual \{\s*float([^;]*);\s*bool "
                     r"(\w+);", src)
    assert [w.strip() for w in body.group(1).split(",")] == \
        ["dt"] + list(kernels.SNOWPACK_INPUTS)
    assert (body.group(2),) == kernels.SNOWPACK_FLAGS
    glac = re.search(r"struct GlacierResidual \{\s*float([^;]*);", src)
    assert [w.strip() for w in glac.group(1).split(",")] == \
        ["dt"] + list(kernels.GLACIER_INPUTS)
    k2 = (build.CSRC / "vic_kernels.cu").read_text()
    launch = re.search(r"launch_brent\(snowpack_brent_kernel, f, f_stride, "
                       r"nf, (\d+), m, m_stride,\s*nm, (\d+),", k2)
    assert (int(launch.group(1)), int(launch.group(2))) == \
        (len(kernels.SNOWPACK_INPUTS), 1 + len(kernels.SNOWPACK_FLAGS))
    k17 = (build.CSRC / "bisection.cu").read_text()
    counts = re.search(r"nf, snow \? (\d+) : (\d+), m, m_stride,\s*nm, "
                       r"snow \? (\d+) : (\d+)", k17)
    assert tuple(int(g) for g in counts.groups()) == (
        len(kernels.SNOWPACK_INPUTS), len(kernels.GLACIER_INPUTS), 2, 1)


def test_implicit_geometry_is_the_kernels_rows():
    """kernels.IMPLICIT_GEOMETRY is the order of csrc/implicit_profile.cu's
    geometry pointers, and every name is a NodeGeometry field."""
    src = (build.CSRC / "implicit_profile.cu").read_text()
    args = re.search(r"const float\* alpha;(.*?)const float\* surf_temp;",
                     src, re.S).group(1)
    names = ["alpha"] + re.findall(r"const float\* (\w+);", args)
    assert len(names) == len(kernels.IMPLICIT_GEOMETRY)
    from vic_tpu_torch.physics.frozen_soil import NodeGeometry
    fields = set(NodeGeometry.__dataclass_fields__)
    assert set(kernels.IMPLICIT_GEOMETRY) <= fields


@pytest.mark.gpu
def test_mass_release_kernel_matches_plain(cuda):
    """K15 on seeded canopy snow and melt storage (both branches, the
    MIN_INTERCEPTION_STORAGE gate) within 1e-5."""
    from vic_tpu_torch.physics.canopy_snow import mass_release_plain
    rng = np.random.default_rng(3)
    int_snow = torch.tensor(rng.uniform(0.0, 0.03, (64, 5)),
                            dtype=torch.float32, device=cuda)
    storage = int_snow * torch.tensor(rng.uniform(0.0, 0.3, (64, 5)),
                                      dtype=torch.float32, device=cuda)
    before = kernels.launches["mass_release"]
    got = kernels.mass_release(int_snow, storage)
    ref = mass_release_plain(int_snow, storage)
    torch.cuda.synchronize()
    assert kernels.launches["mass_release"] == before + 1
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(),
                                   rtol=1e-5, atol=1e-5)
    assert bool((ref[2] > 0).any()) and bool((ref[3] > 0).any())


@pytest.mark.gpu
@pytest.mark.parametrize("residual,config,record", [
    ("snowpack", "light", 0), ("glacier", "light", 0),
    ("snowpack", "spatial_snow", 1)])
def test_bisection_kernel_matches_plain(cuda, residual, config, record):
    """K17 on K2's and K1's arguments in the light step (K2's also in the
    spatial_snow step, with the advected sensible heat), 40 steps: equal
    flags, roots within 1e-5."""
    from vic_tpu_torch.physics.bisection import bisection_plain
    name = {"snowpack": "snowpack_brent", "glacier": "glacier_brent"}[
        residual]
    a, kw = _captured_args(cuda, names=(name,), config=config,
                           record=record)[name]
    lo, hi, active = a
    inputs = {k: v for k, v in kw.items()
              if k not in ("dt", "max_iter", "max_tries")}
    before = kernels.launches["bisection"]
    got = kernels.bisection(residual, lo, hi, active, 40, dt=kw["dt"],
                            **inputs)
    ref = bisection_plain(residual, lo, hi, active, 40, dt=kw["dt"],
                          **inputs)
    torch.cuda.synchronize()
    assert kernels.launches["bisection"] == before + 1
    assert torch.equal(got.bracketed, ref.bracketed)
    assert bool(got.bracketed.any())
    assert float((got.root - ref.root).abs().max()) <= 1e-5


@pytest.mark.gpu
def test_snowpack_brent_kernel_with_coverage_matches_plain(cuda):
    """K2 on the spatial_snow step's second record, where packs cover part
    of their lanes: equal flags, roots within the final bracket width."""
    a, kw = _captured_args(cuda, names=("snowpack_brent",),
                           config="spatial_snow", record=1)["snowpack_brent"]
    cov = kw["snow_cover_fract"].expand(a[0].shape)
    assert bool(((cov > 0.0) & (cov < 1.0) & a[2]).any())
    got = kernels.snowpack_brent(*a, **kw)
    ref = snowpack_brent_plain(*a, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got.bracketed, ref.bracketed)
    assert torch.equal(got.converged, ref.converged)
    both = got.converged & ref.converged
    tol = 2.0 * (2.0 * torch.finfo(torch.float32).eps * got.root.abs() + 1e-4)
    assert bool(((got.root - ref.root).abs() <= tol)[both].all())


@pytest.mark.gpu
@pytest.mark.parametrize("config", ["frozen", "frozen_exp"])
@pytest.mark.parametrize("noflux", [False, True])
def test_implicit_profile_kernel_matches_plain(cuda, config, noflux):
    """K16 on K6's arguments in the third record of the frozen (5 nodes,
    the exact lane) and frozen_exp (10 EXP_TRANS nodes, the rolled lane)
    steps, NOFLUX both ways: temperatures within 1e-4 C, equal fallback
    counts."""
    from vic_tpu_torch.physics.frozen_soil import \
        solve_t_profile_implicit_plain
    a, kw = _captured_args(cuda, names=("node_sweep",), config=config,
                           record=2)["node_sweep"]
    args = dict(dt_sec=kw["dt_sec"], noflux=noflux, frozen=kw["frozen"])
    before = kernels.launches["implicit_profile"]
    got = kernels.implicit_profile(*a, **args)
    ref = solve_t_profile_implicit_plain(*a, **args)
    torch.cuda.synchronize()
    assert kernels.launches["implicit_profile"] == before + 1
    assert torch.equal(got.fbcount, ref.fbcount)
    assert float((got.temp - ref.temp).abs().max()) <= 1e-4
