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
import dataclasses
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
from vic_tpu_torch.physics.canopy_air import (canopy_air_final_plain,
                                              canopy_air_step_plain)
from vic_tpu_torch.physics.canopy_snow import canopy_brent_plain
from vic_tpu_torch.physics.frozen_soil import solve_t_profile_explicit_plain
from vic_tpu_torch.physics.glacier import glacier_brent_plain
from vic_tpu_torch.physics.lake import (depth_from_volume_plain,
                                        lake_ice_melt_plain,
                                        lake_open_water_plain,
                                        lake_water_balance_plain,
                                        water_under_ice_plain)
from vic_tpu_torch.physics.runoff import runoff_step_plain
from vic_tpu_torch.physics.snow import (snow_energy_terms,
                                        snowpack_brent_plain)
from vic_tpu_torch.physics.surface import (surface_brent_plain,
                                           surface_root_plain)
from vic_tpu_torch.testing import (TERMS_RTOL, ice_melt_at_roots,
                                   ice_melt_failures, ice_melt_inputs,
                                   terms_atol)

torch.set_num_threads(1)

PLAIN = {"glacier_brent": glacier_brent_plain,
         "snowpack_brent": snowpack_brent_plain,
         "canopy_brent": canopy_brent_plain,
         "runoff_hourly": runoff_step_plain,
         "surface_brent": surface_brent_plain,
         "node_sweep": solve_t_profile_explicit_plain,
         "fd_surface_brent": surface_root_plain,
         "blowing_snow": calc_blowing_snow_plain,
         "canopy_air_step": canopy_air_step_plain,
         "affine_surface_brent": surface_root_plain}


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
        kernels.runoff_hourly(lay, lay, lay, lane, lay, lay, lay, lay, lay,
                              lane, lane, lane, lane, lane, 24)


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
    with pytest.raises(ValueError, match="CUDA"):
        kernels.canopy_air_final(tair=t)


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
    floats = [("lanes", lanes, 0), ("cell", cell, 0),
              ("scalar", torch.tensor(2.5), 0), ("layered", layered, nl),
              ("sliced", sliced, 0)]
    masks = [("mask", cell > 0, 0)]
    table = kernels._lane_inputs(floats, masks, (c, h), torch.device("cpu"))
    assert table.dtype == np.int64 and table.shape == (4 * 6,)
    for (name, x, n_l), (ptr, s0, s1, s2) in zip(floats + masks,
                                                 table.reshape(-1, 4)):
        assert ptr == x.data_ptr(), name                  # not copied
        full = x.expand((c, h) + ((n_l,) if n_l else ()))
        for ci in range(c):
            for hi in range(h):
                for li in range(max(n_l, 1)):
                    off = int(ci * s0 + hi * s1 + li * s2)
                    got = torch.as_strided(x, (1,), (1,),
                                           x.storage_offset() + off)
                    want = full[ci, hi, li] if n_l else full[ci, hi]
                    assert torch.equal(got[0], want), (name, ci, hi, li)


def _stride_cases(c=3, h=4, nl=5):
    rng = np.random.default_rng(1)

    def f32(*shape):
        return torch.tensor(rng.normal(size=shape), dtype=torch.float32)
    return {"scalar": (f32(), 0), "cell": (f32(c, 1), 0),
            "lanes": (f32(c, h), 0), "layered": (f32(c, h, nl), nl),
            "layer0_slice": (f32(c, h, nl)[..., 0], 0),
            "transposed": (f32(h, c).t(), 0),
            "transposed_layered": (f32(c, nl, h).transpose(1, 2), nl)}


@pytest.mark.parametrize("case", list(_stride_cases()))
@pytest.mark.parametrize("one_cell", [False, True])
def test_lane_table_holds_broadcast_strides(case, one_cell):
    """_lane_inputs writes each input's data pointer and the strides of its
    broadcast to the lanes, x.expand(lanes).stride() with 0 on the axes it
    is broadcast over, worked out without a view; lanes [n] are one cell,
    whose cell stride is 0."""
    c, h = 3, 4
    x, nl = _stride_cases(c, h)[case]
    if one_cell:
        x = x[0] if x.dim() > 1 else x
        lanes = (h,)
    else:
        lanes = (c, h)
    target = lanes + ((nl,) if nl else ())
    table = kernels._lane_inputs([(case, x, nl)], [], lanes,
                                 torch.device("cpu"))
    want = list(x.expand(target).stride())
    if one_cell:
        want = [0] + want
    if not nl:
        want.append(0)
    assert table.tolist() == [x.data_ptr()] + want
    assert x.expand(target).data_ptr() == x.data_ptr()


def test_lane_table_refuses_what_does_not_broadcast():
    """A wrong device, a wrong dtype, a shape that does not broadcast to
    the lanes and a non-tensor raise, as the expand views did."""
    cpu = torch.device("cpu")
    x = torch.zeros(3, 4)
    with pytest.raises(ValueError, match="on meta"):
        kernels._lane_inputs([("x", torch.zeros(3, 4, device="meta"), 0)],
                             [], (3, 4), cpu)
    with pytest.raises(TypeError, match="dtype"):
        kernels._lane_inputs([("x", x.double(), 0)], [], (3, 4), cpu)
    with pytest.raises(TypeError, match="dtype"):
        kernels._lane_inputs([], [("m", x, 0)], (3, 4), cpu)
    for bad in (torch.zeros(2, 4), torch.zeros(3, 5), torch.zeros(2, 3, 4)):
        with pytest.raises(RuntimeError, match="does not broadcast"):
            kernels._lane_inputs([("x", bad, 0)], [], (3, 4), cpu)
    with pytest.raises(TypeError, match="expected a tensor"):
        kernels._lane_inputs([("x", 1.0, 0)], [], (3, 4), cpu)
    with pytest.raises(ValueError, match="lanes must be"):
        kernels._lane_inputs([("x", x, 0)], [], (1, 3, 4), cpu)


def test_root_outputs_are_slices_of_one_allocation():
    """K3's and K14's four outputs share one allocation, without overlap,
    each of the lanes' shape and its RootResult dtype."""
    outs = kernels._root_outputs((5, 3), torch.device("cpu"))
    assert [t.dtype for t in outs] == [torch.float32, torch.bool, torch.bool,
                                       torch.int32]
    assert all(t.shape == (5, 3) and t.is_contiguous() for t in outs)
    base = outs.root.untyped_storage().data_ptr()
    spans = sorted((t.data_ptr() - base, t.numel() * t.element_size())
                   for t in outs)
    assert all(t.untyped_storage().data_ptr() == base for t in outs)
    assert spans[0][0] == 0 and all(
        a + n <= b for (a, n), (b, _) in zip(spans, spans[1:]))


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
                   config="light", record=0, build=None, nth=0):
    """The first call (or call number `nth`, from 0) of each kernel in
    `names` in the step of record `record` of `config` (or of
    build(n_cell, n_rec, device)'s configuration) on `device`."""
    captured, seen = {}, {}
    originals = {name: getattr(kernels, name) for name in names}

    def wrap(name, fn):
        def wrapper(*args, **kwargs):
            if seen.get(name, 0) == nth:
                captured[name] = (args, kwargs)
            seen[name] = seen.get(name, 0) + 1
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
    """K4 against the plain runoff_step on the light step's arguments,
    every field of RunoffResult at 1e-5."""
    a, kw = _captured_args(cuda)["runoff_hourly"]
    ref = runoff_step_plain(*a, **kw)
    got = kernels.runoff_hourly(*a, **kw)
    torch.cuda.synchronize()
    assert got._fields == ref._fields
    for g, r in zip(got, ref):
        assert g.shape == r.shape
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
    for g, r in zip(_flat(got), _flat(ref)):
        assert torch.equal(g, r)


def _flat(result):
    """The tensors of a result whose fields may be named tuples, in
    order."""
    if isinstance(result, torch.Tensor):
        return [result]
    return [t for x in result for t in _flat(x)]


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


def _strained_lanes(a, kw, plain_fn, max_iter):
    """A captured K3 or K14 call rebuilt to strain csrc/lane_brent.cuh's
    compaction and refill: the first 128-lane tile with no active lane,
    the second with one, the rest as captured (a last partial tile where
    the lanes are not a multiple of 128); every third active lane's
    bracket narrowed to +/- 1e-4 C around the plain version's root, so it
    stops after its first two evaluations, and max_iter low enough that the
    slowest lanes reach it."""
    lo, hi, active = a
    shape = torch.broadcast_shapes(lo.shape, hi.shape, active.shape)
    act = active.expand(shape).clone().reshape(-1)
    act[:256] = False
    act[140] = True
    act = act.reshape(shape)
    root = plain_fn(lo, hi, act, **kw).root
    tight = act & (torch.arange(act.numel(), device=act.device)
                   .reshape(shape) % 3 == 0)
    lo = torch.where(tight, root - 1e-4, lo.expand(shape))
    hi = torch.where(tight, root + 1e-4, hi.expand(shape))
    return (lo, hi, act), dict(kw, max_iter=max_iter)


@pytest.mark.gpu
@pytest.mark.parametrize("name,config,record,max_iter", [
    ("canopy_brent", "light", 0, 4),
    ("surface_brent", "light", 0, 4),
    ("affine_surface_brent", "heavy_nolakes", 3, 8)])
def test_lane_brent_kernels_under_strain(cuda, name, config, record,
                                         max_iter):
    """K3, K5 and K14 (csrc/lane_brent.cuh) against their plain versions
    where whole tiles of lanes are inactive, one tile holds one active lane,
    the last tile is partial and the lanes' evaluations run from 2 to the
    max_iter cap: the same flags, roots within the final bracket width,
    the midpoints of unbracketed lanes, iterations 0 to max_iter."""
    a, kw = _captured_args(cuda, n_cell=70, names=(name,), config=config,
                           record=record)[name]
    a, kw = _strained_lanes(a, kw, PLAIN[name], max_iter)
    lanes = a[2].numel()
    assert lanes % 128 and not bool(a[2].reshape(-1)[:128].any())
    assert int(a[2].reshape(-1)[128:256].sum()) == 1
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
    its = got.iterations[got.bracketed]
    assert int(its.min()) == 0 and int(its.max()) == max_iter
    assert bool((got.iterations[~a[2]] == 0).all())


def _nan_build(config, cell=1, start=1):
    """`config`'s build function with CONTINUEONERROR and NaN air in
    one cell from record `start`."""
    def build_fn(n_cell, n_rec, device):
        gp, params, stack, state, extras = CONFIGS[config](n_cell, n_rec,
                                                           device)
        air = stack["air_temp"].clone()
        air[start:, cell] = float("nan")
        return (gp.replace(continue_on_error=True), params,
                dict(stack, air_temp=air), state, extras)
    return build_fn


@pytest.mark.gpu
@pytest.mark.parametrize("nan", [False, True])
def test_blowing_snow_kernel_matches_plain(cuda, nan):
    """K8 (compacted snow lanes, one thread a (lane, increment) item) on
    the blowing_close step's fourth record: flux and transport at rtol
    1e-4, atol 1e-9, with snow blowing on some lanes; with NaN air in one
    cell from that record, NaN on the same lanes as the plain version."""
    a, kw = _captured_args(cuda, names=("blowing_snow",),
                           config="blowing_close", record=3,
                           build=_nan_build("blowing_close", start=3)
                           if nan else None)["blowing_snow"]
    before = kernels.launches["blowing_snow"]
    got = kernels.blowing_snow(*a, **kw)
    ref = calc_blowing_snow_plain(*a, **kw)
    torch.cuda.synchronize()
    assert kernels.launches["blowing_snow"] == before + 1
    assert int((ref[0] != 0).sum()) > 0
    for g, r in zip(got, ref):
        assert torch.equal(torch.isnan(g), torch.isnan(r))
        assert bool(torch.isnan(r).any()) == nan
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


LAKE_KERNELS = ("lake_open_water", "lake_under_ice", "lake_ice_melt",
                "lake_depth", "lake_water_balance")
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
        kernels.lake_water_balance(lp, SimpleNamespace(volume=c), None)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.lake_ice_melt(dt_sec=86400.0, active=c > 0,
                              **dict.fromkeys(kernels.ICE_MELT_INPUTS[:-1],
                                              c))
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
    # on the card the kernel is the plain version bit for bit
    got, ref = got._asdict(), ref._asdict()
    got["t_open"], ref["t_open"] = t_open, t_open_ref
    del got["iterations"], ref["iterations"]
    assert _column_mismatch(got, ref) == []


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
    # on the card the kernel is the plain version bit for bit
    got, ref = got._asdict(), ref._asdict()
    del got["iterations"], ref["iterations"]
    assert _column_mismatch(got, ref) == []


def _strained_lake_cases(kw, lp, name, seed=16):
    """K10's or K11's captured keyword arguments `kw` (lake parameters
    `lp`) rebuilt to strain the one-warp-a-lake kernels: every lake
    inactive; one lake active; depths giving 1, 2, 19 and 20 active layers
    in turn on every lake; columns about 4 C, the density maximum, so
    pairs are unstable on both sides of it (on the captured lakes, and on
    none active: K10 still mixes, K11 still writes qw); NaN in the
    shortwave (K11) or the air temperature (K10) of every seventh lake and
    in one layer of every eleventh."""
    from vic_tpu_torch.physics.lake import make_grid
    active, temp = kw["active"], kw["temp"]
    n, device = active.shape[0], active.device
    rng = np.random.default_rng(seed)
    none = torch.zeros_like(active)
    one = none.clone()
    one[5] = True
    depth = torch.tensor([0.5, 0.9, 11.7, 15.0],
                         device=device).repeat(n // 4 + 1)[:n]
    near_4c = torch.tensor(4.0 + rng.normal(0.0, 0.6, temp.shape),
                           dtype=torch.float32, device=device)
    nan = float("nan")
    air = "tair" if name == "lake_open_water" else "sw_ice"
    x = kw[air].expand(active.shape).clone()
    x[3::7] = nan
    t_nan = temp.clone()
    t_nan[4::11, 2] = nan
    return {"all_inactive": dict(kw, active=none),
            "one_active": dict(kw, active=one),
            "layers_1_2_19_20": dict(kw, grid=make_grid(lp, depth),
                                     active=torch.ones_like(active)),
            "near_4c": dict(kw, temp=near_4c),
            "near_4c_inactive": dict(kw, temp=near_4c, active=none),
            "nan": dict(kw, temp=t_nan, **{air: x})}


# K10's iceform divides the supercooled layers' heat by RHO_W * LF as a
# product with the float's reciprocal (csrc/physics.cuh div_s), where
# PyTorch multiplies by the double's reciprocal rounded to float: the new
# ice's water equivalent may differ by an ulp or two (PERF.md section
# 6); every other output is bit for bit
NEW_ICE_WE_ULPS = 2


def _column_mismatch(got, ref):
    """The fields of K10's or K11's outputs (by field, _lake_column_outputs)
    that differ from the plain version's: not bit for bit, NaN where it is
    NaN, but new_ice_water_eq within NEW_ICE_WE_ULPS ulps."""
    bad = []
    for k, r in ref.items():
        g = got[k]
        if k == "new_ice_water_eq":
            ulp = np.spacing(np.abs(r.cpu().numpy())).astype(np.float64)
            diff = np.abs(g.cpu().numpy().astype(np.float64)
                          - r.cpu().numpy())
            ok = (diff <= NEW_ICE_WE_ULPS * ulp) | (
                np.isnan(g.cpu().numpy()) & np.isnan(r.cpu().numpy()))
            if not ok.all():
                bad.append(k)
        elif not _equal_nan(g, r):
            bad.append(k)
    return bad


def _lake_column_outputs(name, kw):
    """The kernel's and the plain version's outputs of K10 (with t_open)
    or K11 on kw, by field."""
    if name == "lake_open_water":
        got, t_open = kernels.lake_open_water(**kw)
        ref, t_open_ref = lake_open_water_plain(**kw)
        got, ref = (got._asdict(), ref._asdict())
        got["t_open"], ref["t_open"] = t_open, t_open_ref
    else:
        got = kernels.lake_under_ice(**kw)._asdict()
        ref = water_under_ice_plain(**kw)._asdict()
    torch.cuda.synchronize()
    return got, ref


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["all_inactive", "one_active",
                                  "layers_1_2_19_20", "near_4c",
                                  "near_4c_inactive", "nan"])
@pytest.mark.parametrize("name", ["lake_open_water", "lake_under_ice"])
def test_lake_column_kernels_under_strain(cuda, name, case):
    """K10 and K11 (one warp a lake on persistent blocks) against their
    plain versions on the lakes step's second record at 70 lakes (not a
    multiple of a block's 4 warps), rebuilt by _strained_lake_cases: every
    float output bit for bit (NaN where the plain version is NaN; K10's
    new_ice_water_eq within NEW_ICE_WE_ULPS, _column_mismatch), t_open
    on every lake (the mixed column where the lake is inactive), K11's qw
    on an inactive lake 0.57 (T0 - tcutoff) / (surfdz / 2), the converged
    flags, and the batch's trips the largest of the kernel's iterations, in
    one launch."""
    kw = _captured_args(cuda, 70, names=(name,), config="lakes",
                        record=1)[name][1]
    lp = CONFIGS["lakes"](70, 1, cuda)[4]["lake_params"]
    kw = _strained_lake_cases(kw, lp, name)[case]
    before = kernels.launches[name]
    got, ref = _lake_column_outputs(name, kw)
    assert kernels.launches[name] == before + 1
    assert torch.equal(got["converged"], ref["converged"])
    active = kw["active"]
    its = got.pop("iterations")
    assert bool((its[~active] == 0).all())
    assert ref.pop("iterations") == (int(its.max()) if bool(active.any())
                                     else 0)
    assert _column_mismatch(got, ref) == []
    if case == "nan":
        assert bool(torch.isnan(got["temp"]).any())
        assert not bool(got["converged"][active].all())


def _check_ice_melt(kw):
    """K12 against lake_ice_melt_plain on kw (testing.ice_melt_failures),
    one launch; returns the kernel's result."""
    before = kernels.launches["lake_ice_melt"]
    got = kernels.lake_ice_melt(**kw)
    ref = lake_ice_melt_plain(**kw)
    at_roots = ice_melt_at_roots(kw, got.solve)
    torch.cuda.synchronize()
    assert kernels.launches["lake_ice_melt"] == before + 1
    assert ice_melt_failures(got, ref, at_roots) == []
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["lakes", "seed", "nan_lakes"])
def test_lake_ice_brent_kernel_matches_plain(cuda, case):
    """K12, the whole of lake_ice_melt in one launch: the Brent's flags
    equal the plain version's and its roots within the final bracket, the
    other fields within testing.ice_melt_failures' rule of the plain
    version at the kernel's roots, NaN on the same lakes; on the lakes
    step's second record (with NaN air in one cell), and on the seed whose
    lakes reach every branch (tests/test_torch_ice_melt.py)."""
    if case == "seed":
        kw, _ = ice_melt_inputs(64, 15)
        kw = {k: torch.from_numpy(v).to(cuda) if isinstance(v, np.ndarray)
              else v for k, v in kw.items()}
    else:
        kw = _captured_args(cuda, names=("lake_ice_melt",), config="lakes",
                            record=1, build=_nan_build("lakes")
                            if case == "nan_lakes" else None)[
                                "lake_ice_melt"][1]
    got = _check_ice_melt(kw)
    assert bool(got.solve.bracketed.any())
    assert bool(torch.isnan(got.qnet).any()) == (case != "lakes")


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


def _equal_nan(got, ref):
    """Bit for bit, NaN where the other is NaN."""
    if got is None or ref is None:
        return got is None and ref is None
    return got.shape == ref.shape and bool(
        ((got == ref) | (torch.isnan(got) & torch.isnan(ref))).all())


def _lake_rows(obj, n, rows):
    """obj (a tensor, NamedTuple, dataclass or dict of them) with every
    tensor whose first axis has the n lakes cut to `rows`."""
    if isinstance(obj, torch.Tensor):
        return obj[rows] if obj.dim() and obj.shape[0] == n else obj
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: _lake_rows(getattr(obj, f.name), n, rows)
            for f in dataclasses.fields(obj)})
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*[_lake_rows(x, n, rows) for x in obj])
    if isinstance(obj, tuple):
        return tuple(_lake_rows(x, n, rows) for x in obj)
    if isinstance(obj, dict):
        return {k: _lake_rows(v, n, rows) for k, v in obj.items()}
    return obj


# the water balance under strain: one lake, a lake count that does not
# fill its last block, every lake inactive, NaN volumes, empty and
# brim-full lakes (beside open ones), HRU lanes outside the mask
BALANCE_STRAINS = ("as_captured", "one_lake", "ragged", "inactive",
                   "nan_volume", "empty_and_brim_full", "lanes_outside")


def _strained_balance(a, kw, strain):
    lp, st, res = a
    n = st.volume.shape[0]
    s1 = res.state
    if strain == "one_lake":
        return _lake_rows((a, kw), n, slice(0, 1))
    if strain == "ragged":
        return _lake_rows((a, kw), n, slice(0, 37))
    if strain == "inactive":
        return a, dict(kw, active=torch.zeros_like(kw["active"]))
    if strain == "lanes_outside":
        gen = torch.Generator(device=st.volume.device).manual_seed(18)
        keep = torch.rand(kw["lane_mask"].shape, generator=gen,
                          device=st.volume.device) < 0.6
        return a, dict(kw, lane_mask=kw["lane_mask"] & keep)
    volume = s1.volume.clone()
    if strain == "nan_volume":
        volume[::3] = float("nan")
        return (lp, st, res._replace(state=dataclasses.replace(
            s1, volume=volume))), kw
    # every second lake empty, with no ice every fourth; every fifth over
    # full, the rest of the odd ones full to the brim
    iwe = s1.ice_water_eq.clone()
    volume[::2] = 0.0
    iwe[::4] = 0.0
    full = lp.maxvolume.expand_as(volume)
    volume[1::2] = full[1::2] * 1.0
    volume[::5] = full[::5] * 1.3
    return (lp, st, res._replace(state=dataclasses.replace(
        s1, volume=volume, ice_water_eq=iwe))), kw


@pytest.mark.gpu
@pytest.mark.parametrize("strain", BALANCE_STRAINS)
@pytest.mark.parametrize("config,record", [("lakes", 1), ("heavy", 3)])
def test_lake_water_balance_kernel_matches_plain(cuda, config, record,
                                                 strain):
    """The water balance after solve_lake: every output of the lakes
    step's second record and the heavy step's fourth, as captured and
    under each of BALANCE_STRAINS, equal to lake_water_balance_plain's,
    lake by lake and lane by lane, in one launch."""
    a, kw = _captured_args(cuda, names=("lake_water_balance",),
                           config=config,
                           record=record)["lake_water_balance"]
    a, kw = _strained_balance(a, kw, strain)
    ref = lake_water_balance_plain(*a, **kw)
    if strain == "as_captured":
        assert bool(kw["lane_mask"].any()) and bool(
            (ref.recharge_m3 > 0).any())
    before = kernels.launches["lake_water_balance"]
    got = kernels.lake_water_balance(*a, **kw)
    torch.cuda.synchronize()
    assert kernels.launches["lake_water_balance"] == before + 1
    for field in ref._fields:
        assert _equal_nan(getattr(got, field), getattr(ref, field)), field


@pytest.mark.gpu
def test_lake_depth_kernel_matches_plain_on_every_volume(cuda):
    """K13 on lake_basin.cuh against the plain bisection on volumes from
    empty to over full, the basin's own levels' volumes (the layer edges)
    and NaN: equal depths."""
    a, kw = _lake_args(cuda)["lake_depth"]
    z, basin, maxdepth, _ = a
    lp = SimpleNamespace(z=z, basin=basin, maxdepth=maxdepth)
    n = z.shape[0]
    edges = tl_volume(lp, z[:, 5])
    for volume in (torch.linspace(-1.0, 1.2, n, device=cuda)
                   * tl_volume(lp, maxdepth), edges,
                   torch.full((n,), float("nan"), device=cuda)):
        got = kernels.lake_depth(z, basin, maxdepth, volume)
        assert _equal_nan(got, depth_from_volume_plain(lp, volume))


@pytest.mark.gpu
def test_lake_depth_kernel_matches_plain_on_seeded_basins(cuda):
    """K13 against the plain bisection on seeded falling basins of 1-20
    nodes (uneven, even and tied levels, the flat zero tail io.lakeparam
    pads a short profile with), volumes at the levels and across the
    basin, 0, negative and NaN, and NaN or negative maxdepth: equal
    depths."""
    rng = np.random.default_rng(13)
    n = 4096
    z, b = np.zeros((n, 21)), np.zeros((n, 21))
    for i in range(n):
        nn, md = int(rng.integers(1, 21)), rng.uniform(0.5, 30.0)
        kind = i % 3
        if kind == 0:
            zz = np.concatenate([[md], np.sort(rng.uniform(0, md, nn - 1))
                                 [::-1], [0.0]])
        elif kind == 1:
            zz = md * (1.0 - np.arange(nn + 1) / nn)
        else:
            zz = np.round(np.sort(rng.uniform(0, md, nn + 1))[::-1])
            zz[-1] = 0.0
        bb = np.sort(rng.uniform(0, 1e6, nn + 1))[::-1]
        bb[-1] = 0.0
        z[i, :nn + 1], b[i, :nn + 1] = zz, bb
    t = lambda x: torch.tensor(np.asarray(x, np.float32), device=cuda)
    z, basin = t(z), t(b)
    maxdepth = z[:, 0].clone()
    maxdepth[3::101] = float("nan")
    maxdepth[4::101] = -1.0
    lp = SimpleNamespace(z=z, basin=basin, maxdepth=maxdepth)
    at_levels = tl_volume(lp, z[torch.arange(n), t(rng.integers(0, 21, n))
                                .long()])
    across = tl_volume(lp, z[:, 0]) * t(rng.uniform(-0.1, 1.2, n))
    for volume in (at_levels, across):
        volume[::97] = 0.0
        volume[1::97] = float("nan")
        got = kernels.lake_depth(z, basin, maxdepth, volume)
        assert _equal_nan(got, depth_from_volume_plain(lp, volume))


def tl_volume(lp, depth):
    from vic_tpu_torch.physics.lake import volume_from_depth
    return volume_from_depth(lp, depth)


@pytest.mark.gpu
@pytest.mark.parametrize("config", ["blowing_close", "heavy_nolakes"])
def test_canopy_air_final_kernel_matches_plain(cuda, config):
    """K9's final update on the settled pass of the blowing_close and
    heavy_nolakes steps' fourth record: Tcanopy, the fallback flag and the
    sensible heat equal to the plain version's, in one launch."""
    a, kw = _captured_args(cuda, names=("canopy_air_final",), config=config,
                           record=3)["canopy_air_final"]
    before = kernels.launches["canopy_air_final"]
    got = kernels.canopy_air_final(*a, **kw)
    ref = canopy_air_final_plain(*a, **kw)
    torch.cuda.synchronize()
    assert kernels.launches["canopy_air_final"] == before + 1
    assert torch.equal(got[1], ref[1])
    assert _equal_nan(got[0], ref[0]) and _equal_nan(got[2], ref[2])


@pytest.mark.gpu
def test_canopy_air_step_publishes_and_resets_its_maximum(cuda):
    """K9's step: bit-equal to its plain version pass after pass, the
    batch's largest change read from the pinned host word equal to the
    device word's, and the accumulator and ticket back at 0 after every
    launch (no fill between passes)."""
    a, kw = _captured_args(cuda, names=("canopy_air_step",),
                           config="heavy_nolakes",
                           record=3)["canopy_air_step"]
    for it in range(3):
        got = kernels.canopy_air_step(*a, **dict(kw, it=it))
        ref = canopy_air_step_plain(*a, **dict(kw, it=it))
        host = kernels.canopy_air_largest_change(got[2])
        scratch = kernels._canopy_air[cuda]
        assert scratch.acc.tolist() == [0, 0]
        assert all(_equal_nan(g, r) for g, r in zip(got, ref))
        assert np.float32(host) == got[2].item() == ref[2].item()
        kw = dict(kw, tc=got[0], tc_prev=kw["tc"], g_prev=got[1])


def test_ice_residual_fields_are_the_kernels_inputs():
    """csrc/lake_ice_melt.cu's IceResidual holds dt, then
    kernels.ICE_EB_INPUTS in that order (the blowing-snow flux last), which
    its lane's prologue forms; its C function expects as many float inputs
    as kernels.ICE_MELT_INPUTS names and the one mask, and runs the lane on
    csrc/lane_brent.cuh's driver."""
    src = (build.CSRC / "lake_ice_melt.cu").read_text()
    body = re.search(r"struct IceResidual \{\s*float([^;]*);", src).group(1)
    fields = [w.strip() for w in body.split(",")]
    assert fields == ["dt"] + list(kernels.ICE_EB_INPUTS)
    assert kernels.ICE_EB_INPUTS[-1] == "blowing_flux"
    enum = re.search(r"enum In \{([^}]*)\}", src).group(1)
    assert len([w for w in enum.split(",") if w.strip()]) \
        == len(kernels.ICE_MELT_INPUTS) + 1
    assert "fill_lane_inputs(&in, lanes, nf, kNumIn, nm, 1, h)" in src
    assert "launch_lane_brent<IceLane>" in src


@pytest.mark.parametrize("name,source,inputs", [
    ("lake_open_water", "lake_open_water.cu", kernels.OPEN_WATER_INPUTS),
    ("lake_under_ice", "lake_under_ice.cu", kernels.UNDER_ICE_INPUTS)])
def test_lake_column_inputs_are_the_kernels_inputs(name, source, inputs):
    """K10's and K11's lane tables name their sources' In enums in order:
    the layered temp, z, zhalf and surface (kernels._column_lanes), then
    kernels.OPEN_WATER_INPUTS or UNDER_ICE_INPUTS, as many as kNumIn; and
    the masks active, mask and last, as lake.cuh's load_layer reads them
    (mask and last from index 1), as many as kNumMask."""
    src = (build.CSRC / source).read_text()
    enum = re.search(r"enum In \{([^}]*)\}", src).group(1)
    names = [re.sub(r"(?<!^)([A-Z])", r"_\1", w.strip()[1:]).lower()
             for w in enum.split(",") if w.strip()]
    assert names == ["temp", "z", "zhalf", "surface"] + list(inputs)
    assert f"constexpr int kNumIn = {len(names)};" in src
    assert "constexpr int kNumMask = 3;" in src
    assert "lane_m(in, 0, row)" in src
    assert "load_layer(in, row, kZ, 1, k)" in src
    assert f"int {name}(const int64_t* lanes" in src


def _heavy_lake_args(device, n_cell=64, record=6):
    """K12's call and K8's call on the lake lanes (its second in a step) in
    the heavy step's seventh record, where lakes carry snow that blows."""
    calls = {"lake_ice_melt": [], "blowing_snow": []}
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
    return calls["lake_ice_melt"][0], calls["blowing_snow"][1]


@pytest.mark.gpu
def test_lake_ice_brent_kernel_matches_plain_with_blowing_flux(cuda):
    """K12 on the heavy step's lakes, some of them bracketed under a
    blowing-snow flux: testing.ice_melt_failures' rule, as above."""
    (_, kw), _ = _heavy_lake_args(cuda)
    got = _check_ice_melt(kw)
    blown = kw["blowing_flux"].expand(got.swq.shape) != 0.0
    assert bool((blown & got.solve.bracketed).any())


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
    inputs and masks, lo and hi after the residual's inputs; GlacierResidual
    reads GLACIER_INPUTS, and K17's glacier lane as many."""
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
    lane = re.search(r"struct SnowpackLane : SnowpackResidual \{\s*static "
                     r"constexpr int kNumIn = (\d+);", k2)
    launch = re.search(r"fill_lane_inputs\(&in, lanes, nf, "
                       r"SnowpackLane::kNumIn \+ 2, nm, (\d+),", k2)
    # lo and hi follow the residual's inputs in K2's lane table
    assert (int(lane.group(1)), int(launch.group(1))) == \
        (len(kernels.SNOWPACK_INPUTS), 1 + len(kernels.SNOWPACK_FLAGS))
    # K17: one lane type a residual on csrc/lane_brent.cuh's driver, its
    # table the residual's inputs, then lo and hi, and its masks
    k17 = (build.CSRC / "bisection.cu").read_text()
    lanes = {m.group(1): (int(m.group(2)), int(m.group(3))) for m in
             re.finditer(r"struct (\w+) : (?:SnowpackResidual|"
                         r"GlacierResidual) \{\s*static constexpr int "
                         r"kNumIn = (\d+), kNumMasks = (\d+);", k17)}
    assert lanes == {
        "SnowBisectLane": (len(kernels.SNOWPACK_INPUTS),
                           1 + len(kernels.SNOWPACK_FLAGS)),
        "GlacierBisectLane": (len(kernels.GLACIER_INPUTS), 1)}
    assert re.search(r"fill_lane_inputs\(&in, lanes, nf, Lane::kNumIn \+ 2, "
                     r"nm,\s*Lane::kNumMasks, h\)", k17)
    assert re.search(r"static constexpr int kLo = kNumIn, kHi = kNumIn \+ 1, "
                     r"kActive = 0;", k17)


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


def _bisection_strain(a, kw, case):
    """A captured K1 or K2 call rebuilt for K17 under strain: every 37th
    lane active ("sparse"), none ("none_active"), every lane with NaN air
    on every fifth and a NaN lo on one ("nan"), or the first 37 cells, a
    lane count that is not a multiple of 128 ("partial_tile"). Returns
    (lo, hi, active, dt, the residual's inputs)."""
    lo, hi, active = a
    shape = torch.broadcast_shapes(lo.shape, hi.shape, active.shape)
    inputs = {k: v for k, v in kw.items()
              if k not in ("dt", "max_iter", "max_tries")}
    if case == "partial_tile":
        n = shape[0]

        def cut(x):
            return x[:37] if torch.is_tensor(x) and x.dim() and \
                x.shape[0] == n else x
        lo, hi, active = cut(lo), cut(hi), cut(active)
        inputs = {k: cut(v) for k, v in inputs.items()}
    elif case == "nan":
        active = torch.ones(shape, dtype=torch.bool, device=lo.device)
        tair = inputs["tair"].expand(shape).clone()
        tair.view(-1)[::5] = float("nan")
        inputs["tair"] = tair
        lo = lo.expand(shape).clone()
        lo.view(-1)[3] = float("nan")
    else:
        active = torch.zeros(shape, dtype=torch.bool, device=lo.device)
        if case == "sparse":
            active.view(-1)[::37] = True
    return lo, hi, active, kw["dt"], inputs


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["sparse", "none_active", "nan",
                                  "partial_tile"])
@pytest.mark.parametrize("residual", ["snowpack", "glacier"])
def test_bisection_kernel_under_strain(cuda, residual, case):
    """K17 on csrc/lane_brent.cuh's compacted lanes against the plain
    version on K2's and K1's arguments of the light step, 40 steps, where
    the active lanes are sparse or absent, residuals are NaN or the last
    128-lane tile is partial: equal flags, iterations n_iter on the active
    lanes and 0 elsewhere, NaN roots where the plain version's are, the
    other roots within 1e-5."""
    from vic_tpu_torch.physics.bisection import bisection_plain
    name = {"snowpack": "snowpack_brent", "glacier": "glacier_brent"}[
        residual]
    a, kw = _captured_args(cuda, names=(name,))[name]
    lo, hi, active, dt, inputs = _bisection_strain(a, kw, case)
    if case == "partial_tile":
        assert active.expand(lo.shape).numel() % 128
    before = kernels.launches["bisection"]
    got = kernels.bisection(residual, lo, hi, active, 40, dt=dt, **inputs)
    ref = bisection_plain(residual, lo, hi, active, 40, dt=dt, **inputs)
    torch.cuda.synchronize()
    assert kernels.launches["bisection"] == before + 1
    assert torch.equal(got.bracketed, ref.bracketed)
    assert torch.equal(got.converged, ref.converged)
    act = active.expand(got.root.shape)
    assert torch.equal(got.iterations, torch.where(act, 40, 0).int())
    nan = ref.root.isnan()
    assert torch.equal(got.root.isnan(), nan)
    assert bool(((got.root - ref.root).abs() <= 1e-5)[~nan].all())
    if case == "nan":
        assert bool(nan.any())
    if case == "none_active":
        assert not bool(got.bracketed.any())
        assert torch.equal(got.root, ref.root)


def _mass_release_case(case, device, n_cell=64, h=8):
    """K15's inputs for `case`, seeded: both lane-contiguous and aligned
    ("contiguous"); canopy snow a view offset by one float ("offset");
    canopy snow broadcast from [n_cell, 1] ("broadcast"); 13 x 7 lanes, not
    a multiple of 4 ("odd_count"); NaN and +/-inf in both ("nan_inf")."""
    rng = np.random.default_rng(5)
    if case == "odd_count":
        n_cell, h = 13, 7
    snow = rng.uniform(0.0, 0.03, (n_cell, h)).astype(np.float32)
    storage = (snow * rng.uniform(0.0, 0.3, (n_cell, h))).astype(np.float32)
    if case == "nan_inf":
        snow.reshape(-1)[::7] = np.nan
        snow.reshape(-1)[3::11] = np.inf
        snow.reshape(-1)[5::13] = -np.inf
        storage.reshape(-1)[2::9] = np.nan
        storage.reshape(-1)[4::17] = np.inf
    snow_t = torch.tensor(snow, device=device)
    storage_t = torch.tensor(storage, device=device)
    if case == "offset":
        buf = torch.empty(snow.size + 1, device=device)
        buf[1:] = snow_t.reshape(-1)
        snow_t = buf[1:].view(n_cell, h)
    if case == "broadcast":
        snow_t = snow_t[:, :1]
    return snow_t, storage_t


@pytest.mark.gpu
@pytest.mark.parametrize("case,route", [
    ("contiguous", "vector"), ("offset", "table"), ("broadcast", "table"),
    ("odd_count", "vector"), ("nan_inf", "vector")])
def test_mass_release_kernel_paths(cuda, case, route):
    """K15's vector path (lane-contiguous, 16-byte aligned inputs, four
    lanes a thread, a scalar tail) and table path (a view offset by one
    float, a broadcast input) against the plain version at 1e-5, NaN and
    inf where its are; the four outputs are rows of one allocation."""
    from vic_tpu_torch.physics.canopy_snow import mass_release_plain
    snow, storage = _mass_release_case(case, cuda)
    assert kernels.mass_release_route(snow, storage) == route
    before = kernels.launches["mass_release"]
    got = kernels.mass_release(snow, storage)
    ref = mass_release_plain(snow, storage)
    torch.cuda.synchronize()
    assert kernels.launches["mass_release"] == before + 1
    assert len({g.untyped_storage().data_ptr() for g in got}) == 1
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(),
                                   rtol=1e-5, atol=1e-5)
    if case == "nan_inf":
        assert bool(ref[0].isnan().any()) and bool(ref[0].isinf().any())


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
@pytest.mark.parametrize("nnode", [3, 5, 10, 18, 50])
@pytest.mark.parametrize("noflux", [False, True])
def test_implicit_profile_kernel_matches_plain(cuda, nnode, noflux):
    """K16 on K6's arguments in the third record of the frozen step (5
    linear nodes) and of frozen_exp's configuration at 3, 10 (its own), 18
    and 50 EXP_TRANS nodes, NOFLUX both ways: the instances that hold 3, 5
    and 10 nodes in registers and the rolled lane on node-major scratch;
    temperatures within 1e-4 C, equal fallback counts."""
    from vic_tpu_torch.physics.frozen_soil import \
        solve_t_profile_implicit_plain
    build_nodes = (None if nnode == 5 else
                   _node_solve_build("exp_trans", nnode))
    a, kw = _captured_args(cuda, names=("node_sweep",), config="frozen",
                           record=2, build=build_nodes)["node_sweep"]
    assert a[0].shape[-1] == nnode
    args = dict(dt_sec=kw["dt_sec"], noflux=noflux, frozen=kw["frozen"])
    before = kernels.launches["implicit_profile"]
    got = kernels.implicit_profile(*a, **args)
    ref = solve_t_profile_implicit_plain(*a, **args)
    torch.cuda.synchronize()
    assert kernels.launches["implicit_profile"] == before + 1
    assert torch.equal(got.fbcount, ref.fbcount)
    assert float((got.temp - ref.temp).abs().max()) <= 1e-4


def _node_solve_build(spacing, nnode):
    """The frozen configuration (linear nodes) or frozen_exp's (EXP_TRANS
    nodes, SPATIAL_FROST) with its node count replaced."""
    params = frozen_params if spacing == "linear" else frozen_exp_params

    def build_nodes(n_cell, n_rec, device):
        gp = params(n_rec).replace(nnode=nnode)
        return entry._build(gp, n_cell, n_rec, device)
    return build_nodes


def _nan_lane(x, lane=5):
    """x with one lane ([..., nn] rows flattened) NaN."""
    x = x.clone()
    x.view(-1, x.shape[-1])[lane] = float("nan")
    return x


@pytest.mark.gpu
@pytest.mark.parametrize("nan", [False, True])
@pytest.mark.parametrize("nnode", [3, 5, 10, 50])
@pytest.mark.parametrize("spacing", ["linear", "exp_trans"])
def test_cooperative_node_sweep_matches_plain(cuda, spacing, nnode, nan):
    """K6's one launch at 3, 5, 10 and 50 nodes on linear and EXP_TRANS
    spacing, on its first call of the step's third record, and with one
    lane's old temperatures NaN (a NaN change stops every lane's sweeps):
    the same sweep count and fallback counts, node temperatures within
    1e-4 C where the plain version's are not NaN and NaN where they are."""
    a, kw = _captured_args(cuda, names=("node_sweep",), record=2,
                           build=_node_solve_build(spacing, nnode))[
                               "node_sweep"]
    assert a[0].shape[-1] == nnode and kw["exp_trans"] == (
        spacing == "exp_trans")
    if nan:
        a = (_nan_lane(a[0]),) + tuple(a[1:])
    before = kernels.launches["node_sweep"]
    got = kernels.node_sweep(*a, **kw)
    ref = solve_t_profile_explicit_plain(*a, **kw)
    torch.cuda.synchronize()
    assert kernels.launches["node_sweep"] == before + 1
    assert int(got.iterations) == ref.iterations
    if nan:
        assert ref.iterations == 1
    assert torch.equal(got.fbcount, ref.fbcount)
    assert torch.equal(torch.isnan(got.temp), torch.isnan(ref.temp))
    ok = ~torch.isnan(ref.temp)
    assert float((got.temp - ref.temp)[ok].abs().max()) <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("nan", [False, True])
@pytest.mark.parametrize("nnode", [3, 5, 10, 50])
@pytest.mark.parametrize("spacing", ["linear", "exp_trans"])
def test_cooperative_fd_surface_brent_matches_plain(cuda, spacing, nnode,
                                                     nan):
    """K7's one launch at 3, 5, 10 and 50 nodes on linear and EXP_TRANS
    spacing, on the step's third record, and with one lane's old node
    temperatures NaN: against the plain Brent with the plain node sweep
    inside, the same Brent trips, profile solves and sweeps, the same
    flags, roots within the final bracket width."""
    from vic_tpu_torch.physics.frozen_soil import NodeSolve
    a, kw = _captured_args(cuda, names=("fd_surface_brent",), record=2,
                           build=_node_solve_build(spacing, nnode))[
                               "fd_surface_brent"]
    solve = kw["eb_kwargs"]["fd_solve"]
    assert isinstance(solve, NodeSolve) and solve.t0.shape[-1] == nnode
    if nan:
        solve = solve._replace(t0=_nan_lane(solve.t0))
        kw = dict(kw, eb_kwargs=dict(kw["eb_kwargs"], fd_solve=solve))
    sweeps = []

    def plain_solve(ts):
        args, opts = solve.at(ts)
        res = solve_t_profile_explicit_plain(*args, **opts)
        sweeps.append(int(res.iterations))
        return res

    before = kernels.launches["fd_surface_brent"]
    got = kernels.fd_surface_brent(*a, **kw)
    ref = surface_root_plain(*a, **dict(kw, eb_kwargs=dict(
        kw["eb_kwargs"], fd_solve=plain_solve)))
    torch.cuda.synchronize()
    assert kernels.launches["fd_surface_brent"] == before + 1
    assert (int(got.iterations), int(got.solves), int(got.sweeps)) == (
        ref.iterations, len(sweeps), sum(sweeps))
    if nan:
        assert set(sweeps) == {1}
    assert bool(got.bracketed.any())
    assert torch.equal(got.bracketed, ref.bracketed)
    assert torch.equal(got.converged, ref.converged)
    both = got.converged & ref.converged
    tol = 2.0 * (2.0 * torch.finfo(torch.float32).eps * got.root.abs() + 1e-4)
    assert bool(((got.root - ref.root).abs() <= tol)[both].all())


def _counted(name, call):
    """(call's result, the change of every trace counter across it, the
    change of kernels.launches[name])."""
    from vic_tpu_torch import trace
    before, launched = trace.counters(), kernels.launches[name]
    got = call()
    after = trace.counters()
    return (got, {k: after[k] - before[k] for k in after
                  if after[k] != before[k]},
            kernels.launches[name] - launched)


@pytest.mark.gpu
def test_fd_surface_brent_adds_its_counts_to_the_device_totals(cuda):
    """One K7 call adds its returned trips, profile solves and sweeps to
    trace's k7_* totals, on the device, and one launch."""
    a, kw = _captured_args(cuda, names=("fd_surface_brent",), record=2,
                           build=_node_solve_build("exp_trans", 10))[
                               "fd_surface_brent"]
    got, moved, launched = _counted(
        "fd_surface_brent", lambda: kernels.fd_surface_brent(*a, **kw))
    assert launched == 1
    assert int(got.sweeps) > int(got.solves) > 0
    assert moved == {"k7_trips": int(got.iterations),
                     "k7_solves": int(got.solves),
                     "k7_sweeps": int(got.sweeps),
                     "launches.fd_surface_brent": 1}


@pytest.mark.gpu
def test_node_sweep_adds_its_sweeps_to_the_device_totals(cuda):
    """One stand-alone K6 call adds its returned sweep count to trace's
    k6_sweeps, on the device, and one launch."""
    a, kw = _captured_args(cuda, names=("node_sweep",), record=2,
                           build=_node_solve_build("exp_trans", 10))[
                               "node_sweep"]
    got, moved, launched = _counted("node_sweep",
                                    lambda: kernels.node_sweep(*a, **kw))
    assert launched == 1
    assert int(got.iterations) > 0
    assert moved == {"k6_sweeps": int(got.iterations),
                     "launches.node_sweep": 1}


@pytest.mark.gpu
def test_cooperative_kernels_refuse_a_grid_not_co_resident(cuda,
                                                            monkeypatch):
    """K6 and K7 launch cooperatively: a grid larger than the blocks the
    device holds at once is refused by name, with no fallback."""
    captured = _captured_args(cuda, names=("node_sweep", "fd_surface_brent"),
                              config="frozen", record=2)
    monkeypatch.setattr(kernels, "_COOP_BLOCKS", 1 << 24)
    for name, (a, kw) in captured.items():
        with pytest.raises(RuntimeError, match=f"{name}: a grid of "
                           f"{1 << 24} blocks is not co-resident"):
            getattr(kernels, name)(*a, **kw)


def _card_close(got, ref, residual, label):
    """K5's terms at its root or K2's at 0 C and at its root against the
    plain terms: NaN at the same elements, each field within TERMS_RTOL
    plus its unit's absolute limit (testing.terms_atol)."""
    for field in got._fields:
        g, r = getattr(got, field), getattr(ref, field)
        if not isinstance(g, torch.Tensor) or g is r:
            continue
        r = r.expand(g.shape)
        assert torch.equal(torch.isnan(g), torch.isnan(r)), (label, field)
        ok = ~torch.isnan(r)
        atol = terms_atol(field, residual)
        assert bool(((g - r).abs() <= atol + TERMS_RTOL * r.abs())[ok]
                    .all()), \
            (label, field)


@pytest.mark.gpu
@pytest.mark.parametrize("config,record", [
    ("light", 0), ("blowing_close", 3), ("frozen_quick", 1),
    ("dist_prcp", 1), ("spatial_snow", 1)])
def test_surface_brent_kernel_terms_match_plain(cuda, config, record):
    """K5's root, flags and terms against its plain version on the
    arguments a step gave it: equal flags, roots within the final bracket
    width, the terms within _card_close's limits of the plain terms at the
    kernel's own root."""
    a, kw = _captured_args(cuda, names=("surface_brent",), config=config,
                           record=record)["surface_brent"]
    before = kernels.launches["surface_brent"]
    got = kernels.surface_brent(*a, **kw)
    ref = surface.surface_brent_plain(*a, **kw)
    torch.cuda.synchronize()
    assert kernels.launches["surface_brent"] == before + 1
    assert torch.equal(got.converged, ref.converged)
    assert torch.equal(got.bracketed, ref.bracketed)
    tol = 2.0 * (2.0 * torch.finfo(torch.float32).eps * got.root.abs() + 1e-4)
    both = got.converged & ref.converged
    assert bool(((got.root - ref.root).abs() <= tol)[both].all())
    eb = kw["eb_kwargs"]
    ts = torch.where(got.converged, got.root, eb["ts_old"])
    _card_close(got.terms, surface.surf_energy_terms(ts, **eb), "error",
                config)


@pytest.mark.gpu
@pytest.mark.parametrize("config,record", [
    ("light", 0), ("blowing_close", 3), ("spatial_snow", 1)])
def test_snowpack_brent_kernel_terms_match_plain(cuda, config, record):
    """K2's melt test, root, flags and terms against its plain version:
    the melt test equal (the kernel forms it in CUDA: a tie within an ulp
    of -refreeze_energy could flip, none does on these lanes), roots within
    the final bracket width, the terms at 0 C and at the kernel's root
    within _card_close's limits."""
    a, kw = _captured_args(cuda, names=("snowpack_brent",),
                           config=config, record=record)["snowpack_brent"]
    got = kernels.snowpack_brent(*a, **kw)
    ref = snowpack_brent_plain(*a, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got.melt_cond, ref.melt_cond)
    assert torch.equal(got.converged, ref.converged)
    assert torch.equal(got.bracketed, ref.bracketed)
    tol = 2.0 * (2.0 * torch.finfo(torch.float32).eps * got.root.abs() + 1e-4)
    both = got.converged & ref.converged
    assert bool(((got.root - ref.root).abs() <= tol)[both].all())
    _card_close(got.terms0, ref.terms0, "rest", f"{config} at 0 C")
    inputs = {k: v for k, v in kw.items() if k not in ("max_iter",
                                                       "max_tries")}
    ts = torch.where(got.converged, got.root, kw["old_tsurf"])
    _card_close(got.terms_b, snow_energy_terms(ts, **inputs), "rest",
                f"{config} at the root")


@pytest.mark.gpu
@pytest.mark.parametrize("config,record", [
    ("light", 0), ("blowing_close", 3), ("spatial_snow", 1),
    ("heavy_nolakes", 3)])
def test_glacier_brent_kernel_terms_match_plain(cuda, config, record):
    """K1's melt test, its melt, root, flags and what glacier_ablation
    forms at the accepted temperature against its plain version: the melt
    test equal (formed in CUDA: a tie within an ulp of 0 could flip, none
    does on these lanes), roots within the final bracket width, the
    accepted temperature 0 C, the root or old_tsurf, and the melt and the
    terms, cold content and vapour loss at the kernel's own accepted
    temperature within _card_close's limits."""
    from vic_tpu_torch import constants as c
    from vic_tpu_torch.physics.glacier import glacier_energy_terms
    a, kw = _captured_args(cuda, names=("glacier_brent",), config=config,
                           record=record)["glacier_brent"]
    before = kernels.launches["glacier_brent"]
    got = kernels.glacier_brent(*a, **kw)
    ref = glacier_brent_plain(*a, **kw)
    torch.cuda.synchronize()
    assert kernels.launches["glacier_brent"] == before + 1
    for field in ("melt_cond", "converged", "bracketed", "fbflag"):
        assert torch.equal(getattr(got, field), getattr(ref, field)), field
    tol = 2.0 * (2.0 * torch.finfo(torch.float32).eps * got.root.abs() + 1e-4)
    both = got.converged & ref.converged
    assert bool(((got.root - ref.root).abs() <= tol)[both].all())
    inputs = {k: v for k, v in kw.items() if k not in ("max_iter",
                                                       "max_tries")}
    ts = torch.where(got.melt_cond, 0.0,
                     torch.where(got.converged, got.root, kw["old_tsurf"]))
    assert torch.equal(got.surf_temp, ts)
    terms = glacier_energy_terms(ts, **inputs)
    cold = torch.where(got.melt_cond, 0.0,
                       c.CH_ICE * ts * kw["ice_depth_mm"] / 1000.0)
    for field, r in (("melt_mm", ref.melt_mm), ("cold_content", cold),
                     ("vapor_flux", -terms.vapor_flux)):
        g = getattr(got, field)
        assert torch.equal(torch.isnan(g), torch.isnan(r)), field
        ok = ~torch.isnan(r)
        assert bool(((g - r).abs() <= terms_atol(field, None)
                     + TERMS_RTOL * r.abs())[ok].all()), (config, field)
    _card_close(got.terms, terms, "rest", f"{config} terms")


@pytest.mark.gpu
@pytest.mark.parametrize("call", [0, 1])
def test_runoff_kernel_matches_plain_on_both_columns(cuda, call):
    """K4 on the heavy_nolakes step's fourth record (3-hourly, frozen
    soil), the wet column's call and the dry column's (DIST_PRCP): every
    field of RunoffResult within 1e-5 of the plain runoff_step."""
    a, kw = _captured_args(cuda, 16, ("runoff_hourly",), "heavy_nolakes",
                           3, nth=call)["runoff_hourly"]
    assert a[-1] == 3
    got = kernels.runoff_hourly(*a, **kw)
    ref = runoff_step_plain(*a, **kw)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_card_step_evaluates_no_glacier_terms_or_infiltration_curve(cuda):
    """On the card glacier_ablation takes everything from K1 and
    runoff_step from K4: the light step evaluates no glacier_energy_terms
    and no compute_runoff_and_asat, and launches each kernel once."""
    from vic_tpu_torch.physics import glacier, runoff
    counts = {"glacier_energy_terms": 0, "compute_runoff_and_asat": 0}
    originals = {"glacier_energy_terms": (glacier,
                                          glacier.glacier_energy_terms),
                 "compute_runoff_and_asat": (
                     runoff, runoff.compute_runoff_and_asat)}

    def counted(name, fn):
        def wrapper(*a, **k):
            counts[name] += 1
            return fn(*a, **k)
        return wrapper

    gp, params, stack, state, _ = build_light(64, 1, cuda)
    step = make_step(params, gp)
    kernels.reset_launches()
    for name, (mod, fn) in originals.items():
        setattr(mod, name, counted(name, fn))
    try:
        step(state, {k: v[0] for k, v in stack.items()})
        torch.cuda.synchronize()
    finally:
        for name, (mod, fn) in originals.items():
            setattr(mod, name, fn)
    assert counts == dict.fromkeys(counts, 0)
    assert kernels.launches["glacier_brent"] == 1
    assert kernels.launches["runoff_hourly"] == 1


def _split_matches_one_launch(name, whole, shares):
    """K6's or K7's shares (testing.split_kernel_call) against its one
    launch over the whole batch: every share's sweep (K7: trip, profile
    solve and sweep) counts the launch's, every lane's outputs its own bit
    for bit."""
    if name == "node_sweep":
        counts = [int(r.iterations) for r in shares]
        assert counts == [int(whole.iterations)] * len(shares)
        fields = ("temp", "fbcount")
    else:
        counts = [(int(r.iterations), int(r.solves), int(r.sweeps))
                  for r in shares]
        assert counts == [(int(whole.iterations), int(whole.solves),
                           int(whole.sweeps))] * len(shares)
        fields = ("root", "converged", "bracketed")
    for f in fields:
        got, ref = torch.cat([getattr(r, f) for r in shares]), getattr(
            whole, f)
        if ref.is_floating_point():
            assert torch.allclose(got, ref, rtol=0.0, atol=0.0,
                                  equal_nan=True), f
        else:
            assert torch.equal(got, ref), f


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["node_sweep", "fd_surface_brent"])
def test_cooperative_kernels_split_into_shares_match_one_launch(cuda, name):
    """K6 and K7 as two shares of one batch on the one card, each share a
    cooperative launch on its own stream from its own thread, voting every
    batch-wide decision with the other (a parallel.votes.ShareGroup):
    equal to the one launch over the whole batch, counts and lanes, on the
    frozen step's third record (1,024 cells, so several tiles a grid) and
    with one lane's old temperatures NaN in the second share."""
    from vic_tpu_torch.testing import split_kernel_call
    a, kw = _captured_args(cuda, n_cell=1024, names=(name,),
                           config="frozen", record=2)[name]
    for nan in (False, True):
        t0 = a[0] if name == "node_sweep" else kw["eb_kwargs"]["fd_solve"].t0
        # a lane three quarters of the way through: the second share's
        lane = t0.numel() // t0.shape[-1] * 3 // 4
        if nan and name == "node_sweep":
            a = (_nan_lane(a[0], lane),) + tuple(a[1:])
        elif nan:
            solve = kw["eb_kwargs"]["fd_solve"]
            kw = dict(kw, eb_kwargs=dict(kw["eb_kwargs"], fd_solve=solve
                                         ._replace(t0=_nan_lane(t0, lane))))
        whole = getattr(kernels, name)(*a, **kw)
        torch.cuda.synchronize()
        before = kernels.launches[name]
        shares = split_kernel_call(name, a, kw, [cuda, cuda])
        assert kernels.launches[name] == before + 2
        _split_matches_one_launch(name, whole, shares)


@pytest.mark.gpu
def test_share_group_raises_when_a_share_never_launches(cuda):
    """A group of two whose second share never launches: the first
    share's K6 gives up at the group's time limit and its call raises,
    naming the share, the vote and the share it waited for; the group is
    aborted, and the card runs on. (A group without devices: its shares
    do not meet before a launch, Member.launch_table, which a lone share
    on a shared card would wait at.)"""
    import time

    from vic_tpu_torch.parallel.votes import ShareGroup
    from vic_tpu_torch.testing import cell_share
    a, kw = _captured_args(cuda, names=("node_sweep",), config="frozen",
                           record=2)["node_sweep"]
    a0, kw0 = cell_share((a, kw), 0, 32, 64)
    group = ShareGroup(2, timeout_s=2.0)
    try:
        t0 = time.perf_counter()
        with pytest.raises(RuntimeError, match="node_sweep: share 0 of 2, "
                           "device vote 1: timed out after 2.0 s waiting "
                           "for share 1"):
            kernels.node_sweep(*a0, **dict(kw0, votes=group.member(0)))
        assert time.perf_counter() - t0 < 30.0
        assert group.error is not None
    finally:
        group.close()
    got = kernels.node_sweep(*a, **kw)
    ref = solve_t_profile_explicit_plain(*a, **kw)
    assert int(got.iterations) == ref.iterations
