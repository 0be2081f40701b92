"""Frozen-soil finite-difference thermal solver on the node profile.

Counterpart of `vic_tpu/physics/frozen_soil.py` (frozen_soil.c,
soil_conduction.c) on the explicit path the step runs:

- `build_node_geometry`: the node depths (QUICK_FLUX's 3 nodes, linear or
  EXP_TRANS spacing, any node count), finite-difference spacings,
  node->layer maps, the layer-averaging trapezoid samples and the
  reference-quirk solver arrays, on the host in float64
  (initialize_model_state.c:505-660, set_node_parameters);
- `distribute_node_moisture`: node moisture, ice, conductivity and heat
  capacity from the layer moisture (soil_conduction.c:304-440);
- `solve_t_profile_explicit`: the Gauss-Seidel node sweep
  (frozen_soil.c:305-494) -- on the CPU through
  `solve_t_profile_explicit_plain`, on a CUDA device through the
  `node_sweep` kernel (`csrc/node_sweep.cu`); `NodeSolve` holds its
  arguments but the boundary condition, which the surface Brent of the
  finite-difference step varies (the `fd_surface_brent` kernel runs the
  same sweeps inside its own launch);
- `solve_t_profile_implicit`: the IMPLICIT Newton-Raphson solve with a
  Thomas solve per step (frozen_soil.c:229-300) -- on the CPU through
  `solve_t_profile_implicit_plain`, on a CUDA device through the
  `implicit_profile` kernel (`csrc/implicit_profile.cu`). No step calls it,
  in vic_tpu or here, whatever IMPLICIT says;
- `estimate_layer_ice` (with SPATIAL_FROST's frost subareas) and
  `find_zero_fronts` (soil_conduction.c:444-830).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from .. import constants as c
from .soil_thermal import (maximum_unfrozen_water, soil_conductivity,
                           unfrozen_water_from_terms,
                           volumetric_heat_capacity)

SWEEP_TOL = 1e-2       # C, the sweep's convergence test (frozen_soil.c:466)
BISECT_ITERS = 16      # bisection depth of the nodes below the layers


@dataclass
class NodeGeometry:
    """Static node-profile geometry, [n_cell, n_node] unless noted: numpy
    float64 on the host as built, tensors after `to(device)` (floats as
    float32, indices as int64)."""
    zsum: object          # node depth (m)
    dz: object            # node thickness (m)
    alpha: object         # Zsum[j+1]-Zsum[j-1] (soil_conduction.c:266)
    beta: object          # Zsum[j]-Zsum[j-1]
    gamma: object         # Zsum[j+1]-Zsum[j]
    node_layer: object    # soil layer each node reads (the reference's lag)
    on_boundary: object   # bool: node exactly on a layer interface
    max_moist_node: object  # mm/mm
    expt_node: object
    bubble_node: object
    samp_i0: object       # [n_cell, n_layer, ns] lower node of each sample
    samp_w: object        # weight of node i0+1 (1-w on i0)
    samp_trap: object     # trapezoid weight / layer depth
    bexp: object          # [n_cell] EXP_TRANS exponent (0 if unused)
    # the reference's layer-array aliasing in the node solver
    # (frozen_soil.c:114-115, vicNl_def.h:919-940): nodes j < 3 read layer
    # j's mm-unit values, nodes j >= 3 node j-3's volumetric ones
    solver_max_moist: object
    solver_bubble: object
    solver_expt: object
    # parameter-only terms the JAX package forms in float64 from its numpy
    # geometry before rounding to float32: the sweep's E (rho_ice*Lf*alpha^2,
    # with EXP_TRANS 4*bexp^2*rho_ice*Lf*(Zsum+1)^2), EXP_TRANS's 4*bexp^2
    # and Zsum+1 of its A = 4*bexp^2*Cs*(Zsum+1)^2, and
    # maximum_unfrozen_water's 9.81*bubble/100 and -2/(expt-3) per node
    e_coef: object
    e_lin: object         # rho_ice*Lf*alpha^2 on any spacing (implicit solve)
    exp_a: object         # [n_cell] 4*bexp^2 (0 if unused)
    zp1: object           # Zsum + 1
    bubble_term_node: object
    power_node: object

    @property
    def n_node(self):
        return self.zsum.shape[1]

    def to(self, device) -> "NodeGeometry":
        def conv(a):
            a = a.cpu().numpy() if isinstance(a, torch.Tensor) else \
                np.asarray(a)
            if a.dtype.kind == "f":
                dtype = torch.float32
            elif a.dtype.kind == "b":
                dtype = torch.bool
            else:
                dtype = torch.int64
            return torch.as_tensor(a, dtype=dtype, device=device)
        return dataclasses.replace(
            self, **{f.name: conv(getattr(self, f.name))
                     for f in dataclasses.fields(self)})


def build_node_geometry(soil, gp) -> NodeGeometry:
    """Host-side construction (initialize_model_state.c:505-660 +
    set_node_parameters + the layer-averaging sample maps), float64.
    A copy of vic_tpu's, array for array."""
    n_cell = soil.n_cell
    nn = max(gp.nnode, 3)
    nl = gp.nlayer
    depth = np.asarray(soil.depth, np.float64)
    dp = np.asarray(soil.dp, np.float64)

    zsum = np.zeros((n_cell, nn))
    dz = np.zeros((n_cell, nn))
    bexp = np.zeros(n_cell)

    if gp.quick_flux:
        # QUICK_FLUX 3-node geometry (initialize_model_state.c:507-513)
        zsum[:, 1] = depth[:, 0]
        zsum[:, 2] = dp
        dz[:, 0] = depth[:, 0]
        dz[:, 1] = depth[:, 0]
        dz[:, 2] = 2.0 * (dp - 1.5 * depth[:, 0])
        for j in range(3, nn):
            zsum[:, j] = dp
    elif gp.exp_trans:
        # exponential spacing Zsum = exp(bexp*j) - 1 down to dp
        # (vic_tpu/physics/frozen_soil.py:110-115)
        bexp = np.log(dp + 1.0) / (nn - 1)
        for j in range(nn):
            zsum[:, j] = np.exp(bexp * j) - 1.0
        dz[:, :-1] = np.diff(zsum, axis=1)
        dz[:, -1] = dz[:, -2]
    else:
        # linear-ish spacing (initialize_model_state.c:560-600)
        d0 = depth[:, 0]
        zsum[:, 1] = d0
        zsum[:, 2] = 2.0 * d0
        dz[:, 0] = d0
        dz[:, 1] = d0
        dz[:, 2] = d0
        tmpdp = dp - d0 * 2.5
        tmpadj = 3.5
        z = 2.0 * d0
        for j in range(3, nn - 1):
            dz[:, j] = tmpdp / (nn - tmpadj)
            z = z + (dz[:, j] + dz[:, j - 1]) / 2.0
            zsum[:, j] = z
        dz[:, nn - 1] = (dp - z - dz[:, nn - 2] / 2.0) * 2.0
        zsum[:, nn - 1] = z + (dz[:, nn - 2] + dz[:, nn - 1]) / 2.0

    # finite-difference spacings (soil_conduction.c:262-275)
    alpha = np.zeros((n_cell, nn))
    beta = np.zeros((n_cell, nn))
    gamma = np.zeros((n_cell, nn))
    for j in range(1, nn - 1):
        alpha[:, j] = zsum[:, j + 1] - zsum[:, j - 1]
        beta[:, j] = zsum[:, j] - zsum[:, j - 1]
        gamma[:, j] = zsum[:, j + 1] - zsum[:, j]
    # NOFLUX bottom-node spacings (soil_conduction.c:272-274)
    alpha[:, nn - 1] = 2.0 * (zsum[:, nn - 1] - zsum[:, nn - 2])
    beta[:, nn - 1] = zsum[:, nn - 1] - zsum[:, nn - 2]
    gamma[:, nn - 1] = zsum[:, nn - 1] - zsum[:, nn - 2]
    alpha = np.maximum(alpha, 1e-6)
    beta = np.maximum(beta, 1e-6)
    gamma = np.maximum(gamma, 1e-6)

    # node -> layer map: the reference advances the layer index at the END
    # of each node (soil_conduction.c:91-118,370-435), so a node just below
    # a layer boundary still reads the layer above it
    lsum = np.concatenate([np.zeros((n_cell, 1)), np.cumsum(depth, 1)], 1)
    node_layer = np.zeros((n_cell, nn), np.int32)
    on_boundary = np.zeros((n_cell, nn), bool)
    for ci in range(n_cell):
        lidx = 0
        cum = 0.0
        past_bottom = False
        for j in range(nn):
            z = zsum[ci, j]
            if (j != 0 and lidx != nl - 1
                    and abs(z - (cum + depth[ci, lidx])) < 1e-12):
                on_boundary[ci, j] = True
            node_layer[ci, j] = lidx
            if z > cum + depth[ci, lidx] + 1e-12 and not past_bottom:
                cum += depth[ci, lidx]
                lidx += 1
                if lidx == nl:
                    past_bottom = True
                    lidx = nl - 1

    gidx = np.arange(n_cell)[:, None]
    max_moist_vol = np.asarray(soil.max_moist) / (depth * 1000.0)
    max_moist_node = max_moist_vol[gidx, node_layer]
    expt_node = np.asarray(soil.expt)[gidx, node_layer]
    bubble_node = np.asarray(soil.bubble)[gidx, node_layer]
    # boundary nodes average the two adjacent layers (set_node_parameters)
    nl_dn = np.minimum(node_layer + 1, nl - 1)
    for arr, src in ((max_moist_node, max_moist_vol),
                     (expt_node, np.asarray(soil.expt)),
                     (bubble_node, np.asarray(soil.bubble))):
        avg = (src[gidx, node_layer] + src[gidx, nl_dn]) / 2.0
        arr[on_boundary] = avg[on_boundary]

    # layer-averaging trapezoid samples (estimate_layer_ice_content)
    ns = nn + 2
    samp_i0 = np.zeros((n_cell, nl, ns), np.int32)
    samp_w = np.zeros((n_cell, nl, ns))
    samp_trap = np.zeros((n_cell, nl, ns))
    for ci in range(n_cell):
        zs = zsum[ci]
        for l in range(nl):
            z_top, z_bot = lsum[ci, l], lsum[ci, l + 1]
            inner = [j for j in range(nn) if z_top < zs[j] < z_bot]
            pts = [z_top] + [zs[j] for j in inner] + [z_bot]
            m = len(pts)
            for k, z in enumerate(pts):
                j = int(np.clip(np.searchsorted(zs, z, "right") - 1, 0,
                                nn - 2))
                w = (z - zs[j]) / max(zs[j + 1] - zs[j], 1e-12)
                samp_i0[ci, l, k] = j
                samp_w[ci, l, k] = np.clip(w, 0.0, 1.0)
            for k in range(m):
                left = pts[k] - pts[k - 1] if k > 0 else 0.0
                right = pts[k + 1] - pts[k] if k < m - 1 else 0.0
                samp_trap[ci, l, k] = 0.5 * (left + right) / max(
                    z_bot - z_top, 1e-12)

    # reference-quirk solver arrays (MAX_LAYERS = 3, user_def.h:95)
    layer_vals = (np.asarray(soil.max_moist), np.asarray(soil.bubble),
                  np.asarray(soil.expt))
    node_vals = (max_moist_node, bubble_node, expt_node)
    solver = [np.zeros((n_cell, nn)) for _ in range(3)]
    for j in range(nn):
        for out, lay, nod in zip(solver, layer_vals, node_vals):
            out[:, j] = lay[:, min(j, nl - 1)] if j < 3 else nod[:, j - 3]

    # vic_tpu's sweep forms these from its numpy geometry in float64,
    # left to right as written (frozen_soil.py:375-389)
    b3 = bexp[:, None]
    zp1 = zsum + 1.0
    e_lin = c.ICE_DENSITY * c.LF * alpha * alpha
    e_coef = (4.0 * b3 * b3 * c.ICE_DENSITY * c.LF * zp1 * zp1
              if gp.exp_trans and not gp.quick_flux else e_lin)
    return NodeGeometry(
        zsum=zsum, dz=dz, alpha=alpha, beta=beta, gamma=gamma,
        node_layer=node_layer, on_boundary=on_boundary,
        max_moist_node=max_moist_node, expt_node=expt_node,
        bubble_node=bubble_node, samp_i0=samp_i0, samp_w=samp_w,
        samp_trap=samp_trap, bexp=bexp, solver_max_moist=solver[0],
        solver_bubble=solver[1], solver_expt=solver[2], e_coef=e_coef,
        e_lin=e_lin, exp_a=4.0 * bexp * bexp, zp1=zp1,
        bubble_term_node=9.81 * bubble_node / 100.0,
        power_node=-(2.0 / (expt_node - 3.0)))


def _per_node(layer_arr, idx):
    """[c, h|1, nl] layer values -> [c, h, nn] by node->layer index
    [c, 1, nn]."""
    shape = torch.broadcast_shapes(layer_arr.shape[:-1], idx.shape[:-1])
    return torch.gather(layer_arr.expand(shape + layer_arr.shape[-1:]), -1,
                        idx.expand(shape + idx.shape[-1:]))


def distribute_node_moisture(moist_mm, node_temp, geom: NodeGeometry, params,
                             frozen: bool):
    """Node moisture/ice/kappa/Cs from layer moisture
    (soil_conduction.c:304-440). moist_mm: [c,h,nl]; node_temp: [c,h,nn];
    geom on the tensors' device. Returns a dict of [c,h,nn]."""
    nl_idx = geom.node_layer[:, None, :]
    moist_vol = moist_mm / (params.depth[:, None, :] * 1000.0)

    def g(a):           # per-cell layer array [c, nl] -> [c, h, nn]
        return _per_node(a[:, None, :], nl_idx).expand(node_temp.shape)

    moist_node = _per_node(moist_vol, nl_idx)
    # boundary nodes average adjacent layers (soil_conduction.c:365-370)
    nl_dn = torch.clamp(nl_idx + 1, max=moist_vol.shape[-1] - 1)
    moist_dn = _per_node(moist_vol, nl_dn)
    ob = geom.on_boundary[:, None, :]
    moist_node = torch.where(ob, (moist_node + moist_dn) / 2.0, moist_node)
    max_moist_node = geom.max_moist_node[:, None, :]
    moist_node = torch.minimum(moist_node, max_moist_node)

    if frozen:
        ice_node = torch.clamp(moist_node - unfrozen_water_from_terms(
            node_temp, max_moist_node, geom.bubble_term_node[:, None, :],
            geom.power_node[:, None, :]), min=0.0)
        ice_node = torch.where(params.fs_active[:, None, None], ice_node, 0.0)
    else:
        ice_node = torch.zeros_like(moist_node)

    kappa = soil_conductivity(
        moist_node, moist_node - ice_node, g(params.soil_dens_min),
        g(params.bulk_dens_min), g(params.quartz), g(params.soil_density),
        g(params.bulk_density), g(params.organic))
    cs = volumetric_heat_capacity(
        g(params.bulk_density / params.soil_density), moist_node - ice_node,
        ice_node, g(params.organic))
    return dict(moist=moist_node, ice=ice_node, kappa=kappa, cs=cs)


class ProfileResult(NamedTuple):
    temp: torch.Tensor      # [c, h, nn] new node temperatures
    fbcount: torch.Tensor   # [c, h, nn] int32 per-node TFALLBACK counts
    iterations: object      # sweeps run: int (plain) or int32 0-d tensor


def solve_t_profile_explicit(t0, surf_temp, kappa, cs, moist_node, ice0_node,
                             geom: NodeGeometry, fs_active, *, nlayer: int,
                             dt_sec: float, noflux: bool, frozen: bool,
                             max_sweeps: int, exp_trans: bool = False,
                             votes=None) -> ProfileResult:
    """The Gauss-Seidel node sweep: `solve_t_profile_explicit_plain` for
    CPU tensors, the `node_sweep` kernel for CUDA tensors. votes: the
    share of a split block these lanes are (parallel.votes.Member), or
    None."""
    solve = solve_t_profile_explicit_plain
    return solve(t0, surf_temp, kappa, cs, moist_node, ice0_node, geom,
                 fs_active, nlayer=nlayer, dt_sec=dt_sec, noflux=noflux,
                 frozen=frozen, max_sweeps=max_sweeps, exp_trans=exp_trans,
                 votes=votes)


class NodeSolve(NamedTuple):
    """The node profile's solve at a candidate surface temperature, fixed
    over a step: solve_t_profile_explicit's arguments but surf_temp.
    Called with the candidates it returns that function's ProfileResult;
    the `fd_surface_brent` kernel reads the arguments and runs the solve
    inside its own launch. votes: the share of a split block these lanes
    are (parallel.votes.Member), whose sweeps, and the Brent's decisions
    around them, are voted over every share; None on one device."""
    t0: torch.Tensor
    kappa: torch.Tensor
    cs: torch.Tensor
    moist_node: torch.Tensor
    ice0_node: torch.Tensor
    geom: NodeGeometry
    fs_active: torch.Tensor
    nlayer: int
    dt_sec: float
    noflux: bool
    frozen: bool
    max_sweeps: int
    exp_trans: bool = False
    votes: object = None

    def at(self, surf_temp):
        """solve_t_profile_explicit's (args, kwargs) at surf_temp."""
        return ((self.t0, surf_temp, self.kappa, self.cs, self.moist_node,
                 self.ice0_node, self.geom, self.fs_active),
                dict(nlayer=self.nlayer, dt_sec=self.dt_sec,
                     noflux=self.noflux, frozen=self.frozen,
                     max_sweeps=self.max_sweeps, exp_trans=self.exp_trans,
                     votes=self.votes))

    def __call__(self, surf_temp) -> ProfileResult:
        args, kwargs = self.at(surf_temp)
        return solve_t_profile_explicit(*args, **kwargs)


def solve_t_profile_explicit_plain(t0, surf_temp, kappa, cs, moist_node,
                                   ice0_node, geom: NodeGeometry, fs_active,
                                   *, nlayer: int, dt_sec: float,
                                   noflux: bool, frozen: bool,
                                   max_sweeps: int,
                                   exp_trans: bool = False,
                                   votes=None) -> ProfileResult:
    """Plain version of the `node_sweep` kernel: vic_tpu's
    solve_t_profile_explicit (frozen_soil.py:311-598) with the reference's
    ice quirk and no warm start, at any node count, on linear or (exp_trans)
    EXP_TRANS node spacing.

    t0: [c,h,nn] previous temperatures; surf_temp: [c,h] node-0 boundary
    condition; kappa/cs/moist_node/ice0_node: [c,h,nn] at the old
    temperatures; geometry [c,nn] broadcast over h; fs_active [c].

    Sweeps run while any lane of the WHOLE batch moved more than 1e-2 C in
    the last sweep, up to max_sweeps (one device-to-host sync per sweep);
    a NaN anywhere stops them, as jnp.max propagates it. With votes (a
    parallel.votes.Member) the batch is the whole split block: each
    sweep's largest change is the largest of every share's. Nodes j < nlayer
    take the closed-form root of the quirk's linear residual, deeper nodes
    a 6-pair bracket expansion and 16 bisection steps, both only where the
    node was below 0 C and frozen soil is active; then the post-sweep
    cold-nose fix, and the whole profile of a lane whose last sweep moved
    more than 1e-2 C reverts to the old temperatures."""
    W = torch.where
    nn = t0.shape[-1]

    def B1(a):
        return a[:, None, :]

    alpha, beta, gamma = B1(geom.alpha), B1(geom.beta), B1(geom.gamma)
    mmax = B1(geom.solver_max_moist)
    bub = B1(geom.solver_bubble)
    expt = B1(geom.solver_expt)
    deltat = dt_sec
    fs = fs_active[:, None] if frozen else torch.zeros_like(
        fs_active[:, None])

    kap_p1 = torch.roll(kappa, -1, dims=-1)
    kap_m1 = torch.roll(kappa, 1, dims=-1)
    B = (kap_p1 - kap_m1) * deltat
    B_last = (kappa - kap_m1) * deltat
    E = B1(geom.e_coef)
    if exp_trans:
        # the coefficients on the exponential grid (frozen_soil.c:190-212)
        zp1 = B1(geom.zp1)
        bexp = geom.bexp[:, None, None]
        A = geom.exp_a[:, None, None] * cs * zp1 * zp1
        C = 4.0 * deltat * kappa
        D = 2.0 * deltat * kappa * bexp
    else:
        A = cs * alpha * alpha
        C = 2.0 * deltat * kappa * alpha / gamma
        D = 2.0 * deltat * kappa * alpha / beta

    def flux2(j, t, tl, tu):
        """The C/D terms of the residual at node j (soil_thermal_eqn.c)."""
        if exp_trans:
            return C[..., j] * (tl - 2.0 * t + tu) - D[..., j] * (tl - tu)
        return C[..., j] * (tl - t) - D[..., j] * (t - tu)

    def closed_form(j, tl, tu, b):
        """The unfrozen closed-form update at node j (frozen_soil.c:390-392)
        with the B coefficient b, and its denominator."""
        if exp_trans:
            denom = A[..., j] + 2.0 * C[..., j]
            num = (A[..., j] * t0[..., j] + b * (tl - tu)
                   + C[..., j] * (tl + tu) - D[..., j] * (tl - tu)
                   + E[..., j] * (0.0 - ice0_node[..., j]))
        else:
            denom = A[..., j] + C[..., j] + D[..., j]
            num = (A[..., j] * t0[..., j] + b * (tl - tu)
                   + C[..., j] * tl + D[..., j] * tu
                   + E[..., j] * (0.0 - ice0_node[..., j]))
        return num / denom, denom

    def ice_at(t, j):
        iw = torch.clamp(moist_node[..., j] - maximum_unfrozen_water(
            t, mmax[..., j], bub[..., j], expt[..., j]), min=0.0)
        return W(fs, torch.minimum(iw, mmax[..., j]), 0.0)

    def node_residual(t, j, T):
        """SoilThermalEqn at node j (soil_thermal_eqn.c) with the node-1
        cold-nose patch (:58-70)."""
        tl, tu = T[j + 1], T[j - 1]
        ice = W(t < 0.0, ice_at(t, j), 0.0) if frozen else \
            torch.zeros_like(t)
        f1 = B[..., j] * (tl - tu)
        f2 = flux2(j, t, tl, tu)
        val = (-A[..., j] * (t - t0[..., j]) + f1 + f2
               + E[..., j] * (ice - ice0_node[..., j]))
        if j == 1:
            cold_nose = ((torch.abs(tl - tu) > 5.0) & (t < tl) & (t < tu)
                         & (f1 < 0.0) & (f2 > 0.0)
                         & (torch.abs(f1) > torch.abs(f2)))
            val = W(cold_nose, val - f1, val)
        return val

    deltas = torch.tensor([c.SOIL_DT + 10.0 * k for k in range(6)],
                          dtype=t0.dtype, device=t0.device)
    deltas = deltas.reshape((6,) + (1,) * (t0.dim() - 1))

    def sweep(T):
        fb = [torch.zeros_like(t0[..., 0], dtype=torch.int32)
              for _ in range(nn)]
        maxdiff = torch.zeros_like(t0[..., 0])
        for j in range(1, nn - 1):
            oldT, tl, tu = T[j], T[j + 1], T[j - 1]
            t_lin, denom = closed_form(j, tl, tu, B[..., j])
            if frozen and j < nlayer:
                # the quirk's residual is linear in t here (ice == 0 for
                # every reachable t): its root in closed form, then the
                # bracket test over t0 +/- (SOIL_DT + 50)
                t_root = t_lin
                if j == 1:
                    f1 = B[..., j] * (tl - tu)
                    r1 = t_lin - f1 / denom
                    f2_r1 = flux2(j, r1, tl, tu)
                    cn_r1 = ((torch.abs(tl - tu) > 5.0) & (r1 < tl)
                             & (r1 < tu) & (f1 < 0.0) & (f2_r1 > 0.0)
                             & (torch.abs(f1) > torch.abs(f2_r1)))
                    t_root = W(cn_r1, r1, t_lin)
                wide = c.SOIL_DT + 50.0
                f_lo = node_residual(t0[..., j] - wide, j, T)
                f_hi = node_residual(t0[..., j] + wide, j, T)
                bracketed = f_lo * f_hi < 0.0
            elif frozen:
                # the first of six symmetric pairs t0 +/- (SOIL_DT + 10k)
                # that brackets a sign change, then 16 bisection steps
                los = t0[None, ..., j] - deltas
                his = t0[None, ..., j] + deltas
                f_los = node_residual(los, j, T)
                f_his = node_residual(his, j, T)
                br = f_los * f_his < 0.0
                first = torch.argmax(br.to(torch.int8), dim=0)[None]

                def pick(a):
                    return torch.gather(a, 0, first)[0]

                lo, hi, flo = pick(los), pick(his), pick(f_los)
                bracketed = br.any(dim=0)
                for _ in range(BISECT_ITERS):
                    mid = 0.5 * (lo + hi)
                    fm = node_residual(mid, j, T)
                    left = flo * fm <= 0.0
                    lo, hi, flo = (W(left, lo, mid), W(left, mid, hi),
                                   W(left, flo, fm))
                t_root = 0.5 * (lo + hi)
            if frozen:
                t_frozen = W(bracketed, t_root, t0[..., j])
                use_root = (oldT < 0.0) & fs
                t_new = W(use_root, t_frozen, t_lin)
                fb[j] = fb[j] + (use_root & ~bracketed).to(torch.int32)
            else:
                t_new = t_lin
            T[j] = t_new
            maxdiff = torch.maximum(maxdiff, torch.abs(oldT - t_new))
        if noflux:
            # no-flux bottom: the node mirrors itself (B_last)
            j = nn - 1
            oldT, tl, tu = T[j], T[j], T[j - 1]
            t_lin = closed_form(j, tl, tu, B_last[..., j])[0]
            T[j] = t_lin
            maxdiff = torch.maximum(maxdiff, torch.abs(oldT - t_lin))
        return fb, maxdiff

    T_init = [surf_temp] + [t0[..., j] for j in range(1, nn)]
    T = list(T_init)
    fb_tot = [torch.zeros_like(t0[..., 0], dtype=torch.int32)
              for _ in range(nn)]
    lastdiff = torch.ones_like(t0[..., 0])
    iters = 0

    def another():
        if votes is None:
            return bool(lastdiff.max() > SWEEP_TOL)
        # float32 1e-2 lies below the double, and the next float32 above
        # it: the same test in either precision
        return votes.max_nan(float(lastdiff.max())) > SWEEP_TOL

    while iters < max_sweeps and another():
        fb, lastdiff = sweep(T)
        fb_tot = [a + b for a, b in zip(fb_tot, fb)]
        iters += 1

    # post-sweep runaway-cold-nose fix (frozen_soil.c:470-484): the old/new
    # mix of the reference, ascending j with the already-fixed T[j-1]
    tlast = T_init
    for j in range(1, nn - 1):
        nose = ((tlast[j - 1] - tlast[j] > 0.0)
                & (tlast[j + 1] - T[j] > 0.0)
                & ((T[j - 1] - T[j]) - (tlast[j - 1] - tlast[j]) > 0.0)
                & ((T[j + 1] - T[j]) - (tlast[j + 1] - tlast[j]) > 0.0))
        T[j] = W(nose, 0.5 * (T[j - 1] + T[j + 1]), T[j])
        fb_tot[j] = fb_tot[j] + nose.to(torch.int32)

    # non-convergence: the whole profile reverts, node 0 keeps the new BC
    # (frozen_soil.c:486-494)
    not_done = (lastdiff > SWEEP_TOL)[..., None]
    temp = W(not_done, torch.stack(T_init, -1), torch.stack(T, -1))
    fbcount = torch.stack(fb_tot, -1)
    fbcount = W(not_done, fbcount + 1, fbcount)
    return ProfileResult(temp=temp, fbcount=fbcount, iterations=iters)


def solve_t_profile_implicit(t0, surf_temp, kappa, cs, moist_node,
                             ice0_node, geom: NodeGeometry, fs_active, *,
                             dt_sec: float, noflux: bool, frozen: bool,
                             max_nr: int = 12,
                             relax: float = None) -> ProfileResult:
    """The IMPLICIT Newton-Raphson solve: `solve_t_profile_implicit_plain`
    for CPU tensors, the `implicit_profile` kernel for CUDA tensors."""
    solve = solve_t_profile_implicit_plain
    return solve(t0, surf_temp, kappa, cs, moist_node, ice0_node, geom,
                 fs_active, dt_sec=dt_sec, noflux=noflux, frozen=frozen,
                 max_nr=max_nr, relax=relax)


def solve_t_profile_implicit_plain(t0, surf_temp, kappa, cs, moist_node,
                                   ice0_node, geom: NodeGeometry, fs_active,
                                   *, dt_sec: float, noflux: bool,
                                   frozen: bool, max_nr: int = 12,
                                   relax: float = None) -> ProfileResult:
    """Plain version of the `implicit_profile` kernel: vic_tpu's
    solve_t_profile_implicit (frozen_soil.py:601-700; frozen_soil.c:229-300
    with fda_heat_eqn's residual). max_nr Newton-Raphson steps on the node
    system with the reference's relaxation 0.9/0.7/0.2 (or `relax`); each
    step solves the tridiagonal Jacobian, its rows divided by |diagonal| +
    1e-6 (the raw coefficients reach ~1e8), by the Thomas algorithm, and
    clips the update to +-10 C. The linear-spacing coefficients on any
    geometry, as vic_tpu; kappa[j+1] - kappa[j-1] wraps at the ends as
    jnp.roll does, so under NOFLUX the bottom row reads kappa[0]. A lane
    with a non-finite node or one more than 40 C from its old temperature
    reverts to the old profile with the new surface temperature; fbcount
    marks those nodes.

    Arguments as solve_t_profile_explicit_plain's: t0 and the node
    properties [c,h,nn], surf_temp [c,h], geometry [c,nn], fs_active [c].
    """
    from ..ops.tridiag import thomas_solve
    W = torch.where
    nn = t0.shape[-1]

    def B1(a):
        return a[:, None, :]

    alpha, beta, gamma = B1(geom.alpha), B1(geom.beta), B1(geom.gamma)
    mmax = B1(geom.max_moist_node)
    bubble_term = B1(geom.bubble_term_node)
    power = B1(geom.power_node)
    fs = fs_active[:, None, None]
    deltat = dt_sec

    kap_p1 = torch.roll(kappa, -1, dims=-1)
    kap_m1 = torch.roll(kappa, 1, dims=-1)
    A = cs * alpha * alpha
    Bc = (kap_p1 - kap_m1) * deltat
    C = 2.0 * deltat * kappa * alpha / gamma
    D = 2.0 * deltat * kappa * alpha / beta
    E = B1(geom.e_lin)

    def ice_of(t):
        if not frozen:
            return torch.zeros_like(t)
        iw = torch.clamp(moist_node - unfrozen_water_from_terms(
            t, mmax, bubble_term, power), min=0.0)
        return W(fs & (t < 0.0), torch.minimum(iw, mmax), 0.0)

    interior = torch.zeros(nn, dtype=torch.bool, device=t0.device)
    interior[1:nn - 1] = True
    if noflux:
        interior[nn - 1] = True

    def residual(T):
        tl = torch.roll(T, -1, dims=-1)
        tu = torch.roll(T, 1, dims=-1)
        if noflux:
            # NOFLUX bottom: the node mirrors itself
            tl = torch.cat([tl[..., :nn - 1], T[..., nn - 1:]], -1)
        f = (-A * (T - t0) + Bc * (tl - tu) + C * (tl - T) - D * (T - tu)
             + E * (ice_of(T) - ice0_node))
        return W(interior, f, 0.0)

    T = torch.cat([surf_temp[..., None], t0[..., 1:]], -1)
    for i in range(max_nr):
        relax_i = (0.9 if i == 0 else 0.7 if i == 1 else 0.2) \
            if relax is None else relax
        f = residual(T)
        # the tridiagonal Jacobian
        dice = (ice_of(T + 0.05) - ice_of(T - 0.05)) / 0.1
        dmain = W(interior, -A - C - D + E * dice, 1.0)
        dl = W(interior, -Bc + D, 0.0)
        du = W(interior, Bc + C, 0.0)
        if noflux:
            # the bottom row: tl == T folds the super-diagonal into the
            # diagonal
            dmain = torch.cat([dmain[..., :nn - 1], dmain[..., nn - 1:]
                               + (Bc[..., nn - 1:] + C[..., nn - 1:])], -1)
            du = torch.cat([du[..., :nn - 1],
                            torch.zeros_like(du[..., nn - 1:])], -1)
        scale = W(interior, torch.abs(dmain) + 1e-6, 1.0)
        delta = thomas_solve(dl / scale, dmain / scale, du / scale,
                             -f / scale)
        delta = torch.clamp(delta, -10.0, 10.0)
        T = T + relax_i * W(interior, delta, 0.0)
    # fallback (TFALLBACK): non-finite or wild nodes revert the lane
    bad = ~torch.isfinite(T) | (torch.abs(T - t0) > 40.0)
    T_init = torch.cat([surf_temp[..., None], t0[..., 1:]], -1)
    T = W(bad.any(-1, keepdim=True), T_init, T)
    return ProfileResult(temp=T, fbcount=bad.to(torch.int32),
                         iterations=max_nr)


class LayerIceParams(NamedTuple):
    """What estimate_layer_ice reads of the soil: [c, nl] max_moist (mm),
    maximum_unfrozen_water's parameter terms 9.81*bubble/100 and
    -2/(expt-3), and [c] fs_active."""
    max_moist: torch.Tensor
    bubble_term: torch.Tensor
    power: torch.Tensor
    fs_active: torch.Tensor


def layer_ice_params(max_moist, bubble, expt, fs_active,
                     device=None) -> LayerIceParams:
    """LayerIceParams from float32 tensors (the step's device parameters)
    or from numpy arrays (the cold start's float64 soil parameters, whose
    terms are formed in float64 and rounded once, as the JAX package does
    with numpy inputs)."""
    bubble_term = 9.81 * bubble / 100.0
    power = -(2.0 / (expt - 3.0))
    if isinstance(max_moist, torch.Tensor):
        return LayerIceParams(max_moist, bubble_term, power, fs_active)

    def f32(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                               device=device)
    return LayerIceParams(f32(max_moist), f32(bubble_term), f32(power),
                          torch.as_tensor(np.asarray(fs_active),
                                          dtype=torch.bool, device=device))


def frost_kwargs(gp) -> dict:
    """estimate_layer_ice's SPATIAL_FROST arguments under `gp`, as vic_tpu
    passes them (model.py:974-977): one subarea without spatial_frost."""
    return dict(frost_subareas=gp.frost_subareas if gp.spatial_frost else 1,
                frost_slope=gp.frost_slope)


def frost_offsets(frost_subareas: int, frost_slope: float, device=None):
    """SPATIAL_FROST's temperature offsets of the frost subareas, spread
    uniformly over +-frost_slope/2: vic_tpu's
    jnp.linspace(-0.5, 0.5, n) * frost_slope in float32, as jnp.linspace
    forms it (start*(1-s) + stop*s with s = k/(n-1), the last point stop)."""
    f32 = dict(dtype=torch.float32, device=device)
    div = frost_subareas - 1
    step = torch.arange(div, **f32) / torch.tensor(float(div), **f32)
    offs = torch.cat([-0.5 * (1.0 - step) + 0.5 * step,
                      torch.tensor([0.5], **f32)])
    return offs * frost_slope


def estimate_layer_ice(node_temp, moist_mm, geom: NodeGeometry,
                       soil: LayerIceParams = None, frost_subareas: int = 1,
                       frost_slope: float = 0.0):
    """Layer-average temperature and ice content from node temperatures
    (soil_conduction.c:444-616) through the trapezoid sample maps.
    node_temp: [c,h,nn]; moist_mm: [c,h,nl]; soil None for the temperatures
    alone (ice zero). With frost_subareas > 1 (SPATIAL_FROST, vic_tpu/
    physics/frozen_soil.py:731-740) each sample's ice is the mean over the
    subareas of the ice at the sample temperature plus the subarea's offset
    (frost_offsets), summed subarea by subarea so that no [.., n_subarea]
    temporary is formed. Returns (layer_T, layer_ice_mm)."""
    nn = node_temp.shape[-1]
    c_, h = node_temp.shape[:2]
    nl, ns = geom.samp_i0.shape[1:]
    i0 = geom.samp_i0[:, None].expand(c_, h, nl, ns).reshape(c_, h, -1)
    t_lo = torch.gather(node_temp, -1, i0).reshape(c_, h, nl, ns)
    t_hi = torch.gather(node_temp, -1, torch.clamp(i0 + 1, max=nn - 1)) \
        .reshape(c_, h, nl, ns)
    w = geom.samp_w[:, None]
    trap = geom.samp_trap[:, None]
    t_samp = (1.0 - w) * t_lo + w * t_hi                 # [c,h,nl,ns]
    layer_t = (t_samp * trap).sum(-1)

    if soil is None:
        return layer_t, torch.zeros_like(moist_mm)

    def ice_at(t):
        return torch.clamp(moist_mm[..., None] - unfrozen_water_from_terms(
            t, soil.max_moist[:, None, :, None],
            soil.bubble_term[:, None, :, None],
            soil.power[:, None, :, None]), min=0.0)

    if frost_subareas > 1:
        offs = frost_offsets(frost_subareas, frost_slope, node_temp.device)
        ice_samp = ice_at(t_samp + offs[0])
        for k in range(1, frost_subareas):
            ice_samp = ice_samp + ice_at(t_samp + offs[k])
        ice_samp = ice_samp / float(frost_subareas)
    else:
        ice_samp = ice_at(t_samp)
    layer_ice = (ice_samp * trap).sum(-1)
    layer_ice = torch.where(soil.fs_active[:, None, None], layer_ice, 0.0)
    return layer_t, torch.minimum(layer_ice, moist_mm)


def find_zero_fronts(node_temp, zsum, max_fronts: int = c.MAX_FRONTS):
    """Thawing and freezing front depths (m) from the node profile
    (find_0_degree_fronts, soil_conduction.c:775-830): node pairs scanned
    from the bottom up, a thawing front where T[n] > 0 >= T[n+1], a freezing
    front where T[n] < 0 <= T[n+1], at the linearly interpolated zero
    crossing; the first `max_fronts` of each in bottom-up order, 0 where
    there is none. Returns (tdepth, fdepth), each [..., max_fronts]."""
    t_up = node_temp[..., :-1]
    t_dn = node_temp[..., 1:]
    z = zsum.expand(node_temp.shape)
    z_up, z_dn = z[..., :-1], z[..., 1:]
    denom = torch.where(torch.abs(t_dn - t_up) > 1e-12, t_dn - t_up, 1e-12)
    zcross = z_up + (0.0 - t_up) * (z_dn - z_up) / denom
    thaw = (t_up > 0.0) & (t_dn <= 0.0)
    frost = (t_up < 0.0) & (t_dn >= 0.0)

    def collect(mask, depth):
        m = mask.flip(-1)
        d = depth.flip(-1)
        rank = torch.cumsum(m.to(torch.int32), dim=-1) - 1
        return torch.stack([torch.where(m & (rank == f), d, 0.0).sum(-1)
                            for f in range(max_fronts)], dim=-1)

    return collect(thaw, zcross), collect(frost, zcross)
