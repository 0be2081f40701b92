"""Two ways to solve a lake's depth on the card, each held bit for bit in a
plain model against the bisection it must repeat
(`physics.lake.depth_from_volume_plain`):

- the solve the water balance kernel runs (csrc/lake_basin.cuh
  `Basin::solve`, `span_depth` here): once the bracket's ends are at most
  one level apart, each step takes the levels of its midpoint from one
  comparison against the deeper end's levels (the `Span`), where the
  bisection searches them; the levels of the solved depth give its area;
- a group's replay of the bisection tree (`tree_depth`, L = 2, 3, 4, 5:
  groups of 4, 8, 16 and 32 lanes), which the kernel does not run: each
  round, the group's lanes test the midpoints of the bisection's next L
  levels at once, each formed by repeating the step along its node's path
  from the round's bracket, and every lane then walks the L steps by the
  ballot of the tests (on the H100 it cost more than it saved; PERF.md).

The cases:

- the lakes fixture's basins (tests/fixtures/torch_port/lakes_16x4.npz,
  the synthetic parabolic basin) at its state's and outputs' volumes;
- seeded basins that `physics.lake.check_basin` accepts (1-20 nodes,
  uneven, even and tied levels, the flat zero tail of a short profile);
- volumes from 0 to past the full volume, and one ulp either side of each
  level's volume;
- NaN and negative volumes, and a maxdepth of 0.

Both models equal `physics.lake.depth_from_volume_plain`, which the kernel
matches, bit for bit on every case. Against vic_tpu's `depth_from_volume`
they are bit for bit on the fixture's basins at every volume that is not
subnormal: XLA on the CPU flushes subnormals to zero, so vic_tpu returns 0
for the smallest positive volumes, where PyTorch and the card do not. On
the seeded basins vic_tpu's volume curve differs from the port's in its
last bits (XLA adds the full layers in its own order and fuses products
into sums as it compiles; the port adds in index order, `_isum`), so there
they are held at tests/test_torch_lake.py's ELEM_TOL, as the port's depths
always were.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_lake_depth_tree.py -q
"""
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vic_tpu.physics import lake as jlake
from vic_tpu_torch.entry import build_lakes
from vic_tpu_torch.physics import lake

torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "torch_port", "lakes_16x4.npz")
LEVELS = (2, 3, 4, 5)
CASES = ("fixture", "seeded", "maxdepth_0")
ELEM_TOL = 1e-5     # rtol = atol, tests/test_torch_lake.py's


def tree_depth(volume_of, maxdepth, volume, levels):
    """The bisection of volume_of (depth -> volume) as a group of
    2**levels lanes replays it: each round tests the 2**steps - 1 nodes of
    the next `steps` levels (heap order: node n's children are 2n, the
    lower half, and 2n + 1), then walks down the tree by the tests."""
    lo = torch.zeros_like(volume)
    hi = maxdepth * torch.ones_like(volume)
    done = 0
    while done < lake.DEPTH_ITERS:
        steps = min(levels, lake.DEPTH_ITERS - done)
        tests = []
        for node in range(1, 2 ** steps):
            l, h = lo, hi
            for s in range(node.bit_length() - 2, -1, -1):
                mid = 0.5 * (l + h)
                l, h = (mid, h) if (node >> s) & 1 else (l, mid)
            tests.append(volume_of(0.5 * (l + h)) > volume)
        tests = torch.stack(tests)
        n = torch.ones(volume.shape, dtype=torch.int64)
        for _ in range(steps):
            mid = 0.5 * (lo + hi)
            high = torch.gather(tests, 0, (n - 1)[None])[0]
            lo, hi = torch.where(high, lo, mid), torch.where(high, mid, hi)
            n = 2 * n + (~high).long()
        done += steps
    d = 0.5 * (lo + hi)
    return torch.where(volume <= 0.0, 0.0, d)


def _at(t, k):
    """t[row, k[row]] for each row, k clamped to t's columns (where the
    kernel reads no value, the model's is masked out)."""
    return torch.gather(t, 1, k.clamp(0, t.shape[1] - 1)[:, None])[:, 0]


def _levels(z, d):
    """Basin::levels(d): the first of the levels 1..20 below d, and the
    first full layer; on falling levels the binary searches' results are
    these counts."""
    return (1 + (z[:, 1:] >= d[:, None]).sum(1),
            (z[:, :-1] > d[:, None]).sum(1))


def _volume(z, b, full, d, j, k0):
    """Basin::volume(d, lv) at the levels (j, k0): the area's trapezoid
    j - 1 and the partial trapezoid k0 - 1 above the full layers' sum."""
    n_levels, n_layers = z.shape[1], z.shape[1] - 1
    za, zb = _at(z, j - 1), _at(z, j)
    ba = _at(b, j)
    den = torch.clamp(za - zb, min=1e-10)
    a = torch.where((j < n_levels) & (d <= za) & (d > zb),
                    ba + (d - zb) / den * (_at(b, j - 1) - ba), 0.0)
    a = torch.where(d >= z[:, 0], b[:, 0], a)
    a_surf = torch.where(d <= 0.0, 0.0, a)
    zk = _at(z, k0)
    full_v = torch.where((k0 < n_layers) & (d >= zk), _at(full, k0), 0.0)
    part = torch.where((k0 > 0) & (d > zk) & (d < _at(z, k0 - 1)),
                       torch.clamp(d - zk, min=0.0) * (a_surf + _at(b, k0))
                       / 2.0, 0.0)
    return full_v + part, a_surf


def span_depth(lp, volume):
    """Basin::solve: the bisection, each step's levels searched until the
    bracket's ends are at most one level apart in both indices, then taken
    from one comparison each against the deeper end's (the Span, frozen
    at entry). Returns (depth, its surface area at its levels, the share
    of the solves that entered the span)."""
    z, b = lp.z, lp.basin
    layer = (z[:, :-1] - z[:, 1:]) * (b[:, :-1] + b[:, 1:]) / 2.0
    full = torch.empty_like(layer)
    for k0 in range(layer.shape[1]):
        s = layer[:, k0]
        for k in range(k0 + 1, layer.shape[1]):
            s = s + layer[:, k]
        full[:, k0] = s
    lo = torch.zeros_like(volume)
    hi = lp.maxdepth * torch.ones_like(volume)
    track = hi >= lo
    j_lo, k_lo = _levels(z, lo)
    j_hi, k_hi = _levels(z, hi)
    in_span = torch.zeros(volume.shape, dtype=torch.bool)
    sj_lo, sj_hi, sk_lo, sk_hi = j_lo, j_hi, k_lo, k_hi

    def span_levels(d):
        z_j = _at(z, torch.where(sj_hi < z.shape[1], sj_hi, 0))
        return (torch.where((sj_hi < sj_lo) & (z_j >= d), sj_lo, sj_hi),
                torch.where((sk_hi < sk_lo) & (_at(z, sk_hi) > d), sk_lo,
                            sk_hi))

    for _ in range(lake.DEPTH_ITERS):
        enter = (~in_span & track & (j_lo - j_hi <= 1)
                 & (k_lo - k_hi <= 1))
        sj_lo, sj_hi = (torch.where(enter, j_lo, sj_lo),
                        torch.where(enter, j_hi, sj_hi))
        sk_lo, sk_hi = (torch.where(enter, k_lo, sk_lo),
                        torch.where(enter, k_hi, sk_hi))
        in_span = in_span | enter
        mid = 0.5 * (lo + hi)
        j_s, k_s = span_levels(mid)
        j_m, k_m = _levels(z, mid)
        j, k0 = (torch.where(in_span, j_s, j_m),
                 torch.where(in_span, k_s, k_m))
        high = _volume(z, b, full, mid, j, k0)[0] > volume
        j_hi, k_hi = (torch.where(high, j, j_hi), torch.where(high, k0, k_hi))
        j_lo, k_lo = (torch.where(high, j_lo, j), torch.where(high, k_lo, k0))
        lo, hi = torch.where(high, lo, mid), torch.where(high, mid, hi)
    d = 0.5 * (lo + hi)
    j_s, k_s = span_levels(d)
    j_m, k_m = _levels(z, d)
    j, k0 = torch.where(in_span, j_s, j_m), torch.where(in_span, k_s, k_m)
    empty = volume <= 0.0
    d = torch.where(empty, 0.0, d)
    area = _volume(z, b, full, d, j, k0)[1]
    return d, area, float((in_span & ~empty).float().mean())


@jax.jit
def _vic_depth(z, basin, maxdepth, volume):
    return jlake.depth_from_volume(
        SimpleNamespace(z=z, basin=basin, maxdepth=maxdepth), volume)


def _seeded_basins(n, rng):
    """Falling levels of 1-20 nodes, as K13's GPU case makes them."""
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
    z, b = (torch.from_numpy(x.astype(np.float32)) for x in (z, b))
    return SimpleNamespace(z=z, basin=b, maxdepth=z[:, 0].clone())


def _volumes(lp, rng, per_lake=24):
    """[lakes, k] volumes: 0 to 1.2 times the full volume, each level's
    volume and one ulp either side of it, negative and NaN."""
    n = lp.z.shape[0]
    full = lake.volume_from_depth(lp, lp.maxdepth)
    span = torch.from_numpy(rng.uniform(0.0, 1.2, (n, per_lake))
                            .astype(np.float32)) * full[:, None]
    at_levels = torch.stack([lake.volume_from_depth(lp, lp.z[:, k])
                             for k in range(lp.z.shape[1])], 1)
    up = torch.nextafter(at_levels, torch.full_like(at_levels, np.inf))
    down = torch.nextafter(at_levels, torch.full_like(at_levels, -np.inf))
    edge = torch.stack([torch.zeros(n), -full, torch.full((n,), np.nan),
                        full], 1)
    return torch.cat([span, at_levels, up, down, edge], 1)


def _case(name):
    """(lp with z, basin, maxdepth of [lakes * k] rows, volumes [lakes *
    k])."""
    rng = np.random.default_rng(18)
    if name == "fixture":
        fx = np.load(FIXTURE)
        lp = build_lakes(fx["state/lake_volume"].shape[0], 1,
                         "cpu")[4]["lake_params"]
        lp = SimpleNamespace(z=lp.z, basin=lp.basin, maxdepth=lp.maxdepth)
        volumes = _volumes(lp, rng)
        given = np.concatenate(
            [fx["state/lake_volume"][:, None],
             fx["out/OUT_LAKE_VOLUME"].reshape(-1, lp.z.shape[0]).T], 1)
        volumes = torch.cat([volumes, torch.from_numpy(
            given.astype(np.float32))], 1)
    else:
        lp = _seeded_basins(128, rng)
        lake.check_basin(lp.z)
        volumes = _volumes(lp, rng)
        if name == "maxdepth_0":
            lp.maxdepth = torch.zeros_like(lp.maxdepth)
    k = volumes.shape[1]
    rows = SimpleNamespace(**{f: getattr(lp, f).repeat_interleave(k, 0)
                              for f in ("z", "basin", "maxdepth")})
    return rows, volumes.reshape(-1)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return bool(np.all((a == b) | (np.isnan(a) & np.isnan(b))))


@pytest.mark.parametrize("levels", LEVELS)
@pytest.mark.parametrize("case", CASES)
def test_tree_replay_is_the_bisection(case, levels):
    """The replay of the tree by a group of 2**levels lanes gives the plain
    bisection's depths bit for bit, and vic_tpu's as the docstring says;
    the cases reach empty, partial and over-full volumes and NaN."""
    lp, volume = _case(case)
    got = tree_depth(lambda d: lake.volume_from_depth(lp, d), lp.maxdepth,
                     volume, levels)
    assert _same(got, lake.depth_from_volume_plain(lp, volume))
    vic = np.asarray(_vic_depth(*(jnp.asarray(x.numpy()) for x in (
        lp.z, lp.basin, lp.maxdepth, volume))))
    if case == "fixture":
        normal = ~(volume.abs() < torch.finfo(torch.float32).tiny)
        assert _same(got[normal], vic[normal.numpy()])
    np.testing.assert_allclose(got.numpy(), vic, rtol=ELEM_TOL,
                               atol=ELEM_TOL)
    assert bool(torch.isnan(volume).any()) and bool((volume <= 0).any())
    if case != "maxdepth_0":
        inside = (got > 0) & (got < lp.maxdepth)
        assert int(inside.sum()) > volume.numel() // 2


@pytest.mark.parametrize("case", CASES)
def test_span_is_the_bisection(case):
    """The water balance kernel's solve, the Span's levels by one
    comparison, gives the plain bisection's depths bit for bit, and the
    area at its levels the plain area at that depth; most solves reach the
    span."""
    lp, volume = _case(case)
    got, area, spanned = span_depth(lp, volume)
    assert _same(got, lake.depth_from_volume_plain(lp, volume))
    assert _same(area, lake.area_from_depth(lp, got))
    assert spanned > 0.5
