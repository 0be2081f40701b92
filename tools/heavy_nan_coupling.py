"""How a NaN cell moves the other cells of the heavy configuration under
CONTINUEONERROR, in vic_tpu and in the port (CPU).

    JAX_PLATFORMS=cpu python tools/heavy_nan_coupling.py [--cells 32]
        [--records 8]

The heavy configuration with CONTINUEONERROR through vic_tpu.model.run
with and without NaN air temperature in cells 1 and cells/2 + 1 from the
fourth record, and through vic_tpu_torch.model.run with it, from the same
float32 bits. A NaN keeps the batch-wide CLOSE_ENERGY pass loop going to
its cap of 25 in every record that has it (vic_tpu/model.py:841's jnp.max
of a NaN); past convergence the other cells' secant steps move them.
Prints the pass counts, the other cells' largest differences between
vic_tpu's two runs, and between vic_tpu's and the port's runs with the
NaN, with the keys the heavy rule (vic_tpu_torch.testing.
heavy_lake_run_failures) fails at 1e-3. About 3 minutes at 32 cells.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

NAN_FROM = 3
KEYS = ("OUT_ENERGY_ERROR", "OUT_SOIL_MOIST", "OUT_SURF_TEMP",
        "OUT_LAKE_VOLUME")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells", type=int, default=32)
    ap.add_argument("--records", type=int, default=8)
    args = ap.parse_args(argv)
    n_cell, n_rec = args.cells, args.records

    import jax
    import jax.numpy as jnp
    jax.config.update("jax_enable_x64", False)
    import make_torch_port_fixture as fixture
    from vic_tpu.model import run as jax_run
    from vic_tpu_torch import entry, model
    from vic_tpu_torch.testing import (heavy_lake_run_failures,
                                       synthetic_domain)

    cells = [1, n_cell // 2 + 1]
    others = [c for c in range(n_cell) if c not in cells]
    gp, params, stack, state, geom, zwt, lp = fixture.heavy_inputs(
        n_cell, n_rec, continue_on_error=True)
    step = jax.jit(lambda s, f: jax_run(s, f, params, gp, geom=geom,
                                        zwt_curves=zwt, lake_params=lp))
    air = np.asarray(stack["air_temp"]).copy()
    air[NAN_FROM:, cells] = np.nan
    j_clean = {k: np.asarray(v) for k, v in step(state, stack)[1].items()}
    j_nan = {k: np.asarray(v) for k, v in step(
        state, dict(stack, air_temp=jnp.asarray(air)))[1].items()}

    t_gp, t_params, t_stack, t_state, extras = entry._build(
        entry.heavy_params(n_rec).replace(continue_on_error=True), n_cell,
        n_rec, "cpu", zwt=True, forcing=entry.heavy_forcing)
    if not np.array_equal(t_stack["air_temp"].numpy(),
                          np.asarray(stack["air_temp"])):
        raise RuntimeError("the port's forcing is not vic_tpu's")
    t_air = t_stack["air_temp"].clone()
    t_air[NAN_FROM:, cells] = float("nan")
    t_nan = {k: v.numpy() for k, v in model.run(
        t_state, dict(t_stack, air_temp=t_air), t_params, t_gp,
        **extras)[1].items()}

    def passes(o):
        return [int(x) for x in o["OUT_TCANOPY_ITER"][:, others[0]]]
    print(f"{n_cell} cells x {n_rec} records, NaN air in cells {cells} "
          f"from record {NAN_FROM}")
    print(f"CLOSE_ENERGY passes: vic_tpu without the NaN {passes(j_clean)},"
          f" with it {passes(j_nan)}; the port with it {passes(t_nan)}")
    for title, a, b in (("vic_tpu with against without the NaN", j_nan,
                         j_clean),
                        ("the port against vic_tpu, both with the NaN",
                         t_nan, j_nan)):
        diffs = ", ".join(
            f"{k} {float(np.nanmax(np.abs(a[k] - b[k])[:, others])):.4g}"
            for k in KEYS)
        print(f"other cells, {title}: largest differences {diffs}")
    area = synthetic_domain(n_cell=n_cell, n_band=2,
                            with_glacier=True).soil.cell_area[others]
    ref = {f"out/{k}": v[:, others] for k, v in j_nan.items()}
    got = {f"out/{k}": v[:, others] for k, v in t_nan.items()}
    print("keys outside the heavy rule at 1e-3 (the port against vic_tpu, "
          "both with the NaN): "
          f"{heavy_lake_run_failures(ref, got, 1e-3, area, gp.dt * 3600.0)}")


if __name__ == "__main__":
    main()
