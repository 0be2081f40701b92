"""The PyTorch port imports, steps and runs its driver without JAX and
without vic_tpu."""
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = """
import sys
import torch
torch.set_num_threads(1)
import vic_tpu_torch
import vic_tpu_torch.model
import vic_tpu_torch.ops.interp
import vic_tpu_torch.physics.bisection
from vic_tpu_torch.entry import CONFIGS
gp, params, stack, state, extras = CONFIGS[sys.argv[1]](2, 1, "cpu")
step = vic_tpu_torch.model.make_step(params, gp, **extras)
new_state, out = step(state, {k: v[0] for k, v in stack.items()})
assert all(bool(torch.isfinite(v).all()) for v in out.values())
assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
loaded = sorted(m for m in sys.modules
                if m == "vic_tpu" or m.startswith("vic_tpu."))
assert not loaded, loaded
print("ok", len(out))
"""


@pytest.mark.parametrize("config,n_out", [("light", 150), ("frozen", 151),
                                          ("blowing_close", 150),
                                          ("lakes", 186),
                                          ("dist_prcp", 150),
                                          ("heavy_nolakes", 155),
                                          ("heavy", 191),
                                          ("frozen_exp", 151),
                                          ("frozen_quick", 151),
                                          ("spatial_snow", 151)])
def test_port_imports_and_steps_without_jax(config, n_out):
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", SCRIPT, config], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith(f"ok {n_out}"), proc.stdout


DRIVER_SCRIPT = """
import runpy
import sys
sys.argv = ["vic_tpu_torch", "-g", sys.argv[1], "--device", "cpu"]
try:
    runpy.run_module("vic_tpu_torch", run_name="__main__")
except SystemExit as e:
    assert e.code == 0, e.code
assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
loaded = sorted(m for m in sys.modules
                if m == "vic_tpu" or m.startswith("vic_tpu."))
assert not loaded, loaded
assert "vic_tpu_torch.driver" in sys.modules
print("ok")
"""


def test_driver_cli_runs_without_jax(tmp_path):
    """`python -m vic_tpu_torch -g <file> --device cpu` on
    tests/test_driver.py's fixture loads neither jax nor vic_tpu."""
    from test_driver import write_fixture
    gfile = write_fixture(tmp_path, n_day=5, fmt="ASCII")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", DRIVER_SCRIPT, str(gfile)],
                          cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok"), proc.stdout
    assert len([f for f in os.listdir(tmp_path)
                if f.startswith("fluxes_")]) == 2


IO_SPLIT_SCRIPT = """
import os
import sys
import torch
torch.set_num_threads(1)
from vic_tpu_torch import config, driver
from vic_tpu_torch.io import native, state_io
from vic_tpu_torch.parallel.io_shards import find_shards, merge_shards
from vic_tpu_torch.state import initial_state
from vic_tpu_torch.testing import write_driver_run
root = sys.argv[1]
g = write_driver_run(os.path.join(root, "run"), 5, start=(1995, 9, 25),
                     n_day=4, accum_start=(1994, 10, 1),
                     july_tavg=(6.0, 16.0), output_format="NETCDF")
text = open(g).read().replace("STATE_FORMAT ASCII", "STATE_FORMAT NETCDF")
text += "NETCDF_OUTPUT_SHARDS 3\\n"
open(g, "w").write(text)
res = driver.run_main(["-g", g, "--device", "cpu,cpu"])
gp = config.parse_global_param_file(g)
assert gp.state_format == "NETCDF" and int(gp.output_shards) == 3
base = os.path.join(gp.result_dir, gp.netcdf_output_filename)
assert len(find_shards(base)) == 3
merge_shards(base)
domain = driver.load_domain(gp)
template = initial_state(domain, gp, "cpu")
state = [f for f in os.listdir(gp.result_dir) if f.startswith("state")]
assert len(state) == 1, state
path = os.path.join(gp.result_dir, state[0])
assert state_io.is_netcdf(path)
ref = state_io.load_state(path, gp, template, domain)
assert torch.equal(ref.moist, res.final_state.moist)
for fmt, dom in (("NETCDF", None), ("npz", None)):
    p = os.path.join(root, "own_" + fmt)
    state_io.save_state(p, res.final_state, gp, dom, fmt=fmt)
    back = state_io.load_state(p, gp, template)
    assert torch.equal(back.swq, res.final_state.swq), fmt
assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
loaded = sorted(m for m in sys.modules
                if m == "vic_tpu" or m.startswith("vic_tpu."))
assert not loaded, loaded
assert "vic_tpu_torch.parallel.sharding" in sys.modules
print("ok", native.netcdf_found())
"""


def test_state_shards_and_split_run_without_jax(tmp_path):
    """NETCDF state in both schemas and npz, OUTPUT_SHARDS with the merge,
    and a run split over two devices (`--device cpu,cpu`) load neither jax
    nor vic_tpu."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", IO_SPLIT_SCRIPT,
                           str(tmp_path)], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok True"), proc.stdout


SPLIT_STOPS_SCRIPT = """
import os
import sys
import numpy as np
import torch
torch.set_num_threads(1)
from vic_tpu_torch import driver, entry
from vic_tpu_torch.testing import synthetic_domain, write_driver_run
gp = entry.heavy_nolakes_params(1)
res = driver.run_simulation(
    gp, domain=synthetic_domain(n_cell=3, n_band=2, with_glacier=True),
    forcing=entry.heavy_forcing(1, 3), write_output=False, progress=False,
    devices=["cpu", "cpu"])
assert all(np.isfinite(v).all() for v in res.outputs.values())
g = write_driver_run(os.path.join(sys.argv[1], "run"), 3,
                     start=(1995, 9, 25), n_day=2,
                     accum_start=(1994, 10, 1))
open(g, "a").write("CLOSE_ENERGY TRUE\\n")
split = driver.run_main(["-g", g, "--device", "cpu,cpu"])
one = driver.run_main(["-g", g, "--device", "cpu"])
assert split.timeaxis.nrecs == 2
for k, v in one.outputs.items():
    assert np.allclose(split.outputs[k], v, rtol=1e-5, atol=1e-3), k
assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
loaded = sorted(m for m in sys.modules
                if m == "vic_tpu" or m.startswith("vic_tpu."))
assert not loaded, loaded
assert "vic_tpu_torch.parallel.votes" in sys.modules
print("ok", len(res.outputs))
"""


def test_split_batch_wide_stops_run_without_jax(tmp_path):
    """A heavy_nolakes run split over two devices (its node sweeps, Brents
    and CLOSE_ENERGY passes voted over the shares) and a CLOSE_ENERGY run
    from reference-format files through `--device cpu,cpu`, equal to its
    one-device run, load neither jax nor vic_tpu."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", SPLIT_STOPS_SCRIPT,
                           str(tmp_path)], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok 155"), proc.stdout
