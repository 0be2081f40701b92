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
