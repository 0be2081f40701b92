"""The PyTorch port imports and steps without JAX and without vic_tpu."""
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
                                          ("heavy", 191)])
def test_port_imports_and_steps_without_jax(config, n_out):
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", SCRIPT, config], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith(f"ok {n_out}"), proc.stdout
