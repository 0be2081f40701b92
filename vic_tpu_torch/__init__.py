"""vic_tpu_torch: the PyTorch/CUDA port of vic-tpu's column physics.

The port runs the "light" configuration (FULL_ENERGY, snow, a glacier HRU,
elevation bands, QUICK_FLUX ground heat, daily records), the same with
FROZEN_SOIL on finite-difference soil nodes, with BLOWING and
CLOSE_ENERGY, and with LAKES through `model.make_step`/`model.run` on
`[n_cell, max_hru]` float32 tensors (the lakes on `[n_cell]`), entered
through `entry.CONFIGS`. On a CUDA device the loop solvers (the Brent
solves, the hourly runoff loop, the frozen-soil node sweep, blowing snow,
the canopy-air step, the lake columns' fixed points and the lake depth
bisection) run as hand-written CUDA kernels (`vic_tpu_torch/csrc/`, built
at first use by `kernels/build.py`); on the CPU every call site takes the
plain PyTorch version in the same module.

The package imports torch and numpy only; it keeps its own copies of the
JAX package's jax-free `constants`, `config` and `timeaxis` modules.
"""

__version__ = "0.2.0"
