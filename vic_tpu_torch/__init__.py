"""vic_tpu_torch: the PyTorch/CUDA port of vic-tpu's column physics.

The port runs the "light" configuration (FULL_ENERGY, snow, a glacier HRU,
elevation bands, QUICK_FLUX ground heat, daily records) and the same with
FROZEN_SOIL on finite-difference soil nodes through
`model.make_step`/`model.run` on `[n_cell, max_hru]` float32 tensors,
entered through `entry.build_light` and `entry.build_frozen`. On a CUDA
device the glacier, snowpack, canopy-foliage and soil-surface Brent solves,
the hourly runoff loop and the frozen-soil node sweep run as hand-written
CUDA kernels (`vic_tpu_torch/csrc/`, built at first use by
`kernels/build.py`); on the CPU every call site takes the plain PyTorch
version in the same module.

The package imports torch and numpy only; it keeps its own copies of the
JAX package's jax-free `constants`, `config` and `timeaxis` modules.
"""

__version__ = "0.2.0"
