"""The benchmark's plain reference: a frozen copy of vic_tpu_torch's plain
PyTorch path (the modules its step runs on the CPU, as of commit cde231f),
with each call site's kernel branch taken out, so it runs the plain
version on any device. It holds only what the benchmark's configurations
run: BLOWING, CLOSE_ENERGY, DIST_PRCP and LAKES are refused. It imports nothing of the program; a later change
to the program cannot move it. `benchmark/compare.py` drives it.
"""
