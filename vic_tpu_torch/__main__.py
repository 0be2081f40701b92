"""CLI: ``python -m vic_tpu_torch -g <global parameter file> [--device cuda]``
(cmd_proc.c analog)."""
import sys

from .driver import main

sys.exit(main())
