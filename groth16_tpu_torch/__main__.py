"""`python -m groth16_tpu_torch ...` runs the CLI (groth16_tpu_torch/cli.py)."""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
