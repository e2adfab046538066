"""groth16_tpu_torch must run where JAX is not installed: importing the
package and every submodule in a fresh interpreter loads no jax module."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CODE = """
import importlib, pkgutil, sys
import groth16_tpu_torch as P
names = [m.name for m in pkgutil.walk_packages(P.__path__, "groth16_tpu_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(k for k in sys.modules if k == "jax" or k.startswith(("jax.", "jaxlib", "groth16_tpu.")))
assert not leaked, leaked
print(len(names))
"""


def test_port_and_submodules_import_without_jax():
    out = subprocess.run([sys.executable, "-c", CODE], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20        # every module was walked
