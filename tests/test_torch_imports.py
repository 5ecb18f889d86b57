"""grail_torch imports neither JAX nor anything of the reference package."""
import subprocess
import sys

_PROBE = r"""
import pkgutil, importlib, sys
import grail_torch
names = [m.name for m in pkgutil.walk_packages(grail_torch.__path__, "grail_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "grail" or m.startswith("grail."))
print(len(names), bad)
"""


def test_port_imports_no_jax_and_no_reference():
    out = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True,
                         text=True, timeout=120, check=True).stdout.split()
    n_modules, bad = int(out[0]), " ".join(out[1:])
    assert n_modules >= 64
    assert bad == "[]", bad
