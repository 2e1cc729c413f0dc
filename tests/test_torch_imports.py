"""The port never imports JAX: every module of tinyfaces_tpu_torch, and
chip_smoke.py, imports in a fresh interpreter where `import jax` and
`import PIL` fail (the machine with the GPU has neither)."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

_PROBE = """
import importlib, pkgutil, sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
sys.modules["PIL"] = None  # PIL is imported only where an image is decoded or drawn
import tinyfaces_tpu_torch
names = ["chip_smoke"] + [m.name for m in pkgutil.walk_packages(
    tinyfaces_tpu_torch.__path__, "tinyfaces_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert not any(k == "jax" or k.startswith("jax.") for k, v in sys.modules.items() if v is not None)
print(len(names))
"""


def test_port_imports_without_jax():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 26  # chip_smoke + every module of the package
