"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the port: module top-level names compared
whole (the part before the first dot), since `tinyfaces_tpu_torch` begins
with `tinyfaces_tpu`."""

import ast
import json
import subprocess
import sys

from perfbench import harness

ROOT = harness.ROOT
RUN_TINY = """
import json, sys
sys.path.insert(0, {root!r})
from perfbench.tests.tiny import run_tiny
line, _ = run_tiny("eval-sweep-b32", seconds=1.0)
line2, _ = run_tiny("train-wider-b12", seconds=1.0)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_forbidden_is_whole_name():
    assert harness.forbidden_modules(["tinyfaces_tpu_torch.evaluation", "jaxtyping", "numpy"]) == []
    assert harness.forbidden_modules(["jax.numpy", "tinyfaces_tpu.ops"]) == ["jax.numpy", "tinyfaces_tpu.ops"]


def test_tiny_cells_load_no_jax():
    out = subprocess.run([sys.executable, "-c", RUN_TINY.format(root=str(ROOT))], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    tops = json.loads(out.stdout.strip().splitlines()[-1])
    assert "tinyfaces_tpu_torch" in tops  # the port ran
    assert not set(tops) & set(harness.FORBIDDEN), tops


def test_reference_loads_nothing_of_the_port():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import perfbench.reference.model, perfbench.reference.pyramid, perfbench.reference.compare, "
            "perfbench.reference.train, perfbench.weights, perfbench.counts.flops, perfbench.counts.bounds\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    tops = eval(out.stdout.strip().splitlines()[-1])
    assert not {"tinyfaces_tpu_torch", *harness.FORBIDDEN} & set(tops), tops


def test_no_source_imports_jax_or_the_jax_package():
    for path in (ROOT / "perfbench").rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                top = n.split(".")[0]
                assert top not in harness.FORBIDDEN, (path, n)
                if "reference" in path.parts or path.parent.name == "counts":
                    assert top != "tinyfaces_tpu_torch", (path, n)
