"""A later change adds a cell, a configuration, a traffic mix and a metric
by adding files and BENCHMARK.json entries: here they are dropped into a
copy of the folder and run, and no file that was there is edited."""

import hashlib
import json
import shutil
import subprocess
import sys

from perfbench import harness

ROOT = harness.ROOT
READER = '''"""Host fetch: the harness's span around _fetch, mean ms."""

from perfbench.metrics._read import span_mean_ms


def read(run):
    return span_mean_ms(run, "fetch")
'''


def digest(folder):
    return {p.relative_to(folder): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(folder.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_new_cell_config_mix_and_metric_run_unedited(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "perfbench", root / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    before = digest(root / "perfbench")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    conf = json.loads((ROOT / "perfbench/configs/tinyfaces-r101-eval-bf16.json").read_text())
    conf["name"] = "extra-eval-fp32"
    conf["dtype"] = "float32"
    conf["wire"] = "rgb"
    (root / "perfbench/configs/extra-eval-fp32.json").write_text(json.dumps(conf))
    mix = json.loads((ROOT / "perfbench/traffic/closed-b32-768x1024.json").read_text())
    mix["batch"] = 16
    (root / "perfbench/traffic/extra-closed-b16.json").write_text(json.dumps(mix))
    (root / "perfbench/metrics/fetch_ms.extra.py").write_text(READER)
    bench["configs"].append({"name": "extra-eval-fp32", "source": "https://arxiv.org/abs/1612.04402",
                             "file": "perfbench/configs/extra-eval-fp32.json", "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "extra-cell", "config": "extra-eval-fp32",
                               "traffic": "extra-closed-b16", "chips": 1, "why": "test"})
    bench["end_to_end"].append({"name": "pyramid_img_per_s", "unit": "img/s", "better": "higher",
                                "bound": 0.05, "source": "host_clock", "workloads": ["extra-cell"]})
    bench["per_layer"].append({"name": "fetch_ms.extra", "unit": "ms", "better": "lower",
                               "source": "program_span", "layer": "compiled pyramid",
                               "moves": "pyramid_img_per_s", "workloads": ["extra-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import sys, json; sys.path.insert(0, %r); sys.path.insert(1, %r)\n"
            "from pathlib import Path\n"
            "from perfbench.tests.tiny import run_tiny\n"
            "line, run = run_tiny('extra-cell', seconds=1.0, trace=True, root=Path(%r))\n"
            "import perfbench; print(perfbench.__file__); print(json.dumps(line))"
            % (str(root), str(ROOT), str(root)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600, cwd=root)
    assert out.returncode == 0, out.stderr[-3000:]
    where, line = out.stdout.strip().splitlines()[-2:]
    assert where.startswith(str(root))
    line = json.loads(line)
    assert "fetch_ms.extra" in line["metrics"] and line["correct"], line
    after = digest(root / "perfbench")
    assert {k: v for k, v in after.items() if k in before} == before
