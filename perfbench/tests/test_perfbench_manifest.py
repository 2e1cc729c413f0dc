"""BENCHMARK.json keeps to the benchmark's format rules, and every name in it
finds its file."""

import json
import re
import subprocess
import sys

from perfbench import harness

ROOT = harness.ROOT
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
B = harness.manifest()


def test_keys_and_names():
    assert set(B) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in B[k]]
    assert len(names) == len(set(names))
    for n in names + [w["config"] for w in B["workloads"]] + [w["traffic"] for w in B["workloads"]]:
        assert NAME.fullmatch(n), n
    for m in B["end_to_end"] + B["per_layer"]:
        assert UNIT.fullmatch(m["unit"]) and m["better"] in ("lower", "higher"), m
    for c in B["configs"]:
        for k in c["reduced"]:
            assert NAME.fullmatch(k)
    assert 1 <= B["run_seconds"] <= 51 and isinstance(B["run_seconds"], int)
    assert len(json.dumps(B)) < 64 * 1024


def test_files_found_by_name():
    for c in B["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("perfbench/")
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    for w in B["workloads"]:
        traffic = json.loads((ROOT / "perfbench" / "traffic" / f"{w['traffic']}.json").read_text())
        assert (ROOT / "perfbench" / "drivers" / f"{traffic['driver']}.py").is_file()
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    for m in B["per_layer"]:
        assert (ROOT / "perfbench" / "metrics" / f"{m['name']}.py").is_file(), m["name"]


def test_every_cell_reports_what_it_must():
    e2e = {m["name"]: m for m in B["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in B["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for w in B["workloads"]:
        reported = [m["name"] for m in harness.metrics_for(w["name"], B["end_to_end"])]
        assert "setup_s" in reported and len(reported) >= 2, w["name"]
        assert harness.metrics_for(w["name"], B["per_layer"]), w["name"]
    for m in B["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        for cell in m.get("workloads", [w["name"] for w in B["workloads"]]):
            assert m["moves"] in [x["name"] for x in harness.metrics_for(cell, B["end_to_end"])], (m, cell)
    layers = {}
    for m in B["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_command_refuses_without_a_card():
    out = subprocess.run([sys.executable, *B["command"][1:], "--workload", B["workloads"][0]["name"],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
