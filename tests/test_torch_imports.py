"""The port imports nothing of JAX or of the JAX package: every module of
tinyfaces_tpu_torch, chip_smoke.py and the distributed tests' worker
(tests/torch_dist_worker.py) import in a fresh interpreter where
`import jax`, `import tinyfaces_tpu` and `import PIL` fail (the machine with
the GPU has neither JAX nor PIL), and the port's grader grades a result tree
there. The port's own copies of what it took from
the JAX package (configurations, templates.json, the step timer) stay equal
to the originals."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import pytest

import tinyfaces_tpu.config as jax_config
import tinyfaces_tpu.data as jax_data
import tinyfaces_tpu.utils.profiling as jax_profiling
import tinyfaces_tpu_torch.config as port_config
import tinyfaces_tpu_torch.data as port_data
import tinyfaces_tpu_torch.utils.profiling as port_profiling

ROOT = Path(__file__).resolve().parent.parent

_PROBE = """
import importlib, pkgutil, sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
sys.modules["tinyfaces_tpu"] = None  # and so does any import of the JAX package
sys.modules["PIL"] = None  # PIL is imported only where an image is decoded or drawn
import tinyfaces_tpu_torch
names = ["chip_smoke"] + [m.name for m in pkgutil.walk_packages(
    tinyfaces_tpu_torch.__path__, "tinyfaces_tpu_torch.")]
for name in names:
    importlib.import_module(name)
banned = ("jax", "tinyfaces_tpu")
assert not any(k.split(".")[0] in banned for k, v in sys.modules.items() if v is not None)
# the jpegdct wire's modules, and its decoder's bindings, load without PIL
from tinyfaces_tpu_torch.data import jpegdct
assert {"tinyfaces_tpu_torch.data.jpegdct", "tinyfaces_tpu_torch.data.dct_train",
        "tinyfaces_tpu_torch.ops.jpeg"} <= set(names)
assert jpegdct.jpeg_dims(open("tests/torch_jpeg/odd_197x263_q90.jpg", "rb").read()) == (197, 263)
# the accuracy path: grader, metrics, clustering and the tools
assert {"tinyfaces_tpu_torch.wider_eval", "tinyfaces_tpu_torch.metrics",
        "tinyfaces_tpu_torch.clustering.cluster", "tinyfaces_tpu_torch.ops.pilresize",
        "tinyfaces_tpu_torch.tools.cluster_templates", "tinyfaces_tpu_torch.tools.train_soak",
        "tinyfaces_tpu_torch.tools.parity_run", "tinyfaces_tpu_torch.tools.recall_bands",
        "tinyfaces_tpu_torch.tools.e2e_accuracy", "tinyfaces_tpu_torch.tools.ap_cost"} <= set(names)
# the grader grades a two-image tree (one perfect detection, one miss)
import pathlib, tempfile
from tinyfaces_tpu_torch import wider_eval
root = pathlib.Path(tempfile.mkdtemp())
(root / "gt.txt").write_text("0--Ev/a.jpg\\n1\\n10 10 40 40 0 0 0 0 0 0\\n"
                             "0--Ev/b.jpg\\n1\\n5 5 60 60 0 0 0 0 0 0\\n")
(root / "res" / "0--Ev").mkdir(parents=True)
(root / "res" / "0--Ev" / "a.txt").write_text("a.jpg\\n1\\n10 10 40 40 0.9\\n")
(root / "res" / "0--Ev" / "b.txt").write_text("b.jpg\\n1\\n300 300 20 20 0.5\\n")
scores = wider_eval.main([str(root / "gt.txt"), "--results-dir", str(root / "res")])
assert scores["all"] == 0.5 and scores["hard~"] == 0.5, scores
# the speed instruments: the benches and the tools
assert {"tinyfaces_tpu_torch.bench", "tinyfaces_tpu_torch.bench_train",
        "tinyfaces_tpu_torch.utils.instruments"} | {
    "tinyfaces_tpu_torch.tools." + t for t in (
        "train_bench", "profile_model", "device_profile", "pipeline_profile", "jpegdct_ceiling",
        "serving_bench", "eval_sweep_bench", "loader_bench", "wire_stats")} <= set(names)
# the folded stem, the yuv420 and jpegdct4 wires and the debug rendering run without PIL
import numpy as np
assert {"tinyfaces_tpu_torch.ops.stemfold", "tinyfaces_tpu_torch.data.debug"} <= set(names)
from tinyfaces_tpu_torch.data.targets import rgb_to_yuv420
y, u, v = rgb_to_yuv420(np.full((1, 4, 6, 3), 200, np.uint8))
assert y.shape == (1, 4, 6) and u.shape == v.shape == (1, 2, 3) and int(y[0, 0, 0]) == 200
assert hasattr(jpegdct.load(), "tf_jpeg_dct_pack_sparse")
wire = jpegdct.pack_dct_batch([open("tests/torch_jpeg/odd_197x263_q90.jpg", "rb").read()], 256, 320,
                              wire_version=4)["_wire"]
assert wire.shape == (1, jpegdct.wire_layout_v4(256, 320)["__total__"])
# multi-process training and evaluation, and the worker of their CPU tests
assert {"tinyfaces_tpu_torch.parallel.distributed", "tinyfaces_tpu_torch.parallel.mesh"} <= set(names)
importlib.import_module("tests.torch_dist_worker")
# spatial partitioning, the multi step's trainer, the last JAX tools
assert {"tinyfaces_tpu_torch.parallel.spatial"} | {"tinyfaces_tpu_torch.tools." + t for t in (
    "h2d_probe", "prewarm_cache", "kernel_selftest")} <= set(names)
from tinyfaces_tpu_torch.trainer import make_multi_train_step
assert not any(k.split(".")[0] in banned + ("PIL",) for k, v in sys.modules.items() if v is not None)
print(len(names))
"""


def test_port_imports_without_jax():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 70  # chip_smoke + every module of the package


@pytest.mark.parametrize("name", ["ReceptiveField", "DetectorConfig", "TrainConfig", "EvalConfig"])
def test_config_copies_match_jax(name):
    ours, theirs = getattr(port_config, name), getattr(jax_config, name)
    fields = lambda cls: [(f.name, f.type) for f in dataclasses.fields(cls)]  # noqa: E731
    assert fields(ours) == fields(theirs)
    assert dataclasses.asdict(ours()) == dataclasses.asdict(theirs())
    assert ours.__dataclass_params__.frozen and theirs.__dataclass_params__.frozen


def test_config_constants_and_templates_match_jax():
    for name in ("IMAGENET_MEAN", "IMAGENET_STD", "NUM_TEMPLATES", "NUM_OBJECTS"):
        assert getattr(port_config, name) == getattr(jax_config, name), name
    assert port_config.DetectorConfig().out_channels == jax_config.DetectorConfig().out_channels
    assert port_data.TEMPLATE_FILE.read_bytes() == jax_data.TEMPLATE_FILE.read_bytes()


def test_wire_and_stem_constants_match_jax():
    """The port's own copies of the JAX package's constants: the stem's
    phase matrix, the JPEG wires' cutoffs and v4 budgets, and the neutral
    YCbCr of the canvas fill."""
    from tinyfaces_tpu.data import jpegdct as jax_jpegdct
    from tinyfaces_tpu.ops import stemfold as jax_stemfold
    from tinyfaces_tpu_torch.data import jpegdct
    from tinyfaces_tpu_torch.ops import stemfold

    assert (stemfold.PHASE_G == jax_stemfold.PHASE_G).all()
    for name in ("Z_KEEP_Y", "Z_KEEP_C", "ESC_PER_BLOCK", "VALS_PER_BLOCK_Y", "VALS_PER_BLOCK_C"):
        assert getattr(jpegdct, name) == getattr(jax_jpegdct, name), name
    assert (jpegdct.ZIGZAG == jax_jpegdct.ZIGZAG).all()
    assert jpegdct._neutral_ycc() == jax_jpegdct._neutral_ycc()


def test_step_timer_matches_jax_on_a_scripted_clock(monkeypatch):
    results = []
    for mod in (port_profiling, jax_profiling):
        clock = iter([0.0, 0.5, 0.75, 1.5, 1.5, 2.25, 3.0, 3.5])
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(clock))
        timer = mod.StepTimer(warmup=2)
        stats = [(timer.measured_steps, timer.elapsed, timer.steps_per_sec, timer.items_per_sec)]
        for items in (3, 4, 5, 6, 7, 8):
            timer.tick(items=items)
            stats.append((timer.measured_steps, timer.elapsed, timer.steps_per_sec,
                          timer.items_per_sec))
        timer.reset()
        timer.tick(1)
        timer.tick(2)
        stats.append((timer.measured_steps, timer.elapsed, timer.items_per_sec))
        results.append(stats)
    assert results[0] == results[1]
    assert results[0][6] == (4, 1.75, 4 / 1.75, (5 + 6 + 7 + 8) / 1.75)
    assert results[0][7] == (0, 0.0, 0.0)  # after reset, two ticks are still warmup
