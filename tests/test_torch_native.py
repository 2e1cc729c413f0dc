"""The port's C++ augmentation engine and loaders against the JAX package's.

The port builds its own copy of the engine (csrc/tinyfaces_native.cpp) with
the JAX package's compiler flags; from the same seeds both give the same
bytes, per sample and per batch, and the same GT-overflow counts. The first
batch of each port loader (C++ engine and Python augmentation) equals the
JAX loader's, and one train step from the first C++-engine batch matches
the JAX train step at tests/test_torch_trainer.py's tolerances. A failed
build raises and nothing falls back to the Python path.

`jax_native_library` is the shared module fixture of every port test that
calls into the JAX package's C++ library (native/libtinyfaces_native.so):
it builds that library once under a file lock, through a temporary file
moved into place, and clears the JAX loader's failure latch (see its
docstring).
"""

import ctypes
import fcntl
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_trainer import TC, TINY_STAGES, _step_draws
from tests.test_torch_wider_train import CFG, JAX_CFG, random_boxes, write_train_tree
from tinyfaces_tpu.data import loader as jax_loader
from tinyfaces_tpu.data import native as jax_native
from tinyfaces_tpu.data import overflow as jax_overflow
from tinyfaces_tpu.data import wider_face as jax_wf
from tinyfaces_tpu.models.detection import TinyFacesDetector as JaxDetector
from tinyfaces_tpu.models.detection import init_model as jax_init_model
from tinyfaces_tpu.trainer import create_train_state
from tinyfaces_tpu.trainer import make_optimizer as jax_make_optimizer
from tinyfaces_tpu.trainer import make_train_step as jax_make_train_step
from tinyfaces_tpu_torch.data import load_templates, loader, native, overflow
from tinyfaces_tpu_torch.data import wider_face as wf
from tinyfaces_tpu_torch.models.detection import TinyFacesDetector
from tinyfaces_tpu_torch.trainer import make_lr_schedule, make_optimizer, train_step
from tinyfaces_tpu_torch.utils import cuda_build
from tinyfaces_tpu_torch.utils.convert import from_jax, to_jax

BUILD_LOCK = Path(__file__).resolve().parent.parent / "build" / "torch_ext" / "jax_native.lock"


def _abi_of(path: Path):
    """tf_version() of the library at `path`, read in a child process (no
    handle of a partial or stale file stays mapped here), or None."""
    probe = ("import ctypes, sys; lib = ctypes.CDLL(sys.argv[1]); "
             "lib.tf_version.restype = ctypes.c_int; print(lib.tf_version())")
    out = subprocess.run([sys.executable, "-c", probe, str(path)], capture_output=True,
                         text=True, timeout=60)
    return int(out.stdout) if out.returncode == 0 and out.stdout.strip() else None


def build_jax_native() -> ctypes.CDLL:
    """The JAX package's C++ library, loaded in this process.

    The JAX loader (tinyfaces_tpu/data/native.py) builds the library with
    `make -C native` in whichever process asks first, the Makefile writes
    the .so in place, and any failure latches `_load_failed` for the rest of
    the process. Test modules ask at import (skipif), so the pytest-xdist
    workers of one run build it side by side, and a worker that maps a
    half-written file latches the failure. Here the build runs under an
    exclusive lock on a file in build/torch_ext/ (gitignored), with the
    Makefile's own recipe and flags into a temporary target, and is moved
    into place with os.replace, so no process ever reads a partial file
    from this side; an existing library is kept when a child process loads
    it with the current ABI version. Then the latch is cleared and the
    library loaded."""
    so = jax_native._LIB_PATH
    BUILD_LOCK.parent.mkdir(parents=True, exist_ok=True)
    with open(BUILD_LOCK, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if _abi_of(so) != jax_native._ABI_VERSION:
            tmp = so.parent / f".{so.name}.{os.getpid()}.tmp"
            try:
                subprocess.run(["make", "-C", str(so.parent), f"TARGET={tmp.name}"], check=True,
                               capture_output=True, timeout=600)
                os.replace(tmp, so)
            finally:
                tmp.unlink(missing_ok=True)
        if jax_native._lib is None:
            jax_native._load_failed = False
        assert jax_native.is_available(), "the JAX package's native library does not load"
    return jax_native._lib


@pytest.fixture(scope="module", autouse=True)
def jax_native_library():
    """build_jax_native() before a module's tests; import it into a test
    module to make it that module's fixture too."""
    return build_jax_native()


def _inputs(rng, b):
    images, boxes = [], []
    for _ in range(b):
        h, w = int(rng.integers(40, 400)), int(rng.integers(40, 400))
        images.append(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        n = int(rng.choice([0, 3, 30]))
        boxes.append(random_boxes(rng, h, w, n, hi=min(h, w) - 2).astype(np.float32))
    return images, boxes


def _assert_same(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in got:
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else np.asarray(got[k])
        np.testing.assert_array_equal(g, np.asarray(want[k]), err_msg=k)
        assert g.dtype == np.asarray(want[k]).dtype, k


@pytest.mark.parametrize("entry", ["sample", "batch"])
def test_engine_is_bit_identical_to_jax(entry):
    assert jax_native.is_available()
    overflow.reset()
    jax_overflow.reset()
    samples = native.counters["samples"]
    args = (CFG.input_size, CFG.neg_thresh, CFG.max_gt)
    rng = np.random.default_rng(11)
    with pytest.warns(RuntimeWarning, match="GT truncation"):
        for seed in [i * (2**63 // 12) for i in range(12)]:  # up to the top bit of the uint64 seed
            images, boxes = _inputs(rng, 5)
            if entry == "sample":
                for im, bx in zip(images, boxes):
                    _assert_same(native.native_augment_sample(im, bx, *args, seed=seed),
                                 jax_native.native_augment_sample(im, bx, *args, seed=seed))
            else:
                _assert_same(native.native_augment_batch(images, boxes, *args, seed=seed, n_threads=3),
                             jax_native.native_augment_batch(images, boxes, *args, seed=seed,
                                                             n_threads=3))
    assert native.counters["samples"] - samples == 60
    assert overflow.snapshot() == jax_overflow.snapshot()
    assert overflow.snapshot()["dropped_boxes"] > 0


def _datasets(root, seed=3):
    ann = write_train_tree(root)
    templates = load_templates()
    return (wf.WIDERFace(ann, templates, cfg=CFG, dataset_root=root, seed=seed),
            jax_wf.WIDERFace(ann, templates, cfg=JAX_CFG, dataset_root=root, seed=seed))


def _first_batches(root, engine):
    ours, theirs = _datasets(root)
    if engine == "native":
        cls, jax_cls = loader.NativePrefetchLoader, jax_loader.NativePrefetchLoader
    else:
        cls, jax_cls = loader.PrefetchLoader, jax_loader.PrefetchLoader
    got = next(iter(cls(ours, 2, device="cpu", workers=2, seed=5, epoch=1)))
    want = next(iter(jax_cls(theirs, 2, workers=2, seed=5, epoch=1)))
    assert ours.epoch == theirs.epoch == 1  # both loaders rebased the augmentation stream
    return got, want


@pytest.mark.parametrize("engine", ["native", "python"])
def test_first_batch_matches_jax_loader(tmp_path, engine):
    samples = native.counters["samples"]
    got, want = _first_batches(tmp_path, engine)
    _assert_same(got, want)
    assert (native.counters["samples"] > samples) == (engine == "native")


def test_one_step_from_first_batch_matches_jax(tmp_path):
    got, want = _first_batches(tmp_path, "native")
    _assert_same(got, want)
    templates = load_templates()
    jmodel = JaxDetector(stage_sizes=TINY_STAGES)
    params, stats = jax.device_get(jax_init_model(jmodel, jax.random.PRNGKey(2), CFG.input_size))
    tx = jax_make_optimizer(TC, steps_per_epoch=10)
    key = jax.random.PRNGKey(4)
    jstate, jlb = jax_make_train_step(jmodel, tx, JAX_CFG, templates)(
        create_train_state(jmodel, params, stats, tx),
        {k: jnp.asarray(v) for k, v in want.items()}, key)

    model = TinyFacesDetector(stage_sizes=TINY_STAGES)
    model.load_state_dict(from_jax(params, stats))
    lb = train_step(model, make_optimizer(model, TC), got, None, cfg=CFG,
                    templates=torch.tensor(templates, dtype=torch.float32),
                    lr=make_lr_schedule(TC, 10)(0), draws=_step_draws(key, 0, 2))
    for a, b in zip(lb, jlb):
        np.testing.assert_allclose(a.item(), float(b), rtol=1e-4)
    new_params, _ = to_jax(model.state_dict())
    want_params = jax.device_get(jstate.params)
    scale = max(np.abs(w).max() for w in jax.tree_util.tree_leaves(want_params))
    for a, b in zip(jax.tree_util.tree_leaves(new_params), jax.tree_util.tree_leaves(want_params)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4 * scale)


def test_failed_build_raises_without_fallback(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "tinyfaces_native.cpp").write_text("#error broken engine source\n")
    monkeypatch.setattr(cuda_build, "CSRC", src)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda_build, "_loaded", {})
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="broken engine source"):
        native.load()
    img = np.zeros((64, 64, 3), np.uint8)
    with pytest.raises(RuntimeError, match="broken engine source"):
        native.native_augment_sample(img, np.zeros((0, 4), np.float32), (32, 32), 0.3, 4, seed=0)
    ours, _ = _datasets(tmp_path)
    with pytest.raises(RuntimeError, match="broken engine source"):
        next(iter(loader.NativePrefetchLoader(ours, 2, device="cpu", workers=2)))
    assert "broken engine source" in (tmp_path / "build" / "tinyfaces_native.log").read_text()


@pytest.mark.parametrize("script", ["echo 'no -Q here' >&2; exit 1", "exit 0"])
def test_unknown_target_features_raise(tmp_path, monkeypatch, script):
    """-march=native ties a build to its host, so a compiler that does not
    report the host's target features (it fails the query, or answers
    nothing) builds nothing: the library's hash key would miss the CPU."""
    cxx = tmp_path / "cxx"
    cxx.write_text(f"#!/bin/sh\n{script}\n")
    cxx.chmod(0o755)
    monkeypatch.setenv("CXX", str(cxx))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda_build, "_loaded", {})
    with pytest.raises(RuntimeError, match="target features"):
        cuda_build.load_host_library("tinyfaces_native")
    assert not (tmp_path / "build").exists()


def test_the_shared_build_clears_a_latched_jax_loader(tmp_path, monkeypatch):
    """The fault build_jax_native repairs, on a copy of native/: a library
    not yet written (as one xdist worker's `make` leaves it for another)
    is newer than its sources, so the JAX loader's `make` does nothing, the
    load fails and latches; build_jax_native rebuilds it through a
    temporary file and the loader then loads it."""
    native_dir = tmp_path / "native"
    native_dir.mkdir()
    for name in ("Makefile", "tinyfaces_native.cpp", "jpeg_dct.cpp"):
        (native_dir / name).write_bytes((jax_native._NATIVE_DIR / name).read_bytes())
    so = native_dir / jax_native._LIB_PATH.name
    # created by the linker, nothing written yet (a file cut off inside its
    # ELF segments can kill the process that maps it with SIGBUS instead)
    so.write_bytes(b"")
    monkeypatch.setattr(jax_native, "_LIB_PATH", so)
    monkeypatch.setattr(jax_native, "_NATIVE_DIR", native_dir)
    monkeypatch.setattr(jax_native, "_lib", None)
    monkeypatch.setattr(jax_native, "_load_failed", False)
    monkeypatch.setattr(sys.modules[__name__], "BUILD_LOCK", tmp_path / "build" / "lock")
    assert not jax_native.is_available()
    assert not jax_native.is_available()  # latched: not even tried again
    lib = build_jax_native()
    assert jax_native.is_available() and jax_native._lib is lib
    assert _abi_of(so) == jax_native._ABI_VERSION
    assert not list(native_dir.glob(".*.tmp"))
