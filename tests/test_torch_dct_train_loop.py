"""The port's `jpegdct` train wire through the loaders, one train step and
the CLI (PrefetchLoader / NativePrefetchLoader pack="jpegdct", main.py
--transfer jpegdct) against the JAX package's on the CPU: the loaders'
first batch equals the JAX loader's, and one train step from it matches
the JAX step at rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_main import FACES, SIZES, _argv, _run
from tests.test_torch_native import _assert_same, jax_native_library  # noqa: F401
from tests.test_torch_trainer import TC, TINY_STAGES, _step_draws
from tests.test_torch_wider_train import CFG, JAX_CFG, write_train_tree
from tinyfaces_tpu.data import loader as jax_loader
from tinyfaces_tpu.data import wider_face as jax_wf
from tinyfaces_tpu.models.detection import TinyFacesDetector as JaxDetector
from tinyfaces_tpu.models.detection import init_model as jax_init_model
from tinyfaces_tpu.trainer import create_train_state
from tinyfaces_tpu.trainer import make_optimizer as jax_make_optimizer
from tinyfaces_tpu.trainer import make_train_step as jax_make_train_step
from tinyfaces_tpu_torch.data import load_templates, loader, native
from tinyfaces_tpu_torch.data import wider_face as wf
from tinyfaces_tpu_torch.models.detection import TinyFacesDetector
from tinyfaces_tpu_torch.trainer import make_lr_schedule, make_optimizer, train_step
from tinyfaces_tpu_torch.utils.convert import from_jax

torch.set_num_threads(2)


def _datasets(root):
    ann = write_train_tree(root)
    templates = load_templates()
    return (wf.WIDERFace(ann, templates, cfg=CFG, dataset_root=root, seed=3),
            jax_wf.WIDERFace(ann, templates, cfg=JAX_CFG, dataset_root=root, seed=3))


def _first_batches(root, engine):
    ours, theirs = _datasets(root)
    cls = loader.NativePrefetchLoader if engine == "native" else loader.PrefetchLoader
    samples = native.counters["samples"]
    got = next(iter(cls(ours, 2, device="cpu", workers=2, seed=5, epoch=1, pack="jpegdct")))
    want = next(iter(jax_loader.PrefetchLoader(theirs, 2, workers=2, seed=5, epoch=1, pack="jpegdct")))
    assert native.counters["samples"] == samples  # no pixels for the C++ engine
    assert len(ours._dct_cache._store) >= 2  # decoded once, cached
    return got, want


@pytest.mark.parametrize("engine", ["native", "python"])
def test_first_batch_matches_jax_loader(tmp_path, engine):
    got, want = _first_batches(tmp_path, engine)
    _assert_same(got, want)
    assert got["dct_wire"].shape == (2, 713992)


def test_one_step_from_first_batch_matches_jax(tmp_path):
    got, want = _first_batches(tmp_path, "native")
    templates = load_templates()
    jmodel = JaxDetector(stage_sizes=TINY_STAGES)
    params, stats = jax.device_get(jax_init_model(jmodel, jax.random.PRNGKey(2), CFG.input_size))
    tx = jax_make_optimizer(TC, steps_per_epoch=10)
    key = jax.random.PRNGKey(4)
    jstate, jlb = jax_make_train_step(jmodel, tx, JAX_CFG, templates)(
        create_train_state(jmodel, params, stats, tx), {k: jnp.asarray(v) for k, v in want.items()}, key)
    model = TinyFacesDetector(stage_sizes=TINY_STAGES)
    model.load_state_dict(from_jax(params, stats))
    lb = train_step(model, make_optimizer(model, TC), got, None, cfg=CFG,
                    templates=torch.tensor(templates, dtype=torch.float32),
                    lr=make_lr_schedule(TC, 10)(0), draws=_step_draws(key, 0, 2))
    for a, b in zip(lb, jlb):
        np.testing.assert_allclose(a.item(), float(b), rtol=1e-4)


def test_loader_refuses_unported_packs():
    """Every pack of the JAX loader is taken (yuv420: tests/test_torch_
    yuv420.py); an unknown one is refused."""
    assert loader.PrefetchLoader([], 2, device="cpu", pack="yuv420").pack == "yuv420"
    with pytest.raises(ValueError, match="unknown pack"):
        loader.PrefetchLoader([], 2, device="cpu", pack="png")


def test_cli_trains_on_the_dct_wire(tmp_path, monkeypatch):
    tree = write_train_tree(tmp_path / "data", sizes=SIZES, faces=FACES)
    samples = native.counters["samples"]
    trainer, run_dir = _run(tmp_path, monkeypatch, "dct",
                            _argv(tree, "--transfer", "jpegdct", "--epochs", "2", "--save-every", "2"))
    assert trainer.transfer == "jpegdct" and trainer.step == 4 and trainer.skipped_steps == 0
    assert np.isfinite(trainer.class_average.average) and np.isfinite(trainer.reg_average.average)
    assert native.counters["samples"] == samples  # every sample came over the dct wire
    assert (run_dir / "weights" / "checkpoint_2").is_file()
