"""K train steps per call (trainer.make_multi_train_step) against K plain
steps and against the JAX package's make_multi_train_step, on the CPU.

On the CPU the multi step is a plain loop of train_step, with each step's
draws made from step_generator(seed, step), as Trainer's steps make them:
against K port steps it is bit-equal (losses, parameters, BN statistics
and momentum). Against the JAX multi step (lax.scan over stacked batches,
draws from fold_in(key, step)), fed the JAX draws, it holds
tests/test_trainer.py's tolerances: the last loss within rtol 1e-3 and the
score_res3 kernel within atol 1e-5. On a card the steps are replays of one
captured CUDA graph; chip_smoke.py holds them bit-equal to plain steps
there.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_trainer import CFG, TC, TINY_STAGES, _batch, _dataset, _port_model, _step_draws
from tinyfaces_tpu.models.detection import TinyFacesDetector as JaxDetector
from tinyfaces_tpu.models.detection import init_model as jax_init_model
from tinyfaces_tpu.trainer import create_train_state
from tinyfaces_tpu.trainer import make_multi_train_step as jax_make_multi_train_step
from tinyfaces_tpu.trainer import make_optimizer as jax_make_optimizer
from tinyfaces_tpu_torch.data import load_templates
from tinyfaces_tpu_torch.models.detection import TinyFacesDetector
from tinyfaces_tpu_torch.parallel import distributed
from tinyfaces_tpu_torch.tools import train_bench
from tinyfaces_tpu_torch.trainer import (make_lr_schedule, make_multi_train_step, make_optimizer,
                                         step_draws, step_generator, train_step)
from tinyfaces_tpu_torch.utils.convert import from_jax, to_jax

torch.set_num_threads(2)

TEMPLATES = torch.tensor(load_templates(), dtype=torch.float32)
N_ANCHORS = CFG.heatmap_size[0] * CFG.heatmap_size[1] * CFG.num_templates


def _stacked(batches):
    return {k: torch.stack([b[k] for b in batches]) for k in batches[0]}


def _state(model, opt):
    momentum = [opt.state[p]["momentum_buffer"] for g in opt.param_groups for p in g["params"]]
    return [*model.state_dict().values(), *momentum]


def test_multi_step_equals_plain_steps():
    """K=3 from step 19 of a schedule that steps down after 20: the third
    step runs at the next rate, as a plain step there does."""
    items = _dataset(6, seed=2)
    batches = [_batch(items[2 * i:2 * i + 2]) for i in range(3)]
    schedule = make_lr_schedule(TC, 1)
    assert schedule(19) != schedule(20)
    plain = _port_model()
    multi_model = copy.deepcopy(plain)
    opt_a, opt_b = make_optimizer(plain, TC), make_optimizer(multi_model, TC)
    want = [train_step(plain, opt_a, b, step_generator(7, 19 + k, "cpu"), cfg=CFG,
                       templates=TEMPLATES, lr=schedule(19 + k)) for k, b in enumerate(batches)]
    got = make_multi_train_step(multi_model, opt_b, CFG, TEMPLATES, schedule)(
        _stacked(batches), 7, 19)
    assert got.total.shape == (3,)
    for g, w in zip(got, zip(*want)):
        assert torch.equal(g, torch.stack(w))
    for a, b in zip(_state(multi_model, opt_b), _state(plain, opt_a)):
        assert torch.equal(a, b)


def test_step_draws_are_the_plain_steps_draws():
    """The draws the multi step makes outside a CUDA graph (step_draws) are
    the ones train_step makes inside from the same generator: fed to one
    step, they give that step bit for bit."""
    batch = _batch(_dataset(2, seed=4))
    a, b = _port_model(), _port_model()
    opt_a, opt_b = make_optimizer(a, TC), make_optimizer(b, TC)
    want = train_step(a, opt_a, batch, step_generator(3, 5, "cpu"), cfg=CFG, templates=TEMPLATES,
                      lr=0.1)
    draws = step_draws(step_generator(3, 5, "cpu"), 2, N_ANCHORS)
    assert draws["seeds"].dtype == torch.int32 and draws["uniforms"][0].shape == (2, N_ANCHORS)
    got = train_step(b, opt_b, batch, None, cfg=CFG, templates=TEMPLATES, lr=0.1, draws=draws)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for x, y in zip(_state(a, opt_a), _state(b, opt_b)):
        assert torch.equal(x, y)


def test_multi_step_matches_jax_multi_train_step():
    """tests/test_trainer.py::test_multi_step_scan_matches_sequential's
    check, the port against the JAX scan, both from the same weights."""
    jmodel = JaxDetector(stage_sizes=TINY_STAGES)
    params, stats = jax.device_get(jax_init_model(jmodel, jax.random.PRNGKey(0), CFG.input_size))
    tx = jax_make_optimizer(TC, steps_per_epoch=10)
    items = _dataset(6, seed=1)
    batches = [{k: np.stack([it[k] for it in items[2 * i:2 * i + 2]]) for k in items[0]}
               for i in range(3)]
    key = jax.random.PRNGKey(9)
    jstate, jlbs = jax_make_multi_train_step(jmodel, tx, CFG, load_templates())(
        create_train_state(jmodel, params, stats, tx),
        {k: jnp.asarray(np.stack([b[k] for b in batches])) for k in batches[0]}, key)

    model = TinyFacesDetector(stage_sizes=TINY_STAGES)
    model.load_state_dict(from_jax(params, stats))
    multi = make_multi_train_step(model, make_optimizer(model, TC), CFG, TEMPLATES,
                                  make_lr_schedule(TC, 10))
    lbs = multi(_stacked([{k: torch.from_numpy(v) for k, v in b.items()} for b in batches]), 0, 0,
                draws=[_step_draws(key, k, 2) for k in range(3)])
    assert lbs.total.shape == jlbs.total.shape == (3,)
    np.testing.assert_allclose(lbs.total[-1].item(), float(jlbs.total[-1]), rtol=1e-3)
    got = to_jax(model.state_dict())[0]["score_res3"]["kernel"]
    want = jax.device_get(jstate.params)["score_res3"]["kernel"]
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_multi_step_refuses_a_process_group(monkeypatch):
    model = _port_model()
    multi = make_multi_train_step(model, make_optimizer(model, TC), CFG, TEMPLATES,
                                  make_lr_schedule(TC, 10))
    monkeypatch.setattr(distributed, "world", lambda: 2)
    with pytest.raises(ValueError, match="one process"):
        multi(_stacked([_batch(_dataset(2))]), 0, 0)


def test_train_bench_multi_on_the_cpu(capsys, monkeypatch):
    """`train_bench --multi 2` prints the JAX tool's scan line and the plain
    step's line; every step's loss is finite."""
    for flags in (torch.backends.cudnn, torch.backends.cuda.matmul):  # main sets them
        monkeypatch.setattr(flags, "allow_tf32", flags.allow_tf32)
    out = train_bench.main(["--device", "cpu", "--batch", "2", "--iters", "1", "--multi", "2"],
                           stage_sizes=(1, 1, 1))
    printed = capsys.readouterr().out
    assert "train_step[fp32 scan x2] batch=2:" in printed and "train_step[fp32] batch=2:" in printed
    multi = out["multi"]
    assert multi["k"] == 2 and len(multi["losses"]) == 4 and np.isfinite(multi["losses"]).all()
    assert multi["ms_per_step"] > 0 and multi["k1_launches"] == 0  # the CPU takes K1's twin
    assert len(out["losses"]) == 2
