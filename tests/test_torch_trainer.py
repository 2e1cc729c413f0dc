"""The port's trainer against the JAX package's on the CPU.

One step from the same weights, batch and random draws (the JAX step's
tie-break noise and sampling uniforms, rebuilt from its keys) must give the
same loss within rtol 1e-4 and the same updated parameters and BN statistics
within rtol 1e-4 of the model's weight scale. The float32 gradients of the
backbone are ill-conditioned at this tiny size (train-mode BN backward
cancels; the port's own float32 and float64 gradients differ by up to 2%),
so the backward pass itself is held to the JAX package in float64, where
the two agree to 1e-6. A batch mean of near-zero-mean activations is a
cancelling float32 sum over B*H*W values of unit scale, so running
statistics get atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_loss import jax_uniforms
from tinyfaces_tpu.config import DetectorConfig, TrainConfig
from tinyfaces_tpu.models.detection import TinyFacesDetector as JaxDetector
from tinyfaces_tpu.models.detection import init_model as jax_init_model
from tinyfaces_tpu.trainer import create_train_state
from tinyfaces_tpu.trainer import make_lr_schedule as jax_make_lr_schedule
from tinyfaces_tpu.trainer import make_optimizer as jax_make_optimizer
from tinyfaces_tpu.trainer import make_train_step as jax_make_train_step
from tinyfaces_tpu_torch.data import load_templates
from tinyfaces_tpu_torch.data.loader import PrefetchLoader
from tinyfaces_tpu_torch.models.detection import TinyFacesDetector, init_model
from tinyfaces_tpu_torch.trainer import (
    GROUP_LR_FACTORS,
    Trainer,
    load_checkpoint,
    make_lr_schedule,
    make_optimizer,
    save_checkpoint,
    train_step,
)
from tinyfaces_tpu_torch.utils.convert import from_jax, to_jax

torch.set_num_threads(2)

TINY_STAGES = (1, 1, 1)
CFG = DetectorConfig(input_size=(128, 128), heatmap_size=(16, 16), max_gt=8)
TC = TrainConfig(batch_size=2, workers=2)


def _sample(rng, cfg):
    n = int(rng.integers(1, cfg.max_gt + 1))
    xy = rng.uniform(0, 80, (n, 2))
    wh = rng.uniform(10, 45, (n, 2))
    gt = np.zeros((cfg.max_gt, 4), np.float32)
    gt[:n] = np.concatenate([xy, xy + wh], 1)
    return {
        "image": rng.integers(0, 255, (*cfg.input_size, 3), dtype=np.uint8),
        "gt_boxes": gt,
        "gt_valid": np.arange(cfg.max_gt) < n,
        "paste_box": np.array([0, 0, 128, 128], np.float32),
        "flip": bool(rng.integers(0, 2)),
    }


def _dataset(n, seed=0):
    rng = np.random.default_rng(seed)
    return [_sample(rng, CFG) for _ in range(n)]


def _batch(items):
    return {k: torch.from_numpy(np.stack([it[k] for it in items])) for k in items[0]}


def _port_model(seed=0):
    return init_model(TinyFacesDetector(stage_sizes=TINY_STAGES), torch.Generator().manual_seed(seed))


def _step_draws(key, step, b):
    """The draws the JAX train step makes from `key` at `step`."""
    k_assign, k_sample = jax.random.split(jax.random.fold_in(key, step))
    vsy, vsx = CFG.heatmap_size
    shape = (vsy, vsx, CFG.num_templates, CFG.max_gt)
    noise = np.stack([np.asarray(1e-6 * jax.random.uniform(k, shape))
                      for k in jax.random.split(k_assign, b)])
    return {"noise": torch.from_numpy(noise),
            "uniforms": jax_uniforms(k_sample, b, vsy * vsx * CFG.num_templates)}


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_one_step_matches_jax_train_step():
    templates = load_templates()
    jmodel = JaxDetector(stage_sizes=TINY_STAGES)
    params, stats = jax.device_get(jax_init_model(jmodel, jax.random.PRNGKey(0), CFG.input_size))
    tx = jax_make_optimizer(TC, steps_per_epoch=10)
    state = create_train_state(jmodel, params, stats, tx)
    items = _dataset(2, seed=1)
    key = jax.random.PRNGKey(5)
    jstate, jlb = jax_make_train_step(jmodel, tx, CFG, templates)(
        state, {k: jnp.asarray(np.stack([it[k] for it in items])) for k in items[0]}, key)

    model = TinyFacesDetector(stage_sizes=TINY_STAGES)
    model.load_state_dict(from_jax(params, stats))
    opt = make_optimizer(model, TC)
    lb = train_step(model, opt, _batch(items), None, cfg=CFG,
                    templates=torch.tensor(templates, dtype=torch.float32),
                    lr=make_lr_schedule(TC, 10)(0), draws=_step_draws(key, 0, 2))

    for got, want in zip(lb, jlb):
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-4)
    new_params, new_stats = to_jax(model.state_dict())
    want_params, want_stats = jax.device_get((jstate.params, jstate.batch_stats))
    scale = max(np.abs(w).max() for w in jax.tree_util.tree_leaves(want_params))
    for a, b in zip(jax.tree_util.tree_leaves(new_params), jax.tree_util.tree_leaves(want_params)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4 * scale)
    for a, b in zip(jax.tree_util.tree_leaves(new_stats), jax.tree_util.tree_leaves(want_stats)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
    # The updates themselves agree (lr * grad is far below rtol 1e-4 of a
    # weight, so compare the deltas of the heads on their own scale).
    for head in ("score_res3", "score_res4"):
        _close(new_params[head]["kernel"] - params[head]["kernel"],
               want_params[head]["kernel"] - params[head]["kernel"])


def test_float64_gradients_match_jax():
    """Same weights, images, labels and sampling draws in float64: every
    parameter gradient of the port equals the JAX package's."""
    from tinyfaces_tpu.loss import detection_loss as jax_detection_loss
    from tinyfaces_tpu_torch.data.targets import build_targets
    from tinyfaces_tpu_torch.loss import detection_loss

    templates = torch.tensor(load_templates(), dtype=torch.float32)
    params, stats = jax.device_get(jax_init_model(JaxDetector(stage_sizes=TINY_STAGES),
                                                  jax.random.PRNGKey(1), CFG.input_size))
    images, cls, reg = build_targets(_batch(_dataset(2, seed=2)), templates,
                                     torch.Generator().manual_seed(0), CFG)
    key = jax.random.PRNGKey(8)
    with jax.enable_x64(True):
        f64 = lambda tree: jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64), tree)  # noqa: E731
        jmodel = JaxDetector(stage_sizes=TINY_STAGES, dtype=jnp.float64)

        def jax_loss(p):
            out, _ = jmodel.apply({"params": p, "batch_stats": f64(stats)},
                                  jnp.asarray(images.double().numpy()), train=True,
                                  mutable=["batch_stats"])
            return jax_detection_loss(out.astype(jnp.float64), jnp.asarray(cls.double().numpy()),
                                      jnp.asarray(reg.double().numpy()), key).total

        want = from_jax(jax.device_get(jax.jit(jax.grad(jax_loss))(f64(params))), stats)
        uniforms = tuple(u.double() for u in jax_uniforms(key, 2, 16 * 16 * 25))

    model = TinyFacesDetector(stage_sizes=TINY_STAGES)
    model.load_state_dict(from_jax(params, stats))
    model.double().train()
    detection_loss(model(images.double()), cls.double(), reg.double(), None,
                   uniforms=uniforms).total.backward()
    n = 0
    for name, p in model.named_parameters():
        if p.requires_grad:
            w = want[name].double().numpy()
            np.testing.assert_allclose(p.grad.numpy(), w, rtol=0, atol=1e-6 * np.abs(w).max(),
                                       err_msg=name)
            n += 1
    assert n == len([p for p in model.parameters() if p.requires_grad])


def test_lr_staircase_matches_jax():
    ours = make_lr_schedule(TC, steps_per_epoch=10)  # decays every 200 steps
    theirs = jax_make_lr_schedule(TC, steps_per_epoch=10)
    for step in (0, 1, 199, 200, 201, 399, 400, 599, 600, 799):
        np.testing.assert_allclose(ours(step), float(theirs(step)), rtol=1e-6)
    assert ours(600) == pytest.approx(TC.lr * 1e-3)


def test_upsample_frozen_and_group_lrs():
    model = _port_model()
    opt = make_optimizer(model, TC)
    by_name = {g["name"]: g for g in opt.param_groups}
    assert set(by_name) == {k for k, f in GROUP_LR_FACTORS.items() if f}
    grouped = {id(p) for g in opt.param_groups for p in g["params"]}
    trainable = {id(p) for p in model.parameters() if p.requires_grad}
    assert grouped == trainable
    assert id(model.score4_upsample.weight) not in grouped

    up = model.score4_upsample.weight.clone()
    old = {k: v.clone() for k, v in model.state_dict().items()}
    lb = train_step(model, opt, _batch(_dataset(2)), torch.Generator().manual_seed(0), cfg=CFG,
                    templates=torch.tensor(load_templates(), dtype=torch.float32), lr=1e-3)
    assert torch.isfinite(lb.total)
    assert torch.equal(model.score4_upsample.weight, up)
    for name, factor in GROUP_LR_FACTORS.items():
        if factor:
            assert by_name[name]["lr"] == pytest.approx(1e-3 * factor)
    new = model.state_dict()
    for prefix in ("model.", "score_res3.", "score_res4."):
        assert any(not torch.equal(new[k], old[k]) for k in new if k.startswith(prefix)), prefix


def test_nan_guard_drops_poisoned_update():
    templates = torch.tensor(load_templates(), dtype=torch.float32)
    batch = _batch(_dataset(2))

    def run(nan_guard):
        model = _port_model()
        with torch.no_grad():
            model.score_res3.weight[0, 0, 0, 0] = float("nan")
        before = {k: v.clone() for k, v in model.state_dict().items()}
        opt = make_optimizer(model, TC)
        lb = train_step(model, opt, batch, torch.Generator().manual_seed(0), cfg=CFG,
                        templates=templates, lr=1e-3, nan_guard=nan_guard)
        return before, model, opt, lb

    before, model, opt, lb = run(True)
    assert not torch.isfinite(lb.total)
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), before[k].numpy(), err_msg=k)
    for p in opt.param_groups[0]["params"]:
        assert not opt.state[p]["momentum_buffer"].any()

    _, model, _, _ = run(False)
    assert not all(torch.isfinite(p).all() for p in model.model.parameters())


def test_checkpoint_round_trip(tmp_path):
    data = _dataset(4)
    a = Trainer(_port_model(), CFG, TC, load_templates(), device="cpu", seed=3)
    a.setup(steps_per_epoch=2)
    a.train_step(_batch(data[:2]))
    path = save_checkpoint(a.model, a.opt, a.step, epoch=7, batch_size=2,
                           save_path=tmp_path, filename="ck")
    payload = load_checkpoint(path)
    assert payload["epoch"] == 7 and payload["step"] == 1 and payload["batch_size"] == 2

    b = Trainer(_port_model(seed=9), CFG, TC, load_templates(), device="cpu", seed=3)
    b.setup(steps_per_epoch=2)
    b.restore(payload)
    for k, v in a.model.state_dict().items():
        assert torch.equal(v, b.model.state_dict()[k]), k
    la, lb = a.train_step(_batch(data[2:])), b.train_step(_batch(data[2:]))
    for x, y in zip(la, lb):
        assert x.item() == y.item()


def test_train_epoch_runs_two_steps(capsys):
    trainer = Trainer(_port_model(), CFG, TC, load_templates(), device="cpu", seed=0,
                      augment="python")
    trainer.setup(steps_per_epoch=2)
    timer = trainer.train_epoch(_dataset(5), epoch=0)  # drop_last: 2 batches of 2
    out = capsys.readouterr().out
    assert "Epoch: [0][0/2]" in out and "Epoch: [0][1/2]" in out and "images/sec" in out
    assert trainer.step == 2 and timer.measured_steps == 1
    assert np.isfinite(trainer.class_average.average) and trainer.skipped_steps == 0
    assert trainer.class_average.num_averaged == 4


def test_loader_order_is_a_function_of_seed_and_epoch():
    data = _dataset(7)
    a = PrefetchLoader(data, 2, device="cpu", workers=2, seed=1, epoch=3)
    b = PrefetchLoader(data, 2, device="cpu", workers=3, seed=1, epoch=3)
    np.testing.assert_array_equal(a.order(3), b.order(3))
    assert not np.array_equal(a.order(3), a.order(4))
    batches = list(a)
    assert len(batches) == len(a) == 3  # drop_last
    first = a.order(3)[:2]
    np.testing.assert_array_equal(batches[0]["image"].numpy(),
                                  np.stack([data[i]["image"] for i in first]))
    assert batches[0]["flip"].dtype == torch.bool and batches[0]["gt_boxes"].shape == (2, 8, 4)
