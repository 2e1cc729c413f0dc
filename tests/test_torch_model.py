"""The port's detector and weight bridge against the JAX package on the CPU.

Weights are made by the JAX package's own init (with randomized BN scale,
shift and statistics), carried over with utils/convert.from_jax, and both
models see the same numpy inputs. Tolerances: atol 2e-4 for eval-mode
outputs (fp32 convolutions summed in another order, as in
tests/test_convert.py); in train mode, where both sides compute batch
statistics (flax by E[x^2] - E[x]^2, torch in two passes), rtol 1e-4 with
an absolute floor of 1e-4 times the tensor's largest magnitude, so values
near zero are held to the tensor's scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tinyfaces_tpu.models.detection import TinyFacesDetector as JaxDetector
from tinyfaces_tpu.models.detection import init_model as jax_init_model
from tinyfaces_tpu_torch.models.detection import TinyFacesDetector, init_model
from tinyfaces_tpu_torch.models.resnet import ARCH_STAGES
from tinyfaces_tpu_torch.utils.convert import from_jax, to_jax

torch.set_num_threads(2)

TINY_STAGES = (1, 1, 1)


def _jax_weights(stages, seed, input_size=(64, 64)):
    params, stats = jax_init_model(JaxDetector(stage_sizes=stages), jax.random.PRNGKey(seed),
                                   input_size=input_size)
    params, stats = jax.device_get((params, stats))
    rng = np.random.default_rng(seed)

    def randomize(tree, which):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = randomize(v, which)
            elif k in ("mean", "bias") and which != "head":
                out[k] = rng.uniform(-0.3, 0.3, v.shape).astype(np.float32)
            elif k in ("var", "scale"):
                out[k] = rng.uniform(0.6, 1.4, v.shape).astype(np.float32)
            else:
                out[k] = np.asarray(v)
        return out

    params = {k: randomize(v, "head" if k.startswith("score") else "backbone")
              for k, v in params.items()}
    params["score_res3"]["bias"] = rng.uniform(-0.1, 0.1, 125).astype(np.float32)
    return params, randomize(stats, "backbone")


def _port(stages, params, stats):
    model = TinyFacesDetector(stage_sizes=stages)
    model.load_state_dict(from_jax(params, stats))
    return model


def _assert_trees_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            _assert_trees_equal(a[k], b[k])
        else:
            np.testing.assert_array_equal(a[k], b[k])


def test_bridge_round_trip_is_exact():
    params, stats = _jax_weights(TINY_STAGES, 0)
    params["score4_upsample"]["kernel"] = np.random.default_rng(1).normal(
        size=(4, 4, 125)).astype(np.float32)  # non-symmetric: pins the axis order
    sd = from_jax(params, stats)
    model = TinyFacesDetector(stage_sizes=TINY_STAGES)
    assert sd.keys() == model.state_dict().keys()  # names match the module tree
    p2, s2 = to_jax(sd)
    _assert_trees_equal(p2, params)
    _assert_trees_equal(s2, stats)


@pytest.mark.parametrize("arch,hw", [
    ("tiny", (128, 128)),
    ("tiny", (120, 152)),  # odd res3/res4 rounding
    ("resnet50", (64, 64)),
])
def test_eval_forward_matches_jax(arch, hw):
    stages = TINY_STAGES if arch == "tiny" else ARCH_STAGES[arch]
    params, stats = _jax_weights(stages, 2)
    model = _port(stages, params, stats).eval()
    x = np.random.default_rng(3).normal(0, 1, (2, *hw, 3)).astype(np.float32)
    want = np.asarray(JaxDetector(stage_sizes=stages).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32
    assert got.shape == want.shape == (2, -(-hw[0] // 8), -(-hw[1] // 8), 125)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=0)


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_train_forward_and_batch_stats_match_jax():
    params, stats = _jax_weights(TINY_STAGES, 4)
    model = _port(TINY_STAGES, params, stats).train()
    x = np.random.default_rng(5).normal(0, 1, (2, 128, 128, 3)).astype(np.float32)
    want, muts = JaxDetector(stage_sizes=TINY_STAGES).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x), train=True,
        mutable=["batch_stats"])
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    _close(got.numpy(), np.asarray(want))

    new_stats = to_jax(model.state_dict())[1]
    want_stats = jax.device_get(muts["batch_stats"])
    flat_got = jax.tree_util.tree_leaves(new_stats)
    flat_want = jax.tree_util.tree_leaves(want_stats)
    assert len(flat_got) == len(flat_want)
    for a, b in zip(flat_got, flat_want):
        _close(a, b)


def test_batchnorm_running_var_uses_biased_variance():
    """flax momentum 0.9 == torch 0.1, and the biased batch variance."""
    from tinyfaces_tpu_torch.models.resnet import BatchNorm2d

    x = torch.from_numpy(np.random.default_rng(6).normal(2.0, 3.0, (2, 3, 2, 2)).astype(np.float32))
    bn = BatchNorm2d(3).train()
    bn(x)
    xn = x.numpy().transpose(1, 0, 2, 3).reshape(3, -1)
    np.testing.assert_allclose(bn.running_mean.numpy(), 0.1 * xn.mean(1), rtol=1e-5)
    np.testing.assert_allclose(bn.running_var.numpy(), 0.9 + 0.1 * xn.var(1, ddof=0), rtol=1e-5)


@pytest.mark.parametrize("case,tol", [
    ("float32", 1e-5),
    ("bfloat16", 8e-3),  # the output and input gradient are rounded to bf16
    ("cancels", 2e-4),  # one ulp of 100 in float32 is 7.6e-6, a tenth of a percent of the spread
    ("remat", 1e-5),
])
def test_batchnorm_train_forward_matches_two_pass_float64(case, tol):
    """Training-mode BatchNorm2d, which updates the running statistics from
    the statistics its normalisation took, against the plain two-pass
    computation in float64 (F.batch_norm for the output, var_mean for the
    update): the output, the input and parameter gradients, and both
    running buffers. `cancels` gives one channel a mean 1e3 times its
    spread, where E[x^2] - E[x]^2 in float32 loses the variance; `remat`
    checkpoints the layer and a ReLU (whose saved output makes the backward
    pass recompute past the update), and the recompute must not update the
    running statistics a second time."""
    from tinyfaces_tpu_torch.models.resnet import BatchNorm2d, checkpointed

    rng = np.random.default_rng(7)
    n, c, h, w = 3, 5, 6, 7
    x = rng.normal(0.5, 2.0, (n, c, h, w))
    if case == "cancels":
        x[:, 2] = rng.normal(100.0, 0.1, (n, h, w))
    dtype = torch.bfloat16 if case == "bfloat16" else torch.float32
    x = torch.from_numpy(x).to(dtype)  # both sides see the rounded values
    g = torch.from_numpy(rng.normal(0, 1, (n, c, h, w))).to(dtype).float()
    bn = BatchNorm2d(c).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c)))
        bn.bias.copy_(torch.from_numpy(rng.uniform(-0.5, 0.5, c)))
        bn.running_mean.copy_(torch.from_numpy(rng.uniform(-1.0, 1.0, c)))
        bn.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c)))
    init = {k: v.double() for k, v in bn.named_buffers()}

    x64 = x.double().requires_grad_(True)
    w64 = bn.weight.detach().double().requires_grad_(True)
    b64 = bn.bias.detach().double().requires_grad_(True)
    act = F.relu if case == "remat" else (lambda t: t)
    want = act(F.batch_norm(x64, None, None, w64, b64, True, 0.0, bn.eps))
    (want * g.double()).sum().backward()
    var, mean = torch.var_mean(x64.detach(), dim=(0, 2, 3), correction=0)
    want_stats = {"running_mean": 0.9 * init["running_mean"] + 0.1 * mean,
                  "running_var": 0.9 * init["running_var"] + 0.1 * var}

    xg = x.clone().requires_grad_(True)
    got = checkpointed(torch.nn.Sequential(bn, torch.nn.ReLU()), xg) if case == "remat" else bn(xg)
    assert got.dtype == dtype
    (got.float() * g).sum().backward()
    for name, a, b in (("y", got, want), ("x.grad", xg.grad, x64.grad),
                       ("weight.grad", bn.weight.grad, w64.grad),
                       ("bias.grad", bn.bias.grad, b64.grad)):
        b = b.detach().numpy()
        np.testing.assert_allclose(a.detach().double().numpy(), b, rtol=0,
                                   atol=tol * np.abs(b).max(), err_msg=name)
    for name, b in want_stats.items():
        np.testing.assert_allclose(getattr(bn, name).double().numpy(), b.numpy(), rtol=2e-6,
                                   err_msg=name)


def test_init_model_is_seeded_and_upsample_frozen():
    a = init_model(TinyFacesDetector(stage_sizes=TINY_STAGES), torch.Generator().manual_seed(0))
    b = init_model(TinyFacesDetector(stage_sizes=TINY_STAGES), torch.Generator().manual_seed(0))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    assert not a.score4_upsample.weight.requires_grad
    np.testing.assert_allclose(a.score4_upsample.weight[0, 0, :, 0].numpy(),
                               [0.0625, 0.1875, 0.1875, 0.0625])
