"""The port's sampling and loss against the JAX package on the CPU.

The JAX side draws its balance-sampling uniforms from PRNG keys; the same
draws are rebuilt here from those keys and fed to the port. Labels must be
equal; loss sums within rtol 1e-5 (float32 sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyfaces_tpu.loss import detection_loss as jax_detection_loss
from tinyfaces_tpu.ops.sampling import balance_sample_batch as jax_balance_sample_batch
from tinyfaces_tpu.ops.sampling import hard_negative_mining as jax_hard_negative_mining
from tinyfaces_tpu_torch.loss import AvgMeter, detection_loss, smooth_l1
from tinyfaces_tpu_torch.ops.sampling import (
    balance_sample,
    balance_sample_batch,
    hard_negative_mining,
)

torch.set_num_threads(2)

B, H, W, T = 3, 16, 16, 25


def jax_uniforms(key, b, n):
    """The (pos, neg) uniforms jax balance_sample_batch draws from `key`."""
    pos, neg = [], []
    for k in jax.random.split(key, b):
        kp, kn = jax.random.split(k)
        pos.append(np.asarray(jax.random.uniform(kp, (n,))))
        neg.append(np.asarray(jax.random.uniform(kn, (n,))))
    return torch.from_numpy(np.stack(pos)), torch.from_numpy(np.stack(neg))


def _scene(seed, p_pos=0.1):
    rng = np.random.default_rng(seed)
    out = rng.normal(0, 2, (B, H, W, 5 * T)).astype(np.float32)
    cls = rng.choice([-1.0, 0.0, 1.0], size=(B, H, W, T), p=[0.6, 0.4 - p_pos, p_pos])
    reg = rng.normal(0, 1, (B, H, W, 4 * T)).astype(np.float32)
    return out, cls.astype(np.float32), reg


def test_hard_negative_mining_matches_jax():
    out, cls, _ = _scene(0)
    want = np.asarray(jax_hard_negative_mining(jnp.asarray(out[..., :T]), jnp.asarray(cls)))
    got = hard_negative_mining(torch.from_numpy(out[..., :T]), torch.from_numpy(cls)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got == 0).sum() > (cls == 0).sum()  # some easy examples were dropped


@pytest.mark.parametrize("p_pos", [0.1, 0.002])  # over and under the 128 cap
def test_balance_sample_matches_jax(p_pos):
    _, cls, _ = _scene(1, p_pos)
    key = jax.random.PRNGKey(7)
    want = np.asarray(jax_balance_sample_batch(jnp.asarray(cls), key))
    uniforms = jax_uniforms(key, B, H * W * T)
    got = balance_sample_batch(torch.from_numpy(cls), uniforms=uniforms).numpy()
    np.testing.assert_array_equal(got, want)
    for i in range(B):
        assert (got[i] == 1).sum() == min(128, (cls[i] == 1).sum())
        assert (got[i] == -1).sum() == 128  # constant-cap quirk
        one = balance_sample(torch.from_numpy(cls[i]), uniforms=(uniforms[0][i], uniforms[1][i]))
        np.testing.assert_array_equal(one.numpy(), got[i])


def test_balance_sample_generator_draws_are_seeded():
    _, cls, _ = _scene(2)
    a = balance_sample_batch(torch.from_numpy(cls), torch.Generator().manual_seed(3))
    b = balance_sample_batch(torch.from_numpy(cls), torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    assert ((a == 1).sum(dim=(1, 2, 3)) == 128).all()


def test_detection_loss_matches_jax():
    out, cls, reg = _scene(3)
    key = jax.random.PRNGKey(11)
    want = jax_detection_loss(jnp.asarray(out), jnp.asarray(cls), jnp.asarray(reg), key)
    out_t = torch.from_numpy(out).requires_grad_(True)
    got = detection_loss(out_t, torch.from_numpy(cls), torch.from_numpy(reg), None,
                         uniforms=jax_uniforms(key, B, H * W * T))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.item(), float(w), rtol=1e-5)

    # Gradients reach the logits and regression, not the labels.
    got.total.backward()
    want_grad = jax.grad(lambda o: jax_detection_loss(
        o, jnp.asarray(cls), jnp.asarray(reg), key).total)(jnp.asarray(out))
    np.testing.assert_allclose(out_t.grad.numpy(), np.asarray(want_grad), rtol=1e-5, atol=1e-7)


def test_smooth_l1_branches():
    d = torch.tensor([0.0, 0.5, 1.0, 3.0])
    np.testing.assert_allclose(smooth_l1(d, torch.zeros(4)).numpy(), [0.0, 0.125, 0.5, 2.5])


def test_avg_meter():
    m = AvgMeter()
    m.update(10.0, 2)  # a per-batch sum over 2 samples
    m.update(2.0, 2)
    assert m.average == pytest.approx(3.0) and m.num_averaged == 4
    m.reset()
    assert m.average == 0.0 and m.num_averaged == 0
