"""DiffAugment of the port (``ops/diffaug.py``) against the JAX package's
``diff_augment``: each policy and the full "color,translation,cutout", on
packed and canonical batches, applied to the parameters the JAX function
draws from its key (derived here exactly as ``ops/diffaug.py`` derives
them: ``fold_in(key, i)`` per policy, then ``split``, then
``uniform``/``randint``); the layout law packed(T(x)) == T(packed(x)); the
input gradient against ``jax.grad``; and the port's own draws (ranges,
shapes, out-buffers).

Tolerances: translation and cutout move or zero values, so they are
bit-equal; color is three f32 operations on the same operands in the same
order, held to rtol 1e-6 / atol 1e-7 (f32); the bf16 case to 1 bf16 ulp of
[-2, 2] (atol 1.6e-2), where XLA may keep an f32 intermediate that PyTorch
rounds to bf16."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from siggan_tpu.ops.diffaug import diff_augment as j_diff_augment
from siggan_tpu.ops.packed import space_to_depth as j_space_to_depth
from siggan_tpu_torch.ops import diffaug
from siggan_tpu_torch.ops.packed import space_to_depth

POLICIES = ["color", "translation", "cutout", "color,translation,cutout"]


def jax_params(key, policy: str, n: int, image_size: int, ndim: int = 4):
    """The per-image parameters ``diff_augment(x, key, policy, ...)`` draws,
    in the port's ``draw`` form."""
    rows = cols = image_size // 2
    out = []
    for i, name in enumerate(diffaug.policies(policy)):
        k = jax.random.fold_in(key, i)
        a, b = jax.random.split(k)
        if name == "color":
            shape = (n,) + (1,) * (ndim - 1)
            p = (jax.random.uniform(a, shape, jnp.float32, -0.5, 0.5),
                 jax.random.uniform(b, shape, jnp.float32, 0.5, 1.5))
        elif name == "translation":
            m_r, m_c = max(int(rows * 0.125), 1), max(int(cols * 0.125), 1)
            p = (jax.random.randint(a, (n,), -m_r, m_r + 1),
                 jax.random.randint(b, (n,), -m_c, m_c + 1))
        else:
            ch, cw = max(int(rows * 0.5), 1), max(int(cols * 0.5), 1)
            p = (jax.random.randint(a, (n,), -(ch // 2), rows - ch + ch // 2 + 1),
                 jax.random.randint(b, (n,), -(cw // 2), cols - cw + cw // 2 + 1))
        t = [torch.from_numpy(np.array(v)).reshape(n) for v in p]
        out.append(tuple(t if name == "color" else [v.long() for v in t]))
    return out


def batch(packed: bool, seed: int, n: int = 5, size: int = 64):
    x = np.random.RandomState(seed).uniform(-1, 1, (n, size, size, 1)).astype(np.float32)
    return np.array(j_space_to_depth(jnp.asarray(x))) if packed else x


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("policy", POLICIES)
def test_apply_on_jax_draws_matches_diff_augment(policy, packed):
    x = batch(packed, 1)
    key = jax.random.key(7, impl="threefry2x32")
    want = np.asarray(j_diff_augment(jnp.asarray(x), key, policy, packed))
    got = diffaug.apply(torch.from_numpy(x), jax_params(key, policy, 5, 64), policy, packed)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    if "color" not in policy:
        np.testing.assert_array_equal(got.numpy(), want)


def test_bf16_apply_matches_diff_augment():
    x = batch(True, 2)
    key = jax.random.key(8, impl="threefry2x32")
    policy = "color,translation,cutout"
    want = j_diff_augment(jnp.asarray(x, jnp.bfloat16), key, policy, True)
    got = diffaug.apply(torch.from_numpy(x).bfloat16(), jax_params(key, policy, 5, 64),
                        policy, True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=0, atol=1.6e-2)


@pytest.mark.parametrize("policy", POLICIES)
def test_packed_of_transform_is_transform_of_packed(policy):
    x = torch.from_numpy(batch(False, 3))
    params = diffaug.draw(policy, 5, 64, torch.Generator().manual_seed(4))
    a = space_to_depth(diffaug.apply(x, params, policy, packed=False))
    b = diffaug.apply(space_to_depth(x), params, policy, packed=True)
    torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("packed", [True, False])
def test_input_gradient_matches_jax_grad(packed):
    x = batch(packed, 5)
    ct = np.random.RandomState(6).randn(*x.shape).astype(np.float32)
    key = jax.random.key(9, impl="threefry2x32")
    policy = "color,translation,cutout"
    jg = jax.grad(lambda v: jnp.sum(j_diff_augment(v, key, policy, packed) * ct))(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = diffaug.apply(xt, jax_params(key, policy, 5, 64), policy, packed)
    (g,) = torch.autograd.grad(out, xt, torch.from_numpy(ct))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-6)


def test_draws_stay_in_the_jax_ranges_and_fill_buffers():
    policy = "color,translation,cutout"
    p = diffaug.draw(policy, 4096, 64, torch.Generator().manual_seed(0))
    (b, c), (tr, tc), (oy, ox) = p
    assert b.dtype == c.dtype == torch.float32 and tr.dtype == oy.dtype == torch.int64
    assert -0.5 <= float(b.min()) and float(b.max()) < 0.5
    assert 0.5 <= float(c.min()) and float(c.max()) < 1.5
    for t in (tr, tc):          # rows 32: a budget of 4 grid units
        assert (int(t.min()), int(t.max())) == (-4, 4)
    for t in (oy, ox):          # side 16: offsets in [-8, 32 - 16 + 8]
        assert (int(t.min()), int(t.max())) == (-8, 24)
    out = [tuple(torch.empty_like(t) for t in pair) for pair in p]
    again = diffaug.draw(policy, 4096, 64, torch.Generator().manual_seed(0), out=out)
    for pa, pb, po in zip(p, again, out):
        for s, t, o in zip(pa, pb, po):
            assert torch.equal(s, t) and t is o
    assert diffaug.apply(torch.ones(2, 8, 8, 4), [], "", True).shape == (2, 8, 8, 4)
    with pytest.raises(ValueError, match="unknown diffaugment policy"):
        diffaug.policies("color,blur")
