"""The training slice's ops against the JAX package: the packed-tail pack
(kernel B1's plain version, the CPU side of its autograd Function) and its
backward (B1'), train-mode and packed BatchNorm, the packed re-indexings,
dropout2d, both Adam variants, the augmentation warp and the synthetic
data. Inputs are made with numpy from a seed and fed to both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from siggan_tpu.core.state import adam_low_mem as j_adam_low_mem
from siggan_tpu.data import augment as jaug
from siggan_tpu.data import synthetic as jsyn
from siggan_tpu.ops import norm as jnorm
from siggan_tpu.ops import packed as jpk
from siggan_tpu.ops.regularizers import dropout2d as j_dropout2d
from siggan_tpu_torch.core.state import Adam
from siggan_tpu_torch.data import augment as taug
from siggan_tpu_torch.data import synthetic as tsyn
from siggan_tpu_torch.data.dataset import SignatureDataset
from siggan_tpu_torch.ops import norm as tnorm
from siggan_tpu_torch.ops import packed as tpk
from siggan_tpu_torch.ops.kernels import pack_tail as pt
from siggan_tpu_torch.ops.regularizers import dropout2d

# Packed tail of a 64 px generator at base_features 32: entry 16->8,
# interiors 8->4 and 4->4, final 4->1 (HWIO, the JAX layout).
TAIL_HWIO = [(4, 4, 16, 8), (4, 4, 8, 4), (4, 4, 4, 4), (3, 3, 4, 1)]
# Port stored layout <- JAX HWIO, and packed consumer layout <- packed HWIO.
TO_STORED = [(2, 3, 0, 1)] * 3 + [(3, 2, 0, 1)]
TO_CONSUMER = [(3, 2, 0, 1), (2, 3, 0, 1), (2, 3, 0, 1), (2, 0, 1, 3)]


def t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


@pytest.mark.parametrize("odt,jdt", [(torch.float32, jnp.float32),
                                     (torch.bfloat16, jnp.bfloat16)])
def test_pack_tail_matches_pallas_and_its_vjp(odt, jdt):
    rs = np.random.RandomState(0)
    wj = [rs.randn(*s).astype(np.float32) for s in TAIL_HWIO]
    ws = [t(w).permute(*p).contiguous().requires_grad_(True)
          for w, p in zip(wj, TO_STORED)]
    ref, vjp = jax.vjp(lambda *w: jpk.pack_tail_kernels_pallas(list(w), out_dtype=jdt),
                       *[jnp.asarray(w) for w in wj])
    got = pt.pack_tail(ws, odt)
    for g, r, p in zip(got, ref, TO_CONSUMER):
        assert g.dtype == odt and g.is_contiguous()
        want = torch.from_numpy(np.asarray(r).astype(np.float32)).permute(*p)
        assert torch.equal(g.float(), want)          # a copy and a cast: exact
    cts = [rs.randn(*np.asarray(r).shape).astype(np.float32) for r in ref]
    jg = vjp(tuple(jnp.asarray(c, jdt) for c in cts))
    tg = torch.autograd.grad(got, ws, [t(c).permute(*p).contiguous().to(odt)
                                       for c, p in zip(cts, TO_CONSUMER)])
    for g, r, p in zip(tg, jg, TO_STORED):
        assert g.dtype == torch.float32
        back = g.permute(*np.argsort(p))
        np.testing.assert_allclose(back.numpy(), np.asarray(r), rtol=1e-6, atol=0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_pack_tail_plan_lays_out_one_aligned_buffer(dtype):
    """B1's host plan, built once per shapes and dtype: the consumer shapes
    of the plain version, outputs at 16-byte aligned offsets of one buffer
    that do not overlap, and the kinds and (Ci, Co) the kernel is given."""
    shapes = [(128, 64, 4, 4), (64, 32, 4, 4), (32, 32, 4, 4), (1, 32, 3, 3)]
    ws = [torch.zeros(s) for s in shapes]
    plan = pt._plan(ws, dtype)
    assert pt._plan([torch.ones(s) for s in shapes], dtype) is plan
    assert pt._plan(ws, torch.float32 if dtype == torch.bfloat16 else torch.bfloat16) is not plan
    assert plan.shapes == [tuple(r.shape) for r in pt.pack_tail_reference(ws, dtype)]
    isz = 2 if dtype == torch.bfloat16 else 4
    ends = [off for _, _, off in plan.views[1:]] + [plan.total]
    for (shape, stride, off), end, want in zip(plan.views, ends, plan.shapes):
        assert shape == want and stride == torch.empty(shape).stride()
        assert off * isz % 16 == 0 and 0 <= end - off - int(np.prod(shape)) < 16 // isz
    assert plan.offsets == [isz * off for _, _, off in plan.views]
    n, ks, cis, cos = plan.args
    assert (n, list(ks), list(cis), list(cos)) == (4, [0, 1, 1, 2], [128, 64, 32, 32],
                                                   [64, 32, 32, 1])


@pytest.mark.parametrize("fn", ["pack_convt_kernel_out_mc", "pack_convt_kernel_both_mc",
                                "pack_conv3_kernel_both_mc", "pack_first_conv_kernel"])
def test_pack_laws_match_jax(fn):
    shape = {"pack_conv3_kernel_both_mc": (3, 3, 4, 2),
             "pack_first_conv_kernel": (4, 4, 1, 5)}.get(fn, (4, 4, 3, 2))
    w = np.random.RandomState(1).randn(*shape).astype(np.float32)
    np.testing.assert_array_equal(getattr(tpk, fn)(t(w)).numpy(),
                                  np.asarray(getattr(jpk, fn)(jnp.asarray(w))))


def test_space_to_depth_and_conv3_matmul_match_jax():
    rs = np.random.RandomState(2)
    x = rs.randn(2, 8, 6, 3).astype(np.float32)
    s2d = tpk.space_to_depth_mc(t(x))
    np.testing.assert_array_equal(s2d.numpy(), np.asarray(jpk.space_to_depth_mc(jnp.asarray(x))))
    assert torch.equal(tpk.depth_to_space_mc(s2d), t(x))
    img = rs.randn(2, 8, 8, 1).astype(np.float32)
    np.testing.assert_array_equal(tpk.space_to_depth(t(img)).numpy(),
                                  np.asarray(jpk.space_to_depth(jnp.asarray(img))))
    assert torch.equal(tpk.depth_to_space(tpk.space_to_depth(t(img))), t(img))
    h = rs.randn(2, 5, 6, 16).astype(np.float32)
    wp = rs.randn(3, 3, 16, 4).astype(np.float32)
    b = rs.randn(4).astype(np.float32)
    ref = jpk.conv3_mc_as_matmul(jnp.asarray(h), jnp.asarray(wp), jnp.asarray(b),
                                 compute_dtype=jnp.float32)
    got = tpk.conv3_mc_as_matmul(t(h), t(wp), t(b), compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("packed,per_sample", [(False, False), (True, False),
                                               (False, True), (True, True)])
def test_train_batch_norm_matches_jax(packed, per_sample):
    rs = np.random.RandomState(3)
    c = 6
    x = (rs.randn(5, 4, 4, 4 * c if packed else c) * 2 + 0.5).astype(np.float32)
    rows = (5, c) if per_sample else (c,)
    scale = rs.rand(*rows).astype(np.float32) + 0.5
    offset = rs.randn(*rows).astype(np.float32)
    state = {"mean": rs.randn(c).astype(np.float32),
             "var": rs.rand(c).astype(np.float32) + 0.5}
    jfn, tfn = ((jnorm.batch_norm_packed, tnorm.batch_norm_packed) if packed
                else (jnorm.batch_norm, tnorm.batch_norm))
    ref, rst = jfn(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(offset),
                   {k: jnp.asarray(v) for k, v in state.items()}, train=True)
    got, gst = tfn(t(x), t(scale), t(offset), {k: t(v) for k, v in state.items()},
                   train=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    for k in ("mean", "var"):
        np.testing.assert_allclose(gst[k].numpy(), np.asarray(rst[k]), rtol=1e-5, atol=1e-6)
    # Groups (the fused generator forwards): 5 groups of one row, as JAX
    # takes them; a batch that does not split raises.
    ref, rst = jfn(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(offset),
                   {k: jnp.asarray(v) for k, v in state.items()}, train=True, groups=5)
    got, gst = tfn(t(x), t(scale), t(offset), {k: t(v) for k, v in state.items()},
                   train=True, groups=5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    for k in ("mean", "var"):
        np.testing.assert_allclose(gst[k].numpy(), np.asarray(rst[k]), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="does not split into 2 groups"):
        tfn(t(x), t(scale), t(offset), {k: t(v) for k, v in state.items()},
            train=True, groups=2)


def test_dropout2d_with_jax_mask():
    rs = np.random.RandomState(4)
    x = rs.randn(6, 3, 3, 8).astype(np.float32)
    key = jax.random.key(5, impl="threefry2x32")
    ref = j_dropout2d(jnp.asarray(x), 0.25, key, train=True)
    mask = np.array(jax.random.bernoulli(key, 0.75, (6, 1, 1, 8)))
    got = dropout2d(t(x), 0.25, train=True, mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=0)
    drawn = dropout2d(t(x), 0.25, train=True, gen=torch.Generator().manual_seed(0))
    kept = (drawn != 0).any(dim=(1, 2)).float().mean()
    assert 0.5 < float(kept) < 1.0
    assert torch.equal(dropout2d(t(x), 0.25, train=False), t(x))


@pytest.mark.parametrize("moments", ["bfloat16", "float32"])
def test_adam_matches_jax(moments):
    rs = np.random.RandomState(6)
    shapes = [(3, 4), (5,), (2, 2, 3)]
    params = [rs.randn(*s).astype(np.float32) for s in shapes]
    grads = [[rs.randn(*s).astype(np.float32) * 10 ** rs.uniform(-4, 0) for s in shapes]
             for _ in range(3)]
    tx = (j_adam_low_mem(2e-4, 0.5, 0.999) if moments == "bfloat16"
          else optax.adam(2e-4, b1=0.5, b2=0.999, eps=1e-8))
    jp = [jnp.asarray(p) for p in params]
    js = tx.init(jp)
    port = Adam(2e-4, 0.5, 0.999, 1e-8, moments)
    tp = [t(p) for p in params]
    ts = port.init(tp)
    for g in grads:
        upd, js = tx.update([jnp.asarray(x) for x in g], js, jp)
        jp = optax.apply_updates(jp, upd)
        port.step(tp, [t(x) for x in g], ts)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-9)
    jm = js["m"] if moments == "bfloat16" else js[0].mu
    assert ts["count"] == 3 and ts["m"][0].dtype == getattr(torch, moments)
    np.testing.assert_allclose(ts["m"][1].float().numpy(),
                               np.asarray(jm[1]).astype(np.float32), rtol=1e-6)


def test_adam_clips_by_global_norm():
    g = [torch.full((4,), 3.0), torch.full((2,), 4.0)]
    jg = [jnp.full((4,), 3.0), jnp.full((2,), 4.0)]
    clip = optax.clip_by_global_norm(1.0)
    want, _ = clip.update(jg, clip.init(jg))
    got = Adam(1e-3, 0.5, 0.999, clip=1.0)._clip(g)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


@pytest.mark.parametrize("hflip,dtype", [(False, None), (True, None), (False, "bfloat16")])
def test_augment_apply_matches_jax(hflip, dtype):
    imgs = jsyn.generate_dataset(4, 64, seed=3)
    theta, scale, flip = jaug.augment_params(jax.random.key(7, impl="threefry2x32"), 4,
                                             hflip=hflip)
    ref = jaug.augment_apply(jnp.asarray(imgs), theta, scale, flip,
                             dtype=None if dtype is None else jnp.bfloat16)
    got = taug.augment_apply(t(imgs), t(theta), t(scale),
                             None if flip is None else torch.from_numpy(np.array(flip)),
                             dtype=dtype)
    tol = 1e-5 if dtype is None else 2e-2   # bf16 taps round in both packages
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=tol)
    if dtype is None:
        wide = jaug._affine_warp_twopass(jnp.asarray(imgs), jnp.asarray(
            np.tile(np.eye(2, 3, dtype=np.float32) * 0.95, (4, 1, 1))), 1.0)
        mats = torch.from_numpy(np.tile(np.eye(2, 3, dtype=np.float32) * 0.95, (4, 1, 1)))
        np.testing.assert_allclose(taug._affine_warp_twopass(t(imgs), mats, 1.0).numpy(),
                                   np.asarray(wide), rtol=0, atol=1e-5)
    assert taug._band_radii(64, 64, 5.0, 0.9, 1.1) == jaug._band_radii(64, 64, 5.0, 0.9, 1.1)


def test_synthetic_data_and_png_dataset_match_jax(tmp_path):
    np.testing.assert_array_equal(tsyn.generate_dataset(3, 64, seed=9),
                                  jsyn.generate_dataset(3, 64, seed=9))
    tsyn.save_dataset_pngs(5, tmp_path / "d", seed=2)
    from siggan_tpu.data.dataset import SignatureDataset as JDataset
    a = SignatureDataset(tmp_path / "d", 64, use_cache=False).images
    b = JDataset(tmp_path / "d", 64, use_cache=False).images
    np.testing.assert_array_equal(a, b)
    c = SignatureDataset(tmp_path / "d", 64).images          # writes the cache
    assert list((tmp_path / "d").glob(".siggan_torch_cache_*.npy"))
    np.testing.assert_array_equal(SignatureDataset(tmp_path / "d", 64).images, c)
