"""The port's verifier (``siggan_tpu_torch/verify``) against the JAX package's.

Same inputs (numpy seeds) and, through ``bridge.verifier_from_jax``, the
same weights go through ``siggan_tpu.verify`` and
``siggan_tpu_torch.verify`` on the CPU. Tolerances:

- metrics: equal (the same float64 formulas over the same ROC points),
  and ``roc_curve`` / ``auc`` equal to sklearn's;
- forwards (embeddings, logits, hidden features, BN statistics): the f32
  bar, rtol 1e-4 / atol 1e-5;
- train steps on JAX's dropout masks, each from JAX's state: the losses
  and accuracy rtol 1e-4 / atol 1e-6; Adam's moments rtol 1e-3 / atol 1e-4
  of each leaf's largest entry; the parameters atol 1e-5, but those whose
  gradient is 0 up to rounding, which Adam may move by a few lr either way
  (``_assert_step_matches``); the gradients on signature images against the
  port's own float64 run (1e-4), where JAX's f32 is off by up to 2.5 %;
- scores of a pickle in the other package, features and FID of the
  ``verifier:`` backbone: the f32 bar (FID rtol 1e-4).
"""

import json
import pickle
import random

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from siggan_tpu.verify import eval as jeval
from siggan_tpu.verify import metrics as jmetrics
from siggan_tpu.verify import models as jmodels
from siggan_tpu.verify import pairs as jpairs
from siggan_tpu.verify import train as jtrain
from siggan_tpu_torch import bridge
from siggan_tpu_torch.verify import eval as teval
from siggan_tpu_torch.verify import metrics as tmetrics
from siggan_tpu_torch.verify import models as tmodels
from siggan_tpu_torch.verify import pairs as tpairs
from siggan_tpu_torch.verify import train as ttrain

RTOL, ATOL = 1e-4, 1e-5


def np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def assert_trees_close(a, b, **kw):
    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_allclose(np.asarray(x, np.float32), np.asarray(y, np.float32), **kw)


def signatures(n, seed):
    from siggan_tpu_torch.data.synthetic import generate_dataset
    return generate_dataset(n, 64, seed=seed)


def save_png(path, arr):
    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(arr).save(path)


def scan(rs, size=48):
    """A 48 x 48 grey stroke image (off the 64 px size, so it is resized)."""
    arr = np.full((size, size), 255, np.uint8)
    r = rs.randint(4, size - 10)
    arr[r:r + 6, 4:size - 4] = rs.randint(0, 90)
    arr[rs.randint(0, size, 30), rs.randint(0, size, 30)] = rs.randint(0, 255, 30)
    return arr


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """A per-user tree (with a 1-signature user, dropped, and a text file),
    a flat tree grouped by filename prefix, and a synthetic directory."""
    root = tmp_path_factory.mktemp("verify")
    rs = np.random.RandomState(0)
    for u, n in (("writer_003", 5), ("writer_010", 4), ("writer_024", 3), ("writer_099", 1)):
        for i in range(n):
            save_png(root / "users" / u / f"original_{u[-2:]}_{i}.png", scan(rs))
    (root / "users" / "writer_003" / "notes.txt").write_text("not an image")
    for u in ("u1", "u2", "u3"):
        for i in range(3):
            save_png(root / "flat" / f"{u}_sig{i}.png", scan(rs))
    for i in range(4):
        save_png(root / "synth" / f"signature_{i:06d}.png",
                 rs.randint(0, 256, (64, 64)).astype(np.uint8))
    return root


# -- metrics -----------------------------------------------------------------

def _metric_case(name):
    rs = np.random.RandomState(3)
    y = (rs.rand(40) < 0.5).astype(np.float32)
    return {
        "random": (y, rs.rand(40).astype(np.float32)),
        "ties": (y, (rs.randint(0, 4, 40) / 4).astype(np.float32)),
        "constant": (y, np.full(40, 0.5, np.float32)),
        "separable": (y, (y * 0.6 + 0.2).astype(np.float32)),
        "inverted": (y, (0.8 - y * 0.6).astype(np.float32)),
        "all_genuine": (np.ones(10, np.float32), rs.rand(10).astype(np.float32)),
        "all_impostor": (np.zeros(10, np.float32), rs.rand(10).astype(np.float32)),
    }[name]


@pytest.mark.filterwarnings("ignore")
@pytest.mark.parametrize("threshold", [0.5, 0.3])
@pytest.mark.parametrize("case", ["random", "ties", "constant", "separable", "inverted",
                                  "all_genuine", "all_impostor"])
def test_metrics_match_jax(case, threshold):
    """``compute_verification_metrics``, ``compute_eer_from_scores``, the ROC
    and DET points equal the JAX module's (sklearn's), on tied and constant
    scores (the inf-threshold branch) and on one-class labels (where both
    raise: no rate of the absent class exists)."""
    from sklearn.metrics import auc, roc_curve
    y, s = _metric_case(case)
    preds = (s > threshold).astype(np.float32)
    for want, got in zip(roc_curve(y, s), tmetrics.roc_curve(y, s)):
        np.testing.assert_array_equal(got, want)
    for want, got in zip(jmetrics.det_points(y, s), tmetrics.det_points(y, s)):
        np.testing.assert_array_equal(got, want)
    if case.startswith("all_"):
        for fn in (jmetrics.compute_verification_metrics, tmetrics.compute_verification_metrics):
            with pytest.raises(ValueError):
                fn(y, s, preds, threshold)
        return
    fpr, tpr, _ = tmetrics.roc_curve(y, s)
    assert tmetrics.auc(fpr, tpr) == auc(fpr, tpr)
    want = jmetrics.compute_verification_metrics(y, s, preds, threshold)
    got = tmetrics.compute_verification_metrics(y, s, preds, threshold)
    assert got == want
    assert np.isfinite(got["eer_threshold"])
    assert tmetrics.compute_eer_from_scores(y, s) == jmetrics.compute_eer_from_scores(y, s)


# -- the network ---------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_verifier():
    params, state = jmodels.init_fn(jax.random.key(0))
    return np_tree(params), np_tree(state)


def jax_masks(rng, n):
    r1, r2, r3 = jax.random.split(rng, 3)
    return [torch.from_numpy(np.asarray(jax.random.bernoulli(r, keep, shape)))
            for r, keep, shape in ((r1, 0.5, (n, 512)), (r2, 0.5, (n, 512)),
                                   (r3, 0.7, (n, 64)))]


@pytest.mark.parametrize("mode", ["eval", "train", "hidden"])
def test_forward_matches_jax(jax_verifier, mode):
    """The pair forward (both twins, the classifier, the BN state twin 2
    leaves after twin 1) in eval and train mode on JAX's masks, and the
    encoder's hidden features, on bridged weights."""
    params, state = jax_verifier
    rs = np.random.RandomState(1)
    x1, x2 = (rs.uniform(-1, 1, (4, 64, 64, 1)).astype(np.float32) for _ in range(2))
    model = bridge.verifier_from_jax(params, state)
    t1, t2 = torch.from_numpy(x1), torch.from_numpy(x2)
    if mode == "hidden":
        want, _ = jmodels.encode(params, state, x1, train=False, return_hidden=True)
        with torch.no_grad():
            got = model.encode(t1, train=False, return_hidden=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
        return
    train = mode == "train"
    rng = jax.random.key(5)
    e1, e2, logits, new_state = jmodels.apply_fn(params, state, x1, x2, train=train,
                                                 rng=rng if train else None)
    with torch.no_grad():
        g1, g2, gl = model(t1, t2, train=train, masks=jax_masks(rng, 4) if train else None)
    for got, want in ((g1, e1), (g2, e2), (gl, logits)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    assert_trees_close(bridge.verifier_to_jax(model)[1], np_tree(new_state), rtol=RTOL, atol=1e-6)
    if not train:
        assert_trees_close(bridge.verifier_to_jax(model)[1], state, rtol=0, atol=0)


def test_contrastive_loss_param_count_and_bridge(jax_verifier):
    """contrastive_loss on both label conventions, param_count, and the
    bridge round trip (port -> JAX trees -> port)."""
    params, state = jax_verifier
    rs = np.random.RandomState(2)
    e1, e2 = (rs.randn(6, 128).astype(np.float32) * 0.3 for _ in range(2))
    lab = np.asarray([1, 0, 1, 0, 0, 1], np.float32)
    want = jmodels.contrastive_loss(e1, e2, lab)
    got = tmodels.contrastive_loss(*(torch.from_numpy(a) for a in (e1, e2, lab)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=1e-6)
    model = bridge.verifier_from_jax(params, state)
    assert tmodels.param_count(model) == jmodels.param_count(params) == 4395201
    p2, s2 = bridge.verifier_to_jax(model)
    assert_trees_close(p2, params, rtol=0, atol=0)
    assert_trees_close(s2, state, rtol=0, atol=0)
    fresh = tmodels.init_fn(torch.Generator().manual_seed(0))
    again = bridge.verifier_from_jax(*bridge.verifier_to_jax(fresh))
    for a, b in zip(fresh.state_dict().values(), again.state_dict().values()):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="generator or a mask"):
        fresh(torch.zeros(1, 64, 64, 1), torch.zeros(1, 64, 64, 1), train=True)


# -- pairs ---------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["users", "flat", "users+synthetic"])
def test_pairs_and_split_match_jax(trees, layout):
    """The same users, pair lists (paths and labels, from random.Random),
    decoded pair arrays (48 px PNGs resized bit-equal with PIL), splits
    (RandomState) and summary as the JAX package's."""
    data = trees / ("flat" if layout == "flat" else "users")
    synth = trees / "synth" if "synthetic" in layout else None
    assert tpairs.load_user_signatures(data, synth) == jpairs.load_user_signatures(data, synth)
    want = jpairs.PairDataset(data, synth, pairs_per_user=4, seed=7)
    got = tpairs.PairDataset(data, synth, pairs_per_user=4, seed=7)
    assert got.pairs == want.pairs and got.summary() == want.summary()
    if synth is not None:
        assert tpairs.SYNTHETIC_USER in got.users
        assert all(not (str(a).startswith(str(synth)) and lab == 1) for a, _, lab in got.pairs)
    for a, b in ((got.img1, want.img1), (got.img2, want.img2), (got.labels, want.labels)):
        np.testing.assert_array_equal(a, b)
    for gs, ws in zip(got.split(0.25, seed=3), want.split(0.25, seed=3)):
        for a, b in zip(gs, ws):
            np.testing.assert_array_equal(a, b)


def test_pairs_refuse_other_image_formats(trees, tmp_path):
    """A tree holding .jpg, .bmp and .tif scans (a CCITT Group 4 one among
    them) is paired and decoded as the JAX package does (its PIL path);
    only a file of a kind not read yet (an AVIF under a .tif name; the CMYK
    TIFF, BigTIFF, LZMA TIFF, CCITT TIFF in tiles, LZMA TIFF of the ARM64
    BCJ filter, WebP and ICO this test refused before are read) is refused,
    naming the ROADMAP item of the decoders."""
    import shutil

    from siggan_tpu.data.native import loader as jnative
    shutil.copytree(trees / "users", tmp_path / "users")
    rs = np.random.RandomState(9)
    for i, ext in enumerate((".jpg", ".bmp", ".tif")):
        scan = (rs.rand(50, 70, 3) * 255).astype(np.uint8)
        Image.fromarray(scan).save(tmp_path / "users" / "writer_010" / f"scan{i}{ext}")
    Image.fromarray(scan[..., 0] > 128).save(tmp_path / "users" / "writer_010" / "fax.tif",
                                             compression="group4")
    got = tpairs.load_user_signatures(tmp_path / "users")
    assert got == jpairs.load_user_signatures(tmp_path / "users")
    assert {p.suffix for p in got["writer_010"]} >= {".jpg", ".bmp", ".tif"}
    available = jnative.available
    jnative.available = lambda: False        # the JAX dataset's PIL path
    try:
        want = jpairs.PairDataset(tmp_path / "users", pairs_per_user=3, seed=2)
    finally:
        jnative.available = available
    have = tpairs.PairDataset(tmp_path / "users", pairs_per_user=3, seed=2)
    np.testing.assert_array_equal(have.img1, want.img1)
    np.testing.assert_array_equal(have.img2, want.img2)
    Image.fromarray(scan).convert("CMYK").save(tmp_path / "users" / "writer_010" / "cmyk.tif",
                                               compression="tiff_adobe_deflate")
    jnative.available = lambda: False
    try:
        want = jpairs.PairDataset(tmp_path / "users", pairs_per_user=3, seed=2)
    finally:
        jnative.available = available
    have = tpairs.PairDataset(tmp_path / "users", pairs_per_user=3, seed=2)
    np.testing.assert_array_equal(have.img1, want.img1)
    np.testing.assert_array_equal(have.img2, want.img2)
    from test_torch_port_decode import unread_bytes
    (tmp_path / "users" / "writer_010" / "avif.tif").write_bytes(unread_bytes())
    with pytest.raises(NotImplementedError, match="AVIF.*ROADMAP A.6"):
        tpairs.PairDataset(tmp_path / "users", pairs_per_user=30, seed=2)


# -- training ------------------------------------------------------------------

def test_schedule_matches_optax():
    """The StepLR (optax staircase exponential_decay) at counts on both
    sides of its boundaries, equal to optax's f32 value."""
    from siggan_tpu_torch.core.state import StaircaseDecay
    for steps in (1, 27, 270):
        want = optax.exponential_decay(1e-3, steps, 0.5, staircase=True)
        got = StaircaseDecay(1e-3, steps, 0.5)
        for c in sorted({0, 1, steps - 1, steps, steps + 1, 2 * steps - 1, 2 * steps,
                         5 * steps + 1}):
            assert np.float32(want(jnp.int32(c))) == got(torch.tensor(c, dtype=torch.int32)), c


def _conv_bias(path) -> bool:
    return path.startswith("['conv']") and path.endswith("['b']")


def _assert_step_matches(ts, js, lr):
    """The port's state after a step against JAX's after the same step from
    the same state: Adam's count, moments (rtol 1e-3, atol 1e-4 of each
    leaf's largest entry; the conv biases, whose gradient is 0 up to
    rounding before a train-mode BatchNorm, atol 1e-6 (m) and 1e-12 (v))
    and parameters
    (atol 1e-5) and the BN running statistics (rtol 1e-4, atol 1e-6). Adam
    moves a parameter by up to a few lr whatever its gradient's size, so a
    parameter whose gradient is within rounding of 0 (|m| <= 1e-4 of its
    leaf's largest, and every conv bias) may move the other way: those
    may differ by up to 4 lr."""
    adam = js.opt[0]
    assert int(ts.opt["count"]) == int(adam.count)
    port_m = bridge.tensors_to_jax(ts.model, ts.opt["m"])
    port_v = bridge.tensors_to_jax(ts.model, ts.opt["v"])
    port_p, port_s = bridge.verifier_to_jax(ts.model)
    flat = {k: dict(jax.tree_util.tree_flatten_with_path(t)[0])
            for k, t in (("m", port_m), ("v", port_v), ("p", port_p))}
    want_m = dict(jax.tree_util.tree_flatten_with_path(np_tree(adam.mu))[0])
    want_v = dict(jax.tree_util.tree_flatten_with_path(np_tree(adam.nu))[0])
    for path, want_p in jax.tree_util.tree_flatten_with_path(np_tree(js.params))[0]:
        key = jax.tree_util.keystr(path)
        bias = _conv_bias(key)
        for name, want in (("m", want_m[path]), ("v", want_v[path])):
            atol = {"m": 1e-6, "v": 1e-12}[name] if bias else 1e-4 * np.abs(want).max()
            np.testing.assert_allclose(flat[name][path], want, rtol=0 if bias else 1e-3,
                                       atol=atol, err_msg=f"{name} {key}")
        d = np.abs(flat["p"][path] - want_p)
        m = np.abs(want_m[path])
        near_zero = np.ones_like(m, bool) if bias else m <= 1e-4 * m.max()
        assert np.all((d <= 1e-5) | (near_zero & (d <= 4 * lr))), key
    assert_trees_close(port_s, np_tree(js.bn), rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize("n_steps", [1, 3])
def test_train_steps_match_jax_step(jax_verifier, n_steps):
    """``n_steps`` updates on batches of uniform images with JAX's dropout
    masks, each from the state JAX's previous step left (copied into the
    port through the bridge, Adam's moments and count included, so that a
    parameter moved the other way at step 1 does not carry over): the
    metrics of each step, then Adam's count and moments, the parameters,
    the BN running statistics, and the LR of the schedule, which decays
    every step (``step_size=1``)."""
    params, state = jax_verifier
    tx = jtrain.make_optimizer(1e-3, step_size=1, gamma=0.5)
    js = jtrain.VerifierState(step=jnp.zeros((), jnp.int32), params=params, bn=state,
                              opt=tx.init(params))
    jstep = jax.jit(jtrain.make_train_step(tx, True, seed=4))
    rs = np.random.RandomState(0)
    imgs = rs.uniform(-1, 1, (16, 64, 64, 1)).astype(np.float32)
    for i in range(n_steps):
        model = bridge.verifier_from_jax(np_tree(js.params), np_tree(js.bn))
        adam = js.opt[0]
        ts = ttrain.VerifierState(i, model, ttrain.make_optimizer(1e-3, step_size=1, gamma=0.5),
                                  bridge.opt_from_jax({"count": adam.count, "m": np_tree(adam.mu),
                                                       "v": np_tree(adam.nu)}, model,
                                                      torch.float32))
        a, b = rs.permutation(16)[:6], rs.permutation(16)[:6]
        lab = (rs.rand(6) < 0.5).astype(np.float32)
        rng = jax.random.fold_in(jax.random.key(4), i)
        js, jm = jstep(js, imgs[a], imgs[b], lab)
        m = ttrain.train_step(ts, *(torch.from_numpy(v) for v in (imgs[a], imgs[b], lab)),
                              masks=jax_masks(rng, 6))
        for k in ("loss", "bce_loss", "contrastive_loss", "accuracy"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4, atol=1e-6, err_msg=k)
        lr = 1e-3 * 0.5 ** i
        assert float(ts.opt["lr"]) == np.float32(lr) and ts.step == i + 1
        _assert_step_matches(ts, js, lr)
    assert int(js.opt[0].count) == n_steps


def test_gradients_on_signature_pairs_match_float64(jax_verifier):
    """On signature images (mostly white, so the first convs' outputs are
    nearly constant and BatchNorm's E[x^2] - E[x]^2 cancels badly) the
    port's f32 gradient stays within 1e-4 (of each tree leaf's largest
    entry) of the same code in float64, and JAX's f32 gradient within
    5e-2: JAX's f32 reductions lose up to ~2.5 % of a conv weight's
    gradient there (measured 2.47e-2), the port's ~1e-6."""
    params, state = jax_verifier
    imgs = signatures(12, seed=9)
    rs = np.random.RandomState(0)
    a, b = rs.permutation(12)[:6], rs.permutation(12)[:6]
    lab = (rs.rand(6) < 0.5).astype(np.float32)
    rng = jax.random.key(4)

    def jloss(p):
        e1, e2, logits, _ = jmodels.apply_fn(p, state, imgs[a], imgs[b], train=True, rng=rng)
        return (jnp.mean(optax.sigmoid_binary_cross_entropy(logits[:, 0], lab))
                + 0.5 * jmodels.contrastive_loss(e1, e2, lab))
    grads = {"jax": np_tree(jax.grad(jloss)(params))}
    for dt in (torch.float32, torch.float64):
        m = bridge.verifier_from_jax(params, state).to(dt)
        x1, x2, y = (torch.from_numpy(v).to(dt) for v in (imgs[a], imgs[b], lab))
        e1, e2, logits = m(x1, x2, train=True, masks=jax_masks(rng, 6))
        loss = (ttrain.bce_with_logits(logits[:, 0], y).mean()
                + 0.5 * tmodels.contrastive_loss(e1, e2, y))
        grads[dt] = bridge.tensors_to_jax(m, torch.autograd.grad(loss, list(m.parameters())))
    ref = dict(jax.tree_util.tree_flatten_with_path(grads[torch.float64])[0])
    for name, tol in ((torch.float32, 1e-4), ("jax", 5e-2)):
        for path, g in jax.tree_util.tree_flatten_with_path(grads[name])[0]:
            if _conv_bias(jax.tree_util.keystr(path)):
                continue   # 0 up to rounding (a bias before BatchNorm)
            r = np.asarray(ref[path], np.float64)
            err = np.abs(np.asarray(g, np.float64) - r).max() / np.abs(r).max()
            assert err <= tol, (name, jax.tree_util.keystr(path), err)


def _pair_data(n, seed):
    rs = np.random.RandomState(seed)
    imgs = signatures(12, seed)
    a, b = rs.randint(0, 12, n), rs.randint(0, 12, n)
    return imgs[a], imgs[b], (a % 3 == b % 3).astype(np.float32)


def test_pickles_score_the_same_pairs_in_both_packages(tmp_path):
    """``train_verifier`` (2 epochs) in each package; each pickle, loaded by
    the other package's ``evaluate_model``, gives the scores and metrics
    its own package gives; the port's pickle has the JAX layout."""
    train, val, test = _pair_data(24, 1), _pair_data(8, 2), _pair_data(10, 3)
    _, hist = ttrain.train_verifier(train, val, epochs=2, batch_size=8, seed=0,
                                    save_path=tmp_path / "port.pkl", log=False, device="cpu")
    jtrain.train_verifier(train, val, epochs=2, batch_size=8, seed=0,
                          save_path=tmp_path / "jax.pkl", log=False)
    assert len(hist["train"]) == len(hist["val"]) == len(hist["epoch_seconds"]) == 2
    assert all(np.isfinite(h["loss"]) for h in hist["train"])
    with open(tmp_path / "port.pkl", "rb") as f:
        snap = pickle.load(f)
    with open(tmp_path / "jax.pkl", "rb") as f:
        jsnap = pickle.load(f)
    assert jax.tree_util.tree_structure(snap) == jax.tree_util.tree_structure(jsnap)
    for a, b in zip(jax.tree_util.tree_leaves(snap), jax.tree_util.tree_leaves(jsnap)):
        assert a.shape == b.shape and a.dtype == b.dtype
    for name in ("port.pkl", "jax.pkl"):
        s = ttrain.load_verifier(tmp_path / name)
        want = jeval.evaluate_model(jtrain.load_verifier(tmp_path / name), test, batch_size=4)
        got = teval.evaluate_model(s, test, batch_size=4, device="cpu")
        np.testing.assert_allclose(got["y_scores"], want["y_scores"], rtol=RTOL, atol=1e-6)
        assert got["metadata"] == want["metadata"]
        assert got["metrics"]["accuracy"] == want["metrics"]["accuracy"]


def test_report_and_curves_match_jax(tmp_path):
    """``generate_evaluation_report`` on the same results: the same report
    (but its timestamp), improvement percentages included; ``curves.json``
    holds the ROC points of sklearn, the DET points the plot draws and the
    score histograms."""
    rs = np.random.RandomState(4)
    y = (rs.rand(30) < 0.5).astype(np.float32)
    results = {}
    for name, sep in (("baseline", 0.2), ("augmented", 0.4)):
        s = np.clip(y * sep + rs.rand(30) * 0.6, 0, 1).astype(np.float32)
        results[name] = {"metrics": tmetrics.compute_verification_metrics(
            y, s, (s > 0.5).astype(np.float32)), "y_true": y, "y_scores": s,
            "metadata": {"epoch": np.asarray(3), "val_accuracy": np.asarray(0.75)}}
    want = jeval.generate_evaluation_report(results, tmp_path / "j.json")
    got = teval.generate_evaluation_report(results, tmp_path / "t.json")
    want.pop("evaluation_timestamp"), got.pop("evaluation_timestamp")
    assert got == want and set(got["comparison"]) == set(teval.BAR_KEYS)
    assert json.loads((tmp_path / "t.json").read_text())["comparison"] == json.loads(
        (tmp_path / "j.json").read_text())["comparison"]
    curves = json.loads(teval.write_curves(results, tmp_path / "curves.json").read_text())
    from sklearn.metrics import roc_curve
    for name, r in results.items():
        c = curves["models"][name]
        fpr, tpr, thr = roc_curve(r["y_true"], r["y_scores"])
        assert c["roc"]["fpr"] == fpr.tolist() and c["roc"]["tpr"] == tpr.tolist()
        assert c["roc"]["thresholds"][0] is None and c["roc"]["thresholds"][1:] == thr[1:].tolist()
        dfpr, dfnr = jmetrics.det_points(r["y_true"], r["y_scores"])
        m = (dfpr > 0) & (dfnr > 0)
        assert c["det"] == {"fpr": dfpr[m].tolist(), "fnr": dfnr[m].tolist()}
        dens, edges = np.histogram(r["y_scores"][r["y_true"] == 1], bins=30, density=True)
        assert c["scores"]["genuine"]["density"] == pytest.approx(dens.tolist())
        assert c["scores"]["eer_threshold"] == r["metrics"]["eer_threshold"]
    assert curves["bars"]["values"]["augmented"] == [
        results["augmented"]["metrics"][k] for k in teval.BAR_KEYS]


def test_verifier_clis_end_to_end(trees, tmp_path, capsys):
    """``cli.verifier_train`` (baseline and augmented) then
    ``cli.verifier_eval`` on both, on the CPU: the pickles, the history, the
    report with its comparison and ``curves.json``; the port refuses to run
    on a missing card unasked."""
    from siggan_tpu_torch.cli import verifier_eval, verifier_train
    out = tmp_path / "models"
    assert verifier_train.main(["--data_dir", str(trees / "users"), "--synthetic_dir",
                                str(trees / "synth"), "--output_dir", str(out), "--epochs",
                                "2", "--batch_size", "8", "--pairs_per_user", "4",
                                "--device", "cpu"]) == 0
    hist = json.loads((out / "training_history.json").read_text())
    assert set(hist) == {"baseline", "augmented"}
    for r in hist.values():
        assert len(r["history"]["train"]) == 2 and 0 <= r["best_val_accuracy"] <= 1
        assert r["steps"] == 2 * 2 and r["seconds"] > 0
    ev = tmp_path / "eval"
    assert verifier_eval.main(["--data_dir", str(trees / "users"), "--baseline_model",
                               str(out / "verifier_baseline.pkl"), "--augmented_model",
                               str(out / "verifier_augmented.pkl"), "--output_dir", str(ev),
                               "--pairs_per_user", "5", "--device", "cpu"]) == 0
    report = json.loads((ev / "evaluation_report.json").read_text())
    assert set(report["models"]) == {"baseline", "augmented"}
    assert report["models"]["baseline"]["num_test_samples"] == 3 * 2 * 5
    assert set(report["comparison"]) == set(teval.BAR_KEYS)
    assert set(json.loads((ev / "curves.json").read_text())["models"]) == {"baseline", "augmented"}
    assert "accuracy" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device requested"):
            verifier_eval.main(["--data_dir", str(trees / "users"), "--baseline_model",
                                str(out / "verifier_baseline.pkl")])


# -- the verifier: FID backbone ------------------------------------------------------

def test_verifier_backbone_matches_jax_scorer(jax_verifier, tmp_path):
    """``make_scorer("verifier:<pkl>")`` on a JAX pickle: the 512-d features
    of 64 px images, of 128 px images (resized, antialiased) and of RGB
    images equal the JAX scorer's, and so does the FID."""
    from siggan_tpu.eval import fid as jfid
    from siggan_tpu_torch.eval import fid as tfid
    params, state = jax_verifier
    path = tmp_path / "v.pkl"
    jtrain.save_verifier({"params": params, "bn": state, "epoch": 0, "val_accuracy": 0.5}, path)
    jsc = jfid.make_scorer(f"verifier:{path}", batch_size=4)
    tsc = tfid.make_scorer(f"verifier:{path}", batch_size=4, device="cpu")
    assert tsc.backbone == jsc.backbone == f"verifier:{path}"
    rs = np.random.RandomState(6)
    for shape in ((6, 64, 64, 1), (5, 128, 128, 1), (3, 64, 64, 3), (3, 32, 32, 1)):
        x = np.tanh(rs.randn(*shape) * 2).astype(np.float32)
        np.testing.assert_allclose(tsc.features(x), jsc.features(x), rtol=RTOL, atol=ATOL)
    real, fake = signatures(12, 1), signatures(12, 2)
    assert tsc.fid(real, fake) == pytest.approx(jsc.fid(real, fake), rel=1e-4)


def test_cli_evaluate_reports_the_verifier_floor_and_diversity(jax_verifier, tmp_path):
    """``cli.evaluate --backbone verifier:<pkl> --device cpu``: no errors,
    the FID, the split-half real floor and the feature diversity."""
    from siggan_tpu_torch.ckpt.manager import save_generator
    from siggan_tpu_torch.cli import evaluate
    from siggan_tpu_torch.core import rng
    from siggan_tpu_torch.core.config import ModelConfig, TrainConfig
    from siggan_tpu_torch.data.synthetic import save_dataset_pngs
    from siggan_tpu_torch.models.generator import init_fn
    params, state = jax_verifier
    pkl = ttrain.save_verifier({"params": params, "bn": state, "epoch": 1,
                                "val_accuracy": 0.5}, tmp_path / "v.pkl")
    data = save_dataset_pngs(16, tmp_path / "data", seed=3)
    cfg = ModelConfig(latent_dim=16, base_features=32)
    ckpt = save_generator(tmp_path / "ck", init_fn(rng.generator(0, rng.STREAM_INIT_G), cfg),
                          TrainConfig(model=cfg, use_pallas=True, compute_dtype="float32"))
    assert evaluate.main(["--checkpoint", str(ckpt), "--data_dir", str(data), "--n_samples",
                          "16", "--lpips_subset", "4", "--seeds", "0", "--backbone",
                          f"verifier:{pkl}", "--output_dir", str(tmp_path / "out"),
                          "--device", "cpu"]) == 0
    m = json.loads((tmp_path / "out" / "evaluation_report.json").read_text())["metrics"]
    assert m["errors"] == {} and m["fid_backbone"] == f"verifier:{pkl}"
    assert np.isfinite(m["fid"]) and np.isfinite(m["fid_real_floor"])
    assert m["feature_diversity"]["fake"] >= 0 and m["feature_diversity"]["real"] > 0


def test_pair_generation_consumes_the_same_random_stream():
    """generate_pairs is a function of the user lists and the seed only:
    the stdlib stream, consumed in the JAX package's order."""
    users = {f"u{i}": [f"u{i}_{j}" for j in range(3 + i)] for i in range(4)}
    users[tpairs.SYNTHETIC_USER] = ["s0", "s1"]
    assert tpairs.generate_pairs(users, 6, seed=11) == jpairs.generate_pairs(users, 6, seed=11)
    random.seed(0)
    assert tpairs.generate_pairs(users, 2, seed=1) == tpairs.generate_pairs(users, 2, seed=1)
