"""The port's evaluation layer against the JAX package's, on the CPU.

Same inputs (numpy seeds) and, through ``bridge.inception_from_jax`` /
``bridge.lpips_from_jax``, the same weights go through ``siggan_tpu.eval``
and ``siggan_tpu_torch.eval``. Tolerances:

- Inception features, block outputs and ``prepare_images``: the f32 bar,
  rtol 1e-4 / atol 1e-5 (the same products summed in another order).
- LPIPS distances and diversity: rtol 1e-4 / atol 1e-6 (values ~1e-2).
- Stroke stats, and the host FID / KID / precision-recall math on the same
  float64 features: equal to 1e-12 relative (the same numpy code).
- ``compute_metrics`` whole, on 8 real and 8 fake 64 px images: FID, KID
  and LPIPS rtol 1e-4, precision/recall and stroke stats equal. The
  random-init conditioning divides each feature by the real set's std +
  1e-6, which magnifies the features' f32 differences; the features are
  held at the f32 bar first, and the test prints the features' and the
  FID's relative differences (1.3e-6 and 1.0e-6 when written).
- ``score_with_discriminator``: rtol 1e-4 / atol 1e-6 on the probabilities.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from siggan_tpu.eval import evaluate as jev
from siggan_tpu.eval import fid as jfid
from siggan_tpu.eval import inception as jinc
from siggan_tpu.eval import lpips as jlpips
from siggan_tpu.eval import stroke as jstroke
from siggan_tpu.eval.manifests import INCEPTION_V3_SD, synthetic_state_dict
from siggan_tpu_torch import bridge
from siggan_tpu_torch.eval import evaluate as tev
from siggan_tpu_torch.eval import fid as tfid
from siggan_tpu_torch.eval import inception as tinc
from siggan_tpu_torch.eval import lpips as tlpips
from siggan_tpu_torch.eval import stroke as tstroke

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads for this file's CPU work (the 299 px Inception
    passes): the suite runs files in parallel workers, and a full-width
    pool in each oversubscribes the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_scorer():
    """The JAX package's random-init scorer (``init_params(0)``)."""
    return jfid.FIDScorer(batch_size=8)


@pytest.fixture(scope="module")
def port_scorer(jax_scorer):
    """The port's random-init scorer carrying JAX's weights, so that both
    condition their features the same way."""
    scorer = tfid.FIDScorer(batch_size=8, device="cpu")
    tinc.load_torchvision(scorer.model, bridge.inception_from_jax(jax_scorer.params))
    return scorer


def images(n, size=64, seed=0, c=1):
    return np.random.RandomState(seed).uniform(-1, 1, (n, size, size, c)).astype(np.float32)


@pytest.mark.parametrize("size", [64, 128])
def test_prepare_images_matches_jax(size):
    x = images(2, size, seed=size)
    want = np.asarray(jinc.prepare_images(jnp.asarray(x)))
    got = tinc.prepare_images(torch.from_numpy(x)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, 299, 299, 3)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # The edge rows and columns of the resize, where the two clamp.
    np.testing.assert_allclose(got[:, [0, -1]], want[:, [0, -1]], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[:, :, [0, -1]], want[:, :, [0, -1]], rtol=RTOL, atol=ATOL)


def test_state_dict_names_are_torchvision_keys():
    keys = set(tinc.InceptionV3().state_dict())
    want = {k for k in INCEPTION_V3_SD if not k.startswith(("AuxLogits.", "fc."))}
    assert keys == want
    for k, v in tinc.InceptionV3().state_dict().items():
        assert tuple(v.shape) == INCEPTION_V3_SD[k], k
    assert sum(p.numel() for p in tinc.init_inception(0).parameters()) == 21_785_568


def test_init_inception_law():
    m = tinc.init_inception(3)
    w = m.Mixed_6b.branch7x7_2.conv.weight        # (c7, c7, 1, 7)
    std = (2.0 / (1 * 7 * 128)) ** 0.5
    assert w.shape == (128, 128, 1, 7) and float(w.abs().max()) <= 2 * std + 1e-7
    assert float(w.std()) == pytest.approx(std * 0.8796, rel=0.02)   # truncated at 2 sigma
    bn = m.Mixed_6b.branch7x7_2.bn
    assert torch.equal(bn.weight, torch.ones(128)) and torch.equal(bn.bias, torch.zeros(128))
    assert torch.equal(bn.running_var, torch.ones(128)) and not m.training
    assert torch.equal(w, tinc.init_inception(3).Mixed_6b.branch7x7_2.conv.weight)


# (module, JAX block fn, NHWC input shape): non-square inputs, so that an
# asymmetric conv padded (W, H) instead of (H, W) fails.
BLOCKS = [("Mixed_5b", jinc._inception_a, (2, 9, 11, 192)),
          ("Mixed_6a", jinc._inception_b, (2, 9, 11, 288)),
          ("Mixed_6b", jinc._inception_c, (2, 7, 9, 768)),
          ("Mixed_7a", jinc._inception_d, (2, 9, 11, 768)),
          ("Mixed_7b", jinc._inception_e, (2, 5, 7, 1280))]


@pytest.mark.parametrize("name,jfn,shape", BLOCKS, ids=[b[0] for b in BLOCKS])
def test_inception_block_matches_jax(jax_scorer, port_scorer, name, jfn, shape):
    x = np.random.RandomState(1).rand(*shape).astype(np.float32)
    want = np.asarray(jfn(jax_scorer.params[name], jnp.asarray(x)))
    with torch.no_grad():
        got = getattr(port_scorer.model, name)(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def real_fake():
    return images(8, seed=9), np.tanh(images(8, seed=10) * 3)


def test_inception_features_match_jax(jax_scorer, port_scorer, real_fake):
    """The full-width network on 8 real and 8 fake 64 px images (resized to
    299), features held directly: a consistent permutation of the 2048
    would leave every metric unchanged."""
    for x in real_fake:
        got, want = port_scorer.features(x), jax_scorer.features(x)
        assert got.shape == (8, tinc.FEATURE_DIM) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def lpips_pair():
    jp = jlpips.init_params(0)
    return jp, tlpips.from_state_dict(bridge.lpips_from_jax(jp))


def test_lpips_distance_and_diversity_match_jax(lpips_pair):
    jp, model = lpips_pair
    a, b = images(4, seed=3, c=3), images(4, seed=4, c=3)
    want = np.asarray(jlpips.distance(jp, jnp.asarray(a), jnp.asarray(b)))
    with torch.no_grad():
        got = tlpips.distance(model, torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    assert np.all(got > 0)
    fakes = images(12, seed=5)
    assert tlpips.diversity(model, fakes) == pytest.approx(jlpips.diversity(jp, fakes),
                                                           rel=1e-4, abs=1e-6)
    assert tlpips.diversity(model, fakes[:1]) == 0.0


def test_lpips_init_and_torch_state_dict():
    m = tlpips.init_lpips(0)
    assert [tuple(c.weight.shape) for c in m.convs] == [
        (64, 3, 11, 11), (192, 64, 5, 5), (384, 192, 3, 3), (256, 384, 3, 3), (256, 256, 3, 3)]
    assert float(m.convs[1].weight.std()) == pytest.approx(1 / np.sqrt(25 * 64), rel=0.02)
    assert all(torch.allclose(lin, torch.full_like(lin, 1 / len(lin))) for lin in m.lins)
    from siggan_tpu.eval.manifests import ALEXNET_SD, LPIPS_ALEX_LIN_SD
    alex = synthetic_state_dict(ALEXNET_SD, seed=1)
    lins = synthetic_state_dict(LPIPS_ALEX_LIN_SD, seed=2)
    got = tlpips.from_state_dict(tlpips.convert_torch_state_dict(alex, lins))
    want = bridge.lpips_from_jax(jlpips.convert_torch_state_dict(alex, lins))
    for k, v in got.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_stroke_stats_match_jax():
    for x in (images(6, seed=6), images(5, seed=7, c=3)):
        assert tstroke.calculate_stroke_density(x, device="cpu") == pytest.approx(
            jstroke.calculate_stroke_density(x), rel=1e-12)
        got = tstroke.calculate_foreground_ratio(x, device="cpu")
        want = jstroke.calculate_foreground_ratio(x)
        assert got["percentiles"] == pytest.approx(want["percentiles"], rel=1e-12)
        assert (got["mean"], got["std"]) == pytest.approx((want["mean"], want["std"]),
                                                          rel=1e-12)
    tr = tstroke.MetricsTracker()
    tr.add("fid", torch.tensor(2.0))
    tr.add("fid", 4.0)
    assert tr.get_average("fid") == 3.0
    tr.reset()
    assert tr.get_history("fid") == [3.0] and tr.get_last("fid") == 3.0


def test_host_metrics_match_jax():
    rs = np.random.RandomState(8)
    fr, ff = rs.randn(40, 16), rs.randn(30, 16) * 1.3 + 0.2
    assert tfid.frechet_distance(fr, ff) == pytest.approx(jfid.frechet_distance(fr, ff),
                                                          rel=1e-12)
    assert tfid.frechet_distance(fr, fr) == 0.0
    assert tfid.kernel_distance(fr, ff) == pytest.approx(jfid.kernel_distance(fr, ff),
                                                         rel=1e-12)
    assert tfid.precision_recall(fr, ff) == jfid.precision_recall(fr, ff)
    with pytest.raises(ValueError, match=">= 2 samples"):
        tfid.kernel_distance(fr[:1], ff)


def test_compute_metrics_matches_jax(jax_scorer, port_scorer, lpips_pair, real_fake,
                                     capsys):
    """After the features (above, at the f32 bar): the conditioned metrics."""
    real, fake = real_fake
    ff_j, ff_t = jax_scorer.features(fake), port_scorer.features(fake)
    want = jev.compute_metrics(real, fake, scorer=jax_scorer)
    got = tev.compute_metrics(real, fake, scorer=port_scorer,
                              lpips_params=bridge.lpips_from_jax(lpips_pair[0]),
                              lpips_backbone="random-init", device="cpu")
    feat_rel = float(np.max(np.abs(ff_t - ff_j)) / np.max(np.abs(ff_j)))
    with capsys.disabled():
        print(f"features max rel diff {feat_rel:.3e}; FID port {got['fid']!r} "
              f"JAX {want['fid']!r} (rel {abs(got['fid'] / want['fid'] - 1):.3e})")
    assert got["errors"] == want["errors"] == {}
    assert set(got) == set(want)
    assert got["fid_backbone"] == want["fid_backbone"] == "random-init"
    assert got["lpips_backbone"] == want["lpips_backbone"] == "random-init"
    assert got["fid"] > 0 and got["fid"] == pytest.approx(want["fid"], rel=1e-4)
    assert got["kid_mean"] == pytest.approx(want["kid_mean"], rel=1e-4)
    assert (got["precision"], got["recall"]) == (want["precision"], want["recall"])
    assert got["lpips_diversity"] == pytest.approx(want["lpips_diversity"], rel=1e-4)
    for key in ("stroke_density", "foreground_ratio"):
        assert json.dumps(got[key], sort_keys=True) == json.dumps(want[key], sort_keys=True)
    tev.print_summary(got)
    assert "relative metric" in capsys.readouterr().out


def test_compute_metrics_records_each_failure(monkeypatch):
    """One broken metric never kills the report; its error is recorded."""
    from siggan_tpu_torch.eval import lpips as lp

    def boom(*a, **k):
        raise RuntimeError("lpips broke")
    monkeypatch.setattr(lp, "diversity", boom)
    res = tev.compute_metrics(images(4, seed=11), images(4, seed=12),
                              fid_backbone="nope:x", device="cpu")
    assert res["errors"]["fid"].startswith("ValueError: unknown FID backbone")
    assert res["errors"]["lpips"] == "RuntimeError: lpips broke"
    assert "stroke_density" in res and "fid" not in res


def test_torchvision_spec_and_verifier(tmp_path):
    """A synthetic torchvision state dict (every key of the published file)
    through ``torchvision:<file>``: the port's features equal the JAX
    package's ``convert_torch_state_dict`` of the same dict. The
    ``verifier:<pkl>`` spec builds a scorer of the verifier's 512-d features
    (held against the JAX scorer in ``test_torch_port_verify.py``)."""
    sd = synthetic_state_dict(INCEPTION_V3_SD, seed=0, torch_tensors=True)
    path = tmp_path / "inception.pt"
    torch.save(sd, path)
    scorer = tfid.make_scorer(f"torchvision:{path}", batch_size=2, device="cpu")
    assert scorer.backbone == "torchvision"
    x = images(2, 64, seed=13)
    want = jfid.FIDScorer(jinc.convert_torch_state_dict(sd), batch_size=2).features(x)
    got = scorer.features(x)
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL * float(np.abs(want).max()))
    # The CLI's --inception_weights reads the same dict from .npz too.
    from siggan_tpu_torch.cli.evaluate import _load_inception_weights
    np.savez(tmp_path / "inception.npz", **{k: v.numpy() for k, v in sd.items()})
    loaded = tfid.FIDScorer(_load_inception_weights(str(tmp_path / "inception.npz")),
                            device="cpu").model.state_dict()
    assert all(torch.equal(v, scorer.model.state_dict()[k]) for k, v in loaded.items())
    from siggan_tpu_torch.verify import models as vmodels
    from siggan_tpu_torch.verify import train as vtrain
    pkl = vtrain.save_verifier(vtrain.snapshot(vmodels.init_fn(torch.Generator().manual_seed(0)),
                                               0, 0.5), tmp_path / "verifier.pkl")
    verifier = tfid.make_scorer(f"verifier:{pkl}", batch_size=2, device="cpu")
    assert verifier.backbone == f"verifier:{pkl}" and verifier.features(x).shape == (2, 512)
    with pytest.raises(FileNotFoundError):
        tfid.make_scorer(f"verifier:{tmp_path / 'missing.pkl'}", device="cpu")
    del sd["Mixed_7c.branch_pool.conv.weight"]
    torch.save(sd, path)
    with pytest.raises(ValueError, match="required keys missing"):
        tfid.make_scorer(f"torchvision:{path}", device="cpu")


def test_score_with_discriminator_matches_jax():
    from siggan_tpu.core.config import ModelConfig as JModelConfig
    from siggan_tpu.infer.generate import GeneratorSession as JSession
    from siggan_tpu.models import discriminator as jdisc
    import jax
    from siggan_tpu_torch.core.config import ModelConfig
    from siggan_tpu_torch.infer.generate import GeneratorSession
    from siggan_tpu_torch.models.generator import Generator
    x = images(5, seed=14)
    for kw in ({}, {"num_classes": 4, "use_spectral_norm": True}):
        jcfg, cfg = JModelConfig(latent_dim=16, base_features=32, **kw), ModelConfig(
            latent_dim=16, base_features=32, **kw)
        d_params, d_state = jdisc.init_fn(jax.random.key(3), jcfg)
        d_params = jax.tree_util.tree_map(lambda a: a * 3.0, d_params)  # spread the logits
        np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
        d = bridge.d_from_jax(np_tree(d_params), cfg, "cpu", np_tree(d_state))
        session = GeneratorSession(Generator(cfg), compute_dtype="float32", device="cpu")
        y = np.arange(5) % 4 if kw else None
        want = JSession.score_with_discriminator(None, x, d_params, d_state, jcfg, y=y)
        got = session.score_with_discriminator(x, d, y=y)
        assert got.shape == (5,) and got.std() > 1e-3
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
        if kw:
            with pytest.raises(ValueError, match="requires labels y"):
                session.score_with_discriminator(x, d)


def test_cli_report_matches_jax_cli(tmp_path, monkeypatch, jax_scorer, lpips_pair):
    """``cli.evaluate`` on tiny checkpoints, on the same flags as the JAX
    CLI (``--n_samples 8 --max_real 8 --lpips_subset 8 --seeds 0 1``): the
    report's keys equal the JAX report's at every level, the seeds
    aggregate, the grids are written, and ``--inception_weights`` with
    ``--backbone`` is refused. The JAX CLI's backbones are memoized: its
    random-init scorer (``init_params(0)``, an 18 s threefry init on the
    CPU, and its compiled forward) and LPIPS weights."""
    from siggan_tpu.ckpt.manager import CheckpointManager as JManager
    from siggan_tpu.cli import evaluate as jcli
    from siggan_tpu.core import platform as jplatform
    from siggan_tpu.core.config import ModelConfig as JModelConfig
    from siggan_tpu.core.config import TrainConfig as JTrainConfig
    from siggan_tpu.core.state import create_train_state as j_create_train_state
    from siggan_tpu_torch.ckpt.manager import save_generator
    from siggan_tpu_torch.cli import evaluate as tcli
    from siggan_tpu_torch.core import rng
    from siggan_tpu_torch.core.config import ModelConfig, TrainConfig
    from siggan_tpu_torch.data.synthetic import save_dataset_pngs
    from siggan_tpu_torch.models.generator import init_fn
    from siggan_tpu_torch.ops.kernels import generator_fwd as gf

    data = save_dataset_pngs(10, tmp_path / "data", seed=3)
    tiny = dict(latent_dim=16, base_features=32)
    port_ckpt = save_generator(tmp_path / "pc", init_fn(rng.generator(0, rng.STREAM_INIT_G),
                                                        ModelConfig(**tiny)),
                               TrainConfig(model=ModelConfig(**tiny), use_pallas=True,
                                           compute_dtype="float32"))
    jcfg = JTrainConfig(model=JModelConfig(**tiny), compute_dtype="float32")
    js = j_create_train_state(jcfg)
    JManager(tmp_path / "jc", jcfg).save(js, epoch=0, g_loss=1.0,
                                         fixed_noise=jnp.zeros((4, 16)))
    monkeypatch.setattr(jplatform, "setup", lambda *a, **k: None)
    monkeypatch.setattr(jfid, "make_scorer", lambda spec, batch_size=32: jax_scorer)
    monkeypatch.setattr(jlpips, "init_params", lambda seed=0: lpips_pair[0])
    flags = ["--data_dir", str(data), "--n_samples", "8", "--max_real", "8",
             "--lpips_subset", "8", "--seeds", "0", "1", "--batch_size", "8"]
    assert jcli.main(["--checkpoint", str(tmp_path / "jc"), "--output_dir",
                      str(tmp_path / "jout")] + flags) == 0
    before = gf.LAUNCHES.count
    assert tcli.main(["--checkpoint", str(port_ckpt), "--output_dir", str(tmp_path / "out"),
                      "--device", "cpu"] + flags) == 0
    assert gf.LAUNCHES.count == before   # the CPU runs B4's plain version
    want = json.loads((tmp_path / "jout" / "evaluation_report.json").read_text())
    got = json.loads((tmp_path / "out" / "evaluation_report.json").read_text())

    def keys(d):
        return {k: keys(v) if isinstance(v, dict) and k not in ("errors", "per_seed")
                else None for k, v in d.items()}
    assert keys(got) == keys(want)
    m = got["metrics"]
    assert m["errors"] == want["metrics"]["errors"] == {}
    assert (got["n_samples"], got["n_real"], got["seeds"]) == (8, 8, [0, 1])
    assert m["fid_backbone"] == "random-init" and m["seed"] == 0 and m["fid"] > 0
    for key in ("fid", "lpips_diversity"):
        per = m["multi_seed"][key]["per_seed"]
        assert sorted(per) == ["0", "1"] and per["0"] == m[key]
        assert m["multi_seed"][key]["mean"] == pytest.approx(np.mean(list(per.values())))
    for f in ("fake_grid.png", "real_grid.png", "sample_grid_1.png"):
        assert (tmp_path / "out" / f).exists(), f
    assert not (tmp_path / "out" / "sample_grid_2.png").exists()
    with pytest.raises(SystemExit, match="mutually exclusive"):
        tcli.main(["--checkpoint", str(port_ckpt), "--device", "cpu", "--inception_weights",
                   "w.pt", "--backbone", "torchvision:w.pt"] + flags)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(["--checkpoint", str(port_ckpt)] + flags)
