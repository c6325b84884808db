"""The JAX package's figures drawn without matplotlib, against the JAX
package: ``utils/visualizer.py`` (real against fake, interpolation strip,
loss curves, the training GIF, the progress montage), ``cli.verifier_eval``'s
four charts and ``cli.ablate``'s five, under the JAX file names and
conditions; PIL reads the port's GIF back to the exact frames, its frame
count, delay and loop; a line and a bar chart of known values put the
series' colour where the axes map the values (within 1 px); the same input
gives the same bytes."""

import io

import numpy as np
import pytest
from PIL import Image

from siggan_tpu.train import ablation as jabl
from siggan_tpu.utils import visualizer as jvis
from siggan_tpu.verify import eval as jeval
from siggan_tpu_torch.infer.export import decode_png, encode_gif
from siggan_tpu_torch.train import ablation as tabl
from siggan_tpu_torch.utils import visualizer as vis
from siggan_tpu_torch.verify import eval as teval
from siggan_tpu_torch.verify.metrics import compute_verification_metrics


def near(img, col, row, colour, r=1):
    """Whether ``colour`` is within ``r`` px of (col, row)."""
    c, w = int(round(col)), int(round(row))
    box = img[max(w - r, 0):w + r + 1, max(c - r, 0):c + r + 1]
    return bool((box == np.asarray(colour, np.uint8)).all(-1).any())


def results(seed=0):
    rs = np.random.RandomState(seed)
    out = {}
    for name, sep in (("baseline", 1.0), ("augmented", 1.6)):
        y = np.r_[np.ones(60), np.zeros(60)].astype(np.float32)
        s = (1 / (1 + np.exp(-(rs.randn(120) + sep * (2 * y - 1))))).astype(np.float32)
        out[name] = {"metrics": compute_verification_metrics(y, s, (s > 0.5).astype(np.float32),
                                                             0.5),
                     "y_true": y, "y_scores": s, "metadata": {}}
    return out


def test_verifier_eval_writes_the_jax_charts(tmp_path, monkeypatch):
    """Both packages' ``evaluate_signature_verifier`` on the same scores
    write the same chart files; the port's decode at the JAX figures' pixel
    sizes and repeat byte for byte."""
    res = results()
    for mod in (jeval, teval):
        monkeypatch.setattr(mod, "load_verifier", lambda path: path)
        monkeypatch.setattr(mod, "evaluate_model", lambda name, *a, **k: res[name])
    models = {"baseline": "baseline", "augmented": "augmented"}
    jeval.evaluate_signature_verifier(models, None, tmp_path / "j")
    teval.evaluate_signature_verifier(models, None, tmp_path / "t", device="cpu")
    names = sorted(p.name for p in (tmp_path / "j").glob("*.png"))
    assert names == sorted(p.name for p in (tmp_path / "t").glob("*.png")) == [
        "det.png", "metric_comparison.png", "roc.png", "score_distributions.png"]
    shapes = {"roc.png": (550, 660, 3), "det.png": (550, 660, 3),
              "score_distributions.png": (440, 1320, 3), "metric_comparison.png": (495, 990, 3)}
    for name, shape in shapes.items():
        data = (tmp_path / "t" / name).read_bytes()
        assert decode_png(data).shape == shape
    teval.evaluate_signature_verifier(models, None, tmp_path / "t2", device="cpu")
    for name in shapes:
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "t2" / name).read_bytes()


@pytest.mark.parametrize("with_fid", [True, False])
def test_ablation_writes_the_jax_charts(tmp_path, with_fid):
    """Both managers' ``save_plots`` on the same runs write the same files:
    the FID's two only when a run has a FID."""
    images = np.zeros((4, 64, 64, 1), np.float32)
    managers = (jabl.AblationStudyManager(images, tmp_path / "j"),
                tabl.AblationStudyManager(images, tmp_path / "t", device="cpu"))
    for mod, mgr in zip((jabl, tabl), managers):
        for i, (z, act) in enumerate(((50, "relu"), (100, "leaky_relu"))):
            cfg = mod.AblationConfig(latent_dim=z, g_activation=act)
            mgr.results.append(mod.AblationResult(
                cfg, 0.5 + i, 1.0 + i, 0.01 * (i + 1), 0.02, 80.0 - 10 * i if with_fid else None,
                3.0 + i, 1000 * (i + 1), 2000))
            mgr.histories[cfg.short_name] = {"d_loss": [1.0, 0.8, 0.7 + i / 10],
                                             "g_loss": [0.5, 0.9, 1.1]}
        mgr.save_plots()
    want = ["loss_curves.png", "stability.png", "wall_time.png"] + (
        ["fid_comparison.png", "params_vs_fid.png"] if with_fid else [])
    for d in ("j", "t"):
        assert sorted(p.name for p in (tmp_path / d).glob("*.png")) == sorted(want)
    shapes = {"loss_curves.png": (495, 1320, 3), "stability.png": (440, 990, 3),
              "wall_time.png": (440, 990, 3), "fid_comparison.png": (440, 990, 3),
              "params_vs_fid.png": (495, 660, 3)}
    for name in want:
        assert decode_png((tmp_path / "t" / name).read_bytes()).shape == shapes[name]


def test_line_chart_puts_each_series_where_the_axes_map_it(tmp_path):
    metrics = [{"epoch": e, "d_loss": 1.0 / (e + 1), "g_loss": 0.3 + 0.2 * e}
               for e in range(6)] + [{"epoch": 6, "g_loss": 1.7}]
    chart = vis.losses_chart(metrics)
    img = decode_png(vis.plot_losses(metrics, tmp_path / "l.png").read_bytes())
    assert img.shape == (495, 880, 3) and np.array_equal(img, chart.img)
    for i, key in enumerate(("d_loss", "g_loss")):
        for m in metrics:
            if key in m:
                assert near(img, *chart.px(m["epoch"], m[key]), vis.colour(i)), (key, m)
    # The value axis runs from the data's low to its high end, padded by 5 %.
    lo, hi = 1.0 / 6, 1.7
    pad = 0.05 * (hi - lo)
    assert chart.px(0, lo - pad)[1] == pytest.approx(chart.bottom)
    assert chart.px(6, hi + pad) == pytest.approx((chart.right, chart.top))
    assert vis.plot_losses([], tmp_path / "none.png") is None


def test_bar_charts_fill_to_the_mapped_heights():
    values = [3.0, 7.5, 0.5]
    chart = vis.bar_chart(["a", "bb", "ccc"], values)
    blue = vis.colour(0)
    for i, v in enumerate(values):
        col, top = chart.px(i, v)
        assert near(chart.img, col, top + 2, blue, 0) and near(chart.img, col, top + 1, blue)
        assert not near(chart.img, col, top - 2, blue, 0)
        assert near(chart.img, col, chart.px(i, v / 2)[1], blue, 0)
    res = results(1)
    bars = teval.metric_bars_chart(res)
    for i, name in enumerate(res):
        for j, key in enumerate(teval.BAR_KEYS):
            v = float(res[name]["metrics"][key])
            x = j - 0.4 + (i + 0.5) * 0.4        # the middle of model i's bar
            c, r = bars.px(x, v / 2)
            assert near(bars.img, c, r, vis.colour(i), 0), (name, key)
            if v > 0.05:
                assert near(bars.img, c, bars.px(x, v)[1] + 1, vis.colour(i))


def test_gif_decodes_in_pil_to_the_exact_frames():
    rs = np.random.RandomState(2)
    frames = [rs.randint(0, 256, (70, 90)).astype(np.uint8) for _ in range(3)]
    frames += [np.full((70, 90), 17, np.uint8), (np.arange(6300) % 251).astype(np.uint8)
               .reshape(70, 90)]
    data = encode_gif(frames, duration_ms=250)
    assert data == encode_gif(frames, duration_ms=250)
    im = Image.open(io.BytesIO(data))
    assert im.n_frames == 5 and im.info["loop"] == 0 and im.info["duration"] == 250
    for i, f in enumerate(frames):
        im.seek(i)
        assert im.info["duration"] == 250
        np.testing.assert_array_equal(np.asarray(im.convert("L")), f)
    with pytest.raises(ValueError):
        encode_gif([])


def grids(tmp_path, n=3):
    rs = np.random.RandomState(3)
    d = tmp_path / "samples"
    d.mkdir()
    for e in range(n):
        grid = vis.make_grid(vis.to_uint8(rs.uniform(-1, 1, (8, 16, 16, 1))), nrow=4)
        (d / f"epoch_{e:04d}.png").write_bytes(jvis_png(grid))
    return d


def jvis_png(u8):
    buf = io.BytesIO()
    Image.fromarray(u8[..., 0]).save(buf, format="PNG")
    return buf.getvalue()


def test_training_gif_and_montage_match_the_jax_packages(tmp_path):
    """``create_training_gif`` of a sample directory: the same frames as the
    JAX package's GIF (PIL), with its delay and loop; the montage has a
    panel a grid under its epoch."""
    d = grids(tmp_path)
    port = vis.create_training_gif(d, tmp_path / "t.gif", duration_ms=200)
    jax_gif = jvis.create_training_gif(d, tmp_path / "j.gif", duration_ms=200)
    a, b = Image.open(port), Image.open(jax_gif)
    assert a.n_frames == b.n_frames == 3 and a.info["loop"] == b.info["loop"] == 0
    for i in range(3):
        a.seek(i)
        b.seek(i)
        assert a.info["duration"] == b.info["duration"] == 200
        np.testing.assert_array_equal(np.asarray(a.convert("L")), np.asarray(b.convert("L")))
    assert vis.create_training_gif(tmp_path / "nothing", tmp_path / "n.gif") is None
    montage = decode_png(vis.save_progress_montage(d, tmp_path / "m.png").read_bytes())
    assert montage.shape == (286, 3 * 242, 3)
    assert jvis.save_progress_montage(d, tmp_path / "jm.png").exists()
    assert vis.save_progress_montage(tmp_path / "nothing", tmp_path / "n.png") is None


def test_real_vs_fake_and_interpolation_strip_equal_the_jax_pixels(tmp_path):
    rs = np.random.RandomState(4)
    real, fake = rs.uniform(-1, 1, (10, 12, 12, 1)), rs.uniform(-1, 1, (10, 12, 12, 1))
    frames = rs.uniform(-1, 1, (7, 12, 12, 1))
    for port, jax_fn, args in ((vis.save_real_vs_fake, jvis.save_real_vs_fake, (real, fake)),
                               (vis.save_interpolation_strip, jvis.save_interpolation_strip,
                                (frames,))):
        got = decode_png(port(*args, tmp_path / "t.png").read_bytes())
        want = np.asarray(Image.open(jax_fn(*args, tmp_path / "j.png")))
        np.testing.assert_array_equal(got[..., 0], want)


def test_losses_from_json_and_the_same_bytes_twice(tmp_path):
    log = tmp_path / "log.json"
    log.write_text('{"metrics": [{"epoch": 0, "d_loss": 1.0, "g_loss": 2.0}, '
                   '{"epoch": 1, "d_loss": 0.5, "g_loss": 2.5}]}')
    a = vis.plot_losses_from_json(log, tmp_path / "a.png").read_bytes()
    b = vis.plot_losses_from_json(log, tmp_path / "b.png").read_bytes()
    assert a == b and decode_png(a).shape == (495, 880, 3)
    assert jvis.plot_losses_from_json(log, tmp_path / "j.png").exists()
