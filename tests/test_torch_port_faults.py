"""Faults found in the port against the JAX package, each repaired with its
test: the gradient norms ``log_grad_norms`` asks for (in the step, against
the JAX step, and in the trainer's log), serving and sampling any saved
epoch (``--which``, ``load_session``, ``--info``'s ``available``), a data
directory with image files the port cannot decode, and the training CLI's
account of what it trains."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_train import TINY, jax_draws, port_cfg, port_state

from siggan_tpu.core.config import ModelConfig as JModelConfig
from siggan_tpu.core.config import OptimConfig as JOptimConfig
from siggan_tpu.core.config import TrainConfig as JTrainConfig
from siggan_tpu.core.state import create_train_state as j_create_train_state
from siggan_tpu.train.train_step import make_train_step as j_make_train_step
from siggan_tpu_torch.cli import generate as generate_cli
from siggan_tpu_torch.cli import train as train_cli
from siggan_tpu_torch.core.config import ModelConfig, TrainConfig
from siggan_tpu_torch.data.dataset import SignatureDataset
from siggan_tpu_torch.data.synthetic import generate_dataset, save_dataset_pngs
from siggan_tpu_torch.infer.generate import load_session
from siggan_tpu_torch.parallel.mesh import make_mesh
from siggan_tpu_torch.train.train_step import make_train_step
from siggan_tpu_torch.train.trainer import GANTrainer, check_trainer_supported


@pytest.mark.parametrize("clip", [None, 0.05])
def test_grad_norms_match_the_jax_step(clip):
    """d_grad_norm / g_grad_norm: the global norm of the raw gradients
    (before any clipping), equal to JAX's on injected draws."""
    jcfg = JTrainConfig(model=JModelConfig(**TINY), batch_size=4, compute_dtype="float32",
                        seed=0, rng_impl="threefry2x32", log_grad_norms=True,
                        optim=JOptimConfig(gradient_clip_value=clip))
    cfg = port_cfg(jcfg)
    js = j_create_train_state(jcfg)
    st = port_state(js, cfg)
    real = generate_dataset(4, 64, seed=6)
    _, jm = jax.jit(j_make_train_step(jcfg))(js, jnp.asarray(real))
    _, m = make_train_step(cfg)(st, torch.from_numpy(real), jax_draws(jcfg, 0, 4))
    for k in ("d_grad_norm", "g_grad_norm"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4, atol=1e-6, err_msg=k)
    assert float(m["d_grad_norm"]) > 0 and float(m["g_grad_norm"]) > 0


def small_run(tmp_path, epochs=2, **kw):
    """A two-epoch CPU run of the tiny model on 16 images (2 steps an epoch),
    checkpointed every epoch; returns the trainer."""
    cfg = TrainConfig(model=ModelConfig(**TINY), batch_size=8, compute_dtype="float32",
                      seed=5, epochs=epochs, sample_interval=0, checkpoint_interval=1,
                      checkpoint_dir=str(tmp_path / "c"), sample_dir=str(tmp_path / "s"),
                      log_dir=str(tmp_path / "l"), **kw)
    trainer = GANTrainer(cfg, generate_dataset(16, 64, seed=4), device="cpu")
    trainer.train()
    return trainer


def test_trainer_logs_the_optional_metric_keys(tmp_path):
    trainer = small_run(tmp_path, epochs=1, log_grad_norms=True)
    logged = trainer.logger.metrics[-1]
    assert logged["d_grad_norm"] > 0 and logged["g_grad_norm"] > 0
    saved = json.loads(next((tmp_path / "l").glob("*.json")).read_text())["metrics"][-1]
    assert saved["d_grad_norm"] == logged["d_grad_norm"]


def test_best_and_an_epoch_are_served_and_listed(tmp_path, capsys):
    small_run(tmp_path)
    ckpt = tmp_path / "c"
    idx = json.loads((ckpt / "index.json").read_text())
    assert idx["epochs"] == [0, 1] and idx["best"] in (0, 1)

    def images(which):
        return load_session(str(ckpt), which, device="cpu").sample(3, seed=2)

    # A run's alias or epoch number serves the same generator as that epoch's
    # own directory; the two epochs differ.
    best = ckpt / f"epoch_{idx['best']:04d}"
    np.testing.assert_array_equal(images("best"), load_session(str(best), device="cpu")
                                  .sample(3, seed=2))
    np.testing.assert_array_equal(images(1), images("latest"))
    assert not np.array_equal(images(0), images(1))
    with pytest.raises(FileNotFoundError, match="epoch_"):
        load_session(str(best), "best", device="cpu")
    with pytest.raises(FileNotFoundError, match="7"):
        load_session(str(ckpt), 7, device="cpu")

    capsys.readouterr()
    assert generate_cli.main(["--checkpoint", str(ckpt), "--which", "best", "--info"]) == 0
    info = json.loads(capsys.readouterr().out)
    assert info["available"]["epochs"] == [0, 1]
    assert info["available"]["best"] == idx["best"] and info["available"]["latest"] == 1
    out = tmp_path / "gen"
    assert generate_cli.main(["--checkpoint", str(ckpt), "--which", "0", "--n_samples", "2",
                              "--output_dir", str(out), "--device", "cpu"]) == 0
    assert len(list(out.glob("*.png"))) == 2


def test_dataset_refuses_images_it_cannot_decode(tmp_path):
    """C.3, then A.6: the dataset reads the JAX package's formats (a .JPG
    next to PNGs is trained on, as PIL reads it; so is a CMYK JPEG) and
    refuses, naming A.6, only a file of a kind not read yet (an AVIF under
    a .tif name; a BigTIFF, an LZMA TIFF, a CCITT TIFF in tiles, an LZMA
    TIFF of the ARM64 BCJ filter, a WebP and an ICO under a .tif name, this
    test's such kinds before A.6.7, A.6.13, A.6.16, A.6.25, A.6.30 and
    A.6.37, are read)."""
    from PIL import Image
    save_dataset_pngs(3, tmp_path, seed=1)
    assert len(SignatureDataset(tmp_path, 64, use_cache=False)) == 3
    (tmp_path / "sub").mkdir()
    scan = (np.random.RandomState(0).rand(40, 90) * 255).astype(np.uint8)
    Image.fromarray(scan).save(tmp_path / "sub" / "scan.JPG", "JPEG", quality=90)
    ds = SignatureDataset(tmp_path, 64, use_cache=False)
    assert len(ds) == 4 and ds.paths[-1].name == "scan.JPG"
    with Image.open(tmp_path / "sub" / "scan.JPG") as im:
        want = np.asarray(im.convert("L").resize((64, 64), Image.BILINEAR), np.float32)
    np.testing.assert_array_equal(ds.images[-1, ..., 0], want / 255.0 * 2.0 - 1.0)
    Image.fromarray(scan).convert("CMYK").save(tmp_path / "sub" / "scan2.jpg", "JPEG")
    ds = SignatureDataset(tmp_path, 64, use_cache=False)
    with Image.open(tmp_path / "sub" / "scan2.jpg") as im:
        want = np.asarray(im.convert("L").resize((64, 64), Image.BILINEAR), np.float32)
    assert len(ds) == 5 and ds.paths[-1].name == "scan2.jpg"
    np.testing.assert_array_equal(ds.images[-1, ..., 0], want / 255.0 * 2.0 - 1.0)
    Image.fromarray(scan).save(tmp_path / "sub" / "scan3.tif", big_tiff=True)
    ds = SignatureDataset(tmp_path, 64, use_cache=False)
    with Image.open(tmp_path / "sub" / "scan3.tif") as im:
        want = np.asarray(im.convert("L").resize((64, 64), Image.BILINEAR), np.float32)
    assert len(ds) == 6 and ds.paths[-1].name == "scan3.tif"
    np.testing.assert_array_equal(ds.images[-1, ..., 0], want / 255.0 * 2.0 - 1.0)
    from test_torch_port_decode import unread_bytes, webp_bytes
    (tmp_path / "sub" / "scan4.tif").write_bytes(webp_bytes())
    ds = SignatureDataset(tmp_path, 64, use_cache=False)
    with Image.open(tmp_path / "sub" / "scan4.tif") as im:
        want = np.asarray(im.convert("L").resize((64, 64), Image.BILINEAR), np.float32)
    assert len(ds) == 7 and ds.paths[-1].name == "scan4.tif"
    np.testing.assert_array_equal(ds.images[-1, ..., 0], want / 255.0 * 2.0 - 1.0)
    (tmp_path / "sub" / "scan5.tif").write_bytes(unread_bytes())
    with pytest.raises(NotImplementedError, match="AVIF.*A.6"):
        SignatureDataset(tmp_path, 64, use_cache=False)


def test_train_cli_doc_names_only_what_raises(tmp_path):
    """The CLI's docstring lists the flags that raise: none now. Spectral
    norm (v1.1), EMA, the in-training FID, shared fakes, the profiler and
    several cards (its usage is in the docstring) train, and so do the
    fused generator forwards (a config field, no flag)."""
    doc = " ".join(train_cli.__doc__.split())
    assert "Flags of features" not in doc and "NotImplementedError" not in doc
    assert "--num_data_devices 4" in doc and "torchrun --nproc_per_node 4" in doc
    images = np.zeros((8, 128, 128, 1), np.float32)
    args = train_cli.parse_arguments(["--data_dir", str(tmp_path), "--image_size", "128",
                                      "--spectral_norm"])
    check_trainer_supported(train_cli.build_config(args), images)
    args = train_cli.parse_arguments(["--data_dir", str(tmp_path), "--ema_decay", "0.99"])
    check_trainer_supported(train_cli.build_config(args), images)
    args = train_cli.parse_arguments(["--data_dir", str(tmp_path), "--fid_interval", "5"])
    check_trainer_supported(train_cli.build_config(args), images)
    args = train_cli.parse_arguments(["--data_dir", str(tmp_path), "--share_fakes"])
    check_trainer_supported(train_cli.build_config(args), images)
    check_trainer_supported(train_cli.build_config(args).replace(fuse_g_forwards=True),
                            images)
    args = train_cli.parse_arguments(["--data_dir", str(tmp_path), "--profile_dir", "p"])
    check_trainer_supported(train_cli.build_config(args), images)
    # Several cards: the config is accepted; a single launched rank refuses
    # a mesh of 4.
    args = train_cli.parse_arguments(["--data_dir", str(tmp_path), "--num_data_devices", "4"])
    cfg = train_cli.build_config(args)
    check_trainer_supported(cfg, images)
    with pytest.raises(ValueError, match=r"exceeds the launched ranks \(1\)"):
        make_mesh(cfg.mesh, "cpu")
