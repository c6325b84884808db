"""In-training FID and the FID-keyed ``best`` checkpoint, against the JAX
package, on the CPU (tiny generator, 8-image FID sets at 299 px).

- ``CheckpointManager.save(..., fid=)``: the same sequence of saves through
  the JAX manager and the port's gives the same ``index.json`` (``best``,
  ``best_fid``, ``best_g_loss``) and the same running best G loss; exact.
- The trainer's real FID subset equals the JAX trainer's images (the
  expression ``RandomState(seed).permutation(N)[:fid_samples]``), exact;
  each epoch logs a finite ``fid`` equal (rtol 1e-6) to a fresh scorer's
  ``fid`` of the same fakes; ``best`` follows the lowest FID, also after a
  resume.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from siggan_tpu.ckpt.manager import CheckpointManager as JManager
from siggan_tpu.core.config import ModelConfig as JModelConfig
from siggan_tpu.core.config import TrainConfig as JTrainConfig
from siggan_tpu.train.trainer import GANTrainer as JTrainer
from siggan_tpu_torch.ckpt.manager import CheckpointManager
from siggan_tpu_torch.core.config import ModelConfig, TrainConfig
from siggan_tpu_torch.core.state import create_train_state
from siggan_tpu_torch.data.synthetic import generate_dataset, generate_labeled_dataset
from siggan_tpu_torch.eval.fid import FIDScorer
from siggan_tpu_torch.train.train_step import make_eval_generate
from siggan_tpu_torch.train.trainer import GANTrainer

TINY = dict(latent_dim=16, base_features=32)
FIELDS = dict(batch_size=8, seed=3, sample_interval=0, checkpoint_interval=1,
              fid_interval=1, fid_samples=8)


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads for this file's CPU work (the 299 px Inception
    passes): the suite runs files in parallel workers, and a full-width
    pool in each oversubscribes the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def dirs(root):
    return dict(checkpoint_dir=str(root / "c"), sample_dir=str(root / "s"),
                log_dir=str(root / "l"))


def port_cfg(root, **kw):
    return TrainConfig(**{"model": ModelConfig(**TINY), "compute_dtype": "float32",
                          **FIELDS, **kw}, **dirs(root))


@pytest.fixture(scope="module")
def images():
    return generate_dataset(16, 64, seed=8)


@pytest.fixture(scope="module")
def jax_trainer(images, tmp_path_factory):
    cfg = JTrainConfig(model=JModelConfig(**TINY), compute_dtype="float32", **FIELDS,
                       **dirs(tmp_path_factory.mktemp("jax")))
    return JTrainer(cfg, images, use_mesh=False)


SAVES = [(1.0, None), (0.8, 7.0), (0.5, None), (0.9, 9.0), (0.7, 6.0)]


def test_fid_keyed_best_rules_match_jax(tmp_path, capsys, jax_trainer):
    """FID wins once recorded; an epoch without a FID never becomes best
    (and warns); each save's best G loss is kept either way."""
    cfg = port_cfg(tmp_path)
    state = create_train_state(cfg, "cpu")
    port = CheckpointManager(tmp_path / "p", cfg)
    jax_mgr = JManager(tmp_path / "j", jax_trainer.cfg)
    noise = torch.zeros(4, 16)
    for epoch, (g_loss, fid) in enumerate(SAVES):
        port.save(state, epoch=epoch, fixed_noise=noise, g_loss=g_loss, fid=fid)
        jax_mgr.save(jax_trainer.state, epoch=epoch, fixed_noise=jnp.zeros((4, 16)),
                     g_loss=g_loss, fid=fid)
        assert port.available() == jax_mgr.available(), epoch
        if epoch == 0:
            assert port.available()["best"] == 0 and "best_fid" not in port.available()
    assert port.available() == {"epochs": [0, 1, 2, 3, 4], "latest": 4, "best": 4,
                                "best_g_loss": 1.0, "best_fid": 6.0}
    assert capsys.readouterr().out.count("saved without a FID") == 2   # epoch 2, both
    meta = json.loads((port.resolve("latest") / "state.json").read_text())
    # min(index best_g_loss, this save's g_loss); JAX stores it as f32.
    assert meta["best_g_loss"] == 0.7
    assert meta["best_g_loss"] == pytest.approx(jax_mgr.restore("latest")[1]["best_g_loss"],
                                                rel=1e-7)
    assert port.resolve("best") == port.resolve(4)


def test_trainer_scores_fid_and_keeps_the_fid_best(tmp_path, capsys, images, jax_trainer):
    trainer = GANTrainer(port_cfg(tmp_path, epochs=2), images, device="cpu")
    sel = np.random.RandomState(3).permutation(16)[:8]
    np.testing.assert_array_equal(trainer._fid_real, images[sel])
    np.testing.assert_array_equal(trainer._fid_real, np.asarray(jax_trainer._fid_real))
    trainer.train()
    logs = [m["fid"] for m in trainer.logger.metrics]
    assert len(logs) == 2 and all(np.isfinite(logs)) and min(logs) > 0
    assert capsys.readouterr().out.count("FID epoch") == 2
    idx = trainer.ckpt.available()
    assert idx["best_fid"] == min(logs) and idx["best"] == int(np.argmin(logs))
    # The logged FID is the scorer's FID of the same fakes.
    fakes = make_eval_generate(trainer.cfg)(trainer.state, trainer._fid_noise)
    fresh = FIDScorer(batch_size=8, device="cpu").fid(trainer._fid_real, fakes.numpy())
    assert logs[-1] == pytest.approx(fresh, rel=1e-6)

    # Resume: one more epoch; best_fid stays the minimum over all three.
    resumed = GANTrainer(port_cfg(tmp_path, epochs=3), images, device="cpu")
    assert resumed.resume("latest") and resumed.start_epoch == 2
    resumed.train()
    fids = logs + [m["fid"] for m in resumed.logger.metrics]
    idx = resumed.ckpt.available()
    assert idx["epochs"] == [0, 1, 2] and idx["best_fid"] == min(fids)
    assert idx["best"] == int(np.argmin(fids))

    # fid_interval must divide checkpoint_interval, or the trainer warns.
    GANTrainer(port_cfg(tmp_path / "w", fid_interval=2), images, device="cpu")
    assert "does not divide checkpoint_interval" in capsys.readouterr().out


def test_conditional_trainer_fid_labels(tmp_path):
    images, labels = generate_labeled_dataset(4, 4, 64, seed=3)
    cfg = port_cfg(tmp_path, model=ModelConfig(num_classes=4, g_conditioning="concat",
                                               **TINY))
    trainer = GANTrainer(cfg, images, device="cpu", labels=labels)
    assert trainer._fid_labels.tolist() == [0, 1, 2, 3, 0, 1, 2, 3]
    assert np.isfinite(trainer._compute_fid())
