"""``cli.train --num_data_devices N`` on the CPU: the CLI starts N gloo
ranks itself (``parallel/mesh.py::spawn``), only rank 0 writes files, the
checkpoint equals a one-rank run's, a run of 2 ranks resumes on 1, a stop
file ends every rank, and the refusals (a global batch the ranks do not
divide, more ranks than were launched or than there are cards).

The model is the CLI's full-width default at batch 8 on 16 PNGs (2 steps
an epoch), with learning rates 1/100 of the defaults so that Adam's
sign-like first steps keep the two runs' weights within the f32 bar
(rtol 1e-4 / atol 1e-5); the moments are bf16 (the default), held to 1e-2
of each array's largest entry.
"""

import json
import shutil
import threading
import time

import numpy as np
import pytest
import torch

from siggan_tpu_torch.cli import train as train_cli
from siggan_tpu_torch.core.config import MeshConfig, TrainConfig
from siggan_tpu_torch.data.synthetic import save_dataset_pngs
from siggan_tpu_torch.train.trainer import GANTrainer

TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture
def ranks_env(monkeypatch):
    """Two torch threads per spawned rank."""
    monkeypatch.setenv("OMP_NUM_THREADS", "2")


def argv(data, run, *extra):
    return ["--data_dir", str(data), "--batch_size", "8", "--compute_dtype", "float32",
            "--g_lr", "2e-6", "--d_lr", "2e-6", "--checkpoint_interval", "1",
            "--sample_interval", "1", "--run_dir", str(run), "--device", "cpu", *extra]


def arrays(run, epoch, name):
    with np.load(run / "checkpoints" / f"epoch_{epoch:04d}" / name) as z:
        return {k: z[k] for k in z.files}


def files(root):
    """The run's files; a log's name (its start time) as its suffix."""
    return sorted(f"logs/*{p.suffix}" if p.parent.name == "logs" else str(p.relative_to(root))
                  for p in root.rglob("*") if p.is_file())


@pytest.fixture(scope="module")
def two_rank_run(tmp_path_factory):
    """One epoch of 2 steps on 2 ranks, and the same on one."""
    root = tmp_path_factory.mktemp("dpcli")
    data = save_dataset_pngs(16, root / "data", seed=3)
    mp = pytest.MonkeyPatch()
    mp.setenv("OMP_NUM_THREADS", "2")
    try:
        assert train_cli.main(argv(data, root / "two", "--epochs", "1",
                                   "--num_data_devices", "2")) == 0
    finally:
        mp.undo()
    assert train_cli.main(argv(data, root / "one", "--epochs", "1",
                               "--num_data_devices", "1")) == 0
    return root, data


def test_two_ranks_write_once_and_match_one_rank(two_rank_run):
    root, _ = two_rank_run
    two, one = root / "two", root / "one"
    # Rank 0 alone wrote: the same files as the one-rank run (one log, one
    # grid per sample epoch, one checkpoint), nothing twice.
    assert files(two) == files(one)
    assert len(list((two / "logs").glob("*.json"))) == 1
    idx = json.loads((two / "checkpoints" / "index.json").read_text())
    assert idx["latest"] == 0 and idx["epochs"] == [0]
    state = json.loads((two / "checkpoints" / "epoch_0000" / "state.json").read_text())
    assert state["step"] == 2
    for name in ("generator.npz", "discriminator.npz"):
        a, b = arrays(two, 0, name), arrays(one, 0, name)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_allclose(a[k], b[k], **TOL, err_msg=f"{name} {k}")
    # The moments: 1e-2 of each array's largest entry (bf16), and 1e-8 / 1e-16
    # (m / v) where BatchNorm cancels a gradient to rounding noise (G's fc
    # bias, ~1e-10).
    a, b = arrays(two, 0, "optimizer.npz"), arrays(one, 0, "optimizer.npz")
    assert a.keys() == b.keys()
    for k in a:
        x, y = a[k].astype(np.float32), b[k].astype(np.float32)
        floor = 1e-16 if "/v/" in k else 1e-8
        np.testing.assert_allclose(x, y, rtol=1e-2, atol=max(1e-2 * np.abs(y).max(), floor),
                                   err_msg=k)
    logs = [json.loads(next((r / "logs").glob("*.json")).read_text())["metrics"][0]
            for r in (two, one)]
    for k in ("d_loss", "g_loss", "d_real_mean", "d_fake_mean", "d_on_g_mean"):
        np.testing.assert_allclose(logs[0][k], logs[1][k], **TOL, err_msg=k)


def test_two_rank_run_resumes_on_one_rank(two_rank_run, capsys, tmp_path):
    root, data = two_rank_run
    run = tmp_path / "two"
    shutil.copytree(root / "two", run)
    assert train_cli.main(argv(data, run, "--epochs", "2", "--resume",
                               "--num_data_devices", "1")) == 0
    assert "Resumed from epoch 0 (step 2)" in capsys.readouterr().out
    idx = json.loads((run / "checkpoints" / "index.json").read_text())
    assert idx["latest"] == 1
    state = json.loads((run / "checkpoints" / "epoch_0001" / "state.json").read_text())
    assert state["step"] == 4


def test_stop_file_ends_every_rank(tmp_path, ranks_env):
    """The stop file appears after the second checkpoint: rank 0 sees it and
    its decision ends both ranks at the same window (neither waits in a
    collective for the other), and the last checkpoint is saved. The trainer
    also polls before each epoch, and a stop seen there labels the final
    checkpoint with the last finished epoch; waiting for epoch 1's checkpoint
    keeps that label at 1 or more wherever the stop lands."""
    data = save_dataset_pngs(16, tmp_path / "data", seed=3)
    run, stop = tmp_path / "run", tmp_path / "STOP"
    second = run / "checkpoints" / "epoch_0001" / "state.json"

    def touch_after_second_checkpoint():
        deadline = time.time() + 600
        while not second.exists() and time.time() < deadline:
            time.sleep(0.05)
        stop.touch()

    watcher = threading.Thread(target=touch_after_second_checkpoint, daemon=True)
    watcher.start()
    assert train_cli.main(argv(data, run, "--epochs", "200", "--num_data_devices", "2",
                               "--stop_file", str(stop))) == 0
    watcher.join(timeout=5)
    assert not watcher.is_alive()
    idx = json.loads((run / "checkpoints" / "index.json").read_text())
    assert 0 < idx["latest"] < 199


def test_refusals(tmp_path):
    data = save_dataset_pngs(2, tmp_path, seed=0)
    with pytest.raises(ValueError, match="global batch 8 not divisible by data-axis size 3"):
        train_cli.main(argv(data, tmp_path / "r", "--num_data_devices", "3"))
    # The card: more ranks than visible cards (none here).
    with pytest.raises(ValueError, match="exceeds the 0 visible devices"):
        train_cli.main(["--data_dir", str(data), "--num_data_devices", "2"])
    # A trainer in one process asked for a mesh of 2.
    cfg = TrainConfig(batch_size=2, mesh=MeshConfig(num_data=2))
    with pytest.raises(ValueError, match=r"mesh \(2 data ranks\) exceeds the launched "
                                         r"ranks \(1\)"):
        GANTrainer(cfg, np.zeros((4, 64, 64, 1), np.float32), device="cpu")
    assert train_cli.ranks_to_start(train_cli.parse_arguments(
        ["--data_dir", "d", "--device", "cpu"])) == 1
    assert train_cli.ranks_to_start(train_cli.parse_arguments(
        ["--data_dir", "d", "--device", "cpu", "--num_data_devices", "4"])) == 4


def test_rank_other_than_zero_writes_nothing(tmp_path, monkeypatch):
    """The logger and the checkpoint manager of a rank other than 0 create
    no directory and write no file; its stop decision is rank 0's."""
    from siggan_tpu_torch.ckpt.manager import CheckpointManager
    from siggan_tpu_torch.core.state import create_train_state
    from siggan_tpu_torch.utils.logger import GANLogger
    cfg = TrainConfig(checkpoint_dir=str(tmp_path / "c"))
    log = GANLogger(tmp_path / "l", write=False)
    log.log_metrics(0, {"d_loss": 1.0})
    assert log.save_to_csv() is None and log.save_to_json() is None
    mgr = CheckpointManager(cfg.checkpoint_dir, cfg, authoritative=True, write=False)
    assert mgr.save(create_train_state(cfg, "cpu"), epoch=0,
                    fixed_noise=torch.zeros(2, 100)) is None
    assert list(tmp_path.iterdir()) == []
    assert log.metrics[0]["d_loss"] == 1.0


def test_stop_decision_is_rank_zeros(tmp_path):
    """A rank other than 0 does not read the stop file: it takes rank 0's
    decision (``DataMesh.decide``)."""
    from siggan_tpu_torch.core.config import ModelConfig
    stop = tmp_path / "STOP"
    stop.touch()
    cfg = TrainConfig(model=ModelConfig(latent_dim=16, base_features=32), batch_size=4,
                      checkpoint_dir=str(tmp_path / "c"), sample_dir=str(tmp_path / "s"),
                      log_dir=str(tmp_path / "l"))
    trainer = GANTrainer(cfg, np.zeros((8, 64, 64, 1), np.float32), stop_file=str(stop),
                         device="cpu")
    assert trainer._should_stop()
    seen = []

    class Mesh:
        def decide(self, flag):
            seen.append(flag)
            return "rank 0's"
    trainer.mesh, trainer.main = Mesh(), False
    assert trainer._should_stop() == "rank 0's" and seen == [False]
