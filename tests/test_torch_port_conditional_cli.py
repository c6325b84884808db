"""The conditional (v2.0) trainer and CLI end to end on the CPU: grid,
checkpoint, resume with the schedule going on, served with ``class_id``;
the ``--num_classes`` check. Split from ``test_torch_port_conditional.py``,
the tests unchanged."""

import base64
import json

import numpy as np
import pytest

from siggan_tpu_torch.ckpt.manager import CheckpointManager
from siggan_tpu_torch.cli import train as train_cli
from siggan_tpu_torch.core.config import TrainConfig
from siggan_tpu_torch.data import synthetic
from siggan_tpu_torch.infer.export import decode_png
from siggan_tpu_torch.serve.api import ApiCore
from test_torch_port_multistep import few_threads  # noqa: F401  (autouse)


def test_conditional_cli_trains_samples_checkpoints_resumes_and_serves(tmp_path, capsys):
    data = synthetic.save_labeled_dataset_pngs(3, 8, tmp_path / "data", seed=2)
    run = tmp_path / "run"
    argv = ["--data_dir", str(data), "--epochs", "2", "--batch_size", "8",
            "--compute_dtype", "float32", "--checkpoint_interval", "1", "--sample_interval", "1",
            "--run_dir", str(run), "--device", "cpu", "--num_classes", "3",
            "--g_conditioning", "concat", "--spectral_norm", "--latent_dim", "20",
            "--d_lr", "1e-4", "--g_lr", "2e-4", "--lr_schedule", "linear",
            "--diffaugment", "translation,cutout", "--ema_decay", "0.9", "--aux_weight", "0.5"]
    assert train_cli.main(argv) == 0
    out = capsys.readouterr().out
    assert "Writers: 3" in out and "aux_acc_real" in out
    ckpt = run / "checkpoints"
    cfg = TrainConfig.from_json((ckpt / "config.json").read_text())
    # The span was filled in (2 epochs x 3 steps) and travels with the config.
    assert cfg.optim.lr_total_steps == 6 and cfg.model.num_classes == 3
    ep = ckpt / "epoch_0001"
    assert (ep / "generator_ema.npz").exists()
    state, extras = CheckpointManager(ckpt, cfg).restore("latest", "cpu")
    assert state.step == 6 and int(state.g_opt["count"]) == 6
    for opt, lr in ((state.g_opt, 2e-4), (state.d_opt, 1e-4)):
        assert float(opt["lr"]) == pytest.approx(lr * (1 - 2 / 3), rel=1e-6)  # lr(5)
    assert sorted(p.name for p in (run / "samples").glob("*.png"))[-1] == "epoch_0002.png"

    # Resume for a third epoch: the schedule goes on from the restored count.
    assert train_cli.main([a if a != "2" else "3" for a in argv] + ["--resume"]) == 0
    assert "Resumed from epoch 1 (step 6)" in capsys.readouterr().out
    cfg3 = TrainConfig.from_json((ckpt / "config.json").read_text())
    assert cfg3.optim.lr_total_steps == 9
    state, _ = CheckpointManager(ckpt, cfg3).restore("latest", "cpu")
    assert state.step == 9
    assert float(state.g_opt["lr"]) == pytest.approx(2e-4 * (1 - 4 / 5), rel=1e-6)  # lr(8)

    # Served with class_id: the EMA generator, images that repeat for a
    # seed and differ between classes.
    core = ApiCore(device="cpu")
    core.load_model(str(ckpt))
    assert core.info()["num_classes"] == 3

    def images(class_id):
        payload, _ = core.generate({"n": 2, "seed": 5, "format": "base64",
                                    "class_id": class_id})
        return [decode_png(base64.b64decode(s)) for s in json.loads(payload)["images"]]
    a0, a0_again, a2 = images(0), images(0), images(2)
    assert all(np.array_equal(p, q) for p, q in zip(a0, a0_again))
    assert not all(np.array_equal(p, q) for p, q in zip(a0, a2))
    assert a0[0].shape[:2] == (64, 64)


def test_cli_refuses_a_num_classes_mismatch(tmp_path):
    data = synthetic.save_labeled_dataset_pngs(2, 2, tmp_path, seed=0)
    with pytest.raises(SystemExit, match="--num_classes=3 but found 2 writer subdirs"):
        train_cli.main(["--data_dir", str(data), "--num_classes", "3", "--batch_size", "2",
                        "--device", "cpu", "--run_dir", str(tmp_path / "run")])
