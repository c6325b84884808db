"""The trainer's profiler hook (``profile_dir``) and the synthetic-set disk
cache (``SIGGAN_SYNTH_CACHE``) on the CPU.

The hook traces epoch ``start_epoch + 1`` on either route and after a
resume, as the JAX trainer picks its epoch, and ``cli.train
--profile_dir`` trains; the cache hits, serves prefixes, regenerates a
corrupt file, warns once on a failed write, never reads the JAX package's
files, and returns the JAX package's arrays. Small widths on 2 torch
threads."""

import json
import warnings

import numpy as np
import pytest

from siggan_tpu.data import synthetic as jsyn
from siggan_tpu_torch.cli import train as train_cli
from siggan_tpu_torch.core.config import ModelConfig, TrainConfig
from siggan_tpu_torch.data import synthetic as syn
from siggan_tpu_torch.data.synthetic import save_dataset_pngs
from siggan_tpu_torch.train.trainer import GANTrainer
from test_torch_port_multistep import few_threads  # noqa: F401

SMALL = dict(latent_dim=8, base_features=16)


def small_cfg(tmp_path, **kw):
    return TrainConfig(**{"model": ModelConfig(**SMALL), "batch_size": 4,
                          "compute_dtype": "float32", "checkpoint_dir": str(tmp_path / "c"),
                          "sample_dir": str(tmp_path / "s"), "log_dir": str(tmp_path / "l"),
                          **kw})


def trace_names(path):
    return {e.get("name", "") for e in json.loads(path.read_text())["traceEvents"]}


@pytest.mark.parametrize("resident_data", [True, False])
def test_profile_dir_traces_the_epoch_after_the_first(tmp_path, capsys, resident_data):
    """Three epochs: only epoch 1 is traced, into ``profile_dir`` as a
    Chrome trace holding the step's operations; after a resume from epoch
    1's checkpoint the traced epoch is start_epoch + 1 = 3."""
    images = syn.generate_dataset(8, 64, seed=1)
    prof = tmp_path / "prof"
    cfg = small_cfg(tmp_path, epochs=3, resident_data=resident_data, profile_dir=str(prof),
                    checkpoint_interval=1)
    GANTrainer(cfg, images, device="cpu").train()
    assert f"Profiler trace written to {prof}" in capsys.readouterr().out
    assert [p.name for p in prof.iterdir()] == ["epoch_0001.pt.trace.json"]
    assert "aten::convolution" in trace_names(prof / "epoch_0001.pt.trace.json")
    resumed = GANTrainer(cfg.replace(epochs=5), images, device="cpu")
    assert resumed.resume(1) and resumed.start_epoch == 2
    resumed.train()
    assert sorted(p.name for p in prof.iterdir()) == ["epoch_0001.pt.trace.json",
                                                     "epoch_0003.pt.trace.json"]


def test_cli_train_profile_dir_trains_and_writes_a_trace(tmp_path, capsys):
    data = save_dataset_pngs(8, tmp_path / "data", seed=2)
    prof = tmp_path / "prof"
    assert train_cli.main(["--data_dir", str(data), "--epochs", "2", "--batch_size", "4",
                           "--latent_dim", "8", "--compute_dtype", "float32",
                           "--run_dir", str(tmp_path / "run"), "--profile_dir", str(prof),
                           "--device", "cpu"]) == 0
    assert f"Profiler trace written to {prof}" in capsys.readouterr().out
    assert (prof / "epoch_0001.pt.trace.json").stat().st_size > 0


@pytest.fixture
def cache(tmp_path, monkeypatch):
    d = tmp_path / "synth"
    monkeypatch.setenv("SIGGAN_SYNTH_CACHE", str(d))
    monkeypatch.setattr(syn, "_write_failed_warned", False)
    return d


def test_cache_hits_serves_prefixes_and_equals_the_jax_arrays(cache, monkeypatch):
    a = syn.generate_dataset(6, 32, seed=3)
    assert sorted(p.name for p in cache.iterdir()) == ["synth_torch_g1_32px_seed3.npy"]
    with monkeypatch.context() as mp:
        mp.setattr(syn, "make_signature", lambda *a, **k: 1 / 0)
        b = syn.generate_dataset(4, 32, seed=3)        # a prefix of the cached six
    np.testing.assert_array_equal(b, a[:4])
    monkeypatch.delenv("SIGGAN_SYNTH_CACHE")
    np.testing.assert_array_equal(a, syn.generate_dataset(6, 32, seed=3))
    np.testing.assert_array_equal(a, jsyn.generate_dataset(6, 32, seed=3))
    x, y = jsyn.generate_labeled_dataset(2, 3, 32, seed=4)
    monkeypatch.setenv("SIGGAN_SYNTH_CACHE", str(cache))
    for _ in range(2):   # written, then read back
        got = syn.generate_labeled_dataset(2, 3, 32, seed=4)
        np.testing.assert_array_equal(got[0], x)
        np.testing.assert_array_equal(got[1], y)
    assert (cache / "labeled_torch_g1_2w3_32px_seed4.npz").exists()


def test_cache_regenerates_a_corrupt_file_and_ignores_the_jax_packages(cache, monkeypatch):
    want = syn.generate_dataset(3, 32, seed=5)
    path = cache / "synth_torch_g1_32px_seed5.npy"
    path.write_bytes(path.read_bytes()[:100])     # cut short
    np.testing.assert_array_equal(syn.generate_dataset(3, 32, seed=5), want)
    np.testing.assert_array_equal(np.load(path), want)
    (cache / "labeled_torch_g1_1w2_32px_seed5.npz").write_bytes(b"not a zip")
    np.testing.assert_array_equal(syn.generate_labeled_dataset(1, 2, 32, seed=5)[0],
                                  jsyn.generate_labeled_dataset(1, 2, 32, seed=5)[0])
    # A JAX package's cache file of the same set, with other pixels, is not read.
    np.save(cache / "synth_32px_seed6.npy", np.zeros((9, 32, 32, 1), np.float32))
    np.savez(cache / "labeled_1w2_32px_seed6.npz", images=np.zeros((2, 32, 32, 1)),
             labels=np.zeros(2, np.int32))
    assert syn.generate_dataset(2, 32, seed=6).min() < 0
    assert syn.generate_labeled_dataset(1, 2, 32, seed=6)[0].min() < 0


def test_a_failed_cache_write_warns_once(tmp_path, monkeypatch):
    blocker = tmp_path / "file"
    blocker.write_text("a file where the cache directory should be")
    monkeypatch.setenv("SIGGAN_SYNTH_CACHE", str(blocker / "sub"))
    monkeypatch.setattr(syn, "_write_failed_warned", False)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        a = syn.generate_dataset(2, 32, seed=7)
        syn.generate_dataset(2, 32, seed=8)
        syn.generate_labeled_dataset(1, 2, 32, seed=7)
    msgs = [str(w.message) for w in caught if issubclass(w.category, RuntimeWarning)]
    assert len(msgs) == 1 and "SIGGAN_SYNTH_CACHE" in msgs[0]
    np.testing.assert_array_equal(a, jsyn.generate_dataset(2, 32, seed=7))
