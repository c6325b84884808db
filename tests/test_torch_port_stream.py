"""The streaming route against the JAX package on the CPU: the port's
``data/loader.py::BatchLoader`` batch for batch against the JAX loader
(with and without labels, across epochs, ``drop_last``, ``shuffle``,
``len()``, the size checks), the trainer's choice of route against the JAX
trainer's rule, the first streamed batch, a stop file mid-epoch, a resume's
epoch order, conditional streaming, the refusals (no labels, a mesh), and
the streamed step's graph buffers replayed without a capture against eager
steps. Small widths (base 16, latent 8, batch 4) on 2 torch threads."""

import copy

import numpy as np
import pytest
import torch

from siggan_tpu.core.config import ModelConfig as JModelConfig
from siggan_tpu.core.config import TrainConfig as JTrainConfig
from siggan_tpu.data.loader import BatchLoader as JBatchLoader
from siggan_tpu.train import trainer as jtrainer
from siggan_tpu_torch.core.config import ModelConfig, TrainConfig
from siggan_tpu_torch.core.state import create_train_state
from siggan_tpu_torch.data.loader import BatchLoader
from siggan_tpu_torch.data.synthetic import generate_dataset, generate_labeled_dataset
from siggan_tpu_torch.parallel.mesh import DataMesh
from siggan_tpu_torch.train.train_step import make_stream_step, make_train_step
from siggan_tpu_torch.train.trainer import GANTrainer, is_resident
from test_torch_port_multistep import assert_states_equal, few_threads  # noqa: F401
from test_torch_port_multistep import uncaptured

SMALL = dict(latent_dim=8, base_features=16)


def small_cfg(tmp_path, **kw):
    return TrainConfig(**{"model": ModelConfig(**SMALL), "batch_size": 4,
                          "compute_dtype": "float32", "checkpoint_dir": str(tmp_path / "c"),
                          "sample_dir": str(tmp_path / "s"), "log_dir": str(tmp_path / "l"),
                          **kw})


def jax_batches(loader, epoch):
    return [tuple(np.asarray(v) for v in b) if isinstance(b, tuple) else (np.asarray(b),)
            for b in loader.epoch(epoch)]


def port_batches(loader, epoch):
    return [tuple(v.numpy() for v in b) if isinstance(b, tuple) else (b.numpy(),)
            for b in loader.epoch(epoch)]


@pytest.mark.parametrize("n,bs,shuffle,drop_last,labelled", [
    (23, 4, True, True, False),
    (23, 4, True, False, True),     # a partial last batch
    (24, 6, False, True, True),
    (10, 10, True, False, False),
    (7, 3, False, False, False),
])
def test_batches_equal_the_jax_loaders(n, bs, shuffle, drop_last, labelled):
    rs = np.random.RandomState(n)
    images = rs.rand(n, 5, 4, 1).astype(np.float32)
    labels = rs.randint(0, 7, n).astype(np.int32) if labelled else None
    kw = dict(labels=labels, shuffle=shuffle, drop_last=drop_last, seed=11)
    port = BatchLoader(images, bs, device="cpu", **kw)
    jax_loader = JBatchLoader(images, bs, **kw)
    assert len(port) == len(jax_loader)
    for epoch in (0, 1, 5):
        got, want = port_batches(port, epoch), jax_batches(jax_loader, epoch)
        assert len(got) == len(want) == len(port)
        for g, w in zip(got, want):
            assert len(g) == len(w) == (2 if labelled else 1)
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)


def test_size_checks_and_mesh_refusal():
    images = np.zeros((3, 2, 2, 1), np.float32)
    for loader in (BatchLoader, JBatchLoader):
        kw = {"device": "cpu"} if loader is BatchLoader else {}
        with pytest.raises(ValueError, match=r"dataset shard \(3\) smaller than the "
                                             r"per-process batch \(4\)"):
            loader(images, 4, **kw)
        with pytest.raises(ValueError, match=r"labels \(2\) and images \(3\) lengths differ"):
            loader(images, 2, labels=np.zeros(2, np.int32), **kw)
    assert len(BatchLoader(images, 4, drop_last=False, device="cpu")) == 1
    # A one-rank mesh yields the global batch; a mesh forces drop_last.
    one = BatchLoader(images, 2, mesh=DataMesh(1, 0, "cpu"), drop_last=False, device="cpu")
    plain = BatchLoader(images, 2, device="cpu")
    assert len(one) == len(plain) == 1 and one.drop_last
    for a, b in zip(one.epoch(0), plain.epoch(0)):
        assert torch.equal(a, b) and a.shape == (2, 2, 2, 1)
    with pytest.raises(TypeError, match="DataMesh"):
        BatchLoader(images, 2, mesh=object(), device="cpu")


@pytest.mark.parametrize("resident_data,max_mb", [(True, 4096), (True, 0), (False, 4096)])
def test_route_follows_the_jax_trainers_rule(tmp_path, monkeypatch, resident_data, max_mb):
    """The trainer streams when ``resident_data`` is off or the set is over
    ``resident_max_mb`` (0 MB here), as the JAX GANTrainer decides."""
    images = generate_dataset(8, 64, seed=1)
    cfg = small_cfg(tmp_path, resident_data=resident_data, resident_max_mb=max_mb)
    monkeypatch.setattr(jtrainer, "create_train_state", lambda c: None)
    jcfg = JTrainConfig(model=JModelConfig(**SMALL), batch_size=4, resident_data=resident_data,
                        resident_max_mb=max_mb, checkpoint_dir=str(tmp_path / "jc"),
                        log_dir=str(tmp_path / "jl"), sample_dir=str(tmp_path / "js"))
    want = jtrainer.GANTrainer(jcfg, images, use_mesh=False).resident
    trainer = GANTrainer(cfg, images, device="cpu")
    assert is_resident(cfg, images) == trainer.resident == want
    assert (trainer.loader is None) == want and hasattr(trainer, "images_dev") == want


def recording(trainer, seen):
    """Wrap the trainer's step so that it records each streamed batch."""
    inner = trainer._step_fn

    def step(state, *batch):
        seen.append([b.clone() for b in batch])
        return inner(state, *batch)
    step.graphed = inner.graphed
    trainer._step_fn = step


def test_streamed_run_sees_the_jax_loaders_batches_and_resumes(tmp_path, capsys):
    """Two epochs streamed (resident_data off): every batch the step gets is
    the JAX loader's (seed cfg.seed, epoch keyed); a new trainer resumed
    from epoch 0's checkpoint trains epoch 1 on the same batches and ends
    on the same state as the uninterrupted run."""
    images = generate_dataset(12, 64, seed=2)
    cfg = small_cfg(tmp_path, epochs=2, resident_data=False, seed=3)
    trainer = GANTrainer(cfg, images, device="cpu")
    seen = []
    recording(trainer, seen)
    trainer.train()
    assert "(streaming, 2 batches copied ahead)" in capsys.readouterr().out
    jl = JBatchLoader(images, 4, seed=3)
    want = [b[0] for e in range(2) for b in jax_batches(jl, e)]
    assert len(seen) == len(want) == 6 and trainer.state.step == 6
    for got, w in zip(seen, want):
        np.testing.assert_array_equal(got[0].numpy(), w)
    m = trainer.logger.metrics
    assert len(m) == 2 and all(np.isfinite([e["d_loss"], e["g_loss"], e["ms_per_step"],
                                            e["images_per_sec"]]).all() for e in m)

    first = GANTrainer(cfg.replace(epochs=1, checkpoint_dir=str(tmp_path / "c1"),
                                   log_dir=str(tmp_path / "l1")), images, device="cpu")
    first.train()
    resumed = GANTrainer(cfg.replace(checkpoint_dir=str(tmp_path / "c1"),
                                     log_dir=str(tmp_path / "l2")), images, device="cpu")
    assert resumed.resume("latest") and resumed.start_epoch == 1
    seen2 = []
    recording(resumed, seen2)
    resumed.train()
    assert len(seen2) == 3
    for got, w in zip(seen2, want[3:]):
        np.testing.assert_array_equal(got[0].numpy(), w)
    assert_states_equal(resumed.state, trainer.state)


def test_stop_file_stops_a_streamed_epoch(tmp_path, capsys):
    images = generate_dataset(16, 64, seed=4)
    stop = tmp_path / "STOP"
    cfg = small_cfg(tmp_path, epochs=3, resident_data=False)
    trainer = GANTrainer(cfg, images, stop_file=str(stop), device="cpu")
    inner = trainer._step_fn

    def step(state, *batch):
        if state.step == 1:
            stop.touch()
        return inner(state, *batch)
    step.graphed = inner.graphed
    trainer._step_fn = step
    trainer.train()
    assert "stopping mid-epoch" in capsys.readouterr().out
    assert trainer.state.step == 2 and len(trainer.logger.metrics) == 1
    assert trainer.ckpt.resolve("latest") is not None


def test_conditional_streaming_trains_and_needs_labels(tmp_path):
    """A conditional model streams (image, label) pairs: the step gets the
    JAX loader's labels with its images; without labels both trainers
    refuse with the same error."""
    images, labels = generate_labeled_dataset(2, 6, 64, seed=5)
    cfg = small_cfg(tmp_path, epochs=1, resident_data=False,
                    model=ModelConfig(num_classes=2, **SMALL))
    trainer = GANTrainer(cfg, images, device="cpu", labels=labels)
    seen = []
    recording(trainer, seen)
    trainer.train()
    want = jax_batches(JBatchLoader(images, 4, labels=labels, seed=cfg.seed), 0)
    assert len(seen) == len(want) == 3
    for (x, y), (wx, wy) in zip(seen, want):
        np.testing.assert_array_equal(x.numpy(), wx)
        np.testing.assert_array_equal(y.numpy(), wy)
    assert np.isfinite(trainer.logger.metrics[-1]["g_loss"])
    jcfg = JTrainConfig(model=JModelConfig(num_classes=2, **SMALL), batch_size=4,
                        resident_data=False, checkpoint_dir=str(tmp_path / "jc"),
                        log_dir=str(tmp_path / "jl"), sample_dir=str(tmp_path / "js"))
    for make in (lambda: jtrainer.GANTrainer(jcfg, images, use_mesh=False),
                 lambda: GANTrainer(cfg, images, device="cpu")):
        with pytest.raises(ValueError, match="conditional training requires labels"):
            make()


@pytest.mark.parametrize("overrides", [dict(hflip=True), dict(n_critic=2),
                                       dict(share_fakes=True)])
def test_stream_graph_buffers_reproduce_eager_steps(tmp_path, overrides):
    """``make_stream_step``'s graph route on the CPU, each capture replaced
    by a direct call of the step it would capture: the batch through the
    static buffer, per-step augmentation and the other draws through the
    draw buffers, bit-equal to eager ``make_train_step`` steps on the same
    batches; a state that is not the bound one is copied in."""
    cfg = small_cfg(tmp_path, **overrides)
    images = generate_dataset(16, 64, seed=6)
    batches = [b[0] for e in range(2) for b in jax_batches(JBatchLoader(images, 4), e)]
    stream = make_stream_step(cfg)
    graphed = uncaptured(stream)
    a, b = create_train_state(cfg, "cpu"), create_train_state(cfg, "cpu")
    eager = make_train_step(cfg)
    for x in batches[:6]:
        a2, m = graphed(a, torch.from_numpy(x))
        b, want = eager(b, torch.from_numpy(x))
        assert a2 is a and m["g_loss"].shape == (1,)
        for key in want:
            assert torch.equal(m[key][0], want[key]), key
    assert graphed.graph is not None and graphed.warm == graphed.WARMUP
    assert_states_equal(a, b)
    fresh = create_train_state(cfg, "cpu")
    out, _ = graphed(copy.deepcopy(fresh), torch.from_numpy(batches[6]))
    ref, _ = eager(fresh, torch.from_numpy(batches[6]))
    assert out is a and out.step == 1
    assert_states_equal(out, ref)
    with pytest.raises(ValueError, match="built on batches of"):
        graphed(a, torch.from_numpy(batches[7][:2]))
