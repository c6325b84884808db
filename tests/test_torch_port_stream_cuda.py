"""The streaming route on a card: ``data/loader.py::BatchLoader``'s pinned
ring and ``train_step.make_stream_step``'s CUDA graph.

Every test here is marked ``cuda`` and skips without a CUDA card (the ring
and the graph exist only there). The file imports neither JAX nor
``siggan_tpu``, so it runs where JAX is absent:

    python -m pytest --noconftest tests/test_torch_port_stream_cuda.py -q
"""

import copy

import numpy as np
import pytest
import torch

from siggan_tpu_torch.core.config import ModelConfig, TrainConfig
from siggan_tpu_torch.core.state import create_train_state
from siggan_tpu_torch.data.loader import BatchLoader
from siggan_tpu_torch.data.synthetic import generate_dataset
from siggan_tpu_torch.ops.kernels import pack_tail as pt
from siggan_tpu_torch.ops.kernels import train_tail as tt
from siggan_tpu_torch.train.train_step import make_stream_step, make_train_step, state_tensors
from siggan_tpu_torch.train.trainer import GANTrainer

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the loader's ring and the step's graph live there")
    return torch.device("cuda")


def small_cfg(**kw):
    return TrainConfig(**{"model": ModelConfig(latent_dim=16, base_features=32),
                          "batch_size": 16, **kw})


def run(step_fn, cfg, images, state, steps, reshape=False):
    loader = BatchLoader(images, cfg.batch_size, seed=cfg.seed, device="cuda")
    ms = []
    for epoch in range(steps):
        for batch in loader.epoch(epoch):
            if len(ms) == steps:
                break
            state, m = step_fn(state, batch)
            ms.append({k: v.reshape(1) for k, v in m.items()} if reshape else m)
    torch.cuda.synchronize()
    return state, {k: torch.cat([m[k] for m in ms]) for k in ms[0]}


@pytest.fixture
def deterministic(dev):
    """cuDNN's deterministic algorithms: under a graph capture cuDNN may
    otherwise pick other algorithms than in eager steps (other bits), as in
    ``test_torch_port_cuda.py``'s graphed-step test."""
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield dev
    torch.backends.cudnn.deterministic = before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_graphed_stream_steps_equal_eager_steps(deterministic, dtype):
    """Six streamed steps (two eager warm-up steps, the capture, four
    replays, across an epoch change) against six eager ``make_train_step``
    steps on the loader's batches, from copies of one state: the same bits
    and metrics; the kernels' launches are counted per replay (B1 twice,
    B1' once, B2 once a step)."""
    cfg = small_cfg(compute_dtype=dtype)
    images = generate_dataset(64, 64, seed=3)
    state0 = create_train_state(cfg, deterministic)
    want_state, want = run(make_train_step(cfg), cfg, images, copy.deepcopy(state0), 6,
                           reshape=True)
    for c in (pt.FWD_LAUNCHES, pt.BWD_LAUNCHES, tt.LAUNCHES):
        c.reset()
    step = make_stream_step(cfg)
    state, got = run(step, cfg, images, copy.deepcopy(state0), 6)
    assert step.graphed.graph is not None and state.step == want_state.step == 6
    assert (pt.FWD_LAUNCHES.count, pt.BWD_LAUNCHES.count, tt.LAUNCHES.count) == (12, 6, 6)
    for x, y in zip(state_tensors(state), state_tensors(want_state)):
        assert torch.equal(x, y)
    for key in want:
        assert torch.equal(got[key], want[key]), key


def test_ring_never_hands_over_a_slot_whose_copy_is_in_flight(dev):
    """A consumer that sleeps on the card before reading each batch: the
    host runs ahead refilling the ring, yet every batch read is the one the
    JAX order names (a slot refilled early would show another batch's
    rows), labels included."""
    rs = np.random.RandomState(0)
    images = rs.rand(200, 8, 8, 1).astype(np.float32)
    labels = np.arange(200, dtype=np.int64)
    loader = BatchLoader(images, 16, labels=labels, seed=5, prefetch=2, device="cuda")
    for epoch in range(2):
        got = []
        for x, y in loader.epoch(epoch):
            torch.cuda._sleep(2_000_000)
            got.append((x.clone(), y.clone()))
        torch.cuda.synchronize()
        order = np.random.RandomState((5, epoch)).permutation(200)
        assert len(got) == len(loader) == 12
        for b, (x, y) in enumerate(got):
            sel = order[b * 16:(b + 1) * 16]
            np.testing.assert_array_equal(x.cpu().numpy(), images[sel])
            np.testing.assert_array_equal(y.cpu().numpy(), labels[sel])


def test_the_set_never_lands_on_the_card(dev, tmp_path):
    """A 1 GiB set streamed by the loader, then trained on by GANTrainer
    with ``resident_data=False``: the memory allocated on the card grows by
    the ring's batches, and then by the model's state and its step's
    memory, never by the set (less than half its size)."""
    images = np.random.RandomState(1).rand(65536, 64, 64, 1).astype(np.float32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    loader = BatchLoader(images, 64, device="cuda")
    for n, _ in enumerate(loader.epoch(0)):
        if n == 40:
            break
    torch.cuda.synchronize()
    ring = 4 * 64 * 64 * 64 * 4
    assert torch.cuda.max_memory_allocated() - before <= ring + (1 << 20)
    cfg = small_cfg(epochs=1, batch_size=64, resident_data=False,
                    checkpoint_dir=str(tmp_path / "c"), sample_dir=str(tmp_path / "s"),
                    log_dir=str(tmp_path / "l"))
    trainer = GANTrainer(cfg, images, device="cuda")
    assert not trainer.resident and not hasattr(trainer, "images_dev")
    trainer.train()
    assert trainer.state.step == 1024
    assert torch.cuda.max_memory_allocated() - before < images.nbytes / 2
