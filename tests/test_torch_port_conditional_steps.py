"""Conditional (v2.0) labels through the resident and K-step routes on the
CPU (their graph buffers replayed with each capture replaced by a direct
call), against eager resident steps, bit for bit. Split from
``test_torch_port_conditional.py``, the test unchanged."""

import pytest
import torch

from siggan_tpu_torch.core.config import ModelConfig, OptimConfig, TrainConfig
from siggan_tpu_torch.core.state import create_train_state, lr_schedule
from siggan_tpu_torch.data import synthetic
from siggan_tpu_torch.train.train_step import (make_resident_multi_step,
                                               make_resident_train_step, state_tensors)
from test_torch_port_multistep import few_threads  # noqa: F401  (autouse)
from test_torch_port_multistep import assert_states_equal, uncaptured, windows
from test_torch_port_train import TINY


def v20_cfg(**kw) -> TrainConfig:
    return TrainConfig(
        model=ModelConfig(num_classes=3, g_conditioning="concat", use_spectral_norm=True,
                          aux_classifier=True, **TINY),
        batch_size=4, compute_dtype="float32", seed=3, diffaugment="color,translation,cutout",
        ema_decay=0.9, aux_weight=0.5, aux_d_on_fakes=True,
        optim=OptimConfig(lr_schedule="linear", lr_total_steps=8, lr_end_frac=0.1), **kw)


def eager_run(cfg, images, labels, state, steps):
    fn, _ = make_resident_train_step(cfg, len(images))
    ms = []
    for _ in range(steps):
        state, m = fn(state, images, labels=labels)
        ms.append(m)
    return state, {k: torch.stack([m[k] for m in ms]) for k in ms[0]}


@pytest.mark.parametrize("k,class_balanced", [(2, True), (4, False)])
def test_conditional_multi_step_equals_resident_steps(k, class_balanced):
    """K steps per call on the CPU, and the graph route's buffers (fake
    labels, DiffAugment parameters, labels gathered with the batch rows)
    replayed with each capture replaced by a direct call, against eager
    resident steps over two epochs; the LR records follow the schedule."""
    cfg = v20_cfg(class_balanced_fakes=class_balanced)
    images, labels = synthetic.generate_labeled_dataset(3, 6, 64, seed=4)
    images = torch.from_numpy(images[:16])
    labels = torch.from_numpy(labels[:16]).long()
    want_state, want = eager_run(cfg, images, labels, create_train_state(cfg, "cpu"), 8)
    assert set(want) >= {"aux_acc_real", "d_loss", "g_loss"}
    multi, spe = make_resident_multi_step(cfg, 16, k)
    a, got = windows(lambda s, im: multi(s, im, labels), create_train_state(cfg, "cpu"),
                     images, 8 // k)
    assert_states_equal(a, want_state)
    graphed = uncaptured(make_resident_multi_step(cfg, 16, k)[0])
    b, got_g = windows(lambda s, im: graphed(s, im, labels), create_train_state(cfg, "cpu"),
                       images, 8 // k)
    assert_states_equal(b, want_state)
    for key, v in want.items():
        assert torch.equal(got[key], v) and torch.equal(got_g[key], v), key
    assert len(state_tensors(b)) == len(state_tensors(want_state))
    sched = lr_schedule(cfg, cfg.optim.g_lr)
    assert torch.equal(b.g_opt["lr"], sched(torch.tensor(7, dtype=torch.int32)))
    with pytest.raises(ValueError, match="other images or labels"):
        graphed(b, images, labels.clone())
