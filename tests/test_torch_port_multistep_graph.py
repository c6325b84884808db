"""The K-step dispatch's graph route (``_GraphedSteps``) on the CPU: its
buffers (the window's draws, batch rows, epoch tables, metrics rows and a
replaced state) replayed with each capture replaced by a direct call of the
step it would capture, bit-equal to eager resident steps over two epochs.
Split from ``test_torch_port_multistep.py``, the test unchanged."""

import copy
import dataclasses

import pytest
import torch

from siggan_tpu_torch.core.config import ModelConfig
from siggan_tpu_torch.core.state import create_train_state
from siggan_tpu_torch.data.synthetic import generate_dataset
from siggan_tpu_torch.train.train_step import make_resident_multi_step
from test_torch_port_multistep import few_threads  # noqa: F401  (autouse)
from test_torch_port_multistep import (TINY, assert_states_equal, eager_run, tiny_cfg,
                                       uncaptured, windows)


@pytest.mark.parametrize("k,overrides", [
    (4, dict(hflip=True)),                         # warm-up, capture and replays in window 1
    (2, dict(augment_bulk=False, n_critic=2)),     # per-step augment draws; capture in window 2
    (4, dict(augment=False, model=ModelConfig(dropout=0.0, **TINY))),
    (4, dict(share_fakes=True)),                   # one latent batch, two masks a step
])
def test_graph_route_buffers_reproduce_eager_steps(k, overrides):
    cfg = tiny_cfg(seed=6).replace(**overrides)
    images = torch.from_numpy(generate_dataset(16, 64, seed=7))
    multi, spe = make_resident_multi_step(cfg, 16, k)
    graphed = uncaptured(multi)
    a = create_train_state(cfg, "cpu")
    a2, got = windows(graphed, a, images, 8 // k)               # two epochs
    assert a2 is a and graphed.graph is not None and graphed.warm == graphed.WARMUP
    b, want = eager_run(cfg, images, create_train_state(cfg, "cpu"), 8)
    assert_states_equal(a, b)
    for key, v in want.items():
        assert torch.equal(got[key], v), key
    # A state that is not the bound one (a restored checkpoint, say) is
    # copied into the bound storage and training goes on from it.
    c = copy.deepcopy(b)
    out, m = graphed(c, images)
    assert out is a and out.step == 8 + k
    b, want = eager_run(cfg, images, b, k)
    assert_states_equal(out, b)
    for key, v in want.items():
        assert torch.equal(m[key], v), key
    with pytest.raises(ValueError, match="crosses an epoch"):
        graphed(dataclasses.replace(b, step=b.step + 1), images)
