"""The K-step resident dispatch (``make_resident_multi_step``) on the CPU:
K steps per call against K resident steps over an epoch boundary. Split
from ``test_torch_port_multistep.py``, the test unchanged."""

import pytest
import torch

from siggan_tpu_torch.core.state import create_train_state
from siggan_tpu_torch.data.synthetic import generate_dataset
from siggan_tpu_torch.train.train_step import make_resident_multi_step
from test_torch_port_multistep import few_threads  # noqa: F401  (autouse)
from test_torch_port_multistep import assert_states_equal, eager_run, tiny_cfg, windows


def test_multi_step_equals_k_resident_steps_over_an_epoch_boundary():
    cfg = tiny_cfg(seed=3, log_grad_norms=True)
    images = torch.from_numpy(generate_dataset(16, 64, seed=5))   # 4 steps an epoch
    multi, spe = make_resident_multi_step(cfg, 16, 2)
    assert spe == 4
    a, m1 = multi(create_train_state(cfg, "cpu"), images)
    assert set(m1) >= {"d_loss", "g_loss", "d_grad_norm", "g_grad_norm"}
    assert all(v.shape == (2,) for v in m1.values())
    a, rest = windows(multi, a, images, 2)                      # steps 2-5: epoch 0 -> 1
    b, want = eager_run(cfg, images, create_train_state(cfg, "cpu"), 6)
    assert_states_equal(a, b)
    for k, v in want.items():
        assert torch.equal(torch.cat([m1[k], rest[k]]), v), k
    with pytest.raises(ValueError, match="must divide"):
        make_resident_multi_step(cfg, 16, 3)
