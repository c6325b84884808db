"""``chip_smoke.py`` phase 16b runs both sides of its f32 comparison (the two
gloo ranks and every one-process run) under cuDNN's deterministic
algorithms, so that a repeat of the same steps gives the same bits and the
check the same verdict on every run (C.12). The pieces of that which run
without a card: the settings helper, and that phase 16b's code enters it
around both sides."""

import inspect

import pytest
import torch

import chip_smoke


@pytest.mark.parametrize("deterministic,benchmark", [(False, False), (True, False), (False, True)])
def test_cudnn_deterministic_sets_and_restores(deterministic, benchmark):
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    try:
        cudnn.deterministic, cudnn.benchmark = deterministic, benchmark
        with chip_smoke.cudnn_deterministic():
            assert cudnn.deterministic and not cudnn.benchmark
        assert (cudnn.deterministic, cudnn.benchmark) == (deterministic, benchmark)
        with pytest.raises(RuntimeError):
            with chip_smoke.cudnn_deterministic():
                raise RuntimeError("a failing phase")
        assert (cudnn.deterministic, cudnn.benchmark) == (deterministic, benchmark)
    finally:
        cudnn.deterministic, cudnn.benchmark = saved


def test_phase_16b_runs_both_sides_deterministically():
    """The spawned ranks' work and the one-process runs (the first, its
    repeat, the 3 permutations) sit inside ``cudnn_deterministic``; the bar
    (rtol 1e-4, atol 1e-5, twice the spread) and the 3 permutations are as
    they were."""
    rank = inspect.getsource(chip_smoke.dp_rank)
    assert "with cudnn_deterministic():" in rank and "dp_rank_work(" in rank
    two = inspect.getsource(chip_smoke.dp_two_ranks)
    block = two[two.index("with cudnn_deterministic():"):two.index("one process's repeat")]
    assert block.count("dp_one_process(") == 3 and "for perm in perms" in block
    assert "for s in (11, 12, 13)" in two
    y = torch.tensor([0.0, 1.0, -2.0])
    torch.testing.assert_close(chip_smoke.dp_bar("G Adam", y, True, 2e-6), 1e-5 + 1e-4 * y.abs())
    assert "2 * spread[part]" in inspect.getsource(chip_smoke.dp_within)
