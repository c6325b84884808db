"""Data parallelism on a card: a one-rank NCCL process group.

Every test here is marked ``cuda`` and skips without a CUDA card. The file
imports neither JAX nor ``siggan_tpu``, so it runs where JAX is absent:

    python -m pytest --noconftest tests/test_torch_port_dp_cuda.py -q

- The graphed resident steps over a one-rank NCCL mesh (their gradient and
  metric all-reduces captured in the CUDA graph) give the bits of the
  steps without a mesh.
- Kernel B2's layer route (per BN layer: conv and totals, an all-reduce of
  the totals, the finalize) gives the bits of its single host call, eagerly
  and captured in a CUDA graph with its NCCL all-reduces.
"""

import copy

import numpy as np
import pytest
import torch
import torch.distributed as dist

from siggan_tpu_torch.core.config import MeshConfig, ModelConfig, TrainConfig
from siggan_tpu_torch.core.state import create_train_state
from siggan_tpu_torch.data.synthetic import generate_dataset
from siggan_tpu_torch.models.generator import init_fn
from siggan_tpu_torch.core import rng
from siggan_tpu_torch.ops.kernels import pack_tail as pt
from siggan_tpu_torch.ops.kernels import train_tail as tt
from siggan_tpu_torch.parallel.mesh import free_port, make_mesh
from siggan_tpu_torch.train.train_step import make_resident_multi_step, state_tensors

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def mesh():
    """A one-rank NCCL process group on card 0 and its mesh."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: NCCL and the kernels live there")
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0)
    try:
        m = make_mesh(MeshConfig(), "cuda")
        assert m is not None and m.size == 1 and m.backend == "nccl"
        yield m
    finally:
        dist.destroy_process_group()


@pytest.fixture
def deterministic(mesh):
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield mesh
    torch.backends.cudnn.deterministic = before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_one_rank_nccl_graph_equals_the_no_mesh_graph(deterministic, dtype):
    """Two windows of 4 graphed resident steps (the first holding the eager
    warm-up steps and the capture) with and without the one-rank mesh,
    from copies of one state: the same bits; the mesh's graph replays its
    all-reduces (gradients of D and G, metrics: 3 a step)."""
    mesh = deterministic
    cfg = TrainConfig(model=ModelConfig(latent_dim=16, base_features=32), batch_size=16,
                      compute_dtype=dtype)
    images = torch.from_numpy(generate_dataset(64, 64, seed=3)).cuda()
    state0 = create_train_state(cfg, "cuda")
    out = []
    for m in (None, mesh):
        multi, _ = make_resident_multi_step(cfg, 64, 4, m)
        state = copy.deepcopy(state0)
        before = mesh.collectives.count
        for _ in range(2):
            state, metrics = multi(state, images)
        torch.cuda.synchronize()
        assert multi.graphed.graph is not None
        out.append((state, metrics, mesh.collectives.count - before))
    (a, ma, na), (b, mb, nb) = out
    assert na == 0 and nb == 3 * 8
    assert a.step == b.step == 8
    for x, y in zip(state_tensors(a), state_tensors(b)):
        assert torch.equal(x, y)
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k


def b2_inputs(size, dtype, batch):
    g = init_fn(rng.generator(0, rng.STREAM_INIT_G),
                ModelConfig(image_size=size, base_features=32, latent_dim=16), "cuda")
    tail = g.blocks[g.tail_entry():]
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for blk in tail:
            c = blk.bn.mean.shape[0]
            blk.bn.offset.copy_(torch.randn(c, generator=gen) * 0.1)
            blk.bn.var.copy_(torch.rand(c, generator=gen) + 0.5)
        ws = pt.pack_tail_reference([b.weight for b in tail] + [g.final.weight], dtype)
    side = size // 2 ** len(tail)
    h0 = torch.relu(torch.randn(batch, side, side, tail[0].weight.shape[0],
                                generator=gen)).to("cuda", dtype)
    return (h0, ws, [(b.bn.scale.detach(), b.bn.offset.detach()) for b in tail],
            [{"mean": b.bn.mean.detach(), "var": b.bn.var.detach()} for b in tail],
            g.final.bias.detach())


@pytest.mark.parametrize("size,dtype,batch", [(64, torch.float32, 16),
                                              (64, torch.bfloat16, 16),
                                              (128, torch.bfloat16, 8)])
def test_b2_layer_route_equals_the_single_call(mesh, size, dtype, batch):
    """The layer route, without a mesh, on the one-rank mesh, and captured
    in a CUDA graph on that mesh, against the single host call: the same
    image and running statistics, bit for bit."""
    h0, ws, bn, states, bias = b2_inputs(size, dtype, batch)
    fresh = lambda: [{k: v.clone() for k, v in s.items()} for s in states]  # noqa: E731
    single = fresh()
    with torch.no_grad():
        want = tt.tail_forward_train_launch(h0, ws, bn, single, bias, dtype)
        runs = []
        for m in (None, mesh):
            st = fresh()
            runs.append((tt.tail_forward_train_layers(h0, ws, bn, st, bias, dtype, m), st))
        st = fresh()
        layers0, n0 = tt.LAYER_LAUNCHES.count, mesh.collectives.count
        graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            # The plan and the library are made outside the capture.
            tt.tail_forward_train_layers(h0, ws, bn, fresh(), bias, dtype, mesh)
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        with torch.cuda.graph(graph):
            img = tt.tail_forward_train_layers(h0, ws, bn, st, bias, dtype, mesh)
        graph.replay()
        torch.cuda.synchronize()
        runs.append((img, st))
    # The warm-up call and the capture ran the wrapper; a replay does not.
    assert tt.LAYER_LAUNCHES.count == layers0 + 2
    assert mesh.collectives.count == n0 + 2 * len(states)
    for got, st in runs:
        assert torch.equal(got, want)
        for a, b in zip(st, single):
            assert torch.equal(a["mean"], b["mean"]) and torch.equal(a["var"], b["var"])
    assert np.isfinite(want.float().cpu().numpy()).all()
