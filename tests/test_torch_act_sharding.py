"""The port's layers on DTensor inputs (``models/act_sharding.py``):
the route a local-attention layer takes on a CPU mesh and on the card.
Imports torch and ``repro_torch`` only, so that the card's test runs
where JAX is not installed:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_act_sharding.py
"""
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads in an xdist worker)

from repro_torch.launch.mesh import fake_world


def _local_layer_inputs(device: str, dtype=torch.float32):
    """q (2, 96, 4, 16), k/v (2, 96, 2, 16) from a seed, window 24."""
    rng = np.random.default_rng(21)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               .to(dtype).to(device)
               for shape in ((2, 96, 4, 16), (2, 96, 2, 16), (2, 96, 2, 16)))
    pos = torch.arange(96, dtype=torch.int32, device=device).expand(2, 96)
    return q, k, v, pos, 24


def _local_layer(mesh, q, k, v, pos, window, placements, spy):
    """``act_sharding.local_attention`` on ``q``, ``k``, ``v`` made
    DTensors (the full tensors as one device's shards, on a mesh of one)
    with ``placements``; ``spy`` records which route ran and on what."""
    from torch.distributed.tensor import DTensor

    from repro_torch.kernels import ops
    from repro_torch.models import act_sharding as A
    from repro_torch.models.flash import chunked_heads

    def kernel(q, k, v):
        spy.append(("kernel", type(q)))
        return ops.local_attention(q, k, v, window=window)

    def banded(q, k, v, qp, kp):
        spy.append(("banded", type(q)))
        return chunked_heads(q, k, v, qp, kp, causal=True, window=window,
                             q_chunk=32, kv_chunk=32)

    dq, dk, dv = (DTensor.from_local(t, mesh, placements, run_check=False)
                  for t in (q, k, v))
    return A.local_attention(kernel, banded, dq, dk, dv, pos, pos)


def test_dtensor_local_layer_routes(monkeypatch):
    """A local-attention layer on DTensors: off the card the banded chunks
    in plain ops; on the card (``_on_card`` made true here) the layer's
    kernel entry point on each device's plain shards, never the plain
    path, and a layout the kernel cannot take (split over head_dim)
    raises.  Both routes give the plain layer's output within 1e-5."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard

    from repro_torch.kernels import ops
    from repro_torch.models import act_sharding as A

    q, k, v, pos, window = _local_layer_inputs("cpu")
    want = ops.local_attention(q, k, v, window=window).flatten(2)
    heads = (Shard(0), Shard(2))
    with fake_world(1):
        mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
        spy: list = []
        out = _local_layer(mesh, q, k, v, pos, window, heads, spy)
        assert [r for r, _ in spy] == ["banded"]
        np.testing.assert_allclose(out.to_local().numpy(), want.numpy(),
                                   atol=1e-5, rtol=0)
        monkeypatch.setattr(A, "_on_card", lambda x: True)
        spy.clear()
        out = _local_layer(mesh, q, k, v, pos, window, heads, spy)
        assert spy == [("kernel", torch.Tensor)]
        assert out.placements == heads
        np.testing.assert_allclose(out.to_local().numpy(), want.numpy(),
                                   atol=1e-5, rtol=0)
        spy.clear()
        with pytest.raises(ValueError, match="batch and heads only"):
            _local_layer(mesh, q, k, v, pos, window, (Shard(0), Shard(3)), spy)
        assert spy == []


@pytest.mark.cuda
def test_dtensor_local_layer_launches_kernel_on_card():
    """On a CUDA mesh a DTensor local layer launches the forward kernel on
    the shards and, through autograd, the backward kernel; output and
    gradients equal the plain version's within the kernels' tolerances;
    a layout split over head_dim raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard

    from repro_torch.kernels import local_attn_kernel, ops, ref

    q, k, v, pos, window = _local_layer_inputs("cuda", torch.bfloat16)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    heads = (Shard(0), Shard(2))
    with fake_world(1):
        mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
        spy: list = []
        before = ops.launches()
        out = _local_layer(mesh, q, k, v, pos, window, heads, spy)
        dout = torch.randn(out.shape, generator=torch.Generator().manual_seed(3)
                           ).to(torch.bfloat16).cuda()
        grads = torch.autograd.grad(out.to_local(), (q, k, v), dout)
        after = ops.launches()
        assert [r for r, _ in spy] == ["kernel"]
        assert after["local_attention"] == before["local_attention"] + 1
        assert after["local_attention_bwd"] == before["local_attention_bwd"] + 1
        plain = ref.local_attention(q.detach(), k.detach(), v.detach(), window)
        err = float((out.to_local().detach().float() - plain.flatten(2).float()).abs().max())
        assert err <= local_attn_kernel.tolerance(plain), err
        want = ref.local_attention_bwd(q.detach(), k.detach(), v.detach(), plain,
                                       dout.reshape(plain.shape), window)
        for name, g, w, tol in zip("qkv", grads, want,
                                   local_attn_kernel.bwd_tolerance(want)):
            err = float((g.float() - w.float()).abs().max())
            assert err <= tol, (name, err, tol)
        with pytest.raises(ValueError, match="batch and heads only"):
            _local_layer(mesh, q, k, v, pos, window, (Shard(0), Shard(3)), spy)
