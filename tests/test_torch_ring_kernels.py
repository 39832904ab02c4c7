"""Ring and Ulysses attention (parallel/sequence.py) on the port's flash
kernels, on a GPU.  Marked ``cuda``: they skip on a machine without one.

One card holds one rank, so the ring of 4 is played in one process
(``play_ring``, the hop functions ``ring_attention`` runs); the ring and
Ulysses of one run through their entry points.  This file imports
neither jax nor horovod_tpu, so it runs where only PyTorch is installed
(the repo's conftest imports jax; skip it there)::

    python -m pytest --noconftest -q tests/test_torch_ring_kernels.py
"""

import pytest
import torch

from horovod_tpu_torch.core.topology import MeshAxis
from horovod_tpu_torch.ops import flash_attention as tfa
from horovod_tpu_torch.parallel import sequence as ts


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's flash kernels run "
                    "only on the GPU")
    return torch.device("cuda")


def _qkvg(device, s=1024, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(1, 2, s, 64, generator=gen, device=device)
            .bfloat16() for _ in range(4)]


def _whole(q, k, v, g, causal):
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    o = tfa.flash_attention(*leaves, causal=causal)
    o.backward(g)
    return [o.detach()] + [t.grad for t in leaves]


@pytest.mark.cuda
@pytest.mark.parametrize("causal,launches", [(True, 10), (False, 16)])
def test_ring_of_four_launches_and_matches_whole_flash(cuda_device, causal,
                                                       launches):
    """Rank my of a causal ring of 4 launches my + 1 of each kernel, 10
    in all; a non-causal ring 4 on each rank, 16; the result is within
    bf16 rounding of flash attention over the whole sequence."""
    q, k, v, g = _qkvg(cuda_device)
    tfa.reset_launches()
    got = ts.play_ring(q, k, v, g, 4, causal=causal)
    torch.cuda.synchronize()
    assert tfa.launches == {n: launches for n in tfa.KERNELS}
    for a, b in zip(got, _whole(q, k, v, g, causal)):
        a, b = a.float(), b.float()
        rms_row = b.pow(2).mean(-1, keepdim=True).sqrt()
        allowed = (2.0 ** -5 * rms_row + 2.0 ** -9 * b.pow(2).mean().sqrt()
                   + 2.0 ** -7 * b.abs())
        assert bool(((a - b).abs() <= allowed).all())


@pytest.mark.cuda
def test_ring_and_ulysses_of_one_launch_the_kernels_bitwise_flash(
        cuda_device):
    q, k, v, g = _qkvg(cuda_device, s=512, seed=1)
    axis = MeshAxis.local("seq")
    want = _whole(q, k, v, g, True)
    for fn in (ts.ring_attention, ts.ulysses_attention):
        tfa.reset_launches()
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        o = fn(*leaves, axis=axis, causal=True)
        o.backward(g)
        torch.cuda.synchronize()
        assert tfa.launches == {n: 1 for n in tfa.KERNELS}
        for a, b in zip([o.detach()] + [t.grad for t in leaves], want):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_ring_refuses_mixed_devices(cuda_device):
    q, k, v, _ = _qkvg(cuda_device, s=256)
    with pytest.raises(ValueError, match="CUDA device"):
        ts.ring_attention(q, k.cpu(), v, axis=MeshAxis.local("seq"),
                          causal=True)
