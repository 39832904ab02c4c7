"""The port's flash-attention kernels against their plain versions, on a
GPU.  Marked ``cuda``: they skip on a machine without one.

This file imports neither jax nor horovod_tpu, so it also runs where only
PyTorch is installed (the repo's conftest imports jax; skip it there)::

    python -m pytest --noconftest -q tests/test_torch_flash_kernels.py
"""

import pytest
import torch

from horovod_tpu_torch.ops import flash_attention as tfa


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's flash kernels run "
                    "only on the GPU")
    return torch.device("cuda")


def _allowed(ref, dtype, tol_f32):
    """Per-element tolerance, as chip_smoke.py sets and argues it: f32
    absolute; bf16 2^-7 of the element plus 2^-5 of its row's RMS plus
    2^-9 of the whole output's RMS."""
    if dtype == torch.float32:
        return torch.full_like(ref, tol_f32)
    rms_row = ref.pow(2).mean(dim=-1, keepdim=True).sqrt()
    return (2.0 ** -5 * rms_row + 2.0 ** -9 * ref.pow(2).mean().sqrt()
            + 2.0 ** -7 * ref.abs())


def _check_against_plain(device, dtype, *, q_len, kv_len, d, causal,
                         offset):
    """Kernel against plain version on the same inputs, on the card,
    element by element; each kernel launches once.

    With one key, dq and dk are exactly zero, and from random floats both
    versions give only the rounding noise of dp - delta, summed in other
    orders, which no tolerance relative to the output can hold.  So that
    case takes small integers: every product and sum is exact in f32,
    and both versions give exact zeros."""
    gen = torch.Generator(device=device).manual_seed(0)

    def rnd(n):
        if kv_len == 1:
            return torch.randint(-3, 4, (2, n, d), generator=gen,
                                 device=device).to(dtype)
        return torch.randn(2, n, d, generator=gen, device=device).to(dtype)

    q, k, v, g = rnd(q_len), rnd(kv_len), rnd(kv_len), rnd(q_len)
    scale = d ** -0.5
    tfa.reset_launches()
    o, lse = tfa.flash_fwd(q, k, v, scale, causal, offset)
    delta = (g.float() * o.float()).sum(-1)
    dk, dv = tfa.flash_bwd_dkdv(q, k, v, g, lse, delta, scale, causal, offset)
    dq = tfa.flash_bwd_dq(q, k, v, g, lse, delta, scale, causal, offset)
    assert tfa.launches == {name: 1 for name in tfa.KERNELS}
    o_ref, lse_ref = tfa._dense_forward(q, k, v, scale, causal, offset)
    want = tfa._dense_backward_from_delta(q, k, v, g, lse, delta,
                                          sm_scale=scale, causal=causal,
                                          q_block_offset=offset)
    for name, got, ref in zip(("o", "dq", "dk", "dv"), (o, dq, dk, dv),
                              (o_ref, *want)):
        got, ref = got.float(), ref.float()
        err = (got - ref).abs()
        assert bool((err <= _allowed(ref, dtype, 5e-5)).all()), (
            name, float(err.max()))
    assert torch.equal(torch.isneginf(lse), torch.isneginf(lse_ref))
    fin = torch.isfinite(lse_ref)
    assert bool(((lse - lse_ref)[fin].abs() <= 5e-5).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,offset", [(True, 0), (False, 0),
                                           (True, -1000)])
def test_kernels_match_plain_version_on_gpu(cuda_device, dtype, causal,
                                            offset):
    """Both kernel forms (bf16 d64 runs the Hopper redesign, f32 the first
    form) against the plain version at a length inside one tile."""
    _check_against_plain(cuda_device, dtype, q_len=100, kv_len=100, d=64,
                         causal=causal, offset=offset)


@pytest.mark.cuda
@pytest.mark.parametrize("q_len,kv_len,d,causal,offset", [
    (1000, 1000, 64, True, 0),    # ragged across 128-row q and key tiles
    (200, 200, 128, True, 0),
    (384, 384, 128, True, 0),     # bf16 d128, whole tiles
    (300, 1000, 64, False, 0),    # q and kv both ragged, non-causal
    (256, 1024, 128, True, 700),  # the diagonal crosses two key tiles
    (130, 260, 64, True, -100),   # rows with no visible key, ragged
    (70, 1000, 64, False, 0),     # dQ: warpgroup 1 mostly padding
    (64, 300, 128, False, 0),     # dQ: warpgroup 1 all padding
    (192, 192, 64, True, 0),      # dQ: warpgroup 0's last key tile masked
    (100, 1, 64, False, 0),       # one key
])
def test_redesigned_bf16_kernels_at_tile_edges_on_gpu(cuda_device, q_len,
                                                      kv_len, d, causal,
                                                      offset):
    _check_against_plain(cuda_device, torch.bfloat16, q_len=q_len,
                         kv_len=kv_len, d=d, causal=causal, offset=offset)
