"""The port's quantization kernels (ops/csrc/quant.cu) against their plain
versions, on a GPU, bit for bit.  Marked ``cuda``: they skip on a machine
without one.

This file imports neither jax nor horovod_tpu, so it also runs where only
PyTorch is installed (the repo's conftest imports jax; skip it there)::

    python -m pytest --noconftest -q tests/test_torch_quant_kernels.py
"""

import itertools

import pytest
import torch

from horovod_tpu_torch.ops import compression as tc
from horovod_tpu_torch.ops import quant as tq


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's quantization kernels "
                    "run only on the GPU")
    return torch.device("cuda")


def _rows(device, r, C, dtype):
    gen = torch.Generator(device=device).manual_seed(r * C)
    x = torch.randn(r, C, generator=gen, device=device) * torch.exp(
        3 * torch.randn(r, 1, generator=gen, device=device))
    x[:, :256] = 0.0             # an all-zero block
    x[:, 300] = 3e4              # a block with one huge value
    return x.to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("bits,stochastic,dtype", list(itertools.product(
    [8, 4], [True, False], [torch.float32, torch.bfloat16, torch.float16])))
def test_kernels_equal_their_plain_versions(cuda_device, bits, stochastic,
                                            dtype):
    fmt = tc.WireFormat(kind="quant", name=f"int{bits}", bits=bits,
                        block=256, stochastic=stochastic)
    rows = _rows(cuda_device, 4, 4096, dtype)
    key = tc.step_key(3, 5)
    tq.reset_launches()
    res, res_plain = torch.empty_like(rows), torch.empty_like(rows)
    wire = tq.quant_pack(rows, fmt, key, res)
    assert torch.equal(wire, tq.quant_pack_plain(rows, fmt, key, res_plain))
    assert torch.equal(res.view(torch.uint8), res_plain.view(torch.uint8))
    for sum_rows in (False, True):
        got = tq.unpack_dequantize(wire, 4096, fmt, sum_rows)
        want = tq.unpack_dequantize_plain(wire, 4096, fmt, sum_rows)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    torch.cuda.synchronize()
    assert tq.launches == {"quant_pack": 1, "unpack_dequantize": 2}


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_take(cuda_device):
    fmt = tc.WireFormat(kind="quant", name="int8", bits=8, block=256)
    with pytest.raises(ValueError, match="float32, bfloat16 or float16"):
        tq.quant_pack(torch.zeros(1, 256, dtype=torch.float64,
                                  device=cuda_device), fmt, (0, 0))
    with pytest.raises(ValueError, match="wire must be uint8"):
        tq.unpack_dequantize(torch.zeros(1, 10, dtype=torch.uint8,
                                         device=cuda_device), 256, fmt, True)
