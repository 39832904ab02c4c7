"""The port's quantization kernels (ops/csrc/quant.cu) against their plain
versions, on a GPU, bit for bit; and on the CPU, the form choice and the
arithmetic identities the one-pass kernel relies on.  The GPU tests are
marked ``cuda``: they skip on a machine without one.

This file imports neither jax nor horovod_tpu, so it also runs where only
PyTorch is installed (the repo's conftest imports jax; skip it there)::

    python -m pytest --noconftest -q tests/test_torch_quant_kernels.py
"""

import itertools

import numpy as np
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


def _fmt(bits, block=256, stochastic=True):
    return tc.WireFormat(kind="quant", name=f"int{bits}", bits=bits,
                         block=block, stochastic=stochastic)


def _rows(device, r, C, dtype):
    """Seeded rows (C a multiple of 64, at least 768) whose blocks span
    many magnitudes, with an all-zero block, a block with one huge value
    and, in the last 256 elements, a NaN block, a +inf block, a -inf block
    and a block with a NaN and a +inf (at block 64; fewer, larger blocks
    hold several of them at wider blocks)."""
    gen = torch.Generator(device=device).manual_seed(r * C)
    x = torch.randn(r, C, generator=gen, device=device) * torch.exp(
        3 * torch.randn(r, 1, generator=gen, device=device))
    x[:, :256] = 0.0             # an all-zero block
    x[:, 300] = 3e4              # a block with one huge value
    x[:, C - 256 + 5] = float("nan")
    x[:, C - 192 + 7] = float("inf")
    x[:, C - 128 + 9] = -float("inf")
    x[:, C - 64 + 1] = float("nan")
    x[:, C - 64 + 2] = float("inf")
    return x.to(dtype)


def _pack_both_forms(rows, fmt, key, residual, expect):
    """Each form quant_pack can take for these rows, bitwise against
    quant_pack_plain, with the per-form launch counts."""
    res_plain = torch.empty_like(rows) if residual else None
    want = tq.quant_pack_plain(rows, fmt, key, res_plain)
    forms = [None, "first"] if expect == "one_pass" else [None]
    for form in forms:
        tq.reset_launches()
        res = torch.empty_like(rows) if residual else None
        wire = tq.quant_pack(rows, fmt, key, res, form=form)
        torch.cuda.synchronize()
        took = form or expect
        assert tq.launches["quant_pack"] == 1
        assert tq.form_launches == {f: int(f == took) for f in tq.FORMS}
        assert torch.equal(wire, want), took
        if residual:
            assert torch.equal(res.view(torch.uint8),
                               res_plain.view(torch.uint8)), took


# The cases: blocks 6 (the first form) to 1024 at r = 1, and r = 4 rows
# of C = 768, 1536, 4096, whose frames keep rows after the first only 2-,
# 4- or 8-byte aligned (int8; int4: 2, 4, 4).
SHAPES = [(6, 1, 3072), (64, 1, 4096), (128, 1, 4096), (256, 1, 4096),
          (512, 1, 4096), (1024, 1, 4096), (256, 4, 768), (256, 4, 1536),
          (256, 4, 4096)]


@pytest.mark.cuda
@pytest.mark.parametrize("block,r,C", SHAPES)
@pytest.mark.parametrize("bits,stochastic,dtype,residual", list(
    itertools.product([8, 4], [True, False],
                      [torch.float32, torch.bfloat16, torch.float16],
                      [True, False])))
def test_quant_pack_forms_equal_the_plain_version(cuda_device, block, r, C,
                                                  bits, stochastic, dtype,
                                                  residual):
    fmt = _fmt(bits, block, stochastic)
    rows = _rows(cuda_device, r, C, dtype)
    expect = "first" if block == 6 else "one_pass"
    assert tq.quant_pack_form(r, C, dtype, fmt, rows.data_ptr())[0] == expect
    _pack_both_forms(rows, fmt, tc.step_key(3, 5), residual, expect)


@pytest.mark.cuda
@pytest.mark.parametrize("bits,dtype", list(itertools.product(
    [8, 4], [torch.float32, torch.bfloat16])))
def test_misaligned_rows_take_the_first_form(cuda_device, bits, dtype):
    base = _rows(cuda_device, 1, 4096 + 64, dtype).reshape(-1)
    rows = base[1:4097].reshape(1, 4096)  # one element off 16 bytes
    fmt = _fmt(bits)
    assert tq.quant_pack_form(1, 4096, dtype, fmt,
                              rows.data_ptr())[0] == "first"
    _pack_both_forms(rows, fmt, tc.step_key(3, 5), True, "first")
    with pytest.raises(ValueError, match="one_pass form does not take"):
        tq.quant_pack(rows, fmt, tc.step_key(3, 5), form="one_pass")


@pytest.mark.cuda
@pytest.mark.parametrize("bits,stochastic,dtype", list(itertools.product(
    [8, 4], [True, False], [torch.float32, torch.bfloat16, torch.float16])))
def test_kernels_equal_their_plain_versions(cuda_device, bits, stochastic,
                                            dtype):
    fmt = _fmt(bits, 256, stochastic)
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
    assert tq.form_launches == {"one_pass": 1, "first": 0}


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_take(cuda_device):
    fmt = tc.WireFormat(kind="quant", name="int8", bits=8, block=256)
    with pytest.raises(ValueError, match="float32, bfloat16 or float16"):
        tq.quant_pack(torch.zeros(1, 256, dtype=torch.float64,
                                  device=cuda_device), fmt, (0, 0))
    with pytest.raises(ValueError, match="wire must be uint8"):
        tq.unpack_dequantize(torch.zeros(1, 10, dtype=torch.uint8,
                                         device=cuda_device), 256, fmt, True)


# ---------------------------------------------------------------------------
# CPU: the form choice and the identities of the one-pass kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("block", [64, 128, 256, 512, 1024])
@pytest.mark.parametrize("bits", [8, 4])
def test_form_one_pass_for_power_of_two_blocks(block, bits):
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        form, store = tq.quant_pack_form(1, 4096, dtype, _fmt(bits, block),
                                         rows_ptr=1 << 20,
                                         residual_ptr=1 << 21)
        assert (form, store) == ("one_pass", 8 if bits == 8 else 4)


@pytest.mark.parametrize("block", [2, 6, 32, 96, 192, 2048])
def test_form_first_for_other_blocks(block):
    C = 3 * 2048
    assert tq.quant_pack_form(1, C, torch.float32,
                              _fmt(8, block)) == ("first", 0)


def test_form_first_for_misaligned_pointers_and_large_launches():
    fmt = _fmt(8)
    for rows_ptr, res_ptr in [(2, None), (8, None), (0, 4), (16, 24)]:
        assert tq.quant_pack_form(1, 4096, torch.bfloat16, fmt, rows_ptr,
                                  res_ptr) == ("first", 0)
    assert tq.quant_pack_form(1, 4096, torch.bfloat16, fmt, 32, 48)[0] \
        == "one_pass"
    # r * C must stay below 2^32, so that the counter's high word is 0.
    assert tq.quant_pack_form(1, 2 ** 32 - 256, torch.float32,
                              fmt)[0] == "one_pass"
    assert tq.quant_pack_form(1, 2 ** 32, torch.float32, fmt)[0] == "first"
    assert tq.quant_pack_form(4, 2 ** 30, torch.float32, fmt)[0] == "first"
    assert tq.quant_pack_form(65536, 256, torch.float32, fmt)[0] == "first"
    assert tq.quant_pack_form(1, 4096, torch.float64, fmt)[0] == "first"


@pytest.mark.parametrize("bits,C,store", [
    (8, 768, 2), (8, 1024, 8), (8, 1536, 4), (8, 4096, 8),
    (4, 768, 2), (4, 1024, 4), (4, 1536, 4), (4, 4096, 4)])
def test_form_store_width_follows_the_frame(bits, C, store):
    """Row i of the wire starts at i * frame: the code stores are as wide
    as every row's start keeps aligned (at r = 1, the widest)."""
    fmt = _fmt(bits)
    frame = tc.wire_bytes_per_chunk(C, fmt)
    assert frame % store == 0
    assert tq.quant_pack_form(4, C, torch.bfloat16, fmt) == (
        "one_pass", store)
    assert tq.quant_pack_form(1, C, torch.bfloat16, fmt) == (
        "one_pass", 8 if bits == 8 else 4)


def _f32(bits):
    return torch.tensor(np.array(bits, dtype=np.uint32).view(np.float32))


def _reciprocal_inputs():
    """0, ±subnormals, ±normals of every size, values near f32's maximum,
    and for every scale values whose quotient is subnormal."""
    rng = np.random.default_rng(0)
    bits = [0, 1, 2, 3, 0x7FFFFF, 0x400000, 0x000ABCDE, 0x00800000,
            0x00800001, 0x3F800000, 0x3FFFFFFF, 0x7F7FFFFF, 0x7F7FFFFE,
            0x7F000000, 0x7F800000]
    bits += list(rng.integers(0, 0x7F800000, 200))
    bits += list(rng.integers(0, 0x00800000, 50))
    # Quotients in the subnormal range for any scale 2^e: mantissas at
    # exponents e - 149 ... e - 127.
    for field in range(1, 255, 7):
        bits += list((field << 23) | rng.integers(0, 0x800000, 3))
    bits = np.array(bits, dtype=np.uint32)
    return _f32(np.concatenate([bits, bits | 0x80000000]))


def test_exact_reciprocal_equals_division():
    """For every scale 2^e, e in [-126, 127]: x / 2^e == x * 2^-e bitwise
    in f32, with 2^-e built from the bits as the kernel builds it (its
    exponent field 254 - pe, or the subnormal 2^-127 for pe = 254)."""
    x = _reciprocal_inputs()
    pe = np.arange(1, 255, dtype=np.uint32)               # e = pe - 127
    scale = _f32(pe << 23)
    inv = _f32(np.where(pe == 254, 0x00400000, (254 - pe) << 23))
    assert torch.equal(inv[-1], torch.tensor(2.0 ** -127))
    assert torch.equal(scale * inv, torch.ones(254))
    q_div = x[None, :] / scale[:, None]
    q_mul = x[None, :] * inv[:, None]
    assert torch.equal(q_div.view(torch.int32), q_mul.view(torch.int32))
    # The comparison reached subnormal quotients and inputs.
    tiny = q_div.abs() < 2.0 ** -126
    assert int((tiny & (q_div != 0)).sum()) > 1000
    assert bool(((x.abs() < 2.0 ** -126) & (x != 0)).any())


def _cvt_rmi(x, lo, hi):
    """The kernel's round-down conversion to an integer of range [lo, hi]
    (cvt.rmi.s8.f32 / cvt.rmi.s32.f32): floor, saturate, NaN -> 0."""
    f = torch.floor(x.double()).clamp(lo, hi)
    return torch.where(torch.isnan(f), torch.zeros_like(f), f).long()


@pytest.mark.parametrize("bits", [8, 4])
def test_round_down_conversion_and_clip_equal_floor_and_clamp(bits):
    """The kernel's clip(floor(x)): int8 converts to s8 then clips -127;
    int4 converts to s32 then clips both sides.  Over the values
    quantize_blocks can feed it, this equals the plain version's
    clamp(floor(x), -lv, lv).to(int8)."""
    lv = (1 << (bits - 1)) - 1
    edges = [lv + d for d in (-1.5, -1, -0.5, 0, 0.25, 0.5, 1, 1.5, 2)]
    vals = edges + [-e for e in edges] + [
        0.0, -0.0, 0.5, -0.5, 0.999, -0.001, 127.99, -127.01, 128.0,
        -128.0, -129.0, 2.0 ** 31, -2.0 ** 31, 2.0 ** 31 - 128,
        -2.0 ** 31 - 256, 3e9, -3e9, 1e20, -1e20, 3.4e38, -3.4e38,
        float("inf"), -float("inf"), float("nan")]
    rng = np.random.default_rng(bits)
    vals += list(rng.uniform(-300, 300, 2000))
    x = torch.tensor(vals, dtype=torch.float32)
    plain = torch.clamp(torch.floor(x), -lv, lv).to(torch.int8).long()
    if bits == 8:
        kernel = torch.clamp(_cvt_rmi(x, -128, 127), min=-127)
    else:
        kernel = torch.clamp(_cvt_rmi(x, -2 ** 31, 2 ** 31 - 1), -lv, lv)
    assert torch.equal(kernel, plain)
    assert int(plain[-1 - 2000]) == 0  # NaN -> 0 in both


def test_int4_word_packing_identity():
    """The kernel packs a lane's 8 int4 codes as 0x88888888 + sum of
    q_k << 4k (mod 2^32); its little-endian bytes are pack_int4's."""
    rng = np.random.default_rng(1)
    q = rng.integers(-7, 8, size=(500, 8))
    word = (0x88888888 + (q << (4 * np.arange(8))).sum(-1)) % 2 ** 32
    got = word.astype("<u4").view(np.uint8).reshape(500, 4)
    want = tc.pack_int4(torch.from_numpy(q.astype(np.int8))).numpy()
    assert np.array_equal(got, want)
