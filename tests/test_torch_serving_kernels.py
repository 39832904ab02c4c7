"""The arithmetic of the serving kernels' Hopper forms (ops/csrc/
serving_gemm_sm90.cuh, cache_attention_sm90.cuh), held against the JAX
reference on the CPU; and, on a GPU, both forms of each kernel against
their plain versions.

On the CPU an "order model" stands in for each Hopper form: plain torch
that sums in the kernel's order.  The attention's model takes 64-key
tiles at fixed positions, an online softmax with a guarded running max,
P rounded to bf16 before P V, the masked tail of V zeroed, and the
division by the row's sum at the end; the GEMM's model adds the f32
partials of ``serving_gemm_form``'s fixed K ranges in split order.  Each
model agrees with the reference (``horovod_tpu.models.transformer``)
within the bf16 allowance ``chip_smoke.py`` holds the kernels to, and the
attention's model is bitwise across the number of query rows and the
batch, because a key tile wholly masked for a row is an exact no-op.

The GPU tests are marked ``cuda`` and skip on a machine without one.
The reference is imported inside the tests that need it, so on a machine
with PyTorch alone the GPU tests run with::

    python -m pytest --noconftest -q tests/test_torch_serving_kernels.py
"""

import inspect
import math

import numpy as np
import pytest
import torch

from horovod_tpu_torch.ops import serving as S

# chip_smoke.py's bf16 allowance (argued there):
#   |got - want| <= 2^-7 |want| + 2^-5 rms(row) + 2^-9 rms(all).
RTOL_BF16, ATOL_BF16, ATOL_FLOOR_BF16 = 2.0 ** -7, 2.0 ** -5, 2.0 ** -9
LOG2E = 1.4426950408889634
TILE = 64  # rows and keys of a Hopper attention block; k of a GEMM tile


def _within_bf16_allowance(got, want):
    got, want = got.float(), want.float()
    rms_row = want.pow(2).mean(dim=-1, keepdim=True).sqrt()
    rms_all = want.pow(2).mean().sqrt()
    allowed = (ATOL_BF16 * rms_row + ATOL_FLOOR_BF16 * rms_all
               + RTOL_BF16 * want.abs())
    err = (got - want).abs()
    assert bool(torch.isfinite(got).all())
    assert bool((err <= allowed).all()), float((err / allowed).max())


def _reference():
    pytest.importorskip("jax")
    from horovod_tpu.models import transformer as RT
    return RT


def _bf16(rng, shape, scale=1.0):
    x = rng.standard_normal(shape).astype(np.float32) * scale
    return torch.from_numpy(x).bfloat16()


def _jnp_bf16(t):
    import jax.numpy as jnp
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


# ---------------------------------------------------------------------------
# Order models
# ---------------------------------------------------------------------------

def _tile_matmul(a, b):
    """``a [n <= 64, k] @ b [k, m]`` in f32 as one fixed [64, k] product
    (zero rows padded), so a row's bits do not depend on n on the CPU."""
    pad = torch.zeros((TILE, a.shape[1]), dtype=torch.float32)
    pad[:a.shape[0]] = a
    return (pad @ b)[:a.shape[0]]


def attention_order_model(q, k, v, q_pos):
    """The Hopper attention's order of operations in plain torch: q
    [b, s, h, hd], k and v [b, cap, h, hd] (bf16), q_pos [b, s]."""
    b, s, h, hd = q.shape
    cap = k.shape[1]
    scale_log2 = np.float32(np.float32(hd ** -0.5) * np.float32(LOG2E))
    out = torch.zeros((b, s, h, hd), dtype=torch.float32)
    for bi in range(b):
        for i0 in range(0, s, TILE):
            rows = slice(i0, min(i0 + TILE, s))
            pos = q_pos[bi, rows].long()
            p_max = int(pos.max())
            n_kv = 0 if p_max < 0 else min(p_max + 1, cap)
            n = pos.shape[0]
            for hi in range(h):
                qf = q[bi, rows, hi].float()
                m = torch.full((n,), -math.inf)
                l = torch.zeros(n)
                acc = torch.zeros((n, hd))
                for k0 in range(0, n_kv, TILE):
                    kt = torch.zeros((TILE, hd))
                    vt = torch.zeros((TILE, hd))
                    hi_key = min(k0 + TILE, cap)
                    kt[:hi_key - k0] = k[bi, k0:hi_key, hi].float()
                    vt[:hi_key - k0] = v[bi, k0:hi_key, hi].float()
                    vt[max(0, n_kv - k0):] = 0.0  # the masked tail
                    keys = torch.arange(k0, k0 + TILE)
                    vis = (keys[None] <= pos[:, None]) & (keys[None] < cap)
                    sc = torch.where(vis, _tile_matmul(qf, kt.t())
                                     * scale_log2, -math.inf)
                    m_new = torch.maximum(m, sc.amax(dim=-1))
                    alpha = torch.where(m == -math.inf, 1.0,
                                        torch.exp2(m - m_new))
                    m_use = torch.where(m_new == -math.inf, 0.0, m_new)
                    p = torch.exp2(sc - m_use[:, None])
                    l = alpha * l + p.sum(dim=-1)
                    acc = acc * alpha[:, None] + _tile_matmul(
                        p.bfloat16().float(), vt)
                    m = m_new
                empty = (pos < 0) | (l == 0)
                out[bi, rows, hi] = torch.where(
                    empty[:, None], 0.0, acc / torch.where(empty, 1.0, l)
                    [:, None])
    return out.to(q.dtype)


def gemm_order_model(x, w, out_dtype):
    """The Hopper GEMM's K ranges: each range's f32 product (fixed
    16-row blocks), the partials added in split order, rounded once."""
    K, N = w.shape
    form, _, split = S.serving_gemm_form(x.dtype, K, N)
    assert form == "sm90"
    k_tiles = -(-K // TILE)
    total = None
    for z in range(split):
        lo = TILE * (z * k_tiles // split)
        hi = min(K, TILE * ((z + 1) * k_tiles // split))
        part = S._block_rows(x[:, lo:hi].float(), w[lo:hi].float())
        total = part if total is None else total + part
    return total.to(out_dtype)


# tests/test_serving.py's config (d_model 64, 4 heads: head_dim 16,
# capacity 32) and GPT-2's head_dim 64.
ATTENTION_CASES = {
    "serving_test_hd16": dict(b=3, s=5, h=4, hd=16, cap=32, pos=[
        [3, 4, 5, 6, 7], [-1, -1, 0, 1, 2], [27, 28, 29, 30, 31]]),
    "hd64": dict(b=3, s=70, h=2, hd=64, cap=160, pos=[0, 50, 90]),
}


def _attention_inputs(case, seed=0):
    c = ATTENTION_CASES[case]
    rng = np.random.default_rng(seed)
    q = _bf16(rng, (c["b"], c["s"], c["h"], c["hd"]))
    k = _bf16(rng, (c["b"], c["cap"], c["h"], c["hd"]))
    v = _bf16(rng, (c["b"], c["cap"], c["h"], c["hd"]))
    pos = c["pos"]
    if isinstance(pos[0], list):
        q_pos = torch.tensor(pos, dtype=torch.int32)
    else:
        q_pos = (torch.tensor(pos)[:, None]
                 + torch.arange(c["s"])[None]).to(torch.int32)
        q_pos[1, :3] = -1  # inactive rows in a tile with active ones
    return q, k, v, q_pos


@pytest.mark.parametrize("case", sorted(ATTENTION_CASES))
def test_attention_order_model_matches_the_reference(case):
    RT = _reference()
    q, k, v, q_pos = _attention_inputs(case)
    want = torch.from_numpy(np.array(RT.cache_attention(
        _jnp_bf16(q), _jnp_bf16(k), _jnp_bf16(v),
        q_pos.numpy()).astype(np.float32)))
    got = attention_order_model(q, k, v, q_pos)
    _within_bf16_allowance(got, want)
    assert bool((got[q_pos < 0] == 0).all())


@pytest.mark.parametrize("case", sorted(ATTENTION_CASES))
def test_attention_order_model_is_bitwise_across_rows_and_batch(case):
    q, k, v, q_pos = _attention_inputs(case, seed=1)
    full = attention_order_model(q, k, v, q_pos)
    s = q.shape[1]
    for n in sorted({1, 2, 3, s // 2, s - 1, min(s, 65)}):
        part = attention_order_model(q[:, :n], k, v, q_pos[:, :n])
        assert torch.equal(part, full[:, :n]), n
    for bi in range(q.shape[0]):
        alone = attention_order_model(q[bi:bi + 1], k[bi:bi + 1],
                                      v[bi:bi + 1], q_pos[bi:bi + 1])
        assert torch.equal(alone[0], full[bi]), bi


def test_a_wholly_masked_key_tile_is_an_exact_no_op():
    """A row at position 5 in a block whose other row reaches key 200
    runs four key tiles, three of them wholly masked for it: the same
    bits as the row alone (one tile)."""
    rng = np.random.default_rng(2)
    q = _bf16(rng, (1, 2, 2, 64))
    k, v = _bf16(rng, (1, 256, 2, 64)), _bf16(rng, (1, 256, 2, 64))
    both = attention_order_model(q, k, v, torch.tensor([[5, 200]]))
    alone = attention_order_model(q[:, :1], k, v, torch.tensor([[5]]))
    assert torch.equal(both[:, :1], alone)


def test_negative_positions_give_zeros_and_nan_tails_stay_out():
    """q_pos < 0 rows are zero; K and V hold NaN past every row's
    position and the output is bitwise that of a zeroed tail."""
    q, k, v, q_pos = _attention_inputs("hd64", seed=3)
    q_pos[2, :] = -1
    kz, vz = k.clone(), v.clone()
    kn, vn = k.clone(), v.clone()
    for bi in range(q.shape[0]):
        last = int(q_pos[bi].max()) + 1
        kz[bi, last:], vz[bi, last:] = 0, 0
        kn[bi, last:], vn[bi, last:] = float("nan"), float("nan")
    got = attention_order_model(q, kn, vn, q_pos)
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, attention_order_model(q, kz, vz, q_pos))
    assert bool((got[q_pos < 0] == 0).all())
    assert bool((got[2] == 0).all())


# GPT-2-small's products (K, N), their tile width and split (the rule's
# outputs): the narrow product with a long K splits it, the wide ones
# take 128 columns.
GPT2_GEMMS = {"qkv": (768, 2304, 128, 1), "wo": (768, 768, 64, 1),
              "w_in": (768, 3072, 128, 1), "w_out": (3072, 768, 64, 4),
              "logits": (768, 32768, 128, 1)}


@pytest.mark.parametrize("name", sorted(GPT2_GEMMS))
def test_gemm_form_and_split_at_gpt2_widths(name):
    K, N, tile_n, split = GPT2_GEMMS[name]
    assert S.serving_gemm_form(torch.bfloat16, K, N) == ("sm90", tile_n,
                                                         split)
    assert S.serving_gemm_form(torch.float32, K, N) == ("first", 0, 1)


def test_the_routing_functions_take_no_rows_or_batch():
    """The form is a function of the dtype and the widths alone: nothing
    that would let a row's arithmetic depend on M, s or b."""
    assert list(inspect.signature(S.serving_gemm_form).parameters) == [
        "dtype", "K", "N"]
    assert list(inspect.signature(S.cache_attention_form).parameters) == [
        "dtype", "head_dim"]
    for K, N in ((770, 768), (768, 36), (4, 768)):
        assert S.serving_gemm_form(torch.bfloat16, K, N)[0] == "first"
    assert S.serving_gemm_form(torch.bfloat16, 8, 8) == ("sm90", 64, 1)
    assert S.serving_gemm_form(torch.bfloat16, 768, 2056)[1] == 64
    for hd, form in ((16, "first"), (32, "first"), (64, "sm90"),
                     (80, "sm90"), (96, "sm90"), (128, "sm90"),
                     (256, "first")):
        assert S.cache_attention_form(torch.bfloat16, hd) == form
        assert S.cache_attention_form(torch.float32, hd) == "first"


def test_split_is_at_most_one_cluster():
    """The K ranges of a split product are the blocks of one cluster:
    never more than the portable cluster size, at any width."""
    for K in (512, 3072, 8192, 65536):
        for N in (8, 64, 768, 3072):
            form, _, split = S.serving_gemm_form(torch.bfloat16, K, N)
            assert form == "sm90" and 1 <= split <= S.GEMM_SPLIT_MAX == 8
            assert split <= -(-K // TILE) // S.GEMM_SPLIT_MIN_K_TILES or \
                split == 1


def test_gemm_operands_are_read_at_their_own_row_pitch():
    """A column slice is passed as it is, with its row pitch (what the
    tensor map is told); a pitch that is not a multiple of 8 elements, or
    a base that is not 16-byte aligned, is copied to a contiguous matrix
    first."""
    big = torch.zeros(16, 3 * 768, dtype=torch.bfloat16)
    view, ld = S._tma_rows(big[:, 768:1536])
    assert view.data_ptr() == big[:, 768:1536].data_ptr() and ld == 3 * 768
    whole, ld = S._tma_rows(big)
    assert whole.data_ptr() == big.data_ptr() and ld == 3 * 768
    one_row, ld = S._tma_rows(big[3:4, 768:1536])
    assert one_row.data_ptr() == big[3:4, 768:1536].data_ptr() and ld == 768
    for odd in (torch.zeros(16, 772, dtype=torch.bfloat16)[:, :768],
                big[:, 4:772], big[:, 768:1536:2]):
        copy, ld = S._tma_rows(odd)
        assert copy.is_contiguous() and ld == odd.shape[1]
        assert copy.data_ptr() != odd.data_ptr()
        assert torch.equal(copy, odd)


@pytest.mark.parametrize("K,N,out", [(768, 768, None), (3072, 768, None),
                                     (768, 2304, None),
                                     (768, 512, torch.float32)])
def test_gemm_order_model_matches_the_reference(K, N, out):
    RT = _reference()
    import jax.numpy as jnp
    rng = np.random.default_rng(K + N)
    x = _bf16(rng, (40, K))
    w = _bf16(rng, (K, N), K ** -0.5)
    got = gemm_order_model(x, w, out or torch.bfloat16)
    if out is None:
        want = np.array(jnp.dot(_jnp_bf16(x), _jnp_bf16(w)).astype(
            jnp.float32))
        _within_bf16_allowance(got, torch.from_numpy(want))
    else:  # the logits: f32 products of bf16 values, exact in f32
        want = torch.from_numpy(np.array(jnp.dot(
            _jnp_bf16(x).astype(jnp.float32),
            _jnp_bf16(w).astype(jnp.float32))))
        rms = want.pow(2).mean(dim=-1, keepdim=True).sqrt()
        assert bool(((got - want).abs() <= 1e-5 * rms).all())
    for m in (1, 2, 16, 37):
        assert torch.equal(gemm_order_model(x[:m], w, out or torch.bfloat16),
                           got[:m]), m


# ---------------------------------------------------------------------------
# On the card: both forms against the plain versions
# ---------------------------------------------------------------------------

@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the serving kernels' forms run "
                    "only on the GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("K,N,out", [(64, 64, torch.bfloat16),
                                     (768, 768, torch.bfloat16),
                                     (3072, 768, torch.bfloat16),
                                     (768, 2304, torch.bfloat16),
                                     (200, 2176, torch.bfloat16),
                                     (768, 2304, torch.float32)])
def test_gemm_forms_against_the_plain_version(cuda_device, K, N, out):
    g = torch.Generator().manual_seed(K * N)
    x = torch.randn(130, K, generator=g).to(cuda_device, torch.bfloat16)
    w = (torch.randn(K, N, generator=g) * K ** -0.5).to(cuda_device,
                                                        torch.bfloat16)
    S.reset_launches()
    full = S.serving_gemm(x, w, out_dtype=out)
    assert torch.equal(S.serving_gemm(x, w, out_dtype=out), full)
    first = S._first_form_gemm(x, w, out)
    torch.cuda.synchronize()
    assert S.launches_by_form[("serving_gemm", "sm90")] == 2
    assert S.launches_by_form[("serving_gemm", "first")] == 1
    want = S.serving_gemm_plain(x, w, out)
    for got in (full, first):
        if out == torch.bfloat16:
            _within_bf16_allowance(got, want)
        else:
            rms = want.pow(2).mean(dim=-1, keepdim=True).sqrt()
            assert bool(((got - want).abs() <= 1e-5 * rms).all())
    for m in (1, 2, 16, 63, 64, 65, 127):
        assert torch.equal(S.serving_gemm(x[:m], w, out_dtype=out),
                           full[:m]), m


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 128])
def test_attention_forms_against_the_plain_version(cuda_device, hd):
    """q a view of a fused product, K and V views of a buffer one row
    longer (forward_step's), NaN past every row's position: the Hopper
    form reads no copy and no NaN, and its rows do not depend on s or
    b."""
    b, s, h, cap = 3, 130, 2, 200
    g = torch.Generator().manual_seed(hd)
    fused = torch.randn(b, s, 3 * h * hd, generator=g).to(cuda_device,
                                                          torch.bfloat16)
    q = fused[..., :h * hd].reshape(b, s, h, hd)
    kbuf = torch.randn(b, cap + 1, h, hd, generator=g).to(cuda_device,
                                                          torch.bfloat16)
    vbuf = torch.randn(b, cap + 1, h, hd, generator=g).to(cuda_device,
                                                          torch.bfloat16)
    k, v = kbuf[:, :cap], vbuf[:, :cap]
    q_pos = (torch.tensor([0, 40, 69])[:, None]
             + torch.arange(s)[None]).to(cuda_device)
    q_pos[0, :5] = -1
    kz, vz = k.clone(), v.clone()
    for bi in range(b):
        last = int(q_pos[bi].max()) + 1
        k[bi, last:], v[bi, last:] = float("nan"), float("nan")
        kz[bi, last:], vz[bi, last:] = 0, 0
    S.reset_launches()
    full = S.cache_attention(q, k, v, q_pos)
    assert torch.equal(S.cache_attention(q, k, v, q_pos), full)
    first = S._first_form_attention(q, kz, vz, q_pos)
    torch.cuda.synchronize()
    assert S.launches_by_form[("cache_attention", "sm90")] == 2
    assert S.launches_by_form[("cache_attention", "first")] == 1
    want = S.cache_attention_plain(q, kz, vz, q_pos)
    _within_bf16_allowance(full, want)
    _within_bf16_allowance(first, want)
    assert bool((full[q_pos < 0] == 0).all())
    for n in (1, 2, 37, 64, 65, 127):
        assert torch.equal(S.cache_attention(q[:, :n], k, v, q_pos[:, :n]),
                           full[:, :n]), n
    for bi in range(b):
        assert torch.equal(S.cache_attention(
            q[bi:bi + 1], k[bi:bi + 1], v[bi:bi + 1], q_pos[bi:bi + 1])[0],
            full[bi]), bi


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [(16, 3072, 768), (130, 3072, 768),
                                   (16, 768, 3072), (130, 768, 2304)])
def test_gemm_reads_strided_operands_in_place(cuda_device, M, K, N):
    """x a column slice of a wider matrix (q of a fused product), w a
    column slice of a wider weight: rows read at their own pitch, split
    and unsplit, the same bits as on contiguous copies."""
    g = torch.Generator().manual_seed(M + K + N)
    xb = torch.randn(M, 3 * K, generator=g).to(cuda_device, torch.bfloat16)
    wb = (torch.randn(K, N + 64, generator=g) * K ** -0.5).to(
        cuda_device, torch.bfloat16)
    x, w = xb[:, K:2 * K], wb[:, 64:]
    assert not x.is_contiguous() and not w.is_contiguous()
    got = S.serving_gemm(x, w)
    assert torch.equal(got, S.serving_gemm(x.contiguous(), w.contiguous()))
    _within_bf16_allowance(got, S.serving_gemm_plain(x, w))


@pytest.mark.cuda
def test_f32_and_other_widths_take_the_first_form(cuda_device):
    S.reset_launches()
    x = torch.randn(16, 768, device=cuda_device)
    S.serving_gemm(x, torch.randn(768, 64, device=cuda_device))
    q = torch.randn(1, 2, 4, 16, device=cuda_device, dtype=torch.bfloat16)
    kv = torch.randn(1, 8, 4, 16, device=cuda_device, dtype=torch.bfloat16)
    S.cache_attention(q, kv, kv, torch.tensor([[3, 4]], device=cuda_device))
    torch.cuda.synchronize()
    assert S.launches_by_form == {
        ("serving_gemm", "first"): 1, ("serving_gemm", "sm90"): 0,
        ("cache_attention", "first"): 1, ("cache_attention", "sm90"): 0}
