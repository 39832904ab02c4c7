"""The serving half of horovod_tpu_torch/models/transformer.py and its two
kernels' plain versions (ops/serving.py), against horovod_tpu's.

Parity with the reference on tests/test_serving.py's config (f32 logits
and KV within 1e-5; greedy tokens equal where the reference's top-2
margin exceeds 1e-4); then the port's own bitwise contract, case for case
with tests/test_serving.py:375-490: prefill + width-2 decodes equal the
non-incremental forward, at the final capacity position, and a ragged
batch equals each sequence alone; the plain GEMM row-invariant at
GPT-2-small's widths where ``torch.matmul`` is not; out-of-range
positions clamp instead of raising; a CUDA tensor never takes a plain
version.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import transformer as RT
from horovod_tpu_torch.models import transformer as TT
from horovod_tpu_torch.ops import _build
from horovod_tpu_torch.ops import serving as S
from torch_serving_cases import (CFG, CFG_R, DRAFT, DRAFT_CFG, DRAFT_CFG_R,
                                 DRAFT_R, PARAMS, PARAMS_R, MARGIN)

TOL = 1e-5
HD = CFG.d_model // CFG.n_heads


def _tokens(seed, shape, vocab=CFG.vocab_size):
    return np.random.default_rng(seed).integers(0, vocab, shape)


def _zeros(b, cap, cfg=CFG):
    return torch.zeros((cfg.n_layers, b, cap, cfg.n_heads,
                        cfg.d_model // cfg.n_heads))


def _step(tokens, start, kv, vv):
    with torch.no_grad():
        return TT.forward_step(PARAMS, torch.as_tensor(tokens),
                               torch.as_tensor(start), kv, vv, CFG)


# ---------------------------------------------------------------------------
# Parity with the reference
# ---------------------------------------------------------------------------

def test_cache_attention_plain_matches_the_reference():
    rng = np.random.default_rng(0)
    b, s, h, hd, cap = 3, 5, 4, 16, 24
    q, k, v = (rng.standard_normal(shape).astype(np.float32) for shape in
               ((b, s, h, hd), (b, cap, h, hd), (b, cap, h, hd)))
    q_pos = np.array([[3, 4, 5, 6, 7], [-1, -1, 0, 1, 2],
                      [19, 20, 21, 22, 23]], np.int32)
    want = np.asarray(RT.cache_attention(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), jnp.asarray(q_pos)))
    got = S.cache_attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), torch.from_numpy(q_pos))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    assert torch.equal(got[1, :2], torch.zeros(2, h, hd))  # empty masks


@pytest.mark.parametrize("out_dtype", [None, torch.float32])
def test_serving_gemm_plain_matches_a_float64_product(out_dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 37, 64)).astype(np.float32)
    w = rng.standard_normal((64, 48)).astype(np.float32)
    got = S.serving_gemm(torch.from_numpy(x), torch.from_numpy(w),
                         out_dtype=out_dtype)
    assert got.shape == (3, 37, 48) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), x.astype(np.float64) @ w,
                               atol=1e-4, rtol=1e-5)


def test_serving_gemm_bf16_rounds_once_and_logits_stay_f32():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((20, 64)).astype(
        np.float32)).bfloat16()
    w = torch.from_numpy(rng.standard_normal((64, 32)).astype(
        np.float32)).bfloat16()
    exact = x.double() @ w.double()
    got = S.serving_gemm(x, w)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, S.serving_gemm(x, w, torch.float32).bfloat16())
    f32 = S.serving_gemm(x, w, out_dtype=torch.float32)
    assert f32.dtype == torch.float32
    torch.testing.assert_close(f32.double(), exact, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("start", [[0, 0], [5, 11], [-1, 3]])
def test_forward_step_matches_the_reference(start):
    """Logits and the new KV entries of a 4-wide block at ragged starts
    (an inactive slot included) against the reference, from the same
    populated views."""
    cap = 32
    rng = np.random.default_rng(3)
    shape = (CFG.n_layers, 2, cap, CFG.n_heads, HD)
    kv = rng.standard_normal(shape).astype(np.float32) * 0.5
    vv = rng.standard_normal(shape).astype(np.float32) * 0.5
    toks = _tokens(4, (2, 4))
    start_np = np.array(start, np.int32)
    lr, kr, vr = jax.jit(RT.forward_step, static_argnums=(5,))(
        PARAMS_R, jnp.asarray(toks, jnp.int32), jnp.asarray(start_np),
        jnp.asarray(kv), jnp.asarray(vv), CFG_R)
    lt, kt, vt = _step(toks, start_np.astype(np.int64),
                       torch.from_numpy(kv), torch.from_numpy(vv))
    active = start_np >= 0
    np.testing.assert_allclose(lt.numpy()[active], np.asarray(lr)[active],
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(kt.numpy(), np.asarray(kr), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vr), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("length,capacity", [(20, 32), (64, 64)])
def test_serving_forward_matches_the_reference(length, capacity):
    toks = _tokens(5, (2, length))
    want = np.asarray(jax.jit(RT.serving_forward, static_argnums=(2, 3))(
        PARAMS_R, jnp.asarray(toks, jnp.int32), CFG_R, capacity))
    with torch.no_grad():
        got = TT.serving_forward(PARAMS, torch.from_numpy(toks), CFG,
                                 capacity).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > MARGIN
    assert clear.sum() > 0
    assert np.array_equal(got.argmax(-1)[clear], want.argmax(-1)[clear])


def test_speculative_propose_matches_the_reference():
    cap, m = 32, 3
    rng = np.random.default_rng(6)
    shape = (DRAFT_CFG.n_layers, 2, cap, DRAFT_CFG.n_heads,
             DRAFT_CFG.d_model // DRAFT_CFG.n_heads)
    kv = rng.standard_normal(shape).astype(np.float32) * 0.5
    vv = rng.standard_normal(shape).astype(np.float32) * 0.5
    prev, pending = np.array([4, 7]), np.array([9, 1])
    start = np.array([6, 12])
    pr, kr, vr = jax.jit(RT.speculative_propose, static_argnums=(6, 7))(
        DRAFT_R, jnp.asarray(prev, jnp.int32), jnp.asarray(pending, jnp.int32),
        jnp.asarray(start, jnp.int32), jnp.asarray(kv), jnp.asarray(vv),
        DRAFT_CFG_R, m)
    kv_t, vv_t = torch.from_numpy(kv), torch.from_numpy(vv)
    before = kv_t.clone()
    with torch.no_grad():
        pt, kt, vt = TT.speculative_propose(
            DRAFT, torch.from_numpy(prev), torch.from_numpy(pending),
            torch.from_numpy(start), kv_t, vv_t, DRAFT_CFG, m)
    assert torch.equal(kv_t, before)  # the caller's view is not written
    assert pt.tolist() == np.asarray(pr).tolist()
    np.testing.assert_allclose(kt.numpy(), np.asarray(kr), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vr), atol=TOL,
                               rtol=TOL)


# ---------------------------------------------------------------------------
# The port's bitwise contract (tests/test_serving.py:375-490)
# ---------------------------------------------------------------------------

def test_prefill_plus_decode_bitwise_equals_noncached_forward():
    b, P, N, cap = 2, 7, 9, 32
    toks = torch.from_numpy(_tokens(1, (b, P + N)))
    zero = torch.zeros(b, dtype=torch.long)
    ref, _, _ = _step(toks, zero, _zeros(b, cap), _zeros(b, cap))
    k, v = _zeros(b, cap), _zeros(b, cap)
    logits, kn, vn = _step(toks[:, :P], zero, k, v)
    assert torch.equal(logits, ref[:, :P])
    k[:, :, :P], v[:, :, :P] = kn, vn
    for t in range(N):
        blk = torch.stack([toks[:, P + t], torch.zeros(b, dtype=torch.long)],
                          dim=1)
        logits, kn, vn = _step(blk, torch.full((b,), P + t), k, v)
        assert torch.equal(logits[:, 0], ref[:, P + t]), f"step {t}"
        k[:, :, P + t], v[:, :, P + t] = kn[:, :, 0], vn[:, :, 0]


def test_decode_at_final_capacity_position_is_bitwise():
    """A [token, dummy] block at start == capacity - 1: the token keeps
    its index, the dummy drops (and reads a clamped ``pos_embed`` row:
    position capacity == max_seq_len here)."""
    b, cap = 2, CFG.max_seq_len
    toks = torch.from_numpy(_tokens(4, (b, cap)))
    zero = torch.zeros(b, dtype=torch.long)
    ref, k_ref, _ = _step(toks, zero, _zeros(b, cap), _zeros(b, cap))
    _, kn, vn = _step(toks[:, :cap - 1], zero, _zeros(b, cap),
                      _zeros(b, cap))
    k, v = _zeros(b, cap), _zeros(b, cap)
    k[:, :, :cap - 1], v[:, :, :cap - 1] = kn, vn
    blk = torch.stack([toks[:, cap - 1], torch.zeros(b, dtype=torch.long)],
                      dim=1)
    logits, kn2, _ = _step(blk, torch.full((b,), cap - 1), k, v)
    assert torch.equal(logits[:, 0], ref[:, cap - 1])
    assert torch.equal(kn2[:, :, 0], k_ref[:, :, cap - 1])
    assert bool(torch.isfinite(logits).all())


def test_ragged_batch_masking_matches_per_sequence_runs():
    cap = 16
    zero = torch.zeros(1, dtype=torch.long)
    t1, t2 = (torch.from_numpy(_tokens(s, (1, n))) for s, n in ((2, 5),
                                                                 (3, 9)))
    _, k1, v1 = _step(t1, zero, _zeros(1, cap), _zeros(1, cap))
    _, k2, v2 = _step(t2, zero, _zeros(1, cap), _zeros(1, cap))

    def install(view, new, row):
        view[:, row, :new.shape[2]] = new[:, 0]
        return view

    kb = install(install(_zeros(2, cap), k1, 0), k2, 1)
    vb = install(install(_zeros(2, cap), v1, 0), v2, 1)
    toks = torch.tensor([[7, 0], [11, 0]])
    lb, _, _ = _step(toks, torch.tensor([5, 9]), kb, vb)
    la, _, _ = _step(toks[:1], torch.tensor([5]),
                     install(_zeros(1, cap), k1, 0),
                     install(_zeros(1, cap), v1, 0))
    lc, _, _ = _step(toks[1:], torch.tensor([9]),
                     install(_zeros(1, cap), k2, 0),
                     install(_zeros(1, cap), v2, 0))
    assert torch.equal(lb[0, 0], la[0, 0])
    assert torch.equal(lb[1, 0], lc[0, 0])
    linact, _, _ = _step(toks, torch.tensor([5, -1]), kb, vb)
    assert bool(torch.isfinite(linact).all())


def test_forward_step_leaves_the_callers_views_alone():
    k, v = _zeros(2, 16), _zeros(2, 16)
    k[:, :, :3] = 1.0
    before = (k.clone(), v.clone())
    _step(torch.tensor([[1, 2], [3, 4]]), torch.tensor([3, 15]), k, v)
    assert torch.equal(k, before[0]) and torch.equal(v, before[1])


def test_fused_qkv_built_once_gives_the_same_bits():
    """serving_params' [wq | wk | wv], built once, is the weight
    forward_step otherwise concatenates per call: the same bits out."""
    fused = TT.serving_params(PARAMS)
    assert fused["layers"]["wqkv"].shape == (
        CFG.n_layers, CFG.d_model, 3 * CFG.d_model)
    toks = torch.from_numpy(_tokens(9, (2, 3)))
    start = torch.tensor([4, 0])
    kv, vv = _zeros(2, 16), _zeros(2, 16)
    kv[:, :, :4] = 0.5
    want = _step(toks, start, kv, vv)
    with torch.no_grad():
        got = TT.forward_step(fused, toks, start, kv, vv, CFG)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_positions_past_max_seq_len_clamp_instead_of_raising():
    """A verify block whose tail passes max_seq_len (the reference's
    jnp.take gives NaN there; torch would raise): the rows in range are
    unchanged, the others finite."""
    cap = CFG.max_seq_len
    toks = torch.from_numpy(_tokens(8, (1, 4)))
    ref, _, _ = _step(toks[:, :2], torch.tensor([cap - 2]),
                      _zeros(1, cap), _zeros(1, cap))
    logits, _, _ = _step(toks, torch.tensor([cap - 2]), _zeros(1, cap),
                         _zeros(1, cap))
    assert torch.equal(logits[:, :2], ref)
    assert bool(torch.isfinite(logits).all())


# ---------------------------------------------------------------------------
# Row invariance of the plain versions
# ---------------------------------------------------------------------------

ROWS = (2, 16, 32, 37, 64, 128, 512)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K,N", [(3072, 768), (768, 32768)])
def test_plain_gemm_is_row_invariant_at_gpt2_widths(K, N, dtype):
    """Row i of ``x[:M] @ W`` has the same bits for every M (the widths
    where ``torch.matmul`` on the CPU does not: FFN-out and the
    logits)."""
    g = torch.Generator().manual_seed(K + N)
    x = torch.randn(max(ROWS), K, generator=g).to(dtype)
    w = (torch.randn(K, N, generator=g) * K ** -0.5).to(dtype)
    out = torch.float32 if N == 32768 else None
    full = S.serving_gemm(x, w, out_dtype=out)
    for m in ROWS[:-1]:
        assert torch.equal(S.serving_gemm(x[:m], w, out_dtype=out),
                           full[:m]), m


def test_plain_cache_attention_is_row_invariant_in_batch_and_rows():
    rng = np.random.default_rng(9)
    b, s, h, hd, cap = 3, 40, 4, 16, 64
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)) for shape in ((b, s, h, hd), (b, cap, h, hd),
                                   (b, cap, h, hd)))
    q_pos = torch.arange(s)[None].repeat(b, 1) + torch.tensor([[0], [7],
                                                               [20]])
    full = S.cache_attention(q, k, v, q_pos)
    for bi in range(b):
        for rows in (slice(0, 2), slice(5, 7), slice(3, 40), slice(17, 18)):
            one = S.cache_attention(q[bi:bi + 1, rows], k[bi:bi + 1],
                                    v[bi:bi + 1], q_pos[bi:bi + 1, rows])
            assert torch.equal(one[0], full[bi, rows]), (bi, rows)


# ---------------------------------------------------------------------------
# No plain version for a CUDA tensor
# ---------------------------------------------------------------------------

def test_cuda_tensors_never_take_the_plain_serving_kernels(monkeypatch):
    from torch._subclasses.fake_tensor import FakeTensorMode

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    def plain_called(*args, **kwargs):
        raise AssertionError("a CUDA tensor took the plain version")

    monkeypatch.setattr(_build, "nvcc_path", no_nvcc)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(S, "_entry_points", {})
    monkeypatch.setattr(S, "serving_gemm_plain", plain_called)
    monkeypatch.setattr(S, "cache_attention_plain", plain_called)
    S.reset_launches()
    with warnings.catch_warnings(), FakeTensorMode():
        warnings.simplefilter("ignore")
        x = torch.empty(4, 64, device="cuda")
        w = torch.empty(64, 32, device="cuda")
        q = torch.empty(1, 2, 4, 16, device="cuda")
        kv = torch.empty(1, 8, 4, 16, device="cuda")
        pos = torch.zeros(1, 2, dtype=torch.long, device="cuda")
        with pytest.raises(RuntimeError, match="nvcc not found"):
            S.serving_gemm(x, w)
        with pytest.raises(RuntimeError, match="nvcc not found"):
            S.cache_attention(q, kv, kv, pos)
    assert S.launches == {name: 0 for name in S.KERNELS}


def test_mixed_devices_are_refused():
    with pytest.raises(ValueError, match="all on the CPU"):
        S.serving_gemm(torch.zeros(2, 4), torch.zeros(4, 4, device="meta"))


@pytest.mark.parametrize("N", [128, 3072])
def test_cpu_gelu_is_row_invariant(N):
    """ATen's CPU GELU over a large tensor gives some elements its
    scalar tanh (the tail of each thread's range): ``gelu_tanh`` runs in
    single-thread pieces so no row's bits depend on the number of rows;
    the values are F.gelu's."""
    x = torch.randn(max(ROWS) + 3, N, generator=torch.Generator().manual_seed(N))
    full = S.gelu_tanh(x)
    for m in ROWS + (315,):
        assert torch.equal(S.gelu_tanh(x[:m]), full[:m]), m
    torch.testing.assert_close(full, torch.nn.functional.gelu(
        x, approximate="tanh"), atol=1e-6, rtol=1e-6)
