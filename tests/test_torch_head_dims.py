"""The port at head_dim 80 and 96 (GPT-3 2.7B's and GPT-3 Large's widths,
Brown et al. 2020, Table 2.1) against horovod_tpu, whose Pallas kernels
take any head_dim.

On the CPU, the same inputs drawn with numpy from a seed go through the
JAX package and the port:

* flash attention: the forward against the Pallas kernels in interpret
  mode (HVD_TPU_FLASH_INTERPRET=1, as tests/test_torch_flash_attention.py
  runs them), and the gradients against jax.grad through the Pallas
  backward kernels in interpret mode, on that file's masked, ragged and
  offset cases at small b/h/seq.  f32; the reference's tolerances, 5e-5
  forward and 1e-4 backward.
* a 2-layer model at GPT-3 Large's head width (d_model 192, 2 heads of
  96, d_ff 768, vocab 512, seq 128, f32) and at GPT-3 2.7B's (d_model
  160, 2 heads of 80), carried across with utils/convert.params_from_jax:
  the loss and every gradient (1e-4), and two SGD steps of
  make_train_step against the reference's on two virtual devices (loss
  1e-5, parameters 1e-4), as tests/test_torch_data_parallel.py holds
  them at head_dim 16.
* serving at the same widths: serving_forward and forward_step against
  the reference (1e-5), and the port's bitwise contract (prefill plus
  width-2 decodes equal the non-incremental forward).
* the kernels' validation: 80 and 96 are taken, any other width raises
  with a message that names the set.

On a GPU (marked ``cuda``, skipped here): each flash kernel and both
forms of ``cache_attention`` at 80 and 96 against their plain versions,
by tests/test_torch_flash_kernels.py's and
tests/test_torch_serving_kernels.py's checks.
The reference is imported inside the tests that need it, so on a machine
with PyTorch alone the GPU tests run with::

    python -m pytest --noconftest -q tests/test_torch_head_dims.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from horovod_tpu_torch.models import transformer as TT
from horovod_tpu_torch.ops import flash_attention as tfa
from horovod_tpu_torch.ops import serving as S
from horovod_tpu_torch.utils.convert import params_from_jax, params_to_numpy
from horovod_tpu_torch.utils.tree import tree_flatten
from test_torch_flash_kernels import _check_against_plain
from test_torch_serving_kernels import (
    test_attention_forms_against_the_plain_version as
    _attention_forms_against_the_plain_version)

HEAD_DIMS = (80, 96)
TOL_FWD, TOL_BWD = 5e-5, 1e-4   # the reference's flash tolerances
TOL_SERVE = 1e-5                # tests/test_torch_serving_model.py's


def _jax():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    return jax, jnp


def _qkv(q_len, kv_len, d, seed, b=1, h=2):
    rng = np.random.RandomState(seed)
    q = rng.standard_normal((b, h, q_len, d)).astype(np.float32)
    k = rng.standard_normal((b, h, kv_len, d)).astype(np.float32)
    v = rng.standard_normal((b, h, kv_len, d)).astype(np.float32)
    g = rng.standard_normal((b, h, q_len, d)).astype(np.float32)
    return q, k, v, g


def _t(*xs):
    return [torch.from_numpy(x.copy()) for x in xs]


def _err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    return float(np.max(np.abs(a - b))) if a.size else 0.0


# ---------------------------------------------------------------------------
# Flash attention against the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------

# (label, q_len, kv_len, causal, q_block_offset, JAX block):
# tests/test_torch_flash_attention.py's cases, with a fully masked one.
CASES = [
    ("causal", 64, 64, True, 0, 32),
    ("non_causal", 64, 64, False, 0, 32),
    ("uneven_tail", 40, 40, True, 0, 16),
    ("q_shorter_than_kv", 16, 64, False, 0, 16),
    ("q_block_offset", 32, 64, True, 32, 16),
    ("fully_masked", 32, 32, True, -1000, 16),
]


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("label,q_len,kv_len,causal,offset,block", CASES,
                         ids=[c[0] for c in CASES])
def test_forward_matches_jax_pallas_interpret(monkeypatch, d, label, q_len,
                                              kv_len, causal, offset, block):
    jax, jnp = _jax()
    from horovod_tpu.ops import flash_attention as jfa
    monkeypatch.setenv("HVD_TPU_FLASH_INTERPRET", "1")
    q, k, v, _ = _qkv(q_len, kv_len, d, seed=d + len(label))
    o_j, lse_j = jfa.flash_attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        q_block_offset=offset, block_q=block, block_k=block)
    o_t, lse_t = tfa.flash_attention_with_lse(*_t(q, k, v), causal=causal,
                                              q_block_offset=offset)
    assert _err(o_t, o_j) < TOL_FWD
    fin = np.isfinite(np.asarray(lse_j))
    assert np.array_equal(torch.isfinite(lse_t).numpy(), fin)
    assert _err(lse_t.numpy()[fin], np.asarray(lse_j)[fin]) < TOL_FWD


# The backward in interpret mode is the reference's slowest path: the
# gradient cases keep one head and at most 48 rows.
GRAD_CASES = [
    ("causal", 48, 48, True, 0, 16),
    ("uneven_tail", 40, 40, True, 0, 16),
    ("q_shorter_than_kv", 16, 48, False, 0, 16),
    ("q_block_offset", 32, 48, True, 16, 16),
    ("partly_masked", 32, 48, True, -8, 16),
]


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("label,q_len,kv_len,causal,offset,block",
                         GRAD_CASES, ids=[c[0] for c in GRAD_CASES])
def test_gradients_match_jax_pallas_interpret(monkeypatch, d, label, q_len,
                                              kv_len, causal, offset, block):
    jax, jnp = _jax()
    from horovod_tpu.ops import flash_attention as jfa
    monkeypatch.setenv("HVD_TPU_FLASH_INTERPRET", "1")
    q, k, v, g = _qkv(q_len, kv_len, d, seed=10 * d + len(label), h=1)

    def f(q, k, v):
        o = jfa.flash_attention(q, k, v, causal=causal,
                                q_block_offset=offset, block_q=block,
                                block_k=block)
        return jnp.sum(o * jnp.asarray(g))

    want = jax.grad(f, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    qt, kt, vt = (x.requires_grad_() for x in _t(q, k, v))
    o = tfa.flash_attention(qt, kt, vt, causal=causal, q_block_offset=offset)
    o.backward(torch.from_numpy(g))
    for got, ref in zip((qt.grad, kt.grad, vt.grad), want):
        assert bool(torch.isfinite(got).all())
        assert _err(got, ref) < TOL_BWD


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_fully_masked_rows_have_zero_gradients(d):
    q, k, v, g = _qkv(32, 32, d, seed=d)
    qt, kt, vt = (x.requires_grad_() for x in _t(q, k, v))
    o = tfa.flash_attention(qt, kt, vt, causal=True, q_block_offset=-1000)
    assert bool(torch.all(o == 0.0))
    o.backward(torch.from_numpy(g))
    for t in (qt, kt, vt):
        assert bool(torch.all(t.grad == 0.0))


@pytest.mark.parametrize("d", [16, 32, 64, 80, 96, 128])
def test_kernel_widths_are_taken(d):
    q = torch.zeros(2, 8, d)
    assert d in tfa.HEAD_DIMS
    assert all(x.shape == q.shape for x in tfa._kernel_operands(q, q, q))


@pytest.mark.parametrize("d", [8, 48, 72, 112, 160, 256])
def test_other_widths_raise_naming_the_supported_set(d):
    q = torch.zeros(2, 8, d)
    with pytest.raises(ValueError) as e:
        tfa._kernel_operands(q, q, q)
    assert "(16, 32, 64, 80, 96, 128)" in str(e.value)
    assert f"got {d}" in str(e.value)


@pytest.mark.parametrize("d", [16, 32, 64, 80, 96, 128])
def test_flash_kernel_form_is_hopper_for_bf16_from_64(d):
    """kernel_form mirrors hopper_form (csrc/flash_common.cuh): the
    launch counts by (kernel, form, head_dim) name the kernel that ran."""
    assert tfa.kernel_form(torch.bfloat16, d) == ("sm90" if d >= 64
                                                  else "first")
    assert tfa.kernel_form(torch.float32, d) == "first"


@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_cache_attention_takes_the_hopper_form_in_bf16(hd):
    assert S.cache_attention_form(torch.bfloat16, hd) == "sm90"
    assert S.cache_attention_form(torch.float32, hd) == "first"


def test_gpt3_large_runs_the_hopper_forms_but_its_logits_product():
    """GPT-3 Large as chip_smoke.py trains and serves it (Brown et al.
    2020, Table 2.1; GPT-2's vocabulary, untied unembedding): 837,347,328
    parameters by the reference's own shapes; its head_dim 96 takes the
    flash kernels and cache_attention's Hopper form; every serving
    product takes serving_gemm's Hopper form but the logits (vocab 50257
    is not a multiple of 8: the first form)."""
    jax, jnp = _jax()
    from horovod_tpu.models import transformer as RT
    shape = dict(vocab_size=50257, d_model=1536, n_heads=16, n_layers=24,
                 d_ff=6144, max_seq_len=2048)
    cfg = TT.TransformerConfig(**shape, dtype=torch.bfloat16)
    tree = jax.eval_shape(
        lambda key: RT.init_transformer(
            key, RT.TransformerConfig(**shape, dtype=jnp.bfloat16)),
        jax.random.PRNGKey(0))
    assert sum(int(np.prod(leaf.shape)) for leaf in
               jax.tree_util.tree_leaves(tree)) == 837_347_328
    hd = cfg.d_model // cfg.n_heads
    assert hd == 96 and hd in tfa.HEAD_DIMS
    assert tfa.kernel_form(cfg.dtype, hd) == "sm90"
    assert S.cache_attention_form(cfg.dtype, hd) == "sm90"
    d, f = cfg.d_model, cfg.d_ff
    for K, N in ((d, 3 * d), (d, d), (d, f), (f, d)):
        assert S.serving_gemm_form(cfg.dtype, K, N)[0] == "sm90"
    assert S.serving_gemm_form(cfg.dtype, d, cfg.vocab_size)[0] == "first"


# ---------------------------------------------------------------------------
# A 2-layer model at GPT-3 Large's and GPT-3 2.7B's head widths
# ---------------------------------------------------------------------------

# (d_model, n_heads, d_ff): 2 heads of 96 (GPT-3 Large) and of 80
# (GPT-3 2.7B), d_ff 4 d_model as both.
WIDTHS = {96: (192, 2, 768), 80: (160, 2, 640)}
VOCAB, SEQ = 512, 128


def _configs(hd, **kw):
    from horovod_tpu.models import transformer as RT
    d_model, heads, d_ff = WIDTHS[hd]
    shape = dict(vocab_size=VOCAB, d_model=d_model, n_heads=heads,
                 n_layers=2, d_ff=d_ff, max_seq_len=SEQ, **kw)
    return RT.TransformerConfig(**shape), TT.TransformerConfig(**shape)


def _init(hd, **kw):
    jax, _ = _jax()
    from horovod_tpu.models import transformer as RT
    jcfg, tcfg = _configs(hd, **kw)
    params = jax.tree_util.tree_map(
        np.asarray, RT.init_transformer(jax.random.PRNGKey(hd), jcfg))
    return jcfg, tcfg, params


def _lm_batch(b, seed):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, VOCAB, size=(b, SEQ + 1))
    return toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)


@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_loss_and_every_gradient_match_jax(hd):
    jax, jnp = _jax()
    from horovod_tpu.models import transformer as RT
    jcfg, tcfg, init = _init(hd)
    tokens, targets = _lm_batch(2, seed=hd)
    want_loss, want_grads = jax.jit(jax.value_and_grad(
        RT.make_loss_fn(jcfg, RT.ParallelAxes(data=None))))(
        init, (jnp.asarray(tokens), jnp.asarray(targets)))
    params = params_from_jax(init)
    loss = TT.make_loss_fn(tcfg)(params, (torch.from_numpy(tokens).long(),
                                          torch.from_numpy(targets).long()))
    loss.backward()
    assert abs(float(loss.detach()) - float(want_loss)) < 1e-4
    want_leaves = jax.tree_util.tree_leaves(want_grads)
    got_leaves, _ = tree_flatten(params)
    assert len(got_leaves) == len(want_leaves) == 17
    for got, want in zip(got_leaves, want_leaves):
        assert tuple(got.shape) == want.shape
        assert _err(got.grad, want) < 1e-4


@pytest.fixture()
def port_cpu():
    import horovod_tpu_torch as thvd
    thvd.init(device="cpu")
    yield thvd
    thvd.shutdown()


@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_two_sgd_steps_match_jax_make_train_step(hvd2, port_cpu, hd):
    jax, jnp = _jax()
    import optax
    from horovod_tpu.models import transformer as RT
    from horovod_tpu.parallel.training import make_train_step as jax_step
    jcfg, tcfg, init = _init(hd)
    tokens, targets = _lm_batch(4, seed=hd + 1)

    # Reference: two replicas, two rows each.
    opt = hvd2.DistributedOptimizer(optax.sgd(0.1))
    step = jax_step(RT.make_loss_fn(jcfg, RT.ParallelAxes(data=None)), opt)
    params = jax.tree_util.tree_map(jnp.asarray, init)
    opt_state = opt.init(params)
    want_losses = []
    for _ in range(2):
        params, opt_state, loss = step(
            params, opt_state, (jnp.asarray(tokens), jnp.asarray(targets)))
        want_losses.append(float(loss))

    # Port: one rank, the whole batch of four.
    tparams = params_from_jax(init)
    tstep = port_cpu.make_train_step(
        TT.make_loss_fn(tcfg), port_cpu.DistributedOptimizer(
            torch.optim.SGD(port_cpu.tree_leaves(tparams), lr=0.1)))
    batch = (torch.from_numpy(tokens).long(),
             torch.from_numpy(targets).long())
    got_losses = [float(tstep(tparams, batch)) for _ in range(2)]

    np.testing.assert_allclose(got_losses, want_losses, atol=1e-5, rtol=0)
    got = jax.tree_util.tree_leaves(params_to_numpy(tparams))
    for a, b in zip(got, jax.tree_util.tree_leaves(params)):
        assert _err(a, b) < 1e-4


# ---------------------------------------------------------------------------
# Serving at the same widths
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def served():
    """``{hd: (reference config, reference params, port config, port
    params)}`` at the widths above, max_seq_len 64."""
    jax, _ = _jax()
    from horovod_tpu.models import transformer as RT
    out = {}
    for hd in HEAD_DIMS:
        jcfg, tcfg = (dataclasses.replace(c, max_seq_len=64)
                      for c in _configs(hd))
        params_r = RT.init_transformer(jax.random.PRNGKey(hd + 2), jcfg)
        params = params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                        params_r),
                                 requires_grad=False)
        out[hd] = (jcfg, params_r, tcfg, params)
    return out


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, VOCAB, shape)


def _zeros(tcfg, b, cap):
    return torch.zeros((tcfg.n_layers, b, cap, tcfg.n_heads,
                        tcfg.d_model // tcfg.n_heads))


@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("length,capacity", [(20, 32), (64, 64)])
def test_serving_forward_matches_the_reference(served, hd, length,
                                               capacity):
    jax, jnp = _jax()
    from horovod_tpu.models import transformer as RT
    jcfg, params_r, tcfg, params = served[hd]
    toks = _tokens(hd + length, (2, length))
    want = np.asarray(jax.jit(RT.serving_forward, static_argnums=(2, 3))(
        params_r, jnp.asarray(toks, jnp.int32), jcfg, capacity))
    with torch.no_grad():
        got = TT.serving_forward(params, torch.from_numpy(toks), tcfg,
                                 capacity).numpy()
    np.testing.assert_allclose(got, want, atol=TOL_SERVE, rtol=TOL_SERVE)


@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("start", [[0, 0], [5, 11], [-1, 3]])
def test_forward_step_matches_the_reference(served, hd, start):
    jax, jnp = _jax()
    from horovod_tpu.models import transformer as RT
    jcfg, params_r, tcfg, params = served[hd]
    cap = 32
    rng = np.random.default_rng(hd)
    shape = (tcfg.n_layers, 2, cap, tcfg.n_heads, hd)
    kv = rng.standard_normal(shape).astype(np.float32) * 0.5
    vv = rng.standard_normal(shape).astype(np.float32) * 0.5
    toks = _tokens(hd + 4, (2, 4))
    start_np = np.array(start, np.int32)
    lr, kr, vr = jax.jit(RT.forward_step, static_argnums=(5,))(
        params_r, jnp.asarray(toks, jnp.int32), jnp.asarray(start_np),
        jnp.asarray(kv), jnp.asarray(vv), jcfg)
    with torch.no_grad():
        lt, kt, vt = TT.forward_step(
            params, torch.from_numpy(toks), torch.from_numpy(
                start_np.astype(np.int64)), torch.from_numpy(kv),
            torch.from_numpy(vv), tcfg)
    active = start_np >= 0
    np.testing.assert_allclose(lt.numpy()[active], np.asarray(lr)[active],
                               atol=TOL_SERVE, rtol=TOL_SERVE)
    for got, want in ((kt, kr), (vt, vr)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=TOL_SERVE, rtol=TOL_SERVE)


@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_cache_attention_plain_matches_the_reference(hd):
    jax, jnp = _jax()
    from horovod_tpu.models import transformer as RT
    rng = np.random.default_rng(hd)
    b, s, h, cap = 3, 5, 2, 24
    q, k, v = (rng.standard_normal(shape).astype(np.float32) for shape in
               ((b, s, h, hd), (b, cap, h, hd), (b, cap, h, hd)))
    q_pos = np.array([[3, 4, 5, 6, 7], [-1, -1, 0, 1, 2],
                      [19, 20, 21, 22, 23]], np.int32)
    want = np.asarray(RT.cache_attention(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v),
                                         jnp.asarray(q_pos)))
    got = S.cache_attention(*_t(q, k, v), torch.from_numpy(
        q_pos.astype(np.int64)))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL_SERVE,
                               rtol=TOL_SERVE)


@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_prefill_plus_decode_bitwise_equals_noncached_forward(served, hd):
    _, _, tcfg, params = served[hd]
    b, P, N, cap = 2, 7, 9, 32

    def step(tokens, start, k, v):
        with torch.no_grad():
            return TT.forward_step(params, tokens, start, k, v, tcfg)

    toks = torch.from_numpy(_tokens(hd, (b, P + N)))
    zero = torch.zeros(b, dtype=torch.long)
    ref, _, _ = step(toks, zero, _zeros(tcfg, b, cap), _zeros(tcfg, b, cap))
    k, v = _zeros(tcfg, b, cap), _zeros(tcfg, b, cap)
    logits, kn, vn = step(toks[:, :P], zero, k, v)
    assert torch.equal(logits, ref[:, :P])
    k[:, :, :P], v[:, :, :P] = kn, vn
    for t in range(N):
        blk = torch.stack([toks[:, P + t], torch.zeros(b, dtype=torch.long)],
                          dim=1)
        logits, kn, vn = step(blk, torch.full((b,), P + t), k, v)
        assert torch.equal(logits[:, 0], ref[:, P + t]), f"step {t}"
        k[:, :, P + t], v[:, :, P + t] = kn[:, :, 0], vn[:, :, 0]


@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_engine_tokens_equal_the_noncached_rollout(served, hd):
    from horovod_tpu_torch.serving import InferenceEngine
    _, _, tcfg, params = served[hd]
    engine = InferenceEngine(params, tcfg, device="cpu", max_slots=3,
                             page_size=8, capacity=32)
    prompts = [_tokens(hd + i, (n,)).tolist() for i, n in
               enumerate((3, 9, 17))]
    reqs = [engine.submit(p, max_new_tokens=6) for p in prompts]
    engine.run_until_idle()
    for p, r in zip(prompts, reqs):
        seq, want = list(p), []
        with torch.no_grad():
            for _ in range(6):
                logits = TT.serving_forward(params, torch.tensor([seq]),
                                            tcfg, 32)
                want.append(int(np.argmax(logits[0, -1].numpy())))
                seq.append(want[-1])
        assert r.result(0) == want


# ---------------------------------------------------------------------------
# On the card: the kernels against their plain versions
# ---------------------------------------------------------------------------

@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only on "
                    "the GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("q_len,kv_len,causal,offset", [
    (1000, 1000, True, 0),     # ragged across 128-row tiles
    (384, 384, True, 0),       # whole tiles
    (300, 1000, False, 0),     # q and kv ragged, non-causal
    (256, 1024, True, 700),    # the diagonal crosses two key tiles
    (130, 260, True, -100),    # rows with no visible key
    (64, 300, False, 0),       # dQ: warpgroup 1 all padding
])
def test_flash_kernels_match_plain_version_on_gpu(cuda_device, d, dtype,
                                                  q_len, kv_len, causal,
                                                  offset):
    """bf16 runs the Hopper forms at a partial second panel, f32 the
    first form; tests/test_torch_flash_kernels.py's check."""
    _check_against_plain(cuda_device, dtype, q_len=q_len, kv_len=kv_len,
                         d=d, causal=causal, offset=offset)


@pytest.mark.cuda
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_launches_are_counted_by_form_and_width_on_gpu(cuda_device, d):
    tfa.reset_launches()
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.randn(2, 64, d, device=cuda_device).to(dtype)
        tfa.flash_fwd(q, q, q, d ** -0.5, True, 0)
    torch.cuda.synchronize(cuda_device)
    assert tfa.launches_by_form == {("flash_fwd", "sm90", d): 1,
                                    ("flash_fwd", "first", d): 1}
    assert tfa.launches["flash_fwd"] == 2
    tfa.reset_launches()
    assert tfa.launches_by_form == {}


@pytest.mark.cuda
def test_other_widths_raise_on_gpu(cuda_device):
    q = torch.zeros(2, 64, 48, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=r"\(16, 32, 64, 80, 96, 128\)"):
        tfa.flash_fwd(q, q, q, 0.1, True, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_cache_attention_forms_match_plain_version_on_gpu(cuda_device, hd):
    """tests/test_torch_serving_kernels.py's check at a partial second
    panel: q a view of a fused product, K and V views one row longer with
    NaN past every row's position, rows independent of s and b."""
    _attention_forms_against_the_plain_version(cuda_device, hd)
