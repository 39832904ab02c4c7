"""horovod_tpu_torch's wire compression (ops/prng.py, ops/compression.py,
ops/quant.py's plain path, ops/megakernel.py's plans, core/topology.py)
against horovod_tpu's, in one process.

Bitwise, on seeded inputs: the threefry dither bits against
``jax.random.bits``; ``_pow2_scale``, ``quantize_blocks``,
``dequantize_blocks``, ``pack_int4`` and the wire frame for int8/int4 x
stochastic/nearest x f32/bf16/f16; ``reference_allreduce`` at n = 1, 3, 4
with and without residuals and error feedback; the standalone codec.
Equal: the registry, policy and env checks of tests/test_compression.py
:255-430, ``wire_accounting`` and the hierarchy plans on the same specs,
and ``ReplicaHierarchy`` from host lists and virtual slices.

One limit of the comparison, shown by a test: XLA's CPU runtime treats
subnormal floats as zero, PyTorch does not, so on subnormal inputs the
two codecs differ (ROADMAP.md C.3).
"""

import itertools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from horovod_tpu.core import topology as J_topo
from horovod_tpu.ops import compression as J
from horovod_tpu.ops import megakernel as J_mk
from horovod_tpu_torch.core import topology as P_topo
from horovod_tpu_torch.ops import compression as P
from horovod_tpu_torch.ops import megakernel as P_mk
from horovod_tpu_torch.ops import prng
from horovod_tpu_torch.ops import quant as P_quant
from horovod_tpu_torch.ops import transport as P_tp

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float16": (jnp.float16, torch.float16)}


def _to_torch(a):
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _bits(t):
    """A tensor's or array's bytes, for bitwise comparison."""
    if isinstance(t, torch.Tensor):
        t = t.detach()
        return (t.view(torch.int16) if t.dtype == torch.bfloat16
                else t).numpy().tobytes()
    a = np.asarray(t)
    return (a.view(np.int16) if a.dtype == ml_dtypes.bfloat16
            else a).tobytes()


def _same(port, ref):
    assert tuple(port.shape) == tuple(np.shape(ref))
    assert _bits(port) == _bits(ref)


def _formats(bits, stochastic, ef=True, block=256):
    kw = dict(kind="quant", name=f"int{bits}", bits=bits, block=block,
              stochastic=stochastic, error_feedback=ef)
    return J.WireFormat(**kw), P.WireFormat(**kw)


def _rows(seed, shape, dtype):
    """Seeded rows whose blocks span many magnitudes, with an all-zero
    block and a block with one huge value."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape)
         * np.exp(rng.standard_normal(shape[:-1] + (1,)) * 3))
    x = x.astype(np.float32)
    x[..., :256] = 0.0
    x[..., 300] = 3e4
    xj = jnp.asarray(x).astype(DTYPES[dtype][0])
    return xj, _to_torch(xj)


# ---------------------------------------------------------------------------
# The noise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,tick,n", [
    (0, 0, 1), (0, 1, 7), (1234, 5, 1000), (2 ** 31 - 1, 2 ** 31 + 3, 33),
    (2 ** 32 - 1, 9, 4097), (-5, 0, 18)])
def test_bits_u8_equal_jax_random_bits(seed, tick, n):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), tick)
    pkey = P.step_key(seed, tick)
    assert pkey == tuple(int(v) for v in np.asarray(key))
    assert prng.prng_key(seed) == tuple(
        int(v) for v in np.asarray(jax.random.PRNGKey(seed)))
    want = np.asarray(jax.random.bits(key, (n,), jnp.uint8))
    np.testing.assert_array_equal(prng.bits_u8(pkey, n).numpy(), want)
    # The noise key of a leg and a participant (compression.py:583), and
    # the flat index over a 2-D shape.
    jk, pk = J._noise_key(key, 2, 3), P._noise_key(pkey, 2, 3)
    assert pk == tuple(int(v) for v in np.asarray(jk))
    want2 = np.asarray(jax.random.bits(jk, (3, n), jnp.uint8)).reshape(-1)
    np.testing.assert_array_equal(prng.bits_u8(pk, 3 * n).numpy(), want2)


def test_prng_key_refuses_seeds_wider_than_32_bits():
    with pytest.raises(ValueError, match="32 bits"):
        prng.prng_key(2 ** 32)


# ---------------------------------------------------------------------------
# The block codec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [8, 4])
def test_pow2_scale_bitwise(bits):
    rng = np.random.default_rng(bits)
    amax = np.abs(rng.standard_normal(4000) * np.exp(
        rng.standard_normal(4000) * 20)).astype(np.float32)
    amax[:6] = [0.0, 1.0, 127.0, 7.0, 3.4e38, 1.2e-38]
    # Mantissas at and beside the int8/int4 thresholds.
    for i, m in enumerate((0.984375, 0.75)):
        base = np.float32(1.0 + m)
        amax[6 + 3 * i:9 + 3 * i] = [np.nextafter(base, np.float32(0)),
                                     base, np.nextafter(base, np.inf)]
    got = P._pow2_scale(torch.from_numpy(amax), bits)
    want = J._pow2_scale(jnp.asarray(amax), bits)
    _same(got, want)


@pytest.mark.parametrize("bits,stochastic,dtype", list(itertools.product(
    [8, 4], [True, False], ["float32", "bfloat16", "float16"])))
def test_block_codec_bitwise(bits, stochastic, dtype):
    jf, pf = _formats(bits, stochastic)
    xj, xp = _rows(bits + 10 * stochastic, (3, 1024), dtype)
    key = J.step_key(5, 7)
    qj, sj = J.quantize_blocks(xj, jf, key)
    qp, sp = P.quantize_blocks(xp, pf, P.step_key(5, 7))
    _same(qp, qj)
    _same(sp, sj)
    _same(P.dequantize_blocks(qp, sp, pf), J.dequantize_blocks(qj, sj, jf))
    wj, wp = J.wire_pack(qj, sj, jf), P.wire_pack(qp, sp, pf)
    _same(wp, wj)
    assert wp.shape[-1] == P.wire_bytes_per_chunk(1024, pf) \
        == J.wire_bytes_per_chunk(1024, jf)
    q2, s2 = P.wire_unpack(wp, 1024, pf)
    _same(q2, qj)
    _same(s2, sj)
    # The kernel wrappers' plain path (a CPU tensor) is the same codec,
    # and the residual is rows - dequant in rows' dtype.
    res = torch.empty_like(xp)
    _same(P_quant.quant_pack(xp, pf, P.step_key(5, 7), res), wj)
    _same(res, xj - J.dequantize_blocks(qj, sj, jf).astype(xj.dtype))
    deq = J.dequantize_blocks(qj, sj, jf)
    _same(P_quant.unpack_dequantize(wp, 1024, pf, sum_rows=False), deq)
    _same(P_quant.unpack_dequantize(wp, 1024, pf, sum_rows=True),
          J.ordered_sum(deq))


def _nonfinite_rows(seed):
    """[2, 1280] f32: a NaN block, a +inf block, a -inf block and a block
    with a NaN and a +inf, after a block of standard normals."""
    x = np.random.default_rng(seed).standard_normal((2, 1280))
    x[:, 256 + 5] = np.nan
    x[:, 512 + 7] = np.inf
    x[:, 768 + 9] = -np.inf
    x[:, 1024 + 1] = np.nan
    x[:, 1024 + 2] = np.inf
    return x.astype(np.float32)


@pytest.mark.parametrize("bits,stochastic,dtype", list(itertools.product(
    [8, 4], [True, False], ["float32", "bfloat16"])))
def test_nonfinite_blocks_bitwise(bits, stochastic, dtype):
    """A NaN block (amax NaN: scale 0, the NaN's code 0), a +inf and a
    -inf block (scale 2^122 or 2^126, the inf clipped to +-levels) and a
    block holding a NaN and a +inf: the port's codec equals the
    reference's bitwise.
    The finite values are at least 1 in magnitude, so that their quotients
    by 2^126 stay normal: XLA's CPU runtime flushes a subnormal quotient
    to zero and PyTorch does not (the next test; ROADMAP.md C.3)."""
    jf, pf = _formats(bits, stochastic)
    x = _nonfinite_rows(20 + bits + 10 * stochastic)
    x = np.sign(x) * (1.0 + np.abs(x))
    x[:, :256] = 0.0
    xj = jnp.asarray(x.astype(np.float32)).astype(DTYPES[dtype][0])
    xp = _to_torch(xj)
    qj, sj = J.quantize_blocks(xj, jf, J.step_key(5, 7))
    qp, sp = P.quantize_blocks(xp, pf, P.step_key(5, 7))
    _same(qp, qj)
    _same(sp, sj)
    scales = sp.float().numpy()
    assert (scales[:, [0, 1, 4]] == 0).all()
    # inf's exponent 128, less 6 (int8) or 2 (int4).
    assert (scales[:, [2, 3]] == 2.0 ** (122 if bits == 8 else 126)).all()
    codes = (P.unpack_int4(qp) if bits == 4 else qp).numpy()
    lv = (1 << (bits - 1)) - 1
    assert (codes[:, [261, 1025]] == 0).all()
    assert (codes[:, 519] == lv).all() and (codes[:, 777] == -lv).all()
    _same(P.dequantize_blocks(qp, sp, pf), J.dequantize_blocks(qj, sj, jf))
    wj = J.wire_pack(qj, sj, jf)
    _same(P.wire_pack(qp, sp, pf), wj)
    _same(P_quant.quant_pack(xp, pf, P.step_key(5, 7)), wj)


def test_subnormal_quotients_are_a_limit_of_the_comparison():
    """In an inf block (int4 scale 2^126) a finite |x| < 1 has a subnormal
    quotient.  XLA's CPU runtime flushes it to zero and PyTorch keeps it,
    so with a zero dither a negative one floors to -1 in the port and to
    0 in the reference; every code where the quotient is normal agrees."""
    jf, pf = _formats(4, True)
    x = _nonfinite_rows(24)
    qj, _ = J.quantize_blocks(jnp.asarray(x), jf, J.step_key(5, 7))
    qp, _ = P.quantize_blocks(torch.from_numpy(x), pf, P.step_key(5, 7))
    cj = np.asarray(J.unpack_int4(qj))
    cp = P.unpack_int4(qp).numpy()
    differ = cj != cp
    assert differ.any()
    quotient = np.abs(x[:, 512:1024]) * np.float32(2.0 ** -126)
    subnormal = np.zeros_like(differ)
    subnormal[:, 512:1024] = (quotient > 0) & (quotient < 2.0 ** -126)
    assert not (differ & ~subnormal).any()
    assert ((cp - cj)[differ] == -1).all()


def test_pack_int4_bitwise():
    q = np.random.default_rng(1).integers(-7, 8, size=(3, 64)).astype(np.int8)
    packed = P.pack_int4(torch.from_numpy(q))
    _same(packed, J.pack_int4(jnp.asarray(q)))
    np.testing.assert_array_equal(P.unpack_int4(packed).numpy(), q)


def test_denormal_inputs_are_a_limit_of_the_comparison():
    """XLA's CPU runtime flushes subnormal inputs to zero; PyTorch keeps
    them.  On a block of subnormals the codes differ, and the port on
    the input with its subnormals zeroed gives the reference's codes."""
    jf, pf = _formats(8, True)
    x = (np.float32(1e-39) * np.arange(256, dtype=np.float32))[None]
    x[0, 0] = np.float32(2e-38)
    qj, sj = J.quantize_blocks(jnp.asarray(x), jf, J.step_key(0, 0))
    qp, sp = P.quantize_blocks(torch.from_numpy(x), pf, P.step_key(0, 0))
    _same(sp, sj)
    assert _bits(qp) != _bits(qj)
    flushed = np.where(np.abs(x) < np.finfo(np.float32).tiny, 0.0, x)
    qf, _ = P.quantize_blocks(torch.from_numpy(flushed.astype(np.float32)),
                              pf, P.step_key(0, 0))
    _same(qf, qj)


@pytest.mark.parametrize("n,ef,residual", [
    (1, True, False), (1, False, False), (3, True, False), (3, True, True),
    (3, False, False), (4, True, True), (4, False, True),
    (4, True, False)])
@pytest.mark.parametrize("bits,dtype", [(8, "float32"), (4, "bfloat16")])
def test_reference_allreduce_bitwise(n, ef, residual, bits, dtype):
    jf, pf = _formats(bits, True, ef, block=16)
    rng = np.random.default_rng(n)
    rows = rng.standard_normal((n, 75)).astype(np.float32)
    rj = jnp.asarray(rows).astype(DTYPES[dtype][0])
    res_j = res_p = None
    if residual:
        res_j = jnp.asarray((rng.standard_normal((n, 75)) * 0.01)
                            .astype(np.float32)).astype(rj.dtype)
        res_p = _to_torch(res_j)
    oj, nj = J.reference_allreduce(rj, jf, 3, seed=11, residuals=res_j)
    op, np_ = P.reference_allreduce(_to_torch(rj), pf, 3, seed=11,
                                    residuals=res_p)
    _same(op, oj)
    if ef:
        _same(np_, nj)
    else:
        assert np_ is None and nj is None


@pytest.mark.parametrize("codec", ["int8", "int4"])
def test_standalone_codec_roundtrip(codec):
    t = np.random.default_rng(0).standard_normal((5, 37)).astype(np.float32)
    cls = P.resolve(codec)
    wire, ctx = cls.quantize(torch.from_numpy(t))
    back = cls.dequantize(wire, ctx)
    assert back.shape == t.shape and back.dtype == torch.float32
    step = 2.0 * np.abs(t).max() / P._levels(cls.bits)
    assert np.abs(back.numpy() - t).max() <= step
    jwire, jctx = J.resolve(codec).quantize(jnp.asarray(t))
    _same(wire[0], jwire[0])
    _same(back, J.resolve(codec).dequantize(jwire, jctx))
    key = P.step_key(1, 2)
    wire_s, ctx_s = cls.quantize(torch.from_numpy(t), key=key)
    jwire_s, _ = J.resolve(codec).quantize(jnp.asarray(t),
                                           key=J.step_key(1, 2))
    _same(wire_s[0], jwire_s[0])


# ---------------------------------------------------------------------------
# Registry, policy, env (tests/test_compression.py:255-430)
# ---------------------------------------------------------------------------

def test_resolve_error_names_every_compressor():
    with pytest.raises(ValueError) as ei:
        P.resolve("int7")
    with pytest.raises(ValueError) as ej:
        J.resolve("int7")
    assert str(ei.value) == str(ej.value)
    for name in ("none", "fp16", "bf16", "int8", "int4"):
        assert name in str(ei.value)
    assert set(P.valid_names()) == set(J.valid_names())


def test_quant_compressor_rejects_wrap_api():
    for bits in (8, 4):
        with pytest.raises(ValueError) as ei:
            P.resolve(f"int{bits}").compress(torch.ones(4))
        with pytest.raises(ValueError) as ej:
            J.resolve(f"int{bits}").compress(jnp.ones(4))
        assert str(ei.value) == str(ej.value)
        assert "set_compression" in str(ei.value)


@pytest.mark.parametrize("name,dtype,numel", [
    ("int8", np.float32, 1024), ("int8", np.int32, 1024),
    ("int8", np.float32, 4), ("int4", "bfloat16", 1024),
    ("bf16", np.float32, 8), ("bf16", "bfloat16", 1024),
    ("fp16", np.float32, 8), ("none", np.float32, 1024),
    ("int8", np.float16, 16)])
def test_wire_format_applicability(name, dtype, numel):
    jdt = jnp.bfloat16 if dtype == "bfloat16" else dtype
    got = P.wire_format_for(name, dtype, numel)
    want = J.wire_format_for(name, jdt, numel)
    assert (got is None) == (want is None)
    if want is not None:
        assert got.__dict__ == want.__dict__


def test_policy_precedence_and_process_sets(monkeypatch):
    monkeypatch.setenv(P.DEFAULT_ENV, "bf16")
    try:
        assert P.policy_name_for("anything", 0) == "bf16"
        rules = [(r"embedding", "int4"), (r"\bln\b|bias", "none")]
        pol = P.CompressionPolicy(default="int8", rules=rules,
                                  process_sets={3: "none"})
        ref = J.CompressionPolicy(default="int8", rules=rules,
                                  process_sets={3: "none"})
        for name in ("model.embedding.w", "model.ln.scale", "dense.kernel",
                     "x.bias"):
            for psid in (0, 3):
                assert pol.name_for(name, psid) == ref.name_for(name, psid)
        assert pol.name_for("model.embedding.w", 3) == "int4"
        assert pol.name_for("dense.kernel", 3) == "none"
        with pytest.raises(ValueError, match="int8"):
            P.CompressionPolicy(default="int9")
        with pytest.raises(ValueError):
            P.CompressionPolicy(rules=[("x", "bogus")])
        P.set_compression(default="int8", rules=rules)
        assert P.policy_format_for("dense.kernel", 0, torch.float32, 4096) \
            .__dict__ == J.wire_format("int8").__dict__
        assert P.policy_format_for("a.bias", 0, torch.float32, 4096) is None
    finally:
        P.set_compression()
    assert P.get_compression() is None


def test_set_compression_and_threshold_flush_the_executor_state():
    from horovod_tpu_torch.ops.coordinator import Coordinator

    P_mk.store_residuals([("g", 0, "w")], [torch.ones(3)])
    P_mk.next_tick(("mp", 0, "int8", "w"))
    flushes = P_mk.stats.flushes
    P.set_compression(default="int8")
    try:
        assert P_mk.stats.flushes == flushes + 1
        assert P_mk.residual_count() == 0
        assert P_mk.next_tick(("mp", 0, "int8", "w")) == 0
        assert P.policy_name_for("w", 0) == "int8"
        P_mk.store_residuals([("g", 0, "w")], [torch.ones(3)])
        Coordinator(1, 64 << 20).set_fusion_threshold(16 << 20)
        assert P_mk.residual_count() == 0
    finally:
        P.set_compression()


def test_validate_env_messages(monkeypatch):
    def both(match):
        for mod in (P, J):
            with pytest.raises(ValueError, match=match) as ei:
                mod.validate_env()
        return str(ei.value)

    monkeypatch.setenv("HVD_TPU_COMPRESSION", "int9")
    both("HVD_TPU_COMPRESSION")
    monkeypatch.setenv("HVD_TPU_COMPRESSION", "int8")
    monkeypatch.setenv("HVD_TPU_QUANT_ROUNDING", "sometimes")
    both("ROUNDING")
    monkeypatch.setenv("HVD_TPU_QUANT_ROUNDING", "nearest")
    monkeypatch.setenv("HVD_TPU_QUANT_BLOCK", "33")
    both("even block")
    monkeypatch.setenv("HVD_TPU_QUANT_BLOCK", "128")
    monkeypatch.setenv("HVD_TPU_QUANT_SEED", "x")
    both("expected an integer")
    monkeypatch.delenv("HVD_TPU_QUANT_SEED")
    monkeypatch.setenv("HVD_TPU_DCN_COMPRESS", "gzip")
    both("HVD_TPU_DCN_COMPRESS")
    monkeypatch.setenv("HVD_TPU_DCN_COMPRESS", "int4")
    P.validate_env()
    monkeypatch.setenv("HVD_TPU_HIERARCHICAL", "sometimes")
    for mod in (P_topo, J_topo):
        with pytest.raises(ValueError, match="expected auto, on or off"):
            mod.validate_env()
    monkeypatch.setenv("HVD_TPU_HIERARCHICAL", "on")
    monkeypatch.setenv("HVD_TPU_VIRTUAL_SLICES", "two")
    for mod in (P_topo, J_topo):
        with pytest.raises(ValueError, match="expected an integer"):
            mod.validate_env()


def test_validate_env_runs_at_init(monkeypatch):
    import horovod_tpu_torch as thvd

    monkeypatch.setenv("HVD_TPU_COMPRESSION", "int9")
    with pytest.raises(ValueError, match="expected one of"):
        thvd.init(device="cpu")
    assert not thvd.is_initialized()


def test_env_fingerprint_and_its_warning(monkeypatch, capsys):
    fp0 = P.env_fingerprint()
    assert "HVD_TPU_COMPRESSION=<unset>" in fp0
    monkeypatch.setenv("HVD_TPU_COMPRESSION", "int8")
    monkeypatch.setenv("HVD_TPU_VIRTUAL_SLICES", "2")
    fp1 = P.env_fingerprint()
    assert fp1 != fp0
    assert "HVD_TPU_COMPRESSION=int8" in fp1
    assert "HVD_TPU_VIRTUAL_SLICES=2" in fp1
    # Every knob the port reads is one of the reference's.
    port_knobs = [kv.split("=")[0] for kv in fp1.split(";")]
    ref_knobs = [kv.split("=")[0] for kv in J.env_fingerprint().split(";")]
    assert set(port_knobs) <= set(ref_knobs)
    P_tp.check_env_fingerprint(3, P.env_fingerprint())
    assert "WARNING" not in capsys.readouterr().err
    theirs = fp1.replace("HVD_TPU_COMPRESSION=int8",
                         "HVD_TPU_COMPRESSION=none")
    P_tp.check_env_fingerprint(3, theirs)
    err = capsys.readouterr().err
    assert "WARNING: rank 3 disagrees with rank 0" in err
    assert "HVD_TPU_COMPRESSION: rank0=int8 rank3=none" in err


# ---------------------------------------------------------------------------
# Topology and plans
# ---------------------------------------------------------------------------

class _FakeDev:
    def __init__(self, slice_index):
        self.slice_index = slice_index


@pytest.mark.parametrize("hosts,mode,virtual", [
    (["a", "a", "b", "b"], "auto", ""),
    (["a", "b", "a", "b"], "auto", ""),
    (["a", "a", "b", "b", "c", "c"], "on", ""),
    (["a", "a", "a", "b"], "auto", ""),          # ragged: flat
    (["a", "a", "b", "b"], "off", ""),
    (["a"] * 4, "auto", "2"),                     # one host, auto: flat
    (["a"] * 4, "on", "2"),
    (["a"] * 8, "on", "4"),
    (["a"] * 6, "on", "4"),                       # 6 % 4: flat
    (["a"], "on", "2")])
def test_replica_hierarchy_matches_the_reference(monkeypatch, hosts, mode,
                                                 virtual):
    monkeypatch.setenv(P_topo.HIERARCHICAL_ENV, mode)
    monkeypatch.setenv(P_topo.VIRTUAL_SLICES_ENV, virtual)
    order = list(dict.fromkeys(hosts))
    devices = [_FakeDev(order.index(h) if len(order) > 1 else None)
               for h in hosts]
    got = P_topo.replica_hierarchy(hosts)
    want = J_topo.replica_hierarchy(devices)
    assert (got is None) == (want is None)
    if want is not None:
        assert (got.n_slices, got.ici_size, got.ici_groups,
                got.dcn_groups) == (want.n_slices, want.ici_size,
                                    want.ici_groups, want.dcn_groups)
        assert got.slice_of_positions() == want.slice_of_positions()


def _topologies():
    kw = dict(n_slices=2, ici_size=2, ici_groups=((0, 1), (2, 3)),
              dcn_groups=((0, 2), (1, 3)))
    return J_topo.ReplicaHierarchy(**kw), P_topo.ReplicaHierarchy(**kw)


def _hier_fields(h):
    if h is None:
        return None
    return (h.wire_dtype,
            None if h.dcn_quant is None else h.dcn_quant.__dict__,
            None if h.ici_quant is None else h.ici_quant.__dict__)


@pytest.mark.parametrize("dcn,ici,group,dtype", [
    (None, None, "int8", "float32"), ("none", None, "int8", "float32"),
    ("bf16", None, None, "float32"), ("int4", "int8", None, "float32"),
    (None, "int8", "int8", "bfloat16"), ("fp16", None, "bf16", "float32"),
    (None, None, None, "float32"), ("bf16", None, None, "bfloat16")])
def test_plans_and_wire_accounting_match_the_reference(monkeypatch, dcn, ici,
                                                       group, dtype):
    """hierarchy_for (the DCN leg inheriting the group's quantized
    format unless HVD_TPU_DCN_COMPRESS is set, ``none`` included) and
    wire_accounting on the same specs, flat and hierarchical."""
    for knob, value in ((P_mk.DCN_COMPRESS_ENV, dcn),
                        (P_mk.ICI_COMPRESS_ENV, ici)):
        if value is None:
            monkeypatch.delenv(knob, raising=False)
        else:
            monkeypatch.setenv(knob, value)
    monkeypatch.setenv("HVD_TPU_HIERARCHICAL", "on")
    monkeypatch.setenv("HVD_TPU_VIRTUAL_SLICES", "2")
    jtopo, ptopo = _topologies()
    jdt = DTYPES[dtype][0]
    jfmt = J.wire_format_for(group, jdt, 1 << 20) if group else None
    pfmt = P.wire_format_for(group, dtype, 1 << 20) if group else None
    mesh = tuple(_FakeDev(None) for _ in range(4))
    want_h = J_mk.hierarchy_for(mesh, "psum", jdt, group_fmt=jfmt)
    got_h = P_mk.hierarchy_for(ptopo, "psum", dtype, group_fmt=pfmt)
    assert _hier_fields(got_h) == _hier_fields(want_h)
    assert P_mk.hierarchy_for(ptopo, "pmax", dtype, pfmt) is None
    assert P_mk.hierarchy_for(None, "psum", dtype, pfmt) is None
    shapes = ((300, 7), (5,), (1,))
    for hier in (False, True):
        jh = J_mk.Hierarchy(topo=jtopo, wire_dtype=want_h.wire_dtype,
                            dcn_quant=want_h.dcn_quant,
                            ici_quant=want_h.ici_quant) if hier else None
        ph = got_h if hier else None
        jspec = J_mk.GroupSpec(mesh_key=mesh, variant="mp", op="psum",
                               average=True, denom=4,
                               dtype=jnp.dtype(jdt).name, shapes=shapes,
                               donate=(True,), hier=jh, quant=jfmt)
        pspec = P_mk.GroupSpec(process_set_id=0, size=4, op="psum", average=True, denom=4,
                               dtype=dtype, shapes=shapes, hier=ph,
                               quant=pfmt)
        assert P_mk.wire_accounting_legs(pspec) == \
            J_mk.wire_accounting_legs(jspec)
        assert P_mk.needs_quant(pspec) == J_mk._needs_quant_build(jspec)
        assert P_mk._quant_unit(pspec) == J_mk._quant_unit(jspec)


def test_compression_state_json_keys_match_the_reference():
    """The snapshot's keys are the reference's JSON of the flat tuples;
    a bf16 residual leaves as float32 and comes back exact."""
    P_mk.flush("test")
    try:
        r = torch.tensor([1.5, -2.25, 3.0], dtype=torch.bfloat16)
        key = ("g", 0, "a", "b")
        P_mk.store_residuals([key], [r])
        P_mk.next_tick(("mp", 0, "int8", "a", "b"))
        snap = P_mk.compression_state()
        assert list(snap["residuals"]) == ['["g", 0, "a", "b"]']
        assert snap["ticks"] == {'["mp", 0, "int8", "a", "b"]': 1}
        P_mk.flush("test")
        P_mk.load_compression_state(snap)
        P_mk.drop_residuals([("g", 0, "other")])
        assert P_mk.residual_count() == 1
        back = P_mk.take_residual(key, torch.bfloat16, (3,), "cpu")
        assert torch.equal(back, r) and back.dtype == torch.bfloat16
        assert P_mk.take_residual(key, torch.bfloat16, (3,), "cpu") is None
        P_mk.load_compression_state({"residuals": {
            '["g", 0, "a", "b"]': np.asarray(
                [1.5, -2.25, 3.0], ml_dtypes.bfloat16)}})
        back = P_mk.take_residual(key, torch.bfloat16, (3,), "cpu")
        assert torch.equal(back, r)
    finally:
        P_mk.flush("test")
