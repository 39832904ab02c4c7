"""horovod_tpu_torch's msgpack codec (utils/serialization.py) against
flax.serialization, the reference's.

Byte identity: ``flax.serialization.to_bytes(tree)`` equals the port's
``to_bytes`` of the same tree, built in the same insertion order, with
numpy leaves on flax's side and tensors on the port's (bfloat16 through
``ml_dtypes`` there, ``torch.bfloat16`` here).  Each package decodes the
other's bytes bitwise; chunking is held with ``MAX_CHUNK_SIZE``
monkeypatched small on both sides; missing keys and wrong structures
raise naming the path.  Seeded numpy cases, plus hypothesis trees.
"""

import flax.serialization as fs
import ml_dtypes
import numpy as np
import pytest
import torch

from horovod_tpu_torch.utils import serialization as S

DTYPES = ["float64", "float32", "float16", "bfloat16", "int8", "int16",
          "int32", "int64", "uint8", "uint16", "uint32", "uint64", "bool"]

INTS = [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
        2 ** 63 - 1, 2 ** 63, 2 ** 64 - 1, -1, -32, -33, -128, -129,
        -32768, -32769, -2 ** 31, -2 ** 31 - 1, -2 ** 63]


def _np_array(rng, dtype, shape):
    if dtype == "bool":
        return rng.random(shape) < 0.5
    if dtype.startswith(("int", "uint")):
        info = np.iinfo(dtype)
        return rng.integers(info.min, info.max, size=shape, dtype=dtype,
                            endpoint=True)
    x = rng.standard_normal(shape) * 100
    return x.astype(ml_dtypes.bfloat16 if dtype == "bfloat16" else dtype)


def _to_tensor(a: np.ndarray) -> torch.Tensor:
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(a.copy())


def _port_tree(tree):
    """The same tree with every numpy array leaf a tensor (numpy scalars
    stay numpy: a tensor has no scalar form)."""
    if isinstance(tree, dict):
        return {k: _port_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_port_tree(v) for v in tree)
    if isinstance(tree, np.ndarray):
        return _to_tensor(tree)
    return tree


def _raw(x) -> bytes:
    """An array leaf's dtype name, shape and bytes, either package's."""
    if isinstance(x, torch.Tensor):
        return (S.DTYPE_NAMES[x.dtype], tuple(x.shape),
                x.contiguous().reshape(-1).view(torch.uint8).numpy()
                .tobytes())
    x = np.asarray(x)
    return x.dtype.name, x.shape, np.ascontiguousarray(x).tobytes()


def _assert_same(got, want, path="."):
    """Decoded trees equal bitwise: arrays by dtype, shape and bytes."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            _assert_same(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{path}/{i}")
    elif isinstance(want, (np.ndarray, np.generic, torch.Tensor)):
        assert _raw(got) == _raw(want), path
    else:
        assert type(got) is type(want) and got == want, path


def _cases():
    rng = np.random.default_rng(20261017)
    cases = {
        "nested": {"b": {"y": [1, 2, (3, [4, 5])], "x": (6.5,)},
                   "a": [{"k": None}, []], "c": ()},
        "none_and_bools": {"n": None, "t": True, "f": False,
                           "l": [None, True, False]},
        "ints": {"ints": list(INTS)},
        "floats": {"f": [0.0, -0.0, 1.5, -2.25e300, 1e-310,
                         float("inf"), float("-inf")]},
        "strings": {"s0": "", "s31": "x" * 31, "s32": "y" * 32,
                    "s255": "z" * 255, "s256": "w" * 256,
                    "s65536": "v" * 65536, "utf8": "épée ∑ 🐍"},
        "bytes": {"b0": b"", "b1": b"\x01", "b255": bytes(range(255)),
                  "b256": bytes(256), "b65536": bytes(65536)},
        "numpy_scalars": {
            "f32": np.float32(2.5), "f64": np.float64(-1.0),
            "f16": np.float16(0.5), "bf16": ml_dtypes.bfloat16(1.5),
            "i8": np.int8(-3), "u64": np.uint64(2 ** 64 - 1),
            "b": np.bool_(True), "i64": np.int64(-2 ** 40)},
        "zero_d_and_empty": {
            "z32": np.zeros((), np.int32), "zbf": np.asarray(
                3.0, ml_dtypes.bfloat16),
            "e": np.zeros((0, 3), np.float16), "e1": np.zeros((0,), bool),
            "e3": np.zeros((2, 0, 4), np.int64)},
        "complex": {"c": complex(1.5, -2.0), "l": [complex(0, 1)]},
        "wide_containers": {
            "map16": {f"k{i}": i for i in range(20)},
            "list16": list(range(40)),
            "map65536": {str(i): i % 7 for i in range(65536)}},
        "ext_sizes": {   # fixext 16 (an f32 scalar), ext 8 / 16 / 32
            "fixext16": np.float32(7.0),
            "ext8": np.arange(3, dtype=np.uint8),
            "ext16": np.arange(1000, dtype=np.int32),
            "ext32": np.arange(20000, dtype=np.float32)},
        "fortran_order": {"a": np.asfortranarray(
            rng.standard_normal((5, 7)))},
    }
    for dtype in DTYPES:
        cases[f"dtype_{dtype}"] = {
            "m": _np_array(rng, dtype, (3, 17)),
            "v": _np_array(rng, dtype, (64,)),
            "s": _np_array(rng, dtype, ())}
    cases["transformer_like"] = {
        "embed": rng.standard_normal((128, 64)).astype(ml_dtypes.bfloat16),
        "layers": {"wq": rng.standard_normal((2, 64, 64)).astype("float32"),
                   "ln1": {"scale": np.ones((2, 64), "float32"),
                           "bias": np.zeros((2, 64), "float32")}},
        "step": 3, "lr": 3e-4, "name": "gpt2"}
    return cases


CASES = _cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_bytes_equal_flax_with_tensor_leaves(name):
    tree = CASES[name]
    assert S.to_bytes(_port_tree(tree)) == fs.to_bytes(tree)


@pytest.mark.parametrize("name", sorted(CASES))
def test_bytes_equal_flax_with_numpy_leaves(name):
    tree = CASES[name]
    assert S.to_bytes(tree) == fs.to_bytes(tree)


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_decodes_flax_bytes_bitwise(name):
    blob = fs.to_bytes(CASES[name])
    _assert_same(S.msgpack_restore(blob), fs.msgpack_restore(blob))


@pytest.mark.parametrize("name", sorted(CASES))
def test_flax_decodes_port_bytes_bitwise(name):
    blob = S.to_bytes(_port_tree(CASES[name]))
    _assert_same(fs.msgpack_restore(blob), S.msgpack_restore(blob))


def test_msgpack_serialize_equals_flax():
    """The low-level call: lists stay msgpack arrays, dict keys are
    sorted unless in place (flax copies the tree with tree_map)."""
    tree = {"l": [1, [2.5, None], np.arange(3, dtype="int16")],
            "d": {"x": np.float32(1.0), "a": 2}}
    for in_place in (False, True):
        assert S.msgpack_serialize(_port_tree(tree), in_place) == \
            fs.msgpack_serialize(tree, in_place)
    _assert_same(S.msgpack_restore(fs.msgpack_serialize(tree)),
                 fs.msgpack_restore(fs.msgpack_serialize(tree)))


def test_decoded_types():
    """Arrays come back as CPU tensors (bfloat16 as torch.bfloat16),
    numpy scalars as numpy scalars (bfloat16 as a 0-d tensor)."""
    blob = fs.to_bytes(CASES["dtype_bfloat16"] | CASES["numpy_scalars"])
    out = S.msgpack_restore(blob)
    assert isinstance(out["m"], torch.Tensor)
    assert out["m"].dtype == torch.bfloat16 and out["m"].shape == (3, 17)
    assert isinstance(out["f32"], np.float32) and out["f32"] == 2.5
    assert isinstance(out["bf16"], torch.Tensor)
    assert out["bf16"].dtype == torch.bfloat16 and float(out["bf16"]) == 1.5
    assert isinstance(out["u64"], np.uint64)


@pytest.mark.parametrize("limit", [64, 1000])
def test_chunked_leaves_equal_flax(monkeypatch, limit):
    """Arrays over MAX_CHUNK_SIZE bytes are chunked alike on both sides
    (the limit monkeypatched small on each) and read back whole."""
    monkeypatch.setattr(fs, "MAX_CHUNK_SIZE", limit)
    monkeypatch.setattr(S, "MAX_CHUNK_SIZE", limit)
    rng = np.random.default_rng(limit)
    tree = {"big": rng.standard_normal((33, 17)).astype("float32"),
            "nested": {"bf": rng.standard_normal((40, 9)).astype(
                ml_dtypes.bfloat16), "small": np.arange(3, dtype="int8")},
            "odd": rng.integers(0, 9, size=(7, 13, 3), dtype="int64")}
    blob = fs.to_bytes(tree)
    assert b"__msgpack_chunked_array__" in blob
    assert S.to_bytes(_port_tree(tree)) == blob
    got = S.msgpack_restore(blob)
    assert _raw(got["big"]) == _raw(tree["big"])
    assert _raw(got["nested"]["bf"]) == _raw(tree["nested"]["bf"])
    assert _raw(got["odd"]) == _raw(tree["odd"])
    back = fs.msgpack_restore(S.to_bytes(_port_tree(tree)))
    assert _raw(back["odd"]) == _raw(tree["odd"])


def test_large_arrays_are_written_from_their_memory():
    """No whole-file copy: a large tensor's bytes are a piece of their
    own, a memoryview of the tensor's memory."""
    t = torch.arange(1 << 18, dtype=torch.float32)
    pieces = S.to_pieces({"t": t, "n": 1})
    views = [p for p in pieces if isinstance(p, memoryview)]
    assert len(views) == 1 and len(views[0]) == t.numel() * 4
    assert np.shares_memory(np.asarray(views[0]), t.numpy())
    assert b"".join(pieces) == fs.to_bytes({"t": t.numpy(), "n": 1})


def test_from_bytes_restores_by_target():
    tree = {"a": np.arange(4.0), "b": [np.ones(2, "float32"), 3],
            "c": (1, 2)}
    out = S.from_bytes({"a": 0, "b": [0, 0], "c": (0, 0)},
                       fs.to_bytes(tree))
    assert torch.equal(out["a"], torch.arange(4.0, dtype=torch.float64))
    assert isinstance(out["b"], list) and out["b"][1] == 3
    assert out["c"] == (1, 2)


@pytest.mark.parametrize("target,message", [
    ({"a": 0, "zz": 0}, r"keys \{'zz'\}.*at path \."),
    ({"a": 0, "b": {"x": 0, "q": 0}}, r"keys \{'q'\}.*at path \./b"),
    ({"a": 0, "b": {"x": 0, "y": [0]}}, r"do not match, got 1 and 2 at "
                                        r"path \./b/y"),
    ({"a": {"deep": 0}}, r"dict at path \./a"),
    ({"a": 0, "b": {"x": 0, "y": [0, {"z": 0}]}}, r"path \./b/y/1"),
])
def test_missing_keys_and_wrong_structures_raise_naming_the_path(
        target, message):
    blob = fs.to_bytes({"a": 1, "b": {"x": 2, "y": [3, 4]}})
    with pytest.raises(ValueError, match=message):
        S.from_bytes(target, blob)


def test_keys_that_stringify_alike_raise():
    with pytest.raises(ValueError, match="unique string"):
        S.to_bytes({1: 0, "1": 0})
    with pytest.raises(ValueError, match="unique string"):
        fs.to_bytes({1: 0, "1": 0})


def test_unsupported_leaves_and_truncated_data_raise():
    with pytest.raises(TypeError, match="can not serialize"):
        S.to_bytes({"s": {1, 2}})
    with pytest.raises(ValueError, match="ext code 5"):
        S.msgpack_restore(b"\xd4\x05\x00")
    with pytest.raises(ValueError, match="'float128'"):
        S.msgpack_restore(b"\xc7\x0d\x01\x93\x90\xa8float128\xc4\x00")
    blob = S.to_bytes({"a": np.arange(10)})
    with pytest.raises(ValueError):
        S.msgpack_restore(blob[:-3])
    with pytest.raises(ValueError, match="after the msgpack"):
        S.msgpack_restore(blob + b"\x00")


try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
    from hypothesis.extra import numpy as hnp
except ImportError:  # pragma: no cover - hypothesis is optional
    given = None


if given is not None:
    _ARRAY_DTYPES = st.sampled_from(
        [d for d in DTYPES if d != "bfloat16"])
    _leaves = st.one_of(
        st.none(), st.booleans(),
        st.integers(min_value=-2 ** 63, max_value=2 ** 64 - 1),
        st.floats(allow_nan=False), st.text(max_size=40),
        st.binary(max_size=300),
        _ARRAY_DTYPES.flatmap(lambda d: hnp.arrays(
            np.dtype(d), hnp.array_shapes(min_dims=0, max_dims=3,
                                          min_side=0, max_side=5))),
    )
    _trees = st.recursive(
        _leaves, lambda children: st.one_of(
            st.lists(children, max_size=5),
            st.dictionaries(st.text(max_size=8), children, max_size=5)),
        max_leaves=20)

    @settings(max_examples=150, deadline=None, derandomize=True,
              database=None)
    @given(tree=_trees)
    def test_hypothesis_trees_equal_flax_and_round_trip(tree):
        blob = fs.to_bytes(tree)
        assert S.to_bytes(_port_tree(tree)) == blob
        assert S.to_bytes(tree) == blob
        _assert_same(S.msgpack_restore(blob), fs.msgpack_restore(blob))
