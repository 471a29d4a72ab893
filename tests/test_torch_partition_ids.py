"""The port's ``device_partition_ids`` against the JAX package's, bit for
bit, on the same numpy batch handed to both engines: every fixed-width,
bool, date, float and string key, with and without nulls, seeds 42 and 9001
(the grace join's), 2, 7 and 64 partitions, several keys combined, and
hashes with the top bit set (the uint32 remainder torch has not). A
two-limb decimal key hashes bit-equal to JAX too; the nested branch raises
naming its ROADMAP step."""
import numpy as np
import pytest
import torch

from spark_rapids_tpu.shuffle import manager as jmanager

from spark_rapids_tpu_torch.columnar.device import DeviceColumn, DeviceTable
from spark_rapids_tpu_torch.shuffle import manager as tmanager

from test_torch_joins import _key_plane, _payload, _tables

_KINDS = ["int64", "int32", "date", "double", "float32", "bool", "string"]
_NAMES = {"int64": "bigint", "int32": "int", "date": "date",
          "double": "double", "float32": "float", "bool": "boolean"}


def _batch(seed: int, kind: str, nulls: bool, cap: int = 512):
    """(port table, JAX table) with key ``k`` of ``kind`` beside a double,
    an int32 and a string column; a string key is the payload's string
    column (empty strings, widths past 8 bytes)."""
    rng = np.random.default_rng(seed)
    cols = _payload(rng, cap)
    names = ["d", "i", "s"]
    if kind != "string":
        cols.append({"data": _key_plane(rng, kind, cap, 40),
                     "validity": (rng.random(cap) > 0.2) if nulls
                     else np.ones(cap, bool), "dtype": _NAMES[kind],
                     "all_valid": not nulls})
        names.append("k")
    elif not nulls:
        cols[2]["validity"] = np.ones(cap, bool)
    row_mask = rng.random(cap) < 0.9
    return _tables(names, cols, row_mask)


def _key(kind: str) -> str:
    return "s" if kind == "string" else "k"


def _jax_ids(jt, keys, parts, seed) -> np.ndarray:
    return np.asarray(jmanager.device_partition_ids(jt, keys, parts,
                                                    seed=seed))


@pytest.mark.parametrize("parts", [2, 7, 64])
@pytest.mark.parametrize("seed", [42, 9001])
@pytest.mark.parametrize("nulls", [False, True])
@pytest.mark.parametrize("kind", _KINDS)
def test_partition_ids_bit_equal_jax(kind, nulls, seed, parts):
    port, jt = _batch(seed + parts, kind, nulls)
    keys = [_key(kind)]
    got = tmanager.device_partition_ids(port, keys, parts, seed=seed)
    want = _jax_ids(jt, keys, parts, seed)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.min() >= 0 and got.max() < parts


@pytest.mark.parametrize("seed", [42, 9001])
def test_several_keys_combine_as_jax(seed):
    port, jt = _batch(seed, "double", True)
    keys = ["k", "s", "i", "d"]
    for parts in (2, 7, 64):
        np.testing.assert_array_equal(
            tmanager.device_partition_ids(port, keys, parts,
                                          seed=seed).numpy(),
            _jax_ids(jt, keys, parts, seed))


@pytest.mark.parametrize("kind", _KINDS)
def test_column_hash_bit_equal_jax(kind):
    port, jt = _batch(5, kind, True)
    got = tmanager.column_key_hash(port.column(_key(kind)))
    want = np.asarray(jmanager._column_key_hash(jt.column(_key(kind))))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_hash_with_the_top_bit_set_takes_the_uint32_remainder():
    """``h % num_parts`` on the uint32 hash: with 2**32 - 1 partitions the
    id is the hash itself, so ids with the top bit set come out negative
    in int32 in both engines; a signed remainder would differ from the
    unsigned one on each of them for 3 and 7 partitions."""
    port, jt = _batch(11, "int64", False)
    full = tmanager.device_partition_ids(port, ["k"], 2**32 - 1).numpy()
    np.testing.assert_array_equal(full, _jax_ids(jt, ["k"], 2**32 - 1, 42))
    top = full < 0
    assert top.sum() > 50
    unsigned = full.astype(np.int64) & 0xFFFFFFFF
    for parts in (3, 7):
        got = tmanager.device_partition_ids(port, ["k"], parts).numpy()
        np.testing.assert_array_equal(got, unsigned % parts)
        np.testing.assert_array_equal(got, _jax_ids(jt, ["k"], parts, 42))
        assert (got[top] != np.fmod(full[top], parts)).any()


def test_string_hash_does_not_depend_on_the_matrix_width():
    """The same strings in a matrix of width 8 and of width 64 hash
    alike (the words past each length are left out)."""
    values = [b"", b"a", b"abcdefgh", b"abcdefghi", b"zz"]
    hashes = []
    for width in (16, 64):
        mat = np.zeros((len(values), width), np.uint8)
        for i, v in enumerate(values):
            mat[i, :len(v)] = np.frombuffer(v, np.uint8)
        col = DeviceColumn(torch.from_numpy(mat),
                           torch.ones(len(values), dtype=torch.bool),
                           None, True,
                           torch.tensor([len(v) for v in values],
                                        dtype=torch.int32))
        hashes.append(tmanager.string_key_hash(col))
    assert torch.equal(hashes[0], hashes[1])


@pytest.mark.parametrize("shape,step", [((8, 2), "decimal128"),
                                        ((8, 2, 2), "breadth")])
def test_decimal_and_nested_keys_raise_naming_their_steps(shape, step):
    """A nested key still raises naming its step. A two-limb (decimal128)
    key, which raised until decimals were ported, now hashes bit-equal to
    the JAX package's fold of its limbs (``hi ^ lo * 0x9E3779B97F4A7C15``,
    the top bits of the product wrapped away) at every partition count."""
    rng = np.random.default_rng(12)
    data = rng.integers(-2**63, 2**63 - 1, shape, dtype=np.int64)
    data[0] = [-1, -1] if len(shape) == 2 else data[0]
    valid = np.ones(8, bool)
    valid[3] = False
    col = DeviceColumn(torch.from_numpy(data), torch.from_numpy(valid), None,
                       False)
    table = DeviceTable((col,), torch.ones(8, dtype=torch.bool),
                        torch.tensor(8, dtype=torch.int32), ("k",))
    if step != "decimal128":
        with pytest.raises(NotImplementedError,
                           match=rf"\(ROADMAP Queue 1: {step}\)"):
            tmanager.device_partition_ids(table, ["k"], 4)
        return
    import jax.numpy as jnp
    from spark_rapids_tpu.columnar import device as jdev
    from spark_rapids_tpu.columnar import dtypes as jdt
    jt = jdev.DeviceTable(
        (jdev.DeviceColumn(jnp.asarray(data), jnp.asarray(valid),
                           jdt.DecimalType(30, 2), None),),
        jnp.ones(8, bool), jnp.int32(8), ("k",))
    for parts in (2, 7, 64):
        for seed in (42, 9001):
            np.testing.assert_array_equal(
                tmanager.device_partition_ids(table, ["k"], parts,
                                              seed=seed).numpy(),
                _jax_ids(jt, ["k"], parts, seed))
