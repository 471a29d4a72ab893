"""The port's host native library (``spark_rapids_tpu_torch/host_native.py``
over ``csrc/host_native.cpp``) against the JAX package's
(``spark_rapids_tpu/native``), in the cases of the JAX package's
tests/test_native.py.

Tolerances: none; bytes, hashes, partition ids and orders are equal."""
import numpy as np
import pytest

from spark_rapids_tpu import native as jnative

from spark_rapids_tpu_torch import host_native as native

_PATTERNS = (b"", b"a", b"ab" * 10_000, b"abcabcabcabc" * 1000,
             bytes(range(256)) * 256, b"x" * 70_000,
             b"the quick brown fox jumps over the lazy dog; " * 4096)


def _random_inputs():
    rng = np.random.default_rng(1)
    return [rng.bytes(n) for n in (0, 1, 5, 12, 13, 64, 1000, 65_536,
                                   1 << 20)]


@pytest.mark.parametrize("kind", ["patterns", "random"])
def test_lz4_bytes_equal_the_jax_codec_and_cross_decompress(kind):
    """Each package decompresses the other's blocks, and the port's block is
    the JAX package's byte for byte."""
    for data in (_PATTERNS if kind == "patterns" else _random_inputs()):
        comp = native.lz4_compress(data)
        assert comp == jnative.lz4_compress(data)
        assert native.lz4_decompress(comp, len(data)) == data
        assert jnative.lz4_decompress(comp, len(data)) == data
    text = _PATTERNS[-1]
    assert len(native.lz4_compress(text)) < len(text) // 10


def test_lz4_decompress_of_a_wrong_size_raises():
    comp = native.lz4_compress(b"abc" * 100)
    with pytest.raises(RuntimeError, match="lz4 decompression"):
        native.lz4_decompress(comp, 301)


def test_xxhash64_known_vectors_and_the_jax_hash():
    assert native.xxhash64(b"") == 0xEF46DB3751D8E999
    assert native.xxhash64(b"a") == 0xD24EC4F1A98C6E5B
    assert native.xxhash64(b"abc") == 0x44BC2CF5AD770999
    assert native.xxhash64(b"abc", 1) != native.xxhash64(b"abc", 2)
    for data in _random_inputs() + list(_PATTERNS):
        for seed in (0, 7, 2 ** 63 + 5):
            assert native.xxhash64(data, seed) == jnative.xxhash64(data,
                                                                   seed)


def _hash_columns(n=500, seed=2):
    rng = np.random.default_rng(seed)
    dbls = rng.normal(size=n)
    dbls[::17] = 0.0
    dbls[::23] = -0.0
    dbls[::31] = np.nan
    flts = rng.normal(size=n).astype(np.float32)
    flts[::13] = np.float32(0.0)
    flts[::19] = np.float32(-0.0)
    flts[::29] = np.float32("nan")
    return [
        (rng.integers(-1 << 40, 1 << 40, n), None),
        (rng.integers(-1 << 30, 1 << 30, n).astype(np.int32),
         rng.random(n) > 0.2),
        (dbls, None), (flts, rng.random(n) > 0.1),
        (rng.integers(-100, 100, n).astype(np.int8), None),
        (np.array([f"row-{i}-{'x' * (i % 9)}" if i % 5 else "é"
                   for i in range(n)], dtype=object), None)]


def test_murmur3_columns_equal_the_jax_package():
    cols = _hash_columns()
    for seed in (42, 0, 12345):
        np.testing.assert_array_equal(native.murmur3_columns(cols, seed),
                                      jnative.murmur3_columns(cols, seed))
    for col in cols:
        np.testing.assert_array_equal(native.murmur3_columns([col]),
                                      jnative.murmur3_columns([col]))


def test_murmur3_matches_the_host_engine_hash():
    """The native hash is Spark's Murmur3Hash as the JAX host engine
    evaluates it (they feed the same bucket choice)."""
    from spark_rapids_tpu.columnar import dtypes as dt
    from spark_rapids_tpu.columnar.host import HostColumn, HostTable
    from spark_rapids_tpu.expr.base import AttributeReference, EvalContext
    from spark_rapids_tpu.expr.hashing import Murmur3Hash
    cols = _hash_columns()
    picked = [cols[0], (cols[1][0], None), cols[2], (cols[3][0], None),
              cols[5]]
    types = [dt.LONG, dt.INT, dt.DOUBLE, dt.FLOAT, dt.STRING]
    names = ["l", "i", "d", "f", "s"]
    table = HostTable(names, [HostColumn(t, v) for t, (v, _) in
                              zip(types, picked)])
    expr = Murmur3Hash(*[AttributeReference(n, t)
                         for n, t in zip(names, types)])
    want = expr.eval(EvalContext.for_host(table)).values.astype(np.uint32)
    np.testing.assert_array_equal(native.murmur3_columns(picked, 42), want)


def test_murmur3_null_chaining():
    longs = np.array([1, 2, 3, 4], dtype=np.int64)
    validity = np.array([True, False, True, False])
    ints = np.array([9, 9, 9, 9], dtype=np.int32)
    h = native.murmur3_columns([(longs, validity), (ints, None)])
    h_ref = native.murmur3_columns([(ints[:1], None)])
    assert h[1] == h[3] == h_ref[0]
    assert h[0] != h[1]
    assert len(native.murmur3_columns([(longs[:0], None)])) == 0


@pytest.mark.parametrize("parts", [1, 7, 64])
def test_hash_partition_equals_the_jax_package(parts):
    rng = np.random.default_rng(3)
    hashes = rng.integers(0, 1 << 32, 10_000, dtype=np.uint64) \
        .astype(np.uint32)
    pids, counts, order = native.hash_partition(hashes, parts)
    for mine, theirs in zip((pids, counts, order),
                            jnative.hash_partition(hashes, parts)):
        np.testing.assert_array_equal(mine, theirs)
    want = (hashes.view(np.int32).astype(np.int64) % parts + parts) % parts
    np.testing.assert_array_equal(pids, want.astype(np.int32))
    assert counts.sum() == len(hashes)
    sorted_pids = pids[order]
    assert (np.diff(sorted_pids) >= 0).all()
    for p in range(parts):
        assert (np.diff(order[sorted_pids == p]) > 0).all()


def test_priority_queue():
    q = native.HashedPriorityQueue()
    h1 = q.push(50, 100)
    h2 = q.push(10, 200)
    h3 = q.push(30, 300)
    assert len(q) == 3
    assert q.pop() == (10, 200)
    assert q.update(h1, 5)
    assert q.pop() == (5, 100)
    assert not q.update(h2, 1)  # already popped
    assert q.remove(h3)
    assert q.pop() is None
    assert len(q) == 0
    for payload in (1, 2, 3):
        q.push(7, payload)
    assert [q.pop()[1] for _ in range(3)] == [1, 2, 3]


def test_priority_queue_order_equals_the_jax_queue():
    rng = np.random.default_rng(5)
    mine, theirs = native.HashedPriorityQueue(), jnative.HashedPriorityQueue()
    handles = []
    for i, p in enumerate(rng.integers(0, 50, 300)):
        handles.append((mine.push(int(p), i), theirs.push(int(p), i)))
    for a, b in handles[::7]:
        assert mine.update(a, 3) == theirs.update(b, 3)
    for a, b in handles[::11]:
        assert mine.remove(a) == theirs.remove(b)
    assert [mine.pop() for _ in range(len(mine) + 1)] == \
        [theirs.pop() for _ in range(len(theirs) + 1)]


def test_arena_alloc_free_coalesce_read_write():
    a = native.HostArena(1 << 16)
    offs = [a.alloc(1000) for _ in range(30)]
    assert all(o is not None for o in offs)
    assert a.used >= 30 * 1000
    for o in offs[::2]:
        assert a.free(o)
    big = a.alloc(30_000)
    for o in offs[1::2]:
        assert a.free(o)
    if big is not None:
        a.free(big)
    assert a.used == 0
    assert a.alloc(60_000) is not None
    small = native.HostArena(4096)
    assert small.alloc(100_000) is None
    o = small.alloc(256)
    small.write(o, b"hello spill world")
    assert small.read(o, 17) == b"hello spill world"
    with pytest.raises(IndexError):
        small.read(4000, 200)


def test_the_build_is_named_by_its_source_and_a_failure_raises(monkeypatch,
                                                              tmp_path):
    """The library sits in the ignored ``_build/`` under a content hash; a
    compiler that fails raises (nothing carries on without the library)."""
    path = native._library_path()
    assert path.parent.name == "_build" and path.exists()
    native.load_host_native()
    bad = tmp_path / "host_native.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SRC", bad)
    monkeypatch.setattr(native, "_BUILD_DIR", tmp_path / "_build")
    with pytest.raises(native.HostNativeBuildError, match="g\\+\\+ failed"):
        native._build(native._library_path())
    assert not list((tmp_path / "_build").glob("*.tmp"))
