"""The port's checksum and chunk fingerprints against the reference package's.

On the CPU the port's wrappers take their plain versions (``kernels/ref.py``);
they are held bit for bit against ``repro.kernels.ops`` run through the Pallas
kernels in interpret mode and through its own oracle (``impl="ref"``), and
against the host's ``serialization.fingerprint_chunks``, on the cases of
tests/test_device_fp.py: every dtype width, zero-byte leaves, ragged tails,
numpy leaves, the power-of-two errors.  Inputs are made with numpy from a
seed.  The CUDA kernels are held against the plain versions by the ``gpu``
tests at the end, which run only on an H100.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import serialization as SER
from repro_torch.kernels import checksum as CK
from repro_torch.kernels import ops, ref


class _Elsewhere(torch.Tensor):
    """A tensor with no storage on a device the wrappers have no path for
    (the meta device has one: the dry run's)."""

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        raise RuntimeError(f"{func} on a tensor with no storage")


def _elsewhere(shape, dtype=torch.float32):
    return torch.Tensor._make_wrapper_subclass(_Elsewhere, shape, dtype=dtype,
                                               device=torch.device("xpu"))


CHUNK = 256                       # 64 words: a power of two, as the kernels want


@pytest.fixture
def jax_ops():
    """The reference's dispatch; imported here and not at module level, so
    the ``gpu`` tests of this file also run where JAX is not installed."""
    pytest.importorskip("jax")
    from repro.kernels import ops as JO

    return JO


def _u32(t) -> np.ndarray:
    return np.asarray(t.cpu().numpy()).view(np.uint32)


def _words(rng, n) -> np.ndarray:
    return rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)


def _host_words(a) -> np.ndarray:
    """The host-side convention: little-endian payload bytes, zero-padded
    to a word boundary, viewed <u4."""
    b = np.ascontiguousarray(SER.host_array(a)).tobytes()
    return np.frombuffer(b + b"\0" * ((-len(b)) % 4), dtype="<u4")


# ---------------------------------------------------------------------------
# the word-stream functions against repro.kernels.ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,chunk_words", [
    (1, 1), (1, 8), (7, 8), (64, 8), (100, 64), (1000, 256), (4096, 1024), (5000, 1024),
])
@pytest.mark.parametrize("impl", ["pallas_interpret", "ref"])
def test_chunk_fingerprints_vs_reference(jax_ops, n, chunk_words, impl):
    import jax.numpy as jnp

    w = _words(np.random.default_rng(n), n)
    want = np.asarray(jax_ops.chunk_fingerprints(jnp.asarray(w), chunk_words=chunk_words,
                                                 impl=impl))
    for words in (torch.from_numpy(w), torch.from_numpy(w.view(np.int32))):
        got = ops.chunk_fingerprints(words, chunk_words=chunk_words)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(_u32(got), want)
    np.testing.assert_array_equal(
        _u32(ops.chunk_fingerprints(torch.from_numpy(w), chunk_words=chunk_words,
                                    impl="ref")), want)


@pytest.mark.parametrize("n,block", [(1, 8), (7, 8), (100, 64), (3000, 2048), (4096, 2048)])
@pytest.mark.parametrize("impl", ["pallas_interpret", "ref"])
def test_checksum_vs_reference(jax_ops, n, block, impl):
    import jax.numpy as jnp

    w = _words(np.random.default_rng(100 + n), n)
    want = int(np.asarray(jax_ops.checksum(jnp.asarray(w), impl=impl, block=block)))
    for words in (torch.from_numpy(w), torch.from_numpy(w.view(np.int32))):
        got = ops.checksum(words, block=block)
        assert got.shape == () and got.dtype == torch.int32
        assert int(_u32(got)) == want
    assert int(_u32(ops.checksum(torch.from_numpy(w), block=block, impl="ref"))) == want


def test_empty_streams_and_the_oracles_agree_with_the_mix():
    empty = torch.zeros(0, dtype=torch.int32)
    assert ops.chunk_fingerprints(empty, chunk_words=8).shape == (0,)
    assert int(ops.checksum(empty)) == 0
    assert int(CK.checksum(empty)) == 0
    # a 1-word stream by hand: (w ^ 0*P) * (0|1) = w, so XOR + SUM = 2w
    w = torch.tensor([0x12345678], dtype=torch.int32)
    assert int(_u32(ref.checksum(w))) == (2 * 0x12345678) & 0xFFFFFFFF
    assert int(_u32(ref.chunk_fingerprints(w, 1))[0]) == (2 * 0x12345678) & 0xFFFFFFFF


@pytest.mark.parametrize("call,match", [
    (lambda w: ops.chunk_fingerprints(w, chunk_words=3), "chunk_words must be a positive"),
    (lambda w: ops.chunk_fingerprints(w, chunk_words=0), "chunk_words must be a positive"),
    (lambda w: ops.checksum(w, block=12), "block must be a positive"),
    (lambda w: CK.chunk_fingerprints(w, 6), "chunk_words must be a positive"),
    (lambda w: CK.checksum(w, block=3), "block must be a positive"),
    (lambda w: ops.tree_chunk_fingerprints([("a", w)], 12), "chunk_words must be a positive"),
    (lambda w: ops.tree_chunk_fingerprints([("a", w)], 6), "multiple of 4"),
])
def test_power_of_two_errors_before_any_work(call, match):
    # raised even for an empty stream, like the reference's require_pow2
    with pytest.raises(ValueError, match=match):
        call(torch.zeros(0, dtype=torch.int32))


def test_wrappers_refuse_what_the_kernels_do_not_take():
    with pytest.raises(TypeError, match="int32 or uint32"):
        CK.chunk_fingerprints(torch.zeros(8), 8)
    with pytest.raises(ValueError, match="1-d"):
        CK.checksum(torch.zeros(2, 4, dtype=torch.int32))
    with pytest.raises(ValueError, match="contiguous"):
        CK.chunk_fingerprints(torch.zeros(16, dtype=torch.int32)[::2], 8)
    with pytest.raises(ValueError, match="no kernel for device"):
        CK.checksum(_elsewhere((8,), torch.int32))
    with pytest.raises(ValueError, match="not available"):
        ops.checksum(torch.zeros(8, dtype=torch.int32), impl="pallas_interpret")


# ---------------------------------------------------------------------------
# leaf_words and tree_chunk_fingerprints against the host serialization
# ---------------------------------------------------------------------------

DTYPES = [
    ("float32", 33), ("int32", 7), ("uint32", 8), ("float16", 9), ("bfloat16", 10),
    ("int8", 7), ("uint8", 13), ("bool", 11), ("float64", 5), ("float32", 0),
]


def _torch_leaf(rng, dtype: str, n: int) -> torch.Tensor:
    raw = rng.integers(0, 200, size=n)
    if dtype == "bool":
        return torch.from_numpy(raw % 2 == 0)
    if dtype == "bfloat16":
        return torch.from_numpy(raw.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(raw.astype(dtype))


@pytest.mark.parametrize("dtype,n", DTYPES)
def test_leaf_words_matches_reference_and_host_view(jax_ops, dtype, n):
    import jax.numpy as jnp

    leaf = _torch_leaf(np.random.default_rng(3), dtype, n)
    got = ops.leaf_words(leaf)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_u32(got), _host_words(leaf))
    if dtype != "float64":          # jnp would downcast float64 without x64
        jleaf = jnp.asarray(np.ascontiguousarray(SER.host_array(leaf)).view(np.uint8)
                            ).view(jnp.bfloat16 if dtype == "bfloat16" else dtype)
        np.testing.assert_array_equal(_u32(got), np.asarray(jax_ops.leaf_words(jleaf)))


def test_leaf_words_scalar_and_numpy_paths(jax_ops):
    rng = np.random.default_rng(4)
    np.testing.assert_array_equal(_u32(ops.leaf_words(torch.tensor(1.5))),
                                  _host_words(np.float32(1.5)))
    for a in (rng.standard_normal(5),                 # f64
              np.float64(2.75),                       # 0-d
              rng.integers(0, 9, 7).astype(np.int8),  # 7 bytes -> pad
              np.zeros(0, np.float32)):
        got = ops.leaf_words(a)
        assert isinstance(got, np.ndarray)
        np.testing.assert_array_equal(got, _host_words(a))
        np.testing.assert_array_equal(got, np.asarray(jax_ops.leaf_words(a)))


def _fp_tree():
    rng = np.random.default_rng(5)
    return [
        ("aligned", torch.from_numpy(rng.standard_normal(CHUNK // 4 * 3).astype(np.float32))),
        ("ragged", torch.from_numpy(rng.standard_normal(CHUNK // 4 + 5).astype(np.float32))),
        ("bytes", torch.from_numpy(rng.integers(0, 100, CHUNK + 7).astype(np.int8))),
        ("tiny", torch.from_numpy(rng.standard_normal(3).astype(np.float32))),
        ("empty", torch.zeros(0)),
        ("bf16", torch.from_numpy(rng.standard_normal(CHUNK + 3).astype(np.float32)
                                  ).to(torch.bfloat16)),
        ("flags", torch.from_numpy(rng.integers(0, 2, 37).astype(bool))),
        ("step", torch.tensor(7, dtype=torch.int32)),
        ("host64", rng.standard_normal(CHUNK // 8 + 1)),   # numpy f64
    ]


@pytest.mark.parametrize("impl", ["auto", "pallas", "ref"])
def test_tree_chunk_fingerprints_matches_serialization(impl):
    from repro.checkpoint.serialization import fingerprint_chunks

    leaves = _fp_tree()
    got = ops.tree_chunk_fingerprints(leaves, CHUNK, impl=impl)
    assert set(got) == {name for name, _ in leaves}
    for name, leaf in leaves:
        host = np.ascontiguousarray(SER.host_array(leaf)).tobytes()
        np.testing.assert_array_equal(got[name], fingerprint_chunks(host, CHUNK),
                                      err_msg=f"leaf {name} ({impl})")
        np.testing.assert_array_equal(got[name], SER.fingerprint_chunks(host, CHUNK))
        assert got[name].dtype == np.uint32


def test_tree_chunk_fingerprints_matches_reference_tree(jax_ops):
    """The same leaves through the reference's ``tree_chunk_fingerprints``
    (Pallas kernel in interpret mode) give the same vectors."""
    import jax.numpy as jnp

    leaves = _fp_tree()
    jleaves = []
    for name, leaf in leaves:
        if isinstance(leaf, torch.Tensor):
            h = np.ascontiguousarray(SER.host_array(leaf))
            dt = jnp.bfloat16 if leaf.dtype == torch.bfloat16 else h.dtype
            leaf = jnp.asarray(h.view(np.uint8)).view(dt).reshape(h.shape)
        jleaves.append((name, leaf))
    want = jax_ops.tree_chunk_fingerprints(jleaves, CHUNK, impl="pallas_interpret")
    got = ops.tree_chunk_fingerprints(leaves, CHUNK)
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_tree_leaves_are_only_read():
    leaves = _fp_tree()
    before = [np.ascontiguousarray(SER.host_array(x)).tobytes() for _, x in leaves]
    ops.tree_chunk_fingerprints(leaves, CHUNK)
    after = [np.ascontiguousarray(SER.host_array(x)).tobytes() for _, x in leaves]
    assert before == after


# ---- the CUDA kernels on the card --------------------------------------------

@pytest.fixture
def hopper():
    if not torch.cuda.is_available() or torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("the CUDA kernels are built for sm_90a: needs an H100 and nvcc")
    return torch.device("cuda")


def _cuda_words(n, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randint(-2**31, 2**31, (n,), generator=g, dtype=torch.int64,
                         device="cuda").to(torch.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("n,chunk_words", [
    (1, 1), (5, 1), (1, 8), (100, 8), (4096, 8), (777, 512), (4096, 1024), (5003, 1024),
    (262144 * 3, 262144), (262144 * 2 + 17, 262144), (5, 262144),
])
def test_chunk_fingerprints_kernel_vs_plain(hopper, n, chunk_words):
    w = _cuda_words(n, seed=n)
    count = CK.fingerprint_launches
    got = ops.chunk_fingerprints(w, chunk_words=chunk_words)
    assert CK.fingerprint_launches == count + 1
    want = ref.chunk_fingerprints(w, chunk_words)
    assert torch.equal(got, want)
    # an unaligned start takes the scalar path and agrees too
    if n > 1:
        assert torch.equal(ops.chunk_fingerprints(w[1:], chunk_words=chunk_words),
                           ref.chunk_fingerprints(w[1:], chunk_words))


@pytest.mark.gpu
@pytest.mark.parametrize("n,block", [(1, 8), (7, 8), (100, 64), (3000, 2048),
                                     (1 << 20, 2048), ((1 << 20) + 3, 2048)])
def test_checksum_kernel_vs_plain(hopper, n, block):
    w = _cuda_words(n, seed=n)
    count = CK.checksum_launches
    got = ops.checksum(w, block=block)
    again = ops.checksum(w, block=block)
    assert CK.checksum_launches == count + 2
    pad = (-n) % block
    want = ref.checksum(torch.cat([w, w.new_zeros(pad)]))
    assert torch.equal(got, want) and torch.equal(got, again)


@pytest.mark.gpu
def test_tree_on_the_card_matches_the_host(hopper):
    leaves = [(n, x.cuda() if isinstance(x, torch.Tensor) else x) for n, x in _fp_tree()]
    count = CK.fingerprint_launches
    got = ops.tree_chunk_fingerprints(leaves, CHUNK)
    # bodies of "aligned", "ragged", "bytes", "bf16" + one launch for all the
    # CUDA tails; the numpy leaf takes the host path
    assert CK.fingerprint_launches == count + 5
    for name, leaf in leaves:
        host = np.ascontiguousarray(SER.host_array(leaf)).tobytes()
        np.testing.assert_array_equal(got[name], SER.fingerprint_chunks(host, CHUNK))


@pytest.mark.gpu
def test_ops_refuses_the_plain_version_on_cuda(hopper):
    w = _cuda_words(64)
    for call in (lambda: ops.checksum(w, impl="ref"),
                 lambda: ops.chunk_fingerprints(w, chunk_words=8, impl="xla"),
                 lambda: ops.tree_chunk_fingerprints([("a", w)], CHUNK, impl="ref")):
        with pytest.raises(ValueError, match="CPU tensors only"):
            call()
