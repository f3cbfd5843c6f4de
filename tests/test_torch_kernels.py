"""The port's attention against the reference package's Pallas kernels.

On the CPU the port's wrappers take their plain versions (``kernels/ref.py``);
they are held against ``repro``'s ``flash`` and ``flash_decode`` run in
interpret mode, on the cases of tests/test_kernels.py plus qwen2-0.5b's head
grouping (H=14, Hkv=2, G=7), with that file's tolerances (2e-5 float32, 5e-2
bfloat16).  The CUDA kernels themselves are held against the plain versions
by the ``gpu`` tests at the end, which run only on an H100.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build, decode_attention, flash_attention, ops, ref

TOL = {"float32": 2e-5, "bfloat16": 5e-2}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture
def jax_kernels():
    """The reference's Pallas kernels; imported here and not at module level,
    so the ``gpu`` tests of this file also run where JAX is not installed."""
    pytest.importorskip("jax")
    from repro.kernels.decode_attention import flash_decode
    from repro.kernels.flash_attention import flash

    return flash, flash_decode


def _mk(rng, B, Sq, Skv, H, Hkv, Dq, Dv, dtype):
    """The same inputs for both packages: numpy float32, rounded to ``dtype``
    by each framework (both round to nearest even)."""
    import jax.numpy as jnp

    arrs = [rng.standard_normal(s, np.float32) for s in
            ((B, Sq, H, Dq), (B, Skv, Hkv, Dq), (B, Skv, Hkv, Dv))]
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    return ([jnp.asarray(a, jdt) for a in arrs],
            [torch.from_numpy(a).to(TDT[dtype]) for a in arrs])


def _err(port, want) -> float:
    return float(np.abs(port.float().numpy() - np.asarray(want, np.float32)).max())


@pytest.mark.parametrize("B,S,H,Hkv,Dq,Dv", [
    (2, 256, 4, 2, 64, 64),     # GQA
    (1, 128, 8, 1, 128, 64),    # MQA-ish, d_qk != d_v (MLA shape)
    (2, 128, 4, 4, 32, 32),     # MHA
    (1, 512, 2, 2, 64, 64),     # longer seq
    (2, 128, 14, 2, 64, 64),    # qwen2-0.5b grouping, G = 7
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_vs_pallas_flash(jax_kernels, rng, B, S, H, Hkv, Dq, Dv, dtype):
    (qj, kj, vj), (q, k, v) = _mk(rng, B, S, S, H, Hkv, Dq, Dv, dtype)
    want = jax_kernels[0](qj, kj, vj, causal=True, block_q=64, block_k=64, interpret=True)
    got = ops.attention(q, k, v, causal=True)
    assert got.dtype == TDT[dtype] and tuple(got.shape) == (B, S, H, Dv)
    assert _err(got, want) < TOL[dtype]
    # the wrapper's CPU path is the same plain version
    assert torch.equal(flash_attention.flash(q, k, v, causal=True), got)


@pytest.mark.parametrize("B,H,Hkv,Dq,Dv,S,kvl", [
    (2, 8, 2, 64, 64, 512, 300),
    (1, 16, 1, 128, 64, 256, 256),   # MLA-ish absorbed shape
    (4, 4, 4, 32, 32, 128, 77),
    (4, 14, 2, 64, 64, 256, 130),    # qwen2-0.5b grouping, G = 7
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_vs_pallas_flash_decode(jax_kernels, rng, B, H, Hkv, Dq, Dv, S, kvl,
                                       dtype):
    (qj, kj, vj), (q, k, v) = _mk(rng, B, 1, S, H, Hkv, Dq, Dv, dtype)
    want = jax_kernels[1](qj, kj, vj, kv_len=kvl, block_k=128, interpret=True)
    kv_len = torch.tensor(kvl, dtype=torch.int32)       # as the cache's t + 1
    got = ops.attention(q, k, v, causal=False, kv_len=kv_len, decode=True)
    assert got.dtype == TDT[dtype] and tuple(got.shape) == (B, 1, H, Dv)
    assert _err(got, want) < TOL[dtype]
    assert torch.equal(decode_attention.flash_decode(q, k, v, kv_len=kv_len), got)


def test_ref_fully_masked_rows_are_zero():
    q, k, v = (torch.randn(1, 1, 2, 32), torch.randn(1, 8, 1, 32), torch.randn(1, 8, 1, 32))
    out = ref.attention(q, k, v, causal=False, kv_len=0)
    assert torch.equal(out, torch.zeros_like(out))


# ---- dispatch and wrapper checks (no card needed) ---------------------------

def test_ops_rejects_unknown_impl():
    q = torch.zeros(1, 4, 2, 32)
    with pytest.raises(ValueError, match="not available"):
        ops.attention(q, q[:, :, :1], q[:, :, :1], impl="ring")


def test_ops_plain_impls_run_on_cpu():
    q, k, v = torch.randn(1, 8, 4, 32), torch.randn(1, 8, 2, 32), torch.randn(1, 8, 2, 32)
    want = ref.attention(q, k, v, causal=True)
    for impl in ops.KERNEL_IMPLS + ops.PLAIN_IMPLS:
        assert torch.equal(ops.attention(q, k, v, causal=True, impl=impl), want)


def test_ops_refuses_devices_without_a_path():
    q = torch.empty(1, 4, 2, 32, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.attention(q, q, q)


@pytest.mark.parametrize("wrapper", [flash_attention.flash, decode_attention.flash_decode])
def test_wrappers_refuse_other_devices(wrapper):
    q = torch.empty(1, 1, 2, 32, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        wrapper(q, q, q)


@pytest.mark.parametrize("check,shapes,dtype,match", [
    (flash_attention._check, ((1, 8, 4, 32), (1, 8, 2, 32), (1, 8, 2, 32)),
     torch.float16, "dtypes"),
    (flash_attention._check, ((1, 8, 4, 48), (1, 8, 2, 48), (1, 8, 2, 48)),
     torch.float32, "head dims"),
    (flash_attention._check, ((1, 8, 6, 32), (1, 8, 4, 32), (1, 8, 4, 32)),
     torch.float32, "multiple"),
    (flash_attention._check, ((1, 8, 4, 32), (1, 9, 2, 32), (1, 8, 2, 32)),
     torch.float32, "do not match"),
    (decode_attention._check, ((1, 2, 4, 32), (1, 8, 2, 32), (1, 8, 2, 32)),
     torch.float32, "one query token"),
    (decode_attention._check, ((1, 1, 16, 576), (1, 8, 1, 576), (1, 8, 1, 512)),
     torch.float32, "MLA"),
])
def test_wrapper_checks_refuse_what_the_kernel_does_not_take(check, shapes, dtype, match):
    q, k, v = (torch.zeros(s, dtype=dtype) for s in shapes)
    with pytest.raises((ValueError, TypeError), match=match):
        check(q, k, v)


def test_wrapper_checks_refuse_non_contiguous():
    q = torch.zeros(1, 4, 8, 32).transpose(1, 2)
    k = torch.zeros(1, 8, 2, 32)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention._check(q, k, k)


def test_build_names_carry_a_source_digest(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    for name in _build.SOURCES:
        assert (_build.CSRC / f"{name}.cu").exists()
        p = _build.lib_path(name)
        assert p.parent == tmp_path and p.name.startswith(f"lib{name}-")
        assert p == _build.lib_path(name)          # stable across calls


# ---- the CUDA kernels on the card --------------------------------------------

@pytest.fixture
def hopper():
    if not torch.cuda.is_available() or torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("the CUDA kernels are built for sm_90a: needs an H100 and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _cuda_inputs(B, Sq, Skv, H, Hkv, Dq, Dv, dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(s, generator=g, device="cuda").to(TDT[dtype]) for s in
            ((B, Sq, H, Dq), (B, Skv, Hkv, Dq), (B, Skv, Hkv, Dv))]


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,Hkv,Dq,Dv,causal", [
    (4, 512, 14, 2, 64, 64, True),
    (2, 300, 14, 2, 64, 64, True),     # ragged
    (1, 256, 8, 1, 128, 64, False),
    (1, 100, 4, 4, 32, 128, True),
    (1, 64, 4, 2, 192, 128, True),     # MLA prefill shape
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_vs_plain(hopper, B, S, H, Hkv, Dq, Dv, causal, dtype):
    q, k, v = _cuda_inputs(B, S, S, H, Hkv, Dq, Dv, dtype)
    n = flash_attention.launches
    got = flash_attention.flash(q, k, v, causal=causal)
    assert flash_attention.launches == n + 1
    want = ref.attention(q.float(), k.float(), v.float(), causal=causal)
    assert got.dtype == q.dtype
    assert float((got.float() - want).abs().max()) < TOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,Hkv,D,kvl", [
    (4, 1024, 14, 2, 64, 1), (4, 1024, 14, 2, 64, 300), (4, 1024, 14, 2, 64, 1024),
    (2, 512, 8, 2, 64, 77), (1, 256, 32, 1, 128, 200),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_kernel_vs_plain(hopper, B, S, H, Hkv, D, kvl, dtype):
    q, k, v = _cuda_inputs(B, 1, S, H, Hkv, D, D, dtype)
    kv_len = torch.tensor(kvl, dtype=torch.int32, device="cuda")
    n = decode_attention.launches
    got = decode_attention.flash_decode(q, k, v, kv_len=kv_len)
    again = decode_attention.flash_decode(q, k, v, kv_len=kv_len)
    assert decode_attention.launches == n + 2
    want = ref.attention(q.float(), k.float(), v.float(), causal=False, kv_len=kvl)
    assert float((got.float() - want).abs().max()) < TOL[dtype]
    assert torch.equal(got, again)           # no atomics: the same bits every run


@pytest.mark.gpu
def test_ops_refuses_the_plain_version_on_cuda(hopper):
    q, k, v = _cuda_inputs(1, 8, 8, 4, 2, 32, 32, "float32")
    with pytest.raises(ValueError, match="CPU tensors only"):
        ops.attention(q, k, v, impl="xla")
