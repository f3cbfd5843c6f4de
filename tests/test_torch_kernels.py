"""The port's attention against the reference package's Pallas kernels.

On the CPU the port's wrappers take their plain versions (``kernels/ref.py``);
they are held against ``repro``'s ``flash`` and ``flash_decode`` run in
interpret mode, on the cases of tests/test_kernels.py plus qwen2-0.5b's head
grouping (H=14, Hkv=2, G=7), with that file's tolerances (2e-5 float32, 5e-2
bfloat16).  Test-local models of the CUDA kernels' own arithmetic (P rounded
to bfloat16 before P V; split-KV partials and their fixed-order combine) are
held against the same Pallas kernels.  The CUDA kernels themselves are held
against the plain versions by the ``gpu`` tests at the end, which run only
on an H100.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build, decode_attention, flash_attention, ops, ref
from repro_torch.kernels import ssd as SSD
from repro_torch.kernels import wkv6 as WKV

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


# ---- the CUDA kernels' arithmetic, modelled on the CPU against repro ----------

def _tc_flash_model(q, k, v, *, causal=True, block=64):
    """The bfloat16 tensor-core flash kernel's arithmetic (csrc/flash_attention.cu,
    flash_fwd_bf16_kernel) in plain torch: fp32 scores, an online softmax over
    tiles of ``block`` keys, P rounded to bfloat16 before P V, fp32
    accumulation, l summing the unrounded P and floored at 1e-30, the
    output rounded to q's dtype."""
    B, Sq, H, Dq = q.shape
    Skv, Hkv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    G = H // Hkv
    scale = 1.0 / np.sqrt(Dq)
    kf = k.float().repeat_interleave(G, dim=2)
    vf = v.float().repeat_interleave(G, dim=2)
    qf = q.float()
    m = torch.full((B, H, Sq), -1e30)
    l = torch.zeros(B, H, Sq)
    acc = torch.zeros(B, H, Sq, Dv)
    qpos = torch.arange(Sq)[:, None]
    for k0 in range(0, Skv, block):
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kf[:, k0:k0 + block]) * scale
        kpos = torch.arange(k0, min(k0 + block, Skv))[None, :]
        if causal:
            s = s.masked_fill(kpos > qpos, -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        pv = torch.einsum("bhqk,bkhd->bhqd", p.to(torch.bfloat16).float(),
                          vf[:, k0:k0 + block])
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)


@pytest.mark.parametrize("B,S,H,Hkv,Dq,Dv", [
    (2, 256, 4, 2, 64, 64), (1, 128, 8, 1, 128, 64), (2, 128, 4, 4, 32, 32),
    (1, 512, 2, 2, 64, 64), (2, 128, 14, 2, 64, 64),
])
def test_tensor_core_flash_numerics_vs_pallas_flash(jax_kernels, rng, B, S, H, Hkv, Dq, Dv):
    """The tensor-core kernel rounds P to bfloat16 before P V, where the
    reference keeps it in fp32.  Its arithmetic, modelled here, stays within
    the bfloat16 tolerance of repro's flash on the cases of
    test_attention_vs_pallas_flash: worst error 1.56e-2 of the 5e-2 allowed
    (a CPU run of these cases), one bfloat16 rounding of the output."""
    (qj, kj, vj), (q, k, v) = _mk(rng, B, S, S, H, Hkv, Dq, Dv, "bfloat16")
    want = jax_kernels[0](qj, kj, vj, causal=True, block_q=64, block_k=64, interpret=True)
    got = _tc_flash_model(q, k, v, causal=True)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (B, S, H, Dv)
    assert _err(got, want) < TOL["bfloat16"]


def _split_decode_model(q, k, v, kv_len):
    """The split-KV decode kernel's arithmetic (csrc/decode_attention.cu) in
    plain torch: per split of ``decode_attention.split_size(S)`` positions a
    partial (m, l, acc) with an fp32 online softmax over 64-position tiles,
    then the combine over the active splits in split order, out = acc /
    max(l, 1e-30) in q's dtype."""
    B, _, H, Dq = q.shape
    S, Hkv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    G = H // Hkv
    split = decode_attention.split_size(S)
    ns = decode_attention.num_splits(S)
    assert ns * split >= S
    scale = 1.0 / np.sqrt(Dq)
    qf = q.float().reshape(B, Hkv, G, Dq)
    kf, vf = k.float(), v.float()
    parts = []
    for s0 in range(0, ns * split, split):
        end = min(s0 + split, kv_len)
        if s0 >= end:
            continue                       # reads nothing, adds nothing
        m = torch.full((B, Hkv, G), -1e30)
        l = torch.zeros(B, Hkv, G)
        acc = torch.zeros(B, Hkv, G, Dv)
        for k0 in range(s0, end, 64):
            sc = torch.einsum("bkgd,bskd->bkgs", qf, kf[:, k0:k0 + 64]) * scale
            pos = torch.arange(k0, min(k0 + 64, S))
            sc = sc.masked_fill(pos >= end, -1e30)
            m_new = torch.maximum(m, sc.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(sc - m_new[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum("bkgs,bskd->bkgd", p, vf[:, k0:k0 + 64])
            m = m_new
        parts.append((m, l, acc))
    m_star = torch.full((B, Hkv, G), -1e30)
    for m, _, _ in parts:
        m_star = torch.maximum(m_star, m)
    l_sum = torch.zeros(B, Hkv, G)
    acc_sum = torch.zeros(B, Hkv, G, Dv)
    for m, l, acc in parts:                # split order 0, 1, ...
        w = torch.exp(m - m_star)
        l_sum = l_sum + l * w
        acc_sum = acc_sum + acc * w[..., None]
    out = acc_sum / torch.clamp(l_sum, min=1e-30)[..., None]
    return out.reshape(B, 1, H, Dv).to(q.dtype)


@pytest.mark.parametrize("B,H,Hkv,Dq,Dv,S", [
    (2, 8, 2, 64, 64, 512), (1, 16, 1, 128, 64, 256), (4, 4, 4, 32, 32, 128),
    (4, 14, 2, 64, 64, 256),               # qwen2-0.5b grouping, G = 7
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_decode_numerics_vs_pallas_flash_decode(jax_kernels, rng, B, H, Hkv, Dq, Dv,
                                                      S, dtype):
    """Split partials and the fixed-order combine, modelled here with the
    wrapper's own split_size / num_splits, against repro's flash_decode at
    kv_len 0, 1, on each side of the first split boundary, and S: worst
    error 4.77e-7 in float32 and 0 in bfloat16 (a CPU run of these cases)."""
    (qj, kj, vj), (q, k, v) = _mk(rng, B, 1, S, H, Hkv, Dq, Dv, dtype)
    split = decode_attention.split_size(S)
    for kvl in (0, 1, split - 1, split, split + 1, S):
        want = jax_kernels[1](qj, kj, vj, kv_len=kvl, block_k=128, interpret=True)
        got = _split_decode_model(q, k, v, kvl)
        assert got.dtype == TDT[dtype] and tuple(got.shape) == (B, 1, H, Dv)
        assert _err(got, want) < TOL[dtype], kvl


def test_num_splits_depends_on_the_cache_shape_alone():
    import inspect

    # the cache's length alone: no kv_len (a decode step never syncs the
    # host), no batch, head count or group size (G = 7, 1 and 32 alike)
    assert list(inspect.signature(decode_attention.num_splits).parameters) == ["S"]
    for S in (1, 64, 65, 1024, 4096, 4097, 32768):
        split = decode_attention.split_size(S)
        ns = decode_attention.num_splits(S)
        assert split % 64 == 0 and ns * split >= S > (ns - 1) * split
        assert ns <= decode_attention.MAX_SPLITS
    assert decode_attention.num_splits(1024) == 16     # 16 x 2 x 4 = 128 CTAs at qwen2's shape


def test_max_splits_is_the_kernels():
    """The combine kernel's loops run to the source's MAX_SPLITS and its C
    entry refuses more splits: the wrapper's limit must be the same number."""
    import re
    from pathlib import Path

    src = (Path(decode_attention.__file__).parents[1] / "csrc" / "decode_attention.cu").read_text()
    assert re.findall(r"constexpr int MAX_SPLITS = (\d+);", src) == [str(decode_attention.MAX_SPLITS)]


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


@pytest.mark.parametrize("check", [flash_attention._check, decode_attention._check])
def test_wrapper_checks_refuse_unaligned_starts(check):
    """The kernels copy rows in 16-byte pieces (cp.async), so every tensor
    must start on a 16-byte boundary; a contiguous view 4 bytes in does not."""
    q = torch.zeros(1, 1, 4, 32)
    k = torch.zeros(1 + 8 * 2 * 32)[1:].view(1, 8, 2, 32)
    assert k.is_contiguous() and k.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte"):
        check(q, k, k)


def test_wrapper_checks_refuse_non_contiguous():
    q = torch.zeros(1, 4, 8, 32).transpose(1, 2)
    k = torch.zeros(1, 8, 2, 32)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention._check(q, k, k)


def _ssd_args(B, S, H, P, N, dtype=torch.float32, device="cpu", seed=0):
    """Inputs of tests/test_kernels.py::_mk_ssd's scales, made on ``device``;
    dt, B and C in ``dtype``, A_log and D in float32, an fp32 initial state."""
    g = torch.Generator(device=device).manual_seed(seed)

    def rn(*shape):
        return torch.randn(shape, generator=g, device=device)

    x, Bm, Cm = rn(B, S, H, P) * 0.5, rn(B, S, N) * 0.5, rn(B, S, N) * 0.5
    dt = rn(B, S, H).abs() * 0.5
    args = (x.to(dtype), dt.to(dtype), rn(H) * 0.3, Bm.to(dtype), Cm.to(dtype),
            torch.ones(H, device=device))
    return args, rn(B, H, P, N) * 0.5


def _wkv_args(B, S, H, D, dtype=torch.float32, device="cpu", seed=0):
    g = torch.Generator(device=device).manual_seed(seed)

    def rn(*shape):
        return torch.randn(shape, generator=g, device=device)

    r, k, v = (rn(B, S, H, D) * 0.5 for _ in range(3))
    w = torch.rand((B, S, H, D), generator=g, device=device) * 0.299 + 0.7
    args = (r.to(dtype), k.to(dtype), v.to(dtype), w.to(dtype), rn(H, D) * 0.3)
    return args, rn(B, H, D, D) * 0.5


@pytest.mark.parametrize("wrapper,make", [(SSD.ssd, lambda: _ssd_args(1, 4, 2, 8, 8)[0]),
                                          (WKV.wkv6, lambda: _wkv_args(1, 4, 2, 16)[0])])
def test_scan_wrappers_refuse_other_devices(wrapper, make):
    args = [t.to("meta") for t in make()]
    with pytest.raises(ValueError, match="no kernel for device"):
        wrapper(*args)


def test_scan_ops_plain_impls_run_on_cpu():
    args, st0 = _ssd_args(1, 9, 2, 8, 8)
    want = ref.ssd(*args, init_state=st0)
    for impl in ops.KERNEL_IMPLS + ops.PLAIN_IMPLS:
        assert torch.equal(ops.ssd(*args, init_state=st0, impl=impl), want)
    args, st0 = _wkv_args(1, 9, 2, 16)
    want = ref.wkv6(*args, init_state=st0)
    for impl in ops.KERNEL_IMPLS + ops.PLAIN_IMPLS:
        assert torch.equal(ops.wkv6(*args, init_state=st0, impl=impl), want)
    with pytest.raises(ValueError, match="not available"):
        ops.wkv6(*args, impl="pallas_interpret")


def test_scan_plain_versions_differentiate_on_cpu():
    args, _ = _ssd_args(1, 6, 2, 8, 8)
    x = args[0].clone().requires_grad_()
    ops.ssd(x, *args[1:]).sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()


@pytest.mark.parametrize("mutate,match", [
    (lambda a: (a[0][:, :, :1],) + a[1:], "shape"),
    (lambda a: (a[0].to(torch.float16),) + a[1:], "dtypes"),
    (lambda a: (a[0].transpose(1, 2).contiguous().transpose(1, 2),) + a[1:], "contiguous"),
])
def test_ssd_check_refuses_what_the_kernel_does_not_take(mutate, match):
    args, _ = _ssd_args(1, 4, 2, 8, 8)
    with pytest.raises((ValueError, TypeError), match=match):
        SSD._check(*mutate(args), None)


@pytest.mark.parametrize("D,mutate,match", [
    (16, lambda a: (a[0], a[1][:, :3]) + a[2:], "shape"),
    (48, lambda a: a, "head dim"),
    (16, lambda a: (a[0].to(torch.float16),) + a[1:], "dtypes"),
    (16, lambda a: a[:4] + (a[4][:1],), "u has shape"),
])
def test_wkv6_check_refuses_what_the_kernel_does_not_take(D, mutate, match):
    args, _ = _wkv_args(1, 4, 2, D)
    with pytest.raises((ValueError, TypeError), match=match):
        WKV._check(*mutate(args), None)


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


# bfloat16 attention, element by element: |kernel - plain| <= atol + rtol |plain|,
# beside the absolute TOL.  rtol covers the output's rounding to bfloat16 (at
# most 2^-8 of |plain|); atol what the arithmetic adds: flash's P rounded to
# bfloat16 before P V (a CPU model of it needs 1.8e-3-2.4e-3), decode's fp32
# sums.  A typical |plain| is 0.03-0.14 at the main shapes.
ATTN_BF16_TOL = {"flash": (5e-3, 1e-2), "flash_decode": (1e-4, 1e-2)}


def _excess(got, want, rtol) -> float:
    """The largest |got - want| - rtol |want|: the atol the comparison needs."""
    return float(((got.float() - want).abs() - rtol * want.abs()).max())


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
    (8, 128, 14, 2, 64, 64, True),     # the train forward
    (4, 512, 32, 32, 64, 64, True),    # zamba2-1.2b's shared block, G = 1
    (2, 1, 14, 2, 64, 64, True),       # ragged against the 64-row tiles
    (2, 17, 14, 2, 64, 64, True),
    (2, 63, 14, 2, 64, 64, True),
    (2, 65, 14, 2, 64, 64, True),
    (2, 300, 14, 2, 64, 64, False),
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
    if dtype == "bfloat16":
        atol, rtol = ATTN_BF16_TOL["flash"]
        assert _excess(got, want, rtol) <= atol
    assert torch.equal(flash_attention.flash(q, k, v, causal=causal), got)   # no atomics
    assert flash_attention.launches == n + 2


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,Hkv,D,kvl", [
    (4, 1024, 14, 2, 64, 1), (4, 1024, 14, 2, 64, 300), (4, 1024, 14, 2, 64, 1024),
    (2, 512, 8, 2, 64, 77), (1, 256, 32, 1, 128, 200),
    # the split boundaries (64 positions a split at S = 1024), and an empty cache
    (4, 1024, 14, 2, 64, 63), (4, 1024, 14, 2, 64, 64), (4, 1024, 14, 2, 64, 65),
    (4, 1024, 14, 2, 64, 0),
    (4, 1024, 32, 32, 64, 544), (4, 1024, 32, 32, 64, 65),    # zamba2-1.2b, G = 1
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
    if dtype == "bfloat16":
        atol, rtol = ATTN_BF16_TOL["flash_decode"]
        assert _excess(got, want, rtol) <= atol
    assert torch.equal(got, again)           # fixed combine order: the same bits every run


@pytest.mark.gpu
def test_ops_refuses_the_plain_version_on_cuda(hopper):
    q, k, v = _cuda_inputs(1, 8, 8, 4, 2, 32, 32, "float32")
    with pytest.raises(ValueError, match="CPU tensors only"):
        ops.attention(q, k, v, impl="xla")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_gradient_vs_plain(hopper, dtype):
    """Training's attention: the kernel forward under autograd, with the plain
    version's backward, against the plain forward and backward in float32 at
    the training shape (B8 S128 H14 Hkv2 D64)."""
    q, k, v = (t.requires_grad_() for t in _cuda_inputs(8, 128, 128, 14, 2, 64, 64, dtype))
    g = torch.Generator(device="cuda").manual_seed(1)
    go = torch.randn(q.shape, generator=g, device="cuda").to(q.dtype)
    n = flash_attention.launches
    out = flash_attention.flash(q, k, v, causal=True)
    assert flash_attention.launches == n + 1 and out.grad_fn is not None
    grads = torch.autograd.grad(out, (q, k, v), go)
    plain_in = [t.detach().float().requires_grad_() for t in (q, k, v)]
    want = ref.attention(*plain_in, causal=True)
    want_grads = torch.autograd.grad(want, plain_in, go.float())
    assert float((out.detach().float() - want.detach()).abs().max()) < TOL[dtype]
    for got, w in zip(grads, want_grads):
        assert got.dtype == q.dtype and float(w.abs().max()) > 0
        assert float((got.float() - w).abs().max()) < TOL[dtype]


def _rel_err(got, want) -> float:
    """Largest error relative to the largest |plain| value (at least 1)."""
    return float((got.float() - want).abs().max()) / max(1.0, float(want.abs().max()))


# bfloat16: the kernels round y to bfloat16, at most 2^-8 of |y|
SCAN_TOL = {"ssd": {"float32": 5e-5, "bfloat16": 1e-2},
            "wkv6": {"float32": 1e-4, "bfloat16": 1e-2}}


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,P,N", [
    (4, 512, 64, 64, 64),      # zamba2-1.2b's prefill
    (2, 500, 3, 32, 16),       # ragged: the last chunk is short
    (1, 37, 8, 32, 16),        # under one chunk (reduced zamba2's widths)
    (2, 128, 2, 16, 64), (1, 1, 4, 8, 8),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_kernel_vs_plain(hopper, B, S, H, P, N, dtype, with_state):
    args, st0 = _ssd_args(B, S, H, P, N, TDT[dtype], "cuda")
    st0 = st0 if with_state else None
    n = SSD.launches
    y, st = SSD.ssd(*args, init_state=st0, return_state=True)
    y2, st2 = SSD.ssd(*args, init_state=st0, return_state=True)
    assert SSD.launches == n + 2
    want, wst = ref.ssd(*(a.float() for a in args), init_state=st0, return_state=True)
    assert y.dtype == TDT[dtype] and st.dtype == torch.float32
    assert _rel_err(y, want) < SCAN_TOL["ssd"][dtype]
    assert _rel_err(st, wst) < SCAN_TOL["ssd"][dtype]
    assert torch.equal(y, y2) and torch.equal(st, st2)    # no atomics: the same bits


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,D", [
    (4, 512, 32, 64),          # rwkv6-1.6b's prefill
    (2, 500, 3, 32),           # ragged: the last tile is short
    (1, 12, 4, 32), (2, 96, 1, 16), (1, 70, 2, 128), (1, 1, 2, 64),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
def test_wkv6_kernel_vs_plain(hopper, B, S, H, D, dtype, with_state):
    args, st0 = _wkv_args(B, S, H, D, TDT[dtype], "cuda")
    st0 = st0 if with_state else None
    n = WKV.launches
    y, st = WKV.wkv6(*args, init_state=st0, return_state=True)
    y2, st2 = WKV.wkv6(*args, init_state=st0, return_state=True)
    assert WKV.launches == n + 2
    want, wst = ref.wkv6(*(a.float() for a in args), init_state=st0, return_state=True)
    assert y.dtype == TDT[dtype] and st.dtype == torch.float32
    assert _rel_err(y, want) < SCAN_TOL["wkv6"][dtype]
    assert _rel_err(st, wst) < SCAN_TOL["wkv6"][dtype]
    assert torch.equal(y, y2) and torch.equal(st, st2)


@pytest.mark.gpu
def test_scan_kernels_raise_under_autograd(hopper):
    args, _ = _ssd_args(1, 8, 2, 8, 8, device="cuda")
    x = args[0].clone().requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        SSD.ssd(x, *args[1:])
    args, _ = _wkv_args(1, 8, 2, 16, device="cuda")
    u = args[4].clone().requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        WKV.wkv6(*args[:4], u)
    with torch.no_grad():                   # serving: no gradient wanted
        WKV.wkv6(*args[:4], u)


@pytest.mark.gpu
def test_scan_ops_refuse_the_plain_version_on_cuda(hopper):
    args, _ = _ssd_args(1, 8, 2, 8, 8, device="cuda")
    with pytest.raises(ValueError, match="CPU tensors only"):
        ops.ssd(*args, impl="xla")
    args, _ = _wkv_args(1, 8, 2, 16, device="cuda")
    with pytest.raises(ValueError, match="CPU tensors only"):
        ops.wkv6(*args, impl="ref")
