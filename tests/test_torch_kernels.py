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


# ---- the bfloat16 scans' tensor-core arithmetic, modelled on the CPU -----------

def _rb(t):
    """Round to bfloat16 and back: the kernels' rounding points."""
    return t.to(torch.bfloat16).float()


def tc_ssd_model(x, dt, A_log, Bm, Cm, D, *, init_state=None, chunk=64, p_slice=64):
    """The bfloat16 SSD kernel's arithmetic (csrc/ssd_scan.cu, ssd_tc_kernel)
    in plain torch: per slice of ``p_slice`` columns of P and per chunk of
    ``chunk`` tokens (the last one ragged), cA = cumsum(dt A) from the chunk
    start; G = C B^T in fp32; S_ij = G_ij exp(cA_i - cA_j) dt_j taken for
    j <= i only and rounded to bfloat16; y = S x + exp(cA_i) C state^T + D x
    with the state rounded to bfloat16 as an operand; w x = exp(cA_last -
    cA_j) dt_j x_j rounded to bfloat16; state = state exp(cA_last) + (w x)^T B
    in fp32.  y in x's dtype, the state in fp32.  ``p_slice`` defaults to the
    kernel's PS."""
    Bz, S, H, P = x.shape
    xf, dtf, Bf, Cf = (t.float() for t in (x, dt, Bm, Cm))
    A = -torch.exp(A_log.float())
    Df = D.float()[None, None, :, None]
    state = (torch.zeros(Bz, H, P, Bm.shape[-1]) if init_state is None
             else init_state.float().clone())
    y = torch.empty(Bz, S, H, P)
    for p0 in range(0, P, p_slice):
        st = state[:, :, p0:p0 + p_slice].clone()
        for t0 in range(0, S, chunk):
            L = min(chunk, S - t0)
            xs, d = xf[:, t0:t0 + L, :, p0:p0 + p_slice], dtf[:, t0:t0 + L]
            Bc, Cc = Bf[:, t0:t0 + L], Cf[:, t0:t0 + L]
            cA = torch.cumsum(d * A, dim=1)                                  # (B,L,H)
            G = torch.einsum("bin,bjn->bij", Cc, Bc)
            diff = cA[:, :, None] - cA[:, None, :]                           # (B,i,j,H)
            lower = torch.ones(L, L, dtype=torch.bool).tril()[None, :, :, None]
            decay = torch.exp(torch.where(lower, diff, torch.full_like(diff, -float("inf"))))
            Sm = _rb(G[..., None] * decay * d[:, None])
            yc = (torch.einsum("bijh,bjhp->bihp", Sm, xs)
                  + torch.exp(cA)[..., None] * torch.einsum("bin,bhpn->bihp", Cc, _rb(st))
                  + xs * Df)
            y[:, t0:t0 + L, :, p0:p0 + p_slice] = yc
            last = cA[:, -1]
            wx = _rb((torch.exp(last[:, None] - cA) * d)[..., None] * xs)
            st = st * torch.exp(last)[..., None, None] + torch.einsum("bjhp,bjn->bhpn", wx, Bc)
        state[:, :, p0:p0 + p_slice] = st
    return y.to(x.dtype), state


def tc_wkv6_model(r, k, v, w, u, *, init_state=None, chunk=32, sub=8, v_slice=64):
    """The bfloat16 WKV6 kernel's arithmetic (csrc/wkv6.cu, wkv6_tc_kernel) in
    plain torch: per slice of ``v_slice`` state columns and per chunk of
    ``chunk`` tokens (sub-blocks of ``sub``), w clamped at 1e-30 and cw_t =
    sum_{s<=t} log2 w_s from the chunk start.  r_dec_i = r_i 2^cw_{i-1} and
    k_carry_j = k_j 2^(cw_last - cw_j) rounded to bfloat16.  The scores A:
    inside a sub-block, A_ij = sum_k r_ik k_jk prod_{j<t<i} w_tk (j < i) and
    the bonus sum_k r_ik u_k k_ik on the diagonal, in fp32; below it, against
    sub-block J with m its last token, r~_i = r_i 2^(cw_{i-1} - cw_m) and k~_j
    = k_j 2^(cw_m - cw_j), rounded to bfloat16, and A_ij = r~_i . k~_j.  Every
    exponent is <= 0.  A rounded to bfloat16; y = A v + r_dec State with the
    state rounded to bfloat16 as an operand; State = diag(2^cw_last) State +
    k_carry^T v in fp32.  ``v_slice`` defaults to the kernel's VS (at most
    D)."""
    Bz, S, H, Dh = r.shape
    v_slice = min(v_slice, Dh)
    rf, kf, vf = (t.float() for t in (r, k, v))
    wf = torch.clamp(w.float(), min=1e-30)
    uf = u.float()
    state = (torch.zeros(Bz, H, Dh, Dh) if init_state is None
             else init_state.float().clone())
    y = torch.empty(Bz, S, H, Dh)
    for v0 in range(0, Dh, v_slice):
        st = state[..., v0:v0 + v_slice].clone()
        for t0 in range(0, S, chunk):
            L = min(chunk, S - t0)
            rc, kc, wc = rf[:, t0:t0 + L], kf[:, t0:t0 + L], wf[:, t0:t0 + L]
            vc = vf[:, t0:t0 + L, :, v0:v0 + v_slice]
            cw = torch.cumsum(torch.log2(wc), 1)                       # (B,L,H,D)
            cw_prev = torch.cat([torch.zeros_like(cw[:, :1]), cw[:, :-1]], 1)
            Am = torch.zeros(Bz, L, L, H)
            for i in range(L):
                Am[:, i, i] = (rc[:, i] * uf * kc[:, i]).sum(-1)
                dec = torch.ones_like(wc[:, 0])
                for j in range(i - 1, (i // sub) * sub - 1, -1):
                    Am[:, i, j] = (rc[:, i] * kc[:, j] * dec).sum(-1)
                    dec = dec * wc[:, j]
            for j0 in range(0, L - sub, sub):
                m = j0 + sub - 1
                ktil = _rb(kc[:, j0:m + 1] * torch.exp2(cw[:, m:m + 1] - cw[:, j0:m + 1]))
                rtil = _rb(rc[:, m + 1:] * torch.exp2(cw_prev[:, m + 1:] - cw[:, m:m + 1]))
                Am[:, m + 1:, j0:m + 1] = torch.einsum("bihk,bjhk->bijh", rtil, ktil)
            last = cw[:, -1:]
            yc = (torch.einsum("bijh,bjhv->bihv", _rb(Am), vc)
                  + torch.einsum("bihk,bhkv->bihv", _rb(rc * torch.exp2(cw_prev)), _rb(st)))
            y[:, t0:t0 + L, :, v0:v0 + v_slice] = yc
            st = (torch.exp2(last[:, 0])[..., None] * st
                  + torch.einsum("bjhk,bjhv->bhkv", _rb(kc * torch.exp2(last - cw)), vc))
        state[..., v0:v0 + v_slice] = st
    return y.to(r.dtype), state


# bfloat16 scans, element by element: |got - oracle| <= atol + rtol |oracle|
# per output, beside SCAN_TOL's 1e-2 of the output's max |oracle|.  rtol
# covers y's rounding to bfloat16; atol what the arithmetic adds (S, w x,
# r_dec, k_carry, A and the state operand rounded to bfloat16).  The CPU
# models need at most: SSD y 9.1e-3, state 1.3e-3 (B1 S512 H4 P64 N64);
# WKV6 y 3.5e-2, state 3.2e-3 (D128); about twice that is the limit.
SCAN_BF16_TOL = {"ssd": {"y": (2e-2, 1e-2), "state": (4e-3, 1e-2)},
                 "wkv6": {"y": (7e-2, 1e-2), "state": (8e-3, 1e-2)}}


def scan_bf16_errors(kind, got, gst, want, wst):
    """{output: (max err / max |oracle|, largest err - rtol |oracle|)}."""
    out = {}
    for name, a, b in (("y", got, want), ("state", gst, wst)):
        a, b = a.float(), b.float()
        err = (a - b).abs()
        rtol = SCAN_BF16_TOL[kind][name][1]
        out[name] = (float(err.max()) / max(float(b.abs().max()), 1e-30),
                     float((err - rtol * b.abs()).max()))
    return out


def assert_scan_bf16_close(kind, got, gst, want, wst):
    assert torch.isfinite(got.float()).all() and torch.isfinite(gst).all()
    for name, (rel, excess) in scan_bf16_errors(kind, got, gst, want, wst).items():
        assert rel <= 1e-2, (name, rel)
        assert excess <= SCAN_BF16_TOL[kind][name][0], (name, excess)


def _bf16_np(*arrs):
    """numpy float32 arrays rounded to bfloat16: (bf16 tensors, the same values
    as float32 numpy for the reference)."""
    ts = [torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16) for a in arrs]
    return ts, [t.float().numpy() for t in ts]


def ssd_np_inputs(rng, B, S, H, P, N):
    """tests/test_kernels.py::_mk_ssd's scales, plus an initial state."""
    x = rng.standard_normal((B, S, H, P), np.float32) * 0.5
    dt = np.abs(rng.standard_normal((B, S, H))).astype(np.float32) * 0.5
    Al = rng.standard_normal((H,)).astype(np.float32) * 0.3
    Bm = rng.standard_normal((B, S, N)).astype(np.float32) * 0.5
    Cm = rng.standard_normal((B, S, N)).astype(np.float32) * 0.5
    st0 = rng.standard_normal((B, H, P, N)).astype(np.float32) * 0.5
    return (x, dt, Al, Bm, Cm, np.ones((H,), np.float32)), st0


def wkv6_np_inputs(rng, B, S, H, Dh):
    """tests/test_kernels.py::_mk_wkv's scales, plus an initial state."""
    r, k, v = (rng.standard_normal((B, S, H, Dh), np.float32) * 0.5 for _ in range(3))
    w = rng.uniform(0.7, 0.999, (B, S, H, Dh)).astype(np.float32)
    u = rng.standard_normal((H, Dh)).astype(np.float32) * 0.3
    st0 = rng.standard_normal((B, H, Dh, Dh)).astype(np.float32) * 0.5
    return (r, k, v, w, u), st0


def rwkv6_decay_init_inputs():
    """rwkv6's decay init (w = exp(-exp(w0)), w0 ~ N(-1, 0.5)), B1 S256 H4 D64."""
    rng = np.random.default_rng(0)
    B, S_, H, D = 1, 256, 4, 64
    r, k, v = (rng.standard_normal((B, S_, H, D), np.float32) * 0.5 for _ in range(3))
    w0 = rng.standard_normal((H, D)).astype(np.float32) * 0.5 - 1.0
    w = np.broadcast_to(np.exp(-np.exp(w0)), (B, S_, H, D)).astype(np.float32)
    u = rng.standard_normal((H, D)).astype(np.float32) * 0.3
    return r, k, v, w, u


def zamba2_like_ssd_inputs():
    """zamba2-like A (A_log = log U[1,16], the ssm_a init) and dt =
    softplus(N(0, 0.5)), B1 S512 H8 P64 N64."""
    rng = np.random.default_rng(0)
    B, S_, H, P, N = 1, 512, 8, 64, 64
    x = rng.standard_normal((B, S_, H, P)).astype(np.float32) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((B, S_, H)).astype(np.float32) * 0.5))
    Al = np.log(rng.uniform(1, 16, (H,))).astype(np.float32)
    Bm, Cm = (rng.standard_normal((B, S_, N)).astype(np.float32) * 0.5 for _ in range(2))
    return x, dt.astype(np.float32), Al, Bm, Cm, np.ones((H,), np.float32)


def wkv6_clamp_inputs():
    """w at the 1e-30 clamp and at 1.0 in the same 16-token chunk, on
    alternating channels and tokens, with ordinary decays elsewhere: B1 S48 H2
    D64, an initial state."""
    (r, k, v, w, u), st0 = wkv6_np_inputs(np.random.default_rng(3), 1, 48, 2, 64)
    w = w.copy()
    w[:, 3:13, :, 0::2] = 1e-30
    w[:, 3:13, :, 1::2] = 1.0
    w[:, 20:30, :, 0::4] = 1.0
    w[:, 21:29:2, :, 1::4] = 1e-30
    return (r, k, v, w, u), st0


@pytest.fixture
def jax_scans():
    """The reference's sequential oracles and Pallas scans."""
    pytest.importorskip("jax")
    from repro.kernels import ref as jref
    from repro.kernels._rwkv6_pallas import wkv6_pallas
    from repro.kernels._ssd_pallas import ssd_pallas

    return jref, ssd_pallas, wkv6_pallas


# the reference's test shapes (tests/test_kernels.py:74, :106) with their
# Pallas chunks, and a ragged S against the kernels' chunks (the Pallas
# kernel takes a chunk that divides S)
SSD_MODEL_SHAPES = [(2, 128, 3, 32, 16, 32), (1, 256, 2, 16, 64, 64), (2, 64, 4, 8, 8, 16),
                    (2, 100, 3, 32, 16, 20)]
WKV6_MODEL_SHAPES = [(2, 128, 3, 32, 32), (1, 64, 2, 64, 16), (2, 96, 1, 16, 32),
                     (2, 100, 3, 32, 20)]


@pytest.mark.parametrize("B,S,H,P,N,chunk", SSD_MODEL_SHAPES)
@pytest.mark.parametrize("with_state", [False, True])
def test_tensor_core_ssd_numerics_vs_reference(jax_scans, rng, B, S, H, P, N, chunk,
                                               with_state):
    """The bfloat16 SSD kernel's arithmetic, modelled here on inputs rounded to
    bfloat16, against repro's sequential oracle and its Pallas scan
    (interpret mode) on the same values in float32."""
    import jax.numpy as jnp

    jref, ssd_pallas, _ = jax_scans
    args, st0 = ssd_np_inputs(rng, B, S, H, P, N)
    (x, dt, Bm, Cm), (xn, dtn, Bn, Cn) = _bf16_np(args[0], args[1], args[3], args[4])
    Al, D = args[2], args[5]
    init = torch.from_numpy(st0) if with_state else None
    got, gst = tc_ssd_model(x, dt, torch.from_numpy(Al), Bm, Cm, torch.from_numpy(D),
                            init_state=init)
    assert got.dtype == torch.bfloat16 and tuple(gst.shape) == (B, H, P, N)
    jargs = [jnp.asarray(a) for a in (xn, dtn, Al, Bn, Cn, D)]
    jinit = jnp.asarray(st0) if with_state else None
    for oracle in (jref.ssd(*jargs, init_state=jinit, return_state=True),
                   ssd_pallas(*jargs, chunk=chunk, init_state=jinit, return_state=True,
                              interpret=True)):
        want, wst = (torch.from_numpy(np.array(a, np.float32)) for a in oracle)
        assert_scan_bf16_close("ssd", got, gst, want, wst)


@pytest.mark.parametrize("B,S,H,Dh,chunk", WKV6_MODEL_SHAPES)
@pytest.mark.parametrize("with_state", [False, True])
def test_tensor_core_wkv6_numerics_vs_reference(jax_scans, rng, B, S, H, Dh, chunk,
                                                with_state):
    """The bfloat16 WKV6 kernel's arithmetic, modelled here on inputs rounded
    to bfloat16, against repro's sequential oracle and its Pallas kernel
    (interpret mode) on the same values in float32."""
    import jax.numpy as jnp

    jref, _, wkv6_pallas = jax_scans
    (r, k, v, w, u), st0 = wkv6_np_inputs(rng, B, S, H, Dh)
    tens, nps = _bf16_np(r, k, v, w)
    init = torch.from_numpy(st0) if with_state else None
    got, gst = tc_wkv6_model(*tens, torch.from_numpy(u), init_state=init)
    assert got.dtype == torch.bfloat16 and tuple(gst.shape) == (B, H, Dh, Dh)
    jargs = [jnp.asarray(a) for a in (*nps, u)]
    jinit = jnp.asarray(st0) if with_state else None
    for oracle in (jref.wkv6(*jargs, init_state=jinit, return_state=True),
                   wkv6_pallas(*jargs, chunk=chunk, init_state=jinit, return_state=True,
                               interpret=True)):
        want, wst = (torch.from_numpy(np.array(a, np.float32)) for a in oracle)
        assert_scan_bf16_close("wkv6", got, gst, want, wst)


def test_tensor_core_wkv6_numerics_at_the_clamp_and_at_one(jax_scans):
    """w at 1e-30 and at 1.0 in one chunk: the products stay finite (1e-30
    squared underflows to 0, which is harmless) and on the sequential oracle."""
    import jax.numpy as jnp

    jref = jax_scans[0]
    (r, k, v, w, u), st0 = wkv6_clamp_inputs()
    tens, nps = _bf16_np(r, k, v, w)
    got, gst = tc_wkv6_model(*tens, torch.from_numpy(u), init_state=torch.from_numpy(st0))
    want, wst = (torch.from_numpy(np.array(a, np.float32)) for a in jref.wkv6(
        *[jnp.asarray(a) for a in (*nps, u)], init_state=jnp.asarray(st0), return_state=True))
    assert_scan_bf16_close("wkv6", got, gst, want, wst)


@pytest.mark.parametrize("P,p_slice", [(64, 16), (64, 64), (40, 32)])
def test_tensor_core_ssd_model_is_the_same_at_every_slice_width(P, p_slice):
    """Each column of P is its own recurrence: the slice width changes which
    CTA computes a column, not its arithmetic."""
    args, st0 = ssd_np_inputs(np.random.default_rng(1), 1, 70, 2, P, 16)
    (x, dt, Bm, Cm), _ = _bf16_np(args[0], args[1], args[3], args[4])
    rest = dict(init_state=torch.from_numpy(st0))
    a = tc_ssd_model(x, dt, torch.from_numpy(args[2]), Bm, Cm, torch.from_numpy(args[5]),
                     p_slice=p_slice, **rest)
    b = tc_ssd_model(x, dt, torch.from_numpy(args[2]), Bm, Cm, torch.from_numpy(args[5]),
                     p_slice=P, **rest)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


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


def test_ssd_check_refuses_a_bf16_state_wider_than_the_kernel():
    args, _ = _ssd_args(1, 4, 2, 8, SSD.MAX_N_BF16 + 8, torch.bfloat16)
    with pytest.raises(ValueError, match="N up to"):
        SSD._check(*args, None)
    args, _ = _ssd_args(1, 4, 2, 8, SSD.MAX_N_BF16 + 8)      # float32: the CUDA-core kernel
    SSD._check(*args, None)


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
    (4, 512, 32, 8, 128, 128, True),   # qwen3-4b's prefill, D 128, G = 4
    (2, 300, 32, 8, 128, 128, True),
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
    (4, 1024, 32, 8, 128, 544), (4, 1024, 32, 8, 128, 65),    # qwen3-4b, D 128, G = 4
    (4, 1024, 32, 8, 128, 1024),
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
    (1, 70, 2, 80, 128),       # P over two slices, the widest N of the bf16 kernel
    (1, 130, 3, 12, 20),       # P, N not multiples of 8: the wrapper zero-pads them
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
    if dtype == "bfloat16":
        assert_scan_bf16_close("ssd", y, st, want, wst)
    assert torch.equal(y, y2) and torch.equal(st, st2)    # no atomics: the same bits


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,D", [
    (4, 512, 32, 64),          # rwkv6-1.6b's prefill
    (2, 500, 3, 32),           # ragged: the last chunk is short
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
    if dtype == "bfloat16":
        assert_scan_bf16_close("wkv6", y, st, want, wst)
    assert torch.equal(y, y2) and torch.equal(st, st2)


def _cuda_bf16(*arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16).cuda() for a in arrs]


@pytest.mark.gpu
def test_ssd_kernel_at_zamba2_init_is_finite(hopper):
    """Twin of the CPU overflow guard: zamba2's A and dt, where the
    reference's chunked XLA form overflows."""
    x, dt, Al, Bm, Cm, D = zamba2_like_ssd_inputs()
    x, dt, Bm, Cm = _cuda_bf16(x, dt, Bm, Cm)
    Al, D = torch.from_numpy(Al).cuda(), torch.from_numpy(D).cuda()
    y, st = SSD.ssd(x, dt, Al, Bm, Cm, D, return_state=True)
    want, wst = ref.ssd(x.float(), dt.float(), Al, Bm.float(), Cm.float(), D,
                        return_state=True)
    assert_scan_bf16_close("ssd", y, st, want, wst)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["rwkv6_decay_init", "clamp_and_one"])
def test_wkv6_kernel_at_extreme_decays_is_finite(hopper, case):
    """Twins of the CPU overflow guards: rwkv6's decay init, where the
    reference's chunked forms overflow, and w at 1e-30 and 1.0 in one chunk."""
    if case == "rwkv6_decay_init":
        (r, k, v, w, u), st0 = rwkv6_decay_init_inputs(), None
    else:
        (r, k, v, w, u), st0 = wkv6_clamp_inputs()
        st0 = torch.from_numpy(st0).cuda()
    r, k, v, w = _cuda_bf16(r, k, v, w)
    u = torch.from_numpy(u).cuda()
    y, st = WKV.wkv6(r, k, v, w, u, init_state=st0, return_state=True)
    want, wst = ref.wkv6(r.float(), k.float(), v.float(), w.float(), u, init_state=st0,
                         return_state=True)
    assert_scan_bf16_close("wkv6", y, st, want, wst)


@pytest.mark.gpu
def test_scan_kernels_take_views_off_a_16_byte_boundary(hopper):
    """Contiguous views that start 2 bytes in: the wrappers copy them to
    aligned buffers for the bf16 kernels' 16-byte copies; the same results."""
    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        assert view.is_contiguous() and view.data_ptr() % 16
        return view

    args, st0 = _ssd_args(1, 90, 2, 32, 16, torch.bfloat16, "cuda")
    want = SSD.ssd(*args, init_state=st0, return_state=True)
    moved = (shifted(args[0]), args[1], args[2], shifted(args[3]), shifted(args[4]), args[5])
    got = SSD.ssd(*moved, init_state=st0, return_state=True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    args, st0 = _wkv_args(1, 40, 2, 32, torch.bfloat16, "cuda")
    want = WKV.wkv6(*args, init_state=st0, return_state=True)
    got = WKV.wkv6(*(shifted(a) for a in args[:4]), args[4], init_state=st0,
                   return_state=True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


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
