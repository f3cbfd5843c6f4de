"""The port's SSM families (mamba2/zamba2 and rwkv6) against the reference
package's, on the CPU.

The scans: the port's plain versions (``ref.ssd``, ``ref.wkv6``, which its
kernel wrappers take for CPU tensors) and decode steps against the
reference's sequential oracles and its Pallas kernels in interpret mode, on
the shape grid of tests/test_kernels.py with that file's tolerances (5e-5
SSD, 1e-4 WKV6, float32).  The models: reduced zamba2-1.2b and rwkv6-1.6b,
parameters from the reference's ``init_params`` carried over as numpy, prefill
and 8 greedy decode steps against ``M.prefill``/``M.decode_step`` with
``impl="xla"`` (the reference's sequential oracles; its "auto" path sends
prefills over 64 tokens to the chunked XLA scans, which overflow, see the
last tests), atol 1e-4 on float32 logits and equal tokens.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.configs.base import get_config as jax_get_config, reduced as jax_reduced
from repro.kernels import ref as jref
from repro.kernels._rwkv6_pallas import wkv6_pallas
from repro.kernels._ssd_pallas import ssd_pallas
from repro.kernels.rwkv6_scan import wkv6_chunked_xla, wkv6_step as jax_wkv6_step
from repro.kernels.ssd_scan import ssd_chunked_xla, ssd_step as jax_ssd_step
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import rwkv as JR
from repro.models import ssm as JS
from repro.utils.tree import flatten_with_names as jax_flatten
from repro_torch.configs.base import get_config, reduced
from repro_torch.kernels import ops, ref
from repro_torch.kernels.rwkv6_scan import wkv6_step
from repro_torch.kernels.ssd_scan import ssd_step
from repro_torch.launch import serve
from repro_torch.models import model as M
from repro_torch.models import rwkv as R
from repro_torch.models import ssm as S
from repro_torch.utils.tree import flatten_with_names, tree_map
from test_torch_kernels import (assert_scan_bf16_close, rwkv6_decay_init_inputs,
                                ssd_np_inputs, tc_ssd_model, tc_wkv6_model, wkv6_np_inputs,
                                zamba2_like_ssd_inputs)

ARCHS = ["zamba2-1.2b", "rwkv6-1.6b"]
SSD_TOL, WKV_TOL, MODEL_ATOL = 5e-5, 1e-4, 1e-4


def _t(*arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


def _j(*arrs):
    return [jnp.asarray(a) for a in arrs]


def _err(got, want) -> float:
    return float(np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32)).max())


# ---- the scans -----------------------------------------------------------------

@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (2, 128, 3, 32, 16, 32), (1, 256, 2, 16, 64, 64), (2, 64, 4, 8, 8, 16),
])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_vs_reference_oracle_and_pallas(rng, B, S, H, P, N, chunk, with_state):
    args, st0 = ssd_np_inputs(rng, B, S, H, P, N)
    st0 = st0 if with_state else None
    want, wst = jref.ssd(*_j(*args), init_state=None if st0 is None else jnp.asarray(st0),
                         return_state=True)
    pal, pst = ssd_pallas(*_j(*args), chunk=chunk, return_state=True, interpret=True,
                          init_state=None if st0 is None else jnp.asarray(st0))
    got, gst = ops.ssd(*_t(*args), chunk=chunk, return_state=True,
                       init_state=None if st0 is None else torch.from_numpy(st0))
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, S, H, P)
    assert gst.dtype == torch.float32 and tuple(gst.shape) == (B, H, P, N)
    for y, s in ((want, wst), (pal, pst)):
        assert _err(got, y) < SSD_TOL and _err(gst, s) < SSD_TOL
    assert torch.equal(ops.ssd(*_t(*args), chunk=chunk, impl="ref",
                               init_state=None if st0 is None else torch.from_numpy(st0)),
                       got)


@pytest.mark.parametrize("B,S,H,Dh,chunk", [
    (2, 128, 3, 32, 32), (1, 64, 2, 64, 16), (2, 96, 1, 16, 32),
])
@pytest.mark.parametrize("with_state", [False, True])
def test_wkv6_vs_reference_oracle_and_pallas(rng, B, S, H, Dh, chunk, with_state):
    args, st0 = wkv6_np_inputs(rng, B, S, H, Dh)
    st0 = st0 if with_state else None
    want, wst = jref.wkv6(*_j(*args), init_state=None if st0 is None else jnp.asarray(st0),
                          return_state=True)
    pal, pst = wkv6_pallas(*_j(*args), chunk=chunk, return_state=True, interpret=True,
                           init_state=None if st0 is None else jnp.asarray(st0))
    got, gst = ops.wkv6(*_t(*args), chunk=chunk, return_state=True,
                        init_state=None if st0 is None else torch.from_numpy(st0))
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, S, H, Dh)
    assert gst.dtype == torch.float32 and tuple(gst.shape) == (B, H, Dh, Dh)
    for y, s in ((want, wst), (pal, pst)):
        assert _err(got, y) < WKV_TOL and _err(gst, s) < WKV_TOL


def test_ssd_step_vs_reference(rng):
    B, S_, H, P, N = 2, 16, 2, 8, 8
    args, st0 = ssd_np_inputs(rng, B, S_, H, P, N)
    x, dt, Al, Bm, Cm, D = args
    sj, st = jnp.asarray(st0), torch.from_numpy(st0)
    for t in range(S_):
        yj, sj = jax_ssd_step(*_j(x[:, t], dt[:, t], Al, Bm[:, t], Cm[:, t], D), sj)
        yt, st = ssd_step(*_t(x[:, t], dt[:, t], Al, Bm[:, t], Cm[:, t], D), st)
        assert _err(yt, yj) < SSD_TOL
    assert _err(st, sj) < SSD_TOL
    # the steps and the scan agree
    ys, sscan = ref.ssd(*_t(*args), init_state=torch.from_numpy(st0), return_state=True)
    assert _err(st, sscan) < SSD_TOL and _err(yt, ys[:, -1]) < SSD_TOL


def test_wkv6_step_vs_reference(rng):
    B, S_, H, Dh = 1, 12, 2, 16
    args, st0 = wkv6_np_inputs(rng, B, S_, H, Dh)
    r, k, v, w, u = args
    sj, st = jnp.asarray(st0), torch.from_numpy(st0)
    outs = []
    for t in range(S_):
        yj, sj = jax_wkv6_step(*_j(r[:, t], k[:, t], v[:, t], w[:, t], u), sj)
        yt, st = wkv6_step(*_t(r[:, t], k[:, t], v[:, t], w[:, t], u), st)
        assert _err(yt, yj) < WKV_TOL
        outs.append(yt)
    assert _err(st, sj) < WKV_TOL
    ys, sscan = ref.wkv6(*_t(*args), init_state=torch.from_numpy(st0), return_state=True)
    assert _err(torch.stack(outs, 1), ys) < WKV_TOL and _err(st, sscan) < WKV_TOL


def test_scans_take_an_empty_sequence():
    args, st0 = ssd_np_inputs(np.random.default_rng(0), 1, 0, 2, 4, 4)
    y, st = ops.ssd(*_t(*args), init_state=torch.from_numpy(st0), return_state=True)
    assert tuple(y.shape) == (1, 0, 2, 4) and torch.equal(st, torch.from_numpy(st0))
    args, st0 = wkv6_np_inputs(np.random.default_rng(0), 1, 0, 2, 16)
    y, st = ops.wkv6(*_t(*args), init_state=torch.from_numpy(st0), return_state=True)
    assert tuple(y.shape) == (1, 0, 2, 16) and torch.equal(st, torch.from_numpy(st0))


# ---- the blocks ------------------------------------------------------------------

def _spec_params(spec_j, seed):
    tree = jax.tree_util.tree_map(np.asarray, JL.materialize(spec_j, jax.random.PRNGKey(seed)))
    return tree, tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


@pytest.mark.parametrize("S_len", [5, 40])
def test_mamba2_block_vs_reference(S_len):
    cfg_j = jax_reduced(jax_get_config("zamba2-1.2b"))
    cfg = reduced(get_config("zamba2-1.2b"))
    pj, pt = _spec_params(JS.mamba2_spec(cfg_j), 3)
    x = np.random.default_rng(4).standard_normal((2, S_len, cfg.d_model), np.float32)
    oj, (cj, sj) = JS.mamba2_full(pj, cfg_j, jnp.asarray(x), want_state=True, impl="xla")
    ot, (ct, st) = S.mamba2_full(pt, cfg, torch.from_numpy(x), want_state=True)
    assert _err(ot, oj) < MODEL_ATOL and _err(ct, cj) < MODEL_ATOL and _err(st, sj) < MODEL_ATOL
    x1 = np.random.default_rng(5).standard_normal((2, 1, cfg.d_model), np.float32)
    oj, (cj, sj) = JS.mamba2_decode(pj, cfg_j, jnp.asarray(x1), cj, sj)
    ot, (ct, st) = S.mamba2_decode(pt, cfg, torch.from_numpy(x1), ct, st)
    assert _err(ot, oj) < MODEL_ATOL and _err(ct, cj) < MODEL_ATOL and _err(st, sj) < MODEL_ATOL


@pytest.mark.parametrize("S_len", [5, 40])
def test_rwkv6_time_and_channel_mix_vs_reference(S_len):
    cfg_j = jax_reduced(jax_get_config("rwkv6-1.6b"))
    cfg = reduced(get_config("rwkv6-1.6b"))
    tj, tt = _spec_params(JR.time_mix_spec(cfg_j), 6)
    cj_p, ct_p = _spec_params(JR.channel_mix_spec(cfg_j), 7)
    x = np.random.default_rng(8).standard_normal((2, S_len, cfg.d_model), np.float32)
    oj, (xj, wj) = JR.time_mix_full(tj, cfg_j, jnp.asarray(x), want_state=True, impl="xla")
    ot, (xt, wt) = R.time_mix_full(tt, cfg, torch.from_numpy(x), want_state=True)
    assert _err(ot, oj) < MODEL_ATOL and _err(xt, xj) < MODEL_ATOL and _err(wt, wj) < MODEL_ATOL
    mj, xcj = JR.channel_mix(cj_p, cfg_j, jnp.asarray(x), want_state=True)
    mt, xct = R.channel_mix(ct_p, cfg, torch.from_numpy(x), want_state=True)
    assert _err(mt, mj) < MODEL_ATOL and _err(xct, xcj) < MODEL_ATOL
    x1 = np.random.default_rng(9).standard_normal((2, 1, cfg.d_model), np.float32)
    oj, (xj, wj) = JR.time_mix_decode(tj, cfg_j, jnp.asarray(x1), xj, wj)
    ot, (xt, wt) = R.time_mix_decode(tt, cfg, torch.from_numpy(x1), xt, wt)
    assert _err(ot, oj) < MODEL_ATOL and _err(xt, xj) < MODEL_ATOL and _err(wt, wj) < MODEL_ATOL
    mj = JR.channel_mix(cj_p, cfg_j, jnp.asarray(x1), x_prev0=xcj)
    mt = R.channel_mix(ct_p, cfg, torch.from_numpy(x1), x_prev0=xct)
    assert _err(mt, mj) < MODEL_ATOL


# ---- the models -------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_trees():
    """The reference's reduced parameter trees, as numpy, made once."""
    out = {}
    for arch in ARCHS:
        cfg_j = jax_reduced(jax_get_config(arch))
        out[arch] = (cfg_j, jax.tree_util.tree_map(
            np.asarray, JM.init_params(cfg_j, jax.random.PRNGKey(0))))
    return out


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("prompt_len", [12, 80])     # 80 is ragged against ssm_chunk 32
def test_prefill_and_greedy_decode_match_reference(jax_trees, arch, prompt_len):
    cfg_j, tree = jax_trees[arch]
    cfg = reduced(get_config(arch))
    model = M.params_from_numpy(cfg, tree, "cpu")
    params_j = jax.tree_util.tree_map(jnp.asarray, tree)
    B, max_seq, steps = 2, prompt_len + 16, 8
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, prompt_len)).astype(np.int32)

    lj, cache_j = JM.prefill(params_j, cfg_j, {"tokens": jnp.asarray(tokens)}, max_seq,
                             impl="xla")
    lt, cache_t = M.prefill(model, cfg, {"tokens": torch.from_numpy(tokens)}, max_seq)
    assert [n for n, _ in jax_flatten(cache_j)] == [n for n, _ in flatten_with_names(cache_t)]
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0, atol=MODEL_ATOL)

    tok_j = jnp.argmax(lj, axis=-1).astype(jnp.int32)
    tok_t = lt.argmax(-1).to(torch.int32)
    for _ in range(steps):
        np.testing.assert_array_equal(tok_t.numpy(), np.asarray(tok_j))
        lj, cache_j = JM.decode_step(params_j, cfg_j, tok_j, cache_j, impl="xla")
        lt, cache_t = M.decode_step(model, cfg, tok_t, cache_t)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0, atol=MODEL_ATOL)
        tok_j = jnp.argmax(lj, axis=-1).astype(jnp.int32)
        tok_t = lt.argmax(-1).to(torch.int32)
    np.testing.assert_array_equal(tok_t.numpy(), np.asarray(tok_j))
    assert int(cache_t["t"]) == prompt_len + steps == int(cache_j["t"])
    for (n, a), (_, b) in zip(jax_flatten(cache_j), flatten_with_names(cache_t)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=MODEL_ATOL,
                                   err_msg=n)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_numpy_carries_the_reference_tree(jax_trees, arch):
    _, tree = jax_trees[arch]
    cfg = reduced(get_config(arch))
    model = M.params_from_numpy(cfg, tree, "cpu")
    got = dict(flatten_with_names(M.params_tree(model)))
    want = dict(jax_flatten(tree))
    assert sorted(got) == sorted(want)
    for n, a in want.items():
        assert torch.equal(got[n], torch.from_numpy(np.array(a))), n
    names = {n.replace(".", "/") for n, _ in model.named_parameters()}
    assert names == set(want)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_params_match_reference_on_meta(arch):
    cfg = get_config(arch)
    got = flatten_with_names(M.abstract_params(cfg))
    want = jax_flatten(JM.abstract_params(jax_get_config(arch)))
    assert [n for n, _ in got] == [n for n, _ in want]
    for (n, t), (_, s) in zip(got, want):
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(s.shape), n
        assert str(t.dtype).removeprefix("torch.") == str(s.dtype), n
    assert cfg.param_count() == jax_get_config(arch).param_count()


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_tree_matches_reference_cache_specs(arch):
    """Paths, shapes and dtypes of the full-width cache, so a snapshot has the
    same names in both packages."""
    cfg = get_config(arch)
    want, _ = JM.cache_specs(jax_get_config(arch), 4, 1024)
    got = M.cache_specs(cfg, 4, 1024)

    def leaves(spec, path=()):
        for k in sorted(spec):
            v = spec[k]
            if isinstance(v, dict):
                yield from leaves(v, path + (k,))
            else:
                yield "/".join(path + (k,)), tuple(v[0]), v[1]

    assert list(leaves(got)) == [(n, tuple(s.shape), str(s.dtype)) for n, s in jax_flatten(want)]
    small = M.init_cache(reduced(cfg), 2, 16, "cpu")
    want_small, _ = JM.cache_specs(jax_reduced(jax_get_config(arch)), 2, 16)
    assert ([(n, tuple(t.shape), str(t.dtype).removeprefix("torch."))
             for n, t in flatten_with_names(small)]
            == [(n, tuple(s.shape), str(s.dtype)) for n, s in jax_flatten(want_small)])


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_snapshot_migrate_restore_matches(tmp_path, capsys, arch):
    rc = serve.main(["--arch", arch, "--reduced", "--snapshot-at", "4",
                     "--ckpt-dir", str(tmp_path), "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "continuation MATCHES" in out


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_snapshot_holds_the_nested_cache_and_fp32_states(tmp_path, arch):
    args = serve.parse_args(["--arch", arch, "--reduced", "--batch", "2", "--prompt-len", "7",
                             "--gen", "6", "--max-seq", "16", "--snapshot-at", "3",
                             "--ckpt-dir", str(tmp_path), "--device", "cpu"])
    rep = serve.run(args)
    assert rep["match"] is True and rep["logits_finite"]
    cache = M.init_cache(reduced(get_config(arch)), 2, 16, "cpu")
    names = [n for n, _ in flatten_with_names(cache)]
    assert any(n.endswith(("ssm", "wkv")) for n in names)
    assert all(t.dtype == torch.float32 for n, t in flatten_with_names(cache)
               if n.endswith(("ssm", "wkv")))
    want = sum(t.numel() * t.element_size() for _, t in flatten_with_names(cache))
    assert rep["snapshot_bytes"] == want + 2 * 4          # + the last tokens


def test_zamba2_plan_has_groups_and_a_tail():
    plan = M.layer_plan(get_config("zamba2-1.2b"))
    assert [(s.kind, s.count) for s in plan] == [("zamba_group", 6), ("mamba2", 2)]
    assert [(s.kind, s.count) for s in M.layer_plan(get_config("rwkv6-1.6b"))] == [("rwkv6", 24)]


# ---- the reference's chunked scans overflow where the port's do not -----------------

def test_reference_wkv6_pallas_overflows_at_rwkv6_decay_init_port_does_not():
    """The TPU kernel's chunk-128 factorisation k * exp(-cw) overflows; the
    port's recurrence stays finite and on the sequential oracle."""
    args = rwkv6_decay_init_inputs()
    pal = np.asarray(wkv6_pallas(*_j(*args), chunk=128, interpret=True))
    assert not np.isfinite(pal).all()
    assert not np.isfinite(np.asarray(wkv6_chunked_xla(*_j(*args), chunk=128))).all()
    want, wst = jref.wkv6(*_j(*args), return_state=True)
    got, gst = ops.wkv6(*_t(*args), return_state=True)
    assert torch.isfinite(got).all() and torch.isfinite(gst).all()
    assert _err(got, want) < WKV_TOL and _err(gst, wst) < WKV_TOL


def test_reference_ssd_chunked_xla_overflows_at_zamba2_init_port_does_not():
    """exp(cA_i - cA_j) times a 0/1 mask overflows in the reference's XLA
    chunked form (chunk 256); the port's scan stays finite and on the
    sequential oracle."""
    args = zamba2_like_ssd_inputs()
    assert not np.isfinite(np.asarray(ssd_chunked_xla(*_j(*args), chunk=256))).all()
    want, wst = jref.ssd(*_j(*args), return_state=True)
    got, gst = ops.ssd(*_t(*args), chunk=256, return_state=True)
    assert torch.isfinite(got).all() and torch.isfinite(gst).all()
    assert _err(got, want) < SSD_TOL and _err(gst, wst) < SSD_TOL


def _bf16(*arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16) for a in arrs]


def test_tensor_core_wkv6_model_at_rwkv6_decay_init_stays_finite():
    """The bfloat16 kernel's chunked form (products of w within 16-token
    chunks, every factor <= 1), modelled in tests/test_torch_kernels.py, where
    the reference's chunk-128 forms are NaN: finite and on the sequential
    oracle within the bfloat16 limits."""
    r, k, v, w, u = rwkv6_decay_init_inputs()
    tens = _bf16(r, k, v, w)
    pal = np.asarray(wkv6_pallas(*_j(*(t.float().numpy() for t in tens), u), chunk=128,
                                 interpret=True))
    assert np.isnan(pal).mean() > 0.4           # the reference's form on the same values
    got, gst = tc_wkv6_model(*tens, torch.from_numpy(u))
    want, wst = (torch.from_numpy(np.array(a, np.float32)) for a in jref.wkv6(
        *_j(*(t.float().numpy() for t in tens), u), return_state=True))
    assert_scan_bf16_close("wkv6", got, gst, want, wst)


def test_tensor_core_ssd_model_at_zamba2_init_stays_finite():
    """The bfloat16 SSD kernel's form (scores exponentiated for j <= i only),
    modelled in tests/test_torch_kernels.py, where the reference's chunked XLA
    form is NaN: finite and on the sequential oracle within the bfloat16
    limits."""
    x, dt, Al, Bm, Cm, D = zamba2_like_ssd_inputs()
    x, dt, Bm, Cm = _bf16(x, dt, Bm, Cm)
    xn, dtn, Bn, Cn = (t.float().numpy() for t in (x, dt, Bm, Cm))
    vals = [xn, dtn, Al, Bn, Cn, D]
    chunked = np.asarray(ssd_chunked_xla(*_j(*vals), chunk=256))
    assert np.isnan(chunked).mean() > 0.5
    got, gst = tc_ssd_model(x, dt, torch.from_numpy(Al), Bm, Cm, torch.from_numpy(D))
    want, wst = (torch.from_numpy(np.array(a, np.float32))
                 for a in jref.ssd(*_j(*vals), return_state=True))
    assert_scan_bf16_close("ssd", got, gst, want, wst)
