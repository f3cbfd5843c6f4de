"""Ring and blockwise attention of the port against the reference's.

1. ``xla_attention.causal_blockwise`` against the reference's at ragged
   shapes (float32, 2e-5: the attention tolerance of tests/test_kernels.py).
2. An 8-rank (2, 4) gloo ring over "model" at the reference test's three
   shapes (tests/test_ring_attention.py) against the port's ``ref.attention``
   and against the reference's own ring (an 8-device JAX subprocess, its
   inputs and outputs as .npy), within 2e-5; the gradients of sum(out^2)
   within 5e-4 of both, whole and unscaled on every rank.  In the same
   group, a train step at (2, 4) with ``impl="ring"`` reaches the ring and
   takes the default path's step.
3. ``ops.attention``'s dispatch: ``impl="ring"`` with a mesh whose "model"
   axis holds several ranks in context goes to the ring; on a mesh of one
   rank, without a mesh, or on a decode step to ``auto``; on CPU tensors
   ``xla_chunked`` and a causal ``auto`` prefill longer than 2048 tokens go
   to ``causal_blockwise``; ``ring`` is accepted for CUDA tensors.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp

from repro.kernels import xla_attention as RX
from repro_torch.kernels import ops, ref
from repro_torch.kernels import xla_attention as X
from repro_torch.launch.mesh import Mesh, make_host_mesh
from repro_torch.parallel.context import use_mesh_context
from torch_gloo import SRC, launch, last_json

TOL, GRAD_TOL = 2e-5, 5e-4
SHAPES = [(2, 64, 4, 2, 32), (4, 128, 14, 2, 16), (2, 64, 4, 4, 64)]


@pytest.mark.parametrize("B,S,H,Hkv,Dq,Dv,bq,bk", [
    (2, 70, 4, 2, 16, 8, 16, 32),       # ragged against both blocks
    (1, 33, 6, 3, 32, 32, 8, 8),
    (2, 100, 4, 1, 16, 16, 32, 16),     # more k-blocks than q-blocks
    (1, 17, 2, 2, 8, 8, 1024, 1024),    # one block, smaller than its size
])
def test_causal_blockwise_matches_reference(B, S, H, Hkv, Dq, Dv, bq, bk):
    rng = np.random.default_rng(S)
    q = rng.standard_normal((B, S, H, Dq), np.float32)
    k = rng.standard_normal((B, S, Hkv, Dq), np.float32)
    v = rng.standard_normal((B, S, Hkv, Dv), np.float32)
    want = np.asarray(RX.causal_blockwise(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          block_q=bq, block_k=bk))
    got = X.causal_blockwise(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                             block_q=bq, block_k=bk).numpy()
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) < TOL
    plain = ref.attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          causal=True).numpy()
    assert float(np.abs(got - plain).max()) < TOL


# ---------------------------------------------------------------------------
# 2. the ring on 8 gloo ranks against the reference's ring on 8 JAX devices
# ---------------------------------------------------------------------------

_JAX_RING = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from repro.kernels.ring_attention import ring_attention
out_dir = sys.argv[1]
mesh = jax.make_mesh((2, 4), ("data", "model"))
rng = np.random.default_rng(0)
for i, (B, S, H, Hkv, D) in enumerate(%r):
    q = rng.standard_normal((B, S, H, D), np.float32)
    k = rng.standard_normal((B, S, Hkv, D), np.float32)
    v = rng.standard_normal((B, S, Hkv, D), np.float32)
    with mesh:
        out = jax.jit(lambda q, k, v: ring_attention(q, k, v, mesh=mesh))(q, k, v)
        g = jax.jit(jax.grad(lambda q, k, v: jnp.sum(ring_attention(q, k, v, mesh=mesh) ** 2),
                             argnums=(0, 1, 2)))(q, k, v)
    for name, x in zip(("q", "k", "v", "out", "gq", "gk", "gv"), (q, k, v, out) + tuple(g)):
        np.save(os.path.join(out_dir, f"{name}{i}.npy"), np.asarray(x))
print("SAVED")
"""

_PORT_RING = """
from repro_torch.kernels import ref
from repro_torch.kernels.ring_attention import ring_attention
from repro_torch.launch.mesh import make_mesh

d = ARGS[0]
mesh = make_mesh((2, 4))
report = []
for i in range(int(ARGS[1])):
    load = lambda n: torch.from_numpy(np.load(os.path.join(d, f"{n}{i}.npy")))
    q, k, v = (load(n).requires_grad_(True) for n in ("q", "k", "v"))
    out = ring_attention(q, k, v, mesh=mesh)
    (torch.sum(out ** 2)).backward()
    qp, kp, vp = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    plain = ref.attention(qp, kp, vp, causal=True)
    (torch.sum(plain ** 2)).backward()
    err = lambda a, b: float((a.detach() - b.detach()).abs().max())
    report.append({
        "out_vs_plain": err(out, plain), "out_vs_reference": err(out, load("out")),
        "grad_vs_plain": max(err(a.grad, b.grad) for a, b in ((q, qp), (k, kp), (v, vp))),
        "grad_vs_reference": max(err(a.grad, load(n)) for a, n in ((q, "gq"), (k, "gk"),
                                                                    (v, "gv"))),
        "grad_max": max(float(x.grad.abs().max()) for x in (q, k, v))})

# a train step at (2, 4): the step installs its mesh, so impl="ring" reaches the
# ring (one call a layer, in the forward), and it takes the default path's step
from repro_torch.configs.base import get_config, reduced
from repro_torch.core.virtualization import fetch_tree, place_tree
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.kernels import ops
from repro_torch.optim import adamw
from repro_torch.parallel.mesh_rules import Rules
from repro_torch.train import step as TS

cfg = reduced(get_config("qwen2-0.5b")).replace(num_layers=2)
oc = adamw.OptConfig()
rules = Rules(mesh)
batch = {k: torch.from_numpy(v) for k, v in SyntheticTokens(cfg, 2, 16).batch_at(0).items()}
host = fetch_tree(TS.init_train_state(cfg, oc, 0, "cpu"))
calls = []
ops.ring_attention = lambda *a, **kw: calls.append(1) or ring_attention(*a, **kw)
train = {}
for impl in ("ring", None):
    state = place_tree(host, TS.state_logical_axes(cfg), rules, "cpu")
    _, m = TS.make_train_step(cfg, oc, rules=rules, impl=impl)(state, batch)
    train[impl or "auto"] = {k: float(m[k]) for k in ("loss", "grad_norm")}
train["ring_calls"] = len(calls)
print(json.dumps({"coord": list(mesh.coordinate), "cases": report, "train": train}))
"""


@pytest.fixture(scope="module")
def gloo_ring(tmp_path_factory):
    """Each rank's report of the 8-rank gloo group (``_PORT_RING``), its
    inputs and the reference's outputs written by an 8-device JAX run."""
    tmp_path = tmp_path_factory.mktemp("ring")
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu"}
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", _JAX_RING % (SHAPES,), str(tmp_path)], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0 and "SAVED" in r.stdout, r.stdout + r.stderr
    return [last_json(out) for out in launch(_PORT_RING, 8, tmp_path, tmp_path, len(SHAPES))]


def test_ring_on_eight_gloo_ranks_matches_reference_ring(gloo_ring):
    for rank, rep in enumerate(gloo_ring):
        assert rep["coord"] == [rank // 4, rank % 4]
        for shape, c in zip(SHAPES, rep["cases"]):
            assert c["out_vs_plain"] < TOL and c["out_vs_reference"] < TOL, (rank, shape, c)
            # whole and unscaled on every rank: a sum over the 4 ranks of the
            # ring would stand off by 3x the gradient itself
            assert c["grad_vs_plain"] < GRAD_TOL and c["grad_vs_reference"] < GRAD_TOL, \
                (rank, shape, c)
            assert c["grad_max"] > 100 * GRAD_TOL


# ---------------------------------------------------------------------------
# 3. ops.attention's dispatch
# ---------------------------------------------------------------------------

def _qkv(B, S, H, Hkv, D, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(B, S, H, D, generator=g), torch.randn(B, S, Hkv, D, generator=g),
            torch.randn(B, S, Hkv, D, generator=g))


def test_ring_with_a_mesh_goes_to_the_ring(monkeypatch):
    """A mesh whose "model" axis holds 2 ranks (the rules' stand-in, with no
    group: the spy stands for the ring) sends a prefill to the ring; a ring
    of one rank is attention, so the (1, 1) mesh sends it to ``auto``, as a
    decode step under either."""
    q, k, v = _qkv(2, 16, 4, 2, 8)
    seen = []

    def spy(q, k, v, **kw):
        seen.append(kw["mesh"])
        return ref.attention(q, k, v, causal=kw["causal"], scale=kw["scale"])

    monkeypatch.setattr(ops, "ring_attention", spy)
    two = Mesh((1, 2), ("data", "model"))
    with use_mesh_context(two):
        got = ops.attention(q, k, v, impl="ring")
        # a decode step falls through to auto: flash_decode's plain version
        one = ops.attention(q[:, :1], k, v, impl="ring", decode=True, kv_len=16)
    assert seen == [two]
    assert float((got - ref.attention(q, k, v, causal=True)).abs().max()) < TOL
    assert torch.equal(one, ops.attention(q[:, :1], k, v, decode=True, kv_len=16))
    with use_mesh_context(make_host_mesh()):
        single = ops.attention(q, k, v, impl="ring")
    assert seen == [two] and torch.equal(single, ops.attention(q, k, v))


def test_train_step_with_ring_runs_the_ring(gloo_ring):
    """The train step installs its mesh and rules, as the reference's does,
    so ``impl="ring"`` reaches the ring in training over the (2, 4) mesh's
    "model" axis, and its loss and gradient norm are the default path's."""
    for rank, rep in enumerate(gloo_ring):
        train = rep["train"]
        assert train["ring_calls"] == 2, rank           # one a layer, in the forward
        for k in ("loss", "grad_norm"):
            assert abs(train["ring"][k] - train["auto"][k]) <= 1e-5 * abs(train["auto"][k]), \
                (rank, k, train)


def test_ring_without_a_mesh_is_auto(monkeypatch):
    q, k, v = _qkv(2, 16, 4, 2, 8)
    monkeypatch.setattr(ops, "ring_attention", lambda *a, **kw: pytest.fail("ring called"))
    assert torch.equal(ops.attention(q, k, v, impl="ring"), ops.attention(q, k, v))


def test_long_causal_prefill_and_xla_chunked_go_blockwise(monkeypatch):
    calls = []
    real = X.causal_blockwise

    def spy(*a, **kw):
        calls.append(a[0].shape[1])
        return real(*a, **kw)

    monkeypatch.setattr(ops, "causal_blockwise", spy)
    q, k, v = _qkv(1, 2056, 1, 1, 8)
    long = ops.attention(q, k, v)                       # auto, causal, Sq > 2048
    assert calls == [2056]
    assert float((long - ref.attention(q, k, v, causal=True)).abs().max()) < TOL
    ops.attention(q, k, v, causal=False)                # not causal: the plain version
    ops.attention(q[:, :64], k[:, :64], v[:, :64])      # short: the plain version
    assert calls == [2056]
    ops.attention(q[:, :64], k[:, :64], v[:, :64], impl="xla_chunked")
    assert calls == [2056, 64]


def test_resolve_accepts_ring_for_cuda_tensors():
    cuda = torch.device("cuda")
    assert ops._resolve("ring", cuda, "attention") == "ring"
    for impl in ops.PLAIN_IMPLS:
        with pytest.raises(ValueError, match="CPU tensors only"):
            ops._resolve(impl, cuda, "attention")
