"""The port's checkpoint plane against the reference package's.

A checkpoint written by one package restores in the other byte for byte, in
the shard formats v1 and v2 and the chunked delta plane (v3), with a
bfloat16 leaf among the float32 and int32 ones; headers, manifests and
chunk files name the same dtypes and hold the same bytes.
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.checkpoint.manager import CheckpointManager as RefManager
from repro.checkpoint.manager import CheckpointPolicy as RefPolicy
from repro.checkpoint.store import TieredStore as RefStore
from repro.utils.tree import flatten_with_names as ref_flatten
from repro_torch.checkpoint import serialization as SER
from repro_torch.checkpoint.manager import CheckpointManager, CheckpointPolicy
from repro_torch.checkpoint.store import TieredStore
from repro_torch.configs.base import get_config, reduced
from repro_torch.models import model as M
from repro_torch.serve.engine import Engine
from repro_torch.utils.tree import flatten_with_names, tree_map, unflatten_like

POLICIES = {"v2": {}, "v1": {"shard_format": 1}, "v3": {"delta": True, "chunk_bytes": 4096}}


def _snapshot() -> dict:
    """A half-generated serving batch of reduced qwen2 with a bfloat16 cache,
    plus the (float32) parameters it serves."""
    cfg = reduced(get_config("qwen2-0.5b")).replace(compute_dtype="bfloat16")
    model = M.init_params(cfg, 0, "cpu")
    eng = Engine(cfg, model, batch=2, max_seq=32)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    eng.prefill({"tokens": torch.from_numpy(tokens)})
    eng.generate(3)
    return {**eng.snapshot(), "params": M.params_tree(model)}


def _as_reference_host(tree):
    """The port's tree as the reference package holds it on the host: numpy,
    with bfloat16 in ml_dtypes' type."""
    def conv(t):
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype(jnp.bfloat16))
        return t.numpy()
    return tree_map(conv, tree)


def _bytes(tree) -> dict:
    return {n: (str(SER.dtype_name(np.asarray(a).dtype)), tuple(np.shape(a)),
                np.ascontiguousarray(a).tobytes()) for n, a in ref_flatten(tree)}


def _data_files(root: Path) -> dict:
    """Every shard and chunk file under ``root``, by its path without the
    replica's node directory (replicas land on random nodes), with the set of
    contents its replicas hold.  Manifests and worker parts carry timings, so
    they are compared by their entries instead."""
    out: dict = {}
    for p in sorted(root.rglob("*")):
        if p.is_file() and p.suffix != ".json":
            key = re.sub(r"/node\d+/", "/", str(p.relative_to(root)))
            out.setdefault(key, set()).add(p.read_bytes())
    return out


def _entries(manifest: dict) -> dict:
    keep = ("dtype", "shape", "crc32", "nbytes")
    return {e["path"]: {k: e.get(k) for k in keep} for e in manifest["leaves"]}


def test_tree_names_and_order_match_reference():
    tree = {"zeta": [np.zeros(1), (np.ones(2), None, {"b": 1, "a": np.int32(2)})],
            "alpha": {"y": np.zeros(3), "x": {"q": [], "p": np.zeros(())}},
            "mid": (np.zeros(4),)}
    assert [n for n, _ in flatten_with_names(tree)] == [n for n, _ in ref_flatten(tree)]
    snap = _snapshot()
    assert ([n for n, _ in flatten_with_names(snap)]
            == [n for n, _ in ref_flatten(_as_reference_host(snap))])
    named = dict(flatten_with_names(tree))
    assert [n for n, _ in flatten_with_names(unflatten_like(tree, named))] == list(named)


def test_bfloat16_host_round_trip_keeps_bits_and_shape():
    x = torch.randn(3, 5).to(torch.bfloat16)
    for t in (x, x[0, 0].clone(), torch.tensor(7, dtype=torch.int32)):
        h = SER.host_array(t)
        back = SER.to_torch(h)
        assert back.dtype == t.dtype and back.shape == t.shape and torch.equal(back, t)
    assert SER.dtype_name(SER.host_array(x).dtype) == "bfloat16"
    ml = x.view(torch.int16).numpy().view(np.dtype(jnp.bfloat16))
    assert torch.equal(SER.to_torch(ml), x)


@pytest.mark.parametrize("fmt", sorted(POLICIES))
def test_port_checkpoint_restores_in_reference(tmp_path, fmt):
    snap = _snapshot()
    mgr = CheckpointManager(TieredStore(tmp_path / "port"), CheckpointPolicy(**POLICIES[fmt]))
    mgr.save(1, snap)
    mgr.commit(1)
    port_manifest = mgr.read_manifest(1)
    mgr.close()

    ref_host = _as_reference_host(snap)
    rmgr = RefManager(RefStore(tmp_path / "port"), RefPolicy(**POLICIES[fmt]))
    restored, _ = rmgr.restore(ref_host)
    rmgr.close()
    assert _bytes(restored) == _bytes(ref_host)
    assert str(np.asarray(restored["cache"]["seg0"]["k"]).dtype) == "bfloat16"

    # the same tree written by the reference: same files, same manifest entries
    wmgr = RefManager(RefStore(tmp_path / "ref"), RefPolicy(**POLICIES[fmt]))
    wmgr.save(1, ref_host)
    wmgr.commit(1)
    ref_manifest = wmgr.read_manifest(1)
    wmgr.close()
    assert _entries(port_manifest) == _entries(ref_manifest)
    assert _entries(port_manifest)["cache/seg0/k"]["dtype"] == "bfloat16"
    assert _data_files(tmp_path / "port") == _data_files(tmp_path / "ref")


@pytest.mark.parametrize("fmt", sorted(POLICIES))
def test_reference_checkpoint_restores_in_port(tmp_path, fmt):
    snap = _snapshot()
    ref_host = _as_reference_host(snap)
    rmgr = RefManager(RefStore(tmp_path), RefPolicy(**POLICIES[fmt]))
    rmgr.save(5, ref_host)
    rmgr.commit(5)
    rmgr.close()

    mgr = CheckpointManager(TieredStore(tmp_path), CheckpointPolicy(**POLICIES[fmt]))
    restored, manifest = mgr.restore(snap)
    mgr.close()
    assert manifest["step"] == 5
    assert _bytes(restored) == _bytes(ref_host)
    back = tree_map(SER.to_torch, restored)
    for (n, a), (_, b) in zip(flatten_with_names(back), flatten_with_names(snap)):
        assert a.dtype == b.dtype and torch.equal(a, b), n


def test_device_fingerprints_wait_for_their_kernel(tmp_path):
    with pytest.raises(NotImplementedError, match="fingerprint kernel"):
        CheckpointManager(TieredStore(tmp_path),
                          CheckpointPolicy(delta=True, device_fp=True))
