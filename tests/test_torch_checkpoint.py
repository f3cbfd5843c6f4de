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


# ---------------------------------------------------------------------------
# device fingerprints (CheckpointPolicy(device_fp=True)) on torch leaves
# ---------------------------------------------------------------------------

CHUNK = 256                       # 64 words: a power of two for the kernel


def _base_tree():
    """Torch leaves (the device path's input; the plain version stands in
    for the kernel on the CPU), with the cases of tests/test_device_fp.py."""
    rng = np.random.default_rng(6)
    return {
        # 4 exact chunks: the D2H accounting below is byte-exact on it
        "a": torch.from_numpy(rng.standard_normal(CHUNK).astype(np.float32)),
        "b": torch.from_numpy(rng.standard_normal(CHUNK // 4 + 9).astype(np.float32)),
        "c": torch.from_numpy(rng.integers(0, 100, CHUNK + 7).astype(np.int8)),
        "d": torch.from_numpy(rng.standard_normal(5)),                   # float64
        "e": torch.zeros(0),                                             # zero-byte
        "f": torch.tensor(3.25),                                         # 0-d scalar
        "g": torch.from_numpy(rng.standard_normal(CHUNK // 2 + 3).astype(np.float32)
                              ).to(torch.bfloat16),
        "h": torch.from_numpy(rng.integers(0, 2, 37).astype(bool)),
        "step": torch.tensor(4, dtype=torch.int32),
    }


def _mutate_in_place(tree, elems):
    """The optimizer's way: the live leaf changes in place."""
    tree["a"][:elems] += 1.0
    return tree


def _payload(m):
    return {"step": m["step"], "leaves": m["leaves"]}


def _save_chain(root, device_fp):
    store = TieredStore(root, seed=0)
    mgr = CheckpointManager(store, CheckpointPolicy(
        replicas=1, delta=True, chunk_bytes=CHUNK, fingerprint=True, device_fp=device_fp))
    tree = _base_tree()
    parts, manifests, snapshots = [], [], []
    for s, elems in ((1, 0), (2, 96), (3, 40)):
        if elems:
            _mutate_in_place(tree, elems)
        parts.append(mgr.save(s, tree))
        mgr.commit(s)
        manifests.append(_payload(mgr.read_manifest(s)))
        snapshots.append(_bytes(tree_map(SER.host_array, tree)))
    restored = [_bytes(mgr.restore(tree, s)[0]) for s in (1, 2, 3)]
    digests = store.chunk_digests("shared", "ckpt")
    mgr.close()
    return parts, manifests, restored, snapshots, digests


def test_device_save_chain_bit_identical_to_host(tmp_path):
    h_parts, h_man, h_res, h_snap, h_dig = _save_chain(tmp_path / "host", False)
    d_parts, d_man, d_res, d_snap, d_dig = _save_chain(tmp_path / "dev", True)

    # identical chunk stores, manifests and restores; and every restore is the
    # tree as it was at its save, though the leaves changed in place since
    assert d_dig == h_dig
    assert d_man == h_man
    assert d_res == h_res == d_snap == h_snap
    assert {e["dtype"] for e in d_man[0]["leaves"]} == {
        "float32", "int8", "float64", "bfloat16", "bool", "int32"}

    # D2H accounting: the host path copies the whole tree every step...
    payload = sum(SER.host_array(a).nbytes for a in _base_tree().values())
    assert h_parts[1]["delta"]["d2h_bytes"] == payload
    assert h_parts[1]["delta"]["chunks_clean_device"] == 0
    # ...the device path only the dirty chunks: step 2 dirties elements
    # [0,96) of the 4-chunk f32 leaf "a" -> chunks 0-1, step 3 chunk 0
    d2 = d_parts[1]["delta"]
    assert d2["d2h_bytes"] == 2 * CHUNK
    assert d2["chunks_clean_device"] > 0 and d2["fp_device_s"] > 0.0
    assert d_parts[2]["delta"]["d2h_bytes"] == CHUNK


def test_device_iterative_predump_hashes_only_new_churn(tmp_path):
    store = TieredStore(tmp_path, seed=0)
    mgr = CheckpointManager(store, CheckpointPolicy(
        replicas=1, delta=True, chunk_bytes=CHUNK, fingerprint=True, device_fp=True))
    tree = _base_tree()
    mgr.save(1, tree)
    mgr.commit(1)

    # lead N-2: 2 chunks of "a" dirtied since the parent manifest
    _mutate_in_place(tree, 96)
    mgr.precommit(2, tree)
    s1 = mgr.wait_predump()
    assert s1["chunks_hashed"] == 2 and s1["d2h_bytes"] == 2 * CHUNK

    # lead N-1: only chunk 0 re-dirtied since lead N-2; the pre-dump hashes
    # in the background what it copied, so a later in-place step is harmless
    _mutate_in_place(tree, 40)
    mgr.precommit(3, tree)
    want = _bytes(tree_map(SER.host_array, tree))
    s2 = mgr.wait_predump()
    assert s2["chunks_hashed"] == 1 and s2["d2h_bytes"] == CHUNK

    # the save consumes lead N-1: nothing dirtied since -> zero D2H, zero
    # hashing, and the manifest still restores bit-exactly
    p = mgr.save(4, tree)
    mgr.commit(4)
    d = p["delta"]
    assert d["chunks_hashed"] == 0 and d["d2h_bytes"] == 0
    assert d["predump_step"] == 3
    assert _bytes(mgr.restore(tree, 4)[0]) == want
    mgr.close()


def _as_reference_leaf(t):
    import jax.numpy as jnp

    h = SER.host_array(t)
    if t.dtype == torch.bfloat16:
        return jnp.asarray(h.view(np.uint16)).view(jnp.bfloat16)
    return jnp.asarray(h) if t.dtype != torch.float64 else h    # jnp would drop f64


def test_device_fp_checkpoint_crosses_packages(tmp_path, monkeypatch):
    """A device-fingerprinted delta checkpoint written by either package
    restores in the other, byte for byte, and both write the same manifest
    entries (hashes, CRCs, fingerprints, dtype names) and chunk files."""
    monkeypatch.setenv("REPRO_DEVICE_FP_IMPL", "pallas_interpret")
    tree = _base_tree()
    ref_tree = {k: _as_reference_leaf(v) for k, v in tree.items()}
    policy = dict(replicas=1, delta=True, chunk_bytes=CHUNK, fingerprint=True,
                  device_fp=True)

    rmgr = RefManager(RefStore(tmp_path / "ref", seed=0), RefPolicy(**policy))
    rmgr.save(1, ref_tree)
    rmgr.commit(1)
    ref_manifest = _payload(rmgr.read_manifest(1))
    rmgr.close()
    monkeypatch.setenv("REPRO_DEVICE_FP_IMPL", "auto")
    mgr = CheckpointManager(TieredStore(tmp_path / "port", seed=0), CheckpointPolicy(**policy))
    mgr.save(1, tree)
    mgr.commit(1)
    port_manifest = _payload(mgr.read_manifest(1))
    mgr.close()
    assert port_manifest == ref_manifest
    assert _data_files(tmp_path / "port") == _data_files(tmp_path / "ref")

    want = _bytes(tree_map(SER.host_array, tree))
    # the reference's checkpoint in the port, the port's in the reference
    mgr = CheckpointManager(TieredStore(tmp_path / "ref"), CheckpointPolicy(**policy))
    assert _bytes(mgr.restore(tree)[0]) == want
    mgr.close()
    monkeypatch.setenv("REPRO_DEVICE_FP_IMPL", "pallas_interpret")
    rmgr = RefManager(RefStore(tmp_path / "port"), RefPolicy(**policy))
    assert _bytes(rmgr.restore(ref_tree)[0]) == want
    rmgr.close()


def test_dtype_names_match_the_reference():
    for t, name in ((torch.float32, "float32"), (torch.bfloat16, "bfloat16"),
                    (torch.bool, "bool"), (torch.int32, "int32"), (torch.int8, "int8"),
                    (torch.float64, "float64"), (torch.float16, "float16")):
        assert SER.dtype_name(t) == name
        assert SER.dtype_name(SER.host_array(torch.zeros(1, dtype=t)).dtype) == name
