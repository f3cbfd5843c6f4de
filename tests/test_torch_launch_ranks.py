"""``launch.train`` and ``launch.serve`` started as ranks from the launcher's
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``, as ``torchrun`` sets them) on gloo CPU ranks, and the
trainer's trap of signals that land during its start-up.

Inputs: reduced qwen2-0.5b, B4 S32, seed 0, ``--ckpt-delta --ckpt-device-fp``,
4 steps; every process runs one thread of torch and gets a port of its own.

(a) SIGUSR1 the moment the child's ``SigCgt`` shows it caught, which is
    while torch is imported (the child says so): exit 85 with step 0
    saved; requeued, it finishes with every loss equal to an uninterrupted
    run's.
(b) Two ranks: A uninterrupted; B with SIGUSR1 sent to rank 1 alone during
    its start-up: both ranks exit 85 after step 0; C, both relaunched on
    B's directory, resume at step 1 and exit 0.  Every loss of B + C and the
    final chunk hashes equal A's exactly (the gloo collectives reduce in a
    fixed order at a fixed world and shapes).
(c) A's checkpoint: two worker parts, rank r's holding the leaves
    i % 2 == r; its chunk files and shard indexes byte-equal, and its worker
    parts equal less their clock fields, to what the reference's
    ``CheckpointManager(delta=True, device_fp=True)`` writes for the same
    host tree as workers 0 and 1 of 2.
(d) A's checkpoint restored at two gloo ranks (its leaves split over
    "data"), gathered whole; restored at one rank in the port and in the
    reference's manager: the same bytes, leaf for leaf.
(e) A's step losses within 5e-4 of the one-rank run's (the reference's
    elastic limit, tests/test_elastic.py).
(f) ``launch.serve`` at two ranks, reduced qwen2-0.5b and deepseek-v3 (MLA's
    latent cache), B4, ``--snapshot-at 4``: rank 0 prints "continuation
    MATCHES", and the tokens equal one rank's.  For qwen2 that is the CLI at
    one rank.  deepseek-v3's MoE prefill routes with the mesh's batch shards
    as groups (2 here), as the reference's ``make_prefill_step`` does, so
    its one-rank tokens are ``prefill(moe_groups=2)`` then greedy
    ``decode_step`` in this process.
(g) Without the rank variables nothing starts: no process group, a (1, 1)
    mesh with no device mesh, and ``"ranks": {"world": 1, "backend": null}``
    in the metrics; a CUDA rank without a GPU and a partial environment
    fail with a message, and ``--worker-id`` against a rank's id is refused.
(h) Rank 1 SIGKILLed mid-run: rank 0 exits non-zero within the group's
    timeout (``--dist-timeout 30``) and a margin.
"""
import json
import os
import re
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint.manager import CheckpointManager, CheckpointPolicy
from repro_torch.checkpoint.store import TieredStore
from repro_torch.configs.base import get_config, reduced
from repro_torch.launch.mesh import RANK_VARS, make_host_mesh, start_ranks
from repro_torch.optim import adamw
from repro_torch.train import step as TS
from repro_torch.utils.tree import flatten_with_names
from torch_gloo import launch, last_json

SRC = str(Path(__file__).resolve().parents[1] / "src")
STEPS = 4
BASE = ["--arch", "qwen2-0.5b", "--reduced", "--device", "cpu", "--batch", "4", "--seq", "32"]
TRAIN = [*BASE, "--steps", str(STEPS), "--ckpt-delta", "--ckpt-device-fp"]
RUN_S = 240                 # each launch's deadline
ELASTIC_TOL = 5e-4
CLOCK = re.compile(r"(_s|_at|^t)$")


def _env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items() if k not in RANK_VARS}
    env.update(PYTHONPATH=SRC, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               PYTHONUNBUFFERED="1", JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    env.update(extra)
    return env


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _caught(pid: int, sig: int) -> bool:
    """Whether process ``pid`` has a handler for ``sig`` (its ``SigCgt``)."""
    try:
        status = Path(f"/proc/{pid}/status").read_text()
    except FileNotFoundError:
        return False
    mask = int(re.search(r"^SigCgt:\s*([0-9a-f]+)", status, re.M).group(1), 16)
    return bool(mask >> (sig - 1) & 1)


def _signal_when_caught(proc, sig=signal.SIGUSR1, timeout=60.0) -> None:
    deadline = time.monotonic() + timeout
    while not _caught(proc.pid, sig):
        if proc.poll() is not None or time.monotonic() > deadline:
            raise AssertionError(f"the child never caught signal {sig}")
        time.sleep(0.001)
    proc.send_signal(sig)


class Ranks:
    """``world`` processes of ``python -m module args``, rank r with the
    launcher's variables; each one's output to a file; every process killed
    on the way out."""

    def __init__(self, tmp: Path, tag: str, module: str, args: list, world: int):
        self.logs = [tmp / f"{tag}-{r}.log" for r in range(world)]
        port = str(_free_port())
        self.procs = []
        for r, path in enumerate(self.logs):
            env = _env(RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=port)
            with open(path, "w") as fh:
                self.procs.append(subprocess.Popen(
                    [sys.executable, "-m", module, *map(str, args)], env=env,
                    stdout=fh, stderr=subprocess.STDOUT))

    def output(self, r: int) -> str:
        return self.logs[r].read_text()

    def wait(self, timeout: float = RUN_S) -> list:
        deadline = time.monotonic() + timeout
        try:
            for p in self.procs:
                p.wait(timeout=max(deadline - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            raise AssertionError(f"ranks passed their {timeout} s deadline:\n"
                                 + "\n".join(self.output(r)[-3000:]
                                             for r in range(len(self.procs)))) from None
        finally:
            self.kill()
        return [p.returncode for p in self.procs]

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _train(tmp: Path, tag: str, ckpt: Path, world: int, *extra, signal_rank=None):
    """A train run at ``world`` ranks (0: no rank variables, one process);
    with ``signal_rank``, SIGUSR1 to that rank as soon as it catches it.
    Returns (exit codes, metrics, each rank's output)."""
    metrics = tmp / f"{tag}.json"
    args = [*TRAIN, "--ckpt-dir", ckpt, "--metrics-out", metrics, *extra]
    if world == 0:
        log = tmp / f"{tag}.log"
        with open(log, "w") as fh:
            p = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.train",
                                  *map(str, args)], env=_env(), stdout=fh,
                                 stderr=subprocess.STDOUT)
        try:
            if signal_rank is not None:
                _signal_when_caught(p)
            rcs = [p.wait(timeout=RUN_S)]
        finally:
            if p.poll() is None:
                p.kill()
                p.wait()
        outs = [log.read_text()]
    else:
        ranks = Ranks(tmp, tag, "repro_torch.launch.train", args, world)
        try:
            if signal_rank is not None:
                _signal_when_caught(ranks.procs[signal_rank])
        finally:
            rcs = ranks.wait()
        outs = [ranks.output(r) for r in range(world)]
    assert metrics.exists(), "\n".join(o[-3000:] for o in outs)
    return rcs, json.loads(metrics.read_text()), outs


def _losses(m: dict) -> list:
    return [s["loss"] for s in m["steps"]]


def _hashes(root: Path, step: int = STEPS - 1) -> dict:
    mgr = CheckpointManager(TieredStore(root), CheckpointPolicy(delta=True))
    man = mgr.read_manifest(step)
    mgr.close()
    return {e["path"]: [c["hash"] for c in e["chunks"]] for e in man["leaves"]}


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    return tmp_path_factory.mktemp("ranks")


@pytest.fixture(scope="module")
def one_rank(work):
    rcs, m, outs = _train(work, "one", work / "one", 0)
    assert rcs == [0], outs[0][-3000:]
    return m


@pytest.fixture(scope="module")
def run_a(work):
    rcs, m, outs = _train(work, "A", work / "a", 2)
    assert rcs == [0, 0], "\n".join(o[-3000:] for o in outs)
    return m


# ---------------------------------------------------------------------------
# (a) a signal during start-up
# ---------------------------------------------------------------------------

def test_signal_during_imports_checkpoints_and_requeues(tmp_path, one_rank):
    rcs, cut, outs = _train(tmp_path, "cut", tmp_path / "ck", 0, signal_rank=0)
    assert rcs == [85], outs[0][-3000:]
    assert "signal 10 arrived during start-up (before torch finished importing)" in outs[0], outs[0]
    assert [s["step"] for s in cut["steps"]] == [0]
    assert CheckpointManager(TieredStore(tmp_path / "ck")).steps() == [0]
    rcs, rest, outs = _train(tmp_path, "rest", tmp_path / "ck", 0)
    assert rcs == [0], outs[0][-3000:]
    assert rest["start_step"] == 1
    assert _losses(cut) + _losses(rest) == _losses(one_rank)


# ---------------------------------------------------------------------------
# (b) one preemption for every rank, and the requeue, bit for bit
# ---------------------------------------------------------------------------

def test_signal_to_one_rank_stops_both_and_requeue_is_bit_identical(work, run_a):
    rcs, b, outs = _train(work, "B", work / "b", 2, signal_rank=1)
    assert rcs == [85, 85], "\n".join(o[-3000:] for o in outs)
    assert "signal 10 arrived during start-up" in outs[1]
    assert "signal 10 arrived" not in outs[0]
    assert [s["step"] for s in b["steps"]] == [0]
    for r in (0, 1):
        assert f"[rank {r}] [train] interrupted at step 0 -> requeue" in outs[r]
    rcs, c, outs = _train(work, "C", work / "b", 2)
    assert rcs == [0, 0], "\n".join(o[-3000:] for o in outs)
    assert c["start_step"] == 1
    for r in (0, 1):
        assert f"[rank {r}] [cr] restored checkpoint step=0 -> resuming at 1" in outs[r]
    assert _losses(b) + _losses(c) == _losses(run_a)
    assert _hashes(work / "b") == _hashes(work / "a")
    assert c["ranks"] == run_a["ranks"] == {"world": 2, "backend": "gloo"}


# ---------------------------------------------------------------------------
# (c), (d) the two-rank checkpoint against the reference's manager
# ---------------------------------------------------------------------------

_GATHER = """
from pathlib import Path
from repro_torch.checkpoint.manager import CheckpointManager, CheckpointPolicy
from repro_torch.checkpoint.store import TieredStore
from repro_torch.configs.base import get_config, reduced
from repro_torch.core.virtualization import fetch_tree, place_tree
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.optim import adamw
from repro_torch.parallel.mesh_rules import Rules
from repro_torch.train import step as TS
from repro_torch.utils.tree import flatten_with_names

cfg = reduced(get_config("qwen2-0.5b"))
oc = adamw.OptConfig(lr=3e-4, warmup_steps=10, decay_steps=4)
mgr = CheckpointManager(TieredStore(Path(ARGS[0])), CheckpointPolicy(delta=True))
host, _ = mgr.restore(TS.abstract_train_state(cfg, oc), promote=False)
mgr.close()
rules = Rules(make_host_mesh("cpu"))
state = place_tree(host, TS.state_logical_axes(cfg), rules, "cpu")
split = sum(hasattr(x, "to_local") for _, x in flatten_with_names(state))
whole = fetch_tree(state)                        # every rank gathers
if RANK == 0:
    np.savez(ARGS[1], **{n: np.ascontiguousarray(a).reshape(-1).view(np.uint8)
                         for n, a in flatten_with_names(whole)})
print(json.dumps({"mesh": list(rules.mesh.shape), "split": split}))
"""


@pytest.fixture(scope="module")
def gathered(work, run_a):
    """A's final state, restored at two gloo ranks and gathered whole: each
    leaf's bytes, by path."""
    out = launch(_GATHER, 2, work, work / "a", work / "gathered.npz")
    rep = last_json(out[0])
    assert rep["mesh"] == [2, 1] and rep["split"] > 0, rep
    arrs = np.load(work / "gathered.npz")
    return {k: arrs[k].tobytes() for k in arrs.files}


def _leaf_bytes(tree) -> dict:
    return {n: np.ascontiguousarray(np.asarray(a)).reshape(-1).view(np.uint8).tobytes()
            for n, a in flatten_with_names(tree)}


def _data_files(root: Path) -> dict:
    """Every chunk file and shard index under ``root`` by its path less the
    replica's node directory, with the contents its replicas hold."""
    out: dict = {}
    for p in sorted(root.rglob("*")):
        if p.is_file() and p.suffix != ".json":
            key = re.sub(r"/node\d+/", "/", str(p.relative_to(root)))
            out.setdefault(key, set()).add(p.read_bytes())
    return out


def _part(root: Path, w: int) -> dict:
    """Worker ``w``'s part of the final step, less its clock fields."""
    path = next(root.rglob(f"step_{STEPS - 1:010d}/wpart_{w:05d}.json"))

    def strip(d):
        return {k: strip(v) if isinstance(v, dict) else v
                for k, v in d.items() if not CLOCK.search(k)}
    return strip(json.loads(path.read_text()))


def test_two_rank_checkpoint_is_the_reference_managers_two_worker_save(
        work, run_a, gathered, monkeypatch):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.checkpoint.manager import CheckpointManager as RefManager
    from repro.checkpoint.manager import CheckpointPolicy as RefPolicy
    from repro.checkpoint.store import TieredStore as RefStore
    from repro.utils.tree import unflatten_like as ref_unflatten

    mgr = CheckpointManager(TieredStore(work / "a"), CheckpointPolicy(delta=True))
    man = mgr.read_manifest(STEPS - 1)
    mgr.close()
    assert man["num_workers"] == 2
    names = [n for n, _ in flatten_with_names(TS.abstract_train_state(
        reduced(get_config("qwen2-0.5b")), adamw.OptConfig()))]
    for w in (0, 1):
        part = _part(work / "a", w)
        assert part["worker_id"] == w and part["num_workers"] == 2
        assert [e["index"] for e in part["leaves"]] == list(range(w, len(names), 2))
        assert [e["path"] for e in part["leaves"]] == names[w::2]

    # the same host tree, written by the reference as workers 0 and 1 of 2
    entries = {e["path"]: e for e in man["leaves"]}

    def host(name):
        e = entries[name]
        dt = jnp.bfloat16 if e["dtype"] == "bfloat16" else np.dtype(e["dtype"])
        return np.frombuffer(gathered[name], dtype=dt).reshape(e["shape"])

    template = TS.abstract_train_state(reduced(get_config("qwen2-0.5b")), adamw.OptConfig())
    tree = ref_unflatten(template, {n: host(n) for n in names})
    monkeypatch.setenv("REPRO_DEVICE_FP_IMPL", "xla")
    for w in (0, 1):
        ref = RefManager(RefStore(work / "ref"), RefPolicy(delta=True, device_fp=True),
                         worker_id=w, num_workers=2)
        ref.save(STEPS - 1, tree, extra_meta=_part(work / "a", w)["meta"])
        if w == 1:
            ref.commit(STEPS - 1, num_workers=2)
        ref.close()
    assert _data_files(work / "ref") == _data_files(work / "a")
    for w in (0, 1):
        assert _part(work / "ref", w) == _part(work / "a", w)


def test_two_rank_checkpoint_restores_at_one_rank_in_both_packages(work, gathered):
    jax = pytest.importorskip("jax")
    from repro.checkpoint.manager import CheckpointManager as RefManager
    from repro.checkpoint.store import TieredStore as RefStore

    cfg = reduced(get_config("qwen2-0.5b"))
    mgr = CheckpointManager(TieredStore(work / "a"), CheckpointPolicy(delta=True))
    tree, _ = mgr.restore(TS.abstract_train_state(cfg, adamw.OptConfig()), promote=False)
    mgr.close()
    assert _leaf_bytes(tree) == gathered
    rmgr = RefManager(RefStore(work / "a"))
    ref_tree, _ = rmgr.restore(_ref_template(cfg))
    rmgr.close()
    assert _leaf_bytes(ref_tree) == gathered


def _ref_template(cfg):
    """The reference's abstract train state of ``cfg`` (its configs carry
    the same fields)."""
    from repro.configs.base import get_config as ref_get_config
    from repro.configs.base import reduced as ref_reduced
    from repro.optim import adamw as RA
    from repro.train import step as RTS

    return RTS.abstract_train_state(ref_reduced(ref_get_config(cfg.name)), RA.OptConfig())


# ---------------------------------------------------------------------------
# (e) two ranks against one
# ---------------------------------------------------------------------------

def test_two_rank_losses_within_the_elastic_limit_of_one_rank(run_a, one_rank):
    a, one = _losses(run_a), _losses(one_rank)
    assert len(a) == len(one) == STEPS
    assert max(abs(x - y) for x, y in zip(a, one)) <= ELASTIC_TOL, (a, one)


# ---------------------------------------------------------------------------
# (f) serving at two ranks
# ---------------------------------------------------------------------------

SERVE = ["--reduced", "--device", "cpu", "--batch", "4", "--snapshot-at", "4"]


def _one_rank_tokens(arch: str, tmp: Path):
    """The tokens of one rank: the CLI for a dense arch; for an MoE arch,
    prefill routed with 2 groups and greedy decode, in this process."""
    from repro_torch.launch import serve

    args = serve.parse_args(["--arch", arch, *SERVE, "--ckpt-dir", str(tmp / "one")])
    cfg = serve.served_config(args)
    if not cfg.num_experts:
        rep = tmp / "one.json"
        r = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
                            *SERVE, "--ckpt-dir", str(tmp / "one"), "--report-out", str(rep)],
                           env=_env(), capture_output=True, text=True, timeout=RUN_S)
        assert r.returncode == 0, r.stdout + r.stderr
        return json.loads(rep.read_text())["tokens"]
    from repro_torch.models import model as M

    model = M.init_params(cfg, args.seed, "cpu")
    prompts = serve.synthetic_prompts(cfg, np.random.default_rng(args.seed), args.batch,
                                      args.prompt_len, torch.device("cpu"))
    logits, cache = M.prefill(model, cfg, prompts, args.max_seq, moe_groups=2)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    out = []
    for _ in range(args.gen):
        logits, cache = M.decode_step(model, cfg, tok, cache, max_seq=args.max_seq)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        out.append(tok.numpy())
    return np.stack(out, axis=1).tolist()


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "deepseek-v3-671b"])
def test_serve_at_two_ranks_matches_and_equals_one_rank(tmp_path, arch):
    rep = tmp_path / "two.json"
    ranks = Ranks(tmp_path, "serve", "repro_torch.launch.serve",
                  ["--arch", arch, *SERVE, "--ckpt-dir", tmp_path / "two",
                   "--report-out", rep], 2)
    rcs = ranks.wait()
    assert rcs == [0, 0], ranks.output(0)[-3000:] + ranks.output(1)[-3000:]
    assert "continuation MATCHES the unmigrated reference" in ranks.output(0)
    assert "continuation" not in ranks.output(1)
    got = json.loads(rep.read_text())
    assert got["match"] is True and got["ranks"] == {"world": 2, "backend": "gloo"}
    assert got["tokens"] == _one_rank_tokens(arch, tmp_path)


# ---------------------------------------------------------------------------
# (g) no environment, no group
# ---------------------------------------------------------------------------

def test_without_rank_variables_nothing_starts(monkeypatch, one_rank):
    import torch.distributed as dist

    for k in RANK_VARS:
        monkeypatch.delenv(k, raising=False)
    assert start_ranks("cpu") is None and start_ranks("cuda") is None
    assert not dist.is_initialized()
    mesh = make_host_mesh("cpu")
    assert mesh.shape == (1, 1) and mesh.device_mesh is None
    assert one_rank["ranks"] == {"world": 1, "backend": None}


def test_a_rank_never_falls_back_to_the_cpu(monkeypatch):
    for k, v in zip(RANK_VARS, ("0", "1", "0", "127.0.0.1", str(_free_port()))):
        monkeypatch.setenv(k, v)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device found"):
            start_ranks("cuda")
    monkeypatch.delenv("MASTER_PORT")
    with pytest.raises(RuntimeError, match="MASTER_PORT not set"):
        start_ranks("cpu")


def test_worker_id_against_a_ranks_id_is_refused(tmp_path):
    ranks = Ranks(tmp_path, "wid", "repro_torch.launch.train",
                  [*TRAIN, "--ckpt-dir", tmp_path / "ck", "--worker-id", "1"], 1)
    assert ranks.wait() == [1]
    assert "--worker-id/--num-workers (1, None) contradict rank 0 of 1" in ranks.output(0)


# ---------------------------------------------------------------------------
# (h) a dead rank
# ---------------------------------------------------------------------------

def test_a_dead_rank_does_not_hang_the_others(tmp_path):
    timeout_s, margin_s = 30.0, 90.0
    ranks = Ranks(tmp_path, "dead", "repro_torch.launch.train",
                  [*BASE, "--steps", "500", "--step-sleep", "0.05",
                   "--ckpt-dir", tmp_path / "ck", "--dist-timeout", timeout_s], 2)
    try:
        deadline = time.monotonic() + RUN_S
        while "step 0 loss" not in ranks.output(0):
            assert time.monotonic() < deadline and ranks.procs[0].poll() is None, \
                ranks.output(0)[-3000:]
            time.sleep(0.05)
        ranks.procs[1].kill()
        t0 = time.monotonic()
        rc = ranks.procs[0].wait(timeout=timeout_s + margin_s)
        assert rc != 0 and time.monotonic() - t0 < timeout_s + margin_s
    finally:
        ranks.kill()
