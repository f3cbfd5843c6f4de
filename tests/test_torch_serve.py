"""The port's serving entry point on the CPU: pause/migrate/resume with a
bit-identical continuation, the engine against the reference model's greedy
decode, and ``--follow``: a replica serving the steps a publisher pushes,
swapping only at generation boundaries, draining and re-admitting."""
import ast
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.configs.base import get_config as jax_get_config, reduced as jax_reduced
from repro.models import model as JM
from repro_torch.checkpoint.manager import CheckpointManager, CheckpointPolicy
from repro_torch.checkpoint.store import TieredStore
from repro_torch.configs.base import get_config, reduced
from repro_torch.launch import serve
from repro_torch.models import model as M
from repro_torch.sched.cache_registry import REGISTRY_DIRNAME, CacheRegistry
from repro_torch.serve import engine as E
from repro_torch.serve.engine import Engine
from repro_torch.serve.weight_sync import ParamHandle
from repro_torch.utils.tree import tree_map

ROOT = Path(__file__).resolve().parents[1]


def test_snapshot_migrate_restore_matches(tmp_path, capsys):
    rc = serve.main(["--arch", "qwen2-0.5b", "--reduced", "--snapshot-at", "4",
                     "--ckpt-dir", str(tmp_path), "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "continuation MATCHES" in out


@pytest.mark.parametrize("arch", ["qwen3-4b", "granite-8b"])
def test_snapshot_migrate_restore_matches_head_dim_128_archs(tmp_path, capsys, arch):
    rc = serve.main(["--arch", arch, "--reduced", "--snapshot-at", "4",
                     "--ckpt-dir", str(tmp_path), "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "continuation MATCHES" in out


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "deepseek-v3-671b",
                                  "musicgen-large", "llava-next-mistral-7b"])
def test_snapshot_migrate_restore_matches_moe_mla_codebook_image_archs(tmp_path, capsys, arch):
    """MoE, MLA's compressed cache, codebook tokens (B, K) and the image-token
    model's text path: a snapshot at the first token resumes bit for bit."""
    rc = serve.main(["--arch", arch, "--reduced", "--snapshot-at", "1", "--gen", "6",
                     "--ckpt-dir", str(tmp_path), "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "continuation MATCHES" in out


def test_default_mode_generates(tmp_path, capsys):
    rc = serve.main(["--arch", "llama3.2-1b", "--reduced", "--gen", "5", "--device", "cpu"])
    assert rc == 0
    assert "generated 5 tokens x 4 requests" in capsys.readouterr().out


def test_run_reports_a_bfloat16_snapshot(tmp_path):
    args = serve.parse_args(["--arch", "qwen2-0.5b", "--reduced", "--batch", "2",
                             "--prompt-len", "7", "--gen", "6", "--max-seq", "16",
                             "--snapshot-at", "3", "--ckpt-dir", str(tmp_path),
                             "--device", "cpu"])
    rep = serve.run(args)
    assert rep["match"] is True and rep["logits_finite"]
    assert rep["tokens"].shape == (2, 6)
    cfg = reduced(get_config("qwen2-0.5b"))
    kv = 2 * cfg.num_layers * 2 * 16 * cfg.num_kv_heads * cfg.head_dim * 4   # float32 cache
    assert rep["snapshot_bytes"] == kv + 4 + 2 * 4                           # + t + tokens


def test_num_layers_serves_the_cut_config_and_run_takes_only_its_model(tmp_path):
    """--num-layers cuts the depth the CLI serves; a model handed to ``run``
    must be the config that the argv names."""
    argv = ["--arch", "deepseek-v3-671b", "--reduced", "--num-layers", "2", "--batch", "2",
            "--prompt-len", "5", "--gen", "4", "--max-seq", "12", "--snapshot-at", "2",
            "--ckpt-dir", str(tmp_path), "--device", "cpu"]
    args = serve.parse_args(argv)
    cfg = serve.served_config(args)
    assert cfg.num_layers == 2 and cfg.first_dense_layers == 1
    rep = serve.run(args)
    assert rep["match"] is True
    again = serve.run(serve.parse_args(argv), M.init_params(cfg, 0, "cpu"))
    np.testing.assert_array_equal(again["tokens"], rep["tokens"])
    other = M.init_params(reduced(get_config("deepseek-v3-671b")), 0, "cpu")
    with pytest.raises(ValueError, match="--num-layers"):
        serve.run(serve.parse_args(argv), other)


def test_cuda_is_required_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve.resolve_device("cuda")


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "llama3.2-1b"])
def test_engine_matches_reference_greedy_decode(arch):
    cfg_j = jax_reduced(jax_get_config(arch))
    tree = jax.tree_util.tree_map(np.asarray, JM.init_params(cfg_j, jax.random.PRNGKey(1)))
    cfg = reduced(get_config(arch))
    prompts = np.random.default_rng(3).integers(0, cfg.vocab_size, (3, 10)).astype(np.int32)

    eng = Engine(cfg, ParamHandle(M.params_from_numpy(cfg, tree, "cpu")), batch=3,
                 max_seq=32)
    first = eng.prefill({"tokens": torch.from_numpy(prompts)})
    got = eng.generate(6)

    params = jax.tree_util.tree_map(jnp.asarray, tree)
    logits, cache = JM.prefill(params, cfg_j, {"tokens": jnp.asarray(prompts)}, 32,
                               impl="pallas_interpret")
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    np.testing.assert_array_equal(first.numpy(), np.asarray(tok))
    want = []
    for _ in range(6):
        logits, cache = JM.decode_step(params, cfg_j, tok, cache, impl="pallas_interpret")
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        want.append(np.asarray(tok))
    np.testing.assert_array_equal(got, np.stack(want, axis=1))


# ---------------------------------------------------------------------------
# --follow
# ---------------------------------------------------------------------------

def test_serve_accepts_every_flag_of_the_reference():
    tree = ast.parse((ROOT / "src" / "repro" / "launch" / "serve.py").read_text())
    flags = {n.args[0].value for n in ast.walk(tree)
             if isinstance(n, ast.Call) and getattr(n.func, "attr", None) == "add_argument"}
    assert {"--follow", "--max-lag-steps", "--pipeline-uploads", "--restore-workers"} <= flags
    ours = serve.parse_args([])
    for flag in flags:
        assert hasattr(ours, flag.lstrip("-").replace("-", "_")), flag
    args = serve.parse_args(["--follow", "--replica", "r3", "--max-lag-steps", "2",
                             "--on-stale", "raise", "--drain-timeout-s", "5",
                             "--poll-s", "0.01", "--pipeline-uploads", "--local-root", "x",
                             "--batches", "2", "--delta", "--restore-workers", "2"])
    assert (args.replica, args.max_lag_steps, args.on_stale, args.batches) == ("r3", 2, "raise", 2)
    assert args.pipeline_uploads and args.delta and args.restore_workers == 2


class Publisher:
    """A trainer's side of the push plane: delta saves of a reduced qwen2's
    parameters as numpy, committed and announced."""

    def __init__(self, root: Path):
        self.cfg = reduced(get_config("qwen2-0.5b"))
        self.root = root
        self.registry = CacheRegistry(root / REGISTRY_DIRNAME)
        self.mgr = CheckpointManager(TieredStore(root), CheckpointPolicy(delta=True),
                                     node="pub", registry=self.registry)
        self.trees = {}

    def tree(self, step: int) -> dict:
        """Step 1's weights from seed 0; each later step moves a few leaves."""
        tree = tree_map(lambda t: t.detach().numpy().copy(),
                        M.params_tree(M.init_params(self.cfg, 0, "cpu")))
        for s in range(2, step + 1):
            tree["embed"]["table"][s % 7] += 0.5
            tree["seg0"]["ffn"]["up"]["w"][:, :, s % 5] -= 0.25
        return tree

    def push(self, step: int) -> None:
        self.trees[step] = self.tree(step)
        self.mgr.save(step, self.trees[step])
        man = self.mgr.commit(step)
        self.registry.announce_push(step=step, node="pub",
                                    manifest_version=man.get("manifest_version"))

    def close(self):
        self.mgr.close()


def _follow_argv(tmp_path, *extra):
    return ["--follow", "--device", "cpu", "--arch", "qwen2-0.5b", "--reduced",
            "--ckpt-dir", str(tmp_path / "weights"), "--local-root", str(tmp_path / "r0"),
            "--replica", "r0", "--batch", "2", "--prompt-len", "6", "--gen", "3",
            "--max-seq", "16", "--poll-s", "0.01", *extra]


def _after_first_generate(monkeypatch, fn):
    """Run ``fn`` once, at the end of the first batch's generation."""
    orig, calls = Engine.generate, []

    def generate(self, n, on_token=None):
        out = orig(self, n, on_token)
        calls.append(n)
        if len(calls) == 1:
            fn()
        return out

    monkeypatch.setattr(E.Engine, "generate", generate)


@pytest.mark.parametrize("pipelined", [False, True], ids=["staged", "pipelined"])
def test_follow_serves_a_pushed_step(tmp_path, capsys, monkeypatch, pipelined):
    pub = Publisher(tmp_path / "weights")
    pub.push(1)
    _after_first_generate(monkeypatch, lambda: pub.push(2))
    rc = serve.main(_follow_argv(tmp_path, "--batches", "3", "--max-lag-steps", "2",
                                 *(["--pipeline-uploads"] if pipelined else [])))
    cap = capsys.readouterr()
    out = cap.out
    pub.close()
    assert rc == 0, out
    # on the CPU the attention wrappers run their plain versions: no launch
    assert "replica r0: launches flash 0 flash_decode 0" in cap.err.splitlines(), cap.err
    lines = out.splitlines()
    assert "replica r0: serving step 1" in lines
    assert lines[-3].startswith("batch 0: served step 1, lag 1, swaps 0, swap_stall ")
    # the push lands during batch 0; it is fetched before batch 1 and swapped
    # in at a generation boundary (the upload thread may stage it a batch later)
    served = [int(ln.split("served step ")[1].split(",")[0]) for ln in lines[-3:]]
    assert served[-1] == 2 and served == sorted(served), lines
    assert lines[-1].startswith("batch 2: served step 2, lag 0, swaps 1, swap_stall ")
    assert (tmp_path / "weights" / REGISTRY_DIRNAME / "followers" / "r0.json").exists()


def test_follow_drains_and_readmits_under_a_paused_publisher(tmp_path, capsys, monkeypatch):
    """The publisher announces step 9 during batch 0 and commits it only once
    the replica shows ``draining``: past --max-lag-steps the replica refuses
    the next batch, then re-admits on step 9 and serves it."""
    pub = Publisher(tmp_path / "weights")
    pub.push(1)
    _after_first_generate(monkeypatch, lambda: pub.registry.announce_push(step=9, node="pub"))
    done = threading.Event()

    def recover():
        while not done.wait(0.01):
            st = pub.registry.replica_status().get("r0", {})
            if st.get("phase") == "draining":
                pub.push(9)
                return

    t = threading.Thread(target=recover, daemon=True)
    t.start()
    try:
        rc = serve.main(_follow_argv(tmp_path, "--batches", "2", "--max-lag-steps", "1",
                                     "--drain-timeout-s", "60"))
    finally:
        done.set()
        t.join(timeout=10)
    cap = capsys.readouterr()
    pub.close()
    assert rc == 0, cap.out + cap.err
    assert "replica r0: draining at lag 8" in cap.err
    # re-admitted as soon as step 9 is staged; it swaps in at the next boundary
    # unless the gate forced the swap itself
    assert ("replica r0: re-admitted at step 1" in cap.out
            or "replica r0: re-admitted at step 9" in cap.out), cap.out
    assert cap.out.splitlines()[-1].startswith("batch 1: served step 9, lag 0, swaps 1")


def test_follow_drain_times_out(tmp_path, capsys, monkeypatch):
    pub = Publisher(tmp_path / "weights")
    pub.push(1)
    _after_first_generate(monkeypatch, lambda: pub.registry.announce_push(step=9, node="pub"))
    rc = serve.main(_follow_argv(tmp_path, "--batches", "2", "--max-lag-steps", "1",
                                 "--drain-timeout-s", "0.2"))
    err = capsys.readouterr().err
    pub.close()
    assert rc == 1
    assert "replica r0: drain timed out after 0s at lag 8" in err


def test_follow_without_a_push_fails(tmp_path, capsys):
    assert serve.main(_follow_argv(tmp_path)) == 1
    assert "no committed weight push found" in capsys.readouterr().err


def test_pipelined_swap_gives_a_fresh_engines_tokens(tmp_path):
    """The follower's wiring with uploads on the upload thread: once step 2 is
    swapped in, a batch's tokens equal those of a fresh engine built on step
    2's weights."""
    pub = Publisher(tmp_path / "weights")
    pub.push(1)
    args = serve.parse_args(_follow_argv(tmp_path, "--pipeline-uploads"))
    fol = serve.open_follower(args)
    assert fol.manifest["step"] == 1 and fol.client.handle.step == 1
    pub.push(2)
    rng = np.random.default_rng(0)
    try:
        rec = fol.client.sync_once()
        assert rec["step"] == 2 and rec["pipelined"]
        # a swap lands at the entry of prefill or of generate, whichever first
        # finds the upload staged; the batch to compare is the first one
        # prefilled on step 2
        for _ in range(20):
            prompts = serve.synthetic_prompts(fol.cfg, rng, args.batch, args.prompt_len,
                                              fol.device)
            fol.engine.prefill(prompts)
            prefilled_on = fol.client.handle.step
            got = fol.engine.generate(args.gen)
            if prefilled_on == 2:
                break
            fol.client.wait_uploads()
        assert fol.client.handle.step == 2 and fol.client.handle.swap_count == 1
    finally:
        fol.close()
    fresh = Engine(fol.cfg, M.params_from_numpy(fol.cfg, pub.trees[2], "cpu"),
                   batch=args.batch, max_seq=args.max_seq)
    fresh.prefill(prompts)
    np.testing.assert_array_equal(got, fresh.generate(args.gen))
    old = Engine(fol.cfg, M.params_from_numpy(fol.cfg, pub.trees[1], "cpu"),
                 batch=args.batch, max_seq=args.max_seq)
    old.prefill(prompts)
    assert not np.array_equal(got, old.generate(args.gen)), "step 2 must change the tokens"
    pub.close()
