"""The port's serving entry point on the CPU: pause/migrate/resume with a
bit-identical continuation, and the engine against the reference model's
greedy decode."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.configs.base import get_config as jax_get_config, reduced as jax_reduced
from repro.models import model as JM
from repro_torch.configs.base import get_config, reduced
from repro_torch.launch import serve
from repro_torch.models import model as M
from repro_torch.serve.engine import Engine
from repro_torch.serve.weight_sync import ParamHandle


def test_snapshot_migrate_restore_matches(tmp_path, capsys):
    rc = serve.main(["--arch", "qwen2-0.5b", "--reduced", "--snapshot-at", "4",
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


def test_follow_is_not_ported(capsys):
    assert serve.main(["--follow", "--device", "cpu"]) != 0
    assert "not yet ported" in capsys.readouterr().err


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
