"""Training the codebook (musicgen-large) and image-token
(llava-next-mistral-7b) families in the port against the reference, on the
CPU.

1. One AdamW step of reduced musicgen (2 layers, 4 codebooks, B2 S16): the
   loss is the codebooks' mean cross entropy (labels (B,S,K)); every
   gradient, the (K,V,D) embedding and the (K,D,V) head included, and the
   update (tests/torch_train_parity.py has the reference side and the
   tolerances).
2. One AdamW step of reduced llava (2 layers, 16 image tokens) at S 32: the
   image embeddings take the first 16 positions and no position before the
   last image token is scored (16 of 31 positions a row); the embeddings
   carry no parameter.
3. The reference's own edge: at S 16, as many positions as image tokens, no
   position is scored: loss 0, ``tokens`` 1, every gradient 0; at S 12 both
   packages refuse the batch.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs.base import get_config as ref_get_config
from repro.configs.base import reduced as ref_reduced
from repro.data.pipeline import SyntheticTokens as RefTokens
from repro.models import model as RM
from repro.optim import adamw as RA
from repro.train import step as RTS
from repro_torch.configs.base import get_config, reduced
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.train import step as TS
from repro_torch.utils.tree import tree_leaves
from torch_train_parity import check_one_step, port_batch, to_port

ATOL_REL = 1e-4
MUSICGEN, LLAVA = "musicgen-large", "llava-next-mistral-7b"


def _setup(arch, B, S):
    cfg = reduced(get_config(arch)).replace(num_layers=2)
    rcfg = ref_reduced(ref_get_config(arch)).replace(num_layers=2)
    oc, roc = (adamw.OptConfig(warmup_steps=1, decay_steps=10),
               RA.OptConfig(warmup_steps=1, decay_steps=10))
    state = RTS.init_train_state(rcfg, roc, jax.random.PRNGKey(0))
    return cfg, rcfg, oc, roc, state, RefTokens(rcfg, B, S, seed=1).batch_at(0)


def test_codebook_step_matches_reference():
    cfg, rcfg, oc, roc, state, batch = _setup(MUSICGEN, 2, 16)
    K, V, D = cfg.num_codebooks, cfg.vocab_size, cfg.d_model
    assert K == 4 and batch["tokens"].shape == (2, 16, K)
    grads, mets, _ = check_one_step(cfg, rcfg, oc, roc, state, batch, moe_groups=1,
                                    atol_rel=ATOL_REL)
    assert tuple(grads["embed/table"].shape) == (K, V, D)
    assert tuple(grads["head"].shape) == (K, D, V)
    for k in range(K):                  # each codebook's table and head get a gradient
        assert float(grads["embed/table"][k].abs().max()) > 0
        assert float(grads["head"][k].abs().max()) > 0
    assert mets["tokens"] == 2 * 15

    # the loss is the mean of the K codebooks' cross entropies
    params = to_port(state)["params"]
    tokens = torch.from_numpy(batch["tokens"])
    with torch.no_grad():
        h, _, _ = M.forward_full(params, cfg, {"tokens": tokens})
        labels, mask = M._shift_labels(cfg, {"tokens": tokens})
        logits = M.logits_fn(params, cfg, h)
        each = [M._ce_from_logits(logits[:, :, k], labels[..., k], mask)[0] for k in range(K)]
    assert len(set(float(c) for c in each)) == K
    np.testing.assert_allclose(mets["ce"], float(sum(each) / K) / float(mask.sum()), rtol=1e-6)


def test_image_token_step_matches_reference():
    cfg, rcfg, oc, roc, state, batch = _setup(LLAVA, 2, 32)
    n = cfg.num_image_tokens
    assert n == 16 and batch["image_embeds"].shape == (2, n, cfg.d_model)
    grads, mets, _ = check_one_step(cfg, rcfg, oc, roc, state, batch, moe_groups=1,
                                    atol_rel=ATOL_REL)
    assert mets["tokens"] == 2 * (32 - n)           # positions n - 1 .. 30 a row
    assert not any("image" in name for name in grads)
    _, mask = M._shift_labels(cfg, port_batch(batch))
    assert mask[0].tolist() == [0.0] * (n - 1) + [1.0] * (32 - n) + [0.0]


def test_image_tokens_filling_the_sequence_score_nothing():
    cfg, rcfg, oc, roc, state, batch = _setup(LLAVA, 2, 16)
    params = to_port(state)["params"]
    loss, mets, grads = TS.loss_and_grads(params, cfg, port_batch(batch))
    want, want_mets = RM.loss_fn(state["params"], rcfg, batch, moe_groups=1, impl="xla")
    assert float(loss) == float(want) == 0.0
    assert float(mets["tokens"]) == float(want_mets["tokens"]) == 1.0
    assert all(float(g.abs().max()) == 0 for g in tree_leaves(grads))
    short = RefTokens(rcfg, 2, 12, seed=1).batch_at(0)
    with pytest.raises(TypeError):
        RM.loss_fn(state["params"], rcfg, short, moe_groups=1, impl="xla")
    with pytest.raises(RuntimeError):
        M.loss_fn(params, cfg, port_batch(short))

