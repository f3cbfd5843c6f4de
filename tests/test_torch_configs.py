"""The port's config registry against the reference's: every arch resolves,
field by field equal, and every arch's full-width parameter tree builds on
the meta device with the reference's names and shapes."""
import dataclasses

import pytest

pytest.importorskip("torch")

from repro.configs import base as JB
from repro.models import model as JM
from repro.utils.tree import flatten_with_names as jax_flatten
from repro_torch.configs import base as B
from repro_torch.models import model as M
from repro_torch.utils.tree import flatten_with_names, tree_leaves

# the plans served since the MoE/MLA slice: MoE, MLA with MTP, codebooks, image tokens
PLAN_ARCHS = ["granite-moe-3b-a800m", "deepseek-v3-671b", "musicgen-large",
              "llava-next-mistral-7b"]


def test_registry_lists_the_reference_archs():
    assert B.ARCH_IDS == JB.ARCH_IDS
    assert B._MODULES == JB._MODULES
    assert set(PLAN_ARCHS) < set(B.ARCH_IDS)


@pytest.mark.parametrize("arch", JB.ARCH_IDS)
def test_config_equals_the_reference(arch):
    got, want = B.get_config(arch), JB.get_config(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(B.reduced(got)) == dataclasses.asdict(JB.reduced(want))


@pytest.mark.parametrize("arch", PLAN_ARCHS)
def test_plan_param_specs_match_reference_on_meta(arch):
    """Names, order, shapes and dtype of the full-width tree (deepseek-v3's
    671B included: nothing is allocated), the layer plan, and the counts of
    parameters and of active parameters."""
    cfg, cfg_j = B.get_config(arch), JB.get_config(arch)
    got = flatten_with_names(M.abstract_params(cfg))
    want = jax_flatten(JM.abstract_params(cfg_j))
    assert [n for n, _ in got] == [n for n, _ in want]
    for (n, t), (_, s) in zip(got, want):
        assert t.device.type == "meta", n
        assert tuple(t.shape) == tuple(s.shape), n
        assert str(t.dtype).removeprefix("torch.") == str(s.dtype), n
    assert ([(s.kind, s.count) for s in M.layer_plan(cfg)]
            == [(s.kind, s.count) for s in JM.layer_plan(cfg_j)])
    assert M.count_active_params(cfg) == JM.count_active_params(cfg_j)
    assert cfg.param_count() == cfg_j.param_count()


@pytest.mark.parametrize("arch", sorted(B.ARCH_IDS))
def test_ported_arch_builds_its_full_width_tree_on_meta(arch):
    cfg = B.get_config(arch)
    assert cfg.param_count() == JB.get_config(arch).param_count()
    assert all(t.device.type == "meta" for t in tree_leaves(M.abstract_params(cfg)))


def test_cut_depth_keeps_the_width_and_one_layer_of_each_kind():
    """deepseek-v3 at 2 layers, as serve --num-layers 2 names it: one dense
    and one MoE MLA layer at full width (the count the card serves)."""
    full = B.get_config("deepseek-v3-671b")
    cut = B.cut_depth(full, 2)
    assert [(s.kind, s.count) for s in M.layer_plan(cut)] == [("mla_dense", 1), ("mla_moe", 1)]
    assert cut.replace(num_layers=full.num_layers,
                       first_dense_layers=full.first_dense_layers) == full
    assert M.count_params_analytic(cut) == 14_630_385_664
    assert B.cut_depth(B.get_config("qwen2-0.5b"), 3).num_layers == 3
    for n in (0, full.num_layers + 1):
        with pytest.raises(ValueError, match="layers"):
            B.cut_depth(full, n)


def test_unknown_arch_is_a_key_error():
    with pytest.raises(KeyError, match="unknown arch"):
        B.get_config("gpt-2")
