"""The port's config registry against the reference's: every arch resolves,
field by field equal, and the families the port does not run yet refuse with
``layer_plan``'s own error, never an import error."""
import dataclasses

import pytest

pytest.importorskip("torch")

from repro.configs import base as JB
from repro_torch.configs import base as B
from repro_torch.models import model as M
from repro_torch.utils.tree import tree_leaves

# dense GQA, mamba2/zamba2 and rwkv6 run on the port; the rest do not yet
PORTED = {"qwen2-0.5b", "granite-8b", "qwen3-4b", "llama3.2-1b", "zamba2-1.2b",
          "rwkv6-1.6b"}


def test_registry_lists_the_reference_archs():
    assert B.ARCH_IDS == JB.ARCH_IDS
    assert B._MODULES == JB._MODULES
    assert PORTED < set(B.ARCH_IDS)


@pytest.mark.parametrize("arch", JB.ARCH_IDS)
def test_config_equals_the_reference(arch):
    got, want = B.get_config(arch), JB.get_config(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(B.reduced(got)) == dataclasses.asdict(JB.reduced(want))


@pytest.mark.parametrize("arch", sorted(set(JB.ARCH_IDS) - PORTED))
def test_unported_family_refuses_with_not_implemented(arch):
    for cfg in (B.get_config(arch), B.reduced(B.get_config(arch))):
        with pytest.raises(NotImplementedError, match="ported"):
            M.param_specs(cfg)
        with pytest.raises(NotImplementedError):
            M.init_params(B.reduced(cfg), 0, "cpu")


@pytest.mark.parametrize("arch", sorted(PORTED))
def test_ported_arch_builds_its_full_width_tree_on_meta(arch):
    cfg = B.get_config(arch)
    assert cfg.param_count() == JB.get_config(arch).param_count()
    assert all(t.device.type == "meta" for t in tree_leaves(M.abstract_params(cfg)))


def test_unknown_arch_is_a_key_error():
    with pytest.raises(KeyError, match="unknown arch"):
        B.get_config("gpt-2")
