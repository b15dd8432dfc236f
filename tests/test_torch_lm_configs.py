"""The port's model configs and GQA padding plans against the reference's.

Every architecture's ``ModelConfig`` field by field (dtypes as their
strings), its smoke config, parameter counts, padded vocabulary, the
assigned shapes and dry-run cells, and ``gqa_pad_plan`` over
``tests/test_models.py``'s padding cases and every architecture's heads.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import padding as tpad  # noqa: E402

ARCHS = sorted(treg.ARCHS)
#: tests/test_models.py's padding cases, then edges of both schemes
PAD_CASES = [(40, 8, 16), (36, 36, 16), (14, 2, 16), (24, 24, 16), (6, 2, 4),
             (3, 3, 4), (8, 1, 16), (64, 8, 16), (4, 4, 1), (7, 7, 8)]


def _ref():
    from repro.configs import registry
    from repro.models import padding
    return registry, padding


def _fields(cfg):
    return dataclasses.asdict(cfg)


def test_the_registry_names_the_reference_archs_in_its_order():
    reg, _ = _ref()
    assert list(treg.ARCHS) == list(reg.ARCHS)
    assert treg.SHAPES == reg.SHAPES
    assert treg.SUBQUADRATIC == reg.SUBQUADRATIC
    assert treg.cells() == reg.cells()


@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_the_reference_field_by_field(arch):
    reg, _ = _ref()
    mine, ref = treg.get(arch), reg.get(arch)
    assert _fields(mine) == _fields(ref)
    assert [f.name for f in dataclasses.fields(mine)] == \
        [f.name for f in dataclasses.fields(ref)]
    assert (mine.hd, mine.padded_vocab) == (ref.hd, ref.padded_vocab)
    for active in (False, True):
        assert mine.param_count(active) == ref.param_count(active)
    assert str(mine.pdtype).removeprefix("torch.") == ref.pdtype.name
    assert str(mine.cdtype).removeprefix("torch.") == ref.cdtype.name


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_config_equals_the_reference(arch):
    reg, _ = _ref()
    mine, ref = treg.smoke(arch), reg.smoke(arch)
    assert _fields(mine) == _fields(ref)
    assert (mine.hd, mine.padded_vocab) == (ref.hd, ref.padded_vocab)
    assert mine.param_count() == ref.param_count()
    assert mine.pdtype == torch.float32 and mine.cdtype == torch.float32


def test_config_classes_keep_the_reference_defaults():
    from repro.configs import base
    for mine, ref in ((tbase.MoECfg(4, 2, 8), base.MoECfg(4, 2, 8)),
                      (tbase.SSMCfg(), base.SSMCfg()),
                      (tbase.RWKVCfg(), base.RWKVCfg())):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    cfg = treg.get("qwen2-0.5b")
    assert cfg.replace(num_layers=2).num_layers == 2
    assert cfg.pdtype == torch.bfloat16 and cfg.cdtype == torch.bfloat16
    with pytest.raises(KeyError, match="unknown arch"):
        treg.get("no-such-arch")


@pytest.mark.parametrize("hq,hkv,align", PAD_CASES)
def test_pad_plan_equals_the_reference(hq, hkv, align):
    _, padding = _ref()
    assert dataclasses.asdict(tpad.gqa_pad_plan(hq, hkv, align)) == \
        dataclasses.asdict(padding.gqa_pad_plan(hq, hkv, align))
    mine = tpad.gqa_pad_plan(hq, hkv, align)
    assert mine.head_mask == padding.gqa_pad_plan(hq, hkv, align).head_mask
    assert mine.is_identity == padding.gqa_pad_plan(hq, hkv, align).is_identity


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_every_arch_pads_as_the_reference(arch, smoke):
    from repro.models import attention
    reg, _ = _ref()
    mine = (treg.smoke if smoke else treg.get)(arch)
    ref = (reg.smoke if smoke else reg.get)(arch)
    assert dataclasses.asdict(tattn.plan_for(mine)) == \
        dataclasses.asdict(attention.plan_for(ref))


def test_pad_plan_refuses_non_uniform_gqa():
    with pytest.raises(ValueError, match="non-uniform GQA"):
        tpad.gqa_pad_plan(6, 4, 4)


def test_qwen2_0_5b_pads_to_16_and_16():
    plan = tattn.plan_for(treg.get("qwen2-0.5b"))
    assert (plan.hq_p, plan.hkv_p, plan.group_p) == (16, 16, 1)
    assert [i for i, m in enumerate(plan.qmap) if m < 0] == [7, 15]
