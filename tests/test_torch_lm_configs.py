"""The port's LM configs (``repro_torch.configs``) equal the reference's
field for field: ``CONFIG`` and ``SMOKE_CONFIG`` of each of the ten LM
archs (gemma3-4b's ``act``, ``tie_embeddings``, ``rope_theta`` and
``long_context_ok`` included), their derived properties, parameter counts,
``ARCHS`` and the registry's errors."""
import dataclasses

import pytest

import repro.configs as J
import repro_torch.configs as C

LM_ARCHS = [a for a in J.ARCHS if a != "paper-gnn"]
DERIVED = ("period", "n_periods", "remainder_kinds", "d_inner", "ssm_heads")


def test_archs_and_fields():
    assert C.ARCHS == J.ARCHS
    assert [f.name for f in dataclasses.fields(C.ModelConfig)] \
        == [f.name for f in dataclasses.fields(J.ModelConfig)]
    with pytest.raises(KeyError):
        C.get_config("nope")


@pytest.mark.parametrize("getter", ["get_config", "get_smoke_config"])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_config_equals_reference(arch, getter):
    got, want = getattr(C, getter)(arch), getattr(J, getter)(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for name in DERIVED:
        assert getattr(got, name) == getattr(want, name), name
    assert got.param_count() == want.param_count()
    assert got.active_param_count() == want.active_param_count()
