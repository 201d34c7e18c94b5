"""Port parity of the LM models (``repro_torch.models.transformer``)
against ``repro.models.transformer``, per arch's ``SMOKE_CONFIG`` in f32:
the MoE and dense archs (the rest are in ``test_torch_lm_models_b.py``;
the ten LM archs are split over two files so each runs on its own
worker).

For each arch: ``forward_hidden`` and its aux loss, ``prefill`` plus 8
``decode_step``s with the logits and every cache leaf compared after
each, ``lm_loss``, and the port's ``init_lm`` tree and count against
``param_count``; ``lm_loss``'s gradients against ``jax.grad`` on
llama4-scout (MoE).
Tolerances are stated in ``tests/test_torch_lm_parity.py``.
"""
import pytest

import test_torch_lm_parity as P

ARCHS = ["llama4-scout-17b-a16e", "llama4-maverick-400b-a17b",
         "nemotron-4-15b", "granite-20b", "qwen1.5-110b"]
GRAD_ARCHS = ["llama4-scout-17b-a16e"]


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_hidden(arch):
    P.check_forward(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode(arch):
    P.check_prefill_decode(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss(arch):
    P.check_loss(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count(arch):
    P.check_param_count(arch)


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_lm_loss_grads(arch):
    P.check_grads(arch)
