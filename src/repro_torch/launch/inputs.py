"""Meta-tensor stand-ins for every model input, without allocation (the
port of ``repro.launch.inputs``).

``input_specs(cfg, shape)`` returns the abstract inputs of the cell's step:
  train_*   -> (params f32, train-state, batch{tokens,targets,mask,...})
  prefill_* -> (params bf16, batch{tokens,...})
  decode_*  -> (params bf16, token, cache)

Every leaf is a tensor on the ``meta`` device with the reference's shape
and dtype (the counterpart of ``jax.ShapeDtypeStruct``).  The trees come
from the port's own ``init_lm`` / ``init_train_state`` / ``init_cache``,
run under ``FakeTensorMode`` (no storage is made) and handed back as meta
tensors.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.transformer import init_cache, init_lm
from repro_torch.train.loop import TrainConfig, init_train_state
from repro_torch.tree import tree_map


def SDS(shape, dtype) -> torch.Tensor:
    """A meta tensor of ``shape`` and ``dtype`` (``ShapeDtypeStruct``)."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _abstract(fn, *args, **kwargs):
    """``fn``'s tree of tensors, built without storage, as meta tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        tree = fn(*args, **kwargs)
    return tree_map(lambda x: SDS(x.shape, x.dtype), tree)


def abstract_params(cfg: ModelConfig, dtype=None):
    tree = _abstract(init_lm, cfg, device="cpu")
    if dtype is not None:
        tree = tree_map(lambda s: SDS(s.shape, dtype)
                        if s.is_floating_point() else s, tree)
    return tree


def abstract_train_state(cfg: ModelConfig, tcfg: TrainConfig):
    params = abstract_params(cfg)
    return params, _abstract(
        lambda: init_train_state(
            tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype), params),
            tcfg))


def batch_specs(cfg: ModelConfig, shape: ShapeConfig,
                train: bool = True) -> Dict[str, Any]:
    b, s = shape.global_batch, shape.seq_len
    n_text = s - cfg.vision_tokens
    out: Dict[str, Any] = {"tokens": SDS((b, n_text), torch.int32)}
    if train:
        out["targets"] = SDS((b, n_text), torch.int32)
        out["mask"] = SDS((b, n_text), torch.float32)
    if cfg.vision_tokens:
        out["vision_embeds"] = SDS((b, cfg.vision_tokens, cfg.d_model),
                                   torch.bfloat16)
    if cfg.encoder_layers:
        out["enc_embeds"] = SDS((b, cfg.encoder_seq, cfg.d_model),
                                torch.bfloat16)
    return out


def abstract_cache(cfg: ModelConfig, shape: ShapeConfig,
                   dtype=torch.bfloat16):
    return _abstract(init_cache, cfg, shape.global_batch, shape.seq_len,
                     dtype, device="cpu")


def decode_specs(cfg: ModelConfig, shape: ShapeConfig) -> Tuple:
    token = SDS((shape.global_batch, 1), torch.int32)
    return token, abstract_cache(cfg, shape)


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                tcfg: TrainConfig = None) -> Dict[str, Any]:
    """All abstract inputs for the cell, keyed by role."""
    tcfg = tcfg or TrainConfig()
    if shape.kind == "train":
        params, state = abstract_train_state(cfg, tcfg)
        return {"params": params, "state": state,
                "batch": batch_specs(cfg, shape, train=True)}
    if shape.kind == "prefill":
        return {"params": abstract_params(cfg, torch.bfloat16),
                "batch": batch_specs(cfg, shape, train=False)}
    token, cache = decode_specs(cfg, shape)
    return {"params": abstract_params(cfg, torch.bfloat16),
            "token": token, "cache": cache}
