"""Serving launcher:  python -m repro_torch.launch.serve --arch <id> [...]

(The port of ``repro.launch.serve``.)  Inits a model with seeded random
weights, prefills a batch of synthetic prompts and decodes continuations
with the batched engine, on ``--device`` (the card by default).  The
prompts are drawn with the reference's numpy calls, so both launchers
serve the same prompts.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.models.transformer import init_lm
from repro_torch.serve.engine import ServeConfig, ServingEngine


def synthetic_inputs(cfg, batch: int, prompt_len: int):
    """The prompts (int32 [batch, prompt_len - vision_tokens]) and the
    side inputs of the reference's launcher, from ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    prompts = rng.integers(
        0, cfg.vocab_size,
        (batch, prompt_len - cfg.vision_tokens)).astype(np.int32)
    kw = {}
    if cfg.vision_tokens:
        kw["vision_embeds"] = rng.normal(
            size=(batch, cfg.vision_tokens, cfg.d_model)).astype(np.float32)
    if cfg.encoder_layers:
        kw["enc_embeds"] = rng.normal(
            size=(batch, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return prompts, kw


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda",
                    help="where the model runs (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch) if args.full else dataclasses.replace(
        get_smoke_config(args.arch), dtype="float32")
    eng = ServingEngine(init_lm(cfg, seed=0, device=dev), cfg, ServeConfig(
        max_len=args.prompt_len + args.new_tokens,
        temperature=args.temperature))

    prompts, kw = synthetic_inputs(cfg, args.batch, args.prompt_len)
    t0 = time.time()
    out = eng.generate(prompts, args.new_tokens, **kw)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    print(f"{args.batch}x{args.new_tokens} tokens in {dt:.2f}s "
          f"({args.batch * args.new_tokens / dt:.1f} tok/s)")
    print("sample:", out[0][:16])
    return out


if __name__ == "__main__":
    main()
