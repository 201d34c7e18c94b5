"""Training launcher:  python -m repro_torch.launch.train --arch <id> [...]

(The port of ``repro.launch.train``.)  Runs the reduced (smoke) config by
default and the full config with ``--full``, on ``--device`` (the card by
default): AdamW through ``train.loop.train_loop`` with the checkpoint
resume, the ``StragglerDetector`` and a callback every 10 steps.  In a
process group of more than one rank every rank runs it and the step runs
on a (world / 2, 2) mesh (``sharding.specs.make_mesh``, params and state
placed by ``param_sharding_tree``).

As the reference does, ``--resume`` restarts the schedule's length:
``total_steps`` is ``--steps`` again while the optimizer's step count
carries on from the checkpoint, so a resumed run's learning rate differs
from an uninterrupted run's (``repro.launch.train``'s behaviour, kept).
"""
from __future__ import annotations

import argparse
import dataclasses

import torch.distributed as dist

from repro_torch.configs import SHAPES, get_config, get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.pipeline import DataConfig, lm_data_iter
from repro_torch.device import resolve_device
from repro_torch.ft.checkpoint import Checkpointer
from repro_torch.ft.health import StragglerDetector
from repro_torch.models.transformer import init_lm
from repro_torch.sharding import ctx as shard_ctx
from repro_torch.train.loop import (TrainConfig, init_train_state,
                                    make_train_step, train_loop)
from repro_torch.train.optimizer import OptConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k", choices=list(SHAPES))
    ap.add_argument("--full", action="store_true",
                    help="use the full config (the published widths)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compression", default="none",
                    choices=("none", "int8", "topk_ef"))
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="where the step runs (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch) if args.full else dataclasses.replace(
        get_smoke_config(args.arch), dtype="float32")
    base = SHAPES[args.shape]
    shape = ShapeConfig("train",
                        args.seq or (base.seq_len if args.full else 128),
                        args.batch or (base.global_batch if args.full
                                       else 8), "train")
    tcfg = TrainConfig(
        opt=OptConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                      total_steps=args.steps),
        microbatches=args.microbatches, compression=args.compression)

    params = init_lm(cfg, seed=0, device=dev)
    state = init_train_state(params, tcfg)
    ck = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    start = 0
    if ck and args.resume and ck.latest_step() is not None:
        restored = ck.restore({"params": params, "state": state})
        params, state = restored["params"], restored["state"]
        start = ck.latest_step()
        print(f"resumed from step {start}")

    n_dev = dist.get_world_size() if dist.is_initialized() else 1
    if n_dev > 1:
        from repro_torch.sharding.specs import make_mesh
        from repro_torch.sharding.step import (make_sharded_train_step,
                                               place_tree)
        mesh = make_mesh((n_dev // 2, 2), ("data", "model"), device=dev)
        shard_ctx.set_mesh(mesh)
        params, state = place_tree(params, mesh), place_tree(state, mesh)
        step = make_sharded_train_step(cfg, tcfg, mesh)
    else:
        step = make_train_step(cfg, tcfg)
    data = lm_data_iter(cfg, shape, DataConfig(seed=0), start_step=start,
                        device=dev)
    det = StragglerDetector()

    def cb(i, params, state, metrics):
        if i % 10 == 0:
            print(f"step {start + i:5d}  loss {float(metrics['loss']):.4f}"
                  f"  lr {float(metrics['lr']):.2e}")

    out = train_loop(params, state, step, data, args.steps,
                     checkpointer=ck, ckpt_every=args.ckpt_every,
                     health=det, callback=cb)
    if ck:
        ck.wait()
    h = out["history"]
    print(f"done: loss {h[0]['loss']:.4f} -> {h[-1]['loss']:.4f}; "
          f"median step {det.median:.3f}s; stragglers {det.flags}")
    return out


if __name__ == "__main__":
    main()
