"""Port parity of LM serving (``repro_torch.serve.engine.ServingEngine``,
``make_prefill_step`` / ``make_serve_step``) and of the LM data pipeline
(``repro_torch.data.pipeline``) against the JAX package.

* Greedy ``generate`` gives the reference engine's tokens exactly on the
  granite and gemma3 smoke models, dense and with MLP weights pruned to
  ``SparseMatrix`` (f32, the same weights; random weights leave argmax
  margins far above the f32 differences of ``tests/test_torch_lm_parity.py``).
* Temperature sampling draws from an engine-owned ``torch.Generator``:
  the same tokens for the same seed, not ``jax.random``'s.
* At bf16 the engine's load-time cast (``transformer.cast_weights``) gives
  the same bits as casting each weight at its use, for every LM arch.
* ``make_lm_batch`` gives the reference's arrays exactly; ``lm_data_iter``
  steps through them.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_smoke_config as j_smoke
from repro.data import pipeline as JD
from repro.models import pruning as JP
from repro.models import transformer as JT
from repro.serve import engine as JE
from repro_torch.configs import ARCHS, SHAPES, get_smoke_config
from repro_torch.data import pipeline as D
from repro_torch.models import pruning as P
from repro_torch.models import transformer as T
from repro_torch.serve import engine as E

PRUNE = dict(sparsity=0.8, prune_block=(4, 4), block=(8, 8))
LM_ARCHS = [a for a in ARCHS if a != "paper-gnn"]


def _models(arch, dtype="float32"):
    jcfg = dataclasses.replace(j_smoke(arch), dtype=dtype)
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
    jparams = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    params = T.lm_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return jcfg, cfg, jparams, params


def _prompts(cfg, b=3, s=20, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


@pytest.mark.parametrize("pruned", [False, True], ids=["dense", "pruned"])
@pytest.mark.parametrize("arch", ["granite-20b", "gemma3-4b"])
def test_greedy_tokens_equal_reference(arch, pruned):
    jcfg, cfg, jparams, params = _models(arch)
    if pruned:
        jparams = JP.sparsify_lm(jparams, jcfg, **PRUNE)
        params = P.sparsify_lm(params, cfg, **PRUNE)
    prompts = _prompts(cfg)
    want = JE.ServingEngine(jparams, jcfg,
                            JE.ServeConfig(max_len=40)).generate(prompts, 12)
    got = E.ServingEngine(params, cfg,
                          E.ServeConfig(max_len=40)).generate(prompts, 12)
    assert got.dtype == np.int32 and got.shape == (3, 12)
    assert np.array_equal(got, np.asarray(want))


def test_temperature_sampling_repeats_for_a_seed():
    _, cfg, _, params = _models("granite-20b")
    prompts = _prompts(cfg)

    def run(seed):
        scfg = E.ServeConfig(max_len=40, temperature=1.0, seed=seed)
        return E.ServingEngine(params, cfg, scfg).generate(prompts, 10)

    a, b, c = run(3), run(3), run(4)
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c)
    assert ((a >= 0) & (a < cfg.vocab_size)).all()


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_load_time_cast_is_the_same_bits(arch):
    """bf16: the engine casts the dense weights once; prefill and decode
    on those give the same bits as on the f32 weights cast at each use
    (norms, embedding, head, router and recurrence constants stay f32 in
    both), for every arch's tree."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="bfloat16")
    params = T.init_lm(cfg, seed=0, device="cpu")
    cast = T.cast_weights(params, cfg)
    for path, leaf in _leaves(cast):
        want = torch.float32 if path[-1] in T._F32_LEAVES else torch.bfloat16
        assert leaf.dtype == want, path
    rng = np.random.default_rng(3)
    side = {}
    if cfg.vision_tokens:
        side["vision_embeds"] = torch.from_numpy(rng.normal(
            size=(3, cfg.vision_tokens, cfg.d_model)).astype(np.float32))
    if cfg.encoder_layers:
        side["enc_embeds"] = torch.from_numpy(rng.normal(
            size=(3, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
    toks = torch.from_numpy(_prompts(cfg))
    outs = []
    for p in (params, cast):
        logits, cache = T.prefill(p, cfg, toks, cfg.vision_tokens + 32,
                                  **side)
        steps = [logits]
        for _ in range(4):
            tok = torch.argmax(steps[-1], -1)[:, None]
            logits, cache = T.decode_step(p, cfg, tok, cache)
            steps.append(logits)
        outs.append(steps)
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("pruned", [False, True], ids=["dense", "pruned"])
def test_engine_holds_one_cast_tree(pruned):
    """bf16: ``ServingEngine.params`` is the one tree the engine holds, cast
    once (f32 leaves and sparse weights the given objects); the f32 leaves
    it cast are freed with the caller's tree; greedy tokens equal a loop
    over ``prefill`` / ``decode_step`` on the f32 tree cast at each use."""
    import gc
    import weakref

    cfg = dataclasses.replace(get_smoke_config("gemma3-4b"),
                              dtype="bfloat16")
    params = T.init_lm(cfg, seed=0, device="cpu")
    if pruned:
        params = P.sparsify_lm(params, cfg, **PRUNE)
    prompts = _prompts(cfg)
    toks = torch.from_numpy(prompts)
    logits, cache = T.prefill(params, cfg, toks, 40)
    want = [torch.argmax(logits, -1).to(torch.int32)]
    for _ in range(7):
        logits, cache = T.decode_step(params, cfg, want[-1][:, None], cache)
        want.append(torch.argmax(logits, -1).to(torch.int32))
    want = torch.stack(want, 1).numpy()

    eng = E.ServingEngine(params, cfg, E.ServeConfig(max_len=40))
    given = {id(leaf): path for path, leaf in _leaves(params)}
    kept = 0
    for path, leaf in _leaves(eng.params):
        f32 = path[-1] in T._F32_LEAVES
        assert leaf.dtype == (torch.float32 if f32 else torch.bfloat16), path
        assert (id(leaf) in given) == f32, path
        kept += f32
    assert kept and not any(isinstance(v, (dict, list, tuple))
                            for k, v in vars(eng).items() if k != "params")
    cast_away = [weakref.ref(leaf) for path, leaf in _leaves(params)
                 if path[-1] not in T._F32_LEAVES]
    del params, leaf
    gc.collect()
    assert cast_away and all(r() is None for r in cast_away)
    assert np.array_equal(eng.generate(prompts, 8), want)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v, path)
    elif isinstance(tree, torch.Tensor):
        yield path, tree


def test_step_factories():
    jcfg, cfg, _, params = _models("internvl2-26b")
    rng = np.random.default_rng(2)
    batch = {"tokens": torch.from_numpy(_prompts(cfg, s=12)),
             "vision_embeds": torch.from_numpy(rng.normal(
                 size=(3, cfg.vision_tokens, cfg.d_model)).astype(
                     np.float32))}
    logits, cache = E.make_prefill_step(cfg, 32)(params, batch)
    want, wcache = T.prefill(params, cfg, batch["tokens"], 32,
                             vision_embeds=batch["vision_embeds"])
    assert torch.equal(logits, want)
    tok = torch.argmax(logits, -1)[:, None]
    got, _ = E.make_serve_step(cfg)(params, tok, cache)
    want, _ = T.decode_step(params, cfg, tok, wcache)
    assert torch.equal(got, want)


@pytest.mark.parametrize("structure", ["ngram", "uniform"])
@pytest.mark.parametrize("arch", ["gemma3-4b", "internvl2-26b",
                                  "whisper-small"])
def test_make_lm_batch(arch, structure):
    jcfg, cfg = j_smoke(arch), get_smoke_config(arch)
    dcfg = D.DataConfig(seed=5, host_index=1, host_count=2,
                        structure=structure)
    jdcfg = JD.DataConfig(seed=5, host_index=1, host_count=2,
                          structure=structure)
    got = D.make_lm_batch(cfg, 24, 8, 3, dcfg, device="cpu")
    want = JD.make_lm_batch(jcfg, 24, 8, 3, jdcfg)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].device.type == "cpu"
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
        assert got[k].numpy().dtype == np.asarray(want[k]).dtype, k


def test_lm_data_iter():
    """``SHAPES`` equals the reference's; the iterator gives the
    reference's batches, step after step."""
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in J_SHAPES.items()}
    cfg, jcfg = get_smoke_config("granite-20b"), j_smoke("granite-20b")
    small = dict(seq_len=16, global_batch=2)
    it = D.lm_data_iter(cfg, dataclasses.replace(SHAPES["train_4k"], **small),
                        start_step=2, device="cpu")
    jit = JD.lm_data_iter(
        jcfg, dataclasses.replace(J_SHAPES["train_4k"], **small),
        start_step=2)
    for _ in range(3):
        got, want = next(it), next(jit)
        assert np.array_equal(got["tokens"].numpy(),
                              np.asarray(want["tokens"]))
