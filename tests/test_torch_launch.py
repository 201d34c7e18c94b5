"""Port parity: ``repro_torch.runtime`` and ``repro_torch.launch`` against
``repro.runtime`` and ``repro.launch``.

``cost_mode`` nesting and threads; ``flash_attention`` under
``cost_mode(causal_skip=True)`` against the reference's (rtol = atol =
2e-5, ``tests/test_attention.py``) and its FLOPs; ``input_specs`` leaf for
leaf; ``model_flops_for``; the cases of ``tests/test_roofline.py`` that do
not parse HLO, with the H100 constants; ``report``'s tables byte for byte
on the same artifacts; the serve launcher's prompts; the train launcher's
resume (the reference's schedule restart pinned) and its mesh path on two
gloo ranks; and ``lower_cell`` on a fake (2, 2) world, run in a
subprocess so that no process group outlives it, its argument bytes equal
to the reference's shard bytes (a second subprocess with 4 forced host
devices) and its FLOPs derived by hand.
"""
import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import textwrap
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import runtime as j_runtime
from repro.configs import ARCHS as J_ARCHS
from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.configs import get_smoke_config as j_get_smoke_config
from repro.core.attention import flash_attention as j_flash_attention
from repro.launch import report as j_report
from repro.launch.inputs import input_specs as j_input_specs
from repro.launch.roofline import model_flops_for as j_model_flops_for
from repro_torch import runtime
from repro_torch.configs import ARCHS, SHAPES, get_config, get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.attention import flash_attention
from repro_torch.launch import report
from repro_torch.launch.inputs import input_specs
from repro_torch.launch.roofline import (HBM_BW, ICI_BW, PEAK_FLOPS,
                                         CostCounter, RooflineTerms,
                                         collective_bytes, costs_of,
                                         extrapolate, model_flops_for,
                                         weighted_collective_bytes)
from repro_torch.tree import tree_leaves

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LM_ARCHS = [a for a in ARCHS if a != "paper-gnn"]
KINDS = ("train_4k", "prefill_32k", "decode_32k")


# ---------------------------------------------------------------------------
# runtime
# ---------------------------------------------------------------------------


def _flags(mod):
    return (mod.unrolled(), mod.causal_skip(), mod.attn_chunk_override())


def test_cost_mode_nests_and_restores_as_the_reference():
    seen = []
    for mod in (runtime, j_runtime):
        trace = [_flags(mod)]
        with mod.cost_mode(causal_skip=True, attn_chunk=64):
            trace.append(_flags(mod))
            with mod.cost_mode():
                trace.append(_flags(mod))
            trace.append(_flags(mod))
        trace.append(_flags(mod))
        with pytest.raises(RuntimeError):
            with mod.cost_mode(attn_chunk=8):
                raise RuntimeError("restored on the way out")
        trace.append(_flags(mod))
        seen.append(trace)
    assert seen[0] == seen[1]
    assert seen[0] == [(False, False, None), (True, True, 64),
                       (True, False, None), (True, True, 64),
                       (False, False, None), (False, False, None)]


def test_cost_mode_is_thread_local():
    got = {}
    entered, release = threading.Event(), threading.Event()

    def other():
        entered.wait(10)
        got["other"] = _flags(runtime)
        release.set()

    t = threading.Thread(target=other)
    t.start()
    with runtime.cost_mode(causal_skip=True, attn_chunk=32):
        entered.set()
        assert release.wait(10)
        got["here"] = _flags(runtime)
    t.join(10)
    assert not t.is_alive()
    assert got == {"other": (False, False, None), "here": (True, True, 32)}


@pytest.mark.parametrize("causal_skip", [False, True])
@pytest.mark.parametrize("attn_chunk", [None, 16, 32])
def test_flash_attention_under_cost_mode_matches_reference(causal_skip,
                                                           attn_chunk):
    rng = np.random.default_rng(4)
    b, s, hq, hkv, d = 2, 64, 4, 2, 8
    q = rng.normal(size=(b, s, hq, d)).astype(np.float32)
    k = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    with runtime.cost_mode(causal_skip=causal_skip, attn_chunk=attn_chunk):
        got = flash_attention(*map(torch.from_numpy, (q, k, v)),
                              causal=True, q_chunk=16, kv_chunk=16)
    with j_runtime.cost_mode(causal_skip=causal_skip, attn_chunk=attn_chunk):
        want = j_flash_attention(*map(jnp.asarray, (q, k, v)), causal=True,
                                 q_chunk=16, kv_chunk=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_causal_skip_counts_the_causal_chunks():
    """Under ``cost_mode(causal_skip=True)`` q chunk i visits kv chunks
    0..i: ``FlopCounterMode`` counts (nq + 1) / (2 nq) of the masked
    count (two products a visited pair)."""
    from torch.utils.flop_counter import FlopCounterMode

    b, s, hq, hkv, d, chunk = 1, 128, 4, 2, 16, 32
    nq = s // chunk
    q, k, v = (torch.randn(b, s, h, d) for h in (hq, hkv, hkv))
    counts = {}
    for skip in (False, True):
        with runtime.cost_mode(causal_skip=skip, attn_chunk=chunk), \
                FlopCounterMode(display=False) as fc:
            flash_attention(q, k, v, causal=True)
        counts[skip] = fc.get_total_flops()
    per_pair = 2 * (2 * b * hq * chunk * chunk * d)
    assert counts[False] == nq * nq * per_pair
    assert counts[True] == nq * (nq + 1) // 2 * per_pair
    assert counts[True] / counts[False] == (nq + 1) / (2 * nq)


# ---------------------------------------------------------------------------
# inputs, model FLOPs
# ---------------------------------------------------------------------------


def _leaves(tree):
    return [(tuple(x.shape), str(x.dtype).replace("torch.", ""))
            for x in tree_leaves(tree)]


def _j_leaves(tree):
    return [(tuple(x.shape), str(jnp.dtype(x.dtype)))
            for x in jax.tree_util.tree_leaves(tree)]


@pytest.mark.parametrize("arch", LM_ARCHS + ["gemma3-4b:full"])
def test_input_specs_match_reference(arch):
    """Every leaf's shape and dtype, in tree order, for each smoke config
    and gemma3-4b's full config, on a train, a prefill and a decode shape
    (cut to small sizes for the smoke configs)."""
    full = arch.endswith(":full")
    name = arch.split(":")[0]
    cfg = get_config(name) if full else get_smoke_config(name)
    jcfg = j_get_config(name) if full else j_get_smoke_config(name)
    for kind in KINDS:
        shape = SHAPES[kind] if full else ShapeConfig(
            kind, 64, 4, SHAPES[kind].kind)
        got = input_specs(cfg, shape)
        want = j_input_specs(jcfg, shape)
        assert sorted(got) == sorted(want)
        for role in got:
            assert all(x.device.type == "meta"
                       for x in tree_leaves(got[role]))
            assert _leaves(got[role]) == _j_leaves(want[role]), (kind, role)


def test_model_flops_match_reference():
    assert list(ARCHS) == list(J_ARCHS) and list(SHAPES) == list(J_SHAPES)
    for arch in LM_ARCHS:
        for shape in SHAPES:
            assert model_flops_for(get_config(arch), SHAPES[shape]) \
                == j_model_flops_for(j_get_config(arch), J_SHAPES[shape])


# ---------------------------------------------------------------------------
# roofline (tests/test_roofline.py without the HLO parsing)
# ---------------------------------------------------------------------------


def test_h100_constants():
    assert (PEAK_FLOPS, HBM_BW, ICI_BW) == (989e12, 3.35e12, 450e9)


def test_weighted_bytes_doubles_allreduce():
    assert weighted_collective_bytes({"all-reduce": 10, "all-gather": 4}) \
        == 24


def test_extrapolation_linear():
    c1 = {"flops": 10.0, "bytes": 100.0, "coll": {"all-reduce": 1.0}}
    c2 = {"flops": 16.0, "bytes": 130.0, "coll": {"all-reduce": 1.5,
                                                  "all-gather": 2.0}}
    out = extrapolate(c1, c2, n_periods=5)
    assert out["flops"] == 10 + 4 * 6
    assert out["bytes"] == 100 + 4 * 30
    assert out["coll"]["all-reduce"] == 1.0 + 4 * 0.5
    assert out["coll"]["all-gather"] == 8.0  # 0 + 4*2


def test_terms_and_bottleneck():
    t = RooflineTerms(
        flops_per_chip=PEAK_FLOPS, bytes_per_chip=HBM_BW * 2,
        collective_bytes_per_chip=ICI_BW * 0.5,
        per_op_collectives={}, chips=256,
        model_flops=PEAK_FLOPS * 256 * 0.5)
    assert abs(t.t_compute - 1.0) < 1e-9
    assert abs(t.t_memory - 2.0) < 1e-9
    assert abs(t.t_collective - 0.5) < 1e-9
    assert t.bottleneck == "memory"
    assert abs(t.roofline_fraction - 0.25) < 1e-9
    assert set(t.summary()) >= {"t_compute_s", "bottleneck", "chips"}


def test_model_flops_train_vs_decode():
    cfg = get_config("gemma3-4b")
    tr = model_flops_for(cfg, SHAPES["train_4k"])
    dec = model_flops_for(cfg, SHAPES["decode_32k"])
    n = cfg.active_param_count()
    assert tr == pytest.approx(6.0 * n * 256 * 4096)
    assert dec == pytest.approx(2.0 * n * 128)


def test_cost_counter_records_flops_bytes_and_collectives():
    """A matmul's FLOPs, its operands' and result's bytes (a view counts
    nothing), and collective records summed per op."""
    a, b = torch.randn(8, 16), torch.randn(16, 4)
    with CostCounter() as c:
        a.t()  # a view: no bytes
        y = a @ b
    assert c.flops == 2 * 8 * 16 * 4
    assert c.bytes == (8 * 16 + 16 * 4 + 8 * 4) * 4
    assert c.peak_live_bytes == 8 * 4 * 4
    del y
    c.records.extend([("all-gather", 10), ("all-reduce", 4),
                      ("all-gather", 6)])
    assert collective_bytes(c.records) == {"all-gather": 16,
                                           "all-reduce": 4}
    assert costs_of(c)["coll"] == {"all-gather": 16.0, "all-reduce": 4.0}


# ---------------------------------------------------------------------------
# report
# ---------------------------------------------------------------------------


def _artifact(arch, shape, mesh, status="ok", tag=""):
    d = {"arch": arch, "shape": shape, "mesh": mesh, "status": status}
    if status == "skipped":
        d["reason"] = "skipped: test"
        return d, f"{arch}_{shape}_{mesh}{tag}"
    rng = np.random.default_rng(abs(hash((arch, shape, mesh))) % 2**32)
    d.update({"chips": 256, "compile_s": float(rng.integers(1, 99)),
              "memory": {"argument_bytes_per_device": int(rng.integers(2**30)),
                         "temp_bytes_per_device": int(rng.integers(2**34))},
              "roofline": {
                  "t_compute_s": float(rng.random()),
                  "t_memory_s": float(rng.random()),
                  "t_collective_s": float(rng.random()),
                  "bottleneck": "memory", "model_flops": 1.5e15,
                  "useful_flop_fraction": float(rng.random()),
                  "roofline_fraction": float(rng.random()),
                  "per_op_collectives": {"all-gather": 3.0 * 2**30,
                                         "all-reduce": 2**29}}})
    return d, f"{arch}_{shape}_{mesh}{tag}"


def test_report_tables_match_reference(tmp_path):
    cells = [("gemma3-4b", "train_4k", "16x16", "ok", ""),
             ("gemma3-4b", "decode_32k", "16x16", "ok", ""),
             ("gemma3-4b", "long_500k", "16x16", "skipped", ""),
             ("mamba2-2.7b", "prefill_32k", "2x16x16", "ok", ""),
             ("gemma3-4b", "train_4k", "16x16", "ok", "_cast")]
    for arch, shape, mesh, status, tag in cells:
        d, name = _artifact(arch, shape, mesh, status, tag)
        (tmp_path / (name + ".json")).write_text(json.dumps(d))
    got, want = report.load(str(tmp_path)), j_report.load(str(tmp_path))
    assert got == want
    for mesh in ("16x16", "2x16x16"):
        assert report.dryrun_table(got, mesh) \
            == j_report.dryrun_table(want, mesh)
    assert report.roofline_table(got) == j_report.roofline_table(want)
    assert report.collectives_table(got) == j_report.collectives_table(want)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        report.main(["--dir", str(tmp_path)])
    ref = io.StringIO()
    argv = sys.argv
    sys.argv = ["report", "--dir", str(tmp_path)]
    try:
        with contextlib.redirect_stdout(ref):
            j_report.main()
    finally:
        sys.argv = argv
    assert out.getvalue() == ref.getvalue()


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["gemma3-4b", "internvl2-26b",
                                  "whisper-small"])
def test_serve_prompts_equal_the_reference(arch, monkeypatch):
    """The reference's launcher's prompts and side inputs (its
    ``ServingEngine`` replaced by a recorder) equal the port's; the port's
    launcher then serves them on the CPU and prints the two lines."""
    import repro.launch.serve as j_serve
    from repro_torch.launch import serve

    seen = {}

    class Recorder:
        def __init__(self, *a, **kw):
            pass

        def generate(self, prompts, n_new, **kw):
            seen["prompts"], seen["kw"] = np.asarray(prompts), kw
            return np.zeros((prompts.shape[0], n_new), np.int32)

    monkeypatch.setattr(j_serve, "ServingEngine", Recorder)
    monkeypatch.setattr(j_serve, "init_lm", lambda *a, **kw: None)
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", arch, "--batch",
                                      "2", "--prompt-len", "24"])
    with contextlib.redirect_stdout(io.StringIO()):
        j_serve.main()
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    prompts, kw = serve.synthetic_inputs(cfg, 2, 24)
    np.testing.assert_array_equal(prompts, seen["prompts"])
    assert sorted(kw) == sorted(seen["kw"])
    for k in kw:
        np.testing.assert_array_equal(kw[k], np.asarray(seen["kw"][k]))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        toks = serve.main(["--arch", arch, "--batch", "2", "--prompt-len",
                           "24", "--new-tokens", "3", "--device", "cpu"])
    lines = out.getvalue().splitlines()
    assert toks.shape == (2, 3) and len(lines) == 2
    assert lines[0].startswith("2x3 tokens in ") and "tok/s" in lines[0]
    assert lines[1].startswith("sample:")


def test_train_resume_restores_bits_and_restarts_the_schedule(tmp_path):
    """``--ckpt-every 2 --steps 4``, then ``--resume``: the restored params
    and moments equal the saved ones bit for bit, the batches start at
    the saved step, and the learning rate at that step is the schedule of
    a 4-step run past its end (min_lr), not an 8-step run's: the
    reference restarts ``total_steps`` on resume
    (``repro/launch/train.py``), and the port keeps that."""
    from repro_torch.ft.checkpoint import Checkpointer
    from repro_torch.launch import train
    from repro_torch.train.optimizer import OptConfig, schedule

    common = ["--arch", "gemma3-4b", "--device", "cpu", "--batch", "2",
              "--seq", "32", "--ckpt-dir", str(tmp_path), "--ckpt-every",
              "2", "--steps", "4"]
    with contextlib.redirect_stdout(io.StringIO()):
        first = train.main(common)
    saved = Checkpointer(str(tmp_path)).restore(
        {"params": first["params"], "state": first["state"]})
    for a, b in zip(tree_leaves((first["params"], first["state"])),
                    tree_leaves((saved["params"], saved["state"]))):
        assert torch.equal(a, b)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        second = train.main(common + ["--resume"])
    lines = out.getvalue().splitlines()
    assert lines[0] == "resumed from step 4"
    assert lines[1].startswith("step     4  loss ")
    lr = float(lines[1].split("lr ")[1])
    opt = OptConfig(lr=3e-4, warmup_steps=1, total_steps=4)
    assert lr == pytest.approx(float(schedule(torch.tensor(4), opt)),
                               rel=1e-2)
    uninterrupted = dataclasses.replace(opt, total_steps=8)
    assert lr != pytest.approx(float(schedule(torch.tensor(4),
                                              uninterrupted)), rel=1e-2)
    assert int(second["state"]["opt"]["step"]) == 8


_TWO_RANKS = textwrap.dedent("""
    import os, sys, torch, torch.distributed as dist
    import torch.multiprocessing as mp

    def run(rank, d):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", store=dist.FileStore(
            os.path.join(d, "store"), 2), rank=rank, world_size=2)
        from repro_torch.launch import train
        out = train.main(["--arch", "gemma3-4b", "--device", "cpu",
                          "--steps", "2", "--batch", "2", "--seq", "32"])
        kind = type(out["params"]["final_ln"]).__name__
        print("RANK", rank, kind, repr(out["history"][0]["loss"]),
              flush=True)
        dist.destroy_process_group()

    if __name__ == "__main__":
        mp.spawn(run, args=(sys.argv[1],), nprocs=2)
""")


def test_train_launcher_on_two_gloo_ranks(tmp_path):
    """In a process group of two ranks the launcher takes the mesh path
    (a (1, 2) mesh, params as ``DTensor``s placed by
    ``param_sharding_tree``); its first loss equals the one-rank run's."""
    from repro_torch.launch import train

    script = tmp_path / "two_ranks.py"
    script.write_text(_TWO_RANKS)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, str(script), str(tmp_path)],
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    ranks = [line.split() for line in proc.stdout.splitlines()
             if line.startswith("RANK")]
    with contextlib.redirect_stdout(io.StringIO()):
        one = train.main(["--arch", "gemma3-4b", "--device", "cpu",
                          "--steps", "2", "--batch", "2", "--seq", "32"])
    assert sorted(r[1] for r in ranks) == ["0", "1"]
    assert all(r[2] == "DTensor" for r in ranks)
    assert all(float(r[3]) == one["history"][0]["loss"] for r in ranks)


# ---------------------------------------------------------------------------
# the dry run on a fake (2, 2) world
# ---------------------------------------------------------------------------

_SHAPES = {"train": (64, 8), "prefill": (64, 4), "decode": (64, 4)}

_PORT_CELL = textwrap.dedent("""
    import json, sys
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.dryrun import lower_cell
    out = {}
    for kind, (s, b) in json.loads(sys.argv[1]).items():
        out[kind] = lower_cell(
            "gemma3-4b", kind, False, verbose=False,
            config=get_smoke_config("gemma3-4b"),
            shape_config=ShapeConfig(kind, s, b, kind), mesh_shape=(2, 2))
    print(json.dumps(out))
""")

_REFERENCE_BYTES = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import json, math
    import numpy as np
    from repro.configs import get_smoke_config
    from repro.configs.base import ShapeConfig
    from repro.launch.inputs import abstract_cache, input_specs
    from repro.sharding.specs import (cache_sharding_tree,
                                      data_sharding_tree, make_mesh,
                                      param_sharding_tree)
    import jax

    def nbytes(tree, shardings):
        leaves = jax.tree_util.tree_leaves(tree)
        shs = jax.tree_util.tree_leaves(shardings)
        return sum(math.prod(sh.shard_shape(x.shape))
                   * np.dtype(x.dtype).itemsize for x, sh in zip(leaves, shs))

    cfg = get_smoke_config("gemma3-4b")
    mesh = make_mesh((2, 2), ("data", "model"))
    out = {}
    for kind, (s, b) in json.loads(sys.argv[1]).items():
        shape = ShapeConfig(kind, s, b, kind)
        sp = input_specs(cfg, shape)
        p = nbytes(sp["params"], param_sharding_tree(sp["params"], mesh))
        if kind == "train":
            out[kind] = p + nbytes(sp["state"],
                                   param_sharding_tree(sp["state"], mesh)) \\
                + nbytes(sp["batch"], data_sharding_tree(sp["batch"], mesh, b))
        elif kind == "prefill":
            out[kind] = p + nbytes(sp["batch"],
                                   data_sharding_tree(sp["batch"], mesh, b))
        else:
            out[kind] = p + nbytes(sp["token"], data_sharding_tree(
                sp["token"], mesh, b)) + nbytes(sp["cache"],
                cache_sharding_tree(sp["cache"], mesh, cfg, shape))
    print(json.dumps(out))
""")


def _decode_flops_by_hand(cfg, b: int, t: int) -> int:
    """One decode step of ``b`` tokens over a cache of ``t`` slots: every
    layer's projections (q, k, v, o) and gated MLP (wi, wg, wo), the
    scores and the weighted values over the whole cache buffer (the
    port's decode attends over ``t`` positions and masks), and the tied
    head; 2 FLOPs a multiply-add."""
    d, hq, hkv, hd, ff = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                          cfg.head_dim, cfg.d_ff)
    proj = d * hq * hd + 2 * d * hkv * hd + hq * hd * d
    mlp = 3 * d * ff
    attn = 2 * hq * hd * t
    per_layer = 2 * b * (proj + mlp + attn)
    return cfg.n_layers * per_layer + 2 * b * d * cfg.vocab_size


def test_lower_cell_on_a_fake_two_by_two_world():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    arg = json.dumps(_SHAPES)
    ref = subprocess.Popen([sys.executable, "-c", _REFERENCE_BYTES, arg],
                           env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
    try:
        port = subprocess.run([sys.executable, "-c", _PORT_CELL, arg],
                              env=env, capture_output=True, text=True,
                              timeout=300)
        ref_out, _ = ref.communicate(timeout=300)
    finally:
        if ref.poll() is None:
            ref.kill()
    assert port.returncode == 0, port.stdout + port.stderr
    assert ref.returncode == 0, ref_out
    cells = json.loads(port.stdout.splitlines()[-1])
    want = json.loads(ref_out.splitlines()[-1])
    cfg = get_smoke_config("gemma3-4b")
    for kind, cell in cells.items():
        assert cell["status"] == "ok" and cell["chips"] == 4
        assert cell["mesh"] == "2x2"
        assert cell["memory"]["argument_bytes_per_device"] == want[kind]
        assert cell["memory"]["temp_bytes_per_device"] > 0
        assert cell["cost_1p"] is None and cell["cost_2p"] is None
        r = cell["roofline"]
        assert r["flops_per_chip"] > 0 and r["bytes_per_chip"] > 0
        # the params are gathered whole on the rank: all-gathers
        assert r["per_op_collectives"].get("all-gather", 0) > 0
    # the decode step on rank 0's batch slice (4 rows over data = 2)
    s, b = _SHAPES["decode"]
    assert cells["decode"]["roofline"]["flops_per_chip"] \
        == _decode_flops_by_hand(cfg, b // 2, s)
    # train: the gradients are averaged over the batch axis
    assert cells["train"]["roofline"]["per_op_collectives"]["all-reduce"] > 0
