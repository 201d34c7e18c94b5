"""The plain reference against the port's CPU path at the smoke size, and
the reference's independence from the program."""
import ast

import pytest
import torch

from bench.harness.check import logit_gap
from bench.harness.device import generator
from bench.harness.spec import BENCH, load_json
from bench.reference import gnn as reference
from bench.reference.precision import matmul, tf32_round

N, DENSITY, SEED = 256, 0.1, 20260
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "repro_torch"}


@pytest.fixture(scope="module")
def smoke():
    from repro_torch.configs.paper_gnn import SMOKE_CONFIG
    from repro_torch.models import gnn

    c = SMOKE_CONFIG
    g = torch.Generator().manual_seed(SEED)
    adj01 = torch.rand((N, N), generator=g) < DENSITY
    graph = gnn.build_graph(adj01.numpy(), c, device="cpu")
    cfg = {k: getattr(c, k) for k in ("n_layers", "in_features", "hidden",
                                      "n_classes", "block_m", "block_n")}
    x = torch.randn((N, c.in_features), generator=g)
    labels = torch.randint(0, c.n_classes, (N,), generator=g)
    return cfg, adj01, graph, x, labels


def smoke_config(cfg, model):
    """The benchmark's configuration of ``model`` at the smoke widths."""
    full = load_json(BENCH / "configs" / f"paper-{model}.json")
    return dict(full, **cfg)


def make_params(cfg):
    return reference.make_params(
        cfg, generator(SEED, "weights", torch.device("cpu")),
        torch.device("cpu"))


@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_logits_equal_the_port_at_smoke_size(smoke, model):
    from repro_torch.models import gnn

    cfg, adj01, graph, x, _ = smoke
    cfg = smoke_config(cfg, model)
    params = make_params(cfg)
    forward = gnn.gcn_forward if model == "gcn" else gnn.gat_forward
    with torch.no_grad():
        got = forward(params, graph, x)
        want = reference.logits(cfg, reference.graph_operand(cfg, adj01),
                                params, x)
    assert logit_gap(got, want) < 1e-5


@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_one_step_equals_the_port_at_smoke_size(smoke, model):
    from repro_torch.train import gnn as train

    cfg, adj01, graph, x, labels = smoke
    cfg = smoke_config(cfg, model)
    params = make_params(cfg)
    own = train.trainable({k: [p.clone() for p in v]
                           for k, v in params.items()})
    loss, _ = train.train_step(own, graph, x, labels, kind=model, lr=0.05)
    ref = reference.train_steps(cfg, reference.graph_operand(cfg, adj01),
                                params, x, labels, lr=0.05, steps=1)
    assert float(loss) == pytest.approx(ref.losses[0], rel=1e-6)
    for name, p0 in zip(reference.leaf_names(params),
                        reference.leaves(params)):
        key, i = name[:-3], int(name[-2])
        moved, want = own[key][i].detach() - p0, ref.after_first[name] - p0
        assert float((moved - want).abs().max()) <= \
            1e-4 * float(want.abs().max()) + 1e-9, name


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 2**-12,
                      -(1.0 + 2**-11), 3.0e-3, 0.0])
    r = tf32_round(x)
    assert r[0] == 1.0 and r[1] == 1.0 + 2**-10  # kept: 10 bits
    assert r[2] == 1.0 + 2**-10  # a tie goes away from zero
    assert r[3] == 1.0 and r[4] == -(1.0 + 2**-10) and r[6] == 0.0
    assert (r.view(torch.int32) & 0x1FFF == 0).all()
    assert abs(float(r[5]) / 3.0e-3 - 1) <= 2**-11


def test_tf32_products_differentiate_like_float32():
    g = torch.Generator().manual_seed(1)
    a = torch.randn(8, 5, generator=g, requires_grad=True)
    b = torch.randn(5, 3, generator=g, requires_grad=True)
    (matmul(a, b, "tf32") ** 2).sum().backward()
    ga, gb = a.grad.clone(), b.grad.clone()
    a.grad = b.grad = None
    (matmul(a, b, "float32") ** 2).sum().backward()
    for got, want in ((ga, a.grad), (gb, b.grad)):  # TF32: 2^-11 an operand
        assert float((got - want).abs().max()) <= \
            1e-2 * float(want.abs().max())
    assert not torch.equal(ga, a.grad)


@pytest.mark.parametrize("folder", ["reference", "work"])
def test_the_yardstick_imports_nothing_of_the_program(folder):
    for path in (BENCH / folder).glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN, (path, name)
