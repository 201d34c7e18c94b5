"""Port parity, continued from ``tests/test_torch_mesh.py`` (its
tolerances and its runs' plumbing): an 8-rank gloo group on the CPU
against the reference's forced 8-device run of the same inputs —
``spmm_2p5d`` on 2 x 2 x 2, ``reshard`` of every leaf from 4 x 2 onto the
surviving 2 x 2, and the elastic restart (3 sharded steps on 4 x 2, a
checkpoint of gathered ``DTensor``s, a restore onto 2 x 2, 3 more steps)
against 6 steps on 4 x 2, within 1e-4, and against the reference's."""
import numpy as np
import pytest

from test_torch_mesh import _REFERENCE_8, _close, _leaves_of, ranks, run_both


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_both(tmp_path_factory, ranks.rank8, 8, _REFERENCE_8)


def test_spmm_2p5d_on_2x2x2_matches_reference(runs):
    want = runs["inputs"]["dense"] @ runs["inputs"]["h"]
    for r in runs["port"]:
        _close(r["y25"], runs["ref"]["y25"], 2e-4)
        _close(r["y25"], want, 2e-4)


def test_reshard_4x2_to_2x2_keeps_every_value(runs):
    want = _leaves_of(runs["inputs"], "granite")
    for r in runs["port"][:4]:
        got = _leaves_of(r, "resharded")
        assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert not any(k.startswith("resharded/") for k in runs["port"][4])


def test_elastic_rescale_preserves_trajectory(runs):
    """3 steps on 4 x 2, a checkpoint (gathered DTensors), a restore onto
    the surviving 2 x 2 and 3 more steps give the 6-step run's params."""
    for r in runs["port"][:4]:
        assert int(r["ckpt_step"]) == 3
        got, want = _leaves_of(r, "elastic"), _leaves_of(r, "elastic_ref")
        worst = max(float(np.abs(a - b).max()) for a, b in zip(got, want))
        assert worst < 1e-4, worst
        assert abs(float(r["elastic_loss"]) - float(r["elastic_ref_loss"])) \
            < 1e-4


def test_elastic_trajectory_matches_reference(runs):
    """The port's elastic run against the reference's, six AdamW steps
    apart from the same init (each step's lr quanta, as the sharded
    step's bound)."""
    ref = runs["ref"]
    r = runs["port"][0]
    for port_key, ref_key in (("elastic", "elastic"),
                              ("elastic_ref", "elastic_ref")):
        worst = max(float(np.abs(a - b).max()) for a, b in
                    zip(_leaves_of(r, port_key), _leaves_of(ref, ref_key)))
        assert worst < 6 * 3e-3, (port_key, worst)
    assert abs(float(r["elastic_loss"]) - float(ref["elastic_loss"])) \
        < 5e-3
