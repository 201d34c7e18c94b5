"""Port parity: the corpus (``repro_torch.corpus``) and the bench helpers
(``data.pipeline.random_sparse_dense``, ``core.formats``'s stream-element
counts, ``dispatch.stats.sparsity_bucket``) against the reference's, on
the same specs and seeds: the same arrays bit for bit, the same forms,
stats and auto-picked formats."""
import dataclasses

import numpy as np
import pytest

from repro.core import formats as j_formats
from repro.corpus import CorpusSpec as JCorpusSpec
from repro.corpus import default_corpus as j_default_corpus
from repro.corpus import make_dense as j_make_dense
from repro.corpus import make_matrix as j_make_matrix
from repro.data.pipeline import random_sparse_dense as j_random_sparse_dense
from repro.dispatch.stats import sparsity_bucket as j_sparsity_bucket
from repro_torch.core import formats
from repro_torch.corpus import (FAMILIES, CorpusSpec, default_corpus,
                                make_dense, make_matrix)
from repro_torch.data.pipeline import random_sparse_dense
from repro_torch.dispatch.stats import sparsity_bucket

# a spec per family and sparsity, with the knobs off their defaults too
SPECS = [dict(family=f, shape=(96, 80), sparsity=s, seed=7)
         for f in FAMILIES for s in (0.9, 0.99)] + [
    dict(family="powerlaw", shape=(64, 64), alpha=2.0, seed=3),
    dict(family="banded", shape=(70, 70), band_width=5, sparsity=0.5),
    dict(family="block_pruned", shape=(64, 48), block=(4, 16), seed=2),
    dict(family="rmat", shape=(128, 128), rmat_probs=(0.4, 0.3, 0.2, 0.1)),
]
IDS = ["-".join(f"{v}" for v in spec.values()) for spec in SPECS]


@pytest.mark.parametrize("kw", SPECS, ids=IDS)
def test_make_dense_matches_reference(kw):
    got = make_dense(CorpusSpec(**kw))
    want = j_make_dense(JCorpusSpec(**kw))
    assert got.dtype == want.dtype
    assert np.array_equal(got, want)


def test_spec_contract_matches_reference():
    spec, jspec = CorpusSpec("rmat", seed=4), JCorpusSpec("rmat", seed=4)
    assert dataclasses.asdict(spec) == dataclasses.asdict(jspec)
    assert (spec.name, spec.target_nnz) == (jspec.name, jspec.target_nnz)
    for bad in (dict(family="nope"), dict(family="uniform", sparsity=1.5)):
        with pytest.raises(ValueError):
            CorpusSpec(**bad)
        with pytest.raises(ValueError):
            JCorpusSpec(**bad)
    assert [dataclasses.asdict(s) for s in default_corpus(quick=False,
                                                          seed=2)] \
        == [dataclasses.asdict(s) for s in j_default_corpus(quick=False,
                                                            seed=2)]


def _stats(mat):
    return dataclasses.asdict(mat.stats)


@pytest.mark.parametrize("spec", default_corpus(), ids=lambda s: s.name)
def test_make_matrix_auto_format_matches_reference(spec):
    """``formats=None``: the cost model picks one form from the measured
    structure, the same as the reference's."""
    got = make_matrix(spec, formats=None, device="cpu")
    want = j_make_matrix(JCorpusSpec(**dataclasses.asdict(spec)),
                         formats=None)
    assert got.formats == want.formats
    assert _stats(got) == _stats(want)
    np.testing.assert_array_equal(got.to_dense(), np.asarray(want.to_dense()))


@pytest.mark.parametrize("family", FAMILIES)
def test_make_matrix_forms_match_reference(family):
    spec = CorpusSpec(family=family, shape=(96, 80), sparsity=0.95, seed=5)
    got = make_matrix(spec, block=(16, 16), device="cpu")
    want = j_make_matrix(JCorpusSpec(**dataclasses.asdict(spec)),
                         block=(16, 16))
    assert got.formats == want.formats == ("ell", "sell", "csr")
    assert _stats(got) == _stats(want)
    for name in got.formats:
        np.testing.assert_array_equal(got.to(name).to_dense(),
                                      np.asarray(want.to(name).to_dense()))
    ell, jell = got.form("ell"), want.form("ell")
    np.testing.assert_array_equal(ell.indices.numpy(),
                                  np.asarray(jell.indices))
    np.testing.assert_array_equal(ell.nblocks.numpy(),
                                  np.asarray(jell.nblocks))
    sell, jsell = got.form("sell"), want.form("sell")
    for field in ("slot_cols", "slot_rows", "slot_vals", "out_gather"):
        np.testing.assert_array_equal(getattr(sell, field).numpy(),
                                      np.asarray(getattr(jsell, field)))


@pytest.mark.parametrize("n,density,seed,m", [(64, 0.1, 0, None),
                                              (50, 0.5, 3, 30),
                                              (128, 0.01, 9, None)])
def test_random_sparse_dense_matches_reference(n, density, seed, m):
    got = random_sparse_dense(n, density, seed=seed, m=m)
    want = j_random_sparse_dense(n, density, seed=seed, m=m)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("chunk,per_pe", [(16, 16), (32, 24), (7, 100)])
def test_stream_element_counts_match_reference(family, chunk, per_pe):
    a = make_dense(CorpusSpec(family=family, shape=(96, 80), sparsity=0.9))
    got = formats.sellpack_stream_elements(formats.CSR.from_dense(a), chunk,
                                           per_pe)
    want = j_formats.sellpack_stream_elements(j_formats.CSR.from_dense(a),
                                              chunk, per_pe)
    assert got == want
    ell = formats.BlockELL.from_dense(a, 16, 16, device="cpu")
    assert formats.blockell_stream_elements(ell) \
        == j_formats.blockell_stream_elements(
            j_formats.BlockELL.from_dense(a, 16, 16))


@pytest.mark.parametrize("per_decade", [1, 2, 3])
def test_sparsity_bucket_matches_reference(per_decade):
    densities = [0.0, 1e-12, 1e-9, 3e-5, 1e-3, 0.0099, 0.01, 0.05, 0.3,
                 0.5, 0.99, 1.0, 2.0]
    got = [sparsity_bucket(d, per_decade) for d in densities]
    assert got == [j_sparsity_bucket(d, per_decade) for d in densities]
    assert all(isinstance(b, int) for b in got)
