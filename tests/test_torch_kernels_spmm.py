"""Port parity: the four SpMM kernels' wrappers (K1, K2, K5, K6).

On the CPU each wrapper runs its kernel's plain version; it is held to
the JAX package's Pallas kernel run in interpret mode on the same numpy
inputs.  Tolerance: rtol 1e-5, atol 1e-5 (f32 sums in another order).
The CUDA kernels themselves are held to the same plain versions on the
card by ``chip_smoke.py`` and ``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.formats import BlockELL as JBlockELL
from repro.core.formats import SellCS as JSellCS
from repro.kernels.fused.epilogue import Epilogue as JEpilogue
from repro.kernels.fused.spmm import spmm_blockell_fused as j_ell_fused
from repro.kernels.fused.spmm import spmm_sell_fused as j_sell_fused
from repro.kernels.spmm.ops import spmm_blockell as j_spmm_blockell
from repro.kernels.spmm.sell import spmm_sell_blocked as j_spmm_sell
from repro_torch.core.formats import BlockELL, SellCS
from repro_torch.kernels.fused.epilogue import Epilogue
from repro_torch.kernels.fused.spmm import (spmm_blockell_epilogue_kernel,
                                            spmm_blockell_fused,
                                            spmm_sell_epilogue_kernel,
                                            spmm_sell_fused)
from repro_torch.kernels.spmm.kernel import spmm_blockell_kernel
from repro_torch.kernels.spmm.ops import spmm_blockell
from repro_torch.kernels.spmm.sell import (sell_row_ptr, spmm_sell_blocked,
                                           spmm_sell_kernel)
from repro_torch.sparse.paths import pad_rows

TOL = dict(rtol=1e-5, atol=1e-5)
M, N, BLOCK = 45, 40, (8, 8)  # ragged: M and N are not multiples of 8
EPILOGUES = [(act, has_bias, has_res)
             for act in ("identity", "relu", "leaky_relu")
             for has_bias in (False, True) for has_res in (False, True)]
WRAPPERS = (spmm_blockell_kernel, spmm_sell_kernel,
            spmm_blockell_epilogue_kernel, spmm_sell_epilogue_kernel)


def _inputs(seed, d, density=0.15):
    rng = np.random.default_rng(seed)
    a = np.where(rng.random((M, N)) < density, rng.normal(size=(M, N)),
                 0.0).astype(np.float32)
    a[7] = 0.0  # an empty row (pruned by the SELL packing)
    h = rng.normal(size=(N, d)).astype(np.float32)
    bias = rng.normal(size=(d,)).astype(np.float32)
    res = rng.normal(size=(M, d)).astype(np.float32)
    return a, h, bias, res


def _epilogues(act, has_bias, has_res):
    slope = 0.2 if act == "leaky_relu" else 0.01
    kw = dict(act=act, negative_slope=slope, has_bias=has_bias,
              has_residual=has_res)
    return JEpilogue(**kw), Epilogue(**kw)


@pytest.mark.parametrize("d", [4, 16, 32])
def test_k1_blockell_matches_pallas(d):
    a, h, _, _ = _inputs(0, d)
    jell = JBlockELL.from_dense(a, *BLOCK)
    ell = BlockELL.from_dense(a, *BLOCK, device="cpu")
    hp = pad_rows(torch.from_numpy(h), ell.shape[1])
    ref = j_spmm_blockell(jell, jnp.asarray(hp.numpy()), use_kernel=True,
                          interpret=True)
    out = spmm_blockell(ell, hp)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(out.numpy()[:M], a @ h, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("d", [4, 16, 32])
def test_k2_sell_matches_pallas(d):
    a, h, _, _ = _inputs(1, d)
    jsell = JSellCS.from_dense(a, block=BLOCK)
    sell = SellCS.from_dense(a, block=BLOCK, device="cpu")
    ref = j_spmm_sell(jsell, jnp.asarray(h), interpret=True)
    out = spmm_sell_blocked(sell, torch.from_numpy(h))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


# every epilogue at D=16, and the full one at the other widths
CASES = [(spec, 16) for spec in EPILOGUES] \
    + [(("relu", True, True), d) for d in (4, 32)]


@pytest.mark.parametrize("spec,d", CASES)
def test_k5_blockell_epilogue_matches_pallas(spec, d):
    a, h, bias, res = _inputs(2, d)
    jepi, epi = _epilogues(*spec)
    b = bias if epi.has_bias else None
    r = res if epi.has_residual else None
    jell = JBlockELL.from_dense(a, *BLOCK)
    ell = BlockELL.from_dense(a, *BLOCK, device="cpu")
    hp = pad_rows(torch.from_numpy(h), ell.shape[1])
    ref = j_ell_fused(jell, jnp.asarray(hp.numpy()), jepi,
                      None if b is None else jnp.asarray(b),
                      None if r is None else jnp.asarray(r), interpret=True)
    out = spmm_blockell_fused(
        ell, hp, epi, None if b is None else torch.from_numpy(b),
        None if r is None else torch.from_numpy(r))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("spec,d", CASES)
def test_k6_sell_epilogue_matches_pallas(spec, d):
    a, h, bias, res = _inputs(3, d)
    jepi, epi = _epilogues(*spec)
    b = bias if epi.has_bias else None
    r = res if epi.has_residual else None
    jsell = JSellCS.from_dense(a, block=BLOCK)
    sell = SellCS.from_dense(a, block=BLOCK, device="cpu")
    ref = j_sell_fused(jsell, jnp.asarray(h), jepi,
                       None if b is None else jnp.asarray(b),
                       None if r is None else jnp.asarray(r), interpret=True)
    out = spmm_sell_fused(
        sell, torch.from_numpy(h), epi,
        None if b is None else torch.from_numpy(b),
        None if r is None else torch.from_numpy(r))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_sell_without_live_tiles():
    a = np.zeros((20, 12), np.float32)
    sell = SellCS.from_dense(a, block=BLOCK, device="cpu")
    jsell = JSellCS.from_dense(a, block=BLOCK)
    h = np.ones((12, 4), np.float32)
    bias = np.arange(4, dtype=np.float32) - 1.5
    jepi, epi = _epilogues("relu", True, False)
    out = spmm_sell_fused(sell, torch.from_numpy(h), epi,
                          torch.from_numpy(bias))
    ref = j_sell_fused(jsell, jnp.asarray(h), jepi, jnp.asarray(bias),
                       interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    assert not spmm_sell_blocked(sell, torch.from_numpy(h)).any()


def test_cpu_path_launches_no_kernel():
    a, h, bias, _ = _inputs(4, 16)
    before = [w.launches for w in WRAPPERS]
    ell = BlockELL.from_dense(a, *BLOCK, device="cpu")
    sell = SellCS.from_dense(a, block=BLOCK, device="cpu")
    hp = pad_rows(torch.from_numpy(h), ell.shape[1])
    _, epi = _epilogues("relu", True, False)
    spmm_blockell(ell, hp)
    spmm_blockell_fused(ell, hp, epi, torch.from_numpy(bias))
    spmm_sell_blocked(sell, torch.from_numpy(h))
    spmm_sell_fused(sell, torch.from_numpy(h), epi, torch.from_numpy(bias))
    assert [w.launches for w in WRAPPERS] == before


def test_wrappers_refuse_other_devices():
    """Tensors that are neither on the CPU nor on CUDA get no kernel and
    no plain version."""
    meta = dict(device="meta")
    idx = torch.zeros((2, 1), dtype=torch.int32, **meta)
    blocks = torch.zeros((2, 1, 8, 8), **meta)
    h = torch.zeros((8, 4), **meta)
    with pytest.raises(ValueError, match="neither CPU"):
        spmm_blockell_kernel(idx, blocks, h)
    with pytest.raises(ValueError, match="neither CPU"):
        spmm_sell_kernel(idx[:, 0], idx[:, 0], blocks[:, 0], h,
                         n_live_block_rows=1)


def test_epilogue_operands_must_match_spec():
    a, h, bias, _ = _inputs(5, 4)
    ell = BlockELL.from_dense(a, *BLOCK, device="cpu")
    hp = pad_rows(torch.from_numpy(h), ell.shape[1])
    _, epi = _epilogues("relu", True, False)
    with pytest.raises(ValueError, match="disagrees"):
        spmm_blockell_epilogue_kernel(ell.indices, ell.blocks, hp, None,
                                      None, epi=epi)


def test_sell_row_ptr_requires_ascending_rows():
    rows = torch.tensor([0, 0, 1, 3, 3], dtype=torch.int32)
    assert sell_row_ptr(rows, 4).tolist() == [0, 2, 3, 3, 5]
    with pytest.raises(ValueError, match="non-decreasing"):
        sell_row_ptr(torch.tensor([0, 2, 1], dtype=torch.int32), 3)
    with pytest.raises(ValueError, match="non-decreasing"):
        sell_row_ptr(rows, 3)
