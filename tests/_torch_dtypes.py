"""bf16 / f16 operands in the port's parity tests: the dtypes, their JAX
counterparts and the comparison both packages are held to.

The reference takes any float dtype, sums in f32 and returns
``jnp.result_type`` of the operands its ``out_dtype`` line names; the
port must return the same dtype.  Values: rtol = atol = 2e-2, the
reference's own bf16 tolerance (``tests/test_kernels_spmm.py::
test_spmm_kernel_bf16``): one bf16 rounding of each operand and of the
result.
"""
import jax.numpy as jnp
import numpy as np
import torch

NARROW_TOL = dict(rtol=2e-2, atol=2e-2)
DTYPES = [torch.float32, torch.bfloat16, torch.float16]
J_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
            torch.float16: jnp.float16}
# (values or q, H or v): each dtype alone, and two mixed pairs
DTYPE_PAIRS = [(dt, dt) for dt in DTYPES] + [
    (torch.bfloat16, torch.float32), (torch.float16, torch.bfloat16)]


def to_jax(t):
    """A torch tensor as a JAX array of the same dtype (exact)."""
    return jnp.asarray(t.float().numpy()).astype(J_DTYPES[t.dtype])


def torch_dtype(jdt):
    return {jnp.dtype(v): k for k, v in J_DTYPES.items()}[jnp.dtype(jdt)]


def result_type(*tensors):
    """The reference's default output dtype for these operands."""
    return torch_dtype(jnp.result_type(*(J_DTYPES[t.dtype]
                                         for t in tensors)))


def assert_narrow_close(got, want):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               **NARROW_TOL)
