"""torch_ops_ms.<op>: device milliseconds a request or step in operations
that are not the port's own kernels (cuBLAS, PyTorch's elementwise,
scatter and reduction kernels, copies and fills), over the traced
window."""
from bench.harness.trace import is_port_kernel


def read(run):
    tr = run.trace
    if tr is None or run.window.units <= 0 or not tr.device:
        return None
    return tr.device_s(lambda name: not is_port_kernel(name)) \
        / run.window.units * 1e3
