"""kernel_roofline.<op>: the least time of the sparse products a request
or step performs (the configuration's ``work`` module: bytes at 3.35 TB/s
or FLOPs at 165 TFLOP/s, the larger, each product at its own width) over
the device time of the port's own kernels a request or step, in %.
Silent where no port kernel ran."""
from bench.harness.trace import is_port_kernel
from bench.work.ops import least_s


def read(run):
    tr = run.trace
    if tr is None or run.window.units <= 0:
        return None
    port_s = tr.device_s(is_port_kernel) / run.window.units
    if port_s <= 0:
        return None
    ops = run.work.sparse_ops(run.cell.config, run.window.op, run.shape)
    return 100.0 * least_s(ops) / port_s
