"""mfu.<op>: the FLOPs the model needs a request or step (the
configuration's ``work`` module: the dense products and 2·nnz·width a
sparse product) over the window's time a unit at 165 TFLOP/s (3×TF32, the
card's fastest float32-accurate rate), in %.  Bounds every kernel's
roofline from the whole request's or step's side.  It is read, as every
per-layer metric is, in the traced run: under the profiler, whose host
overhead slows a host-paced request by some per cent."""
from bench.work.ops import flops
from bench.work.peaks import PEAK_F32_FLOP_PER_S


def read(run):
    tr, win = run.trace, run.window
    if tr is None or win.units <= 0 or not tr.device:
        return None
    cfg = run.cell.config
    need = flops(run.work.sparse_ops(cfg, win.op, run.shape)) \
        + flops(run.work.dense_ops(cfg, win.op, run.shape))
    return 100.0 * need / (win.window_s / win.units * PEAK_F32_FLOP_PER_S)
