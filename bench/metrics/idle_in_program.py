"""idle_in_program.<op>: the share of the traced window's device-idle
seconds whose gap begins while one of the port's own spans is open, on
any thread (``harness/spans.py``), in %.  The rest began outside the
program: at the benchmark's sync, or between its calls."""
from bench.harness.spans import open_at, port_spans, union


def read(run):
    tr = run.trace
    if tr is None or not tr.device:
        return None
    spans = union(port_spans(tr))
    if not spans:
        return None
    gaps = tr.idle_gaps()
    idle = sum(length for _, length in gaps)
    if idle <= 0:
        return 0.0
    starts = [a for a, _ in spans]
    inside = sum(length for t, length in gaps if open_at(spans, starts, t))
    return 100.0 * inside / idle
