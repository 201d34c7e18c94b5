"""dispatch_ms.<op>: host milliseconds a request or step inside the port's
``sparse.dispatch`` spans (each sparse op's front end up to its autograd
``apply``: operand checks, the epilogue and policy, the plan, its record
and the values read; and the backward rules' plan records), over the
traced window.  Spans that overlap count their union once."""
from bench.harness.spans import named, union

SPAN = "sparse.dispatch"


def read(run):
    tr = run.trace
    if tr is None or run.window.units <= 0:
        return None
    spans = union(named(tr, SPAN))
    if not spans:
        return None
    return sum(b - a for a, b in spans) / run.window.units * 1e3
