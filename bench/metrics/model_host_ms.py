"""model_host_ms.<op>: host milliseconds a request or step inside the
port's ``gnn.layer`` spans, less the ``sparse.dispatch`` spans they hold:
the model's own Python and the launches of its products (the dense
transforms, GAT's scores, the sparse products, the activations), over
the traced window."""
from bench.harness.spans import named, overlap_s, union

LAYER, DISPATCH = "gnn.layer", "sparse.dispatch"


def read(run):
    tr = run.trace
    if tr is None or run.window.units <= 0:
        return None
    layers = named(tr, LAYER)
    if not layers:
        return None
    dispatch = union(named(tr, DISPATCH))
    starts = [a for a, _ in dispatch]
    own = sum(e.dur - overlap_s(dispatch, starts, e.start, e.end)
              for e in layers)
    return own / run.window.units * 1e3
