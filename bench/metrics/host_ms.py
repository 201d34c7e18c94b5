"""host_ms.<op>: host milliseconds of one call into the program, from the
call to its return (its work queued, not waited for), the mean over the
traced window.  The driver names the span it opens around each call
(``bench.infer`` around ``engine.infer``, ``bench.train_step`` around the
training step); its length is the host's clock, read by the profiler."""


def read(run):
    spans = run.trace.spans_named(run.window.call_span) if run.trace else []
    if not spans:
        return None
    return sum(s.dur for s in spans) / len(spans) * 1e3
