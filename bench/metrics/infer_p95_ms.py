"""infer_p95_ms: the 95th percentile of every request of the window, each
timed on the host's clock from the call into the program to the return of
the synchronisation that waits for its answer."""
import statistics


def read(run):
    lat = run.window.latencies_ms
    if run.window.op != "infer" or len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=20, method="inclusive")[18]
