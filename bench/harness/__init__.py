"""The general code of the benchmark: the spec, what a window driver is
handed and hands back, the trace reduction, the correctness check and the
result line."""
