"""infer_nodes_per_s: nodes classified per second, the nodes of every
request the window completed over the window's length (host clock)."""


def read(run):
    win = run.window
    if win.op != "infer" or win.window_s <= 0:
        return None
    return win.items / win.window_s
