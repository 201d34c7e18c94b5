"""train_step_ms: the window over the steps it completed (steps dispatched
back to back, one synchronisation at the window's end; host clock)."""


def read(run):
    if run.window.op != "train" or run.window.units <= 0:
        return None
    return run.window.window_s / run.window.units * 1e3
