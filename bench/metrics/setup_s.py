"""setup_s: from the process's start (the first line of ``run.py``) to
the window's start: imports, the kernel build where it is not there yet,
drawing the graph, the program's packing, inputs and warm-up."""


def read(run):
    return run.setup_s
