"""Process start to the first timed request: the interpreter and torch,
the weights, the reference pools, the program's kernels and the captured
graphs of the cell's bucket."""


def read(window):
    return window.setup_s
