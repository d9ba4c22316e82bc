"""setup_s: from the process's start to the first timed call: imports,
inputs, tables, the program's set-up (upload, a fit read from or
written to its cache, a kernel build the first time) and the warm-up
calls."""


def read(run):
    return run.setup_s
