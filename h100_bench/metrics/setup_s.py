"""Process start to window start: imports, CUDA start-up, kernel builds
or loads, inputs, the program's objects and the warm-up."""


def read(rec):
    return rec["setup_s"]
