"""``setup_s``: from the process's start to the first timed call:
interpreter, imports, CUDA context, kernel load (and build, in a fresh
checkout), data, build or index, warm-up."""


def read(rec):
    return rec.setup_s
