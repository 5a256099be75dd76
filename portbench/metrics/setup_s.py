"""Seconds from the start of the process to the window's opening: imports,
kernel builds, weights, the server and the warm phase."""


def read(run):
    return run.setup_s
