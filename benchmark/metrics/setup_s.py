"""Seconds from the process's start to the window's opening: imports, the card,
the inputs, the files set-up makes, the warm-up (first run: the build)."""


def read(run):
    return run.setup_s
