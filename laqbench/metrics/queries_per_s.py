"""Queries completed in the window over the window's host seconds."""


def read(run):
    return run.answered / run.window_s
