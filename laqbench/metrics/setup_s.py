"""Host seconds from the start of the process to the first timed query."""


def read(run):
    return run.setup_s
