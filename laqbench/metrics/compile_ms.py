"""Host milliseconds of every ``compile_query`` the cell makes, each
ending in a synchronize, summed over its plans."""


def read(run):
    return sum(run.compile_ms.values()) if run.compile_ms else None
