"""Device kernels in the profiled slice over the queries completed in it."""


def read(run):
    t = run.trace
    if not t or not t["queries"] or not t["kernels"]:
        return None
    return t["kernels"] / t["queries"]
