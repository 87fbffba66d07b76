"""The model head's share of its roofline: the least time of each model
query's prediction matrix (``roofline.head_work``), summed, over the
summed CUDA-event time of ``CompiledQuery.predictions()``."""


def read(run):
    if not run.head:
        return None
    return 100.0 * (sum(h["least_s"] for h in run.head)
                    / sum(h["measured_s"] for h in run.head))
