"""LAQ + ML operator fusion + the predictive-query compiler, in torch."""
from . import fusion, laq, query

__all__ = ["laq", "fusion", "query"]
