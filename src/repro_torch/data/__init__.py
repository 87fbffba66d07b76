"""Data substrate: the SSB benchmark, synthetic star schemas, the query
registry."""
from .ssb import SSBData, generate as generate_ssb
from .ssb_queries import (QUERY_IR, predictive_query_names, query_groups,
                          ssb_catalog)
from .synthetic import SyntheticStar, cardinalities, generate as generate_star

__all__ = ["SSBData", "generate_ssb", "QUERY_IR", "predictive_query_names",
           "query_groups", "ssb_catalog", "SyntheticStar", "cardinalities",
           "generate_star"]
