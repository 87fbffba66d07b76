"""Data substrate: the SSB benchmark, synthetic star schemas, the query
registry, the LM token pipeline."""
from .ssb import SSBData, generate as generate_ssb
from .ssb_queries import (PREDICTIVE_QUERIES, QUERIES, QUERY_IR,
                          compiled_plan, predictive_query_names,
                          query_groups, ssb_catalog, ssb_session)
from .synthetic import SyntheticStar, cardinalities, generate as generate_star
from .tokens import TokenPipeline, TokenPipelineConfig, make_global_batch

__all__ = ["SSBData", "generate_ssb", "QUERIES", "QUERY_IR",
           "PREDICTIVE_QUERIES", "compiled_plan", "predictive_query_names",
           "query_groups", "ssb_catalog", "ssb_session", "SyntheticStar",
           "cardinalities", "generate_star", "TokenPipeline",
           "TokenPipelineConfig", "make_global_batch"]
