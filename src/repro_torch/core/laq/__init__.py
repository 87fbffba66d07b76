"""LAQ: relational query processing as linear algebra (paper §2), in torch."""
from .table import PAD_KEY, Table
from .projection import mapping_matrix
from .selection import Pred, select, selection_vector
from .domain import (DomainCache, default_domain_cache, key_domain,
                     positions)
from .catalog import (Catalog, CatalogHistoryError, CatalogReadOnlyError,
                      ChangedSpans, TableDelta, changed_spans)
from .join import (FactoredJoin, PKIndex, join_factored, mmjoin_dense,
                   onehot_keys, pk_index, stack_joins)
from .aggregation import (PAD_GROUP, auto_num_groups, composite_code,
                          decode_composite, groupby_codes, matmul_aggregate,
                          segment_aggregate, segment_reduce)
from .star import DimSpec, StarJoin, dim_mapping_matrices, star_join

__all__ = [
    "Table", "PAD_KEY", "mapping_matrix", "Pred", "select",
    "selection_vector", "DomainCache", "default_domain_cache", "key_domain",
    "positions", "Catalog", "CatalogHistoryError", "CatalogReadOnlyError",
    "ChangedSpans", "TableDelta", "changed_spans", "FactoredJoin", "PKIndex",
    "join_factored", "mmjoin_dense", "onehot_keys", "pk_index", "stack_joins",
    "PAD_GROUP", "auto_num_groups", "composite_code", "decode_composite",
    "groupby_codes", "matmul_aggregate", "segment_aggregate",
    "segment_reduce", "DimSpec", "StarJoin", "dim_mapping_matrices",
    "star_join",
]
