"""LAQ: relational query processing as linear algebra (paper §2), in torch."""
from .table import PAD_KEY, Table
from .projection import mapping_matrix, project_gather, project_matmul
from .selection import Pred, select, selection_vector
from .domain import (DomainCache, default_domain_cache, key_domain,
                     positions)
from .catalog import (Catalog, CatalogHistoryError, CatalogReadOnlyError,
                      ChangedSpans, TableDelta, changed_spans)
from .join import (FactoredJoin, PKIndex, ShardedPKIndex, join_factored,
                   matching_pairs, materialize_gather, materialize_matmul,
                   mmjoin_bcoo, mmjoin_dense, onehot_keys, pk_index,
                   row_mapping_matrices, shard_pk_index, stack_joins)
from .aggregation import (PAD_GROUP, auto_num_groups, composite_code,
                          decode_composite, groupby_codes, groupby_reduce,
                          groupby_sum_matmul, groupby_sum_segment,
                          matmul_aggregate, segment_aggregate, segment_reduce)
from .sort import order_by, sorted_domain_order
from .star import (DimSpec, StarJoin, dim_mapping_matrices, shard_rows,
                   star_join)

__all__ = [
    "Table", "PAD_KEY", "mapping_matrix", "project_matmul",
    "project_gather", "Pred", "select",
    "selection_vector", "DomainCache", "default_domain_cache", "key_domain",
    "positions", "Catalog", "CatalogHistoryError", "CatalogReadOnlyError",
    "ChangedSpans", "TableDelta", "changed_spans", "FactoredJoin", "PKIndex",
    "join_factored", "mmjoin_dense", "mmjoin_bcoo", "onehot_keys",
    "matching_pairs", "row_mapping_matrices", "materialize_matmul",
    "materialize_gather", "pk_index", "stack_joins", "ShardedPKIndex",
    "shard_pk_index",
    "groupby_sum_matmul", "groupby_sum_segment", "groupby_reduce",
    "PAD_GROUP", "auto_num_groups", "composite_code", "decode_composite",
    "groupby_codes", "matmul_aggregate", "segment_aggregate",
    "segment_reduce", "order_by", "sorted_domain_order", "DimSpec",
    "StarJoin", "dim_mapping_matrices", "shard_rows", "star_join",
]
