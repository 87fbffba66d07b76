"""Per-architecture configs (assigned pool) + the paper's pipeline configs
(port of ``repro.configs``: data only, the same numbers)."""
from .registry import arch_ids, get_config, get_smoke_config

__all__ = ["arch_ids", "get_config", "get_smoke_config"]
