"""``fused_star_gather``: the fused star pipeline's online phase."""
from .ops import fused_star_gather
from .ref import fused_star_gather_ref

__all__ = ["fused_star_gather", "fused_star_gather_ref"]
