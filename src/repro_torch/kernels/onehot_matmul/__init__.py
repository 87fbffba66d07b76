"""``onehot_matmul``: join-as-matmul, ``onehot(idx) @ table``."""
from .ops import onehot_matmul
from .ref import onehot_matmul_ref

__all__ = ["onehot_matmul", "onehot_matmul_ref"]
