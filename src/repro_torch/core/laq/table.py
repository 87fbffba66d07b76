"""Table-as-matrix representation for LAQ (port of ``repro.core.laq.table``).

Two synchronized views of a relation, as in the reference:

* ``matrix`` — the (capacity × cols) float32 matrix the LA operators read;
* ``keys``   — exact int32 join/group key columns (float32 is only exact
  below 2**24, so no key round-trips through a float).

A Table may be padded: ``nvalid`` rows are live, the rest are zero rows with
key ``PAD_KEY``.  Every LAQ operator preserves this invariant.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from ...device import DeviceLike, resolve_device

# Padding sentinel for key columns: int32 max sorts after every real key.
PAD_KEY = 2**31 - 1


@dataclasses.dataclass(frozen=True)
class Table:
    """An immutable relation in LAQ (matrix) form.

    Attributes:
      name:    relation name.
      columns: ordered column names; ``matrix[:, i]`` is ``columns[i]``.
      matrix:  (capacity, len(columns)) float32.
      keys:    key-column name -> (capacity,) int32 exact values.
      nvalid:  number of live rows; rows >= nvalid are padding.
    """

    name: str
    columns: tuple
    matrix: torch.Tensor
    keys: Mapping[str, torch.Tensor]
    nvalid: int

    @staticmethod
    def from_columns(name: str, cols: Mapping[str, np.ndarray],
                     key_cols: Sequence[str] = (),
                     capacity: Optional[int] = None,
                     device: DeviceLike = None) -> "Table":
        """Build a Table from named 1-D columns (all equal length).

        Runs on ``cuda`` unless ``device`` says otherwise.
        """
        dev = resolve_device(device)
        names = tuple(cols.keys())
        n = int(np.asarray(next(iter(cols.values()))).shape[0])
        cap = capacity if capacity is not None else n
        if cap < n:
            raise ValueError(f"capacity {cap} < rows {n}")
        mat = np.zeros((cap, len(names)), np.float32)
        for j, c in enumerate(names):
            mat[:n, j] = np.asarray(cols[c], np.float32)
        keys = {}
        for c in key_cols:
            k = np.full((cap,), PAD_KEY, np.int32)
            k[:n] = np.asarray(cols[c], np.int32)
            keys[c] = torch.from_numpy(k).to(dev)
        return Table(name, names, torch.from_numpy(mat).to(dev), keys, n)

    @property
    def device(self) -> torch.device:
        return self.matrix.device

    @property
    def capacity(self) -> int:
        return int(self.matrix.shape[0])

    @property
    def ncols(self) -> int:
        return int(self.matrix.shape[1])

    def col_index(self, col: str) -> int:
        return self.columns.index(col)

    def col(self, col: str) -> torch.Tensor:
        """Float view of a column."""
        return self.matrix[:, self.col_index(col)]

    def key(self, col: str) -> torch.Tensor:
        """Exact int32 view of a key column."""
        return self.keys[col]

    def valid_mask(self) -> torch.Tensor:
        return torch.arange(self.capacity, device=self.device) < self.nvalid
