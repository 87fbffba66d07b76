"""Table-as-matrix representation for LAQ (port of ``repro.core.laq.table``).

Two synchronized views of a relation, as in the reference:

* ``matrix`` — the (capacity × cols) float32 matrix the LA operators read;
* ``keys``   — exact int32 join/group key columns (float32 is only exact
  below 2**24, so no key round-trips through a float).

A Table may be padded: ``nvalid`` rows are live, the rest are zero rows with
key ``PAD_KEY``.  Every LAQ operator preserves this invariant.

Mutation is functional (the Catalog's substrate): ``append_rows``,
``delete_rows``, ``compacted`` and ``update_column`` return a new Table on
the same device and never write into a tensor the old Table holds, so a
plan built on the old version keeps computing from it until it refreshes.
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
      deleted: optional (capacity,) bool tombstone mask.  A tombstoned row
               keeps its slot, data and key, so deletion is a pure
               validity fold; ``compacted()`` reclaims the slots.
    """

    name: str
    columns: tuple
    matrix: torch.Tensor
    keys: Mapping[str, torch.Tensor]
    nvalid: int
    deleted: Optional[torch.Tensor] = None

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
        m = torch.arange(self.capacity, device=self.device) < self.nvalid
        if self.deleted is not None:
            m = m & ~self.deleted
        return m

    @property
    def num_deleted(self) -> int:
        """Count of tombstoned rows (0 when no deletions have happened)."""
        return 0 if self.deleted is None else int(self.deleted.sum())

    @property
    def num_live(self) -> int:
        """Live (non-deleted) rows."""
        return int(self.nvalid) - self.num_deleted

    def with_matrix(self, matrix: torch.Tensor, columns=None) -> "Table":
        return dataclasses.replace(
            self, matrix=matrix, columns=tuple(columns or self.columns))

    # -- functional mutation (the Catalog's append/update substrate) ---------
    def _ids(self, row_ids, n: int, what: str) -> torch.Tensor:
        """Row ids as an int64 tensor on the table's device, each in the
        live range ``[0, n)``."""
        ids = torch.as_tensor(np.asarray(row_ids, np.int64).reshape(-1),
                              device=self.device)
        if ids.numel() and bool(((ids < 0) | (ids >= n)).any()):
            raise ValueError(
                f"{what} on {self.name!r}: row ids out of the live range "
                f"[0, {n})")
        return ids

    def append_rows(self, cols: Mapping[str, np.ndarray], *,
                    capacity: Optional[int] = None) -> "Table":
        """A new Table with ``cols`` appended after the live rows.

        ``cols`` must name every matrix column (key columns update both
        views).  Rows land in the padding region when they fit; otherwise
        ``capacity`` (default: geometric growth, ``max(2·cap, n+m)``)
        reallocates — a shape change, which compiled plans handle by
        recompiling.  ``self`` is unchanged.
        """
        n = int(self.nvalid)
        missing = [c for c in self.columns if c not in cols]
        if missing:
            raise ValueError(
                f"append to {self.name!r} missing columns {missing} "
                f"(need all of {list(self.columns)})")
        unknown = [c for c in cols if c not in self.columns]
        if unknown:
            raise ValueError(
                f"append to {self.name!r}: unknown columns {unknown} "
                f"(columns: {list(self.columns)})")
        vals = {c: _host(cols[c]).reshape(-1) for c in cols}
        m = vals[self.columns[0]].shape[0]
        ragged = [c for c, v in vals.items() if v.shape[0] != m]
        if ragged:
            raise ValueError(
                f"append to {self.name!r}: ragged columns {ragged} "
                f"(expected {m} rows each)")
        new_n = n + m
        cap = self.capacity
        if new_n > cap:
            cap = capacity if capacity is not None else max(2 * cap, new_n)
        if new_n > cap:
            raise ValueError(
                f"append to {self.name!r}: {new_n} rows exceed requested "
                f"capacity {cap}")
        dev = self.device
        block = np.zeros((m, self.ncols), np.float32)
        for j, c in enumerate(self.columns):
            block[:, j] = vals[c].astype(np.float32)
        # Fresh tensors either way: the old Table's stay untouched.
        matrix = torch.zeros((cap, self.ncols), dtype=self.matrix.dtype,
                             device=dev)
        matrix[:n] = self.matrix[:n]
        matrix[n:new_n] = torch.from_numpy(block).to(dev)
        keys = {}
        for c, k in self.keys.items():
            buf = torch.full((cap,), PAD_KEY, dtype=k.dtype, device=dev)
            buf[:n] = k[:n]
            buf[n:new_n] = torch.from_numpy(
                vals[c].astype(np.int32)).to(dev)
            keys[c] = buf
        deleted = self.deleted
        if deleted is not None and cap != self.capacity:
            buf = torch.zeros((cap,), dtype=torch.bool, device=dev)
            buf[:self.capacity] = deleted
            deleted = buf
        return Table(self.name, self.columns, matrix, keys, new_n, deleted)

    def delete_rows(self, row_ids) -> "Table":
        """A new Table with ``row_ids`` tombstoned (validity-masked out).

        Shapes, row placement, keys and data are unchanged — deletion is a
        pure fold on :meth:`valid_mask`, so PK indices, join pointers and
        prefused partials stay valid and a compiled plan absorbs it as a
        shape-preserving delta.  :meth:`compacted` reclaims the slots.
        """
        ids = self._ids(row_ids, int(self.nvalid), "delete_rows")
        dead = (torch.zeros((self.capacity,), dtype=torch.bool,
                            device=self.device)
                if self.deleted is None else self.deleted.clone())
        dead[ids] = True
        return dataclasses.replace(self, deleted=dead)

    def compacted(self) -> "Table":
        """A new Table with tombstoned rows physically removed.

        Live rows pack down into ``[0, num_live)`` in order, the capacity
        is kept and the tombstone mask dropped.  Row ids change, so every
        pointer-based artifact must be rebuilt.
        """
        n = int(self.nvalid)
        if self.deleted is None or not self.num_deleted:
            return dataclasses.replace(self, deleted=None)
        keep = ~self.deleted[:n]
        new_n = int(keep.sum())
        matrix = torch.zeros_like(self.matrix)
        matrix[:new_n] = self.matrix[:n][keep]
        keys = {}
        for c, k in self.keys.items():
            buf = torch.full_like(k, PAD_KEY)
            buf[:new_n] = k[:n][keep]
            keys[c] = buf
        return Table(self.name, self.columns, matrix, keys, new_n, None)

    def update_column(self, col: str, row_ids, values) -> "Table":
        """A new Table with ``col`` overwritten at ``row_ids``.

        Key columns cannot be updated in place — changing join keys would
        invalidate every PK index and prefused partial built over them;
        delete-and-append is the path for key churn.
        """
        n = int(self.nvalid)
        if col in self.keys:
            raise ValueError(
                f"update_column on key column {col!r} of {self.name!r} is "
                "not supported: key updates invalidate join indices — "
                "append corrected rows instead")
        if col not in self.columns:
            raise ValueError(
                f"unknown column {col!r} on table {self.name!r} "
                f"(columns: {list(self.columns)})")
        vals = _host(values).astype(np.float32).reshape(-1)
        n_ids = np.asarray(row_ids).reshape(-1).shape[0]
        if n_ids != vals.shape[0]:
            raise ValueError(
                f"update_column on {self.name!r}: {n_ids} row ids vs "
                f"{vals.shape[0]} values")
        ids = self._ids(row_ids, n, "update_column")
        matrix = self.matrix.clone()
        matrix[ids, self.col_index(col)] = torch.from_numpy(vals).to(
            self.device)
        return dataclasses.replace(self, matrix=matrix)

    def to_numpy_valid(self) -> np.ndarray:
        """The live rows on the host (tests and oracles only)."""
        n = int(self.nvalid)
        rows = self.matrix[:n]
        if self.deleted is not None:
            rows = rows[~self.deleted[:n]]
        return rows.cpu().numpy()


def _host(col) -> np.ndarray:
    """A column given as numpy, a list or a tensor, as a numpy array."""
    if isinstance(col, torch.Tensor):
        return col.detach().cpu().numpy()
    return np.asarray(col)
