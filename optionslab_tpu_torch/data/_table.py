"""The column table the data layer holds a chain as: named 1-D numpy
columns of one length, in insertion order.

Any frame-like input is accepted: a pandas DataFrame, another table, or a
mapping of column name to a 1-D array (scalars broadcast to the length).
:func:`to_frame` gives a pandas DataFrame back where pandas is installed and
the table itself otherwise, so nothing on the path needs pandas.
"""

from __future__ import annotations

import numpy as np


class ColumnTable:
    """Named numpy columns of one length: ``t["col"]`` is the array,
    ``t.take(mask_or_index)`` the rows, ``t["col"] = value`` sets (a scalar
    broadcasts)."""

    def __init__(self, columns=None):
        self._cols: dict = {}
        self._n = None
        for name, value in (columns or {}).items():
            if np.ndim(value) > 0:
                self._n = len(value)
                break
        for name, value in (columns or {}).items():
            self[name] = value

    @classmethod
    def from_frame(cls, frame) -> "ColumnTable":
        """A table of any frame-like input (a copy: the input is not kept)."""
        if isinstance(frame, ColumnTable):
            return frame.copy()
        if hasattr(frame, "columns") and hasattr(frame, "to_numpy"):  # a pandas DataFrame
            return cls({c: frame[c].to_numpy() for c in frame.columns})
        if hasattr(frame, "items"):
            return cls(dict(frame.items()))
        raise TypeError(f"not a frame: {type(frame).__name__}")

    @property
    def columns(self) -> list:
        return list(self._cols)

    def __len__(self) -> int:
        return 0 if self._n is None else self._n

    def __contains__(self, name) -> bool:
        return name in self._cols

    def items(self):
        return self._cols.items()

    def get(self, name, default=None):
        return self._cols.get(name, default)

    def __getitem__(self, name):
        return self._cols[name]

    def __setitem__(self, name, value):
        arr = np.asarray(value)
        if arr.ndim == 0:
            arr = np.full(len(self), arr.item() if arr.dtype.kind != "U" else str(arr),
                          dtype=object if arr.dtype.kind in "OU" else arr.dtype)
        elif arr.ndim != 1:
            raise ValueError(f"column {name!r} must be 1-D, got shape {arr.shape}")
        if self._n is None:
            self._n = len(arr)
        elif len(arr) != self._n:
            raise ValueError(f"column {name!r} has {len(arr)} rows, the table {self._n}")
        self._cols[name] = arr

    def copy(self) -> "ColumnTable":
        out = ColumnTable()
        out._n = self._n
        out._cols = {k: v.copy() for k, v in self._cols.items()}
        return out

    def take(self, rows) -> "ColumnTable":
        """The rows picked by a boolean mask or an integer index array."""
        rows = np.asarray(rows)
        out = ColumnTable()
        out._cols = {k: v[rows] for k, v in self._cols.items()}
        out._n = int(rows.sum()) if rows.dtype == bool else len(rows)
        return out

    def drop(self, columns) -> "ColumnTable":
        columns = [columns] if isinstance(columns, str) else list(columns)
        return ColumnTable({k: v for k, v in self._cols.items() if k not in columns})

    def rename(self, mapping: dict) -> "ColumnTable":
        out = ColumnTable()
        out._n = self._n
        for k, v in self._cols.items():
            out._cols[mapping.get(k, k)] = v
        return out

    def __repr__(self) -> str:
        return f"ColumnTable({len(self)} rows: {', '.join(map(str, self._cols))})"


def as_table(frame) -> ColumnTable:
    """The column table of a frame-like input, or of a dataset's chain."""
    if hasattr(frame, "table"):
        return frame.table
    return ColumnTable.from_frame(frame)


def to_frame(table: ColumnTable):
    """A pandas DataFrame of the table where pandas is installed, else the
    table itself."""
    try:
        import pandas as pd
    except ImportError:
        return table
    return pd.DataFrame({k: v for k, v in table.items()})
