"""CSV matrices in the JAX CLI's layout, with the csv module and numpy.

Counterpart of osteosarcoma_diffusionmodel_tpu/utils/io.py without
pandas: a header row of column names, optionally a leading index column
(sample ids), then one row of numbers per sample. Floats are written
with ``%.6g`` like the JAX package's synthetic tables.
"""

from __future__ import annotations

import csv
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

FLOAT_FORMAT = "%.6g"


@dataclass
class Matrix:
    """A (samples x features) table: values plus column names (and row ids)."""

    values: np.ndarray
    columns: List[str]
    index: Optional[List[str]] = None

    def column(self, name: str) -> np.ndarray:
        return self.values[:, self.columns.index(name)]


def read_matrix_csv(path: str | Path, index_col: Optional[int] = 0) -> Matrix:
    """Read a numeric table; ``index_col=0`` takes the first column as row
    ids (the processed tables), ``None`` reads every column as data (the
    synthetic tables). Empty cells read as NaN."""
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        rows = [r for r in reader if r]
    index = None
    if index_col is not None:
        index = [r[index_col] for r in rows]
        rows = [r[:index_col] + r[index_col + 1:] for r in rows]
        header = header[:index_col] + header[index_col + 1:]
    values = np.array(
        [[float(v) if v != "" else np.nan for v in r] for r in rows], dtype=np.float64
    ).reshape(len(rows), len(header))
    return Matrix(values, list(header), index)


def write_matrix_csv(path: str | Path, values: np.ndarray, columns: Sequence[str],
                     index: Optional[Sequence[str]] = None, index_label: str = "",
                     fmt: str = FLOAT_FORMAT) -> None:
    values = np.asarray(values)
    if values.ndim != 2 or values.shape[1] != len(columns):
        raise ValueError(f"{values.shape} values for {len(columns)} columns")
    with open(path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(([index_label] if index is not None else []) + list(columns))
        for i, row in enumerate(values):
            cells = [fmt % v for v in row.tolist()]
            writer.writerow(([index[i]] if index is not None else []) + cells)
