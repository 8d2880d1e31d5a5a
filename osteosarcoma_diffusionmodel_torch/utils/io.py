"""CSV matrices in the JAX CLI's layout, with the csv module and numpy.

Counterpart of osteosarcoma_diffusionmodel_tpu/utils/io.py without
pandas: a header row of column names, optionally a leading index column
(sample ids), then one row of numbers per sample. Floats are written
with ``%.6g`` like the JAX package's synthetic tables. Column names are
read as ``pandas.read_csv`` names them (:func:`header_names`), so a table
the preprocessor wrote with an empty or a repeated gene name reads the
same here as in the JAX package.
"""

from __future__ import annotations

import csv
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

FLOAT_FORMAT = "%.6g"
# The strings pandas.read_csv reads as a missing value, and as True and
# False, by default.
NA_STRINGS = frozenset([
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
    "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null",
])
TRUE_STRINGS = frozenset(["True", "TRUE", "true"])
FALSE_STRINGS = frozenset(["False", "FALSE", "false"])


@dataclass
class Matrix:
    """A (samples x features) table: values plus column names (and row ids)."""

    values: np.ndarray
    columns: List[str]
    index: Optional[List[str]] = None
    index_name: str = ""  # the index column's header, "" where it has none

    def column(self, name: str) -> np.ndarray:
        return self.values[:, self.columns.index(name)]


def header_names(header: Sequence[str]) -> List[str]:
    """A CSV header's column names as ``pandas.read_csv`` gives them: an
    empty name becomes ``Unnamed: <position>``, and each repeat of a name
    gets the suffix ``.<k>`` (skipping names already taken)."""
    names = [name if name != "" else f"Unnamed: {i}" for i, name in enumerate(header)]
    taken = set(names)
    counts: dict = {}
    for i, base in enumerate(names):
        name, count = base, counts.get(base, 0)
        while count > 0:
            counts[base] = count + 1
            name = f"{base}.{count}"
            count = count + 1 if name in taken else counts.get(name, 0)
        names[i] = name
        counts[name] = count + 1
    return names


def read_matrix_csv(path: str | Path, index_col: Optional[int] = 0) -> Matrix:
    """Read a numeric table; ``index_col=0`` takes the first column as row
    ids (the processed tables), ``None`` reads every column as data (the
    synthetic tables). Empty cells read as NaN."""
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = header_names(next(reader))
        rows = [r for r in reader if r]
    index, index_name = None, ""
    if index_col is not None:
        index = [r[index_col] for r in rows]
        rows = [r[:index_col] + r[index_col + 1:] for r in rows]
        if header[index_col] != f"Unnamed: {index_col}":
            index_name = header[index_col]
        header = header[:index_col] + header[index_col + 1:]
    values = np.array(
        [[float(v) if v != "" else np.nan for v in r] for r in rows], dtype=np.float64
    ).reshape(len(rows), len(header))
    return Matrix(values, list(header), index, index_name)


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


def _typed(cell: str) -> Any:
    if cell in NA_STRINGS:
        return float("nan")
    if cell in TRUE_STRINGS or cell in FALSE_STRINGS:
        return cell in TRUE_STRINGS
    for kind in (int, float):
        try:
            return kind(cell)
        except ValueError:
            pass
    return cell


def read_typed_columns(path: str | Path) -> Dict[str, list]:
    """Every column of a CSV without an index column, by name, with the
    types ``pandas.read_csv`` infers for it: int where every cell is an
    integer, bool where every cell is True or False, float where the
    cells are numbers and one is not an integer or is missing (NaN); a
    column mixing bools or text with numbers or missing cells keeps each
    cell's own type (text stays str)."""
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = header_names(next(reader))
        rows = [r for r in reader if r]
    columns = {}
    for j, name in enumerate(header):
        cells = [_typed(r[j]) if j < len(r) else float("nan") for r in rows]
        kinds = {type(v) for v in cells}
        if kinds == {int, float}:
            cells = [float(v) for v in cells]
        columns[name] = cells
    return columns


def read_first_row(path: str | Path) -> Dict[str, Any]:
    """The first data row by column name, as
    ``pandas.read_csv(path).iloc[0].to_dict()`` gives it: int and float
    columns alone share one dtype (float as soon as one column is float),
    a frame with a bool column keeps each column's type."""
    columns = read_typed_columns(path)
    row = {name: cells[0] for name, cells in columns.items()}
    kinds = {type(v) for v in row.values()}
    if kinds == {int, float}:
        row = {name: float(v) for name, v in row.items()}
    return row
