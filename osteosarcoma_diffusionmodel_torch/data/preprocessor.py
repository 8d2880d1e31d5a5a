"""Raw-data preprocessing on the csv module, gzip and numpy: MAF -> mutation
matrix, STAR counts -> expression matrix, clinical cleaning, alignment.

Counterpart of osteosarcoma_diffusionmodel_tpu/data/preprocessor.py, which
is written on pandas. It writes the same eight files to the processed
directory (``mutation_matrix.csv``, ``expression_matrix.csv``,
``clinical.csv`` and the three ``*_aligned.csv``), which ``pandas.read_csv``
and :func:`..utils.io.read_matrix_csv` parse to the same tables as the JAX
package's. What pandas does there is mirrored, defects included:

- a raw table is read as ``read_csv(comment="#")`` reads it: each line is
  cut at its first ``#`` (a ``#`` inside a field cuts the rest of the
  line), lines left empty are skipped, missing trailing fields and pandas'
  NA strings ("", "NA", "NULL", "nan", ...) are missing values;
- mutations: the protein-altering classes, each (sample, gene) pair once,
  barcodes and genes sorted as ``unstack`` sorts them (a missing one
  first), then the ``min_samples_per_gene`` filter;
- expression: the gene name column, else the gene id; "unstranded", else
  "tpm_unstranded", else the fourth column; a repeated gene keeps its first
  row. STAR's summary rows (``N_unmapped``, ``N_multimapping``, ...) have
  no gene name: the first of them stays, as a column without a name whose
  read counts vary the most, and so is kept among the top genes. The
  patients' columns join outer, genes in order of first appearance, NaN
  where a file lacks one; the Ensembl version suffix is cut at the first
  "." (two genes can end with one name). The 5000 columns of the largest
  variance (ddof 1, NaN skipped) in pandas' descending sort (NaN last)
  are selected by name, so a repeated name brings every column of that
  name each time it is selected; then log2(x + 1);
- clinical: lower-cased headers; days and age coerced to numbers;
  ``event_occurred`` from ``vital_status.capitalize() == "Dead"``;
  survival from days to death, else to the last follow-up (0 with a
  warning where no row has either); gender 1 for "male", 0 otherwise;
  metastasis from "IV" or "M1" in the upper-cased stage; age in years
  (/ 365.25); rows without survival dropped. A derived column whose source
  column is absent is missing in every row, as pandas' index alignment
  leaves it;
- alignment: barcodes cut to three fields, the first row of each kept;
  the sorted intersection of the three tables' ids; an id that repeats in
  the expression or clinical table keeps all its rows.
"""

from __future__ import annotations

import csv
import gzip
import io
import logging
import math
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..utils.io import NA_STRINGS, Matrix, header_names

logger = logging.getLogger(__name__)

PROTEIN_ALTERING_CLASSES = [
    "Missense_Mutation",
    "Nonsense_Mutation",
    "Frame_Shift_Del",
    "Frame_Shift_Ins",
    "In_Frame_Del",
    "In_Frame_Ins",
    "Splice_Site",
]

CLINICAL_FEATURES = [
    "submitter_id",
    "survival_days",
    "event_occurred",
    "age_years",
    "gender_bin",
    "metastasis_at_diagnosis",
]

TOP_EXPRESSION_GENES = 5000


@dataclass
class Table:
    """A raw or clinical table: column names and one list of cells a row.
    A cell that a row lacks, or that holds one of pandas' NA strings, is
    missing (None) in :meth:`column`."""

    columns: List[str]
    rows: List[list]

    def column(self, name: str) -> Optional[list]:
        """The cells of ``name``, or None where the table has no such column."""
        if name not in self.columns:
            return None
        j = self.columns.index(name)
        return [r[j] if j < len(r) and r[j] not in NA_STRINGS else None for r in self.rows]


def read_table(path: Path, sep: str = ",", comment: Optional[str] = None) -> Table:
    """A delimited text file, gzipped where its suffix is ``.gz``, as
    ``pandas.read_csv(sep=sep, comment=comment)`` splits it."""
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rt", newline="") as f:
        text = f.read()
    lines = text.splitlines()
    if comment is not None:
        lines = [line.split(comment, 1)[0] for line in lines]
    lines = [line for line in lines if line]
    parsed = list(csv.reader(io.StringIO("\n".join(lines)), delimiter=sep))
    if not parsed:
        raise ValueError(f"No columns to parse from file {path}")
    return Table(header_names(parsed[0]), parsed[1:])


def to_number(value) -> float:
    """``pandas.to_numeric(errors="coerce")`` of one cell: NaN where it is
    missing or not a number."""
    if value is None:
        return math.nan
    try:
        return float(value)
    except ValueError:
        return math.nan


def _sort_key(value):
    """Sort order of ``unstack``'s levels: a missing value first."""
    return (value is not None, "" if value is None else value)


def _cell(value) -> str:
    if value is None or (isinstance(value, float) and math.isnan(value)):
        return ""
    if isinstance(value, (float, np.floating)):
        return repr(float(value))
    return str(value)


def _write_csv(path: Path, header: Sequence, rows) -> None:
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow([_cell(h) for h in header])
        for row in rows:
            writer.writerow([_cell(v) for v in row])


def write_matrix(path: Path, table: Matrix) -> None:
    """``table`` with its index column first (NaN cells empty)."""
    fmt = str if table.values.dtype.kind in "iu" else repr
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow([_cell(h) for h in [table.index_name] + list(table.columns)])
        for i, row in zip(table.index, table.values.tolist()):
            writer.writerow([_cell(i)] + [fmt(v) if v == v else "" for v in row])


def nanvar(values: np.ndarray) -> np.ndarray:
    """Column variances with ddof 1, NaN skipped (pandas' two-pass
    ``nanvar``); NaN where a column has fewer than two values. Each column
    is summed contiguous, as pandas sums its block, so the roundings (and
    the ties the sort meets) are the same."""
    values = np.asfortranarray(values)
    mask = np.isnan(values)
    count = (~mask).sum(axis=0).astype(np.float64)
    filled = np.where(mask, 0.0, values)
    with np.errstate(invalid="ignore", divide="ignore"):
        avg = filled.sum(axis=0, dtype=np.float64) / count
        sqr = np.where(mask, 0.0, (avg[None, :] - filled) ** 2)
        d = count - 1.0
        out = sqr.sum(axis=0, dtype=np.float64) / d
    out[d <= 0] = np.nan
    return out


def argsort_descending(values: np.ndarray) -> np.ndarray:
    """pandas' ``nargsort(kind="quicksort", ascending=False,
    na_position="last")``: the order of ``Series.sort_values(ascending=
    False)``, ties included."""
    mask = np.isnan(values)
    idx = np.arange(len(values))
    non_nans = values[~mask][::-1]
    non_nan_idx = idx[~mask][::-1]
    indexer = non_nan_idx[non_nans.argsort(kind="quicksort")][::-1]
    return np.concatenate([indexer, np.nonzero(mask)[0]])


def _rows_of(ids: Sequence, order: Sequence) -> List[int]:
    """Positions of each id of ``order`` in ``ids``, every repeat in turn
    (``.loc[order]``)."""
    where: Dict = {}
    for i, s in enumerate(ids):
        where.setdefault(s, []).append(i)
    return [i for s in order for i in where[s]]


class OsteosarcomaPreprocessor:
    """TARGET-OS raw data -> the model's processed tables."""

    def __init__(self, raw_dir: Path, processed_dir: Path, config):
        self.raw_dir = Path(raw_dir)
        self.processed_dir = Path(processed_dir)
        self.processed_dir.mkdir(parents=True, exist_ok=True)
        self.config = config

    # ------------------------------------------------------------------
    def process_mutations(self) -> Matrix:
        """MAF files -> binary (samples x genes) mutation matrix."""
        maf_dir = self.raw_dir / "mutations"
        maf_files = sorted(maf_dir.glob("*.maf*"))
        if not maf_files:
            raise FileNotFoundError(f"No MAF files found in {maf_dir}")
        keys = ("Tumor_Sample_Barcode", "Hugo_Symbol", "Variant_Classification")
        records = []
        for maf_file in maf_files:
            logger.info("Reading %s", maf_file.name)
            table = read_table(maf_file, sep="\t", comment="#")
            cols = [table.column(k) or [None] * len(table.rows) for k in keys]
            records.extend(zip(*cols))
        logger.info("Total mutation records: %d", len(records))
        kept = [r for r in records if r[2] in PROTEIN_ALTERING_CLASSES]
        logger.info("Protein-altering records: %d", len(kept))

        pairs = list(dict.fromkeys((b, g) for b, g, _ in kept))
        barcodes = sorted({b for b, _ in pairs}, key=_sort_key)
        genes = sorted({g for _, g in pairs}, key=_sort_key)
        row = {b: i for i, b in enumerate(barcodes)}
        col = {g: j for j, g in enumerate(genes)}
        values = np.zeros((len(barcodes), len(genes)), np.int64)
        for b, g in pairs:
            values[row[b], col[g]] = 1
        keep = values.sum(axis=0) >= self.config.data.min_samples_per_gene
        matrix = Matrix(values[:, keep], [g for g, k in zip(genes, keep) if k], barcodes,
                        "Tumor_Sample_Barcode")
        logger.info("Mutation matrix: %s", matrix.values.shape)
        write_matrix(self.processed_dir / "mutation_matrix.csv", matrix)
        return matrix

    # ------------------------------------------------------------------
    def process_rna_seq(self) -> Matrix:
        """STAR count files -> log2(x+1) matrix over the top-5000-variance genes."""
        rna_dir = self.raw_dir / "rna_seq"
        metadata_path = rna_dir / "metadata.csv"
        if not metadata_path.exists():
            raise FileNotFoundError(f"RNA-seq metadata not found: {metadata_path}")
        metadata = read_table(metadata_path)

        names, series = [], []
        for file_path, submitter in zip(metadata.column("file_path"),
                                        metadata.column("submitter_id")):
            file_path = Path(file_path)
            if not file_path.exists():
                logger.warning("Missing counts file: %s", file_path)
                continue
            counts = read_table(file_path, sep="\t", comment="#")
            id_col = "gene_name" if "gene_name" in counts.columns else "gene_id"
            if "unstranded" in counts.columns:
                count_col = "unstranded"
            elif "tpm_unstranded" in counts.columns:
                count_col = "tpm_unstranded"
            else:
                count_col = counts.columns[3]
            first: Dict = {}
            for gene, value in zip(counts.column(id_col), counts.column(count_col)):
                first.setdefault(gene, to_number(value))
            names.append(submitter)
            series.append(first)
        if not series:
            raise FileNotFoundError("No RNA-seq count files could be read")

        genes = list(dict.fromkeys(g for s in series for g in s))
        pos = {g: j for j, g in enumerate(genes)}
        values = np.full((len(series), len(genes)), np.nan)
        for i, s in enumerate(series):
            values[i, [pos[g] for g in s]] = list(s.values())
        genes = [None if g is None else g.split(".")[0] for g in genes]

        top = [genes[j] for j in argsort_descending(nanvar(values))[:TOP_EXPRESSION_GENES]]
        cols = _rows_of(genes, top)
        matrix = Matrix(np.log2(values[:, cols] + 1), [genes[j] for j in cols], names)
        logger.info("Expression matrix: %s", matrix.values.shape)
        write_matrix(self.processed_dir / "expression_matrix.csv", matrix)
        return matrix

    # ------------------------------------------------------------------
    def process_clinical(self) -> Table:
        """Clean the clinical CSV into numeric survival/outcome features."""
        raw = read_table(self.raw_dir / "clinical.csv")
        raw.columns = [c.lower() for c in raw.columns]
        n = len(raw.rows)
        nan = [math.nan] * n

        def numbers(name):
            cells = raw.column(name)
            return nan if cells is None else [to_number(v) for v in cells]

        def derived(name, fn):
            cells = raw.column(name)
            return nan if cells is None else [fn("nan" if v is None else v) for v in cells]

        death, follow_up = numbers("days_to_death"), numbers("days_to_last_follow_up")
        age = numbers("age_at_diagnosis")
        vital = raw.column("vital_status")
        event = nan if vital is None else [
            int(("Unknown" if v is None else v).capitalize() == "Dead") for v in vital]
        survival = [f if math.isnan(d) else d for d, f in zip(death, follow_up)]
        if all(math.isnan(v) for v in survival):
            logger.warning("No survival days found; filling with 0")
            survival = [0.0] * n
        gender = derived("gender", lambda v: {"female": 0, "male": 1}.get(v.lower(), 0))
        metastasis = derived("tumor_stage", lambda v: int("IV" in v.upper() or "M1" in v.upper()))
        ids = raw.column("submitter_id")
        if ids is None:
            raise KeyError("submitter_id")
        rows = [[i, s, e, a / 365.25, g, m]
                for i, s, e, a, g, m in zip(ids, survival, event, age, gender, metastasis)
                if not math.isnan(s)]
        processed = Table(list(CLINICAL_FEATURES), rows)
        events = sum(r[2] for r in rows if not math.isnan(r[2]))
        logger.info("Clinical: (%d, %d), events %d/%d", len(rows), len(CLINICAL_FEATURES),
                    events, len(rows))
        _write_csv(self.processed_dir / "clinical.csv", processed.columns, processed.rows)
        return processed

    # ------------------------------------------------------------------
    def align_datasets(self, mutation: Matrix, expression: Matrix, clinical: Table):
        """Truncate barcodes, dedup, intersect, sort, write *_aligned.csv."""
        short = ["-".join(("nan" if b is None else b).split("-")[:3]) for b in mutation.index]
        first = list(dict.fromkeys(short))
        keep = [short.index(s) for s in first]
        clin_ids = clinical.column("submitter_id")
        common = set(first) & set(expression.index) & set(clin_ids)
        common.discard(None)
        logger.info("Common samples: %d", len(common))
        if len(common) < 20:
            logger.warning("Very few common samples — check ID mapping")
        order = sorted(common)

        mut_rows = [keep[first.index(s)] for s in order]
        mutation_aligned = Matrix(mutation.values[mut_rows], mutation.columns, order,
                                  mutation.index_name)
        expr_rows = _rows_of(expression.index, order)
        expression_aligned = Matrix(expression.values[expr_rows], expression.columns,
                                    [expression.index[i] for i in expr_rows])
        clinical_aligned = Table(clinical.columns,
                                 [clinical.rows[i] for i in _rows_of(clin_ids, order)])
        write_matrix(self.processed_dir / "mutation_matrix_aligned.csv", mutation_aligned)
        write_matrix(self.processed_dir / "expression_matrix_aligned.csv", expression_aligned)
        _write_csv(self.processed_dir / "clinical_aligned.csv", clinical_aligned.columns,
                   clinical_aligned.rows)
        return mutation_aligned, expression_aligned, clinical_aligned

    # ------------------------------------------------------------------
    def process_all(self) -> Dict[str, object]:
        mutation = self.process_mutations()
        expression = self.process_rna_seq()
        clinical = self.process_clinical()
        mut_a, expr_a, clin_a = self.align_datasets(mutation, expression, clinical)
        return {"mutation_matrix": mut_a, "expression_matrix": expr_a, "clinical": clin_a}
