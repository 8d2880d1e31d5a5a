"""The port's preprocessor (csv, gzip, numpy) against the JAX package's
(pandas) on raw TARGET-OS-layout fixtures: every one of the eight CSVs it
writes parses, with pandas and with the port's reader, to the same header,
ids and values.

The fixture extends tests/test_preprocessor.py's: two MAF files (one
gzipped) with a ``#version`` line, a ``#`` inside a field, repeated
(sample, gene) records, silent records and two aliquots of one patient;
STAR files with the ``# gene-model`` line, the ``N_*`` summary rows (no
gene name), names with a version-like dot, a repeated name, a gene one
file lacks, tied variances, one gzipped file and one missing file; a
clinical table with mixed-case headers, vital status and stage strings,
a non-numeric age and a patient without survival. Three layouts of the
STAR and clinical columns.
"""

import gzip

import numpy as np
import pandas as pd
import pytest

from osteosarcoma_diffusionmodel_tpu.config import Config as JaxConfig
from osteosarcoma_diffusionmodel_tpu.data.preprocessor import (
    OsteosarcomaPreprocessor as JaxPreprocessor,
)
from osteosarcoma_diffusionmodel_torch.config import Config
from osteosarcoma_diffusionmodel_torch.data.pathways import HALLMARK_GENE_SETS
from osteosarcoma_diffusionmodel_torch.data.preprocessor import OsteosarcomaPreprocessor
from osteosarcoma_diffusionmodel_torch.utils.io import read_matrix_csv

OUTPUTS = ("mutation_matrix.csv", "expression_matrix.csv", "clinical.csv",
           "mutation_matrix_aligned.csv", "expression_matrix_aligned.csv",
           "clinical_aligned.csv")
MATRICES = ("mutation_matrix.csv", "expression_matrix.csv", "mutation_matrix_aligned.csv",
            "expression_matrix_aligned.csv")
N = 10


def _maf(raw):
    header = ["Hugo_Symbol", "Entrez_Gene_Id", "Variant_Classification",
              "Tumor_Sample_Barcode", "Comment"]
    rows = []
    for i in range(N):
        bc = f"TARGET-40-S{i:03d}-01A"
        rows.append(["TP53", "7157", "Missense_Mutation", bc, "a#b"])
        if i < 6:
            rows.append(["RB1", "5925", "Nonsense_Mutation", bc, ""])
        if i in (2, 3):
            rows.append(["TP53", "7157", "Splice_Site", bc, "again"])  # same pair
        if i < 2:
            rows.append(["RARE1", "1", "Frame_Shift_Del", bc, ""])
        rows.append(["SILENTG", "2", "Silent", bc, ""])
    # A second aliquot of S000 (cut to the same patient; its first row wins).
    rows.append(["ATRX", "546", "Missense_Mutation", "TARGET-40-S000-01B", ""])
    rows.append(["MYC#x", "4609", "Missense_Mutation", "TARGET-40-S001-01A", ""])
    text = "#version 2.4\n#annotation\n" + "\t".join(header) + "\n" + "".join(
        "\t".join(r) + "\n" for r in rows)
    (raw / "mutations").mkdir(parents=True)
    with gzip.open(raw / "mutations" / "cohort.maf.gz", "wt") as f:
        f.write(text)
    extra = "Hugo_Symbol\tTumor_Sample_Barcode\tVariant_Classification\n" + "".join(
        f"ATRX\tTARGET-40-S{i:03d}-01A\tIn_Frame_Del\n" for i in range(3, 8))
    (raw / "mutations" / "extra.maf").write_text(extra)


def _star(raw, layout, rng, gap=True):
    """One STAR file a patient; with ``gap`` patient 2's lacks a gene (NaN
    in the expression tables, which the training loss would carry)."""
    genes = [f"ENSG{i:05d}.{1 + i % 3}" for i in range(40)]
    names = list(dict.fromkeys(g for members in HALLMARK_GENE_SETS.values()
                               for g in members))[:40]
    names[10], names[11] = "AC000061.1", "AC000061.2"  # one name after the cut
    names[12] = names[3]  # a repeated name: the first row is kept
    genes[13] = genes[14].split(".")[0] + ".7_PAR_Y"  # one id after the cut
    base = rng.integers(0, 1000, (N, 40))
    base[:, 20] = base[:, 21]  # tied variances
    base[:, 22] = 5
    base[:, 23] = 9  # two zero variances
    summary = [("N_unmapped", 10 ** 6), ("N_multimapping", 10 ** 5), ("N_noFeature", 10 ** 5),
               ("N_ambiguous", 10 ** 4)]
    (raw / "rna_seq").mkdir(parents=True)
    meta = []
    for i in range(N):
        sid = f"TARGET-40-S{i:03d}"
        path = raw / "rna_seq" / (f"{sid}.tsv.gz" if i == 5 else f"{sid}.tsv")
        meta.append({"file_id": f"f{i}", "file_name": path.name, "case_id": f"c{i}",
                     "submitter_id": sid, "file_path": str(path)})
        if i == 8:
            continue  # listed in the metadata, never downloaded
        lines = []
        for name, scale in summary:
            count = int(rng.integers(scale, 3 * scale))
            lines.append([name, "", "", count, count, count, "", ""])
        for j in range(40):
            if gap and i == 2 and j == 7:
                continue  # this file lacks one gene
            c = int(base[i, j])
            lines.append([genes[j], names[j], "protein_coding", c, c // 2, c // 3,
                          round(c / 7, 4), ""])
        header = ["gene_id", "gene_name", "gene_type", "unstranded", "stranded_first",
                  "stranded_second", "tpm_unstranded", "fpkm_unstranded"]
        keep = {"names": header,
                "ids_tpm": ["gene_id", "gene_type", "stranded_first", "tpm_unstranded"],
                "fourth": ["gene_id", "gene_type", "stranded_second", "stranded_first"]}[layout]
        cols = [header.index(k) for k in keep]
        text = "# gene-model: GENCODE v36\n" + "\t".join(keep) + "\n" + "".join(
            "\t".join(str(line[c]) for c in cols) + "\n" for line in lines)
        if path.suffix == ".gz":
            with gzip.open(path, "wt") as f:
                f.write(text)
        else:
            path.write_text(text)
    pd.DataFrame(meta).to_csv(raw / "rna_seq" / "metadata.csv", index=False)


def _clinical(raw, layout):
    vital = ["Dead", "DEAD", "alive", None, "Not Reported", "dead", "Alive", "Dead", "Alive",
             "Dead", "Alive"]
    stage = ["Stage IVA", "stage ii", "T2 N0 M1a", "--", None, "Stage iv", "Stage I",
             "m1", "Stage II", None, "Stage III"]
    gender = ["MALE", "female", "unknown", None, "Male", "Female", "male", "female", "male",
              "female", "male"]
    death = [500, None, 800, None, 300, None, None, 1200, None, None, 45]
    follow = [None, 1200, None, 900, None, 700, 650, None, 400, None, None]
    age = [5000, 5100, "--", 6000, 6100, 4000, 4100, 3000, None, 3300, 7000]
    frame = pd.DataFrame({
        "Case_ID": [f"c{i}" for i in range(N + 1)],
        "Submitter_ID": [f"TARGET-40-S{i:03d}" for i in range(N + 1)],
        "Age_At_Diagnosis": age, "Gender": gender, "Tumor_Stage": stage,
        "Days_To_Death": death, "Days_To_Last_Follow_Up": follow, "Vital_Status": vital,
    })
    if layout == "ids_tpm":  # the derived columns of absent sources are missing
        frame = frame.drop(columns=["Vital_Status", "Gender", "Tumor_Stage"])
    frame.to_csv(raw / "clinical.csv", index=False)


@pytest.fixture(params=["names", "ids_tpm", "fourth"])
def processed(request, tmp_path):
    raw = tmp_path / "raw"
    rng = np.random.default_rng(4)
    _maf(raw)
    _star(raw, request.param, rng)
    _clinical(raw, request.param)
    outs = {}
    for name, cls, cfg in (("jax", JaxPreprocessor, JaxConfig()),
                           ("port", OsteosarcomaPreprocessor, Config())):
        cfg.data.min_samples_per_gene = 3
        outs[name] = cls(raw, tmp_path / name, cfg).process_all()
    return tmp_path, request.param, outs


def test_preprocessors_write_equal_tables(processed, caplog):
    root, layout, outs = processed
    for name in OUTPUTS:
        want = pd.read_csv(root / "jax" / name)
        got = pd.read_csv(root / "port" / name)
        assert list(got.columns) == list(want.columns), name
        pd.testing.assert_frame_equal(got, want, check_dtype=False, rtol=1e-12, obj=name)
    for name in MATRICES:
        want, got = read_matrix_csv(root / "jax" / name), read_matrix_csv(root / "port" / name)
        assert got.columns == want.columns and got.index == want.index, name
        assert got.index_name == want.index_name, name
        np.testing.assert_array_equal(got.values, want.values, err_msg=name)
    mut = pd.read_csv(root / "port" / "mutation_matrix_aligned.csv", index_col=0)
    assert list(mut.columns) == ["ATRX", "RB1", "TP53"]  # RARE1 < 3, SILENTG, "MYC#x" cut
    assert mut.loc["TARGET-40-S000", "ATRX"] == 0  # the first aliquot's row
    expr = pd.read_csv(root / "port" / "expression_matrix.csv", index_col=0)
    assert len(expr) == N - 1  # the missing counts file skipped
    assert expr.isna().any().any()  # the gene one file lacks
    if layout == "names":
        # STAR's first summary row stays, as the unnamed column of the
        # largest variance; "AC000061" selected twice brings both twice.
        assert list(expr.columns)[0] == "Unnamed: 1"
        assert sum(c.startswith("AC000061") for c in expr.columns) == 4
    for key in ("mutation_matrix", "expression_matrix"):
        assert len(outs["port"][key].index) == len(outs["jax"][key])
    assert len(outs["port"]["clinical"].rows) == len(outs["jax"]["clinical"])


def test_missing_maf_raises(tmp_path):
    for cls, cfg in ((JaxPreprocessor, JaxConfig()), (OsteosarcomaPreprocessor, Config())):
        with pytest.raises(FileNotFoundError, match="No MAF files"):
            cls(tmp_path / "raw", tmp_path / "out", cfg).process_mutations()
