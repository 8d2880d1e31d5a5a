"""The report step's analysis: survival statistics, the cohort embedding,
figures and the graded summary (counterpart of
osteosarcoma_diffusionmodel_tpu/analysis/, the same exports)."""

from .report import AnalysisReport, embed_2d, grade, kaplan_meier, write_summary_report

__all__ = [
    "AnalysisReport",
    "embed_2d",
    "grade",
    "kaplan_meier",
    "write_summary_report",
]
