"""GDC REST data acquisition for TARGET-OS, on ``urllib.request``.

Counterpart of osteosarcoma_diffusionmodel_tpu/data/gdc_loader.py, which
uses ``requests``; the card's machine does not promise that package. The
same REST surface: POST ``/files`` with the project, category, type and
workflow filters and the same fields; GET ``/data/<file_id>`` streamed in
8 KiB chunks to ``<name>.part``, then renamed; GET ``/cases`` with the
expanded diagnoses, demographic, exposures and follow-ups. The same
layout under ``<data_dir>/raw``: ``mutations/``, ``rna_seq/`` with
``metadata.csv``, ``clinical.csv`` and, when asked, ``copy_number/``.
Files already present are skipped; downloads run on a thread pool of
``max_workers`` and a failed one raises. An HTTP error is raised as
``urllib.error.HTTPError``. ``GDC_API`` is read at each request.
Downloading needs network access.
"""

from __future__ import annotations

import csv
import json
import logging
import urllib.parse
import urllib.request
from concurrent.futures import ThreadPoolExecutor, as_completed
from pathlib import Path
from typing import Dict, List, Optional, Sequence

logger = logging.getLogger(__name__)

GDC_API = "https://api.gdc.cancer.gov"
CHUNK = 8192


def _open(url: str, payload: Optional[dict] = None, timeout: float = 120):
    """A GET, or a POST of ``payload`` as JSON; raises on an HTTP error."""
    data, headers = None, {}
    if payload is not None:
        data = json.dumps(payload).encode()
        headers["Content-Type"] = "application/json"
    request = urllib.request.Request(url, data=data, headers=headers,
                                     method="POST" if data is not None else "GET")
    return urllib.request.urlopen(request, timeout=timeout)


def _get_json(url: str, payload: Optional[dict] = None) -> dict:
    with _open(url, payload) as response:
        return json.loads(response.read())


def write_records(path: Path, records: Sequence[dict]) -> None:
    """Records as a CSV with their keys as the header and None as an empty
    cell (what ``pandas.DataFrame(records).to_csv(index=False)`` writes,
    read back to the same values)."""
    columns = list(dict.fromkeys(k for r in records for k in r))
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(columns)
        for r in records:
            writer.writerow(["" if r.get(c) is None else r[c] for c in columns])


class GDCDataLoader:
    """Download and organize TARGET-OS data from the GDC REST API."""

    def __init__(self, project_id: str = "TARGET-OS", data_dir: str | Path = "./data",
                 max_workers: int = 4):
        self.project_id = project_id
        self.data_dir = Path(data_dir)
        self.raw_dir = self.data_dir / "raw"
        self.raw_dir.mkdir(parents=True, exist_ok=True)
        self.max_workers = max_workers

    # ------------------------------------------------------------------
    def query_files(self, data_category: str, data_type: str,
                    workflow_type: Optional[str] = None, size: int = 1000) -> List[dict]:
        """Query the /files endpoint with project/category/type filters."""
        content = [
            {"op": "in", "content": {"field": "cases.project.project_id",
                                     "value": [self.project_id]}},
            {"op": "in", "content": {"field": "files.data_category",
                                     "value": [data_category]}},
            {"op": "in", "content": {"field": "files.data_type",
                                     "value": [data_type]}},
        ]
        if workflow_type:
            content.append({"op": "in", "content": {"field": "files.analysis.workflow_type",
                                                    "value": [workflow_type]}})
        params = {
            "filters": json.dumps({"op": "and", "content": content}),
            "fields": "file_id,file_name,cases.submitter_id,cases.case_id",
            "format": "JSON",
            "size": size,
        }
        return _get_json(f"{GDC_API}/files", params)["data"]["hits"]

    def download_file(self, file_id: str, output_path: Path) -> None:
        """Stream one file in 8 KiB chunks to ``<name>.part``, then rename it."""
        with _open(f"{GDC_API}/data/{file_id}", timeout=600) as response:
            tmp_path = output_path.with_suffix(output_path.suffix + ".part")
            with open(tmp_path, "wb") as f:
                while chunk := response.read(CHUNK):
                    f.write(chunk)
        tmp_path.rename(output_path)
        logger.info("Downloaded %s", output_path.name)

    def _download_many(self, files: List[dict], out_dir: Path) -> None:
        out_dir.mkdir(exist_ok=True)
        todo = [(f["file_id"], out_dir / f["file_name"]) for f in files
                if not (out_dir / f["file_name"]).exists()]
        if not todo:
            return
        with ThreadPoolExecutor(max_workers=self.max_workers) as pool:
            futures = [pool.submit(self.download_file, fid, path) for fid, path in todo]
            for fut in as_completed(futures):
                fut.result()  # re-raise errors

    # ------------------------------------------------------------------
    def download_mutations(self) -> Path:
        logger.info("Querying mutation data...")
        files = self.query_files(
            data_category="Simple Nucleotide Variation",
            data_type="Masked Somatic Mutation",
            workflow_type="Aliquot Ensemble Somatic Variant Merging and Masking",
        )
        logger.info("Found %d mutation files", len(files))
        maf_dir = self.raw_dir / "mutations"
        self._download_many(files, maf_dir)
        return maf_dir

    def download_rna_seq(self) -> Path:
        logger.info("Querying RNA-seq data...")
        files = self.query_files(
            data_category="Transcriptome Profiling",
            data_type="Gene Expression Quantification",
            workflow_type="STAR - Counts",
        )
        logger.info("Found %d RNA-seq files", len(files))
        rna_dir = self.raw_dir / "rna_seq"
        rna_dir.mkdir(exist_ok=True)
        metadata = []
        for info in files:
            case = (info.get("cases") or [{}])[0]
            metadata.append({
                "file_id": info["file_id"],
                "file_name": info["file_name"],
                "case_id": case.get("case_id"),
                "submitter_id": case.get("submitter_id"),
                "file_path": str(rna_dir / info["file_name"]),
            })
        write_records(rna_dir / "metadata.csv", metadata)
        self._download_many(files, rna_dir)
        return rna_dir

    def download_copy_number(self) -> Path:
        """Gene-level copy number (optional)."""
        logger.info("Querying copy number data...")
        files = self.query_files(data_category="Copy Number Variation",
                                 data_type="Gene Level Copy Number")
        logger.info("Found %d copy-number files", len(files))
        cnv_dir = self.raw_dir / "copy_number"
        self._download_many(files, cnv_dir)
        return cnv_dir

    def download_clinical(self) -> Path:
        logger.info("Querying clinical data...")
        params = {
            "filters": json.dumps({"op": "in", "content": {
                "field": "cases.project.project_id", "value": [self.project_id]}}),
            "expand": "diagnoses,demographic,exposures,follow_ups",
            "format": "JSON",
            "size": 1000,
        }
        cases = _get_json(f"{GDC_API}/cases?{urllib.parse.urlencode(params)}")["data"]["hits"]
        logger.info("Found %d cases", len(cases))
        clinical_path = self.raw_dir / "clinical.csv"
        write_records(clinical_path, [self.parse_case(case) for case in cases])
        return clinical_path

    @staticmethod
    def parse_case(case: dict) -> Dict:
        """Flatten one expanded GDC case record (the last follow-up wins)."""
        demographic = case.get("demographic") or {}
        diagnoses = case.get("diagnoses") or []
        diag = diagnoses[0] if diagnoses else {}
        follow_ups = case.get("follow_ups") or []
        fu = follow_ups[-1] if follow_ups else {}
        return {
            "case_id": case.get("case_id"),
            "submitter_id": case.get("submitter_id"),
            "age_at_diagnosis": demographic.get("age_at_diagnosis"),
            "gender": demographic.get("gender"),
            "race": demographic.get("race"),
            "ethnicity": demographic.get("ethnicity"),
            "tumor_stage": diag.get("tumor_stage"),
            "primary_diagnosis": diag.get("primary_diagnosis"),
            "site_of_resection": diag.get("site_of_resection_or_biopsy"),
            "morphology": diag.get("morphology"),
            "days_to_death": fu.get("days_to_death"),
            "days_to_last_follow_up": fu.get("days_to_last_follow_up"),
            "vital_status": fu.get("vital_status"),
        }

    # ------------------------------------------------------------------
    def download_all(self, include_copy_number: bool = False) -> Dict[str, Path]:
        logger.info("Starting download for project %s", self.project_id)
        results = {
            "mutations": self.download_mutations(),
            "rna_seq": self.download_rna_seq(),
            "clinical": self.download_clinical(),
        }
        if include_copy_number:
            results["copy_number"] = self.download_copy_number()
        logger.info("Download complete")
        return results
