"""The port's GDC loader (``urllib.request``) against the JAX package's
(``requests``), both driven through the local HTTP stub of
tests/test_gdc_http_stub.py on 127.0.0.1: the request fields, the
``.part`` rename, the error paths, resumed downloads, ``parse_case``, and
``download_all``'s files: the downloads byte for byte, the two CSVs
parsed by pandas to the same values (pandas writes a column of whole
numbers with a missing cell as floats, ``5475.0``, the port ``5475``).
"""

import json
import threading
import urllib.error
from http.server import ThreadingHTTPServer

import pandas as pd
import pytest

from osteosarcoma_diffusionmodel_tpu.data import gdc_loader as jax_gdc
from osteosarcoma_diffusionmodel_torch.data import gdc_loader
from osteosarcoma_diffusionmodel_torch.data.gdc_loader import GDCDataLoader
from test_gdc_http_stub import CASES, FILE_BYTES, _Stub
import test_gdc_loader as jax_loader_tests

MAF_WORKFLOW = "Aliquot Ensemble Somatic Variant Merging and Masking"


@pytest.fixture(scope="module")
def stub_api():
    server = ThreadingHTTPServer(("127.0.0.1", 0), _Stub)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    old = gdc_loader.GDC_API, jax_gdc.GDC_API
    gdc_loader.GDC_API = jax_gdc.GDC_API = url
    yield url
    gdc_loader.GDC_API, jax_gdc.GDC_API = old
    server.shutdown()
    server.server_close()


def test_query_files_sends_the_jax_request(stub_api, tmp_path):
    """The same POST /files body as the JAX loader's: filters, fields,
    format and page size."""
    bodies = []
    for loader in (GDCDataLoader(data_dir=tmp_path / "port"),
                   jax_gdc.GDCDataLoader(data_dir=tmp_path / "jax")):
        _Stub.seen.clear()
        hits = loader.query_files("Simple Nucleotide Variation", "Masked Somatic Mutation",
                                  workflow_type=MAF_WORKFLOW)
        assert [h["file_id"] for h in hits] == ["fid-1", "fid-2"]
        method, path, payload = _Stub.seen[-1]
        assert (method, path) == ("POST", "/files")
        bodies.append(payload)
    assert bodies[0] == bodies[1]
    filters = json.loads(bodies[0]["filters"])
    assert [c["content"]["field"] for c in filters["content"]] == [
        "cases.project.project_id", "files.data_category", "files.data_type",
        "files.analysis.workflow_type"]
    assert bodies[0]["fields"] == "file_id,file_name,cases.submitter_id,cases.case_id"
    assert (bodies[0]["format"], bodies[0]["size"]) == ("JSON", 1000)


def test_download_file_streams_via_part_rename(stub_api, tmp_path):
    out = tmp_path / "a.maf.gz"
    GDCDataLoader(data_dir=tmp_path).download_file("fid-1", out)
    assert out.read_bytes() == FILE_BYTES["fid-1"]
    assert not out.with_suffix(out.suffix + ".part").exists()


@pytest.mark.parametrize("fid", ["fid-broken", "fid-absent"])
def test_download_errors_raise_and_leave_no_output(stub_api, tmp_path, fid):
    """A 500 or a 404 raises ``HTTPError`` with the status, writes nothing,
    and the thread pool re-raises it."""
    loader = GDCDataLoader(data_dir=tmp_path)
    out = tmp_path / "broken.maf.gz"
    with pytest.raises(urllib.error.HTTPError) as err:
        loader.download_file(fid, out)
    assert err.value.code == (500 if fid == "fid-broken" else 404)
    assert not out.exists() and not out.with_suffix(out.suffix + ".part").exists()
    with pytest.raises(urllib.error.HTTPError):
        loader._download_many([{"file_id": "fid-2", "file_name": "ok.maf.gz"},
                               {"file_id": fid, "file_name": "bad.maf.gz"}], tmp_path / "m")
    assert (tmp_path / "m" / "ok.maf.gz").read_bytes() == FILE_BYTES["fid-2"]


def test_download_mutations_is_resumable(stub_api, tmp_path):
    loader = GDCDataLoader(data_dir=tmp_path)
    maf_dir = loader.download_mutations()
    assert sorted(p.name for p in maf_dir.iterdir()) == ["a.maf.gz", "b.maf.gz"]
    _Stub.seen.clear()
    loader.download_mutations()
    assert [s for s in _Stub.seen if s[0] == "GET"] == []


def test_parse_case_matches_jax():
    cases = CASES + [{"case_id": "c3", "submitter_id": "X", "follow_ups": [],
                      "diagnoses": [], "demographic": None}]
    for case in cases:
        assert GDCDataLoader.parse_case(case) == jax_gdc.GDCDataLoader.parse_case(case)
    # The JAX package's own parse test, on the port's loader.
    jax_loader_tests.GDCDataLoader = GDCDataLoader
    try:
        jax_loader_tests.test_parse_case_full()
        jax_loader_tests.test_parse_case_sparse()
    finally:
        jax_loader_tests.GDCDataLoader = jax_gdc.GDCDataLoader


def test_download_all_matches_jax_layout(stub_api, tmp_path):
    """``download_all``: the same files under raw/ with the same bytes; the
    clinical and RNA-seq metadata tables parse to the same frames (the
    file paths relative to each data directory)."""
    port = GDCDataLoader(data_dir=tmp_path / "port").download_all()
    want = jax_gdc.GDCDataLoader(data_dir=tmp_path / "jax").download_all()
    assert set(port) == set(want) == {"mutations", "rna_seq", "clinical"}
    root_p, root_j = tmp_path / "port" / "raw", tmp_path / "jax" / "raw"
    files_p = sorted(p.relative_to(root_p) for p in root_p.rglob("*") if p.is_file())
    files_j = sorted(p.relative_to(root_j) for p in root_j.rglob("*") if p.is_file())
    assert files_p == files_j and len(files_p) == 5
    for rel in files_p:
        if rel.suffix != ".csv":
            assert (root_p / rel).read_bytes() == (root_j / rel).read_bytes(), rel
    pd.testing.assert_frame_equal(pd.read_csv(root_p / "clinical.csv"),
                                  pd.read_csv(root_j / "clinical.csv"), check_dtype=False)
    meta_p = pd.read_csv(root_p / "rna_seq" / "metadata.csv")
    meta_j = pd.read_csv(root_j / "rna_seq" / "metadata.csv")
    for meta, root in ((meta_p, tmp_path / "port"), (meta_j, tmp_path / "jax")):
        meta["file_path"] = [str(p).replace(str(root), "") for p in meta["file_path"]]
    pd.testing.assert_frame_equal(meta_p, meta_j)


def test_download_step_fetches_the_pretraining_projects(stub_api, tmp_path):
    """The CLI's download step: the primary project under data_dir/raw and
    each pretraining entry that is a project id (not a directory) under
    data_dir/pretrain/<project>/raw."""
    from osteosarcoma_diffusionmodel_torch import cli
    from osteosarcoma_diffusionmodel_torch.config import Config

    cfg = Config()
    cfg.data.data_dir = str(tmp_path / "data")
    cfg.training.augmentation.cross_cancer_pretrain = True
    cfg.training.augmentation.pretrain_datasets = ["TARGET-NBL", str(tmp_path)]
    _Stub.seen.clear()
    results = cli.download_data(cfg)
    assert results["clinical"] == tmp_path / "data" / "raw" / "clinical.csv"
    pre = tmp_path / "data" / "pretrain" / "TARGET-NBL" / "raw"
    assert sorted(p.name for p in (pre / "mutations").iterdir()) == ["a.maf.gz", "b.maf.gz"]
    assert (pre / "clinical.csv").exists() and (pre / "rna_seq" / "metadata.csv").exists()
    posted = [json.loads(body["filters"])["content"][0]["content"]["value"]
              for method, _, body in _Stub.seen if method == "POST"]
    assert posted == [["TARGET-OS"], ["TARGET-OS"], ["TARGET-NBL"], ["TARGET-NBL"]]
