"""The ingest job queue and its adapters in the port, held to the JAX
package's own tests of them.

``ingest/{fs_queue,adapters,docformats}.py`` are host code that the port
carries over (the last two byte for byte, the first but for one docstring
line: ``tests/test_torch_copies.py``),
so the strictest mirror of ``tests/integration/test_fs_queue.py``,
``tests/unit/test_adapters.py``, ``tests/unit/test_docformats.py``,
``tests/integration/test_ocr_sidecar.py`` and (for the scanner, worker and
backfill scripts) ``tests/integration/test_cli_scripts.py`` is those files'
own text with the package name replaced where it names a module: each is compiled here against
``cadence_rag_tpu_torch`` and its tests collected under this module, one
test each, prefixed with the file they come from. Their ``tmp_store``
fixture becomes ``port_tmp_store``: the port's settings, a temporary SQLite
store and the port's index on the CPU (``tests/torch_parity.port_store``).
Then the job routes over the port's router client against the JAX
package's.
"""

import sys
from pathlib import Path

import pytest

from torch_parity import (
    BOTH,
    JAX,
    PORT,
    mirror_tests,
    port_store,  # noqa: F401  (fixture)
    set_both,  # noqa: F401  (fixture)
)

MIRRORED = {
    "fs_queue": "integration/test_fs_queue.py",
    "adapters": "unit/test_adapters.py",
    "docformats": "unit/test_docformats.py",
    "ocr_sidecar": "integration/test_ocr_sidecar.py",
    "cli_scripts": "integration/test_cli_scripts.py",
}
# the port's index_snapshot takes --device (default cuda, which raises
# without a card): its round trip is held in tests/test_torch_checkpoint.py
NOT_PORTED = {"cli_scripts": {"TestCliScripts": ["test_snapshot_cli_roundtrip"]}}


@pytest.fixture()
def port_tmp_store(port_store):
    """What ``tmp_store`` is to the JAX package's tests: the settings
    object whose fields the tests patch, here the port's."""
    return port_store


for _stem, _rel in MIRRORED.items():
    mirror_tests(globals(), _stem, _rel, drop=NOT_PORTED.get(_stem))


def test_every_mirrored_file_ran_against_the_port():
    """The mirrored tests import the port's modules, not the JAX package's."""
    from cadence_rag_tpu_torch.ingest import adapters, docformats, fs_queue

    mods = {stem: sys.modules[f"{__name__}.{stem}"] for stem in MIRRORED}
    assert mods["fs_queue"].fs_queue is fs_queue
    assert mods["adapters"].load_analysis_content is adapters.load_analysis_content
    assert mods["docformats"].docx_to_text is docformats.docx_to_text
    collected = [n for n in globals() if n.startswith(("Test_", "test_"))]
    assert len(collected) >= 12


# -- the job routes, both packages -------------------------------------------------
def _bundle(root: Path, name: str) -> None:
    import json

    bundle = root / "inbox" / name
    bundle.mkdir(parents=True)
    (bundle / "transcript.json").write_text(json.dumps([
        {"speaker": "Ana", "start_ts_ms": 0, "end_ts_ms": 900,
         "text": "the ECONNRESET fix landed in rollback v2.3.1"}]))
    (bundle / "summary.md").write_text("ECONNRESET fixed by the rollback.")
    (bundle / "_READY").touch()


def test_job_routes_match(port_store, set_both, tmp_path):
    """A bundle scanned and worked in each package, then ``/ingest/jobs``
    and ``/ingest/jobs/{id}`` through each router: the same jobs, files and
    status codes (ids and paths apart), and the call is retrievable."""
    set_both("ingest_single_file_min_age_s", 0)
    clients = {JAX.root: JAX.testing.TestClient(),
               PORT.root: PORT.testing.TestClient(device="cpu")}
    seen = {}
    for pkg in BOTH:
        root = tmp_path / pkg.root
        pkg.settings.ingest_root_dir = str(root)       # restored by port_store/tmp_store
        _bundle(root, "bundle-1")
        assert pkg.fs_queue.scan_inbox_once(root)["enqueued"] == 1
        client = clients[pkg.root]
        queued = client.get("/ingest/jobs", params={"status": "queued"}).json()["items"]
        assert pkg.fs_queue.work_once("w") == "succeeded"
        assert pkg.fs_queue.work_once("w") is None
        jobs = client.get("/ingest/jobs").json()["items"]
        job = client.get(f"/ingest/jobs/{jobs[0]['ingest_job_id']}").json()
        assert job == jobs[0] and job["call_id"]
        ids = client.post("/retrieve", json={
            "query": "ECONNRESET rollback v2.3.1",
            "return_style": "ids_only"}).json()["retrieved_ids"]
        skip = ("ingest_job_id", "call_id", "bundle_path", "created_at",
                "started_at", "finished_at")
        seen[pkg.root] = (
            [{k: v for k, v in j.items() if k not in skip} for j in queued + jobs],
            ids,
            client.get("/ingest/jobs", params={"status": "bogus"}).status_code,
            client.get("/ingest/jobs", params={"limit": "0"}).status_code,
            client.get("/ingest/jobs/not-a-uuid").status_code,
            client.get("/ingest/jobs/00000000-0000-4000-8000-000000000001").status_code,
        )
    assert seen[PORT.root] == seen[JAX.root]
    jobs, ids, *codes = seen[PORT.root]
    assert [j["status"] for j in jobs] == ["queued", "succeeded"] and ids
    assert codes == [400, 422, 422, 404]
