"""Delete and compaction through the ingest path and the router, JAX package
vs port, on the CPU: the seven cases of
``tests/integration/test_delete_compact.py``, each run in both packages on
the same corpus (stores and indexes of their own, ``tests/torch_parity.py``)
and compared: the same ids retrieved (call ids through their external ids),
the same counts, the same status codes; the port's HTTP cases go through its
in-process router client on ``device="cpu"``.
"""

import pytest

from torch_parity import (
    BOTH,
    JAX,
    PORT,
    assert_same_response,
    port_store,  # noqa: F401  (fixture)
    set_both,  # noqa: F401  (fixture)
)

OPTS = dict(target_tokens=10, max_tokens=30, overlap_tokens=0)


def _call(pkg, ext, texts, tags=None, artifacts=()):
    s = pkg.schemas
    cid, _, _ = pkg.ingest.ingest_transcript(
        s.CallRef(external_id=ext, tags=tags),
        [s.UtteranceIn(speaker="A", start_ts_ms=i * 1000, end_ts_ms=i * 1000 + 900,
                       text=t) for i, t in enumerate(texts)],
        s.ChunkingOptions(**OPTS))
    if artifacts:
        pkg.ingest.ingest_analysis(
            s.CallRef(call_id=cid),
            [s.AnalysisArtifactIn(kind=k, content=c) for k, c in artifacts])
    return cid


def _retrieve(pkg, query, **filters):
    body = {"query": query}
    if filters:
        body["filters"] = filters
    return pkg.retrieve.retrieve_evidence(pkg.request(body))


def _in_both(scenario):
    """Run ``scenario(pkg)`` in the port and in the JAX package -> the
    port's observations, which must equal the JAX package's."""
    got, want = scenario(PORT), scenario(JAX)
    assert got == want
    return got


def _stats(pkg):
    index = pkg.index.get_index()
    return {name: (c.count, c.capacity, c.tombstones, c.emb_rows, c.live_count)
            for name, c in (("chunks", index.chunks), ("artifacts", index.artifacts))}


@pytest.fixture()
def corpus(port_store):
    """Two calls in each package -> {package root: {"a": id, "b": id}}."""
    out = {}
    for pkg in BOTH:
        a = _call(pkg, "del-a", ["the ECONNRESET storm hit the object store gateway",
                                 "rolling back to v2.3.1 stopped the resets"],
                  tags=["infra"],
                  artifacts=[("summary", "ECONNRESET traced to the upgrade.")])
        b = _call(pkg, "del-b", ["lenovo BOM for the bake-off against dell",
                                 "supermicro is the incumbent on density"],
                  tags=["sales"])
        pkg.pipeline.run_embedding_backfill(batch_size=8)
        out[pkg.root] = {"a": a, "b": b}
    return out


def test_deleted_call_invisible_everywhere(corpus):
    query = "ECONNRESET object store gateway"
    responses = {}
    for pkg in BOTH:
        ids = corpus[pkg.root]
        before = _retrieve(pkg, query)
        assert any(q["call_id"] == ids["a"] for q in before["quotes"])
        out = pkg.ingest.delete_call(ids["a"])
        assert out["chunks_deleted"] >= 1 and out["artifact_chunks_deleted"] >= 1
        after = _retrieve(pkg, query)
        assert all(q["call_id"] != ids["a"] for q in after["quotes"])
        assert all(a["call_id"] != ids["a"] for a in after["artifacts"])
        other = _retrieve(pkg, "lenovo BOM bake-off")
        assert any(q["call_id"] == ids["b"] for q in other["quotes"])
        responses[pkg.root] = ({k: v for k, v in out.items() if k != "call_id"},
                               before, after, other)
    port, jax = responses[PORT.root], responses[JAX.root]
    assert port[0] == jax[0]
    # ``before`` was served while call a still stood in the store
    for got, want in zip(port[2:], jax[2:]):
        assert_same_response(got, want)
    assert _stats(PORT) == _stats(JAX)
    assert _stats(PORT)["chunks"][2] == port[0]["chunks_deleted"]


def test_unknown_call_404(corpus):
    def scenario(pkg):
        with pytest.raises(pkg.errors.ApiError) as err:
            pkg.ingest.delete_call("00000000-0000-4000-8000-000000000000")
        return err.value.status, err.value.detail

    assert _in_both(scenario)[0] == 404


def test_store_rows_gone_and_tag_index_cleaned(corpus):
    def scenario(pkg):
        call = corpus[pkg.root]["a"]
        pkg.ingest.delete_call(call)
        with pkg.db.get_store().read() as conn:
            left = {table: conn.execute(
                f"SELECT COUNT(*) FROM {table} WHERE call_id = ?", (call,)).fetchone()[0]
                for table in ("calls", "chunks", "artifact_chunks", "utterances",
                              "analysis_artifacts", "transcript_ingests",
                              "ingestion_runs")}
            tags = conn.execute("SELECT COUNT(*) FROM call_tags").fetchone()[0]
            logged = conn.execute(
                "SELECT tbl, COUNT(*) FROM index_mutations WHERE op='delete' "
                "GROUP BY tbl ORDER BY tbl").fetchall()
        resp = _retrieve(pkg, "ECONNRESET gateway", call_tags=["infra"])
        return left, tags, [tuple(r) for r in logged], resp["quotes"]

    left, tags, logged, quotes = _in_both(scenario)
    assert set(left.values()) == {0} and tags == 1 and quotes == []
    assert [t for t, _n in logged] == ["artifact_chunks", "chunks"]


def test_delete_via_http(corpus):
    clients = {JAX.root: JAX.testing.TestClient(),
               PORT.root: PORT.testing.TestClient(device="cpu")}

    def scenario(pkg):
        client, call = clients[pkg.root], corpus[pkg.root]["a"]
        first = client.delete(f"/calls/{call}")
        body = {k: v for k, v in first.json().items() if k != "call_id"}
        stats = client.get("/index/stats").json()
        return (first.status_code, body, client.delete(f"/calls/{call}").status_code,
                client.delete("/calls/not-a-uuid").status_code,
                client.get(f"/calls/{call}").status_code,
                stats["chunks"]["tombstones"], stats["artifact_chunks"]["tombstones"])

    got = _in_both(scenario)
    assert got[0] == 200 and got[1]["chunks_deleted"] >= 1
    assert got[2:5] == (404, 422, 404) and got[5] >= 1 and got[6] >= 1


def test_compaction_preserves_results_and_filters(port_store):
    def scenario(pkg):
        keep, drop = [], []
        for i in range(12):
            topic = "tiering SSD latency" if i % 2 else "azure migration runbook"
            cid = _call(pkg, f"cmp-{i}",
                        [f"call {i} about the {topic} topic",
                         f"second utterance {i} with ECONNRESET v2.{i % 9}.1"],
                        tags=["even" if i % 2 == 0 else "odd"])
            (keep if i % 2 else drop).append(cid)
        pkg.pipeline.run_embedding_backfill(batch_size=16)
        index = pkg.index.get_index()
        seen = [_stats(pkg)]
        for cid in drop:
            pkg.ingest.delete_call(cid)
        assert index.chunks.tombstones > 0
        seen.append(_stats(pkg))
        index.chunks.compact()
        index.artifacts.compact()
        assert index.chunks.tombstones == 0
        assert index.chunks.count == index.chunks.live_count < seen[0]["chunks"][0]
        seen.append(_stats(pkg))
        ext = pkg.call_ext()
        # retrieval and tag filters still right after row positions moved
        odd = _retrieve(pkg, "tiering SSD latency", call_tags=["odd"])
        assert odd["quotes"] and all(q["call_id"] in keep for q in odd["quotes"])
        azure = _retrieve(pkg, "azure migration runbook")
        assert all(q["call_id"] in keep for q in azure["quotes"])
        return seen, [[(ext[q["call_id"]], q["chunk_id"]) for q in r["quotes"]]
                      for r in (odd, azure)]

    _in_both(scenario)


def test_insert_after_compact(port_store):
    def scenario(pkg):
        cids = [_call(pkg, f"ic-{i}", [f"utterance {i} about the object store"])
                for i in range(4)]
        pkg.pipeline.run_embedding_backfill(batch_size=8)
        for cid in cids[:2]:
            pkg.ingest.delete_call(cid)
        pkg.index.get_index().chunks.compact()
        new = _call(pkg, "ic-new", ["fresh call about SSD tiering economics"])
        pkg.pipeline.run_embedding_backfill(batch_size=8)
        resp = _retrieve(pkg, "SSD tiering economics")
        assert any(q["call_id"] == new for q in resp["quotes"])
        ext = pkg.call_ext()
        return _stats(pkg), [(ext[q["call_id"]], q["chunk_id"]) for q in resp["quotes"]]

    _in_both(scenario)


def test_maybe_compact_threshold(port_store):
    def scenario(pkg):
        index = pkg.index.get_index()
        cid = _call(pkg, "th-1", ["threshold call about the gateway"])
        pkg.pipeline.run_embedding_backfill(batch_size=8)
        below = index.chunks.maybe_compact()
        out = pkg.ingest.delete_call(cid)
        # few tombstones: still under the 64-row floor
        return below, out["compacted"], index.chunks.maybe_compact(), _stats(pkg)

    assert _in_both(scenario)[:3] == (False, False, False)
