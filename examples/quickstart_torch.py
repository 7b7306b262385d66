"""End-to-end quickstart on the PyTorch port: ingest -> embed -> retrieve ->
expand -> browse.

Run:  python examples/quickstart_torch.py [--device cuda|cpu]

The steps of ``examples/quickstart.py`` through the port's in-process
client (``cadence_rag_tpu_torch.serve.testing.TestClient``), with the index
on ``--device``: the card by default (it raises without one), the CPU when
asked. Uses the deterministic stub embedder, so it works offline; set
EMBEDDINGS_PROVIDER=http + EMBEDDINGS_BASE_URL to use an embedding service
(the same /embed contract).
"""

import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
os.environ.setdefault("STORE_PATH", os.path.join(tempfile.mkdtemp(), "demo.db"))
os.environ.setdefault("EMBEDDINGS_PROVIDER", "stub")
os.environ.setdefault("LEXICAL_DIM", "2048")

from cadence_rag_tpu_torch.serve.testing import TestClient  # noqa: E402


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda",
                        help="device of the index: cuda (default; raises "
                             "without a card) or cpu")
    args = parser.parse_args(argv)
    client = TestClient(device=args.device)

    print("== ingest a transcript ==")
    resp = client.post("/ingest/transcript", json={
        "call_ref": {"external_id": "demo-1", "title": "storage incident"},
        "transcript": {"format": "json_turns", "content": [
            {"speaker": "Ana", "start_ts_ms": 0, "end_ts_ms": 5000,
             "text": "we saw ECONNRESET errors from the object store after "
                     "the v2.4.0 upgrade"},
            {"speaker": "Raj", "start_ts_ms": 5000, "end_ts_ms": 10000,
             "text": "rolling back to v2.3.1 stopped the resets immediately"},
            {"speaker": "Ana", "start_ts_ms": 10000, "end_ts_ms": 15000,
             "text": "let's also tier the hot objects onto SSD next sprint"},
        ]},
    })
    print(json.dumps(resp.json(), indent=2))
    call_id = resp.json()["call_id"]

    print("== attach analysis artifacts ==")
    resp = client.post("/ingest/analysis", json={
        "call_ref": {"call_id": call_id},
        "artifacts": [
            {"kind": "action_items",
             "content": "- pin clients to v2.3.1\n- size the SSD tier\n"},
            {"kind": "summary",
             "content": "ECONNRESET storm traced to the v2.4.0 client; "
                        "rollback fixed it; SSD tiering approved."},
        ],
    })
    print(json.dumps(resp.json(), indent=2))

    print("== embed the corpus (dense lane) ==")
    from cadence_rag_tpu_torch.embed.pipeline import run_embedding_backfill

    summary = run_embedding_backfill(batch_size=16)
    print(f"embedded {summary.rows_updated} rows with {summary.model_used}")

    print("== retrieve ==")
    resp = client.post("/retrieve", json={
        "query": "what fixed the ECONNRESET errors?",
        "budget": {"max_evidence_items": 4, "max_total_chars": 1200},
    })
    body = resp.json()
    for artifact in body["artifacts"]:
        print(f"[{artifact['evidence_id']}] ({artifact['kind']}) "
              f"{artifact['snippet'][:80]}")
    for quote in body["quotes"]:
        print(f"[{quote['evidence_id']}] {quote['speaker']}: "
              f"{quote['snippet'][:80]}")
    print("planner:", body["notes"]["retrieval"]["planner"],
          "| tech tokens:", body["notes"]["retrieval"]["tech_tokens"])

    print("== expand the top quote with a 10s window ==")
    evidence_id = body["quotes"][0]["evidence_id"]
    resp = client.post("/expand", json={
        "evidence_id": evidence_id, "window_ms": 10000, "max_chars": 800,
    })
    print(resp.json()["snippet"])

    print("== browse ==")
    print(json.dumps(client.get("/calls").json()["items"][0]["title"]))
    print(json.dumps(client.get("/index/stats").json(), indent=2))


if __name__ == "__main__":
    main()
