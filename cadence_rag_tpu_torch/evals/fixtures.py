"""Lexicon-rich eval fixtures: three calls + gold queries.

Role parity with the reference gate's fixture set (reference:
eval/run_real_regression_gate.py:169-303): content exercises every lane —
structural tech tokens (error codes, versions, IPs), the domain lexicon
(BOM/Lenovo/Dell/AWS/...), itemized artifacts, and semantically-related
phrasing for the dense lane. Gold ids are resolved from the store by
distinctive-substring lookup after ingest.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

# (title, external_id, [utterance texts], [(artifact kind, content)])
FIXTURE_CALLS: List[Tuple[str, str, List[str], List[Tuple[str, str]]]] = [
    (
        "storage incident review",
        "eval-incident",
        [
            "overnight we saw a flood of ECONNRESET errors from the object store gateway",
            "the spike started right after we upgraded the client library to v2.4.0",
            "rolling back to v2.3.1 stopped the connection resets immediately",
            "longer term we want tiering hot data onto SSD to cut tail latency",
            "I filed OPS-1842 to track the permanent fix with the retry budget",
            "the gateway at 10.2.0.15 needs its keepalive settings tuned as well",
        ],
        [
            ("action_items",
             "- roll back all clients to v2.3.1\n"
             "- tune keepalive on 10.2.0.15\n"
             "- size the SSD tier for hot objects\n"),
            ("decisions",
             "1. we will pin the object store client at v2.3.1 until OPS-1842 closes\n"
             "2. SSD tiering is approved for the next quarter\n"),
            ("summary",
             "The team traced an ECONNRESET storm to the v2.4.0 client upgrade "
             "and rolled back to v2.3.1. SSD tiering was approved to reduce "
             "object store latency."),
        ],
    ),
    (
        "competitive bake-off planning",
        "eval-bakeoff",
        [
            "the customer wants a head-to-head bake-off between our build and dell",
            "lenovo already sent their bill of materials for the new cluster",
            "supermicro is the incumbent so we are competing on density and price",
            "we need the BOM finalized before the bake-off window opens",
            "their procurement team compared us versus dell on power draw",
            "if we win the bake-off the expansion covers three more sites",
        ],
        [
            ("action_items",
             "- finalize the BOM with lenovo pricing\n"
             "- prepare the bake-off test plan versus dell\n"),
            ("summary",
             "Planning a competitive bake-off against Dell with Supermicro as "
             "incumbent; the Lenovo bill of materials is nearly final."),
        ],
    ),
    (
        "support escalation triage",
        "eval-support",
        [
            "the customer hit ORA-00600 after the database patch on prod",
            "their api calls return HTTP 503 from the load balancer",
            "we traced it to a certificate that expired at the edge",
            "JIRA ticket SUP-7731 tracks the root cause analysis",
            "the workaround is routing around the edge at 192.168.4.9",
            "a permanent fix ships with release v5.1.2 next tuesday",
        ],
        [
            ("action_items",
             "- renew the edge certificate\n"
             "- attach the RCA to SUP-7731\n"
             "- verify HTTP 503 alarms fire earlier\n"),
            ("summary",
             "Escalation: ORA-00600 plus HTTP 503 traced to an expired edge "
             "certificate; fix in v5.1.2, tracked in SUP-7731."),
        ],
    ),
    (
        "cloud migration sync",
        "eval-cloud",
        [
            "finance approved moving the analytics workloads from aws to azure",
            "gcp quoted aggressive egress pricing but the team prefers azure",
            "oracle cloud came up for the database tier because of licensing",
            "the azure landing zone needs private endpoints before cutover",
            "we will keep s3 buckets read-only during the migration freeze",
            "the migration runbook lives at /runbooks/cloud/cutover-v3",
        ],
        [
            ("decisions",
             "1. analytics moves from AWS to Azure this quarter\n"
             "2. the database tier stays on OCI for licensing reasons\n"),
            ("notes",
             "Azure landing zone requires private endpoints; GCP ruled out on "
             "egress pricing; runbook at /runbooks/cloud/cutover-v3."),
        ],
    ),
]

# Distractor calls: vocabulary-adjacent content with NO gold entries —
# retrieval must rank the true evidence above these near-misses.
FIXTURE_CALLS.extend([
    (
        "storage roadmap brainstorm",
        "eval-distractor-1",
        [
            "someday we should evaluate object store alternatives broadly",
            "connection resets are a thing many gateways see occasionally",
            "ssd prices keep falling so tiering economics shift every year",
            "there was a version upgrade discussion but nothing was decided",
        ],
        [
            ("notes",
             "General brainstorm about storage directions; no decisions, no "
             "incidents, nothing tracked."),
        ],
    ),
    (
        "vendor smalltalk",
        "eval-distractor-2",
        [
            "lenovo and dell both have interesting roadmaps these days",
            "someone mentioned azure and aws pricing in passing",
            "no bill of materials was discussed in this call",
            "we should schedule a real bake-off conversation later",
        ],
        [
            ("notes", "Vendor chit-chat; nothing actionable."),
        ],
    ),
])

# (query_id, query text, [(table, distinctive substring), ...])
GOLD_QUERIES: List[Tuple[str, str, List[Tuple[str, str]]]] = [
    ("q_econnreset", "what caused the ECONNRESET errors",
     [("chunks", "flood of ECONNRESET errors"),
      ("chunks", "stopped the connection resets"),
      ("artifact_chunks", "traced an ECONNRESET storm")]),
    ("q_rollback", "which version did we roll back to",
     [("chunks", "rolling back to v2.3.1"),
      ("artifact_chunks", "pin the object store client at v2.3.1")]),
    ("q_ssd", "SSD tiering decision",
     [("chunks", "tiering hot data onto SSD"),
      ("artifact_chunks", "SSD tiering is approved")]),
    ("q_bom", "status of the lenovo bill of materials",
     [("chunks", "lenovo already sent their bill of materials"),
      ("artifact_chunks", "finalize the BOM with lenovo")]),
    ("q_bakeoff", "bake-off against dell",
     [("chunks", "head-to-head bake-off"),
      ("artifact_chunks", "bake-off test plan versus dell")]),
    ("q_azure", "why are we moving to azure",
     [("chunks", "from aws to azure"),
      ("artifact_chunks", "analytics moves from AWS to Azure")]),
    ("q_oci", "database licensing on oracle cloud",
     [("chunks", "oracle cloud came up for the database tier"),
      ("artifact_chunks", "database tier stays on OCI")]),
    ("q_ticket", "what is tracked in OPS-1842",
     [("chunks", "OPS-1842 to track the permanent fix")]),
    ("q_ora", "ORA-00600 database error",
     [("chunks", "ORA-00600 after the database patch"),
      ("artifact_chunks", "ORA-00600 plus HTTP 503")]),
    ("q_cert", "why did the api return HTTP 503",
     [("chunks", "HTTP 503 from the load balancer"),
      ("chunks", "certificate that expired at the edge"),
      ("artifact_chunks", "renew the edge certificate")]),
    ("q_sup_ticket", "status of SUP-7731",
     [("chunks", "SUP-7731 tracks the root cause"),
      ("artifact_chunks", "attach the RCA to SUP-7731")]),
    ("q_runbook", "where is the migration runbook",
     [("chunks", "/runbooks/cloud/cutover-v3"),
      ("artifact_chunks", "runbook at /runbooks/cloud/cutover-v3")]),
]


def ingest_fixtures() -> Dict[str, str]:
    """Ingest the fixture calls; returns {external_id: call_id}."""
    from ..ingest.ingest import ingest_analysis, ingest_transcript
    from ..schemas import AnalysisArtifactIn, CallRef, ChunkingOptions, UtteranceIn

    options = ChunkingOptions(target_tokens=25, max_tokens=60, overlap_tokens=4)
    out: Dict[str, str] = {}
    for title, external_id, texts, artifacts in FIXTURE_CALLS:
        ref = CallRef(title=title, external_id=external_id)
        utterances = [
            UtteranceIn(
                speaker=["Ana", "Raj", "Mei"][i % 3],
                start_ts_ms=i * 6000,
                end_ts_ms=i * 6000 + 5000,
                text=text,
            )
            for i, text in enumerate(texts)
        ]
        call_id, _n_utt, _n_chunks = ingest_transcript(ref, utterances, options)
        ingest_analysis(
            CallRef(call_id=call_id),
            [AnalysisArtifactIn(kind=kind, content=content)
             for kind, content in artifacts],
        )
        out[external_id] = call_id
    return out


def resolve_gold() -> Dict[str, List[str]]:
    """Look up gold doc ids by distinctive substring (reference:
    run_real_regression_gate.py:249-303 does the same via SQL)."""
    from ..store.db import get_store

    store = get_store()
    gold: Dict[str, List[str]] = {}
    id_cols = {"chunks": ("chunk_id", "text", "chunk"),
               "artifact_chunks": ("artifact_chunk_id", "content", "artifact_chunk")}
    with store.read() as conn:
        for query_id, _query, needles in GOLD_QUERIES:
            ids: List[str] = []
            for table, needle in needles:
                id_col, text_col, prefix = id_cols[table]
                rows = conn.execute(
                    f"SELECT {id_col} AS i FROM {table} "
                    f"WHERE {text_col} LIKE ? ORDER BY {id_col}",
                    (f"%{needle}%",),
                ).fetchall()
                ids.extend(f"{prefix}:{row['i']}" for row in rows)
            gold[query_id] = sorted(set(ids), key=ids.index)
    return gold
