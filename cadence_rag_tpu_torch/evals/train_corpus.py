"""Synthetic paraphrase-structured training corpus for the embedder.

The dense lane's value over the lexical lanes is PARAPHRASE matching —
finding "rolling back to v2.3.1 stopped the resets" for the query "the
downgrade fixed the failures". A hash embedder (embed/stub.py) cannot do
this: unseen synonyms hash to unrelated buckets. A *trained* embedder can,
by learning from data in which paraphrases co-occur — exactly what call
transcripts + their analysis artifacts provide (summaries restate
transcript content in different words; reference data model:
app/ingest.py transcripts vs analysis artifacts).

This module generates that structure synthetically at any size: each call
is (service, event) with transcript sentences phrased in "spoken" wording
and a summary artifact phrased in disjoint "report" wording. Training on
(transcript chunk, summary chunk) positives teaches the synonym pairs; a
HELD-OUT set of (service, event) combinations provides eval queries whose
gold transcripts share almost no content words with the query — the
paraphrase gate (evals/paraphrase_gate.py).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

SERVICES = [
    "billing-api", "auth-gateway", "ledger-core", "search-tier",
    "ingest-relay", "quota-broker", "metrics-hub", "session-cache",
    "export-runner", "webhook-bus", "audit-log", "rate-limiter",
    "token-mint", "image-proxy", "mail-router", "feed-builder",
    "geo-lookup", "price-engine", "cart-svc", "checkout-flow",
    "inventory-db", "shard-mover", "backup-agent", "cron-master",
]

# Each event: transcript phrasings (spoken register) vs summary/query
# phrasings (report register) with deliberately disjoint content words.
EVENTS: Dict[str, Dict[str, List[str]]] = {
    "rollback": {
        "transcript": [
            "we rolled {svc} back to the previous build and the errors stopped",
            "after rolling back {svc} everything went quiet again",
            "the fix was simple: roll {svc} back and watch the errors disappear",
        ],
        "summary": [
            "downgrading {svc} resolved the breakage",
            "the {svc} downgrade cured the failures",
            "reverting {svc} eliminated the fault",
        ],
    },
    "capacity": {
        "transcript": [
            "{svc} is running hot, we need more machines before friday",
            "we should add boxes to {svc} because utilization keeps climbing",
            "{svc} will fall over under load unless we add hardware",
        ],
        "summary": [
            "scaling {svc} out requires extra nodes",
            "{svc} capacity expansion was approved",
            "provisioning additional instances for {svc}",
        ],
    },
    "cert": {
        "transcript": [
            "the tls handshake to {svc} started failing at midnight",
            "clients of {svc} saw handshake errors until we renewed things",
            "{svc} was rejecting connections because the handshake broke",
        ],
        "summary": [
            "an expired certificate on {svc} caused the outage",
            "{svc} certificate expiry triggered the incident",
            "renewing the {svc} certificate restored service",
        ],
    },
    "slowness": {
        "transcript": [
            "{svc} got really sluggish after the deploy, pages taking forever",
            "users complain {svc} is crawling since tuesday",
            "everything through {svc} feels slow, the dashboards agree",
        ],
        "summary": [
            "elevated latency on {svc} degraded response times",
            "{svc} p99 latency regression identified",
            "the {svc} latency spike traced to the release",
        ],
    },
    "quota": {
        "transcript": [
            "{svc} keeps hitting the ceiling and rejecting work",
            "jobs bounce off {svc} because we maxed out the allowance",
            "{svc} throttles us every afternoon when traffic peaks",
        ],
        "summary": [
            "{svc} quota exhaustion caused request rejections",
            "raising the {svc} rate limit fixed the throttling",
            "{svc} exceeded its allocation during peak hours",
        ],
    },
    "migration": {
        "transcript": [
            "we are moving {svc} to the new cluster next sprint",
            "{svc} moves over to the fresh environment once tests pass",
            "the plan is to lift {svc} onto the new platform in stages",
        ],
        "summary": [
            "the {svc} migration to the target infrastructure is scheduled",
            "cutover of {svc} proceeds in phases",
            "{svc} relocation to the new stack was planned",
        ],
    },
    "datafix": {
        "transcript": [
            "some rows in {svc} ended up wrong and we patched them by hand",
            "we found bad records inside {svc} and cleaned them up",
            "{svc} had corrupted entries that needed manual repair",
        ],
        "summary": [
            "a data integrity issue in {svc} required remediation",
            "inconsistent {svc} records were corrected",
            "the {svc} corruption was repaired with a backfill",
        ],
    },
    "oncall": {
        "transcript": [
            "{svc} paged us three times last night for nothing",
            "the {svc} alerts keep waking people up with false alarms",
            "we silenced the noisy {svc} pager rules this morning",
        ],
        "summary": [
            "alert fatigue from {svc} false positives was addressed",
            "{svc} paging thresholds were retuned",
            "spurious {svc} notifications were suppressed",
        ],
    },
}

FILLER = [
    "let's circle back on the roadmap next week",
    "minutes will go out after the call",
    "thanks everyone for joining on short notice",
    "the usual dashboards have the details",
]


@dataclasses.dataclass
class SynthCall:
    service: str
    event: str
    external_id: str
    transcript: List[str]
    summary: str


def generate_calls(
    combos: Sequence[Tuple[str, str]], seed: int = 0
) -> List[SynthCall]:
    rng = np.random.default_rng(seed)
    calls = []
    for i, (svc, event) in enumerate(combos):
        spec = EVENTS[event]
        n_t = min(len(spec["transcript"]), 2 + int(rng.integers(0, 2)))
        t_idx = rng.choice(len(spec["transcript"]), size=n_t, replace=False)
        transcript = [spec["transcript"][j].format(svc=svc) for j in t_idx]
        transcript.append(FILLER[int(rng.integers(0, len(FILLER)))])
        s_idx = int(rng.integers(0, len(spec["summary"])))
        summary = spec["summary"][s_idx].format(svc=svc)
        calls.append(SynthCall(
            service=svc, event=event,
            external_id=f"synth-{svc}-{event}-{i}",
            transcript=transcript, summary=summary,
        ))
    return calls


def train_eval_split(
    n_services: int = len(SERVICES), holdout: int = 24, seed: int = 0
) -> Tuple[List[Tuple[str, str]], List[Tuple[str, str]]]:
    """All (service, event) combos; ``holdout`` pairs are excluded from
    training and become the paraphrase eval set. Every service and every
    event still appears in training (only the combination is unseen)."""
    rng = np.random.default_rng(seed)
    combos = [(s, e) for s in SERVICES[:n_services] for e in EVENTS]
    rng.shuffle(combos)
    eval_combos: List[Tuple[str, str]] = []
    seen_services: Dict[str, int] = {}
    seen_events: Dict[str, int] = {}
    for combo in combos:
        s, e = combo
        # keep at least 4 training combos per service and per event
        if (len(eval_combos) < holdout
                and seen_services.get(s, 0) < 2 and seen_events.get(e, 0) < 4):
            eval_combos.append(combo)
            seen_services[s] = seen_services.get(s, 0) + 1
            seen_events[e] = seen_events.get(e, 0) + 1
    train_combos = [c for c in combos if c not in eval_combos]
    return train_combos, eval_combos


def ingest_synth_calls(calls: Sequence[SynthCall]) -> Dict[str, str]:
    from ..ingest.ingest import ingest_analysis, ingest_transcript
    from ..schemas import AnalysisArtifactIn, CallRef, ChunkingOptions, UtteranceIn

    options = ChunkingOptions(target_tokens=12, max_tokens=40, overlap_tokens=0)
    out: Dict[str, str] = {}
    for call in calls:
        ref = CallRef(title=f"{call.service} {call.event}",
                      external_id=call.external_id)
        utterances = [
            UtteranceIn(speaker=["Ana", "Raj"][i % 2], start_ts_ms=i * 5000,
                        end_ts_ms=i * 5000 + 4500, text=t)
            for i, t in enumerate(call.transcript)
        ]
        call_id, _, _ = ingest_transcript(ref, utterances, options)
        ingest_analysis(
            CallRef(call_id=call_id),
            [AnalysisArtifactIn(kind="summary", content=call.summary)],
        )
        out[call.external_id] = call_id
    return out


def paraphrase_queries(
    eval_combos: Sequence[Tuple[str, str]], seed: int = 1
) -> List[Tuple[str, str, str]]:
    """-> [(query_id, query text, external_id of the gold call)]. Queries
    use the REPORT register (summary phrasings the gold call did not use,
    when possible) so lexical overlap with the gold transcript is ~just
    the service name."""
    rng = np.random.default_rng(seed)
    out = []
    for i, (svc, event) in enumerate(eval_combos):
        phrasings = EVENTS[event]["summary"]
        q = phrasings[int(rng.integers(0, len(phrasings)))].format(svc=svc)
        out.append((f"pq_{i}_{svc}_{event}", q,
                    None))  # external_id filled by caller mapping
    return out
