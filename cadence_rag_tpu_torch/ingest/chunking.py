"""Transcript and artifact chunking + tech-token extraction.

Counterpart of ``cadence_rag_tpu/ingest/chunking.py``.

Behavioral-parity port of the reference's pure ingest logic (reference:
app/ingest.py:24-363): same chunk boundaries, same speaker labeling, same
itemization of action_items/decisions artifacts, same token-extraction
outcomes — so the exact-token lane and the eval gold sets behave
identically. Implementation is table-driven rather than a regex list so
domain lexicons are pluggable.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import re
from typing import Dict, List, Optional, Sequence, Tuple

from ..schemas import ChunkingOptions, UtteranceIn

PIPELINE_VERSION = "tpu-v1"

TOKEN_RE = re.compile(r"\w+|[^\w\s]", re.UNICODE)
BULLET_RE = re.compile(r"^\s*(?:[-*•]|\d+[.)])\s+\S")
ITEMIZED_KINDS = frozenset({"action_items", "decisions"})

# Structural tech-token patterns: technical identifiers worth exact-match
# retrieval (urls, IPs, tickets, errno-style codes, HTTP statuses, ORA
# codes, versions, commit hashes, file paths) — reference behavior:
# app/ingest.py:24-34.
STRUCTURAL_PATTERNS: Tuple[re.Pattern, ...] = (
    re.compile(r"https?://\S+", re.IGNORECASE),
    re.compile(r"\b(?:\d{1,3}\.){3}\d{1,3}\b"),
    re.compile(r"\b[A-Z]{2,10}-\d+\b"),
    re.compile(r"\bE[A-Z0-9_]{2,}\b"),
    re.compile(r"\bHTTP\s?\d{3}\b", re.IGNORECASE),
    re.compile(r"\bORA-\d{4,}\b", re.IGNORECASE),
    re.compile(r"\bv?\d+\.\d+(?:\.\d+)?\b"),
    re.compile(r"\b[a-f0-9]{7,40}\b", re.IGNORECASE),
    re.compile(r"(?:/[\w.\-]+)+"),
)

# Domain lexicon: (trigger regex, canonical token). Keeps the exact-token
# lane relevant for sales/SE call content — reference: app/ingest.py:37-73.
DOMAIN_LEXICON: Tuple[Tuple[re.Pattern, str], ...] = tuple(
    (re.compile(pattern, re.IGNORECASE), canonical)
    for pattern, canonical in [
        (r"\bbill of materials\b", "BOM"),
        (r"\bbom\b", "BOM"),
        (r"\bbuild(?:s|ing)?\b", "build"),
        (r"\bssd\b", "SSD"),
        (r"\bobject\s+(?:store|storage)\b", "object store"),
        (r"\bobject\b", "object"),
        (r"\btiering\b", "tiering"),
        (r"\blenovo\b", "Lenovo"),
        (r"\bdell\b", "Dell"),
        (r"\bsuper[\s-]?micro\b|\bsmc\b", "Supermicro"),
        (r"\baws\b|\bamazon web services\b", "AWS"),
        (r"\bamazon\b", "Amazon"),
        (r"\bazure\b", "Azure"),
        (r"\bmicrosoft\b", "Microsoft"),
        (r"\bgcp\b|\bgoogle cloud(?: platform)?\b", "GCP"),
        (r"\bgoogle\b", "Google"),
        (r"\boci\b|\boracle cloud(?: infrastructure)?\b", "OCI"),
        (r"\boracle\b", "Oracle"),
        (r"\bcompet(?:e|es|ing|ition|itive|itor|itors)\b", "competitive"),
        (r"\bincumbent\b", "incumbent"),
        (r"\bbake[\s-]?off\b", "bake-off"),
        (r"\bhead[\s-]?to[\s-]?head\b", "head-to-head"),
        (r"\bvs\.?(?=\s|$)|\bversus\b", "vs"),
    ]
)


def count_tokens(text: str) -> int:
    return len(TOKEN_RE.findall(text))


# Sound pre-gates: each entry lists lowercase literals of which at least
# one MUST occur in text.lower() for the pattern to possibly match (every
# alternative of the pattern contains one of the literals). When no
# literal is present the regex is skipped — pure fast-path pruning, the
# match outcome is unchanged (differential-tested against the ungated
# loop). Typical queries run 2-3 of the 33 regexes.
_LEXICON_GATES: Tuple[Tuple[str, Optional[str]], ...] = (
    ("bill", None), ("bom", None), ("build", None), ("ssd", None),
    ("object", None), ("object", None), ("tiering", None),
    ("lenovo", None), ("dell", None), ("micro", "smc"),
    ("aws", "amazon"), ("amazon", None), ("azure", None),
    ("microsoft", None), ("gcp", "google"), ("google", None),
    ("oci", "oracle"), ("oracle", None), ("compet", None),
    ("incumbent", None), ("bake", None), ("head", None),
    ("vs", "versus"),
)
assert len(_LEXICON_GATES) == len(DOMAIN_LEXICON)
# fused (pattern, canonical, gate1, gate2) rows: one tight tuple unpack
# per lexicon entry in the hot loop (no per-entry any()-genexpr)
_LEXICON_ROWS: Tuple[Tuple[re.Pattern, str, str, Optional[str]], ...] = (
    tuple(
        (pattern, canonical, g1, g2)
        for (pattern, canonical), (g1, g2) in zip(
            DOMAIN_LEXICON, _LEXICON_GATES
        )
    )
)

_DIGITS = frozenset("0123456789")


def _structural_matches(text: str, low: str) -> List[str]:
    has_digit = not _DIGITS.isdisjoint(text)
    has_dot = "." in text
    p = STRUCTURAL_PATTERNS
    found: List[str] = []
    if "http" in low:
        found.extend(p[0].findall(text))
    if has_digit and has_dot:
        found.extend(p[1].findall(text))
    if has_digit and "-" in text:
        found.extend(p[2].findall(text))
    if "E" in text:
        found.extend(p[3].findall(text))
    if has_digit and "http" in low:
        found.extend(p[4].findall(text))
    if "ora-" in low:
        found.extend(p[5].findall(text))
    if has_digit and has_dot:
        found.extend(p[6].findall(text))
    found.extend(p[7].findall(text))  # hex runs ungated (weak literal)
    if "/" in text:
        found.extend(p[8].findall(text))
    return found


def extract_tech_tokens(text: str) -> List[str]:
    """Structural matches first, then lexicon canonicals; dedupe
    case-insensitively preserving first-seen order."""
    low = text.lower()
    found = _structural_matches(text, low)
    for pattern, canonical, g1, g2 in _LEXICON_ROWS:
        if (g1 in low or (g2 is not None and g2 in low)) \
                and pattern.search(text):
            found.append(canonical)
    seen: set = set()
    out: List[str] = []
    for token in found:
        token = token.strip()
        key = token.lower()
        if token and key not in seen:
            seen.add(key)
            out.append(token)
    return out


def _extract_tech_tokens_ungated(text: str) -> List[str]:
    """The plain 33-regex loop — kept as the differential-test oracle for
    the gated fast path above (identical outputs by construction)."""
    found: List[str] = []
    for pattern in STRUCTURAL_PATTERNS:
        found.extend(pattern.findall(text))
    for pattern, canonical in DOMAIN_LEXICON:
        if pattern.search(text):
            found.append(canonical)
    seen: set = set()
    out: List[str] = []
    for token in found:
        token = token.strip()
        key = token.lower()
        if token and key not in seen:
            seen.add(key)
            out.append(token)
    return out


@dataclasses.dataclass
class Utterance:
    utterance_id: int
    speaker: Optional[str]
    speaker_id: Optional[str]
    start_ts_ms: int
    end_ts_ms: int
    confidence: Optional[float]
    text: str
    token_count: int


@dataclasses.dataclass
class Chunk:
    speaker: str
    start_ts_ms: int
    end_ts_ms: int
    token_count: int
    text: str
    utterance_ids: List[int]


@dataclasses.dataclass
class ArtifactChunk:
    ordinal: int
    content: str
    token_count: int
    start_char: Optional[int]
    end_char: Optional[int]
    tech_tokens: List[str]


def _speaker_prefixed(u: Utterance) -> str:
    return f"{u.speaker}: {u.text}" if u.speaker else u.text


def build_chunks(
    utterances: Sequence[Utterance], options: ChunkingOptions
) -> List[Chunk]:
    """Greedy packer: accumulate utterances until >= target_tokens, never
    exceeding max_tokens mid-chunk (a single oversized utterance still forms
    its own chunk); then back up whole utterances worth >= overlap_tokens
    while guaranteeing forward progress. Single-speaker chunks keep the
    speaker label, mixed ones get "MULTI". (Reference behavior:
    app/ingest.py:299-363.)"""
    out: List[Chunk] = []
    i, n = 0, len(utterances)
    while i < n:
        picked: List[Utterance] = []
        tokens = 0
        window_start = i
        while i < n:
            u = utterances[i]
            if picked and tokens + u.token_count > options.max_tokens:
                break
            picked.append(u)
            tokens += u.token_count
            i += 1
            if tokens >= options.target_tokens:
                break
        if not picked:
            u = utterances[i]
            picked, tokens = [u], u.token_count
            i += 1

        if options.overlap_tokens > 0:
            overlap_n, acc = 0, 0
            for u in reversed(picked):
                acc += u.token_count
                overlap_n += 1
                if acc >= options.overlap_tokens:
                    break
            overlap_n = min(overlap_n, max(len(picked) - 1, 0))
            if overlap_n > 0:
                i = max(window_start + 1, i - overlap_n)

        speakers = {u.speaker for u in picked if u.speaker}
        label = speakers.pop() if len(speakers) == 1 else "MULTI"
        out.append(
            Chunk(
                speaker=label or "MULTI",
                start_ts_ms=picked[0].start_ts_ms,
                end_ts_ms=picked[-1].end_ts_ms,
                token_count=tokens,
                text="\n".join(_speaker_prefixed(u) for u in picked),
                utterance_ids=[u.utterance_id for u in picked],
            )
        )
    return out


def _trimmed_span(content: str, start: int, end: int) -> Optional[Tuple[str, int, int]]:
    raw = content[start:end]
    stripped = raw.strip()
    if not stripped:
        return None
    left = start + (len(raw) - len(raw.lstrip()))
    return stripped, left, left + len(stripped)


def _paragraph_spans(content: str) -> List[Tuple[str, int, int]]:
    spans: List[Tuple[str, int, int]] = []
    para_start: Optional[int] = None
    cursor = 0
    for line in content.splitlines(keepends=True):
        begin = cursor
        cursor += len(line)
        if line.strip():
            if para_start is None:
                para_start = begin
        elif para_start is not None:
            span = _trimmed_span(content, para_start, begin)
            if span:
                spans.append(span)
            para_start = None
    if para_start is not None:
        span = _trimmed_span(content, para_start, len(content))
        if span:
            spans.append(span)
    if not spans:
        span = _trimmed_span(content, 0, len(content))
        if span:
            spans.append(span)
    return spans


def _bullet_spans(segment: str, base: int) -> List[Tuple[str, int, int]]:
    spans: List[Tuple[str, int, int]] = []
    saw_bullet = False
    item_start: Optional[int] = None
    cursor = 0
    for line in segment.splitlines(keepends=True):
        begin = cursor
        cursor += len(line)
        if BULLET_RE.match(line):
            saw_bullet = True
            if item_start is not None:
                span = _trimmed_span(segment, item_start, begin)
                if span:
                    spans.append((span[0], base + span[1], base + span[2]))
            item_start = begin
        elif item_start is None and line.strip():
            item_start = begin
    if item_start is not None:
        span = _trimmed_span(segment, item_start, len(segment))
        if span:
            spans.append((span[0], base + span[1], base + span[2]))
    return spans if saw_bullet else []


def build_artifact_chunks(kind: str, content: str) -> List[ArtifactChunk]:
    """Paragraph-level units; action_items/decisions additionally itemize
    bullet/numbered lines so each item is separately retrievable
    (reference behavior: app/ingest.py:249-296)."""
    itemize = kind.strip().lower() in ITEMIZED_KINDS
    chunks: List[ArtifactChunk] = []
    ordinal = 0
    for seg_text, seg_start, seg_end in _paragraph_spans(content):
        units = (
            _bullet_spans(seg_text, seg_start) if itemize else []
        ) or [(seg_text, seg_start, seg_end)]
        for text, start, end in units:
            text = text.strip()
            if not text:
                continue
            chunks.append(
                ArtifactChunk(
                    ordinal=ordinal,
                    content=text,
                    token_count=count_tokens(text),
                    start_char=start,
                    end_char=end,
                    tech_tokens=extract_tech_tokens(text),
                )
            )
            ordinal += 1
    if chunks:
        return chunks
    fallback = content.strip()
    if not fallback:
        return []
    return [
        ArtifactChunk(
            ordinal=0,
            content=fallback,
            token_count=count_tokens(fallback),
            start_char=0,
            end_char=len(fallback),
            tech_tokens=extract_tech_tokens(fallback),
        )
    ]


def transcript_hash(
    utterances: Sequence[UtteranceIn], options: ChunkingOptions
) -> str:
    """Canonical-JSON sha256 idempotency key over (utterances, chunking
    options) — reference behavior: app/ingest.py:120-138."""
    normalized = [
        {
            "speaker": (u.speaker or "").strip(),
            "speaker_id": (u.speaker_id or "").strip(),
            "start_ts_ms": int(u.start_ts_ms),
            "end_ts_ms": int(u.end_ts_ms),
            "text": u.text.strip(),
        }
        for u in utterances
    ]
    payload: Dict = {
        "chunking_options": options.model_dump(mode="json"),
        "utterances": normalized,
    }
    blob = json.dumps(payload, separators=(",", ":"), ensure_ascii=False)
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()
