"""A query's three lane inputs, worked out again from its text.

The semantics of the upstream service's lanes as the deployment states
them, written plainly (NumPy, float64 where the program uses float32):

- lexical: word tokens and character trigrams of the lower-cased,
  whitespace-collapsed text, each FNV-1a 64 hashed (prefix ``w:`` / ``g:``)
  into ``hash % dim`` with the sign of hash bit 33; term frequency capped
  at 3; bucket idf ``log(1 + (N - df + 0.5) / (df + 0.5))``; the vector
  divided by the signatures' quantisation scale 127/4;
- tech tokens: the upstream identifier patterns (URLs, IPs, tickets,
  errno-style codes, HTTP statuses, ORA codes, versions, hex runs, paths)
  and its domain lexicon, deduplicated case-insensitively; each token's
  hash is ``FNV-1a 64("t:" + token.lower()) % 0x7FFFFFFE + 1``;
- dense (the deterministic hash embedder the deployment serves): each
  lexical feature hash seeds a Gaussian direction
  (``numpy.random.default_rng(hash & 0x7FFF...)``), the text embeds to the
  L2-normalised ``log(1 + tf)``-weighted sum of its features' directions.

Nothing here imports the program.
"""

from __future__ import annotations

import re
from typing import Dict, List, Sequence, Tuple

import numpy as np

FNV_OFFSET = 0xCBF29CE484222325
FNV_PRIME = 0x100000001B3
MASK64 = (1 << 64) - 1
LEX_QUANT_SCALE = 127.0 / 4.0
TF_CAP = 3.0

_WORD = re.compile(r"[a-z0-9_]+")
_SPACE = re.compile(r"\s+")

STRUCTURAL = (
    r"(?i)https?://\S+",
    r"\b(?:\d{1,3}\.){3}\d{1,3}\b",
    r"\b[A-Z]{2,10}-\d+\b",
    r"\bE[A-Z0-9_]{2,}\b",
    r"(?i)\bHTTP\s?\d{3}\b",
    r"(?i)\bORA-\d{4,}\b",
    r"\bv?\d+\.\d+(?:\.\d+)?\b",
    r"(?i)\b[a-f0-9]{7,40}\b",
    r"(?:/[\w.\-]+)+",
)
_STRUCTURAL = tuple(re.compile(p) for p in STRUCTURAL)
LEXICON = (
    (r"\bbill of materials\b", "BOM"), (r"\bbom\b", "BOM"),
    (r"\bbuild(?:s|ing)?\b", "build"), (r"\bssd\b", "SSD"),
    (r"\bobject\s+(?:store|storage)\b", "object store"),
    (r"\bobject\b", "object"), (r"\btiering\b", "tiering"),
    (r"\blenovo\b", "Lenovo"), (r"\bdell\b", "Dell"),
    (r"\bsuper[\s-]?micro\b|\bsmc\b", "Supermicro"),
    (r"\baws\b|\bamazon web services\b", "AWS"), (r"\bamazon\b", "Amazon"),
    (r"\bazure\b", "Azure"), (r"\bmicrosoft\b", "Microsoft"),
    (r"\bgcp\b|\bgoogle cloud(?: platform)?\b", "GCP"),
    (r"\bgoogle\b", "Google"),
    (r"\boci\b|\boracle cloud(?: infrastructure)?\b", "OCI"),
    (r"\boracle\b", "Oracle"),
    (r"\bcompet(?:e|es|ing|ition|itive|itor|itors)\b", "competitive"),
    (r"\bincumbent\b", "incumbent"), (r"\bbake[\s-]?off\b", "bake-off"),
    (r"\bhead[\s-]?to[\s-]?head\b", "head-to-head"),
    (r"\bvs\.?(?=\s|$)|\bversus\b", "vs"),
)
_LEXICON = tuple((re.compile(p, re.IGNORECASE), c) for p, c in LEXICON)


def fnv1a64(data: bytes) -> int:
    h = FNV_OFFSET
    for byte in data:
        h = ((h ^ byte) * FNV_PRIME) & MASK64
    return h


def lexical_features(text: str) -> Tuple[np.ndarray, np.ndarray]:
    """-> (feature hashes uint64, term frequencies) in first-occurrence
    order: the words, then the trigrams."""
    norm = _SPACE.sub(" ", text.lower()).strip()
    counts: Dict[int, int] = {}
    for word in _WORD.findall(norm):
        h = fnv1a64(b"w:" + word.encode("utf-8"))
        counts[h] = counts.get(h, 0) + 1
    data = norm.encode("utf-8")
    for i in range(len(data) - 2):
        h = fnv1a64(b"g:" + data[i:i + 3])
        counts[h] = counts.get(h, 0) + 1
    return (np.array(list(counts), dtype=np.uint64),
            np.array(list(counts.values()), dtype=np.float64))


def lexical_query(text: str, dim: int, doc_freq: np.ndarray,
                  n_docs: int) -> np.ndarray:
    """The idf-weighted signed query vector, float64 (dim,)."""
    hashes, tfs = lexical_features(text)
    q = np.zeros(dim, dtype=np.float64)
    if hashes.size == 0 or n_docs <= 0:
        return q
    buckets = (hashes % np.uint64(dim)).astype(np.int64)
    signs = np.where((hashes >> np.uint64(33)) & np.uint64(1), 1.0, -1.0)
    df = doc_freq[buckets].astype(np.float64)
    idf = np.log(1.0 + (n_docs - df + 0.5) / (df + 0.5))
    np.add.at(q, buckets, signs * idf * np.minimum(tfs, TF_CAP))
    return q / LEX_QUANT_SCALE


def tech_tokens(text: str) -> List[str]:
    """Identifier matches, then lexicon canonicals, deduplicated
    case-insensitively in first-seen order."""
    found: List[str] = []
    for pattern in _STRUCTURAL:
        found.extend(pattern.findall(text))
    for pattern, canonical in _LEXICON:
        if pattern.search(text):
            found.append(canonical)
    seen, out = set(), []
    for token in found:
        token = token.strip()
        if token and token.lower() not in seen:
            seen.add(token.lower())
            out.append(token)
    return out


def tech_hash(token: str) -> int:
    return fnv1a64(b"t:" + token.strip().lower().encode("utf-8")) % 0x7FFFFFFE + 1


def tech_hashes(text: str) -> np.ndarray:
    """The query's distinct tech token hashes (int64)."""
    return np.array(sorted({tech_hash(t) for t in tech_tokens(text)}),
                    dtype=np.int64)


def _direction(h: int, dim: int) -> np.ndarray:
    return np.random.default_rng(int(h) & 0x7FFFFFFFFFFFFFFF).standard_normal(
        dim).astype(np.float32)


def embed(texts: Sequence[str], dim: int) -> np.ndarray:
    """Unit vectors, float64 (len(texts), dim)."""
    cache: Dict[int, np.ndarray] = {}
    out = np.zeros((len(texts), dim), dtype=np.float64)
    for i, text in enumerate(texts):
        hashes, tfs = lexical_features(text)
        if hashes.size == 0:
            out[i, 0] = 1.0
            continue
        for h, tf in zip(hashes.tolist(), tfs.tolist()):
            d = cache.get(h)
            if d is None:
                d = cache[h] = _direction(h, dim)
            out[i] += np.log1p(tf) * d.astype(np.float64)
        out[i] /= np.linalg.norm(out[i])
    return out
