"""Format adapters: normalize on-disk transcript/analysis files.

Behavioral parity with the reference adapter layer (reference:
app/ingest_adapters.py): strict ``json_turns``; ``markdown_turns`` with
``**Speaker**:`` lines and ``*MM:SS*`` timestamps; tolerant ``auto`` mode
mapping alternative turn-list/text/speaker/timestamp keys with
seconds-vs-milliseconds heuristics; analysis normalization for
text/markdown passthrough, csv/tsv -> markdown table, json records ->
table, html tag-strip, and gated docx/pdf (+OCR) paths.

docx/pdf use python-docx/pypdf when installed and otherwise fall back to
the vendored stdlib extractors (``docformats.py``); the OCR path shells
out to ``ocrmypdf`` only when enabled (reference knobs: app/config.py:
27-34).
"""

from __future__ import annotations

import csv
import io
import json
import re
import subprocess
from html.parser import HTMLParser
from pathlib import Path
from typing import Any, Dict, List, Optional

from ..config import settings
from ..schemas import UtteranceIn


class AdapterError(ValueError):
    pass


# Tolerant key tables for auto mode (reference: ingest_adapters.py:17-54)
TURN_LIST_KEYS = ("turns", "utterances", "segments", "transcript", "items", "content")
TEXT_KEYS = ("text", "content", "utterance", "message", "body", "value")
SPEAKER_KEYS = (
    "speaker", "speaker_name", "speaker_label", "name", "participant",
    "who", "author", "user", "role",
)
SPEAKER_ID_KEYS = ("speaker_id", "participant_id", "user_id")
START_KEYS = ("start_ts_ms", "start_ms", "start_time_ms", "start", "start_ts",
              "start_time", "begin", "from", "ts")
END_KEYS = ("end_ts_ms", "end_ms", "end_time_ms", "end", "end_ts", "end_time",
            "to", "until")

_MD_TURN_RE = re.compile(r"^\*\*(?P<speaker>[^*]+)\*\*\s*:\s*(?P<text>.*)$")
_MD_TS_RE = re.compile(r"^\*(?P<min>\d{1,3}):(?P<sec>\d{2})\*\s*$")


# --------------------------------------------------------------- helpers ----

def _to_ms(value: Any, key: Optional[str] = None) -> Optional[int]:
    """Heuristic normalization to milliseconds, KEY-AWARE like the
    reference (ingest_adapters.py:548-574): a key naming ms passes
    numeric values through unscaled; otherwise numeric strings are
    parsed, values that look like seconds (small, fractional, or
    epoch-second magnitude) are scaled, and already-ms values pass."""
    if value is None:
        return None
    if isinstance(value, str):
        value = value.strip()
        if not value:
            return None
        try:
            value = float(value)
        except ValueError:
            m = re.match(r"^(\d+):(\d{2})(?::(\d{2}))?$", value)
            if m:
                parts = [int(p) for p in m.groups() if p is not None]
                if len(parts) == 2:
                    return (parts[0] * 60 + parts[1]) * 1000
                return (parts[0] * 3600 + parts[1] * 60 + parts[2]) * 1000
            return None
    if isinstance(value, bool):
        return None
    if isinstance(value, (int, float)):
        v = float(value)
        if v < 0:
            return None
        if key is not None and "ms" in key:
            # the field SAYS milliseconds — never rescale (a 5000 ms
            # start under the old value-only heuristic became 5000 s)
            return int(round(v))
        # fractional values are seconds; large integers are already ms
        if isinstance(value, float) and not value.is_integer():
            return int(round(v * 1000))
        if v < 100_000:  # < ~28 hours expressed in seconds
            return int(v * 1000)
        if 1e9 <= v < 1e11:  # epoch-second magnitude (1973..5138)
            return int(v * 1000)
        return int(v)
    return None


def _first_key(obj: Dict[str, Any], keys) -> Optional[Any]:
    for key in keys:
        if key in obj and obj[key] is not None:
            return obj[key]
    return None


def _first_keyed(obj: Dict[str, Any], keys):
    """(key, value) of the first present key — _to_ms needs the KEY to
    honor explicit-ms field names."""
    for key in keys:
        if key in obj and obj[key] is not None:
            return key, obj[key]
    return None, None


def _normalize_turn(obj: Dict[str, Any], prev_end_ms: int) -> Optional[UtteranceIn]:
    text = _first_key(obj, TEXT_KEYS)
    if not isinstance(text, str) or not text.strip():
        return None
    speaker = _first_key(obj, SPEAKER_KEYS)
    speaker_id = _first_key(obj, SPEAKER_ID_KEYS)
    start_key, start_val = _first_keyed(obj, START_KEYS)
    end_key, end_val = _first_keyed(obj, END_KEYS)
    start = _to_ms(start_val, start_key)
    end = _to_ms(end_val, end_key)
    if start is None:
        start = prev_end_ms
    if end is None or end < start:
        end = start + 1000
    return UtteranceIn(
        speaker=str(speaker).strip() if speaker is not None else None,
        speaker_id=str(speaker_id).strip() if speaker_id is not None else None,
        start_ts_ms=start,
        end_ts_ms=end,
        confidence=obj.get("confidence"),
        text=text.strip(),
    )


# ----------------------------------------------------------- transcripts ----

def _strict_json_turns(payload: Any) -> List[UtteranceIn]:
    if isinstance(payload, dict):
        payload = payload.get("content", payload.get("turns"))
    if not isinstance(payload, list):
        raise AdapterError("json_turns payload must be a list of utterances")
    out = []
    for i, turn in enumerate(payload):
        if not isinstance(turn, dict):
            raise AdapterError(f"turn {i} is not an object")
        try:
            out.append(UtteranceIn(**turn))
        except Exception as exc:
            raise AdapterError(f"turn {i} invalid: {exc}") from exc
    if not out:
        raise AdapterError("transcript has no utterances")
    return out


def _auto_object(payload: Any) -> List[UtteranceIn]:
    turns = payload
    if isinstance(payload, dict):
        turns = _first_key(payload, TURN_LIST_KEYS)
    if not isinstance(turns, list):
        raise AdapterError("could not locate a turn list in transcript object")
    out: List[UtteranceIn] = []
    prev_end = 0
    for turn in turns:
        if isinstance(turn, str):
            turn = {"text": turn}
        if not isinstance(turn, dict):
            continue
        norm = _normalize_turn(turn, prev_end)
        if norm is not None:
            out.append(norm)
            prev_end = norm.end_ts_ms
    if not out:
        raise AdapterError("transcript has no usable turns")
    return out


def _markdown_turns(text: str) -> List[UtteranceIn]:
    out: List[UtteranceIn] = []
    current_ts: Optional[int] = None
    prev_end = 0
    for line in text.splitlines():
        ts_match = _MD_TS_RE.match(line.strip())
        if ts_match:
            current_ts = (
                int(ts_match.group("min")) * 60 + int(ts_match.group("sec"))
            ) * 1000
            continue
        turn_match = _MD_TURN_RE.match(line.strip())
        if turn_match:
            start = current_ts if current_ts is not None else prev_end
            utt = UtteranceIn(
                speaker=turn_match.group("speaker").strip(),
                start_ts_ms=start,
                end_ts_ms=start + 1000,
                text=turn_match.group("text").strip(),
            )
            if utt.text:
                out.append(utt)
                prev_end = utt.end_ts_ms
            current_ts = None
    if not out:
        raise AdapterError("markdown transcript has no **Speaker**: lines")
    return out


def load_transcript_payload(path: Path, fmt: str = "auto") -> List[UtteranceIn]:
    raw = Path(path).read_text(encoding="utf-8")
    if fmt == "json_turns":
        return _strict_json_turns(json.loads(raw))
    if fmt == "markdown_turns":
        return _markdown_turns(raw)
    if fmt == "auto":
        suffix = Path(path).suffix.lower()
        if suffix in (".md", ".markdown", ".txt"):
            return _markdown_turns(raw)
        return _auto_object(json.loads(raw))
    raise AdapterError(f"unsupported transcript format: {fmt}")


# -------------------------------------------------------------- analysis ----

class _TextExtractor(HTMLParser):
    def __init__(self) -> None:
        super().__init__()
        self.parts: List[str] = []
        self._skip = 0

    def handle_starttag(self, tag, attrs):
        if tag in ("script", "style"):
            self._skip += 1
        if tag in ("p", "br", "div", "li", "tr", "h1", "h2", "h3", "h4"):
            self.parts.append("\n")

    def handle_endtag(self, tag):
        if tag in ("script", "style") and self._skip:
            self._skip -= 1

    def handle_data(self, data):
        if not self._skip:
            self.parts.append(data)


def _html_to_text(raw: str) -> str:
    parser = _TextExtractor()
    parser.feed(raw)
    text = "".join(parser.parts)
    return re.sub(r"\n{3,}", "\n\n", text).strip()


def _table_to_markdown(rows: List[List[str]]) -> str:
    if not rows:
        return ""
    header, *body = rows
    lines = [
        "| " + " | ".join(str(c) for c in header) + " |",
        "| " + " | ".join("---" for _ in header) + " |",
    ]
    for row in body:
        lines.append("| " + " | ".join(str(c) for c in row) + " |")
    return "\n".join(lines)


def _csv_to_markdown(raw: str, delimiter: str) -> str:
    reader = csv.reader(io.StringIO(raw), delimiter=delimiter)
    rows = [row for row in reader if any(cell.strip() for cell in row)]
    if not rows:
        raise AdapterError("empty csv/tsv file")
    return _table_to_markdown(rows)


def _json_to_text(raw: str) -> str:
    payload = json.loads(raw)
    if isinstance(payload, list) and payload and all(
        isinstance(r, dict) for r in payload
    ):
        keys: List[str] = []
        for record in payload:
            for key in record:
                if key not in keys:
                    keys.append(key)
        rows = [keys] + [
            [str(record.get(k, "")) for k in keys] for record in payload
        ]
        return _table_to_markdown(rows)
    return json.dumps(payload, indent=2, ensure_ascii=False)


def _docx_to_text(path: Path) -> str:
    try:
        import docx  # noqa: PLC0415
    except ImportError:
        # vendored stdlib extractor (reference uses python-docx,
        # ingest_adapters.py:131-164; same paragraph-join output shape)
        from .docformats import ExtractionError, docx_to_text

        try:
            return docx_to_text(Path(path))
        except ExtractionError as exc:
            raise AdapterError(str(exc)) from exc
    try:
        document = docx.Document(str(path))
        return "\n\n".join(
            p.text for p in document.paragraphs if p.text.strip()
        )
    except Exception as exc:  # corrupt/invalid file under python-docx
        raise AdapterError(f"docx extraction failed: {exc}") from exc


def _pdf_text_quality(text: str) -> float:
    if not text:
        return 0.0
    alpha = sum(1 for c in text if c.isalpha() or c.isspace())
    return alpha / max(len(text), 1)


def _should_run_ocr(text: str) -> bool:
    if settings.analysis_pdf_ocr_force:
        return True
    if len(text) < int(settings.analysis_pdf_ocr_min_chars):
        return True
    return _pdf_text_quality(text) < float(settings.analysis_pdf_ocr_min_alpha_ratio)


def _pdf_via_ocr(path: Path) -> str:
    # sidecar and output go to TEMP FILES, matching the reference
    # (ingest_adapters.py:224-273): real ocrmypdf rejects `--sidecar -`
    # combined with output `-` (two streams cannot share stdout), so the
    # previous both-to-stdout invocation failed on every real install
    import tempfile

    with tempfile.TemporaryDirectory() as td:
        sidecar = Path(td) / "sidecar.txt"
        out_pdf = Path(td) / "ocr.pdf"
        cmd = [
            settings.analysis_pdf_ocr_command,
            "--sidecar", str(sidecar),
            "--force-ocr",
            "-l", settings.analysis_pdf_ocr_languages,
            str(path), str(out_pdf),
        ]
        try:
            subprocess.run(
                cmd,
                capture_output=True,
                timeout=int(settings.analysis_pdf_ocr_timeout_s),
                check=True,
            )
        except (subprocess.SubprocessError, OSError) as exc:
            raise AdapterError(f"pdf OCR failed: {exc}") from exc
        try:
            return sidecar.read_text(
                encoding="utf-8", errors="replace"
            ).strip()
        except OSError as exc:
            raise AdapterError(
                f"pdf OCR produced no sidecar text: {exc}"
            ) from exc


def _pdf_to_text(path: Path) -> str:
    text = ""
    try:
        import pypdf  # noqa: PLC0415

        try:
            reader = pypdf.PdfReader(str(path))
            pages = reader.pages[: int(settings.analysis_pdf_ocr_max_pages)]
            text = "\n\n".join(
                (page.extract_text() or "") for page in pages
            ).strip()
        except Exception as exc:  # corrupt/encrypted file under pypdf
            # same contract as the vendored extractor's ExtractionError:
            # typed error when OCR can't rescue, else fall to the gate
            if not settings.analysis_pdf_ocr_enabled:
                raise AdapterError(f"pdf extraction failed: {exc}") from exc
            text = ""
    except ImportError:
        # vendored stdlib extractor for digital PDFs (reference: pypdf at
        # ingest_adapters.py:167-182); scanned PDFs yield "" and fall
        # through to the OCR quality gate below, like the reference
        from .docformats import ExtractionError, pdf_to_text

        try:
            text = pdf_to_text(
                Path(path), max_pages=int(settings.analysis_pdf_ocr_max_pages)
            ).strip()
        except ExtractionError as exc:
            if not settings.analysis_pdf_ocr_enabled:
                raise AdapterError(str(exc)) from exc
    if settings.analysis_pdf_ocr_enabled and _should_run_ocr(text):
        try:
            ocr_text = _pdf_via_ocr(path)
        except AdapterError:
            if text:
                # soft-fail like the reference: usable extracted text
                # beats a hard error when the OCR binary misbehaves
                return text
            raise
        # keep whichever extraction looks better (reference quality gate:
        # ingest_adapters.py:276-293)
        if len(ocr_text) > len(text) or (
            _pdf_text_quality(ocr_text) > _pdf_text_quality(text)
        ):
            return ocr_text
    if not text:
        raise AdapterError("pdf produced no text")
    return text


_ANALYSIS_LOADERS = {
    "text": lambda p: Path(p).read_text(encoding="utf-8"),
    "markdown": lambda p: Path(p).read_text(encoding="utf-8"),
    "csv": lambda p: _csv_to_markdown(Path(p).read_text(encoding="utf-8"), ","),
    "tsv": lambda p: _csv_to_markdown(Path(p).read_text(encoding="utf-8"), "\t"),
    "json": lambda p: _json_to_text(Path(p).read_text(encoding="utf-8")),
    "html": lambda p: _html_to_text(Path(p).read_text(encoding="utf-8")),
    "docx": _docx_to_text,
    "pdf": _pdf_to_text,
}

_SUFFIX_TO_ANALYSIS_FORMAT = {
    ".txt": "text", ".md": "markdown", ".markdown": "markdown",
    ".csv": "csv", ".tsv": "tsv", ".json": "json",
    ".html": "html", ".htm": "html", ".docx": "docx", ".pdf": "pdf",
}


def infer_analysis_format(path: Path) -> str:
    return _SUFFIX_TO_ANALYSIS_FORMAT.get(Path(path).suffix.lower(), "text")


def infer_transcript_format(path: Path) -> str:
    suffix = Path(path).suffix.lower()
    if suffix in (".md", ".markdown"):
        return "markdown_turns"
    if suffix == ".json":
        return "auto"
    return "auto"


def load_analysis_content(path: Path, fmt: str = "auto") -> str:
    if fmt == "auto":
        fmt = infer_analysis_format(path)
    loader = _ANALYSIS_LOADERS.get(fmt)
    if loader is None:
        raise AdapterError(f"unsupported analysis format: {fmt}")
    content = loader(Path(path))
    if not content or not content.strip():
        raise AdapterError(f"analysis file produced no content: {path}")
    return content.strip()
