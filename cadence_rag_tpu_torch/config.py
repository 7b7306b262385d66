"""Environment-backed configuration.

Counterpart of ``cadence_rag_tpu/config.py``: the same ``Settings``
dataclass — every field, default and environment variable (the upper-cased
field name, or a ``.env`` file named by ``CADENCE_ENV_FILE``) — so one
environment configures both packages alike. The port reads only some of the
fields (index capacity and dtypes, lexical and tech widths, the planner's
thresholds, IVF); the rest are kept so that the two ``Settings`` stay the
same type of record.

The port's ``settings`` is its own object: setting a field on the JAX
package's ``settings`` does not change this one.
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path


def _parse_bool(raw: str) -> bool:
    return raw.strip().lower() in {"1", "true", "yes", "on"}


def _load_env_file(path: str) -> dict:
    values: dict = {}
    p = Path(path)
    if not p.is_file():
        return values
    for line in p.read_text(encoding="utf-8").splitlines():
        line = line.strip()
        if not line or line.startswith("#") or "=" not in line:
            continue
        key, _, val = line.partition("=")
        values[key.strip().upper()] = val.strip().strip("'\"")
    return values


@dataclasses.dataclass
class Settings:
    store_path: str = "./cadence_rag.db"
    skip_version_check: bool = False

    embeddings_base_url: str = ""
    embeddings_model_id: str = "Qwen/Qwen3-Embedding-4B"
    embeddings_dim: int = 1024
    embeddings_timeout_s: float = 180.0
    embeddings_batch_size: int = 32
    embeddings_provider: str = ""

    embeddings_exact_scan_threshold: int = 2000
    embeddings_hnsw_ef_search: int = 80

    ingest_queue_name: str = "ingest"
    ingest_root_dir: str = "./ingest"
    ingest_poll_seconds: int = 5
    ingest_auto_manifest: bool = True
    ingest_single_file_min_age_s: int = 5
    ingest_job_max_attempts: int = 3
    ingest_job_retry_backoff_s: int = 10
    ingest_auto_embed_on_success: bool = True
    ingest_auto_embed_fail_on_error: bool = False

    analysis_pdf_ocr_enabled: bool = False
    analysis_pdf_ocr_command: str = "ocrmypdf"
    analysis_pdf_ocr_languages: str = "eng"
    analysis_pdf_ocr_min_chars: int = 400
    analysis_pdf_ocr_min_alpha_ratio: float = 0.55
    analysis_pdf_ocr_max_pages: int = 150
    analysis_pdf_ocr_timeout_s: int = 600
    analysis_pdf_ocr_force: bool = False

    log_level: str = "INFO"

    index_initial_capacity: int = 4096
    index_embedding_dtype: str = "bfloat16"
    lexical_dim: int = 4096
    lexical_dtype: str = "int8"
    lex_vocab_head: int = 2048
    lex_vocab_auto_rebuild: bool = False
    lex_vocab_drift_buckets: int = 64
    lex_vocab_rebuild_min_growth: float = 1.5
    lex_vocab_bootstrap_docs: int = 0
    lex_vocab_rebuild_check_s: float = 300.0
    lex_vocab_rebuild_cooldown_s: float = 3600.0
    tech_hash_slots: int = 16
    tech_slot_capacity: int = 1
    query_lex_features: int = 256
    device_rrf_enabled: bool = True
    growth_migration_enabled: bool = True
    readback_prefetch_enabled: bool = True
    ann_recall_target: float = 0.95
    dense_ivf_enabled: bool = False
    ivf_min_rows: int = 200_000
    ivf_clusters: int = 0
    ivf_nprobe: int = 0
    dense_ivf_auto_rebuild_multihost: bool = False
    index_max_device_rows: int = 0
    cold_block_rows: int = 262144
    retrieve_batch_window_ms: int = 0
    retrieve_coalesce_enabled: bool = True
    store_sync_interval_s: float = 1.0
    prewarm_growth_enabled: bool = True
    prewarm_fill_fraction: float = 0.75
    prewarm_min_capacity: int = 65536
    # the growth planner's memory budget where the device reports no free
    # memory: the CPU's fallback (a card answers torch.cuda.mem_get_info)
    prewarm_hbm_budget_gb: float = 14.0
    embedder_params_path: str = ""
    qwen3_preset: str = "4b"
    qwen3_params_path: str = ""
    qwen3_tokenizer_path: str = ""
    embed_cache_size: int = 0
    profiler_port: int = 0
    rerank_enabled: bool = False
    rerank_provider: str = "lexical"
    rerank_topk: int = 50
    reranker_params_path: str = ""
    mesh_shape: str = ""
    use_pallas_fused: bool = False
    dist_coordinator: str = ""
    dist_num_processes: int = 0
    dist_process_id: int = 0
    dist_oplog_port: int = 0
    dist_oplog_bind: str = ""
    dist_oplog_token: str = ""

    def __post_init__(self) -> None:
        env = dict(_load_env_file(os.environ.get("CADENCE_ENV_FILE", ".env")))
        env.update(os.environ)
        for field in dataclasses.fields(self):
            raw = env.get(field.name.upper())
            if raw is None:
                continue
            if field.type in ("bool", bool):
                value: object = _parse_bool(raw)
            elif field.type in ("int", int):
                value = int(raw)
            elif field.type in ("float", float):
                value = float(raw)
            else:
                value = raw
            setattr(self, field.name, value)


settings = Settings()
