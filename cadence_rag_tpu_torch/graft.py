"""The port's counterpart of the repository's ``__graft_entry__.py``.

- ``entry(device)``: the forward step of the in-process embedder that feeds
  the index -> ``(forward, (model, tokens))``; ``forward(model, tokens)``
  gives the two texts' (2, 256) unit vectors.
- ``dryrun_multichip(n, device)``: an ``n``-position mesh with ``data`` and
  ``model`` axes (``model:2`` when ``n`` is even), and on it the four
  programs of the JAX package's dry run, each with its asserts: one dp+tp
  contrastive training step of the embedder, the tiny Qwen3 born sharded
  with unit-norm vectors, the corpus-sharded lanes' self-match
  (``sharded_multi_lane``) and a ``CorpusIndex`` on the mesh with a state
  round trip.

Both run on the card unless the caller passes ``device="cpu"``; on the card
the mesh is ``[cuda:0] * n``, a repeated device list, as the JAX tests'
eight virtual CPU devices are. One difference from the JAX dry run: the
tech lane's rows carry 8 hash slots, not 4, because kernel K3 (the tech
lane on CUDA) is built for 8, 16 and 32.
"""

from __future__ import annotations


import numpy as np
import torch

from .device import DeviceLike, resolve_device

ENTRY_TEXTS = ["the ECONNRESET storm started after the object store upgrade",
               "rolling back to v2.3.1 stopped the resets immediately"]
TECH_SLOTS = 8


def _check(ok, message: str) -> None:
    """The JAX dry run's asserts, kept under ``python -O``."""
    if not ok:
        raise AssertionError(message)


def entry(device: DeviceLike = "cuda"):
    """-> (forward, (model, tokens)): the embedder's forward on two texts."""
    from .models import prng
    from .models.embedder import EmbedderConfig, batch_tokenize, init_params

    cfg = EmbedderConfig(
        vocab_buckets=4096, d_model=128, n_layers=2, n_heads=4,
        d_ff=512, max_len=64, embed_dim=256,
    )
    device = resolve_device(device)
    model = init_params(cfg, prng.PRNGKey(0), device)
    tokens = torch.from_numpy(batch_tokenize(ENTRY_TEXTS, cfg)).to(device)

    def forward(model, token_ids):
        return model(token_ids)

    return forward, (model, tokens)


def dryrun_multichip(n_devices: int, device: DeviceLike = "cuda") -> None:
    """The JAX package's ``dryrun_multichip(n)`` on the port, over the mesh
    ``[device] * n_devices``: raises if a program fails or an assert does
    not hold."""
    from .config import settings
    from .core.index import CorpusIndex, DocRow
    from .models import embedder as emb
    from .models import prng
    from .models import qwen3 as q3
    from .parallel.mesh import make_mesh
    from .parallel.sharded import sharded_multi_lane

    device = resolve_device(device)
    model_axis = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    data_axis = n_devices // model_axis
    mesh = make_mesh(f"data:{data_axis},model:{model_axis}", devices=[device] * n_devices)

    # --- full training step: dp over batch, tp over weights -----------------
    cfg = emb.EmbedderConfig(
        vocab_buckets=512, d_model=64, n_layers=2, n_heads=4,
        d_ff=128, max_len=16, embed_dim=64,
    )
    model = emb.shard_params(emb.init_params(cfg, prng.PRNGKey(0), device), mesh)
    opt_state = emb.adamw_init(model.params.leaves())
    batch = 2 * data_axis
    rng = np.random.default_rng(0)
    anchors = rng.integers(1, cfg.vocab_buckets, size=(batch, cfg.max_len)).astype(np.int32)
    positives = rng.integers(1, cfg.vocab_buckets, size=(batch, cfg.max_len)).astype(np.int32)
    _model, _opt, loss = emb.train_step(model, opt_state, anchors, positives)
    _check(np.isfinite(float(loss)), f"non-finite training loss: {loss}")

    # --- Qwen3-shaped encoder: born sharded, tp+dp ----------------------------
    qcfg = q3.PRESETS["tiny"]
    qmodel = q3.init_params(qcfg, prng.PRNGKey(1), device, mesh=mesh)
    qtokens = rng.integers(1, qcfg.vocab_buckets, size=(2 * data_axis, 16)).astype(np.int32)
    qvecs = qmodel(qtokens).float().cpu().numpy()
    qnorms = np.linalg.norm(qvecs, axis=1)
    _check(np.allclose(qnorms, 1.0, atol=1e-3), f"qwen3 norm contract: {qnorms}")

    # --- corpus-sharded retrieval (all three lanes) over the same mesh -------
    n_docs, dim, dlex, k = 64 * data_axis, 32, 128, 8
    emb_rows = rng.standard_normal((n_docs, dim)).astype(np.float32)
    emb_rows /= np.linalg.norm(emb_rows, axis=1, keepdims=True)
    t = torch.from_numpy
    lanes = sharded_multi_lane(
        mesh,
        t(emb_rows).to(torch.bfloat16),
        t(rng.integers(-4, 5, size=(n_docs, dlex)).astype(np.int8)),
        t(rng.integers(0, 50, size=(n_docs, TECH_SLOTS)).astype(np.int32)),
        torch.zeros(n_docs, dtype=torch.int32),
        torch.full((n_docs,), 1000, dtype=torch.int32),
        torch.ones(n_docs, dtype=torch.bool),
        t(emb_rows[:2]),
        t(0.1 * rng.standard_normal((2, dlex)).astype(np.float32)),
        t(rng.integers(0, 50, size=(2, TECH_SLOTS)).astype(np.int32)),
        torch.ones((2, 4), dtype=torch.bool),
        torch.zeros(2, dtype=torch.int32),
        torch.full((2,), 2**31 - 1, dtype=torch.int32),
        k_dense=k, k_lex=k, k_tech=k,
    )
    top = lanes["dense"][1][:, 0].cpu().numpy()
    _check(top[0] == 0 and top[1] == 1, f"self-match failed: {top}")

    # --- the index's own classes sharded over the mesh -----------------------
    saved = settings.index_max_device_rows
    settings.index_max_device_rows = 0
    try:
        def corpus():
            return CorpusIndex("chunks", dim=dim, lex_dim=dlex, tech_slots=TECH_SLOTS,
                               capacity=16 * data_axis, device=device, mesh=mesh)

        def self_match(c, what):
            out = c.query(
                np.asarray(emb_rows[:2], dtype=np.float32),
                np.zeros((2, dlex), np.float32),
                np.zeros((2, TECH_SLOTS), np.int32),
                np.ones((2, 4), bool),
                np.zeros(2, np.int32),
                np.full(2, 2**31 - 1, np.int32),
                k_dense=4, k_lex=4, k_tech=4,
            )
            ids, _, counts = out["dense"]   # rectangular (ids, scores, counts)
            _check(int(counts[0]) >= 1 and int(counts[1]) >= 1, f"{what}: {counts}")
            _check(int(ids[0][0]) == 1 and int(ids[1][0]) == 2,
                   f"{what} self-match failed: {ids[0][:2]}, {ids[1][:2]}")

        first = corpus()
        rows = []
        for i in range(8 * data_axis):
            sig = rng.integers(-3, 4, size=dlex).astype(np.int8)
            rows.append(DocRow(
                doc_id=i + 1, call_seq=0, started_sec=1000 + i,
                lex_sig=sig, lex_dl=8,
                lex_touched=np.flatnonzero(sig)[:16].astype(np.int32),
                tech=np.zeros(TECH_SLOTS, np.int32),
                embedding=np.asarray(emb_rows[i % n_docs]),
            ))
        first.insert(rows)
        self_match(first, "sharded index")
        # checkpoint round trip on the mesh: the state gathers the shards to
        # the host, and a restore lays them over the same mesh again
        second = corpus()
        second.load_state(first.state_arrays())
        self_match(second, "restored sharded index")
    finally:
        settings.index_max_device_rows = saved
