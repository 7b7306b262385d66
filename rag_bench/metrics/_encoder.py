"""Shared by the encoder's readers: the query encoder's ``embed.encode``
events (one a provider call, ``models/qwen3.py``) and the useful
operations of a batch.

A batch's useful operations are the same work whatever computes it: two
a multiply-add of every layer matrix (q, k, v, o, gate, up, down) for each
real token, and per layer four a (query head, key, head feature) of the
causal attention between real positions (the scores and the weighted
values), a text of t tokens holding t(t+1)/2 such pairs. Padding, the
embedding lookup, norms and pooling count nothing.
"""

from __future__ import annotations

from typing import Any, Dict, List


def events(ctx: Dict[str, Any]) -> List[Dict[str, Any]]:
    return [ev for ev in ctx["spans"] if ev["tag"] == "embed.encode"]


def matrix_params(enc: Dict[str, Any]) -> int:
    """Weights in the layers' matrices, from a configuration's
    ``query_encoder`` group."""
    d, f = int(enc["hidden_size"]), int(enc["intermediate_size"])
    q = int(enc["num_attention_heads"]) * int(enc["head_dim"])
    kv = int(enc["num_key_value_heads"]) * int(enc["head_dim"])
    return int(enc["num_hidden_layers"]) * (2 * d * q + 2 * d * kv + 3 * d * f)


def useful_flop(enc: Dict[str, Any], tokens: int, pairs: int) -> float:
    """Operations of a batch of ``tokens`` real tokens holding ``pairs``
    causal (query, key) pairs."""
    attn = (4 * int(enc["num_hidden_layers"]) * int(enc["num_attention_heads"])
            * int(enc["head_dim"]))
    return 2.0 * matrix_params(enc) * tokens + float(attn) * pairs
