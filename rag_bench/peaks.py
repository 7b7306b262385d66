"""The card's published peaks and the kernels' least times.

One NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at its 700 W
limit): 3,350 GB/s of HBM, 989 TFLOP/s in bf16, 16.7 TOP/s of int32
operations. A kernel's least time is the larger of its bytes at the HBM
rate and its operations at their type's rate; each input byte counts once
and each output byte once, whatever the kernel reads again.

The arithmetic of K1 and K3 is ``chip_smoke.py``'s (``check_k1``,
``k3_timing``), from the shapes of one launch.
"""

from __future__ import annotations

HBM_BYTES_S = 3350e9
BF16_FLOP_S = 989e12
INT32_OP_S = 16.7e12


def k1_least_s(rows: int, batch: int, dim: int, lex_dim: int, emb_bytes: int,
               dense: bool) -> float:
    """K1, the fused dense + lexical scan (``csrc/fused_scan.cu``), over
    ``rows`` rows for ``batch`` queries: every row's embedding (when the
    dense lane runs), signature and embedding flag, and the (batch, rows)
    filter mask, read once; two operations a product of the lanes' useful
    work at the bf16 tensor rate."""
    width = (dim * emb_bytes if dense else 0) + lex_dim + 1
    nbytes = rows * width + batch * rows
    flops = 2.0 * batch * rows * ((dim if dense else 0) + lex_dim)
    return max(nbytes / HBM_BYTES_S, flops / BF16_FLOP_S)


def k3_least_s(rows: int, slots: int, batch: int, width: int, nonzero: int,
               k: int, range_rows: int = 1024) -> float:
    """K3, the tech lane's range top-k (``csrc/tech_keys.cu``): every row's
    slots and start second and the queries' structures read once, each
    range's k int64 keys written once; one compare per row and nonzero
    query column (``nonzero`` summed over the batch). The mask bytes of the
    matching pairs, which the kernel also reads, are left out: a few
    hundred a query."""
    ranges = -(-rows // range_rows)
    nbytes = rows * (slots * 4 + 4) + batch * width * 4 + batch * ranges * k * 8
    return max(nbytes / HBM_BYTES_S, rows * nonzero / INT32_OP_S)
