"""Operations and bytes of the hybrid transformer denoiser (models/dit.py
with KDA layers, models/kda.py) from its configuration's widths and a
call's shapes, counted the same whatever implements them: each input
byte read once, each output byte written once.

- :func:`kda_chunk`: one launch of the KDA kernel (``csrc/kda_chunk.cu``,
  a layer call over ``batch`` sequences of ``seq`` tokens): its products in
  f32, per chunk of n real rows and head of widths dk, dv: the two
  pairwise sums over dk (n(n+1)/2 pairs each), the forward substitution
  over dk + dv columns (n(n−1)/2 rows a column), and the three products
  with the state (u, the output, the update: n·dk·dv each) plus the
  output's n(n+1)/2 intra-chunk rows; q, k, v, g and β read in f32, o
  written in f32. Its bound is against the f32 peak (67 TFLOP/s; the
  kernel does not use the tensor cores) and 3.35 TB/s
  (``benchmark/roofline.py``).
- :func:`flops_per_token`: one denoiser call over one token: every
  product of every layer (KDA's projections, low-rank gates and its
  chunked recurrence; MLA's products and its attention at ``seq`` tokens;
  the dense SwiGLU; the router over every routed expert, the routed
  experts held here at their expected share, k·held/E copies a token, and
  the shared experts), and the patch embedding and head on the
  ``patches`` of the ``seq``; the time and condition MLPs, once a
  sequence, are left out (under 0.1%).

``t`` is the configuration's transformer section (the port's DeepSeek
names, ``linear_attn_config``, ``ep_size``).
"""

from __future__ import annotations

from typing import Mapping, Tuple

from benchmark.roofline import F32, bound_s

CHUNK = 64  # the kernel's chunk


def _kda_dims(t: Mapping) -> Tuple[int, int, int]:
    lac = t["linear_attn_config"]
    return int(lac["num_heads"]), int(lac["head_dim"]), len(lac["kda_layers"])


def _chunk_rows(seq: int):
    full, last = divmod(seq, CHUNK)
    return [CHUNK] * full + ([last] if last else [])


def kda_chunk(t: Mapping, batch: int, seq: int) -> Tuple[float, float]:
    """(operations, bytes) of one KDA kernel launch over ``batch``
    sequences of ``seq`` tokens."""
    heads, d, _ = _kda_dims(t)
    dk = dv = d
    flops = 0.0
    for n in _chunk_rows(seq):
        pairs, below = n * (n + 1) / 2, n * (n - 1) / 2
        flops += (2 * 2 * pairs * dk + 2 * below * (dk + dv) + 3 * 2 * n * dk * dv
                  + 2 * pairs * dv)
    flops *= batch * heads
    tokens = batch * seq * heads
    nbytes = F32 * tokens * (3 * dk + 2 * dv + 1)
    return flops, nbytes


def kda_chunk_bound_s(t: Mapping, batch: int, seq: int) -> float:
    return bound_s(*kda_chunk(t, batch, seq), precision="f32")


def flops_per_token(t: Mapping, seq: int, patches: int) -> float:
    """Operations of one denoiser call over one token (2 per
    multiply-add)."""
    h = int(t["hidden_size"])
    nh, nope, rope, v = (int(t["num_attention_heads"]), int(t["qk_nope_head_dim"]),
                         int(t["qk_rope_head_dim"]), int(t["v_head_dim"]))
    rank = int(t["kv_lora_rank"])
    layers = int(t["num_hidden_layers"])
    heads, d, n_kda = _kda_dims(t)
    width = heads * d
    kda = (2.0 * (3 * h * width + 2 * (h * d + d * width) + h * heads + width * h)
           + kda_chunk(t, 1, seq)[0] / seq)
    mla = (2.0 * (h * nh * (nope + rope) + h * (rank + rope) + rank * nh * (nope + v) + nh * v * h)
           + 2.0 * seq * nh * (nope + rope + v))
    dense = int(t["first_k_dense_replace"])
    e, k, inter = (int(t["n_routed_experts"]), int(t["num_experts_per_tok"]),
                   int(t["moe_intermediate_size"]))
    held = e // int(t.get("ep_size", 1))
    ffn_moe = 2.0 * 3 * h * inter * (k * held / e + int(t["n_shared_experts"])) + 2.0 * h * e
    io = 2.0 * 2 * int(t["patch_size"]) * h * patches / seq
    return (n_kda * kda + (layers - n_kda) * mla + dense * 2.0 * 3 * h * int(t["intermediate_size"])
            + (layers - dense) * ffn_moe + io)
