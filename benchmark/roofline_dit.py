"""Operations and bytes of the transformer denoiser (models/dit.py) from
its configuration's widths and a call's shapes, counted the same whatever
implements them: each input byte read once, each output byte written once;
a bound is the larger of operations over the bf16 peak and bytes over the
HBM bandwidth (``benchmark/roofline.py``'s peaks).

``t`` is the configuration's transformer section (Moonlight's keys).
"""

from __future__ import annotations

from typing import List, Mapping, Tuple

from benchmark.roofline import BF16, F32, bound_s


def _dims(t: Mapping):
    return (int(t["hidden_size"]), int(t["num_attention_heads"]), int(t["qk_nope_head_dim"]),
            int(t["qk_rope_head_dim"]), int(t["v_head_dim"]), int(t["kv_lora_rank"]))


def layers(t: Mapping) -> Tuple[int, int]:
    """(dense layers, routed layers)."""
    dense = int(t["first_k_dense_replace"])
    return dense, int(t["num_hidden_layers"]) - dense


def grouped_products(t: Mapping, tokens: int) -> List[Tuple[str, float, float]]:
    """(epilogue, operations, bytes) of each grouped-kernel launch of one
    denoiser call over ``tokens`` tokens: for each routed layer, over its
    R = tokens · k token copies, a SwiGLU (bf16 A (R, H), the experts'
    [gate | up] (E, H, 2I) -> bf16 (R, I)) and a down product (bf16 (R,
    I), (E, I, H) -> f32 (R, H), with the routing weight and destination
    row of each row read). Every expert is counted as read: at ~700 rows
    an expert, none goes without."""
    h = int(t["hidden_size"])
    _, routed = layers(t)
    k, e, inter = int(t["num_experts_per_tok"]), int(t["n_routed_experts"]), int(
        t["moe_intermediate_size"])
    rows = tokens * k
    gu = (2.0 * rows * h * 2 * inter, BF16 * (rows * h + e * h * 2 * inter + rows * inter))
    down = (2.0 * rows * inter * h,
            BF16 * (rows * inter + e * inter * h) + F32 * rows * h + 8 * rows)
    return [("swiglu",) + gu, ("down",) + down] * routed


def grouped_bound_s(t: Mapping, tokens: int) -> float:
    """The summed bound of one call's grouped-kernel launches."""
    return sum(bound_s(f, b) for _, f, b in grouped_products(t, tokens))


def attention(t: Mapping, batch: int, seq: int) -> Tuple[float, float]:
    """(operations, bytes) of one layer's attention over ``batch``
    sequences of ``seq`` tokens, bidirectional: QKᵀ at qk_nope + qk_rope
    and PV at v_head_dim for every head; bf16 Q, K (every head's rope key
    counted, as the kernel reads it), V read once and the bf16 output
    written once."""
    _, nh, nope, rope, v, _ = _dims(t)
    qk = nope + rope
    flops = 2.0 * batch * nh * seq * seq * (qk + v)
    nbytes = BF16 * batch * nh * seq * (2 * qk + 2 * v)
    return flops, nbytes


def flops_per_token(t: Mapping, seq: int, patches: int) -> float:
    """Operations of one denoiser call over one token (2 per multiply-add):
    every product of every layer, the attention scores and values at
    ``seq`` tokens, the router, and the patch embedding and head on the
    ``patches`` of the ``seq``; the time and condition MLPs, once a
    sequence, are left out (under 0.1%)."""
    h, nh, nope, rope, v, rank = _dims(t)
    dense, routed = layers(t)
    attn = 2.0 * (h * nh * (nope + rope) + h * (rank + rope) + rank * nh * (nope + v)
                  + nh * v * h) + 2.0 * seq * nh * (nope + rope + v)
    ffn_dense = 2.0 * 3 * h * int(t["intermediate_size"])
    inter = int(t["moe_intermediate_size"])
    ffn_moe = 2.0 * 3 * h * inter * (int(t["num_experts_per_tok"]) + int(t["n_shared_experts"]))
    ffn_moe += 2.0 * h * int(t["n_routed_experts"])
    patch = int(t["patch_size"])
    io = 2.0 * 2 * patch * h * patches / seq
    return int(t["num_hidden_layers"]) * attn + dense * ffn_dense + routed * ffn_moe + io
