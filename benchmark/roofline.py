"""The chip's peaks and each kernel's operations and bytes from its shapes.

Bytes count each input byte read once and each output byte written once,
the least traffic the kernel can make; a kernel's bound is the larger
of its operations over the peak rate of its precision and its bytes over
the HBM bandwidth. Peaks: one NVIDIA H100 SXM, dense, at its 700 W limit
(NVIDIA's data sheet).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

PEAK_FLOPS = {"bf16": 989e12, "fp16": 989e12, "fp8": 1979e12, "int8": 1979e12,
              "tf32": 495e12, "f32": 67e12}
HBM_BYTES_PER_S = 3.35e12

BF16, F32 = 2, 4


def bound_s(flops: float, nbytes: float, precision: str = "bf16") -> float:
    return max(flops / PEAK_FLOPS[precision], nbytes / HBM_BYTES_PER_S)


def k1(m: int, k: int, n: int) -> Tuple[float, float]:
    """K1 on the input product: bf16 A (m, k) · B (k, n) + a bias row
    (f32, n) + a per-row add (f32, m x n) -> bf16 (m, n)."""
    return 2.0 * m * k * n, BF16 * (m * k + k * n + m * n) + F32 * (n + m * n)


def k1_gn(m: int, k: int, n: int) -> Tuple[float, float]:
    """K1 with the GroupNorm+SiLU epilogue: bf16 A (m, k) · B (k, n), f32
    bias, GN scale and GN bias (n each) -> bf16 (m, n)."""
    return 2.0 * m * k * n, BF16 * (m * k + k * n + m * n) + F32 * 3 * n


def k1_posterior(m: int, k: int, n: int, mode: str) -> Tuple[float, float]:
    """K1 with the reverse-step epilogue: bf16 A (m, k) · B (k, n), the f32
    output bias (n), one f32 table row (6), the bf16 carry (m, n) read and
    written, and in "buffer" mode the f32 noise (m, n) read. "philox" and
    "none" read no noise."""
    nbytes = BF16 * (m * k + k * n + 2 * m * n) + F32 * (n + 6)
    if mode == "buffer":
        nbytes += F32 * m * n
    elif mode not in ("philox", "none"):
        raise ValueError(f"unknown noise mode {mode!r}")
    return 2.0 * m * k * n, nbytes


def block_products(hidden: Sequence[int]) -> List[Tuple[int, int]]:
    """(K, N) of the ten GN products of one denoiser step: each block's fc1
    and fc2, encoders over hidden[1:], the bottleneck, decoders on
    [h | skip]."""
    hidden = list(hidden)
    shapes, feats, width = [], [], hidden[0]
    for f in hidden[1:]:
        shapes += [(width, f), (f, f)]
        feats.append(f)
        width = f
    shapes += [(width, hidden[-1]), (hidden[-1], hidden[-1])]
    width = hidden[-1]
    for i in range(len(hidden) - 2, -1, -1):
        if not feats:
            break
        skip = feats.pop()
        shapes += [(width + skip, hidden[i]), (hidden[i], hidden[i])]
        width = hidden[i]
    return shapes


def step_products(hidden: Sequence[int], data_dim: int) -> Dict[str, List[Tuple[int, int]]]:
    """The (K, N) shapes of a reverse step's products by kernel."""
    return {"k1": [(data_dim, hidden[0])], "k1_gn": block_products(hidden),
            "k1_posterior": [(block_products(hidden)[-1][1], data_dim)]}


def macs_per_row(hidden: Sequence[int], data_dim: int) -> int:
    """Multiply-accumulates of one denoiser forward pass on one row."""
    return sum(k * n for shapes in step_products(hidden, data_dim).values() for k, n in shapes)


def step_bounds(rows: int, hidden: Sequence[int], data_dim: int, mode: str) -> Dict[str, float]:
    """Each kernel's summed bound (s) over one reverse step at ``rows``."""
    prods = step_products(hidden, data_dim)
    return {
        "k1": sum(bound_s(*k1(rows, k, n)) for k, n in prods["k1"]),
        "k1_gn": sum(bound_s(*k1_gn(rows, k, n)) for k, n in prods["k1_gn"]),
        "k1_posterior": sum(bound_s(*k1_posterior(rows, k, n, mode))
                            for k, n in prods["k1_posterior"]),
    }
