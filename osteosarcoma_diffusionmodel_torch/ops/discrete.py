"""Binary D3PM algebra for the discrete mutation head.

Counterpart of osteosarcoma_diffusionmodel_tpu/ops/discrete.py (:35-100).
The mutation bits diffuse through a uniform 2-state chain that shares
the continuous schedule's alphas-cumprod:

    q(x_t | x_{t-1}) = (1 - beta_t) * delta(x_t, x_{t-1}) + beta_t / 2
    q(x_t | x_0)     = acp_t * delta(x_t, x_0) + (1 - acp_t) / 2

Every quantity is elementwise on (batch, n_mutations) tensors.
:func:`posterior_prob_one` is the plain version of the D3PM branch of
kernel K3 (``csrc/posterior_step.cu``), which evaluates the same
operations in the same order.
"""

from __future__ import annotations

from typing import Optional

import torch


def keep_prob(alphas_cumprod: torch.Tensor) -> torch.Tensor:
    """P(x_t == x_0) under the uniform binary chain: (1 + acp_t) / 2."""
    return 0.5 * (1.0 + alphas_cumprod)


def q_sample_bits(bits: torch.Tensor, alphas_cumprod_t: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  uniforms: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x_t ~ q(x_t | x_0) by flipping bits. ``bits`` (B, M) in {0, 1};
    ``alphas_cumprod_t`` (B,) at each sample's timestep; the flip
    uniforms are ``uniforms`` (B, M) or come from ``generator`` (on the
    bits' device)."""
    flip = 0.5 * (1.0 - alphas_cumprod_t)[:, None]
    if uniforms is None:
        uniforms = torch.rand(bits.shape, generator=generator, device=bits.device)
    return torch.abs(bits - (uniforms.to(bits.device) < flip).to(bits.dtype))


def posterior_prob_one(x_t: torch.Tensor, p1: torch.Tensor, beta_t, acp_prev) -> torch.Tensor:
    """p(x_{t-1} = 1 | x_t): the exact posterior q(x_{t-1} | x_t, x_0 = i)
    marginalized over the model's ``p1 = p(x_0 = 1 | x_t)``, with the
    one-step kernel f(j, k) = (1 - beta_t) delta_jk + beta_t / 2 and the
    cumulative prior g(k, i) = acp_prev delta_ki + (1 - acp_prev) / 2.
    ``beta_t``/``acp_prev`` are scalars or broadcast against ``x_t``.
    With acp_prev = 1 (the last reverse step) it returns ``p1``."""
    half_beta = 0.5 * beta_t
    f1 = (1.0 - beta_t) * x_t + half_beta  # f(x_t, k=1)
    f0 = (1.0 - beta_t) * (1.0 - x_t) + half_beta  # f(x_t, k=0)
    half_om = 0.5 * (1.0 - acp_prev)
    g_same = acp_prev + half_om  # g(1, 1) = g(0, 0); g(1, 0) = g(0, 1) = half_om
    a1_i1 = f1 * g_same
    a0_i1 = f0 * half_om
    a1_i0 = f1 * half_om
    a0_i0 = f0 * g_same
    post1_i1 = a1_i1 / (a1_i1 + a0_i1)
    post1_i0 = a1_i0 / (a1_i0 + a0_i0)
    return p1 * post1_i1 + (1.0 - p1) * post1_i0


def bernoulli_cross_entropy(logits: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """Elementwise stable BCE between x0 logits and true bits (B, M). At a
    logit of exactly 0 (an AR head's gene with no set predecessor and a
    zero context) its gradient is -bit, as the JAX formula's is: relu and
    abs both take a zero derivative there."""
    return torch.relu(logits) - logits * bits + torch.log1p(torch.exp(-logits.abs()))
