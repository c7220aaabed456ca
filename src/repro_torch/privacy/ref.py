"""Plain-PyTorch oracles of the masked wire kernels (bitwise ground truth).

The same math as ``repro_torch.kernels.masked_wire`` on the kernels'
``(N, R, 512)`` views, with the mask and RR streams given as tensors
(``masking.net_masks``, ``dp.rr_bits``) where the kernels regenerate them
in registers. The masked wire is integer end to end, so every comparison
is exact. Word tensors may be ``uint16``/``uint32`` (the dtype of
``masks``/``masked`` picks the modulus) or ``int64`` values; integer
arithmetic runs in ``int64`` (see ``masking``).

The master's Eq. (3) combine ``q − coeff·mult`` is rounded once, as the
CUDA kernel's fused multiply-add rounds it and as XLA:CPU contracts it in
the JAX package's kernel and oracle when ``t`` and ``scale_mult`` are
runtime operands (``kernels.ref.fma_f32``). ``coeff = ci·scale_mult`` is
its own product, rounded on its own.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ref import fma_f32
from repro_torch.privacy.dp import rr_fields64
from repro_torch.privacy.masking import as_u64, to_words, word_bits_of


def codes_any_ref(q, p1, p2, t, beta, alpha1) -> torch.Tensor:
    """Eq. (4) at t <= 1, Eq. (5) after: float {-1, 0, +1}, the fused
    kernels' rule (shared ``q − p1``; the sign of the product, so an
    underflowing product gives 0)."""
    q, p1, p2 = q.float(), p1.float(), p2.float()
    delta = q - p1
    step = p1 - p2
    c5 = torch.where(delta.abs() >= beta * step.abs(),
                     torch.sign(delta * step), 0.0)
    c4 = (delta > alpha1).float() - (delta < -alpha1).float()
    return torch.where(torch.as_tensor(t, device=q.device) <= 1, c4, c5)


def masked_codes_ref(q, p1, p2, t, beta, alpha1, wq, masks, bits,
                     threshold: int) -> torch.Tensor:
    """Masked uplink: ternarize → bias → RR → fixed-point weight → add the
    net pairwise mask → truncate to the wire word.

    q (N, R, 512) float; p1/p2 (R, 512); ``beta`` a scalar or (N,); wq (N,)
    fixed-point weights; ``masks`` (N, R, 512) in the wire dtype (uint16 =
    16-bit modulus, uint32 = 32-bit); ``bits`` (N, R, 512) RR words, unused
    (and may be None) when ``threshold`` is 0, given as uint32 words or
    their int64 values. Returns (N, R, 512) words.
    """
    wb = word_bits_of(masks)
    beta_b = torch.as_tensor(beta, dtype=torch.float32,
                             device=q.device).reshape(-1, 1, 1)
    code = codes_any_ref(q, p1[None], p2[None], t, beta_b, alpha1)
    field = (code + 1.0).to(torch.int64)
    if threshold:
        field = rr_fields64(field, as_u64(bits), int(threshold))
    acc = as_u64(wq).reshape(-1, 1, 1) * field + as_u64(masks)
    return to_words(acc, wb)


def masked_master_ref(q_pilot, masked, sum_wq, p1, p2, t, alpha0,
                      scale_mult) -> torch.Tensor:
    """Sum-then-unmask master: modular sum of the masked words (the masks
    cancel), integer de-bias by the public ``sum_wq``, signed
    reinterpretation at the wire width, descale by ``scale_mult``, Eq. (3).

    masked (N, R, 512) uint16/uint32; q_pilot/p1/p2 (R, 512) float.
    Returns (R, 512) float32.
    """
    wb = word_bits_of(masked)
    mod = 1 << wb
    ci = (as_u64(masked).sum(dim=0) - as_u64(sum_wq)) & (mod - 1)
    ci = torch.where(ci >= mod // 2, ci - mod, ci)
    coeff = ci.to(torch.float32) * float(scale_mult)
    step = p1.float() - p2.float()
    mult = torch.where(torch.as_tensor(t, device=step.device) <= 1,
                       torch.full_like(step, alpha0), step)
    return fma_f32(-coeff, mult, q_pilot.float())
