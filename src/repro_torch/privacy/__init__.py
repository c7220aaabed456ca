"""repro_torch.privacy — the privacy-preserving wire.

Pairwise-masked secure aggregation (the master sees only the modular sum
of the workers' fixed-point-weighted ternary fields, mod 2**16 by default
or 2**32), local-DP 3-ary randomized response on the codes with exact
unbiasing, and an (eps, delta) accountant carried in the round state. The
mask and RR streams are counter-based (``masking.mix32`` chains): the CUDA
uplink regenerates them in registers from tiny key matrices, and the
expansions here are the reference.

Dropout recovery (``recovery``: Shamir shares of the pair seeds, the
repair's device operands), the tree forms of the masks
(``masking.tree_level_seed``, ``tree_pair_signs``, ``tree_activity``) and
the §4.2 audits (``audit.check_round_program``, which
``PrivacySpec(enforce=True)`` runs in both FedPC drivers, and
``audit.check_fed_collectives``, which it runs in the distributed
runtime's ``build_fed_sync``) and the per-worker ``_row`` and slab forms
of the mask and RR functions that a mesh rank draws its own streams with
are here too.
"""
from repro_torch.privacy.accountant import PrivacyAccountant
from repro_torch.privacy.audit import (check_fed_collectives,
                                       check_recovery_target,
                                       check_round_program,
                                       collective_payloads)
from repro_torch.privacy.dp import (rr_bits, rr_fields, rr_stream_key,
                                    rr_stream_keys)
from repro_torch.privacy.masking import (mix32, net_masks, pair_incidence,
                                         pair_signs, pair_stream_keys,
                                         quantize_weights, stream_key)
from repro_torch.privacy.spec import PrivacySpec

__all__ = [
    "PrivacyAccountant", "PrivacySpec", "check_fed_collectives",
    "check_recovery_target", "check_round_program", "collective_payloads",
    "mix32", "net_masks",
    "pair_incidence", "pair_signs", "pair_stream_keys", "quantize_weights",
    "rr_bits", "rr_fields", "rr_stream_key", "rr_stream_keys", "stream_key",
]
