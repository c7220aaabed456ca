"""Activation placement hooks the models call, the JAX package's
``sharding/activations.py`` with no mesh.

The reference pins the residual stream, the attention heads, the wide FFN
intermediate and the logits to mesh axes so that XLA's partitioner
all-gathers weights instead of activations; off a mesh every one of its
helpers returns its input unchanged
(``repro/sharding/activations.py::_current_mesh``). The port runs on one
card, so each hook here is that identity and ``model_size()`` is 1 (the
attention takes its grouped-query path). The model code calls the hooks at
the reference's places, so a multi-card runtime can fill their bodies in
without touching the models.
"""
from __future__ import annotations


def residual(x):
    """(B, S, D) residual stream."""
    return x


def heads(x):
    """(B, S, H, dh) attention heads."""
    return x


def ffn_hidden(x):
    """(B, S, F) wide FFN intermediate."""
    return x


def logits(x):
    """(B, S, V) logits."""
    return x


def model_size() -> int:
    """Size of the tensor-parallel axis: 1 on one card."""
    return 1


def expert_buf(x):
    """(E, C, D) expert buffer."""
    return x


def expert_weights(w, transposed: bool = False):
    """(E, D, F) expert weights, or (E, F, D) ``transposed``."""
    return w


def expert_hidden(x):
    """(E, C, F) expert intermediate."""
    return x


def ssm_state(x):
    """(B, di, ds) selective-scan state."""
    return x
