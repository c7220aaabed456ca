"""Hierarchical aggregation topology — the fan-in tree of sub-aggregators.

Leaves are workers; each internal node folds at most ``fanout`` children
into one partial accumulator (``kernels.partial_sum``), and the root runs
the masked master over the last level's partials. Modular accumulation
is order-free, so the tree gives the flat integer round's bits; de-bias
and descale by the public ΣW_k happen once, at the root.

The tree is an index calculation: level 0 is the N leaves, level ``l``
has ``ceil(w_{l-1} / fanout)`` nodes, and node ``k`` of a level is the
parent of children ``k·fanout .. (k+1)·fanout − 1`` of the level below
(contiguous sibling groups, the grouping the mask scoping and the
partial-sum kernels share). ``levels=None`` derives the depth: the
smallest L >= 1 whose width fits the root's own fan-in (``w_L <=
fanout``).

A copy of the JAX package's ``repro.core.tree``.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.utils import cdiv


@dataclass(frozen=True)
class TreeSpec:
    """A fan-in aggregation tree: ``fanout`` children per internal node,
    ``levels`` partial-sum levels between the leaves and the root (None =
    derived from the cohort size)."""
    fanout: int
    levels: int | None = None

    def __post_init__(self):
        if self.fanout < 2:
            raise ValueError(f"tree fanout must be >= 2, got {self.fanout}")
        if self.levels is not None and self.levels < 1:
            raise ValueError(
                f"tree levels must be >= 1 when set, got {self.levels}")

    def n_levels(self, n: int) -> int:
        """Partial-sum levels for an N-leaf cohort: ``levels`` when pinned,
        else the smallest L >= 1 with ``w_L <= fanout``."""
        if self.levels is not None:
            return self.levels
        level, width = 1, cdiv(n, self.fanout)
        while width > self.fanout:
            level, width = level + 1, cdiv(width, self.fanout)
        return level

    def level_widths(self, n: int) -> list[int]:
        """``[w_0 .. w_L]``: node counts per level, leaves first. The root
        consumes the ``w_L`` last-level partials."""
        widths = [n]
        for _ in range(self.n_levels(n)):
            widths.append(cdiv(widths[-1], self.fanout))
        return widths

    def sibling_size(self, level: int, n: int) -> int:
        """Mask-scoping group size of the nodes at ``level``: blocks of
        ``fanout`` (the masks cancel inside the parent's partial sum) below
        the last level, and one group of all ``w_L`` last-level nodes
        (their masks cancel at the root)."""
        widths = self.level_widths(n)
        last = len(widths) - 1
        return self.fanout if level < last else max(widths[last], 1)

    def launches(self, n: int) -> int:
        """Kernel launches of one tree round: 1 uplink + L partial sums +
        1 root master."""
        return self.n_levels(n) + 2
