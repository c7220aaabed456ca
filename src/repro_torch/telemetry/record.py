"""Device-resident round telemetry: the records a federation keeps of
itself.

Two NamedTuples of 0-d device tensors, like ``privacy.accountant``'s:

* :class:`RoundTelemetry` — one round's record: pilot, participation,
  fault and degradation counts, the numerator and denominator of the cost
  average the master acted on, and the public wire tags (modulus, fanout,
  levels). ``WirePath.round_step`` returns it in ``info["telemetry"]``;
  the drivers stack the rounds' records and fetch them once after the
  run.
* :class:`TelemetryCarry` — running totals in ``RoundState.telemetry``,
  checkpointed with the history buffers, so a resumed federation's
  counters go on where the interrupted run stopped.

Counts, not bytes: float32 holds integers exactly only up to 2**24, and
wire totals of a real model pass that. The device keeps exact int32
counts; ``telemetry.trace`` derives the bytes on the host through
``core.protocol`` and checks them against the simulator's own ledger
math.

Everything here is plain tensor math over (N,) operands the round has
already computed: no kernel of the wire, no host sync. In eager PyTorch
each op is a launch, so the integer counts come from one stacked (6, N)
matrix summed once, the record's integer fields are views of one int32
vector, and the carry folds in with one add for its counts. The float
sums fold the workers strictly in order k = 0..N−1, as XLA:CPU sums a
vector of up to 32 elements, so on the CPU the record equals the JAX
package's bit for bit.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

# The fault codes of ``repro_torch.fed.faults``, repeated here as the JAX
# package does (importing ``fed`` would cycle through ``fed.rounds``);
# tests/test_torch_telemetry.py pins them equal.
FAULT_NONE = 0
DROP_BEFORE = 1


class RoundTelemetry(NamedTuple):
    """One round's record: 0-d int32 tensors but ``cost_sum`` and
    ``weight_sum`` (float32).

    ``cost_sum``/``weight_sum`` are the numerator and denominator of the
    size-weighted cost average over the workers whose report the master
    used (sampled, surviving, in a viable sibling group); the host divides
    and applies the all-reports-lost carry rule.
    """
    round: torch.Tensor          # absolute 1-based round index
    pilot: torch.Tensor          # k* of this round
    n_sampled: torch.Tensor      # participation-mask popcount
    n_used: torch.Tensor         # reports the master used
    n_dead: torch.Tensor         # sampled workers that faulted this round
    n_pre_uplink: torch.Tensor   # dead before the uplink (no bytes spent)
    n_recovered: torch.Tensor    # dead in viable groups (seeds recovered)
    n_degraded: torch.Tensor     # live survivors left out by viability
    cost_sum: torch.Tensor       # sum(size_k * cost_k) over used workers
    weight_sum: torch.Tensor     # sum(size_k) over used workers
    modulus_bits: torch.Tensor   # wire modulus tag (0 = plain wire)
    fanout: torch.Tensor         # tree fanout tag (0 = flat aggregation)
    levels: torch.Tensor         # resolved tree depth tag (0 = flat)


class TelemetryCarry(NamedTuple):
    """Running totals in ``RoundState.telemetry``: 0-d int32 tensors but
    ``cost_sum`` (float32)."""
    rounds: torch.Tensor
    sampled: torch.Tensor
    used: torch.Tensor
    dead: torch.Tensor
    pre_uplink: torch.Tensor
    recovered: torch.Tensor
    degraded: torch.Tensor
    cost_sum: torch.Tensor

    @classmethod
    def zero(cls, device=None) -> "TelemetryCarry":
        counts = torch.zeros((7,), dtype=torch.int32, device=device)
        return cls(*counts.unbind(),
                   cost_sum=torch.zeros((), dtype=torch.float32,
                                        device=device))

    def add(self, rec: RoundTelemetry) -> "TelemetryCarry":
        """Fold one round's record into the totals: two stacks and one add
        for the seven counts, one add for the cost."""
        step = torch.stack([_one(rec.n_sampled.device), rec.n_sampled,
                            rec.n_used, rec.n_dead, rec.n_pre_uplink,
                            rec.n_recovered, rec.n_degraded])
        counts = torch.stack(list(self[:7])) + step
        return TelemetryCarry(*counts.unbind(),
                              cost_sum=self.cost_sum + rec.cost_sum)


@functools.lru_cache(maxsize=16)
def _one(device: torch.device) -> torch.Tensor:
    """A 0-d int32 one on ``device``, made once (never handed out)."""
    return torch.ones((), dtype=torch.int32, device=device)


@functools.lru_cache(maxsize=16)
def _fill(value: float, n: int, device: torch.device) -> torch.Tensor:
    """An (n,) float32 constant on ``device``, made once (read only)."""
    return torch.full((n,), value, dtype=torch.float32, device=device)


@functools.lru_cache(maxsize=64)
def _tags(modulus_bits: int, fanout: int, levels: int,
          device: torch.device) -> torch.Tensor:
    """The (3,) int32 wire tags on ``device``, made once (read only)."""
    return torch.stack([torch.full((), v, dtype=torch.int32, device=device)
                        for v in (modulus_bits, fanout, levels)])


def _flag(x: torch.Tensor) -> torch.Tensor:
    """``x > 0`` as float32 0/1."""
    return (x > 0).to(torch.float32)


def build_round_record(*, t, k_star, n: int, costs, sizes, mask=None,
                       codes=None, sel_mask=None, dead_eff=None,
                       modulus_bits: int = 0, fanout: int = 0,
                       levels: int = 0) -> RoundTelemetry:
    """One round's :class:`RoundTelemetry` from operands the round has
    computed anyway, on their device.

    ``t`` the 0-d int32 device round; ``k_star`` the device pilot;
    ``costs``/``sizes`` (N,); ``mask`` the (N,) participation row (None =
    all sampled); ``codes`` the round's int32 fault codes (None = no fault
    plan); ``sel_mask`` the selection mask after faults and viability that
    pilot selection and the cost carry used (None = every sampled live
    worker); ``dead_eff`` the masked wire's recoverable-dead mask from
    ``recovery.effective_masks`` (None off that path).
    """
    costs = costs.to(torch.float32)
    sizes = sizes.to(torch.float32)
    dev = costs.device
    zeros = _fill(0.0, n, dev)
    pm = _fill(1.0, n, dev) if mask is None else _flag(mask)
    if codes is None:
        live, dead, pre = pm, zeros, zeros
    else:
        ok = (codes == FAULT_NONE).to(torch.float32)
        live = pm * ok
        dead = pm * (1.0 - ok)
        pre = pm * (codes == DROP_BEFORE).to(torch.float32)
    used = live if sel_mask is None else _flag(sel_mask)
    recovered = zeros if dead_eff is None else _flag(dead_eff)
    # live - used holds -1/0/1, so its int32 sum is count(live) - n_used.
    degraded = zeros if used is live else live - used
    counts = torch.stack([pm, used, dead, pre, recovered, degraded]).sum(
        1, dtype=torch.int32)
    ints = torch.cat([t.reshape(1).to(torch.int32),
                      k_star.reshape(1).to(torch.int32), counts,
                      _tags(modulus_bits, fanout, levels, dev)]).unbind()
    cols = (torch.stack([costs * sizes, sizes]) * used).unbind(1)
    acc = cols[0]
    for col in cols[1:]:         # in worker order, as XLA:CPU sums
        acc = acc + col
    return RoundTelemetry(*ints[:8], cost_sum=acc[0], weight_sum=acc[1],
                          modulus_bits=ints[8], fanout=ints[9],
                          levels=ints[10])


def stack(records: list[RoundTelemetry]) -> RoundTelemetry:
    """Rounds' records as one record of (R,) tensors, field by field."""
    return RoundTelemetry(*[torch.stack(f) for f in zip(*records)])
