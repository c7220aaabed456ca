"""Privacy probes on PyTorch: what can each party see on the secure wire?
The twin of privacy_probes.py, through the port (``repro_torch``).

  1. the master's view of a non-pilot uplink is uniform-looking masked
     words — correlating the masked stream with the true codes, or summing
     any strict subset of workers, recovers nothing, while the FULL cohort
     sum recovers exactly the aggregate Eq. (3) needs (16- and 32-bit);
  2. the local-DP randomized response flips codes at the rate the
     configured epsilon implies, and the master's unbias keeps the
     expected update on target;
  3. the PrivacyAccountant composes per-round epsilon across a federation
     (basic and advanced composition read-outs);
  4. the §4.2 enforcement hook: the simulator audits its round program at
     set-up (one run on ``meta`` tensors, before round 1) and the ledger
     records the passed audit;
  5. tree aggregation: the partial sums crossing every tree edge below the
     root are still masked, and the level-scoped masks cancel exactly once,
     at the root;
  6. dropout recovery: a dead worker's mask seeds reconstruct exactly from
     t Shamir share-holders, while the server colluding with t-1 holders
     recovers nothing of a LIVE worker's mask words, and the audit layer
     refuses a live-target reconstruction outright;
  7. the telemetry boundary: the audit scans the round's exported info and
     trace records; the real telemetry (counts and public scalars) passes,
     and a round program smuggling a per-worker float buffer into its
     record is refused.

The wire runs through the port's CUDA kernels on the card; ``--cpu`` runs
their plain PyTorch versions instead.

Run:  PYTHONPATH=src python examples/privacy_probes_torch.py [--cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.core.fedpc import FedPCConfig
from repro_torch.core.privacy import LeakageError
from repro_torch.core.tree import TreeSpec
from repro_torch.data.pipeline import federated_loaders
from repro_torch.data.synthetic import (SyntheticClassification,
                                        random_share_split)
from repro_torch.fed import rounds as rd
from repro_torch.fed.simulator import FedSimulator
from repro_torch.fed.worker import Worker, make_worker_configs
from repro_torch.kernels import ops, seam
from repro_torch.models.mlp import init_mlp_classifier, mlp_loss_and_grad
from repro_torch.privacy import (PrivacySpec, check_round_program,
                                 pair_signs, pair_stream_keys,
                                 quantize_weights, rr_fields,
                                 rr_stream_keys)
from repro_torch.privacy.masking import as_u64, index_hash, stream_values
from repro_torch.privacy.recovery import (deal_worker_shares, reconstruct,
                                          recover_worker_keys)


def _normal(gen, shape, dev):
    return torch.randn(shape, generator=gen).to(dev)


def _word_sum(words):
    """The modular sum of word rows, as int64 values."""
    bits = 16 if words.dtype == torch.uint16 else 32
    return as_u64(words).sum(0) % (1 << bits)


def probe_mask_removal(word_bits: int, dev):
    """Probe 1: the masked uplink leaks nothing short of the full sum, at
    either wire modulus."""
    n, rows = 4, 96
    gen = torch.Generator().manual_seed(0)
    bufs = _normal(gen, (n, rows, 128), dev)
    p1, p2 = _normal(gen, (rows, 128), dev), _normal(gen, (rows, 128), dev)
    w = torch.full((n,), 1.0 / n, device=dev)
    w[0] = 0.0
    wq = quantize_weights(w, 14 if word_bits == 16 else 24)
    keys = pair_stream_keys(0, n, 5, device=dev)
    signs = pair_signs(n, device=dev)
    rrk = rr_stream_keys(1, 5, n, device=dev)

    def uplink(use_masks):
        return ops.flat_ternary_pack_masked(
            bufs, p1, p2, t=5, beta=0.2, alpha1=0.01, wq=wq,
            pair_keys=keys, pair_signs=signs, rr_keys=rrk, rr_threshold=0,
            word_bits=word_bits, use_masks=use_masks)

    masked, clear = uplink(True), uplink(False)
    print(f"probe 1 — pairwise-masked secure aggregation "
          f"(modulus 2**{word_bits}, in-kernel mask streams)")
    print(f"  wire words of worker 1 (masked):   "
          f"{masked[1].reshape(-1)[:4].cpu().tolist()}")
    print(f"  same words without the mask:       "
          f"{clear[1].reshape(-1)[:4].cpu().tolist()}")
    corr = np.corrcoef(as_u64(masked[1]).cpu().numpy().reshape(-1),
                       as_u64(clear[1]).cpu().numpy().reshape(-1))[0, 1]
    print(f"  corr(masked stream, true codes) = {corr:+.4f}  (~0: the "
          f"master learns nothing per-worker)")
    full_ok = bool(torch.equal(_word_sum(masked), _word_sum(clear)))
    sub = _word_sum(masked[:-1]) == _word_sum(clear[:-1])
    recovered = float(sub.float().mean())
    # a 16-bit residue can collide on ~2**-16 of words by chance; anything
    # below 1% is indistinguishable from guessing
    verdict = "fails" if recovered < 0.01 else "SUCCEEDS"
    print(f"  modulus {word_bits}: full-cohort sum == unmasked sum: "
          f"{full_ok}")
    print(f"  modulus {word_bits}: drop-one subset sum recovers "
          f"{recovered:.3%} of words -> the attack {verdict}\n")


def probe_randomized_response(dev):
    """Probe 2: RR flip rate matches epsilon; the unbias keeps E[update]."""
    spec = PrivacySpec(dp_epsilon=2.0)
    p = spec.flip_prob
    fields = torch.ones((1 << 18,), dtype=torch.int64, device=dev)
    gen = torch.Generator().manual_seed(3)
    bits = torch.randint(0, 1 << 32, fields.shape, generator=gen).to(dev)
    out = rr_fields(fields, bits, spec.rr_threshold)
    flipped = float((as_u64(out) != fields).float().mean())
    print("probe 2 — local-DP ternary randomized response")
    print(f"  eps = {spec.dp_epsilon}  ->  flip prob p = {p:.4f} "
          f"(realized eps/round = {spec.eps_round:.4f})")
    print(f"  measured flip rate = {flipped:.4f}  "
          f"(expected p*2/3 = {p * 2 / 3:.4f})")
    print(f"  master unbias multiplier 1/(1-p) folded into the de-bias: "
          f"{1.0 / (1.0 - p):.4f}\n")


def probe_accountant_and_enforcement(dev):
    """Probes 3+4: a DP federation — the accountant and the set-up audit."""
    x, y = SyntheticClassification(n_samples=600, n_features=12,
                                   n_classes=3, seed=0).generate()
    splits = random_share_split(y, 4, seed=1)
    loaders = federated_loaders((x, y), splits, seed=2)
    cfgs = make_worker_configs(4, [len(s) for s in splits], seed=3,
                               batch_menu=(25,))
    workers = [Worker(cfg=cfgs[k], loader=loaders[k],
                      loss_and_grad=mlp_loss_and_grad) for k in range(4)]
    params = init_mlp_classifier(torch.Generator().manual_seed(0), 12, 3,
                                 hidden=(16,), device=dev)
    spec = PrivacySpec(dp_epsilon=2.0)
    sim = FedSimulator(workers, params,
                       FedPCConfig(n_workers=4, privacy=spec), device=dev)
    res = sim.run_fedpc(rounds=8)
    acc = res.round_state.accountant
    print("probe 3 — privacy accountant across a federation")
    print(f"  rounds composed: {int(acc.spent_rounds)}")
    print(f"  eps (basic composition):           "
          f"{float(acc.epsilon()):.3f}")
    print(f"  eps (advanced, delta={spec.delta:g}): "
          f"{float(acc.epsilon(spec.delta)):.3f}")
    print(f"  best of both: {float(acc.best_epsilon(spec.delta)):.3f}\n")

    print("probe 4 — §4.2 enforcement hook")
    for audit in sim.ledger.audits:
        print(f"  audit passed: runtime={audit['runtime']} "
              f"boundary={audit['boundary']} masked={audit['masked']} "
              f"launches={audit['n_launches']}")
    kinds = {k for (_, _, k, _) in sim.ledger.events}
    print(f"  uplink fields recorded on the masked wire: {sorted(kinds)}")
    print("  -> no weight value, no gradient value, no per-worker ternary "
          "direction reaches the master.\n")


def probe_subtree_masks(dev, word_bits: int = 16):
    """Probe 5: tree aggregation keeps every edge below the root masked;
    the level masks cancel exactly once, in the root's sum."""
    n, rows, fanout, t = 8, 32, 2, 5
    gen = torch.Generator().manual_seed(7)
    bufs = _normal(gen, (n, rows, 128), dev)
    p1, p2 = _normal(gen, (rows, 128), dev), _normal(gen, (rows, 128), dev)
    w = torch.full((n,), 1.0 / n, device=dev)
    ts = TreeSpec(fanout=fanout)
    wire = rd.WirePath(privacy=PrivacySpec(modulus_bits=word_bits), tree=ts)
    clear_wire = rd.WirePath(privacy=PrivacySpec(
        modulus_bits=word_bits, mask_seed=None, enforce=False), tree=ts)
    y, _ = wire.uplink_masked(bufs, p1, p2, t=t, w=w)
    y_clear, _ = clear_wire.uplink_masked(bufs, p1, p2, t=t, w=w)
    top = wire._tree_fold_masked(y, t=t)
    top_clear = clear_wire._tree_fold_masked(y_clear, t=t)
    print(f"probe 5 — tree aggregation (fanout {fanout}, "
          f"{ts.n_levels(n)} levels, modulus 2**{word_bits})")
    # tap one tree edge below the root: a whole subtree's sum, yet it still
    # carries that node's own net mask
    match = float((as_u64(top[0]) == as_u64(top_clear[0])).float().mean())
    verdict = "fails" if match < 0.01 else "SUCCEEDS"
    print(f"  tapping a below-root edge recovers {match:.3%} of the "
          f"subtree's words -> the tree-edge attack {verdict}")
    print(f"  tree level masks: subtree sums cancel at the root: "
          f"{bool(torch.equal(_word_sum(top), _word_sum(top_clear)))}\n")


def _stream_words(keys, h):
    return np.stack([stream_values(torch.tensor(int(k), dtype=torch.int64),
                                   h, 16).numpy() for k in keys])


def probe_dropout_recovery():
    """Probe 6: the dropout-recovery control plane — t-of-n seed shares
    (host work: the shares never touch the card)."""
    n, thr, victim, t = 8, 3, 2, 5
    members, xs, shares = deal_worker_shares(5, victim, n, t, thr)
    true_keys = as_u64(pair_stream_keys(5, n, t, device="cpu")).numpy()[
        victim][members]
    h = index_hash(512, 16, device="cpu")
    true_words = _stream_words(true_keys, h)
    print(f"probe 6 — dropout recovery: {thr}-of-{len(members)} seed "
          f"shares (GF(2^16) Shamir)")
    holders = [j for j in range(len(members))
               if int(members[j]) != victim][:thr - 1]
    part = reconstruct(shares[holders], xs[holders])   # t-1 points only
    guess = (part[..., 0].astype(np.uint32)
             | (part[..., 1].astype(np.uint32) << 16))
    hit = float(np.mean(_stream_words(guess, h) == true_words))
    verdict = "fails" if hit < 0.01 else "SUCCEEDS"
    print(f"  server + {thr - 1} colluding share-holders vs a LIVE "
          f"worker: recover {hit:.3%} of its mask words -> the collusion "
          f"attack {verdict}")
    try:
        recover_worker_keys(5, victim, n, t, thr, alive=np.ones(n))
        refused = False
    except LeakageError:
        refused = True
    print(f"  control plane refuses a live-target reconstruction "
          f"(LeakageError): {refused}")
    alive = np.ones(n)
    alive[victim] = 0.0
    _, rec_keys = recover_worker_keys(5, victim, n, t, thr, alive=alive)
    exact = bool(np.array_equal(_stream_words(rec_keys, h), true_words))
    print(f"  declared-dead worker, {thr} surviving share-holders: "
          f"recovered mask stream exact: {exact}\n")


def probe_telemetry_trace(dev):
    """Probe 7: the telemetry rides the round's info off the device; the
    audit scans it, and a per-worker float payload there is refused."""
    n = 4
    gen = torch.Generator().manual_seed(11)
    tree = {"w": _normal(gen, (41, 23), dev), "b": _normal(gen, (23,), dev)}
    spec = PrivacySpec()
    state = rd.init_round_state(tree, n, privacy=spec, device=dev)
    wire = rd.WirePath(privacy=spec)
    sizes = torch.linspace(20.0, 80.0, n, device=dev)
    bufs = torch.empty((n, *state.buf_p1.shape), device="meta")
    costs = torch.empty((n,), device="meta")

    report = check_round_program(wire.round_step, state, bufs, costs, sizes,
                                 n_workers=n, masked=True)
    rec = seam.record(wire.round_step, state, bufs, costs, sizes)[1][2][
        "telemetry"]
    print("probe 7 — telemetry boundary: the trace leaks nothing")
    print(f"  telemetry-carrying round program passes the masked audit "
          f"({report['n_launches']} launches, counts + public scalars "
          f"only): True")
    print(f"  per-round record fields exported off-device: "
          f"{sorted(rec._fields)}")

    def leaky(s, b, c, z):
        new_s, new_buf, info = wire.round_step(s, b, c, z)
        # an (N, rows*128) float export — a per-worker parameter payload
        return new_s, new_buf, {**info, "trace_payload": b.reshape(n, -1)}

    try:
        check_round_program(leaky, state, bufs, costs, sizes, n_workers=n,
                            masked=True)
        refused = False
    except LeakageError:
        refused = True
    print(f"  a per-worker float payload smuggled into the trace record "
          f"is refused (LeakageError): {refused}\n")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain PyTorch versions on the CPU "
                         "(default: the CUDA kernels on the card)")
    args = ap.parse_args()
    if not args.cpu and not torch.cuda.is_available():
        ap.error("CUDA is not available; pass --cpu to run on the CPU")
    dev = torch.device("cpu" if args.cpu else "cuda")
    probe_mask_removal(16, dev)
    probe_mask_removal(32, dev)
    probe_subtree_masks(dev)
    probe_randomized_response(dev)
    probe_accountant_and_enforcement(dev)
    probe_dropout_recovery()
    probe_telemetry_trace(dev)


if __name__ == "__main__":
    main()
