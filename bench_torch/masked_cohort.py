#!/usr/bin/env python3
"""Time the masked uplink's whole-cohort kernels (#6 of ``PERF.md``) on
one CUDA card, beside the row fold and the bound that expands each pair
once.

    python3 bench_torch/masked_cohort.py [--workers 10,17,32,64]
        [--bits 16,32] [--rr off,on] [--repeats 25] [--check] [--json PATH]

At R = 41,016 rows of 512 (the main path's 20,998,154-parameter MLP),
t = 2, every pair active (``pair_signs``, no participation), for each N,
word width and RR setting: the kernel the wrapper picks
(``ternary_pack_masked``: the pair kernel up to 16 workers, the tile
kernel beyond), the tile kernel forced (``_ternary_pack_masked_tiles``,
also below 17 workers) and the row-fold kernel
(``_ternary_pack_masked_rows``), held bitwise to each other first, then
timed with ``chip_smoke``'s queued, L2-scrubbed harness. The bound is
``chip_smoke``'s: the larger of the bytes at the memory rate and
``uplink_masked_int_ops`` with each of the N (N - 1) / 2 pairs expanded
once at ``INT32_OPS_PER_S``. ``--check`` first holds the three kernels
bitwise to the plain twin at R = 8 and a ragged R = 3 at N in {17, 24,
32, 33, 48, 64, 170}, 16/32 bits, RR off/on, masks off/on, t in {1, 2},
with participation-folded and tree-scoped signs. Prints the card's name
and power limit, the tile kernel's registers and spills, one line a
timing and one JSON object (``--json`` also writes it to a file).
"""
from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ROWS = 41_016
CHECK_WORKERS = (17, 24, 32, 33, 48, 64, 170)


def registers() -> None:
    """Print the ptxas report of the masked uplink's tile kernel; raise if
    any kernel of the library spills."""
    import chip_smoke
    from repro_torch.kernels import build
    so = build.build("masked_wire")
    kernel = None
    for line in so.with_name(so.name + ".log").read_text().splitlines():
        if "Compiling entry function" in line:
            kernel = chip_smoke._kernel_label(line.split("'")[1])
        elif kernel and "tiles" in kernel and "registers" in line:
            print(f"build: {kernel}: {line.split(':', 1)[-1].strip()}",
                  flush=True)
        elif kernel and "spill" in line and re.search(r"[1-9]\d* bytes spill",
                                                      line):
            raise RuntimeError(f"{kernel} spills: {line.strip()}")


def operands(torch, n: int, r: int, gen, dev, participation=False,
             sibling=None, t: int = 2, bits: int = 16):
    """The masked uplink's operands as ``WirePath`` builds them."""
    from repro_torch.privacy import dp as pdp
    from repro_torch.privacy import masking as pvm
    p1 = torch.randn((r, 512), generator=gen, device=dev) * 0.05
    p2 = p1 + torch.randn((r, 512), generator=gen, device=dev) * 0.01
    q = p1 + torch.randn((n, r, 512), generator=gen, device=dev) * 0.01
    beta = torch.rand((n,), generator=gen, device=dev) * 0.3
    w = torch.rand((n,), generator=gen, device=dev) / n
    tt = torch.tensor(t, dtype=torch.int32, device=dev)
    part = None
    if participation:
        part = (torch.rand((n,), generator=gen, device=dev) < 0.7).float()
        w = w * part
    keys = pvm.pair_stream_keys(0, n, tt)
    signs = (pvm.pair_signs(n, participation=part, device=dev)
             if sibling is None else
             pvm.tree_pair_signs(n, sibling, participation=part, device=dev))
    wq = pvm.quantize_weights(w, 14 if bits == 16 else 24)
    return (q, p1, p2, tt, beta, 0.01, wq, keys, signs,
            pdp.rr_stream_keys(1, tt, n))


def check(torch, dev) -> int:
    from repro_torch.kernels import masked_wire as mw
    from repro_torch.privacy import masking as pvm
    gen = torch.Generator(device=dev).manual_seed(5)
    cases = 0
    for n in CHECK_WORKERS:
        for r in (8, 3):
            for part, sib in ((False, None), (True, None), (False, 4),
                              (True, 2)):
                for t in (1, 2):
                    for bits in (16, 32):
                        args = operands(torch, n, r, gen, dev, part, sib, t,
                                        bits)
                        for thr in (0, 3277):
                            for masks in (True, False):
                                kw = dict(rr_threshold=thr, word_bits=bits,
                                          use_masks=masks)
                                outs = [mw.ternary_pack_masked(*args, **kw),
                                        mw._ternary_pack_masked_tiles(
                                            *args, **kw),
                                        mw._ternary_pack_masked_rows(
                                            *args, **kw),
                                        mw.ternary_pack_masked_plain(
                                            *args, **kw)]
                                want = pvm.as_u64(outs[-1])
                                for o in outs[:-1]:
                                    if not torch.equal(pvm.as_u64(o), want):
                                        raise RuntimeError(
                                            f"differs at N={n} R={r} "
                                            f"part={part} sibling={sib} "
                                            f"t={t} bits={bits} thr={thr} "
                                            f"masks={masks}")
                                cases += 1
        print(f"check: N = {n} bitwise ({cases} cases so far)", flush=True)
    return cases


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workers", default="10,17,32,64")
    ap.add_argument("--bits", default="16,32")
    ap.add_argument("--rr", default="off,on")
    ap.add_argument("--repeats", type=int, default=25)
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--json", type=Path, default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import masked_wire as mw
    from repro_torch.privacy import masking as pvm
    from repro_torch.privacy.spec import PrivacySpec
    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    _, _, rate = cs.phase_card(torch)
    registers()
    cases = check(torch, dev) if args.check else 0
    m = ROWS * 512
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for n in (int(x) for x in args.workers.split(",")):
        for bits in (int(x) for x in args.bits.split(",")):
            ops = operands(torch, n, ROWS, gen, dev, bits=bits)
            word = bits // 8
            nbytes = (n * m * 4 + 2 * m * 4 + 3 * n * 4 + n * n * 8 + 4
                      + n * m * word)
            for rr in args.rr.split(","):
                thr = (PrivacySpec(dp_epsilon=cs.DP_EPSILON).rr_threshold
                       if rr == "on" else 0)
                kw = dict(rr_threshold=thr, word_bits=bits)
                forms = {"wrapper": lambda: mw.ternary_pack_masked(*ops, **kw),
                         "tiles": lambda: mw._ternary_pack_masked_tiles(
                             *ops, **kw),
                         "rows": lambda: mw._ternary_pack_masked_rows(
                             *ops, **kw)}
                if n > mw.PAIR_MAX_WORKERS:
                    del forms["wrapper"]            # the tile kernel
                outs = {k: pvm.as_u64(f()) for k, f in forms.items()}
                first = next(iter(outs.values()))
                if not all(torch.equal(o, first) for o in outs.values()):
                    raise RuntimeError(f"kernels differ at N={n} bits={bits} "
                                       f"RR {rr}")
                del outs, first
                pairs = n * (n - 1) // 2
                alu, total = cs.uplink_masked_int_ops(n, m, bits, rr == "on",
                                                      True, pairs)
                ops_ms = cs.int_bound_ms(alu, total)
                bytes_ms = nbytes / rate * 1e3
                bound = max(ops_ms, bytes_ms)
                times = {k: cs._median_ms(torch, f, queued=True,
                                          repeats=args.repeats)
                         for k, f in forms.items()}
                row = {"n": n, "bits": bits, "rr": rr, "bound_ms": bound,
                       "bound_by": "bytes" if bytes_ms >= ops_ms
                       else "operations", **{f"{k}_ms": v
                                             for k, v in times.items()}}
                rows.append(row)
                print(f"time: N = {n} {bits}-bit RR {rr}: " + ", ".join(
                    f"{k} {v:.4f} ms ({bound / v:.1%} of bound)"
                    for k, v in times.items())
                    + f"; bound {bound:.4f} ms by {row['bound_by']} "
                    f"(bytes {bytes_ms:.4f}, ops {ops_ms:.4f}: "
                    f"{alu / 1e9:.2f} G ALU-only / {total / 1e9:.2f} G)",
                    flush=True)
            del ops
            torch.cuda.empty_cache()
    out = {"card": cs._smi(), "rows": ROWS, "checked_cases": cases,
           "timings": rows}
    print(json.dumps(out), flush=True)
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
