#!/usr/bin/env python3
"""Time the dropout repair kernel (#8) of the PyTorch/CUDA port at the
main path's row, beside the forms it was chosen over and the floors of
the timing harness, on one CUDA card.

    python3 bench_torch/mask_repair.py [--json PATH]

The row is the one ``chip_smoke.py`` times: R = 41,016 rows of 512 words
(the 20,998,154-parameter MLP), the 13 sibling pairs of the masked tree
(fanout 4, N = 10) under ``chip_smoke.FAULTS`` at round 1, 3 of them
live; at 16 and at 32 bits. Forms, each held bitwise to the plain twin
first:

- ``shipped``: ``masked_wire.mask_repair`` (``csrc/masked_wire.cu``),
  out of place, in place (``out=y``) and write-only (``y`` None);
- ``pr15``: the kernel it replaced, and ``bulk``: the shipped arithmetic
  fed by ``cp.async.bulk`` into a ring of shared memory, both from
  ``bench_torch/csrc/mask_repair_forms.cu``, built here with ``nvcc``;
- floors: ``torch.empty_like(y).copy_(y)`` (a read and a write of the
  row, the least any out-of-place kernel can take under this timing) and
  ``y.fill_(0)`` (the write alone).

All are timed with ``chip_smoke``'s queued, L2-scrubbed harness
(``_median_ms(..., queued=True)``), in turns: every form, then every form
again in the reverse order. Prints the card's name and power limit, one
line a form, and one JSON object; ``--json`` also writes it to a file.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORMS = ROOT / "bench_torch" / "csrc" / "mask_repair_forms.cu"


def build_forms() -> ctypes.CDLL:
    """Compile mask_repair_forms.cu with the port's nvcc flags; print each
    kernel's registers and spills."""
    from repro_torch.kernels import build
    so = build.BUILD_DIR / "mask_repair_forms.so"
    so.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run(
        [build.nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
         str(so), str(FORMS)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {FORMS.name}:\n{proc.stdout}")
    report(proc.stdout, "mask_repair_forms")
    lib = ctypes.CDLL(str(so))
    p = ctypes.c_void_p
    for fn in (lib.mrf_pr15, lib.mrf_bulk):
        fn.argtypes = [p, p, p, ctypes.c_int, p, ctypes.c_int,
                       ctypes.c_longlong, p]
        fn.restype = ctypes.c_int
    lib.mrf_error_string.argtypes = [ctypes.c_int]
    lib.mrf_error_string.restype = ctypes.c_char_p
    return lib


def report(ptxas: str, source: str) -> None:
    """Print the -Xptxas -v lines of the repair kernels of a build log."""
    import chip_smoke
    kernel = None
    for line in ptxas.splitlines():
        if "Compiling entry function" in line:
            kernel = chip_smoke._kernel_label(line.split("'")[1])
        elif kernel and "repair" in kernel and ("registers" in line
                                                or "spill" in line):
            print(f"build: {source} {kernel}: "
                  f"{line.split(':', 1)[-1].strip()}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", type=Path, default=None)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import masked_wire as mw
    from repro_torch.privacy import masking as pvm
    name, _count, rate = cs.phase_card(torch)
    dev = torch.device("cuda", 0)
    lib = build_forms()
    so = build.build("masked_wire")
    report(so.with_name(so.name + ".log").read_text(), "masked_wire")
    keys, coeff = cs.repair_operands(torch, dev)
    p, live = keys.shape[0], int((coeff != 0).sum())
    r = cs.ROWS // 4
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 7)
    stream = torch.cuda.current_stream(dev).cuda_stream
    result = {"card": name, "rows": r, "pairs": p, "live_pairs": live,
              "forms": {}}
    for bits in (16, 32):
        y = cs._rand_words(torch, (r, 512), bits, gen, dev)
        want = mw.mask_repair_plain(y, keys, coeff)
        term = mw.mask_repair_plain(torch.zeros_like(y), keys, coeff)
        out = torch.empty_like(y)
        spare = y.clone()

        def form(fn):
            def call():
                err = fn(y.data_ptr(), keys.data_ptr(), coeff.data_ptr(),
                         bits, out.data_ptr(), p, r, stream)
                if err:
                    raise RuntimeError(lib.mrf_error_string(err).decode())
                return out
            return call

        forms = {
            "shipped": lambda: mw.mask_repair(y, keys, coeff, out=out),
            "pr15": form(lib.mrf_pr15),
            "bulk": form(lib.mrf_bulk),
            "copy floor": lambda: torch.empty_like(y).copy_(y),
            "fill floor": lambda: out.fill_(0),
        }
        if bits == 16:
            forms["shipped in place"] = lambda: mw.mask_repair(
                spare, keys, coeff, out=spare)
            forms["shipped write-only"] = lambda: mw.mask_repair(
                None, keys, coeff, out=out)
        for what, fn in forms.items():
            if "floor" in what:
                continue
            if what == "shipped in place":
                spare.copy_(y)
                got, ref = fn(), want
            else:
                out.fill_(7)
                got = fn()
                ref = term if what == "shipped write-only" else want
            torch.cuda.synchronize()
            cs.check(cs._same_words(got, ref)[0],
                     f"{what} differs from the plain twin at {bits} bits")
        times = {what: [] for what in forms}
        order = list(forms)
        for turn in (order, order[::-1]):
            for what in turn:
                times[what].append(cs._median_ms(torch, forms[what],
                                                 queued=True))
        row_bytes = r * 512 * bits // 8
        nbytes = 2 * row_bytes + 8 * p
        bound = nbytes / rate * 1e3
        for what, ms in times.items():
            mean = sum(ms) / len(ms)
            moved = {"fill floor": row_bytes, "shipped write-only": row_bytes,
                     "copy floor": 2 * row_bytes}.get(what, nbytes)
            print(f"time: {bits}-bit {what}: {mean:.4f} ms on the device "
                  f"(turns {', '.join(f'{t:.4f}' for t in ms)}); "
                  f"{moved / (mean * 1e-3) / 1e12:.2f} TB/s; the repair's "
                  f"bound {bound:.4f} ms = {nbytes / 1e6:.1f} MB at "
                  f"{rate / 1e12:.2f} TB/s", flush=True)
            result["forms"][f"{bits}-bit {what}"] = {
                "ms": mean, "turns": ms, "bytes": moved}
        result[f"bound_ms_{bits}"] = bound
        del y, out, spare, want, term
    line = json.dumps(result)
    print(line, flush=True)
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
