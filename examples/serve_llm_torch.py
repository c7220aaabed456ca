"""Batched serving on PyTorch: prefill a prompt batch, then greedy-decode;
the twin of serve_llm.py.

Exercises the serving path (parallel prefill → KV caches → one-token
decode steps) for every family of the model zoo: Whisper's encoder and
cross-attention caches over its audio frames, Qwen2-VL's patches and
M-RoPE positions. The stub frontends' embeddings come in the weights'
dtype, as the reference's input specs give them. Runs on the card;
``--device cpu`` runs on the CPU. ``--full-size`` with ``--param-dtype
bfloat16`` serves qwen3-14b (29.5 GB of weights), mistral-nemo-12b
(24.5 GB), qwen2-vl-7b or whisper-medium on one 80 GB card.

Run:  PYTHONPATH=src python examples/serve_llm_torch.py --arch qwen3-14b \
          --batch 4 --prompt-len 32 --new-tokens 16 [--device cpu]
"""
import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models.layers import dtype_of
from repro_torch.utils import resolve_device


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-14b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--full-size", action="store_true")
    ap.add_argument("--param-dtype", default=None,
                    help="float32 or bfloat16 (default: the config's)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    args = ap.parse_args()

    cfg = get_config(args.arch)
    if not args.full_size:
        cfg = cfg.reduced()
    if args.param_dtype:
        cfg = cfg.replace(param_dtype=args.param_dtype)
    m = build_model(cfg)
    device = resolve_device(args.device)
    gen = torch.Generator(device).manual_seed(0)
    params = m.init(gen, device=device)
    B, S = args.batch, args.prompt_len

    batch = {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=gen,
                                     device=device)}
    if cfg.mrope:
        batch["positions"] = torch.arange(
            S, dtype=torch.int32, device=device).expand(3, B, S)
    embed_dtype = dtype_of(cfg.param_dtype)
    if cfg.is_encdec:
        batch["audio_embed"] = torch.randn(
            (B, cfg.n_frames, cfg.d_model), generator=gen,
            device=device).to(embed_dtype)
    if cfg.arch_type == "vlm":
        batch["vision_embed"] = torch.randn(
            (B, min(cfg.n_patches, S), cfg.d_model), generator=gen,
            device=device).to(embed_dtype)

    with torch.no_grad():
        state = m.init_decode_state(B, S + args.new_tokens, device=device)
        t0 = time.time()
        logits, state = m.prefill(params, batch, state)
        _sync(device)
        t_prefill = time.time() - t0
        print(f"[serve] {cfg.name}: prefill {B}×{S} in "
              f"{t_prefill*1e3:.0f} ms")

        tok = logits.argmax(-1)
        out_tokens = [tok]
        t0 = time.time()
        for i in range(args.new_tokens - 1):
            sb = {"token": tok, "pos": S + i}
            if cfg.mrope:
                sb["positions"] = torch.full((3, B, 1), S + i,
                                             dtype=torch.int32,
                                             device=device)
            logits, state = m.decode_step(params, state, sb)
            tok = logits.argmax(-1)
            out_tokens.append(tok)
        _sync(device)
        t_decode = time.time() - t0
    per_tok = t_decode / max(args.new_tokens - 1, 1) * 1e3
    print(f"[serve] decoded {args.new_tokens} tokens "
          f"({per_tok:.1f} ms/token)")
    seqs = torch.cat(out_tokens, dim=1)
    print(f"[serve] sample continuation (batch 0): "
          f"{[int(t) for t in seqs[0][:12]]} ...")


if __name__ == "__main__":
    main()
