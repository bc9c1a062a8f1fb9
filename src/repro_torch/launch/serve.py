"""Serving launcher: batched prefill + decode with contiguous caches
(counterpart of ``repro.launch.serve``, with the same flags).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch minitron-8b --full
    PYTHONPATH=src python -m repro_torch.launch.serve --arch minitron-8b --device cpu

Serves a (reduced, unless --full) model with random weights drawn from
--seed on the device (the card unless --device says otherwise): requests
are prefilled in batches, then decoded token by token. Prompts (and, for
the encdec family, unit-normal (encoder_len, d_model) frame embeddings a
request) come from a ``torch.Generator`` seeded with --seed + 1.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import ALIASES, get_config, get_reduced
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.serve.engine import generate


def main(argv=None):
    """Parse flags, serve, print throughput per batch and overall."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="minitron-8b", choices=list(ALIASES))
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch) if args.full else get_reduced(args.arch)
    params = T.init_params(cfg, args.seed, dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)

    done_tokens = 0
    t_start = time.perf_counter()
    for batch_start in range(0, args.requests, args.batch):
        bsz = min(args.batch, args.requests - batch_start)
        prompts = torch.randint(0, cfg.vocab_size, (bsz, args.prompt_len),
                                generator=gen, device=dev)
        enc = None
        if cfg.family == "encdec":
            enc = torch.randn((bsz, cfg.encoder_len, cfg.d_model), generator=gen, device=dev)
        res = generate(cfg, params, prompts, max_new_tokens=args.tokens,
                       temperature=args.temperature, seed=args.seed + batch_start,
                       enc_embeds=enc)
        done_tokens += res.new_tokens
        print(f"batch {batch_start // args.batch}: {bsz} reqs, "
              f"{res.decode_tok_s:.1f} tok/s decode", flush=True)
    print(f"served {args.requests} requests, "
          f"{done_tokens / (time.perf_counter() - t_start):.1f} tok/s overall")


if __name__ == "__main__":
    main()
