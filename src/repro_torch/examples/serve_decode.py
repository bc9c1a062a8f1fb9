"""Batched serving example: prefill a batch of prompts, then decode (the
counterpart of the JAX package's ``examples/serve_decode.py``, with
``--device``).

A thin driver over ``repro_torch.serve.engine.generate`` — the shared
prefill + incremental-decode loop (contiguous caches). For continuous
batching over the paged cache pool, see ``launch/serve.py``. The weights
and prompts are drawn from seeded ``torch.Generator``s, so they differ from
the JAX example's ``jax.random`` draws.

    PYTHONPATH=src python -m repro_torch.examples.serve_decode --arch mamba2-1.3b --device cpu
    PYTHONPATH=src python -m repro_torch.examples.serve_decode --arch gemma2-2b --tokens 32 --device cpu

Runs on the card unless --device (``device=``) says otherwise; there the
ssm family's prefill runs the ``ssd_chunk`` kernel.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import ALIASES, get_reduced
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.serve import generate


def main(argv=None, device=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="minitron-8b", choices=list(ALIASES))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device if device is None else device)

    cfg = get_reduced(args.arch)
    params = T.init_params(cfg, 0, dev)
    gen = torch.Generator().manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen, dtype=torch.int32).to(dev)
    enc = None
    if cfg.family == "encdec":
        enc = torch.randn((args.batch, cfg.encoder_len, cfg.d_model),
                          generator=torch.Generator().manual_seed(2)).to(dev)

    res = generate(
        cfg, params, prompts, max_new_tokens=args.tokens,
        temperature=args.temperature, enc_embeds=enc,
    )

    print(f"arch={args.arch} batch={args.batch} "
          f"prompt={args.prompt_len} new_tokens={args.tokens}")
    print(f"prefill: {res.prefill_s * 1e3:.1f} ms "
          f"({res.prefill_tok_s:.0f} tok/s)")
    print(f"decode : {res.decode_s * 1e3:.1f} ms "
          f"({res.decode_tok_s:.0f} tok/s)")
    for b in range(min(2, args.batch)):
        print(f"  sample[{b}] generated ids: {res.tokens[b][:12]} ...")


if __name__ == "__main__":
    main()
