"""Training launcher (counterpart of ``repro.launch.train``, with the same
flags and ``--device``).

    PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu \\
        --steps 20 --batch 4 --seq 32                     # CPU-runnable
    PYTHONPATH=src python -m repro_torch.launch.train --arch minitron-8b \\
        --steps 100 --batch 8 --seq 256 --reduced        # on the card

Wires together the config registry, the deterministic resumable loader
(``batch_at``), the AdamW train step and async checkpointing with exact
resume: a run restores the newest committed checkpoint in --ckpt-dir and
continues from its step. Runs on the card unless --device says otherwise.
``--mesh single|multi`` builds the production mesh (``make_production_mesh``:
16 x 16 ranks, or 2 x 16 x 16), as the JAX launcher does, and trains with
the within-pod sharded step on it; with fewer devices than that (one card,
or the CPU) it raises the JAX package's ``ValueError``. A sharded run's
checkpoints hold the whole state, gathered from the ranks. The JAX
launcher's ``LIBTPU_INIT_ARGS`` (TPU collective overlap flags) have no
counterpart here.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import ALIASES, get_config, get_reduced
from repro_torch.data.sharded_loader import LoaderConfig, batch_at
from repro_torch.device import resolve_device
from repro_torch.optim.adam import AdamConfig
from repro_torch.train.step import (
    TrainConfig, init_train_state, make_jitted_train_step, train_step,
)


def parse_args(argv=None) -> argparse.Namespace:
    """The JAX launcher's flags, plus --device."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="minitron-8b", choices=list(ALIASES))
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh", default="none", choices=["none", "single", "multi"],
                    help="'none' runs on one device; single/multi build the "
                         "production mesh (needs 256 / 512 devices)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    return ap.parse_args(argv)


def run(args: argparse.Namespace) -> dict:
    """Train as the flags say; returns the final train state."""
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    tc = TrainConfig(optimizer=AdamConfig(lr=args.lr), microbatches=args.microbatches)
    ld = LoaderConfig(cfg.vocab_size, args.batch, args.seq, seed=args.seed)
    mesh = None
    if args.mesh != "none":
        from repro_torch.launch.mesh import make_production_mesh

        mesh = make_production_mesh(multi_pod=args.mesh == "multi")
    dev = resolve_device(args.device)

    mgr = CheckpointManager(args.ckpt_dir)
    state = init_train_state(cfg, tc, args.seed, dev)
    restored, at = mgr.restore(state)
    if restored is not None:
        state = restored
        print(f"resumed from step {at}")
    start = int(state["step"])
    if mesh is None:
        def step_fn(st, batch):
            return train_step(cfg, tc, st, batch)

        def whole(st):
            return st
    else:
        from repro_torch.train.sharded import gather_train_state, shard_train_state

        step_fn = make_jitted_train_step(mesh, cfg, tc)
        state = shard_train_state(mesh, cfg, tc, state)

        def whole(st):
            return gather_train_state(st, dev)

    t0 = time.time()
    for i in range(start, args.steps):
        state, metrics = step_fn(state, batch_at(ld, i))
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i:5d}  loss {float(metrics['loss']):.4f}  "
                  f"gnorm {float(metrics['grad_norm']):.3f}  "
                  f"({(time.time() - t0) / max(1, i - start + 1):.2f} s/step)",
                  flush=True)
        if args.ckpt_every and i and i % args.ckpt_every == 0:
            mgr.save(i, whole(state), async_=True)
    mgr.wait()
    state = whole(state)
    mgr.save(args.steps, state, async_=False)
    print("done; final checkpoint committed.")
    return state


def main(argv=None):
    """Parse flags and train."""
    run(parse_args(argv))


if __name__ == "__main__":
    main()
