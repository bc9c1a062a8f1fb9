"""End-to-end decentralized LM training example (counterpart of the JAX
package's ``examples/train_lm_gossip.py``, with the same flags and
``--device``).

Trains a transformer with the pod-axis DSBA gossip optimizer: P simulated
pods on one device, each with its own replica and data shard, exchanging
extrapolated parameters with ring neighbours only, optionally as top-k
compressed difference streams. Checkpoints with exact resume and an
elastic pod-failure drill.

    PYTHONPATH=src python -m repro_torch.examples.train_lm_gossip --device cpu --steps 40
    PYTHONPATH=src python -m repro_torch.examples.train_lm_gossip --model 100m --steps 300
    PYTHONPATH=src python -m repro_torch.examples.train_lm_gossip --compression topk \\
        --kill-pod-at 5 --steps 12 --ckpt-every 4

Runs on the card unless --device says otherwise. Two additions to the JAX
example: every checkpoint records the pod count in its metadata, so a run
that lost a pod resumes with the survivors (the JAX example rebuilds the
full pod count and starts afresh), and a final checkpoint is committed at
--steps, as ``launch/train.py`` does. The full-width selection kernel
(``GossipConfig(compression="block_topk")``) is driven by ``chip_smoke.py``.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import numpy as np

from repro_torch.ckpt import CheckpointManager
from repro_torch.ckpt.checkpoint import committed_metadata
from repro_torch.configs import get_reduced
from repro_torch.core.gossip import (
    GossipConfig, consensus_distance, init_gossip_state, make_gossip_train_step,
)
from repro_torch.data.sharded_loader import LoaderConfig, batch_at
from repro_torch.device import resolve_device
from repro_torch.ft import ElasticGossip
from repro_torch.models.params import tree_num_params
from repro_torch.models.transformer import model_defs
from repro_torch.optim.adam import AdamConfig
from repro_torch.train.step import TrainConfig

MODELS = {
    "tiny": lambda: dataclasses.replace(
        get_reduced("minitron_8b"), n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=2, head_dim=32, d_ff=512, vocab_size=4096),
    "100m": lambda: dataclasses.replace(
        get_reduced("minitron_8b"), n_layers=12, d_model=768, n_heads=12,
        n_kv_heads=4, head_dim=64, d_ff=3072, vocab_size=32_768),
}


def parse_args(argv=None) -> argparse.Namespace:
    """The JAX example's flags, plus --device."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="tiny", choices=list(MODELS))
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--pods", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch-per-pod", type=int, default=4)
    ap.add_argument("--mode", default="dsba", choices=["dsba", "dsgd", "allreduce"])
    ap.add_argument("--compression", default="none", choices=["none", "topk"])
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_torch_gossip_ckpt"))
    ap.add_argument("--kill-pod-at", type=int, default=0,
                    help="simulate pod failure at this step (0 = off)")
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    return ap.parse_args(argv)


def run(args: argparse.Namespace) -> dict:
    """Train as the flags say; returns the final gossip state."""
    cfg = MODELS[args.model]()
    # dsba mode is the plain-SGD EXTRA structure (needs a real step size);
    # dsgd/allreduce modes are Adam-preconditioned
    lr = 0.5 if args.mode == "dsba" else 3e-3
    tc = TrainConfig(optimizer=AdamConfig(lr=lr, warmup_steps=20))
    dev = resolve_device(args.device)
    # a checkpoint taken after a pod failure holds the survivors' rows
    pods = (committed_metadata(args.ckpt_dir) or {}).get("n_pods", args.pods)
    gc = GossipConfig(n_pods=pods, mode=args.mode, compression=args.compression,
                      topk_ratio=0.05)
    print(f"model={args.model} params={tree_num_params(model_defs(cfg)):,} "
          f"pods={gc.n_pods} mode={gc.mode} compression={gc.compression}")

    def loader(n_pods):
        return LoaderConfig(cfg.vocab_size, n_pods * args.batch_per_pod, args.seq,
                            n_shards=n_pods)

    ld_cfg = loader(gc.n_pods)
    mgr = CheckpointManager(args.ckpt_dir)
    state = init_gossip_state(cfg, tc, gc, 0, dev)
    try:
        restored, at = mgr.restore(state)
    except ValueError as e:
        print(f"checkpoint incompatible ({e}); starting fresh")
        restored = None
    if restored is not None:
        state = restored
        print(f"resumed from step {at}")
    step_fn = make_gossip_train_step(None, cfg, tc, gc)

    t0 = time.time()
    start = int(state["step"])
    for i in range(start, args.steps):
        b = batch_at(ld_cfg, i)
        batch = {k: np.asarray(v).reshape(gc.n_pods, args.batch_per_pod, -1)
                 for k, v in b.items()}
        state, m = step_fn(state, batch)

        if args.kill_pod_at and i == args.kill_pod_at:
            state, gc = ElasticGossip(gc).shrink(state, dead=[gc.n_pods - 1])
            step_fn = make_gossip_train_step(None, cfg, tc, gc)
            print(f"[ft] pod killed at step {i}: continuing with {gc.n_pods} pods "
                  "(no global restart)")
            ld_cfg = loader(gc.n_pods)

        if i % 20 == 0 or i == args.steps - 1:
            cons = float(consensus_distance(state["params"]))
            print(f"step {i:4d}  loss {float(m['loss']):.4f}  consensus {cons:.3e}  "
                  f"({(time.time() - t0) / max(1, i - start + 1):.2f}s/step)", flush=True)
        if args.ckpt_every and i and i % args.ckpt_every == 0:
            mgr.save(i, state, metadata={"n_pods": gc.n_pods}, async_=True)
    mgr.wait()
    mgr.save(args.steps, state, metadata={"n_pods": gc.n_pods}, async_=False)
    print("done.")
    return state


def main(argv=None):
    """Parse flags and train."""
    run(parse_args(argv))


if __name__ == "__main__":
    main()
