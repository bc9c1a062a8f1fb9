"""Dry run: count every (arch x shape) cell's step on the meta device (the
counterpart of ``repro.launch.dryrun``).

For each cell the real step is built on the meta device, whose tensors have
shapes and dtypes and no storage (zero allocation, no card needed):
``train_step`` over a train state from ``init_train_state``, the serve
prefill ``decode_step`` over the full prompt, or the serving decode
``decode_step_paged`` (``shapes.input_specs`` says why). It runs once
under ``cost_analysis.count_step`` (every hand kernel through its
``KernelSpec.meta`` and ``cost``), and the record says:

  memory          argument, output and peak live bytes (``fits_one_card``:
                  the peak within the card's 80 GB)
  hlo_flops/bytes the counted FLOPs and bytes of the step (the reference's
                  keys; there is no HLO), and ``op_table`` (op -> calls,
                  flops, bytes) that ``reanalyze`` reads
  roofline        the reference's terms against the H100's published peaks

A cell that syncs the host inside the step (``.item()``, ``int(tensor)``,
``nonzero``) has no values to sync on meta tensors: it raises there and is
recorded ``ok: false`` with the error, as failures are in the reference.

One card only: ``--mesh single`` (the reference's 16x16 pod, its 2x16x16
multi-pod mesh and the gossip flags that configure it wait for the sharded
backend, ROADMAP Queue 1 item 10). Fields of the reference the port cannot
fill: ``lower_s`` and ``compile_s`` (nothing is lowered or compiled; the
record has ``build_s``, the time to build the state and inputs, and
``count_s``, the counted run), ``xla_cost_analysis`` and the memory
analysis' temp, alias and code bytes (absent), the collectives' by-op
dicts (empty; ``collective_bytes`` is 0). Records go to
``experiments/dryrun_torch/`` (git-ignored), one JSON each, no HLO dump.

Usage:
  python -m repro_torch.launch.dryrun --arch minitron-8b --shape train_4k
  python -m repro_torch.launch.dryrun --all            # every cell
  python -m repro_torch.launch.dryrun --arch mamba2-1.3b --set remat=dots
  python -m repro_torch.launch.dryrun --all --reduced --out /tmp/dry   # small configs
"""
from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import pathlib
import time
import traceback

from repro_torch.configs import ALIASES, get_config, get_reduced, list_archs
from repro_torch.launch import cost_analysis as C
from repro_torch.launch.shapes import SHAPES, ShapeSpec, cells_for, input_specs
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.train.step import TrainConfig, init_train_state, train_step

OUT_DIR = pathlib.Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"


def _serve_fn(cfg: ModelConfig, kind: str):
    if kind == "prefill":
        def serve_step(params, tokens, cache):
            return T.decode_step(cfg, params, tokens, cache)
    else:
        def serve_step(params, tokens, pools, table, lengths):
            return T.decode_step_paged(cfg, params, tokens, pools, table, lengths)

    return serve_step


def build_cell(cfg: ModelConfig, shape: str | ShapeSpec, device="meta", microbatches: int = 1,
               seed: int = 0):
    """Returns (step function, its arguments on `device`)."""
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    inputs = input_specs(cfg, shape, device)
    if shape.kind == "train":
        tc = TrainConfig(microbatches=microbatches)
        state = init_train_state(cfg, tc, seed, device)
        return (lambda st, b: train_step(cfg, tc, st, b)), (state, inputs)
    params = T.init_params(cfg, seed, device)
    fn = _serve_fn(cfg, shape.kind)
    if shape.kind == "prefill":
        return fn, (params, inputs["tokens"], inputs["cache"])
    return fn, (params, inputs["tokens"], inputs["pools"], inputs["table"], inputs["lengths"])


def _roofline_fields(cfg: ModelConfig, shape: ShapeSpec, chips: int, flops: float,
                     nbytes: float) -> dict:
    """The record's hlo_flops .. roofline keys from counted totals."""
    mf = C.model_flops(cfg, shape.kind, shape.batch, shape.seq)
    colls = C.CollectiveStats({}, {})
    rl = C.roofline_terms({"flops": flops, "bytes accessed": nbytes}, colls, chips, mf)
    return dict(
        hlo_flops=rl.hlo_flops,
        hlo_bytes=rl.hlo_bytes,
        collective_bytes=rl.collective_bytes,
        collectives={"bytes": colls.bytes_by_op, "count": colls.count_by_op},
        model_flops=mf,
        roofline={
            "compute_s": rl.compute_s,
            "memory_s": rl.memory_s,
            "collective_s": rl.collective_s,
            "dominant": rl.dominant,
            "useful_flop_ratio": rl.useful_flop_ratio,
            "roofline_fraction": rl.roofline_fraction,
        },
    )


def cell_config(arch: str, overrides: dict | None = None, reduced: bool = False) -> ModelConfig:
    """The arch's config (its small same-family one with `reduced`), overridden."""
    cfg = get_reduced(arch) if reduced else get_config(arch)
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def run_cell(arch: str, shape_name: str, overrides: dict | None = None,
             microbatches: int = 1, reduced: bool = False) -> dict:
    """Build the cell's step and count one run of it; the record (``ok``
    False with the error when the build or the run raises)."""
    cfg = cell_config(arch, overrides, reduced)
    rec: dict = {
        "arch": arch,
        "reduced": reduced,
        "shape": shape_name,
        "mesh": "1",
        "chips": 1,
        "device": "meta",
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "peaks": {"card": C.CARD, "flops_per_s": C.PEAK_FLOPS, "hbm_bytes_per_s": C.HBM_BW,
                  "hbm_bytes": C.HBM_BYTES},
    }
    t0 = time.time()
    try:
        fn, args = build_cell(cfg, shape_name, "meta", microbatches)
        t1 = time.time()
        _, costs = C.count_step(fn, *args)
        t2 = time.time()
        del fn, args
        rec.update(
            ok=True,
            build_s=round(t1 - t0, 2),
            count_s=round(t2 - t1, 2),
            memory={
                "argument_bytes": costs.argument_bytes,
                "output_bytes": costs.output_bytes,
                "peak_bytes": costs.peak_bytes,
            },
            fits_one_card=costs.peak_bytes <= C.HBM_BYTES,
            **_roofline_fields(cfg, SHAPES[shape_name], rec["chips"], costs.flops, costs.bytes),
            op_table={op: dataclasses.asdict(r) for op, r in costs.table.items()},
        )
    except Exception as e:  # noqa: BLE001 — record the failure, keep going
        rec.update(ok=False, error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
    rec["total_s"] = round(time.time() - t0, 2)
    return rec


def cell_list(archs, shapes, meshes=("single",)):
    """[(arch, shape)] of every cell the arch supports among `shapes` (None:
    all of them); one card: `meshes` may only name "single"."""
    if set(meshes) != {"single"}:
        raise ValueError(f"meshes {meshes}: one card only ('single'; ROADMAP Queue 1 item 10)")
    cells = []
    for arch in archs:
        cfg = get_config(arch)
        names = cells_for(cfg) if shapes is None else shapes
        for s in names:
            if s in cells_for(cfg):
                cells.append((arch, s))
    return cells


def record_path(out: pathlib.Path, arch: str, shape: str, tag: str = "") -> pathlib.Path:
    """``<arch id>_<shape>_single[_<tag>].json`` under `out`."""
    aid = ALIASES.get(arch, arch)
    return out / f"{aid}_{shape}_single{f'_{tag}' if tag else ''}.json"


def parse_overrides(pairs) -> dict:
    """``FIELD=VALUE`` strings -> {field: literal value, or the string}."""
    overrides = {}
    for kv in pairs:
        key, val = kv.split("=", 1)
        try:
            overrides[key] = ast.literal_eval(val)
        except (ValueError, SyntaxError):
            overrides[key] = val
    return overrides


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=str(OUT_DIR))
    ap.add_argument("--force", action="store_true", help="recompute cached cells")
    ap.add_argument("--tag", default="", help="suffix for experiment variants")
    ap.add_argument(
        "--set", nargs="*", default=[], metavar="FIELD=VALUE",
        help="ModelConfig overrides for perf variants, e.g. "
             "blockwise_attention=True remat=dots",
    )
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--reduced", action="store_true",
                    help="each arch's small same-family config (CPU checks)")
    args = ap.parse_args(argv)
    overrides = parse_overrides(args.set)

    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    archs = list_archs() if (args.all or not args.arch) else [args.arch]
    shapes = None if (args.all or not args.shape) else [args.shape]
    cells = cell_list(archs, shapes, [args.mesh])
    print(f"{len(cells)} cells to run")
    for arch, shape in cells:
        path = record_path(out, arch, shape, args.tag)
        if path.exists() and not args.force:
            print(f"skip (cached): {path.name}")
            continue
        print(f"=== {arch} x {shape} x single {overrides or ''} ===", flush=True)
        rec = run_cell(arch, shape, overrides, args.microbatches, reduced=args.reduced)
        if overrides or args.microbatches > 1:
            rec["overrides"] = {k: str(v) for k, v in overrides.items()}
            rec["microbatches"] = args.microbatches
        path.write_text(json.dumps(rec, indent=2, default=str))
        status = "OK" if rec.get("ok") else f"FAIL: {rec.get('error')}"
        print(f"--> {status} ({rec['total_s']}s)", flush=True)


if __name__ == "__main__":
    main()
