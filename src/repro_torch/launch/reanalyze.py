"""Recompute roofline terms from saved op tables (no re-run; the
counterpart of ``repro.launch.reanalyze``).

    PYTHONPATH=src python -m repro_torch.launch.reanalyze [--dir experiments/dryrun_torch]

Each dry-run record keeps its step's op table (op -> calls, flops, bytes;
the JAX package keeps the optimized HLO instead). Whenever the roofline
model, the peaks or ``model_flops`` change, this refreshes every record's
counted totals, ``model_flops`` and roofline in place.
"""
from __future__ import annotations

import argparse
import json
import pathlib

from repro_torch.launch import cost_analysis as C
from repro_torch.launch.dryrun import OUT_DIR, _roofline_fields, cell_config, parse_overrides
from repro_torch.launch.shapes import SHAPES


def reanalyze(path: pathlib.Path) -> bool:
    """Refresh one record in place; False for a failed or table-less record."""
    rec = json.loads(path.read_text())
    if not rec.get("ok") or "op_table" not in rec:
        return False
    overrides = parse_overrides(f"{k}={v}" for k, v in rec.get("overrides", {}).items())
    cfg = cell_config(rec["arch"], overrides, rec.get("reduced", False))
    flops, nbytes = C.table_totals(rec["op_table"])
    rec.update(_roofline_fields(cfg, SHAPES[rec["shape"]], rec["chips"], flops, nbytes))
    path.write_text(json.dumps(rec, indent=2, default=str))
    return True


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=str(OUT_DIR))
    args = ap.parse_args(argv)
    n = 0
    for p in sorted(pathlib.Path(args.dir).glob("*.json")):
        if reanalyze(p):
            n += 1
            print(f"reanalyzed {p.name}")
    print(f"{n} records refreshed")


if __name__ == "__main__":
    main()
