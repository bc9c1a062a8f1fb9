"""What the within-pod step's change bar can hold for phase 30's families
(``chip_smoke.py --fsdp-families``), on the card: zamba2-1.2b x12's
unsharded step against itself at 2 microbatches (``fsdp_control``: the same
function in another summation order) in phase 30's compute (float32,
``FAMILY_CONFIG``), with the reference's attention init and with the shared
block's attention conditioned (``condition_attention``, as phase 30 does);
then, in bf16 compute, with the change bar only logged and no fault
control, the phase's checks (each with its 2-microbatch control) of
zamba2-1.2b x12 conditioned, and of qwen2-moe-a2.7b x1 and zamba2-1.2b x12
with the reference's init. With ``--moe-faults``, instead: qwen2-moe-a2.7b
x1 as phase 30 runs it, once with each planted fault of the MoE dispatch
(``chip_smoke.FSDP_FAULTS``), the change bar's reading logged whether it
catches the fault or not.

    python3 tools/fsdp_control_probe.py [--moe-faults] > probe.log

Each reading is a line of ``chip_smoke.log``; the change bar's readings are
the ``final blocks vs the unsharded params`` lines.
"""
from __future__ import annotations

import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as CS  # noqa: E402


def main() -> int:
    """Run the readings on the card; 1 without one."""
    if not torch.cuda.is_available():
        print("fsdp_control_probe: no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    if "--moe-faults" in sys.argv[1:]:
        for fault in ("capacity", "dispatch_grad"):
            try:
                CS.fsdp_run(dev, {"qwen2-moe-a2.7b": (1, 2, fault)})
            except (AssertionError, RuntimeError) as e:  # the reading is logged first
                print(f"fsdp_control_probe: {fault}: {e}", file=sys.stderr)
        return 0
    setup = CS.fsdp_family_setup("zamba2-1.2b", 12)
    batches = CS.fsdp_batches(setup[0])
    conditioned = CS.FAMILY_CONDITIONED
    for families in ((), conditioned):
        CS.FAMILY_CONDITIONED = families
        tag = "probe-conditioned" if families else "probe-reference-init"
        with tempfile.TemporaryDirectory() as d:
            ref = CS.fsdp_reference(dev, setup, batches, d, tag)
            CS.fsdp_control(dev, setup, batches, ref, tag)
    CS.FSDP_CHANGE_REL = float("inf")  # log the change, stop at no reading
    CS.FAMILY_CONFIG = {}  # bf16 compute
    CS.FSDP_GRAD_CHECK = ()
    CS.fsdp_run(dev, {"zamba2-1.2b": (12, 2, None)})
    CS.FAMILY_CONDITIONED = ()
    CS.fsdp_run(dev, {"qwen2-moe-a2.7b": (1, 2, None), "zamba2-1.2b": (12, 2, None)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
