"""What the in-turns probes (``tools/ssd_probe.py``, ``tools/turns_probe.py``)
share: building another source beside the port's, running contenders in
turns, and the timers (CUDA events and host microseconds from
``chip_smoke.py``; profiler device time summed over a contender's kernels).

"In turns": the contenders are measured in order, then in the reverse
order, so that a drift of the card's clocks or of the host over the run
weighs on each alike.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from chip_smoke import cuda_ms, device_profile, host_us  # noqa: E402,F401
from repro_torch.kernels import _build  # noqa: E402


def emit(tag: str, obj) -> None:
    """One JSON object a line: {tag: obj}."""
    print(json.dumps({tag: obj}), flush=True)


def emit_device() -> None:
    """The card's name and power limit, as nvidia-smi gives them."""
    emit("device", subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip())


def build(src: Path, name: str) -> ctypes.CDLL:
    """nvcc `src` with the port's flags into the build directory as
    lib<name>.so (its ptxas registers and spills emitted), with
    ``error_string`` bound for ``_build.check``."""
    out = _build.BUILD_DIR / f"lib{name}.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    r = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(out), str(src)],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed on {src}:\n{r.stderr}")
    emit("ptxas", {name: [ln.strip() for ln in (r.stdout + r.stderr).splitlines()
                          if "Compiling entry" in ln or "registers" in ln or "spill" in ln]})
    lib = ctypes.CDLL(str(out))
    lib.error_string.argtypes, lib.error_string.restype = [ctypes.c_int], ctypes.c_char_p
    return lib


def device_ms(fn, names, iters) -> float:
    """Device ms a call of ``fn``, summed over the kernels whose name holds
    one of `names` (profiler), after one warm call."""
    fn()
    torch.cuda.synchronize()
    _, kern = device_profile(fn, iters)
    return sum(t for key, (t, _) in kern.items() if any(n in key for n in names)) / iters / 1e3


def in_turns(contenders, measure, rounds=2) -> dict:
    """{name: [measure(name), ...]}: the contenders in order, then in the
    reverse order, `rounds` times."""
    out = {}
    for who in (list(contenders) + list(reversed(contenders))) * rounds:
        out.setdefault(who, []).append(measure(who))
    return out
