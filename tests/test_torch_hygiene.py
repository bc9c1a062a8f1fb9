"""The port and chip_smoke.py import neither JAX nor the JAX package."""
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

PROBE = """
import importlib, pkgutil, sys
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for m in mods:
    importlib.import_module(m)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro" or m.startswith("repro."))
assert not bad, bad
assert len(mods) >= 15, mods
new = {"repro_torch.data.sharded_loader", "repro_torch.optim.adam", "repro_torch.train.step",
       "repro_torch.ckpt.checkpoint", "repro_torch.launch.train", "repro_torch.core.gossip",
       "repro_torch.kernels.topk_compress", "repro_torch.ft.elastic",
       "repro_torch.configs.gemma2_2b", "repro_torch.examples.train_lm_gossip"}
assert new <= set(mods), sorted(new - set(mods))
print("ok", len(mods))
"""


def test_port_imports_no_jax_and_no_repro():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(REPO / "src"), str(REPO)])
    proc = subprocess.run([sys.executable, "-c", PROBE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")
