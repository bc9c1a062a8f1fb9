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
       "repro_torch.configs.gemma2_2b", "repro_torch.examples.train_lm_gossip",
       "repro_torch.models.ssm", "repro_torch.kernels.ssd_scan",
       "repro_torch.configs.mamba2_1p3b", "repro_torch.core.baselines",
       "repro_torch.core.deprecation", "repro_torch.ft.faults",
       "repro_torch.examples.quickstart", "repro_torch.examples.decentralized_ridge",
       "repro_torch.examples.auc_maximization", "repro_torch.examples.serve_decode",
       "repro_torch.launch.shapes", "repro_torch.launch.cost_analysis",
       "repro_torch.launch.dryrun", "repro_torch.launch.reanalyze",
       "repro_torch.launch.compile_cache"}
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


def test_private_torch_api_only_in_build():
    """The port reaches torch's private ``torch._C`` in one place:
    ``_build.stream`` reads ``_cuda_getCurrentRawStream`` (the card tests
    check it exists), so a torch that renames it fails there alone."""
    uses = {}
    for path in sorted((REPO / "src/repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]:
        for n, line in enumerate(path.read_text().splitlines(), 1):
            code = line.split("#")[0]
            if "torch._C" in code and "``" not in code:
                uses[f"{path.relative_to(REPO)}:{n}"] = code.strip()
    assert list(uses.values()) == ["return torch._C._cuda_getCurrentRawStream(t.get_device())"], uses
    assert all(k.startswith("src/repro_torch/kernels/_build.py:") for k in uses), uses
