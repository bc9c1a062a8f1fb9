"""The within-pod FSDP x TP train step (``repro_torch.train.sharded``) for the
moe, ssm and hybrid families, against the JAX package.

Sizes: reduced qwen2-moe-a2.7b at capacity factor 1.0 (8 experts top-2, a
shared expert of 64 units; C = 16 pairs an expert of the 128 a step routes,
so pairs drop and the global positions decide which), reduced mamba2-1.3b
(2 layers, 8 heads of 16, state 16) and reduced zamba2-1.2b (4 layers,
period 2: the shared block is used twice), float32 compute, B = 4, S = 16,
AdamW lr 1e-3 with one warmup step. The weights are one numpy draw a
family, the norm scales, ``dt_bias``, ``A_log``, ``D`` and the biases
perturbed off their 0/1 init (so a wrong head or channel slice of them
shows), fed to the JAX package as arrays and to the port through
``repro_torch.convert.model_params_from_numpy``.

The JAX reference runs in a fresh process a family (``_REFERENCE``, started
when the module starts) with 4 forced host devices: three steps of the
unsharded ``jax.jit(train_step)`` and, on meshes (2, 2) and (1, 4) (and (4,
1) for moe), three of its ``make_jitted_train_step`` on the devices of
``make_test_mesh`` with Auto axes (the test mesh's Explicit axes break the
reference's gathers, ROADMAP Queue 3), with each state leaf's shard slices.
Every spec of these layouts divides, so the JAX sharded step runs as it is
(``route`` 0; the ``shardable_pspecs`` jit is the fallback only). The
port's sharded step runs on the same meshes of CPU ranks (gloo), where
the kernels are their plain versions.

Bars, each with its reason:
  * three steps against the JAX sharded step, JAX's unsharded jit and the
    port's unsharded ``train_step``: losses within ``RTOL`` at every step
    and the grad norm within it at step 0 (float32, summed in other
    orders), every parameter within 3 x lr (the most an element can move
    in three AdamW steps: ``test_torch_fsdp.py``'s bar). After a step the
    parameters differ by rounding that Adam divides by small moments: the
    JAX package's own sharded steps of the hybrid differ from its jit by up
    to 5.6e-5 in grad norm at steps 1-2 (the port's by up to 1.3e-4), so
    the later grad norms are held within ``GNORM_DRIFT``;
  * each rank's bytes sent: ``expected_sent_bytes``'s closed form;
  * two runs of the sharded step: bit-equal;
  * a fault planted in the ranks (a job of this module patches the port in
    each worker; the port has no switch for it) misses those bars: moe
    positions from each data rank's own cumsum; ssm without the model-axis
    sums of the wB/wC/wdt and dt_bias gradients; hybrid with the shared
    block gathered at each use and only the last use's gradient kept;
  * the launcher's ``--mesh`` trains each family on a ``make_test_mesh``
    (the production mesh's stand-in) as its unsharded run does, within 2 x
    steps x lr.

torch runs on one thread (ROADMAP Queue 3); the meshes are closed at the
module's end. The module imports no JAX: its fault jobs run in the ranks,
which import it.
"""
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import get_reduced
from repro_torch.data.sharded_loader import LoaderConfig, batch_at
from repro_torch.launch import mesh as TMesh
from repro_torch.launch import train as launcher
from repro_torch.models import layers as L
from repro_torch.models import ssm as SSM
from repro_torch.models import transformer as T
from repro_torch.models.params import shard_index, tree_leaves, tree_map
from repro_torch.optim.adam import AdamConfig, adam_init, shard_sum_of_squares, sum_of_squares
from repro_torch.train import sharded as SH
from repro_torch.train import step as S
from repro_torch.train.step import TrainConfig, train_step

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
ARCHS = {"moe": "qwen2-moe-a2.7b", "ssm": "mamba2-1.3b", "hybrid": "zamba2-1.2b"}
SHAPES = {"moe": [(2, 2), (1, 4), (4, 1)], "ssm": [(2, 2), (1, 4)], "hybrid": [(2, 2), (1, 4)]}
CASES = [(fam, shape) for fam, shapes in SHAPES.items() for shape in shapes]
LR = 1e-3
B, SEQ, STEPS = 4, 16, 3
RTOL = 1e-5
GNORM_DRIFT = 5e-4  # the grad norm after step 0 (the module's docstring)
CAPACITY = 1.0  # moe: pairs drop at B x S = 64 tokens


@pytest.fixture(autouse=True)
def one_torch_thread():
    """torch's CPU threads are unsteady beside JAX (ROADMAP Queue 3)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(family):
    kw = {"capacity_factor": CAPACITY} if family == "moe" else {}
    return dataclasses.replace(get_reduced(ARCHS[family]), compute_dtype=torch.float32, **kw)


def _tc(**kw):
    return TrainConfig(optimizer=AdamConfig(lr=LR, warmup_steps=1), **kw)


def _weights(cfg, seed=0) -> dict:
    """Float32 numpy weights of `cfg`: ParamDef's normals, and the 0/1
    leaves drawn around their init (0.1 and 1 + 0.1 normals)."""
    rng = np.random.default_rng(seed)

    def one(_, d):
        draw = rng.standard_normal(d.shape)
        if d.init == "zeros":
            return (0.1 * draw).astype(np.float32)
        if d.init == "ones":
            return (1 + 0.1 * draw).astype(np.float32)
        return (d.stddev * draw).astype(np.float32)

    return tree_map(one, T.model_defs(cfg))


def _state(cfg, tc, weights) -> dict:
    """A fresh train state of copies of `weights` (the step writes the
    parameters in place; ``convert`` shares a float32 array's memory)."""
    params = convert.model_params_from_numpy(cfg, tree_map(lambda _, a: a.copy(), weights), CPU)
    return {"params": params, "opt": adam_init(tc.optimizer, params),
            "step": torch.zeros((), dtype=torch.int32)}


def _batches(cfg, steps=STEPS, seed=3):
    ld = LoaderConfig(cfg.vocab_size, B, SEQ, seed=seed)
    return [batch_at(ld, i) for i in range(steps)]


def _flat(tree, prefix=""):
    out = {}
    tree_map(lambda path, a: out.__setitem__(prefix + "/".join(path), np.asarray(a)), tree)
    return out


# ---------------------------------------------------------------------------
# the JAX reference, a process a family with 4 host devices
# ---------------------------------------------------------------------------

_REFERENCE = r'''
import dataclasses, json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType, NamedSharding
from repro.configs import get_reduced
from repro.launch.mesh import make_test_mesh
from repro.models.params import shardable_pspecs
from repro.optim.adam import AdamConfig, adam_init
from repro.train import step as S

inp = dict(np.load(sys.argv[1]))
args = json.loads(sys.argv[3])
cfg = dataclasses.replace(get_reduced(args["arch"]), compute_dtype=jnp.float32,
                          attention_kernel="jnp", ssm_kernel="jnp", **args["cfg"])
tc = S.TrainConfig(optimizer=AdamConfig(lr=args["lr"], warmup_steps=1))
res = {}


def nest(prefix):
    out = {}
    for k, v in inp.items():
        if k.startswith(prefix):
            node = out
            *head, last = k[len(prefix):].split("/")
            for h in head:
                node = node.setdefault(h, {})
            node[last] = v
    return out


params0 = nest("p/")
batches = [{"tokens": jnp.asarray(inp[f"b{i}/tokens"]), "targets": jnp.asarray(inp[f"b{i}/targets"])}
           for i in range(args["steps"])]


def state0():
    p = jax.tree_util.tree_map(jnp.asarray, params0)
    return {"params": p, "opt": adam_init(tc.optimizer, p), "step": jnp.zeros((), jnp.int32)}


def keep(tag, st, rows):
    res[f"{tag}/loss"] = np.array([r[0] for r in rows])
    res[f"{tag}/gnorm"] = np.array([r[1] for r in rows])
    for path, a in jax.tree_util.tree_leaves_with_path(st["params"]):
        res[f"{tag}/p/" + "/".join(k.key for k in path)] = np.asarray(a)


def run(step_fn, st):
    rows = []
    for b in batches:
        st, m = step_fn(st, b)
        rows.append((float(m["loss"]), float(m["grad_norm"])))
    return st, rows


st, rows = run(jax.jit(lambda s, b: S.train_step(cfg, tc, s, b)), state0())
keep("jit", st, rows)
for shape in args["shapes"]:
    tag = "x".join(map(str, shape))
    mesh = jax.make_mesh(tuple(shape), ("data", "model"),
                         devices=np.asarray(jax.devices()[:int(np.prod(shape))]),
                         axis_types=(AxisType.Auto, AxisType.Auto))
    sds, spec = S.make_train_state_defs(cfg, tc)
    try:
        st, rows = run(S.make_jitted_train_step(mesh, cfg, tc), state0())
        res[f"{tag}/route"] = np.array(0)
    except ValueError:
        spec = shardable_pspecs(spec, sds, mesh)
        st_sh = jax.tree_util.tree_map(lambda s: NamedSharding(mesh, s), spec)
        b_sh = jax.tree_util.tree_map(lambda s: NamedSharding(mesh, s), S.batch_specs(cfg, tc))
        fn = jax.jit(lambda s, b: S.train_step(cfg, tc, s, b), in_shardings=(st_sh, b_sh),
                     out_shardings=(st_sh, None), donate_argnums=(0,))
        st, rows = run(fn, state0())
        res[f"{tag}/route"] = np.array(1)
    keep(tag, st, rows)
    placed = jax.device_put(state0(), jax.tree_util.tree_map(lambda s: NamedSharding(mesh, s), spec))
    for path, a in jax.tree_util.tree_leaves_with_path(placed):
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        idx = np.full((a.sharding.mesh.size, max(a.ndim, 1), 2), -2)
        for sh in a.addressable_shards:
            for dim, sl in enumerate(sh.index):
                idx[sh.device.id, dim] = (-1 if sl.start is None else sl.start,
                                          -1 if sl.stop is None else sl.stop)
        res[f"{tag}/idx/{name}"] = idx
np.savez(sys.argv[2], **res)
'''


class _Reference:
    """A family's JAX reference process (started at once, read on first use)."""

    def __init__(self, family):
        self.family = family
        self.dir = tempfile.mkdtemp(prefix=f"fsdp_{family}_ref_")
        self.cfg = _cfg(family)
        self.weights = _weights(self.cfg)
        self.batches = _batches(self.cfg)
        inp = _flat(self.weights, "p/")
        for i, b in enumerate(self.batches):
            inp[f"b{i}/tokens"], inp[f"b{i}/targets"] = b["tokens"], b["targets"]
        src = os.path.join(self.dir, "in.npz")
        np.savez(src, **inp)
        self.out = os.path.join(self.dir, "out.npz")
        env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
                   JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO / "src"))
        args = {"arch": ARCHS[family], "lr": LR, "steps": STEPS, "shapes": SHAPES[family],
                "cfg": {"capacity_factor": CAPACITY} if family == "moe" else {}}
        self.proc = subprocess.Popen(
            [sys.executable, "-c", _REFERENCE, src, self.out, json.dumps(args)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        self._res = None

    def result(self) -> dict:
        if self._res is None:
            out, err = self.proc.communicate(timeout=600)
            assert self.proc.returncode == 0, err[-4000:]
            self._res = dict(np.load(self.out))
        return self._res


@pytest.fixture(scope="module", autouse=True)
def references():
    refs = {fam: _Reference(fam) for fam in ARCHS}
    yield refs
    for ref in refs.values():
        if ref.proc.poll() is None:
            ref.proc.kill()
            ref.proc.wait()
        shutil.rmtree(ref.dir, ignore_errors=True)


@pytest.fixture(scope="module")
def grid():
    """shape -> the registry's CPU mesh of that shape; every mesh closed at
    the module's end, none of their workers outliving it."""
    yield lambda shape: TMesh.make_test_mesh(shape, device=CPU)
    procs = [p for m in TMesh._MESHES.values() for p in m._procs]
    TMesh.close_all()
    assert not TMesh._MESHES
    assert not any(p.is_alive() for p in procs)


def _run_sharded(mesh, cfg, tc, weights, batches):
    """(rows of (loss, grad_norm, sent bytes a rank), the gathered state);
    step 0 holds the kernel calls to their plain versions."""
    handle = SH.shard_train_state(mesh, cfg, tc, _state(cfg, tc, weights))
    step = S.make_jitted_train_step(mesh, cfg, tc)
    rows = []
    for i, b in enumerate(batches):
        handle, m = step(handle, b, check=i == 0)
        rows.append((float(m["loss"]), float(m["grad_norm"]), m["sent_bytes"]))
    state = SH.gather_train_state(handle, CPU)
    handle.close()
    return rows, state


def _run_local(cfg, tc, weights, batches):
    state = _state(cfg, tc, weights)
    rows = []
    for b in batches:
        state, m = train_step(cfg, tc, state, b)
        rows.append((float(m["loss"]), float(m["grad_norm"])))
    return rows, state


def _bars(rows, params, want_rows, want_params) -> list[str]:
    """What misses the bars: each step's loss within RTOL, the grad norm
    within RTOL at step 0 and GNORM_DRIFT after, every parameter within 3 x
    lr (`want_params`: "/"-joined path -> array)."""
    out = []
    for i, (row, want) in enumerate(zip(rows, want_rows)):
        for k, tol in ((0, RTOL), (1, RTOL if i == 0 else GNORM_DRIFT)):
            if abs(row[k] - want[k]) > tol * abs(want[k]):
                out.append(f"step {i} {('loss', 'grad norm')[k]} {row[k]} vs {want[k]}")

    def one(path, t):
        err = float(np.abs(t.numpy() - want_params["/".join(path)]).max())
        if err > 3 * LR:
            out.append(f"{'/'.join(path)} off by {err}")

    tree_map(one, params)
    return out


# ---------------------------------------------------------------------------
# the port alone (first: the JAX processes compile meanwhile)
# ---------------------------------------------------------------------------

def test_moe_capacity_drops_pairs():
    """At capacity factor 1.0 the reduced moe drops routed pairs in every
    layer of the first step's forward: the kept set, and with it the
    global positions, decide the output."""
    cfg = _cfg("moe")
    params = convert.model_params_from_numpy(cfg, _weights(cfg), CPU)
    x = T._embed(cfg, params, torch.as_tensor(_batches(cfg, steps=1)[0]["tokens"]))
    *_, keep, capacity = L.scatter_slots(cfg, tree_map(lambda _, t: t[0], params["blocks"])["moe"],
                                         x)
    assert capacity == 16 and 0 < int((~keep).sum()) < keep.numel() // 2


GRAD_RTOL = 1e-3  # a leaf's float32 gradient, summed in another order (~1e-5 seen)


@pytest.mark.parametrize("family,shape", [(f, s) for f, s in CASES if s != (4, 1)])
def test_each_leaf_gradient_matches_the_unsharded(grid, references, family, shape):
    """One step of SGD momentum at lr 1 (no warmup, decay or clipping)
    moves each leaf by its gradient: every leaf's change within GRAD_RTOL
    (relative norm) of the unsharded step's, remat "full". AdamW's
    sign-like first step and the global norm would not show a leaf whose
    gradient misses a small term (a model-axis sum left out, a head
    sliced wrong)."""
    reference = references[family]
    cfg = dataclasses.replace(reference.cfg, remat="full")
    tc = TrainConfig(optimizer=AdamConfig(kind="sgdm", lr=1.0, warmup_steps=0,
                                          weight_decay=0.0, grad_clip=1e9))
    batches = reference.batches[:1]
    _, state = _run_sharded(grid(shape), cfg, tc, reference.weights, batches)
    _, local = _run_local(cfg, tc, reference.weights, batches)
    w0 = _flat(reference.weights)

    def rel(path, a, b):
        start = torch.from_numpy(w0["/".join(path)])
        return float((a - b).norm() / (b - start).norm())

    errs = _flat(tree_map(rel, state["params"], local["params"]))
    assert max(errs.values()) < GRAD_RTOL, {k: v for k, v in errs.items() if v >= GRAD_RTOL}


@pytest.mark.parametrize("family", list(ARCHS))
def test_global_norm_counts_each_element_once(family):
    """Each rank's share of the sum of squares (its blocks; a leaf
    replicated over an axis on that axis' rank 0 only: the gated norm,
    ``dt_bias``, ``A_log``, ``D``, the router), summed over a (2, 2) mesh,
    is the unsharded sum; counting every rank's copy would not be."""
    cfg = _cfg(family)
    mesh_shape = {"data": 2, "model": 2}
    _, spec = SH.state_layout(cfg, _tc(), mesh_shape)
    grads = tree_map(lambda _, a: torch.tensor(a), _weights(cfg, seed=5))
    want = sum_of_squares(grads)
    total = over = torch.zeros(())
    for r in range(4):
        coord = dict(zip(("data", "model"), TMesh.grid_coords(r, (2, 2))))
        blocks = tree_map(lambda _, g, sp: g[shard_index(sp, g.shape, coord, mesh_shape)],
                          grads, spec["params"])
        counted = tree_map(lambda _, sp: SH._counted(sp, coord), spec["params"])
        total = total + shard_sum_of_squares(blocks, counted)
        over = over + shard_sum_of_squares(blocks, tree_map(lambda _, sp: True, spec["params"]))
    np.testing.assert_allclose(float(total), float(want), rtol=1e-6)
    assert float(over) > float(want) * (1 + 1e-4)


@pytest.mark.parametrize("family", list(ARCHS))
def test_two_runs_are_bit_equal(grid, references, family):
    """The sharded step twice from the same state on (2, 2): the same bits
    (every collective reduces in rank order)."""
    reference = references[family]
    mesh = grid((2, 2))
    runs = [_run_sharded(mesh, reference.cfg, _tc(), reference.weights, reference.batches[:2])
            for _ in range(2)]
    assert [r[:2] for r in runs[0][0]] == [r[:2] for r in runs[1][0]]
    for a, b in zip(tree_leaves(runs[0][1]), tree_leaves(runs[1][1])):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# planted faults: jobs that patch the port inside each rank
# ---------------------------------------------------------------------------

_SAVED: dict = {}


def _faulty_shared_full(cfg, params, positions):
    """The hybrid's shared block gathered at each use, each use's gradient
    reduce-scattered on its own, and only the last use's kept: the sum
    over the uses left out."""
    grid = L.current_grid()
    last = T._n_shared(cfg) - 1

    def apply(ai, x):
        leaves = params["shared_attn"] if ai == last else tree_map(
            lambda _, t: t.detach(), params["shared_attn"])
        p = grid.gather_layer(leaves, grid.specs["shared_attn"], stacked=False)
        return T._dense_block(cfg, p, x, positions, None, None, gather=False)[0]

    return apply


_FAULTS = {
    # every data rank counts its positions from 0
    "moe": [(L, "_routed_before", lambda grid, counts: torch.zeros_like(counts))],
    # B, C and dt keep each model rank's share of their gradients; dt_bias too
    "ssm": [(SSM, "_whole_grad", lambda grid, t: t.float()),
            (SSM, "GRID_PARTIAL", tuple(n for n in SSM.GRID_PARTIAL if n != "dt_bias"))],
    "hybrid": [(T, "_shared_full", _faulty_shared_full)],
}


def _plant(me, family):
    """A rank job: patch the port in this worker with `family`'s fault."""
    del me
    for mod, name, value in _FAULTS[family]:
        _SAVED[name] = (mod, getattr(mod, name))
        setattr(mod, name, value)


def _unplant(me, _):
    """A rank job: undo ``_plant``."""
    del me
    for name, (mod, value) in _SAVED.items():
        setattr(mod, name, value)
    _SAVED.clear()


@pytest.mark.parametrize("family", list(ARCHS))
def test_planted_fault_misses_the_bars(grid, references, family):
    """The fault, planted in every rank of a (2, 2) mesh, puts the sharded
    step outside the bars that the sound step meets (the unsharded step's
    losses, grad norms and parameters); the ranks are sound again after."""
    reference = references[family]
    cfg, tc = reference.cfg, _tc()
    mesh = grid((2, 2))
    local_rows, local = _run_local(cfg, tc, reference.weights, reference.batches)
    mesh.run(_plant, [family] * mesh.n)
    try:
        rows, state = _run_sharded(mesh, cfg, tc, reference.weights, reference.batches)
    except RuntimeError as e:  # the ranks' losses or grad norms disagree
        missed = [str(e)]
    else:
        missed = _bars(rows, state["params"], local_rows, _flat(local["params"]))
    finally:
        mesh.run(_unplant, [None] * mesh.n)
    assert missed, f"the {family} fault met every bar"
    rows, state = _run_sharded(mesh, cfg, tc, reference.weights, reference.batches)
    assert _bars(rows, state["params"], local_rows, _flat(local["params"])) == []


# ---------------------------------------------------------------------------
# the launcher's --mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", list(ARCHS))
def test_launcher_mesh_trains_the_family(grid, monkeypatch, tmp_path, family):
    """``launch.train --mesh single`` on a 2 x 2 ``make_test_mesh`` (in the
    production mesh's place: one CPU has not its 256 devices) trains the
    reduced config as the unsharded launcher does: the final checkpoints'
    params within 2 x steps x lr (the launcher's bf16 compute)."""
    monkeypatch.setattr(TMesh, "make_production_mesh", lambda multi_pod=False: grid((2, 2)))
    steps, lr = 3, 3e-4
    flags = ["--arch", ARCHS[family], "--reduced", "--device", "cpu", "--steps", str(steps),
             "--batch", "4", "--seq", "16", "--lr", str(lr), "--ckpt-every", "0"]
    sharded = launcher.run(launcher.parse_args(
        flags + ["--mesh", "single", "--ckpt-dir", str(tmp_path / "mesh")]))
    whole = launcher.run(launcher.parse_args(flags + ["--ckpt-dir", str(tmp_path / "none")]))
    assert int(sharded["step"]) == int(whole["step"]) == steps
    tree_map(lambda p, a, b: np.testing.assert_allclose(
        a.float().numpy(), b.float().numpy(), rtol=0, atol=2 * steps * lr, err_msg="/".join(p)),
        sharded["params"], whole["params"])


def test_chip_smoke_fsdp_families_phase_on_cpu(monkeypatch):
    """chip_smoke's --fsdp and --fsdp-families phases at a tiny size, as one
    table of archs: the reduced configs in float32 (the moe at capacity
    1.0, so pairs drop) with remat "full" (the recompute re-issues the
    forward's collectives), B = 4, S = 64, the phases' step counts, on one
    2 x 2 mesh of CPU ranks: initial blocks bit-equal, no launch on the
    CPU, every rank's bytes the closed form, the loss, grad-norm and change
    bars, each planted fault past the change bar, zamba2's one-step
    gradient check, the mesh closed with no worker left."""
    import chip_smoke

    def setup(arch, layers, **over):
        del over  # float32: the gradient check's bf16 run is its float32 one here
        cfg = get_reduced(arch)
        cap = {"capacity_factor": CAPACITY} if cfg.family == "moe" else {}
        cfg = dataclasses.replace(cfg, n_layers=layers, remat="full",
                                  compute_dtype=torch.float32, **cap)
        return cfg, TrainConfig()

    monkeypatch.setattr(chip_smoke, "fsdp_family_setup", setup)
    table = {**chip_smoke.FSDP_DENSE, **chip_smoke.FSDP_FAMILIES}
    depths = {"gemma2-2b": 2, "mamba2-1.3b": 2, "zamba2-1.2b": 4, "qwen2-moe-a2.7b": 1}
    out = chip_smoke.fsdp_run(CPU, {a: (d, *table[a][1:]) for a, d in depths.items()},
                              b=4, s=64)
    fams = out["families"]
    assert list(fams) == list(depths)
    faults = {a for a, (_, _, fault) in table.items() if fault}
    assert {a for a, v in fams.items() if "fault" in v} == faults == {
        "gemma2-2b", "mamba2-1.3b", "qwen2-moe-a2.7b"}
    assert all(fams[a]["fault"]["worst_change_rel"] > chip_smoke.FSDP_CHANGE_REL for a in faults)
    assert [a for a, v in fams.items() if "grad_check" in v] == list(chip_smoke.FSDP_GRAD_CHECK)
    assert fams["zamba2-1.2b"]["grad_check"]["worst_share_of_bar"] < 1
    assert out["launches"] == dict.fromkeys(chip_smoke.FSDP_KERNELS, 0)
    assert [len(v["rows"]) for v in fams.values()] == [table[a][1] for a in depths]


# ---------------------------------------------------------------------------
# against the JAX package: layouts and the step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family,shape", CASES)
def test_shard_slices_match_jax(grid, references, family, shape):
    """Rank r holds the slice of every state leaf that JAX gives device r
    (experts, ssm_inner and the shared block over "model", embed over
    "data")."""
    ref = references[family].result()
    tag = "x".join(map(str, shape))
    mesh = grid(shape)
    cfg, tc = references[family].cfg, _tc()
    sds, spec = SH.state_layout(cfg, tc, mesh.mesh_shape)
    checked = 0

    def one(path, sd, sp):
        nonlocal checked
        idx = ref[f"{tag}/idx/" + "/".join(path)]
        for r in range(mesh.n):
            sl = shard_index(sp, sd.shape, mesh.coords(r), mesh.mesh_shape)
            want = tuple(slice(None) if a == -1 else slice(int(a), int(b))
                         for a, b in idx[r][:len(sd.shape)])
            assert sl == want, ("/".join(path), r, sl, want)
            checked += 1

    tree_map(one, {k: sds[k] for k in ("params", "opt")}, {k: spec[k] for k in ("params", "opt")})
    assert checked == mesh.n * 3 * len(tree_leaves(T.model_defs(cfg)))
    assert int(ref[f"{tag}/route"]) == 0


@pytest.mark.parametrize("family,shape", CASES)
def test_sharded_step_matches_jax_and_the_unsharded_step(grid, references, family, shape):
    """Three steps on each mesh against the JAX sharded step, JAX's
    unsharded jit and the port's unsharded train_step; every rank's bytes
    equal to the closed form."""
    reference = references[family]
    ref = reference.result()
    tag = "x".join(map(str, shape))
    cfg, tc = reference.cfg, _tc()
    mesh = grid(shape)
    rows, state = _run_sharded(mesh, cfg, tc, reference.weights, reference.batches)
    local_rows, local = _run_local(cfg, tc, reference.weights, reference.batches)
    closed = SH.expected_sent_bytes(cfg, tc, mesh.mesh_shape, B, SEQ)
    assert all(r[2] == [closed] * mesh.n for r in rows), ([r[2] for r in rows], closed)
    assert int(state["step"]) == STEPS
    for want_tag in (tag, "jit"):
        want_rows = list(zip(ref[f"{want_tag}/loss"], ref[f"{want_tag}/gnorm"]))
        want_params = {k[len(want_tag) + 3:]: v for k, v in ref.items()
                       if k.startswith(f"{want_tag}/p/")}
        assert _bars(rows, state["params"], want_rows, want_params) == []
    assert _bars(rows, state["params"], local_rows, _flat(local["params"])) == []
