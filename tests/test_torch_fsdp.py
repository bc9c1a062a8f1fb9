"""The within-pod FSDP x TP train step (``repro_torch.train.sharded``, on the
ranks of a ``launch.mesh.GridMesh``) against the JAX package, and the
mesh's bounded pipe messages.

The JAX package's ``make_jitted_train_step`` runs on a host mesh in a fresh
process with 4 forced host devices (``_REFERENCE``, started when the
module starts and read when a test needs it), on the devices of its
``make_test_mesh`` with Auto axes (with this jax the test mesh's axes are
Explicit, on which the reference's own gathers fail): from one set of numpy
weights and the same ``batch_at`` batches it records, for meshes (2, 2),
(1, 4) and (4, 1), the mesh's device grid, every state leaf's
``addressable_shards[k].index`` and three steps of the sharded step, and
three steps of the unsharded ``jax.jit(train_step)``. On (1, 4) reduced
gemma2-2b's 2 kv heads do not split over 4 model ranks, which the JAX
``make_jitted_train_step`` refuses; there the reference is the same jit
with the JAX ``shardable_pspecs`` applied (the port's layout). The port's
sharded step runs on the same meshes of CPU ranks (gloo).

Sizes: reduced gemma2-2b (2 layers, d_model 64, 4/2 heads of 16, d_ff 128,
vocab 256) and reduced minitron-8b, float32 compute, B = 4, S = 16, AdamW
lr 1e-3 with one warmup step. Bars, each with its reason:
  * the layouts (pspecs, shard slices, device order): equal;
  * three steps against either JAX step: losses and grad norms rtol 1e-5
    (float32, summed in other orders), every parameter within 3 x lr (the
    most an element can move in three steps: ``test_torch_train.py``'s
    bar for the unsharded step);
  * the same against the port's unsharded ``train_step``;
  * two runs of the sharded step: bit-equal (every collective reduces in
    rank order);
  * the bytes each rank sends: equal to ``expected_sent_bytes``'s closed
    form;
  * the masked loss: the global token mean (1e-5 against the unsharded
    step at every step; the grad norm at the first step, where both hold
    the same parameters), never a mean of the data shards' means;
  * pipe pieces: bit-equal after a round trip cut into 64 KiB pieces.

Every mesh comes from the registry, is built with 64 KiB pipe pieces (so
every reply of this module crosses in pieces) and is closed at the
module's end; torch runs on one thread (ROADMAP Queue 3).
"""
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.models import params as JP
from repro.models import transformer as JT
from repro.train import step as JS
from repro_torch.configs import get_reduced
from repro_torch.core import gossip as G
from repro_torch.data.sharded_loader import LoaderConfig, batch_at
from repro_torch.launch import mesh as TMesh
from repro_torch.launch import train as launcher
from repro_torch.models import transformer as T
from repro_torch.models.params import (
    P, TensorSpec, shard_index, shardable_pspecs, tree_leaves, tree_map,
)
from repro_torch.optim.adam import AdamConfig, adam_init, shard_sum_of_squares, sum_of_squares
from repro_torch.train import sharded as SH
from repro_torch.train import step as S
from repro_torch.train.step import TrainConfig, init_train_state, train_step

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
SHAPES = [(2, 2), (1, 4), (4, 1)]
LR = 1e-3
B, SEQ, STEPS = 4, 16, 3
RTOL = 1e-5
PIECE = 1 << 16  # the pipe pieces of this module's meshes


@pytest.fixture(autouse=True)
def one_torch_thread():
    """torch's CPU threads are unsteady beside JAX (ROADMAP Queue 3)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(arch="gemma2-2b", **kw):
    return dataclasses.replace(get_reduced(arch), compute_dtype=torch.float32, **kw)


def _tc(**kw):
    return TrainConfig(optimizer=AdamConfig(lr=LR, warmup_steps=1), **kw)


def _weights(cfg, seed=0) -> dict:
    """Float32 numpy weights of `cfg` (ParamDef's init, numpy's normals)."""
    rng = np.random.default_rng(seed)

    def one(_, d):
        if d.init == "zeros":
            return np.zeros(d.shape, np.float32)
        if d.init == "ones":
            return np.ones(d.shape, np.float32)
        return (d.stddev * rng.standard_normal(d.shape)).astype(np.float32)

    return tree_map(one, T.model_defs(cfg))


def _state(cfg, tc, weights) -> dict:
    params = tree_map(lambda _, a: torch.tensor(a), weights)
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
# the JAX reference, in a process of its own with 4 host devices
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
                          attention_kernel="jnp")
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
    res[f"{tag}/devices"] = np.array([[d.id for d in row]
                                      for row in make_test_mesh(tuple(shape)).devices])
    # make_test_mesh's axes are Explicit here, on which the reference's
    # gathers cannot resolve their sharding: the same devices, Auto axes
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
    """The JAX reference process (started at once, read on first use)."""

    def __init__(self, arch="gemma2-2b"):
        self.dir = tempfile.mkdtemp(prefix="fsdp_ref_")
        self.cfg = _cfg(arch)
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
        args = {"arch": arch, "lr": LR, "steps": STEPS, "shapes": SHAPES}
        self.proc = subprocess.Popen(
            [sys.executable, "-c", _REFERENCE, src, self.out, json.dumps(args)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        self._res = None

    def result(self) -> dict:
        if self._res is None:
            out, err = self.proc.communicate(timeout=300)
            assert self.proc.returncode == 0, err[-4000:]
            self._res = dict(np.load(self.out))
        return self._res


@pytest.fixture(scope="module", autouse=True)
def reference():
    ref = _Reference()
    yield ref
    if ref.proc.poll() is None:
        ref.proc.kill()
        ref.proc.wait()


@pytest.fixture(scope="module")
def grid():
    """shape -> the registry's CPU mesh of that shape, its workers replying
    in 64 KiB pieces; every mesh closed at the module's end, none of their
    workers outliving it."""
    def get(shape):
        old = TMesh.PIPE_PIECE_BYTES
        TMesh.PIPE_PIECE_BYTES = PIECE
        try:
            return TMesh.make_test_mesh(shape, device=CPU)
        finally:
            TMesh.PIPE_PIECE_BYTES = old

    yield get
    procs = [p for m in TMesh._MESHES.values() for p in m._procs]
    TMesh.close_all()
    assert not TMesh._MESHES
    assert not any(p.is_alive() for p in procs)


def _run_sharded(mesh, cfg, tc, weights, batches):
    """(rows of (loss, grad_norm, sent bytes a rank), the gathered state)."""
    handle = SH.shard_train_state(mesh, cfg, tc, _state(cfg, tc, weights))
    step = S.make_jitted_train_step(mesh, cfg, tc)
    rows = []
    for b in batches:
        handle, m = step(handle, b)
        rows.append((float(m["loss"]), float(m["grad_norm"]), m["sent_bytes"]))
    state = SH.gather_train_state(handle, CPU)
    handle.close()
    return rows, state


def _close_params(mine, ref: dict, tag: str, atol: float) -> None:
    def one(path, t):
        want = ref[f"{tag}/p/" + "/".join(path)]
        np.testing.assert_allclose(t.numpy(), want, rtol=0, atol=atol, err_msg="/".join(path))

    tree_map(one, mine)


# ---------------------------------------------------------------------------
# layouts
# ---------------------------------------------------------------------------

def _jax_cfg(arch):
    import jax.numpy as jnp

    return dataclasses.replace(jax_get_reduced(arch), compute_dtype=jnp.float32)


@pytest.mark.parametrize("arch", ["gemma2-2b", "minitron-8b", "qwen2-moe-a2.7b", "mamba2-1.3b",
                                  "zamba2-1.2b"])
def test_state_defs_and_batch_specs_match_jax(arch):
    """make_train_state_defs' pspec tree leaf for leaf, its shapes, and the
    batch's specs and TensorSpecs, against the JAX functions."""
    cfg, jcfg = _cfg(arch), _jax_cfg(arch)
    tc = TrainConfig()
    sds, spec = S.make_train_state_defs(cfg, tc)
    jsds, jspec = JS.make_train_state_defs(jcfg, JS.TrainConfig())
    mine = _flat(tree_map(lambda _, s: tuple(s), spec))
    import jax

    theirs = {"/".join(str(getattr(k, "key", k)) for k in path): tuple(s)
              for path, s in jax.tree_util.tree_leaves_with_path(
                  jspec, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))}
    assert {k: tuple(v) for k, v in mine.items()} == theirs
    theirs_shapes = {"/".join(str(getattr(k, "key", k)) for k in path): tuple(s.shape)
                     for path, s in jax.tree_util.tree_leaves_with_path(jsds)}
    assert _flat(tree_map(lambda _, s: np.empty(0), sds)).keys() == theirs_shapes.keys()
    got_shapes = {}
    tree_map(lambda p, s: got_shapes.__setitem__("/".join(p), tuple(s.shape)), sds)
    assert got_shapes == theirs_shapes
    assert sds["params"]["embed"].dtype == cfg.param_dtype and spec["step"] == P() == ()
    jb = JS.batch_specs(jcfg, JS.TrainConfig())
    assert {k: tuple(v) for k, v in S.batch_specs(cfg, tc).items()} == {
        k: tuple(v) for k, v in jb.items()}
    bsds = S.batch_sds(cfg, 8, 32)
    jbs = JS.batch_sds(jcfg, 8, 32)
    assert {k: tuple(v.shape) for k, v in bsds.items()} == {
        k: tuple(v.shape) for k, v in jbs.items()}
    assert bsds["tokens"] == TensorSpec((8, 32), torch.int32)
    assert TrainConfig().batch_axes == JS.TrainConfig().batch_axes == ("data",)


@pytest.mark.parametrize("mesh_shape", [{"data": 2, "model": 4}, {"data": 16, "model": 16},
                                        {"data": 3, "model": 5}])
def test_shardable_pspecs_drop_as_jax_does(mesh_shape):
    """Dropped axes (kv heads on a wide model axis, a vocabulary that does
    not split) as the JAX ``shardable_pspecs`` drops them."""
    import jax

    cfg = _cfg("gemma2-2b", vocab_size=250)
    jcfg = dataclasses.replace(_jax_cfg("gemma2-2b"), vocab_size=250)
    sds, spec = S.make_train_state_defs(cfg, TrainConfig())
    jsds, jspec = JS.make_train_state_defs(jcfg, JS.TrainConfig())
    mine = shardable_pspecs(spec, sds, mesh_shape)
    theirs = JP.shardable_pspecs(jspec, jsds, types.SimpleNamespace(shape=mesh_shape))
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): tuple(s)
            for path, s in jax.tree_util.tree_leaves_with_path(
                theirs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))}
    assert {k: tuple(v) for k, v in _flat(tree_map(lambda _, s: s, mine)).items()} == flat
    if mesh_shape["model"] == 4:  # 2 kv heads, vocab 250: both left whole
        assert mine["params"]["blocks"]["attn"]["wk"] == (None, "data", None, None)
        assert mine["params"]["embed"] == (None, "data")


@pytest.mark.parametrize("shape", SHAPES)
def test_mesh_order_and_shard_slices_match_jax(grid, reference, shape):
    """Rank r sits where the JAX test mesh puts device r, and holds the
    slice of every state leaf that JAX gives that device."""
    ref = reference.result()
    tag = "x".join(map(str, shape))
    mesh = grid(shape)
    np.testing.assert_array_equal(mesh.devices, ref[f"{tag}/devices"])
    for r in range(mesh.n):
        assert mesh.coords(r) == dict(zip(("data", "model"), TMesh.grid_coords(r, shape)))
    cfg, tc = reference.cfg, _tc()
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


# ---------------------------------------------------------------------------
# the sharded step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES)
def test_sharded_step_matches_jax_and_the_unsharded_step(grid, reference, shape):
    """Three steps on each mesh against the JAX sharded step, JAX's
    unsharded jit and the port's unsharded train_step; the bytes each rank
    sent equal to the closed form."""
    ref = reference.result()
    tag = "x".join(map(str, shape))
    cfg, tc = reference.cfg, _tc()
    mesh = grid(shape)
    rows, state = _run_sharded(mesh, cfg, tc, reference.weights, reference.batches)
    local = _state(cfg, tc, reference.weights)
    local_rows = []
    for b in reference.batches:
        local, m = train_step(cfg, tc, local, b)
        local_rows.append((float(m["loss"]), float(m["grad_norm"])))
    closed = SH.expected_sent_bytes(cfg, tc, mesh.mesh_shape, B, SEQ)
    for i, (loss, gnorm, sent) in enumerate(rows):
        for want_loss, want_norm in ((ref[f"{tag}/loss"][i], ref[f"{tag}/gnorm"][i]),
                                     (ref["jit/loss"][i], ref["jit/gnorm"][i]), local_rows[i]):
            np.testing.assert_allclose(loss, want_loss, rtol=RTOL)
            np.testing.assert_allclose(gnorm, want_norm, rtol=RTOL)
        assert sent == [closed] * mesh.n
    assert int(state["step"]) == STEPS
    _close_params(state["params"], ref, tag, 3 * LR)
    _close_params(state["params"], ref, "jit", 3 * LR)
    tree_map(lambda p, a, b: np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                                        atol=3 * LR, err_msg="/".join(p)),
             state["params"], local["params"])
    if shape == (1, 4):  # 2 kv heads on 4 model ranks: left whole, JAX refuses them
        assert int(ref[f"{tag}/route"]) == 1
        assert SH.state_layout(cfg, tc, mesh.mesh_shape)[1]["params"]["blocks"]["attn"][
            "wk"] == (None, "data", None, None)


def test_two_runs_are_bit_equal_and_state_round_trips(grid, reference):
    """The sharded step twice from the same state: the same bits (every
    collective reduces in rank order); shard then gather is the identity."""
    cfg, tc = reference.cfg, _tc()
    mesh = grid((2, 2))
    whole = _state(cfg, tc, reference.weights)
    handle = SH.shard_train_state(mesh, cfg, tc, whole)
    back = SH.gather_train_state(handle, CPU)
    handle.close()
    tree_map(lambda p, a, b: torch.equal(a, b) or pytest.fail("/".join(p)),
             {k: back[k] for k in ("params", "opt")}, {k: whole[k] for k in ("params", "opt")})
    runs = [_run_sharded(mesh, cfg, tc, reference.weights, reference.batches[:2])
            for _ in range(2)]
    assert [r[:2] for r in runs[0][0]] == [r[:2] for r in runs[1][0]]
    for a, b in zip(tree_leaves(runs[0][1]), tree_leaves(runs[1][1])):
        assert torch.equal(a, b)


def test_masked_loss_is_the_global_token_mean(grid, reference):
    """A mask with a different count on each data shard: the sharded loss
    and update are the unsharded step's (the global token mean), with one
    and with two microbatches (microbatch m is the global rows block m)."""
    cfg = reference.cfg
    mesh = grid((2, 2))
    rng = np.random.default_rng(7)
    mask = (rng.random((B, SEQ)) < np.array([[0.9], [0.2], [0.6], [0.1]])).astype(np.float32)
    batches = [dict(b, mask=mask) for b in reference.batches[:2]]
    shard_means = [mask[i:i + 2].sum() for i in (0, 2)]
    assert shard_means[0] != shard_means[1]
    for mb in (1, 2):
        tc = _tc(microbatches=mb)
        rows, state = _run_sharded(mesh, cfg, tc, reference.weights, batches)
        local = _state(cfg, tc, reference.weights)
        for i, b in enumerate(batches):
            local, m = train_step(cfg, tc, local, b)
            np.testing.assert_allclose(rows[i][0], float(m["loss"]), rtol=RTOL)
            if i == 0:  # the same parameters: the same gradient (after a step,
                # Adam divides the rounding differences by small moments)
                np.testing.assert_allclose(rows[i][1], float(m["grad_norm"]), rtol=RTOL)
            assert rows[i][2] == [SH.expected_sent_bytes(cfg, tc, mesh.mesh_shape, B, SEQ,
                                                         mask=True)] * mesh.n
        tree_map(lambda p, a, b: np.testing.assert_allclose(
            a.numpy(), b.numpy(), rtol=0, atol=2 * LR, err_msg="/".join(p)),
            state["params"], local["params"])


def test_minitron_remat_dots_on_a_grid(grid, reference):
    """An untied head (lm_head over ("data", "model")) and remat "dots":
    the recompute re-issues the forward's collectives on every rank."""
    cfg = _cfg("minitron-8b", remat="dots")
    tc = _tc()
    weights = _weights(cfg, seed=1)
    batches = _batches(cfg, steps=2)
    mesh = grid((2, 2))
    rows, state = _run_sharded(mesh, cfg, tc, weights, batches)
    local = _state(cfg, tc, weights)
    for i, b in enumerate(batches):
        local, m = train_step(cfg, tc, local, b)
        np.testing.assert_allclose(rows[i][0], float(m["loss"]), rtol=RTOL)
        if i == 0:
            np.testing.assert_allclose(rows[i][1], float(m["grad_norm"]), rtol=RTOL)
        assert rows[i][2] == [SH.expected_sent_bytes(cfg, tc, mesh.mesh_shape, B, SEQ)] * 4
    tree_map(lambda p, a, b: np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                                        atol=2 * LR, err_msg="/".join(p)),
             state["params"], local["params"])


def test_global_norm_counts_each_element_once():
    """Each rank's share (its blocks, a replicated leaf on the axis' rank 0
    only), summed over the mesh, is the unsharded sum of squares; counting
    every rank's copy of the norm scales would not be."""
    cfg = _cfg()
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


def test_non_dense_families_and_other_layouts_raise():
    """What the within-pod step has no layout for raises, naming item 10:
    the encdec family, the grouped MoE route, and heads, experts, ssm heads
    or units that do not split over the model axis. The moe, ssm and hybrid
    families have layouts (``test_torch_fsdp_families.py``)."""
    mesh = types.SimpleNamespace(mesh_shape={"data": 2, "model": 2}, device=CPU)
    cfg = get_reduced("whisper-small")
    with pytest.raises(NotImplementedError, match="encdec.*Queue 1 item 10"):
        S.make_jitted_train_step(mesh, cfg, TrainConfig())
    with pytest.raises(NotImplementedError, match="encdec.*Queue 1 item 10"):
        init_train_state(cfg, TrainConfig(), 0, mesh=mesh)
    for arch in ("qwen2-moe-a2.7b", "mamba2-1.3b", "zamba2-1.2b"):
        SH.check_layout(get_reduced(arch), TrainConfig(), mesh.mesh_shape)
    moe = get_reduced("qwen2-moe-a2.7b")  # 8 experts, 4 heads, 64 shared-expert units
    hybrid = get_reduced("zamba2-1.2b")  # 4 heads, 8 ssm heads
    m4, m8 = {"data": 1, "model": 4}, {"data": 1, "model": 8}
    for cfg, shape, what in (
            (dataclasses.replace(moe, moe_groups=2), mesh.mesh_shape, "grouped MoE route"),
            (dataclasses.replace(moe, n_experts=6), {"data": 2, "model": 4}, "6 experts"),
            (dataclasses.replace(moe, shared_expert_d_ff=66), m4, "66 shared expert units"),
            # vocab 256 splits over 16
            (get_reduced("mamba2-1.3b"), {"data": 1, "model": 16}, "8 ssm heads"),
            (dataclasses.replace(hybrid, ssm_head_dim=32), m8, "4 heads"),
            (dataclasses.replace(hybrid, n_heads=8, n_kv_heads=8, head_dim=8, d_ff=256,
                                 ssm_head_dim=32), m8, "4 ssm heads")):
        with pytest.raises(NotImplementedError, match=f"{what}.*Queue 1 item 10"):
            S.make_jitted_train_step(types.SimpleNamespace(mesh_shape=shape, device=CPU), cfg,
                                     TrainConfig())
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        S.make_jitted_train_step(mesh, _cfg(n_heads=3, n_kv_heads=1), TrainConfig())
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        S.make_jitted_train_step(mesh, _cfg(), TrainConfig(batch_axes=("pod", "data")))
    pod = types.SimpleNamespace(mesh_shape={"pod": 2, "data": 2, "model": 2}, device=CPU)
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        S.make_jitted_train_step(pod, _cfg(), TrainConfig())


def test_production_mesh_raises_the_reference_error():
    """One device (the CPU here) is far from 256 or 512: the JAX package's
    ValueError, from the function and from the launcher's --mesh."""
    with pytest.raises(ValueError, match="needs 256 devices"):
        TMesh.make_production_mesh()
    with pytest.raises(ValueError, match="needs 512 devices"):
        TMesh.make_production_mesh(multi_pod=True)
    with pytest.raises(ValueError, match="needs 256 devices"):
        launcher.run(launcher.parse_args(["--reduced", "--device", "cpu", "--mesh", "single"]))


# ---------------------------------------------------------------------------
# the mesh's pipes: bounded pieces
# ---------------------------------------------------------------------------

def test_job_and_reply_in_many_pieces_survive(grid, monkeypatch):
    """A job and its reply, each cut into many 64 KiB pieces both ways:
    arrays (out of band, one of 1.2 MB), an empty one, bfloat16 bits and a
    large in-band list, bit-equal after the round trip."""
    mesh = grid((2, 2))
    monkeypatch.setattr(TMesh, "PIPE_PIECE_BYTES", PIECE)
    rng = np.random.default_rng(0)
    job = {"a": rng.standard_normal(300_000).astype(np.float32),
           "b": TMesh.to_host(torch.randn(7, 1000, dtype=torch.bfloat16)),
           "e": np.zeros((0, 3)), "l": list(range(40_000)), "s": "text"}
    out = mesh.run(TMesh.echo, [job] * mesh.n)
    for o in out:
        assert o["a"].tobytes() == job["a"].tobytes() and o["l"] == job["l"]
        assert o["b"][1] and o["b"][0].tobytes() == job["b"][0].tobytes()
        assert o["e"].shape == (0, 3) and o["s"] == "text"
    assert job["a"].nbytes > 16 * PIECE


def test_gathers_of_multi_piece_states_are_bit_equal(grid, monkeypatch):
    """gather_gossip_state and gather_train_state of states whose leaves
    span several 64 KiB pieces (an embedding of 256 KiB) come back bit for
    bit."""
    monkeypatch.setattr(TMesh, "PIPE_PIECE_BYTES", PIECE)
    cfg = _cfg("gemma2-2b", vocab_size=1024)
    tc = _tc()
    assert 4 * cfg.vocab_size * cfg.d_model > 3 * PIECE
    mesh = grid((2, 2))
    whole = _state(cfg, tc, _weights(cfg, seed=2))
    handle = SH.shard_train_state(mesh, cfg, tc, whole)
    back = SH.gather_train_state(handle, CPU)
    handle.close()
    for a, b in zip(tree_leaves({k: back[k] for k in ("params", "opt")}),
                    tree_leaves({k: whole[k] for k in ("params", "opt")})):
        assert torch.equal(a, b)
    gc = G.GossipConfig(n_pods=2)
    pods = TMesh.NodeMesh(2, CPU)
    try:
        local = G.init_gossip_state(cfg, tc, gc, 0, CPU)
        handle = G.scatter_gossip_state(pods, gc, local)
        got = G.gather_gossip_state(handle, CPU)
        for a, b in zip(tree_leaves(got), tree_leaves(local)):
            assert torch.equal(a, b)
    finally:
        pods.close()
