"""The within-pod sharded train step over the ranks of a
``launch.mesh.GridMesh`` (the JAX ``make_jitted_train_step``'s pjit program:
FSDP over "data" x TP over "model", the batch's rows over "data").

The state lives in the ranks: rank r (data r // M, model r % M) holds its
block of every parameter and moment, laid out by ``state_layout`` (the JAX
``make_train_state_defs`` specs with the axes that do not divide a
dimension dropped, as ``shardable_pspecs`` drops them), under a
``RankTrainState`` handle's token; the parent holds only the handle.

A step computes the unsharded ``train_step``'s function; only the layout
and the order of the sums differ. On each rank, under
``layers.use_constraint_mesh``: the forward and backward of the model on
the rank's rows and share (``models.layers``, ``models.transformer``: each
layer's leaves gathered over "data" where used, their gradients
reduce-scattered back; heads, MLP units, experts, Mamba2 heads and the
vocabulary split over "model"), ``ce_loss``'s share of the global token
mean, the gradients of leaves replicated over "data" (the norm scales)
all-reduced over it, those of the leaves every model rank holds whole but
reads in part (``models.ssm.GRID_PARTIAL``) summed over "model", the
global gradient norm from the blocks (each element counted once,
``optim.adam.shard_sum_of_squares``), then AdamW on the blocks. Data shard
i takes the contiguous rows [i B / D, (i + 1) B / D) (with microbatches,
block i of every microbatch: microbatch m is the global rows block m, as
in the JAX ``local_grads``). Every collective reduces in rank order
(``train.collectives``), so two runs give the same bits.

The dense, moe, ssm and hybrid families have a layout here; heads, MLP
units, experts, the shared expert's units, Mamba2 heads and the
vocabulary must split over "model" (kv heads may not: they stay whole).
The rest (the encdec family, the grouped MoE route, a replicated layout of
what does not split) raises ``NotImplementedError`` naming ROADMAP Queue 1
item 10.

Crossing the pipes (in pieces, ``launch.mesh``): ``shard_train_state`` and
``gather_train_state`` move a whole state; ``shard_diffs`` holds the ranks'
blocks to whole leaves saved as ``.npy`` files, reading only each rank's
block, so a full-width state is checked without crossing a pipe.
"""
from __future__ import annotations

import contextlib
import itertools
import math
import time

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.launch.mesh import from_host, to_host
from repro_torch.models import layers as L
from repro_torch.models import ssm as SSM
from repro_torch.models import transformer as T
from repro_torch.models.params import shard_index, shardable_pspecs, tree_map
from repro_torch.optim.adam import adam_init, adam_update, shard_sum_of_squares
from repro_torch.train import step as S
from repro_torch.train.collectives import KINDS, Grid

MESH_AXES = ("data", "model")
_TOKENS = itertools.count(1)


def state_layout(cfg, tc, mesh_shape: dict) -> tuple[dict, dict]:
    """(TensorSpec tree, PartitionSpec tree) of the train state on a mesh
    of `mesh_shape` ({axis: size}): ``make_train_state_defs`` with the axes
    that do not divide their dimension dropped."""
    sds, spec = S.make_train_state_defs(cfg, tc)
    return sds, shardable_pspecs(spec, sds, mesh_shape)


def check_layout(cfg, tc, mesh_shape: dict) -> None:
    """Raise ``NotImplementedError`` unless the step has a layout for `cfg`
    on a mesh of `mesh_shape`."""
    T.check_grid_family(cfg)
    if set(mesh_shape) != set(MESH_AXES):
        raise NotImplementedError(
            f"the within-pod step runs on a ('data', 'model') mesh, not {tuple(mesh_shape)} "
            "(the 'pod' axis: ROADMAP Queue 1 item 10)")
    if tuple(tc.batch_axes) != ("data",):
        raise NotImplementedError(
            f"batch_axes {tc.batch_axes}: the within-pod step splits the batch over 'data' "
            "only (ROADMAP Queue 1 item 10)")
    if cfg.family == "moe" and cfg.moe_groups > 0:
        raise NotImplementedError(
            f"moe_groups={cfg.moe_groups}: the grouped MoE route has no layout under a grid "
            "(ROADMAP Queue 1 item 10)")
    m = mesh_shape["model"]
    split = [("vocabulary rows", cfg.vocab_size)]
    if cfg.family in ("dense", "moe", "hybrid"):
        split.append(("heads", cfg.n_heads))
    if cfg.family in ("dense", "hybrid"):
        split.append(("MLP units", cfg.d_ff))
    if cfg.family == "moe":
        split += [("experts", cfg.n_experts), ("shared expert units", cfg.shared_expert_d_ff)]
    if cfg.family in ("ssm", "hybrid"):
        split.append(("ssm heads", cfg.ssm_heads))
    for what, n in split:
        if n % m:
            raise NotImplementedError(
                f"{n} {what} do not split over {m} model ranks; a replicated layout of "
                "them is not ported (ROADMAP Queue 1 item 10)")


def _read_in_part(path) -> bool:
    """Whether leaf `path` is one every model rank holds whole but reads in
    part (``models.ssm.GRID_PARTIAL``): its gradient is summed over
    "model"."""
    return len(path) >= 2 and path[-2] == "ssm" and path[-1] in SSM.GRID_PARTIAL


def _counted(spec, coord: dict) -> bool:
    """Whether the rank at `coord` counts (or owns) a leaf of `spec`: rank 0
    of every mesh axis the leaf is replicated over."""
    split = {a for ax in spec if ax is not None
             for a in (ax if isinstance(ax, tuple) else (ax,))}
    return all(c == 0 for a, c in coord.items() if a not in split)


def _rows(n_rows: int, data: int, index: int, microbatches: int) -> np.ndarray:
    """The global rows data shard `index` of `data` takes: block `index` of
    each of the `microbatches` row blocks, in order."""
    if n_rows % (data * microbatches):
        raise ValueError(f"a batch of {n_rows} rows does not split into {microbatches} "
                         f"microbatches over {data} data ranks")
    per_mb, per = n_rows // microbatches, n_rows // (data * microbatches)
    return np.concatenate([np.arange(m * per_mb + index * per, m * per_mb + (index + 1) * per)
                           for m in range(microbatches)])


# ---------------------------------------------------------------------------
# the handle
# ---------------------------------------------------------------------------

class RankTrainState:
    """A train state held by the ranks of a ``GridMesh``: each keeps its
    blocks under this handle's token, across ``NodeMesh.run`` calls.
    ``close()`` frees them (so does closing the mesh);
    ``gather_train_state`` copies them back."""

    def __init__(self, mesh, cfg, tc):
        self.mesh, self.cfg, self.tc = mesh, cfg, tc
        self.token = next(_TOKENS)
        self.closed = False

    def close(self) -> None:
        """Free the ranks' blocks (and their cached device memory)."""
        if not self.closed and not self.mesh.closed:
            self.mesh.run(_rank_free, [self.token] * self.mesh.n)
        self.closed = True

    def _check(self, mesh=None) -> None:
        if self.closed or self.mesh.closed:
            raise ValueError("the train state is closed (or its mesh is)")
        if mesh is not None and mesh is not self.mesh:
            raise ValueError("the train state lives on another mesh than the step's")

    def __repr__(self) -> str:
        return (f"RankTrainState({self.mesh.mesh_shape}, token={self.token}, "
                f"closed={self.closed})")


def _check_mesh(mesh, cfg, tc, device=None) -> None:
    if not hasattr(mesh, "mesh_shape"):
        raise ValueError("the sharded step needs a GridMesh (launch.mesh.make_test_mesh)")
    if device is not None and torch.device(device).type != mesh.device.type:
        raise ValueError(f"the mesh runs on {mesh.device.type}, but device={device!r}")
    check_layout(cfg, tc, mesh.mesh_shape)
    if mesh.device.type == "cuda":  # the ranks load the libraries, never build them
        from repro_torch.kernels import _build

        _build.build_all()


def init_state(mesh, cfg, tc, seed: int = 0, device=None) -> RankTrainState:
    """A fresh state on the ranks of `mesh`: each rank draws the whole
    parameters from `seed` (``T.init_train_params``, the unsharded init's
    bits), keeps its blocks and frees the rest; zero moments."""
    _check_mesh(mesh, cfg, tc, device)
    handle = RankTrainState(mesh, cfg, tc)
    mesh.run(_rank_init, [{"token": handle.token, "cfg": cfg, "tc": tc, "seed": seed}]
             * mesh.n)
    return handle


def _blocks(tree, spec, coord, mesh_shape):
    """Host copies (``to_host``) of the blocks of a tree of whole tensors
    that the rank at `coord` holds."""
    return tree_map(lambda _, t, sp: to_host(t[shard_index(sp, t.shape, coord, mesh_shape)]),
                    tree, spec)


def shard_train_state(mesh, cfg, tc, state: dict) -> RankTrainState:
    """Place a whole train state (any device) on the ranks of `mesh`: each
    gets copies of its blocks. The inverse of ``gather_train_state``."""
    _check_mesh(mesh, cfg, tc)
    _, spec = state_layout(cfg, tc, mesh.mesh_shape)
    handle = RankTrainState(mesh, cfg, tc)
    whole = {k: state[k] for k in ("params", "opt")}
    jobs = [{"token": handle.token, "cfg": cfg, "tc": tc, "step": int(state["step"]),
             "state": _blocks(whole, {k: spec[k] for k in whole}, mesh.coords(r),
                              mesh.mesh_shape)}
            for r in range(mesh.n)]
    mesh.run(_rank_put, jobs)
    return handle


def gather_train_state(handle: RankTrainState, device=None) -> dict:
    """The whole train state of a rank-held one on `device` (the mesh's
    device type unless told otherwise): every leaf put together from the
    blocks of the ranks that own them."""
    handle._check()
    mesh = handle.mesh
    dev = resolve_device(mesh.device.type if device is None else device)
    sds, spec = state_layout(handle.cfg, handle.tc, mesh.mesh_shape)
    res = mesh.run(_rank_gather, [handle.token] * mesh.n)

    def one(path, sd, sp):
        out = torch.empty(sd.shape, dtype=sd.dtype)
        for r, part in enumerate(res):
            h = part["state"]
            for k in path:
                h = h[k]
            if h is not None:
                out[shard_index(sp, sd.shape, mesh.coords(r), mesh.mesh_shape)] = (
                    from_host(h, "cpu"))
        return out.to(dev)

    state = tree_map(one, {k: sds[k] for k in ("params", "opt")},
                     {k: spec[k] for k in ("params", "opt")})
    state["step"] = torch.tensor(res[0]["step"], dtype=torch.int32)
    return state


def shard_diffs(handle: RankTrainState, ref: dict, base: dict | None = None) -> list[dict]:
    """Each rank's parameter blocks held to whole leaves saved as ``.npy``
    files (`ref`: "/"-joined leaf path -> file), read with ``mmap_mode="r"``
    so a rank reads only its block. Per rank and leaf: the largest absolute
    difference, and with `base` (the files of the starting parameters) the
    relative norm of the difference of the two changes (block - base vs
    ref - base) and the reference change's norm. Only these numbers cross
    the pipes."""
    handle._check()
    job = {"token": handle.token, "ref": dict(ref), "base": None if base is None else dict(base)}
    return handle.mesh.run(_rank_diffs, [job] * handle.mesh.n)


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

def make_step(mesh, cfg, tc):
    """``step(handle, batch, check=False) -> (handle, metrics)`` on the
    ranks of `mesh`. `batch` holds the global rows (numpy or host tensors);
    each rank is sent its data shard's. `check` holds every flash and SSD
    kernel call of the ranks' step to its plain version. Metrics: the global
    loss and gradient norm (every rank computes the same bits; the step
    checks it), the learning rate, and each rank's costs (``ranks``: wall,
    collective seconds and bytes by axis and kind, peak memory, kernel
    launches, held calls) and ``sent_bytes``."""
    _check_mesh(mesh, cfg, tc)
    d = mesh.mesh_shape["data"]

    def step(handle: RankTrainState, batch, *, check: bool = False):
        handle._check(mesh)
        batch = {k: np.asarray(v) for k, v in batch.items()}
        n_rows = next(iter(batch.values())).shape[0]
        rows = [_rows(n_rows, d, i, tc.microbatches) for i in range(d)]
        jobs = [{"token": handle.token, "check": check,
                 "batch": {k: np.ascontiguousarray(v[rows[mesh.coords(r)["data"]]])
                           for k, v in batch.items()}}
                for r in range(mesh.n)]
        res = mesh.run(_rank_step, jobs)
        for key in ("loss", "grad_norm"):
            if len({r[key] for r in res}) != 1:
                raise RuntimeError(f"the ranks' {key} differ: {[r[key] for r in res]}")
        metrics = {"loss": torch.tensor(res[0]["loss"], dtype=torch.float32),
                   "grad_norm": torch.tensor(res[0]["grad_norm"], dtype=torch.float32),
                   "lr": res[0]["lr"],
                   "sent_bytes": [r["costs"]["sent_bytes"] for r in res],
                   "ranks": [dict(r["costs"], held=r["held"]) for r in res]}
        return handle, metrics

    return step


def expected_sent_bytes(cfg, tc, mesh_shape: dict, n_rows: int, seq: int,
                        mask: bool = False) -> int:
    """The payload bytes each rank sends in one step, from the layout. Per
    microbatch: every layer's FSDP gathers (twice with remat: the
    recompute gathers again) and its gradients' reduce-scatters, the
    embedding's (and lm_head's, and the hybrid's shared block's) once; over
    "model", in float32 but for the lookup and the MoE slot rows: each
    layer's (``_tp_layer_bytes``), the head input's gradient and the loss's
    three (B, S) reductions, and the vocab-parallel lookup (in the
    parameters' dtype); the mask's count. Once a step: the data all-reduce
    of the replicated leaves' gradients, the model all-reduce of the leaves
    read in part, the loss's, and the norm's over both axes. A gather or
    all-reduce sends (n - 1) x its operand, a reduce-scatter (n - 1) / n of
    it."""
    _, spec = state_layout(cfg, tc, mesh_shape)
    dn, mn = mesh_shape["data"], mesh_shape["model"]
    mb = tc.microbatches
    pbytes = torch.empty((), dtype=cfg.param_dtype).element_size()
    gbytes = pbytes if mb <= 1 else 4  # a step's gradient (accumulated in float32)
    remat = 1 if cfg.remat == "none" else 2
    fsdp = replicated = partial = 0

    def one(path, d, sp):
        nonlocal fsdp, replicated, partial
        n = math.prod(d.shape) // math.prod(mesh_shape[a] for a in sp if a is not None)
        if "data" in sp:
            fsdp += (dn - 1) * n * pbytes * ((remat if path[0] == "blocks" else 1) + 1)
        else:
            replicated += n
        if _read_in_part(path):
            partial += n

    tree_map(one, T.model_defs(cfg), spec["params"])
    tokens = n_rows // (dn * max(mb, 1)) * seq
    act = tokens * cfg.d_model
    tp = (mn - 1) * (_tp_layer_bytes(cfg, mesh_shape, tokens, remat)
                     + act * pbytes + act * 4 + 3 * tokens * 4)
    per_mb = fsdp + tp + ((dn - 1) * 4 if mask else 0)
    if cfg.family == "moe":  # each layer's pair counts (int64), gathered over "data"
        per_mb += (dn - 1) * remat * cfg.n_layers * cfg.n_experts * 8
    return (max(mb, 1) * per_mb + (dn - 1) * replicated * gbytes + (mn - 1) * partial * gbytes
            + 2 * (dn - 1) * 4 + (mn - 1) * 4)


def _tp_layer_bytes(cfg, mesh_shape: dict, tokens: int, remat: int) -> int:
    """The operand bytes a rank's layers all-reduce over "model" in a
    microbatch's forward, its recompute (x `remat`) and its backward;
    float32 but where said.

    Attention: the output's partial sums (forward), the input gradients of
    q, k, v (q only when kv heads stay whole: theirs are the kv gradients).
    MLP (and the shared expert): the output's partial sums, gate's and up's
    input gradients. MoE: the (T K, d) slot rows in the compute dtype
    (forward) and the dispatch input's gradient. Mamba2: ``wo``'s partial sums and the gated
    norm's mean of squares (forward; the statistic again backward), the
    input gradients of ``wz`` and ``wx``, and the gradients of B, C (the
    state width each) and dt (one a head)."""
    mn = mesh_shape["model"]
    act = tokens * cfg.d_model
    attn = remat * act * 4 + (3 if cfg.n_kv_heads % mn == 0 else 1) * act * 4
    if cfg.n_kv_heads % mn:
        attn += 2 * tokens * cfg.n_kv_heads * cfg.head_dim * 4
    mlp = remat * act * 4 + 2 * act * 4
    if cfg.family == "dense":
        return cfg.n_layers * (attn + mlp)
    if cfg.family == "moe":
        cbytes = torch.empty((), dtype=cfg.compute_dtype).element_size()
        k = cfg.experts_per_token
        moe = remat * tokens * k * cfg.d_model * cbytes + act * 4
        return cfg.n_layers * (attn + moe + (mlp if cfg.shared_expert_d_ff else 0))
    ssm = (remat * (act * 4 + tokens * 4) + 2 * act * 4
           + (2 * cfg.ssm_state + cfg.ssm_heads + 1) * tokens * 4)
    if cfg.family == "ssm":
        return cfg.n_layers * ssm
    return cfg.n_layers * ssm + (cfg.n_layers // cfg.hybrid_period) * (attn + mlp)


# ---------------------------------------------------------------------------
# what a rank runs (NodeMesh jobs; the store is only ever filled in a rank)
# ---------------------------------------------------------------------------

_RANK_STATES: dict[int, dict] = {}  # the parent's token -> this rank's blocks




def _store(me, token, cfg, tc, state) -> None:
    _, spec = state_layout(cfg, tc, me.mesh_shape)
    _RANK_STATES[token] = {"state": state, "cfg": cfg, "tc": tc, "spec": spec,
                           "grid": Grid(me, spec["params"])}


def _rank_init(me, job) -> None:
    cfg, tc = job["cfg"], job["tc"]
    _, spec = state_layout(cfg, tc, me.mesh_shape)
    whole = T.init_train_params(cfg, job["seed"], me.device)
    params = tree_map(
        lambda _, t, sp: t[shard_index(sp, t.shape, me.coord, me.mesh_shape)].clone(
            memory_format=torch.contiguous_format),
        whole, spec["params"])
    del whole
    _store(me, job["token"], cfg, tc, {"params": params, "opt": adam_init(tc.optimizer, params),
                                      "step": torch.zeros((), dtype=torch.int32)})


def _rank_put(me, job) -> None:
    state = tree_map(lambda _, h: from_host(h, me.device), job["state"])
    state["step"] = torch.tensor(job["step"], dtype=torch.int32)
    _store(me, job["token"], job["cfg"], job["tc"], state)


def _rank_gather(me, token) -> dict:
    rec = _RANK_STATES[token]
    spec = rec["spec"]

    def one(_, t, sp):
        return to_host(t) if _counted(sp, me.coord) else None

    state = rec["state"]
    return {"state": {k: tree_map(one, state[k], spec[k]) for k in ("params", "opt")},
            "step": int(state["step"])}


def _rank_free(me, token) -> None:
    _RANK_STATES.pop(token, None)


def _rank_diffs(me, job) -> dict:
    rec = _RANK_STATES[job["token"]]
    out = {}

    def one(path, t, sp):
        name = "/".join(path)
        ref = np.load(job["ref"][name], mmap_mode="r")
        idx = shard_index(sp, ref.shape, me.coord, me.mesh_shape)
        want = torch.from_numpy(np.array(ref[idx])).to(t.device, torch.float64)
        got = t.detach().to(torch.float64)
        row = {"max_abs": float((got - want).abs().max()) if got.numel() else 0.0}
        if job["base"] is not None:
            base = np.load(job["base"][name], mmap_mode="r")
            b = torch.from_numpy(np.array(base[idx])).to(t.device, torch.float64)
            ref_change = torch.linalg.vector_norm(want - b)
            row["ref_change_norm"] = float(ref_change)
            row["change_rel"] = float(torch.linalg.vector_norm(got - want) / ref_change
                                      if ref_change > 0 else torch.linalg.vector_norm(got - b))
        out[name] = row

    tree_map(one, rec["state"]["params"], rec["spec"]["params"])
    return out


_STEP_KERNELS = ("flash_attention", "flash_attention_bwd", "ssd_chunk", "ssd_chunk_bwd")


def _launches() -> dict[str, int]:
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ssd_scan as SD

    return {"flash_attention": FA.flash_attention.launches,
            "flash_attention_bwd": FA.flash_attention_bwd.launches,
            "ssd_chunk": SD.ssd_chunk_fwd.launches, "ssd_chunk_bwd": SD.ssd_chunk_bwd.launches}


def _grads(cfg, tc, grid, params, batch, spec):
    """(global loss, this rank's gradient blocks) of the rank's rows:
    ``step.local_grads`` under the rank's grid, then the gradients of
    leaves replicated over "data" summed over it, and those of the leaves
    read in part summed over "model" (each element has one contributor)."""
    with L.use_constraint_mesh(grid):
        loss, grads = S.local_grads(cfg, tc, params, batch)
    grads = tree_map(lambda _, g, sp: g if "data" in sp else grid.data.all_reduce(g),
                     grads, spec)
    grads = tree_map(lambda path, g: grid.model.all_reduce(g) if _read_in_part(path) else g,
                     grads)
    return grid.data.all_reduce(loss), grads


def _rank_step(me, job) -> dict:
    rec = _RANK_STATES[job["token"]]
    cfg, tc, spec, grid, state = rec["cfg"], rec["tc"], rec["spec"], rec["grid"], rec["state"]
    dev = me.device
    cuda = dev.type == "cuda"
    batch = {k: torch.as_tensor(v, device=dev) for k, v in job["batch"].items()}
    grid.reset()
    before = _launches()
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        held = {n: stack.enter_context(ops.held_to_plain(n))
                for n in (_STEP_KERNELS if job["check"] else ())}
        loss, grads = _grads(cfg, tc, grid, state["params"], batch, spec["params"])
    counted = tree_map(lambda _, sp: _counted(sp, me.coord), spec["params"])
    sq = grid.data.all_reduce(grid.model.all_reduce(shard_sum_of_squares(grads, counted)))
    _, _, metrics = adam_update(tc.optimizer, state["params"], grads, state["opt"],
                                state["step"], grad_norm=sq.sqrt())
    del grads
    state["step"] = state["step"] + 1
    if cuda:
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    comms = {c.axis: {k: dict(c.by_kind[k]) for k in KINDS} for c in grid.comms}
    costs = {"wall_s": wall, "sent_bytes": sum(c.sent_bytes for c in grid.comms),
             "collective_s": sum(c.seconds for c in grid.comms), "collectives": comms,
             "peak_bytes": torch.cuda.max_memory_allocated(dev) if cuda else None,
             "launches": {n: c - before[n] for n, c in _launches().items()},
             "coords": me.coord}
    return {"loss": float(loss), "grad_norm": float(metrics["grad_norm"]),
            "lr": metrics["lr"], "costs": costs,
            "held": {n: {"max_abs": list(h), "rel": h.rel} for n, h in held.items()} or None}
