"""The port's launch tooling (``repro_torch.launch``): the shape grid, the
cost accounting by dispatch, the meta-device dry run and ``reanalyze``,
held to the JAX package's grid and arithmetic and to hand counts, on the
CPU. Records are written under pytest's tmp_path only.
"""
import json

import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import list_archs as jax_archs
from repro.launch import hlo_analysis as H
from repro.launch import shapes as JS
from repro_torch.configs import get_config, list_archs
from repro_torch.kernels import ops
from repro_torch.launch import cost_analysis as C
from repro_torch.launch import dryrun, reanalyze
from repro_torch.launch.shapes import SHAPES, cells_for, input_specs
from repro_torch.models import transformer as T


def test_archs_shapes_and_cells_equal_the_references():
    assert list_archs() == jax_archs()
    assert {n: tuple(vars(s).values()) for n, s in SHAPES.items()} == \
        {n: tuple(vars(s).values()) for n, s in JS.SHAPES.items()}
    for arch in list_archs():
        assert cells_for(get_config(arch)) == JS.cells_for(jax_config(arch)), arch


@pytest.mark.parametrize("arch", jax_archs())
def test_model_flops_equal_the_references(arch):
    cfg, jcfg = get_config(arch), jax_config(arch)
    for name in cells_for(cfg):
        s = SHAPES[name]
        assert C.model_flops(cfg, s.kind, s.batch, s.seq) == \
            H.model_flops(jcfg, s.kind, s.batch, s.seq), name


def test_peaks_are_the_h100s():
    assert (C.PEAK_FLOPS, C.HBM_BW, C.HBM_BYTES) == (989e12, 3.35e12, 80e9)
    assert "700 W" in C.CARD


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_mm_chain_counts_equal_a_hand_count():
    """(a @ b) @ c: 2 m k n FLOPs a product; each product reads its inputs
    and writes its output once; the peak holds the arguments, a @ b and
    the result at once."""
    m, k, n, p = 64, 128, 32, 16
    a, b, c = _meta(m, k), _meta(k, n), _meta(n, p)
    out, costs = C.count_step(lambda x, y, z: (x @ y) @ z, a, b, c)
    assert out.shape == (m, p)
    assert costs.flops == 2 * m * k * n + 2 * m * n * p
    assert costs.bytes == 4 * ((m * k + k * n + m * n) + (m * n + n * p + m * p))
    args = 4 * (m * k + k * n + n * p)
    assert costs.argument_bytes == args and costs.output_bytes == 4 * m * p
    assert costs.peak_bytes == args + 4 * (m * n + m * p)
    assert costs.table["aten.mm"].calls == 2


def test_scanned_depth_stack_counts_every_layer():
    """A Python loop over L stacked layers (the JAX scan) counts L products;
    taking a layer's weight is a view and moves no bytes."""
    L, M = 6, 32
    x, ws = _meta(4, M), _meta(L, M, M)

    def stack(x, ws):
        for w in ws.unbind(0):
            x = torch.tanh(x @ w)
        return x

    _, costs = C.count_step(stack, x, ws)
    assert costs.table["aten.mm"].calls == L
    assert costs.flops == L * 2 * 4 * M * M
    assert costs.table["aten.unbind"].bytes == 0
    assert costs.bytes == L * 4 * ((4 * M + M * M + 4 * M) + 2 * 4 * M)


def test_kernel_costs_join_the_table():
    q, k = _meta(1, 4, 64, 32), _meta(1, 2, 64, 32)
    _, costs = C.count_step(lambda *t: ops.flash_attention(*t), q, k, k)
    want = ops.get_kernel("flash_attention").cost(q, k, k)
    rec = costs.table["kernel:flash_attention"]
    assert (rec.calls, rec.flops, rec.bytes) == (1, *want)
    assert costs.flops == want[0]


def _sparse(n, d, k, dtype):
    """chip_smoke.py's kernel_inputs(dups=False): distinct indices a row,
    the last 3 entries padding (idx 0)."""
    rng = np.random.default_rng(0)
    psi = rng.standard_normal((n, d))
    idx = np.stack([rng.choice(d, size=k, replace=False) for _ in range(n)])
    idx[:, k - 3:] = 0
    t = lambda a, dt=dtype: torch.as_tensor(a, dtype=dt)  # noqa: E731
    return t(psi), t(idx, torch.int32), t(rng.standard_normal((n, k))), t(np.ones(n)), \
        t(np.ones(n))


def _decode(lengths, hq, hkv, d, bs, n_pages):
    b = len(lengths)
    q = _meta(b, hq, d, dtype=torch.bfloat16)
    pool = _meta(1, bs, hkv, d, dtype=torch.bfloat16)
    table = _meta(b, n_pages, dtype=torch.int32)
    return q, pool, pool, table, torch.tensor(lengths, dtype=torch.int32)


def _flash(b, hq, hkv, s, d, bwd=False):
    q, k = _meta(b, hq, s, d, dtype=torch.bfloat16), _meta(b, hkv, s, d, dtype=torch.bfloat16)
    if bwd:
        return q, k, k, q, _meta(b, hq, s), q
    return q, k, k


def _ssd(B, nc, Q, nh, hd, ds, bwd=False):
    x, c, bc = _meta(B, nc, Q, nh, hd), _meta(B, nc, Q, nh), _meta(B, nc, Q, ds)
    return (x, c, bc, bc, x, _meta(B, nc, nh, ds, hd)) if bwd else (x, c, bc, bc)


SERVE_LENGTHS = [170, 251, 253, 238, 285, 194, 247, 224]  # chip_smoke.SERVE_BUSIEST_LENGTHS
TF32 = 495e12
# PERF.md section 6's bound column: (kernel, arguments, the rate of its
# operations, the bound as printed). The SSD bounds count three TF32
# products a float32 product, as chip_smoke.py's ssd_bounds does.
BOUNDS = [
    ("sparse_dot", lambda: _sparse(10, 47_236, 74, torch.float64)[:3], 34e12, 1, "0.0000044"),
    ("sparse_axpy", lambda: _sparse(10, 47_236, 74, torch.float64), 34e12, 1, "0.00226"),
    ("sparse_axpy", lambda: _sparse(10, 1_355_191, 450, torch.float64), 34e12, 1, "0.0647"),
    ("block_topk", lambda: (_meta(288_000, 4096), 40), 67e12, 1, "1.436"),
    ("block_topk", lambda: (_meta(2, 1_000_003), 10_000), 67e12, 1, "0.0024"),
    ("flash_attention", lambda: _flash(1, 32, 8, 2048, 128), 989e12, 1, "0.0348"),
    ("flash_attention", lambda: _flash(1, 8, 4, 2048, 256), 989e12, 1, "0.0174"),
    ("flash_attention", lambda: _flash(1, 32, 32, 2048, 64), 989e12, 1, "0.0174"),
    ("flash_attention", lambda: _flash(1, 128, 8, 4096, 128), 989e12, 1, "0.556"),
    ("flash_attention_bwd", lambda: _flash(2, 32, 8, 2048, 128, True), 989e12, 1, "0.174"),
    ("flash_attention_bwd", lambda: _flash(1, 8, 4, 2048, 256, True), 989e12, 1, "0.0434"),
    ("flash_attention_bwd", lambda: _flash(2, 16, 16, 2048, 128, True), 989e12, 1, "0.0869"),
    ("flash_attention_bwd", lambda: _flash(1, 128, 8, 4096, 128, True), 989e12, 1, "1.390"),
    ("ssd_chunk", lambda: _ssd(4, 8, 256, 64, 64, 128), TF32, 3, "0.106"),
    ("ssd_chunk", lambda: _ssd(1, 8, 256, 64, 64, 128), TF32, 3, "0.0265"),
    ("ssd_chunk", lambda: _ssd(1, 1, 256, 64, 64, 128), TF32, 3, "0.0033"),
    ("ssd_chunk_bwd", lambda: _ssd(4, 8, 256, 64, 64, 128, True), TF32, 3, "0.214"),
    ("ssd_chunk_bwd", lambda: _ssd(1, 8, 256, 64, 64, 128, True), TF32, 3, "0.0534"),
    ("decode_attention", lambda: _decode(SERVE_LENGTHS, 32, 8, 128, 16, 64), 989e12, 1,
     "0.00232"),
    ("decode_attention", lambda: _decode([32_768] * 8, 32, 8, 128, 16, 2048), 989e12, 1,
     "0.3206"),
    ("decode_attention", lambda: _decode([32_768] * 128, 32, 8, 128, 16, 2048), 989e12, 1,
     "5.129"),
    ("decode_attention", lambda: _decode([524_288], 32, 32, 64, 16, 32_768), 989e12, 1,
     "1.282"),
]


@pytest.mark.parametrize("name,args,rate,products,printed", BOUNDS,
                         ids=[f"{b[0]}-{b[4]}" for b in BOUNDS])
def test_kernel_cost_reproduces_the_perf_bound_column(name, args, rate, products, printed):
    """Each KernelSpec.cost gives PERF.md's bound (the larger of bytes over
    3.35 TB/s and operations over the rate) to the digits printed."""
    operations, nbytes = ops.get_kernel(name).cost(*args())
    ms = max(nbytes / 3.35e12, products * operations / rate) * 1e3
    decimals = len(printed.split(".")[1])
    assert round(ms, decimals) == pytest.approx(float(printed), abs=10 ** -decimals / 2), ms


FAMILIES = ["minitron-8b", "qwen2-moe-a2.7b", "mamba2-1.3b", "zamba2-1.2b", "whisper-small"]


@pytest.mark.parametrize("arch", FAMILIES)
def test_reduced_dry_run_of_each_family_writes_ok_records(arch, tmp_path):
    dryrun.main(["--arch", arch, "--reduced", "--out", str(tmp_path)])
    recs = [json.loads(p.read_text()) for p in sorted(tmp_path.glob("*_single.json"))]
    assert sorted(r["shape"] for r in recs) == sorted(cells_for(get_config(arch)))
    for r in recs:
        assert r["ok"], r.get("error")
        assert r["reduced"] and r["memory"]["peak_bytes"] >= r["memory"]["argument_bytes"] > 0
        assert r["hlo_flops"] > 0 and r["hlo_bytes"] > 0 and r["model_flops"] > 0
        assert (r["hlo_flops"], r["hlo_bytes"]) == C.table_totals(r["op_table"])
        assert r["roofline"]["dominant"] in ("compute", "memory")
    kernels = {op for r in recs for op in r["op_table"] if op.startswith("kernel:")}
    want = {"minitron-8b": {"flash_attention", "flash_attention_bwd", "decode_attention"},
            "qwen2-moe-a2.7b": {"flash_attention", "flash_attention_bwd", "decode_attention"},
            "mamba2-1.3b": {"ssd_chunk", "ssd_chunk_bwd"},
            "zamba2-1.2b": {"ssd_chunk", "ssd_chunk_bwd", "flash_attention",
                            "flash_attention_bwd", "decode_attention"},
            "whisper-small": {"flash_attention", "flash_attention_bwd", "decode_attention"}}
    assert kernels == {f"kernel:{k}" for k in want[arch]}


def test_full_config_train_cell_counts_the_useful_flops(tmp_path):
    """minitron-8b train_4k at full size on meta: every layer's flash
    forward twice (remat "full") and backward once; the counted FLOPs
    within the reference record's bar of model_flops."""
    rec = dryrun.run_cell("minitron-8b", "train_4k")
    assert rec["ok"], rec.get("error")
    assert 0.5 < rec["roofline"]["useful_flop_ratio"] < 1.5
    assert rec["op_table"]["kernel:flash_attention"]["calls"] == 2 * 32
    assert rec["op_table"]["kernel:flash_attention_bwd"]["calls"] == 32
    assert not rec["fits_one_card"]


def test_reanalyze_reproduces_a_record_bit_for_bit(tmp_path):
    dryrun.main(["--arch", "mamba2-1.3b", "--shape", "train_4k", "--reduced", "--out",
                 str(tmp_path), "--set", "remat=dots"])
    path = dryrun.record_path(tmp_path, "mamba2-1.3b", "train_4k")
    before = path.read_text()
    assert reanalyze.reanalyze(path)
    assert path.read_text() == before
    rec = json.loads(before)
    rec["roofline"]["compute_s"] = 0.0
    rec["hlo_flops"] = 1.0
    path.write_text(json.dumps(rec, indent=2, default=str))
    reanalyze.main(["--dir", str(tmp_path)])
    assert path.read_text() == before


def test_a_host_sync_in_the_step_is_a_failed_record(monkeypatch):
    def synced(cfg, tc, state, batch):
        return float(batch["tokens"].sum())

    monkeypatch.setattr(dryrun, "train_step", synced)
    rec = dryrun.run_cell("minitron-8b", "train_4k", reduced=True)
    assert rec["ok"] is False and "meta" in rec["error"]


def test_input_specs_build_the_steps_arguments():
    cfg = get_config("zamba2-1.2b")
    dec = input_specs(cfg, SHAPES["decode_32k"])
    assert dec["tokens"].shape == (128, 1) and dec["table"].shape == (128, 2048)
    assert dec["pools"]["attn"]["k"].shape == (6, 128 * 2048 + 1, 16, 32, 64)
    assert all(t.is_meta for t in (dec["tokens"], dec["table"], dec["lengths"]))
    small = input_specs(get_config("minitron-8b"), dryrun.ShapeSpec("d", "decode", 40, 2), "cpu")
    assert small["lengths"].tolist() == [39, 39]
    assert small["table"].tolist() == [[1, 2, 3], [4, 5, 6]]
    pre = input_specs(get_config("whisper-small"), SHAPES["prefill_32k"])
    assert pre["cache"]["self"]["k"].shape[:3] == (12, 32, 32_768)
    train = input_specs(get_config("whisper-small"), SHAPES["train_4k"])
    assert train["enc_embeds"].shape == (256, 1500, 768)
    assert T.cache_defs(get_config("mamba2-1.3b"), 1, 8)["state"].shape[0] == 48
