"""The port's analysis modules (``repro_torch.launch.{roofline, dryrun,
report, hillclimb}``) against the reference's.

* The pure functions of ``roofline`` equal the reference's exactly on the
  ten configurations x four shapes, and a collective's wire bytes are the
  reference's ring formulas (fed to the reference as HLO lines).
* ``run_cell``'s skip path equals the reference's on every cell.
* ``render`` gives the reference's table from the same ``summary.json``,
  but for the two recorded differences: the HBM column is held to 80 GB,
  and the two hints that named the TPU name the H100's means.
* Traces on fake process groups: a smoke configuration's step on a small
  mesh counts FLOPs, bytes, collectives and memory; a data-only mesh of 4
  ranks does a quarter of one rank's FLOPs and all-reduces the gradients'
  bytes; attention costs K5's ``4 D`` per unmasked pair and head; the
  reduced-depth traces extrapolate to the full-depth one; a full-size cell
  traces in seconds.

Everything runs on the CPU in this process: the dry run's process group is
``fake`` (no other process), its tensors are ``FakeTensorMode``'s.
"""

from __future__ import annotations

import json
import math
import os
import time
from dataclasses import replace

import pytest
import torch
import torch.distributed as dist

from repro import configs as ref_configs
from repro.launch import roofline as RR
from repro.launch.report import render as ref_render
from repro_torch import configs as port_configs
from repro_torch.compat import make_mesh
from repro_torch.distrib.sharding import axis_rules
from repro_torch.kernels.flash_attn import attention_pairs, flash_attention
from repro_torch.launch import dryrun as D
from repro_torch.launch import hillclimb as H
from repro_torch.launch import roofline as PR
from repro_torch.launch.report import render
from repro_torch.models.model import Model
from repro_torch.models.config import SHAPES, ShapeConfig

ARCHS = sorted(port_configs.REGISTRY)
CELLS = [(a, s) for a in ARCHS for s in SHAPES]


def _ref(module: str):
    """A reference launch module that sets ``XLA_FLAGS`` when imported
    (``dryrun``, ``hillclimb``), with the environment left as it was."""
    import importlib

    before = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module(f"repro.launch.{module}")
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before


@pytest.fixture()
def no_process_group():
    """The dry run starts its own fake group.  A test of another file in
    this worker may have left ``launch/train``'s one-rank group running."""
    if dist.is_initialized():
        dist.destroy_process_group()
    yield
    assert not dist.is_initialized()


# --------------------------------------------------------------------------- #
# roofline: the pure functions
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("arch,shape", CELLS)
def test_pure_functions_equal_reference(arch, shape):
    pc, rc = port_configs.get(arch), ref_configs.get(arch)
    ps, rs = SHAPES[shape], ref_configs.SHAPES[shape]
    assert PR.model_flops_per_step(pc, ps) == RR.model_flops_per_step(rc, rs)
    assert PR.total_params(pc) == RR.total_params(rc)
    assert PR.active_params(pc) == RR.active_params(rc)
    for b, m in ((1, 1), (16, 16), (32, 16), (4, 2), (256, 1)):
        assert PR.ssm_scan_correction(pc, ps, b, m) == \
            RR.ssm_scan_correction(rc, rs, b, m)
    # per-device costs extrapolated to this configuration's depth
    small = dict(flops=3.5e12, bytes_accessed=7.25e10, collective_wire_bytes=1.5e9,
                 collective_breakdown={"all-gather": 1e9, "all-reduce": 5e8})
    big = dict(flops=6.25e12, bytes_accessed=1.3e11, collective_wire_bytes=2.75e9,
               collective_breakdown={"all-gather": 2e9, "reduce-scatter": 7.5e8})
    got = PR.combine_delta(PR.Roofline(**small), PR.Roofline(**big), 2, 4,
                           pc.n_layers).to_dict()
    want = RR.combine_delta(RR.Roofline(**small), RR.Roofline(**big), 2, 4,
                            rc.n_layers).to_dict()
    # the seconds and the dominant term follow each package's constants
    for k in ("compute_s", "memory_s", "collective_s", "dominant"):
        del got[k], want[k]
    assert got == want


def test_roofline_keeps_the_reference_fields():
    kw = dict(flops=2e14, bytes_accessed=3e12, collective_wire_bytes=4e10,
              collective_breakdown={"all-reduce": 4e10}, arg_bytes=5,
              temp_bytes=7, out_bytes=11, alias_bytes=3)
    got, want = PR.Roofline(**kw), RR.Roofline(**kw)
    assert got.to_dict().keys() == want.to_dict().keys()
    assert got.per_device_hbm_bytes == want.per_device_hbm_bytes == 20
    # the H100's constants (bf16 dense, HBM3, one direction of NVLink 4)
    assert (PR.PEAK_FLOPS, PR.HBM_BW, PR.LINK_BW) == (989e12, 3.35e12, 450e9)
    assert got.compute_s == kw["flops"] / 989e12
    assert got.memory_s == kw["bytes_accessed"] / 3.35e12
    assert got.collective_s == kw["collective_wire_bytes"] / 450e9
    assert got.bound_s == max(got.compute_s, got.memory_s, got.collective_s)
    assert got.dominant == "memory"


@pytest.mark.parametrize("kind", RR.COLLECTIVES)
@pytest.mark.parametrize("group", [1, 2, 16, 256])
def test_wire_bytes_are_the_reference_ring_formulas(kind, group):
    out = 3 * 2 ** 20 + 8
    line = (f"%c = u8[{out}] {kind}(u8[1] %p), "
            f"replica_groups=[{512 // group},{group}]")
    (ref,) = RR.parse_collectives(line, 512)
    got = PR.collective(kind, out, group)
    assert (got.kind, got.out_bytes, got.group_size, got.wire_bytes) == \
        (ref.kind, ref.out_bytes, ref.group_size, ref.wire_bytes)


def test_analyze_keeps_the_memory_sum():
    counts = PR.TraceCounts(flops=1e12, bytes_accessed=2e11,
                            collectives=[PR.collective("all-reduce", 400, 4),
                                         PR.collective("all-gather", 800, 4)],
                            arg_bytes=1000, peak_bytes=5000, end_bytes=1300)
    rf = PR.analyze(counts)
    assert (rf.arg_bytes, rf.temp_bytes, rf.out_bytes) == (1000, 3700, 300)
    assert rf.per_device_hbm_bytes == counts.peak_bytes
    assert rf.collective_breakdown == {"all-reduce": 600.0, "all-gather": 600.0}
    assert rf.collective_wire_bytes == 1200.0


# --------------------------------------------------------------------------- #
# dryrun: the skip path
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch,shape", CELLS)
def test_skip_path_equals_reference(arch, shape, multi_pod):
    ref_ok, _ = ref_configs.get(arch).supports_shape(shape)
    ok, _ = port_configs.get(arch).supports_shape(shape)
    assert ok == ref_ok
    if ok:
        return  # an ok cell traces; the tests below hold its counts
    want = _ref("dryrun").run_cell(arch, shape, multi_pod)
    assert want["status"] == "skipped"
    assert D.run_cell(arch, shape, multi_pod) == want


def test_dryrun_constants_equal_reference():
    ref = _ref("dryrun")
    assert D.TRAIN_OVERRIDES == ref.TRAIN_OVERRIDES
    assert D.TRAIN_RULES == ref.TRAIN_RULES
    assert D.ANALYSIS_LAYERS == ref.ANALYSIS_LAYERS
    assert D.HBM_PER_CHIP == 80 * 1024 ** 3


# --------------------------------------------------------------------------- #
# report
# --------------------------------------------------------------------------- #

# the two hints of the reference's table that named the TPU
HINTS = {
    "fuse elementwise chains (TPU) / shard replicated attention":
        "fuse elementwise chains (hand-written kernels) / shard replicated attention",
    "already compute-bound: MXU-align tiles":
        "already compute-bound: tensor-core-aligned (wgmma) tiles",
}


def _summary(tmp_path):
    """Cells of every (dominant, kind) pair, a skipped and an error cell."""
    cells = [{"arch": "llama3.2-3b", "shape": "long_500k", "mesh": "16x16",
              "kind": "decode", "status": "skipped",
              "reason": "pure full attention: O(seq^2)/unbounded KV at 524288"},
             {"arch": "glm4-9b", "shape": "train_4k", "mesh": "pod2x16x16",
              "status": "error", "error": "RuntimeError: out of memory"}]
    terms = {"compute": (3.0, 1.0, 0.5), "memory": (0.25, 2.0, 1.0),
             "collective": (0.5, 0.75, 1.5)}
    for i, (dom, (c, m, k)) in enumerate(terms.items()):
        for j, kind in enumerate(("train", "prefill", "decode")):
            cells.append({
                "arch": f"arch{i}", "shape": f"{kind}_x", "mesh": "16x16",
                "kind": kind, "status": "ok",
                "roofline": {"compute_s": c * (j + 1), "memory_s": m * (j + 1),
                             "collective_s": k * (j + 1), "dominant": dom},
                "per_device_bytes": (i + 1) * (j + 3) * 2 ** 30 + 12345,
                "fits_hbm": bool((i + j) % 2),
                "model_flops_ratio": None if j == 2 else 0.125 * (i + 1)})
    (tmp_path / "summary.json").write_text(json.dumps(cells))
    return str(tmp_path)


def test_render_equals_reference_but_the_recorded_columns(tmp_path):
    d = _summary(tmp_path)
    got, want = render(d).splitlines(), ref_render(d).splitlines()
    assert len(got) == len(want) == 2 + 11
    assert got[0] == want[0].replace("fits 16G", "fits 80G")
    for g, w in zip(got[1:], want[1:]):
        for old, new in HINTS.items():
            w = w.replace(old, new)
        assert g == w


# --------------------------------------------------------------------------- #
# dryrun: traces on fake process groups
# --------------------------------------------------------------------------- #


def _counts(cfg, shape, axes, fsdp=True, rules=None) -> PR.TraceCounts:
    with D.fake_world(math.prod(axes.values())):
        mesh = make_mesh(tuple(axes.values()), tuple(axes), device_type="cpu")
        with axis_rules(dict(rules or {})):
            return D.trace_step(mesh, cfg, shape, fsdp)


def test_smoke_cell_counts_by_reference_formulas(no_process_group):
    """A smoke llama train step (FSDP, sequence-sharded residual stream, 2
    microbatches) on a (2, 2) mesh: FLOPs, bytes, memory and the
    collectives FSDP and tensor parallelism need, each collective's wire
    bytes the reference's for the same HLO collective."""
    cfg = replace(port_configs.smoke_config("llama3.2-3b"), accum_steps=2)
    c = _counts(cfg, ShapeConfig("t", 64, 8, "train"), {"data": 2, "model": 2},
                rules=D.TRAIN_RULES)
    assert c.flops > 0 and c.bytes_accessed > 0
    assert 0 < c.arg_bytes < c.peak_bytes
    kinds = {op.kind for op in c.collectives}
    assert {"all-gather", "reduce-scatter", "all-reduce"} <= kinds
    hlo = "\n".join(f"%c{i} = u8[{op.out_bytes}] {op.kind}(u8[1] %p), "
                    f"replica_groups=[{4 // op.group_size},{op.group_size}]"
                    for i, op in enumerate(c.collectives))
    ref = RR.parse_collectives(hlo, 4)
    assert [(o.kind, o.out_bytes, o.group_size, o.wire_bytes) for o in ref] == \
        [(o.kind, o.out_bytes, o.group_size, o.wire_bytes) for o in c.collectives]
    assert all(op.group_size == 2 for op in c.collectives
               if op.out_bytes > 64)  # every mesh dim holds 2 ranks


def test_data_mesh_does_a_quarter_and_all_reduces_gradients(no_process_group):
    """Data parallelism over 4 ranks, weights replicated: each rank's FLOPs
    are a quarter of one rank's (within 1%), and the gradients' all-reduce
    sends ``2 B (G - 1) / G`` of the parameters' bytes B.  Activations in
    float32, so every gradient is reduced in its weight's float32 (with
    bf16 activations the attention projections' partial gradients are
    reduced in bf16, before the cast back)."""
    cfg = replace(port_configs.smoke_config("qwen2-0.5b"), dtype="float32")
    shape = ShapeConfig("t", 64, 8, "train")
    one = _counts(cfg, shape, {"data": 1, "model": 1}, fsdp=False)
    four = _counts(cfg, shape, {"data": 4, "model": 1}, fsdp=False)
    assert one.collectives == []
    assert four.flops == pytest.approx(one.flops / 4, rel=1e-2)
    param_bytes = sum(4 * p.numel() for p in Model(cfg, "meta").parameters())
    grads = [op for op in four.collectives
             if op.kind == "all-reduce" and op.out_bytes > 64]
    assert sum(op.out_bytes for op in grads) == param_bytes
    assert sum(op.wire_bytes for op in grads) == pytest.approx(
        2 * param_bytes * 3 / 4, rel=1e-12)


@pytest.mark.parametrize("window", [None, 16, 100])
@pytest.mark.parametrize("d", [32, 64, 96])
def test_attention_counts_k5_work(window, d):
    """Under the dry run's counter, K5 on fake tensors costs ``4 D`` per
    unmasked (query, key) pair and head, and moves q, k, v and o."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    BH, S = 6, 256
    with FakeTensorMode() as fake:
        q = torch.zeros((BH, S, d), dtype=torch.bfloat16)
        counter = D.Counter(fake)
        with counter:
            out = flash_attention(q, q, q, window=window)
    assert out.shape == q.shape
    pairs = attention_pairs(S, window)
    assert pairs == (S * (S + 1) // 2 if window is None else
                     sum(min(i + 1, window) for i in range(S)))
    assert counter.counts.flops == 4 * d * pairs * BH
    assert counter.counts.bytes_accessed == 4 * BH * S * d * 2


@pytest.mark.parametrize("window", [None, 16])
def test_prefill_attention_is_counted_as_k5(window, no_process_group):
    """A smoke llama prefill on one rank: its FLOPs are its matrix products
    (every layer's projections and FFN over B S tokens, the last
    position's logits) plus K5's ``4 hd`` per pair, head and sequence:
    the S x S scores of the plain version are not counted."""
    cfg = replace(port_configs.smoke_config("llama3.2-3b"), sliding_window=window)
    B, S = 2, 128
    c = _counts(cfg, ShapeConfig("p", S, B, "prefill"), {"data": 1, "model": 1},
                fsdp=False)
    d, H, hd, f = cfg.d_model, cfg.n_heads, cfg.hd, cfg.d_ff
    per_layer = d * H * hd * 2 + d * cfg.n_kv_heads * hd * 2 + 3 * d * f
    want = (2 * B * S * per_layer * cfg.n_layers + 2 * B * d * cfg.padded_vocab
            + cfg.n_layers * 4 * hd * attention_pairs(S, window) * B * H)
    assert c.flops == want


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_reduced_depth_traces_extrapolate_to_full_depth(kind, no_process_group):
    """``ANALYSIS_LAYERS`` traces extrapolated by ``combine_delta`` equal the
    trace at full depth: every layer does the same work.  Memory, a peak,
    is linear in depth only as far as the peak's make-up stays the same:
    within 2% at this width, where the vocabulary's logits weigh as much as
    a layer."""
    cfg = replace(port_configs.smoke_config("olmoe-1b-7b"), n_layers=6,
                  accum_steps=2 if kind == "train" else 1)
    shape = ShapeConfig("x", 64, 8, kind)

    def mesh():
        return make_mesh((2, 2), ("data", "model"), device_type="cpu")

    _, full, _ = D.trace_cell(cfg, shape, 4, mesh)
    _, delta, _ = D.trace_cell(cfg, shape, 4, mesh, depths=D.ANALYSIS_LAYERS)
    for k, v in full.to_dict().items():
        if isinstance(v, float):
            assert delta.to_dict()[k] == pytest.approx(v, rel=1e-9), k
    assert delta.per_device_hbm_bytes == pytest.approx(
        full.per_device_hbm_bytes, rel=2e-2)


def test_recurrences_count_one_step_and_the_correction(no_process_group):
    """hymba's SSM: the trace runs one step of each scan, and the corrected
    counts are the traced ones plus the reference's analytic correction."""
    cfg = port_configs.smoke_config("hymba-1.5b")
    shape = ShapeConfig("p", 512, 4, "prefill")

    def mesh():
        return make_mesh((2, 1), ("data", "model"), device_type="cpu")

    traced, rf, secs = D.trace_cell(cfg, shape, 2, mesh)
    cf, cb = PR.ssm_scan_correction(cfg, shape, 2, 1)
    assert cf > 0 and cb > 0
    assert rf.flops == traced.flops + cf
    assert rf.bytes_accessed == traced.bytes_accessed + cb
    assert secs < 60


def test_full_size_cell_is_ok_in_seconds(no_process_group):
    """qwen2-0.5b at prefill_32k on the (16, 16) production mesh of a fake
    group of 256 ranks: ``status: ok`` in under 30 s."""
    t0 = time.perf_counter()
    cell = D.run_cell("qwen2-0.5b", "prefill_32k", multi_pod=False,
                      verbose=False)
    assert time.perf_counter() - t0 < 30
    assert cell["status"] == "ok" and cell["devices"] == 256
    rf = cell["roofline"]
    assert rf["flops"] > 0 and rf["bytes_accessed"] > 0
    assert rf["collective_wire_bytes"] > 0
    assert cell["fits_hbm"] and 0 < cell["per_device_bytes"] < D.HBM_PER_CHIP
    assert cell["model_flops"] == RR.model_flops_per_step(
        ref_configs.get("qwen2-0.5b"), ref_configs.SHAPES["prefill_32k"])
    assert not dist.is_initialized()


def test_fake_world_refuses_a_running_group(no_process_group):
    with D.fake_world(2):
        with pytest.raises(RuntimeError, match="already has one"):
            with D.fake_world(2):
                pass
    assert not dist.is_initialized()


def test_main_writes_the_summary_render_reads(tmp_path, capsys):
    out = tmp_path / "dry"
    assert D.main(["--arch", "llama3.2-3b", "--shape", "long_500k",
                   "--both-meshes", "--out", str(out)]) == 0
    cells = json.loads((out / "summary.json").read_text())
    assert [c["mesh"] for c in cells] == ["16x16", "pod2x16x16"]
    assert all(c["status"] == "skipped" for c in cells)
    assert "2 skipped" in capsys.readouterr().out
    assert render(str(out)).splitlines()[2].startswith(
        "| llama3.2-3b | long_500k | 16x16 | — |")


# --------------------------------------------------------------------------- #
# hillclimb
# --------------------------------------------------------------------------- #


def test_hillclimb_experiments_equal_reference():
    assert H.EXPERIMENTS == _ref("hillclimb").EXPERIMENTS


def test_hillclimb_traces_each_variant(tmp_path, monkeypatch, capsys):
    seen = []

    def fake_cell(arch, shape, multi_pod, **kw):
        seen.append((arch, shape, multi_pod, kw))
        rf = {"dominant": "memory", "compute_s": 0.5, "memory_s": 1.0,
              "collective_s": 0.25}
        return {"roofline": rf, "per_device_bytes": 2 ** 30, "fits_hbm": True}

    monkeypatch.setattr(H, "run_cell", fake_cell)
    H.main(["--all", "--out", str(tmp_path)])
    want = [(e["arch"], e["shape"], e["multi_pod"], v)
            for e in H.EXPERIMENTS.values() for v in e["variants"]]
    assert [(a, s, m) for a, s, m, _ in seen] == [w[:3] for w in want]
    for (_, _, _, kw), (_, _, _, (name, var)) in zip(seen, want):
        assert kw == dict(fsdp=var.get("fsdp", True), rules=var.get("rules"),
                          cfg_overrides=var.get("cfg_overrides"), verbose=False)
    files = sorted(p.name for p in tmp_path.iterdir())
    assert files == sorted(f"{n}_{v}.json" for n, e in H.EXPERIMENTS.items()
                           for v, _ in e["variants"])
    assert "dom=memory" in capsys.readouterr().out
