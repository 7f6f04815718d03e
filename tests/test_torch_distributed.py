"""The port's multi-device path against ``tests/test_distributed.py``'s four
tests, on gloo worlds of 8 CPU processes (``torch_dist_cases.py``):

* a sharded ``build_train`` step on ``(data=4, model=2)`` with FSDP against
  the port's single-device step, within the reference's tolerances (loss
  2e-2, weights 5e-2) in the configuration's bf16, and equal clip norms in
  float32; and against the JAX package's own sharded step on ``(4, 2)``
  (8 host devices, in a subprocess) from the same weights and batch;
* elastic restore: a checkpoint saved from ``(4, 2)`` restored onto
  ``(2, 4)``, a sharded train state saved and restored bit for bit, and a
  checkpoint of the JAX package's sharded save (8 host devices, in a
  subprocess) restored onto a port mesh bit for bit;
* ``distributed_refine`` over ``data = 8`` for q3, q4 and q12 at sf 0.002,
  equal to ``query_iterative``;
* mixtral's smoke config on ``(pod=2, data=2, model=2)``: the step's
  collectives counted by ``CommDebugMode``, its loss the unsharded one's;

and ``build_prefill`` / ``build_decode`` on ``(4, 2)`` (llama, and olmoe's
MoE with fewer tokens a rank than a token group), and qwen2's GQA
with its 4 query heads split over ``model = 4`` and its 2 KV heads not.
The card cases (``-m cuda``) run a one-rank NCCL mesh, K5 once a layer on
each rank's own heads:

    python -m pytest -q --noconftest -m cuda tests/test_torch_distributed.py
"""

from __future__ import annotations

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_dist_cases import run_world

SRC = str(Path(__file__).resolve().parent.parent / "src")
LOSS_TOL, WEIGHT_TOL = 2e-2, 5e-2  # tests/test_distributed.py's
F32_TOL = 1e-5
BF16_NORM_RTOL = 2e-3  # the clip norm of a bf16 step, across packages


def test_sharded_train_step_matches_single_device(tmp_path):
    bf16, f32 = run_world(
        tmp_path, 8,
        ("train", {"arch": "llama3.2-3b", "mesh_shape": [4, 2]}),
        ("train", {"arch": "llama3.2-3b", "mesh_shape": [4, 2], "accum": 2,
                   "dtype": "float32"}))
    single, sharded = bf16["loss"]
    assert abs(single - sharded) < LOSS_TOL, bf16["loss"]
    assert bf16["weights"] < WEIGHT_TOL, bf16["weights"]
    for key in ("loss", "grad_norm"):
        a, b = f32[key]
        assert abs(a - b) <= F32_TOL * abs(a), (key, a, b)
    # one AdamW step moves a weight by about lr (1e-3) whatever the size
    # of its gradient, so a gradient near zero turns reduction-order noise
    # into up to a few percent of its update
    assert f32["weights"] < 1e-4, f32["weights"]
    # FSDP over data and tensor parallelism over model, the moments in
    # their weight's layout
    assert bf16["placements"]["layers.0.attn.wq"] == ("S(0)", "S(1)")
    assert bf16["placements"]["layers.0.norm1"] == ("S(0)", "R")
    assert bf16["moments_follow_weights"] and f32["moments_follow_weights"]


JAX_RUNS = textwrap.dedent("""
    import pickle, sys
    from dataclasses import replace
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.checkpoint.manager import CheckpointManager
    from repro.configs import smoke_config
    from repro.launch.mesh import make_host_mesh
    from repro.launch.steps import build_train
    from repro.models import model as M
    from repro.models.config import ShapeConfig
    from repro.optim import adamw

    rng = np.random.default_rng(7)
    tree = {"w": rng.standard_normal((16, 16)).astype(np.float32),
            "b": rng.standard_normal((8, 32)).astype(np.float32),
            "i": rng.integers(-2**31, 2**31 - 1, 16).astype(np.int32)}
    mesh = make_host_mesh(data=4, model=2)
    specs = {"w": P("data", "model"), "b": P(None, "model"), "i": P("data")}
    placed = {k: jax.device_put(v, NamedSharding(mesh, specs[k]))
              for k, v in tree.items()}
    CheckpointManager(sys.argv[1]).save(5, placed)

    # tests/test_distributed.py's sharded step, in bf16 and in float32
    toks = np.random.default_rng(0).integers(0, 512, (8, 32)).astype(np.int32)
    batch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=1)
    runs = {}
    for dtype in ("bfloat16", "float32"):
        cfg = replace(smoke_config("llama3.2-3b"), dtype=dtype, remat=False)
        params, _ = M.init(cfg, jax.random.PRNGKey(0))
        init = jax.tree.map(lambda a: np.array(a, copy=True), params)
        with mesh:
            step, _ = build_train(mesh, cfg, ShapeConfig("t", 32, 8, "train"),
                                  opt_cfg, fsdp=True)
            after, _, m = step(params, adamw.init(params, opt_cfg), batch)
        runs[dtype] = {"init": init, "loss": float(m["loss"]),
                       "grad_norm": float(m["grad_norm"]),
                       "after": jax.tree.map(
                           lambda a: np.array(a.astype(jnp.float32)), after)}
    with open(sys.argv[2], "wb") as f:
        pickle.dump(runs, f)
    print("SAVED")
""")


def jax_tree():
    rng = np.random.default_rng(7)
    return {"w": rng.standard_normal((16, 16)).astype(np.float32),
            "b": rng.standard_normal((8, 32)).astype(np.float32),
            "i": rng.integers(-2**31, 2**31 - 1, 16).astype(np.int32)}


@pytest.fixture(scope="module")
def reference_runs(tmp_path_factory):
    """The JAX package on 8 host devices (a subprocess): a sharded save,
    and its sharded train step from ``M.init``'s weights; then the port's
    gloo world restores the checkpoints and runs its own sharded step from
    the same weights."""
    d = tmp_path_factory.mktemp("ckpt")
    env = dict(os.environ, PYTHONPATH=SRC,
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    proc = subprocess.run([sys.executable, "-c", JAX_RUNS, str(d / "jax"),
                           str(d / "train.pkl")],
                          capture_output=True, text=True, env=env, timeout=240)
    assert "SAVED" in proc.stdout, proc.stderr[-3000:]
    ckpt, *train = run_world(
        d, 8, ("checkpoint", {"ckpt_dir": str(d / "port"),
                              "jax_dir": str(d / "jax")}),
        *(("train_from", {"path": str(d / "train.pkl"), "dtype": dt})
          for dt in ("bfloat16", "float32")))
    return {"checkpoint": ckpt, "train": dict(zip(("bfloat16", "float32"), train))}


@pytest.fixture
def checkpoints(reference_runs):
    return reference_runs["checkpoint"]


def test_sharded_train_step_matches_reference(reference_runs):
    """The port's sharded step on (4, 2) against the JAX package's on
    (4, 2) from the same weights and batch: tests/test_distributed.py's
    tolerances in bf16 (and the clip norm to 2e-3), and in float32 the
    loss and clip norm to 1e-5 and every weight to a tenth of the learning
    rate (1e-3)."""
    bf16, f32 = (reference_runs["train"][k] for k in ("bfloat16", "float32"))
    ref, port = bf16["loss"]
    assert abs(ref - port) < LOSS_TOL, bf16["loss"]
    assert bf16["weights"] < WEIGHT_TOL, bf16["weights"]
    ref, port = bf16["grad_norm"]
    assert abs(ref - port) <= BF16_NORM_RTOL * abs(ref), bf16["grad_norm"]
    for key in ("loss", "grad_norm"):
        ref, port = f32[key]
        assert abs(ref - port) <= F32_TOL * abs(ref), (key, ref, port)
    assert f32["weights"] < 1e-4, f32["weights"]


def test_elastic_checkpoint_reshard(checkpoints):
    step, equal, placements, local = checkpoints["elastic"]
    assert step == 3 and equal
    assert placements == ("S(0)", "S(1)") and local == (8, 4)  # on (2, 4)
    # a sharded train state (weights, moments, step) comes back bit for
    # bit in the same layouts
    assert checkpoints["train_state"] and checkpoints["train_leaves"] > 100


def test_jax_sharded_checkpoint_restores_on_port_mesh(checkpoints):
    step, bits, placements = checkpoints["jax"]
    assert step == 5
    for k, v in jax_tree().items():
        assert bits[k] == v.tobytes(), k
    assert placements == {"w": ("S(0)", "S(1)"), "b": ("R", "S(1)"),
                          "i": ("S(0)", "R")}


def test_distributed_lineage_matches_local(tmp_path):
    out = run_world(tmp_path, 8, ("lineage", {"queries": ["q3", "q4", "q12"]}))[0]
    for q in ("q3", "q4", "q12"):
        assert out[q], q  # each query has output rows at this scale
        for tab, (local, dist) in out[q].items():
            assert local == dist, (q, tab, len(local), len(dist))
        assert out[q + "_scans"] > 0, q  # shard scans went through the backend


def test_multipod_mesh_counts_collectives(tmp_path):
    out = run_world(tmp_path, 8, ("train", {"arch": "mixtral-8x22b",
                                            "mesh_shape": [2, 2, 2],
                                            "count_comms": True}))[0]
    comms = out["comms"]
    for c in ("all_gather_into_tensor", "reduce_scatter_tensor", "all_reduce"):
        assert comms.get(c, 0) > 0, comms
    single, sharded = out["loss"]
    assert abs(single - sharded) < LOSS_TOL, out["loss"]
    assert out["placements"]["embed"] == ("S(1)", "S(1)", "S(0)")


def prefill_close(out):
    return out["prefill"] <= 1e-4 * out["prefill_scale"] + 1e-4


@pytest.fixture(scope="module")
def serve_runs(tmp_path_factory):
    """llama in float32 and bf16, and olmoe in float32, served on (4, 2)
    by one world."""
    return run_world(
        tmp_path_factory.mktemp("serve"), 8,
        ("serve", {"arch": "llama3.2-3b", "mesh_shape": [4, 2],
                   "dtype": "float32"}),
        ("serve", {"arch": "llama3.2-3b", "mesh_shape": [4, 2], "steps": 1}),
        ("serve", {"arch": "olmoe-1b-7b", "mesh_shape": [4, 2],
                   "dtype": "float32"}))


def test_sharded_prefill_and_decode_match_unsharded(serve_runs):
    f32, bf16, _ = serve_runs
    assert prefill_close(f32), f32
    assert f32["decode"] < 1e-4 and f32["same_tokens"], f32
    # the cache: batch over data, KV heads over model
    assert f32["cache"]["cache_k"] == ("S(1)", "S(3)")
    assert bf16["prefill_rms"] < 5e-2, bf16


def test_sharded_moe_decode_matches_unsharded(serve_runs):
    """olmoe's smoke config on (4, 2): a decode step holds 2 of the 8
    tokens on each rank, fewer than a token group (32), so the routing
    must form the global batch's one group and its capacity, not one of
    its own."""
    out = serve_runs[2]
    assert prefill_close(out), out
    assert out["decode"] < 1e-4 and out["same_tokens"], out


def test_gqa_with_kv_heads_replicated_over_model(tmp_path):
    """qwen2's smoke config on (2, 4): 4 query heads, one a rank; 2 KV
    heads, which do not divide the model axis, so each rank takes the KV
    heads that serve its query heads, and the cache shards its slots."""
    train, serve = run_world(
        tmp_path, 8,
        ("train", {"arch": "qwen2-0.5b", "mesh_shape": [2, 4],
                   "dtype": "float32"}),
        ("serve", {"arch": "qwen2-0.5b", "mesh_shape": [2, 4],
                   "dtype": "float32"}))
    for key in ("loss", "grad_norm"):
        a, b = train[key]
        assert abs(a - b) <= F32_TOL * abs(a), (key, a, b)
    assert train["placements"]["layers.0.attn.wq"] == ("S(0)", "S(1)")
    assert train["placements"]["layers.0.attn.wk"] == ("S(0)", "R")
    assert prefill_close(serve) and serve["decode"] < 1e-4, serve
    assert serve["same_tokens"]
    assert serve["cache"]["cache_k"] == ("S(1)", "S(2)")  # kv_seq on model


# --------------------------------------------------------------------------- #
# the card: a one-rank NCCL mesh
# --------------------------------------------------------------------------- #


@pytest.fixture
def one_rank_mesh():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.launch.mesh import make_host_mesh

    return make_host_mesh(data=1, model=1)


@pytest.mark.cuda
def test_cuda_sharded_prefill_launches_k5_on_local_shards(one_rank_mesh):
    from dataclasses import replace

    from repro_torch.configs import smoke_config
    from repro_torch.kernels import flash_attn
    from repro_torch.launch.steps import build_prefill
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.model import Model

    cfg = replace(smoke_config("llama3.2-3b"), remat=False, head_dim=64)
    model = Model.init(cfg, seed=0, dtype=torch.bfloat16)
    toks = torch.randint(0, cfg.vocab, (2, 128), device="cuda")
    want = model.prefill({"tokens": toks})
    step, _ = build_prefill(one_rank_mesh, cfg, ShapeConfig("s", 128, 2, "s"))
    flash_attn.reset_launches()
    got = step(model, {"tokens": toks})
    assert flash_attn.LAUNCHES["flash_attention"] == cfg.n_layers
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_sharded_train_step_matches_unsharded(one_rank_mesh):
    from dataclasses import replace

    from repro_torch.configs import smoke_config
    from repro_torch.launch.steps import build_train, make_train_step
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw

    cfg = replace(smoke_config("llama3.2-3b"), remat=True, accum_steps=2,
                  head_dim=64)
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=1)
    toks = torch.randint(0, cfg.vocab, (4, 128), device="cuda")
    batch = {"tokens": toks, "labels": toks}
    ref = Model.init(cfg, seed=0, dtype=torch.bfloat16)
    model = Model.init(cfg, seed=0, dtype=torch.bfloat16)
    _, _, m1 = make_train_step(cfg, opt_cfg)(
        ref, adamw.init(dict(ref.named_parameters()), opt_cfg), batch)
    step, _ = build_train(one_rank_mesh, cfg, ShapeConfig("t", 128, 4, "t"),
                          opt_cfg, fsdp=True)
    sharded, _, m2 = step(model, adamw.init(dict(model.named_parameters()),
                                            opt_cfg), batch)
    # one rank runs the unsharded step's kernels on the same tensors: the
    # loss and the clip norm agree to 1e-5, and every weight to an eighth
    # of the step's learning rate (a wrong or missing gradient moves a
    # weight by about the learning rate)
    for key in ("loss", "grad_norm"):
        a, b = float(m1[key]), float(m2[key])
        assert abs(a - b) <= F32_TOL * abs(a), (key, a, b)
    lr = float(m1["lr"])
    for (n, a), b in zip(ref.named_parameters(), sharded.parameters()):
        err = float((a.detach().float() - b.detach().full_tensor().float()).abs().max())
        assert err <= lr / 8, (n, err, lr)
