"""Gloo worlds of CPU processes for the port's multi-device tests.

:func:`run_world` starts ``world`` processes of this file, each one rank of
a gloo process group initialised through a ``file://`` store in the test's
``tmp_path`` (no port, so parallel test files never collide), with one
thread each and a timeout on every collective.  Each runs one scenario
below against the port only (no JAX); rank 0 writes what the test checks
with ``torch.save``.  A world that does not finish within its time limit
is killed and fails its test.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch

SRC = str(Path(__file__).resolve().parent.parent / "src")
COLLECTIVE_TIMEOUT = 90  # seconds, per collective


def run_world(tmp_path: Path, world: int, *calls, timeout: float = 150) -> list:
    """Run each ``(scenario, kwargs)`` of ``calls`` in turn on ``world``
    ranks; rank 0's results, one per call."""
    out = tmp_path / "result.pt"
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1")
    args = [sys.executable, __file__, str(world), str(tmp_path / "init"),
            str(out), json.dumps(calls)]
    procs = [subprocess.Popen(args + [str(r)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    deadline = time.monotonic() + timeout
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(
                timeout=max(deadline - time.monotonic(), 1))[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        raise AssertionError(f"{calls} on {world} ranks passed {timeout} s")
    bad = [(r, p.returncode, log[-3000:]) for r, (p, log)
           in enumerate(zip(procs, logs)) if p.returncode]
    assert not bad, bad[0]
    return torch.load(out, weights_only=False)


# --------------------------------------------------------------------------- #
# scenarios (run inside each rank)
# --------------------------------------------------------------------------- #


def _cfg(arch: str, **over):
    from dataclasses import replace

    from repro_torch.configs import smoke_config

    return replace(smoke_config(arch), remat=False, **over)


def _batch(cfg, B: int, S: int, seed: int = 0) -> dict:
    """The reference test's batch: tokens = labels, plus zero patches or
    seeded frames for the stubs."""
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)).astype(np.int32))
    if cfg.encdec:
        frames = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
        return {"frames": torch.from_numpy(frames).bfloat16(), "tokens": toks}
    if cfg.frontend == "vision":
        t = toks[:, : S - cfg.n_patches]
        return {"patches": torch.zeros((B, cfg.n_patches, cfg.d_model),
                                       dtype=torch.bfloat16),
                "tokens": t, "labels": t}
    return {"tokens": toks, "labels": toks}


def _max_diff(a, b) -> float:
    return max(float((x.float() - y.float()).abs().max()) for x, y in zip(a, b))


def _full_params(model) -> list:
    return [p.full_tensor() if hasattr(p, "full_tensor") else p
            for p in model.parameters()]


def _rank0() -> bool:
    import torch.distributed as dist

    return dist.get_rank() == 0


def train(arch: str, mesh_shape, fsdp: bool = True, accum: int = 1,
          count_comms: bool = False, **over) -> dict:
    """One sharded ``build_train`` step; rank 0 then runs the single-device
    step of the same model, optimizer state and batch and compares."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_train, make_train_step
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw

    cfg = _cfg(arch, accum_steps=accum, **over)
    mesh = make_host_mesh(*mesh_shape[-2:], *mesh_shape[:-2], device_type="cpu")
    shape = ShapeConfig("t", 32, 8, "train")
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=1)
    batch = _batch(cfg, 8, 32)
    model = Model.init(cfg, seed=0, device="cpu")
    opt = adamw.init(dict(model.named_parameters()), opt_cfg)
    jitted, _ = build_train(mesh, cfg, shape, opt_cfg, fsdp=fsdp)
    comms = {}
    if count_comms:
        from torch.distributed.tensor.debug import CommDebugMode

        with CommDebugMode() as mode:
            sharded, opt_s, m2 = jitted(model, opt, batch)
        comms = {str(k).split(".")[-1]: v
                 for k, v in mode.get_comm_counts().items()}
    else:
        sharded, opt_s, m2 = jitted(model, opt, batch)
    placements = {n: tuple(str(pl) for pl in p.placements)
                  for n, p in sharded.named_parameters()}
    moments = all(opt_s.m[n].placements == p.placements
                  for n, p in sharded.named_parameters())
    got = _full_params(sharded)  # a collective: every rank
    if not _rank0():
        return {}
    single = Model.init(cfg, seed=0, device="cpu")
    _, _, m1 = make_train_step(cfg, opt_cfg)(
        single, adamw.init(dict(single.named_parameters()), opt_cfg), batch)
    return {"loss": (float(m1["loss"]), float(m2["loss"])),
            "grad_norm": (float(m1["grad_norm"]), float(m2["grad_norm"])),
            "weights": _max_diff(_full_params(single), got),
            "placements": placements, "moments_follow_weights": moments,
            "comms": comms}


def train_from(path: str, dtype: str) -> dict:
    """The sharded step of ``llama3.2-3b``'s smoke config on ``(4, 2)``
    with FSDP from the JAX package's weights in ``path`` (its ``M.init``
    and its own sharded step's result, pickled as numpy); rank 0 compares
    the loss, the clip norm and every weight."""
    import pickle

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_train
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.model import flat_numpy, params_from_numpy
    from repro_torch.optim import adamw

    with open(path, "rb") as f:
        ref = pickle.load(f)[dtype]
    cfg = _cfg("llama3.2-3b", dtype=dtype)
    mesh = make_host_mesh(4, 2, device_type="cpu")
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=1)
    model = params_from_numpy(cfg, ref["init"], "cpu")
    step, _ = build_train(mesh, cfg, ShapeConfig("t", 32, 8, "train"),
                          opt_cfg, fsdp=True)
    sharded, _, m = step(model, adamw.init(dict(model.named_parameters()),
                                           opt_cfg), _batch(cfg, 8, 32))
    got = dict(zip((n for n, _ in sharded.named_parameters()),
                   _full_params(sharded)))
    if not _rank0():
        return {}
    want = flat_numpy(cfg, ref["after"])
    assert sorted(want) == sorted(got), sorted(set(want) ^ set(got))
    return {"loss": (ref["loss"], float(m["loss"])),
            "grad_norm": (ref["grad_norm"], float(m["grad_norm"])),
            "weights": max(float((got[k].float() - torch.from_numpy(w)).abs().max())
                           for k, w in want.items())}


def serve(arch: str, mesh_shape, steps: int = 4, **over) -> dict:
    """``build_prefill`` and greedy ``build_decode``; rank 0 then holds
    them to the unsharded ``prefill`` and ``decode_step`` of the same
    weights."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import (build_decode, build_prefill,
                                          param_shardings, shard_model)
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.model import Model

    cfg = _cfg(arch, **over)
    mesh = make_host_mesh(*mesh_shape, device_type="cpu")
    B, S = 8, 32
    shape = ShapeConfig("s", S + steps, B, "serve")
    model = Model.init(cfg, seed=0, device="cpu")
    batch = _batch(cfg, B, S)
    batch.pop("labels", None)
    prefill, _ = build_prefill(mesh, cfg, shape)
    decode, _ = build_decode(mesh, cfg, shape)

    def greedy(step, m):
        state, tok, out = model.init_decode_state(B, S + steps), \
            batch["tokens"][:, :1], []
        for _ in range(steps):
            logits, state = step(m, state, tok)
            tok = logits.argmax(-1)
            out.append(logits)
        return out, state

    sharded = shard_model(model, param_shardings(mesh, cfg, fsdp=False)[2])
    got, got_dec = prefill(sharded, batch), greedy(decode, sharded)
    if not _rank0():
        return {}
    want = model.prefill(batch)
    want_dec = greedy(lambda m, st, t: m.decode_step(st, t), model)
    dec_err = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(want_dec[0], got_dec[0]))
    same = all(torch.equal(a.argmax(-1), b.argmax(-1))
               for a, b in zip(want_dec[0], got_dec[0]))
    cache = {k: tuple(str(pl) for pl in v.placements)
             for k, v in got_dec[1].items() if hasattr(v, "placements")}
    want, got = (t[..., :cfg.vocab].float() for t in (want, got))
    rms = float((got - want).square().mean().sqrt() / want.square().mean().sqrt())
    return {"prefill": float((want - got).abs().max()),
            "prefill_scale": float(want.abs().max()), "prefill_rms": rms,
            "decode": dec_err, "same_tokens": same, "cache": cache}


def checkpoint(ckpt_dir: str, jax_dir: str = "") -> dict:
    """Elastic restore: a tree saved from a ``(4, 2)`` layout restored
    onto ``(2, 4)``; a sharded train state saved and restored bit for bit;
    a checkpoint of the JAX package restored onto a port mesh."""
    from repro_torch.checkpoint.manager import (CheckpointManager, flatten,
                                                train_state, unflatten)
    from repro_torch.compat import DTensor
    from repro_torch.distrib.sharding import NamedSharding, layout_of
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_train
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw

    out = {}
    tree = {"w": torch.arange(256, dtype=torch.float32).reshape(16, 16)}
    mesh_a = make_host_mesh(data=4, model=2, device_type="cpu")
    mesh_b = make_host_mesh(data=2, model=4, device_type="cpu")
    placed = {"w": NamedSharding(mesh_a, ("data", "model")).distribute(tree["w"])}
    cm = CheckpointManager(Path(ckpt_dir) / "elastic")
    cm.save(3, placed)
    sh_b = {"w": NamedSharding(mesh_b, ("data", "model"))}
    step, restored = cm.restore(tree, shardings=sh_b)
    w = restored["w"]
    out["elastic"] = (step, bool(torch.equal(w.full_tensor(), tree["w"])),
                      tuple(str(p) for p in w.placements),
                      tuple(w.to_local().shape))

    cfg = _cfg("llama3.2-3b")
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=1)
    jitted, _ = build_train(mesh_a, cfg, ShapeConfig("t", 32, 8, "train"),
                            opt_cfg, fsdp=True)
    model = Model.init(cfg, seed=0, device="cpu")
    model, opt, _ = jitted(model, adamw.init(dict(model.named_parameters()),
                                             opt_cfg), _batch(cfg, 8, 32))
    state = train_state(model, opt)
    cm2 = CheckpointManager(Path(ckpt_dir) / "train")
    cm2.save(1, state)
    layouts = unflatten(state, [layout_of(x) if isinstance(x, DTensor) else None
                                for _, x in flatten(state)])
    _, back = cm2.restore(state, shardings=layouts)
    pairs = list(zip(flatten(state), flatten(back)))
    out["train_state"] = all(
        _bits(a) == _bits(b) and _layout(a) == _layout(b)
        for (_, a), (_, b) in pairs)
    out["train_leaves"] = len(pairs)

    if jax_dir:
        like = {"w": np.zeros((16, 16), np.float32),
                "b": np.zeros((8, 32), np.float32),
                "i": np.zeros((16,), np.int32)}
        sh = {"w": NamedSharding(mesh_b, ("data", "model")),
              "b": NamedSharding(mesh_b, (None, "model")),
              "i": NamedSharding(mesh_b, ("data",))}
        step, got = CheckpointManager(jax_dir).restore(like, shardings=sh)
        out["jax"] = (step, {k: _bits(v) for k, v in got.items()},
                      {k: tuple(str(p) for p in v.placements)
                       for k, v in got.items()})
    return out


def _layout(x):
    return tuple(str(p) for p in x.placements) if hasattr(x, "placements") else None


def _bits(x) -> bytes:
    x = x.full_tensor() if hasattr(x, "full_tensor") else x
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        return x.view(torch.uint8).numpy().tobytes() if x.dim() else \
            x.reshape(1).view(torch.uint8).numpy().tobytes()
    return np.asarray(x).tobytes()


def lineage(queries, sf: float = 0.002) -> dict:
    """``distributed_refine`` over a ``data = world`` process mesh against
    ``query_iterative`` on one process, per query."""
    import torch.distributed as dist

    from repro_torch.core import PredTrace
    from repro_torch.core.distributed import distributed_refine
    from repro_torch.core.scan import ScanEngine
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.tpch import ALL_QUERIES, generate

    db = generate(sf=sf, seed=1)
    mesh = make_host_mesh(data=dist.get_world_size(), model=1,
                          device_type="cpu")
    out = {}
    for q in queries:
        plan = ALL_QUERIES[q](db)
        pt = PredTrace(db, plan, device="cpu")
        pt.infer_iterative()
        pt.run_unmodified()
        if pt.exec_result.output.nrows == 0:
            out[q] = None
            continue
        local = pt.query_iterative(0)
        engine = ScanEngine("torch", device="cpu")
        dist_ans = distributed_refine(pt.iter_plan, db, pt._output_binding(0),
                                      mesh, engine=engine)
        tabs = set(local.lineage) | set(dist_ans.lineage)
        out[q] = {t: (sorted(np.asarray(local.lineage.get(t, [])).tolist()),
                      sorted(np.asarray(dist_ans.lineage.get(t, [])).tolist()))
                  for t in tabs}
        out[q + "_scans"] = engine.stats.device_scans
    return out


SCENARIOS = {"train": train, "train_from": train_from, "serve": serve,
             "checkpoint": checkpoint, "lineage": lineage}


def main(world: str, init: str, out: str, calls: str, rank: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}",
                            rank=int(rank), world_size=int(world),
                            timeout=timedelta(seconds=COLLECTIVE_TIMEOUT))
    try:
        results = [SCENARIOS[name](**kw) for name, kw in json.loads(calls)]
        if dist.get_rank() == 0:
            torch.save(results, out)
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:])
