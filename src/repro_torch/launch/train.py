"""End-to-end training program.

Wires together the lineage-aware data pipeline (PredTrace over the
corpus-selection plan), the train step, AdamW, fault-tolerant checkpointing
with resume, and the cluster controller's heartbeat loop.  Runs on the CUDA
card unless ``--device cpu`` asks for the kernels' plain versions:

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b --smoke \\
      --steps 12 --batch 4 --seq 64 --ckpt-dir build/ckpt --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --steps 12 --batch 4 --seq 512 --ckpt-every 6 --ckpt-dir build/ckpt

The weights are the model's dtype in its matrices and float32 in its norms,
biases and SSM constants (``Model``); the step runs one microbatch per
batch (``accum_steps`` of the config) with remat off, as the reference's
``launch/train.py`` sets it.  The step is ``build_train(mesh, ...,
fsdp=False)`` on a ``(world, 1)`` ``("data", "model")`` mesh: one rank on
its own, ``WORLD_SIZE`` ranks under ``torchrun`` (each rank one card, or
one CPU process under gloo with ``--device cpu``), the batch split over
``data``; rank 0 prints.
"""

from __future__ import annotations

import argparse
import os
import time
from dataclasses import replace

import numpy as np
import torch
import torch.distributed as dist

from ..checkpoint.manager import CheckpointManager, train_state
from ..compat import AxisType, make_mesh
from ..configs import get, smoke_config
from ..data.pipeline import LineageDataPipeline, synth_corpus
from ..models.config import ShapeConfig
from ..models.model import Model, _dt
from ..optim import adamw
from ..runtime.controller import ClusterController
from .steps import build_train


def make_batch(raw, cfg, seq: int, device) -> dict:
    """The model's inputs for one pipeline batch: tokens and labels, zero
    patches ahead of the text for the VLM stub, zero frames for the
    encoder-decoder."""
    B = raw["tokens"].shape[0]
    dt = _dt(cfg)
    batch = {"tokens": raw["tokens"], "labels": raw["labels"]}
    if cfg.frontend == "vision":
        batch = {k: v[:, : seq - cfg.n_patches] for k, v in batch.items()}
    batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    if cfg.frontend == "vision":
        batch["patches"] = torch.zeros((B, cfg.n_patches, cfg.d_model), dtype=dt,
                                       device=device)
    if cfg.encdec:
        batch = {"frames": torch.zeros((B, seq, cfg.d_model), dtype=dt, device=device),
                 "tokens": batch["tokens"]}
    return batch


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--ckpt-dir", default="build/repro_ckpt")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the kernels' plain versions)")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch) if args.smoke else get(args.arch)
    cfg = replace(cfg, remat=False)  # small models: remat off is faster
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    opt_cfg = adamw.AdamWConfig(lr=args.lr, total_steps=args.steps, warmup_steps=5)

    device_type = "cpu" if args.device == "cpu" else "cuda"
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1 and not dist.is_initialized():  # torchrun's rendezvous
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo")
    mesh = make_mesh((world, 1), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2, device_type=device_type)
    step_fn, _ = build_train(mesh, cfg, shape, opt_cfg, fsdp=False)
    log = print if dist.get_rank() == 0 else (lambda *a, **k: None)

    model = Model.init(cfg, seed=0, device=args.device, dtype=_dt(cfg))
    dev = model.device

    # lineage-aware data pipeline (vocab-matched to the model)
    catalog, tokens = synth_corpus(n_docs=512, vocab=cfg.vocab, seed=0)
    pipe = LineageDataPipeline(catalog, tokens, seq_len=args.seq,
                               batch=args.batch, seed=0, device=dev)
    log(f"[data] selected {pipe.selected.nrows} docs; "
        f"{len(pipe.pt.lineage_plan.stages)} intermediate(s) materialized")

    opt_state = adamw.init(dict(model.named_parameters()), opt_cfg)

    ckpt = CheckpointManager(args.ckpt_dir, keep=2)
    start_step = 0
    if args.resume and ckpt.list_steps():
        start_step, tree = ckpt.restore(train_state(model, opt_state), device=dev)
        model.load_state_dict(tree["params"])
        opt_state = tree["opt"]
        log(f"[ckpt] resumed from step {start_step}")

    ctrl = ClusterController(n_workers=1)
    losses = []
    for step in range(start_step, args.steps):
        t0 = time.perf_counter()
        batch = make_batch(pipe.batch_at(step), cfg, args.seq, dev)
        model, opt_state, metrics = step_fn(model, opt_state, batch)
        loss = float(metrics["loss"])  # waits for the step
        dt = time.perf_counter() - t0
        ctrl.beat(0, step_time=dt)
        losses.append(loss)
        if step % 10 == 0 or step == args.steps - 1:
            log(f"step {step:4d} loss {loss:.4f} gnorm {float(metrics['grad_norm']):.3f} "
                f"({dt*1e3:.0f} ms)")
        if (step + 1) % args.ckpt_every == 0:
            path = ckpt.save(step + 1, train_state(model, opt_state))
            log(f"[ckpt] saved {path.name}")

    if not np.isfinite(losses).all():
        raise FloatingPointError(f"non-finite loss: {losses}")
    if len(losses) > 10:
        first, last = np.mean(losses[:5]), np.mean(losses[-5:])
        log(f"[train] loss {first:.3f} -> {last:.3f} "
            f"({'improved' if last < first else 'NOT improved'})")
    # demonstrate the paper's feature on the just-used data
    raw = pipe.batch_at(start_step)
    did = int(raw["doc_ids"][0, 0])
    ans = pipe.lineage_of(did)
    log(f"[lineage] doc {did} traces to "
        + ", ".join(f"{k}: {len(v)} rows" for k, v in ans.lineage.items())
        + f" in {ans.seconds*1e3:.1f} ms")
    return losses


if __name__ == "__main__":
    main()
