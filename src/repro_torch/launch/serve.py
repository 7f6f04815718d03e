"""Batched serving: the prompt fills the KV cache through decode
steps, then greedy decoding.  Runs on the CUDA card unless ``--device cpu``
asks for the plain PyTorch versions of the kernels:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b --smoke \\
      --batch 4 --prompt-len 64 --gen 16 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \\
      --batch 4 --prompt-len 128 --gen 32
"""

from __future__ import annotations

import argparse
import time
from dataclasses import replace

import numpy as np
import torch

from ..configs import get, smoke_config
from ..models.model import Model
from .steps import make_decode_step


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def generate(model: Model, prompt: torch.Tensor, gen: int):
    """Feed ``prompt`` [B, P] through decode steps (filling the cache), then
    decode ``gen`` tokens greedily.  Returns (tokens [B, gen] numpy, the
    last logits, prefill seconds, decode seconds)."""
    cfg, dev = model.cfg, model.device
    B, P = prompt.shape
    decode = make_decode_step(cfg)
    state = model.init_decode_state(B, P + gen)

    t0 = time.perf_counter()
    logits = None
    for i in range(P):
        logits, state = decode(model, state, prompt[:, i:i + 1])
    _sync(dev)
    prefill_s = time.perf_counter() - t0

    out = []
    t0 = time.perf_counter()
    tok = logits[:, -1, :].argmax(dim=-1)[:, None]
    for _ in range(gen):
        out.append(tok)
        logits, state = decode(model, state, tok)
        tok = logits[:, -1, :].argmax(dim=-1)[:, None]
    toks = torch.cat(out, dim=1).cpu().numpy()
    decode_s = time.perf_counter() - t0
    return toks, logits, prefill_s, decode_s


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the kernels' plain versions)")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch) if args.smoke else get(args.arch)
    cfg = replace(cfg, remat=False)
    B, P, G = args.batch, args.prompt_len, args.gen

    model = Model.init(cfg, seed=0, device=args.device, dtype=torch.bfloat16)
    rng = np.random.default_rng(0)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (B, P))).to(model.device)

    gen, logits, prefill_s, decode_s = generate(model, prompt, G)
    if gen.shape != (B, G):
        raise AssertionError(f"generated {gen.shape}, want {(B, G)}")
    if not torch.isfinite(logits[..., :cfg.vocab].float()).all():
        raise AssertionError("non-finite logits")
    print(f"[serve] {args.arch}: prefill {P} toks in {prefill_s:.2f}s, "
          f"decode {G} toks in {decode_s:.2f}s "
          f"({G * B / max(decode_s, 1e-9):.1f} tok/s batch={B})")
    print("[serve] sample:", gen[0][:12].tolist())
    return gen


if __name__ == "__main__":
    main()
