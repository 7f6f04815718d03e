"""Weights and inputs made from ``--seed``, on the device, by the benchmark.

Both sides get the same tensors: the port loads them by name, and the
reference makes them again from the same seed after the window.  Leaves are
named and shaped as the port's ``Model`` holds its weights at the published
vocabulary (the port pads it itself; :mod:`benchlib.program`):

* ``embed [V, d]``, ``lm_head [d, V]``, ``final_norm [d]``;
* per layer ``i``: ``layers.i.norm1 [d]``, ``layers.i.attn.wq [d, H, hd]``,
  ``wk``/``wv [d, Hkv, hd]``, ``wo [H, hd, d]``, with ``qkv_bias`` also
  ``bq [H, hd]``, ``bk``/``bv [Hkv, hd]``; ``layers.i.norm2 [d]``,
  ``layers.i.ffn.w_gate``/``w_up [d, f]``, ``w_down [f, d]``.

Matrices are drawn in bf16 by one ``randn`` call over all of them, each then
scaled by ``1 / sqrt(fan_in)``; norm weights are ``1 + 0.1 z`` and biases
``0.1 z`` in float32, from a second call.  Token ids are uniform over the
published vocabulary.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, List, Tuple

import torch

Leaf = Tuple[str, Tuple[int, ...], str, int]  # name, shape, kind, fan_in


def derived_seed(seed: int, *salt: int) -> int:
    """A 63-bit seed for one stream of ``seed`` (any whole number)."""
    digest = hashlib.blake2b(repr((int(seed),) + salt).encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1


def generator(device, seed: int, *salt: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derived_seed(seed, *salt))


def leaves(conf: dict) -> List[Leaf]:
    """Every weight of the configuration in a fixed order."""
    d, f, V = conf["hidden_size"], conf["intermediate_size"], conf["vocab_size"]
    H, kv = conf["num_attention_heads"], conf["num_key_value_heads"]
    hd = conf.get("head_dim") or d // H
    out: List[Leaf] = [("embed", (V, d), "matrix", d)]
    for i in range(conf["num_hidden_layers"]):
        p = f"layers.{i}."
        out += [(p + "norm1", (d,), "norm", 0),
                (p + "attn.wq", (d, H, hd), "matrix", d),
                (p + "attn.wk", (d, kv, hd), "matrix", d),
                (p + "attn.wv", (d, kv, hd), "matrix", d),
                (p + "attn.wo", (H, hd, d), "matrix", H * hd)]
        if conf.get("qkv_bias"):
            out += [(p + "attn.bq", (H, hd), "bias", 0),
                    (p + "attn.bk", (kv, hd), "bias", 0),
                    (p + "attn.bv", (kv, hd), "bias", 0)]
        out += [(p + "norm2", (d,), "norm", 0),
                (p + "ffn.w_gate", (d, f), "matrix", d),
                (p + "ffn.w_up", (d, f), "matrix", d),
                (p + "ffn.w_down", (f, d), "matrix", f)]
    out += [("final_norm", (d,), "norm", 0), ("lm_head", (d, V), "matrix", d)]
    return out


@torch.no_grad()
def make(conf: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The weights of ``seed``: views into two flat buffers, one bf16 (the
    matrices), one float32 (the rest)."""
    specs = leaves(conf)
    sizes = {"matrix": 0, "vector": 0}
    for _, shape, kind, _ in specs:
        sizes["matrix" if kind == "matrix" else "vector"] += math.prod(shape)
    mats = torch.randn(sizes["matrix"], generator=generator(device, seed, 0),
                       device=device, dtype=torch.bfloat16)
    vecs = torch.randn(sizes["vector"], generator=generator(device, seed, 1),
                       device=device, dtype=torch.float32)
    out, at = {}, {"matrix": 0, "vector": 0}
    for name, shape, kind, fan_in in specs:
        buf = "matrix" if kind == "matrix" else "vector"
        n = math.prod(shape)
        t = (mats if buf == "matrix" else vecs)[at[buf]:at[buf] + n].view(shape)
        at[buf] += n
        if kind == "matrix":
            t.mul_(1.0 / math.sqrt(fan_in))
        elif kind == "norm":
            t.mul_(0.1).add_(1.0)
        else:
            t.mul_(0.1)
        out[name] = t
    return out


def tokens(conf: dict, seed: int, stream: int, index: int, shape, device) -> torch.Tensor:
    """int32 ids uniform over the published vocabulary, for input ``index``
    of ``stream``."""
    return torch.randint(0, conf["vocab_size"], shape, generator=generator(
        device, seed, stream, index), device=device, dtype=torch.int32)


def patches(conf: dict, seed: int, stream: int, index: int, batch: int,
            device) -> torch.Tensor:
    """``[batch, n_patches, d]`` bf16 patch embeddings at the token
    embeddings' scale (the stubbed vision tower's output)."""
    d = conf["hidden_size"]
    g = generator(device, seed, stream, index, 1)
    x = torch.randn((batch, conf["n_patches"], d), generator=g, device=device,
                    dtype=torch.bfloat16)
    return x.mul_(1.0 / math.sqrt(d))
