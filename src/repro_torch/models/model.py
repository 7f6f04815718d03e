"""Model assembly: init, loss, prefill and decode for every family (dense,
MoE, hybrid attention + SSM, xLSTM, encoder-decoder, VLM stub).

:class:`Model` holds the weights under the reference's names: a layer's
weight ``layers.<i>.attn.wq`` is row ``i`` of the reference's stacked
``params["layers"]["attn"]["wq"]`` (:func:`params_from_numpy` carries a
reference tree across).  Layers are a ``ModuleList`` run in a Python loop;
with ``cfg.remat`` the training loss runs each block under
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``).  The decode
cache is written in place.  Everything runs on the CUDA card unless the
caller passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import trace
from ..distrib.sharding import local_call, replicate_like, shard
from . import layers as L
from . import ssm as S
from .config import ArchConfig


def _dt(cfg: ArchConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; the CPU only when the caller asks for it.
    Raises when a CUDA device is asked for and none is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("repro_torch models run on a CUDA device by default "
                           "and none is available; pass device='cpu'")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev


# the reference stacks these layer lists on a leading [n_layers] dim
STACKED = ("layers", "encoder", "decoder")


def _is_slstm(cfg: ArchConfig, i: int) -> bool:
    return i % cfg.slstm_every == cfg.slstm_every - 1


def cache_size(cfg: ArchConfig, seq_len: int) -> int:
    if cfg.sliding_window is not None:
        return min(cfg.sliding_window, seq_len)
    return seq_len


# --------------------------------------------------------------------------- #
# modules
# --------------------------------------------------------------------------- #


class Block(nn.Module):
    """One decoder block (``cross``: the encoder-decoder's cross attention)."""

    SPECS = {"norm1": ("embed",), "norm2": ("embed",), "norm_cross": ("embed",)}

    def __init__(self, cfg: ArchConfig, cross: bool = False, **kw):
        super().__init__()
        self.norm1 = L.param((cfg.d_model,), **L.float32(kw))
        self.attn = L.Attention(cfg, **kw)
        if cfg.parallel_ssm:
            self.ssm = S.Mamba(cfg, **kw)
        if cfg.d_ff > 0:
            self.norm2 = L.param((cfg.d_model,), **L.float32(kw))
            self.ffn = L.MoE(cfg, **kw) if cfg.moe is not None else L.SwiGLU(cfg, **kw)
        if cross:
            self.cross = L.Attention(cfg, **kw)
            self.norm_cross = L.param((cfg.d_model,), **L.float32(kw))

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator, cfg: ArchConfig) -> None:
        for name in ("norm1", "norm2", "norm_cross"):
            if hasattr(self, name):
                getattr(self, name).fill_(1.0)

    def forward(self, x, cfg: ArchConfig, causal: bool = True):
        h = L.rmsnorm(x, self.norm1, cfg.norm_eps)
        att = L.attention(self.attn, h, cfg, causal=causal)
        if cfg.parallel_ssm:
            att = 0.5 * (att + S.mamba_forward(self.ssm, h, cfg))  # hymba
        return self._ffn(x + att, cfg)

    def forward_decdec(self, x, enc_out, cfg: ArchConfig):
        h = x + L.attention(self.attn, L.rmsnorm(x, self.norm1, cfg.norm_eps),
                            cfg, causal=True)
        hc = L.rmsnorm(h, self.norm_cross, cfg.norm_eps)
        return self._ffn(h + L.cross_attention(self.cross, hc, enc_out, cfg), cfg)

    def _ffn(self, x, cfg: ArchConfig):
        if cfg.d_ff == 0:
            return x
        h2 = L.rmsnorm(x, self.norm2, cfg.norm_eps)
        if cfg.moe is not None:
            return x + L.moe_ffn(self.ffn, h2, cfg)
        return x + L.swiglu(self.ffn, h2)


class XLSTMBlock(nn.Module):
    SPECS = {"norm1": ("embed",)}

    def __init__(self, cfg: ArchConfig, slstm: bool, **kw):
        super().__init__()
        self.norm1 = L.param((cfg.d_model,), **L.float32(kw))
        if slstm:
            self.kind_slstm = S.SLSTM(cfg, **kw)
        else:
            self.kind_mlstm = S.MLSTM(cfg, **kw)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator, cfg: ArchConfig) -> None:
        self.norm1.fill_(1.0)

    def forward(self, x, cfg: ArchConfig):
        h = L.rmsnorm(x, self.norm1, cfg.norm_eps)
        if hasattr(self, "kind_slstm"):
            return x + S.slstm_forward(self.kind_slstm, h, cfg)
        return x + S.mlstm_forward(self.kind_mlstm, h, cfg)

    def decode(self, x, state, cfg: ArchConfig):
        h = L.rmsnorm(x, self.norm1, cfg.norm_eps)
        if hasattr(self, "kind_slstm"):
            y, state = S.slstm_decode(self.kind_slstm, h, state, cfg)
        else:
            y, state = S.mlstm_decode(self.kind_mlstm, h, state, cfg)
        return x + y, state


class Model(nn.Module):
    """The weights of one architecture and its forward passes.

    ``Model(cfg, device, dtype)`` allocates uninitialised weights: the
    matrices (everything the reference draws with ``dense_init``) in
    ``dtype``, and the leaves the reference builds in float32 (norms, qkv
    biases, the SSM's ``conv_w``, ``A_log`` and ``D``) in float32 whatever
    ``dtype`` is, so a training step can move them.  At float32 this is the
    reference's ``M.init`` tree.  :meth:`init` draws them, and
    :func:`params_from_numpy` loads a reference tree.  Activations run in
    ``cfg.dtype``."""

    SPECS = {"embed": ("vocab", "embed"), "final_norm": ("embed",),
             "lm_head": ("embed", "vocab")}

    def __init__(self, cfg: ArchConfig, device=None, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        kw = dict(device=dev, dtype=dtype)
        V, d = cfg.padded_vocab, cfg.d_model
        self.embed = L.param((V, d), **kw)
        self.final_norm = L.param((d,), **L.float32(kw))
        self.lm_head = L.param((d, V), **kw)
        n = cfg.n_layers
        if cfg.xlstm:
            self.blocks = nn.ModuleList(
                XLSTMBlock(cfg, _is_slstm(cfg, i), **kw) for i in range(n))
        elif cfg.encdec:
            self.encoder = nn.ModuleList(Block(cfg, **kw) for _ in range(n))
            self.decoder = nn.ModuleList(Block(cfg, cross=True, **kw)
                                         for _ in range(n))
        else:
            self.layers = nn.ModuleList(Block(cfg, **kw) for _ in range(n))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def logical_specs(self) -> Dict[str, tuple]:
        """The reference's logical axis names of every weight (the second
        value of its ``M.init``), keyed like ``named_parameters()``.  A
        layer of a stacked stack (``layers``, ``encoder``, ``decoder``)
        carries the stacked leaf's spec, its leading layer dim (None)
        included."""
        out = {}
        for name, _ in self.named_parameters():
            path, _, leaf = name.rpartition(".")
            spec = (self.get_submodule(path) if path else self).SPECS[leaf]
            out[name] = (None,) + spec if name.split(".")[0] in STACKED else spec
        return out

    @classmethod
    @torch.no_grad()
    def init(cls, cfg: ArchConfig, seed: int = 0, device=None,
             dtype=torch.float32) -> "Model":
        """Random weights from a ``torch.Generator`` seeded with ``seed`` on
        the target device: ``N(0, 1) / sqrt(fan_in)`` drawn in float32 and
        cast to each leaf's dtype one tensor at a time; norms 1, biases 0;
        the SSM blocks' own constants as in the reference."""
        model = cls(cfg, device, dtype)
        gen = torch.Generator(device=model.device).manual_seed(seed)
        for mod in model.modules():  # each fills its own weights
            if hasattr(mod, "reset_parameters"):
                mod.reset_parameters(gen, cfg)
        return model

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator, cfg: ArchConfig) -> None:
        L.dense_init_(self.embed, gen, cfg.d_model)
        L.dense_init_(self.lm_head, gen, cfg.d_model)
        self.final_norm.fill_(1.0)

    # ---- forward pieces ---------------------------------------------------- #

    def _embed(self, tokens):
        x = L.embedding(tokens, self.embed).to(_dt(self.cfg))
        return shard(x, "batch", "seq", "embed")

    def _inputs_to_hidden(self, batch: Mapping[str, torch.Tensor]):
        """Map (modality-stubbed) inputs to the initial hidden sequence."""
        x = self._embed(batch["tokens"])
        if self.cfg.frontend == "vision":
            return torch.cat([batch["patches"].to(x.dtype), x], dim=1)
        return x

    def _logits(self, x):
        cfg = self.cfg
        x = L.rmsnorm(x, self.final_norm, cfg.norm_eps)
        logits = shard(x @ self.lm_head.to(x.dtype), "batch", "seq", "vocab")
        if cfg.padded_vocab != cfg.vocab:  # mask the padded tail
            pad = torch.arange(cfg.padded_vocab, device=x.device) >= cfg.vocab
            logits = logits.masked_fill(replicate_like(logits, pad), -1e30)
        return logits

    def _hidden(self, batch: Mapping[str, torch.Tensor], remat: bool = False):
        """The last hidden sequence of every family; with ``remat`` each
        block keeps only its input and recomputes the rest in the
        backward."""
        cfg = self.cfg

        def run(fn, *args, **kw):
            if remat:
                return checkpoint(fn, *args, use_reentrant=False, **kw)
            return fn(*args, **kw)

        def stack(blocks, x, *args, **kw):  # the reference's _run_stack
            x = shard(x, "batch", "seq_act", "embed")
            for fn in blocks:
                x = shard(run(fn, x, *args, **kw), "batch", "seq_act", "embed")
            return x

        if cfg.encdec:
            enc = shard(batch["frames"].to(_dt(cfg)), "batch", "seq", "embed")
            enc = stack(self.encoder, enc, cfg, causal=False)
            x = self._embed(batch["tokens"])
            return stack([b.forward_decdec for b in self.decoder], x, enc, cfg)
        x = self._inputs_to_hidden(batch)
        if cfg.xlstm:
            for blk in self.blocks:
                x = run(blk, x, cfg)
            return x
        return stack(self.layers, x, cfg)

    # ---- public API: loss / prefill / decode -------------------------------- #

    def loss_fn(self, batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """Next-token LM loss, differentiable in the weights (each block
        under ``torch.utils.checkpoint`` when ``cfg.remat``).  batch: tokens
        [B, S] (+ patches / frames for the stubs), labels [B, S_text]."""
        cfg = self.cfg
        remat = cfg.remat and torch.is_grad_enabled()
        x = self._hidden(batch, remat)
        with trace.span("model.head"):
            logits = self._logits(x)
            if cfg.encdec:
                return _xent(logits[:, :-1], batch["tokens"][:, 1:])
            if cfg.frontend == "vision":
                # loss only over text positions (after the patch prefix)
                logits = logits[:, cfg.n_patches:, :]
            return _xent(logits[:, :-1], batch["labels"][:, 1:])

    @torch.no_grad()
    def prefill(self, batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """Forward over a prompt, returning last-position logits [B, 1, V]."""
        return self._logits(self._hidden(batch)[:, -1:, :])

    def init_decode_state(self, batch: int, seq_len: int) -> Dict[str, Any]:
        """The decode cache: zeros, ``kv_pos`` -1 (empty), ``pos`` 0."""
        cfg, dev = self.cfg, self.device
        Sc = cache_size(cfg, seq_len)
        state: Dict[str, Any] = {
            "pos": 0,
            "kv_pos": torch.full((Sc,), -1, dtype=torch.int32, device=dev)}
        if cfg.xlstm:
            state["blocks"] = [
                S.slstm_state(cfg, batch, dev) if _is_slstm(cfg, i)
                else S.mlstm_state(cfg, batch, dev)
                for i in range(cfg.n_layers)]
            return state
        kshape = (cfg.n_layers, batch, Sc, cfg.n_kv_heads, cfg.hd)
        state["cache_k"] = torch.zeros(kshape, dtype=_dt(cfg), device=dev)
        state["cache_v"] = torch.zeros(kshape, dtype=_dt(cfg), device=dev)
        if cfg.parallel_ssm:
            d_in = cfg.ssm.expand * cfg.d_model
            state["ssm"] = torch.zeros((cfg.n_layers, batch, d_in,
                                        cfg.ssm.state_dim),
                                       dtype=torch.float32, device=dev)
        if cfg.encdec:
            state["enc_out"] = torch.zeros((batch, seq_len, cfg.d_model),
                                           dtype=_dt(cfg), device=dev)
        return state

    @torch.no_grad()
    def decode_step(self, state: Dict[str, Any], tokens):
        """One decode step for the whole batch; tokens [B, 1].  Writes the
        cache in place and returns (logits [B, 1, V], state)."""
        cfg = self.cfg
        x = self._embed(tokens)
        pos = state["pos"]
        if cfg.xlstm:
            for i, blk in enumerate(self.blocks):
                x, state["blocks"][i] = blk.decode(x, state["blocks"][i], cfg)
            state["pos"] = pos + 1
            return self._logits(x), state

        slot = pos % state["kv_pos"].shape[0]
        L.local_view(state["kv_pos"])[slot] = pos  # replicated
        stack = self.decoder if cfg.encdec else self.layers
        for i, blk in enumerate(stack):
            hn = L.rmsnorm(x, blk.norm1, cfg.norm_eps)
            att = L.attention_decode(blk.attn, hn, state["cache_k"][i],
                                     state["cache_v"][i], state["kv_pos"],
                                     slot, pos, cfg)
            if cfg.parallel_ssm:
                y, ssm = S.mamba_decode(blk.ssm, hn, state["ssm"][i], cfg)
                L.assign_(state["ssm"][i], ssm)
                att = 0.5 * (att + y)
            x = x + att
            if cfg.encdec:
                hc = L.rmsnorm(x, blk.norm_cross, cfg.norm_eps)
                x = x + L.cross_attention(blk.cross, hc, state["enc_out"], cfg)
            x = blk._ffn(x, cfg)
        state["pos"] = pos + 1
        return self._logits(x), state


def _nll(logits, labels):
    """Stable negative log-likelihoods in float32."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    return lse - torch.gather(logits, -1, labels[..., None].long())[..., 0]


def _xent(logits, labels):
    """Cross-entropy, mean over positions.  On DTensors each rank sums its
    own rows' losses over the whole vocabulary (the logits redistributed
    to ``Replicate`` over ``vocab``): a partial sum over the data axes."""
    total = local_call(lambda lg, lb: _nll(lg, lb).sum(), (logits, labels),
                       (("batch", None, None), ("batch", None)), ((), ()))
    return total / labels.numel()


# --------------------------------------------------------------------------- #
# weights carried across from the reference
# --------------------------------------------------------------------------- #


def _flatten(tree: Mapping, prefix: str, out: Dict[str, np.ndarray],
             layer: Optional[int] = None) -> None:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            _flatten(v, f"{prefix}{k}.", out, layer)
        else:
            a = np.asarray(v)
            out[f"{prefix}{k}"] = a if layer is None else a[layer]


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    """A numpy array on ``device``; ``ml_dtypes`` bfloat16 by its bits."""
    if a.dtype.name == "bfloat16":
        bits = torch.tensor(np.ascontiguousarray(a).view(np.int16))
        return bits.view(torch.bfloat16).to(device)
    return torch.tensor(a, device=device)


def flat_numpy(cfg: ArchConfig, tree: Mapping) -> Dict[str, np.ndarray]:
    """A reference parameter tree (``M.init(cfg, key)[0]``, or its
    gradients) as numpy arrays under the port's parameter names: the
    stacked ``[L, ...]`` leaves of ``layers``, ``encoder`` and ``decoder``
    split per layer, the xLSTM ``blocks`` list taken block by block."""
    flat: Dict[str, np.ndarray] = {}
    for key, sub in tree.items():
        if key in ("layers", "encoder", "decoder"):
            for i in range(cfg.n_layers):
                _flatten(sub, f"{key}.{i}.", flat, layer=i)
        elif key == "blocks":
            for i, blk in enumerate(sub):
                _flatten(blk, f"blocks.{i}.", flat)
        else:
            flat[key] = np.asarray(sub)
    return flat


def params_from_numpy(cfg: ArchConfig, tree: Mapping, device=None) -> Model:
    """A :class:`Model` holding the reference's ``M.init(cfg, key)[0]``,
    given as a nested dict of numpy arrays (:func:`flat_numpy`).  Each
    weight keeps its array's dtype, so a tree that mixes dtypes loads as it
    is."""
    dev = resolve_device(device)
    state = {k: _tensor(a, dev) for k, a in flat_numpy(cfg, tree).items()}
    model = Model(cfg, dev, state["embed"].dtype)
    model.load_state_dict(state, strict=True, assign=True)
    return model
