"""Step builders: the train, prefill and decode steps of a :class:`Model`,
on one device or sharded over a ``DeviceMesh``, and the shapes and layouts
of their inputs.

* ``make_*_step(cfg)``: the steps themselves.  On a model with plain
  tensors they run on its device as they always have; on a model whose
  weights are DTensors they run under the mesh (activations DTensors,
  ``shard`` annotations redistributing them).
* ``build_*(mesh, cfg, shape)``: the reference's builders.  Each returns
  ``(step, abstract inputs)``; the step takes the port's ``Model`` (or a
  sharded copy of it) and places its weights by :func:`param_shardings`
  (``tree_sharding``, with FSDP for training), the batch by
  :func:`batch_shardings` and the decode state by
  :func:`decode_state_shardings`, the counterparts of ``jax.jit``'s
  ``in_shardings``.  Inputs given as plain tensors must be equal on every
  rank (the global batch, weights from one seed).

Parameter shapes and specs are the reference's ``M.init`` tree leaf for
leaf, keyed by the port's parameter names: a layer of ``layers``,
``encoder`` or ``decoder`` carries the stacked ``[n_layers, ...]`` shape
and spec, and its own tensor takes the layout of one slice of it.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, NamedTuple, Optional

import torch
from torch import nn

from .. import trace
from ..compat import DTensor, DeviceMesh
from ..distrib.sharding import (NamedSharding, fsdp_spec, layout_of, spec_for,
                               tree_sharding)
from ..models.config import ArchConfig, ShapeConfig
from ..models.model import Model
from ..optim import adamw


class SDS(NamedTuple):
    """A shape and dtype, ``jax.ShapeDtypeStruct``'s counterpart."""
    shape: tuple
    dtype: torch.dtype


# --------------------------------------------------------------------------- #
# parameter shapes / specs / shardings
# --------------------------------------------------------------------------- #


def param_shapes_and_specs(cfg: ArchConfig):
    """(shapes, specs) keyed by parameter name: the reference's float32
    ``M.init`` leaves (stacked layers with their layer dim) and logical
    axis names.  Nothing is allocated."""
    model = Model(cfg, device="meta")
    specs = model.logical_specs()
    shapes = {n: SDS(((cfg.n_layers,) if len(specs[n]) > p.ndim else ())
                     + tuple(p.shape), torch.float32)
              for n, p in model.named_parameters()}
    return shapes, specs


def param_shardings(mesh, cfg: ArchConfig, fsdp: bool = True):
    shapes, specs = param_shapes_and_specs(cfg)
    return shapes, specs, tree_sharding(mesh, shapes, specs, fsdp=fsdp)


def serve_param_shapes(shapes):
    """bf16 copies for inference."""
    return {k: SDS(s.shape, torch.bfloat16) for k, s in shapes.items()}


def leaf_sharding(sharding: NamedSharding, shape, ndim: int) -> NamedSharding:
    """The layout of one layer's tensor (``ndim`` dims) of a stacked leaf
    of ``shape``: its slice of the stacked layout.  Where FSDP put the
    layer dim itself on a mesh axis (a leaf whose other dims the axis does
    not divide), the reference holds whole layers per rank; a layer's own
    tensor then takes FSDP over its own dims, or stays replicated."""
    extra = len(shape) - ndim
    if not extra:
        return sharding
    spec = sharding.spec[extra:]
    if any(e is not None for e in sharding.spec[:extra]):
        spec = fsdp_spec(sharding.mesh, shape[extra:], spec)
    return NamedSharding(sharding.mesh, spec)


def shard_model(model: Model, shardings: Mapping[str, NamedSharding],
                shapes: Optional[Mapping[str, SDS]] = None) -> Model:
    """``model`` with each weight a DTensor in its layout (``shardings`` of
    :func:`param_shardings`): a new ``Model`` holding the moved weights,
    or ``model`` itself when every weight is in its layout already."""
    if shapes is None:
        shapes, _ = param_shapes_and_specs(model.cfg)
    moved = {}
    for name, p in model.named_parameters():
        sh = leaf_sharding(shardings[name], shapes[name].shape, p.ndim)
        if not (isinstance(p, DTensor) and tuple(p.placements) == sh.placements):
            moved[name] = nn.Parameter(sh.distribute(_full(p.detach())),
                                       requires_grad=p.requires_grad)
    if not moved:
        return model
    out = Model(model.cfg, device="meta")
    for name, p in model.named_parameters():
        path, _, leaf = name.rpartition(".")
        setattr(out.get_submodule(path) if path else out, leaf,
                moved.get(name, p))
    return out


def _mesh_of(model: Model) -> Optional[DeviceMesh]:
    w = model.embed
    return w.device_mesh if isinstance(w, DTensor) else None


# --------------------------------------------------------------------------- #
# batch specs
# --------------------------------------------------------------------------- #

BATCH_LOGICAL = {
    "frames": ("batch", "seq", "embed"),
    "tokens": ("batch", "seq"),
    "labels": ("batch", "seq"),
    "patches": ("batch", None, "embed"),
}


def batch_specs(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, SDS]:
    B, S = shape.global_batch, shape.seq_len
    i32, bf16 = torch.int32, torch.bfloat16
    if cfg.encdec:
        return {"frames": SDS((B, S, cfg.d_model), bf16),
                "tokens": SDS((B, S), i32)}
    if cfg.frontend == "vision":
        return {"patches": SDS((B, cfg.n_patches, cfg.d_model), bf16),
                "tokens": SDS((B, S - cfg.n_patches), i32),
                "labels": SDS((B, S - cfg.n_patches), i32)}
    return {"tokens": SDS((B, S), i32), "labels": SDS((B, S), i32)}


def batch_shardings(mesh, cfg: ArchConfig, shape: ShapeConfig):
    return {k: NamedSharding(mesh, spec_for(mesh, s.shape, BATCH_LOGICAL[k]))
            for k, s in batch_specs(cfg, shape).items()}


def _place_batch(batch: Mapping[str, torch.Tensor], mesh) -> Dict[str, Any]:
    """Each input as a DTensor in its logical layout over ``mesh``: the
    global batch, equal on every rank, cut locally (no collective)."""
    out = {}
    for k, v in batch.items():
        v = v.full_tensor() if isinstance(v, DTensor) else v
        sh = NamedSharding(mesh, spec_for(mesh, v.shape, BATCH_LOGICAL[k]))
        out[k] = sh.distribute(v)
    return out


# --------------------------------------------------------------------------- #
# decode-state specs
# --------------------------------------------------------------------------- #


def decode_state_specs(cfg: ArchConfig, shape: ShapeConfig):
    """The decode state's tree with an :class:`SDS` per leaf (``pos`` a
    scalar int32, as the reference's)."""
    state = Model(cfg, device="meta").init_decode_state(shape.global_batch,
                                                        shape.seq_len)

    def sds(x):
        if isinstance(x, torch.Tensor):
            return SDS(tuple(x.shape), x.dtype)
        if isinstance(x, (list, tuple)):
            return type(x)(sds(t) for t in x)
        return SDS((), torch.int32)

    return {k: sds(v) for k, v in state.items()}


def decode_state_shardings(mesh, cfg: ArchConfig, shape: ShapeConfig,
                           state_shapes):
    model_size = dict(zip(mesh.mesh_dim_names, mesh.shape)).get("model", 1)
    heads_ok = cfg.n_kv_heads % model_size == 0
    cache_logical = ((None, "batch", None, "kv_heads", None) if heads_ok
                     else (None, "batch", "kv_seq", None, None))

    def one(name, x):
        if isinstance(x, list):
            return [one(name, t) for t in x]
        if isinstance(x, tuple) and not isinstance(x, SDS):
            return tuple(one(name, t) for t in x)
        logical = {"cache_k": cache_logical, "cache_v": cache_logical,
                   "ssm": (None, "batch", "mlp", None),
                   "enc_out": ("batch", "seq", "embed"),
                   "blocks": ("batch",) + (None,) * (len(x.shape) - 1),
                   }.get(name, ())  # pos, kv_pos: replicated
        return NamedSharding(mesh, spec_for(mesh, x.shape, logical))

    return {k: one(k, v) for k, v in state_shapes.items()}


def _place_state(state: Dict[str, Any], shardings) -> Dict[str, Any]:
    """The decode state's tensors as DTensors in their layouts (``pos``
    stays a Python int)."""
    def one(x, sh):
        if isinstance(x, (list, tuple)):
            return type(x)(one(t, s) for t, s in zip(x, sh))
        if not isinstance(x, torch.Tensor) or isinstance(x, DTensor):
            return x
        return sh.distribute(x)

    return {k: one(v, shardings[k]) for k, v in state.items()}


# --------------------------------------------------------------------------- #
# steps
# --------------------------------------------------------------------------- #


def _check(model: Model, cfg: ArchConfig) -> None:
    if model.cfg != cfg:
        raise ValueError(f"step made for {cfg.name}, model is {model.cfg.name} "
                         f"or another configuration of it")


def _full(x):
    return x.full_tensor() if isinstance(x, DTensor) else x


def make_train_step(cfg: ArchConfig, opt_cfg: adamw.AdamWConfig):
    """``train_step(model, opt_state, batch) -> (model, opt_state,
    metrics)``.  The batch is cut into ``cfg.accum_steps`` microbatches
    along its first dimension; their gradients are summed in float32 and
    divided by the count, the loss averaged; then one :func:`adamw.update`
    writes the model's weights.  Metrics ``loss``, ``grad_norm`` and ``lr``
    are plain tensors on the model's device.

    On a sharded model (DTensor weights) the batch is the global one, a
    plain tensor equal on every rank: each microbatch is cut from it and
    spread over the data axes, so every rank holds rows of every
    microbatch (the reference's ``(A, B / A)`` reshape with the batch on
    the data axes).  Each gradient is reduced to its weight's layout before
    it is summed (a reduce-scatter under FSDP) on the rank's own shard,
    so the moments, the clip norm over all shards and the update follow
    the weights' layouts.

    With the span recorder on (:mod:`repro_torch.trace`) a call records
    ``train.step`` around itself, and inside it ``train.forward`` and
    ``train.backward`` for each microbatch, ``train.grad_accum`` for each
    microbatch's float32 sum and once more for the division, and
    ``optim.update``."""

    def train_step(model: Model, opt_state: adamw.AdamWState,
                   batch: Mapping[str, torch.Tensor]):
        with trace.span("train.step"):
            return _train_step(model, opt_state, batch)

    def _train_step(model: Model, opt_state: adamw.AdamWState,
                    batch: Mapping[str, torch.Tensor]):
        _check(model, cfg)
        mesh = _mesh_of(model)
        A = max(cfg.accum_steps, 1)
        B = next(iter(batch.values())).shape[0]
        if B % A:
            raise ValueError(f"batch {B} does not split into {A} microbatches")
        params = dict(model.named_parameters())
        names, leaves = list(params), list(params.values())
        grads: Dict[str, torch.Tensor] = {}
        loss = None
        for a in range(A):
            mb = {k: v[a * B // A:(a + 1) * B // A] for k, v in batch.items()}
            if mesh is not None:
                mb = _place_batch(mb, mesh)
            with torch.enable_grad():
                with trace.span("train.forward"):
                    mb_loss = model.loss_fn(mb)
                with trace.span("train.backward"):
                    mb_grads = torch.autograd.grad(mb_loss, leaves)
            loss = mb_loss.detach() if loss is None else loss + mb_loss.detach()
            with trace.span("train.grad_accum"):
                for n, p, g in zip(names, leaves, mb_grads):
                    if isinstance(g, DTensor):  # summed on this rank's shard
                        if g.placements != p.placements:
                            g = g.redistribute(p.device_mesh, p.placements)
                        g = g.to_local()
                    grads[n] = grads[n].add_(g) if n in grads else g.float()
            del mb_loss, mb_grads
        loss = _full(loss).float()
        if A > 1:
            with trace.span("train.grad_accum"):
                grads = {n: g / A for n, g in grads.items()}
            loss = loss / A
        with trace.span("optim.update"):
            _, opt_state, metrics = adamw.update(grads, opt_state, params, opt_cfg)
        metrics["loss"] = loss
        return model, opt_state, metrics

    return train_step


def make_prefill_step(cfg: ArchConfig):
    def prefill_step(model: Model, batch):
        _check(model, cfg)
        return model.prefill(batch)

    return prefill_step


def make_decode_step(cfg: ArchConfig):
    def serve_step(model: Model, state, tokens):
        _check(model, cfg)
        return model.decode_step(state, tokens)

    return serve_step


# --------------------------------------------------------------------------- #
# sharded assembly (used by the train and serve entry points)
# --------------------------------------------------------------------------- #


def _opt_sharded(opt_state: adamw.AdamWState, model: Model) -> adamw.AdamWState:
    """The optimizer state in the weights' layouts: m, v (and the
    residual) take their weight's placements, the step count stays a
    plain tensor on every rank."""
    params = dict(model.named_parameters())

    def place(tree):
        if tree is None:
            return None
        return {k: t if isinstance(t, DTensor)
                and t.placements == params[k].placements
                else layout_of(params[k]).distribute(_full(t))
                for k, t in tree.items()}

    step = _full(opt_state.step).to(params["embed"].device_mesh.device_type)
    return adamw.AdamWState(step, place(opt_state.m), place(opt_state.v),
                            place(opt_state.residual))


def build_train(mesh, cfg: ArchConfig, shape: ShapeConfig,
                opt_cfg: Optional[adamw.AdamWConfig] = None, fsdp: bool = True):
    """``(step, (param shapes, opt shapes, batch specs))``.  ``step(model,
    opt_state, batch)`` shards the model and the optimizer state where
    they are not sharded yet (weights by :func:`param_shardings`, FSDP on
    by default) and returns the sharded model, its state and plain
    metrics."""
    opt_cfg = opt_cfg or adamw.AdamWConfig()
    shapes, specs, p_sh = param_shardings(mesh, cfg, fsdp=fsdp)
    opt_shapes = adamw.AdamWState(
        SDS((), torch.int32),
        {k: SDS(s.shape, torch.float32) for k, s in shapes.items()},
        {k: SDS(s.shape, torch.float32) for k, s in shapes.items()},
        None)
    step = make_train_step(cfg, opt_cfg)

    def sharded_step(model: Model, opt_state: adamw.AdamWState, batch):
        _check(model, cfg)
        model = shard_model(model, p_sh, shapes)
        with mesh:
            return step(model, _opt_sharded(opt_state, model), batch)

    return sharded_step, (shapes, opt_shapes, batch_specs(cfg, shape))


def build_prefill(mesh, cfg: ArchConfig, shape: ShapeConfig, fsdp: bool = False):
    """``(step, (bf16 param shapes, batch specs))``; ``step(model, batch)``
    returns the last position's logits ``[B, 1, V]`` as a plain tensor on
    every rank."""
    shapes, specs, p_sh = param_shardings(mesh, cfg, fsdp=fsdp)
    b_specs = batch_specs(cfg, shape)
    b_specs.pop("labels", None)
    step = make_prefill_step(cfg)

    def sharded_step(model: Model, batch):
        _check(model, cfg)
        model = shard_model(model, p_sh, shapes)
        with mesh:
            return _full(step(model, _place_batch(batch, mesh)))

    return sharded_step, (serve_param_shapes(shapes), b_specs)


def build_decode(mesh, cfg: ArchConfig, shape: ShapeConfig, fsdp: bool = False):
    """``(step, (bf16 param shapes, state specs, token spec))``;
    ``step(model, state, tokens)`` places a plain state by
    :func:`decode_state_shardings` (written in place from then on) and
    returns (logits ``[B, 1, V]`` as a plain tensor, the sharded state)."""
    shapes, specs, p_sh = param_shardings(mesh, cfg, fsdp=fsdp)
    state_shapes = decode_state_specs(cfg, shape)
    state_sh = decode_state_shardings(mesh, cfg, shape, state_shapes)
    tok = SDS((shape.global_batch, 1), torch.int32)
    step = make_decode_step(cfg)

    def sharded_step(model: Model, state, tokens):
        _check(model, cfg)
        model = shard_model(model, p_sh, shapes)
        state = _place_state(state, state_sh)
        with mesh:
            logits, state = step(model, state, _place_batch({"tokens": tokens},
                                                            mesh)["tokens"])
        return _full(logits), state

    return sharded_step, (serve_param_shapes(shapes), state_shapes, tok)
