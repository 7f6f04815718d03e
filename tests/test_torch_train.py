"""The port's training path against the JAX package's: the loss and the
gradients of the ten architectures, ``make_train_step`` with and without
microbatch accumulation, remat, K5 under autograd, the per-leaf weight
dtypes, and ``launch/train``.

Gradients are held leaf by leaf by RMS(port - reference) / RMS(reference)
<= 1e-4 in float32: the forward agrees to about 5e-6
(``test_torch_models.py``), and a backward sums in another order again.
The card case (``-m cuda``, skipped without a card) runs one train step
through K5 and holds its gradients to the plain route's:

    python -m pytest -q --noconftest -m cuda tests/test_torch_train.py
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import pytest
import torch

from repro_torch import configs as port_configs
from repro_torch.kernels import flash_attn
from repro_torch.models.model import Model, flat_numpy, params_from_numpy
from repro_torch.optim import adamw
from torch_lm_cases import batch, f32, pair, port_model, to_jax, to_torch

ARCHS = sorted(port_configs.REGISTRY)
GRAD_RMS = 1e-4
B, S = 2, 16


def rms_ratio(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    den = np.sqrt(np.mean(want ** 2))
    num = np.sqrt(np.mean((got - want) ** 2))
    return float(num / den) if den > 0 else float(num)


def port_grads(model: Model, b) -> tuple:
    params = dict(model.named_parameters())
    loss = model.loss_fn(b)
    grads = torch.autograd.grad(loss, list(params.values()))
    return float(loss.detach()), {n: f32(g) for n, g in zip(params, grads)}


@pytest.mark.parametrize("arch", ARCHS)
def test_float32_loss_and_grads_match_reference(arch):
    import jax

    from repro.models import model as RM

    rcfg, params, model = pair(arch)
    b = batch(rcfg, B, S, seed=2)
    loss_fn = jax.jit(jax.value_and_grad(RM.loss_fn), static_argnums=2)
    want_loss, want = loss_fn(params, to_jax(b), rcfg)
    got_loss, got = port_grads(model, to_torch(b))
    np.testing.assert_allclose(got_loss, float(want_loss), rtol=1e-5)
    want = flat_numpy(rcfg, jax.tree.map(np.asarray, want))
    assert sorted(got) == sorted(want)
    worst = max((rms_ratio(got[n], want[n]), n) for n in want)
    assert worst[0] <= GRAD_RMS, worst


def test_q_k_v_weights_and_biases_get_gradients():
    """qwen2 (qkv biases): every attention weight's gradient is non-zero
    through ``flash_causal``."""
    _, _, model = pair("qwen2-0.5b")
    _, got = port_grads(model, to_torch(batch(model.cfg, B, S, seed=3)))
    for name in ("wq", "wk", "wv", "wo", "bq", "bk", "bv"):
        assert np.abs(got[f"layers.0.attn.{name}"]).max() > 0, name


def test_remat_gives_the_same_gradients():
    _, _, model = pair("qwen2-0.5b")
    b = to_torch(batch(model.cfg, B, S, seed=4))
    loss, plain = port_grads(model, b)
    model.cfg = replace(model.cfg, remat=True)
    try:
        loss_r, remat = port_grads(model, b)
    finally:
        model.cfg = replace(model.cfg, remat=False)
    assert loss_r == loss
    for n in plain:
        np.testing.assert_allclose(remat[n], plain[n], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_reference(accum):
    """One ``make_train_step`` from the same float32 weights and batch:
    loss, gradient norm, new weights, m and v."""
    import jax

    from repro.launch.steps import make_train_step as ref_step
    from repro.optim import adamw as ref_adamw
    from repro_torch.launch.steps import make_train_step

    rcfg, params, _ = pair("qwen2-0.5b")
    rcfg = replace(rcfg, accum_steps=accum)
    model = params_from_numpy(replace(pair("qwen2-0.5b")[2].cfg, accum_steps=accum),
                              jax.tree.map(np.asarray, params), "cpu")
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    b = batch(rcfg, 4, S, seed=5)
    r_params, r_opt, r_m = jax.jit(ref_step(rcfg, opt_cfg))(
        params, ref_adamw.init(params, opt_cfg), to_jax(b))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    step = make_train_step(model.cfg, opt_cfg)
    model, opt, m = step(model, adamw.init(dict(model.named_parameters()), opt_cfg),
                         to_torch(b))
    np.testing.assert_allclose(float(m["loss"]), float(r_m["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(r_m["grad_norm"]),
                               rtol=1e-4)
    np.testing.assert_allclose(float(m["lr"]), float(r_m["lr"]), rtol=1e-6)
    want_p = flat_numpy(rcfg, jax.tree.map(np.asarray, r_params))
    want_m = flat_numpy(rcfg, jax.tree.map(np.asarray, r_opt.m))
    want_v = flat_numpy(rcfg, jax.tree.map(np.asarray, r_opt.v))
    for n, p in model.named_parameters():
        # the step each weight took, against the reference's step
        moved = f32(p) - f32(before[n])
        assert rms_ratio(moved, want_p[n] - f32(before[n])) <= 1e-3, n
        assert rms_ratio(f32(opt.m[n]), want_m[n]) <= GRAD_RMS, n
        assert rms_ratio(f32(opt.v[n]), want_v[n]) <= 2 * GRAD_RMS, n
    assert int(opt.step) == int(r_opt.step) == 1


def test_train_step_decreases_loss():
    """The port of ``tests/test_models_smoke.py::
    test_train_step_decreases_loss``: a few steps on a tiny model (bf16
    activations, the port's own weights) reduce the loss."""
    from repro_torch.launch.steps import make_train_step

    cfg = port_configs.smoke_config("qwen2-0.5b")
    opt_cfg = adamw.AdamWConfig(lr=5e-3, warmup_steps=1, total_steps=50)
    model = Model.init(cfg, seed=0, device="cpu", dtype=torch.bfloat16)
    opt = adamw.init(dict(model.named_parameters()), opt_cfg)
    step = make_train_step(cfg, opt_cfg)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 32)))
    b = {"tokens": toks, "labels": toks}
    losses = []
    for _ in range(12):
        model, opt, metrics = step(model, opt, b)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] * 0.9, losses


def test_k5_function_carries_the_plain_gradients():
    """On the CPU ``mha_flash`` is the ``FlashAttention`` node over the
    plain version: a ``grad_fn``, and the plain version's gradients."""
    from repro_torch.kernels.flash_attn import mha_flash, mha_ref

    rng = np.random.default_rng(6)
    for window in (None, 5):
        qkv = [torch.from_numpy(rng.standard_normal((2, 128, 3, 16)).astype(np.float32))
               for _ in range(3)]
        w = torch.from_numpy(rng.standard_normal((2, 128, 3, 16)).astype(np.float32))
        leaves = [t.clone().requires_grad_() for t in qkv]
        out = mha_flash(*leaves, window=window)
        assert out.grad_fn is not None
        got = torch.autograd.grad((out * w).sum(), leaves)
        plain = [t.clone().requires_grad_() for t in qkv]
        want = torch.autograd.grad((mha_ref(*plain, window=window) * w).sum(), plain)
        for g, h in zip(got, want):
            torch.testing.assert_close(g, h, rtol=0, atol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_init_keeps_the_reference_leaf_dtypes(arch, monkeypatch):
    """``Model.init(dtype=bf16)``: each leaf in the dtype the reference's
    ``M.init`` gives it when its ``dense_init`` draws in bf16 (the matrices
    bf16; the norms, qkv biases and SSM constants it builds in float32 stay
    float32).  At float32 every leaf is float32, as ``M.init`` has it."""
    import jax
    import jax.numpy as jnp

    from repro.models import layers as RL
    from repro.models import model as RM
    from repro.models import ssm as RS

    real = RL.dense_init

    def bf16_draw(key, shape, scale_dim):
        return real(key, shape, scale_dim).astype(jnp.bfloat16)

    rcfg = replace(port_configs.smoke_config(arch))
    for mod in (RL, RS):
        monkeypatch.setattr(mod, "dense_init", bf16_draw)
    want = flat_numpy(rcfg, jax.tree.map(np.asarray, RM.init(rcfg, jax.random.PRNGKey(0))[0]))
    names = {torch.bfloat16: "bfloat16", torch.float32: "float32"}
    got = Model.init(rcfg, seed=0, device="cpu", dtype=torch.bfloat16)
    assert {n: names[p.dtype] for n, p in got.named_parameters()} == {
        n: a.dtype.name for n, a in want.items()}
    assert {n: tuple(p.shape) for n, p in got.named_parameters()} == {
        n: a.shape for n, a in want.items()}
    assert all(p.dtype == torch.float32 for p in
               Model.init(rcfg, seed=0, device="cpu").parameters())


def test_bf16_step_moves_the_norm_weights():
    """A norm weight at 1.0 has a bf16 ulp of 2**-7; an AdamW step of
    about lr = 3e-4 would leave a bf16 copy where it is.  Held in float32,
    every norm moves."""
    from repro_torch.launch.steps import make_train_step

    cfg = port_configs.smoke_config("qwen2-0.5b")
    opt_cfg = adamw.AdamWConfig(lr=3e-4, warmup_steps=0)
    model = Model.init(cfg, seed=0, device="cpu", dtype=torch.bfloat16)
    norms = [n for n, _ in model.named_parameters() if "norm" in n]
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    b = to_torch(batch(cfg, 2, 16, seed=7))
    make_train_step(cfg, opt_cfg)(model, adamw.init(dict(model.named_parameters()),
                                                    opt_cfg), b)
    params = dict(model.named_parameters())
    assert {params[n].dtype for n in norms} == {torch.float32}
    for n in norms:
        assert not torch.equal(params[n], before[n]), n
        moved = before[n].bfloat16().float() - (params[n].bfloat16().float())
        assert torch.equal(moved, torch.zeros_like(moved)), n  # a bf16 copy stays


def test_params_from_numpy_takes_a_mixed_tree():
    import jax

    rcfg, params, _ = pair("qwen2-0.5b")
    tree = jax.tree.map(np.asarray, params)
    tree["embed"] = tree["embed"].astype(jax.numpy.bfloat16)
    model = params_from_numpy(rcfg, tree, "cpu")
    assert model.embed.dtype == torch.bfloat16
    assert model.final_norm.dtype == torch.float32
    np.testing.assert_array_equal(f32(model.embed), tree["embed"].astype(np.float32))


def test_launch_train_resumes(tmp_path, capsys):
    """``launch/train`` on the CPU: eight steps with checkpoints at 3 and
    6, then ``--resume`` from step 6 gives steps 6-7's losses again."""
    from repro_torch.launch import train

    args = ["--arch", "qwen2-0.5b", "--smoke", "--steps", "8", "--batch", "2",
            "--seq", "32", "--ckpt-every", "3", "--ckpt-dir", str(tmp_path),
            "--device", "cpu"]
    losses = train.main(args)
    out = capsys.readouterr().out
    assert len(losses) == 8 and np.isfinite(losses).all()
    assert "[ckpt] saved step_000000006" in out and "[lineage] doc" in out
    again = train.main(args + ["--resume"])
    assert "[ckpt] resumed from step 6" in capsys.readouterr().out
    assert again == losses[6:]


# --------------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------------- #


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [32, 64])
def test_cuda_train_step_k5_gradients(cuda_device, hd, monkeypatch):
    """One train step of a 2-layer qwen2-shaped model (head dim 32, the
    smoke configs', or 64, qwen2's) in float32 on the card: two K5 forward
    launches and two backward launches (one a layer, remat off), and every
    gradient within 1e-3 RMS of the plain route's, autograd through the
    plain attention (TF32 off; the kernels' float32 is within 2e-5 of the
    plain versions)."""
    from repro_torch.kernels.flash_attn import ops
    from repro_torch.launch.steps import make_train_step

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cpu = port_model("qwen2-0.5b", "cpu", "float32", n_layers=2, head_dim=hd,
                     d_model=4 * hd)
    card = Model(cpu.cfg, cuda_device)
    card.load_state_dict(cpu.state_dict())
    b = to_torch(batch(cpu.cfg, 2, 256, seed=8), cuda_device)
    flash_attn.reset_launches()
    _, got = port_grads(card, b)
    assert flash_attn.LAUNCHES["flash_attention"] == 2
    assert flash_attn.LAUNCHES["flash_attention_backward"] == 2
    for n in ("wq", "wk", "wv", "bq", "bk", "bv"):
        assert np.abs(got[f"layers.0.attn.{n}"]).max() > 0, n
    monkeypatch.setattr(ops, "mha_flash", ops.mha_ref)
    monkeypatch.setattr("repro_torch.models.layers.mha_flash", ops.mha_ref)
    _, want = port_grads(card, b)
    assert flash_attn.LAUNCHES["flash_attention"] == 2
    assert flash_attn.LAUNCHES["flash_attention_backward"] == 2
    for n in want:
        assert rms_ratio(got[n], want[n]) <= 1e-3, n
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=0)
    card, _, m = make_train_step(card.cfg, opt_cfg)(
        card, adamw.init(dict(card.named_parameters()), opt_cfg), b)
    assert np.isfinite(float(m["loss"]))
