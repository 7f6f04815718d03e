"""The LM serving path of the port: K5's route through causal
self-attention, the serving steps and ``launch/serve``.

On the CPU, ``attention`` (causal, default positions, no key mask) runs
``flash_causal``: S padded with zeros to a multiple of 128, ``mha_flash``'s
plain version, the pad sliced off.  It is held against the reference's
einsum attention (``repro.models.layers.attention`` with ``wo`` the
identity, so its output is the attention itself): float32 within rtol =
atol = 1e-5.  In bf16 the port's route is exactly the plain version of its
operands, and the reference is within ``attention_limit`` plus the error of
its scores rounded to bf16, which the port does not round (up to 1.32 of
``attention_limit`` alone at these shapes; RMS error 3.1e-3 to 3.5e-3, the
level of ``attention_bf16_scores``, the control ``BF16_RMS_LIMIT``
refuses).  The serving
loop with carried weights gives the reference loop's greedy tokens in
float32.  The card cases (``-m cuda``, skipped without a card) run K5 on
the model path:

    python -m pytest -q --noconftest -m cuda tests/test_torch_lm_serve.py
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import pytest
import torch

from repro_torch import configs as port_configs
from repro_torch.kernels import flash_attn
from repro_torch.kernels.flash_attn import attention_limit, attention_ref
from repro_torch.kernels.flash_attn.ops import _fold
from repro_torch.kernels.flash_attn.ref import _probs
from repro_torch.launch import serve, steps
from repro_torch.models import layers as PL
from repro_torch.models.model import Model
from torch_lm_cases import (batch, configs, f32, pair, port_model,
                            ref_decode_step, to_torch)


def _identity_wo(cfg):
    return np.eye(cfg.d_model, dtype=np.float32).reshape(
        cfg.n_heads, cfg.hd, cfg.d_model)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 16])
@pytest.mark.parametrize("s", [40, 128, 200])
def test_k5_route_matches_reference_attention(s, window, dtype):
    import jax
    import jax.numpy as jnp

    from repro.models import layers as RL

    rcfg, pcfg = configs("llama3.2-3b", dtype, sliding_window=window)
    assert pcfg.d_model == pcfg.n_heads * pcfg.hd
    p, _ = RL.init_attention(jax.random.PRNGKey(s), rcfg)
    p = {**jax.tree.map(np.asarray, p), "wo": _identity_wo(rcfg)}
    mine = PL.Attention(pcfg)
    mine.load_state_dict({k: torch.tensor(v) for k, v in p.items()})
    x = np.random.default_rng(s).standard_normal((2, s, pcfg.d_model)).astype(
        np.float32)
    tdt = getattr(torch, dtype)
    want = RL.attention(p, jnp.asarray(x, getattr(jnp, dtype)), rcfg)
    got = PL.attention(mine, torch.from_numpy(x).to(tdt), pcfg)
    assert got.dtype == tdt and got.shape == (2, s, pcfg.d_model)
    if dtype == "float32":
        np.testing.assert_allclose(f32(got), f32(want), rtol=1e-5, atol=1e-5)
        return
    # the kernel's operands: q, k, v after RoPE, KV heads expanded, folded
    pos = torch.arange(s).expand(2, s)
    q, k, v = PL._qkv(mine, torch.from_numpy(x).to(tdt), pcfg, pos)
    rep = pcfg.n_heads // pcfg.n_kv_heads
    qf, kf, vf = _fold(q), _fold(PL._expand_kv(k, rep)), _fold(PL._expand_kv(v, rep))

    def fold(t):
        return _fold(torch.from_numpy(f32(t)).unflatten(-1, (pcfg.n_heads, pcfg.hd)))

    exact = attention_ref(qf, kf, vf, window)
    # the port's route is K5's plain version of these operands
    torch.testing.assert_close(fold(got), exact.float(), rtol=0, atol=0)
    # the reference rounds each score s to bf16 (relative error <= 2**-9),
    # which moves every probability of a row by a factor within
    # exp(+-2 * 2**-9 * max|s|), so its output by up to (that - 1) * (A |V|)
    # beyond the kernel's own limit
    scores = torch.einsum("bqd,bkd->bqk", qf.float(), kf.float()) / pcfg.hd ** 0.5
    idx = torch.arange(s)
    live = idx[None, :] <= idx[:, None]
    if window is not None:
        live &= idx[None, :] > idx[:, None] - window
    smax = scores.abs().masked_fill(~live, 0).amax(-1, keepdim=True)
    spread = torch.einsum("bqk,bkd->bqd", _probs(qf, kf, window), vf.float().abs())
    lim = attention_limit(qf, kf, vf, exact, window) + torch.expm1(
        2 * 2 ** -9 * smax) * spread
    assert ((fold(want) - exact.float()).abs() <= lim).all()


def test_k5_route_pads_after_the_sequence():
    """Padding S = 40 to 128 changes no output row: against ``mha_ref``
    on the unpadded length, exactly."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 40, 2, 32)).astype(
        np.float32)) for _ in range(3))
    for window in (None, 7):
        padded = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, 88))
                  for t in (q, k, v))
        want = flash_attn.mha_ref(*padded, window=window)[:, :40]
        torch.testing.assert_close(PL.flash_causal(q, k, v, window), want,
                                   rtol=0, atol=0)


@pytest.mark.parametrize("arch,calls", [("llama3.2-3b", 4), ("hymba-1.5b", 4),
                                        ("seamless-m4t-medium", 4),
                                        ("xlstm-125m", 0)])
def test_prefill_routes_causal_attention_through_k5(arch, calls, monkeypatch):
    """Each decoder layer's causal self-attention calls K5's wrapper once a
    prefill (the encoder's non-causal attention does not); on the CPU the
    wrapper runs the plain version, so the launch counter stays 0."""
    from repro_torch.kernels.flash_attn import ops

    seen = []
    real = ops.flash_attention

    def spy(q, k, v, window=None, **kw):
        seen.append((tuple(q.shape), window))
        return real(q, k, v, window=window, **kw)

    monkeypatch.setattr(ops, "flash_attention", spy)
    flash_attn.reset_launches()
    model = port_model(arch, "cpu")
    b = to_torch(batch(model.cfg, 1, 40, seed=7))
    out = steps.make_prefill_step(model.cfg)(model, b)
    assert torch.isfinite(out[..., :model.cfg.vocab]).all()
    assert len(seen) == calls
    cfg = model.cfg
    s = 40 + (cfg.n_patches if cfg.frontend == "vision" else 0)
    assert all(shape == (cfg.n_heads, -(-s // 128) * 128, cfg.hd)
               and window == cfg.sliding_window for shape, window in seen)
    assert flash_attn.LAUNCHES["flash_attention"] == 0


def test_steps_refuse_another_config():
    model = port_model("llama3.2-3b", "cpu")
    other = replace(model.cfg, n_layers=2)
    tok = torch.zeros((1, 1), dtype=torch.long)
    with pytest.raises(ValueError):
        steps.make_prefill_step(other)(model, {"tokens": tok})
    with pytest.raises(ValueError):
        steps.make_decode_step(other)(model, model.init_decode_state(1, 4), tok)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "hymba-1.5b"])
def test_serve_loop_matches_reference_loop(arch):
    """``serve.generate`` with carried weights, float32: the reference
    serving loop (prompt through decode steps, then greedy) gives the same
    tokens."""
    import jax.numpy as jnp

    from repro.models import model as RM

    rcfg, params, model = pair(arch)
    B, P, G = 2, 12, 10
    prompt = np.random.default_rng(0).integers(0, rcfg.vocab, (B, P)).astype(
        np.int32)
    state = RM.init_decode_state(rcfg, B, P + G)
    for i in range(P):
        logits, state = ref_decode_step()(params, state, jnp.asarray(prompt[:, i:i + 1]), rcfg)
    want = []
    tok = jnp.argmax(logits[:, -1, :], axis=-1)[:, None].astype(jnp.int32)
    for _ in range(G):
        want.append(np.asarray(tok))
        logits, state = ref_decode_step()(params, state, tok, rcfg)
        tok = jnp.argmax(logits[:, -1, :], axis=-1)[:, None].astype(jnp.int32)
    got, last, _, _ = serve.generate(model, torch.from_numpy(prompt), G)
    np.testing.assert_array_equal(got, np.concatenate(want, axis=1))
    np.testing.assert_allclose(f32(last), f32(logits), rtol=1e-4, atol=1e-4)


def test_serve_main_smoke_on_cpu(capsys):
    gen = serve.main(["--arch", "qwen2-0.5b", "--smoke", "--batch", "2",
                      "--prompt-len", "8", "--gen", "5", "--device", "cpu"])
    assert gen.shape == (2, 5)
    assert ((gen >= 0) & (gen < port_configs.smoke_config("qwen2-0.5b").vocab)).all()
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("[serve] qwen2-0.5b: prefill 8 toks in ")
    assert out[1].startswith("[serve] sample: ")


def test_entry_points_default_to_the_card(monkeypatch):
    """Without a card and without ``device="cpu"`` the entry points raise;
    they never drop to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = port_configs.smoke_config("llama3.2-3b")
    with pytest.raises(RuntimeError, match="CUDA"):
        Model.init(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--smoke", "--prompt-len", "2", "--gen", "1"])


# --------------------------------------------------------------------------- #
# K5 on the model path (needs a card)
# --------------------------------------------------------------------------- #


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _card_and_cpu(arch, dtype, **kw):
    """The same weights on the CPU and on the card."""
    cpu = port_model(arch, "cpu", dtype, **kw)
    card = Model(cpu.cfg, "cuda")
    card.load_state_dict(cpu.state_dict())
    return cpu, card


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [32, 64, 96, 128])
def test_cuda_prefill_launches_k5_per_layer(cuda_device, hd, dtype,
                                            monkeypatch):
    """Two layers, S = 200 (padded to 256): one K5 launch a layer, each
    within ``attention_limit`` of the plain version on its operands; the
    logits within 1e-3 of the CPU's in float32 (TF32 off), and at the
    reference's bf16 decode/prefill tolerance in bf16."""
    from repro_torch.kernels.flash_attn import ops

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    ops_seen = []
    real = ops.flash_attention

    def keep(q, k, v, window=None, **kw):
        out = real(q, k, v, window=window, **kw)
        ops_seen.append((q, k, v, window, out))
        return out

    monkeypatch.setattr(ops, "flash_attention", keep)
    cpu, card = _card_and_cpu("llama3.2-3b", dtype, n_layers=2, head_dim=hd,
                              d_model=4 * hd, sliding_window=None)
    b = batch(cpu.cfg, 1, 200, seed=8)
    flash_attn.reset_launches()
    got = card.prefill(to_torch(b, cuda_device))
    torch.cuda.synchronize()
    assert flash_attn.LAUNCHES["flash_attention"] == 2 == len(ops_seen)
    for q, k, v, window, out in ops_seen:
        want = attention_ref(q, k, v, window)
        assert ((out.float() - want.float()).abs()
                <= attention_limit(q, k, v, want, window)).all()
    tol = 1e-3 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(f32(got), f32(cpu.prefill(to_torch(b))),
                               rtol=tol, atol=tol)


@pytest.mark.cuda
def test_cuda_windowed_prefill_matches_decode(cuda_device, monkeypatch):
    """A window of 8 on the card, float32: prefill of 12 tokens (K5 with its
    window) ends where decode over the wrapped ring buffer of 8 slots (plain
    attention) does, within 1e-3 (TF32 off)."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    _, card = _card_and_cpu("llama3.2-3b", "float32", head_dim=64, d_model=256,
                            sliding_window=8)
    toks = torch.from_numpy(batch(card.cfg, 1, 12, seed=9)["tokens"]).cuda()
    full = card.prefill({"tokens": toks})
    state = card.init_decode_state(1, 16)
    assert state["kv_pos"].shape == (8,)
    for i in range(12):
        logits, state = card.decode_step(state, toks[:, i:i + 1])
    np.testing.assert_allclose(f32(logits), f32(full), rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,hd", [("phi-3-vision-4.2b", 96),
                                     ("llama3.2-3b", 32)])
def test_cuda_head_dims_prefill_matches_cpu(cuda_device, arch, hd,
                                            monkeypatch):
    """phi-3-vision-4.2b's head dim 96 and the smoke configs' 32 run K5 on
    the card (one launch a layer, each within ``attention_limit`` and
    ``BF16_RMS_LIMIT`` of the plain version on its operands), and the bf16
    logits match the CPU port's at the reference's bf16 tolerance."""
    from repro_torch.kernels.flash_attn import BF16_RMS_LIMIT, ops, rms_ratio

    seen = []
    real = ops.flash_attention

    def keep(q, k, v, window=None, **kw):
        out = real(q, k, v, window=window, **kw)
        seen.append((q, k, v, window, out))
        return out

    monkeypatch.setattr(ops, "flash_attention", keep)
    cpu, card = _card_and_cpu(arch, "bfloat16", head_dim=hd, d_model=4 * hd,
                              n_layers=2)
    b = batch(cpu.cfg, 1, 200, seed=10)
    flash_attn.reset_launches()
    got = card.prefill(to_torch(b, cuda_device))
    torch.cuda.synchronize()
    assert flash_attn.LAUNCHES["flash_attention"] == 2 == len(seen)
    for q, k, v, window, out in seen:
        assert q.shape[-1] == hd
        want = attention_ref(q, k, v, window)
        assert ((out.float() - want.float()).abs()
                <= attention_limit(q, k, v, want, window)).all()
        assert rms_ratio(out, want) <= BF16_RMS_LIMIT
    np.testing.assert_allclose(f32(got), f32(cpu.prefill(to_torch(b))),
                               rtol=5e-2, atol=5e-2)
