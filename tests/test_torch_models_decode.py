"""The port's ``decode_step`` against the JAX package's, float32, within
rtol = atol = 1e-4: three steps of each of the ten architectures at
``smoke_config`` (logits and the whole decode state), decode past the
sliding window's wrap, and the port's own decode-against-prefill check."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch import configs as port_configs
from torch_lm_cases import batch, f32, pair, ref_decode_step

ARCHS = sorted(port_configs.REGISTRY)
TOL = dict(rtol=1e-4, atol=1e-4)
B = 2


def _state_arrays(state):
    """The decode state as (name, float32 array) pairs, ``pos`` included."""
    out = [("pos", np.asarray(int(state["pos"])))]
    for k in sorted(state):
        if k == "pos":
            continue
        if k == "blocks":
            for i, blk in enumerate(state[k]):
                out += [(f"blocks.{i}.{j}", f32(t)) for j, t in enumerate(blk)]
        else:
            out.append((k, f32(state[k])))
    return out


def assert_states_equal(got, want, **tol):
    g, w = _state_arrays(got), _state_arrays(want)
    assert [n for n, _ in g] == [n for n, _ in w]
    for (name, a), (_, b) in zip(g, w):
        np.testing.assert_allclose(a, b, err_msg=name, **tol)


def decode_both(rcfg, params, model, toks, seq_len: int):
    """Decode ``toks`` [B, n] step by step in both packages, holding every
    step's logits to the reference's; returns both final states."""
    import jax.numpy as jnp

    from repro.models import model as RM

    want_st = RM.init_decode_state(rcfg, toks.shape[0], seq_len)
    got_st = model.init_decode_state(toks.shape[0], seq_len)
    assert_states_equal(got_st, want_st)
    for i in range(toks.shape[1]):
        tok = toks[:, i:i + 1]
        want, want_st = ref_decode_step()(params, want_st, jnp.asarray(tok), rcfg)
        got, got_st = model.decode_step(got_st, torch.from_numpy(tok))
        assert got.shape == (toks.shape[0], 1, rcfg.padded_vocab)
        np.testing.assert_allclose(f32(got), f32(want), err_msg=f"step {i}",
                                   **TOL)
    return got_st, want_st


@pytest.mark.parametrize("arch", ARCHS)
def test_float32_decode_matches_reference(arch):
    rcfg, params, model = pair(arch)
    toks = batch(rcfg, B, 3, seed=1)["tokens"]
    got_st, want_st = decode_both(rcfg, params, model, toks, 8)
    assert got_st["pos"] == 3
    assert_states_equal(got_st, want_st, **TOL)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "mixtral-8x22b"])
def test_decode_past_window_wrap_matches_reference(arch):
    """24 steps into a ring buffer of 16 slots (``smoke_config``'s window):
    slots are overwritten from step 16 on; ``kv_pos`` holds absolute
    positions, -1 for slots not yet written."""
    rcfg, params, model = pair(arch)
    assert rcfg.sliding_window == 16
    toks = batch(rcfg, B, 24, seed=3)["tokens"]
    got_st, want_st = decode_both(rcfg, params, model, toks, 40)
    assert got_st["cache_k"].shape[2] == 16
    assert sorted(got_st["kv_pos"].tolist()) == list(range(8, 24))
    assert_states_equal(got_st, want_st, **TOL)


@pytest.mark.parametrize("dtype,tol", [
    ("float32", TOL),
    # the reference's own bf16 decode/prefill tolerance
    ("bfloat16", dict(rtol=5e-2, atol=5e-2))])
def test_decode_matches_prefill(dtype, tol):
    """The port alone: decode over the cache (plain attention) ends where
    prefill (K5's route) does, on llama3.2-3b's smoke config."""
    _, _, model = pair("llama3.2-3b", dtype)
    toks = batch(model.cfg, 1, 8, seed=4)["tokens"]
    full = model.prefill({"tokens": torch.from_numpy(toks)})
    state = model.init_decode_state(1, 16)
    for i in range(8):
        logits, state = model.decode_step(state, torch.from_numpy(toks[:, i:i + 1]))
    np.testing.assert_allclose(f32(logits[0, -1]), f32(full[0, -1]), **tol)
