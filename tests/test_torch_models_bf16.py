"""The port's models against the JAX package's in bf16, and on sequences
long enough (S = 2,560 > ``ATTN_CHUNK_THRESHOLD``) to take the reference's
query-chunked attention.

bf16: the reference rounds the attention scores to bf16 (its einsum's
output dtype) where K5 and its plain version keep them in float32, and the
two packages' bf16 matmuls accumulate in different orders.  So they agree
to the relative tolerance of the reference's own decode/prefill test
(``tests/test_models_smoke.py::test_decode_matches_prefill_logits``, 5e-2),
held here as RMS(port - reference) / RMS(reference) over the real vocab,
with the same top-1 token.  Float32 runs are held at rtol = atol = 1e-4.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from torch_lm_cases import batch, f32, pair, ref_decode_step, to_jax, to_torch

BF16_RMS = 5e-2
TOL = dict(rtol=1e-4, atol=1e-4)


def assert_bf16_close(got, want, vocab: int, what: str):
    g, w = f32(got)[..., :vocab], f32(want)[..., :vocab]
    ratio = np.sqrt(np.mean((g - w) ** 2) / np.mean(w ** 2))
    assert ratio <= BF16_RMS, f"{what}: RMS ratio {ratio:.4f}"
    assert (g.argmax(-1) == w.argmax(-1)).all(), f"{what}: top-1 differs"


@pytest.mark.parametrize("arch", ["llama3.2-3b", "hymba-1.5b", "mixtral-8x22b"])
def test_bf16_prefill_and_decode_match_reference(arch):
    import jax.numpy as jnp

    from repro.models import model as RM

    rcfg, params, model = pair(arch, "bfloat16")
    b = batch(rcfg, 2, 24, seed=2)
    got = model.prefill(to_torch(b))
    assert got.dtype == torch.bfloat16
    assert_bf16_close(got, RM.prefill(params, to_jax(b), rcfg), rcfg.vocab,
                      "prefill")
    want_st, got_st = RM.init_decode_state(rcfg, 2, 8), model.init_decode_state(2, 8)
    for i in range(3):
        tok = b["tokens"][:, i:i + 1]
        want, want_st = ref_decode_step()(params, want_st, jnp.asarray(tok), rcfg)
        got, got_st = model.decode_step(got_st, torch.from_numpy(tok))
        assert_bf16_close(got, want, rcfg.vocab, f"decode step {i}")


@pytest.mark.parametrize("arch", ["llama3.2-3b", "hymba-1.5b",
                                  "seamless-m4t-medium"])
def test_long_prefill_matches_reference_chunked_attention(arch):
    """S = 2,560 (> ``ATTN_CHUNK_THRESHOLD`` = 2,048, a multiple of
    ``Q_CHUNK``), two layers, float32: the reference streams attention over
    query chunks (``_attention_chunked_scan``; hymba's window slices the
    keys; seamless's encoder and cross attention are non-causal); the port
    runs K5's route for causal attention and its own chunked routine for
    the rest."""
    from repro.models import model as RM

    rcfg, params, model = pair(arch, n_layers=2)
    b = batch(rcfg, 1, 2560, seed=5)
    np.testing.assert_allclose(f32(model.prefill(to_torch(b))),
                               f32(RM.prefill(params, to_jax(b), rcfg)), **TOL)
    np.testing.assert_allclose(float(model.loss_fn(to_torch(b))),
                               float(RM.loss_fn(params, to_jax(b), rcfg)), **TOL)
