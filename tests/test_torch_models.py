"""The port's model zoo against the JAX package's: the registry field for
field, and for each of the ten architectures at ``smoke_config`` in float32
``prefill`` and ``loss_fn`` through the same weights (``params_from_numpy``
of the reference's ``M.init``), within rtol = atol = 1e-4
(``test_torch_models_decode.py`` holds ``decode_step``).

Causal self-attention runs K5's plain version on the CPU, in float32 like
the reference's, so the two agree to float32 rounding (about 5e-6 here).
"""

from __future__ import annotations

from dataclasses import asdict

import numpy as np
import pytest
import torch

from repro_torch import configs as port_configs
from torch_lm_cases import batch, f32, pair, to_jax, to_torch

ARCHS = sorted(port_configs.REGISTRY)
TOL = dict(rtol=1e-4, atol=1e-4)
B, S = 2, 24


def test_registry_names_and_shapes_match_reference():
    from repro import configs as ref

    assert sorted(port_configs.REGISTRY) == sorted(ref.REGISTRY)
    assert {k: asdict(v) for k, v in port_configs.SHAPES.items()} == {
        k: asdict(v) for k, v in ref.SHAPES.items()}
    with pytest.raises(KeyError):
        port_configs.get("gpt-2")


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch):
    from repro import configs as ref

    for fn in ("get", "smoke_config"):
        mine, theirs = getattr(port_configs, fn)(arch), getattr(ref, fn)(arch)
        assert asdict(mine) == asdict(theirs), fn
        assert (mine.hd, mine.padded_vocab, mine.sub_quadratic) == (
            theirs.hd, theirs.padded_vocab, theirs.sub_quadratic)
        assert mine.padded_vocab % 2048 == 0
        for shape in port_configs.SHAPES:
            assert mine.supports_shape(shape) == theirs.supports_shape(shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_float32_prefill_and_loss_match_reference(arch):
    from repro.models import model as RM

    rcfg, params, model = pair(arch)
    b = batch(rcfg, B, S, seed=1)
    jb, tb = to_jax(b), to_torch(b)
    got = model.prefill(tb)
    assert got.shape == (B, 1, rcfg.padded_vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(f32(got), f32(RM.prefill(params, jb, rcfg)), **TOL)
    np.testing.assert_allclose(float(model.loss_fn(tb)),
                               float(RM.loss_fn(params, jb, rcfg)), **TOL)
