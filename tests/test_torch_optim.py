"""The port's AdamW (``repro_torch.optim.adamw``): the four cases of
``tests/test_optim.py``, and :func:`update` against the reference's over
five steps on the same seeded float32 gradients, with and without clipping
and error feedback, within 1e-6 (float32 rounding of the same arithmetic in
another order)."""

from __future__ import annotations

from dataclasses import asdict

import numpy as np
import pytest
import torch

from repro_torch.optim import adamw

TOL = dict(rtol=1e-6, atol=1e-6)


def test_config_fields_match_reference():
    from repro.optim import adamw as ref

    assert asdict(adamw.AdamWConfig()) == asdict(ref.AdamWConfig())
    assert adamw.AdamWState._fields == ref.AdamWState._fields


def test_schedule_warmup_and_cosine():
    cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    lrs = [float(adamw.schedule(torch.tensor(s), cfg)) for s in range(101)]
    assert lrs[0] < lrs[9] < lrs[10] * 1.01  # warmup rises
    assert abs(lrs[10] - 1e-3) < 1e-9  # peak at end of warmup
    assert lrs[100] < lrs[50] < lrs[11]  # cosine decays
    assert lrs[100] >= 1e-4 - 1e-12  # floor at min_lr_ratio


def test_schedule_matches_reference():
    import jax.numpy as jnp

    from repro.optim import adamw as ref

    cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    for s in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        np.testing.assert_allclose(float(adamw.schedule(s, cfg)),
                                   float(ref.schedule(jnp.asarray(s), cfg)),
                                   rtol=1e-6)


def test_clipping_bounds_update():
    cfg = adamw.AdamWConfig(lr=1.0, clip_norm=1.0, weight_decay=0.0, warmup_steps=0)
    params = {"w": torch.zeros(4)}
    st = adamw.init(params, cfg)
    huge = {"w": torch.full((4,), 1e6)}
    _, _, metrics = adamw.update(huge, st, params, cfg)
    assert float(metrics["grad_norm"]) > 1e5  # raw norm observed
    # post-clip effective norm is 1: m ~ (1-b1) * clipped grad
    _, st2, _ = adamw.update(huge, st, params, cfg)
    m_norm = float(torch.linalg.norm(st2.m["w"])) / (1 - cfg.beta1)
    assert abs(m_norm - 1.0) < 1e-3


def test_error_feedback_accumulates_quantization_error():
    cfg = adamw.AdamWConfig(lr=1e-2, error_feedback=True, clip_norm=1e9,
                            weight_decay=0.0, warmup_steps=0)
    params = {"w": torch.zeros(())}
    st = adamw.init(params, cfg)
    assert st.residual is not None
    g = {"w": torch.tensor(1.0 + 2.0 ** -10)}  # not representable in bf16
    _, st2, _ = adamw.update(g, st, params, cfg)
    assert abs(float(st2.residual["w"])) > 0  # residual captured the error


def test_update_converges_quadratic():
    cfg = adamw.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=0, total_steps=200)
    params = {"w": torch.tensor(5.0)}
    st = adamw.init(params, cfg)
    for _ in range(150):
        w = params["w"].detach().requires_grad_()
        (g,) = torch.autograd.grad(0.5 * w ** 2, (w,))
        params, st, _ = adamw.update({"w": g}, st, params, cfg)
    assert abs(float(params["w"])) < 0.3


def _seeded(seed: int):
    """Parameters and five steps of gradients, float32 numpy."""
    rng = np.random.default_rng(seed)
    shapes = {"a": (3, 5), "b": (7,), "c": (2, 2, 4)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * 3).astype(np.float32)
              for k, s in shapes.items()} for _ in range(5)]
    return params, grads


@pytest.mark.parametrize("clip_norm,error_feedback",
                         [(1e9, False), (1.0, False), (1e9, True), (0.5, True)])
def test_update_matches_reference_five_steps(clip_norm, error_feedback):
    import jax.numpy as jnp

    from repro.optim import adamw as ref

    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                            clip_norm=clip_norm, error_feedback=error_feedback)
    p0, grads = _seeded(7)
    rp = {k: jnp.asarray(v) for k, v in p0.items()}
    rs = ref.init(rp, cfg)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    ts = adamw.init(tp, cfg)
    for g in grads:
        rp, rs, rm = ref.update({k: jnp.asarray(v) for k, v in g.items()}, rs, rp, cfg)
        tp, ts, tm = adamw.update({k: torch.from_numpy(v) for k, v in g.items()},
                                  ts, tp, cfg)
        for k in p0:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(rp[k]), **TOL)
            np.testing.assert_allclose(ts.m[k].numpy(), np.asarray(rs.m[k]), **TOL)
            np.testing.assert_allclose(ts.v[k].numpy(), np.asarray(rs.v[k]), **TOL)
            if error_feedback:
                np.testing.assert_allclose(ts.residual[k].numpy(),
                                           np.asarray(rs.residual[k]), **TOL)
        for name in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[name]), float(rm[name]), rtol=1e-6)
        assert int(ts.step) == int(rs.step)
    assert (ts.residual is None) == (not error_feedback)


def test_update_keeps_each_leaf_dtype():
    """A bf16 leaf is updated in float32 and cast back; m and v stay
    float32."""
    cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=0)
    params = {"w": torch.ones(8, dtype=torch.bfloat16), "n": torch.ones(8)}
    st = adamw.init(params, cfg)
    g = {k: torch.full((8,), 0.5) for k in params}
    params, st, _ = adamw.update(g, st, params, cfg)
    assert params["w"].dtype == torch.bfloat16 and params["n"].dtype == torch.float32
    assert all(t.dtype == torch.float32 for t in (*st.m.values(), *st.v.values()))
