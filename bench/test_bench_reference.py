"""The plain reference against the port's ``Model`` on the CPU, both in
float32 at test size: last-position logits, the loss, every gradient, and
one AdamW step of the port's train step with gradient accumulation.  This
test may import both; the reference itself imports nothing of the port."""

import copy

import pytest
import torch

from benchlib import manifest, program, weights
from benchtest import BENCH, TINY_CONFIGS, TINY_TRAFFIC

REF = manifest.load_module(BENCH / "reference" / "decoder.py", "test_reference_decoder")
OPT = manifest.load_module(BENCH / "reference" / "adamw.py", "test_reference_adamw")
CONFS = [dict(c, name=n, torch_dtype="float32") for n, c in TINY_CONFIGS.items()]


def _setup(conf, seed=5):
    W = {k: v.float() for k, v in weights.make(conf, seed, "cpu").items()}
    cfg = program.arch(conf, remat=True, accum_steps=2)
    m = program.model(cfg, {k: v.clone() for k, v in W.items()})
    P = conf.get("n_patches") or 0
    batch = {"tokens": weights.tokens(conf, seed, 9, 0, (4, 48 - P), "cpu")}
    batch["labels"] = batch["tokens"]
    if P:
        batch["patches"] = weights.patches(conf, seed, 9, 0, 4, "cpu").float()
    return W, cfg, m, batch


def _rel(a, b):
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("conf", CONFS, ids=lambda c: c["name"])
def test_logits_match(conf):
    W, cfg, m, batch = _setup(conf)
    got = m.prefill({k: v for k, v in batch.items() if k != "labels"})[:, 0, :conf["vocab_size"]]
    want = REF.last_logits(W, conf, batch["tokens"], batch.get("patches"))
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("conf", CONFS, ids=lambda c: c["name"])
def test_loss_and_gradients_match(conf):
    W, cfg, m, batch = _setup(conf)
    params = dict(m.named_parameters())
    loss = m.loss_fn(batch)
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    Wr = {k: v.clone().requires_grad_() for k, v in W.items()}
    want_loss, want = REF.loss_and_grads(Wr, conf, batch, 1)
    assert float(loss.detach()) == pytest.approx(want_loss, rel=1e-6)
    V = conf["vocab_size"]
    for k, g in want.items():
        assert _rel(program.published(k, grads[k], V), g) < 1e-4, k


@pytest.mark.parametrize("conf", CONFS, ids=lambda c: c["name"])
def test_one_adamw_step_matches(conf):
    W, cfg, m, batch = _setup(conf)
    opt_conf = dict(TINY_TRAFFIC["tiny-train"]["optimizer"], warmup_steps=1)
    opt_cfg = program.adamw(opt_conf)
    state = program.adamw_init(m, opt_cfg)
    step = program.train_step(cfg, opt_cfg)
    m, state, metrics = step(m, state, batch)

    Wr = {k: v.clone().requires_grad_() for k, v in W.items()}
    w0 = copy.deepcopy({k: v.detach() for k, v in Wr.items()})
    loss, grads = REF.loss_and_grads(Wr, conf, batch, 2)
    out = OPT.AdamW(Wr, {k: torch.float32 for k in Wr}, opt_conf).step(grads)
    assert float(metrics["loss"]) == pytest.approx(loss, rel=1e-6)
    assert float(metrics["grad_norm"]) == pytest.approx(out["grad_norm"], rel=1e-5)
    lr = opt_conf["lr"]
    V = conf["vocab_size"]
    # Adam's first update is lr times the gradient's sign (and the decay):
    # equal but where a gradient all but nought takes another sign on the
    # other side, which moves that element by 2 lr
    off = total = 0
    for k, p in m.named_parameters():
        diff = ((program.published(k, p.detach(), V) - w0[k])
                - (Wr[k].detach() - w0[k])).abs()
        assert float(diff.max()) <= 2.1 * lr, k
        off += int((diff > 1e-3 * lr).sum())
        total += diff.numel()
    assert off / total < 1e-3
