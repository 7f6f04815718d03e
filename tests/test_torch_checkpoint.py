"""The port's fault-tolerance substrates (``repro_torch.checkpoint.manager``,
``repro_torch.runtime.controller``): the seven cases of
``tests/test_checkpoint_runtime.py``, checkpoints written by either package
read back bit-identical by the other (bfloat16 leaves included), and a
training state (weights of mixed dtypes and the AdamW state) restored
bit-identical into a fresh model."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.manager import CheckpointManager, flatten, train_state
from repro_torch.runtime.controller import ClusterController


@pytest.fixture()
def tree():
    return {
        "w": np.arange(12, dtype=np.float32).reshape(3, 4),
        "nested": {"b": np.ones(5, np.int32)},
    }


def test_save_restore_roundtrip(tmp_path, tree):
    cm = CheckpointManager(tmp_path, keep=3)
    cm.save(10, tree)
    step, restored = cm.restore(tree)
    assert step == 10
    np.testing.assert_array_equal(restored["w"], tree["w"])
    np.testing.assert_array_equal(restored["nested"]["b"], tree["nested"]["b"])


def test_retention_and_latest(tmp_path, tree):
    cm = CheckpointManager(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        cm.save(s, tree)
    assert cm.list_steps() == [3, 4]
    step, _ = cm.restore(tree)
    assert step == 4


def test_corrupt_checkpoint_falls_back(tmp_path, tree):
    cm = CheckpointManager(tmp_path, keep=3)
    cm.save(1, tree)
    cm.save(2, tree)
    # corrupt the newest
    leaf = tmp_path / "step_000000002" / "leaf_00000.npy"
    np.save(leaf, np.zeros((3, 4), np.float32) + 99)
    step, restored = cm.restore(tree, verify=True)
    assert step == 1
    np.testing.assert_array_equal(restored["w"], tree["w"])


def test_atomicity_no_tmp_left(tmp_path, tree):
    cm = CheckpointManager(tmp_path, keep=2)
    cm.save(5, tree)
    assert not list(tmp_path.glob("*.tmp"))


def test_controller_failure_detection_and_remesh():
    plans = []
    c = ClusterController(
        n_workers=512, beat_interval=1.0, miss_limit=2, on_failure=plans.append
    )
    t = 0.0
    for w in range(512):
        c.beat(w, now=t)
    # workers 5 and 300 go silent
    for tick in range(1, 4):
        t += 1.5
        for w in range(512):
            if w not in (5, 300):
                c.beat(w, now=t)
        c.sweep(now=t)
    assert 5 not in c.alive() and 300 not in c.alive()
    assert plans, "failure should trigger a remesh plan"
    plan = plans[-1]
    assert np.prod(plan.shape) <= 510
    assert plan.dropped_workers == (5, 300)
    # model axis preserved for cheap resharding
    assert plan.shape[-1] == 16


def test_controller_straggler_detection():
    c = ClusterController(n_workers=4, straggler_factor=2.0, straggler_window=5)
    for step in range(6):
        for w in range(4):
            c.beat(w, step_time=1.0 if w != 2 else 3.5)
    c.sweep()
    assert c.stragglers() == [2]


def test_elastic_restore_different_device(tmp_path):
    """Saved from one placement, restored onto the device the caller
    names."""
    cm = CheckpointManager(tmp_path)
    tree = {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8)}
    cm.save(1, tree)
    step, restored = cm.restore(tree, device=torch.device("cpu"))
    assert restored["w"].device == torch.device("cpu")
    torch.testing.assert_close(restored["w"], tree["w"], rtol=0, atol=0)


# --------------------------------------------------------------------------- #
# across packages
# --------------------------------------------------------------------------- #


def _mixed_tree():
    """float32, int32 and bfloat16 leaves (the last as the reference holds
    it: a JAX array, numpy ``ml_dtypes.bfloat16`` once converted)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(11)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    return {"b": {"bias": rng.standard_normal(6).astype(np.float32)},
            "a": np.asarray(jnp.asarray(w, dtype=jnp.bfloat16)),
            "step": np.asarray(3, np.int32),
            "list": [np.arange(5, dtype=np.int32), w]}


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    x = np.asarray(x)
    if x.dtype.name == "bfloat16" or x.dtype.kind == "V":
        return x.view(np.uint16)
    return x


def test_reference_checkpoint_reads_bit_identical(tmp_path):
    from repro.checkpoint.manager import CheckpointManager as RefManager

    tree = _mixed_tree()
    RefManager(tmp_path).save(7, tree)
    manifest = json.loads((tmp_path / "step_000000007" / "manifest.json").read_text())
    assert "bfloat16" in [leaf["dtype"] for leaf in manifest["leaves"]]
    step, got = CheckpointManager(tmp_path).restore(tree)
    assert step == 7
    assert got["a"].dtype == torch.bfloat16
    for (n, mine), (_, want) in zip(flatten(got), flatten(tree)):
        np.testing.assert_array_equal(_bits(mine), _bits(want), err_msg=n)


def test_port_checkpoint_reads_bit_identical_in_reference(tmp_path):
    from repro.checkpoint.manager import CheckpointManager as RefManager

    tree = _mixed_tree()
    torch_tree = {"b": {"bias": torch.from_numpy(tree["b"]["bias"])},
                  "a": torch.from_numpy(tree["a"].view(np.int16).copy()).view(torch.bfloat16),
                  "step": torch.tensor(3, dtype=torch.int32),
                  "list": [torch.from_numpy(x) for x in tree["list"]]}
    CheckpointManager(tmp_path).save(9, torch_tree)
    ref_path = tmp_path / "ref"
    RefManager(ref_path).save(9, tree)
    for i in range(5):  # the same files, byte for byte
        name = f"step_000000009/leaf_{i:05d}.npy"
        assert (tmp_path / name).read_bytes() == (ref_path / name).read_bytes(), name
    step, got = RefManager(tmp_path).restore(tree)
    assert step == 9
    for (n, mine), (_, want) in zip(flatten(got), flatten(tree)):
        np.testing.assert_array_equal(_bits(mine), _bits(want), err_msg=n)


def test_training_state_restores_bit_identical(tmp_path):
    """A bf16 model (float32 norms and biases) and its AdamW state after
    one step: saved, restored into a fresh model and state, equal bit for
    bit, in the same named order."""
    from repro_torch import configs
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw

    cfg = configs.smoke_config("qwen2-0.5b")
    opt_cfg = adamw.AdamWConfig(error_feedback=True)
    model = Model.init(cfg, seed=0, device="cpu", dtype=torch.bfloat16)
    opt = adamw.init(dict(model.named_parameters()), opt_cfg)
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (2, 16)))
    model, opt, _ = make_train_step(cfg, opt_cfg)(model, opt,
                                                  {"tokens": toks, "labels": toks})
    cm = CheckpointManager(tmp_path)
    cm.save(1, train_state(model, opt))
    fresh = Model(cfg, "cpu", torch.bfloat16)
    fresh_opt = adamw.init(dict(fresh.named_parameters()), opt_cfg)
    step, tree = cm.restore(train_state(fresh, fresh_opt))
    fresh.load_state_dict(tree["params"])
    names = [leaf["name"] for leaf in json.loads(
        (tmp_path / "step_000000001" / "manifest.json").read_text())["leaves"]]
    assert names == [n for n, _ in flatten(train_state(model, opt))]
    assert names[0].startswith("opt/") and "params/final_norm" in names
    for (n, mine), (_, want) in zip(flatten(train_state(fresh, tree["opt"])),
                                    flatten(train_state(model, opt))):
        assert mine.dtype == want.dtype, n
        np.testing.assert_array_equal(_bits(mine), _bits(want), err_msg=n)
    assert isinstance(tree["opt"], adamw.AdamWState)
