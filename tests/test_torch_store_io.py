"""The port's ``checkpoint/store_io`` against the JAX package's.

Round trips and the kill points of ``tests/test_store_crash.py`` on the
port's spill writer: after a crash at any point between the first staged
byte and the final cleanup, ``load_store`` returns the OLD or the NEW
contents, bit-exactly, under full hash verification.  The on-disk layout is
pinned across packages: a spill written by either package's ``save_store``
(or ``save_store_delta``, or ``save_stage``) loads in the other with equal
columns, encodings and zone maps.
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import pytest

from test_torch_incremental import BOTH, PORT, REF, forced_device  # noqa: F401

SIO = PORT.store_io


class _Crash(RuntimeError):
    """Simulated process death at a spill kill point."""


def _crash_after(real, k):
    state = {"n": 0}

    def wrapper(*a, **kw):
        if state["n"] >= k:
            raise _Crash(f"injected crash at call {k}")
        state["n"] += 1
        return real(*a, **kw)

    return wrapper


def _table(pkg, n, seed=3):
    rng = np.random.default_rng(seed)
    return pkg.table.Table.from_dict({
        "a": rng.integers(0, 50, n).astype(np.int32),
        "b": np.sort(rng.integers(0, 10**6, n)).astype(np.int64),
        "c": rng.normal(size=n),
        "d": np.repeat(rng.integers(0, 4, n // 25 + 1), 25)[:n],
        "e": rng.random(n) < 0.5,
        "f": np.round(rng.uniform(0, 100, n) * 100) / 100,
        "s": rng.choice(["AIR", "MAIL", "SHIP"], n),
    }, name="t")


def _snapshot(store):
    return {nid: {c: np.array(v, copy=True)
                  for c, v in st.to_table().cols.items()}
            for nid, st in store.stages.items()}


def _assert_old_or_new(root, old, new):
    loaded = SIO.load_store(root)
    for want in (old, new):
        if set(loaded.stages) != set(want):
            continue
        if all(np.array_equal(np.asarray(loaded.table(nid).cols[c]), arr,
                              equal_nan=True)
               for nid, cols in want.items() for c, arr in cols.items()):
            return "old" if want is old else "new"
    raise AssertionError(f"reload matches neither state: {sorted(loaded.stages)}")


def _grown(store, n0, n1, seed):
    t = _table(PORT, n1, seed=seed)
    store.put_delta(1, PORT.table.Table.from_dict(
        {c: np.asarray(v)[n0:] for c, v in t.cols.items()}, name="t"))


@pytest.fixture()
def two_spills(tmp_path):
    store = PORT.store.IntermediateStore()
    store.put(1, _table(PORT, 700))
    SIO.save_store(tmp_path, store)
    old = _snapshot(store)
    store.put(2, _table(PORT, 900, seed=5))
    return store, old, _snapshot(store)


# --------------------------------------------------------------------------- #
# kill points
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("k", [0, 1, 2])
def test_crash_during_payload_write(two_spills, tmp_path, monkeypatch, k):
    store, old, new = two_spills
    monkeypatch.setattr(SIO.np, "save", _crash_after(np.save, k))
    with pytest.raises(_Crash):
        SIO.save_store(tmp_path, store)
    monkeypatch.undo()
    assert _assert_old_or_new(tmp_path, old, new) == "old"


def test_crash_during_manifest_write(two_spills, tmp_path, monkeypatch):
    store, old, new = two_spills
    monkeypatch.setattr(SIO.json, "dumps", _crash_after(None, 0))
    with pytest.raises(_Crash):
        SIO.save_store(tmp_path, store)
    monkeypatch.undo()
    assert _assert_old_or_new(tmp_path, old, new) == "old"


def test_crash_during_staged_fsync(two_spills, tmp_path, monkeypatch):
    store, old, new = two_spills
    monkeypatch.setattr(SIO, "_fsync_file", _crash_after(SIO._fsync_file, 1))
    with pytest.raises(_Crash):
        SIO.save_store(tmp_path, store)
    monkeypatch.undo()
    assert _assert_old_or_new(tmp_path, old, new) == "old"


def test_crash_between_demote_and_promote(two_spills, tmp_path, monkeypatch):
    store, old, new = two_spills
    monkeypatch.setattr(SIO.os, "replace", _crash_after(os.replace, 1))
    with pytest.raises(_Crash):
        SIO.save_store(tmp_path, store)
    monkeypatch.undo()
    assert not (tmp_path / "store" / "manifest.json").exists()
    assert _assert_old_or_new(tmp_path, old, new) == "old"


def test_crash_before_old_cleanup(two_spills, tmp_path, monkeypatch):
    store, old, new = two_spills
    monkeypatch.setattr(SIO.shutil, "rmtree", _crash_after(shutil.rmtree, 0))
    with pytest.raises(_Crash):
        SIO.save_store(tmp_path, store)
    monkeypatch.undo()
    assert (tmp_path / "store.old").exists()
    assert _assert_old_or_new(tmp_path, old, new) == "new"
    SIO.save_store(tmp_path, store)
    assert not (tmp_path / "store.old").exists()


def test_crash_during_delta_reuse(tmp_path, monkeypatch):
    store = PORT.store.IntermediateStore(part_rows=128)
    store.put(1, _table(PORT, 1000))
    SIO.save_store(tmp_path, store)
    old = _snapshot(store)
    _grown(store, 1000, 1300, 9)
    new = _snapshot(store)
    monkeypatch.setattr(SIO.os, "link", _crash_after(os.link, 2))
    with pytest.raises(_Crash):
        SIO.save_store_delta(tmp_path, store)
    monkeypatch.undo()
    assert _assert_old_or_new(tmp_path, old, new) == "old"
    SIO.save_store_delta(tmp_path, store)
    assert _assert_old_or_new(tmp_path, old, new) == "new"


def _corrupt_one_payload(path):
    victim = next(p for p in sorted(path.iterdir()) if p.suffix == ".npy")
    data = bytearray(victim.read_bytes())
    data[-1] ^= 0xFF
    victim.write_bytes(bytes(data))


def test_corrupt_current_falls_back_to_old(tmp_path):
    store = PORT.store.IntermediateStore()
    store.put(1, _table(PORT, 400))
    SIO.save_store(tmp_path, store)
    old = _snapshot(store)
    shutil.copytree(tmp_path / "store", tmp_path / "store.old")
    store.put(2, _table(PORT, 300, seed=8))
    new = _snapshot(store)
    SIO.save_store(tmp_path / "scratch", store)
    shutil.rmtree(tmp_path / "store")
    shutil.copytree(tmp_path / "scratch" / "store", tmp_path / "store")
    _corrupt_one_payload(tmp_path / "store")
    assert _assert_old_or_new(tmp_path, old, new) == "old"


def test_manifest_hash_check_raises_without_old(tmp_path):
    store = PORT.store.IntermediateStore()
    store.put(1, _table(PORT, 300))
    SIO.save_store(tmp_path, store)
    man = json.loads((tmp_path / "store" / "manifest.json").read_text())
    for cm in man["stages"]["1"]["columns"].values():
        for fm in cm["arrays"].values():
            arr = np.load(tmp_path / "store" / fm["file"])
            assert fm["sha"] == SIO._hash(arr) == REF.store_io._hash(arr)
    _corrupt_one_payload(tmp_path / "store")
    with pytest.raises(IOError):
        SIO.load_store(tmp_path)
    SIO.load_store(tmp_path, verify=False)


def test_delta_spill_counts_link_vs_copy(tmp_path, monkeypatch):
    store = PORT.store.IntermediateStore(part_rows=128)
    store.put(1, _table(PORT, 1000))
    SIO.save_store(tmp_path, store)
    _grown(store, 1000, 1300, 9)
    SIO.save_store_delta(tmp_path, store)
    inc = json.loads((tmp_path / "store" / "manifest.json").read_text())[
        "incremental"]
    assert inc["reused_chunks"] > 0
    assert inc["linked"] > 0 and inc["copied"] == 0
    _grown(store, 1300, 1600, 10)

    def refuse(*a, **kw):
        raise OSError(18, "Invalid cross-device link")

    monkeypatch.setattr(SIO.os, "link", refuse)
    SIO.save_store_delta(tmp_path, store)
    monkeypatch.undo()
    inc2 = json.loads((tmp_path / "store" / "manifest.json").read_text())[
        "incremental"]
    assert inc2["reused_chunks"] > 0
    assert inc2["linked"] == 0 and inc2["copied"] > 0
    loaded = SIO.load_store(tmp_path)
    assert np.array_equal(np.asarray(loaded.table(1).cols["a"]),
                          np.asarray(store.table(1).cols["a"]))


def test_copied_chunk_detects_corruption(tmp_path, monkeypatch):
    store = PORT.store.IntermediateStore(part_rows=128)
    store.put(1, _table(PORT, 1000))
    SIO.save_store(tmp_path, store)
    _grown(store, 1000, 1300, 9)

    def refuse(*a, **kw):
        raise OSError(18, "Invalid cross-device link")

    real_copy = SIO.shutil.copy2

    def corrupt_copy(src, dst, **kw):
        out = real_copy(src, dst, **kw)
        data = bytearray(open(dst, "rb").read())
        data[-1] ^= 0xFF
        open(dst, "wb").write(bytes(data))
        return out

    monkeypatch.setattr(SIO.os, "link", refuse)
    monkeypatch.setattr(SIO.shutil, "copy2", corrupt_copy)
    with pytest.raises(IOError):
        SIO.save_store_delta(tmp_path, store)


# --------------------------------------------------------------------------- #
# the on-disk layout, across packages
# --------------------------------------------------------------------------- #

def _store(pkg, part_rows):
    store = pkg.store.IntermediateStore(budget_bytes=1 << 20,
                                        part_rows=part_rows)
    store.put(1, _table(pkg, 1000))
    store.put(2, _table(pkg, 333, seed=7))
    return store


def _same_store(a, b):
    assert sorted(a.stages) == sorted(b.stages)
    assert a.budget_bytes == b.budget_bytes
    for nid in a.stages:
        sa, sb = a.stages[nid], b.stages[nid]
        assert (sa.name, sa.nrows, sa.raw_nbytes) == (sb.name, sb.nrows,
                                                      sb.raw_nbytes)
        assert sa.encodings() == sb.encodings()
        assert {k: list(v) for k, v in sa.dicts.items()} == \
            {k: list(v) for k, v in sb.dicts.items()}
        ta, tb = sa.to_table(cache=False), sb.to_table(cache=False)
        for c in ta.cols:
            assert np.array_equal(np.asarray(ta.cols[c]), np.asarray(tb.cols[c]),
                                  equal_nan=True), (nid, c)
        za, zb = sa.zone_maps, sb.zone_maps
        assert (za is None) == (zb is None)
        if za is not None:
            for stat in ("lo", "hi", "nulls", "distinct"):
                for c in za.lo:
                    assert np.array_equal(getattr(za, stat)[c],
                                          getattr(zb, stat)[c],
                                          equal_nan=True), (nid, stat, c)


@pytest.mark.parametrize("part_rows", [None, 128])
@pytest.mark.parametrize("writer", ["ref", "port"])
def test_spill_loads_in_the_other_package(tmp_path, writer, part_rows):
    src, dst = (REF, PORT) if writer == "ref" else (PORT, REF)
    store = _store(src, part_rows)
    src.store_io.save_store(tmp_path, store)
    back = dst.store_io.load_store(tmp_path)
    _same_store(back, store)
    _same_store(back, src.store_io.load_store(tmp_path))
    assert type(back).__module__.startswith(dst.store.__name__.split(".")[0])


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_delta_spill_loads_in_the_other_package(tmp_path, writer):
    src, dst = (REF, PORT) if writer == "ref" else (PORT, REF)
    store = src.store.IntermediateStore(part_rows=100)
    store.put(4, _table(src, 800, seed=9))
    src.store_io.save_store(tmp_path, store)
    t = _table(src, 920, seed=9)
    store.put_delta(4, src.table.Table.from_dict(
        {c: np.asarray(v)[800:] for c, v in t.cols.items()}, name="t"))
    src.store_io.save_store_delta(tmp_path, store)
    man = json.loads((tmp_path / "store" / "manifest.json").read_text())
    assert man["incremental"]["reused_chunks"] == 8
    assert man["incremental"]["written_chunks"] <= 2
    _same_store(dst.store_io.load_store(tmp_path), store)


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_demoted_stage_files_open_in_the_other_package(tmp_path, writer):
    src, dst = (REF, PORT) if writer == "ref" else (PORT, REF)
    st = _store(src, None).stages[1]
    entry = src.store_io.save_stage(tmp_path, 1, st, version=3)
    back = dst.store_io.open_stage(tmp_path, entry)
    assert back.tier == "disk"
    assert all(isinstance(a, np.memmap) for e in back.enc.values()
               for a in e.state()[1].values())
    ta, tb = back.to_table(cache=False), st.to_table(cache=False)
    for c in tb.cols:
        assert np.array_equal(np.asarray(ta.cols[c]), np.asarray(tb.cols[c]))
    dst.store_io.remove_stage_files(tmp_path, entry)
    assert not any(p.suffix == ".npy" for p in tmp_path.iterdir())


def test_spilled_stage_scans_match_reference(tmp_path):
    """load_stage_partitions / scan_spilled_stage read only the surviving
    chunks of a partition-wise spill; both packages agree on which."""
    got = {}
    for pkg in BOTH:
        root = tmp_path / pkg.store.__name__.split(".")[0]
        store = _store(pkg, 128)
        pkg.store_io.save_store(root, store)
        eng = pkg.ScanEngine()
        pred = pkg.expr.Col("b") < 200_000
        mask = pkg.store_io.scan_spilled_stage(root, 1, pred, {}, eng)
        assert np.array_equal(mask, eng.scan(pred, store.table(1), {}))
        zm = store.stages[1].zone_maps
        alive = np.asarray(zm.hi["b"] < 200_000)
        t, idx = pkg.store_io.load_stage_partitions(root, 1, alive)
        got[pkg] = (mask, idx, {c: np.asarray(v) for c, v in t.cols.items()},
                    eng.stats.partitions_pruned)
    (mask, idx, cols, pruned), ref = got[PORT], got[REF]
    assert np.array_equal(mask, ref[0]) and np.array_equal(idx, ref[1])
    assert pruned == ref[3] > 0
    for c, v in cols.items():
        assert np.array_equal(v, ref[2][c], equal_nan=True), c


def test_reloaded_store_answers_like_the_live_one(tmp_path):
    """attach_store over a reloaded spill: a q3 PredTrace answers exactly
    as before the spill (the reference's checkpoint round trip)."""
    from repro.tpch import generate

    from test_torch_lineage_tpch import _as_numpy, _same_answer

    db = PORT.table.catalog_from_numpy(_as_numpy(generate(sf=0.002, seed=1)),
                                       device="cpu")
    pt = PORT.PredTrace(db, PORT.queries["q3"](db), store=True)
    pt.infer()
    pt.run()
    before = pt.query_batch([0, 1, 2])
    SIO.save_store(tmp_path, pt.store)
    back = SIO.load_store(tmp_path, mmap=True)
    assert back.disk_stages() == sorted(back.stages)
    # the plan keeps every stage in RAM: attaching promotes them
    pt.attach_store(back)
    assert back.disk_stages() == [] and back.tier_stats["promotions"] > 0
    for a, b in zip(pt.query_batch([0, 1, 2]), before):
        _same_answer(a, b)
    pt.close()
