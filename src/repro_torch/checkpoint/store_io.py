"""Spill the compressed intermediate store to disk and reload it.

A materialized lineage plan outlives the process that executed the pipeline:
queries can arrive hours later, from another worker, or after a restart.
This module persists an :class:`~repro_torch.core.store.IntermediateStore` in its
*encoded* form — the on-disk bytes are the same compressed columns the
in-situ scan path consumes, so reload is a handful of ``np.load`` calls, not
a re-execution of the pipeline.

Partitioned stages (zone-mapped fixed-size row chunks) spill **partition-
wise**: every chunk's columns are encoded and written as independent
payloads, and the stage's zone maps land in the manifest sidecar.  A later
query can therefore zone-map-prune against the manifest alone and load *only
the surviving chunks* (:func:`load_stage_partitions` /
:func:`scan_spilled_stage`) — the disk-level analogue of the in-memory
partition pruning in ``core/store.py``.

Durability idioms:

* **Atomicity** — writes stage into ``<name>.tmp``; the previous spill is
  moved aside to ``<name>.old`` before the staged directory is promoted (and
  ``load_store`` falls back to ``.old``), so no crash point loses both
  copies.
* **Integrity** — per-payload SHA-256 prefixes recorded in the manifest and
  verified on load (``verify=False`` to skip).

Layout (one directory per spill)::

    <root>/<name>.tmp/...          # staged writes
    <root>/<name>/
        manifest.json              # stages, encodings, dtypes, hashes
        s<node>_<i>_<arr>.npy ...  # whole-column payloads (unpartitioned)
        s<node>_p<p>_<i>_<arr>.npy # per-partition payloads (partitioned)
        s<node>_zones.npz          # zone-map sidecar (partitioned)

The on-disk layout is the reference package's (``repro.checkpoint
.store_io``), so a spill written by either package loads in the other.
This module is numpy-only: the store serves lineage queries whose scans
upload the columns they touch.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

from ..core.scan import partition_safe, prune_zone_maps
from ..core.store import (
    IntermediateStore, StoredTable, column_from_state, encode_column,
)
from ..core.table import Table, ZoneMaps, alive_runs


def _hash(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()[:16]


def _hash_file(path: Path) -> str:
    return hashlib.sha256(path.read_bytes()).hexdigest()[:16]


def _fsync_file(path: Path) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(path: Path) -> None:
    # directory fsync is advisory on some platforms/filesystems; a refusal
    # (EINVAL on some network mounts) must not fail the spill
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _promote(root: Path, tmp: Path, final: Path, name: str) -> Path:
    """Durably promote a staged spill: fsync every staged payload *before*
    any rename (so a post-crash manifest never names torn chunks), swap the
    previous spill aside, promote, and fsync the parent directory so the
    renames themselves survive the crash."""
    for f in tmp.iterdir():
        if f.is_file():
            _fsync_file(f)
    _fsync_dir(tmp)
    # never a window without a good spill: move the previous one aside,
    # promote the staged write, then drop the old copy
    old = root / f"{name}.old"
    if final.exists():
        if old.exists():
            shutil.rmtree(old)
        os.replace(final, old)
        _fsync_dir(root)
    os.replace(tmp, final)
    _fsync_dir(root)
    if old.exists():
        shutil.rmtree(old)
    return final


def _save_payloads(tmp: Path, prefix: str, enc_cols) -> Dict:
    """One stage's (or chunk's) encoded columns -> manifest column dict."""
    cols = {}
    for i, (col, enc) in enumerate(enc_cols.items()):
        meta, arrays = enc.state()
        files = {}
        for aname, arr in arrays.items():
            fname = f"{prefix}_{i}_{aname}.npy"
            np.save(tmp / fname, arr)
            files[aname] = {"file": fname, "sha": _hash(arr)}
        cols[col] = {"meta": meta, "arrays": files}
    return cols


def save_store(root, store: IntermediateStore, name: str = "store") -> Path:
    """Atomically persist every stage of ``store`` under ``root/name``.
    Stages carrying zone maps are written partition-wise."""
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    tmp, final = root / f"{name}.tmp", root / name
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest: Dict = {
        "budget_bytes": store.budget_bytes,
        "nbytes": store.nbytes(),
        "raw_nbytes": store.raw_nbytes(),
        "stages": {},
    }
    for nid, st in store.stages.items():
        entry: Dict = {
            "name": st.name,
            "nrows": st.nrows,
            "raw_nbytes": st.raw_nbytes,
            "dicts": st.dicts,
        }
        zm = st.zone_maps
        if zm is not None and zm.n_partitions > 1:
            zmeta, zarrays = zm.state()
            zfile = f"s{nid}_zones.npz"
            np.savez(tmp / zfile, **zarrays)
            entry["zone_maps"] = {
                "meta": zmeta, "file": zfile, "sha": _hash_file(tmp / zfile),
            }
            entry["format"] = "chunks"
            chunks = []
            for p in range(zm.n_partitions):
                lo, hi = zm.part_bounds(p)
                idx = np.arange(lo, hi, dtype=np.int64)
                chunk_enc = {
                    col: encode_column(enc.gather(idx))
                    for col, enc in st.enc.items()
                }
                chunks.append(_save_payloads(tmp, f"s{nid}_p{p}", chunk_enc))
            entry["chunks"] = chunks
        else:
            entry["columns"] = _save_payloads(tmp, f"s{nid}", st.enc)
        manifest["stages"][str(nid)] = entry
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    return _promote(root, tmp, final, name)


def _link_or_copy(src: Path, dst: Path, sha: Optional[str] = None) -> str:
    """Reuse a payload file from the previous spill without copying bytes
    when the filesystem allows it.  Hard links fail across filesystem
    boundaries (``EXDEV``) and on link-refusing mounts; those fall back to
    a copy verified against the manifest's recorded payload hash.  Returns
    ``"linked"`` or ``"copied"``."""
    try:
        os.link(src, dst)
        return "linked"
    except OSError:
        shutil.copy2(src, dst)
        if sha is not None and _hash(np.load(dst)) != sha:
            raise IOError(
                f"delta spill reuse corrupt: copied payload {src.name} "
                f"hash mismatch"
            )
        return "copied"


def save_store_delta(root, store: IntermediateStore,
                     name: str = "store") -> Path:
    """Incrementally re-spill a store that grew by appended rows.

    Append-only growth (:meth:`IntermediateStore.put_delta`) never changes
    a *complete* partition's rows, and chunk encoding is deterministic — so
    every chunk entirely below the previous spill's row watermark is
    byte-identical on disk.  Those payload files are reused (hard-linked
    into the staged directory, with their recorded hashes); only the
    ragged-tail partition and the fresh partitions are re-encoded and
    written, and the manifest + zone-map sidecars are rewritten.  Stages
    without a reusable prior entry (unpartitioned, shrunk, or differently
    chunked) are written in full, and a missing prior spill degrades to
    :func:`save_store`.  The atomic promote flow is identical to
    :func:`save_store`; the written manifest records the reuse counts under
    ``"incremental"``."""
    root = Path(root)
    prev_path = _spill_path(root, name)
    if not (prev_path / "manifest.json").exists():
        return save_store(root, store, name)
    prev_stages = json.loads(
        (prev_path / "manifest.json").read_text())["stages"]
    root.mkdir(parents=True, exist_ok=True)
    tmp, final = root / f"{name}.tmp", root / name
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    reused = written = linked = copied = 0
    manifest: Dict = {
        "budget_bytes": store.budget_bytes,
        "nbytes": store.nbytes(),
        "raw_nbytes": store.raw_nbytes(),
        "stages": {},
    }
    for nid, st in store.stages.items():
        entry: Dict = {
            "name": st.name,
            "nrows": st.nrows,
            "raw_nbytes": st.raw_nbytes,
            "dicts": st.dicts,
        }
        zm = st.zone_maps
        if zm is not None and zm.n_partitions > 1:
            zmeta, zarrays = zm.state()
            zfile = f"s{nid}_zones.npz"
            np.savez(tmp / zfile, **zarrays)
            entry["zone_maps"] = {
                "meta": zmeta, "file": zfile, "sha": _hash_file(tmp / zfile),
            }
            entry["format"] = "chunks"
            pm = prev_stages.get(str(nid))
            first_dirty = 0
            prev_chunks: list = []
            if (pm is not None and pm.get("format") == "chunks"
                    and pm["nrows"] <= st.nrows
                    and pm.get("zone_maps", {}).get("meta", {})
                          .get("part_rows") == zm.part_rows):
                # chunks strictly below the old complete-partition watermark
                # are unchanged by an append: reuse their files verbatim
                first_dirty = min(pm["nrows"] // zm.part_rows,
                                  zm.n_partitions)
                prev_chunks = pm["chunks"]
            chunks = []
            for p in range(zm.n_partitions):
                if p < first_dirty:
                    cm = prev_chunks[p]
                    for col_m in cm.values():
                        for fm in col_m["arrays"].values():
                            how = _link_or_copy(prev_path / fm["file"],
                                                tmp / fm["file"], fm["sha"])
                            if how == "linked":
                                linked += 1
                            else:
                                copied += 1
                    chunks.append(cm)
                    reused += 1
                else:
                    lo, hi = zm.part_bounds(p)
                    idx = np.arange(lo, hi, dtype=np.int64)
                    chunk_enc = {
                        col: encode_column(enc.gather(idx))
                        for col, enc in st.enc.items()
                    }
                    chunks.append(
                        _save_payloads(tmp, f"s{nid}_p{p}", chunk_enc))
                    written += 1
            entry["chunks"] = chunks
        else:
            entry["columns"] = _save_payloads(tmp, f"s{nid}", st.enc)
            written += 1
        manifest["stages"][str(nid)] = entry
    manifest["incremental"] = {"reused_chunks": reused,
                               "written_chunks": written,
                               "linked": linked, "copied": copied}
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    return _promote(root, tmp, final, name)


def _spill_path(root, name: str) -> Path:
    """The live spill directory, falling back to the ``.old`` copy if a
    crash interrupted a re-spill between demote and promote."""
    path = Path(root) / name
    if not (path / "manifest.json").exists() and (
        Path(root) / f"{name}.old" / "manifest.json"
    ).exists():
        path = Path(root) / f"{name}.old"
    return path


def _load_payloads(path: Path, cols_manifest: Dict, verify: bool,
                   mmap: bool = False) -> Dict:
    """Rebuild one stage's (or chunk's) encoded columns from payload files.

    ``mmap=True`` hands ``column_from_state`` read-only memmapped arrays —
    payload bytes fault in lazily as scans touch them.  Verification reads
    every byte, so disk-tier callers that just wrote (and fsynced) the
    payloads pass ``verify=False`` to keep the open cheap."""
    enc = {}
    mode = "r" if mmap else None
    for col, cm in cols_manifest.items():
        arrays = {}
        for aname, fm in cm["arrays"].items():
            arr = np.load(path / fm["file"], mmap_mode=mode)
            if verify and _hash(arr) != fm["sha"]:
                raise IOError(
                    f"store spill corrupt: column {col!r} payload "
                    f"{aname!r} hash mismatch ({fm['file']})"
                )
            arrays[aname] = arr
        enc[col] = column_from_state(cm["meta"], arrays)
    return enc


def _load_zone_maps(path: Path, entry: Dict, verify: bool) -> Optional[ZoneMaps]:
    zinfo = entry.get("zone_maps")
    if zinfo is None:
        return None
    zpath = path / zinfo["file"]
    if verify and _hash_file(zpath) != zinfo["sha"]:
        raise IOError(f"store spill corrupt: zone-map sidecar {zinfo['file']}")
    with np.load(zpath) as z:
        return ZoneMaps.from_state(zinfo["meta"], dict(z))


def _load_store_at(path: Path, verify: bool, mmap: bool) -> IntermediateStore:
    manifest = json.loads((path / "manifest.json").read_text())
    store = IntermediateStore(budget_bytes=manifest.get("budget_bytes"))
    for nid_s, sm in manifest["stages"].items():
        zm = _load_zone_maps(path, sm, verify)
        if sm.get("format") == "chunks":
            parts = [_load_payloads(path, cm, verify) for cm in sm["chunks"]]
            enc = {}
            for col in parts[0]:
                full = np.concatenate([p[col].decode() for p in parts])
                enc[col] = encode_column(full)
            tier = "ram"
        else:
            enc = _load_payloads(path, sm["columns"], verify, mmap=mmap)
            tier = "disk" if mmap else "ram"
        st = StoredTable(
            enc, {k: list(v) for k, v in sm["dicts"].items()},
            sm["name"], sm["nrows"], sm["raw_nbytes"], zone_maps=zm,
        )
        st.tier = tier
        store.stages[int(nid_s)] = st
    return store


def load_store(root, name: str = "store", verify: bool = True,
               mmap: bool = False) -> IntermediateStore:
    """Reload a spilled store; encoded columns come back byte-identical, so
    in-situ scans and lineage answers match the pre-spill store exactly.
    Partition-wise stages are reassembled (chunk decode + re-encode — the
    encoding choice is deterministic, so the result matches the pre-spill
    encoding) with their zone maps restored.

    ``mmap=True`` opens unpartitioned stage payloads as read-only memmaps
    (the out-of-core tier: bytes fault in on first scan touch) and marks
    those stages ``tier == "disk"``; chunked stages still reassemble in RAM.

    A sha256 mismatch in the live spill falls back to the ``.old`` copy when
    one survives (a torn live spill must not lose the previous good one);
    with no fallback available the corruption is re-raised."""
    path = _spill_path(root, name)
    try:
        return _load_store_at(path, verify, mmap)
    except IOError:
        old = Path(root) / f"{name}.old"
        if path != old and (old / "manifest.json").exists():
            return _load_store_at(old, verify, mmap)
        raise


def save_stage(dirpath, nid: int, st: StoredTable, version: int = 0) -> Dict:
    """Demote one stage to the out-of-core tier: write its encoded columns
    as whole-column payload files under ``dirpath`` (fsynced before return)
    and hand back the manifest entry :func:`open_stage` consumes.

    Payloads are the *same bytes* the in-situ scan path reads in RAM — no
    re-encode, no decode — so a memmapped reopen is bit-identical.  The
    ``version`` counter keeps a re-demote after an append from overwriting
    files an in-flight reader may still have mapped."""
    dirpath = Path(dirpath)
    dirpath.mkdir(parents=True, exist_ok=True)
    cols = _save_payloads(dirpath, f"s{nid}_v{version}", st.enc)
    for cm in cols.values():
        for fm in cm["arrays"].values():
            _fsync_file(dirpath / fm["file"])
    _fsync_dir(dirpath)
    return {"name": st.name, "nrows": st.nrows, "raw_nbytes": st.raw_nbytes,
            "dicts": st.dicts, "columns": cols, "version": version}


def open_stage(dirpath, entry: Dict, zone_maps=None, verify: bool = False,
               mmap: bool = True) -> StoredTable:
    """Reopen a stage written by :func:`save_stage` as a disk-tier
    :class:`StoredTable`: payload arrays are read-only memmaps (bytes fault
    lazily under scans), zone maps stay the caller's RAM-resident object so
    pruning never touches disk."""
    enc = _load_payloads(Path(dirpath), entry["columns"], verify, mmap=mmap)
    st = StoredTable(
        enc, {k: list(v) for k, v in entry["dicts"].items()},
        entry["name"], entry["nrows"], entry["raw_nbytes"],
        zone_maps=zone_maps,
    )
    st.tier = "disk"
    return st


def remove_stage_files(dirpath, entry: Dict) -> None:
    """Best-effort cleanup of one demoted stage's payload files (an unlinked
    file stays readable through any still-open memmap)."""
    dirpath = Path(dirpath)
    for cm in entry["columns"].values():
        for fm in cm["arrays"].values():
            try:
                (dirpath / fm["file"]).unlink()
            except OSError:
                pass


def load_stage_partitions(
    root, node_id: int, alive: np.ndarray, name: str = "store",
    verify: bool = True,
) -> Tuple[Table, np.ndarray]:
    """Load *only* the surviving partitions of one spilled stage.

    ``alive`` is a boolean mask over the stage's partitions (e.g. from
    ``prune_zone_maps`` against the manifest's zone maps).  Returns the
    decoded rows of the surviving chunks as a Table plus their global row
    indices within the stage — pruned chunks are never read from disk."""
    path = _spill_path(root, name)
    manifest = json.loads((path / "manifest.json").read_text())
    sm = manifest["stages"][str(node_id)]
    if sm.get("format") != "chunks":
        raise ValueError(f"stage {node_id} was not spilled partition-wise")
    zm = _load_zone_maps(path, sm, verify)
    alive = np.asarray(alive, dtype=bool)
    cols: Dict[str, list] = {}
    idx_parts = []
    for p in np.flatnonzero(alive):
        enc = _load_payloads(path, sm["chunks"][int(p)], verify)
        for col, e in enc.items():
            cols.setdefault(col, []).append(e.decode())
        lo, hi = zm.part_bounds(int(p))
        idx_parts.append(np.arange(lo, hi, dtype=np.int64))
    if not idx_parts:
        # schema-correct empty result: decode chunk 0 and keep zero rows
        # (dtypes aren't recoverable from the manifest alone)
        cols0 = {}
        if sm["chunks"]:
            enc = _load_payloads(path, sm["chunks"][0], verify)
            cols0 = {col: e.decode()[:0] for col, e in enc.items()}
        t = Table(cols0, {k: list(v) for k, v in sm["dicts"].items()},
                  sm["name"])
        return t, np.empty(0, dtype=np.int64)
    table = Table({c: np.concatenate(vs) for c, vs in cols.items()},
                  {k: list(v) for k, v in sm["dicts"].items()}, sm["name"])
    return table, np.concatenate(idx_parts)


def scan_spilled_stage(
    root, node_id: int, pred, binding, engine, name: str = "store",
    verify: bool = True,
) -> np.ndarray:
    """Predicate mask over a spilled stage, touching only surviving chunks.

    Zone maps are read from the manifest sidecar and pruned *before any
    payload I/O*; only the chunks that may contain matches are loaded and
    scanned.  The returned mask is full-length and identical to scanning the
    fully-loaded stage."""
    path = _spill_path(root, name)
    manifest = json.loads((path / "manifest.json").read_text())
    sm = manifest["stages"][str(node_id)]
    binding = binding or {}
    prog = engine.compile(pred)
    if sm.get("format") == "chunks":
        zm = _load_zone_maps(path, sm, verify)
        if partition_safe(prog, binding):
            alive = prune_zone_maps(prog, zm, binding)
        else:
            alive = np.ones(zm.n_partitions, dtype=bool)
        ns = int(np.count_nonzero(alive))
        engine.stats.bump(prune_calls=1)
        engine.record_prune(ns, len(alive) - ns)
        mask = np.zeros(sm["nrows"], dtype=bool)
        if ns == 0:
            return mask
        # manifest and zone maps were parsed once above; load surviving
        # chunks directly (contiguous runs keep each sub-scan a single slice)
        for p0, p1 in alive_runs(alive):
            cols: Dict[str, list] = {}
            for p in range(p0, p1):
                for col, e in _load_payloads(path, sm["chunks"][p],
                                             verify).items():
                    cols.setdefault(col, []).append(e.decode())
            sub = Table({c: np.concatenate(vs) for c, vs in cols.items()},
                        {k: list(v) for k, v in sm["dicts"].items()},
                        sm["name"])
            lo = zm.part_bounds(p0)[0]
            hi = zm.part_bounds(p1 - 1)[1]
            mask[lo:hi] = engine.backend.scan(prog, sub, binding)
        return mask
    # unpartitioned stage: load just this stage's payloads, not the store
    enc = _load_payloads(path, sm["columns"], verify)
    st = StoredTable(enc, {k: list(v) for k, v in sm["dicts"].items()},
                     sm["name"], sm["nrows"], sm["raw_nbytes"])
    return engine.backend.scan(prog, st.to_table(), binding)
