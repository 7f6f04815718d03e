"""The port's lineage-aware training-data pipeline
(``repro_torch.data.pipeline``): the four cases of
``tests/test_data_pipeline.py`` against the port's eager oracle, the corpus
and the batches of steps 0-3 bit-identical to the reference's, and
``lineage_of`` row sets and ``precise`` flags equal to the reference's, with
the scan cutovers as they are and forced to 0 (every scan through the
``pred_filter_batch`` route, its plain version on the CPU)."""

from __future__ import annotations

import numpy as np
import pytest

from repro_torch.core.eager import oracle_lineage_for_values
from repro_torch.data.pipeline import LineageDataPipeline, synth_corpus

CUTOVER_ENV = ("PREDTRACE_DEVICE_CUTOVER", "PREDTRACE_MEMBER_CUTOVER",
               "PREDTRACE_RLE_CUTOVER")


def lineage_sets(ans):
    return {k: set(np.asarray(v).tolist()) for k, v in ans.items() if len(v)}


@pytest.fixture(scope="module")
def pipe():
    catalog, tokens = synth_corpus(n_docs=300, vocab=128, seed=3)
    return LineageDataPipeline(catalog, tokens, seq_len=64, batch=4, seed=1,
                               device="cpu")


@pytest.fixture(scope="module")
def ref_pipe():
    from repro.data.pipeline import LineageDataPipeline as RefPipe
    from repro.data.pipeline import synth_corpus as ref_corpus

    catalog, tokens = ref_corpus(n_docs=300, vocab=128, seed=3)
    return RefPipe(catalog, tokens, seq_len=64, batch=4, seed=1)


def test_selection_dedups(pipe):
    sel = pipe.selected
    clusters = sel["dedup_cluster"]
    assert len(np.unique(clusters)) == sel.nrows, "dedup must keep one doc per cluster"


def test_batches_deterministic_and_resumable(pipe):
    b1 = pipe.batch_at(7)
    b2 = pipe.batch_at(7)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    np.testing.assert_array_equal(b1["doc_ids"], b2["doc_ids"])
    b3 = pipe.batch_at(8)
    assert not np.array_equal(b1["tokens"], b3["tokens"])


def test_lineage_matches_oracle(pipe):
    did = int(pipe.selected["doc_id"][0])
    ans = pipe.lineage_of(did)
    out = pipe.selected
    idx = int(np.nonzero(out["doc_id"] == did)[0][0])
    values = {c: out.cols[c][idx] for c in out.columns}
    oracle = oracle_lineage_for_values(pipe.catalog, pipe.plan, values)
    assert lineage_sets(ans.lineage) == lineage_sets(oracle)
    # the dedup-cluster mates are part of the lineage (they made this doc the
    # representative) — docs lineage must cover the whole cluster
    cluster = pipe.selected["dedup_cluster"][idx]
    meta = pipe.catalog["metadata"]
    mates = set(meta.rids()[np.asarray(meta["dedup_cluster"]) == cluster].tolist())
    assert mates <= set(ans.lineage["metadata"].tolist())


def test_lineage_of_batch(pipe):
    out = pipe.lineage_of_batch(step=0, row=0)
    assert out, "at least one doc packed in row 0"
    for did, ans in out.items():
        assert ans.total_rows() > 0


def test_corpus_and_selection_match_reference(pipe, ref_pipe):
    for name, table in ref_pipe.catalog.items():
        mine = pipe.catalog[name]
        assert mine.columns == table.columns
        for c in table.columns:
            np.testing.assert_array_equal(mine[c], table[c])
    np.testing.assert_array_equal(pipe.tokens, ref_pipe.tokens)
    assert pipe.selected.columns == ref_pipe.selected.columns
    for c in ref_pipe.selected.columns:
        np.testing.assert_array_equal(pipe.selected[c], ref_pipe.selected[c])


@pytest.mark.parametrize("step", range(4))
def test_batches_bit_identical_to_reference(pipe, ref_pipe, step):
    mine, theirs = pipe.batch_at(step), ref_pipe.batch_at(step)
    assert sorted(mine) == sorted(theirs)
    for k in theirs:
        assert mine[k].dtype == theirs[k].dtype
        np.testing.assert_array_equal(mine[k], theirs[k])


@pytest.mark.parametrize("forced", [False, True])
def test_lineage_of_training_docs_matches_reference(ref_pipe, forced, monkeypatch):
    """Every doc packed into step 0's batch: the same row sets and
    ``precise`` flags as the reference's pipeline."""
    if forced:
        for k in CUTOVER_ENV:
            monkeypatch.setenv(k, "0")
    catalog, tokens = synth_corpus(n_docs=300, vocab=128, seed=3)
    pipe = LineageDataPipeline(catalog, tokens, seq_len=64, batch=4, seed=1,
                               device="cpu")
    docs = {int(d) for row in ref_pipe.batch_at(0)["doc_ids"] for d in row if d >= 0}
    assert len(docs) >= 4
    for did in sorted(docs):
        mine, theirs = pipe.lineage_of(did), ref_pipe.lineage_of(did)
        assert lineage_sets(mine.lineage) == lineage_sets(theirs.lineage), did
        assert {t: mine.precise.get(t, True) for t in mine.lineage} == {
            t: theirs.precise.get(t, True) for t in theirs.lineage}, did
    per_row = pipe.lineage_of_batch(step=0, row=1)
    want = ref_pipe.lineage_of_batch(step=0, row=1)
    assert sorted(per_row) == sorted(want)
    for did in want:
        assert lineage_sets(per_row[did].lineage) == lineage_sets(want[did].lineage)
