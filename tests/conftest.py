import os
import sys

# tests run on the single real CPU device; subprocess tests set their own
# XLA_FLAGS before importing jax.
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import pytest

from repro.core.table import Table


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skipped where there is none")


@pytest.fixture(scope="session")
def tpch_db():
    from repro.tpch import generate

    return generate(sf=0.002, seed=1)


@pytest.fixture(scope="session")
def tpch_db_mid():
    from repro.tpch import generate

    return generate(sf=0.01, seed=1)


@pytest.fixture()
def mini_catalog():
    orders = Table.from_dict(
        {
            "o_orderkey": [1, 2, 3, 4, 5],
            "o_orderpriority": ["1-URGENT", "2-HIGH", "1-URGENT", "3-LOW", "2-HIGH"],
            "o_orderdate": [19930701, 19930801, 19930901, 19940101, 19930715],
        },
        name="orders",
    )
    lineitem = Table.from_dict(
        {
            "l_orderkey": [1, 1, 2, 3, 3, 3, 5, 5],
            "l_commitdate": [19930601] * 8,
            "l_receiptdate": [
                19930701, 19930501, 19930801, 19930901, 19930401, 19930902,
                19930716, 19930301,
            ],
        },
        name="lineitem",
    )
    return {"orders": orders, "lineitem": lineitem}


def lineage_sets(ans):
    return {k: set(np.asarray(v).tolist()) for k, v in ans.items() if len(v)}
