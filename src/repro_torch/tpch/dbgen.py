"""dbgen-lite: a seeded, scale-factor-parametric TPC-H data generator.

Produces the eight TPC-H tables as :class:`repro_torch.core.table.Table`s with
* dictionary-encoded categorical/string columns,
* ``int32 YYYYMMDD`` dates (monotonic, so range predicates work directly and
  ``year(x) == x // 10000``),
* value distributions that keep all 22 queries non-empty at small scale.

Comment-like columns are drawn from small vocabularies that include the
patterns the queries LIKE-match on (``%special%requests%``,
``%Customer%Complaints%``, ``forest%``, ``%green%``, ...), so LIKE compiles to
dictionary-code membership (see ``queries.like``).
"""

from __future__ import annotations

from datetime import date, timedelta
from typing import Dict

import numpy as np

from ..core.table import Table

SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
SHIPMODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]
SHIPINSTRUCT = ["DELIVER IN PERSON", "COLLECT COD", "NONE", "TAKE BACK RETURN"]
RETURNFLAGS = ["R", "A", "N"]
LINESTATUS = ["O", "F"]
ORDERSTATUS = ["O", "F", "P"]
REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
NATIONS = [
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1), ("EGYPT", 4),
    ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3), ("INDIA", 2), ("INDONESIA", 2),
    ("IRAN", 4), ("IRAQ", 4), ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0),
    ("MOROCCO", 0), ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3), ("UNITED KINGDOM", 3),
    ("UNITED STATES", 1),
]
TYPE_SYLL1 = ["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"]
TYPE_SYLL2 = ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
TYPE_SYLL3 = ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]
CONTAINERS = [
    f"{a} {b}"
    for a in ["SM", "MED", "LG", "JUMBO", "WRAP"]
    for b in ["CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM"]
]
COLORS = [
    "almond", "antique", "aquamarine", "azure", "beige", "bisque", "black",
    "blanched", "blue", "blush", "brown", "burlywood", "burnished", "chartreuse",
    "chiffon", "chocolate", "coral", "cornflower", "cornsilk", "cream", "cyan",
    "dark", "deep", "dim", "dodger", "drab", "firebrick", "floral", "forest",
    "frosted", "gainsboro", "ghost", "goldenrod", "green", "grey", "honeydew",
    "hot", "hunter", "indian", "ivory", "khaki", "lace", "lavender", "lawn",
]
O_COMMENTS = [
    "carefully final deposits", "quickly regular packages", "pending special requests",
    "furiously special packages about the requests", "ironic special deposits requests",
    "blithely ironic theodolites", "slyly bold instructions", "even requests",
    "express accounts wake", "silent pinto beans",
]
S_COMMENTS = [
    "blithely regular deposits", "Customer words Complaints sleep", "quick packages",
    "slyly Customer ironic Complaints accounts", "carefully even asymptotes",
    "furiously unusual ideas", "final excuses about", "regular theodolites",
]


def _ymd(d: date) -> int:
    return d.year * 10000 + d.month * 100 + d.day


def _dates_to_ymd(base: date, offsets: np.ndarray) -> np.ndarray:
    out = np.empty(len(offsets), dtype=np.int32)
    # vectorized via numpy datetime64
    d64 = np.datetime64(base) + offsets.astype("timedelta64[D]")
    ys = d64.astype("datetime64[Y]").astype(int) + 1970
    ms = d64.astype("datetime64[M]").astype(int) % 12 + 1
    days = (d64 - d64.astype("datetime64[M]")).astype(int) + 1
    return (ys * 10000 + ms * 100 + days).astype(np.int32)


def generate(sf: float = 0.01, seed: int = 0) -> Dict[str, Table]:
    """Generate the 8 TPC-H tables at scale factor ``sf`` (SF 1 ~ 6M lineitem)."""
    rng = np.random.default_rng(seed)

    n_part = max(int(200_000 * sf), 60)
    n_supp = max(int(10_000 * sf), 25)
    n_cust = max(int(150_000 * sf), 45)
    n_ord = max(int(1_500_000 * sf), 150)
    base = date(1992, 1, 1)

    # ---- region / nation ------------------------------------------------ #
    region = Table.from_dict(
        {"r_regionkey": np.arange(5, dtype=np.int32), "r_name": REGIONS}, name="region"
    )
    nation = Table.from_dict(
        {
            "n_nationkey": np.arange(25, dtype=np.int32),
            "n_name": [n for n, _ in NATIONS],
            "n_regionkey": np.array([r for _, r in NATIONS], dtype=np.int32),
        },
        name="nation",
    )

    # ---- supplier -------------------------------------------------------- #
    supplier = Table.from_dict(
        {
            "s_suppkey": np.arange(1, n_supp + 1, dtype=np.int32),
            "s_name": [f"Supplier#{i:09d}" for i in range(1, n_supp + 1)],
            "s_nationkey": rng.integers(0, 25, n_supp, dtype=np.int32),
            "s_acctbal": np.round(rng.uniform(-999.99, 9999.99, n_supp), 2),
            "s_comment": [S_COMMENTS[i] for i in rng.integers(0, len(S_COMMENTS), n_supp)],
        },
        name="supplier",
    )

    # ---- part ------------------------------------------------------------ #
    pname1 = rng.integers(0, len(COLORS), n_part)
    pname2 = rng.integers(0, len(COLORS), n_part)
    p_type = [
        f"{TYPE_SYLL1[a]} {TYPE_SYLL2[b]} {TYPE_SYLL3[c]}"
        for a, b, c in zip(
            rng.integers(0, 6, n_part), rng.integers(0, 5, n_part), rng.integers(0, 5, n_part)
        )
    ]
    part = Table.from_dict(
        {
            "p_partkey": np.arange(1, n_part + 1, dtype=np.int32),
            "p_name": [f"{COLORS[a]} {COLORS[b]}" for a, b in zip(pname1, pname2)],
            "p_mfgr": [f"Manufacturer#{i}" for i in rng.integers(1, 6, n_part)],
            "p_brand": [f"Brand#{i}{j}" for i, j in zip(rng.integers(1, 6, n_part), rng.integers(1, 6, n_part))],
            "p_type": p_type,
            "p_size": rng.integers(1, 51, n_part, dtype=np.int32),
            "p_container": [CONTAINERS[i] for i in rng.integers(0, len(CONTAINERS), n_part)],
            "p_retailprice": np.round(900 + (np.arange(1, n_part + 1) % 1000) / 10.0, 2),
        },
        name="part",
    )

    # ---- partsupp (4 suppliers per part) ---------------------------------- #
    ps_part = np.repeat(np.arange(1, n_part + 1, dtype=np.int32), 4)
    ps_supp = np.empty(n_part * 4, dtype=np.int32)
    for j in range(4):
        ps_supp[j::4] = ((np.arange(n_part) + j * (n_supp // 4 + 1)) % n_supp) + 1
    partsupp = Table.from_dict(
        {
            "ps_partkey": ps_part,
            "ps_suppkey": ps_supp,
            "ps_availqty": rng.integers(1, 10_000, n_part * 4, dtype=np.int32),
            "ps_supplycost": np.round(rng.uniform(1.0, 1000.0, n_part * 4), 2),
        },
        name="partsupp",
    )

    # ---- customer ---------------------------------------------------------#
    c_nat = rng.integers(0, 25, n_cust, dtype=np.int32)
    c_phone_cntry = c_nat + 10  # TPC-H: country code = nationkey + 10
    customer = Table.from_dict(
        {
            "c_custkey": np.arange(1, n_cust + 1, dtype=np.int32),
            "c_name": [f"Customer#{i:09d}" for i in range(1, n_cust + 1)],
            "c_nationkey": c_nat,
            "c_phone_cntry": c_phone_cntry.astype(np.int32),
            "c_acctbal": np.round(rng.uniform(-999.99, 9999.99, n_cust), 2),
            "c_mktsegment": [SEGMENTS[i] for i in rng.integers(0, 5, n_cust)],
            "c_comment": [O_COMMENTS[i] for i in rng.integers(0, len(O_COMMENTS), n_cust)],
        },
        name="customer",
    )

    # ---- orders ------------------------------------------------------------#
    # TPC-H spec: a third of customers place no orders (custkey % 3 == 0)
    eligible = np.arange(1, n_cust + 1, dtype=np.int32)
    eligible = eligible[eligible % 3 != 0]
    o_cust = rng.choice(eligible, n_ord).astype(np.int32)
    o_date_off = rng.integers(0, (date(1998, 8, 2) - base).days, n_ord)
    o_orderdate = _dates_to_ymd(base, o_date_off)
    orders = Table.from_dict(
        {
            "o_orderkey": np.arange(1, n_ord + 1, dtype=np.int32),
            "o_custkey": o_cust,
            "o_orderstatus": [ORDERSTATUS[i] for i in rng.integers(0, 3, n_ord)],
            "o_totalprice": np.round(rng.uniform(800.0, 500_000.0, n_ord), 2),
            "o_orderdate": o_orderdate,
            "o_orderpriority": [PRIORITIES[i] for i in rng.integers(0, 5, n_ord)],
            "o_shippriority": np.zeros(n_ord, dtype=np.int32),
            "o_comment": [O_COMMENTS[i] for i in rng.integers(0, len(O_COMMENTS), n_ord)],
        },
        name="orders",
    )

    # ---- lineitem (1..7 lines per order) ------------------------------------#
    lines_per = rng.integers(1, 8, n_ord)
    l_order = np.repeat(orders["o_orderkey"], lines_per).astype(np.int32)
    l_odate_off = np.repeat(o_date_off, lines_per)
    n_li = len(l_order)
    l_part = rng.integers(1, n_part + 1, n_li).astype(np.int32)
    # supplier chosen among the 4 suppliers of that part (FK consistency)
    which = rng.integers(0, 4, n_li)
    l_supp = ps_supp.reshape(n_part, 4)[l_part - 1, which].astype(np.int32)
    l_qty = rng.integers(1, 51, n_li).astype(np.int32)
    l_price = np.round(l_qty * (900 + (l_part % 1000) / 10.0) / 10.0, 2)
    ship_off = l_odate_off + rng.integers(1, 122, n_li)
    commit_off = l_odate_off + rng.integers(30, 91, n_li)
    receipt_off = ship_off + rng.integers(1, 31, n_li)
    lineitem = Table.from_dict(
        {
            "l_orderkey": l_order,
            "l_partkey": l_part,
            "l_suppkey": l_supp,
            "l_linenumber": (np.arange(n_li) % 7 + 1).astype(np.int32),
            "l_quantity": l_qty,
            "l_extendedprice": l_price,
            "l_discount": np.round(rng.integers(0, 11, n_li) / 100.0, 2),
            "l_tax": np.round(rng.integers(0, 9, n_li) / 100.0, 2),
            "l_returnflag": [RETURNFLAGS[i] for i in rng.integers(0, 3, n_li)],
            "l_linestatus": [LINESTATUS[i] for i in rng.integers(0, 2, n_li)],
            "l_shipdate": _dates_to_ymd(base, ship_off),
            "l_commitdate": _dates_to_ymd(base, commit_off),
            "l_receiptdate": _dates_to_ymd(base, receipt_off),
            "l_shipinstruct": [SHIPINSTRUCT[i] for i in rng.integers(0, 4, n_li)],
            "l_shipmode": [SHIPMODES[i] for i in rng.integers(0, 7, n_li)],
        },
        name="lineitem",
    )

    return {
        "region": region,
        "nation": nation,
        "supplier": supplier,
        "part": part,
        "partsupp": partsupp,
        "customer": customer,
        "orders": orders,
        "lineitem": lineitem,
    }
