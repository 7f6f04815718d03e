"""All 22 TPC-H queries as PredTrace plan builders.

Each ``qN(db)`` returns a plan over the dbgen-lite catalog.  String LIKE
patterns compile to dictionary-code membership at build time (``like``);
date constants are ``int32 YYYYMMDD`` (monotonic).
"""

from __future__ import annotations

import re
from datetime import date, timedelta
from typing import Dict, List

import numpy as np

from ..core import ops as O
from ..core.expr import Col, Expr, IfThenElse, IsIn, Lit, UnaryOp, land, lnot, lor
from ..core.table import Table


def ymd(y: int, m: int, d: int) -> int:
    return y * 10000 + m * 100 + d


def date_add(yyyymmdd: int, days: int = 0, months: int = 0, years: int = 0) -> int:
    y, m, d = yyyymmdd // 10000, (yyyymmdd // 100) % 100, yyyymmdd % 100
    y += years + (m - 1 + months) // 12
    m = (m - 1 + months) % 12 + 1
    out = date(y, m, min(d, 28)) + timedelta(days=days)
    return ymd(out.year, out.month, out.day)


def like(db: Dict[str, Table], table: str, col: str, pattern: str, negate: bool = False) -> Expr:
    """Compile SQL LIKE on a dictionary-encoded column into code membership."""
    vocab = db[table].dicts.get(col)
    assert vocab is not None, f"{table}.{col} is not dictionary encoded"
    rx = re.escape(pattern).replace("%", ".*").replace("_", ".")
    rx = re.compile("^" + rx + "$")
    codes = tuple(i for i, s in enumerate(vocab) if rx.match(s))
    e = IsIn(Col(col), codes)
    return lnot(e) if negate else e


def enc(db: Dict[str, Table], table: str, col: str, value: str) -> int:
    return db[table].encode_value(col, value)


def enc_set(db, table, col, values) -> tuple:
    return tuple(enc(db, table, col, v) for v in values)


def year(c: str) -> Expr:
    return UnaryOp("year", Col(c))


def _src(t: str) -> O.Source:
    return O.Source(t)


def jn(l, r, on, pred=None) -> O.InnerJoin:
    return O.InnerJoin(l, r, on, pred)


REVENUE = Col("l_extendedprice") * (1 - Col("l_discount"))


# --------------------------------------------------------------------------- #
def q1(db) -> O.Node:
    f = O.Filter(_src("lineitem"), Col("l_shipdate") <= date_add(ymd(1998, 12, 1), days=-90))
    t = O.RowTransform(
        f,
        {
            "disc_price": REVENUE,
            "charge": REVENUE * (1 + Col("l_tax")),
        },
    )
    g = O.GroupBy(
        t,
        ["l_returnflag", "l_linestatus"],
        {
            "sum_qty": O.Agg("sum", Col("l_quantity")),
            "sum_base_price": O.Agg("sum", Col("l_extendedprice")),
            "sum_disc_price": O.Agg("sum", Col("disc_price")),
            "sum_charge": O.Agg("sum", Col("charge")),
            "avg_qty": O.Agg("mean", Col("l_quantity")),
            "avg_price": O.Agg("mean", Col("l_extendedprice")),
            "avg_disc": O.Agg("mean", Col("l_discount")),
            "count_order": O.Agg("count"),
        },
    )
    return O.Sort(g, [("l_returnflag", True), ("l_linestatus", True)])


def _q2_inner(db) -> O.Node:
    ps = _src("partsupp")
    s = _src("supplier")
    n = _src("nation")
    r = O.Filter(_src("region"), Col("r_name").eq(enc(db, "region", "r_name", "EUROPE")))
    j = jn(ps, s, [("ps_suppkey", "s_suppkey")])
    j = jn(j, n, [("s_nationkey", "n_nationkey")])
    j = jn(j, r, [("n_regionkey", "r_regionkey")])
    return j


def q2(db) -> O.Node:
    p = O.Filter(
        _src("part"),
        land(Col("p_size").eq(15), like(db, "part", "p_type", "%BRASS")),
    )
    j = jn(p, _src("partsupp"), [("p_partkey", "ps_partkey")])
    j = jn(j, _src("supplier"), [("ps_suppkey", "s_suppkey")])
    j = jn(j, _src("nation"), [("s_nationkey", "n_nationkey")])
    r = O.Filter(_src("region"), Col("r_name").eq(enc(db, "region", "r_name", "EUROPE")))
    j = jn(j, r, [("n_regionkey", "r_regionkey")])
    fss = O.FilterScalarSub(
        j,
        _q2_inner(db),
        correlate=[("p_partkey", "ps_partkey")],
        agg=O.Agg("min", Col("ps_supplycost")),
        cmp="==",
        outer_expr=Col("ps_supplycost"),
    )
    proj = O.Project(
        fss,
        ["s_acctbal", "s_name", "n_name", "p_partkey", "p_mfgr", "s_comment"],
    )
    return O.Sort(
        proj,
        [("s_acctbal", False), ("n_name", True), ("s_name", True), ("p_partkey", True)],
        limit=100,
    )


def q3(db) -> O.Node:
    c = O.Filter(
        _src("customer"), Col("c_mktsegment").eq(enc(db, "customer", "c_mktsegment", "BUILDING"))
    )
    o = O.Filter(_src("orders"), Col("o_orderdate") < ymd(1995, 3, 15))
    l = O.Filter(_src("lineitem"), Col("l_shipdate") > ymd(1995, 3, 15))
    j = jn(c, o, [("c_custkey", "o_custkey")])
    j = jn(j, l, [("o_orderkey", "l_orderkey")])
    t = O.RowTransform(j, {"revenue_item": REVENUE})
    g = O.GroupBy(
        t,
        ["l_orderkey", "o_orderdate", "o_shippriority"],
        {"revenue": O.Agg("sum", Col("revenue_item"))},
    )
    return O.Sort(g, [("revenue", False), ("o_orderdate", True)], limit=10)


def q4(db) -> O.Node:
    o = O.Filter(
        _src("orders"),
        land(Col("o_orderdate") >= ymd(1993, 7, 1), Col("o_orderdate") < ymd(1993, 10, 1)),
    )
    l = O.Filter(_src("lineitem"), Col("l_commitdate") < Col("l_receiptdate"))
    semi = O.SemiJoin(o, l, [("o_orderkey", "l_orderkey")])
    g = O.GroupBy(semi, ["o_orderpriority"], {"order_count": O.Agg("count")})
    return O.Sort(g, [("o_orderpriority", True)])


def q5(db) -> O.Node:
    o = O.Filter(
        _src("orders"),
        land(Col("o_orderdate") >= ymd(1994, 1, 1), Col("o_orderdate") < ymd(1995, 1, 1)),
    )
    r = O.Filter(_src("region"), Col("r_name").eq(enc(db, "region", "r_name", "ASIA")))
    j = jn(_src("customer"), o, [("c_custkey", "o_custkey")])
    j = jn(j, _src("lineitem"), [("o_orderkey", "l_orderkey")])
    j = jn(j, _src("supplier"), [("l_suppkey", "s_suppkey"), ("c_nationkey", "s_nationkey")])
    j = jn(j, _src("nation"), [("s_nationkey", "n_nationkey")])
    j = jn(j, r, [("n_regionkey", "r_regionkey")])
    t = O.RowTransform(j, {"revenue_item": REVENUE})
    g = O.GroupBy(t, ["n_name"], {"revenue": O.Agg("sum", Col("revenue_item"))})
    return O.Sort(g, [("revenue", False)])


def q6(db) -> O.Node:
    f = O.Filter(
        _src("lineitem"),
        land(
            Col("l_shipdate") >= ymd(1994, 1, 1),
            Col("l_shipdate") < ymd(1995, 1, 1),
            Col("l_discount") >= 0.05,
            Col("l_discount") <= 0.07,
            Col("l_quantity") < 24,
        ),
    )
    return O.GroupBy(f, [], {"revenue": O.Agg("sum", Col("l_extendedprice") * Col("l_discount"))})


def q7(db) -> O.Node:
    fr = enc(db, "nation", "n_name", "FRANCE")
    de = enc(db, "nation", "n_name", "GERMANY")
    n1 = O.Alias(_src("nation"), "n1_")
    n2 = O.Alias(_src("nation"), "n2_")
    l = O.Filter(
        _src("lineitem"),
        land(Col("l_shipdate") >= ymd(1995, 1, 1), Col("l_shipdate") <= ymd(1996, 12, 31)),
    )
    j = jn(_src("supplier"), l, [("s_suppkey", "l_suppkey")])
    j = jn(j, _src("orders"), [("l_orderkey", "o_orderkey")])
    j = jn(j, _src("customer"), [("o_custkey", "c_custkey")])
    j = jn(j, n1, [("s_nationkey", "n1_n_nationkey")])
    j = jn(j, n2, [("c_nationkey", "n2_n_nationkey")])
    f = O.Filter(
        j,
        lor(
            land(Col("n1_n_name").eq(fr), Col("n2_n_name").eq(de)),
            land(Col("n1_n_name").eq(de), Col("n2_n_name").eq(fr)),
        ),
    )
    t = O.RowTransform(f, {"l_year": year("l_shipdate"), "volume": REVENUE})
    g = O.GroupBy(
        t,
        ["n1_n_name", "n2_n_name", "l_year"],
        {"revenue": O.Agg("sum", Col("volume"))},
    )
    return O.Sort(g, [("n1_n_name", True), ("n2_n_name", True), ("l_year", True)])


def q8(db) -> O.Node:
    steel = enc(db, "part", "p_type", "ECONOMY ANODIZED STEEL")
    brazil = enc(db, "nation", "n_name", "BRAZIL")
    p = O.Filter(_src("part"), Col("p_type").eq(steel))
    o = O.Filter(
        _src("orders"),
        land(Col("o_orderdate") >= ymd(1995, 1, 1), Col("o_orderdate") <= ymd(1996, 12, 31)),
    )
    r = O.Filter(_src("region"), Col("r_name").eq(enc(db, "region", "r_name", "AMERICA")))
    n1 = O.Alias(_src("nation"), "n1_")
    n2 = O.Alias(_src("nation"), "n2_")
    j = jn(p, _src("lineitem"), [("p_partkey", "l_partkey")])
    j = jn(j, _src("supplier"), [("l_suppkey", "s_suppkey")])
    j = jn(j, o, [("l_orderkey", "o_orderkey")])
    j = jn(j, _src("customer"), [("o_custkey", "c_custkey")])
    j = jn(j, n1, [("c_nationkey", "n1_n_nationkey")])
    j = jn(j, r, [("n1_n_regionkey", "r_regionkey")])
    j = jn(j, n2, [("s_nationkey", "n2_n_nationkey")])
    t = O.RowTransform(
        j,
        {
            "o_year": year("o_orderdate"),
            "volume": REVENUE,
            "brazil_volume": IfThenElse(Col("n2_n_name").eq(brazil), REVENUE, Lit(0.0)),
        },
    )
    g = O.GroupBy(
        t,
        ["o_year"],
        {"sum_brazil": O.Agg("sum", Col("brazil_volume")), "sum_vol": O.Agg("sum", Col("volume"))},
    )
    t2 = O.RowTransform(g, {"mkt_share": Col("sum_brazil") / Col("sum_vol")})
    return O.Sort(O.Project(t2, ["o_year", "mkt_share"]), [("o_year", True)])


def q9(db) -> O.Node:
    p = O.Filter(_src("part"), like(db, "part", "p_name", "%green%"))
    j = jn(p, _src("lineitem"), [("p_partkey", "l_partkey")])
    j = jn(j, _src("supplier"), [("l_suppkey", "s_suppkey")])
    j = jn(j, _src("partsupp"), [("l_suppkey", "ps_suppkey"), ("l_partkey", "ps_partkey")])
    j = jn(j, _src("orders"), [("l_orderkey", "o_orderkey")])
    j = jn(j, _src("nation"), [("s_nationkey", "n_nationkey")])
    t = O.RowTransform(
        j,
        {
            "o_year": year("o_orderdate"),
            "amount": REVENUE - Col("ps_supplycost") * Col("l_quantity"),
        },
    )
    g = O.GroupBy(t, ["n_name", "o_year"], {"sum_profit": O.Agg("sum", Col("amount"))})
    return O.Sort(g, [("n_name", True), ("o_year", False)])


def q10(db) -> O.Node:
    o = O.Filter(
        _src("orders"),
        land(Col("o_orderdate") >= ymd(1993, 10, 1), Col("o_orderdate") < ymd(1994, 1, 1)),
    )
    l = O.Filter(
        _src("lineitem"), Col("l_returnflag").eq(enc(db, "lineitem", "l_returnflag", "R"))
    )
    j = jn(_src("customer"), o, [("c_custkey", "o_custkey")])
    j = jn(j, l, [("o_orderkey", "l_orderkey")])
    j = jn(j, _src("nation"), [("c_nationkey", "n_nationkey")])
    t = O.RowTransform(j, {"revenue_item": REVENUE})
    g = O.GroupBy(
        t,
        ["c_custkey", "c_name", "c_acctbal", "n_name"],
        {"revenue": O.Agg("sum", Col("revenue_item"))},
    )
    return O.Sort(g, [("revenue", False)], limit=20)


def _q11_join(db) -> O.Node:
    n = O.Filter(_src("nation"), Col("n_name").eq(enc(db, "nation", "n_name", "GERMANY")))
    j = jn(_src("partsupp"), _src("supplier"), [("ps_suppkey", "s_suppkey")])
    return jn(j, n, [("s_nationkey", "n_nationkey")])


def q11(db) -> O.Node:
    g = O.GroupBy(
        _q11_join(db),
        ["ps_partkey"],
        {"value": O.Agg("sum", Col("ps_supplycost") * Col("ps_availqty"))},
    )
    inner = _q11_join(db)
    fss = O.FilterScalarSub(
        g,
        inner,
        correlate=[],
        agg=O.Agg("sum", Col("ps_supplycost") * Col("ps_availqty")),
        cmp=">",
        outer_expr=Col("value"),
        scale=0.0001,
    )
    return O.Sort(fss, [("value", False)])


def q12(db) -> O.Node:
    hi = enc_set(db, "orders", "o_orderpriority", ["1-URGENT", "2-HIGH"])
    l = O.Filter(
        _src("lineitem"),
        land(
            IsIn(Col("l_shipmode"), enc_set(db, "lineitem", "l_shipmode", ["MAIL", "SHIP"])),
            Col("l_commitdate") < Col("l_receiptdate"),
            Col("l_shipdate") < Col("l_commitdate"),
            Col("l_receiptdate") >= ymd(1994, 1, 1),
            Col("l_receiptdate") < ymd(1995, 1, 1),
        ),
    )
    j = jn(_src("orders"), l, [("o_orderkey", "l_orderkey")])
    t = O.RowTransform(
        j,
        {
            "is_high": IfThenElse(IsIn(Col("o_orderpriority"), hi), Lit(1), Lit(0)),
            "is_low": IfThenElse(IsIn(Col("o_orderpriority"), hi), Lit(0), Lit(1)),
        },
    )
    g = O.GroupBy(
        t,
        ["l_shipmode"],
        {"high_line_count": O.Agg("sum", Col("is_high")), "low_line_count": O.Agg("sum", Col("is_low"))},
    )
    return O.Sort(g, [("l_shipmode", True)])


def q13(db) -> O.Node:
    o = O.Filter(
        _src("orders"), like(db, "orders", "o_comment", "%special%requests%", negate=True)
    )
    loj = O.LeftOuterJoin(_src("customer"), o, [("c_custkey", "o_custkey")])
    g1 = O.GroupBy(
        loj,
        ["c_custkey"],
        {"c_count": O.Agg("sum", IfThenElse(Col("o_orderkey") >= 0, Lit(1), Lit(0)))},
    )
    g2 = O.GroupBy(g1, ["c_count"], {"custdist": O.Agg("count")})
    return O.Sort(g2, [("custdist", False), ("c_count", False)])


def q14(db) -> O.Node:
    l = O.Filter(
        _src("lineitem"),
        land(Col("l_shipdate") >= ymd(1995, 9, 1), Col("l_shipdate") < ymd(1995, 10, 1)),
    )
    j = jn(l, _src("part"), [("l_partkey", "p_partkey")])
    promo = like(db, "part", "p_type", "PROMO%")
    t = O.RowTransform(
        j,
        {
            "promo_rev": IfThenElse(promo, REVENUE, Lit(0.0)),
            "rev": REVENUE,
        },
    )
    g = O.GroupBy(t, [], {"sum_promo": O.Agg("sum", Col("promo_rev")), "sum_rev": O.Agg("sum", Col("rev"))})
    return O.RowTransform(g, {"promo_revenue": 100.0 * Col("sum_promo") / Col("sum_rev")})


def _q15_view(db) -> O.Node:
    l = O.Filter(
        _src("lineitem"),
        land(Col("l_shipdate") >= ymd(1996, 1, 1), Col("l_shipdate") < ymd(1996, 4, 1)),
    )
    t = O.RowTransform(l, {"rev": REVENUE})
    return O.GroupBy(t, ["l_suppkey"], {"total_revenue": O.Agg("sum", Col("rev"))})


def q15(db) -> O.Node:
    j = jn(_src("supplier"), _q15_view(db), [("s_suppkey", "l_suppkey")])
    fss = O.FilterScalarSub(
        j,
        _q15_view(db),
        correlate=[],
        agg=O.Agg("max", Col("total_revenue")),
        cmp="==",
        outer_expr=Col("total_revenue"),
    )
    return O.Sort(
        O.Project(fss, ["s_suppkey", "s_name", "total_revenue"]), [("s_suppkey", True)]
    )


def q16(db) -> O.Node:
    p = O.Filter(
        _src("part"),
        land(
            lnot(Col("p_brand").eq(enc(db, "part", "p_brand", "Brand#45"))),
            like(db, "part", "p_type", "MEDIUM POLISHED%", negate=True),
            IsIn(Col("p_size"), (49, 14, 23, 45, 19, 3, 36, 9)),
        ),
    )
    j = jn(_src("partsupp"), p, [("ps_partkey", "p_partkey")])
    bad_s = O.Filter(_src("supplier"), like(db, "supplier", "s_comment", "%Customer%Complaints%"))
    aj = O.AntiJoin(j, bad_s, [("ps_suppkey", "s_suppkey")])
    g = O.GroupBy(
        aj,
        ["p_brand", "p_type", "p_size"],
        {"supplier_cnt": O.Agg("count_distinct", Col("ps_suppkey"))},
    )
    return O.Sort(
        g, [("supplier_cnt", False), ("p_brand", True), ("p_type", True), ("p_size", True)]
    )


def q17(db) -> O.Node:
    p = O.Filter(
        _src("part"),
        land(
            Col("p_brand").eq(enc(db, "part", "p_brand", "Brand#23")),
            Col("p_container").eq(enc(db, "part", "p_container", "MED BOX")),
        ),
    )
    j = jn(_src("lineitem"), p, [("l_partkey", "p_partkey")])
    fss = O.FilterScalarSub(
        j,
        _src("lineitem"),
        correlate=[("l_partkey", "l_partkey")],
        agg=O.Agg("mean", Col("l_quantity")),
        cmp="<",
        outer_expr=Col("l_quantity"),
        scale=0.2,
    )
    g = O.GroupBy(fss, [], {"sum_price": O.Agg("sum", Col("l_extendedprice"))})
    return O.RowTransform(g, {"avg_yearly": Col("sum_price") / 7.0})


def q18(db) -> O.Node:
    # quantity threshold scaled for dbgen-lite's uniform quantities (official
    # parameter range 312-315 targets the same ~1e-4 order selectivity)
    big = O.Filter(
        O.GroupBy(_src("lineitem"), ["l_orderkey"], {"sum_qty_in": O.Agg("sum", Col("l_quantity"))}),
        Col("sum_qty_in") > 250,
    )
    o = O.SemiJoin(_src("orders"), big, [("o_orderkey", "l_orderkey")])
    j = jn(_src("customer"), o, [("c_custkey", "o_custkey")])
    j = jn(j, _src("lineitem"), [("o_orderkey", "l_orderkey")])
    g = O.GroupBy(
        j,
        ["c_name", "c_custkey", "o_orderkey", "o_orderdate", "o_totalprice"],
        {"sum_qty": O.Agg("sum", Col("l_quantity"))},
    )
    return O.Sort(g, [("o_totalprice", False), ("o_orderdate", True)], limit=100)


def q19(db) -> O.Node:
    j = jn(_src("lineitem"), _src("part"), [("l_partkey", "p_partkey")])
    sm = enc_set(db, "part", "p_container", ["SM CASE", "SM BOX", "SM PACK", "SM PKG"])
    med = enc_set(db, "part", "p_container", ["MED BAG", "MED BOX", "MED PKG", "MED PACK"])
    lg = enc_set(db, "part", "p_container", ["LG CASE", "LG BOX", "LG PACK", "LG PKG"])
    modes = enc_set(db, "lineitem", "l_shipmode", ["AIR", "REG AIR"])
    dip = enc_set(db, "lineitem", "l_shipinstruct", ["DELIVER IN PERSON", "COLLECT COD"])
    b1 = enc(db, "part", "p_brand", "Brand#12")
    b2 = enc(db, "part", "p_brand", "Brand#23")
    b3 = enc(db, "part", "p_brand", "Brand#34")
    # windows widened ~2x versus the official parameters so the query is
    # non-empty at dbgen-lite scale factors (structure unchanged)
    common = land(IsIn(Col("l_shipmode"), modes), IsIn(Col("l_shipinstruct"), dip))
    c1 = land(
        Col("p_brand").eq(b1), IsIn(Col("p_container"), sm),
        Col("l_quantity") >= 1, Col("l_quantity") <= 21,
        Col("p_size").between(1, 15), common,
    )
    c2 = land(
        Col("p_brand").eq(b2), IsIn(Col("p_container"), med),
        Col("l_quantity") >= 10, Col("l_quantity") <= 30,
        Col("p_size").between(1, 25), common,
    )
    c3 = land(
        Col("p_brand").eq(b3), IsIn(Col("p_container"), lg),
        Col("l_quantity") >= 20, Col("l_quantity") <= 40,
        Col("p_size").between(1, 35), common,
    )
    f = O.Filter(j, lor(c1, c2, c3))
    t = O.RowTransform(f, {"rev": REVENUE})
    return O.GroupBy(t, [], {"revenue": O.Agg("sum", Col("rev"))})


def q20(db) -> O.Node:
    forest_parts = O.Filter(_src("part"), like(db, "part", "p_name", "forest%"))
    ps = O.SemiJoin(_src("partsupp"), forest_parts, [("ps_partkey", "p_partkey")])
    l = O.Filter(
        _src("lineitem"),
        land(Col("l_shipdate") >= ymd(1994, 1, 1), Col("l_shipdate") < ymd(1995, 1, 1)),
    )
    fss = O.FilterScalarSub(
        ps,
        l,
        correlate=[("ps_partkey", "l_partkey"), ("ps_suppkey", "l_suppkey")],
        agg=O.Agg("sum", Col("l_quantity")),
        cmp=">",
        outer_expr=Col("ps_availqty"),
        scale=0.5,
    )
    n = O.Filter(_src("nation"), Col("n_name").eq(enc(db, "nation", "n_name", "CANADA")))
    j = jn(_src("supplier"), n, [("s_nationkey", "n_nationkey")])
    semi = O.SemiJoin(j, fss, [("s_suppkey", "ps_suppkey")])
    return O.Sort(O.Project(semi, ["s_name", "s_acctbal"]), [("s_name", True)])


def q21(db) -> O.Node:
    n = O.Filter(_src("nation"), Col("n_name").eq(enc(db, "nation", "n_name", "SAUDI ARABIA")))
    l1 = O.Filter(_src("lineitem"), Col("l_receiptdate") > Col("l_commitdate"))
    o = O.Filter(_src("orders"), Col("o_orderstatus").eq(enc(db, "orders", "o_orderstatus", "F")))
    j = jn(_src("supplier"), l1, [("s_suppkey", "l_suppkey")])
    j = jn(j, o, [("l_orderkey", "o_orderkey")])
    j = jn(j, n, [("s_nationkey", "n_nationkey")])
    l2 = O.Alias(_src("lineitem"), "l2_")
    semi = O.SemiJoin(
        j, l2, [("l_orderkey", "l2_l_orderkey")], pred=Col("l2_l_suppkey").ne(Col("l_suppkey"))
    )
    l3 = O.Alias(
        O.Filter(_src("lineitem"), Col("l_receiptdate") > Col("l_commitdate")), "l3_"
    )
    anti = O.AntiJoin(
        semi, l3, [("l_orderkey", "l3_l_orderkey")], pred=Col("l3_l_suppkey").ne(Col("l_suppkey"))
    )
    g = O.GroupBy(anti, ["s_name"], {"numwait": O.Agg("count")})
    return O.Sort(g, [("numwait", False), ("s_name", True)], limit=100)


def q22(db) -> O.Node:
    codes = (13, 31, 23, 29, 30, 18, 17)
    c = O.Filter(_src("customer"), IsIn(Col("c_phone_cntry"), codes))
    inner = O.Filter(
        _src("customer"),
        land(Col("c_acctbal") > 0.0, IsIn(Col("c_phone_cntry"), codes)),
    )
    fss = O.FilterScalarSub(
        c,
        inner,
        correlate=[],
        agg=O.Agg("mean", Col("c_acctbal")),
        cmp=">",
        outer_expr=Col("c_acctbal"),
    )
    aj = O.AntiJoin(fss, _src("orders"), [("c_custkey", "o_custkey")])
    g = O.GroupBy(
        aj,
        ["c_phone_cntry"],
        {"numcust": O.Agg("count"), "totacctbal": O.Agg("sum", Col("c_acctbal"))},
    )
    return O.Sort(g, [("c_phone_cntry", True)])


ALL_QUERIES = {
    f"q{i}": fn
    for i, fn in [
        (1, q1), (2, q2), (3, q3), (4, q4), (5, q5), (6, q6), (7, q7), (8, q8),
        (9, q9), (10, q10), (11, q11), (12, q12), (13, q13), (14, q14), (15, q15),
        (16, q16), (17, q17), (18, q18), (19, q19), (20, q20), (21, q21), (22, q22),
    ]
}
