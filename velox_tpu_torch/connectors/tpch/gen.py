"""TPC-H data generator, numpy-vectorized and deterministic.

Reference: velox/tpch/gen/TpchGen.h:72-232 wraps the vendored dbgen C code
(velox/tpch/gen/dbgen/).  This is a from-scratch implementation of the TPC-H
specification's generation rules (key sparsity, population formulas, date windows,
price formulas, value distributions) with its own seeded PCG64 streams — it is NOT
dbgen-bit-exact (the reference's dbgen RNG streams are not reproduced), so parity
testing runs engine-vs-oracle over *this* generator's output rather than
engine-vs-dbgen.  Distributions and cardinalities match the spec, so query
selectivities and group counts are realistic.

Decimals are generated directly as unscaled int64 (scale 2) — exact fixed-point
end-to-end, where the reference's TPC-H connector materializes DOUBLE
(velox/connectors/tpch/TpchConnector.h).

All generators are column-pruned: only requested columns are materialized
(mirrors the reference ColumnSelector, velox/dwio/common/ColumnSelector.h).
"""

from __future__ import annotations

import datetime
from typing import Dict, List, Optional, Sequence

import numpy as np

from ...dtypes import (
    BIGINT,
    DATE,
    INTEGER,
    RowType,
    VARCHAR,
    decimal,
)
from ...io.table import Table
from ...vector.string_table import StringTable

DEC = decimal(12, 2)

_EPOCH = datetime.date(1970, 1, 1)


def _days(date_str: str) -> int:
    return (datetime.date.fromisoformat(date_str) - _EPOCH).days


STARTDATE = _days("1992-01-01")
CURRENTDATE = _days("1995-06-17")
ENDDATE = _days("1998-12-31")

SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
SHIPMODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]
INSTRUCTIONS = ["DELIVER IN PERSON", "COLLECT COD", "NONE", "TAKE BACK RETURN"]

NATIONS = [
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
    ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
    ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
    ("UNITED KINGDOM", 3), ("UNITED STATES", 1),
]
REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]

P_NAME_WORDS = [
    "almond", "antique", "aquamarine", "azure", "beige", "bisque", "black",
    "blanched", "blue", "blush", "brown", "burlywood", "burnished", "chartreuse",
    "chiffon", "chocolate", "coral", "cornflower", "cornsilk", "cream", "cyan",
    "dark", "deep", "dim", "dodger", "drab", "firebrick", "floral", "forest",
    "frosted", "gainsboro", "ghost", "goldenrod", "green", "grey", "honeydew",
    "hot", "indian", "ivory", "khaki", "lace", "lavender", "lawn", "lemon",
    "light", "lime", "linen", "magenta", "maroon", "medium", "metallic", "midnight",
    "mint", "misty", "moccasin", "navajo", "navy", "olive", "orange", "orchid",
    "pale", "papaya", "peach", "peru", "pink", "plum", "powder", "puff", "purple",
    "red", "rose", "rosy", "royal", "saddle", "salmon", "sandy", "seashell",
    "sienna", "sky", "slate", "smoke", "snow", "spring", "steel", "tan", "thistle",
    "tomato", "turquoise", "violet", "wheat", "white", "yellow",
]
TYPE_S1 = ["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"]
TYPE_S2 = ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
TYPE_S3 = ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]
CONTAINER_S1 = ["SM", "LG", "MED", "JUMBO", "WRAP"]
CONTAINER_S2 = ["CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM"]

# TPC-H §4.2.2.13 text grammar vocabulary (abridged word lists; grammar shape kept).
_NOUNS = (
    "packages requests accounts deposits foxes ideas theodolites pinto beans "
    "instructions dependencies excuses platelets asymptotes courts dolphins "
    "multipliers sauternes warthogs frets dinos attainments somas braids hockey "
    "players frays warhorses dugouts notornis epitaphs pearls tithes waters orbits "
    "gifts sheaves depths sentiments decoys realms pains grouches escapades"
).split()
_VERBS = (
    "sleep wake are cajole haggle nag use boost affix detect integrate maintain "
    "nod was lose sublate solve thrash promise engage hinder print x-ray breach "
    "eat grow impress mold poach serve run dazzle snooze doze unwind kindle play "
    "hang believe doubt"
).split()
_ADJECTIVES = (
    "furious sly careful blithe quick fluffy slow quiet ruthless thin close dogged "
    "daring brave stealthy permanent enticing idle busy regular final ironic even "
    "bold silent special pending unusual express"
).split()
_ADVERBS = (
    "sometimes always never furiously slyly carefully blithely quickly fluffily "
    "slowly quietly ruthlessly thinly closely doggedly daringly bravely stealthily "
    "permanently enticingly idly busily regularly finally ironically evenly boldly "
    "silently"
).split()
_PREPOSITIONS = (
    "about above according to across after against along alongside of amid among "
    "apart from around as at atop before behind beneath beside besides between "
    "beyond by despite during except for from in place of inside instead of into "
    "near of on outside over past since through throughout to toward under until "
    "up upon without with within"
).split()

TABLE_NAMES = (
    "lineitem",
    "orders",
    "customer",
    "part",
    "supplier",
    "partsupp",
    "nation",
    "region",
)

SCHEMAS: Dict[str, RowType] = {
    "lineitem": RowType(
        [
            "l_orderkey", "l_partkey", "l_suppkey", "l_linenumber", "l_quantity",
            "l_extendedprice", "l_discount", "l_tax", "l_returnflag",
            "l_linestatus", "l_shipdate", "l_commitdate", "l_receiptdate",
            "l_shipinstruct", "l_shipmode", "l_comment",
        ],
        [
            BIGINT, BIGINT, BIGINT, INTEGER, DEC, DEC, DEC, DEC, VARCHAR,
            VARCHAR, DATE, DATE, DATE, VARCHAR, VARCHAR, VARCHAR,
        ],
    ),
    "orders": RowType(
        [
            "o_orderkey", "o_custkey", "o_orderstatus", "o_totalprice",
            "o_orderdate", "o_orderpriority", "o_clerk", "o_shippriority",
            "o_comment",
        ],
        [BIGINT, BIGINT, VARCHAR, DEC, DATE, VARCHAR, VARCHAR, INTEGER, VARCHAR],
    ),
    "customer": RowType(
        [
            "c_custkey", "c_name", "c_address", "c_nationkey", "c_phone",
            "c_acctbal", "c_mktsegment", "c_comment",
        ],
        [BIGINT, VARCHAR, VARCHAR, BIGINT, VARCHAR, DEC, VARCHAR, VARCHAR],
    ),
    "part": RowType(
        [
            "p_partkey", "p_name", "p_mfgr", "p_brand", "p_type", "p_size",
            "p_container", "p_retailprice", "p_comment",
        ],
        [BIGINT, VARCHAR, VARCHAR, VARCHAR, VARCHAR, INTEGER, VARCHAR, DEC, VARCHAR],
    ),
    "supplier": RowType(
        ["s_suppkey", "s_name", "s_address", "s_nationkey", "s_phone", "s_acctbal", "s_comment"],
        [BIGINT, VARCHAR, VARCHAR, BIGINT, VARCHAR, DEC, VARCHAR],
    ),
    "partsupp": RowType(
        ["ps_partkey", "ps_suppkey", "ps_availqty", "ps_supplycost", "ps_comment"],
        [BIGINT, BIGINT, INTEGER, DEC, VARCHAR],
    ),
    "nation": RowType(
        ["n_nationkey", "n_name", "n_regionkey", "n_comment"],
        [BIGINT, VARCHAR, BIGINT, VARCHAR],
    ),
    "region": RowType(
        ["r_regionkey", "r_name", "r_comment"],
        [BIGINT, VARCHAR, VARCHAR],
    ),
}


def _rng(table: str, column: str, sf: float) -> np.random.Generator:
    # hashlib, not hash(): python's str hash is salted per process and would make
    # generation irreproducible across runs.
    import hashlib

    digest = hashlib.sha256(f"{table}/{column}/{float(sf)}".encode()).digest()
    return np.random.Generator(np.random.PCG64(int.from_bytes(digest[:8], "little")))


def _retail_price_cents(partkey: np.ndarray) -> np.ndarray:
    """TPC-H §4.2.3: p_retailprice = (90000 + ((pk/10) mod 20001) + 100 (pk mod 1000)) / 100."""
    pk = partkey.astype(np.int64)
    return 90000 + (pk // 10) % 20001 + 100 * (pk % 1000)


def _sparse_orderkey(index: np.ndarray) -> np.ndarray:
    """TPC-H orderkey sparsity: 8 keys used out of every 32."""
    return (index // 8) * 32 + (index % 8) + 1


def _comment_text(
    rng: np.random.Generator, n: int, special_requests_frac: float = 0.0
) -> List[str]:
    """Sentence-shaped comments from the spec vocabulary.

    ``special_requests_frac`` rows contain 'special ... requests' so that the Q13
    anti-LIKE predicate is selective, as with dbgen text.  Words are drawn as
    indices (``rng.choice(len(words), n)`` consumes the stream as
    ``rng.choice(words, n)`` does) and joined as python strings.
    """
    adv, adj, noun, verb, prep, noun2 = (
        np.asarray(words, dtype=object)[rng.choice(len(words), n)].tolist()
        for words in (_ADVERBS, _ADJECTIVES, _NOUNS, _VERBS, _PREPOSITIONS, _NOUNS)
    )
    out = [
        f"{a} {b} {c} {d} {e} the {f}"
        for a, b, c, d, e, f in zip(adv, adj, noun, verb, prep, noun2)
    ]
    if special_requests_frac > 0:
        hits = rng.random(n) < special_requests_frac
        for i in np.flatnonzero(hits).tolist():
            out[i] = f"{adv[i]} special {noun[i]} requests {verb[i]}"
    return out


def _intern(values: Sequence[str]) -> tuple:
    t = StringTable()
    return t.intern_all(values), t


def _phone(rng: np.random.Generator, nationkey: np.ndarray) -> List[str]:
    a = nationkey + 10
    b = rng.integers(100, 1000, len(nationkey))
    c = rng.integers(100, 1000, len(nationkey))
    d = rng.integers(1000, 10000, len(nationkey))
    return [
        f"{w}-{x}-{y}-{z}" for w, x, y, z in zip(a.tolist(), b.tolist(), c.tolist(), d.tolist())
    ]


class _Builder:
    """Collects only the requested columns."""

    def __init__(self, table: str, columns: Optional[Sequence[str]]):
        self.schema_full = SCHEMAS[table]
        self.want = list(columns) if columns else list(self.schema_full.names)
        for c in self.want:
            if c not in self.schema_full:
                raise KeyError(f"unknown column {c!r} of {table}")
        self.cols: Dict[str, np.ndarray] = {}
        self.tables: Dict[str, StringTable] = {}

    def needs(self, *names: str) -> bool:
        return any(n in self.want for n in names)

    def put(self, name: str, arr: np.ndarray) -> None:
        if name in self.want:
            self.cols[name] = arr

    def put_strings(self, name: str, values: Sequence[str]) -> None:
        if name in self.want:
            codes, table = _intern(values)
            self.cols[name] = codes
            self.tables[name] = table

    def put_categorical(self, name: str, codes: np.ndarray, categories: Sequence[str]) -> None:
        """Low-cardinality string column: codes index a fixed category list."""
        if name in self.want:
            table = StringTable()
            remap = table.intern_all(list(categories))
            self.cols[name] = remap[codes].astype(np.int32)
            self.tables[name] = table

    def finish(self) -> Table:
        schema = RowType(self.want, [self.schema_full.type_of(n) for n in self.want])
        return Table(schema, {n: self.cols[n] for n in self.want}, self.tables)


# ---- table generators ----------------------------------------------------


def gen_region(sf: float = 1.0, columns=None) -> Table:
    b = _Builder("region", columns)
    b.put("r_regionkey", np.arange(5, dtype=np.int64))
    b.put_categorical("r_name", np.arange(5), REGIONS)
    b.put_strings("r_comment", _comment_text(_rng("region", "comment", sf), 5))
    return b.finish()


def gen_nation(sf: float = 1.0, columns=None) -> Table:
    b = _Builder("nation", columns)
    b.put("n_nationkey", np.arange(25, dtype=np.int64))
    b.put_categorical("n_name", np.arange(25), [n for n, _ in NATIONS])
    b.put("n_regionkey", np.asarray([r for _, r in NATIONS], dtype=np.int64))
    b.put_strings("n_comment", _comment_text(_rng("nation", "comment", sf), 25))
    return b.finish()


def gen_supplier(sf: float = 1.0, columns=None) -> Table:
    n = int(10_000 * sf)
    b = _Builder("supplier", columns)
    keys = np.arange(1, n + 1, dtype=np.int64)
    b.put("s_suppkey", keys)
    if b.needs("s_name"):
        b.put_strings("s_name", [f"Supplier#{k:09d}" for k in keys.tolist()])
    if b.needs("s_address"):
        rng = _rng("supplier", "address", sf)
        lengths = rng.integers(10, 41, n)
        b.put_strings("s_address", _random_alnum(rng, lengths))
    nat = _rng("supplier", "nation", sf).integers(0, 25, n).astype(np.int64)
    b.put("s_nationkey", nat)
    if b.needs("s_phone"):
        b.put_strings("s_phone", _phone(_rng("supplier", "phone", sf), nat))
    b.put(
        "s_acctbal",
        _rng("supplier", "acctbal", sf).integers(-99999, 999999 + 1, n).astype(np.int64),
    )
    if b.needs("s_comment"):
        b.put_strings("s_comment", _comment_text(_rng("supplier", "comment", sf), n))
    return b.finish()


def gen_part(sf: float = 1.0, columns=None) -> Table:
    n = int(200_000 * sf)
    b = _Builder("part", columns)
    keys = np.arange(1, n + 1, dtype=np.int64)
    b.put("p_partkey", keys)
    rng = _rng("part", "strings", sf)
    if b.needs("p_name"):
        w = rng.choice(P_NAME_WORDS, (n, 5))
        b.put_strings("p_name", [" ".join(row) for row in w.tolist()])
    mfgr = rng.integers(1, 6, n)
    b.put_categorical("p_mfgr", mfgr - 1, [f"Manufacturer#{i}" for i in range(1, 6)])
    if b.needs("p_brand"):
        brand = mfgr * 10 + rng.integers(1, 6, n)
        b.put_categorical(
            "p_brand",
            (mfgr - 1) * 5 + (brand % 10) - 1,
            [f"Brand#{m}{x}" for m in range(1, 6) for x in range(1, 6)],
        )
    if b.needs("p_type"):
        combos = [f"{a} {b_} {c}" for a in TYPE_S1 for b_ in TYPE_S2 for c in TYPE_S3]
        b.put_categorical("p_type", rng.integers(0, len(combos), n), combos)
    b.put("p_size", rng.integers(1, 51, n).astype(np.int32))
    if b.needs("p_container"):
        combos = [f"{a} {b_}" for a in CONTAINER_S1 for b_ in CONTAINER_S2]
        b.put_categorical("p_container", rng.integers(0, len(combos), n), combos)
    b.put("p_retailprice", _retail_price_cents(keys))
    if b.needs("p_comment"):
        b.put_strings("p_comment", _comment_text(_rng("part", "comment", sf), n))
    return b.finish()


def gen_partsupp(sf: float = 1.0, columns=None) -> Table:
    parts = int(200_000 * sf)
    s_count = int(10_000 * sf)
    n = parts * 4
    b = _Builder("partsupp", columns)
    pk = np.repeat(np.arange(1, parts + 1, dtype=np.int64), 4)
    i = np.tile(np.arange(4, dtype=np.int64), parts)
    b.put("ps_partkey", pk)
    # TPC-H §4.2.3 supplier spread formula.
    b.put(
        "ps_suppkey",
        (pk + i * (s_count // 4 + (pk - 1) // s_count)) % s_count + 1,
    )
    rng = _rng("partsupp", "vals", sf)
    b.put("ps_availqty", rng.integers(1, 10_000, n).astype(np.int32))
    b.put("ps_supplycost", rng.integers(100, 100_001, n).astype(np.int64))
    if b.needs("ps_comment"):
        b.put_strings("ps_comment", _comment_text(_rng("partsupp", "comment", sf), n))
    return b.finish()


def gen_customer(sf: float = 1.0, columns=None) -> Table:
    n = int(150_000 * sf)
    b = _Builder("customer", columns)
    keys = np.arange(1, n + 1, dtype=np.int64)
    b.put("c_custkey", keys)
    if b.needs("c_name"):
        b.put_strings("c_name", [f"Customer#{k:09d}" for k in keys.tolist()])
    if b.needs("c_address"):
        rng = _rng("customer", "address", sf)
        b.put_strings("c_address", _random_alnum(rng, rng.integers(10, 41, n)))
    nat = _rng("customer", "nation", sf).integers(0, 25, n).astype(np.int64)
    b.put("c_nationkey", nat)
    if b.needs("c_phone"):
        b.put_strings("c_phone", _phone(_rng("customer", "phone", sf), nat))
    b.put(
        "c_acctbal",
        _rng("customer", "acctbal", sf).integers(-99999, 999999 + 1, n).astype(np.int64),
    )
    b.put_categorical(
        "c_mktsegment",
        _rng("customer", "segment", sf).integers(0, 5, n),
        SEGMENTS,
    )
    if b.needs("c_comment"):
        b.put_strings("c_comment", _comment_text(_rng("customer", "comment", sf), n))
    return b.finish()


def _order_counts(sf: float):
    orders = int(1_500_000 * sf)
    rng = _rng("orders", "lines", sf)
    line_counts = rng.integers(1, 8, orders)
    return orders, line_counts


def gen_orders(sf: float = 1.0, columns=None) -> Table:
    n, line_counts = _order_counts(sf)
    customers = int(150_000 * sf)
    b = _Builder("orders", columns)
    idx = np.arange(n, dtype=np.int64)
    b.put("o_orderkey", _sparse_orderkey(idx))
    # Only customers with custkey % 3 != 0 place orders (spec: 1/3 have none).
    cand = _rng("orders", "custkey", sf).integers(0, customers - customers // 3, n)
    b.put("o_custkey", cand + cand // 2 + 1)
    odate = _rng("orders", "orderdate", sf).integers(
        STARTDATE, ENDDATE - 151 + 1, n
    ).astype(np.int32)
    b.put("o_orderdate", odate)
    need_status = b.needs("o_orderstatus")
    need_total = b.needs("o_totalprice")
    if need_status or need_total:
        line = _lineitem_core(sf, line_counts, odate)
        starts = np.zeros(n, dtype=np.int64)
        np.cumsum(line_counts[:-1], out=starts[1:])
        if need_total:
            per_line = _line_net_cents(line)
            b.put("o_totalprice", np.add.reduceat(per_line, starts))
        if need_status:
            is_f = line["shipdate"] <= CURRENTDATE
            all_f = np.add.reduceat(is_f.astype(np.int64), starts) == line_counts
            none_f = np.add.reduceat(is_f.astype(np.int64), starts) == 0
            codes = np.where(all_f, 0, np.where(none_f, 1, 2))
            b.put_categorical("o_orderstatus", codes, ["F", "O", "P"])
    b.put_categorical(
        "o_orderpriority",
        _rng("orders", "priority", sf).integers(0, 5, n),
        PRIORITIES,
    )
    if b.needs("o_clerk"):
        clerks = max(1, int(1000 * sf))
        c = _rng("orders", "clerk", sf).integers(1, clerks + 1, n)
        b.put_categorical(
            "o_clerk", c - 1, [f"Clerk#{i:09d}" for i in range(1, clerks + 1)]
        )
    b.put("o_shippriority", np.zeros(n, dtype=np.int32))
    if b.needs("o_comment"):
        b.put_strings(
            "o_comment",
            _comment_text(_rng("orders", "comment", sf), n, special_requests_frac=0.012),
        )
    return b.finish()


def _lineitem_core(sf: float, line_counts: np.ndarray, odate: np.ndarray) -> Dict[str, np.ndarray]:
    """Line-level numeric columns shared by orders (totalprice/status) and lineitem."""
    total = int(line_counts.sum())
    parts = int(200_000 * sf)
    rng = _rng("lineitem", "core", sf)
    quantity = rng.integers(1, 51, total).astype(np.int64)
    partkey = rng.integers(1, parts + 1, total).astype(np.int64)
    discount = rng.integers(0, 11, total).astype(np.int64)
    tax = rng.integers(0, 9, total).astype(np.int64)
    o_rep = np.repeat(odate.astype(np.int64), line_counts)
    shipdate = o_rep + rng.integers(1, 122, total)
    commitdate = o_rep + rng.integers(30, 91, total)
    receiptdate = shipdate + rng.integers(1, 31, total)
    extprice = quantity * _retail_price_cents(partkey)
    return dict(
        quantity=quantity,
        partkey=partkey,
        discount=discount,
        tax=tax,
        shipdate=shipdate,
        commitdate=commitdate,
        receiptdate=receiptdate,
        extprice=extprice,
    )


def _line_net_cents(line: Dict[str, np.ndarray]) -> np.ndarray:
    """round(round(ep*(1-disc)) * (1+tax)) in cents, per line."""
    ep = line["extprice"]
    disc_price = (ep * (100 - line["discount"]) + 50) // 100
    return (disc_price * (100 + line["tax"]) + 50) // 100


def gen_lineitem(sf: float = 1.0, columns=None) -> Table:
    n_orders, line_counts = _order_counts(sf)
    odate = _rng("orders", "orderdate", sf).integers(
        STARTDATE, ENDDATE - 151 + 1, n_orders
    ).astype(np.int32)
    line = _lineitem_core(sf, line_counts, odate)
    total = int(line_counts.sum())
    b = _Builder("lineitem", columns)
    okeys = _sparse_orderkey(np.arange(n_orders, dtype=np.int64))
    b.put("l_orderkey", np.repeat(okeys, line_counts))
    b.put("l_partkey", line["partkey"])
    if b.needs("l_suppkey"):
        s_count = int(10_000 * sf)
        i4 = _rng("lineitem", "suppsel", sf).integers(0, 4, total).astype(np.int64)
        pk = line["partkey"]
        b.put(
            "l_suppkey",
            (pk + i4 * (s_count // 4 + (pk - 1) // s_count)) % s_count + 1,
        )
    if b.needs("l_linenumber"):
        starts = np.cumsum(line_counts) - line_counts  # each order's first line
        ln = np.arange(total, dtype=np.int64) - np.repeat(starts, line_counts) + 1
        b.put("l_linenumber", ln.astype(np.int32))
    b.put("l_quantity", line["quantity"] * 100)
    b.put("l_extendedprice", line["extprice"])
    b.put("l_discount", line["discount"])
    b.put("l_tax", line["tax"])
    if b.needs("l_returnflag"):
        r = _rng("lineitem", "returnflag", sf).integers(0, 2, total)
        codes = np.where(line["receiptdate"] <= CURRENTDATE, r, 2)
        b.put_categorical("l_returnflag", codes, ["R", "A", "N"])
    if b.needs("l_linestatus"):
        codes = (line["shipdate"] > CURRENTDATE).astype(np.int64)
        b.put_categorical("l_linestatus", codes, ["F", "O"])
    b.put("l_shipdate", line["shipdate"].astype(np.int32))
    b.put("l_commitdate", line["commitdate"].astype(np.int32))
    b.put("l_receiptdate", line["receiptdate"].astype(np.int32))
    b.put_categorical(
        "l_shipinstruct",
        _rng("lineitem", "instruct", sf).integers(0, 4, total),
        INSTRUCTIONS,
    )
    b.put_categorical(
        "l_shipmode",
        _rng("lineitem", "shipmode", sf).integers(0, 7, total),
        SHIPMODES,
    )
    if b.needs("l_comment"):
        b.put_strings("l_comment", _comment_text(_rng("lineitem", "comment", sf), total))
    return b.finish()


def _random_alnum(rng: np.random.Generator, lengths: np.ndarray) -> List[str]:
    alphabet = np.frombuffer(
        b"abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789 ,", dtype=np.uint8
    )
    total = int(lengths.sum())
    chars = rng.integers(0, len(alphabet), total)
    flat = alphabet[chars].tobytes().decode("ascii")
    ends = np.cumsum(lengths).tolist()
    return [flat[a:b] for a, b in zip([0, *ends[:-1]], ends)]


_GENERATORS = {
    "lineitem": gen_lineitem,
    "orders": gen_orders,
    "customer": gen_customer,
    "part": gen_part,
    "supplier": gen_supplier,
    "partsupp": gen_partsupp,
    "nation": gen_nation,
    "region": gen_region,
}


def generate_table(name: str, sf: float = 1.0, columns: Optional[Sequence[str]] = None) -> Table:
    """Generate one TPC-H table at scale factor ``sf`` (column-pruned)."""
    return _GENERATORS[name](sf, columns)
