"""dbgen-bit-exact TPC-H generator (vectorized numpy).

Counterpart of the JAX package's ``connectors/tpch/dbgen.py``, the same
algorithm and constants, with its own copy of ``dists.dss`` (TPC-published
data) beside it; tables come back as this package's ``Table``.

Reference: velox/tpch/gen/dbgen/ (build.cpp mk_order, rnd.cpp NextRand/UnifInt,
dss.h seed table + constants) — TPC's dbgen drives every column off an
independent Park-Miller "minimum standard" LCG stream (CACM Oct 1988):

    seed' = seed * 16807 mod (2^31 - 1)
    UnifInt(lo, hi): floor(seed' / 2147483647.0 * (hi - lo + 1)) + lo

and advances every stream by a FIXED per-row stride at row end
(row_stop_h / NthElement in the reference), which makes each stream's state a
pure function of the row number:

    seed_at(row, use) = seed0 * 16807^(row*stride + use) mod M

That property turns the whole generator into vectorized modular
exponentiation — no sequential scan, bit-identical output.

Purpose: the main generator (gen.py) is deliberately NOT dbgen; this module
produces dbgen-exact tables so that Q1 / Q6 / Q3 results can be validated
against the TPC-H specification's published SF 1 answer set, an artifact
this repo's authors did not produce.  Columns keep gen.py's representation
(DECIMAL unscaled, flags and text as dictionary codes).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

_M = 2147483647  # 2^31 - 1 (Park-Miller modulus)
_A = 16807

# stream seeds + per-row strides (dss.h Seed[] table; stride = boundary)
O_CKEY_SD = (851767375, 1)
O_ODATE_SD = (1066728069, 1)
O_LCNT_SD = (1434868289, 1)
L_QTY_SD = (209208115, 7)
L_DCNT_SD = (554590007, 7)
L_TAX_SD = (721958466, 7)
L_PKEY_SD = (1808217256, 7)
L_SKEY_SD = (2095021727, 7)
L_SDTE_SD = (1769349045, 7)
L_CDTE_SD = (904914315, 7)
L_RDTE_SD = (373135028, 7)
L_RFLG_SD = (717419739, 7)

# dss.h scalar constants
O_LCNT_MIN, O_LCNT_MAX = 1, 7
L_QTY_MIN, L_QTY_MAX = 1, 50
L_DCNT_MIN, L_DCNT_MAX = 0, 10
L_TAX_MIN, L_TAX_MAX = 0, 8
L_SDTE_MIN, L_SDTE_MAX = 1, 121
L_CDTE_MIN, L_CDTE_MAX = 30, 90
L_RDTE_MIN, L_RDTE_MAX = 1, 30
TOTDATE = 2557
STARTDATE_OFFSET = 0  # linear day offset of 1992-01-01
CURRENTDATE_OFFSET = 1263  # 1995-06-17 as days since 1992-01-01
ORDERS_PER_SF = 1_500_000
CUSTOMERS_PER_SF = 150_000
PARTS_PER_SF = 200_000
SUPPLIERS_PER_SF = 10_000
EPOCH_1992 = 8035  # days from 1970-01-01 to 1992-01-01


_POW_TABLES = None


def _pow_tables():
    """Base-256 digit tables: T[d][j] = 16807^(j * 256^d) mod (2^31-1) for
    exponents up to 2^32 (covers SF <= ~400).  Turns per-element modular
    exponentiation into 3 multiply-mods + 4 gathers."""
    global _POW_TABLES
    if _POW_TABLES is None:
        tables = []
        base = _A
        for _ in range(4):
            t = np.ones(256, np.int64)
            for j in range(1, 256):
                t[j] = (t[j - 1] * base) % _M
            tables.append(t)
            base = (int(t[255]) * base) % _M  # base^256
        _POW_TABLES = tables
    return _POW_TABLES


def _powmod_vec(exponents: np.ndarray) -> np.ndarray:
    """16807^e mod (2^31-1) per element (int64-safe: operands < 2^31 so
    products < 2^62)."""
    t0, t1, t2, t3 = _pow_tables()
    e = exponents if exponents.dtype == np.int64 else exponents.astype(np.int64)
    r = t0[e & 255]
    r = (r * t1[(e >> 8) & 255]) % _M
    r = (r * t2[(e >> 16) & 255]) % _M
    r = (r * t3[(e >> 24) & 255]) % _M
    return r


def _seed_at(seed0: int, exponents: np.ndarray) -> np.ndarray:
    """Stream value after ``exponents`` NextRand() calls from ``seed0``."""
    return (np.int64(seed0) * _powmod_vec(exponents)) % _M


def _unif(seed_vals: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """dbgen UnifInt on already-advanced stream values (rnd.cpp:129)."""
    return (
        (seed_vals.astype(np.float64) / float(_M)) * float(hi - lo + 1)
    ).astype(np.int64) + lo


def _stream(sd, row: np.ndarray, use: np.ndarray, lo: int, hi: int):
    seed0, stride = sd
    return _unif(_seed_at(seed0, row * stride + use), lo, hi)


def sparse_orderkey(index_1based: np.ndarray) -> np.ndarray:
    """mk_sparse (build.cpp:95): 8 keys per 32-key block (SPARSE_KEEP=3,
    SPARSE_BITS=2, update segment 0)."""
    i = index_1based.astype(np.int64)
    return ((i >> 3) << 5) | (i & 7)


def gen_orders_lineitem(sf: float) -> Dict[str, Dict[str, np.ndarray]]:
    """dbgen-exact ORDERS + LINEITEM numeric/date/flag columns.

    Returns {"orders": {...}, "lineitem": {...}} with dates as int32 days
    since 1970-01-01 (the engine's DATE representation) and money columns as
    unscaled cents (DECIMAL(x, 2) representation).
    """
    n_orders = int(round(ORDERS_PER_SF * sf))
    o_row = np.arange(n_orders, dtype=np.int64)

    # ORDERS ----------------------------------------------------------------
    okey = sparse_orderkey(o_row + 1)
    ckey_max = int(round(CUSTOMERS_PER_SF * sf))
    ckey = _stream(O_CKEY_SD, o_row, np.int64(1), 1, ckey_max)
    # customers divisible by 3 hold no orders (CUST_MORTALITY): +1/-1 walk
    # with a clamp at ckey_max (mk_order's while loop; one or two steps)
    div3 = ckey % 3 == 0
    bumped = np.minimum(ckey + 1, ckey_max)
    still = div3 & (bumped % 3 == 0)  # only when the clamp hits a multiple
    ckey = np.where(div3, np.where(still, bumped - 1, bumped), ckey)
    odate_max = TOTDATE - (L_SDTE_MAX + L_RDTE_MAX) - 1
    odate = _stream(O_ODATE_SD, o_row, np.int64(1), 0, odate_max)
    lcnt = _stream(O_LCNT_SD, o_row, np.int64(1), O_LCNT_MIN, O_LCNT_MAX)

    # LINEITEM ---------------------------------------------------------------
    n_lines = int(lcnt.sum())
    line_order = np.repeat(o_row, lcnt)  # order row per line
    starts = np.concatenate([[0], np.cumsum(lcnt)[:-1]])
    line_no = np.arange(n_lines, dtype=np.int64) - starts[line_order]
    use = line_no + 1  # k-th line consumes the stream's k-th draw

    quantity = _stream(L_QTY_SD, line_order, use, L_QTY_MIN, L_QTY_MAX)
    discount = _stream(L_DCNT_SD, line_order, use, L_DCNT_MIN, L_DCNT_MAX)
    tax = _stream(L_TAX_SD, line_order, use, L_TAX_MIN, L_TAX_MAX)
    pkey_max = int(round(PARTS_PER_SF * sf))
    partkey = _stream(L_PKEY_SD, line_order, use, 1, pkey_max)
    supp_num = _stream(L_SKEY_SD, line_order, use, 0, 3)
    scnt = int(round(SUPPLIERS_PER_SF * sf))
    # PART_SUPP_BRIDGE (dss.h): the 4 suppliers of part p
    suppkey = (
        partkey
        + supp_num * (scnt // 4 + (partkey - 1) // scnt)
    ) % scnt + 1
    # retail price bridge (bm_utils.cpp rpb_routine), in cents
    rprice = 90000 + (partkey // 10) % 20001 + (partkey % 1000) * 100
    eprice = rprice * quantity

    s_off = _stream(L_SDTE_SD, line_order, use, L_SDTE_MIN, L_SDTE_MAX)
    c_off = _stream(L_CDTE_SD, line_order, use, L_CDTE_MIN, L_CDTE_MAX)
    r_off = _stream(L_RDTE_SD, line_order, use, L_RDTE_MIN, L_RDTE_MAX)
    odate_l = odate[line_order]
    sdate = odate_l + s_off
    cdate = odate_l + c_off
    rdate = sdate + r_off

    # returnflag: drawn ONLY when receiptdate <= currentdate, so the use
    # index is the running count of such lines within the order
    returned = rdate <= CURRENTDATE_OFFSET
    cum = np.cumsum(returned)
    base = np.concatenate([[0], cum])[starts[line_order]]
    rflg_use = cum - base  # 1-based draw index for rows where returned
    rflg_draw = _stream(
        L_RFLG_SD, line_order, np.maximum(rflg_use, 1), 1, 2
    )
    returnflag = np.where(
        returned, np.where(rflg_draw == 1, ord("R"), ord("A")), ord("N")
    ).astype(np.uint8)
    shipped = sdate <= CURRENTDATE_OFFSET
    linestatus = np.where(shipped, ord("F"), ord("O")).astype(np.uint8)

    # order status + totalprice (mk_order's integer accumulation)
    line_total = (
        (eprice * (100 - discount)) // 100 * (100 + tax) // 100
    )
    totalprice = np.zeros(n_orders, dtype=np.int64)
    np.add.at(totalprice, line_order, line_total)
    f_lines = np.zeros(n_orders, dtype=np.int64)
    np.add.at(f_lines, line_order, shipped.astype(np.int64))
    orderstatus = np.where(
        f_lines == lcnt, ord("F"), np.where(f_lines > 0, ord("P"), ord("O"))
    ).astype(np.uint8)

    orders = {
        "o_orderkey": okey,
        "o_custkey": ckey,
        "o_orderstatus": orderstatus,
        "o_totalprice": totalprice,
        "o_orderdate": (odate + EPOCH_1992).astype(np.int32),
    }
    lineitem = {
        "l_orderkey": okey[line_order],
        "l_partkey": partkey,
        "l_suppkey": suppkey,
        "l_linenumber": (line_no + 1).astype(np.int64),
        "l_quantity": quantity,
        "l_extendedprice": eprice,
        "l_discount": discount,
        "l_tax": tax,
        "l_returnflag": returnflag,
        "l_linestatus": linestatus,
        "l_shipdate": (sdate + EPOCH_1992).astype(np.int32),
        "l_commitdate": (cdate + EPOCH_1992).astype(np.int32),
        "l_receiptdate": (rdate + EPOCH_1992).astype(np.int32),
    }
    return {"orders": orders, "lineitem": lineitem}


def lineitem_table(sf: float, columns=None, _raw=None):
    """dbgen-exact LINEITEM as an engine Table (gen.py's representation:
    DECIMAL(12,2) columns unscaled — quantity x100, prices in cents — and
    flags as dictionary codes)."""
    from ...io.table import Table
    from ...vector.string_table import StringTable
    from .gen import SCHEMAS  # engine schema source of truth

    raw = _raw if _raw is not None else gen_orders_lineitem(sf)["lineitem"]
    want = list(
        columns
        or [
            "l_orderkey", "l_partkey", "l_suppkey", "l_linenumber",
            "l_quantity", "l_extendedprice", "l_discount", "l_tax",
            "l_returnflag", "l_linestatus", "l_shipdate", "l_commitdate",
            "l_receiptdate",
        ]
    )
    cols, tables = {}, {}
    for name in want:
        if name == "l_quantity":
            cols[name] = raw["l_quantity"] * 100
        elif name in ("l_returnflag", "l_linestatus"):
            cats = ["R", "A", "N"] if name == "l_returnflag" else ["F", "O"]
            tab = StringTable()
            remap = {ord(c): code for c, code in zip(cats, tab.intern_all(cats))}
            lut = np.zeros(256, np.int32)
            for byte, code in remap.items():
                lut[byte] = code
            cols[name] = lut[raw[name]]
            tables[name] = tab
        else:
            cols[name] = raw[name]
    from ...dtypes import RowType

    schema_full = SCHEMAS["lineitem"]
    schema = RowType(want, [schema_full.type_of(n) for n in want])
    return Table(schema, cols, tables)


# ---------------------------------------------------------------------------
# dbgen-exact CUSTOMER / SUPPLIER / ORDERS text-free
# columns + alphanumeric "a-strings" (addresses) and phone numbers.
# Reference: velox/tpch/gen/dbgen/build.cpp mk_cust:69, mk_supp:263,
# gen_phone:54, bm_utils.cpp tpch_a_rnd:143; seeds dss.h:491-540.
# Every stream is realigned to its fixed per-row stride at row end
# (rnd.cpp row_stop_h:49), so values stay pure functions of the row number.

C_ADDR_SD = (881155353, 9)
C_NTRG_SD = (1489529863, 1)
C_PHNE_SD = (1521138112, 3)
C_ABAL_SD = (298370230, 1)
C_MSEG_SD = (1140279430, 1)
C_CMNT_SD = (1335826707, 2)
O_CLRK_SD = (1171034773, 1)
O_PRIO_SD = (591449447, 1)
O_CMNT_SD = (276090261, 2)
S_ADDR_SD = (706178559, 9)
S_NTRG_SD = (110356601, 1)
S_PHNE_SD = (884434366, 3)
S_ABAL_SD = (962338209, 1)
S_CMNT_SD = (1341315363, 2)
# supplier Better-Business-Bureau comment patch streams (dss.h:486-489)
BBB_JNK_SD = (263032577, 1)
BBB_TYPE_SD = (753643799, 1)
BBB_CMNT_SD = (202794285, 1)
BBB_OFFSET_SD = (715851524, 1)

V_STR_LOW, V_STR_HGH = 0.4, 1.6
C_ADDR_LEN, S_ADDR_LEN = 25, 25
C_ABAL_MIN, C_ABAL_MAX = -99999, 999999
O_CLRK_SCL = 1000
NATIONS = 25
# bm_utils.cpp:80 — the a-string alphabet (64 chars + NUL)
_ALPHA_NUM = np.frombuffer(
    b"0123456789abcdefghijklmnopqrstuvwxyz ABCDEFGHIJKLMNOPQRSTUVWXYZ,",
    dtype=np.uint8,
)[:64]
MKT_SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY"]
ORDER_PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]


def _a_strings(sd, rows: np.ndarray, avg_len: int) -> np.ndarray:
    """Vectorized tpch_a_rnd: per-row random alphanumeric string.

    One length draw + one draw per 5 characters; each draw's RAW stream value
    yields five base-64 digits (UnifInt(0, MAX_LONG) is the identity on the
    Park-Miller state: floor(v * 2^31 / (2^31-1)) == v for v < 2^31-1).
    Returns a numpy object array of str.
    """
    seed0, stride = sd
    lo, hi = int(avg_len * V_STR_LOW), int(avg_len * V_STR_HGH)
    base = rows * stride + 1
    lens = _unif(_seed_at(seed0, base), lo, hi)
    n = len(rows)
    max_draws = (hi + 4) // 5
    chars = np.zeros((n, max_draws * 5), dtype=np.uint8)
    ndraws = (lens + 4) // 5
    for k in range(max_draws):
        live = ndraws > k
        v = _seed_at(seed0, base + 1 + k)
        for j in range(5):
            digit = (v >> (6 * j)) & 63
            chars[:, 5 * k + j] = np.where(live, _ALPHA_NUM[digit], 0)
    flat = chars.reshape(-1).tobytes()
    w = max_draws * 5
    return np.asarray(
        [
            flat[i * w : i * w + int(lens[i])].decode("ascii")
            for i in range(n)
        ],
        dtype=object,
    )


def _phones(sd, rows: np.ndarray, nation: np.ndarray) -> np.ndarray:
    """gen_phone (build.cpp:54): 'CC-AAA-EEE-NNNN' with CC = 10 + nation."""
    seed0, stride = sd
    base = rows * stride
    acode = _unif(_seed_at(seed0, base + 1), 100, 999)
    exchg = _unif(_seed_at(seed0, base + 2), 100, 999)
    number = _unif(_seed_at(seed0, base + 3), 1000, 9999)
    cc = 10 + (nation % 90)
    return np.asarray(
        [
            f"{c:02d}-{a:03d}-{e:03d}-{x:04d}"
            for c, a, e, x in zip(cc, acode, exchg, number)
        ],
        dtype=object,
    )


def gen_customer(sf: float, with_text: bool = True) -> Dict[str, np.ndarray]:
    """dbgen-exact CUSTOMER columns (comment requires the text pool)."""
    n = int(round(CUSTOMERS_PER_SF * sf))
    r = np.arange(n, dtype=np.int64)
    out = {
        "c_custkey": r + 1,
        "c_name": np.asarray(
            [f"Customer#{k:09d}" for k in range(1, n + 1)], dtype=object
        ),
        "c_address": _a_strings(C_ADDR_SD, r, C_ADDR_LEN),
        "c_nationkey": _stream(C_NTRG_SD, r, np.int64(1), 0, NATIONS - 1),
        "c_acctbal": _stream(C_ABAL_SD, r, np.int64(1), C_ABAL_MIN, C_ABAL_MAX),
        "c_mktsegment": np.asarray(MKT_SEGMENTS, dtype=object)[
            _stream(C_MSEG_SD, r, np.int64(1), 1, 5) - 1
        ],
    }
    out["c_phone"] = _phones(C_PHNE_SD, r, out["c_nationkey"])
    if with_text:
        out["c_comment"] = comments(C_CMNT_SD, r, 73)
    return out


def gen_supplier(sf: float, with_text: bool = True) -> Dict[str, np.ndarray]:
    """dbgen-exact SUPPLIER columns (mk_supp, build.cpp:263)."""
    n = int(round(SUPPLIERS_PER_SF * sf))
    r = np.arange(n, dtype=np.int64)
    out = {
        "s_suppkey": r + 1,
        "s_name": np.asarray(
            [f"Supplier#{k:09d}" for k in range(1, n + 1)], dtype=object
        ),
        "s_address": _a_strings(S_ADDR_SD, r, S_ADDR_LEN),
        "s_nationkey": _stream(S_NTRG_SD, r, np.int64(1), 0, NATIONS - 1),
        "s_acctbal": _stream(S_ABAL_SD, r, np.int64(1), C_ABAL_MIN, C_ABAL_MAX),
    }
    out["s_phone"] = _phones(S_PHNE_SD, r, out["s_nationkey"])
    if with_text:
        out["s_comment"] = _supplier_comments(r)
    return out


def _supplier_comments(r: np.ndarray) -> np.ndarray:
    """s_comment with the BBB 'Customer Complaints/Recommends' patches
    (build.cpp:286-305): 5 in 10000 suppliers get 'Customer ' + noise junk +
    'Complaints'/'Recommends' spliced into their comment."""
    com = comments(S_CMNT_SD, r, 63)
    bad_press = _stream(BBB_CMNT_SD, r, np.int64(1), 1, 10000)
    btype = _stream(BBB_TYPE_SD, r, np.int64(1), 0, 100)
    clen = np.asarray([len(c) for c in com], dtype=np.int64)
    BBB_CMNT_LEN, BBB_BASE, BBB_TYPE_LEN = 19, "Customer ", 10
    # noise/offset draw RANGES depend on this row's comment length, so the
    # vectorized _stream helper does not apply; suppliers are only 10k/SF
    noise = np.asarray(
        [
            _unif(
                _seed_at(BBB_JNK_SD[0], np.asarray([i + 1], dtype=np.int64)),
                0,
                int(cl - BBB_CMNT_LEN),
            )[0]
            for i, cl in zip(r, clen)
        ],
        dtype=np.int64,
    )
    offset = np.asarray(
        [
            _unif(
                _seed_at(BBB_OFFSET_SD[0], np.asarray([i + 1], dtype=np.int64)),
                0,
                int(cl - (BBB_CMNT_LEN + nz)),
            )[0]
            for i, cl, nz in zip(r, clen, noise)
        ],
        dtype=np.int64,
    )
    S_CMNT_BBB, BBB_DEADBEATS = 10, 50
    out = com.copy()
    for i in np.flatnonzero(bad_press <= S_CMNT_BBB):
        word = "Complaints" if btype[i] < BBB_DEADBEATS else "Recommends"
        c = list(out[i])
        o, nz = int(offset[i]), int(noise[i])
        c[o : o + len(BBB_BASE)] = BBB_BASE
        start = len(BBB_BASE) + o + nz
        c[start : start + BBB_TYPE_LEN] = word
        out[i] = "".join(c)
    return out


def gen_orders_text(sf: float, with_text: bool = True) -> Dict[str, np.ndarray]:
    """o_orderpriority / o_clerk (and o_comment with the text pool)."""
    n = int(round(ORDERS_PER_SF * sf))
    r = np.arange(n, dtype=np.int64)
    clerk_num = _stream(
        O_CLRK_SD, r, np.int64(1), 1, max(int(sf), 1) * O_CLRK_SCL
    )
    out = {
        "o_orderpriority": np.asarray(ORDER_PRIORITIES, dtype=object)[
            _stream(O_PRIO_SD, r, np.int64(1), 1, 5) - 1
        ],
        "o_clerk": np.asarray(
            [f"Clerk#{k:09d}" for k in clerk_num], dtype=object
        ),
    }
    if with_text:
        out["o_comment"] = comments(O_CMNT_SD, r, 49)
    return out


# ---------------------------------------------------------------------------
# The dbgen pseudo-text pool (reference: velox/tpch/gen/dbgen/text.cpp
# init_text_pool:408/gen_sentence:359 and the TPC grammar distributions in
# dists.dss).  Comments are random substrings of one shared 10 MB pool
# (DBGenIterator.cpp:38 passes 10 MB — NOTE: classic TPC dbgen uses a
# 300 MB pool, so free-text columns deviate from the classic tool while all
# numeric/date/categorical columns remain spec-exact; validated against the
# reference generator's own output).  Grammar walk is sequential by nature
# (each sentence consumes a data-dependent number of Park-Miller draws), so
# the pool is built once from vectorized-precomputed stream values and cached
# on disk.

TEXT_POOL_SIZE = 10 * 1024 * 1024
TEXT_SD = 933588178  # stream 5 ("text pregeneration", dss.h:498)


def _load_dists():
    """Parse dists.dss (TPC-published data): name -> (cumweights, members)."""
    import os

    path = os.path.join(os.path.dirname(__file__), "dists.dss")
    dists: Dict[str, tuple] = {}
    name, members, weights, acc = None, [], [], 0
    for line in open(path, encoding="ascii"):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        low = line.lower()
        if low.startswith("begin"):
            name, members, weights, acc = line.split()[1].lower(), [], [], 0
        elif low.startswith("end"):
            dists[name] = (np.asarray(weights, np.int64), members)
            name = None
        elif name is not None:
            tok, w = line.rsplit("|", 1)
            if tok.lower() == "count":
                continue
            acc += int(w)
            members.append(tok)
            weights.append(acc)
    return dists


_DISTS = None


def _dist(name: str):
    global _DISTS
    if _DISTS is None:
        _DISTS = _load_dists()
    cum, members = _DISTS[name]
    maxw = int(cum[-1])
    # gen_index (text.cpp:267): weight w -> first member with cumweight >= w
    index = np.zeros(maxw + 1, dtype=np.int32)
    j = 0
    for w in range(maxw + 1):
        while cum[j] < w:
            j += 1
        index[w] = j
    return maxw, index, members


def _build_text_pool() -> bytes:
    """Bit-exact init_text_pool: sentences from stream 5 until the pool
    holds TEXT_POOL_SIZE+1 bytes."""
    dists = {
        n: _dist(n)
        for n in (
            "nouns", "verbs", "adjectives", "adverbs", "auxillaries",
            "prepositions", "terminators", "grammar", "np", "vp",
        )
    }
    g_maxw, _, _ = dists["grammar"]
    g_cum = _DISTS["grammar"][0]
    np_maxw, _, _ = dists["np"]
    np_cum = _DISTS["np"][0]
    vp_maxw, _, _ = dists["vp"]
    vp_cum = _DISTS["vp"][0]
    # pre-encode member byte strings (+ trailing space) per distribution
    words = {
        n: [m.encode("ascii") + b" " for m in dists[n][2]]
        for n in dists
    }
    chunk = 1 << 21
    vals = _seed_at(TEXT_SD, np.arange(1, chunk + 1, dtype=np.int64))
    vals_f = vals.astype(np.float64) / float(_M)
    pos = 0
    base = 0  # exponent offset of vals[0]

    def draw():
        nonlocal pos, vals, vals_f, base
        if pos >= len(vals):
            base += len(vals)
            vals = _seed_at(
                TEXT_SD,
                np.arange(base + 1, base + chunk + 1, dtype=np.int64),
            )
            vals_f = vals.astype(np.float64) / float(_M)
            pos = 0
        v = vals_f[pos]
        pos += 1
        return v

    buf = bytearray()
    ap = buf.extend

    def word(name):
        maxw, index, _ = dists[name]
        j = int(draw() * maxw) + 1
        ap(words[name][index[j]])

    def np_phrase():
        j = int(draw() * np_maxw) + 1
        f = int(np_cum[0] < j) + int(np_cum[1] < j) + int(np_cum[2] < j)
        if f == 0:
            word("nouns")
        elif f == 1:
            word("adjectives")
            word("nouns")
        elif f == 2:
            word("adjectives")
            buf[-1] = 0x2C  # ','
            ap(b" ")
            word("adjectives")
            word("nouns")
        else:
            word("adverbs")
            word("adjectives")
            word("nouns")

    def vp_phrase():
        j = int(draw() * vp_maxw) + 1
        f = int(vp_cum[0] < j) + int(vp_cum[1] < j) + int(vp_cum[2] < j)
        if f == 0:
            word("verbs")
        elif f == 1:
            word("auxillaries")
            word("verbs")
        elif f == 2:
            word("verbs")
            word("adverbs")
        else:
            word("auxillaries")
            word("verbs")
            word("adverbs")

    def preposition():
        word("prepositions")
        ap(b"the ")
        np_phrase()

    def terminator():
        maxw, index, _ = dists["terminators"]
        j = int(draw() * maxw) + 1
        del buf[-1]  # terminators abut the previous word (gen_text(--dest))
        ap(words["terminators"][index[j]])

    end = TEXT_POOL_SIZE + 1
    while len(buf) < end:
        j = int(draw() * g_maxw) + 1
        f = (
            int(g_cum[0] < j)
            + int(g_cum[1] < j)
            + int(g_cum[2] < j)
            + int(g_cum[3] < j)
        )
        np_phrase()
        if f == 0:
            vp_phrase()
        elif f == 1:
            vp_phrase()
            preposition()
        elif f == 2:
            vp_phrase()
            np_phrase()
        elif f == 3:
            preposition()
            vp_phrase()
            np_phrase()
        else:
            preposition()
            vp_phrase()
            preposition()
        terminator()
        # gen_sentence's trailing '*dest = ' '' overwrites the terminator's
        # own trailing space — already present in buf
    return bytes(buf[:TEXT_POOL_SIZE])


_TEXT_POOL = None


def text_pool() -> bytes:
    """The shared pseudo-text pool, built once and cached on disk in the
    build directory (``ops/cuda_build.build_dir``)."""
    global _TEXT_POOL
    if _TEXT_POOL is None:
        import os

        from ...ops.cuda_build import build_dir

        cache = os.path.join(build_dir(), "tpch")
        path = os.path.join(cache, "dbgen_text_pool_10m.bin")
        if os.path.exists(path):
            _TEXT_POOL = open(path, "rb").read()
        else:
            _TEXT_POOL = _build_text_pool()
            os.makedirs(cache, exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(_TEXT_POOL)
            os.replace(tmp, path)
    return _TEXT_POOL


def comments(sd, rows: np.ndarray, avg_len: int) -> np.ndarray:
    """dbg_text (text.cpp:437): substring of the pool; offset then length."""
    seed0, stride = sd
    lo, hi = int(avg_len * V_STR_LOW), int(avg_len * V_STR_HGH)
    off = _unif(
        _seed_at(seed0, rows * stride + 1), 0, TEXT_POOL_SIZE - hi
    )
    ln = _unif(_seed_at(seed0, rows * stride + 2), lo, hi)
    pool = text_pool()
    return np.asarray(
        [pool[o : o + l].decode("ascii") for o, l in zip(off, ln)],
        dtype=object,
    )


# ---------------------------------------------------------------------------
# PART / PARTSUPP (build.cpp mk_part:225; PS children inline in the part row,
# streams realigned per PART row: qty/scost stride 4, ps comment stride 8,
# p_name stride 92 = one full color permutation per row, permute.cpp:28).

P_NAME_SD = (709314158, 92)
P_MFG_SD = (1, 1)
P_BRND_SD = (46831694, 1)
P_TYPE_SD = (1841581359, 1)
P_SIZE_SD = (1193163244, 1)
P_CNTR_SD = (727633698, 1)
P_CMNT_SD = (804159733, 2)
PS_QTY_SD = (1671059989, 4)
PS_SCST_SD = (1051288424, 4)
PS_CMNT_SD = (1961692154, 8)
SUPP_PER_PART = 4


def _pick(name: str, sd, rows: np.ndarray) -> np.ndarray:
    """pick_str: one uniform draw over cumulative weights -> member string."""
    maxw, index, members = _dist(name)
    j = _stream(sd, rows, np.int64(1), 1, maxw)
    return np.asarray(members, dtype=object)[index[j]]


def _color_permutations(rows: np.ndarray) -> np.ndarray:
    n = len(rows)
    seed0, stride = P_NAME_SD
    perm = np.tile(np.arange(92, dtype=np.int16), (n, 1))
    ar = np.arange(n)
    base = rows * stride
    for i in range(92):
        src = _unif(_seed_at(seed0, base + i + 1), i, 91).astype(np.int64)
        tmp = perm[ar, src].copy()
        perm[ar, src] = perm[ar, i]
        perm[ar, i] = tmp
    return perm[:, :5]


def gen_part(sf: float, with_text: bool = True) -> Dict[str, np.ndarray]:
    n = int(round(PARTS_PER_SF * sf))
    r = np.arange(n, dtype=np.int64)
    pk = r + 1
    colors = np.asarray(_dist("colors")[2], dtype=object)
    name5 = colors[_color_permutations(r)]
    mfg = _stream(P_MFG_SD, r, np.int64(1), 1, 5)
    brnd = _stream(P_BRND_SD, r, np.int64(1), 1, 5)
    out = {
        "p_partkey": pk,
        "p_name": np.asarray(
            [" ".join(row) for row in name5], dtype=object
        ),
        "p_mfgr": np.asarray(
            [f"Manufacturer#{m}" for m in mfg], dtype=object
        ),
        "p_brand": np.asarray(
            [f"Brand#{m * 10 + b}" for m, b in zip(mfg, brnd)], dtype=object
        ),
        "p_type": _pick("p_types", P_TYPE_SD, r),
        "p_size": _stream(P_SIZE_SD, r, np.int64(1), 1, 50),
        "p_container": _pick("p_cntr", P_CNTR_SD, r),
        "p_retailprice": 90000 + (pk // 10) % 20001 + (pk % 1000) * 100,
    }
    if with_text:
        out["p_comment"] = comments(P_CMNT_SD, r, 14)
    return out


def gen_partsupp(sf: float, with_text: bool = True) -> Dict[str, np.ndarray]:
    n_parts = int(round(PARTS_PER_SF * sf))
    scnt = int(round(SUPPLIERS_PER_SF * sf))
    p = np.repeat(np.arange(n_parts, dtype=np.int64), SUPP_PER_PART)
    s = np.tile(np.arange(SUPP_PER_PART, dtype=np.int64), n_parts)
    pk = p + 1
    out = {
        "ps_partkey": pk,
        "ps_suppkey": (
            pk + s * (scnt // SUPP_PER_PART + (pk - 1) // scnt)
        ) % scnt + 1,
        "ps_availqty": _stream(PS_QTY_SD, p, s + 1, 1, 9999),
        "ps_supplycost": _stream(PS_SCST_SD, p, s + 1, 100, 100000),
    }
    if with_text:
        seed0, stride = PS_CMNT_SD
        lo, hi = int(124 * V_STR_LOW), int(124 * V_STR_HGH)
        off = _unif(
            _seed_at(seed0, p * stride + 2 * s + 1), 0, TEXT_POOL_SIZE - hi
        )
        ln = _unif(_seed_at(seed0, p * stride + 2 * s + 2), lo, hi)
        pool = text_pool()
        out["ps_comment"] = np.asarray(
            [pool[o : o + l].decode("ascii") for o, l in zip(off, ln)],
            dtype=object,
        )
    return out


# ---------------------------------------------------------------------------
# LINEITEM text columns (mk_order per-line picks, build.cpp:175-177):
# shipinstruct/shipmode one pick per line (stride 7), comment two text draws
# per line (stride 14).

L_SHIP_SD = (1371272478, 7)
L_SMODE_SD = (675466456, 7)
L_CMNT_SD = (1095462486, 14)
SHIP_INSTRUCT = ["DELIVER IN PERSON", "COLLECT COD", "TAKE BACK RETURN", "NONE"]
SHIP_MODES = ["REG AIR", "AIR", "RAIL", "TRUCK", "MAIL", "FOB", "SHIP"]


def gen_lineitem_text(sf: float, line_order=None, line_no=None):
    """l_shipinstruct / l_shipmode / l_comment for every line.

    ``line_order``/``line_no`` (0-based order row, 0-based line index) come
    from gen_orders_lineitem's expansion; recomputed if not given."""
    if line_order is None:
        n_orders = int(round(ORDERS_PER_SF * sf))
        o_row = np.arange(n_orders, dtype=np.int64)
        lcnt = _stream(O_LCNT_SD, o_row, np.int64(1), O_LCNT_MIN, O_LCNT_MAX)
        line_order = np.repeat(o_row, lcnt)
        starts = np.concatenate([[0], np.cumsum(lcnt)[:-1]])
        line_no = np.arange(len(line_order), dtype=np.int64) - starts[line_order]
    use = line_no + 1
    out = {
        "l_shipinstruct": np.asarray(SHIP_INSTRUCT, dtype=object)[
            _stream(L_SHIP_SD, line_order, use, 1, 4) - 1
        ],
        "l_shipmode": np.asarray(SHIP_MODES, dtype=object)[
            _stream(L_SMODE_SD, line_order, use, 1, 7) - 1
        ],
    }
    seed0, stride = L_CMNT_SD
    lo, hi = int(27 * V_STR_LOW), int(27 * V_STR_HGH)
    base = line_order * stride + 2 * line_no
    off = _unif(_seed_at(seed0, base + 1), 0, TEXT_POOL_SIZE - hi)
    ln = _unif(_seed_at(seed0, base + 2), lo, hi)
    pool = text_pool()
    out["l_comment"] = np.asarray(
        [pool[o : o + l].decode("ascii") for o, l in zip(off, ln)],
        dtype=object,
    )
    return out


# ---------------------------------------------------------------------------
# NATION / REGION (build.cpp mk_nation:349, mk_region:358).  n_regionkey is
# the nations distribution's CUMULATIVE weight (read_dist accumulates,
# bm_utils.cpp:297).

N_CMNT_SD = (606179079, 2)
R_CMNT_SD = (1500869201, 2)


def gen_nation() -> Dict[str, np.ndarray]:
    cum, members = _DISTS["nations"] if _DISTS else _load_dists()["nations"]
    r = np.arange(len(members), dtype=np.int64)
    return {
        "n_nationkey": r,
        "n_name": np.asarray(members, dtype=object),
        "n_regionkey": np.asarray(cum, dtype=np.int64),
        "n_comment": comments(N_CMNT_SD, r, 72),
    }


def gen_region() -> Dict[str, np.ndarray]:
    members = (_DISTS or _load_dists())["regions"][1]
    r = np.arange(len(members), dtype=np.int64)
    return {
        "r_regionkey": r,
        "r_name": np.asarray(members, dtype=object),
        "r_comment": comments(R_CMNT_SD, r, 72),
    }


# ---------------------------------------------------------------------------
# Engine Table builders: dbgen-exact data in the engine's representation
# (money as unscaled cents, dates as days since 1970, VARCHAR as dictionary
# codes).  Mirrors gen.py's schemas so plans/oracles work unchanged.

_MONEY = {
    "o_totalprice", "c_acctbal", "s_acctbal", "ps_supplycost",
    "p_retailprice", "l_extendedprice",
}


def _string_column(values: np.ndarray):
    """(codes int32, StringTable) via pandas factorize (fast dedup)."""
    import pandas as pd

    from ...vector.string_table import StringTable

    codes, uniques = pd.factorize(values)
    tab = StringTable.from_values([""] + list(uniques))
    return (codes + 1).astype(np.int32), tab


_LINEITEM_TEXT = ("l_shipinstruct", "l_shipmode", "l_comment")
_ORDERS_TEXT = ("o_orderpriority", "o_clerk", "o_comment")


def table(name: str, sf: float = 1.0, columns=None, raw_orders_lineitem=None):
    """A dbgen-bit-exact Table for any TPC-H table.

    Only the text columns asked for are generated (``columns`` None = all),
    and ``raw_orders_lineitem`` (``gen_orders_lineitem(sf)``) lets ``orders``
    and ``lineitem`` share one generation of their numeric columns."""
    from ...dtypes import RowType
    from ...io.table import Table
    from .gen import SCHEMAS

    def wants(names):
        return columns is None or any(c in columns for c in names)

    if name in ("lineitem", "orders"):
        both = raw_orders_lineitem or gen_orders_lineitem(sf)
        raw = dict(both[name])
    if name == "lineitem":
        if wants(_LINEITEM_TEXT):
            raw.update(gen_lineitem_text(sf))
        raw["l_quantity"] = raw["l_quantity"] * 100  # DECIMAL(12,2) cents
        raw["l_returnflag"] = np.asarray(
            [chr(c) for c in raw["l_returnflag"]], dtype=object
        )
        raw["l_linestatus"] = np.asarray(
            [chr(c) for c in raw["l_linestatus"]], dtype=object
        )
    elif name == "orders":
        if wants(_ORDERS_TEXT):
            raw.update(gen_orders_text(sf, with_text=wants(("o_comment",))))
        raw["o_orderstatus"] = np.asarray(
            [chr(c) for c in raw["o_orderstatus"]], dtype=object
        )
        raw["o_shippriority"] = np.zeros(
            len(raw["o_orderkey"]), dtype=np.int64
        )
    elif name == "customer":
        raw = gen_customer(sf)
    elif name == "supplier":
        raw = gen_supplier(sf)
    elif name == "part":
        raw = gen_part(sf)
    elif name == "partsupp":
        raw = gen_partsupp(sf)
    elif name == "nation":
        raw = gen_nation()
    elif name == "region":
        raw = gen_region()
    else:
        raise KeyError(name)

    schema_full = SCHEMAS[name]
    want = list(columns or [c for c in schema_full.names if c in raw])
    cols, tables = {}, {}
    for c in want:
        arr = raw[c]
        if arr.dtype == object:
            cols[c], tables[c] = _string_column(arr)
        else:
            cols[c] = arr
    schema = RowType(want, [schema_full.type_of(c) for c in want])
    return Table(schema, cols, tables)
