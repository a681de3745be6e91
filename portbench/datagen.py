"""TPC-H columns made on a device from a seed, in plain torch.

A frozen rewrite of the generation rules of the port's
``connectors/tpch/gen.py`` (TPC-H v3 §4.2.3), kept here so that the data the
benchmark hands the program and its reference cannot change with the program.
Each column is a module of its own, found by name:
``portbench/columns/<table>/<column>.py`` holds its SQL type (``TYPE``), the
categories of a string column (``CATEGORIES``, else None) and
``make(g) -> tensor``.  A draw that several columns share is a module
``portbench/draws/<name>.py`` with ``make(g)``, which ``g.shared(name)`` makes
once a set of columns.  A new table or column is therefore new files only.

Every draw has its own random stream, keyed by the seed, its table and its
name, so a column does not depend on which others a cell asks for.  Columns
come back in the engine's host representation: decimals as unscaled int64
(scale 2), dates as int32 days since 1970-01-01, strings as int32 codes into
``[""] + CATEGORIES`` (code 0 is the empty string).

A rank of a multi-rank cell may take only its chunk of a table: the rows that
``dbgen -C ranks -S rank+1`` writes (TPC-H v3 §4.1.3; dbgen's ``partial()``:
``N // ranks`` contiguous rows a chunk, the last one also the remainder), and
of ``lineitem`` the lines of its chunk of orders.  The whole column is made
from the seed as ever and cut on the device, so chunks are disjoint, their
union is the whole table, and only the rank's share reaches host memory.

This module imports torch only: the reference reads the same columns.
"""

from __future__ import annotations

import datetime
import hashlib
import importlib
import os
import pkgutil
from typing import Dict, Iterable, List, Optional, Tuple

import torch

_EPOCH = datetime.date(1970, 1, 1)
_HERE = os.path.dirname(os.path.abspath(__file__))


def days(iso: str) -> int:
    """Days since 1970-01-01 of an ISO date."""
    return (datetime.date.fromisoformat(iso) - _EPOCH).days


STARTDATE = days("1992-01-01")
CURRENTDATE = days("1995-06-17")
ENDDATE = days("1998-12-31")

SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
SHIPMODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]
RETURNFLAGS = ["R", "A", "N"]
LINESTATUSES = ["F", "O"]

DEC = "DECIMAL(12,2)"


def _column_module(table: str, name: str):
    module = f"portbench.columns.{table}.{name}"
    try:
        return importlib.import_module(module)
    except ModuleNotFoundError as e:
        if e.name is None or not module.startswith(e.name):
            raise
        raise KeyError(f"no generator for {table}.{name}") from e


def column_type(table: str, name: str) -> Tuple[str, Optional[List[str]]]:
    """(SQL type, categories of a string column or None) of one column."""
    mod = _column_module(table, name)
    return mod.TYPE, mod.CATEGORIES


def table_columns(table: str) -> List[str]:
    """Every column of ``table`` that has a generator."""
    path = os.path.join(_HERE, "columns", table)
    return sorted(m.name for m in pkgutil.iter_modules([path]))


def stream(seed: int, table: str, name: str, device) -> torch.Generator:
    """The random stream of one (table, name) for ``seed``."""
    digest = hashlib.sha256(f"{int(seed)}/{table}/{name}".encode()).digest()
    gen = torch.Generator(device=device)
    gen.manual_seed(int.from_bytes(digest[:8], "little") >> 1)
    return gen


def sparse_orderkey(index: torch.Tensor) -> torch.Tensor:
    """TPC-H order keys: 8 used of every 32."""
    return (index // 8) * 32 + (index % 8) + 1


def chunk_bounds(n: int, rank: int, ranks: int) -> Tuple[int, int]:
    """Rows [lo, hi) of ``n`` in dbgen's chunk ``rank + 1`` of ``ranks``."""
    size = n // ranks
    lo = rank * size
    return lo, (n if rank == ranks - 1 else lo + size)


def retail_price_cents(partkey: torch.Tensor) -> torch.Tensor:
    """p_retailprice = (90000 + ((pk / 10) mod 20001) + 100 (pk mod 1000)) / 100."""
    return 90000 + (partkey // 10) % 20001 + 100 * (partkey % 1000)


class TpchColumns:
    """The columns of one scale factor and seed on ``device``: what the
    column and draw modules read (``draw``, ``shared``, the table sizes)."""

    def __init__(self, sf: float, seed: int, device):
        self.sf = sf
        self.seed = int(seed)
        self.device = torch.device(device)
        self.n_orders = int(1_500_000 * sf)
        self.n_customers = int(150_000 * sf)
        self.n_parts = int(200_000 * sf)
        self.n_suppliers = int(10_000 * sf)
        self._memo: Dict[str, torch.Tensor] = {}

    def draw(self, table: str, name: str, lo: int, hi: int, n: int) -> torch.Tensor:
        """n int64 values uniform in [lo, hi], from the stream of (table, name)."""
        gen = stream(self.seed, table, name, self.device)
        return torch.randint(lo, hi + 1, (n,), generator=gen, device=self.device, dtype=torch.int64)

    def shared(self, key: str) -> torch.Tensor:
        """The shared draw ``portbench/draws/<key>.py``, made once until
        ``columns`` returns."""
        if key not in self._memo:
            self._memo[key] = importlib.import_module(f"portbench.draws.{key}").make(self)
        return self._memo[key]

    def lines_total(self) -> int:
        """Rows of lineitem: the sum of the lines of every order."""
        return int(self.shared("n_lines").item())

    def chunk(self, table: str, rank: int, ranks: int) -> Tuple[int, int]:
        """Rows [lo, hi) of ``table`` in dbgen's chunk ``rank + 1`` of ``ranks``."""
        if table == "lineitem":  # the lines of the chunk's orders
            lo, hi = self.chunk("orders", rank, ranks)
            ends = torch.cumsum(self.shared("lines"), 0)
            return (int(ends[lo - 1]) if lo else 0), (int(ends[hi - 1]) if hi else 0)
        rows = {"orders": self.n_orders, "orders_text": self.n_orders,
                "customer": self.n_customers, "part": self.n_parts,
                "supplier": self.n_suppliers}
        return chunk_bounds(rows[table], rank, ranks)

    def column(self, table: str, name: str) -> torch.Tensor:
        """One column in the host representation's dtype, on the device."""
        return _column_module(table, name).make(self)

    def columns(self, wanted: Dict[str, Iterable[str]],
                chunk: Optional[Tuple[int, int, Iterable[str]]] = None
                ) -> Dict[str, Dict[str, torch.Tensor]]:
        """{table: {column: device tensor}} for every column named; with
        ``chunk`` (rank, ranks, tables), each of those tables cut to the
        rank's chunk."""
        out = {table: {name: self.column(table, name) for name in dict.fromkeys(names)}
               for table, names in wanted.items()}
        if chunk is not None:
            rank, ranks, tables = chunk
            for table in set(tables) & set(out):
                lo, hi = self.chunk(table, rank, ranks)
                out[table] = {name: v[lo:hi].clone() for name, v in out[table].items()}
        self._memo.clear()
        return out


def generate_host(sf: float, seed: int, wanted: Dict[str, Iterable[str]], device,
                  chunk: Optional[Tuple[int, int, Iterable[str]]] = None):
    """Make the columns on ``device`` and copy each to host numpy once;
    returns {table: {column: numpy array}} and frees the device copies.
    With ``chunk`` (rank, ranks, tables), only the rank's chunk of each of
    those tables is copied."""
    made = TpchColumns(sf, seed, device).columns(wanted, chunk)
    host = {t: {c: v.cpu().numpy() for c, v in cols.items()} for t, cols in made.items()}
    del made
    return host
