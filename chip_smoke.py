#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (velox_tpu_torch).

    python3 chip_smoke.py [--sf 10] [--tile-rows 16777216] [--runs 5] [--ptxas]

Needs one CUDA device and nvcc; exits non-zero without them.  The TPC-H
generator seeds every column from its table, name and scale factor, so the
data is the same in every run.  The script

1. prints the device (``torch.cuda`` name, ``nvidia-smi`` name and power limit);
2. builds the CUDA kernels from ``velox_tpu_torch/csrc`` (seconds printed);
3. holds each kernel against its plain PyTorch version at the shapes the
   queries give it (one tile of SF-``sf`` ``lineitem``), by exact equality
   (the sums are integer; addition wraps and is associative), and times
   kernel, plain version and, where one PyTorch call computes the same, that
   call, with CUDA events (median of ``--runs`` after a warm-up, the launches
   queued behind a short device-side sleep so that no host time is counted);
   then runs the edge cases of the two grouped sums (ragged lengths, unaligned
   slices, all rows dead, 1 and 64 groups, the table limit, every number of
   table copies) against the plain versions, and times both kernels on one
   tile with 1, 4, 12 and 64 live groups;
4. sets every kernel's launch count to 0 and drives the main path once:
   TPC-H Q6 and Q1 at SF ``sf`` through ``LocalExecutor`` over device-resident
   tiles, row-exact against the numpy oracle, and ``selective_sum`` (which
   the executor does not call) and ``grouped_int64_sums`` (which Q1 and Q6
   do not reach: the executor sends direct-mode int64 sums to it only off
   the piece path) through their own entry points over the same tiles,
   checked against the same answers; then Q12 at SF ``sf`` the same way,
   whose join takes the hashed probe (``hash_probe``, K5, one launch a tile)
   and whose array-mode aggregation after it sends each int64 accumulator
   to ``grouped_int64_sums`` (7 launches a tile), each call of either held
   bit for bit against its plain version; then reads the counts and fails
   if any kernel was not launched, and times K3 at Q12's shape (one column
   of the probe batch, 7 groups, nearly every row dead) and K5 at Q12's
   shape (its longest walk through the table too) for the kernels line;
5. times Q6 and Q1 (median of ``--runs``), with the device-busy share from
   ``torch.profiler``;
6. times the primitives the sort-mode paths are made of (``torch.sort``,
   ``index_select`` through its permutation, ``cumsum``, ``cummax`` of 2^24
   int64), each beside its byte bound;
   ``ops/segmented.py last_flagged``, which computes on the sort-mode paths
   what the JAX package computes with ``cummax`` / ``cummin``, is timed
   beside ``cummax`` on the same input;
7. runs TPC-H Q3 and Q13 at SF ``sf`` through
   ``LocalExecutor``: joins with a unique build side, sort-mode grouping with
   the device-resident carry, the device TopN; row-exact against the numpy
   oracle, then timed like Q6 and Q1.  ``engine_ms`` is one run of the probe
   pipeline over device-resident tiles; the build sides run when the executor
   is constructed and their time is printed as ``build_s``.  Q13 runs once
   more with tiles of 2^22 rows, for its rows only, so that its build side's
   carry merge is held against the oracle too.  These paths launch none of
   the three ported kernels (the JAX package has no Pallas kernel on them);
   a join whose grouping reads no key order takes the hashed probe, one
   launch of K5 a tile (``k5_launches``: Q13's, and none in Q3 at SF 10,
   whose grouping over several tiles is presorted);
   Q13's NOT LIKE over ``o_comment`` is one launch of K4
   (``ops/dict_like.py``) for its plan, in its build side (asserted), and
   the ``q13`` line and the kernels line time K4 over that dictionary,
   resident on the card (``dict_like_record``);
8. runs the other eighteen TPC-H plans (``tpch_plans``: one line each; Q21's
   at SF 1 in tiles of 2^20 rows when ``--sf`` is larger, ``PLANS_AT_SF1``,
   where its carries overflow into the host merge as at SF 10) and
   all 22 SQL texts through the SQL front end (``tpch_sql``: one line each;
   expansion joins, scalar subqueries, filtered LEFT and semi / anti joins,
   distinct counts; the texts of ``SQL_AT_SF1`` at SF 1 when ``--sf`` is
   larger), each row-exact against the oracle, with the build time,
   every expansion's output bucket and the device's peak memory, and timed:
   ``query_ms`` is the whole query from host tables (executor construction,
   which runs every build side and barrier, and the run; what ``run_sql``
   costs), for a plan the warm run after the checked one
   (``whole_query_timing``: the first run alone past ``LONG_QUERY_S``, and
   for every line once the script is ``TIMING_UNTIL_S`` old), for a text the
   checked run; a plan's line also has ``engine_ms`` of its last pipeline
   over device-resident tiles, median of ``--runs``, with its device time
   from ``torch.profiler``, as for Q3.  The tables are
   generated once, with every column any query reads.  A plan whose
   aggregation takes the piece path launches ``grouped_piece_sums`` as Q1
   does (``k2_launches``);
9. runs the window and set-operation slice (``tpch_window``: one line each)
   over the same tables: the SQL texts of ``WINDOW_SQL`` (W1 and W2, TPC-H
   Q2 and Q15 with their subqueries written as windows, held against those
   queries' oracles; W3, a window over every ``orders`` row by customer; W4,
   one over every ``lineitem`` row by order, cut into passes of whole
   partitions; F1 and F2, FULL joins plain and with a non-equi condition;
   U1, UNION ALL; N1, a join with no equality) and the two ``window_plan``
   plans (a MergeExchange of two sorted ``orders`` branches, and
   ``topn_row_number``; W3, W4, F2 and the two plans at SF 1 when ``--sf``
   is larger, ``WINDOW_AT_SF1``), each row-exact against its numpy oracle, with the
   window passes, the device's peak memory and ``query_ms`` (the checked
   run of the whole query from host tables); none of them launches K2 or
   ``selective_sum``, and a direct-mode int64 sum launches K3
   (``k3_launches``);
10. runs the function slice (``tpch_functions``: one line each) over the
   same tables: the SQL texts of ``FUNCTION_SQL`` (A1, every new aggregate
   in direct mode over ``lineitem``; A2, five of them in sort mode over its
   orders through the device carry merge; S1 and S2, the date, math,
   probability, conditional and dictionary string functions; D1, long-decimal
   sums past 2^63, avg and a long-decimal division; T1, time zones; W5, a
   window over every
   ``orders`` row with NULL partition and order keys, then again at SF 1 in
   passes of whole partitions of 2^18 rows, for its rows only; A2 again at
   SF 1 in tiles of 2^20 rows, for its rows only, its carry overflowing
   into the host merge; A1, S1 and A2 at SF 1 in tiles of 2^21 rows, and W5
   at SF 1 in one tile, when ``--sf`` is larger, ``FUNCTION_AT_SF1``), each
   row-exact against its numpy oracle (``function_oracle``) and timed like
   the window slice; none of them launches K2 or ``selective_sum``, and the
   direct-mode int64 sums of A1 and D1 launch K3 (``k3_launches``);
11. runs the complex-type slice (``tpch_complex``: one line each) over the
   same tables: the SQL texts of ``COMPLEX_SQL`` and the plans of
   ``complex_plan`` (C1, four collect aggregates over every ``orders`` row;
   C2, array constructors with lambdas over every ``lineitem`` row; C3,
   ROLLUP through GroupId; C4, a VARCHAR cast as grouping key; C5,
   ``array_join`` over a collect; C6, arrays of about 8.5 M elements back on
   the card; C7, ``split`` + Unnest; C8, a collect feeding an Unnest; C1, C5
   and C7 at SF 1 when ``--sf`` is larger, ``COMPLEX_AT_SF1``), each against
   its numpy oracle (``check_complex``), with its largest element pool, its
   render time and the path it is there for (asserted); none of them
   launches K2 or ``selective_sum`` (``k3_launches`` counts K3's);
12. runs the sketch / Spark slice (``spark_sketch``: one line each) over the
   same tables: ``SPARK_SQL`` and ``spark_plan`` (H1 and H2, approx_distinct
   through the HLL rewrite, grouped and over a DOUBLE's bits; P1, a median by
   the KLL rewrite over the window barrier; P2, a 0.9 quantile by DDSketch;
   B1, a Spark bloom filter of the orders of 1992 probed over every
   ``lineitem`` row through a 1 MB ``X'...'`` literal; X1, Spark hashes,
   dates, shifts and ``rand(42)``; X2, Spark string functions; X3,
   ``first`` / ``last`` / ``collect_list`` / ``collect_set``; at SF 1 when
   ``--sf`` is larger, ``SPARK_AT_SF1``), each against
   its numpy oracle (``check_spark``: the HLL estimate bit for bit, KLL's
   rank error, DDSketch's value error, the filter's bytes, the hashes from
   the Spark specification) with the path it is there for asserted, and
   timed like the window slice;
13. generates SF-1 TPC-H with the port's dbgen (TPC's generator bit for
   bit) and holds Q1, Q6 and Q3 to the TPC-H specification's published
   answers to the cent and Q13 to its pinned rows (``dbgen_golden``; Q1
   takes the piece path and launches ``grouped_piece_sums``);
14. runs the files / host-formats slice (``files_io``: one line each, I1-I7)
   at SF ``sf`` on the tables the script generated: I1 writes ``lineitem``'s
   Q1 columns as a Hive dataset partitioned by ship year through a plan's
   TableWrite, and times the partition split alone; I2 reads it back through ``HiveDataSource`` and the data cache
   (cold, then warm) and runs Q1 over it (the piece path: one
   ``grouped_piece_sums`` launch a tile, the counts set to 0 just before the
   run and read just after); I3 runs Q6 over the 1994 partition alone; I4
   writes ``orders`` sorted by date as one parquet file and loads 1995 with
   row-group pruning; I5 runs Q6 over an Arrow stream and sends Q1's result
   through the Arrow PyCapsule protocol; I6 fetches ``orders`` from the
   card and sends its first ``SERDE_PAGE_ROWS`` rows through the page serde, its head through UnsafeRow / CompactRow and one device tile through
   the vector saver; I7 evaluates the fuzzer's expressions over 2^24-row
   SEQUENCE / BIAS columns on the device beside their flat copies, and holds
   each decode to ``repeat_interleave`` / ``bias + deltas``.  Each is
   held against the generated tables or a numpy oracle; the datasets are
   written under ``build/files_io`` and removed at the end;
15. runs the memory / spill slice (``memory_spill``: one line each, M1-M5)
   at SF ``sf``: M1, Q18's subquery aggregation (sum(l_quantity) by
   l_orderkey) under a budget that admits the scan tiles and refuses the
   carry, so the host merge runs and spills its partials; M2, ORDER BY over
   ``orders`` in runs of 2^22 rows under a threshold below the resident runs
   (an external sort merged on the host); M3, Q3 with a budget below its
   orders build (the Grace join; each partition's rows held to the host's
   split by ``splitmix64_np``); M4, a window over ``orders`` by customer in
   passes of 2^22 rows, each spilled; M5, ``GroupedExecution`` of Q1 over
   I1's dataset (7 ship-year groups, 2 at once, checkpoints: all run, all
   restored, 3 run again).  Budgets and thresholds are computed from the
   reservations of the same query run without one, which each line is held
   to beside the numpy oracle; each path is asserted by its injection
   point's hits (``utils/testvalue.py``), and each line prints the pool's
   peak beside ``torch.cuda.max_memory_allocated()``.  No earlier line
   spills (asserted where a line prints its carry);
16. runs Substrait and observability (``substrait_obs``): S1 sends Q1, Q6
   and Q3 through ``to_substrait`` -> JSON -> ``from_substrait`` and runs
   them (rows equal to the direct plan's; Q1 launches K2 once a tile), and
   counts the TPC-H plans that convert; O1 runs ``collect_operator_stats``
   and ``print_plan`` over Q6 (each operator's rows against numpy) and
   writes a ``torch.profiler`` trace through ``trace.device_profile``, with
   the card's kernels and the executor's ``velox.`` spans;
17. runs the distributed slice (``distributed``: one line each) through
   ``parallel.runner.DistributedExecutor`` over 4 gloo ranks that share the
   card (``testing/world.py``; the tables written once as files the ranks
   map): D-Q6 and D-Q1 (direct_agg), D-Q3 (the shuffle join of its orders
   build, then the group exchange) and D-Q13 (a shuffle join into grouping)
   at SF ``sf``, each row-exact against the numpy oracle; DX-skew, Q3 with
   a probe bucket of ``DIST_SKEW_BUCKET_ROWS`` rows, which overflows and
   re-probes (asserted); then, the SF ``sf`` tables released, the 22 plans
   at SF 1 against the port's ``LocalExecutor`` rows; DX-nccl, Q3 at SF 1
   on NCCL at world size 1.
   Each line holds the world, the backend, whether the collectives staged
   through host buffers, the collectives' calls and bytes, the shuffle
   buckets, the carry slots, the retries, ``query_s`` (the whole query on
   rank 0) and every rank's peak device memory;
18. prints a ``summary`` line (every query's time in one place), the
   ``{"kernels": [...]}`` line and, last, ``{"ok": true, "device": {...}}``.

Every phase prints one JSON line (``at_s``: seconds since the start); any
failure ends the run with a traceback and a non-zero exit code, and so
does a run still going after ``WATCHDOG_S`` (every thread's stack is
printed to stderr first).
``bound_ms`` is bytes moved (each input read once,
each output written once; of selective_sum's value column only the 32-byte
sectors that hold a passing row, since the others are never asked for) over
the published device-memory rate of the H100 SXM, 3.35 TB/s, or integer
operations over 67 Tops/s (the published non-tensor-core float32 rate, taken
as the integer ALU rate), whichever is larger.  ``kernel_study.py`` beside this
script holds the longer measurements (design variants, cost split, SASS).
"""

from __future__ import annotations

import argparse
import faulthandler
import gc
import json
import statistics
import subprocess
import sys
import time

PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
DEVICE = "cuda"  # where the script itself allocates; the port's entry points default to it
# whole-query runs from host tables a hand-built plan's line makes: the
# checked first run, then WHOLE_RUNS - 1 warm ones, whose median is
# ``query_ms`` (``whole_query_timing``).  Every other whole-query line keeps
# its checked first run only: with a warm and a profiled run each, the script
# took 865 s and 938 s on an H100 host and passed its 1 200 s on another
WHOLE_RUNS = 2
# a query whose first whole run takes longer is timed by that run alone (no
# warm run): TPC-H Q21's plan at SF 10 took 47 s with an H100 (its build
# side's host merge of about 60 M partial groups)
LONG_QUERY_S = 10.0
# past this many seconds since the script began, a plan's line too keeps its
# checked first run only (``timing`` says so), so that a slow host does not
# push the script past its 1 200 s: every check and every path still runs
TIMING_UNTIL_S = 300.0
# seconds after which the script prints every thread's stack to stderr and
# exits non-zero (``faulthandler``): a run that hangs or crawls says where it
# was before its caller's limit of 1 200 s stops it
WATCHDOG_S = 1140.0
# SQL texts whose planner keeps FROM order, so that a join's build side
# repeats its keys and is sorted on the host (an expansion join over up to
# 60 M lineitem rows).  Their hand-built plans run at ``--sf``; the texts run
# at SF 1 when ``--sf`` is larger, to keep the script inside its time.
SQL_AT_SF1 = (3, 5, 7, 8, 10, 13, 18, 21)
# plans that run at SF 1 when ``--sf`` is larger, with their tile rows there:
# TPC-H Q21's plan took 51 s a run at SF 10 with an H100, nearly all of it a
# host merge of about 60 M partial groups, and the function slice needs the
# script's time.  At SF 1 in tiles of 2^20 rows its barriers' carries (at
# most a tile's rows) still overflow into that host merge (asserted)
PLANS_AT_SF1 = {21: 1 << 20}
# window-slice texts that run at SF 1 when ``--sf`` is larger, with their
# tile rows there: W4 over every SF-10 ``lineitem`` row took 20 s a run with
# an H100 (about 2 minutes with its oracle and profiled run); at SF 1, 6 M
# rows in tiles of 2^21 are still cut into window passes of whole partitions.
# W3 (12 s a run at SF 10, 100 s with its oracle and profiled run) and F2
# (10 s a run, 46 s in all) follow, so that the function slice fits the
# script's time; F1 (19 s in all) stays at SF 10.  The two plans over every
# ``orders`` row (MergeExchange, ``topn_row_number``) took 11 s each at SF 10,
# 6 s of it their oracles, in a script that passed its 1 200 s on another
# host: they run at SF 1, in one tile as at SF 10
WINDOW_AT_SF1 = {"W4": 1 << 21, "W3": 1 << 24, "F2": 1 << 24,
                 "merge_exchange": 1 << 24, "topn_row_number": 1 << 24}


# ---------------------------------------------------------------------------
# The window / set-operation slice: SQL texts over the TPC-H tables and the
# numpy oracles they are held against (W1 and W2 against the oracles of Q2 and
# Q15, whose subqueries they write as windows).  The tests run the same texts
# through both packages' ``run_sql`` at SF 0.01.

WINDOW_SQL = {
    # Q2 with its correlated min(ps_supplycost) subquery as a window
    "W1": """
select s_acctbal, s_name, n_name, p_partkey, p_mfgr, s_address, s_phone, s_comment
from (select s_acctbal, s_name, n_name, p_partkey, p_mfgr, s_address, s_phone,
             s_comment, ps_supplycost,
             min(ps_supplycost) over (partition by p_partkey) as min_cost
      from partsupp, part, supplier, nation, region
      where p_partkey = ps_partkey and s_suppkey = ps_suppkey
        and p_size = 15 and p_type like '%BRASS'
        and s_nationkey = n_nationkey and n_regionkey = r_regionkey
        and r_name = 'EUROPE') w
where ps_supplycost = min_cost
order by s_acctbal desc, n_name, s_name, p_partkey
limit 100
""",
    # Q15 with its max(total_revenue) subquery as a global window
    "W2": """
select s_suppkey, s_name, s_address, s_phone, total_revenue
from (select s_suppkey, s_name, s_address, s_phone, total_revenue,
             max(total_revenue) over () as max_revenue
      from supplier,
           (select l_suppkey as supplier_no,
                   sum(l_extendedprice * (1 - l_discount)) as total_revenue
            from lineitem
            where l_shipdate >= date '1996-01-01'
              and l_shipdate < date '1996-04-01'
            group by l_suppkey) revenue0
      where s_suppkey = supplier_no) w
where total_revenue = max_revenue
order by s_suppkey
""",
    # every orders row, about one partition per customer
    "W3": """
select o_orderkey, o_custkey, o_orderdate, o_totalprice,
  row_number() over (partition by o_custkey order by o_orderdate, o_orderkey) as rn,
  rank() over (partition by o_custkey order by o_totalprice desc) as rk,
  lag(o_totalprice) over (partition by o_custkey order by o_orderdate, o_orderkey) as prev_price,
  sum(o_totalprice) over (partition by o_custkey order by o_orderdate, o_orderkey
                          rows between 2 preceding and current row) as sum3,
  max(o_totalprice) over (partition by o_custkey order by o_orderdate, o_orderkey
                          rows between 3 preceding and current row) as max4,
  min(o_totalprice) over (partition by o_custkey order by o_orderdate) as run_min,
  count(o_orderkey) over (partition by o_custkey order by o_orderdate
                          range between 30 preceding and current row) as cnt30
from orders
""",
    # every lineitem row, one partition per order: chunks of whole partitions
    "W4": """
select l_orderkey, l_linenumber, l_extendedprice, l_quantity, l_shipdate,
  row_number() over (partition by l_orderkey order by l_extendedprice desc, l_linenumber) as rn,
  sum(l_quantity) over (partition by l_orderkey order by l_extendedprice desc, l_linenumber
                        rows between 1 preceding and current row) as qty2,
  lag(l_shipdate) over (partition by l_orderkey order by l_extendedprice desc, l_linenumber)
    as prev_ship
from lineitem
""",
    # FULL OUTER JOIN, unmatched rows on both sides
    "F1": """
select count(c_custkey) as customers, count(o_orderkey) as orders_n, count(*) as pairs,
       sum(o_totalprice) as total
from (select c_custkey, c_acctbal from customer where c_mktsegment = 'BUILDING') c
full outer join
     (select o_orderkey, o_custkey, o_totalprice from orders
      where o_orderdate < date '1995-03-15') o
  on c_custkey = o_custkey
""",
    # F1 with a non-equi condition in ON: rewrite_full_filter
    "F2": """
select count(c_custkey) as customers, count(o_orderkey) as orders_n, count(*) as pairs,
       sum(o_totalprice) as total
from (select c_custkey, c_acctbal from customer where c_mktsegment = 'BUILDING') c
full outer join
     (select o_orderkey, o_custkey, o_totalprice from orders
      where o_orderdate < date '1995-03-15') o
  on c_custkey = o_custkey and o_totalprice > c_acctbal * 10
""",
    "U1": """
select nationkey, count(*) as n, sum(acctbal) as total
from (select c_nationkey as nationkey, c_acctbal as acctbal from customer
      union all
      select s_nationkey as nationkey, s_acctbal as acctbal from supplier) u
group by nationkey
order by nationkey
""",
    # a join with no equality: the nested-loop lowering
    "N1": """
select count(*) as pairs, sum(s_acctbal) as total
from supplier join nation on s_nationkey < n_nationkey
""",
}

# the TPC-H tables and columns each text reads (W1 and W2 read Q2's and Q15's)
WINDOW_COLUMNS = {
    "W3": {"orders": ("o_orderkey", "o_custkey", "o_orderdate", "o_totalprice")},
    "W4": {"lineitem": ("l_orderkey", "l_linenumber", "l_extendedprice", "l_quantity",
                        "l_shipdate")},
    "F1": {"customer": ("c_custkey", "c_mktsegment", "c_acctbal"),
           "orders": ("o_orderkey", "o_custkey", "o_orderdate", "o_totalprice")},
    "U1": {"customer": ("c_nationkey", "c_acctbal"), "supplier": ("s_nationkey", "s_acctbal")},
    "N1": {"supplier": ("s_nationkey", "s_acctbal"), "nation": ("n_nationkey",)},
}
WINDOW_COLUMNS["F2"] = WINDOW_COLUMNS["F1"]
WINDOW_QUERY = {"W1": 2, "W2": 15}  # the TPC-H query whose tables and oracle a text takes


# ---------------------------------------------------------------------------
# The function slice: the Presto scalar functions, the statistical / pair /
# bitwise aggregates, long decimals and NULL window keys, each text over the
# TPC-H tables and held against its numpy oracle (``function_oracle``).  The
# tests run the same texts through both packages at SF 0.01 (W5 is held to
# its oracle only: the JAX package orders and partitions by the raw values
# under NULL keys).

FUNCTION_SQL = {
    # every new aggregate in direct mode: six groups of SF-10 lineitem
    "A1": """
select l_returnflag, l_linestatus,
  count_if(l_discount > 0.05) as discounted,
  bool_and(l_quantity < 50) as all_below_50,
  bool_or(l_tax = 0.08) as any_top_tax,
  min_by(l_orderkey, l_extendedprice) as cheapest_order,
  max_by(l_orderkey, l_extendedprice) as dearest_order,
  stddev_samp(l_extendedprice) as sd_price,
  var_pop(l_quantity) as var_qty,
  skewness(l_extendedprice) as skew_price,
  kurtosis(l_extendedprice) as kurt_price,
  covar_samp(l_quantity, l_extendedprice) as cov_qty_price,
  corr(l_quantity, l_extendedprice) as corr_qty_price,
  geometric_mean(l_extendedprice) as gm_price,
  bitwise_or_agg(l_suppkey) as or_supp,
  bitwise_and_agg(l_partkey * 8 + 5) as and_part,
  checksum(l_orderkey) as ck
from lineitem
group by l_returnflag, l_linestatus
order by l_returnflag, l_linestatus
""",
    # sort mode: 15 M groups (orders) merged in the device carry
    "A2": """
select l_orderkey,
  min_by(l_linenumber, l_extendedprice) as cheapest_line,
  max_by(l_partkey, l_quantity) as biggest_part,
  var_samp(l_extendedprice) as var_price,
  corr(l_quantity, l_extendedprice) as corr_qty_price,
  bool_or(l_returnflag = 'R') as any_returned
from lineitem
group by l_orderkey
""",
    # date parts and arithmetic, rounding, greatest / least, nullif, the
    # math and probability families, inside sums and maxima by month
    "S1": """
select date_trunc('month', l_shipdate) as ship_month,
  count(*) as n,
  sum(date_diff('day', l_shipdate, l_receiptdate)) as transit_days,
  max(date_add('day', 30, l_commitdate)) as last_due,
  sum(quarter(l_shipdate) + week(l_shipdate) + day_of_week(l_receiptdate)) as calendar,
  sum(round(l_extendedprice * (1 - l_discount))) as rounded_revenue,
  max(greatest(l_quantity, l_tax * 100, l_discount * 100)) as greatest_pct,
  sum(least(l_extendedprice, l_quantity * 1000)) as capped_price,
  count(nullif(l_linenumber, 1)) as later_lines,
  sum(ln(cast(l_extendedprice as double))) as log_price,
  max(power(cast(l_quantity as double), 1.5e0)) as qty_pow,
  sum(width_bucket(l_discount, 0.00, 0.10, 5)) as disc_buckets,
  sum(normal_cdf(0.0e0, 1.0e0, cast(l_tax as double) * 10)) as tax_cdf
from lineitem
group by date_trunc('month', l_shipdate)
order by ship_month
""",
    # dictionary string functions and digests, grouped on their results; the
    # join keys pick one part and one customer per supplier
    "S2": """
select split_part(p_type, ' ', 3) as material,
  word_stem(lower(split_part(p_type, ' ', 2))) as finish,
  regexp_extract(c_phone, '^([0-9]+)-', 1) as country,
  count(*) as n,
  max(lpad(p_brand, 10, '*')) as brand_pad,
  min(rpad(p_mfgr, 16, '.')) as mfgr_pad,
  max(regexp_replace(p_container, '^[A-Z]+ ', '')) as container_kind,
  min(replace(p_container, ' ', '_')) as container_code,
  sum(levenshtein_distance(c_mktsegment, 'BUILDING')) as seg_distance,
  sum(hamming_distance(p_brand, 'Brand#13')) as brand_distance,
  min(md5(s_name)) as min_md5,
  max(sha256(s_name)) as max_sha256
from part, supplier, customer
where p_partkey = s_suppkey and s_suppkey = c_custkey
group by split_part(p_type, ' ', 3), word_stem(lower(split_part(p_type, ' ', 2))),
  regexp_extract(c_phone, '^([0-9]+)-', 1)
order by material, finish, country
""",
    # DECIMAL(38, 6) products: sums past 2^63, avg and one long-decimal
    # division (no ORDER BY: a long decimal cannot flow through one, as in
    # the JAX package)
    "D1": """
select l_returnflag,
  sum(cast(l_extendedprice as decimal(38, 2)) * l_extendedprice * l_quantity) as big_sum,
  avg(cast(l_extendedprice as decimal(38, 2)) * l_extendedprice * l_quantity) as big_avg,
  sum(cast(l_extendedprice as decimal(38, 2)) * l_extendedprice * l_quantity) / count(*) as big_mean
from lineitem
group by l_returnflag
""",
    # time zones over every order date as a UTC midnight: a DST zone, a
    # half-hour one, a round trip through Berlin wall time and a zone with a
    # half-hour DST shift (the zone files of the system, zoneinfo.TZPATH)
    "T1": """
select timezone_hour(ts, 'America/New_York') as ny_offset,
  timezone_minute(ts, 'Asia/Kolkata') as kolkata_minute,
  count(*) as n,
  max(to_utc(at_timezone(ts, 'Europe/Berlin'), 'Europe/Berlin')) as back,
  sum(hour(at_timezone(ts, 'Australia/Lord_Howe'))) as lord_howe_hours,
  min(from_unixtime(o_orderkey, 'Asia/Tokyo')) as first_tokyo
from (select o_orderkey, cast(o_orderdate as timestamp) as ts from orders) o
group by timezone_hour(ts, 'America/New_York'), timezone_minute(ts, 'Asia/Kolkata')
order by ny_offset, kolkata_minute
""",
    # NULL partition (custkey % 1000 = 0) and order (1995) keys, NULLS FIRST
    # and the default NULLS LAST
    "W5": """
select o_orderkey, ck, od,
  row_number() over (partition by ck order by od nulls first, o_orderkey) as rn_first,
  row_number() over (partition by ck order by od, o_orderkey) as rn_last,
  rank() over (partition by ck order by od nulls first) as rk_first,
  rank() over (partition by ck order by od) as rk_last
from (select o_orderkey, nullif(o_custkey % 1000, 0) as ck,
             nullif(year(o_orderdate), 1995) * 1000 + day_of_year(o_orderdate) as od
      from orders) o
""",
}
FUNCTION_COLUMNS = {
    "A1": {"lineitem": ("l_returnflag", "l_linestatus", "l_discount", "l_quantity", "l_tax",
                        "l_orderkey", "l_extendedprice", "l_suppkey", "l_partkey")},
    "A2": {"lineitem": ("l_orderkey", "l_linenumber", "l_extendedprice", "l_partkey",
                        "l_quantity", "l_returnflag")},
    "S1": {"lineitem": ("l_shipdate", "l_receiptdate", "l_commitdate", "l_extendedprice",
                        "l_discount", "l_linenumber", "l_quantity", "l_tax")},
    "S2": {"part": ("p_partkey", "p_type", "p_brand", "p_mfgr", "p_container"),
           "supplier": ("s_suppkey", "s_name"),
           "customer": ("c_custkey", "c_phone", "c_mktsegment")},
    "D1": {"lineitem": ("l_returnflag", "l_extendedprice", "l_quantity")},
    "T1": {"orders": ("o_orderkey", "o_orderdate")},
    "W5": {"orders": ("o_orderkey", "o_custkey", "o_orderdate")},
}
# W5 runs a second time at SF 1 in these tile rows (rows only), so that the
# window source's passes of whole partitions meet the NULL partition
W5_CHUNKED_TILE_ROWS = 1 << 18
# function texts that run at SF 1 when ``--sf`` is larger, with their tile
# rows there: with the complex slice the script took 1 094 s of its 1 200
# with an H100 (call 2 of the complex slice), A1 44.8 s and S1 39.8 s of it
# with their oracles and profiled runs; in 2^21-row tiles SF-1 lineitem is 3
# tiles, so A1 still accumulates across tiles in direct mode and S1's sort-mode
# partials still go through the device carry merge (both asserted).  With the
# sketch / Spark slice the script took 1 188 s (call 2 of that slice): A2 took
# 50.7 s of it at SF 10 (16.5 s its oracle, 15.0 s its profiled run), and P1
# still drives a 2^24-slot device carry without overflow at SF 10; at SF 1 in
# 2^21-row tiles A2's 1.5 M groups stay inside the carry (2^21 slots) and merge
# on the device across 3 tiles (asserted).  With the memory / spill slice W5
# followed: 44.3 s at SF 10 (18.8 s its oracle), one window pass over every
# SF-1 ``orders`` row at SF 1 in one tile (asserted); M4 keeps a window over
# every SF-10 ``orders`` row
FUNCTION_AT_SF1 = {"A1": 1 << 21, "S1": 1 << 21, "A2": 1 << 21, "W5": 1 << 24}
# A2 runs a second time at SF 1 in these tile rows (rows only): its 1.5 M
# orders pass the carry's slots (at most a tile's rows), so the partial
# groups of every new aggregate overflow into the host merge
# (``host_merge_sorted``; asserted)
A2_HOST_MERGE_TILE_ROWS = 1 << 20
# M2 and M4 of memory_spill: orders in tiles (runs, window passes) of 2^22 rows
SPILL_SORT_TILE_ROWS = 1 << 22


def _col(table, name):
    import numpy as np

    return np.asarray(table.columns[name]).astype(np.int64)


def _packed(fields):
    """One int64 per row from (non-negative int64 values, bits) fields, most
    significant first: a single-key sort order for several keys."""
    import numpy as np

    word = np.zeros(len(fields[0][0]), np.int64)
    total = 0
    for values, bits in fields:
        assert values.min(initial=0) >= 0 and values.max(initial=0) < (1 << bits), bits
        word = (word << bits) | values
        total += bits
    assert total <= 63, total
    return word


def _partition_starts(part_sorted):
    """Per row of rows sorted by partition, the position of its partition's
    first row."""
    import numpy as np

    n = len(part_sorted)
    new = np.ones(n, bool)
    new[1:] = part_sorted[1:] != part_sorted[:-1]
    return np.maximum.accumulate(np.where(new, np.arange(n), 0))


def _scatter(order, values):
    """``values`` given in ``order``'s row order, back in table row order."""
    import numpy as np

    out = np.empty_like(values)
    out[order] = values
    return out


def window_oracle(name: str, tables):
    """The expected rows of a W3 / W4 / F / U / N text: ({column: values},
    {column: validity}, the key columns that order the rows), integer
    columns in the device representation (unscaled decimals, days)."""
    import numpy as np

    if name == "W3":
        o = tables["orders"]
        cust, key = _col(o, "o_custkey"), _col(o, "o_orderkey")
        date, price = _col(o, "o_orderdate"), _col(o, "o_totalprice")
        n, pos = len(key), np.arange(len(key))
        # (custkey; orderdate, orderkey): row_number, lag, the ROWS frames
        a = np.argsort(_packed([(cust, 21), (date, 14), (key, 27)]))
        start = _partition_starts(cust[a])
        pa = price[a]
        has_prev = pos > start
        prev = np.where(has_prev, np.roll(pa, 1), 0)
        csum = np.cumsum(pa)
        lo = np.maximum(pos - 2, start)
        sum3 = csum - np.where(lo > 0, csum[np.maximum(lo - 1, 0)], 0)
        max4 = pa.copy()
        for back in (1, 2, 3):
            src = pos - back
            max4 = np.where(src >= start, np.maximum(max4, pa[np.maximum(src, 0)]), max4)
        # (custkey; totalprice desc): rank
        b = np.argsort(_packed([(cust, 21), ((1 << 27) - 1 - price, 27)]), kind="stable")
        start_b = _partition_starts(cust[b])
        peer = np.ones(n, bool)
        peer[1:] = (cust[b][1:] != cust[b][:-1]) | (price[b][1:] != price[b][:-1])
        rank = np.maximum.accumulate(np.where(peer, pos, 0)) - start_b + 1
        # (custkey; orderdate): running min with peers, RANGE 30 days back
        c = np.argsort(_packed([(cust, 21), (date, 14)]), kind="stable")
        cc, dc, pc = cust[c], date[c], price[c]
        pid = np.cumsum(np.r_[True, cc[1:] != cc[:-1]]) - 1
        big = np.int64(1) << 40
        run_min = np.minimum.accumulate(pc - pid * big) + pid * big
        peer_end = np.r_[(cc[1:] != cc[:-1]) | (dc[1:] != dc[:-1]), True]
        last_peer = np.minimum.accumulate(np.where(peer_end, pos, n)[::-1])[::-1]
        word = (cc << 14) | dc
        cnt30 = np.searchsorted(word, word, "right") - np.searchsorted(word, word - 30, "left")
        cols = {
            "o_orderkey": key, "o_custkey": cust, "o_orderdate": date, "o_totalprice": price,
            "rn": _scatter(a, pos - start + 1), "rk": _scatter(b, rank),
            "prev_price": _scatter(a, prev), "sum3": _scatter(a, sum3),
            "max4": _scatter(a, max4), "run_min": _scatter(c, run_min[last_peer]),
            "cnt30": _scatter(c, cnt30),
        }
        return cols, {"prev_price": _scatter(a, has_prev)}, ("o_orderkey",)
    if name == "W4":
        li = tables["lineitem"]
        okey, line = _col(li, "l_orderkey"), _col(li, "l_linenumber")
        price, qty, ship = _col(li, "l_extendedprice"), _col(li, "l_quantity"), _col(li, "l_shipdate")
        pos = np.arange(len(okey))
        o = np.argsort(_packed([(okey, 27), ((1 << 24) - 1 - price, 24), (line, 3)]))
        start = _partition_starts(okey[o])
        has_prev = pos > start
        qo, so = qty[o], ship[o]
        cols = {
            "l_orderkey": okey, "l_linenumber": line, "l_extendedprice": price,
            "l_quantity": qty, "l_shipdate": ship,
            "rn": _scatter(o, pos - start + 1),
            "qty2": _scatter(o, qo + np.where(has_prev, np.roll(qo, 1), 0)),
            "prev_ship": _scatter(o, np.where(has_prev, np.roll(so, 1), 0)),
        }
        return cols, {"prev_ship": _scatter(o, has_prev)}, ("l_orderkey", "l_linenumber")
    if name in ("F1", "F2"):
        cu, od = tables["customer"], tables["orders"]
        seg = cu.string_tables["c_mktsegment"].decode(np.asarray(cu.columns["c_mktsegment"]))
        building = seg == "BUILDING"
        ckey, cbal = _col(cu, "c_custkey")[building], _col(cu, "c_acctbal")[building]
        keep = _col(od, "o_orderdate") < _days("1995-03-15")
        ocust, oprice = _col(od, "o_custkey")[keep], _col(od, "o_totalprice")[keep]
        at = np.searchsorted(ckey, ocust)  # custkeys are ascending and unique
        assert np.all(np.diff(ckey) > 0)
        found = (at < len(ckey)) & (ckey[np.minimum(at, len(ckey) - 1)] == ocust)
        if name == "F2":
            found &= oprice > cbal[np.minimum(at, len(ckey) - 1)] * 10
        cust_matched = np.zeros(len(ckey), bool)
        cust_matched[at[found]] = True
        lonely = int((~cust_matched).sum())
        cols = {
            "customers": np.array([int(found.sum()) + lonely]),
            "orders_n": np.array([len(ocust)]),
            "pairs": np.array([len(ocust) + lonely]),
            "total": np.array([int(oprice.sum())]),
        }
        return cols, {}, ()
    if name == "U1":
        cu, su = tables["customer"], tables["supplier"]
        nk = np.concatenate([_col(cu, "c_nationkey"), _col(su, "s_nationkey")])
        bal = np.concatenate([_col(cu, "c_acctbal"), _col(su, "s_acctbal")])
        keys = np.unique(nk)
        cols = {
            "nationkey": keys,
            "n": np.bincount(nk)[keys].astype(np.int64),
            "total": np.array([int(bal[nk == k].sum()) for k in keys], np.int64),
        }
        return cols, {}, ("nationkey",)
    if name == "N1":
        su, na = tables["supplier"], tables["nation"]
        nk, bal = _col(su, "s_nationkey"), _col(su, "s_acctbal")
        nations = np.sort(_col(na, "n_nationkey"))
        above = len(nations) - np.searchsorted(nations, nk, "right")
        cols = {"pairs": np.array([int(above.sum())]), "total": np.array([int((bal * above).sum())])}
        return cols, {}, ()
    raise KeyError(name)


def window_plan(name: str, builder, tables):
    """The two window-slice plans built with ``builder`` (either package's
    PlanBuilder): a MergeExchange of two sorted ``orders`` branches, and the
    top three orders of every customer by price."""
    orders = tables["orders"]
    if name == "merge_exchange":
        branches = [
            builder().table_scan(orders).filter(f"o_orderdate {op} date '1995-01-01'")
            .orderby(["o_totalprice desc"])
            for op in ("<", ">=")
        ]
        return (builder().merge_exchange(branches, ["o_totalprice desc"])
                .project(["o_orderkey", "o_totalprice"]).build())
    if name == "topn_row_number":
        return (builder().table_scan(orders).project(["o_orderkey", "o_custkey", "o_totalprice"])
                .topn_row_number(["o_custkey"], ["o_totalprice desc"], 3).build())
    raise KeyError(name)


WINDOW_PLAN_COLUMNS = {
    "merge_exchange": {"orders": ("o_orderkey", "o_orderdate", "o_totalprice")},
    "topn_row_number": {"orders": ("o_orderkey", "o_custkey", "o_totalprice")},
}


def window_plan_oracle(name: str, tables):
    """``window_oracle``'s form for the two plans; the merge's rows keep
    their order (stable merge: ties in the first branch's order, then the
    second's), so its key tuple is empty and the order is compared too."""
    import numpy as np

    o = tables["orders"]
    key, price = _col(o, "o_orderkey"), _col(o, "o_totalprice")
    if name == "merge_exchange":
        early = _col(o, "o_orderdate") < _days("1995-01-01")
        branches = [np.flatnonzero(early), np.flatnonzero(~early)]
        rows = np.concatenate([b[np.argsort(-price[b], kind="stable")] for b in branches])
        rows = rows[np.argsort(-price[rows], kind="stable")]
        return {"o_orderkey": key[rows], "o_totalprice": price[rows]}, {}, ()
    if name == "topn_row_number":
        cust = _col(o, "o_custkey")
        order = np.argsort(_packed([(cust, 21), ((1 << 27) - 1 - price, 27)]), kind="stable")
        rn = np.arange(len(order)) - _partition_starts(cust[order]) + 1
        keep = order[rn <= 3]
        return ({"o_orderkey": key[keep], "o_custkey": cust[keep], "o_totalprice": price[keep],
                 "row_number": rn[rn <= 3]}, {}, ("o_orderkey",))
    raise KeyError(name)


def _days(text: str) -> int:
    import numpy as np

    return int((np.datetime64(text) - np.datetime64("1970-01-01")).astype(np.int64))


def check_window_rows(result, want, want_valid, keys):
    """A result Table held against an oracle's rows: the rows ordered by
    ``keys`` on both sides (as they come when ``keys`` is empty), every
    validity, and every value where valid — integers exactly, floats to rtol
    1e-9, strings (an oracle column of ``str``) by value, long decimals (an
    oracle column of Python ints) limb pair by limb pair."""
    import numpy as np

    assert result.num_rows == len(next(iter(want.values()))), (result.num_rows,)
    n = result.num_rows

    def order(cols):
        if not keys:
            return np.arange(n)
        arrays = [np.asarray(cols[k]).astype(np.int64) for k in keys]
        bits = [max(1, int(a.max(initial=0)).bit_length()) for a in arrays]
        if all(a.min(initial=0) >= 0 for a in arrays) and sum(bits) <= 63:
            # one sort of the keys packed into one word
            return np.argsort(_packed(list(zip(arrays, bits))), kind="stable")
        return np.lexsort(tuple(reversed(arrays)))

    got_o, want_o = order(result.columns), order(want)
    for name, values in want.items():
        got = np.asarray(result.columns[name])[got_o]
        valid = np.asarray(want_valid.get(name, np.ones(n, bool)))[want_o]
        got_valid = result.validities.get(name)
        got_valid = np.ones(n, bool) if got_valid is None else np.asarray(got_valid)[got_o]
        assert np.array_equal(got_valid, valid), name
        exp = np.asarray(values)[want_o][valid]
        got = got[valid]
        if got.ndim == 2:  # a long decimal: (n, 2) [lo, hi] limbs
            got = np.array([(int(h) << 64) + (int(lo) & ((1 << 64) - 1)) for lo, h in got],
                           dtype=object)
            assert list(got) == [int(v) for v in exp], name
        elif exp.dtype == object and len(exp) and isinstance(exp[0], str):
            assert list(result.string_tables[name].decode(got)) == list(exp), name
        elif exp.dtype.kind == "f":
            assert np.allclose(got, exp, rtol=1e-9, atol=0, equal_nan=True), (
                name, float(np.max(np.abs(got - exp) / np.maximum(np.abs(exp), 1e-300))))
        else:
            assert np.array_equal(got.astype(np.int64), exp.astype(np.int64)), name


def _strings(table, name):
    import numpy as np

    return np.asarray(table.string_tables[name].decode(np.asarray(table.columns[name])), dtype=object)


def _code_groups(table, *names):
    """Rows grouped by the dictionary codes of string columns: (group of
    each row, the groups' decoded key tuples), groups in the order of their
    decoded keys."""
    import numpy as np

    combo = np.zeros(table.num_rows, np.int64)
    for name in names:
        codes = np.asarray(table.columns[name]).astype(np.int64)
        combo = combo * (int(codes.max()) + 1) + codes
    # the combined codes take few values: count them, no sort
    present = np.flatnonzero(np.bincount(combo))
    lut = np.full(int(combo.max()) + 1, -1, np.int64)
    lut[present] = np.arange(len(present))
    gid = lut[combo]
    keys = []
    for c in present:
        key, rest = [], int(c)
        for name in reversed(names):
            width = int(np.asarray(table.columns[name]).max()) + 1
            key.append(table.string_tables[name].decode(np.array([rest % width]))[0])
            rest //= width
        keys.append(tuple(reversed(key)))
    order = sorted(range(len(keys)), key=lambda i: keys[i])
    rank = np.empty(len(keys), np.int64)
    rank[order] = np.arange(len(keys))
    return rank[gid], [keys[i] for i in order]


def _moments(x, y=None):
    """(count, {power: central moment sum of x}, co-moment with y, y's
    second moment) of one group's values, two passes (the mean first)."""
    n = len(x)
    dx = x - x.sum() / n
    out = {p: (dx**p).sum() for p in (2, 3, 4)}
    if y is None:
        return n, out, None, None
    dy = y - y.sum() / n
    return n, out, (dx * dy).sum(), (dy * dy).sum()


def _splitmix64_np(v):
    import numpy as np

    with np.errstate(over="ignore"):
        x = v.astype(np.uint64) + np.uint64(0x9E3779B97F4A7C15)
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return x ^ (x >> np.uint64(31))


def _levenshtein_py(a: str, b: str) -> int:
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


# Porter stems of the finishes of TPC-H ``p_type`` (its second word, lower
# case): the only words S2 stems
FINISH_STEMS = {"anodized": "anod", "burnished": "burnish", "plated": "plate",
                "polished": "polish", "brushed": "brush"}


def function_oracle(name: str, tables):
    """The expected rows of a ``FUNCTION_SQL`` text, in ``check_window_rows``'
    form: ({column: values}, {column: validity}, the key columns that order
    the rows, or () where the text's ORDER BY orders them)."""
    import datetime
    import hashlib
    import math
    import re

    import numpy as np

    if name in ("A1", "A2", "S1", "D1"):
        li = tables["lineitem"]
        price = _col(li, "l_extendedprice") if "l_extendedprice" in li.columns else None
    if name == "A1":
        # few groups: one mask a group, every statistic two-pass over its
        # rows; DECIMAL values unscaled (integers in float64), the scales
        # divided out at the end as the engine does
        gid, keys = _code_groups(li, "l_returnflag", "l_linestatus")
        qty, disc, tax = _col(li, "l_quantity"), _col(li, "l_discount"), _col(li, "l_tax")
        okey, supp, part = _col(li, "l_orderkey"), _col(li, "l_suppkey"), _col(li, "l_partkey")
        hashes = _splitmix64_np(okey)
        rows = []
        for g in range(len(keys)):
            at = np.flatnonzero(gid == g)
            p, q, ok = price[at], qty[at], okey[at]
            n, mp, cov, m2q = _moments(p.astype(np.float64), q.astype(np.float64))
            cheapest = ok[p == p.min()].min()
            dearest = ok[p == p.max()].min()
            with np.errstate(over="ignore"):
                ck = hashes[at].sum(dtype=np.uint64)
            rows.append(dict(
                l_returnflag=keys[g][0], l_linestatus=keys[g][1],
                discounted=int((disc[at] > 5).sum()), all_below_50=bool((q < 5000).all()),
                any_top_tax=bool((tax[at] == 8).any()), cheapest_order=cheapest,
                dearest_order=dearest, sd_price=math.sqrt(mp[2] / (n - 1)) / 100,
                var_qty=m2q / n / 1e4, skew_price=math.sqrt(n) * mp[3] / mp[2] ** 1.5,
                kurt_price=n * mp[4] / mp[2] ** 2 - 3.0, cov_qty_price=cov / (n - 1) / 1e4,
                corr_qty_price=cov / math.sqrt(mp[2] * m2q),
                gm_price=math.exp(np.log(p / 100.0).sum() / n),
                or_supp=np.bitwise_or.reduce(supp[at]),
                and_part=np.bitwise_and.reduce(part[at] * 8 + 5),
                ck=int(np.array([ck], np.uint64).view(np.int64)[0]),
            ))
        cols = {k: np.array([r[k] for r in rows], dtype=object if isinstance(rows[0][k], str) else None)
                for k in rows[0]}
        return cols, {}, ()
    if name == "A2":
        okey, line = _col(li, "l_orderkey"), _col(li, "l_linenumber")
        part, qty = _col(li, "l_partkey"), _col(li, "l_quantity")
        returned = (np.asarray(li.columns["l_returnflag"])
                    == li.string_tables["l_returnflag"].lookup("R"))
        order = np.argsort(okey, kind="stable")  # generated in order: a no-op sort
        okey, line, part, qty, price, returned = (
            v[order] for v in (okey, line, part, qty, price, returned))
        starts = np.flatnonzero(np.r_[True, okey[1:] != okey[:-1]])
        n = np.diff(np.append(starts, len(okey)))
        # min_by / max_by, ties to the smaller payload: one packed word each
        # (price then line number; quantity then the complement of partkey)
        cheapest = np.minimum.reduceat(price * 8 + line, starts) % 8
        bits = int(part.max()).bit_length()
        top = np.maximum.reduceat((qty << bits) + ((1 << bits) - 1 - part), starts)
        # the statistics two-pass over each order's rows, DECIMAL unscaled
        x, q = price.astype(np.float64), qty.astype(np.float64)
        dx = x - np.repeat(np.add.reduceat(x, starts) / n, n)
        dq = q - np.repeat(np.add.reduceat(q, starts) / n, n)
        m2x = np.add.reduceat(dx * dx, starts)
        m2q = np.add.reduceat(dq * dq, starts)
        cxy = np.add.reduceat(dx * dq, starts)
        denom = np.sqrt(m2x * m2q)
        cols = {
            "l_orderkey": okey[starts],
            "cheapest_line": cheapest,
            "biggest_part": (1 << bits) - 1 - (top & ((1 << bits) - 1)),
            "var_price": m2x / np.maximum(n - 1, 1) / 1e4,
            "corr_qty_price": cxy / np.where(denom > 0, denom, 1.0),
            "any_returned": np.maximum.reduceat(returned, starts).astype(bool),
        }
        valid = {"var_price": n >= 2, "corr_qty_price": (n >= 2) & (denom > 0)}
        return cols, valid, ("l_orderkey",)
    if name == "S1":
        ship, receipt, commit = (_col(li, c) for c in ("l_shipdate", "l_receiptdate", "l_commitdate"))
        disc, qty, tax, line = (_col(li, c) for c in ("l_discount", "l_quantity", "l_tax", "l_linenumber"))
        # calendar facts of every day in range, from Python's datetime: a
        # lookup table instead of a pass over 60 M dates each
        first = int(min(ship.min(), receipt.min()))
        days = [datetime.date(1970, 1, 1) + datetime.timedelta(days=first + i)
                for i in range(int(max(ship.max(), receipt.max())) - first + 1)]
        epoch = datetime.date(1970, 1, 1)
        month_lut = np.array([(d.replace(day=1) - epoch).days for d in days])
        quarter_lut = np.array([(d.month - 1) // 3 + 1 for d in days])
        week_lut = np.array([d.isocalendar()[1] for d in days])
        dow_lut = np.array([d.isoweekday() for d in days])
        month = month_lut[ship - first]
        keys = np.unique(month_lut)
        keys = keys[np.isin(keys, month)]
        gid = np.searchsorted(keys, month)
        groups = len(keys)

        def total(values):
            # integers below 2^53 a group, so the float sums are exact;
            # float values: n * eps of relative error at most
            return np.bincount(gid, values, groups)

        def peak(values):
            out = np.full(groups, -np.inf)
            np.maximum.at(out, gid, np.asarray(values, np.float64))  # exact below 2^53
            return out

        calendar = quarter_lut[ship - first] + week_lut[ship - first] + dow_lut[receipt - first]
        revenue = price * (100 - disc)  # DECIMAL scale 4
        rounded = np.sign(revenue) * ((np.abs(revenue) + 5000) // 10000) * 10000
        xd = disc / 100.0
        bucket = np.clip(np.floor((xd - 0.0) / ((0.1 - 0.0) / 5)).astype(np.int64) + 1, 0, 6)
        tax_values, tax_inv = np.unique(tax, return_inverse=True)
        cdf = np.array([0.5 * (1.0 + math.erf((t / 100.0 * 10) / (1.0 * math.sqrt(2.0))))
                        for t in tax_values])[tax_inv]
        exact = {
            "n": np.ones(len(gid)), "transit_days": receipt - ship, "calendar": calendar,
            "rounded_revenue": rounded,
            # DECIMAL(18, 4): an integer literal multiplies at the decimal's
            # scale (both sides coerce to it), so tax * 100 has scale 4
            "capped_price": np.minimum(price * 100, qty * 100000),
            "later_lines": line != 1, "disc_buckets": bucket,
        }
        cols = {"ship_month": keys}
        cols.update({k: np.rint(total(v)).astype(np.int64) for k, v in exact.items()})
        cols.update(
            last_due=peak(commit + 30).astype(np.int64),
            greatest_pct=peak(np.maximum(qty * 100, np.maximum(tax, disc) * 10000)).astype(np.int64),
            log_price=total(np.log(price / 100.0)),
            qty_pow=peak((qty / 100.0) ** 1.5),
            tax_cdf=total(cdf),
        )
        return cols, {}, ()
    if name == "S2":
        pa, su, cu = tables["part"], tables["supplier"], tables["customer"]
        sk = _col(su, "s_suppkey")
        pk, ck = _col(pa, "p_partkey"), _col(cu, "c_custkey")
        # the keys are 1..N in row order: p_partkey = s_suppkey = c_custkey
        # picks the first len(supplier) rows of part and customer
        m = len(sk)
        assert np.array_equal(sk, np.arange(1, m + 1)) and np.array_equal(pk[:m], sk)
        assert np.array_equal(ck[:m], sk)
        ptype, brand = _strings(pa, "p_type")[:m], _strings(pa, "p_brand")[:m]
        mfgr, cont = _strings(pa, "p_mfgr")[:m], _strings(pa, "p_container")[:m]
        phone, seg = _strings(cu, "c_phone")[:m], _strings(cu, "c_mktsegment")[:m]
        sname = _strings(su, "s_name")
        rows = {}
        for i in range(m):
            words = ptype[i].split(" ")
            key = (words[2], FINISH_STEMS[words[1].lower()],
                   re.match(r"^([0-9]+)-", phone[i]).group(1))
            vals = (
                brand[i].rjust(10, "*")[:10], mfgr[i].ljust(16, ".")[:16],
                re.sub(r"^[A-Z]+ ", "", cont[i]), cont[i].replace(" ", "_"),
                _levenshtein_py(seg[i], "BUILDING"),
                sum(a != b for a, b in zip(brand[i], "Brand#13")) if len(brand[i]) == 8 else -1,
                hashlib.md5(sname[i].encode()).hexdigest(),
                hashlib.sha256(sname[i].encode()).hexdigest(),
            )
            r = rows.get(key)
            if r is None:
                rows[key] = [1, *vals]
            else:
                rows[key] = [r[0] + 1, max(r[1], vals[0]), min(r[2], vals[1]), max(r[3], vals[2]),
                             min(r[4], vals[3]), r[5] + vals[4], r[6] + vals[5],
                             min(r[7], vals[6]), max(r[8], vals[7])]
        keys = sorted(rows)
        names = ("n", "brand_pad", "mfgr_pad", "container_kind", "container_code",
                 "seg_distance", "brand_distance", "min_md5", "max_sha256")
        cols = {
            "material": np.array([k[0] for k in keys], dtype=object),
            "finish": np.array([k[1] for k in keys], dtype=object),
            "country": np.array([k[2] for k in keys], dtype=object),
        }
        for j, col in enumerate(names):
            vals = [rows[k][j] for k in keys]
            cols[col] = np.array(vals, dtype=object if isinstance(vals[0], str) else np.int64)
        return cols, {}, ()
    if name == "D1":
        qty = _col(li, "l_quantity")
        product = price * price * qty  # DECIMAL(38, 6), every row within int64
        assert product.max() < (1 << 62)
        # the text's rows come in the grouping's order, the dictionary codes
        # of l_returnflag
        codes = np.asarray(li.columns["l_returnflag"])
        present = np.flatnonzero(np.bincount(codes))
        keys = li.string_tables["l_returnflag"].decode(present)
        sums, counts = [], []
        for c in present:
            at = codes == c
            # the 32-bit halves' int64 sums are exact; Python ints join them
            sums.append((int((product[at] >> 32).sum()) << 32) + int((product[at] & 0xFFFFFFFF).sum()))
            counts.append(int(at.sum()))

        def div_round(a, b):
            q, r = divmod(abs(a), b)
            return (q + (2 * r >= b)) * (1 if a >= 0 else -1)

        cols = {
            "l_returnflag": np.array(keys, dtype=object),
            "big_sum": np.array(sums, dtype=object),
            "big_avg": np.array([v / c / 1e6 for v, c in zip(sums, counts)]),
            "big_mean": np.array([div_round(v, c) for v, c in zip(sums, counts)], dtype=object),
        }
        return cols, {}, ()
    if name == "T1":
        from zoneinfo import ZoneInfo

        o = tables["orders"]
        okey, date = _col(o, "o_orderkey"), _col(o, "o_orderdate")
        day_us = 86_400_000_000
        hour_us = 3_600_000_000
        # every zone fact per distinct date, from Python's zoneinfo
        dates, inv = np.unique(date, return_inverse=True)
        utc = [datetime.datetime(1970, 1, 1, tzinfo=datetime.timezone.utc)
               + datetime.timedelta(days=int(d)) for d in dates]

        def offset_us(zone):
            return np.array([int(u.astimezone(ZoneInfo(zone)).utcoffset().total_seconds()) * 1_000_000
                             for u in utc])

        ny = offset_us("America/New_York") // hour_us
        kolkata = offset_us("Asia/Kolkata") % hour_us // 60_000_000
        lord_howe = (dates * day_us + offset_us("Australia/Lord_Howe")) % day_us // hour_us
        berlin = offset_us("Europe/Berlin")
        # the wall time back to UTC; an ambiguous wall time takes the offset
        # after the transition (fold=1), as the engine does
        back = []
        for u, off in zip(utc, berlin):
            wall = (u + datetime.timedelta(microseconds=int(off))).replace(tzinfo=None)
            local = wall.replace(tzinfo=ZoneInfo("Europe/Berlin"), fold=1)
            back.append(int(local.timestamp()) * 1_000_000)
        back = np.array(back)
        key = ny[inv] * 100 + kolkata[inv]
        keys = np.unique(key)
        gid = np.searchsorted(keys, key)
        groups = len(keys)
        first = np.full(groups, np.iinfo(np.int64).max)
        np.minimum.at(first, gid, okey)
        last_back = np.full(groups, np.iinfo(np.int64).min)
        np.maximum.at(last_back, gid, back[inv])
        cols = {
            "ny_offset": keys // 100, "kolkata_minute": keys % 100,
            "n": np.bincount(gid, minlength=groups),
            "back": last_back,
            "lord_howe_hours": np.bincount(gid, lord_howe[inv], groups).astype(np.int64),
            # Tokyo has kept +09:00 since 1951; order keys are seconds of 1970
            "first_tokyo": first * 1_000_000 + 9 * hour_us,
        }
        return cols, {}, ()
    if name == "W5":
        o = tables["orders"]
        okey, cust, date = _col(o, "o_orderkey"), _col(o, "o_custkey"), _col(o, "o_orderdate")
        ck = cust % 1000
        ck_valid = ck != 0
        dt = date.astype("datetime64[D]")
        year = dt.astype("datetime64[Y]").astype(np.int64) + 1970
        doy = (dt - dt.astype("datetime64[Y]").astype("datetime64[D]")).astype(np.int64) + 1
        od = year * 1000 + doy
        od_valid = year != 1995
        n = len(okey)
        # partition: (ck null last, ck); NULLs are one partition
        part = np.where(ck_valid, ck, 1000)
        cols = {"o_orderkey": okey, "ck": np.where(ck_valid, ck, 0), "od": np.where(od_valid, od, 0)}
        for suffix, null_key in (("first", 0), ("last", 1)):
            flag = np.where(od_valid, 1 - null_key, null_key)  # sorts NULLs first / last
            key_od = np.where(od_valid, od, 0)
            # one sort of (partition, flag, od, orderkey) packed in a word
            bits = [(part, 11), (flag, 1), (key_od, 22),
                    (okey, max(1, int(okey.max()).bit_length()))]
            rn_order = np.argsort(_packed(bits), kind="stable")
            ps = part[rn_order]
            start = np.flatnonzero(np.r_[True, ps[1:] != ps[:-1]])
            first = np.repeat(start, np.diff(np.append(start, n)))
            pos = np.arange(n)
            cols[f"rn_{suffix}"] = _scatter(rn_order, pos - first + 1)
            peer = np.r_[True, (ps[1:] != ps[:-1]) | (flag[rn_order][1:] != flag[rn_order][:-1])
                         | (key_od[rn_order][1:] != key_od[rn_order][:-1])]
            peer_start = np.maximum.accumulate(np.where(peer, pos, 0))
            cols[f"rk_{suffix}"] = _scatter(rn_order, peer_start - first + 1)
        return cols, {"ck": ck_valid, "od": od_valid}, ("o_orderkey",)
    raise KeyError(name)


# ---------------------------------------------------------------------------
# The complex-type slice: ARRAY / MAP values, lambdas, GroupId, Unnest, the
# collect aggregates and string construction, over the TPC-H tables, each
# text held against its numpy oracle (``check_complex``).  The tests run the
# same texts and plans through both packages at SF 0.01.  C2's reduce starts
# from cast(0 as double): from the BIGINT 0 (or the DECIMAL(2,1) 0.0) the
# state's type and the lambda's DECIMAL(18,4) result differ, which Presto
# refuses at planning, and both packages then carry the raw unscaled integer
# from step to step (ROADMAP Queue 3).

COMPLEX_SQL = {
    # four collect aggregates over 15 M orders, about 1 M groups
    "C1": """
select o_custkey, array_agg(o_totalprice) as prices, set_agg(o_orderpriority) as prios,
       histogram(o_orderstatus) as hist, map_agg(o_orderkey, o_shippriority) as ship
  from orders group by o_custkey
""",
    # array constructors, lambdas and per-row reductions over 60 M lineitem rows
    "C2": """
select l_returnflag, count(*) as n,
       sum(cardinality(filter(array[l_quantity, l_tax, l_discount], x -> x > 0))) as pos,
       sum(reduce(transform(array[l_quantity, l_discount], x -> x * 2), cast(0 as double),
                  (s, x) -> s + x, s -> s)) as red
  from lineitem group by l_returnflag
""",
    # GroupId: three grouping sets
    "C3": """
select l_returnflag, l_linestatus, sum(l_quantity) as q, count(*) as n
  from lineitem group by rollup(l_returnflag, l_linestatus)
""",
    # a numeric key rendered as VARCHAR on the host
    "C4": """
select cast(l_linenumber as varchar) as ln, count(*) as n
  from lineitem group by cast(l_linenumber as varchar)
""",
    # a collect rendered by array_join
    "C5": """
select o_custkey, array_join(array_agg(o_orderpriority), ',') as prios
  from orders group by o_custkey
""",
    # seven arrays of about 8.5 M elements back on the card
    "C6": """
select l_shipmode, cardinality(array_distinct(array_agg(l_linenumber))) as nd,
       element_at(array_sort(array_agg(l_quantity)), 1) as qmin
  from lineitem group by l_shipmode
""",
}
COMPLEX_COLUMNS = {
    "C1": {"orders": ("o_custkey", "o_totalprice", "o_orderpriority", "o_orderstatus",
                      "o_orderkey", "o_shippriority")},
    "C2": {"lineitem": ("l_returnflag", "l_quantity", "l_tax", "l_discount")},
    "C3": {"lineitem": ("l_returnflag", "l_linestatus", "l_quantity")},
    "C4": {"lineitem": ("l_linenumber",)},
    "C5": {"orders": ("o_custkey", "o_orderpriority")},
    "C6": {"lineitem": ("l_shipmode", "l_linenumber", "l_quantity")},
    "C7": {"part": ("p_name",)},
    "C8": {"lineitem": ("l_orderkey", "l_partkey")},
}
# texts that run at SF 1 when ``--sf`` is larger, with their tile rows there:
# C5's render is a Python loop over every element (``exec/strcast.py
# _render_array_join``): at SF 10 a run took 18.2 s with an H100, 16.1 s of
# it the render, and 43.7 s with its oracle and profiled run; at SF 1 its 1.5 M
# elements still go through the collect and the render (asserted).  C1 follows
# (31.1 s at SF 10 in call 2 of the sketch / Spark slice, whose script took
# 1 188 s): C6 and C8 still drive the collect over 60 M SF-10 rows, and at SF 1
# in 2^20-row tiles C1's four collects span two tiles (asserted).  C7's split
# and Unnest over every SF-10 ``part`` name took 13.6 s with its oracle; at SF
# 1 its 200 000 names still go through them
COMPLEX_AT_SF1 = {"C5": 1 << 24, "C1": 1 << 20, "C7": 1 << 24}


def complex_plan(name: str, builder, tables):
    """C7: ``part`` -> split(p_name, ' ') -> unnest with ordinality -> per
    word the count and the last position; C8: ``lineitem`` ->
    array_agg(l_partkey) by order -> unnest with ordinality -> sums, count
    and the longest order (a collect feeding an unnest)."""
    if name == "C7":
        return (
            builder().table_scan(tables["part"]).project(["split(p_name, ' ') as words"])
            .unnest([], ["words"], ordinality="pos")
            .aggregation(["words"], ["count(*) as n", "max(pos) as last_pos"]).build()
        )
    if name == "C8":
        return (
            builder().table_scan(tables["lineitem"])
            .aggregation(["l_orderkey"], ["array_agg(l_partkey) as parts"])
            .unnest(["l_orderkey"], ["parts"], ordinality="pos")
            .project(["parts", "pos", "parts * pos as w"])
            .aggregation([], ["sum(parts) as s", "count(*) as n", "max(pos) as m",
                              "sum(w) as sw"]).build()
        )
    raise KeyError(name)


def _groups(keys):
    """(order, starts, group keys) of a stable sort by ``keys``."""
    import numpy as np

    order = np.argsort(keys, kind="stable")
    ks = keys[order]
    starts = np.flatnonzero(np.r_[True, ks[1:] != ks[:-1]]) if len(ks) else np.zeros(0, np.int64)
    return order, starts, ks[starts]


def _decimal_ints(result, name):
    """A DECIMAL result column as Python ints (short: int64; long: limbs)."""
    import numpy as np

    arr = np.asarray(result.columns[name])
    if arr.ndim == 2:
        return [(int(h) << 64) + (int(lo) & ((1 << 64) - 1)) for lo, h in arr]
    return [int(v) for v in arr]


def _by_key(result, key):
    """Row order of a result sorted by a non-NULL integer key column."""
    import numpy as np

    return np.argsort(np.asarray(result.columns[key]), kind="stable")


def check_complex(name: str, result, tables):
    """Hold the result Table of a complex text to its numpy oracle: integers,
    decimals, dates, strings and array contents exactly (``array_agg`` in
    input order within each group, set-like results as sorted sets), DOUBLE
    to rtol 1e-9.  Returns facts of the check (groups, elements)."""
    import numpy as np

    if name in ("C1", "C5"):
        o_t = tables["orders"]
        order, starts, keys = _groups(np.asarray(o_t.columns["o_custkey"]))
        sizes = np.diff(np.append(starts, len(order)))
        gids = np.repeat(np.arange(len(keys)), sizes)
        ro = _by_key(result, "o_custkey")
        assert np.array_equal(np.asarray(result.columns["o_custkey"])[ro], keys)
        if name == "C5":
            prio = _strings(o_t, "o_orderpriority")[order]
            want = [",".join(p) for p in np.split(prio, starts[1:])] if len(order) else []
            got = result.string_tables["prios"].decode(np.asarray(result.columns["prios"])[ro])
            assert list(got) == want, name
            return dict(groups=len(keys), elements=len(order))
        prices = result.columns["prices"].take_rows(ro)
        assert np.array_equal(prices.sizes, sizes)
        assert np.array_equal(prices.children[0], np.asarray(o_t.columns["o_totalprice"])[order])
        assert prices.child_validities[0] is None
        # set_agg and histogram are held as sorted sets: (group, string rank)
        # pairs in order on both sides, counted by one bincount
        for col, src_col in (("prios", "o_orderpriority"), ("hist", "o_orderstatus")):
            table = o_t.string_tables[src_col]
            rank = np.asarray(table.sort_permutation(), np.int64)
            width = len(rank)
            codes = np.asarray(o_t.columns[src_col]).astype(np.int64)[order]
            counts = np.bincount(gids * width + rank[codes], minlength=len(keys) * width)
            present = np.flatnonzero(counts)
            seg = result.columns[col].take_rows(ro)
            rank_of = dict(zip(table.values(), rank))
            lut = np.asarray([rank_of.get(s, -1) for s in seg.string_tables[0].values()], np.int64)
            seg_gids = np.repeat(np.arange(len(seg.sizes)), np.asarray(seg.sizes, np.int64))
            got = seg_gids * width + lut[np.asarray(seg.children[0]).astype(np.int64)]
            o = np.argsort(got, kind="stable")
            assert np.array_equal(got[o], present), col
            if col == "hist":
                assert np.array_equal(np.asarray(seg.children[1])[o], counts[present]), "hist counts"
        ship = result.columns["ship"].take_rows(ro)
        okey = np.asarray(o_t.columns["o_orderkey"]).astype(np.int64)[order]
        o = np.argsort(gids * (int(okey.max(initial=0)) + 1) + okey, kind="stable")
        assert np.array_equal(ship.sizes, sizes)
        assert np.array_equal(ship.children[0], okey[o])
        assert np.array_equal(ship.children[1], np.asarray(o_t.columns["o_shippriority"])[order][o])
        return dict(groups=len(keys), elements=len(order))
    li = tables.get("lineitem")
    if name == "C2":
        flags, keys = _code_groups(li, "l_returnflag")
        q, t, d = (np.asarray(li.columns[c]).astype(np.int64)
                   for c in ("l_quantity", "l_tax", "l_discount"))
        n = np.bincount(flags, minlength=len(keys))
        pos = np.bincount(flags, weights=(q > 0).astype(np.int64) + (t > 0) + (d > 0),
                          minlength=len(keys)).astype(np.int64)
        red = np.bincount(flags, weights=(0.0 + q * 200 / 1e4) + d * 200 / 1e4, minlength=len(keys))
        want = {k[0]: (int(a), int(b), float(c)) for k, a, b, c in zip(keys, n, pos, red)}
        got_rf = result.string_tables["l_returnflag"].decode(np.asarray(result.columns["l_returnflag"]))
        assert sorted(got_rf) == sorted(want), name
        for i, flag in enumerate(got_rf):
            wn, wpos, wred = want[flag]
            assert int(result.columns["n"][i]) == wn, (name, flag)
            assert int(result.columns["pos"][i]) == wpos, (name, flag)
            assert abs(float(result.columns["red"][i]) - wred) <= 1e-9 * abs(wred), (name, flag)
        return dict(groups=len(keys))
    if name == "C3":
        pairs, keys = _code_groups(li, "l_returnflag", "l_linestatus")
        q = np.asarray(li.columns["l_quantity"]).astype(np.float64)  # exact below 2^53
        sums = np.bincount(pairs, weights=q, minlength=len(keys)).astype(np.int64)
        counts = np.bincount(pairs, minlength=len(keys))
        want = {k: (int(s), int(c)) for k, s, c in zip(keys, sums, counts)}
        for a in {k[0] for k in keys}:
            m = [i for i, k in enumerate(keys) if k[0] == a]
            want[(a, None)] = (int(sums[m].sum()), int(counts[m].sum()))
        want[(None, None)] = (int(sums.sum()), int(counts.sum()))

        def col(c):
            v = result.validities.get(c)
            s = result.string_tables[c].decode(np.asarray(result.columns[c]))
            return [x if v is None or v[i] else None for i, x in enumerate(s)]

        got = {k: (s, int(n)) for k, s, n in zip(
            zip(col("l_returnflag"), col("l_linestatus")), _decimal_ints(result, "q"),
            np.asarray(result.columns["n"]))}
        assert got == want, name
        return dict(groups=len(want))
    if name == "C4":
        counts = np.bincount(np.asarray(li.columns["l_linenumber"]).astype(np.int64))
        want = {str(i): int(c) for i, c in enumerate(counts) if c}
        got = dict(zip(result.string_tables["ln"].decode(np.asarray(result.columns["ln"])),
                       (int(n) for n in result.columns["n"])))
        assert got == want, name
        return dict(groups=len(want))
    if name == "C6":
        modes, keys = _code_groups(li, "l_shipmode")
        ln = np.asarray(li.columns["l_linenumber"]).astype(np.int64)
        q = np.asarray(li.columns["l_quantity"]).astype(np.int64)
        width = int(ln.max()) + 1
        distinct = np.bincount(np.unique(modes * width + ln) // width, minlength=len(keys))
        qmin = np.full(len(keys), np.iinfo(np.int64).max)
        np.minimum.at(qmin, modes, q)
        want = {k[0]: (int(a), int(b)) for k, a, b in zip(keys, distinct, qmin)}
        got_mode = result.string_tables["l_shipmode"].decode(np.asarray(result.columns["l_shipmode"]))
        assert sorted(got_mode) == sorted(want), name
        qmins = _decimal_ints(result, "qmin")
        for i, m_name in enumerate(got_mode):
            assert (int(result.columns["nd"][i]), qmins[i]) == want[m_name], (name, m_name)
        return dict(groups=len(keys), elements=len(modes))
    if name == "C7":
        part = tables["part"]
        codes = np.asarray(part.columns["p_name"]).astype(np.int64)
        names = part.string_tables["p_name"].values()
        per_code = np.bincount(codes, minlength=len(names))
        words, owner, pos = {}, [], []
        word_id = []
        for c, text in enumerate(names):
            if not per_code[c] or not text:
                continue
            for j, w in enumerate(text.split(" ")):
                word_id.append(words.setdefault(w, len(words)))
                owner.append(c)
                pos.append(j + 1)
        word_id, owner, pos = (np.asarray(a, np.int64) for a in (word_id, owner, pos))
        count = np.bincount(word_id, weights=per_code[owner], minlength=len(words)).astype(np.int64)
        last = np.zeros(len(words), np.int64)
        np.maximum.at(last, word_id, pos)
        got_w = result.string_tables["words"].decode(np.asarray(result.columns["words"]))
        assert sorted(got_w) == sorted(words), name
        ids = np.asarray([words[w] for w in got_w], np.int64)
        assert np.array_equal(np.asarray(result.columns["n"]), count[ids]), name
        assert np.array_equal(np.asarray(result.columns["last_pos"]), last[ids]), name
        return dict(groups=len(words), elements=int(count.sum()))
    if name == "C8":
        ok = np.asarray(li.columns["l_orderkey"])
        pk = np.asarray(li.columns["l_partkey"]).astype(np.int64)
        order, starts, _ = _groups(ok)
        sizes = np.diff(np.append(starts, len(order)))
        rank = np.arange(len(order)) - np.repeat(starts, sizes) + 1
        got = {c: int(result.columns[c][0]) for c in ("s", "n", "m", "sw")}
        want = dict(s=int(pk.sum()), n=len(pk), m=int(sizes.max()),
                    sw=int((pk[order] * rank).sum()))
        assert got == want, (name, got, want)
        return dict(groups=len(starts), elements=len(pk))
    raise KeyError(name)


# ---------------------------------------------------------------------------
# The sketch / Spark slice: approx_distinct (H1, H2), approx_percentile by the
# KLL rewrite (P1) and by DDSketch (P2), a Spark bloom filter built from
# orders and probed over lineitem (B1), Spark hashes, dates, shifts and rand
# (X1), Spark string functions (X2) and the Spark aggregate aliases (X3).
# Each is held against a numpy oracle below, written from the algorithms'
# specifications, not from the port.  l_extendedprice is DECIMAL(12,2): the
# sketches of H2, P1 and P2 take it cast to DOUBLE (a DECIMAL argument takes
# approx_percentile's exact path; the HLL of H2 then hashes the DOUBLE's
# IEEE bits).
SPARK_SQL = {
    "H1": "select l_shipmode, approx_distinct(l_partkey) as d from lineitem group by l_shipmode",
    "H2": "select approx_distinct(cast(l_extendedprice as double)) as d from lineitem",
    "P1": """
select l_returnflag, approx_percentile(cast(l_extendedprice as double), 0.5) as med
  from lineitem group by l_returnflag
""",
    "X1": """
select pmod(l_orderkey, 7) as b, count(*) as n, min(hash(l_partkey, l_suppkey)) as h,
       max(xxhash64(l_orderkey, l_linenumber)) as x,
       max(datediff(l_receiptdate, l_shipdate)) as dd, min(add_months(l_shipdate, 1)) as am,
       max(last_day(l_shipdate)) as ld, sum(shiftleft(l_linenumber, 3)) as sl,
       min(rand(42)) as r0, max(rand(42)) as r1
  from lineitem group by pmod(l_orderkey, 7)
""",
    "X2": """
select substring_index(p_type, ' ', 1) as t, count(*) as n, max(crc32(p_name)) as c,
       sum(instr(p_name, 'green')) as i, max(levenshtein(p_brand, 'Brand#11')) as lv
  from part group by substring_index(p_type, ' ', 1)
""",
    # the build side of a runtime filter (Spark / Gluten): a Spark bloom filter
    # of the orders of 1992, probed by ``B1_PROBE`` over every lineitem row
    "B1": "select bloom_filter_agg(o_orderkey) as bf from orders where o_orderdate < date '1993-01-01'",
}
B1_PROBE = "select count(*) as n from lineitem where might_contain(X'{hex}', l_orderkey)"
SPARK_COLUMNS = {
    "H1": {"lineitem": ("l_shipmode", "l_partkey")},
    "H2": {"lineitem": ("l_extendedprice",)},
    "P1": {"lineitem": ("l_returnflag", "l_extendedprice")},
    "P2": {"lineitem": ("l_shipmode", "l_extendedprice")},
    "B1": {"orders": ("o_orderkey", "o_orderdate"), "lineitem": ("l_orderkey",)},
    "X1": {"lineitem": ("l_orderkey", "l_partkey", "l_suppkey", "l_linenumber",
                        "l_shipdate", "l_receiptdate")},
    "X2": {"part": ("p_type", "p_name", "p_brand")},
    "X3": {"partsupp": ("ps_partkey", "ps_suppkey", "ps_availqty")},
}
SPARK_NAMES = ["H1", "H2", "P1", "P2", "B1", "X1", "X2", "X3"]
# the slice runs at SF 1 when ``--sf`` is larger, with these tile rows: at SF
# 10 its eight lines took 59 s with an H100, 50 s of it their numpy oracles
# (the Spark hashes of every ``lineitem`` row); X1 in tiles of 2^21 rows, so
# that ``rand(42)`` still spans three tiles (asserted)
SPARK_AT_SF1 = {**dict.fromkeys(SPARK_NAMES, 1 << 24), "X1": 1 << 21}
HLL_REGISTERS = 2048
ORACLE_CHUNK = 1 << 20  # rows an oracle computes at a time
HLL_TOLERANCE = 4 * 0.023  # 4 standard errors of 2 048 registers
KLL_POINTS = 256  # QueryConfig.kll_points: rank error at most 2/256 of a group
DD_ALPHA = 0.005  # DDSketch's relative value error
# the bound of a DDSketch bucket's representative, gamma^(b - 1/2) for the
# values in (gamma^(b-1), gamma^b]: sqrt(gamma) - 1, 0.50125 %
DD_BOUND = ((1 + DD_ALPHA) / (1 - DD_ALPHA)) ** 0.5 - 1


def spark_plan(name: str, builder, tables):
    """P2 and X3, built as plans: P2 with ``QueryConfig(percentile_sketch=
    "ddsketch")`` (see ``spark_config``), X3 the Spark aggregate aliases
    (their SQL spelling is not known to the SQL front end)."""
    if name == "P2":
        return (builder().table_scan(tables["lineitem"])
                .project(["l_shipmode", "cast(l_extendedprice as double) as price"])
                .aggregation(["l_shipmode"], ["approx_percentile(price, 0.9) as q"]).build())
    assert name == "X3", name
    return (builder().table_scan(tables["partsupp"])
            .aggregation(["ps_partkey"], ["first(ps_suppkey) as f", "last(ps_suppkey) as la",
                                          "collect_list(ps_suppkey) as cl",
                                          "collect_set(ps_availqty) as cs"]).build())


def spark_config(name: str):
    from velox_tpu_torch.config import DEFAULT_CONFIG

    return DEFAULT_CONFIG.copy(percentile_sketch="ddsketch") if name == "P2" else None


_U64 = (1 << 64) - 1


def _u64(c: int):
    import numpy as np

    return np.uint64(c & _U64)


def hll_hash_np(words):
    """The HLL hash of 64-bit words: splitmix64's finalizer (a multiply by
    the golden gamma, then two xor-shift-multiply rounds), uint64."""
    import numpy as np

    with np.errstate(over="ignore"):
        x = words.astype(np.int64).view(np.uint64) * _u64(0x9E3779B97F4A7C15)
        x = x ^ (x >> np.uint64(31))
        x = x * _u64(0xBF58476D1CE4E5B9)
        return x ^ (x >> np.uint64(27))


def hll_oracle(words, gid, ngroups: int):
    """HyperLogLog with 2 048 registers: the register is the hash's top 11
    bits, its value the leading zeros of the remaining 53 bits plus one (65
    when they are all zero), merged by max; the estimate is the harmonic mean
    with linear counting below 2.5 m, rounded half away from zero.  Returns
    (estimate of every group, live registers of every group)."""
    import math

    import numpy as np

    # the largest rho of every register: mark (register, rho), then the last
    # mark of each register; in chunks of rows that stay in the caches
    seen = np.zeros((ngroups * HLL_REGISTERS, 66), bool)
    for lo in range(0, len(words), ORACLE_CHUNK):
        h = hll_hash_np(words[lo:lo + ORACLE_CHUNK])
        bucket = (h >> np.uint64(53)).astype(np.int64)
        # the low 53 bits hold exactly in a double: frexp's exponent is their
        # bit length, and the remainder's leading zeros are 53 minus it
        _, length = np.frexp((h & np.uint64((1 << 53) - 1)).astype(np.float64))
        rho = 54 - length.astype(np.int64)
        rho[length == 0] = 65
        seen[gid[lo:lo + ORACLE_CHUNK].astype(np.int64) * HLL_REGISTERS + bucket, rho] = True
    regs = np.where(seen.any(axis=1), 65 - np.argmax(seen[:, ::-1], axis=1), 0)
    regs = regs.reshape(ngroups, HLL_REGISTERS)
    m = float(HLL_REGISTERS)
    alpha = 0.7213 / (1.0 + 1.079 / HLL_REGISTERS)
    out, live = [], []
    for g in range(ngroups):
        r = regs[g][regs[g] > 0]
        v = len(r)
        s = int(sum(1 << max(54 - int(x), 0) for x in r))
        raw = (alpha * m * m) / (float(s) / float(1 << 54) + (m - float(v)))
        guard = 1.0 if v >= HLL_REGISTERS else m - float(v)
        est = m * math.log(m / guard) if (raw <= 2.5 * m and v < HLL_REGISTERS) else raw
        out.append(int(math.floor(abs(est) + 0.5)))
        live.append(v)
    return out, live


def twang_mix64_np(x):
    """folly's twang_mix64 (the hash of Spark's bloom filter), uint64."""
    import numpy as np

    k = np.asarray(x).astype(np.int64).view(np.uint64)
    with np.errstate(over="ignore"):
        k = (~k) + (k << np.uint64(21))
        k = k ^ (k >> np.uint64(24))
        k = k * np.uint64(265)
        k = k ^ (k >> np.uint64(14))
        k = k * np.uint64(21)
        k = k ^ (k >> np.uint64(28))
        return k + (k << np.uint64(31))


def spark_bloom_np(values, num_bits: int = 8_388_608):
    """Spark's bloom_filter_agg of int64 values in its wire format: int8
    version 1, int32 word count, little-endian uint64 words; a value sets 4
    bits of one 64-bit block, from the low 24 bits of its hash, the block from
    the bits above (velox BloomFilter.h; numBits capped at 4 194 304, 16 bits
    a value, words = max(4, nextPow2(bits / 16) / 4))."""
    import struct

    import numpy as np

    capacity = max(min(num_bits, 4_194_304) // 16, 1)
    words = max(4, (1 << (capacity - 1).bit_length()) // 4)
    h = twang_mix64_np(values)
    mask = np.zeros(len(h), np.uint64)
    for shift in (0, 6, 12, 18):
        mask |= np.uint64(1) << ((h >> np.uint64(shift)) & np.uint64(63))
    idx = ((h >> np.uint64(24)) & np.uint64(words - 1)).astype(np.int64)
    out = np.zeros(words, np.uint64)
    np.bitwise_or.at(out, idx, mask)
    return struct.pack("<bi", 1, words) + out.astype("<u8").tobytes()


def spark_bloom_probe_np(data: bytes, values):
    import numpy as np

    words = np.frombuffer(data, dtype="<u8", offset=5)
    h = twang_mix64_np(values)
    mask = np.zeros(len(h), np.uint64)
    for shift in (0, 6, 12, 18):
        mask |= np.uint64(1) << ((h >> np.uint64(shift)) & np.uint64(63))
    idx = ((h >> np.uint64(24)) & np.uint64(len(words) - 1)).astype(np.int64)
    return (words[idx] & mask) == mask


_M32 = 0xFFFFFFFF


def _rotl32_np(x, r):
    import numpy as np

    return ((x << np.uint32(r)) | (x >> np.uint32(32 - r)))


def murmur3_np(words, seed, nbytes: int):
    """Spark's Murmur3_x86_32 of 4- or 8-byte little-endian words (a long is
    two 4-byte blocks, low first), uint32 seeds per row."""
    import numpy as np

    u = words.astype(np.int64).view(np.uint64)
    blocks = [(u & np.uint64(_M32)).astype(np.uint32)]
    if nbytes == 8:
        blocks.append((u >> np.uint64(32)).astype(np.uint32))
    h = np.broadcast_to(np.asarray(seed, np.uint32), u.shape).copy()
    with np.errstate(over="ignore"):
        for k in blocks:
            k = k * np.uint32(0xCC9E2D51)
            k = _rotl32_np(k, 15) * np.uint32(0x1B873593)
            h = _rotl32_np(h ^ k, 13) * np.uint32(5) + np.uint32(0xE6546B64)
        h = h ^ np.uint32(nbytes)
        h = h ^ (h >> np.uint32(16))
        h = h * np.uint32(0x85EBCA6B)
        h = h ^ (h >> np.uint32(13))
        h = h * np.uint32(0xC2B2AE35)
        return h ^ (h >> np.uint32(16))


_XXP = (0x9E3779B185EBCA87, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9,
        0x85EBCA77C2B2AE63, 0x27D4EB2F165667C5)


def xxhash64_np(words, seed, nbytes: int):
    """Spark's XXH64 of one 4- or 8-byte little-endian value (hashInt /
    hashLong), uint64 seeds per row."""
    import numpy as np

    p1, p2, p3, p4, p5 = (np.uint64(p) for p in _XXP)

    def rotl(x, r):
        return (x << np.uint64(r)) | (x >> np.uint64(64 - r))

    u = words.astype(np.int64).view(np.uint64)
    with np.errstate(over="ignore"):
        h = np.asarray(seed, np.uint64) + p5 + np.uint64(nbytes)
        if nbytes == 8:
            h = h ^ (rotl(u * p2, 31) * p1)
            h = rotl(h, 27) * p1 + p4
        else:
            h = h ^ ((u & np.uint64(_M32)) * p1)
            h = rotl(h, 23) * p2 + p3
        h = h ^ (h >> np.uint64(33))
        h = h * p2
        h = h ^ (h >> np.uint64(29))
        h = h * p3
        return h ^ (h >> np.uint64(32))


def rand_np(seed: int, index):
    """Spark rand(seed) as this engine defines it: splitmix64 of (seed,
    global row index), the top 53 bits over 2^53."""
    import numpy as np

    with np.errstate(over="ignore"):
        z = index.astype(np.uint64) * _u64(0x9E3779B97F4A7C15) + _u64(seed)
        z = (z ^ (z >> np.uint64(30))) * _u64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * _u64(0x94D049BB133111EB)
        z = z ^ (z >> np.uint64(31))
    return (z >> np.uint64(11)).astype(np.float64) * (1.0 / (1 << 53))


def _group_reduce(values, order, starts, op):
    """Per-group min / max / sum of ``values`` over rows sorted by group
    (``order``), the groups starting at ``starts`` (every group has rows)."""
    import numpy as np

    fn = {"min": np.minimum, "max": np.maximum, "sum": np.add}[op]
    return fn.reduceat(values[order], starts)


def _civil_np(days):
    """(first day of the month, days in the month) of int32 days, numpy."""
    import numpy as np

    d = days.astype("M8[D]")
    month = d.astype("M8[M]")
    first = month.astype("M8[D]")
    return month, first, ((month + 1).astype("M8[D]") - first).astype(np.int64)


def _result_by_key(result, key: str):
    """{key value: {column: value}} of a result Table (strings decoded)."""
    import numpy as np

    cols = {}
    for name in result.schema.names:
        values = np.asarray(result.columns[name])
        if name in result.string_tables:
            values = result.string_tables[name].decode(values)
        cols[name] = values
    keys = cols[key]
    return {(k.item() if hasattr(k, "item") else k): {c: v[i] for c, v in cols.items()}
            for i, k in enumerate(keys)}


def check_spark(name: str, result, tables, ex, extra):
    """Hold a ``SPARK_SQL`` / ``spark_plan`` result against its numpy oracle;
    returns the fields the line prints (the sketches' errors beside their
    bounds).  ``extra`` holds what B1's two queries measured."""
    import numpy as np

    if name in ("H1", "H2"):
        li = tables["lineitem"]
        if name == "H1":
            words = small = _col(li, "l_partkey")
            gid, keys = _code_groups(li, "l_shipmode")
            keys = [k[0] for k in keys]
        else:
            # distinct doubles of price / 100 are the distinct unscaled prices
            small = _col(li, "l_extendedprice")
            words = (small.astype(np.float64) / 100).view(np.int64)
            gid, keys = np.zeros(li.num_rows, np.int64), [None]
        want, live = hll_oracle(words, gid, len(keys))
        # exact distinct counts by presence marks (the words are small keys)
        base = small - small.min()
        seen = np.zeros((len(keys), int(base.max()) + 1), bool)
        seen[gid, base] = True
        exact_all = seen.sum(axis=1)
        got = (_result_by_key(result, "l_shipmode") if name == "H1"
               else {None: {"d": np.asarray(result.columns["d"])[0]}})
        assert sorted(map(repr, got)) == sorted(map(repr, keys)), (list(got), keys)
        exact, rel = [], []
        for g, key in enumerate(keys):
            d = int(got[key]["d"])
            assert d == want[g], (name, key, d, want[g])
            n = int(exact_all[g])
            exact.append(n)
            rel.append(abs(d - n) / n)
        assert max(rel) <= HLL_TOLERANCE, rel
        return dict(estimates=want, exact_distinct=exact, relative_error=rel,
                    error_bound=HLL_TOLERANCE, live_registers=live)
    if name in ("P1", "P2"):
        li = tables["lineitem"]
        key = "l_returnflag" if name == "P1" else "l_shipmode"
        p = 0.5 if name == "P1" else 0.9
        out = "med" if name == "P1" else "q"
        price = np.asarray(li.columns["l_extendedprice"]).astype(np.float64) / 100
        gid, keys = _code_groups(li, key)
        got = _result_by_key(result, key)
        assert len(got) == len(keys), (list(got), keys)
        errs = []
        for g, (k,) in enumerate(keys):
            v = price[gid == g]
            est, n = float(got[k][out]), len(v)
            if name == "P1":
                # the estimate's rank in its group within p +- 2/256 of its size
                lo, hi = int((v < est).sum()), int((v <= est).sum()) - 1
                target = np.floor(p * n)
                dist = max(lo - target, target - hi, 0) / n
                assert dist <= 2.0 / KLL_POINTS, (k, est, dist)
                errs.append(float(dist))
            else:
                # the rank rule of the DDSketch finisher: element floor(p * n)
                rank = min(n - 1, int(np.floor(p * n)))
                exact = np.partition(v, rank)[rank]
                rel = abs(est - exact) / exact
                assert rel <= DD_BOUND * (1 + 1e-9), (k, est, exact, rel)  # + rounding
                errs.append(rel)
        return dict(errors=errs, error_bound=2.0 / KLL_POINTS if name == "P1" else DD_BOUND)
    if name == "B1":
        orders, li = tables["orders"], tables["lineitem"]
        keys = _col(orders, "o_orderkey")[np.asarray(orders.columns["o_orderdate"]) < _days("1993-01-01")]
        want = spark_bloom_np(keys)
        assert extra["filter"] == want, "bloom filter bytes"
        lkeys = _col(li, "l_orderkey")
        hits = spark_bloom_probe_np(want, lkeys)
        in_build = np.zeros(int(max(lkeys.max(), keys.max())) + 1, bool)
        in_build[keys] = True
        member = in_build[lkeys]
        assert hits[member].all(), "a false negative"
        n = int(np.asarray(result.columns["n"])[0])
        assert n == int(hits.sum()), (n, int(hits.sum()))
        fp = int((hits & ~member).sum())
        return dict(build_keys=int(len(keys)), filter_bytes=len(want), rows_passing=n,
                    rows_in_build_set=int(member.sum()),
                    false_positive_rate=fp / max(1, int((~member).sum())))
    if name == "X1":
        li = tables["lineitem"]
        ok, pk, sk = _col(li, "l_orderkey"), _col(li, "l_partkey"), _col(li, "l_suppkey")
        ln = _col(li, "l_linenumber")
        ship, receipt = _col(li, "l_shipdate"), _col(li, "l_receiptdate")
        # add_months / last_day over the few distinct days, then gathered
        first_day = int(ship.min())
        days = np.arange(first_day, int(ship.max()) + 1)
        month, first, dim = _civil_np(days)
        nmonth, nfirst, ndim = _civil_np((month + 1).astype("M8[D]").astype(np.int64))
        am_of = nfirst.astype(np.int64) + np.minimum(days - first.astype(np.int64), ndim - 1)
        ld_of = first.astype(np.int64) + dim - 1
        ops = {"h": "min", "x": "max", "dd": "max", "am": "min", "ld": "max", "sl": "sum",
               "r0": "min", "r1": "max"}
        combine = {"min": np.minimum, "max": np.maximum, "sum": np.add}
        want = {"n": np.bincount(ok % 7, minlength=7)}
        # in chunks of rows that stay in the caches, each reduced by group
        for lo in range(0, li.num_rows, ORACLE_CHUNK):
            part = slice(lo, lo + ORACLE_CHUNK)
            gid = ok[part] % 7
            order, starts, present = _groups(gid)
            assert len(present) == 7  # every group in every chunk
            r = rand_np(42, np.arange(lo, lo + len(gid), dtype=np.int64))
            values = {
                "h": murmur3_np(sk[part], murmur3_np(pk[part], np.uint32(42), 8), 8).view(np.int32),
                "x": xxhash64_np(ln[part], xxhash64_np(ok[part], np.uint64(42), 8), 4).view(np.int64),
                "dd": receipt[part] - ship[part],
                "am": am_of[ship[part] - first_day], "ld": ld_of[ship[part] - first_day],
                "sl": ln[part] << 3, "r0": r, "r1": r,
            }
            for col, op in ops.items():
                reduced = _group_reduce(values[col], order, starts, op)
                want[col] = reduced if col not in want else combine[op](want[col], reduced)
        got = _result_by_key(result, "b")
        assert sorted(got) == list(range(7)), list(got)
        for col, values in want.items():
            for b in range(7):
                assert got[b][col] == values[b], (col, b, got[b][col], values[b])
        return dict(groups=7, rand_rows=int(li.num_rows))
    if name == "X2":
        import zlib

        part = tables["part"]

        def per_entry(col, fn, dtype):
            values = part.string_tables[col].values()
            return np.asarray([fn(v) for v in values], dtype)[np.asarray(part.columns[col])]

        word = per_entry("p_type", lambda v: v.split(" ")[0], object)
        crc = per_entry("p_name", lambda v: zlib.crc32(v.encode()), np.int64)
        instr = per_entry("p_name", lambda v: v.find("green") + 1, np.int64)
        lev = per_entry("p_brand", lambda v: _levenshtein_py(v, "Brand#11"), np.int64)
        words = sorted(set(word))
        gid = np.searchsorted(np.asarray(words, object), word)
        got = _result_by_key(result, "t")
        assert sorted(got) == words, (list(got), words)
        for g, w in enumerate(words):
            m = gid == g
            row = got[w]
            assert (row["n"], row["c"], row["i"], row["lv"]) == (
                int(m.sum()), int(crc[m].max()), int(instr[m].sum()), int(lev[m].max())), (w, row)
        return dict(groups=len(words), name_entries=len(part.string_tables["p_name"].values()))
    assert name == "X3", name
    ps = tables["partsupp"]
    pk, sk, aq = _col(ps, "ps_partkey"), _col(ps, "ps_suppkey"), _col(ps, "ps_availqty")
    order, starts, keys = _groups(pk)
    sizes = np.diff(np.append(starts, len(pk)))
    rorder = _by_key(result, "ps_partkey")
    assert np.array_equal(np.asarray(result.columns["ps_partkey"])[rorder], keys)
    smallest = np.minimum.reduceat(sk[order], starts)
    for col in ("f", "la"):  # first / last: the reference's arbitrary, the smallest
        assert np.array_equal(np.asarray(result.columns[col]).astype(np.int64)[rorder], smallest), col
    lists, sets = result.columns["cl"], result.columns["cs"]

    def flat(seg):
        """(sizes, elements) of an ARRAY column, its rows in key order."""
        lens = np.asarray(seg.sizes).astype(np.int64)
        offs = np.concatenate([[0], np.cumsum(lens)[:-1]])
        vals = np.asarray(seg.children[0]).astype(np.int64)
        lens_k = lens[rorder]
        out_starts = np.cumsum(lens_k) - lens_k
        pos = np.repeat(offs[rorder] - out_starts, lens_k) + np.arange(int(lens_k.sum()))
        return lens_k, vals[pos]

    lens, vals = flat(lists)
    assert np.array_equal(lens, sizes) and np.array_equal(vals, sk[order]), "collect_list"
    uniq = np.lexsort((aq[order], pk[order]))
    a_sorted, p_sorted = aq[order][uniq], pk[order][uniq]
    keep = np.ones(len(a_sorted), bool)
    keep[1:] = (a_sorted[1:] != a_sorted[:-1]) | (p_sorted[1:] != p_sorted[:-1])
    lens, vals = flat(sets)
    assert np.array_equal(lens, np.bincount(np.searchsorted(keys, p_sorted[keep]),
                                            minlength=len(keys)))
    # set order inside a row is not specified: compare each row sorted
    got_sorted = vals[np.lexsort((vals, np.repeat(np.arange(len(lens)), lens)))]
    assert np.array_equal(got_sorted, a_sorted[keep]), "collect_set"
    return dict(groups=int(len(keys)), list_elements=int(len(sk)), set_elements=int(keep.sum()))


def _agg_call_names(node, out=None):
    """The aggregate call names of a plan tree."""
    out = set() if out is None else out
    for c in getattr(node, "aggregates", ()):
        out.add(c.name)
    for s in getattr(node, "sources", ()):
        _agg_call_names(s, out)
    return out


def run_spark_text(name: str, cache, tile_rows: int):
    """One text of the sketch / Spark slice over the tables of ``cache``, as a
    caller of ``run_sql`` waits for it (B1: its build text, the filter
    fetched, then its probe text with the filter as a literal), held against
    its oracle on the first run, whose time is ``query_ms`` as in
    ``run_slice_text``.  Asserts the path the text is there for."""
    import torch

    from velox_tpu_torch.exec.runner import LocalExecutor
    from velox_tpu_torch.plan import PlanBuilder
    from velox_tpu_torch.sql import plan_sql
    from velox_tpu_torch.utils.spark_bloom import probe_uploads

    tables = {t: cache.table(t).select(list(c)) for t, c in SPARK_COLUMNS[name].items()}
    t0 = time.perf_counter()
    if name in SPARK_SQL:
        plan = plan_sql(SPARK_SQL[name], tables)
    else:
        plan = spark_plan(name, PlanBuilder, tables)
    plan_s = time.perf_counter() - t0
    config = spark_config(name)
    extra = {}

    def once():
        ex = LocalExecutor(plan, tile_rows=tile_rows, config=config, device=DEVICE)
        result = ex.run()
        if name != "B1":
            return [ex], result
        data = result.to_pandas()["bf"][0]  # VARBINARY rides as a dictionary code
        t1 = time.perf_counter()
        probe_plan = plan_sql(B1_PROBE.format(hex=data.hex()), {"lineitem": tables["lineitem"]})
        extra.update(filter=data, probe_plan_s=time.perf_counter() - t1)
        probe = LocalExecutor(probe_plan, tile_rows=tile_rows, device=DEVICE)
        return [ex, probe], probe.run()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    exs, result = once()
    walls = [(time.perf_counter() - t0) * 1e3]
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    check = check_spark(name, result, tables, exs[0], extra)
    oracle_s = time.perf_counter() - t0
    ex = exs[-1]
    # the path the text is there for
    names = set()
    for e in exs:
        names |= _agg_call_names(e.root)
    assert not names & {"approx_distinct", "approx_percentile", "bloom_filter_agg"}, names
    path = {}
    if name in ("H1", "H2"):
        registers = [a["groups_out"] for a in aggregation_report(ex)
                     if a["groups_out"] is not None and a["groups_out"] > 7]
        ngroups = 7 if name == "H1" else 1
        assert registers and max(registers) <= ngroups * HLL_REGISTERS, aggregation_report(ex)
        path = dict(register_rows=max(registers), register_rows_bound=ngroups * HLL_REGISTERS)
    elif name == "P1":
        assert "__kll_quantile" in names and ex.window_chunks, names
    elif name == "P2":
        assert "__dd_quantile" in names and "__kll_quantile" not in names, names
    elif name == "B1":
        probes = [f for f in _call_names(exs[1].root) if f.startswith("__bloom_probe_")]
        assert "__bloom_assemble" in names and len(probes) == 1, (names, probes)
        path = dict(probe_function=probes[0], probe_plan_s=extra["probe_plan_s"],
                    literal_chars=len(extra["filter"]) * 2)
    elif name == "X1":
        tiles = -(-tables["lineitem"].num_rows // tile_rows)
        assert tiles > 1, tiles  # rand(42) over the global row index of every tile
        path = dict(tiles=tiles)
    elif name == "X2":
        # the string functions were evaluated once per dictionary entry while
        # the text was planned: no call of them is left in the plan
        left = _call_names(plan) & {"substring_index", "crc32", "instr", "levenshtein"}
        assert not left, left
        path = dict(bound_at_planning_s=plan_s)
    elif name == "X3":
        assert "collect_agg" in [a["kind"] for a in aggregation_report(ex)], aggregation_report(ex)
    fields = dict(
        name=name, sf=cache.sf, tile_rows=tile_rows,
        rows_in={t: v.num_rows for t, v in tables.items()}, result_rows=result.num_rows,
        plan_s=plan_s, build_s=sum(e.build_seconds for e in exs), kind=ex.kind,
        window_passes=sum(len(e.window_chunks) for e in exs),
        window_largest_pass_rows=max((r for e in exs for _, r in e.window_chunks), default=0),
        aggregations=[a for e in exs for a in aggregation_report(e)],
        spilled_bytes=sum(unspilled(e) for e in exs),
        device_peak_bytes_first_run=peak, oracle_s=oracle_s, correct=True,
        check=check, path=path,
    )
    del exs, ex, result
    torch.cuda.empty_cache()
    fields.update(whole_query_timing(once, walls[0], timed=False))
    if name == "B1":
        # every run bound the same literal: its words went to the card once
        fields["path"]["probe_uploads"] = probe_uploads(fields["path"]["probe_function"])
        assert fields["path"]["probe_uploads"] == 1, fields["path"]
    return fields


def _call_names(node, out=None):
    """The scalar call names of a plan's project and filter expressions."""
    out = set() if out is None else out

    def walk(e):
        if hasattr(e, "name") and hasattr(e, "args"):
            out.add(e.name)
        for c in getattr(e, "children", ()) or ():
            walk(c)

    for e in getattr(node, "exprs", ()) or ():
        walk(e)
    if getattr(node, "filter", None) is not None:
        walk(node.filter)
    if getattr(node, "predicate", None) is not None:
        walk(node.predicate)
    for s in getattr(node, "sources", ()):
        _call_names(s, out)
    return out


# ---------------------------------------------------------------------------
# dbgen_golden: the port's dbgen (TPC's generator, bit for bit) at SF 1, the
# scale of the TPC-H specification's published validation answers, and the
# hand-built Q1, Q6 and Q3 plans held to those answers to the cent.  Q13
# depends on o_comment, whose text pool in the reference generator differs
# from classic dbgen's; its rows are pinned from the reference generator.

# TPC-H specification, validation answer set for SF 1: Q1 (returnflag,
# linestatus, sum_qty, sum_base_price, sum_disc_price, sum_charge,
# count_order)
Q1_GOLDEN = [
    ("A", "F", 37734107.00, 56586554400.73, 53758257134.87, 55909065222.83, 1478493),
    ("N", "F", 991417.00, 1487504710.38, 1413082168.05, 1469649223.19, 38854),
    ("N", "O", 74476040.00, 111701729697.74, 106118230307.61, 110367043872.50, 2920374),
    ("R", "F", 37719753.00, 56568041380.90, 53741292684.60, 55889619119.83, 1478870),
]
# TPC-H specification, validation answer for SF 1: Q6 revenue
Q6_GOLDEN = 123141078.23
# TPC-H specification, validation answer set for SF 1: Q3 (l_orderkey,
# revenue, o_orderdate, o_shippriority), top 10
Q3_GOLDEN = [
    (2456423, 406181.0111, "1995-03-05", 0), (3459808, 405838.6989, "1995-03-04", 0),
    (492164, 390324.0610, "1995-02-19", 0), (1188320, 384537.9359, "1995-03-09", 0),
    (2435712, 378673.0558, "1995-02-26", 0), (4878020, 378376.7952, "1995-03-12", 0),
    (5521732, 375153.9215, "1995-03-13", 0), (2628192, 373133.3094, "1995-02-22", 0),
    (993600, 371407.4595, "1995-03-05", 0), (2300070, 367371.1452, "1995-03-13", 0),
]
# Q13 (c_count, custdist) at SF 1, pinned from the reference generator's
# compiled output (velox/tpch/gen/dbgen with its 10 MB text pool)
Q13_GOLDEN = [
    (0, 50004), (10, 6668), (9, 6563), (11, 6004), (8, 5890), (12, 5600), (13, 5029),
    (19, 4805), (7, 4680), (18, 4531), (20, 4507), (14, 4473), (15, 4463), (17, 4445),
    (16, 4410), (21, 4168), (22, 3742), (6, 3273), (23, 3189), (24, 2700), (25, 2090),
    (5, 1957), (26, 1653), (27, 1177), (4, 1010), (28, 901), (29, 564), (3, 408),
    (30, 378), (31, 242), (32, 133), (2, 128), (33, 72), (34, 52), (35, 32), (36, 20),
    (1, 20), (37, 8), (38, 4), (41, 3), (40, 3), (39, 1),
]
# dbgen_golden's tiles: SF-1 lineitem is two of them
DBGEN_TILE_ROWS = 1 << 22
DBGEN_LINEITEM = ["l_orderkey", "l_quantity", "l_extendedprice", "l_discount", "l_tax",
                  "l_returnflag", "l_linestatus", "l_shipdate"]


def dbgen_tables(sf: float):
    """The port's dbgen tables the golden queries read, and the seconds each
    took to generate (orders and lineitem share one generation)."""
    from velox_tpu_torch.connectors.tpch import dbgen

    seconds = {}
    t0 = time.perf_counter()
    raw = dbgen.gen_orders_lineitem(sf)
    seconds["orders_lineitem_numeric"] = time.perf_counter() - t0
    out = {}
    for name, cols in (("lineitem", DBGEN_LINEITEM),
                       ("orders", ["o_orderkey", "o_custkey", "o_orderdate", "o_shippriority",
                                   "o_comment"]),
                       ("customer", ["c_custkey", "c_mktsegment"])):
        t0 = time.perf_counter()
        out[name] = dbgen.table(name, sf, cols, raw_orders_lineitem=raw)
        seconds[name] = time.perf_counter() - t0
    return out, seconds


def golden_rows(num: int, result):
    """A golden query's result as the published answer's rows: Q1 sorted by
    its flags with the sums to the cent, Q6 its revenue to the cent, Q3 its
    rows with revenue to 1e-4 and the date as text, Q13 its rows."""
    import numpy as np

    df = result.to_pandas()
    if num == 1:
        df = df.sort_values(["l_returnflag", "l_linestatus"]).reset_index(drop=True)
        return [(r.l_returnflag, r.l_linestatus, round(float(r.sum_qty), 2),
                 round(float(r.sum_base_price), 2), round(float(r.sum_disc_price), 2),
                 round(float(r.sum_charge), 2), int(r.count_order)) for r in df.itertuples()]
    if num == 6:
        return round(float(df["revenue"][0]), 2)
    if num == 3:
        dates = np.datetime_as_string(
            np.asarray(df["o_orderdate"]).astype(np.int64).astype("M8[D]"), unit="D")
        return [(int(r.l_orderkey), round(float(r.revenue), 4), str(d), int(r.o_shippriority))
                for r, d in zip(df.itertuples(), dates)]
    return [(int(r.c_count), int(r.custdist)) for r in df.itertuples()]


GOLDEN = {1: Q1_GOLDEN, 6: Q6_GOLDEN, 3: Q3_GOLDEN, 13: Q13_GOLDEN}


def golden_plan(num: int, tables):
    from velox_tpu_torch.connectors.tpch.plans import build_q1, build_q3, build_q6, build_q13

    li = tables["lineitem"]
    if num == 1:
        return build_q1(li)
    if num == 6:
        return build_q6(li)
    if num == 3:
        return build_q3(tables["customer"], tables["orders"], li)
    return build_q13(tables["customer"], tables["orders"])


def run_dbgen_golden(sf: float, tile_rows: int, device=None):
    """Generate the dbgen tables, run Q1, Q6, Q3 and Q13 through
    ``LocalExecutor`` on ``device`` (None: the script's) and hold each to its
    published answer; returns the line's fields (the generation seconds, each
    query's seconds, Q1's grouped_piece_sums launches and piece path)."""
    from velox_tpu_torch.exec.runner import LocalExecutor
    from velox_tpu_torch.ops.group_piece import grouped_piece_sums

    t0 = time.perf_counter()
    tables, seconds = dbgen_tables(sf)
    fields = dict(sf=sf, tile_rows=tile_rows, generate_s=time.perf_counter() - t0,
                  generate_parts_s=seconds,
                  rows={k: v.num_rows for k, v in tables.items()})
    if sf == 1.0:
        assert tables["lineitem"].num_rows == 6_001_215, tables["lineitem"].num_rows
        assert tables["orders"].num_rows == 1_500_000
    for num in (1, 6, 3, 13):
        before = grouped_piece_sums.launches
        t0 = time.perf_counter()
        ex = LocalExecutor(golden_plan(num, tables), tile_rows=tile_rows,
                           device=device or DEVICE)
        result = ex.run()
        fields[f"q{num}_s"] = time.perf_counter() - t0
        if sf == 1.0:
            got = golden_rows(num, result)
            assert got == GOLDEN[num], (num, got, GOLDEN[num])
        if num == 1:
            fields["q1_piece_path"] = bool(ex.use_piece)
            fields["q1_k2_launches"] = grouped_piece_sums.launches - before
        fields[f"q{num}_result_rows"] = result.num_rows
    fields["correct"] = sf == 1.0
    return fields


# ---------------------------------------------------------------------------
# The files / host-formats slice (``files_io``): a Hive dataset written and
# read back at ``--sf`` (I1-I3), parquet row-group pruning (I4), Arrow streams
# (I5), the page and row serde and the vector saver (I6) and SEQUENCE / BIAS
# columns from the fuzzer (I7).  Each line's ``correct`` is held against the
# generated tables or a numpy oracle over them.

Q6_FILTER = (
    "l_shipdate >= date '1994-01-01' "
    "and l_shipdate < date '1994-01-01' + interval '365' day "
    "and l_discount between 0.05 and 0.07 and l_quantity < 24"
)
DAY_1995 = 9131  # 1995-01-01 in days since 1970-01-01
FUZZ_EXPRS = [
    # tests/test_fuzz.py:19-30
    "c0 + c1", "c0 * 2 - c1", "c0 < c1", "c0 = c1 or c0 > 100", "if(c0 < c1, c0, c1)",
    "coalesce(c0, c1)", "try(c0 / c1)", "c0 is null",
    "case when c0 < 0 then 0 - c0 else c0 end", "abs(c0) + abs(c1)",
]
FUZZ_SEED = 20260  # the first of the seeds I7 draws its batches from
# I6's page holds the first 2^22 ``orders`` rows: all 15 M at SF 10 took 15 s
# with an H100 (zlib at level 1 on the host, 65 MB/s), in a script that passed
# its 1 200 s on another host
SERDE_PAGE_ROWS = 1 << 22


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _timed(fn, device):
    """(result, seconds) of fn(), the device drained before and after."""
    _sync(device)
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return out, time.perf_counter() - t0


def _years(days):
    import numpy as np

    return np.asarray(days).astype("M8[D]").astype("M8[Y]").astype(np.int64) + 1970


def q6_unscaled(lineitem) -> int:
    """TPC-H Q6's revenue as an unscaled DECIMAL(18, 4) integer, in numpy."""
    import numpy as np

    c = lineitem.columns
    keep = ((c["l_shipdate"] >= 8766) & (c["l_shipdate"] < DAY_1995) & (c["l_discount"] >= 5)
            & (c["l_discount"] <= 7) & (c["l_quantity"] < 2400))
    return int(np.sum(c["l_extendedprice"][keep].astype(np.int64)
                      * c["l_discount"][keep].astype(np.int64)))


def tables_equal(got, want) -> bool:
    """Same names, types, columns (strings by text), validity."""
    import numpy as np

    if list(got.schema.names) != list(want.schema.names) or \
            [str(t) for t in got.schema.types] != [str(t) for t in want.schema.types]:
        return False
    for name, t in zip(want.schema.names, want.schema.types):
        g, w = np.asarray(got.columns[name]), np.asarray(want.columns[name])
        if t.is_string:
            g, w = got.string_tables[name].decode(g), want.string_tables[name].decode(w)
        gv, wv = got.validities.get(name), want.validities.get(name)
        if g.shape != w.shape or not np.array_equal(g, w):
            return False
        if (gv is None) != (wv is None) or (gv is not None and not np.array_equal(gv, wv)):
            return False
    return True


def files_io_write(cache, tile_rows: int, device, root: str):
    """I1: a Hive INSERT of ``lineitem``'s Q1 columns partitioned by ship
    year, through the plan's TableWrite."""
    import os

    import numpy as np
    import pyarrow.parquet as pq

    import velox_tpu_torch as vtt
    from velox_tpu_torch.connectors.hive import _partition_rows
    from velox_tpu_torch.connectors.tpch.queries import Q1_COLUMNS
    from velox_tpu_torch.exec.runner import LocalExecutor
    from velox_tpu_torch.io.table import Table
    from velox_tpu_torch.plan import PlanBuilder

    lineitem = cache.table("lineitem").select(Q1_COLUMNS)
    plan = (
        PlanBuilder().table_scan(lineitem)
        .project([*Q1_COLUMNS, "year(l_shipdate) as l_shipyear"])
        .table_write(root, partition_by=["l_shipyear"]).build()
    )
    result, write_s = _timed(
        lambda: LocalExecutor(plan, tile_rows=tile_rows, device=device).run(), device)
    shipyear = _years(lineitem.columns["l_shipdate"])
    years, counts = np.unique(shipyear, return_counts=True)
    # the partition split alone, over the same key column on the host
    keys = Table(vtt.RowType(["l_shipyear"], [vtt.BIGINT]), {"l_shipyear": shipyear})
    t0 = time.perf_counter()
    split = _partition_rows(keys, ["l_shipyear"])
    split_s = time.perf_counter() - t0
    dirs = sorted(os.listdir(root))
    files = {}
    for d in dirs:
        [name] = os.listdir(os.path.join(root, d))
        files[d] = pq.ParquetFile(os.path.join(root, d, name)).metadata.num_rows
    want = {f"l_shipyear={y}": int(c) for y, c in zip(years, counts)}
    split_ok = [v for v, _ in split] == [(str(y),) for y in years] and all(
        np.array_equal(rows, np.flatnonzero(shipyear == y)) for (_, rows), y in zip(split, years))
    correct = (int(result.columns["rows"][0]) == lineitem.num_rows and files == want
               and dirs == [f"l_shipyear={y}" for y in range(1992, 1999)] and split_ok)
    disk = sum(os.path.getsize(os.path.join(dp, f)) for dp, _, fs in os.walk(root) for f in fs)
    return dict(line="I1", path="vectorized partition split (connectors/hive _partition_rows)",
                rows=lineitem.num_rows, files=len(files), rows_per_file=files,
                bytes_on_disk=disk, write_s=write_s, split_s=split_s, correct=correct)


def _hive_read(root: str, columns, partition_filter=None):
    from velox_tpu_torch.connectors.hive import HiveDataSource, _discover

    src = HiveDataSource(columns=columns, partition_filter=partition_filter)
    splits = _discover(root)
    for split in splits:
        src.add_split(split)
    return src.to_table(), len(src.splits), len(splits)


def files_io_q1(root: str, tile_rows: int, runs: int, device, want, wrappers):
    """I2: Q1 over the dataset, read cold and then warm through the data
    cache; the first run on the card launches grouped_piece_sums once a tile
    (the counts set to 0 just before it and read just after)."""
    import statistics

    from velox_tpu_torch.connectors.tpch.plans import build_q1
    from velox_tpu_torch.connectors.tpch.queries import Q1_COLUMNS
    from velox_tpu_torch.exec.runner import LocalExecutor
    from velox_tpu_torch.io.cache import DEFAULT_CACHE

    DEFAULT_CACHE.clear()
    reads = {}
    for kind in ("cold", "warm"):
        before = (DEFAULT_CACHE.hits, DEFAULT_CACHE.misses, DEFAULT_CACHE.loads)
        (table, read, found), seconds = _timed(lambda: _hive_read(root, Q1_COLUMNS), "cpu")
        reads[kind] = dict(read_s=seconds, splits_read=read, splits=found,
                           hits=DEFAULT_CACHE.hits - before[0],
                           misses=DEFAULT_CACHE.misses - before[1],
                           files_decoded=DEFAULT_CACHE.loads - before[2])
    ex = LocalExecutor(build_q1(table), tile_rows=tile_rows, device=device)
    tiles, upload_s = _timed(ex.device_tiles, device)
    for w in wrappers.values():
        w.launches = 0
    result = ex.run(prefetched_tiles=tiles)
    launches = {name: w.launches for name, w in wrappers.items()}
    _, want = check_frame(1, result, None, want=want)
    walls = []
    for _ in range(runs):
        walls.append(_timed(lambda: ex.run(prefetched_tiles=tiles), device)[1] * 1e3)
    cold, warm = reads["cold"], reads["warm"]
    # a cold read decodes every file once (the splits' prefetches, which the
    # reads join in flight); a warm read decodes none
    cache_ok = (cold["files_decoded"] == cold["splits"] and cold["hits"] + cold["misses"]
                == cold["splits"] and warm["hits"] == warm["splits"] and warm["misses"] == 0
                and warm["files_decoded"] == 0)
    on_card = str(device).startswith("cuda")
    k2_ok = launches["grouped_piece_sums"] == len(tiles) if on_card else True
    assert ex.use_piece and cache_ok and k2_ok, (ex.use_piece, reads, launches, len(tiles))
    fields = dict(line="I2", path="Q1 over the Hive dataset, piece path (K2 once a tile)",
                  rows=table.num_rows, tiles=len(tiles), piece_path=ex.use_piece,
                  launches=launches, cold=cold, warm=warm, upload_s=upload_s,
                  query_ms=statistics.median(walls), runs_ms=walls, correct=True)
    return fields, result, table, tiles


def files_io_q6(root: str, tile_rows: int, device, want_unscaled: int):
    """I3: Q6 over the 1994 partition only."""
    from velox_tpu_torch.connectors.tpch.plans import build_q6
    from velox_tpu_torch.connectors.tpch.queries import Q6_COLUMNS
    from velox_tpu_torch.exec.runner import LocalExecutor

    (table, read, found), read_s = _timed(
        lambda: _hive_read(root, Q6_COLUMNS, lambda keys: keys["l_shipyear"] == "1994"), "cpu")
    ex = LocalExecutor(build_q6(table), tile_rows=tile_rows, device=device)
    result, query_s = _timed(ex.run, device)
    got = int(result.columns["revenue"][0])
    assert read == 1 and found == 7, (read, found)
    return dict(line="I3", path="partition filter: 1 of 7 splits read", splits_read=read,
                splits=found, rows=table.num_rows, read_s=read_s, query_ms=query_s * 1e3,
                revenue_unscaled=got, correct=got == want_unscaled)


def files_io_pruning(cache, tile_rows: int, device, root: str):
    """I4: ``orders`` sorted by date and written as one file; a load with a
    1995 date range decodes only the row groups whose statistics overlap it."""
    import math
    import os

    import numpy as np
    import pyarrow.parquet as pq

    from velox_tpu_torch.exec.runner import LocalExecutor
    from velox_tpu_torch.io.table import Table, _row_group_may_match
    from velox_tpu_torch.plan import PlanBuilder

    cols = ["o_orderkey", "o_custkey", "o_totalprice", "o_orderdate", "o_orderpriority"]
    orders = cache.table("orders").select(cols)
    plan = PlanBuilder().table_scan(orders).orderby(["o_orderdate"]).table_write(root).build()
    out, write_s = _timed(lambda: LocalExecutor(plan, tile_rows=tile_rows, device=device).run(),
                          device)
    [name] = os.listdir(root)
    path = os.path.join(root, name)
    lo, hi = DAY_1995, DAY_1995 + 364
    meta = pq.ParquetFile(path).metadata
    date_col = meta.schema.names.index("o_orderdate")
    groups, overlap = [], []
    for i in range(meta.num_row_groups):
        rg = meta.row_group(i)
        st = rg.column(date_col).statistics
        groups.append(rg.num_rows)
        overlap.append(bool(st.max >= lo and st.min <= hi))
        assert overlap[-1] == _row_group_may_match(rg, {"o_orderdate": (lo, hi)})
    loaded, read_s = _timed(
        lambda: Table.load_parquet(path, ranges={"o_orderdate": (lo, hi)}), "cpu")
    d = orders.columns["o_orderdate"]
    in_1995 = (d >= lo) & (d <= hi)
    n_1995 = int(in_1995.sum())
    want = (n_1995, int(orders.columns["o_totalprice"][in_1995].astype(np.int64).sum()))
    agg = (
        PlanBuilder()
        .table_scan(loaded, filter="o_orderdate between date '1995-01-01' and date '1995-12-31'")
        .aggregation([], ["count(*) as n", "sum(o_totalprice) as s"]).build()
    )
    res, query_s = _timed(lambda: LocalExecutor(agg, tile_rows=tile_rows, device=device).run(),
                          device)
    got = (int(res.columns["n"][0]), int(res.columns["s"][0]))
    read_groups = sum(overlap)
    bound = math.ceil(n_1995 / max(groups)) + 1
    # (a file of one or two groups, as at SF 0.01, has nothing to prune)
    assert read_groups <= bound and (read_groups < len(groups) / 2 or len(groups) <= 2), (
        read_groups, bound, groups)
    assert loaded.num_rows == sum(g for g, o in zip(groups, overlap) if o)
    return dict(line="I4", path="row groups pruned by statistics (_row_group_may_match)",
                rows=orders.num_rows, rows_written=int(out.columns["rows"][0]),
                row_groups=len(groups), rows_per_group=max(groups), groups_read=read_groups,
                groups_bound=bound, rows_loaded=loaded.num_rows, rows_1995=n_1995,
                write_s=write_s, read_s=read_s, query_ms=query_s * 1e3,
                count_sum=list(got), correct=got == want)


def files_io_arrow(cache, tile_rows: int, device, q6_want: int, q1_result):
    """I5: Q6 over an Arrow RecordBatchReader of 2^20-row batches through
    ``PlanBuilder.arrow_stream``, and Q1's result through the Arrow PyCapsule
    stream and back."""
    import pyarrow as pa

    from velox_tpu_torch.connectors.tpch.queries import Q6_COLUMNS
    from velox_tpu_torch.exec.runner import LocalExecutor
    from velox_tpu_torch.io.table import Table
    from velox_tpu_torch.plan import ArrowStreamNode, PlanBuilder

    arrow, export_s = _timed(lambda: cache.table("lineitem").select(Q6_COLUMNS).to_arrow(), "cpu")
    batches = arrow.to_batches(1 << 20)
    reader = pa.RecordBatchReader.from_batches(arrow.schema, batches)
    plan, ingest_s = _timed(lambda: (
        PlanBuilder().arrow_stream(reader).filter(Q6_FILTER)
        .aggregation([], ["sum(l_extendedprice * l_discount) as revenue"]).build()), "cpu")
    ex = LocalExecutor(plan, tile_rows=tile_rows, device=device)
    assert isinstance(ex.lin.source, ArrowStreamNode), type(ex.lin.source)
    result, query_s = _timed(ex.run, device)
    got = int(result.columns["revenue"][0])
    back = Table.from_arrow(pa.table(q1_result))  # through __arrow_c_stream__
    return dict(line="I5", path="ArrowStreamNode as the scan source", batches=len(batches),
                rows=arrow.num_rows, export_s=export_s,
                ingest_s=ingest_s, query_ms=query_s * 1e3, revenue_unscaled=got,
                q1_roundtrip=tables_equal(back, q1_result),
                correct=got == q6_want and tables_equal(back, q1_result))


def files_io_serde(cache, tile_rows: int, device, tile, workdir: str, row_count: int):
    """I6: every ``orders`` row fetched from the card, a page of its first
    ``SERDE_PAGE_ROWS`` rows (compressed and not), UnsafeRow and CompactRow
    over its first ``row_count`` rows, and one device tile through the vector
    saver."""
    import os

    import torch

    from velox_tpu_torch import native
    from velox_tpu_torch.exec.runner import LocalExecutor
    from velox_tpu_torch.io.table import Table
    from velox_tpu_torch.plan import PlanBuilder
    from velox_tpu_torch.serde import (
        decode_compactrow,
        decode_unsaferow,
        deserialize_page,
        encode_compactrow,
        encode_unsaferow,
        serialize_page,
    )
    from velox_tpu_torch.vector.saver import load_batch, save_batch

    cols = ["o_orderkey", "o_custkey", "o_totalprice", "o_orderdate", "o_orderpriority"]
    orders = cache.table("orders").select(cols)
    plan = PlanBuilder().table_scan(orders).project(cols).build()
    fetched = LocalExecutor(plan, tile_rows=tile_rows, device=device).run()
    fields = dict(line="I6", path="native codecs loaded", native=native.available(),
                  rows=fetched.num_rows)
    ok = native.available() and tables_equal(fetched, orders)
    def head_of(n):
        return Table(fetched.schema, {k: v[:n] for k, v in fetched.columns.items()},
                     fetched.string_tables)

    paged = head_of(min(SERDE_PAGE_ROWS, fetched.num_rows))
    raw_mb = sum(a.nbytes for a in paged.columns.values()) / 1e6
    for compress in (False, True):
        page, ser_s = _timed(lambda: serialize_page(paged, compress=compress), "cpu")
        back, de_s = _timed(lambda: deserialize_page(page), "cpu")
        ok = ok and tables_equal(back, paged)
        key = "zlib" if compress else "plain"
        fields[key] = dict(rows=paged.num_rows, page_mb=len(page) / 1e6, serialize_s=ser_s,
                           deserialize_s=de_s, serialize_mb_per_s=raw_mb / ser_s,
                           deserialize_mb_per_s=raw_mb / de_s)
    n = min(row_count, fetched.num_rows)
    head = head_of(n)
    for name, enc, dec in (("unsaferow", encode_unsaferow, decode_unsaferow),
                           ("compactrow", encode_compactrow, decode_compactrow)):
        rows, enc_s = _timed(lambda: enc(head), "cpu")
        back, dec_s = _timed(lambda: dec(rows, head.schema), "cpu")
        ok = ok and tables_equal(back, head)
        fields[name] = dict(rows=n, bytes=sum(map(len, rows)), encode_s=enc_s, decode_s=dec_s)
    path = os.path.join(workdir, "tile.vxpg")
    _, save_s = _timed(lambda: save_batch(tile, path), device)
    loaded, load_s = _timed(lambda: load_batch(path, capacity=tile.capacity, device=device),
                            device)
    same = int(loaded.length) == int(tile.length)
    for a, b in zip(loaded.columns, tile.columns):
        va, ma = a.decode(tile.capacity)
        vb, mb = b.decode(tile.capacity)
        live = torch.arange(tile.capacity, device=va.device) < tile.length
        same = same and torch.equal(va[live], vb[live]) and (ma is None) == (mb is None)
        if a.strings is not None:
            same = same and a.strings.values() == b.strings.values()
    fields["saver"] = dict(rows=int(tile.length), file_mb=os.path.getsize(path) / 1e6,
                           save_s=save_s, load_s=load_s, equal=same)
    fields["correct"] = bool(ok and same)
    return fields


def files_io_encodings(rows: int, device, runs: int):
    """I7: fuzzed BIGINT batches of ``rows`` rows with SEQUENCE and BIAS
    columns on the device, through ExprSet beside their flat copies."""
    import torch

    import velox_tpu_torch as vtt
    from velox_tpu_torch.expr.compiler import ExprSet
    from velox_tpu_torch.expr.parser import parse_expr
    from velox_tpu_torch.vector.column import Batch, Encoding
    from velox_tpu_torch.vector.fuzzer import FuzzerOptions, VectorFuzzer

    schema = vtt.RowType(["c0", "c1"], [vtt.BIGINT, vtt.BIGINT])
    exprs = [parse_expr(sql, schema) for sql in FUZZ_EXPRS]
    seen, batches, ok, decoded = set(), [], True, []
    seed = FUZZ_SEED
    while not {Encoding.SEQUENCE, Encoding.BIAS} <= seen:
        fz = VectorFuzzer(seed, FuzzerOptions(sequence_ratio=0.45, bias_ratio=0.45),
                          device=device)
        batch = fz.batch(schema, rows)
        flat = Batch.make(schema, [fz.flat_copy(c, rows) for c in batch.columns],
                          batch.length, capacity=rows)
        n = int(batch.length)
        for sql, got, want in zip(FUZZ_EXPRS, ExprSet(exprs).eval(batch),
                                  ExprSet(exprs).eval(flat)):
            def lane(x, fill):
                if x is None:
                    return torch.full((n,), fill, device=batch.device)
                return x.expand(rows)[:n] if x.dim() == 0 else x[:n]

            v1, v2 = lane(got.validity, True), lane(want.validity, True)
            e1, e2 = lane(got.errors, False), lane(want.errors, False)
            keep = v1 & ~e1
            same = (torch.equal(v1, v2) and torch.equal(e1, e2)
                    and torch.equal(lane(got.values, 0)[keep], lane(want.values, 0)[keep]))
            ok = ok and same
        for col in batch.columns:
            seen.add(col.encoding)
            if col.encoding in (Encoding.SEQUENCE, Encoding.BIAS):
                times = [_timed(lambda: col.decode(rows), device)[1] * 1e3 for _ in range(runs)]
                info = dict(encoding=col.encoding.value, decode_ms=statistics.median(times))
                # the decode itself, against a formula that shares no code with it
                values, validity = col.decode(rows)
                if col.encoding == Encoding.SEQUENCE:
                    info["runs"] = int(col.data.shape[0])
                    lengths = col.data.to(torch.int64)
                    want_values = torch.repeat_interleave(col.base.data.to(torch.int64), lengths)
                    want_validity = (None if col.base.validity is None
                                     else torch.repeat_interleave(col.base.validity, lengths))
                else:
                    info["delta_bytes"] = col.data.element_size()
                    want_values = int(col.base.data.item()) + col.data.to(torch.int64)
                    want_validity = col.validity
                info["decode_equal"] = bool(
                    torch.equal(values.to(torch.int64), want_values)
                    and (validity is None) == (want_validity is None)
                    and (validity is None or torch.equal(validity, want_validity)))
                ok = ok and info["decode_equal"]
                decoded.append(info)
        batches.append(dict(seed=seed, length=n,
                            encodings=[c.encoding.value for c in batch.columns]))
        seed += 1
    return dict(line="I7", path="SEQUENCE and BIAS columns decoded on the device",
                rows=rows, expressions=len(FUZZ_EXPRS), batches=batches, decoded=decoded,
                correct=bool(ok))


def run_files_io(cache, tile_rows: int, runs: int, device, workdir: str, wrappers,
                 oracles=None, fuzz_rows: int = 1 << 24, row_count: int = 65536,
                 dataset_root=None):
    """Every line of the files / host-formats slice (I1-I7) at ``cache``'s
    scale factor, on ``device``; the datasets are written under ``workdir``,
    which is removed at the end with the data cache's entries.  I1's dataset
    of lineitem by ship year goes to ``dataset_root`` when it is given (and
    stays for the caller: ``memory_spill``'s M5 reads it).  Returns the
    lines' fields."""
    import os
    import shutil

    from velox_tpu_torch.connectors.tpch.plans import oracle_result
    from velox_tpu_torch.connectors.tpch.queries import Q1_COLUMNS
    from velox_tpu_torch.io.cache import DEFAULT_CACHE

    oracles = oracles or {}
    want1 = oracles.get(1)
    if want1 is None:
        want1 = oracle_result(1, {"lineitem": cache.table("lineitem").select(Q1_COLUMNS)})
    q6_want = q6_unscaled(cache.table("lineitem"))
    os.makedirs(workdir, exist_ok=True)
    try:
        root = dataset_root or os.path.join(workdir, "lineitem_by_year")
        lines = [files_io_write(cache, tile_rows, device, root)]
        fields, q1_result, _, tiles = files_io_q1(root, tile_rows, runs, device, want1, wrappers)
        lines.append(fields)
        lines.append(files_io_q6(root, tile_rows, device, q6_want))
        lines.append(files_io_pruning(cache, tile_rows, device,
                                      os.path.join(workdir, "orders_by_date")))
        lines.append(files_io_arrow(cache, tile_rows, device, q6_want, q1_result))
        lines.append(files_io_serde(cache, tile_rows, device, tiles[0], workdir, row_count))
        del tiles
        lines.append(files_io_encodings(fuzz_rows, device, runs))
    finally:
        DEFAULT_CACHE.clear()
        shutil.rmtree(workdir, ignore_errors=True)
    return lines


# ---- the memory / spill phase (M1-M5) and the Substrait / observability
# phase (S1, O1)

INJECTION_POINTS = (
    "Spiller::spill", "LocalExecutor::carryMemoryFallback",
    "AggExecutor::carryOverflowFallback", "LocalExecutor::sortSpill",
    "LocalExecutor::windowSpill", "LocalExecutor::graceJoin",
    "LocalExecutor::graceNoProgress", "GroupedExecution::runGroup",
)


class PointHits:
    """The hits of every injection point (``utils/testvalue.py``) while the
    context is entered, as a dict by point (thread-safe: grouped execution
    hits from several threads)."""

    def __enter__(self):
        import threading

        from velox_tpu_torch.utils import testvalue

        self.counts = dict.fromkeys(INJECTION_POINTS, 0)
        lock = threading.Lock()

        def hook(point):
            def hit(_state):
                with lock:
                    self.counts[point] += 1
            return hit

        for point in INJECTION_POINTS:
            testvalue.register(point, hook(point))
        return self.counts

    def __exit__(self, *exc):
        from velox_tpu_torch.utils import testvalue

        for point in INJECTION_POINTS:
            testvalue.unregister(point)
        return False


def _reset_peak(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()


def _device_peak(device):
    """``torch.cuda.max_memory_allocated()`` since the last reset (None on
    the CPU, where the script is rehearsed)."""
    import torch

    if torch.device(device).type != "cuda":
        return None
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated()


def _sorted_frame(table, keys):
    return table.to_pandas().sort_values(keys, kind="stable").reset_index(drop=True)


def same_rows(got, want, keys) -> bool:
    """Two results hold the same rows (sorted by ``keys``): integers, dates
    and strings exactly, DOUBLE to rtol 1e-9."""
    import pandas as pd

    pd.testing.assert_frame_equal(_sorted_frame(got, keys), _sorted_frame(want, keys),
                                  check_dtype=False, rtol=1e-9)
    return True


def _unscaled(table, name):
    """A DECIMAL column's unscaled int64 values (a long decimal's limbs [lo,
    hi] must be the sign extension of lo)."""
    import numpy as np

    arr = np.asarray(table.columns[name])
    if arr.ndim == 2:
        assert np.array_equal(arr[:, 1], arr[:, 0] >> 63), name
        return arr[:, 0]
    return arr.astype(np.int64)


def _spill_fields(ex, hits, device):
    return dict(**ex.spill_stats, hits={k: v for k, v in hits.items() if v},
                pool_peak_bytes=ex.pool.peak, device_max_allocated_bytes=_device_peak(device))


def spill_m1(cache, tile_rows: int, device):
    """M1: Q18's subquery aggregation (sum(l_quantity) by l_orderkey) under
    a budget that admits the scan tiles and refuses the carry:
    carryMemoryFallback, then the host merge spilling its partials past a
    threshold of a third of them (2 files at least)."""
    import numpy as np

    from velox_tpu_torch.config import DEFAULT_CONFIG
    from velox_tpu_torch.exec.runner import LocalExecutor
    from velox_tpu_torch.plan import PlanBuilder

    lineitem = cache.table("lineitem").select(["l_orderkey", "l_quantity"])
    plan = (PlanBuilder().table_scan(lineitem)
            .aggregation(["l_orderkey"], ["sum(l_quantity) as sum_qty"]).build())
    _reset_peak(device)
    base = LocalExecutor(plan, tile_rows=tile_rows, device=device)
    tiles = base.device_tiles()
    tile_bytes = base.pool.reserved
    free, free_s = _timed(lambda: base.run(prefetched_tiles=tiles), device)
    assert base.kind == "sort_agg_device" and base.carry_groups and not base.carry_overflowed
    free_peak = dict(pool_peak_bytes=base.pool.peak,
                     device_max_allocated_bytes=_device_peak(device))
    carry_bytes = base.pool.peak - tile_bytes
    partial_bytes = base.groups_out * base.agg_exec.carry_row_bytes()
    del base, tiles
    budget = tile_bytes + carry_bytes // 2
    threshold = partial_bytes // 3
    config = DEFAULT_CONFIG.copy(query_memory_limit_bytes=budget, spill_bytes_threshold=threshold)
    _reset_peak(device)
    with PointHits() as hits:
        ex = LocalExecutor(plan, tile_rows=tile_rows, config=config, device=device)
        tiles = ex.device_tiles()
        got, run_s = _timed(lambda: ex.run(prefetched_tiles=tiles), device)
    fields = _spill_fields(ex, hits, device)
    # the oracle: lineitem is generated in l_orderkey order
    keys = np.asarray(lineitem.columns["l_orderkey"])
    assert np.all(keys[1:] >= keys[:-1])
    starts = np.flatnonzero(np.r_[True, keys[1:] != keys[:-1]])
    want = np.add.reduceat(np.asarray(lineitem.columns["l_quantity"]).astype(np.int64), starts)

    def equals_oracle(result):
        order = np.argsort(np.asarray(result.columns["l_orderkey"]), kind="stable")
        return (np.array_equal(np.asarray(result.columns["l_orderkey"])[order], keys[starts])
                and np.array_equal(_unscaled(result, "sum_qty")[order], want))

    # the run without a budget gives the oracle's rows too
    correct = equals_oracle(got) and equals_oracle(free)
    assert correct and hits["LocalExecutor::carryMemoryFallback"] == 1, hits
    assert fields["spill_files"] >= 2 and hits["Spiller::spill"] == fields["spill_files"], fields
    assert ex.carry_groups is None and not ex.carry_overflowed
    return dict(line="M1", path="carryMemoryFallback -> host merge, partials spilled",
                rows=lineitem.num_rows, tiles=len(tiles), groups=int(len(starts)),
                budget_bytes=budget, scan_tile_bytes=tile_bytes, carry_reserve_bytes=carry_bytes,
                spill_bytes_threshold=threshold, **fields, run_s=run_s,
                without_budget=dict(run_s=free_s, **free_peak), correct=correct)


def spill_m2(cache, device):
    """M2: ORDER BY over orders (o_totalprice DESC, o_orderkey, two payload
    columns) in tiles of 2^22 rows, the threshold a third of the resident
    runs: sortSpill, an external sort merged on the host."""
    import numpy as np

    from velox_tpu_torch.config import DEFAULT_CONFIG
    from velox_tpu_torch.exec.runner import LocalExecutor
    from velox_tpu_torch.plan import PlanBuilder

    tile_rows = SPILL_SORT_TILE_ROWS
    orders = cache.table("orders").select(["o_orderkey", "o_totalprice", "o_custkey",
                                           "o_orderdate"])
    plan = (PlanBuilder().table_scan(orders)
            .orderby(["o_totalprice desc", "o_orderkey"]).build())
    _reset_peak(device)
    base = LocalExecutor(plan, tile_rows=tile_rows, device=device)
    free, free_s = _timed(base.run, device)
    free_peak = dict(pool_peak_bytes=base.pool.peak,
                     device_max_allocated_bytes=_device_peak(device))
    assert base.spill_stats["spill_files"] == 0
    runs_bytes = base.pool.peak  # every resident run, reserved
    del base
    threshold = runs_bytes // 3
    config = DEFAULT_CONFIG.copy(spill_bytes_threshold=threshold)
    _reset_peak(device)
    with PointHits() as hits:
        ex = LocalExecutor(plan, tile_rows=tile_rows, config=config, device=device)
        got, run_s = _timed(ex.run, device)
    fields = _spill_fields(ex, hits, device)
    c = orders.columns
    order = np.lexsort((np.asarray(c["o_orderkey"]), -np.asarray(c["o_totalprice"])))
    correct = all(np.array_equal(np.asarray(got.columns[n]), np.asarray(c[n])[order])
                  for n in orders.schema.names) and all(
        np.array_equal(np.asarray(got.columns[n]), np.asarray(free.columns[n]))
        for n in orders.schema.names)
    tiles = -(-orders.num_rows // tile_rows)
    assert correct and hits["LocalExecutor::sortSpill"] >= 2, hits
    assert fields["spill_files"] == tiles and fields["spilled_rows"] == orders.num_rows, fields
    return dict(line="M2", path="sortSpill: external sort, runs merged on the host",
                rows=orders.num_rows, tile_rows=tile_rows, tiles=tiles,
                resident_runs_bytes=runs_bytes, spill_bytes_threshold=threshold, **fields,
                run_s=run_s, without_budget=dict(run_s=free_s, **free_peak), correct=correct)


def spill_m3(cache, tile_rows: int, device, want=None):
    """M3: TPC-H Q3, whose probe-side join builds on orders (semi-joined with
    the BUILDING customers), under a budget that admits the inner build and
    half the orders build: graceJoin with P >= 2.  Each partition's build
    rows and joined rows are held to the host's split of the same keys by
    ``splitmix64_np`` (the device filter and the host hash agree), and the
    probe rows each partition takes add up to the probe's rows."""
    import numpy as np

    from velox_tpu_torch.config import DEFAULT_CONFIG
    from velox_tpu_torch.connectors.tpch.plans import build_query
    from velox_tpu_torch.exec.grace import splitmix64_np
    from velox_tpu_torch.exec.runner import LocalExecutor

    tables = cache.for_query(3)
    plan = build_query(3, tables, device=device)
    def construct_and_run(config=None):
        ex = LocalExecutor(plan, tile_rows=tile_rows, config=config, device=device)
        return ex, ex.run()

    _reset_peak(device)
    (base, free), free_s = _timed(construct_and_run, device)
    [outer] = join_steps(base)
    state = outer.state_bytes()
    reserved = base.pool.reserved  # the inner (customer) build and the orders build
    free_peak = dict(pool_peak_bytes=base.pool.peak,
                     device_max_allocated_bytes=_device_peak(device))
    del base, outer
    budget = reserved - state // 2
    config = DEFAULT_CONFIG.copy(query_memory_limit_bytes=budget)
    _reset_peak(device)
    with PointHits() as hits:
        (ex, got), run_s = _timed(lambda: construct_and_run(config), device)
    fields = _spill_fields(ex, hits, device)
    [report] = ex.grace_joins
    check_frame(3, got, tables, want=want)
    P, salt = report["P"], report["salt"]
    # the host's view of the same partitioning
    li, o, cu = tables["lineitem"].columns, tables["orders"].columns, tables["customer"].columns
    day = int(np.datetime64("1995-03-15").astype(np.int64))
    probe = np.asarray(li["l_orderkey"])[np.asarray(li["l_shipdate"]) > day]
    building = tables["customer"].string_tables["c_mktsegment"].values().index("BUILDING")
    custs = np.asarray(cu["c_custkey"])[np.asarray(cu["c_mktsegment"]) == building]
    keep = (np.asarray(o["o_orderdate"]) < day) & np.isin(np.asarray(o["o_custkey"]), custs)
    build = np.asarray(o["o_orderkey"])[keep]
    part_of = lambda k: (splitmix64_np(k, salt) & (P - 1)).astype(np.int64)  # noqa: E731
    probe_rows = np.bincount(part_of(probe), minlength=P)
    build_rows = np.bincount(part_of(build), minlength=P)
    matched = np.bincount(part_of(probe[np.isin(probe, build)]), minlength=P)
    got_build = [p["build_rows"] for p in report["partitions"]]
    got_out = [p["out_rows"] for p in report["partitions"]]
    correct = (same_rows(got, free, ["l_orderkey"]) and got_build == build_rows.tolist()
               and got_out == matched.tolist() and int(probe_rows.sum()) == len(probe))
    assert correct and P >= 2 and hits["LocalExecutor::graceJoin"] == 1, (report, hits)
    assert not hits["LocalExecutor::graceNoProgress"] and not hits["LocalExecutor::carryMemoryFallback"]
    return dict(line="M3", path="graceJoin: build split on the host, probe filtered on the card",
                budget_bytes=budget, orders_build_state_bytes=state, P=P, salt=salt,
                probe_rows=int(len(probe)), probe_rows_by_partition=probe_rows.tolist(),
                build_rows_by_partition=got_build, joined_rows_by_partition=got_out,
                **fields, query_s=run_s, without_budget=dict(query_s=free_s, **free_peak),
                correct=correct)


def spill_m4(cache, device):
    """M4: a window over orders by o_custkey (row_number, a running sum of
    o_totalprice) in passes of whole partitions of 2^22 rows, the threshold
    below one pass's result: windowSpill, one file a pass."""
    import numpy as np

    from velox_tpu_torch.config import DEFAULT_CONFIG
    from velox_tpu_torch.exec.memory import table_nbytes
    from velox_tpu_torch.exec.runner import LocalExecutor
    from velox_tpu_torch.plan import PlanBuilder

    tile_rows = SPILL_SORT_TILE_ROWS
    orders = cache.table("orders").select(["o_orderkey", "o_custkey", "o_orderdate",
                                           "o_totalprice"])
    plan = (PlanBuilder().table_scan(orders)
            .window(["o_custkey"], ["o_orderdate", "o_orderkey"],
                    ["row_number() as rn", "sum(o_totalprice) as run_sum"]).build())
    def construct_and_run(config=None):
        ex = LocalExecutor(plan, tile_rows=tile_rows, config=config, device=device)
        return ex, ex.run()

    _reset_peak(device)
    (base, free), free_s = _timed(construct_and_run, device)
    free_peak = dict(pool_peak_bytes=base.pool.peak,
                     device_max_allocated_bytes=_device_peak(device))
    passes = len(base.window_chunks)
    del base
    threshold = table_nbytes(free) // (2 * passes)
    config = DEFAULT_CONFIG.copy(spill_bytes_threshold=threshold)
    _reset_peak(device)
    with PointHits() as hits:
        (ex, got), run_s = _timed(lambda: construct_and_run(config), device)
    fields = _spill_fields(ex, hits, device)
    c = orders.columns
    order = np.lexsort((np.asarray(c["o_orderkey"]), np.asarray(c["o_orderdate"]),
                        np.asarray(c["o_custkey"])))
    cust = np.asarray(c["o_custkey"])[order]
    starts = np.flatnonzero(np.r_[True, cust[1:] != cust[:-1]])
    sizes = np.diff(np.r_[starts, len(cust)])
    rn = np.arange(len(cust)) - np.repeat(starts, sizes) + 1
    price = np.asarray(c["o_totalprice"]).astype(np.int64)[order]
    run = np.cumsum(price)
    run_sum = run - np.repeat(run[starts] - price[starts], sizes)
    g = got.columns
    gorder = np.lexsort((np.asarray(g["o_orderkey"]), np.asarray(g["o_orderdate"]),
                         np.asarray(g["o_custkey"])))
    correct = (np.array_equal(np.asarray(g["o_orderkey"])[gorder], np.asarray(c["o_orderkey"])[order])
               and np.array_equal(np.asarray(g["rn"])[gorder], rn)
               and np.array_equal(_unscaled(got, "run_sum")[gorder], run_sum)
               # the passes come back in their order: the rows and their order
               # are those of the run without a threshold
               and tables_equal(got, free))
    assert correct and hits["LocalExecutor::windowSpill"] == passes >= 2, (hits, passes)
    assert fields["spill_files"] == passes, fields
    return dict(line="M4", path="windowSpill: finished passes spilled, restored in order",
                rows=orders.num_rows, tile_rows=tile_rows, window_passes=passes,
                largest_pass_rows=max(r for _, r in ex.window_chunks),
                spill_bytes_threshold=threshold, **fields, query_s=run_s,
                without_budget=dict(query_s=free_s, **free_peak), correct=correct)


def spill_m5(cache, tile_rows: int, device, root: str, workdir: str, wrappers):
    """M5: GroupedExecution of Q1 over the Hive dataset by ship year (7
    groups), two groups at once, a checkpoint a group: all 7 run; all 7 are
    restored (groups_run 0) with the same rows; after 3 checkpoints are
    deleted, 3 run.  Rows are held to the oracle's Q1 per year; K2 launches
    once a tile of each group that runs."""
    import os

    import pandas as pd

    from velox_tpu_torch.connectors.tpch.plans import build_q1, oracle_result
    from velox_tpu_torch.connectors.tpch.queries import Q1_COLUMNS
    from velox_tpu_torch.exec.grouped import GroupedExecution, split_groups

    if not os.path.isdir(root):
        files_io_write(cache, tile_rows, device, root)
    groups, split_s = _timed(lambda: split_groups(root, columns=Q1_COLUMNS), "cpu")
    want = pd.concat([oracle_result(1, {"lineitem": t}) for _, t in groups],
                     ignore_index=True)
    tiles = {key: -(-t.num_rows // tile_rows) for key, t in groups}
    ckpt = os.path.join(workdir, "m5_checkpoints")
    os.makedirs(workdir, exist_ok=True)
    keys = [k for k, _ in groups]
    attempts = []
    for attempt in range(3):
        to_run = (keys, [], keys[:3])[attempt]
        if attempt == 2:
            for key in to_run:
                os.unlink(GroupedExecution(build_q1, [], checkpoint_dir=ckpt,
                                           device=device)._ckpt_path(key))
        for w in wrappers.values():
            w.launches = 0
        with PointHits() as hits:
            ge = GroupedExecution(build_q1, groups, concurrent_groups=2, checkpoint_dir=ckpt,
                                  tile_rows=tile_rows, device=device)
            got, run_s = _timed(ge.run, device)
        k2 = wrappers["grouped_piece_sums"].launches
        ran = hits["GroupedExecution::runGroup"]
        frame = got.to_pandas().reset_index(drop=True)
        pd.testing.assert_frame_equal(frame, want, check_dtype=False, rtol=1e-9)
        on_card = str(device).startswith("cuda")
        ok = ge.groups_run == ran == len(to_run) and (
            not on_card or k2 == sum(tiles[k] for k in to_run))
        assert ok and len(groups) == 7, (attempt, ge.groups_run, ran, k2, tiles)
        attempts.append(dict(groups_run=ge.groups_run, run_group_hits=ran, k2_launches=k2,
                             run_s=run_s, result_rows=got.num_rows))
    return dict(line="M5", path="GroupedExecution: 7 ship-year groups, 2 at once, checkpoints",
                groups=[k for k, _ in groups], rows_by_group={k: t.num_rows for k, t in groups},
                tiles_by_group=tiles, split_groups_s=split_s, attempts=attempts,
                deleted_checkpoints=keys[:3], correct=True)


def run_memory_spill(cache, tile_rows: int, device, workdir: str, dataset_root: str,
                     wrappers, oracles=None):
    """Every line of the memory / spill phase (M1-M5) on ``device``; returns
    the lines' fields.  ``dataset_root`` is the files_io phase's Hive dataset
    of lineitem by ship year (written when missing)."""
    import shutil

    oracles = oracles or {}
    lines = []
    for fn in (lambda: spill_m1(cache, tile_rows, device),
               lambda: spill_m2(cache, device),
               lambda: spill_m3(cache, tile_rows, device, want=oracles.get(3)),
               lambda: spill_m4(cache, device)):
        (fields, seconds) = _timed(fn, device)
        fields["line_s"] = seconds
        lines.append(fields)
    try:
        fields, seconds = _timed(
            lambda: spill_m5(cache, tile_rows, device, dataset_root, workdir, wrappers), device)
        fields["line_s"] = seconds
        lines.append(fields)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return lines


def _scan_tables(node, out=None):
    out = {} if out is None else out
    for s in node.sources:
        _scan_tables(s, out)
    if not node.sources:
        out[node.id] = node.table
    return out


def substrait_s1(cache, tile_rows: int, device, wrappers, oracles):
    """S1: Q1, Q6 and Q3 through to_substrait -> JSON text -> from_substrait,
    run on the card; rows equal the direct plan's and the oracle's, and Q1
    launches K2 once a tile.  Then how many of the 22 TPC-H plans convert."""
    from velox_tpu_torch.connectors.tpch.plans import build_query
    from velox_tpu_torch.exec.runner import LocalExecutor
    from velox_tpu_torch.substrait import to_substrait

    queries = {}
    for num in (1, 6, 3):
        tables = cache.for_query(num)
        plan = build_query(num, tables, device=device)
        (text, back), convert_s = _timed(lambda: _substrait_roundtrip(plan), "cpu")
        for w in wrappers.values():
            w.launches = 0

        def construct_and_run():
            ex = LocalExecutor(back, tile_rows=tile_rows, device=device)
            return ex, ex.run()

        (ex, got), query_s = _timed(construct_and_run, device)
        launches = {n: w.launches for n, w in wrappers.items()}
        direct = LocalExecutor(plan, tile_rows=tile_rows, device=device).run()
        check_frame(num, got, tables, want=oracles.get(num))
        same_rows(got, direct, list(direct.schema.names))
        # the renaming projection of the root names puts the aggregation in
        # a barrier below the top pipeline: its kind is reported there
        kinds = [k for k, *_ in ex.barrier_aggregations] + (
            [ex.kind] if ex.agg_exec is not None else [])
        lineitem_tiles = -(-tables["lineitem"].num_rows // tile_rows)
        if num == 1:
            on_card = str(device).startswith("cuda")
            assert kinds == ["direct_agg"] and (
                not on_card or launches["grouped_piece_sums"] == lineitem_tiles), (
                kinds, launches, lineitem_tiles)
        queries[f"q{num}"] = dict(json_bytes=len(text), convert_s=convert_s, query_s=query_s,
                                  lineitem_tiles=lineitem_tiles, aggregations=kinds,
                                  launches=launches, result_rows=got.num_rows)
    converted, refused = [], {}
    for num in range(1, 23):
        try:
            to_substrait(build_query(num, cache.for_query(num), device=device))
            converted.append(num)
        except TypeError as exc:
            refused[num] = str(exc)
    return dict(line="S1", path="to_substrait -> JSON -> from_substrait, run on the card",
                queries=queries, tpch_plans_converted=len(converted), converted=converted,
                refused=refused, correct=True)


def _substrait_roundtrip(plan):
    from velox_tpu_torch.substrait import from_substrait, to_substrait

    text = json.dumps(to_substrait(plan))
    return text, from_substrait(json.loads(text), _scan_tables(plan))


def observability_o1(cache, tile_rows: int, device, workdir: str):
    """O1: collect_operator_stats + print_plan of Q6; each operator's rows
    equal the numpy count at that step; the profiler context writes a trace
    with the card's kernels and the executor's spans."""
    import os
    import shutil

    import numpy as np

    from velox_tpu_torch.connectors.tpch.plans import build_q6
    from velox_tpu_torch.exec.runner import LocalExecutor
    from velox_tpu_torch.utils import trace
    from velox_tpu_torch.utils.stats import collect_operator_stats, print_plan

    lineitem = cache.table("lineitem")
    plan = build_q6(lineitem)
    stats, stats_s = _timed(
        lambda: collect_operator_stats(plan, tile_rows=tile_rows, device=device), device)
    c = lineitem.columns
    keep = ((c["l_shipdate"] >= 8766) & (c["l_shipdate"] < DAY_1995) & (c["l_discount"] >= 5)
            & (c["l_discount"] <= 7) & (c["l_quantity"] < 2400))
    passing = int(np.count_nonzero(keep))
    rows = [(o.operator_type, o.input_rows, o.output_rows) for o in stats.operators]
    # the scan's filter keeps the passing rows; the projection of the
    # aggregate's input keeps them all; one row comes out
    assert rows == [("TableScan", 0, passing), ("Project", passing, passing),
                    ("Aggregation", passing, 1)], rows
    log_dir = os.path.join(workdir, "o1_profile")
    try:
        with trace.device_profile(log_dir):
            LocalExecutor(plan, tile_rows=tile_rows, device=device).run()
            _sync(device)
        path = os.path.join(log_dir, "trace.json")
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        kernels = sum(1 for e in events if e.get("cat") == "kernel")
        spans = sorted({e["name"] for e in events if e.get("cat") == "user_annotation"
                        and str(e.get("name", "")).startswith(trace.PREFIX)})
        trace_bytes = os.path.getsize(path)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    on_card = str(device).startswith("cuda")
    assert events and (kernels > 0 or not on_card), (len(events), kernels)
    assert {"velox.construct", "velox.run", "velox.steps"} <= set(spans), spans
    return dict(line="O1", path="collect_operator_stats, print_plan, trace, device_profile",
                operators=[dict(type=t, input_rows=i, output_rows=o,
                                wall_s=s.wall_seconds) for (t, i, o), s in
                           zip(rows, stats.operators)],
                plan_text=print_plan(plan, stats), stats_s=stats_s, trace_spans=spans,
                trace_events=len(events), trace_kernel_events=kernels, trace_bytes=trace_bytes,
                correct=True)


def run_substrait_obs(cache, tile_rows: int, device, workdir: str, wrappers, oracles=None):
    """S1 and O1 on ``device``; returns the lines' fields."""
    oracles = oracles or {}
    lines = []
    for fn in (lambda: substrait_s1(cache, tile_rows, device, wrappers, oracles),
               lambda: observability_o1(cache, tile_rows, device, workdir)):
        fields, seconds = _timed(fn, device)
        fields["line_s"] = seconds
        lines.append(fields)
    return lines


# ---------------------------------------------------------------------------
# The distributed slice (``velox_tpu_torch/parallel``): DistributedExecutor on
# torch.distributed, every rank a process of ``testing/world.py``.  Four gloo
# ranks share the card (NCCL refuses two ranks on one device); gloo is a host
# transport, so every collective stages through pinned host buffers
# (``staged`` on each line).  NCCL runs at world size 1 (DX-nccl).  The
# tables cross once, as files the ranks map; a plan crosses as its query
# number.

DIST_RANKS = 4
DIST_THREADS = 2  # torch host threads a rank: 4 ranks on the card's 8 host cores
DIST_PER_DEVICE_ROWS = 1 << 22  # a rank's shard of a tile (a tile is 2^24 rows)
# DX-skew: Q3's probe exchange bucket, far below a rank's share of a
# destination at SF 10, so that the exchange overflows and every rank
# re-probes the exact sizes
DIST_SKEW_BUCKET_ROWS = 1 << 16
DIST_QUERIES = (6, 1, 3, 13)
DIST_TASK = "velox_tpu_torch.testing.dist_tasks:run_tpch"


def _dist_line(name: str, num: int, sf: float, got) -> dict:
    after = got["after"]
    return dict(
        line=name, num=num, sf=sf, world=got["world"], backend=got["backend"],
        staged=got["staged"], **got["stats"], kind=after["kind"],
        shuffle_joins=after["segments"], sjoin_buckets=after["sjoin_buckets"],
        sjoin_outcaps=after["sjoin_outcaps"], carry_rows=after["carry_rows"],
        carry_retries=got["carry_retries"], reprobes=got["reprobes"], query_s=got["seconds"],
        device_peak_bytes=got["device_peak_bytes"], result_rows=got["result"].num_rows,
    )


def run_distributed(cache, small, device, oracles, tile_rows: int):
    """The ``distributed`` lines: Q6, Q1 (direct_agg), Q3 (a shuffle join,
    then the group exchange) and Q13 (a shuffle join into grouping) at SF
    ``cache.sf`` over 4 gloo ranks sharing the card, each row-exact against
    the numpy oracle (``oracles``, or computed); DX-skew, Q3 with an
    undersized probe bucket (the re-probe asserted); the 22 plans at SF
    ``small.sf`` against the port's LocalExecutor rows; DX-nccl, Q3 at SF
    ``small.sf`` on NCCL at world size 1.  Yields each line's fields."""
    import shutil

    from velox_tpu_torch.config import QueryConfig
    from velox_tpu_torch.connectors.tpch.plans import build_query
    from velox_tpu_torch.connectors.tpch.queries import QUERY_COLUMNS
    from velox_tpu_torch.exec.runner import LocalExecutor
    from velox_tpu_torch.testing import assert_same_rows
    from velox_tpu_torch.testing.world import World

    def tables_of(tables_cache, nums):
        cols = {}
        for num in nums:
            for name, names in QUERY_COLUMNS[num].items():
                cols.setdefault(name, set()).update(names)
        return {name: tables_cache.table(name).select(
                    [c for c in tables_cache.table(name).schema.names if c in names])
                for name, names in cols.items()}

    want_local = {}
    with World(DIST_RANKS, "gloo", device, threads=DIST_THREADS) as world:
        t0 = time.perf_counter()
        handle = world.share_tables(tables_of(cache, DIST_QUERIES))
        share_s = time.perf_counter() - t0
        for num in DIST_QUERIES:
            got = world.run(DIST_TASK, num, handle, DIST_PER_DEVICE_ROWS)
            check_frame(num, got["result"], cache.for_query(num), want=oracles.get(num))
            after = got["after"]
            if num in (6, 1):
                assert after["kind"] == "direct_agg", after
            else:  # the build side is far over 2^16 rows: a shuffle join
                assert after["kind"] == "sort_agg_exchange" and after["segments"] == 1, after
            yield dict(_dist_line(f"D-Q{num}", num, cache.sf, got), tables_share_s=share_s,
                       correct=True)
        cfg = QueryConfig(exchange_bucket_rows=DIST_SKEW_BUCKET_ROWS)
        got = world.run(DIST_TASK, 3, handle, DIST_PER_DEVICE_ROWS, cfg)
        check_frame(3, got["result"], cache.for_query(3), want=oracles.get(3))
        assert got["reprobes"] >= 1, got["after"]
        assert got["after"]["sjoin_buckets"][0] > DIST_SKEW_BUCKET_ROWS, got["after"]
        yield dict(_dist_line("DX-skew", 3, cache.sf, got), bucket_rows=DIST_SKEW_BUCKET_ROWS,
                   correct=True)
        # the sweep reads SF ``small.sf`` only: the SF ``cache.sf`` tables
        # and their shared files go first (with them held, the four ranks'
        # host-staged exchanges of the sweep came within 4 GiB of a 96 GiB
        # host at SF 10)
        shutil.rmtree(handle, ignore_errors=True)
        cache.release()
        t0 = time.perf_counter()
        handle = world.share_tables(tables_of(small, range(1, 23)))
        share_s = time.perf_counter() - t0
        for num in range(1, 23):
            tables = small.for_query(num)
            t0 = time.perf_counter()
            want = LocalExecutor(build_query(num, tables, device=device), tile_rows=tile_rows,
                                 device=device).run()
            local_s = time.perf_counter() - t0
            want_local[num] = want
            got = world.run(DIST_TASK, num, handle, DIST_PER_DEVICE_ROWS)
            assert_same_rows(got["result"], want)
            yield dict(_dist_line(f"sweep Q{num}", num, small.sf, got), local_query_s=local_s,
                       tables_share_s=share_s, correct=True)
    with World(1, "nccl", device, threads=DIST_THREADS) as world:
        handle = world.share_tables(tables_of(small, (3,)))
        got = world.run(DIST_TASK, 3, handle, DIST_PER_DEVICE_ROWS)
        assert_same_rows(got["result"], want_local[3])
        yield dict(_dist_line("DX-nccl", 3, small.sf, got), correct=True)


_T0 = time.perf_counter()


def say(phase: str, **fields) -> None:
    """One JSON line a phase; ``at_s`` is the seconds since the script began."""
    print(json.dumps({"phase": phase, "at_s": time.perf_counter() - _T0, **fields},
                     default=float), flush=True)


def median_ms(fn, runs: int) -> float:
    """Median CUDA-event time of ``fn`` in ms over ``runs``, after one warm-up.
    Each run is queued behind a device-side sleep of about half a millisecond,
    so the host is ahead of the device and only device time lies between the
    two events.  The sleep is ``torch.cuda._sleep``, a private call that counts
    clock cycles (so its length follows the clock; only that it outlasts the
    host's enqueueing matters); a torch without it raises here."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def dict_like_record(strings, runs: int, launches: int) -> dict:
    """The kernels line's record of K4 (``ops/dict_like.py``) over Q13's
    comment dictionary, resident on the card where the program keeps it, at
    Q13's first pattern: bit for bit against its plain version, timed
    against it and against the byte floor (the entries' bytes and offsets
    read once, one result byte an entry written once)."""
    import torch

    from velox_tpu_torch.ops import dict_like as k4

    pattern = k4.parse_like("%special%requests%")
    data, offsets = strings.byte_arrays(DEVICE)
    got = k4.dict_like(data, offsets, pattern, DEVICE)
    want = k4.dict_like_plain(data, offsets, pattern)
    assert torch.equal(got, want), "dict_like disagrees with its plain version"
    entries = offsets.shape[0] - 1
    moved = k4.launch_bytes(data.shape[0], entries, offsets.element_size())
    b_ms, b_by = bound(moved, data.shape[0])  # a compare a byte at least
    record = dict(
        name="dict_like", shape="q13 o_comment dictionary, %special%requests%", route="cuda",
        source="velox_tpu_torch/csrc/dict_like.cu", replaces=None, max_abs_err=0,
        ms=median_ms(lambda: k4.dict_like(data, offsets, pattern, DEVICE), runs),
        plain_ms=median_ms(lambda: k4.dict_like_plain(data, offsets, pattern), runs),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        entries=entries, bytes=moved, matches=int(want.sum()), geometry=None,
        launches=launches,
    )
    record["share_of_bound"] = record["bound_ms"] / record["ms"]
    del got, want
    torch.cuda.empty_cache()
    return record


def measured_bandwidth(runs: int) -> float:
    """Device-memory bytes/s of a large int64 ``sum`` (read once)."""
    import torch

    x = torch.ones((1 << 27,), dtype=torch.int64, device=DEVICE)  # 1 GiB
    ms = median_ms(lambda: x.sum(), runs)
    return x.numel() * 8 / (ms * 1e-3)


def device_busy_ms(fn, top: int = 6):
    """(sum of device kernel time of one ``fn()`` in ms, the ``top`` kernels
    as [name, ms, launches]) from torch.profiler; (None, []) when the
    profiler reports no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # device-side rows only: a CPU operator's row repeats its kernels' time
    kernels = []
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None) or getattr(
                e, "self_cuda_time_total", 0.0
            )
            kernels.append([e.key[:80], us / 1e3, e.count])
    total = sum(k[1] for k in kernels)
    if total <= 0:
        return None, []
    kernels.sort(key=lambda k: -k[1])
    return total, kernels[:top]


def whole_query_timing(once, first_ms: float, timed: bool = True) -> dict:
    """The timing fields of a whole-query line whose checked first run took
    ``first_ms``: ``WHOLE_RUNS`` - 1 warm runs of ``once`` (none when the
    first run passed ``LONG_QUERY_S``), ``query_ms`` their median (the first
    run's when there is none).  When not ``timed`` (every line but a
    hand-built plan's), or past ``TIMING_UNTIL_S`` into the script, the
    first run is the only one.  A whole query's device time is not measured
    (a profiled run took two to four times the query); a plan's line has its
    last pipeline's (``time_query``)."""
    import torch

    walls = [first_ms]
    if not timed:
        timing = "first run only: a plan's line alone is timed"
    elif time.perf_counter() - _T0 > TIMING_UNTIL_S:
        timing = f"first run only: past {TIMING_UNTIL_S:.0f} s"
    else:
        long_run = first_ms > LONG_QUERY_S * 1e3
        timing = "first run, no warm run: a long query" if long_run else "warm runs"
        for _ in range(0 if long_run else WHOLE_RUNS - 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            once()
            walls.append((time.perf_counter() - t0) * 1e3)
    return dict(timing=timing, query_ms=statistics.median(walls[1:] or walls),
                query_runs_ms=walls)


def bound(bytes_moved: int, ops: int):
    by_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    by_ops = ops / PEAK_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def tensor_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# ---------------------------------------------------------------------------
# the kernels' inputs, taken from the executors' own tiles


def q1_piece_inputs(ex, tile):
    """(cols, gid_live, plans, num_groups, mask, gids) as the executor's tile
    step hands them to grouped_piece_sums (AggExecutor.piece_inputs)."""
    import torch

    from velox_tpu_torch.exec.runner import apply_streaming

    agg = ex.agg_exec
    batch2, _ = apply_streaming(tile, ex.lin.steps)
    mask = batch2.active_mask()
    gids = agg.grouping.group_ids(batch2)
    cols, gid_live = agg.piece_inputs(tile, mask, gids)
    return cols, gid_live, agg._piece_plan[1], agg.num_groups, mask, gids.to(torch.int32)


def q6_selective_inputs(tile):
    """Q6 as selective_sum sees it: int64 copies of the product and the three
    filter columns of one tile, and Q6's bands in the device representation."""
    import torch

    from velox_tpu_torch.connectors.tpch.gen import _days

    def wide(name):
        return tile.column(name).data.to(torch.int64)

    values = wide("l_extendedprice") * wide("l_discount")
    filters = [wide("l_shipdate"), wide("l_discount"), wide("l_quantity")]
    lo = _days("1994-01-01")
    bounds = [(lo, lo + 364), (5, 7), (-(1 << 62), 2399)]
    return values, filters, bounds


Q1_MEASURES = ("l_quantity", "l_extendedprice", "l_discount", "l_tax")


def q1_group_sum_inputs(tile):
    import torch

    return [tile.column(n).data.to(torch.int64) for n in Q1_MEASURES]


# ---------------------------------------------------------------------------


def check_kernels(ex1, tile1, tile6, runs: int):
    """Phase 3: each kernel vs its plain version on one tile; returns the
    per-kernel records (without the main path's launch counts)."""
    import torch

    from velox_tpu_torch.ops.group_piece import (
        grouped_piece_sums,
        grouped_piece_sums_plain,
    )
    from velox_tpu_torch.ops.group_sum import (
        grouped_int64_sums,
        grouped_int64_sums_plain,
    )
    from velox_tpu_torch.ops.selective_sum import selective_sum, selective_sum_plain

    records = []

    def max_abs_err(got, want) -> int:
        err = 0
        for g, w in zip(got, want):
            err = max(err, int((g.to(torch.int64) - w.to(torch.int64)).abs().max()))
        return err

    # K1 selective_sum at Q6's shape
    values, filters, bounds = q6_selective_inputs(tile6)
    got = selective_sum(values, filters, bounds)
    want = selective_sum_plain(values, filters, bounds)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    assert err == 0 and int(want[2]) > 0, ("selective_sum disagrees", got, want)
    n = values.shape[0]
    # the kernel reads a value only where the row passes, so of the value
    # column this run's data needs the 32-byte sectors that hold a passing row
    passing = torch.ones((n,), dtype=torch.bool, device=DEVICE)
    for f, (lo, hi) in zip(filters, bounds):
        passing &= (f >= lo) & (f <= hi)
    whole = n - n % 4
    value_bytes = 32 * (int(passing[:whole].view(-1, 4).any(dim=1).sum())
                        + int(passing[whole:].any()))
    k1_bytes = tensor_bytes(*filters) + value_bytes + 24
    b_ms, b_by = bound(k1_bytes, 9 * n)
    records.append(
        dict(
            name="selective_sum", shape="q6 tile", route="cuda",
            source="velox_tpu_torch/csrc/kernels.cu",
            replaces="velox_tpu/ops/pallas_kernels.py:107",
            max_abs_err=err,
            ms=median_ms(lambda: selective_sum(values, filters, bounds), runs),
            plain_ms=median_ms(lambda: selective_sum_plain(values, filters, bounds), runs),
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
            rows=n, bytes=k1_bytes, value_bytes_needed=value_bytes,
            geometry=None,  # grid-stride, no staged geometry
        )
    )
    del values, filters, passing

    # K2 grouped_piece_sums at Q1's shape
    cols, gid_live, plans, groups, mask, gids = q1_piece_inputs(ex1, tile1)
    got = grouped_piece_sums(cols, gid_live, plans, groups)
    want = grouped_piece_sums_plain(cols, gid_live, plans, groups)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    assert err == 0 and int(want[0].sum()) > 0, ("grouped_piece_sums disagrees", got, want)
    n = gid_live.shape[0]
    live = int((gid_live >= 0).sum())
    ops = live * sum(2 * len(p.factors) + 1 for p in plans)
    moved = tensor_bytes(*cols, gid_live) + 8 * groups * len(plans)
    b_ms, b_by = bound(moved, ops)
    records.append(
        dict(
            name="grouped_piece_sums", shape="q1 tile", route="cuda",
            source="velox_tpu_torch/csrc/grouped_piece_sums.cu",
            replaces="velox_tpu/ops/pallas_group_piece.py:235",
            max_abs_err=err,
            ms=median_ms(lambda: grouped_piece_sums(cols, gid_live, plans, groups), runs),
            plain_ms=median_ms(
                lambda: grouped_piece_sums_plain(cols, gid_live, plans, groups), runs
            ),
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
            rows=n, bytes=moved, specs=len(plans), groups=groups,
            column_dtypes=[str(c.dtype) for c in cols],
            geometry=grouped_piece_sums.last_geometry.summary(),
        )
    )

    # K3 grouped_int64_sums: G = 12 over int64 copies of Q1's measure columns
    wide = q1_group_sum_inputs(tile1)
    got = grouped_int64_sums(wide, gids, mask, groups)
    want = grouped_int64_sums_plain(wide, gids, mask, groups)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    assert err == 0 and int(want[0].sum()) > 0, ("grouped_int64_sums disagrees", got, want)
    moved = tensor_bytes(*wide, gids, mask) + 8 * groups * len(wide)
    b_ms, b_by = bound(moved, live * len(wide))
    # the yardstick: ONE index_add_ over the pre-stacked (N, 4) matrix, with
    # masked rows pointed at a spare slot; stacking and folding are not timed
    stacked = torch.stack(wide, dim=1)
    index = torch.where(mask, gids.to(torch.int64), torch.full_like(gids, groups, dtype=torch.int64))
    lib = lambda: torch.zeros(  # noqa: E731
        (groups + 1, len(wide)), dtype=torch.int64, device=DEVICE
    ).index_add_(0, index, stacked)
    assert torch.equal(lib()[:groups].t().contiguous(), torch.stack(list(want)))
    records.append(
        dict(
            name="grouped_int64_sums", shape="q1 tile, 4 int64 columns", route="cuda",
            source="velox_tpu_torch/csrc/grouped_int64_sums.cu",
            replaces="velox_tpu/ops/pallas_group_sum.py:139",
            max_abs_err=err,
            ms=median_ms(lambda: grouped_int64_sums(wide, gids, mask, groups), runs),
            plain_ms=median_ms(
                lambda: grouped_int64_sums_plain(wide, gids, mask, groups), runs
            ),
            bound_ms=b_ms, bound_by=b_by, library_ms=median_ms(lib, runs),
            rows=n, bytes=moved, columns=len(wide), groups=groups,
            geometry=grouped_int64_sums.last_geometry.summary(),
        )
    )
    for r in records:
        r["share_of_bound"] = r["bound_ms"] / r["ms"]
    return records


def equal_bits(got, want) -> bool:
    import torch

    return len(got) == len(want) and all(torch.equal(g, w) for g, w in zip(got, want))


def check_edges():
    """The edge cases of the two grouped sums, kernel against plain version by
    exact equality; returns per case what geometry it ran with."""
    import torch

    from velox_tpu_torch.ops.group_piece import grouped_piece_sums, grouped_piece_sums_plain
    from velox_tpu_torch.ops.group_sum import grouped_int64_sums, grouped_int64_sums_plain
    from velox_tpu_torch.testing import kernel_cases

    report = {}
    suites = (
        ("grouped_piece_sums", kernel_cases.piece_cases, kernel_cases.piece_inputs,
         grouped_piece_sums, grouped_piece_sums_plain),
        ("grouped_int64_sums", kernel_cases.group_sum_cases, kernel_cases.group_sum_inputs,
         grouped_int64_sums, grouped_int64_sums_plain),
    )
    for kernel, cases, inputs, fn, plain in suites:
        ran = []
        for case in cases():
            args = inputs(case, DEVICE)
            got = fn(*args)
            want = plain(*args)
            torch.cuda.synchronize()
            assert equal_bits(got, want), (kernel, case["name"], got, want)
            g = fn.last_geometry
            assert case["copies"] in (None, g.lane_copies), (kernel, case["name"], g)
            ran.append([case["name"], g.lane_copies, g.stages, g.chunk_rows,
                        g.head, g.body_rows, g.tail, g.smem_bytes])
        report[kernel] = ran
    return report


def live_group_inputs(n, live_groups: int, dtype):
    """Synthetic group ids: ``live_groups`` groups, uniform, every row live."""
    import numpy as np
    import torch

    rng = np.random.default_rng(live_groups)
    return torch.from_numpy(rng.integers(0, live_groups, n).astype(dtype)).to(DEVICE)


def contention_sweep(ex1, tile1, runs: int):
    """Kernel ms of the two grouped sums on one tile against the number of
    live groups (1, 4, 12, 64; uniform synthetic group ids)."""
    import numpy as np
    import torch

    from velox_tpu_torch.ops.group_piece import grouped_piece_sums, grouped_piece_sums_plain
    from velox_tpu_torch.ops.group_sum import grouped_int64_sums, grouped_int64_sums_plain

    cols, gid_live, plans, _, _, _ = q1_piece_inputs(ex1, tile1)
    wide = q1_group_sum_inputs(tile1)
    n = gid_live.shape[0]
    mask = torch.ones((n,), dtype=torch.bool, device=DEVICE)
    out = {"rows": n, "grouped_piece_sums": {}, "grouped_int64_sums": {}}
    for live in (1, 4, 12, 64):
        groups = max(live, 12)
        gid8 = live_group_inputs(n, live, np.int8)
        assert equal_bits(grouped_piece_sums(cols, gid8, plans, groups),
                          grouped_piece_sums_plain(cols, gid8, plans, groups))
        out["grouped_piece_sums"][str(live)] = median_ms(
            lambda: grouped_piece_sums(cols, gid8, plans, groups), runs)
        gid32 = gid8.to(torch.int32)
        assert equal_bits(grouped_int64_sums(wide, gid32, mask, groups),
                          grouped_int64_sums_plain(wide, gid32, mask, groups))
        out["grouped_int64_sums"][str(live)] = median_ms(
            lambda: grouped_int64_sums(wide, gid32, mask, groups), runs)
    return out


def launches_but_k3(wrappers):
    """The launch counts of the hand-written kernels other than
    ``grouped_int64_sums``, which every direct-mode int64 sum on the card
    takes (ops/segmented.py ``direct_group_reduce``)."""
    return {name: w.launches for name, w in wrappers.items() if name != "grouped_int64_sums"}


def drive_ops(tiles6, ex1, tiles1, q1_result, q6_exact: int):
    """selective_sum, which the executor does not call, and
    grouped_int64_sums over Q1's columns, through their own entry points over
    all tiles, held against the queries' answers."""
    import numpy as np
    import torch

    from velox_tpu_torch.ops.group_sum import grouped_int64_sums
    from velox_tpu_torch.ops.selective_sum import selective_sum

    hi = lo = count = 0
    for tile in tiles6:
        h, l, c = selective_sum(*q6_selective_inputs(tile))
        hi, lo, count = hi + int(h), lo + int(l), count + int(c)
    assert hi * (1 << 32) + lo == q6_exact, ("selective_sum vs Q6", hi, lo, q6_exact)

    groups = ex1.agg_exec.num_groups
    sums = torch.zeros((len(Q1_MEASURES), groups), dtype=torch.int64, device=DEVICE)
    for tile in tiles1:
        _, _, _, _, mask, gids = q1_piece_inputs(ex1, tile)
        sums += torch.stack(
            list(grouped_int64_sums(q1_group_sum_inputs(tile), gids, mask, groups))
        )
    sums = sums.cpu().numpy()
    for row, name in ((0, "sum_qty"), (1, "sum_base_price")):
        got = sums[row][sums[row] != 0]
        want = np.sort(np.asarray(q1_result.columns[name], dtype=np.int64))
        assert np.array_equal(np.sort(got), want), (name, got, want)
    return count


def drive_q12(cache, tile_rows: int):
    """Q12 at the cache's scale factor through ``LocalExecutor`` over
    device-resident tiles, row-exact against the numpy oracle.  Its grouping
    reads no row order, so its join takes the hashed probe, one ``hash_probe``
    (K5) a tile; it groups by ship mode in array mode after its join, off the
    piece path, so each of a tile's int64 accumulators is one call of
    ``grouped_int64_sums`` over the probe batch.  Every call of either
    kernel the run makes is held bit for bit against its plain version; a
    copy of the first call's operands of each is kept.  Returns (K3
    launches of the run, tiles, K3's kept operands, K5 launches, K5's kept
    operands)."""
    import types

    import torch

    from velox_tpu_torch.exec import joins
    from velox_tpu_torch.ops import group_sum, hash_probe, segmented

    ex, tiles, tables, rep = prepare_query(12, cache.sf, tile_rows, cache)
    assert rep["kind"] == "direct_agg" and rep["piece_path"] is False, rep
    assert [j.hashed for j in join_steps(ex)] == [True]
    real = group_sum.grouped_int64_sums
    kept, probes = [], []

    def checked_probe(table, keys, length, selection=None, validity=None):
        got = hash_probe.hash_probe(table, keys, length, selection, validity)
        want = hash_probe.hash_probe_plain(table, keys, length, selection, validity)
        assert torch.equal(got, want), "hash_probe disagrees with its plain version in Q12"
        if not probes:
            probes.append((table, keys.clone(), length.clone(),
                           None if selection is None else selection.clone(),
                           None if validity is None else validity.clone()))
        return got

    def checked(cols, gids, mask, num_groups):
        got = real(cols, gids, mask, num_groups)
        want = group_sum.grouped_int64_sums_plain(cols, gids, mask, num_groups)
        assert equal_bits(got, want), ("grouped_int64_sums disagrees in Q12", num_groups)
        if not kept:
            kept.append((tuple(c.clone() for c in cols), gids.clone(), mask.clone(),
                         num_groups))
        return got

    before, k5_before = real.launches, hash_probe.hash_probe.launches
    # direct_group_reduce reaches K3 through its module's name, the join K5
    # through its own
    segmented.group_sum = types.SimpleNamespace(
        grouped_int64_sums=checked, MAX_TABLE_BYTES=group_sum.MAX_TABLE_BYTES
    )
    joins.hash_probe = checked_probe
    try:
        check_result(12, ex, tiles, tables)
    finally:
        segmented.group_sum = group_sum
        joins.hash_probe = hash_probe.hash_probe
    [(cols, gids, mask, groups)] = kept
    assert len(cols) == 1 and groups == ex.agg_exec.num_groups, (len(cols), groups)
    k5 = hash_probe.hash_probe.launches - k5_before
    return real.launches - before, len(tiles), kept[0], k5, probes[0]


def k3_at_q12_record(operands, runs: int, launches: int):
    """The kernels line's record of ``grouped_int64_sums`` at the shape Q12's
    executor gives it, timed against the plain version (the ``index_add_``
    that direct_group_reduce ran before the kernel took these sums)."""
    import torch

    from velox_tpu_torch.ops.group_sum import grouped_int64_sums, grouped_int64_sums_plain

    cols, gids, mask, groups = operands
    got = grouped_int64_sums(cols, gids, mask, groups)
    want = grouped_int64_sums_plain(cols, gids, mask, groups)
    torch.cuda.synchronize()
    assert equal_bits(got, want), ("grouped_int64_sums disagrees at Q12's shape", got, want)
    n = gids.shape[0]
    live = int((mask & (gids >= 0) & (gids < groups)).sum())
    assert 0 < live * 20 < n, (live, n)  # nearly every row of the probe batch is dead
    moved = tensor_bytes(*cols, gids, mask) + 8 * groups * len(cols)
    b_ms, b_by = bound(moved, live * len(cols))
    record = dict(
        name="grouped_int64_sums", shape=f"q12 probe batch of {n} rows, 1 int64 column",
        route="cuda",
        source="velox_tpu_torch/csrc/grouped_int64_sums.cu",
        replaces="velox_tpu/ops/pallas_group_sum.py:139",
        max_abs_err=0,
        ms=median_ms(lambda: grouped_int64_sums(cols, gids, mask, groups), runs),
        plain_ms=median_ms(lambda: grouped_int64_sums_plain(cols, gids, mask, groups), runs),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        rows=n, live_rows=live, bytes=moved, columns=len(cols), groups=groups,
        geometry=grouped_int64_sums.last_geometry.summary(), launches=launches,
    )
    record["share_of_bound"] = record["bound_ms"] / record["ms"]
    return record


def k5_at_q12_record(operands, runs: int, launches: int):
    """The kernels line's record of ``hash_probe`` (K5) at the shape Q12's
    executor gives it: the first tile's probe of the orders table, slot ids
    held equal to the plain version's (a binary search of the sorted keys),
    the longest walk through the table, and the time against the byte bound
    (the selection and validity bytes and 4 bytes of slot id a row, and a
    live row's key, its slot and the build key it names)."""
    import torch

    from velox_tpu_torch.ops.hash_probe import hash_probe, hash_probe_plain

    table, keys, length, selection, validity = operands
    walk = torch.zeros((1,), dtype=torch.int32, device=keys.device)
    got = hash_probe(table, keys, length, selection, validity, walk=walk)
    want = hash_probe_plain(table, keys, length, selection, validity)
    torch.cuda.synchronize()
    assert torch.equal(got, want), "hash_probe disagrees with its plain version at Q12's shape"
    n = keys.shape[0]
    live = torch.arange(n, device=keys.device) < length
    for m in (selection, validity):
        if m is not None:
            live = live & m
    live = int(live.sum())
    masks = [m for m in (selection, validity) if m is not None]
    moved = n * 4 + tensor_bytes(*masks) + live * (keys.element_size() + 4 + 8)
    b_ms, b_by = bound(moved, live)
    record = dict(
        name="hash_probe", shape=f"q12 probe of {n} lineitem rows into {table.keys.shape[0]} "
        "orders", route="cuda", source="velox_tpu_torch/csrc/hash_probe.cu", replaces=None,
        max_abs_err=int((got.long() - want.long()).abs().max()),
        ms=median_ms(lambda: hash_probe(table, keys, length, selection, validity), runs),
        plain_ms=median_ms(lambda: hash_probe_plain(table, keys, length, selection, validity),
                           runs),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        rows=n, live_rows=live, hits=int((want >= 0).sum()), bytes=moved,
        key_bytes=keys.element_size(), slots=table.capacity, longest_walk=int(walk.item()),
        geometry=None, launches=launches,
    )
    record["share_of_bound"] = record["bound_ms"] / record["ms"]
    return record


class TpchTables:
    """The TPC-H tables at one scale factor, each generated once, on first
    use, with every column any of the 22 queries reads (the generator seeds
    each column from its table, name and scale factor, so a column does not
    depend on which others are generated); a query gets views of its own
    columns."""

    def __init__(self, sf: float):
        from velox_tpu_torch.connectors.tpch.queries import QUERY_COLUMNS

        self.sf = sf
        self.columns = {}
        for cols in (*QUERY_COLUMNS.values(), *WINDOW_COLUMNS.values(),
                     *WINDOW_PLAN_COLUMNS.values(), *FUNCTION_COLUMNS.values(),
                     *COMPLEX_COLUMNS.values(), *SPARK_COLUMNS.values()):
            for name, names in cols.items():
                self.columns.setdefault(name, set()).update(names)
        self._tables = {}
        self.generate_s = {}

    def table(self, name: str):
        from velox_tpu_torch.connectors.tpch import SCHEMAS, load_table

        if name not in self._tables:
            t0 = time.perf_counter()
            cols = [c for c in SCHEMAS[name].names if c in self.columns[name]]
            # generated in every run (no parquet cache), as in earlier runs;
            # the files_io phase writes and reads files on purpose
            self._tables[name] = load_table(name, self.sf, cols, cache_dir=None)
            self.generate_s[name] = time.perf_counter() - t0
        return self._tables[name]

    def for_query(self, num: int):
        from velox_tpu_torch.connectors.tpch.queries import QUERY_COLUMNS

        return {name: self.table(name).select(cols) for name, cols in QUERY_COLUMNS[num].items()}

    def kept_bytes(self) -> dict:
        """The page-locked bytes each table keeps for the streaming scans of
        it and of its views (``Table.kept_bytes``)."""
        return {name: t.kept_bytes() for name, t in self._tables.items()}

    def release(self) -> None:
        """Drop every table, and with it the page-locked tiles it keeps, so
        that its host memory can go; a later ``table`` generates it again."""
        self._tables.clear()
        gc.collect()


def plan_query(num: int, tables, tile_rows: int, plan=None):
    """Plan the query (or take ``plan``), construct its executor (which runs
    the build sides) and upload the probe side's tiles; returns (executor,
    tiles, plan, report dict)."""
    import torch

    from velox_tpu_torch.connectors.tpch.plans import build_query
    from velox_tpu_torch.exec.runner import LocalExecutor

    t0 = time.perf_counter()
    if plan is None:
        plan = build_query(num, tables, device=DEVICE)  # fragments run on the card
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ex = LocalExecutor(plan, tile_rows=tile_rows, device=DEVICE)
    torch.cuda.synchronize()
    executor_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tiles = ex.device_tiles()
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    rep = dict(
        rows=ex.source_table.num_rows,
        rows_in={name: t.num_rows for name, t in tables.items()},
        tiles=len(tiles), capacity=ex.capacity, plan_s=plan_s, executor_s=executor_s,
        build_s=ex.build_seconds, upload_s=upload_s, kind=ex.kind,
        pool_reserved_bytes=ex.pool.reserved,
    )
    agg = ex.agg_exec
    if agg is not None:
        rep.update(
            mode=agg.mode, num_groups=agg.num_groups, piece_path=ex.use_piece,
            presorted=bool(getattr(agg.grouping, "presorted", False)),
            keys=[k.name for k in agg.key_infos],
            accumulators=[len(a.acc_ops) for a in agg.aggs],
        )
    return ex, tiles, plan, rep


def prepare_query(num: int, sf: float, tile_rows: int, tables=None):
    """Generate the tables (or take them from a ``TpchTables``), plan the
    query and upload its tiles; returns (executor, tiles, tables, report)."""
    cache = tables if tables is not None else TpchTables(sf)
    before = dict(cache.generate_s)
    query_tables = cache.for_query(num)
    gen = {k: v for k, v in cache.generate_s.items() if k not in before}
    ex, tiles, _, rep = plan_query(num, query_tables, tile_rows)
    return ex, tiles, query_tables, dict(generate_s=gen, **rep)


def check_result(num: int, ex, tiles, tables, want=None):
    """One run held against the numpy oracle (``check_frame``); returns
    (result Table, engine frame, oracle frame)."""
    result = ex.run(prefetched_tiles=tiles)
    got, want = check_frame(num, result, tables, want)
    return result, got, want


def check_frame(num: int, result, tables, want=None, sql=False):
    """A result Table held against the numpy oracle (or ``want``): integers,
    dates and strings exactly, DOUBLE to rtol 1e-9.  A SQL text's result is
    held in the oracle's column order (its names are the spec's).  Returns
    (engine frame, oracle frame)."""
    import pandas as pd

    from velox_tpu_torch.connectors.tpch.plans import ENGINE_OUTPUT_ORDER, oracle_result

    got = result.to_pandas().reset_index(drop=True)
    if want is None:
        want = oracle_result(num, tables).reset_index(drop=True)
    if sql:
        assert set(got.columns) >= set(want.columns), (list(got.columns), list(want.columns))
        got = got[list(want.columns)]
    elif num in ENGINE_OUTPUT_ORDER:
        got = got[ENGINE_OUTPUT_ORDER[num]]
    pd.testing.assert_frame_equal(got, want, check_dtype=False, rtol=1e-9)
    return got, want


def join_steps(ex):
    return [s[1] for s in ex.lin.steps if s[0] == "join"]


def sort_mode_report(ex):
    """What the last run of a sort-mode executor did."""
    joins = join_steps(ex)
    return dict(
        carry_groups=ex.carry_groups, carry_overflowed=ex.carry_overflowed,
        groups_out=ex.groups_out, pool_reserved_bytes=ex.pool.reserved,
        pool_peak_bytes=ex.pool.peak, spilled_bytes=unspilled(ex),
        joins=[dict(type=j.node.join_type.value, build_size=j.build_size,
                    build_keys=j.n_valid_build_keys, key_range=j.key_range,
                    packed_payload=j.bp_plan is not None,
                    fused=j._fused_static(ex.capacity) is not None,
                    state_bytes=j.state_bytes()) for j in joins],
    )


def time_primitives(runs: int, n: int = 1 << 24):
    """Median CUDA-event ms of the torch calls the sort-mode paths are made
    of, on ``n`` int64 values, each beside its byte bound (bytes read +
    written over the published memory rate)."""
    import torch

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(24)
    # packed words as the grouping sort sees them: 40 random key bits above
    # the row id
    bits = max(1, (n - 1).bit_length())
    keys = (torch.randint(0, 1 << 40, (n,), generator=gen, device=DEVICE) << bits) | torch.arange(
        n, dtype=torch.int64, device=DEVICE
    )
    operand = torch.randint(-(1 << 62), 1 << 62, (n,), generator=gen, device=DEVICE)
    perm = torch.sort(keys, stable=True).indices
    word = 8 * n
    # "the value at the last flagged row" as the join probes and the run
    # structure ask it: 1 row in 8 flagged, non-decreasing values
    from velox_tpu_torch.ops.segmented import last_flagged

    flags = torch.randint(0, 8, (n,), generator=gen, device=DEVICE) == 0
    iota = torch.arange(n, dtype=torch.int64, device=DEVICE)
    marked = torch.where(flags, iota, torch.full_like(iota, -1))
    assert torch.equal(last_flagged(flags, iota, -1), torch.cummax(marked, 0).values)
    cases = {
        # keys in, keys and int64 positions out
        "sort_stable_int64": (lambda: torch.sort(keys, stable=True), 3 * word),
        # positions and operand in (the operand's rows in random order), one out
        "index_select_int64": (lambda: operand.index_select(0, perm), 3 * word),
        "cumsum_int64": (lambda: torch.cumsum(operand, 0), 2 * word),
        "cummax_int64": (lambda: torch.cummax(operand, 0), 3 * word),
        # the same function both ways: the running maximum of the flagged
        # values (values + indices out) and the engine's helper (flags and
        # values in, values out)
        "last_flagged_by_cummax": (lambda: torch.cummax(marked, 0), 3 * word),
        "last_flagged_int64": (lambda: last_flagged(flags, iota, -1), 2 * word + n),
    }
    out = {"rows": n}
    for name, (fn, moved) in cases.items():
        out[name] = dict(ms=median_ms(fn, runs), bound_ms=moved / PEAK_BYTES_PER_S * 1e3,
                         bytes=moved)
    return out


def time_query(ex, tiles, runs: int):
    import torch

    def once():
        ex.run(prefetched_tiles=tiles)

    once()
    walls = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        once()  # ends in the result fetch, which waits for the device
        walls.append((time.perf_counter() - t0) * 1e3)
    engine_ms = statistics.median(walls)
    busy, top = device_busy_ms(once)
    return dict(
        engine_ms=engine_ms, runs_ms=walls, device_busy_ms=busy,
        host_share=None if busy is None else max(0.0, 1.0 - busy / engine_ms),
        top_kernels=top,
    )


def expansion_report(ex):
    """The expansion joins of a query's first run (the build sides' and
    barriers' ones, run while the executor was constructed, then the last
    pipeline's): how many tiles were expanded, the largest output bucket, the
    rows they held, and how many expansions had each bucket."""
    done = ex.build_expansions + ex.expansions
    buckets = {}
    for b, _ in done:
        buckets[str(b)] = buckets.get(str(b), 0) + 1
    return dict(
        expansions=len(done), max_bucket=max((b for b, _ in done), default=0),
        expanded_rows=sum(r for _, r in done), buckets=buckets,
    )


def run_tpch(num: int, tables, tile_rows: int, runs: int, want=None, sql=False):
    """One query (its hand-built plan, or its SQL text when ``sql``) from host
    tables as a caller of ``run_plan`` / ``run_sql`` waits for it: executor
    construction (every build side and barrier pipeline, the uploads) and the
    run, ending in the result fetch.  The first run is held against the
    oracle (or ``want``), then timed by ``whole_query_timing``.  A
    plan's line also has ``engine_ms``: its last pipeline over
    device-resident tiles, median of ``runs``, as the Q1 / Q3 lines time it.
    Returns (the line's fields, the oracle frame)."""
    import torch

    from velox_tpu_torch.connectors.tpch.queries import SQL
    from velox_tpu_torch.exec.runner import LocalExecutor
    from velox_tpu_torch.ops.group_piece import grouped_piece_sums
    from velox_tpu_torch.sql import plan_sql

    k2_before = grouped_piece_sums.launches
    plan = None
    t0 = time.perf_counter()
    if sql:
        plan = plan_sql(SQL[num], tables)
    plan_sql_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ex, tiles, plan, rep = plan_query(num, tables, tile_rows, plan=plan)
    result = ex.run(prefetched_tiles=tiles)
    # the first whole run: construction, upload and run (not the planning)
    walls = [(time.perf_counter() - t0 - rep["plan_s"]) * 1e3]
    rep["plan_s"] += plan_sql_s
    t0 = time.perf_counter()
    got, want = check_frame(num, result, tables, want=want, sql=sql)
    oracle_s = time.perf_counter() - t0
    first = dict(
        device_peak_bytes_first_run=torch.cuda.max_memory_allocated(), **expansion_report(ex),
        carry_groups=ex.carry_groups, carry_overflowed=ex.carry_overflowed,
        groups_out=ex.groups_out, pool_peak_bytes=ex.pool.peak,
        aggregations=aggregation_report(ex), spilled_bytes=unspilled(ex),
    )
    fields = dict(num=num, **rep, **first, oracle_s=oracle_s, result_rows=int(len(got)),
                  correct=True)
    if not sql:
        timing = time_query(ex, tiles, runs)
        timing["top_kernels"] = timing["top_kernels"][:4]
        fields.update(timing)
    del ex, tiles, result
    torch.cuda.empty_cache()

    def once():
        LocalExecutor(plan, tile_rows=tile_rows, device=DEVICE).run()

    fields.update(whole_query_timing(once, walls[0], timed=not sql))
    fields["k2_launches"] = grouped_piece_sums.launches - k2_before
    return fields, want


def unspilled(ex) -> int:
    """The bytes an executor of an earlier line spilled: none, asserted (the
    default configuration's threshold and no budget; the spill and Grace
    paths are the ``memory_spill`` phase's)."""
    assert ex.spill_stats["spilled_bytes"] == 0 and not ex.grace_joins, (
        ex.spill_stats, ex.grace_joins)
    return ex.spill_stats["spilled_bytes"]


def aggregation_report(ex):
    """Kind, carry slots, overflow and groups out of every aggregation an
    executor's last run ran: its barriers' (``barrier_aggregations``), then
    its own."""
    return [
        dict(kind=k, carry_groups=g, carry_overflowed=o, groups_out=n)
        for k, g, o, n in ex.barrier_aggregations
    ] + ([dict(kind=ex.kind, carry_groups=ex.carry_groups,
               carry_overflowed=ex.carry_overflowed, groups_out=ex.groups_out)]
         if ex.agg_exec is not None else [])


def _plan_kinds(plan):
    """The GroupId / Unnest nodes of a plan, top down: GroupId with its set
    count, Unnest with its unnested columns."""
    from velox_tpu_torch.plan.nodes import GroupIdNode, UnnestNode

    out, stack = [], [plan]
    while stack:
        node = stack.pop()
        if isinstance(node, GroupIdNode):
            out.append(f"GroupId(sets={len(node.grouping_sets)})")
        elif isinstance(node, UnnestNode):
            out.append(f"Unnest({','.join(node.unnest)})")
        stack.extend(node.sources)
    return out


def run_slice_text(name: str, cache, tile_rows: int, want=None, rows_only=False):
    """One text of ``WINDOW_SQL`` / ``FUNCTION_SQL`` (planned by
    ``plan_sql``) or one of the two ``window_plan`` plans over the tables of
    ``cache``, as a caller of ``run_sql`` / ``run_plan`` waits for it:
    executor construction (which runs the window, union, merge or join build
    sides and every barrier) and the run, ending in the result fetch.  The
    first run is held against the numpy oracle (``window_oracle`` /
    ``window_plan_oracle`` / ``function_oracle``; W1 and W2 against the
    oracles of Q2 and Q15, or ``want``); ``query_ms`` is that run
    (``whole_query_timing``).  ``rows_only``: the checked run alone, its
    time as ``first_run_ms``.
    Returns (the line's fields, the oracle frame of W1 / W2 or None)."""
    import torch

    from velox_tpu_torch.connectors.tpch.queries import QUERY_COLUMNS
    from velox_tpu_torch.exec.runner import LocalExecutor
    from velox_tpu_torch.plan import PlanBuilder
    from velox_tpu_torch.sql import plan_sql

    from velox_tpu_torch.vector.complex import largest_pool, reset_pool_record

    is_plan = name in WINDOW_PLAN_COLUMNS or (name in COMPLEX_COLUMNS and name not in COMPLEX_SQL)
    if name in COMPLEX_COLUMNS:
        columns = COMPLEX_COLUMNS[name]
    elif is_plan:
        columns = WINDOW_PLAN_COLUMNS[name]
    elif name in FUNCTION_SQL:
        columns = FUNCTION_COLUMNS[name]
    elif name in WINDOW_QUERY:
        columns = QUERY_COLUMNS[WINDOW_QUERY[name]]
    else:
        columns = WINDOW_COLUMNS[name]
    tables = {t: cache.table(t).select(list(c)) for t, c in columns.items()}
    t0 = time.perf_counter()
    if name in COMPLEX_COLUMNS:
        plan = (complex_plan(name, PlanBuilder, tables) if is_plan
                else plan_sql(COMPLEX_SQL[name], tables))
    else:
        plan = (window_plan(name, PlanBuilder, tables) if is_plan
                else plan_sql(FUNCTION_SQL.get(name) or WINDOW_SQL[name], tables))
    plan_s = time.perf_counter() - t0

    def once():
        ex = LocalExecutor(plan, tile_rows=tile_rows, device=DEVICE)
        return ex, ex.run()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_pool_record()
    t0 = time.perf_counter()
    ex, result = once()
    walls = [(time.perf_counter() - t0) * 1e3]
    peak = torch.cuda.max_memory_allocated()
    pool_capacity, pool_elements = largest_pool()
    t0 = time.perf_counter()
    extra = {}
    if name in COMPLEX_COLUMNS:
        extra = dict(check=check_complex(name, result, tables),
                     largest_pool_elements=pool_elements, largest_pool_capacity=pool_capacity,
                     render_s=ex.render_seconds, plan_node_kinds=_plan_kinds(plan))
    elif name in WINDOW_QUERY:
        _, want = check_frame(WINDOW_QUERY[name], result, tables, want=want, sql=True)
    elif is_plan:
        check_window_rows(result, *window_plan_oracle(name, tables))
    elif name in FUNCTION_SQL:
        check_window_rows(result, *function_oracle(name, tables))
    else:
        check_window_rows(result, *window_oracle(name, tables))
    oracle_s = time.perf_counter() - t0
    fields = dict(
        name=name, sf=cache.sf, tile_rows=tile_rows,
        rows_in={t: v.num_rows for t, v in tables.items()},
        result_rows=result.num_rows, plan_s=plan_s, build_s=ex.build_seconds,
        kind=ex.kind, window_passes=len(ex.window_chunks),
        window_largest_pass_rows=max((r for _, r in ex.window_chunks), default=0),
        window_largest_pass_capacity=max((c for c, _ in ex.window_chunks), default=0),
        **expansion_report(ex), aggregations=aggregation_report(ex),
        spilled_bytes=unspilled(ex), device_peak_bytes_first_run=peak,
        oracle_s=oracle_s, correct=True, **extra,
    )
    del ex, result
    torch.cuda.empty_cache()
    if rows_only:
        fields.update(first_run_ms=walls[0])
        return fields, want
    fields.update(whole_query_timing(once, walls[0], timed=False))
    return fields, want


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sf", type=float, default=10.0)
    ap.add_argument("--tile-rows", type=int, default=1 << 24)
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--ptxas", action="store_true", help="print ptxas -v of the build")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    faulthandler.dump_traceback_later(WATCHDOG_S - (time.perf_counter() - _T0), exit=True)

    from velox_tpu_torch.ops import cuda_build
    from velox_tpu_torch.ops.group_piece import grouped_piece_sums
    from velox_tpu_torch.ops.group_sum import grouped_int64_sums
    from velox_tpu_torch.ops.selective_sum import selective_sum

    wrappers = {
        "selective_sum": selective_sum,
        "grouped_piece_sums": grouped_piece_sums,
        "grouped_int64_sums": grouped_int64_sums,
    }
    t_begin = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    try:
        import pyarrow

        pyarrow_import = f"ok {pyarrow.__version__}"
    except ImportError as exc:
        pyarrow_import = f"fails: {exc}"
    say("device", kind=kind, count=torch.cuda.device_count(), nvidia_smi=smi,
        torch=torch.__version__, cuda=torch.version.cuda, pyarrow_import=pyarrow_import)

    t0 = time.perf_counter()
    path = cuda_build.build(verbose=args.ptxas)
    cuda_build.library()
    say("build", seconds=time.perf_counter() - t0, nvcc_seconds=cuda_build.build_seconds,
        library=path.rsplit("/", 1)[-1], flags=" ".join(cuda_build.NVCC_FLAGS))

    bw = measured_bandwidth(args.runs)
    say("bandwidth", measured_bytes_per_s=bw, published_bytes_per_s=PEAK_BYTES_PER_S)

    cache = TpchTables(args.sf)
    ex6, tiles6, tables6, rep6 = prepare_query(6, args.sf, args.tile_rows, cache)
    ex1, tiles1, tables1, rep1 = prepare_query(1, args.sf, args.tile_rows, cache)
    assert rep1["piece_path"] is True and rep6["piece_path"] is False, (rep1, rep6)

    records = check_kernels(ex1, tiles1[0], tiles6[0], args.runs)
    say("edges", cases="[name, R, stages, chunk_rows, head, body_rows, tail, smem_bytes]",
        **check_edges())
    say("live_groups", **contention_sweep(ex1, tiles1[0], args.runs))

    # ---- the main path, with the counts set to 0 just before it
    for w in wrappers.values():
        w.launches = 0
    result6, got6, want6 = check_result(6, ex6, tiles6, tables6)
    result1, got1, want1 = check_result(1, ex1, tiles1, tables1)
    oracles = {6: want6, 1: want1}  # the SQL texts are held against these too
    q6_exact = int(result6.columns["revenue"][0])  # unscaled DECIMAL(18,4)
    passing = drive_ops(tiles6, ex1, tiles1, result1, q6_exact)
    q12_k3, q12_tiles, q12_call, q12_k5, q12_probe = drive_q12(cache, args.tile_rows)
    launches = {name: w.launches for name, w in wrappers.items()}
    assert launches["grouped_piece_sums"] == len(tiles1), launches
    assert launches["selective_sum"] == len(tiles6), launches
    # Q12: two exact BIGINT sums of three limbs and the row count, a tile
    assert q12_k3 == 7 * q12_tiles, (q12_k3, q12_tiles)
    # Q12's join: one hashed probe a tile (4 at SF 10)
    assert q12_k5 == q12_tiles, (q12_k5, q12_tiles)
    assert launches["grouped_int64_sums"] == len(tiles1) + q12_k3, launches
    assert all(n > 0 for n in launches.values()), launches
    say("main_path", launches=launches, q6_rows_passing=passing,
        q6_revenue=float(got6["revenue"][0]), q1_groups=int(len(got1)),
        q1_count_order=[int(x) for x in got1["count_order"]],
        q12_k3_launches=q12_k3, q12_k5_launches=q12_k5, q12_tiles=q12_tiles)

    # the kernels line, with K3 at the shape Q12's executor gave it; each
    # record's launches are those of the main path at its shape
    records.append(k3_at_q12_record(q12_call, args.runs, q12_k3))
    records.append(k5_at_q12_record(q12_probe, args.runs, q12_k5))
    del q12_call, q12_probe
    for r, n in zip(records, (launches["selective_sum"], launches["grouped_piece_sums"],
                              len(tiles1))):
        r["launches"] = n
    for r in records:
        r["bound_ms_at_measured_bandwidth"] = r["bytes"] / bw * 1e3
    say("kernels", kernel_names=[r["name"] for r in records], records=records)

    # ---- timings
    summary = {}
    for num, ex, tiles, rep in ((6, ex6, tiles6, rep6), (1, ex1, tiles1, rep1)):
        before = grouped_piece_sums.launches
        timing = time_query(ex, tiles, args.runs)
        k2 = grouped_piece_sums.launches - before
        if num == 1:
            # warm-up + timed runs + the profiled run, one launch per tile each
            assert k2 == len(tiles) * (args.runs + 2), (k2, len(tiles), args.runs)
        else:
            assert k2 == 0, k2
        rows_per_s = rep["rows"] / (timing["engine_ms"] * 1e-3)
        say(f"q{num}", sf=args.sf, **rep, **timing, rows_per_s=rows_per_s,
            k2_launches_while_timing=k2, correct=True)
        summary[f"plan q{num}"] = [timing["engine_ms"], timing["device_busy_ms"], rep["build_s"],
                                   None]

    del ex6, tiles6, tables6, ex1, tiles1, tables1, result6, result1
    torch.cuda.empty_cache()

    say("primitives", card=smi, published_bytes_per_s=PEAK_BYTES_PER_S,
        **time_primitives(args.runs))

    # ---- the sort-mode paths: joins, sort-mode grouping, device TopN.  They
    # launch none of the hand-written kernels, and must not.
    before = dict((name, w.launches) for name, w in wrappers.items())
    from velox_tpu_torch.ops.dict_like import dict_like
    from velox_tpu_torch.ops.hash_probe import hash_probe

    for num in (3, 13):
        before_gen = dict(cache.generate_s)
        tables = cache.for_query(num)
        gen = {k: v for k, v in cache.generate_s.items() if k not in before_gen}
        dict_like.launches = 0  # Q13's LIKE: one launch for its plan, counted from here
        ex, tiles, plan, rep = plan_query(num, tables, args.tile_rows)
        assert ex.kind == "sort_agg_device", ex.kind
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        k5_before = hash_probe.launches
        _, got, oracles[num] = check_result(num, ex, tiles, tables)
        check_s = time.perf_counter() - t0
        # a presorted grouping (Q3 over several tiles, 0 at SF 10) reads the
        # merge probe's key order; otherwise one hashed probe a tile
        k5 = hash_probe.launches - k5_before
        assert k5 == (0 if ex.agg_exec.presorted else len(tiles)), (num, k5, len(tiles))
        first = sort_mode_report(ex)
        first["device_peak_bytes_first_run"] = torch.cuda.max_memory_allocated()
        assert not ex.carry_overflowed, first
        extra = {"k5_launches": k5}
        if num == 3:
            # several tiles: grouped without a sort, merged through the carry
            assert rep["tiles"] == 1 or (rep["presorted"] and ex.carry_groups), (rep, first)
            extra["top_row"] = [int(got["l_orderkey"][0]), float(got["revenue"][0])]
        else:
            # Q13's grouping over orders is its join's build side: time that
            # plan alone too (one executor, the tile kept on the device)
            from velox_tpu_torch.exec.runner import LocalExecutor

            build_ex = LocalExecutor(join_steps(ex)[0].node.right, tile_rows=args.tile_rows,
                                     device=DEVICE)
            build_tiles = build_ex.device_tiles()
            extra["build_side"] = dict(
                kind=build_ex.kind, rows=build_ex.source_table.num_rows,
                tiles=len(build_tiles), keys=[k.name for k in build_ex.agg_exec.key_infos],
                **time_query(build_ex, build_tiles, args.runs),
                groups_out=build_ex.groups_out, carry_groups=build_ex.carry_groups,
            )
            del build_ex, build_tiles
            # once more with small tiles, for the rows only: the build side's
            # 2^22-row tiles go through the carry merge
            small = 1 << 22
            ex4, tiles4, _, rep4 = plan_query(num, tables, small, plan=plan)
            check_result(num, ex4, tiles4, tables, want=oracles[num])
            extra["again_at_tile_rows"] = dict(
                tile_rows=small, correct=True, build_s=rep4["build_s"],
                orders_tiles=-(-tables["orders"].num_rows // small),
            )
            del ex4, tiles4
        timing = time_query(ex, tiles, args.runs)
        if num == 13:
            # the LIKE's result is kept on the plan's node: every executor of
            # the one plan above, and every timed run, reads the first launch
            assert dict_like.launches == 1, dict_like.launches
            records.append(dict_like_record(tables["orders"].string_tables["o_comment"],
                                            args.runs, dict_like.launches))
            extra["k4"] = {k: records[-1][k] for k in
                           ("launches", "ms", "plain_ms", "bound_ms", "share_of_bound", "entries",
                            "bytes", "matches")}
        rows_per_s = rep["rows"] / (timing["engine_ms"] * 1e-3)
        say(f"q{num}", **{
            "sf": args.sf, "generate_s": gen, **rep, **timing, "rows_per_s": rows_per_s,
            "oracle_and_first_run_s": check_s, "result_rows": int(len(got)),
            "correct": True, **first, **sort_mode_report(ex), **extra,
        })
        summary[f"plan q{num}"] = [timing["engine_ms"], timing["device_busy_ms"], rep["build_s"],
                                   None]
        del ex, tiles, tables, plan
        torch.cuda.empty_cache()
    assert before == dict((name, w.launches) for name, w in wrappers.items())

    # ---- the other eighteen plans, then the 22 texts through the SQL front
    # end; a text is held against the oracle of its query's plan
    small = TpchTables(min(args.sf, 1.0))
    for num in range(1, 23):
        if num in (1, 3, 6, 13):
            continue
        if num in PLANS_AT_SF1 and args.sf > 1:
            fields, _ = run_tpch(num, small.for_query(num), PLANS_AT_SF1[num], args.runs)
            # the sort-mode carry overflows into the host merge, as at SF 10
            assert any(a["carry_overflowed"] for a in fields["aggregations"]), fields
            say("tpch_plans", sf=small.sf, tile_rows=PLANS_AT_SF1[num], **fields)
        else:
            fields, oracles[num] = run_tpch(num, cache.for_query(num), args.tile_rows, args.runs)
            say("tpch_plans", sf=args.sf, **fields)
        summary[f"plan q{num}"] = [fields["engine_ms"], fields["device_busy_ms"], fields["build_s"],
                                   fields["query_ms"]]
    for num in range(1, 23):
        if num in SQL_AT_SF1 and args.sf > 1:
            fields, _ = run_tpch(num, small.for_query(num), args.tile_rows, args.runs, sql=True)
            say("tpch_sql", sf=small.sf, **fields)
        else:
            fields, _ = run_tpch(num, cache.for_query(num), args.tile_rows, args.runs,
                                 want=oracles[num], sql=True)
            say("tpch_sql", sf=args.sf, **fields)
        summary[f"sql q{num}"] = [None, None, fields["build_s"], fields["query_ms"]]

    # ---- the window / set-operation slice: windows (W1-W4), FULL joins (F1,
    # F2), UNION ALL (U1), a nested-loop join (N1), MergeExchange and
    # topn_row_number (the plans).  They launch neither K2 nor
    # selective_sum, and must not; a direct-mode int64 sum takes K3
    # (``k3_launches``).
    before = launches_but_k3(wrappers)
    names = [*WINDOW_SQL, *WINDOW_PLAN_COLUMNS]
    for name in names:
        k3_before = grouped_int64_sums.launches
        if name in WINDOW_AT_SF1 and args.sf > 1:
            fields, _ = run_slice_text(name, small, WINDOW_AT_SF1[name])
        else:
            fields, _ = run_slice_text(name, cache, args.tile_rows,
                                       want=oracles.get(WINDOW_QUERY.get(name)))
        fields["k3_launches"] = grouped_int64_sums.launches - k3_before
        say("tpch_window", **fields)
        summary[f"window {name}"] = [None, None, fields["build_s"], fields["query_ms"]]
    assert before == launches_but_k3(wrappers)

    # ---- the function slice: the new aggregates in direct mode (A1) and in
    # sort mode through the device carry merge (A2), the scalar functions
    # (S1, S2), long decimals (D1) and NULL window keys (W5, and W5 again at
    # SF 1 in passes of whole partitions).  They launch neither K2 nor
    # selective_sum, and must not; the direct-mode int64 sums of A1 and D1
    # take K3 (``k3_launches``).
    before = launches_but_k3(wrappers)
    for name in FUNCTION_SQL:
        k3_before = grouped_int64_sums.launches
        if name in FUNCTION_AT_SF1 and args.sf > 1:
            fields, _ = run_slice_text(name, small, FUNCTION_AT_SF1[name])
            if name != "W5":
                [agg] = fields["aggregations"]
                tiles = -(-fields["rows_in"]["lineitem"] // FUNCTION_AT_SF1[name])
                assert tiles > 1, fields
                if name in ("S1", "A2"):
                    assert agg["kind"] == "sort_agg_device" and agg["carry_groups"], agg
                else:
                    assert agg["kind"] == "direct_agg", agg
        else:
            fields, _ = run_slice_text(name, cache, args.tile_rows)
        if name == "A2":
            [agg] = fields["aggregations"]
            assert agg["kind"] == "sort_agg_device" and not agg["carry_overflowed"], agg
        if name == "W5":  # one pass a window node over every orders row
            assert fields["window_largest_pass_rows"] == fields["rows_in"]["orders"], fields
        fields["k3_launches"] = grouped_int64_sums.launches - k3_before
        if name in ("A1", "D1"):  # direct-mode int64 sums
            assert fields["k3_launches"] > 0, fields
        say("tpch_functions", **fields)
        summary[f"functions {name}"] = [None, None, fields["build_s"], fields["query_ms"]]
    fields, _ = run_slice_text("W5", small, W5_CHUNKED_TILE_ROWS, rows_only=True)
    assert fields["window_passes"] > 1, fields
    say("tpch_functions", **fields)
    fields, _ = run_slice_text("A2", small, A2_HOST_MERGE_TILE_ROWS, rows_only=True)
    [agg] = fields["aggregations"]
    assert agg["kind"] == "sort_agg_device" and agg["carry_overflowed"], agg
    say("tpch_functions", **fields)
    assert before == launches_but_k3(wrappers)

    # ---- the complex-type slice: collect aggregates (C1, C5, C6, C8),
    # array constructors and lambdas (C2), GroupId (C3), a VARCHAR cast key
    # rendered on the host (C4), array_join (C5), a collect back on the card
    # (C6), split + Unnest (C7), a collect feeding an Unnest (C8).  They
    # launch neither K2 nor selective_sum, and must not; a direct-mode int64
    # sum takes K3 (``k3_launches``).  A text cut to SF 1
    # (``COMPLEX_AT_SF1``) still asserts the path it is there for.
    before = launches_but_k3(wrappers)
    for name in [*COMPLEX_SQL, "C7", "C8"]:
        k3_before = grouped_int64_sums.launches
        if name in COMPLEX_AT_SF1 and args.sf > 1:
            fields, _ = run_slice_text(name, small, COMPLEX_AT_SF1[name])
        else:
            fields, _ = run_slice_text(name, cache, args.tile_rows)
        kinds = [a["kind"] for a in fields["aggregations"]]
        if name in ("C1", "C5", "C6", "C8"):
            assert "collect_agg" in kinds, fields
        if name == "C1" and args.sf > 1:
            assert fields["rows_in"]["orders"] > COMPLEX_AT_SF1["C1"], fields  # two tiles
        if name == "C3":
            assert fields["plan_node_kinds"] == ["GroupId(sets=3)"], fields
        if name in ("C7", "C8"):
            # the oracle holds every unnested row (C7: the word counts, C8:
            # the row count); the unnest batch is the largest pool
            assert any(k.startswith("Unnest") for k in fields["plan_node_kinds"]), fields
            assert 0 < fields["largest_pool_elements"] <= fields["check"]["elements"], fields
        if name == "C5":
            assert fields["render_s"] > 0, fields
        fields["k3_launches"] = grouped_int64_sums.launches - k3_before
        say("tpch_complex", **fields)
        summary[f"complex {name}"] = [None, None, fields["build_s"], fields["query_ms"]]
    assert before == launches_but_k3(wrappers)

    # ---- the sketch / Spark slice (H1, H2, P1, P2, B1, X1, X2, X3), each
    # against its numpy oracle with the path it is there for asserted; then
    # dbgen at SF 1 and the published TPC-H answers
    for name in SPARK_NAMES:
        before = dict((n, w.launches) for n, w in wrappers.items())
        if args.sf > 1:
            fields = run_spark_text(name, small, SPARK_AT_SF1[name])
        else:
            fields = run_spark_text(name, cache, args.tile_rows)
        fields["hand_kernel_launches"] = {n: w.launches - before[n] for n, w in wrappers.items()}
        say("spark_sketch", **fields)
        summary[f"spark {name}"] = [None, None, fields["build_s"], fields["query_ms"]]
    fields = run_dbgen_golden(1.0, DBGEN_TILE_ROWS)
    # dbgen keeps gen.py's column representation: Q1 takes the piece path
    assert fields["q1_piece_path"] and fields["q1_k2_launches"] > 0, fields
    say("dbgen_golden", **fields)
    summary["dbgen q1 q6 q3 q13"] = [None, None, fields["generate_s"],
                                     sum(fields[f"q{n}_s"] for n in (1, 6, 3, 13)) * 1e3]

    # ---- the files / host-formats slice (I1-I7): a Hive dataset written and
    # read back, Q1 and Q6 over it, parquet pruning, Arrow streams, the serde
    # and the saver, SEQUENCE / BIAS columns.  I2's Q1 launches
    # grouped_piece_sums once a tile (the counts set to 0 just before its
    # first run and read just after; asserted)
    import os
    import shutil

    from velox_tpu_torch.io.cache import DEFAULT_CACHE
    from velox_tpu_torch.ops.cuda_build import build_dir

    dataset_root = os.path.join(build_dir(), "lineitem_by_year")
    t0 = time.perf_counter()
    for fields in run_files_io(cache, args.tile_rows, args.runs, DEVICE,
                               os.path.join(build_dir(), "files_io"), wrappers, oracles,
                               dataset_root=dataset_root):
        assert fields["correct"], fields
        say("files_io", sf=args.sf, **fields)
    summary["files_io I1-I7"] = [None, None, None, (time.perf_counter() - t0) * 1e3]

    # ---- the memory / spill slice (M1-M5): the carry's fallback to the
    # spilling host merge, the external sort, the Grace join, the window
    # spill and grouped execution over I1's dataset; each path asserted by
    # its injection point's hits, each line against the numpy oracle and the
    # same query without a budget.  Then Substrait (S1) and the operator
    # stats / trace / profiler (O1).
    try:
        for fields in run_memory_spill(cache, args.tile_rows, DEVICE,
                                       os.path.join(build_dir(), "memory_spill"), dataset_root,
                                       wrappers, oracles):
            assert fields["correct"], fields
            say("memory_spill", sf=args.sf, **fields)
            summary[f"memory_spill {fields['line']}"] = [None, None, None,
                                                         fields["line_s"] * 1e3]
    finally:
        shutil.rmtree(dataset_root, ignore_errors=True)
        DEFAULT_CACHE.clear()
    for fields in run_substrait_obs(cache, args.tile_rows, DEVICE,
                                    os.path.join(build_dir(), "substrait_obs"), wrappers,
                                    oracles):
        assert fields["correct"], fields
        say("substrait_obs", sf=args.sf, **fields)
        summary[f"substrait_obs {fields['line']}"] = [None, None, None,
                                                      fields["line_s"] * 1e3]
    # ---- the distributed slice: DistributedExecutor over 4 gloo ranks that
    # share the card (Q6, Q1, Q3, Q13 at --sf, DX-skew, the 22 plans at SF 1)
    # and over NCCL at world size 1 (DX-nccl); every line row-exact
    torch.cuda.empty_cache()
    kept = cache.kept_bytes()  # the distributed slice releases these tables
    t0 = time.perf_counter()
    for fields in run_distributed(cache, small, DEVICE, oracles, args.tile_rows):
        assert fields["correct"], fields
        say("distributed", **fields)
        summary[f"distributed {fields['line']}"] = [None, None, None, fields["query_s"] * 1e3]
    say("distributed_total", seconds=time.perf_counter() - t0)
    say("generate", sf=args.sf, seconds=cache.generate_s, sf1_seconds=small.generate_s)
    sf1_kept = small.kept_bytes()
    say("page_locked_kept", sf=args.sf, bytes=sum(kept.values()), by_table=kept,
        sf1_bytes=sum(sf1_kept.values()), sf1_by_table=sf1_kept)

    keys = ("name", "shape", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "share_of_bound", "geometry")
    say("summary", card=smi,
        columns="[engine_ms, device_busy_ms, build_s, query_ms]", **summary)
    say("total", seconds=time.perf_counter() - t_begin)
    faulthandler.cancel_dump_traceback_later()
    print(smi, flush=True)
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in records]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
