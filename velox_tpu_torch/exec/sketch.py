"""Sketch aggregates as plan rewrites: bounded-state approx_distinct,
approx_percentile and bloom_filter_agg.

Counterpart of the JAX package's ``exec/sketch.py``, with the same rewrites,
hashes and estimators.  Reference: velox/common/hyperloglog/DenseHll.h (+
SparseHll.h) — the reference's approx_distinct keeps an HLL register file per
group and merges register-wise maxima.

This engine's grouped aggregation is SORT-based, and HyperLogLog is itself
"max(rho) per (group, bucket)", so approx_distinct lowers into machinery that
already exists, as a plan rewrite:

    agg g: approx_distinct(x)
      ->  project  b = top-11-bits(hash64(x)), r = clz(remainder)+1
      ->  agg (g, b): max(r)                      -- the HLL register file,
                                                  -- one ROW per live register
      ->  project  w = 2^(54 - max_r)             -- integer-exact harmonic term
      ->  agg g: count(*) as V, sum(w) as S
      ->  project  round(HLL estimate(V, S))      -- + linear counting branch

State is bounded by min(NDV, groups x 2048) rows; merges are exact integer
max/sum, so tiling and merge order cannot change the estimate.  m = 2048
registers matches the reference's default standard error (~2.3%).

The device functions (``hll_bucket64``, ``hll_rho64``, ``dd_bucket64``) run
on int64 lanes (``ops/u64.py``).  A DOUBLE hashes
by its IEEE bits (``view(torch.int64)``), as the JAX package's ``f64_to_word``
does on the CPU.

Mixed aggregation nodes: when sketch-eligible aggregates share a node with
exact ones, the node SPLITS — one exact node for the rest, one
single-aggregate node per sketch (each then rewritten as above) — and the
pieces re-join on NULL-safe grouping-key equality (is_null flag + coalesced
value per key), with a final projection restoring column order.
approx_distinct over an all-NULL group coalesces to 0 there (Presto
semantics); a lone approx_distinct drops such a group.  ``PlanBuilder``
turns an approx_distinct that shares its node with other aggregates into an
exact distinct count before this rewrite sees it, so a mixed node with one
comes only from an ``AggregationNode`` built directly.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..dtypes import BIGINT, DOUBLE
from ..expr.ir import Call, FieldAccess
from ..ops.u64 import srl64
from ..parallel.exchange import hash64  # the register hash: the exchange's 64-bit mix
from ..plan.nodes import AggregationNode, PlanNode

_M_REG = 2048  # registers (log2m = 11), reference default stderr ~2.3%
_ALPHA = 0.7213 / (1.0 + 1.079 / _M_REG)
_SCALE = float(1 << 54)  # integer harmonic-term scale: w = 2^(54 - rho)

# approx_percentile sketch: DDSketch-style log buckets with 0.5% relative
# value error (gamma = (1+a)/(1-a), a = 0.005).  The reference's KLL sketch
# (functions/lib/KllSketch.h) bounds RANK error instead — a documented
# deviation; log-bucket counting is a pure grouped count aggregation, which
# is this engine's cheapest primitive.
_DD_ALPHA = 0.005
_DD_GAMMA = (1.0 + _DD_ALPHA) / (1.0 - _DD_ALPHA)
_DD_OFF = 1 << 21  # keeps positive-sign buckets positive for any magnitude


def _bits_of(a: torch.Tensor) -> torch.Tensor:
    """A fixed-width device value as a 64-bit word: ints, dates, decimals and
    dictionary codes widen; a DOUBLE gives its IEEE bits (distinct doubles
    keep distinct bit patterns)."""
    if a.is_floating_point():
        return a.to(torch.float64).view(torch.int64)
    return a.to(torch.int64)


def hll_bucket(a: torch.Tensor) -> torch.Tensor:
    """The register of a value: the top 11 bits of its hash."""
    return srl64(hash64(_bits_of(a)), 53)


def hll_rho(a: torch.Tensor) -> torch.Tensor:
    """Leading-zero count of the 53-bit remainder (top-aligned), + 1: a bit
    smear and a popcount give the position of the highest set bit.  An
    all-zero remainder gives 65, which the estimate's shift clamps."""
    w = hash64(_bits_of(a)) << 11
    for k in (1, 2, 4, 8, 16, 32):
        w = w | srl64(w, k)
    x = w - (srl64(w, 1) & 0x5555555555555555)
    x = (x & 0x3333333333333333) + (srl64(x, 2) & 0x3333333333333333)
    x = (x + srl64(x, 4)) & 0x0F0F0F0F0F0F0F0F
    ones = srl64(x * 0x0101010101010101, 56)
    return 64 - ones + 1


def dd_bucket(a: torch.Tensor) -> torch.Tensor:
    """Sign-aware log-gamma bucket of the VALUE (not its bits): order-
    preserving, 0.5% relative value error per bucket."""
    x = a.to(torch.float64)
    logg = torch.log(torch.clamp(torch.abs(x), min=1e-300)) / math.log(_DD_GAMMA)
    b = torch.ceil(logg).to(torch.int64) + _DD_OFF
    zero = torch.zeros_like(b)
    return torch.where(x == 0, zero, torch.where(x < 0, -b, b))


def _register_hll_functions():
    from ..expr.registry import ANY, DEFAULT_REGISTRY as reg

    if reg.signatures("hll_bucket64"):
        return
    reg.register("hll_bucket64", [ANY], BIGINT, lambda ctx, out_t, arg_ts, a: hll_bucket(a))
    reg.register("hll_rho64", [ANY], BIGINT, lambda ctx, out_t, arg_ts, a: hll_rho(a))
    reg.register("dd_bucket64", [ANY], BIGINT, lambda ctx, out_t, arg_ts, a: dd_bucket(a))


def _lit(x: float) -> str:
    """A DOUBLE literal: plain decimal literals parse as DECIMAL (fixed
    point) and overflow int64 under multiplication; e-notation is DOUBLE."""
    return f"{float(x):.17e}"


def _estimate_expr(v_name: str, s_name: str) -> str:
    """The HLL estimator over (live-register count V, scaled harmonic sum S)
    as one scalar expression (Flajolet et al.; linear counting below 2.5m)."""
    m = float(_M_REG)
    v = f"cast({v_name} as double)"
    s = f"(cast({s_name} as double) / {_lit(_SCALE)})"
    # absent registers contribute 2^0 = 1 each
    raw = f"({_lit(_ALPHA * m * m)} / ({s} + ({_lit(m)} - {v})))"
    empty_guard = f"if({v_name} >= {_M_REG}, {_lit(1.0)}, {_lit(m)} - {v})"
    lc = f"({_lit(m)} * ln({_lit(m)} / {empty_guard}))"
    cond = f"{raw} <= {_lit(2.5 * m)} and {v_name} < {_M_REG}"
    return f"cast(round(if({cond}, {lc}, {raw})) as bigint)"


def _DECIMAL_KIND():
    from ..dtypes import TypeKind

    return TypeKind.DECIMAL


def dd_bucket_value(buckets: np.ndarray) -> np.ndarray:
    """Representative value of a dd_bucket64 bucket (log-space midpoint)."""
    mag = np.abs(buckets).astype(np.float64) - _DD_OFF
    val = np.power(_DD_GAMMA, mag - 0.5)
    return np.where(buckets == 0, 0.0, np.sign(buckets) * val)


def _percentile_eligible(c) -> bool:
    """approx_percentile(x, p) / (x, w, p) / (x, p, accuracy) /
    (x, w, p, accuracy) over plain numeric columns rewrites to the bounded
    sketch form (kll rank-compression by default, dd-buckets as fallback)."""
    return (
        c.name == "approx_percentile"
        and len(c.args) in (2, 3, 4)
        and all(isinstance(a, FieldAccess) for a in c.args)
        and not c.args[0].dtype.is_string
        and c.args[0].dtype.kind != _DECIMAL_KIND()
    )


def _percentile_args(cargs):
    """Split approx_percentile's argument forms (Presto signatures:
    the weight is an integer column; percentage/accuracy are fractional).
    Returns (xarg, warg|None, parg, accuracy_arg|None)."""
    if len(cargs) == 2:
        return cargs[0], None, cargs[1], None
    if len(cargs) == 4:
        return cargs[0], cargs[1], cargs[2], cargs[3]
    # 3 args: (x, w, p) when the middle column is integral, else (x, p, acc)
    if cargs[1].dtype.is_integer:
        return cargs[0], cargs[1], cargs[2], None
    return cargs[0], None, cargs[1], cargs[2]


def _bloom_eligible(c) -> bool:
    """bloom_filter_agg(x[, estimatedNumItems[, numBits]]) (reference:
    sparksql/aggregates/BloomFilterAggAggregate.cpp).  The builder
    auto-projects every argument to a column; size arguments must resolve
    to literals through provenance (_const_field_value) at rewrite time."""
    return (
        c.name == "bloom_filter_agg"
        and 1 <= len(c.args) <= 3
        and all(isinstance(a, FieldAccess) for a in c.args)
    )


def _const_field_value(src: PlanNode, name: str):
    """Resolve a column to its defining literal, walking pass-through
    projects and filters; None when not a literal."""
    from ..expr.ir import Constant
    from ..plan.nodes import FilterNode, ProjectNode

    node = src
    while node is not None:
        if isinstance(node, ProjectNode):
            if name not in node.names:
                return None
            e = node.exprs[node.names.index(name)]
            if isinstance(e, Constant):
                return e.value
            if isinstance(e, FieldAccess):
                name = e.name
                node = node.source
                continue
            return None
        if isinstance(node, FilterNode):
            node = node.source
            continue
        return None
    return None


def _rewrite_bloom(node: AggregationNode) -> PlanNode:
    """bloom_filter_agg -> per-row (block index, block mask) projections +
    grouped bitwise-OR + a per-group assemble collect into the Spark wire
    format.  The build is scatter-free on device: OR-ing per block IS the
    insert (utils/spark_bloom.py)."""
    from ..expr.parser import parse_expr
    from ..plan.nodes import FilterNode, ProjectNode
    from ..utils.spark_bloom import (
        DEFAULT_NUM_BITS,
        num_words,
        register_bloom_device_fns,
    )

    register_bloom_device_fns()
    call = node.aggregates[0]
    gkeys = list(node.grouping_keys)
    out_name = node.agg_names[0]
    xcol = call.args[0].name
    src = node.source
    size_args = []
    for a in call.args[1:]:
        v = _const_field_value(src, a.name)
        if v is None:
            raise NotImplementedError(
                "bloom_filter_agg size arguments must be literals "
                "(reference requires constants too: "
                "BloomFilterAggAggregate.cpp setConstantArgument)"
            )
        size_args.append(int(v))
    if len(size_args) == 2:
        bits = size_args[1]
    elif len(size_args) == 1:
        bits = size_args[0] * 8
    else:
        bits = DEFAULT_NUM_BITS
    nwords = num_words(bits)

    def proj(source, names, texts):
        s = source.output_schema
        return ProjectNode(
            source, tuple(names), tuple(parse_expr(t, s) for t in texts)
        )

    # NO pre-filter on x IS NOT NULL: the word/mask projections propagate
    # NULL (default-null semantics), so all-NULL groups survive to the
    # assembler and come out as rows with a NULL filter — the reference's
    # behavior (BloomFilterAggAggregateTest emptyInput/nullBloomFilter);
    # a filter here would make those groups vanish
    p1 = proj(
        src,
        gkeys + ["__bf_w", "__bf_m", "__bf_n"],
        gkeys
        + [
            f"__bloom_word64({xcol}, {nwords})",
            f"__bloom_mask64({xcol})",
            str(nwords),
        ],
    )
    a1 = AggregationNode(
        p1,
        node.step,
        tuple(gkeys + ["__bf_w"]),
        ("__bf_b", "__bf_nn"),
        (
            Call(BIGINT, "bitwise_or_agg", (FieldAccess(BIGINT, "__bf_m"),)),
            Call(BIGINT, "min", (FieldAccess(BIGINT, "__bf_n"),)),
        ),
    )
    from ..dtypes import VARBINARY

    return AggregationNode(
        a1,
        node.step,
        tuple(gkeys),
        (out_name,),
        (
            Call(
                VARBINARY,
                "__bloom_assemble",
                (
                    FieldAccess(BIGINT, "__bf_w"),
                    FieldAccess(BIGINT, "__bf_b"),
                    FieldAccess(BIGINT, "__bf_nn"),
                ),
            ),
        ),
    )


def _rewrite_percentile_kll(node: AggregationNode, cfg) -> PlanNode:
    """approx_percentile with RANK-error semantics (the reference's KllSketch
    contract, velox/functions/lib/KllSketch.h) as a plan rewrite:

        agg g: approx_percentile(x[, w], p[, accuracy])
          -> filter x is not null
          -> agg (g, x): c = count(*) | sum(w), p carried by min
          -> window over (partition by g order by x):
                 cum = sum(c) rows unbounded preceding..current row
                 tot = sum(c) rows unbounded preceding..unbounded following
          -> filter KEEP rows whose cumulative rank crosses a multiple of
             tot/m (plus each group's first and last row)
          -> agg g: __kll_quantile(x, cum, tot, p)   -- tiny per-group collect

    The kept rows are a deterministic rank-compressed ECDF: between two kept
    points the cumulative rank advances at most ~2*tot/m, so the reported
    quantile's rank error is <= 2/m of the group size — the KLL guarantee
    shape, with determinism instead of the reference's random compaction
    (merge order cannot change results; cf. the approx_distinct design note
    above).  State is bounded by m+2 rows per group after the keep filter;
    the (g, x) pre-aggregation upstream is ordinary grouped execution with
    the engine's tiling/spill.  m defaults to config.kll_points; an explicit
    accuracy argument (resolved to a literal) sets m = ceil(2/accuracy)."""
    import math as _math

    from ..dtypes import BIGINT as _BI
    from ..expr.parser import parse_expr
    from ..plan.nodes import FilterNode, ProjectNode
    from .window import WindowNode, parse_window_call

    gkeys = list(node.grouping_keys)
    out_name = node.agg_names[0]
    cargs = node.aggregates[0].args
    xarg, warg, parg, aarg = _percentile_args(cargs)
    xcol, pcol = xarg.name, parg.name
    src = node.source
    m = int(getattr(cfg, "kll_points", 256))
    if aarg is not None:
        acc = _const_field_value(src, aarg.name)
        if acc is not None:
            accf = float(acc)
            if hasattr(aarg.dtype, "scale") and aarg.dtype.kind == _DECIMAL_KIND():
                accf /= 10.0 ** aarg.dtype.scale
            if accf > 0:
                m = max(m, int(_math.ceil(2.0 / accf)))

    def proj(source, names, texts):
        s = source.output_schema
        return ProjectNode(
            source, tuple(names), tuple(parse_expr(t, s) for t in texts)
        )

    flt = FilterNode(src, parse_expr(f"{xcol} is not null", src.output_schema))
    p1 = proj(
        flt,
        gkeys + ["__kx", "__kp"] + (["__kw"] if warg is not None else []),
        gkeys + [xcol, pcol] + ([warg.name] if warg is not None else []),
    )
    a1 = AggregationNode(
        p1,
        node.step,
        tuple(gkeys + ["__kx"]),
        ("__kc", "__kpp"),
        (
            Call(_BI, "count", ())
            if warg is None
            else Call(_BI, "sum", (FieldAccess(warg.dtype, "__kw"),)),
            Call(parg.dtype, "min", (FieldAccess(parg.dtype, "__kp"),)),
        ),
    )
    from ..plan.nodes import SortKey

    w1 = WindowNode(
        a1,
        tuple(gkeys),
        (SortKey("__kx"),),
        (
            parse_window_call(
                "sum(__kc) rows between unbounded preceding and current row"
            ),
            parse_window_call(
                "sum(__kc) rows between unbounded preceding and unbounded"
                " following"
            ),
        ),
        ("__kcum", "__ktot"),
    )
    mlit = _lit(float(m))
    keep = (
        f"floor(cast(__kcum as double) * {mlit} / cast(__ktot as double)) > "
        f"floor(cast(__kcum - __kc as double) * {mlit} / "
        f"cast(__ktot as double)) or __kcum = __kc or __kcum = __ktot"
    )
    f1 = FilterNode(w1, parse_expr(keep, w1.output_schema))
    a2 = AggregationNode(
        f1,
        node.step,
        tuple(gkeys),
        ("__kq",),
        (
            Call(
                DOUBLE,
                "__kll_quantile",
                (
                    FieldAccess(xarg.dtype, "__kx"),
                    FieldAccess(_BI, "__kcum"),
                    FieldAccess(_BI, "__ktot"),
                    FieldAccess(parg.dtype, "__kpp"),
                ),
            ),
        ),
    )
    if xarg.dtype.kind.name in ("DOUBLE", "REAL"):
        final = "__kq"
    else:
        final = f"cast(round(__kq) as {xarg.dtype.kind.name.lower()})"
    return proj(a2, gkeys + [out_name], gkeys + [final])


def _rewrite_percentile(node: AggregationNode, config=None) -> PlanNode:
    """approx_percentile(x[, w], p[, accuracy]) -> bounded sketch form.

    Default: the kll rank-compression rewrite (_rewrite_percentile_kll),
    matching the reference's KllSketch RANK-error semantics
    (velox/functions/lib/KllSketch.h).  config.percentile_sketch="ddsketch"
    keeps the legacy value-error log-bucket form below."""
    from ..config import DEFAULT_CONFIG

    cfg = config or DEFAULT_CONFIG
    if getattr(cfg, "percentile_sketch", "kll") == "kll":
        return _rewrite_percentile_kll(node, cfg)
    from ..expr.parser import parse_expr
    from ..plan.nodes import FilterNode, ProjectNode

    _register_hll_functions()
    gkeys = list(node.grouping_keys)
    out_name = node.agg_names[0]
    cargs = node.aggregates[0].args
    xarg, warg, parg, _acc = _percentile_args(cargs)
    xcol, pcol = xarg.name, parg.name
    src = node.source

    def proj(source, names, texts):
        s = source.output_schema
        return ProjectNode(
            source, tuple(names), tuple(parse_expr(t, s) for t in texts)
        )

    flt = FilterNode(src, parse_expr(f"{xcol} is not null", src.output_schema))
    p1 = proj(
        flt,
        gkeys + ["__ap_b", "__ap_p"]
        + (["__ap_w"] if warg is not None else []),
        gkeys + [f"dd_bucket64({xcol})", pcol]
        + ([warg.name] if warg is not None else []),
    )
    a1 = AggregationNode(
        p1,
        node.step,
        tuple(gkeys + ["__ap_b"]),
        ("__ap_c", "__ap_pp"),
        (
            # weighted form: a bucket's count is its summed weight
            # (weight w repeats the value w times)
            Call(BIGINT, "count", ())
            if warg is None
            else Call(
                BIGINT, "sum", (FieldAccess(warg.dtype, "__ap_w"),)
            ),
            Call(parg.dtype, "min", (FieldAccess(parg.dtype, "__ap_p"),)),
        ),
    )
    a2 = AggregationNode(
        a1,
        node.step,
        tuple(gkeys),
        ("__ap_q",),
        (
            Call(
                DOUBLE,
                "__dd_quantile",
                (
                    FieldAccess(BIGINT, "__ap_b"),
                    FieldAccess(BIGINT, "__ap_c"),
                    FieldAccess(parg.dtype, "__ap_pp"),
                ),
            ),
        ),
    )
    if xarg.dtype.kind.name in ("DOUBLE", "REAL"):
        final = "__ap_q"
    else:
        final = f"cast(round(__ap_q) as {xarg.dtype.kind.name.lower()})"
    return proj(a2, gkeys + [out_name], gkeys + [final])


def _split_mixed_node(node: AggregationNode, rewrite) -> PlanNode:
    """Mixed aggregation node containing sketch-eligible aggregates: split
    into (exact rest) + one node per sketch, re-join on NULL-safe key
    equality, and restore the original column order."""
    from ..expr.ir import Constant
    from ..expr.parser import parse_expr
    from ..plan.nodes import HashJoinNode, JoinType, ProjectNode

    def _eligible(c) -> bool:
        if _percentile_eligible(c) or _bloom_eligible(c):
            return True
        return (
            c.name == "approx_distinct"
            and len(c.args) == 1
            and isinstance(c.args[0], FieldAccess)
        )

    gkeys = list(node.grouping_keys)
    idxs = list(range(len(node.aggregates)))
    sketch_idx = [i for i in idxs if _eligible(node.aggregates[i])]
    rest_idx = [i for i in idxs if i not in sketch_idx]

    def _with_join_keys(piece: PlanNode, keep: list) -> PlanNode:
        """Project NULL-safe join-key columns: per grouping key an is-null
        flag + a zero-coalesced value; ungrouped nodes join on a literal."""
        s = piece.output_schema
        names = list(keep)
        exprs = [parse_expr(c, s) for c in keep]
        if not gkeys:
            names.append("__sk_one")
            exprs.append(Constant(BIGINT, 1))
        from ..expr.ir import Special, SpecialForm

        for j, k in enumerate(gkeys):
            kt = s.type_of(k)
            names.append(f"__sk_n{j}")
            exprs.append(parse_expr(f"cast({k} is null as bigint)", s))
            names.append(f"__sk_v{j}")
            # NULL-safe value half: the is-null flag disambiguates a real
            # default from a coalesced NULL, so any in-domain default works
            default = Constant(kt, "" if kt.is_string else 0)
            exprs.append(
                Special(kt, SpecialForm.COALESCE, (FieldAccess(kt, k), default))
            )
        return ProjectNode(piece, tuple(names), tuple(exprs))

    jkeys = (
        ["__sk_one"]
        if not gkeys
        else [f"__sk_{t}{j}" for j in range(len(gkeys)) for t in ("n", "v")]
    )
    left = None
    left_cols: list = []
    if rest_idx:
        rest = AggregationNode(
            node.source,
            node.step,
            tuple(gkeys),
            tuple(node.agg_names[i] for i in rest_idx),
            tuple(node.aggregates[i] for i in rest_idx),
        )
        left = _with_join_keys(
            rest, gkeys + [node.agg_names[i] for i in rest_idx]
        )
        left_cols = gkeys + [node.agg_names[i] for i in rest_idx]
    for i in sketch_idx:
        single = rewrite(
            AggregationNode(
                node.source,
                node.step,
                tuple(gkeys),
                (node.agg_names[i],),
                (node.aggregates[i],),
            )
        )
        piece = _with_join_keys(single, gkeys + [node.agg_names[i]])
        if left is None:
            left = piece
            left_cols = gkeys + [node.agg_names[i]]
            continue
        left = HashJoinNode(
            left,
            piece,
            JoinType.LEFT,
            tuple(jkeys),
            tuple(jkeys),
            tuple(left_cols + jkeys + [node.agg_names[i]]),
        )
        left_cols = left_cols + [node.agg_names[i]]
    # restore original order; all-NULL groups: approx_distinct -> 0
    out_names, out_exprs = [], []
    s = left.output_schema
    for c in gkeys:
        out_names.append(c)
        out_exprs.append(parse_expr(c, s))
    for i in idxs:
        nm = node.agg_names[i]
        out_names.append(nm)
        if i in sketch_idx and node.aggregates[i].name == "approx_distinct":
            out_exprs.append(parse_expr(f"coalesce({nm}, 0)", s))
        else:
            out_exprs.append(parse_expr(nm, s))
    return ProjectNode(left, tuple(out_names), tuple(out_exprs), id=node.id)


def rewrite_sketch_aggregates(root: PlanNode, config=None) -> PlanNode:
    """Rewrite eligible approx_distinct aggregations bottom-up (see module
    docstring); returns the (possibly new) plan root."""
    from ..expr.parser import parse_expr
    from ..plan.nodes import (
        AggregationStep,
        FilterNode,
        ProjectNode,
    )

    def rewrite(node: PlanNode) -> PlanNode:
        # rebuild children first
        replaced = {}
        for attr in ("source", "left", "right"):
            child = getattr(node, attr, None)
            if isinstance(child, PlanNode):
                new = rewrite(child)
                if new is not child:
                    replaced[attr] = new
        inputs = getattr(node, "inputs", None)
        if inputs and all(isinstance(i, PlanNode) for i in inputs):
            new_inputs = tuple(rewrite(i) for i in inputs)
            if any(a is not b for a, b in zip(new_inputs, inputs)):
                replaced["inputs"] = new_inputs
        if replaced:
            node = dataclasses.replace(node, **replaced)
        if not isinstance(node, AggregationNode):
            return node

        def _eligible(c) -> bool:
            if _percentile_eligible(c) or _bloom_eligible(c):
                return True
            return (
                c.name == "approx_distinct"
                and len(c.args) == 1
                and isinstance(c.args[0], FieldAccess)
            )

        if len(node.aggregates) != 1:
            if any(_eligible(c) for c in node.aggregates):
                return _split_mixed_node(node, rewrite)
            return node
        call = node.aggregates[0]
        if _percentile_eligible(call):
            return _rewrite_percentile(node, config)
        if _bloom_eligible(call):
            return _rewrite_bloom(node)
        if call.name != "approx_distinct" or len(call.args) != 1:
            return node
        arg = call.args[0]
        if not isinstance(arg, FieldAccess):
            return node
        _register_hll_functions()
        gkeys = list(node.grouping_keys)
        out_name = node.agg_names[0]
        src = node.source
        schema = src.output_schema
        col = arg.name

        def proj(source, names, texts):
            s = source.output_schema
            return ProjectNode(
                source,
                tuple(names),
                tuple(parse_expr(t, s) for t in texts),
            )

        flt = FilterNode(src, parse_expr(f"{col} is not null", schema))
        p1 = proj(
            flt,
            gkeys + ["__ad_b", "__ad_r"],
            gkeys + [f"hll_bucket64({col})", f"hll_rho64({col})"],
        )
        a1 = AggregationNode(
            p1,
            node.step,
            tuple(gkeys + ["__ad_b"]),
            ("__ad_maxr",),
            (Call(BIGINT, "max", (FieldAccess(BIGINT, "__ad_r"),)),),
        )
        p2 = proj(
            a1,
            gkeys + ["__ad_w"],
            gkeys
            + [
                # 2^(54 - rho), clamped: rho in [1, 65] -> shift in [0, 53]
                "bitwise_left_shift(1, greatest(54 - __ad_maxr, 0))"
            ],
        )
        a2 = AggregationNode(
            p2,
            node.step,
            tuple(gkeys),
            ("__ad_v", "__ad_s"),
            (
                Call(BIGINT, "count", ()),
                Call(BIGINT, "sum", (FieldAccess(BIGINT, "__ad_w"),)),
            ),
        )
        p3 = proj(
            a2,
            gkeys + [out_name],
            gkeys + [_estimate_expr("__ad_v", "__ad_s")],
        )
        return p3

    return rewrite(root)
