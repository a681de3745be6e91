"""Ranks, collectives and a distributed query step.

Counterpart of the JAX package's ``parallel/distributed.py``.  Reference
re-orientation (SURVEY.md §2.12): the reference's parallelism is
intra-pipeline driver parallelism + distributed partitioned exchange.

The JAX package is single-controller: one process drives a
``jax.sharding.Mesh`` and the per-device code runs inside ``shard_map``.
Here execution is SPMD over processes: every rank of an initialised
``torch.distributed`` process group runs the same code over its own rows and
the collectives (``all_to_all_single``, ``all_reduce``, ``all_gather``)
replace ``lax.all_to_all`` / ``lax.psum``.  ``Mesh`` says who this rank is,
where its tensors live and which backend moves them.

The backend is always explicit.  NCCL moves CUDA tensors, one rank a card.
Several ranks that share one card use gloo (NCCL refuses two ranks on one
device); gloo is a host transport, so under gloo with a CUDA device every
collective stages its tensor through a pinned host buffer (``Mesh.staged``).
On the CPU, gloo moves the tensors as they are.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from ..device import resolve_device
from ..expr.compiler import ExprSet
from ..expr.ir import Expr
from ..vector.column import Batch, Column
from .exchange import exchange_rows

_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}


@dataclasses.dataclass
class Mesh:
    """This rank's view of the process group (the JAX package's
    ``jax.sharding.Mesh`` over one ``data`` axis).

    ``stats`` counts the collectives this rank issued and the bytes it sent
    (all-to-all: its whole send buffer, its own bucket included; all-gather:
    its own contribution)."""

    group: Optional[object]
    rank: int
    size: int
    device: torch.device
    backend: str
    stats: Dict[str, int] = dataclasses.field(
        default_factory=lambda: dict(all_to_all_calls=0, all_to_all_bytes=0,
                                     all_reduce_calls=0, all_gather_calls=0,
                                     all_gather_bytes=0)
    )

    @property
    def staged(self) -> bool:
        """Collectives copy through pinned host buffers: gloo with a CUDA device."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def reset_stats(self) -> None:
        for k in self.stats:
            self.stats[k] = 0

    # ---- transport ------------------------------------------------------
    def _send_buffer(self, t: torch.Tensor) -> torch.Tensor:
        t = t.contiguous()
        if not self.staged:
            return t
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        return host

    def _empty(self, shape, dtype) -> torch.Tensor:
        if self.staged:
            return torch.empty(shape, dtype=dtype, pin_memory=True)
        return torch.empty(shape, dtype=dtype, device=self.device)

    def _back(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.device) if self.staged else t

    def all_to_all(self, t: torch.Tensor, async_op: bool = False):
        """Equal-split all-to-all along dim 0 ([size, ...] in and out): row p
        goes to rank p, row q of the result came from rank q.  With
        ``async_op`` returns a handle whose ``wait()`` gives the result."""
        send = self._send_buffer(t)
        recv = self._empty(send.shape, send.dtype)
        self.stats["all_to_all_calls"] += 1
        self.stats["all_to_all_bytes"] += send.numel() * send.element_size()
        work = dist.all_to_all_single(recv, send, group=self.group, async_op=True)
        back = self._back

        class _Pending:
            def wait(self):
                work.wait()
                return back(recv)

        pending = _Pending()
        return pending if async_op else pending.wait()

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """A reduced copy of ``t`` on this rank's device (``op``: sum / max / min)."""
        buf = self._send_buffer(t.clone() if not self.staged else t)
        self.stats["all_reduce_calls"] += 1
        dist.all_reduce(buf, op=_REDUCE_OPS[op], group=self.group)
        return self._back(buf)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """[size, *t.shape]: every rank's ``t`` (equal shapes), rank order."""
        send = self._send_buffer(t)
        outs = [self._empty(send.shape, send.dtype) for _ in range(self.size)]
        self.stats["all_gather_calls"] += 1
        self.stats["all_gather_bytes"] += send.numel() * send.element_size()
        dist.all_gather(outs, send, group=self.group)
        return self._back(torch.stack(outs))


def make_mesh(n_devices: Optional[int] = None, *, backend: str, device=None,
              group=None) -> Mesh:
    """This rank's Mesh over an initialised process group.

    ``backend`` must name the group's backend ("gloo" or "nccl"): it is never
    guessed.  ``device`` None means the CUDA device and raises without one;
    NCCL needs a CUDA device.  ``n_devices``, when given, must equal the
    world size (every rank takes part)."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialised process group "
            "(torch.distributed.init_process_group with an explicit backend)"
        )
    actual = dist.get_backend(group)
    if backend != actual:
        raise ValueError(f"make_mesh(backend={backend!r}) over a {actual!r} process group")
    size = dist.get_world_size(group)
    if n_devices is not None and n_devices != size:
        raise ValueError(f"make_mesh({n_devices}) in a world of {size} ranks")
    device = resolve_device(device)
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("the nccl backend moves CUDA tensors only")
    return Mesh(group, dist.get_rank(group), size, device, backend)


# ---------------------------------------------------------------------------
# Byte packing: several arrays of any dtype in one message


def pack_bytes(arrays: Sequence[torch.Tensor], dim: int):
    """Concatenate ``arrays`` as raw bytes after their first ``dim`` axes
    (which they share): (uint8 tensor [*lead, W], layout).  One collective
    then moves arrays of different dtypes and widths together."""
    parts, layout = [], []
    lead = tuple(arrays[0].shape[:dim])
    for a in arrays:
        flat = a.contiguous().reshape(lead + (-1,))
        if flat.dtype == torch.bool:
            flat = flat.view(torch.uint8)
        b = flat.view(torch.uint8)
        parts.append(b)
        layout.append((a.dtype, tuple(a.shape[dim:]), b.shape[-1]))
    return torch.cat(parts, dim=dim), layout


def unpack_bytes(buf: torch.Tensor, layout, dim: int) -> List[torch.Tensor]:
    """Inverse of ``pack_bytes`` (the leading axes may have changed size)."""
    lead = tuple(buf.shape[:dim])
    out, pos = [], 0
    for dtype, rest, width in layout:
        # a fresh buffer: ``contiguous()`` keeps the packed row stride where
        # a leading axis has one row (or none), and ``view`` needs it dense
        b = torch.empty(lead + (width,), dtype=torch.uint8, device=buf.device)
        b.copy_(buf.narrow(dim, pos, width))
        pos += width
        if dtype == torch.bool:
            a = b.view(torch.bool)
        else:
            a = b.view(dtype)
        out.append(a.reshape(lead + rest))
    return out


def all_gather_arrays(mesh: Mesh, arrays: Sequence[torch.Tensor]) -> List[List[torch.Tensor]]:
    """Every rank's ``arrays`` (equal shapes on every rank), in rank order:
    one all-gather of their bytes."""
    buf, layout = pack_bytes([a.reshape((1,) + tuple(a.shape)) for a in arrays], dim=1)
    got = mesh.all_gather(buf[0])
    return [[a[0] for a in unpack_bytes(got[r : r + 1], layout, dim=1)]
            for r in range(mesh.size)]


def gather_prefixes(mesh: Mesh, arrays: Sequence[torch.Tensor], lengths: torch.Tensor):
    """Every rank's live rows: ``arrays`` hold this rank's rows in
    ``lengths.sum()`` leading rows, cut into segments of ``lengths`` (a
    segment a tile; the same number of segments on every rank).  Two
    all-gathers: the lengths, then the rows padded to the longest rank's.
    Returns, in rank order, (segment lengths, numpy arrays of that rank's
    rows)."""
    counts = mesh.all_gather(lengths.to(torch.int64)).cpu().numpy()
    totals = counts.sum(axis=1)
    width = int(totals.max()) if len(totals) else 0
    n = int(lengths.sum())
    rows = []
    for a in arrays:
        part = a[:n]
        if n < width:
            pad = torch.zeros((width - n,) + tuple(a.shape[1:]), dtype=a.dtype, device=a.device)
            part = torch.cat([part, pad])
        rows.append(part.reshape((width,) + tuple(a.shape[1:])))
    if not rows:
        return [(counts[r], []) for r in range(mesh.size)]
    buf, layout = pack_bytes(rows, dim=1)
    got = mesh.all_gather(buf).cpu()
    out = []
    for r in range(mesh.size):
        arrs = unpack_bytes(got[r], layout, dim=1)
        out.append((counts[r], [x[: int(totals[r])].numpy() for x in arrs]))
    return out


# ---------------------------------------------------------------------------


def distributed_grouped_sum(
    mesh: Mesh,
    predicate: Expr,
    value_expr: Expr,
    schema,
    num_groups: int,
) -> Callable:
    """A distributed step: filter -> project -> exchange-by-key -> local
    grouped sum.  The returned function takes this rank's shard (a sequence
    of [N] column tensors + an [N] int32 group-key tensor) and returns this
    rank's [num_groups] partial sums: exactly the groups it owns
    (hash(key) % size == rank), the others zero.  The JAX package returns all
    devices' rows as one [n_devices, num_groups] array."""

    def step(local_cols: Sequence[torch.Tensor], local_keys: torch.Tensor) -> torch.Tensor:
        cap = local_keys.shape[0]
        batch = Batch.make(
            schema,
            [Column.flat(c, t) for c, t in zip(local_cols, schema.types)],
            length=cap,
            capacity=cap,
        )
        [pred, val] = ExprSet([predicate, value_expr]).eval(batch)
        mask = pred.values.to(torch.bool)
        if pred.validity is not None:
            mask = mask & pred.validity
        # default bucket = full capacity: overflow is impossible, the dropped
        # counter is zero by construction
        (vals_recv,), keys_recv, live, _dropped = exchange_rows(
            [val.values], local_keys, mask, mesh, mesh.size
        )
        from ..ops.segmented import direct_group_reduce

        gids = keys_recv.to(torch.int32).clamp(0, num_groups - 1)
        return direct_group_reduce(vals_recv, live, gids, num_groups, "sum")

    return step
