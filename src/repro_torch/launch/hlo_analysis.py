"""Per-device cost analysis of one eager step (port of
``repro.launch.hlo_analysis``).

The reference re-derives roofline inputs from compiled, SPMD-partitioned
HLO text, applying loop trip counts that ``cost_analysis()`` misses.  The
port has no HLO: it runs the step once under :class:`CostMode`, a
``TorchDispatchMode`` that sees every operator the step runs.  Its loops
run, so trip counts come for free.  What it counts, per device, as the
reference's ``Costs`` holds it:

* **flops** of matrix products (``torch.utils.flop_counter``'s registry:
  ``mm``, ``bmm``, ``addmm``, ``baddbmm``, convolutions, attention), as the
  reference counts ``dot`` ops.  DTensor runs an op on DTensors as ops on
  each position's local shards, which this mode sees and counts: the
  local count, for an even split the op's global count divided by the
  product of the mesh dims over which its output is ``Shard`` or
  ``Partial``.  An op on plain tensors — inside a ``local`` region, or
  unsharded code — counts as it is.
* **mem_bytes**, the HBM traffic of an eager run: each op's operand and
  result bytes at their local shapes (eager fuses nothing).  Views move
  nothing; an in-place op's written operand counts once.
* **coll_bytes** by kind, **wire_bytes** and **n_collectives**: the c10d
  functional collectives DTensor issues, mapped to the reference's five
  kinds, each with the reference's payload and ring-wire formulas.
  DTensor's ``shard_dim_alltoall`` counts as an all-to-all.

It also tracks live bytes (:class:`MemoryStats`): the storages the step's
arguments hold and every storage an op creates, freed when the last tensor
on it dies; the peak is the step's per-device footprint.  An op that
makes host tensors (DTensor's own index bookkeeping) counts nothing.

Beside the per-device flops the mode keeps ``FlopCounterMode``'s count
(``global_flops``): an op on DTensors counts at its global shapes, by
the same registry, and the ops DTensor then runs on the shards count only
per device; an op on plain tensors outside that — a ``local`` region's —
counts as it is.  To tell the two apart the mode runs a DTensor op
itself, entered once more around it, and lets DTensor split it
(``NotImplemented``) there.

On ``meta`` tensors most elementwise ops find their output's shape in
Python (``torch._refs``), at some hundred microseconds an op; a traced
step runs the same few hundred (op, shapes) pairs millions of times (the
flash blocks, the scan chunks).  So for an op on ``meta`` tensors that
returns fresh tensors, the mode remembers the outputs' shapes, strides
and dtypes, flops and bytes by the op and its operands' shapes, strides,
dtypes and other arguments, and makes empty outputs from them on the
next call.

The reference's HLO parser (``HloAnalyzer``, ``Instruction``,
``Computation``) and ``xla_cost_analysis`` have no counterpart.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Dict

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

#: Bytes per element by torch dtype (the reference's table is keyed by
#: HLO type names).
DTYPE_BYTES = {d: torch.empty((), dtype=d).element_size() for d in (
    torch.float64, torch.float32, torch.bfloat16, torch.float16,
    torch.int64, torch.int32, torch.int16, torch.int8, torch.uint8,
    torch.bool, torch.complex64, torch.complex128)}

#: Collective operators → kind.
_KINDS = {
    "_c10d_functional.all_reduce": "all-reduce",
    "_c10d_functional.all_reduce_": "all-reduce",
    "_c10d_functional.all_gather_into_tensor": "all-gather",
    "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional.all_to_all_single": "all-to-all",
    "_dtensor.shard_dim_alltoall": "all-to-all",
}
_COLL_NAMESPACES = ("_c10d_functional", "c10d_functional", "_dtensor",
                    "c10d")
#: Ops that allocate or wait and move no data of their own.
_NO_TRAFFIC = {"aten.empty", "aten.empty_strided", "aten.empty_like",
               "aten.new_empty", "aten.new_empty_strided",
               "_c10d_functional.wait_tensor",
               "_c10d_functional._wrap_tensor_autograd", "aten.lift_fresh",
               "aten.lift_fresh_copy"}


@dataclasses.dataclass
class Costs:
    flops: float = 0.0
    coll_bytes: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in COLLECTIVES})
    wire_bytes: float = 0.0     # ring-algorithm estimate
    mem_bytes: float = 0.0      # HBM traffic estimate
    n_collectives: float = 0.0

    def add(self, other: "Costs", times: float = 1.0):
        self.flops += other.flops * times
        for k in COLLECTIVES:
            self.coll_bytes[k] += other.coll_bytes[k] * times
        self.wire_bytes += other.wire_bytes * times
        self.mem_bytes += other.mem_bytes * times
        self.n_collectives += other.n_collectives * times

    @property
    def total_coll_bytes(self) -> float:
        return sum(self.coll_bytes.values())


@dataclasses.dataclass
class MemoryStats:
    """Live local bytes of one traced step: the arguments' storages, the
    peak of all live storages, and the storages the outputs hold."""

    argument_bytes: int = 0
    peak_bytes: int = 0
    output_bytes: int = 0

    @property
    def temp_bytes(self) -> int:
        return self.peak_bytes - self.argument_bytes


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _local(t):
    return t.to_local() if isinstance(t, DTensor) else t


def _tensors(tree):
    return [_local(t) for t in tree_flatten(tree)[0]
            if isinstance(t, torch.Tensor)]


def _sig(v):
    """A hashable signature of an operand; TypeError where there is none
    (a tensor that is not a plain ``meta`` one, an unhashable value)."""
    t = type(v)
    if t is torch.Tensor:
        if not v.is_meta:
            raise TypeError
        return (v.shape, v.stride(), v.dtype)
    if t is list or t is tuple:
        return tuple(_sig(x) for x in v)
    if isinstance(v, torch.Tensor):
        raise TypeError
    hash(v)
    return (t, v)              # 2 and 2.0 give results of other dtypes


_REMEMBERED = {}   # op → whether CostMode may remember its output shapes


def _rememberable(func) -> bool:
    ok = _REMEMBERED.get(func)
    if ok is None:
        schema = func._schema
        ok = (func.namespace == "aten" and bool(schema.returns)
              and all(r.alias_info is None for r in schema.returns)
              and not any(a.alias_info is not None and a.alias_info.is_write
                          for a in schema.arguments))
        _REMEMBERED[func] = ok
    return ok


def _meta_key(func, args, kwargs):
    """The key under which ``CostMode`` remembers an op's output shapes,
    or None for an op whose outputs must come from running it: one that
    returns a view or writes an operand, a collective, or one with an
    operand that is not a plain ``meta`` tensor."""
    if not _rememberable(func):
        return None
    try:
        return (func, _sig(args),
                _sig(tuple(sorted(kwargs.items()))) if kwargs else ())
    except TypeError:
        return None


def _group_size(name) -> int:
    return dist.distributed_c10d._resolve_process_group(name).size()


class CostMode(TorchDispatchMode):
    """Counts the per-device :class:`Costs` and live bytes of the ops run
    inside it (module docstring).  ``track(tree)`` registers tensors that
    exist before the step (its arguments) with the live bytes."""

    def __init__(self):
        super().__init__()
        self.costs = Costs()
        self.live = 0
        self.peak = 0
        self._held = set()
        self.global_flops = 0.0
        self._in_dtensor = 0    # DTensor ops being split into local ones
        # (op, operands) → (outputs' (shape, stride, dtype), flops, bytes)
        self._seen = {}

    # ------------------------------------------------------------ memory ---
    def track(self, tree) -> int:
        """Count the storages of ``tree``'s tensors (DTensors' local
        shards) as live; returns the bytes newly counted."""
        return sum(self._hold(t) for t in _tensors(tree))

    def _hold(self, t: torch.Tensor) -> int:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._held:
            return 0
        n = st.nbytes()
        self._held.add(key)
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._release, key, n)
        return n

    def _release(self, key, n):
        self._held.discard(key)
        self.live -= n

    # ---------------------------------------------------------- dispatch ---
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            if self._in_dtensor:
                return NotImplemented  # let DTensor run it on the shards
            fn = flop_registry.get(func._overloadpacket)
            if fn is not None:
                self.global_flops += fn(*args, **kwargs)
            self._in_dtensor += 1
            try:
                with self:             # see the ops it is split into
                    return func(*args, **kwargs)
            finally:
                self._in_dtensor -= 1
        if torch._C._get_dispatch_mode(
                torch._C._TorchDispatchModeKey.FAKE) is not None:
            # DTensor's sharding propagation, finding an op's global output
            # shape on fake tensors (once per op and placements): no work.
            return func(*args, **kwargs)
        key = _meta_key(func, args, kwargs)
        seen = self._seen.get(key) if key is not None else None
        if seen is not None:
            outs, flops, nbytes, one = seen
            made = [torch.empty_strided(sh, st, dtype=dt, device="meta")
                    for sh, st, dt in outs]
            out = made[0] if one else tuple(made)
            for t in made:
                self._hold(t)
        else:
            out = func(*args, **kwargs)
            outs = _tensors(out)
            if outs and outs[0].device.type == "cpu":
                return out          # host bookkeeping (DTensor's indices)
            name = str(func._overloadpacket)
            if name.split(".")[0] in _COLL_NAMESPACES:
                self._collective(name, args, out)
            fn = flop_registry.get(func._overloadpacket)
            flops = fn(*args, **kwargs, out_val=out) if fn is not None \
                else 0
            nbytes = self._traffic(func, name, args, kwargs, out)
            for t in outs:
                self._hold(t)
            if key is not None and outs and all(t.is_meta for t in outs) \
                    and (isinstance(out, torch.Tensor)
                         or len(outs) == len(out)):
                self._seen[key] = ([(tuple(t.shape), t.stride(), t.dtype)
                                    for t in outs], flops, nbytes,
                                   isinstance(out, torch.Tensor))
        self.costs.flops += flops
        self.costs.mem_bytes += nbytes
        if not self._in_dtensor:
            self.global_flops += flops
        return out

    def _traffic(self, func, name, args, kwargs, out) -> int:
        """The bytes an op reads and writes."""
        if name in _NO_TRAFFIC:
            return 0
        schema = func._schema
        rets = schema.returns
        if rets and all(r.alias_info is not None and not r.alias_info.is_write
                        for r in rets):
            return 0                                 # a view moves nothing
        written = {a.name for a in schema.arguments
                   if a.alias_info is not None and a.alias_info.is_write}
        n = sum(_nbytes(t) for t in _tensors(out))
        for a, v in zip(schema.arguments, args):
            if a.name not in written:
                n += sum(_nbytes(t) for t in _tensors(v))
        for k, v in kwargs.items():
            if k not in written:
                n += sum(_nbytes(t) for t in _tensors(v))
        return n

    def _collective(self, name, args, out):
        if name in _NO_TRAFFIC:
            return
        kind = _KINDS.get(name)
        if kind is None:
            raise NotImplementedError(f"CostMode: collective {name} has no "
                                      "kind")
        payload = float(_nbytes(args[0]))           # the operand's bytes
        if kind == "all-reduce":
            g = _group_size(args[2])
            wire = 2.0 * payload * (g - 1) / max(g, 1)
        elif kind == "all-gather":
            g = int(args[1])
            wire = payload * (g - 1)                 # result·(g-1)/g
        elif kind == "reduce-scatter":
            g = int(args[2])
            wire = payload * (g - 1) / max(g, 1)
        else:
            wire = payload
        self.costs.coll_bytes[kind] += payload
        self.costs.wire_bytes += wire
        self.costs.n_collectives += 1


def trace_costs(fn, *args):
    """Run ``fn(*args)`` once under a :class:`CostMode`; returns (its
    result, the per-device :class:`Costs`, the :class:`MemoryStats`, and
    ``FlopCounterMode``'s count, ``CostMode.global_flops``)."""
    mode = CostMode()
    argument_bytes = mode.track(args)
    with mode:
        out = fn(*args)
    mem = MemoryStats(argument_bytes=argument_bytes, peak_bytes=mode.peak,
                      output_bytes=sum(_nbytes(t) for t in _tensors(out)))
    return out, mode.costs, mem, mode.global_flops
