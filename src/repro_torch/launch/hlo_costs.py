"""Cost analysis of one step of the port, by walking the aten ops it dispatches.

The reference re-walks a compiled step's optimized HLO.  PyTorch runs
eagerly, so there is no HLO here: the file keeps the reference's name, so
that a reader finds the counterpart, and :class:`Walk` (a
``TorchDispatchMode``) sees every aten op the step dispatches, its backward
included, on any device (``meta`` in the dry run, the card, the CPU):

  * FLOPs: the aten products by ``torch.utils.flop_counter``'s formulas (the
    table ``FlopCounterMode`` counts with), and each hand-written kernel by
    its formula in ``kernels/costs.py``: the wrapper charges the walk, and
    the ops it dispatches inside the call (the plain version on the CPU,
    casts and padding on the card) are that charge, counted once;
  * HBM bytes: each op's input and output bytes.  Views and metadata ops
    move nothing, as the reference's ``_SKIP_BYTES_OPS``; an in-place
    update of a slice (``copy_`` into a view, ``index_put_``, the scatters)
    is charged twice its update and a gather twice its result, as the
    reference's dynamic-update-slice and dynamic-slice rules do: a view
    already has the slice's size, so a slice read costs its consumer only
    the slice.  On an eager program ``bytes_native`` equals ``bytes``: each
    op runs as dispatched, in its own dtype, so there is no CPU-lowering
    artifact (the reference's f32 dot accumulators) to correct;
  * collectives, by kind, from the c10d ops and the functional collectives
    (send as ``collective-permute``; a receive is the other end of a send
    and is not charged again).  As in the reference, an all-gather is
    charged its operand's (the shard's) bytes, every other collective its
    result's.

Memory (``Walk.memory``): the arguments' bytes on this rank, the outputs',
and the peak of the bytes of storages the step allocated and still held
(``temp_size``), tracked by a weak reference to each storage, so a meta run
predicts what the card's allocator holds.

The per-op table (``Walk.table``) keeps each distinct op's tensor sizes and
count; ``costs_from_table`` turns it into the totals, so the cost model can
be run again over a saved table (``roofline.py --reanalyze-ops``).
"""
from __future__ import annotations

import contextlib
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode, is_traceable_wrapper_subclass
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

# ops that move no bytes (the reference's _SKIP_BYTES_OPS: parameters,
# bitcasts, tuples); every view op (``OpOverload.is_view``) is skipped too
_SKIP_BYTES_OPS = {
    "aten.empty.memory_format", "aten.empty_like.default", "aten.empty_strided.default",
    "aten.new_empty.default", "aten.new_empty_strided.default", "aten.detach.default",
    "aten.lift_fresh.default", "aten._local_scalar_dense.default",
    "aten.is_same_size.default", "aten.sym_size.int", "aten.sym_stride.int",
    "aten.sym_numel.default", "aten.sym_storage_offset.default",
    "_c10d_functional.wait_tensor.default",
}
# ops that write their last tensor argument into (a view of) their first:
# charged twice the update (a dynamic-update-slice); copy_ is one of them
_UPDATE_OPS = ("aten.copy_.", "aten.index_put_.", "aten.index_put.", "aten.scatter_.",
               "aten.scatter.", "aten.scatter_add_.", "aten.scatter_add.",
               "aten.index_add_.", "aten.index_add.", "aten.index_copy_.",
               "aten.index_copy.", "aten.slice_scatter.", "aten.select_scatter.")
# ops that read a slice picked by an index: charged twice the result
_GATHER_OPS = ("aten.index.Tensor", "aten.embedding.", "aten.gather.", "aten.index_select.",
               "aten.take.")
# ops that only write their output
_FILL_OPS = ("aten.fill_.", "aten.zero_.", "aten.zeros.", "aten.ones.", "aten.full.",
             "aten.zeros_like.", "aten.ones_like.", "aten.full_like.", "aten.arange.",
             "aten.scalar_tensor.")

# collective op name (without the overload) -> (kind, what its bytes are)
_COLLECTIVES = {
    "_c10d_functional.all_gather_into_tensor": ("all-gather", "operand"),
    "_c10d_functional.all_gather_into_tensor_coalesced": ("all-gather", "operand"),
    "c10d._allgather_base_": ("all-gather", "operand"),
    "c10d.allgather_": ("all-gather", "operand"),
    "c10d.allgather_into_tensor_coalesced_": ("all-gather", "operand"),
    "_c10d_functional.all_reduce": ("all-reduce", "result"),
    "_c10d_functional.all_reduce_": ("all-reduce", "result"),
    "_c10d_functional.all_reduce_coalesced": ("all-reduce", "result"),
    "c10d.allreduce_": ("all-reduce", "result"),
    "c10d.allreduce_coalesced_": ("all-reduce", "result"),
    "_c10d_functional.reduce_scatter_tensor": ("reduce-scatter", "result"),
    "_c10d_functional.reduce_scatter_tensor_coalesced": ("reduce-scatter", "result"),
    "c10d._reduce_scatter_base_": ("reduce-scatter", "result"),
    "c10d.reduce_scatter_": ("reduce-scatter", "result"),
    "_c10d_functional.all_to_all_single": ("all-to-all", "result"),
    "c10d.alltoall_base_": ("all-to-all", "result"),
    "c10d.alltoall_": ("all-to-all", "result"),
    "c10d.send": ("collective-permute", "operand"),
    "c10d.broadcast_": ("collective-broadcast", "result"),
    "_c10d_functional.broadcast": ("collective-broadcast", "result"),
}
# c10d ops called as (outputs, inputs, ...): the result is their first argument
_OUTPUT_FIRST = {"c10d._allgather_base_", "c10d._reduce_scatter_base_", "c10d.alltoall_base_",
                 "c10d.reduce_scatter_", "c10d.alltoall_", "c10d.allgather_",
                 "c10d.allgather_into_tensor_coalesced_"}
_NOT_CHARGED = {"c10d.recv_", "c10d.recv_any_source_", "c10d.barrier"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def local_tensor(x: torch.Tensor) -> torch.Tensor:
    """A ``DTensor``'s block on this rank; any other tensor as it is."""
    return x.to_local() if hasattr(x, "to_local") else x


def _collective(name: str, args, out):
    """(kind, bytes) of a collective op, or None."""
    base = name.rsplit(".", 1)[0]
    if base in _NOT_CHARGED or base not in _COLLECTIVES:
        return None
    kind, what = _COLLECTIVES[base]
    if base in _OUTPUT_FIRST:               # each may be a list of tensors
        res, opd = _tensors(args[0]), _tensors(args[1])
    else:
        opd = _tensors(args[0])
        res = _tensors(out) if name.startswith("_c10d_functional.") else opd
    return kind, sum(_nbytes(t) for t in (opd if what == "operand" else res))


class Walk(TorchDispatchMode):
    """Counts what a step dispatches (see the module's docstring).  Enter it
    around the step, as ``with Walk(args) as w: out = fn(*args)``; then
    ``w.finish(out)``, and read ``w.costs()``, ``w.memory``, ``w.table``.
    ``args``: the step's arguments, whose storages are not temporaries."""

    def __init__(self, args=()):
        super().__init__()
        self._rows: dict = {}
        self._inside = 0                  # depth of kernel wrapper calls
        self._section = None              # the ``costs.section`` the ops run in
        self._outer: list = []            # the sections it opened in
        self._refs: dict = {}             # storage key -> weak reference
        self._live = 0
        self.peak = 0
        leaves = [local_tensor(t) for t in _tensors(args)]
        self.memory = {"argument_size": sum(_nbytes(t) for t in leaves),
                       "output_size": None, "temp_size": None}
        self._args = {self._key(t) for t in leaves}
        self._stack = contextlib.ExitStack()

    # -- storages ---------------------------------------------------------------
    @staticmethod
    def _key(t):
        return t.untyped_storage()._cdata

    def _track(self, out) -> None:
        for t in _tensors(out):
            if is_traceable_wrapper_subclass(t):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self._refs or key in self._args:
                continue
            n = st.nbytes()
            self._refs[key] = weakref.ref(st, lambda _w, key=key, n=n: self._free(key, n))
            self._live += n
            self.peak = max(self.peak, self._live)

    def _free(self, key, n) -> None:
        self._refs.pop(key, None)
        self._live -= n

    # -- the recorder of kernels/costs.py -----------------------------------------
    @contextlib.contextmanager
    def kernel(self, name: str, flops: int, nbytes: int):
        self._row((name, "kernel", (), (), (), int(flops), False, None, int(nbytes),
                   self._section))
        self._inside += 1
        try:
            yield
        finally:
            self._inside -= 1

    @contextlib.contextmanager
    def section(self, name: str):
        self.open_section(name)
        try:
            yield
        finally:
            self.close_section()

    def open_section(self, name: str) -> None:
        self._outer.append(self._section)
        self._section = name

    def close_section(self) -> None:
        self._section = self._outer.pop()

    # -- the dispatch mode -----------------------------------------------------------
    def _row(self, key) -> None:
        self._rows[key] = self._rows.get(key, 0) + 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self._track(out)
        if self._inside:
            return out
        name = str(func)
        ins = _tensors((args, kwargs))
        written = []
        schema_args = func._schema.arguments
        for i, a in enumerate(schema_args):
            if a.alias_info is not None and a.alias_info.is_write:
                v = args[i] if i < len(args) else kwargs.get(a.name)
                written += [_nbytes(t) for t in _tensors(v)]
        packet = func._overloadpacket
        flops = int(flop_registry[packet](*args, **kwargs, out_val=out)) \
            if packet in flop_registry else 0
        coll = _collective(name, args, out)
        self._row((name, "op" if coll is None else "collective",
                   tuple(_nbytes(t) for t in ins), tuple(written),
                   tuple(_nbytes(t) for t in _tensors(out)), flops, bool(func.is_view),
                   coll, 0, self._section))
        return out

    def __enter__(self):
        from repro_torch.kernels import costs

        self._stack.enter_context(costs.recording(self))
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._stack.close()

    def finish(self, out) -> None:
        """Record the step's outputs and the peak of its temporaries."""
        self.memory["output_size"] = sum(_nbytes(local_tensor(t)) for t in _tensors(out))
        self.memory["temp_size"] = self.peak

    # -- results ---------------------------------------------------------------------
    @property
    def table(self) -> list[dict]:
        """One row per distinct op: name, kind (op, collective, kernel), the
        bytes of its tensor inputs, of the inputs it writes, of its outputs,
        its FLOPs, whether it is a view, its collective (kind, bytes), a
        kernel's bytes, the ``costs.section`` it ran in (or None), and how
        many times it ran."""
        return [{"op": k[0], "kind": k[1], "in": list(k[2]), "written": list(k[3]),
                 "out": list(k[4]), "flops": k[5], "view": k[6],
                 "collective": list(k[7]) if k[7] else None, "kernel_bytes": k[8],
                 "section": k[9], "n": n}
                for k, n in self._rows.items()]

    def costs(self) -> dict:
        return {**costs_from_table(self.table), "memory": dict(self.memory)}


def _op_bytes(row: dict) -> int:
    """The HBM bytes of one run of a table row (the module's rules)."""
    op = row["op"]
    if row["kind"] == "kernel":
        return row["kernel_bytes"]
    if row["view"] or op in _SKIP_BYTES_OPS:
        return 0
    if op.startswith(_UPDATE_OPS):
        return 2 * row["in"][-1]
    if op.startswith(_GATHER_OPS):
        return 2 * sum(row["out"])
    if op.startswith(_FILL_OPS):
        return sum(row["out"])
    return sum(row["in"]) + sum(row["out"])


def costs_from_table(table: list[dict]) -> dict:
    """The reference's keys (``hlo_costs.py:analyze_hlo_text``) from a per-op
    table, plus the kernels' calls, FLOPs and bytes, the collectives'
    counts by kind, and the collectives' bytes and the FLOPs by
    ``costs.section`` (the train step's gradient reduction is "grads", the
    MoE layers' routed experts, forward and backward, "experts")."""
    totals = {"flops": 0.0, "bytes": 0.0, "unknown_while": 0}
    coll = defaultdict(float)
    sections = defaultdict(float)
    section_flops = defaultdict(float)
    coll_n = defaultdict(int)
    kernels = defaultdict(lambda: {"calls": 0, "flops": 0.0, "bytes": 0.0})
    coll_rows, byte_rows = [], []
    for row in table:
        n = row["n"]
        b = _op_bytes(row) * n
        totals["flops"] += row["flops"] * n
        if row.get("section") and row["flops"]:
            section_flops[row["section"]] += row["flops"] * n
        totals["bytes"] += b
        if row["kind"] == "kernel":
            k = kernels[row["op"]]
            k["calls"] += n
            k["flops"] += row["flops"] * n
            k["bytes"] += b
        if row["collective"]:
            kind, cb = row["collective"]
            coll[kind] += cb * n
            coll_n[kind] += n
            if row.get("section"):
                sections[row["section"]] += cb * n
            coll_rows.append((cb * n, f"{kind} {row['op']} {row['in'][:2]} x{n}"))
        if b:
            byte_rows.append((b, f"{row['op']} in {row['in'][:3]} out {row['out'][:2]} x{n}"))
    totals["bytes_native"] = totals["bytes"]
    totals["collectives"] = dict(coll)
    totals["collective_counts"] = dict(coll_n)
    totals["collective_bytes"] = float(sum(coll.values()))
    totals["collective_bytes_native"] = totals["collective_bytes"]
    totals["section_collective_bytes"] = dict(sections)
    totals["section_flops"] = dict(section_flops)
    coll_rows.sort(key=lambda r: -r[0])
    totals["top_collectives"] = [f"{b:.3e}B {d}" for b, d in coll_rows[:10]]
    byte_rows.sort(key=lambda r: -r[0])
    totals["top_bytes"] = [f"{b:.3e}B {d}" for b, d in byte_rows[:12]]
    totals["kernels"] = {k: dict(v) for k, v in sorted(kernels.items())}
    return totals


def analyze_step(fn, *args) -> dict:
    """Run ``fn(*args)`` once under a :class:`Walk`; its costs and the
    walk's ``memory``."""
    with Walk(args) as w:
        out = fn(*args)
    w.finish(out)
    return w.costs()
