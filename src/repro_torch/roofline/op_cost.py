"""Op-level cost model of eager PyTorch: the port's counterpart of the JAX
package's ``roofline/hlo_cost.py``.

Eager PyTorch has no HLO to parse, so :func:`analyze_ops` runs the function
itself under a ``TorchDispatchMode`` that sees every aten op as it is
dispatched (the backward's too) and bills each one by the HLO parser's
rules:

* matrix products (``mm``, ``addmm``, ``bmm``, ``baddbmm``, ``mv``,
  ``dot``, ``_scaled_mm``, ``convolution`` and its backward) count
  2·|out|·K FLOPs into ``dot_flops`` and ``flops``;
* an elementwise op counts one FLOP per output element, a reduction one per
  input element (softmax is one reduction at this granularity), a data
  mover (copy, cat, index, scatter, sort, ...) none; a dtype conversion is
  elementwise, as HLO's ``convert`` is;
* HBM bytes are each op's tensor operands plus its results: eager has no
  fusion, so every op is a boundary. A view (an output on an input's
  storage) launches nothing and costs nothing. A gather-like read
  (``index``, ``index_select``, ``gather``, ``embedding``) bills twice its
  output, a scatter (``index_put_``, ``index_add_``, ``scatter*``) twice its
  update, and any other in-place op twice its written region plus its other
  operands: the HLO parser's slice, scatter and dynamic-update-slice rules.

A Python loop unrolls in eager, so every layer and microbatch is counted
as it runs: the analogue of the HLO parser's trip-count rule, and
``unknown_trip_whiles`` stays 0. There are no collectives on one card, so
the collective fields stay 0. ``temp_bytes`` is the peak of the live
storage that the ops created: a storage is added when an op returns it new
and subtracted when a weak-reference finaliser sees it die (the storages
autograd saves for the backward included, as they hold it). Given a
``split`` (tensor → the number of cards that share it), :class:`OpCounter`
also keeps the peak of each live storage's per-card share,
``local_temp_bytes``: the dry run's temp on a mesh.

It runs on meta tensors, where nothing is allocated, and counts the same
on CPU tensors. Like the HLO parser it is a model, not a measurement.
"""

from __future__ import annotations

import dataclasses
import functools
import threading
import weakref
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

_DOTS = {"mm", "addmm", "bmm", "baddbmm", "mv", "addmv", "dot", "vdot", "_scaled_mm", "convolution",
         "convolution_backward"}
_ELEMENTWISE = {
    "add", "sub", "rsub", "mul", "div", "maximum", "minimum", "clamp", "clamp_min", "clamp_max", "pow",
    "exp", "exp2", "log", "log2", "log10", "log1p", "expm1", "tanh", "rsqrt", "sqrt", "neg", "abs", "reciprocal",
    "logical_and", "logical_or", "logical_xor", "logical_not", "bitwise_and", "bitwise_or", "bitwise_xor",
    "bitwise_not", "eq", "ne", "lt", "le", "gt", "ge", "where", "floor", "ceil", "round", "trunc", "sign",
    "cos", "sin", "tan", "sigmoid", "silu", "gelu", "relu", "threshold", "threshold_backward", "atan2",
    "remainder", "fmod", "erf", "isfinite", "isnan", "isinf", "square", "lerp", "addcmul", "addcdiv",
    "sigmoid_backward", "silu_backward", "gelu_backward", "tanh_backward", "softplus", "softplus_backward",
    "masked_fill", "_softmax_backward_data", "_log_softmax_backward_data", "clamp_backward", "bitwise_left_shift",
    "bitwise_right_shift", "__lshift__", "__rshift__", "floor_divide", "nan_to_num", "hypot", "xlogy", "mish",
}
_REDUCTIONS = {
    "sum", "mean", "amax", "amin", "max", "min", "argmax", "argmin", "logsumexp", "prod", "var", "std",
    "var_mean", "std_mean", "norm", "linalg_vector_norm", "any", "all", "cumsum", "cumprod", "_softmax",
    "_log_softmax", "count_nonzero",
}
_CONVERTS = {"_to_copy", "copy"}
_GATHERS = {"index", "index_select", "gather", "embedding", "take_along_dim"}
# scatter family: aten name -> position of the update operand
_SCATTERS = {"index_put": 2, "_index_put_impl": 2, "index_add": 3, "scatter": 3, "scatter_add": 3,
             "scatter_reduce": 3, "index_copy": 3, "embedding_dense_backward": 0}


@dataclasses.dataclass
class CostReport:
    """The HLO parser's report fields, plus ``temp_bytes`` (peak live
    storage the ops created), ``ops`` (aten ops seen) and ``dot_by_op``
    (``dot_flops`` by aten op name)."""

    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: float = 0.0
    coll_by_type: Dict[str, float] = dataclasses.field(default_factory=dict)
    coll_ops: float = 0.0
    dot_flops: float = 0.0
    unknown_trip_whiles: int = 0
    temp_bytes: float = 0.0
    ops: int = 0
    dot_by_op: Dict[str, float] = dataclasses.field(default_factory=dict)

    def add(self, other: "CostReport", mult: float = 1.0):
        self.flops += other.flops * mult
        self.bytes += other.bytes * mult
        self.collective_bytes += other.collective_bytes * mult
        self.dot_flops += other.dot_flops * mult
        self.coll_ops += other.coll_ops * mult
        self.unknown_trip_whiles += other.unknown_trip_whiles
        for k, v in other.coll_by_type.items():
            self.coll_by_type[k] = self.coll_by_type.get(k, 0.0) + v * mult
        # sequential pieces: the larger peak
        self.temp_bytes = max(self.temp_bytes, other.temp_bytes)
        self.ops += int(other.ops * mult)
        for k, v in other.dot_by_op.items():
            self.dot_by_op[k] = self.dot_by_op.get(k, 0.0) + v * mult


def _flat(x, acc: list) -> list:
    """The tensors of an op's arguments or results (nested lists, tuples
    and dicts), appended to ``acc``."""
    if isinstance(x, torch.Tensor):
        acc.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _flat(y, acc)
    elif isinstance(x, dict):
        for y in x.values():
            _flat(y, acc)
    return acc


@functools.lru_cache(maxsize=None)
def _composite(func) -> bool:
    """Whether an aten overload is only a composite of other ops (a
    CompositeImplicitAutograd kernel and no CPU or meta kernel of its own:
    ``matmul``, ``to``, ``linear``, but not ``silu_backward``)."""
    has = torch._C._dispatch_has_kernel_for_dispatch_key
    K = torch._C.DispatchKey
    name = func.name()
    return has(name, K.CompositeImplicitAutograd) and not (has(name, K.CPU) or has(name, K.Meta))


@functools.lru_cache(maxsize=None)
def _op_info(func):
    """(base name, the (position, name) of each argument the op writes) of
    an aten overload: ``add_`` and ``add.out`` are ``add``."""
    name = func.overloadpacket.__name__
    base = name[:-1] if name.endswith("_") and not name.endswith("__") else name
    writes = tuple((i, a.name) for i, a in enumerate(func._schema.arguments)
                   if a.alias_info is not None and a.alias_info.is_write)
    return base, writes


def _nbytes(t: torch.Tensor) -> float:
    return float(t.numel() * t.element_size())


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _numel(shape) -> float:
    n = 1.0
    for d in shape:
        n *= int(d)
    return n


def dot_flops(name: str, args: tuple, out) -> float:
    """2·|out|·K of one matrix product or convolution, ``out`` as the op
    returned it."""
    if name in ("mm", "bmm", "_scaled_mm", "mv", "dot", "vdot"):
        return 2.0 * max(out.numel(), 1) * args[0].shape[-1]
    if name in ("addmm", "baddbmm", "addmv"):
        return 2.0 * out.numel() * args[1].shape[-1]
    if name == "convolution":
        w = args[1]
        k = w.shape[0] if args[6] else w.shape[1]  # transposed: (Cin, Cout/groups, ...)
        return 2.0 * out.numel() * k * _numel(w.shape[2:])
    # convolution_backward(grad_out, input, weight, ...): each gradient asked for is a product
    g, w = args[0], args[2]
    return 2.0 * g.numel() * w.shape[1] * _numel(w.shape[2:]) * sum(1 for t in out[:2] if t is not None)


class OpCounter(TorchDispatchMode):
    """The dispatch mode behind :func:`analyze_ops`: bills every aten op
    into :attr:`report` and tracks the live storage the ops create."""

    def __init__(self, split=None):
        super().__init__()
        self.report = CostReport()
        self.split = split
        self.local_temp_bytes = 0.0
        self._live = self._live_local = 0.0
        self._seen: Dict[int, tuple] = {}
        self._lock = threading.Lock()

    def _free(self, key: int) -> None:
        with self._lock:
            n = self._seen.pop(key, None)
            if n is not None:
                self._live -= n[0]
                self._live_local -= n[1]

    def _track(self, outs: list, in_keys: set) -> None:
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            with self._lock:
                if key in self._seen or key in in_keys:
                    continue
                n = float(st.nbytes())
                local = n / self.split(t) if self.split is not None else n
                self._seen[key] = (n, local)
                self._live += n
                self._live_local += local
                self.report.temp_bytes = max(self.report.temp_bytes, self._live)
                self.local_temp_bytes = max(self.local_temp_bytes, self._live_local)
            weakref.finalize(st, self._free, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _composite(func):
            # under inference mode composite ops (matmul, to, ...) arrive
            # whole: bill the ops they decompose into, as autograd's
            # dispatch would have shown them
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        ins = _flat((args, kwargs), [])
        outs = _flat(out, [])
        base, writes = _op_info(func)
        in_keys = {_storage_key(t) for t in ins}
        self._track(outs, in_keys)
        rep = self.report
        rep.ops += 1
        written = []
        for i, nm in writes:
            a = args[i] if i < len(args) else kwargs.get(nm)
            if isinstance(a, torch.Tensor):
                written.append(a)
        # views: every output on an input's storage and nothing written
        if not written and outs and all(_storage_key(t) in in_keys for t in outs):
            return out
        # FLOPs
        if base in _DOTS:
            f = dot_flops(base, args, out)
            rep.flops += f
            rep.dot_flops += f
            rep.dot_by_op[base] = rep.dot_by_op.get(base, 0.0) + f
        elif base in _ELEMENTWISE:
            rep.flops += float(sum(t.numel() for t in (written or outs)[:1]))
        elif base in _REDUCTIONS:
            rep.flops += float(ins[0].numel()) if ins else 0.0
        elif base in _CONVERTS:
            src, dst = (args[1], args[0]) if base == "copy" else (args[0], outs[0] if outs else None)
            if isinstance(src, torch.Tensor) and dst is not None and src.dtype != dst.dtype:
                rep.flops += float(dst.numel())
        # bytes
        if base in _GATHERS:
            rep.bytes += 2.0 * sum(_nbytes(t) for t in outs)
        elif base in _SCATTERS:
            upd = args[_SCATTERS[base]] if len(args) > _SCATTERS[base] else None
            if isinstance(upd, (list, tuple)):
                upd = None
            rep.bytes += 2.0 * (_nbytes(upd) if isinstance(upd, torch.Tensor) else sum(_nbytes(t) for t in outs))
        elif written:
            w_ids = {id(t) for t in written}
            rep.bytes += 2.0 * sum(_nbytes(t) for t in written)
            if base != "copy":
                rep.bytes += sum(_nbytes(t) for t in ins if id(t) not in w_ids)
        else:
            rep.bytes += sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        return out


def analyze_ops(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` under :class:`OpCounter`: returns
    ``(result, CostReport)``. On meta tensors nothing is allocated."""
    counter = OpCounter()
    with counter:
        result = fn(*args, **kwargs)
    return result, counter.report


def _storages(tree) -> Dict[int, float]:
    """{storage key: bytes} of the distinct storages under ``tree`` (nested
    dicts, lists, tuples, ``nn.Module`` weights and buffers)."""
    out: Dict[int, float] = {}
    for leaf in tree_flatten(tree)[0]:
        if isinstance(leaf, torch.nn.Module):
            tensors = list(leaf.parameters()) + list(leaf.buffers())
        elif isinstance(leaf, torch.Tensor):
            tensors = [leaf]
        else:
            continue
        for t in tensors:
            st = t.untyped_storage()
            out[st._cdata] = float(st.nbytes())
    return out


def memory_analysis(args, result, report: CostReport) -> dict:
    """The dry run's memory record in the JAX package's keys: the bytes of
    the arguments, of the result (``alias_bytes`` of it on an argument's
    storage, as an in-place update returns its weights), the ops' peak of
    new storage beyond the result's, and ``per_device_total`` =
    argument + output + temp − alias (the arguments plus the peak)."""
    arg, out = _storages(args), _storages(result)
    argument, output = sum(arg.values()), sum(out.values())
    alias = sum(n for k, n in out.items() if k in arg)
    temp = max(report.temp_bytes - (output - alias), 0.0)
    return {
        "argument_bytes": argument,
        "output_bytes": output,
        "temp_bytes": temp,
        "alias_bytes": alias,
        "per_device_total": argument + output + temp - alias,
    }
