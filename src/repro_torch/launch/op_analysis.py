"""Cost of one call of a step, walked op by op: the port's counterpart of
``repro.launch.hlo_analysis`` (the port has no HLO, hence the other name).

``analyze(fn, *args)`` runs ``fn(*args)`` once under ``OpWalk``, a
``TorchDispatchMode`` that sees every aten op the call runs (the autograd
backward's too; composite ops such as ``matmul`` and ``einsum`` as the ops
they decompose into, as ``FlopCounterMode`` sees them) and every kernel
launch (``kernels.work.charge``). The same
walk runs on meta, CPU and CUDA tensors; on meta nothing is computed and
nothing is allocated, which makes it the dry run's ``jax.eval_shape``. It
counts:

  * flops - 2 x numel(out) x the contracted size for every ``mm``,
    ``bmm``, ``addmm``, ``baddbmm`` and ``matmul`` (``hlo_analysis``'s
    ``_dot_flops`` rule, and ``FlopCounterMode``'s), plus each kernel
    launch's operations (``kernels.work``).
  * bytes - input plus output bytes of every op that writes memory: a new
    storage or an in-place write. Views and metadata ops are free, as the
    HLO walk makes ``bitcast`` and ``tuple`` free (so is an op whose result
    shares its input's storage without a view's schema, ``_unsafe_view``);
    so are ``empty``-style allocations, which move nothing. An input is charged the smaller of its
    view's bytes and its storage's (a broadcast view reads its storage).
    Eager PyTorch fuses nothing, so this is the traffic the port runs;
    kernel launches are charged their ``kernels.work`` bytes.
  * collectives - ``{}``: one card.
  * memory - the arguments' bytes (the unique storages reachable from the
    call's arguments), the output's (storages made in the call that its
    result holds) and the peak of the bytes made in the call and live at
    once (``temp_size_in_bytes``), which stands in for
    ``memory_analysis()``. Liveness follows each storage's lifetime, so the
    peak is what the caching allocator's ``max_memory_allocated`` rises by
    on the card, less the allocator's rounding and any scratch an op's
    CUDA implementation takes for itself.

``ModuleCost.top_bytes(k)`` attributes bytes to (op, result type) and to
each kernel, as ``hlo_analysis.top_bytes`` does to HLO ops.
"""

from __future__ import annotations

import weakref
from typing import Any, Dict, Iterator, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.kernels import work

Tensor = torch.Tensor

_aten = torch.ops.aten
# (op, index of the left operand): 2 x numel(out) x lhs.shape[-1]. The
# first four have no decomposition; matmul decomposes into them, and counts
# itself only where it does not
_DOTS = {_aten.mm.default: 0, _aten.bmm.default: 0, _aten.addmm.default: 1,
         _aten.baddbmm.default: 1, _aten.matmul.default: 0}
_LEAF_DOTS = set(list(_DOTS)[:4])
# allocations that move no data
_FREE = {_aten.empty.memory_format, _aten.empty_strided.default,
         _aten.empty_like.default, _aten.new_empty.default,
         _aten.new_empty_strided.default}


def _tensors(obj) -> Iterator[Tensor]:
    """Every tensor reachable from ``obj``: tensors, modules (parameters,
    buffers), dicts, lists and tuples (NamedTuples too)."""
    if isinstance(obj, Tensor):
        yield obj
    elif isinstance(obj, torch.nn.Module):
        yield from obj.parameters()
        yield from obj.buffers()
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)


def _storage_bytes(objs) -> Tuple[int, Dict[int, Any]]:
    """Bytes of the unique storages reachable from ``objs``, and those
    storages by id."""
    seen: Dict[int, Any] = {}
    for t in _tensors(objs):
        st = t.untyped_storage()
        seen.setdefault(id(st), st)
    return sum(st.nbytes() for st in seen.values()), seen


def _in_bytes(t: Tensor) -> int:
    return min(t.numel() * t.element_size(), t.untyped_storage().nbytes())


def _type_str(t: Tensor) -> str:
    name = str(t.dtype).replace("torch.", "")
    return f"{name}[{','.join(str(d) for d in t.shape)}]"


class OpWalk(TorchDispatchMode):
    """The walk: enter it around a call (``with OpWalk(): ...``), or use
    ``analyze``. Kernel wrappers charge it through ``kernels.work``."""

    def __init__(self):
        super().__init__()
        self.aten_flops = 0
        self.aten_bytes = 0
        # name -> [calls, flops, bytes]
        self.kernels: Dict[str, List[int]] = {}
        # "op result-type" -> [calls, flops, bytes]
        self.ops: Dict[str, List[int]] = {}
        self.live_bytes = 0
        self.peak_live_bytes = 0
        self._live: Dict[int, Tuple[weakref.ref, int]] = {}
        self._depth = 0

    def __enter__(self):
        # entered again around each decomposition; charged once
        if not self._depth:
            work.push(self)
        self._depth += 1
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._depth -= 1
            if not self._depth:
                work.pop(self)

    def charge_kernel(self, name: str, w: work.Work) -> None:
        rec = self.kernels.setdefault(name, [0, 0, 0])
        rec[0] += 1
        rec[1] += w.flops
        rec[2] += w.bytes

    def _dead(self, key: int):
        _, n = self._live.pop(key)
        self.live_bytes -= n

    def _track(self, out: List[Tensor], ins: List[Tensor]) -> bool:
        """Count each new storage among ``out`` as live until it dies;
        whether there was one."""
        inputs = {id(t.untyped_storage()) for t in ins}
        made = False
        for t in out:
            st = t.untyped_storage()
            key = id(st)
            if key in self._live or key in inputs:
                continue
            n = st.nbytes()
            self._live[key] = (weakref.ref(st, lambda _, k=key:
                                           self._dead(k)), n)
            self.live_bytes += n
            made = True
        self.peak_live_bytes = max(self.peak_live_bytes, self.live_bytes)
        return made

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func not in _LEAF_DOTS:
            with self:
                result = func.decompose(*args, **kwargs)
            if result is not NotImplemented:
                return result
        result = func(*args, **kwargs)
        out = [t for t in tree_leaves(result) if isinstance(t, Tensor)]
        if func.is_view or not out:
            return result
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, Tensor)]
        # an op that writes no input and makes no storage aliases its
        # inputs, as _unsafe_view does without a view's schema: free
        if not (func._schema.is_mutable or self._track(out, ins)):
            return result
        if func in _FREE:
            return result
        flops = 0
        if func in _DOTS:
            lhs = args[_DOTS[func]]
            flops = 2 * out[0].numel() * lhs.shape[-1]
        n_bytes = (sum(_in_bytes(t) for t in ins)
                   + sum(t.numel() * t.element_size() for t in out))
        self.aten_flops += flops
        self.aten_bytes += n_bytes
        rec = self.ops.setdefault(f"{func} {_type_str(out[0])}", [0, 0, 0])
        rec[0] += 1
        rec[1] += flops
        rec[2] += n_bytes
        return result


class ModuleCost:
    """What ``analyze`` found in one call (``hlo_analysis.ModuleCost``'s
    fields, and the memory and the kernels beside them)."""

    def __init__(self, walk: OpWalk, argument_bytes: int, output_bytes: int,
                 result: Any = None):
        self.aten_flops = walk.aten_flops
        self.aten_bytes = walk.aten_bytes
        self.kernels = {name: {"calls": c, "flops": f, "bytes": b}
                        for name, (c, f, b) in walk.kernels.items()}
        self.flops = self.aten_flops + sum(k["flops"]
                                           for k in self.kernels.values())
        self.bytes = self.aten_bytes + sum(k["bytes"]
                                           for k in self.kernels.values())
        self.collectives: Dict[str, float] = {}
        self.collective_bytes = 0.0
        self.ops = {k: {"calls": c, "flops": f, "bytes": b}
                    for k, (c, f, b) in walk.ops.items()}
        self.argument_bytes = argument_bytes
        self.output_bytes = output_bytes
        self.temp_bytes = walk.peak_live_bytes
        self.result = result

    def memory_analysis(self) -> Dict[str, int]:
        """``compiled.memory_analysis()``'s fields: the arguments, the
        output, and the peak of what the call made and held at once."""
        return {"temp_size_in_bytes": self.temp_bytes,
                "argument_size_in_bytes": self.argument_bytes,
                "output_size_in_bytes": self.output_bytes}

    def top_bytes(self, k: int = 25) -> List[Tuple[str, float]]:
        """The top-k [(descriptor, bytes)]: ``op result-type xcalls`` per
        aten op and result type, ``kernel name xcalls`` per kernel."""
        rows = [(f"{d} x{r['calls']}", float(r["bytes"]))
                for d, r in self.ops.items()]
        rows += [(f"kernel {name} x{r['calls']}", float(r["bytes"]))
                 for name, r in self.kernels.items()]
        rows.sort(key=lambda x: -x[1])
        return rows[:k]


def analyze(fn, *args, **kwargs) -> ModuleCost:
    """Run ``fn(*args, **kwargs)`` once under an ``OpWalk``; its result is
    ``ModuleCost.result``."""
    argument_bytes, arg_storages = _storage_bytes((args, kwargs))
    walk = OpWalk()
    with walk:
        result = fn(*args, **kwargs)
    live = {key for key in walk._live if key not in arg_storages}
    _, out_storages = _storage_bytes(result)
    output_bytes = sum(st.nbytes() for key, st in out_storages.items()
                       if key in live)
    return ModuleCost(walk, argument_bytes, output_bytes, result)
