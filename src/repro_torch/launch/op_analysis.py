"""Per-rank cost of one eager step, counted op by op: the port's
counterpart of ``repro.launch.hlo_analysis``.

The reference walks the optimized per-device HLO of a compiled program.
An eager port has no HLO to walk; what it has is the stream of ATen ops
one step dispatches.  ``OpAnalysis`` is a ``TorchDispatchMode`` over that
stream.  Ops on ``DTensor``s are let through to ``DTensor``'s own
dispatch (the mode returns ``NotImplemented`` for them, as torch's
``CommDebugMode`` does), which runs each as ops on the LOCAL shards and
the collectives its redistributions need; the mode counts those.  So
every number is one rank's, like the reference's per-device numbers (a
mode that counted the ``DTensor``-level op would count the global one).
It returns the reference's keys:

  * ``flops``: matmul and convolution flops (``torch.utils.flop_counter``'s
    registry: 2 * M * N * K for a product, as ``hlo_analysis._dot_flops``);
  * ``bytes``: each op's tensor inputs and outputs, the port's honest HBM
    traffic, since each eager op reads its inputs from memory and writes
    its outputs back (views and uninitialised allocations move nothing
    and are not counted; the reference counts dot, fusion, copy and
    collective ops);
  * ``collective_bytes`` and ``collectives`` by kind: the
    ``c10d_functional`` ops, their operand bytes summed, under the
    reference's kind names;

plus ``peak_bytes``, the most bytes that tensors created during the step
held at once (released as they are freed): the counterpart of XLA's temp
size.  ``breakdown(top)`` lists the largest contributors by bytes, by op.
On ``meta`` tensors (the dry run, ``launch/dryrun.py``) nothing runs on a
device: the counts come from shapes alone.
"""
from __future__ import annotations

import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

# the reference's collective kinds (hlo_analysis.COLLECTIVES)
_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "broadcast",
}
_FUNCOL = ("_c10d_functional", "c10d_functional", "_c10d_functional_autograd")
# allocations without a write, identity wrappers and views that the
# schema does not mark as views: no bytes move
_NO_TRAFFIC = {"empty", "empty_strided", "empty_like", "new_empty",
               "new_empty_strided", "wait_tensor", "detach", "alias",
               "lift_fresh", "_wrap_tensor_autograd", "_unsafe_view",
               "_reshape_alias"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _fake_tensor():
    from torch._subclasses.fake_tensor import FakeTensor
    return FakeTensor


def _tensors(tree) -> list:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


class OpAnalysis(TorchDispatchMode):
    """Counts one rank's flops, bytes and collectives over what runs
    inside it (module docstring)."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flop_fns = flop_registry
        self.flops = 0.0
        self.bytes = 0.0
        self.coll = defaultdict(float)
        self.by_op = defaultdict(lambda: [0.0, 0.0])     # name -> [B, F]
        self.live = 0
        self.peak = 0

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(t.__name__ == "DTensor" for t in types):
            # let DTensor run it as local ops and collectives, seen below
            return NotImplemented
        out = func(*args, **kwargs)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if any(isinstance(t, _fake_tensor()) for t in ins + outs):
            # DTensor's sharding propagation evaluates the GLOBAL op on
            # fake tensors for its output's metadata: not this rank's work
            return out
        ns = func.namespace
        name = func._overloadpacket.__name__
        if ns in _FUNCOL and name in _KINDS:
            size = float(sum(_nbytes(t) for t in ins))
            self.coll[_KINDS[name]] += size
            self.bytes += size
            self.by_op[f"{ns}.{name}"][0] += size
            return out
        if func.is_view or name in _NO_TRAFFIC:
            return out
        b = float(sum(_nbytes(t) for t in ins) + sum(_nbytes(t)
                                                        for t in outs))
        f = 0.0
        fn = self._flop_fns.get(func._overloadpacket)
        if fn is not None:
            f = float(fn(*args, **kwargs, out_val=out))
        self.bytes += b
        self.flops += f
        rec = self.by_op[f"{ns}.{name}"]
        rec[0] += b
        rec[1] += f
        for t in outs:
            n = _nbytes(t)
            self.live += n
            weakref.finalize(t, self._free, n)
        self.peak = max(self.peak, self.live)
        return out

    def result(self) -> dict:
        coll = {k: float(v) for k, v in self.coll.items()}
        return {"flops": self.flops, "bytes": self.bytes,
                "collective_bytes": float(sum(coll.values())),
                "collectives": coll, "peak_bytes": float(self.peak)}

    def breakdown(self, top: int = 20) -> list:
        """The ``top`` ops by bytes: ``{"op", "gbytes", "gflops"}``, as
        ``hlo_analysis.breakdown`` lists its op names."""
        rows = sorted(self.by_op.items(), key=lambda kv: -kv[1][0])[:top]
        return [{"op": k, "gbytes": v[0] / 1e9, "gflops": v[1] / 1e9}
                for k, v in rows]


def analyze(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` under an ``OpAnalysis``: (its output, the
    analysis)."""
    with OpAnalysis() as oa:
        out = fn(*args, **kwargs)
    return out, oa
