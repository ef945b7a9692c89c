"""Per-function scan with tensor taint (a copy of the reference's
``rules/_taint.py``, with ``torch`` in the place of ``jax``).

``FnScanner`` walks ONE function body in statement order (never entering
nested defs: each def gets its own scan) while tracking which names hold
tensors:

* seed: a per-step function's non-static parameters (``lint.FuncInfo``'s
  staticness convention);
* propagation through assignments: a name assigned from a tensor
  expression is tainted, a name reassigned from a host one is cleared;
* ``torch.*`` calls make tensors, except the few that return host values
  (``TORCH_HOST_CALLS``); ``numpy.*`` / ``math.*`` calls and
  ``guards.to_host`` return host values;
* static extractors break the chain: ``len(...)``, ``range(...)``,
  ``.shape`` / ``.ndim`` / ``.dtype`` / ``.device`` are host values even on
  tensors.
"""
from __future__ import annotations

import ast
from typing import Iterable, List

STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda",
                "requires_grad", "itemsize", "nbytes"}
STATIC_CALLS = {"len", "range", "isinstance", "hasattr", "getattr", "type",
                "str", "repr", "id", "callable", "tuple", "enumerate", "zip"}
HOST_PREFIXES = ("numpy.", "math.")
HOST_FUNCS = {"repro_torch.analysis.guards.to_host"}
TORCH_HOST_CALLS = {"torch.is_grad_enabled", "torch.device", "torch.finfo",
                    "torch.iinfo", "torch.cuda.is_available",
                    "torch.get_default_dtype", "torch.Size"}


def stmt_exprs(s: ast.stmt) -> List[ast.expr]:
    """The expressions belonging to the statement itself (headers only for
    compound statements; bodies are walked as their own statements)."""
    if isinstance(s, ast.Assign):
        return [s.value] + list(s.targets)
    if isinstance(s, ast.AnnAssign):
        return [x for x in (s.value, s.target) if x is not None]
    if isinstance(s, ast.AugAssign):
        return [s.value, s.target]
    if isinstance(s, (ast.Expr, ast.Return)):
        return [s.value] if s.value is not None else []
    if isinstance(s, (ast.If, ast.While)):
        return [s.test]
    if isinstance(s, (ast.For, ast.AsyncFor)):
        return [s.iter]
    if isinstance(s, (ast.With, ast.AsyncWith)):
        return [i.context_expr for i in s.items]
    if isinstance(s, ast.Assert):
        return [s.test] + ([s.msg] if s.msg else [])
    if isinstance(s, ast.Raise):
        return [x for x in (s.exc, s.cause) if x is not None]
    return []


def walk_no_defs(node: ast.AST) -> Iterable[ast.AST]:
    """``ast.walk`` that does not descend into nested function definitions
    (they are scanned on their own)."""
    stack = [node]
    while stack:
        n = stack.pop()
        yield n
        for c in ast.iter_child_nodes(n):
            if isinstance(c, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
                continue
            stack.append(c)


def assigned_names(targets) -> List[str]:
    out: List[str] = []
    stack = list(targets)
    while stack:
        t = stack.pop()
        if isinstance(t, ast.Name):
            out.append(t.id)
        elif isinstance(t, (ast.Tuple, ast.List)):
            stack.extend(t.elts)
        elif isinstance(t, ast.Starred):
            stack.append(t.value)
    return out


class FnScanner:
    """Statement-ordered scan of one function with taint tracking.
    Subclasses override ``on_stmt`` (called once per statement, before the
    statement's own assignments update the taint) and append to
    ``self.findings``."""

    def __init__(self, project, mod, fi):
        self.project = project
        self.mod = mod
        self.fi = fi
        static = fi.effective_static()
        self.tensors = {n for n in fi.arg_names if n not in static}
        self.findings: list = []

    def tainted(self, node) -> bool:
        if node is None or isinstance(node, (ast.Constant, ast.Lambda,
                                             ast.JoinedStr)):
            return False
        if isinstance(node, ast.Name):
            return node.id in self.tensors
        if isinstance(node, ast.Attribute):
            return node.attr not in STATIC_ATTRS and self.tainted(node.value)
        if isinstance(node, ast.Subscript):
            return self.tainted(node.value)
        if isinstance(node, ast.Call):
            d = self.mod.dotted(node.func)
            if d in STATIC_CALLS or d in HOST_FUNCS or d in TORCH_HOST_CALLS:
                return False
            if d and d.startswith(HOST_PREFIXES):
                return False
            if d and d.startswith("torch."):
                return True
            args = list(node.args) + [k.value for k in node.keywords]
            if self.project.resolve_ref(self.mod, node.func,
                                        self.fi) is not None:
                return any(self.tainted(a) for a in args)
            return self.tainted(node.func) or any(self.tainted(a)
                                                  for a in args)
        if isinstance(node, ast.BinOp):
            return self.tainted(node.left) or self.tainted(node.right)
        if isinstance(node, ast.BoolOp):
            return any(self.tainted(v) for v in node.values)
        if isinstance(node, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                   for op in node.ops):
                return False
            return (self.tainted(node.left)
                    or any(self.tainted(c) for c in node.comparators))
        if isinstance(node, ast.UnaryOp):
            return self.tainted(node.operand)
        if isinstance(node, ast.IfExp):
            return self.tainted(node.body) or self.tainted(node.orelse)
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            return any(self.tainted(e) for e in node.elts)
        if isinstance(node, ast.Starred):
            return self.tainted(node.value)
        if isinstance(node, (ast.ListComp, ast.GeneratorExp)):
            return self.tainted(node.elt) or any(self.tainted(g.iter)
                                                 for g in node.generators)
        return False

    def run(self) -> list:
        body = self.fi.node.body
        if not isinstance(body, list):      # lambda: body is an expression
            ret = ast.Return(value=body)
            ast.copy_location(ret, body)
            body = [ret]
        self._stmts(body)
        return self.findings

    def _stmts(self, stmts) -> None:
        for s in stmts:
            self._stmt(s)

    def _stmt(self, s) -> None:
        if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef)):
            return
        self.on_stmt(s)
        if isinstance(s, ast.Assign):
            self._assign(s.targets, self.tainted(s.value))
        elif isinstance(s, ast.AnnAssign) and s.value is not None:
            self._assign([s.target], self.tainted(s.value))
        elif isinstance(s, ast.AugAssign) and self.tainted(s.value):
            self._assign([s.target], True)
        elif isinstance(s, (ast.For, ast.AsyncFor)):
            self._assign([s.target], self.tainted(s.iter))
        for block in ("body", "orelse", "finalbody"):
            self._stmts(getattr(s, block, []))
        for h in getattr(s, "handlers", []):
            self._stmts(h.body)

    def _assign(self, targets, is_tensor: bool) -> None:
        for name in assigned_names(targets):
            if is_tensor:
                self.tensors.add(name)
            else:
                self.tensors.discard(name)

    def on_stmt(self, s) -> None:            # pragma: no cover - interface
        pass
