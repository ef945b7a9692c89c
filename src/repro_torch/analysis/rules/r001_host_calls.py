"""R001: a device->host conversion of a tensor in per-step code.

``.item()`` / ``.tolist()`` / ``.cpu()`` / ``.numpy()`` on a tensor, and
``float()`` / ``int()`` / ``bool()`` of one, inside per-step code wait for
the device and copy to the host: each turns one sync per step (the
decode's tokens, a dispatch's logits, an epoch's losses) into one sync per
op.  Conversions of host values (config, shapes, numpy arrays) are not
flagged, and neither is ``guards.to_host``, the one counted copy.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.lint import Finding
from repro_torch.analysis.rules._taint import (FnScanner, stmt_exprs,
                                               walk_no_defs)

RULE = "R001"
TITLE = "device->host conversion of a tensor in per-step code"
HINT = ("keep per-step code on the device; return the tensor and copy it "
        "once, outside, through guards.to_host")

CAST_BUILTINS = {"float", "int", "bool"}
SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}


class _Scanner(FnScanner):

    def on_stmt(self, s):
        for expr in stmt_exprs(s):
            for node in walk_no_defs(expr):
                if isinstance(node, ast.Call):
                    self._call(node)

    def _call(self, call):
        d = self.mod.dotted(call.func)
        bad = None
        if d in CAST_BUILTINS and any(self.tainted(a) for a in call.args):
            bad = f"{d}() of a tensor"
        elif (isinstance(call.func, ast.Attribute)
              and call.func.attr in SYNC_METHODS
              and self.tainted(call.func.value)):
            bad = f".{call.func.attr}() of a tensor"
        if bad:
            self.findings.append(Finding(
                rule=RULE, file=self.mod.relpath, line=call.lineno,
                symbol=self.fi.qualname,
                message=f"{bad} in per-step code", hint=HINT,
                code=self.mod.code_line(call)))


def check(project):
    out = []
    for mod, fi in project.per_step_functions():
        out.extend(_Scanner(project, mod, fi).run())
    return out
