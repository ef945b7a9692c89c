"""R007: dtype hygiene.

The port computes in fp32 (and bf16 where a config asks), with fp32
state; a stray float64 doubles a tensor's bytes and, on the card, runs at
a 64th of the fp32 rate.  So ``torch.float64`` / ``torch.double`` and
``.double()`` are flagged anywhere in the package, except inside the
functions that sum in float64 on purpose (``F64_ALLOWED``, by name).  And
in per-step code every tensor creation names its dtype: the defaults
(float32 for floats, int64 for ``arange`` of ints) are a dtype chosen by
accident.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.lint import PACKAGE, Finding

RULE = "R007"
TITLE = "float64, or a tensor created without a dtype in per-step code"
HINT = ("compute in float32 (or the config's dtype); pass dtype= to every "
        "tensor creation in per-step code")

# (module, top-level function) -> why it sums in float64
F64_ALLOWED = {
    (f"{PACKAGE}.kernels.ref", "prefix_sum"):
        "log-decay prefix sums accumulated in float64, rounded once: the "
        "same bits on the card and the CPU (the SSD, the mLSTM)",
    (f"{PACKAGE}.optim.schedule", "warmup_cosine"):
        "the cosine in float64, rounded once: correctly rounded, as XLA's "
        "fp32 cosine",
    (f"{PACKAGE}.robustness.defense", "laplace_noise"):
        "the reference's Laplace draw: float64 uniforms, rounded once",
}
F64_NAMES = {"torch.float64", "torch.double"}
CREATE = {"zeros", "ones", "empty", "full", "arange", "tensor", "as_tensor",
          "linspace", "eye", "rand", "randn"}


def _allowed(mod, fi) -> bool:
    return fi is not None and (mod.modpath, fi.top_name) in F64_ALLOWED


def _finding(mod, node, fi, message: str) -> Finding:
    return Finding(rule=RULE, file=mod.relpath, line=node.lineno,
                   symbol=fi.qualname if fi is not None else "",
                   message=message, hint=HINT, code=mod.code_line(node))


def _walk(node, fi, mod):
    """Every node of ``node`` with its innermost enclosing FuncInfo."""
    for child in ast.iter_child_nodes(node):
        inner = mod.funcs.get(child, fi)
        yield child, inner
        yield from _walk(child, inner, mod)


def check(project):
    out = []
    for mod in project.modules.values():
        for node, fi in _walk(mod.tree, None, mod):
            if isinstance(node, ast.Attribute) and \
                    mod.dotted(node) in F64_NAMES and not _allowed(mod, fi):
                out.append(_finding(mod, node, fi,
                                    f"`{mod.dotted(node)}`: the port "
                                    f"computes in float32"))
            if not isinstance(node, ast.Call):
                continue
            if isinstance(node.func, ast.Attribute) and \
                    node.func.attr == "double" and not _allowed(mod, fi):
                out.append(_finding(mod, node, fi, "`.double()`: the port "
                                    "computes in float32"))
            d = mod.dotted(node.func)
            if fi is not None and fi.per_step and d and \
                    d.startswith("torch.") and d[6:] in CREATE and \
                    not any(kw.arg == "dtype" for kw in node.keywords):
                out.append(_finding(
                    mod, node, fi, f"`{d}` without an explicit dtype in "
                                   f"per-step code"))
    return out
