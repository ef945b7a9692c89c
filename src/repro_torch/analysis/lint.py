"""The port's static layer: an AST index of the package that knows which
function bodies are *per-step* code (run once per training step, decode
step or served dispatch), the lint driver and the baseline machinery.  A
copy of ``repro.analysis.lint`` cut to what an eager PyTorch package needs.

Per-step code is named by module, not found by tracing: an eager package
has no ``jit`` or ``scan`` whose bodies the reference's index follows.  It
is every function of ``models/``, ``kernels/ops.py``, ``serve/decode.py``,
``optim/`` and ``train/loop.py``, and the autoencoder and Eq. 5 losses
(defs named ``loss`` or ``*_loss`` in ``core/autoencoder.py`` and
``core/distill.py``; ``make_*`` factories build them on the host).

Staticness convention (as the reference's): parameters named like config
(``cfg``, ``config``, ``spec``, ``hp``), keyword-only parameters and
parameters annotated with a Python scalar type (``int``, ``str``,
``bool``, ``float``) are host values, so converting them with ``float()``
or ``int()`` is legal (R001).

The baseline (``analysis/baseline.json``) freezes known findings by
fingerprint ``(rule, file, symbol, code-line)``; line numbers are not part
of the identity, so unrelated edits do not churn it, and each entry
carries a one-line justification.  Findings beyond the baseline fail the
lint.  Pure stdlib: the linter reads the sources with ``ast`` and never
runs them.
"""
from __future__ import annotations

import ast
import json
import os
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

PACKAGE = "repro_torch"

# modules whose every function is per-step code: prefixes and exact paths
PER_STEP_PREFIXES = (f"{PACKAGE}.models.", f"{PACKAGE}.optim.")
PER_STEP_MODULES = {f"{PACKAGE}.kernels.ops", f"{PACKAGE}.serve.decode",
                    f"{PACKAGE}.train.loop"}
# modules whose losses are per-step code (the training engine's step)
LOSS_MODULES = {f"{PACKAGE}.core.autoencoder", f"{PACKAGE}.core.distill"}
LOSS_NAME_SUFFIX = "loss"
FACTORY_PREFIXES = ("make_", "build_", "get_", "create_")

STATIC_PARAM_NAMES = {"cfg", "config", "spec", "hp"}
STATIC_ANNOTATIONS = {"int", "str", "bool", "float"}


def is_per_step_module(modpath: str) -> bool:
    return modpath in PER_STEP_MODULES or modpath.startswith(
        PER_STEP_PREFIXES)


# ---------------------------------------------------------------------------
# findings + baseline
# ---------------------------------------------------------------------------

@dataclass
class Finding:
    rule: str                 # "R001" or "R007"
    file: str                 # repo-relative path
    line: int                 # 1-indexed
    symbol: str               # enclosing function qualname ("" = module)
    message: str
    hint: str = ""
    code: str = ""            # stripped source line (fingerprint component)

    @property
    def fingerprint(self) -> Tuple[str, str, str, str]:
        return (self.rule, self.file, self.symbol, self.code)

    def to_dict(self) -> dict:
        return {"rule": self.rule, "file": self.file, "line": self.line,
                "symbol": self.symbol, "message": self.message,
                "hint": self.hint, "code": self.code}


def load_baseline(path: str) -> Dict[Tuple[str, str, str, str], int]:
    """fingerprint -> allowed occurrence count."""
    if not os.path.exists(path):
        return {}
    with open(path) as fh:
        data = json.load(fh)
    out: Dict[Tuple[str, str, str, str], int] = {}
    for e in data.get("entries", []):
        fp = (e["rule"], e["file"], e["symbol"], e["code"])
        out[fp] = out.get(fp, 0) + int(e.get("count", 1))
    return out


def write_baseline(path: str, findings: Sequence[Finding]) -> None:
    """Freeze ``findings`` as the new baseline, keeping the justification
    of any entry whose fingerprint survives."""
    old = {}
    if os.path.exists(path):
        with open(path) as fh:
            for e in json.load(fh).get("entries", []):
                old[(e["rule"], e["file"], e["symbol"], e["code"])] = \
                    e.get("justification", "")
    first: Dict[Tuple[str, str, str, str], Finding] = {}
    n: Dict[Tuple[str, str, str, str], int] = {}
    for f in findings:
        first.setdefault(f.fingerprint, f)
        n[f.fingerprint] = n.get(f.fingerprint, 0) + 1
    entries = [{"rule": f.rule, "file": f.file, "symbol": f.symbol,
                "code": f.code, "count": n[fp],
                "justification": old.get(fp, "TODO: justify or fix")}
               for fp, f in sorted(first.items())]
    with open(path, "w") as fh:
        json.dump({"_": "lint baseline of the PyTorch port: frozen "
                        "findings; regenerate with python -m "
                        "repro_torch.launch.lint --baseline-update",
                   "entries": entries}, fh, indent=1)
        fh.write("\n")


def apply_baseline(findings: Sequence[Finding],
                   baseline: Dict[Tuple[str, str, str, str], int]
                   ) -> List[Finding]:
    """Drop findings covered by the baseline; occurrences beyond an
    entry's count still fail."""
    budget = dict(baseline)
    out = []
    for f in findings:
        if budget.get(f.fingerprint, 0) > 0:
            budget[f.fingerprint] -= 1
        else:
            out.append(f)
    return out


# ---------------------------------------------------------------------------
# the module index
# ---------------------------------------------------------------------------

class FuncInfo:
    """One function/lambda definition and what the linter knows about it."""

    __slots__ = ("node", "module", "qualname", "parent", "class_name",
                 "per_step", "children")

    def __init__(self, node, module: "ModuleIndex", qualname: str,
                 parent: Optional["FuncInfo"], class_name: Optional[str]):
        self.node = node
        self.module = module
        self.qualname = qualname
        self.parent = parent
        self.class_name = class_name
        self.per_step = False
        self.children: Dict[str, "FuncInfo"] = {}

    @property
    def arg_names(self) -> List[str]:
        a = self.node.args
        return ([x.arg for x in getattr(a, "posonlyargs", [])]
                + [x.arg for x in a.args] + [x.arg for x in a.kwonlyargs])

    def conventional_static_params(self) -> set:
        """Keyword-only params, config-named params and params annotated
        with a Python scalar type."""
        a = self.node.args
        out = {x.arg for x in a.kwonlyargs}
        for arg in (list(getattr(a, "posonlyargs", [])) + list(a.args)
                    + list(a.kwonlyargs)):
            if arg.arg in STATIC_PARAM_NAMES:
                out.add(arg.arg)
            ann = arg.annotation
            if isinstance(ann, ast.Name) and ann.id in STATIC_ANNOTATIONS:
                out.add(arg.arg)
        return out

    def effective_static(self) -> set:
        """Static names visible in this body, the enclosing defs' too."""
        names, fi = set(), self
        while fi is not None:
            names |= fi.conventional_static_params()
            fi = fi.parent
        return names

    @property
    def top_name(self) -> str:
        """The outermost enclosing def's (or method's) qualname."""
        fi = self
        while fi.parent is not None:
            fi = fi.parent
        return fi.qualname


class ModuleIndex(ast.NodeVisitor):
    """Parse one module: definitions, import aliases, source lines."""

    def __init__(self, abspath: str, relpath: str, modpath: str,
                 source: str):
        self.abspath = abspath
        self.relpath = relpath
        self.modpath = modpath          # e.g. "repro_torch.core.training"
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=relpath)
        self.imports: Dict[str, str] = {}     # local alias -> dotted path
        self.funcs: Dict[ast.AST, FuncInfo] = {}
        self.top_names: Dict[str, FuncInfo] = {}
        self._func_stack: List[FuncInfo] = []
        self._class_stack: List[str] = []
        self.visit(self.tree)

    def code_line(self, node) -> str:
        try:
            return self.lines[node.lineno - 1].strip()
        except IndexError:
            return ""

    def visit_Import(self, node):
        for a in node.names:
            self.imports[a.asname or a.name.split(".")[0]] = \
                a.name if a.asname else a.name.split(".")[0]

    def visit_ImportFrom(self, node):
        if node.level:                      # relative imports: not used here
            return
        for a in node.names:
            self.imports[a.asname or a.name] = f"{node.module}.{a.name}"

    def _visit_def(self, node, name: str):
        parent = self._func_stack[-1] if self._func_stack else None
        cls = self._class_stack[-1] if self._class_stack else None
        qual = f"{parent.qualname}.{name}" if parent else \
            (f"{cls}.{name}" if cls else name)
        fi = FuncInfo(node, self, qual, parent, cls)
        self.funcs[node] = fi
        if parent is not None:
            parent.children[name] = fi
        elif cls is None:
            self.top_names[name] = fi
        self._func_stack.append(fi)
        self.generic_visit(node)
        self._func_stack.pop()

    def visit_FunctionDef(self, node):
        self._visit_def(node, node.name)

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node):
        self._visit_def(node, "<lambda>")

    def visit_ClassDef(self, node):
        self._class_stack.append(node.name)
        self.generic_visit(node)
        self._class_stack.pop()

    def dotted(self, node) -> Optional[str]:
        """Resolve an expression to a dotted path through the module's
        import aliases (``F.silu`` -> ``torch.nn.functional.silu``, bare
        builtins to their own name); None when unresolvable."""
        if isinstance(node, ast.Name):
            return self.imports.get(node.id, node.id)
        if isinstance(node, ast.Attribute):
            base = self.dotted(node.value)
            return f"{base}.{node.attr}" if base else None
        return None

    def resolve_local(self, node, scope: Optional[FuncInfo]
                      ) -> Optional[FuncInfo]:
        """A Name resolved to a def in THIS module: the enclosing scopes'
        nested defs, then the module's top level."""
        if isinstance(node, ast.Name):
            fi = scope
            while fi is not None:
                if node.id in fi.children:
                    return fi.children[node.id]
                fi = fi.parent
            return self.top_names.get(node.id)
        return None


# ---------------------------------------------------------------------------
# the project index
# ---------------------------------------------------------------------------

class ProjectIndex:
    """All modules of a lint run, with the per-step functions marked."""

    def __init__(self, modules: Dict[str, ModuleIndex]):
        self.modules = modules
        for mod in modules.values():
            whole = is_per_step_module(mod.modpath)
            losses = mod.modpath in LOSS_MODULES
            for fi in mod.funcs.values():      # parents before children
                name = fi.qualname.rsplit(".", 1)[-1]
                fi.per_step = whole or (
                    fi.parent is not None and fi.parent.per_step) or (
                    losses and (name == LOSS_NAME_SUFFIX
                                or name.endswith("_" + LOSS_NAME_SUFFIX))
                    and not name.startswith(FACTORY_PREFIXES))

    def resolve_ref(self, mod: ModuleIndex, node,
                    scope: Optional[FuncInfo]) -> Optional[FuncInfo]:
        """A reference resolved to a FuncInfo, same-module first, then
        across modules through import aliases."""
        fi = mod.resolve_local(node, scope)
        if fi is not None:
            return fi
        dotted = mod.dotted(node)
        if not dotted or "." not in dotted:
            return None
        modpath, name = dotted.rsplit(".", 1)
        target = self.modules.get(modpath)
        return None if target is None else target.top_names.get(name)

    def per_step_functions(self) -> Iterable[Tuple[ModuleIndex, FuncInfo]]:
        for mod in self.modules.values():
            for fi in mod.funcs.values():
                if fi.per_step:
                    yield mod, fi


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------

def _modpath_for(relpath: str) -> str:
    """src/repro_torch/core/training.py -> repro_torch.core.training"""
    p = relpath.replace(os.sep, "/")
    if p.startswith("src/"):
        p = p[len("src/"):]
    p = p[:-3] if p.endswith(".py") else p
    if p.endswith("/__init__"):
        p = p[: -len("/__init__")]
    return p.replace("/", ".")


def _collect_files(paths: Sequence[str], root: str) -> List[str]:
    files = []
    for p in paths:
        ap = p if os.path.isabs(p) else os.path.join(root, p)
        if os.path.isdir(ap):
            for dirpath, _, names in os.walk(ap):
                files.extend(os.path.join(dirpath, n)
                             for n in names if n.endswith(".py"))
        elif ap.endswith(".py"):
            files.append(ap)
    return sorted(set(files))


def build_index(paths: Sequence[str], root: str) -> ProjectIndex:
    modules: Dict[str, ModuleIndex] = {}
    for ap in _collect_files(paths, root):
        rel = os.path.relpath(ap, root)
        with open(ap) as fh:
            source = fh.read()
        try:
            mod = ModuleIndex(ap, rel, _modpath_for(rel), source)
        except SyntaxError:
            continue                      # not this linter's job
        modules[mod.modpath] = mod
    return ProjectIndex(modules)


def run_rules(project: ProjectIndex,
              report_files: Optional[set] = None) -> List[Finding]:
    """Run every registered rule; ``report_files`` (repo-relative paths)
    restricts what is reported, not what is indexed."""
    from repro_torch.analysis import rules as rules_pkg
    findings: List[Finding] = []
    for rule in rules_pkg.ALL_RULES:
        findings.extend(rule.check(project))
    if report_files is not None:
        findings = [f for f in findings if f.file in report_files]
    findings.sort(key=lambda f: (f.file, f.line, f.rule))
    return findings


def lint_paths(paths: Sequence[str], *, root: str,
               baseline_path: Optional[str] = None,
               report_files: Optional[set] = None) -> List[Finding]:
    """Index ``paths`` under ``root`` and return non-baselined findings."""
    findings = run_rules(build_index(paths, root), report_files)
    if baseline_path:
        findings = apply_baseline(findings, load_baseline(baseline_path))
    return findings


def lint_source(source: str, *, modpath: str = "fixture",
                filename: str = "fixture.py") -> List[Finding]:
    """Lint a source snippet in isolation (the test-fixture entry point);
    ``modpath`` decides whether its functions are per-step code."""
    mod = ModuleIndex(filename, filename, modpath, source)
    return run_rules(ProjectIndex({modpath: mod}))
