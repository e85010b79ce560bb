"""The port's invariant lints: AST rules over ``src/repro_torch`` that the
contract checker cannot see from one launch (the counterpart of
``repro.analysis.lint``).

Rules (suppress a line with ``# lint: allow(<rule>)`` and a reason):

- ``flat-pad`` — flat posting arrays may only be sized through
  :func:`repro_torch.core.index.flat_tile_pad`: hand-rolled ``(n // TILE
  ...) * TILE`` arithmetic outside that function is flagged.
- ``posting-alloc`` — flat posting/attr arrays (``*posting*``,
  ``*attrs*``) allocated with ``np``/``numpy``/``torch``
  ``zeros``/``full``/``empty``/``ones`` must take a size derived from
  ``flat_tile_pad``/``packed_word_pad`` (a call, or a name assigned from
  one); ``core/index.py``, the layout layer, is exempt.
- ``worklist-pad`` — work-list descriptor tables (``*worklist*``,
  ``desc``, ``*_desc``, ``desc_*``) must be sized through
  :func:`repro_torch.kernels.worklist.worklist_pad`.
- ``posting-gather`` — no gather of a posting/attr array (``x[idx]`` with
  a computed index, ``torch.gather``/``take``/``index_select``/
  ``take_along_dim`` or the methods) inside a ``*_cuda`` wrapper of
  ``kernels/`` or on the ``backend="kernel"`` host path
  (``core/engine.py:_query_topk_kernel``): the kernels read the flat
  arrays in place.  The plain versions gather by design and are out of
  scope.
- ``cpu-fallback`` — the port never falls back to the CPU on its own: no
  ``try``/``except`` around a ``*_cuda`` call or ``_build.kernel(...)``
  whose handler goes on (does not end in ``raise``), and no
  ``torch.cuda.is_available()`` test whose branch picks a plain
  (``*_torch``) version.
- ``launch-counter`` — every ``*_cuda`` wrapper that calls
  ``_build.kernel`` increments its own ``.launches``.
- ``import-time-build`` — no ``_build.kernel``/``_build.build`` (or those
  names imported from ``_build``) at module level: the package imports on
  a machine with no card and no ``nvcc``.

The reference's ``interpret-literal`` has no counterpart: a CUDA kernel
has no interpret mode; the plain version is chosen by the device of the
tensors a dispatcher is given, which ``cpu-fallback`` polices.
"""
from __future__ import annotations

import ast
import dataclasses
import os
import re

RULES = (
    "flat-pad",
    "posting-alloc",
    "worklist-pad",
    "posting-gather",
    "cpu-fallback",
    "launch-counter",
    "import-time-build",
)

_ALLOW_RE = re.compile(r"#\s*lint:\s*allow\(([a-z-]+)\)")

#: Array constructors whose result is a fresh allocation.
_ALLOC_FNS = ("zeros", "empty", "full", "ones")
_ALLOC_MODULES = ("np", "numpy", "torch")

#: Size helpers of the layout/codec layer and of the work-list layer.
_PAD_FNS = ("flat_tile_pad", "packed_word_pad")
_WL_PAD_FNS = ("worklist_pad",)

#: The layout layer itself, where the pad helpers live.
_ALLOC_EXEMPT = ("repro_torch/core/index.py",)

#: Host paths of the ``kernel`` backends that must not gather a stream.
_GATHER_PATHS = {("repro_torch/core/engine.py", "_query_topk_kernel")}
_GATHER_FNS = ("gather", "take", "take_along_dim", "index_select")

#: Entry points of the kernel build: never at module level.
_BUILD_FNS = ("kernel", "build")


def _is_payload_name(name: str) -> bool:
    low = name.lower()
    return "posting" in low or "attrs" in low


def _name_of(node: ast.AST) -> str:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return ""


def _is_alloc_call(node: ast.AST) -> bool:
    return (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Attribute)
        and node.func.attr in _ALLOC_FNS
        and isinstance(node.func.value, ast.Name)
        and node.func.value.id in _ALLOC_MODULES
    )


def _calls_fn(node: ast.AST, fns: tuple[str, ...]) -> bool:
    return any(isinstance(sub, ast.Call) and _name_of(sub.func) in fns
               for sub in ast.walk(node))


def _is_desc_name(name: str) -> bool:
    low = name.lower()
    return ("worklist" in low or low == "desc" or low.endswith("_desc")
            or low.startswith("desc_"))


def _is_build_call(node: ast.AST, imported: set) -> bool:
    """``_build.kernel(...)``/``_build.build(...)``, or a name imported
    from ``_build``."""
    if not isinstance(node, ast.Call):
        return False
    fn = node.func
    if isinstance(fn, ast.Attribute) and fn.attr in _BUILD_FNS:
        return isinstance(fn.value, ast.Name) and fn.value.id == "_build"
    return isinstance(fn, ast.Name) and fn.id in imported


def _calls_cuda(node: ast.AST) -> bool:
    return any(isinstance(sub, ast.Call) and _name_of(sub.func).endswith("_cuda")
               for sub in ast.walk(node))


def _ends_in_raise(body: list) -> bool:
    return bool(body) and isinstance(body[-1], ast.Raise)


def _is_cuda_available(node: ast.AST) -> bool:
    return any(
        isinstance(sub, ast.Call) and isinstance(sub.func, ast.Attribute)
        and sub.func.attr == "is_available"
        and _name_of(sub.func.value) == "cuda"
        for sub in ast.walk(node))


def _picks_plain(nodes) -> bool:
    for node in nodes:
        for sub in ast.walk(node):
            if isinstance(sub, (ast.Name, ast.Attribute)) and _name_of(sub).endswith("_torch"):
                return True
    return False


@dataclasses.dataclass(frozen=True)
class LintFinding:
    rule: str
    message: str
    path: str
    line: int

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


def _allowed(source_lines: list[str], node: ast.AST) -> set[str]:
    """Rules suppressed on this node's lines, trailing comments included,
    plus any comment-only lines immediately above the statement."""
    out: set[str] = set()
    first = getattr(node, "lineno", 0)
    for lineno in {first, getattr(node, "end_lineno", 0)}:
        if 1 <= lineno <= len(source_lines):
            out.update(_ALLOW_RE.findall(source_lines[lineno - 1]))
    lineno = first - 1
    while 1 <= lineno <= len(source_lines):
        stripped = source_lines[lineno - 1].strip()
        if not stripped.startswith("#"):
            break
        out.update(_ALLOW_RE.findall(stripped))
        lineno -= 1
    return out


def _contains_tile_floordiv(node: ast.AST) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.BinOp) and isinstance(sub.op, ast.FloorDiv):
            if isinstance(sub.right, ast.Name) and sub.right.id == "TILE":
                return True
    return False


def _is_tile_name(node: ast.AST) -> bool:
    return isinstance(node, ast.Name) and node.id == "TILE"


class _FileLinter(ast.NodeVisitor):
    def __init__(self, rel: str, source: str):
        self.rel = rel
        self.lines = source.splitlines()
        self.findings: list[LintFinding] = []
        self._func_stack: list[str] = []
        self._alloc_scoped = rel not in _ALLOC_EXEMPT
        self._kernels = rel.startswith("repro_torch/kernels/")
        self._pad_names: list[set[str]] = [set()]
        self._wl_names: list[set[str]] = [set()]
        self._build_imports: set[str] = set()

    def _emit(self, rule: str, message: str, node: ast.AST):
        if rule in _allowed(self.lines, node):
            return
        self.findings.append(
            LintFinding(rule, message, self.rel, getattr(node, "lineno", 0)))

    # -- scopes --------------------------------------------------------------
    def visit_FunctionDef(self, node: ast.FunctionDef):
        self._check_launch_counter(node)
        self._func_stack.append(node.name)
        self._pad_names.append(set())
        self._wl_names.append(set())
        self.generic_visit(node)
        self._wl_names.pop()
        self._pad_names.pop()
        self._func_stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node: ast.Lambda):
        self._func_stack.append("<lambda>")
        self.generic_visit(node)
        self._func_stack.pop()

    def visit_ImportFrom(self, node: ast.ImportFrom):
        if (node.module or "").endswith("_build"):
            self._build_imports.update(a.asname or a.name for a in node.names
                                       if a.name in _BUILD_FNS)
        self.generic_visit(node)

    def _gather_scoped(self) -> bool:
        if not self._func_stack:
            return False
        if self._kernels and any(f.endswith("_cuda") for f in self._func_stack):
            return True
        return any((self.rel, f) in _GATHER_PATHS for f in self._func_stack)

    # -- posting-alloc / worklist-pad ----------------------------------------
    def _tracked(self, stack, node: ast.AST) -> bool:
        names = set().union(*stack)
        return any(isinstance(sub, ast.Name) and sub.id in names for sub in ast.walk(node))

    def _pad_derived(self, value: ast.AST) -> bool:
        return _calls_fn(value, _PAD_FNS) or self._tracked(self._pad_names, value)

    def _wl_derived(self, value: ast.AST) -> bool:
        return _calls_fn(value, _WL_PAD_FNS) or self._tracked(self._wl_names, value)

    def _size_args(self, value):
        return list(value.args) + [kw.value for kw in value.keywords]

    def _check_alloc(self, name: str, value: ast.AST, node: ast.AST):
        if not (self._alloc_scoped and _is_alloc_call(value) and _is_payload_name(name)):
            return
        if not any(self._pad_derived(a) for a in self._size_args(value)):
            self._emit("posting-alloc",
                       f"posting/attr array {name!r} allocated with an ad-hoc size — "
                       "derive it from flat_tile_pad()/packed_word_pad() (or pragma a "
                       "deliberately different host-side layout)", node)

    def _check_wl_alloc(self, name: str, value: ast.AST, node: ast.AST):
        if not (_is_alloc_call(value) and _is_desc_name(name)):
            return
        if not any(self._wl_derived(a) for a in self._size_args(value)):
            self._emit("worklist-pad",
                       f"work-list descriptor table {name!r} allocated with an ad-hoc "
                       "size — derive it from worklist_pad() so the spare entry exists",
                       node)

    def _assigned(self, name: str, value: ast.AST, node: ast.AST):
        if self._pad_derived(value):
            self._pad_names[-1].add(name)
        if self._wl_derived(value):
            self._wl_names[-1].add(name)
        self._check_alloc(name, value, node)
        self._check_wl_alloc(name, value, node)

    def visit_Assign(self, node: ast.Assign):
        for target in node.targets:
            if isinstance(target, ast.Name):
                self._assigned(target.id, node.value, node)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign):
        if isinstance(node.target, ast.Name) and node.value is not None:
            self._assigned(node.target.id, node.value, node)
        self.generic_visit(node)

    # -- flat-pad -------------------------------------------------------------
    def visit_BinOp(self, node: ast.BinOp):
        if ("flat_tile_pad" not in self._func_stack and isinstance(node.op, ast.Mult)
                and (_is_tile_name(node.left) or _is_tile_name(node.right))):
            other = node.right if _is_tile_name(node.left) else node.left
            if _contains_tile_floordiv(other):
                self._emit("flat-pad",
                           "hand-rolled TILE padding arithmetic — size flat posting "
                           "arrays through flat_tile_pad() so the spare tile exists", node)
        self.generic_visit(node)

    # -- posting-gather -------------------------------------------------------
    def visit_Subscript(self, node: ast.Subscript):
        if self._gather_scoped() and _is_payload_name(_name_of(node.value)):
            idx = node.slice
            parts = idx.elts if isinstance(idx, ast.Tuple) else [idx]
            if any(not isinstance(p, (ast.Slice, ast.Constant)) for p in parts):
                self._emit("posting-gather",
                           f"indexed gather of posting/attr array {_name_of(node.value)!r} "
                           "on the kernel path — the kernels read the flat arrays in "
                           "place", node)
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call):
        fn = node.func
        if self._gather_scoped() and isinstance(fn, ast.Attribute) and fn.attr in _GATHER_FNS:
            on_module = isinstance(fn.value, ast.Name) and fn.value.id == "torch"
            target = node.args[0] if on_module and node.args else (
                None if on_module else fn.value)
            if target is not None and _is_payload_name(_name_of(target)):
                self._emit("posting-gather",
                           f"{fn.attr} of posting/attr array {_name_of(target)!r} on the "
                           "kernel path — the kernels read the flat arrays in place", node)
        if not self._func_stack and _is_build_call(node, self._build_imports):
            self._emit("import-time-build",
                       "a kernel is built at import time — build inside the function "
                       "that launches it", node)
        for kw in node.keywords:
            if kw.arg is not None and not _is_alloc_call(node):
                self._check_alloc(kw.arg, kw.value, kw.value)
                self._check_wl_alloc(kw.arg, kw.value, kw.value)
        self.generic_visit(node)

    # -- cpu-fallback ---------------------------------------------------------
    def visit_Try(self, node: ast.Try):
        guarded = any(_calls_cuda(s) or any(_is_build_call(c, self._build_imports)
                                            for c in ast.walk(s)) for s in node.body)
        if guarded:
            for h in node.handlers:
                if not _ends_in_raise(h.body):
                    self._emit("cpu-fallback",
                               "an exception of a CUDA launch or build is caught and the "
                               "code goes on — the port never falls back on its own", h)
        self.generic_visit(node)

    visit_TryStar = visit_Try

    def visit_If(self, node: ast.If):
        if _is_cuda_available(node.test) and _picks_plain(node.body + node.orelse):
            self._emit("cpu-fallback",
                       "torch.cuda.is_available() picks a plain (*_torch) version — "
                       "pick by the tensors' device, never by the machine", node)
        self.generic_visit(node)

    def visit_IfExp(self, node: ast.IfExp):
        if _is_cuda_available(node.test) and _picks_plain([node.body, node.orelse]):
            self._emit("cpu-fallback",
                       "torch.cuda.is_available() picks a plain (*_torch) version — "
                       "pick by the tensors' device, never by the machine", node)
        self.generic_visit(node)

    # -- launch-counter -------------------------------------------------------
    def _check_launch_counter(self, node: ast.FunctionDef):
        if not node.name.endswith("_cuda"):
            return
        if not any(_is_build_call(c, self._build_imports) and _name_of(c.func) == "kernel"
                   for c in ast.walk(node)):
            return
        counted = any(
            isinstance(s, ast.AugAssign) and isinstance(s.target, ast.Attribute)
            and s.target.attr == "launches" and _name_of(s.target.value) == node.name
            for s in ast.walk(node))
        if not counted:
            self._emit("launch-counter",
                       f"wrapper {node.name!r} launches a kernel but never adds to "
                       f"{node.name}.launches", node)


def lint_source(source: str, rel: str) -> list[LintFinding]:
    """Lint a source string as if it lived at ``rel`` under ``src/``."""
    try:
        tree = ast.parse(source, filename=rel)
    except SyntaxError as e:
        return [LintFinding("flat-pad", f"unparseable: {e}", rel, e.lineno or 0)]
    linter = _FileLinter(rel, source)
    linter.visit(tree)
    return linter.findings


def lint_file(path: str, rel: str) -> list[LintFinding]:
    with open(path, encoding="utf-8") as f:
        return lint_source(f.read(), rel)


def lint_tree(root: str) -> list[LintFinding]:
    """Lint every ``.py`` file under ``root`` (the ``repro_torch`` package
    directory, or any tree), paths relative to ``root``'s parent."""
    findings: list[LintFinding] = []
    base = os.path.dirname(os.path.abspath(root))
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        for fname in sorted(filenames):
            if fname.endswith(".py"):
                path = os.path.join(dirpath, fname)
                rel = os.path.relpath(path, base).replace(os.sep, "/")
                findings.extend(lint_file(path, rel))
    return findings


def default_root() -> str:
    """The ``repro_torch`` package directory this module was imported from."""
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
