"""D1 and D3 by a static pass over a step's Python source.

In eager PyTorch the source *is* the program, and a branch that one rank
skips is never seen by a recording of another: so the rules that JAX
decides on a jaxpr's ``cond`` / ``switch`` (rank-derived predicates,
branch orders) the port decides on the ``ast`` of the step function, of
the ``loss_fn`` handed to a builder, and of the functions they call by
plain name in the same module (nested ``def`` s included), to a bounded
depth.

- **Taint**: a value derived from the rank — a call of ``rank``,
  ``process_index``, ``get_rank``, ``local_rank`` or ``axis_index``
  (``runtime.rank()``, ``torch.distributed.get_rank()``,
  ``collectives.axis_index(...)``), or a ``.rank`` attribute (a
  communicator's) — taints every name assigned from it, through
  arithmetic, comparisons and calls, to a fixed point (flow-insensitive
  within one function).
- **Branches**: an ``if`` / ``elif`` chain is one site with one branch a
  clause (the last the ``else``, empty or not), a ``while`` one site of
  two branches (its body, or not), a conditional expression one site of
  two.  A site whose tests are tainted is rank-divergent.
- **Collectives**: the port's verbs (``allreduce``, ... and their
  ``_rank_major`` / ``_in_axis`` forms), its gradient syncs and barrier,
  and ``torch.distributed``'s, in evaluation order (a call after its
  arguments).  A bare verb name (``gather``, ``scatter``, ``reduce``,
  ``broadcast``) counts only where it resolves, through the function's
  globals, to this package or ``torch.distributed`` — a tensor's
  ``gather`` is not a collective.

Each collective the pass reaches becomes a :class:`CollectiveEvent`
with the stack of branch frames around it, JAX's event shape, so D1 and
D3 are JAX's rules over this stream.  A function with no retrievable
source (a builtin, a lambda in a REPL) is skipped.
"""

from __future__ import annotations

import ast
import inspect
import textwrap
import types
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .events import CollectiveEvent, CondFrame

VERBS = ("allreduce", "broadcast", "reduce", "reduce_scatter", "allgather",
         "gather", "scatter", "sendreceive", "alltoall")
# Forms whose names are unambiguous wherever they resolve.
_FORMS = {f"{v}{s}": v for v in VERBS
          for s in ("_rank_major", "_in_axis", "_in_axis_grad")}
_LIBRARY = {
    "synchronize_gradients": "allreduce",
    "synchronize_gradients_rank_major": "allreduce",
    "synchronize_gradient_tensors": "allreduce",
    "synchronize_parameters": "broadcast",
    "resynchronize_parameters_in_axis": "broadcast",
    "resynchronize_parameters_in_axis_rank_major": "broadcast",
    "fused_allreduce_rank_major_": "allreduce",
    "shift_in_axis": "sendreceive", "shift_in_axis_grad": "sendreceive",
}
_DIST = {"all_reduce": "allreduce", "broadcast": "broadcast",
         "reduce": "reduce", "all_gather": "allgather",
         "all_gather_into_tensor": "allgather",
         "reduce_scatter": "reduce_scatter",
         "reduce_scatter_tensor": "reduce_scatter",
         "all_to_all": "alltoall", "all_to_all_single": "alltoall",
         "gather": "gather", "scatter": "scatter", "barrier": "barrier",
         "send": "sendreceive", "recv": "sendreceive"}
RANK_SOURCES = ("rank", "process_index", "get_rank", "local_rank",
                "get_local_rank", "axis_index")
MAX_DEPTH = 3


def _resolve(node: ast.AST, env: dict):
    """The object a Name / Attribute chain names in ``env``, or None."""
    if isinstance(node, ast.Name):
        return env.get(node.id)
    if isinstance(node, ast.Attribute):
        base = _resolve(node.value, env)
        return None if base is None else getattr(base, node.attr, None)
    return None


def _ours(obj) -> bool:
    mod = (obj.__name__ if isinstance(obj, types.ModuleType)
           else getattr(obj, "__module__", None)) or ""
    return (mod.startswith("torchmpi_tpu_torch")
            or mod.startswith("torch.distributed"))


def _call_name(call: ast.Call) -> str:
    f = call.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return ""


def _literal_axes(call: ast.Call) -> Tuple[str, ...]:
    node = next((k.value for k in call.keywords if k.arg == "axis_names"),
                None)
    if node is None and _call_name(call).endswith(("_in_axis",
                                                   "_in_axis_grad")) \
            and len(call.args) > 1:
        node = call.args[1]
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return (node.value,)
    if isinstance(node, (ast.Tuple, ast.List)):
        return tuple(e.value for e in node.elts
                     if isinstance(e, ast.Constant)
                     and isinstance(e.value, str))
    return ()


def _reduction(call: ast.Call) -> str:
    node = next((k.value for k in call.keywords if k.arg == "op"), None)
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return ""


def _taint_source(node: ast.AST) -> bool:
    if isinstance(node, ast.Call) and _call_name(node) in RANK_SOURCES:
        return True
    return (isinstance(node, ast.Attribute) and node.attr == "rank"
            and not isinstance(getattr(node, "ctx", None), ast.Store))


class _Scope:
    """One analyzed function: its source file, globals, nested defs and
    tainted names."""

    def __init__(self, tree: ast.AST, filename: str, first_line: int,
                 env: dict, name: str) -> None:
        self.filename, self.first, self.env, self.name = (
            filename, first_line, env, name)
        self.defs: Dict[str, ast.AST] = {
            n.name: n for n in ast.walk(tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
        self.tainted: Set[str] = set()
        assigns = [n for n in ast.walk(tree)
                   if isinstance(n, (ast.Assign, ast.AugAssign,
                                     ast.AnnAssign, ast.NamedExpr))]
        changed = True
        while changed:
            changed = False
            for a in assigns:
                value = a.value
                if value is None or not self.is_tainted(value):
                    continue
                targets = (a.targets if isinstance(a, ast.Assign)
                           else [a.target])
                for t in targets:
                    for n in ast.walk(t):
                        if isinstance(n, ast.Name) and \
                                n.id not in self.tainted:
                            self.tainted.add(n.id)
                            changed = True

    def is_tainted(self, expr: ast.AST) -> bool:
        for n in ast.walk(expr):
            if _taint_source(n):
                return True
            if isinstance(n, ast.Name) and n.id in self.tainted:
                return True
        return False

    def line(self, node: ast.AST) -> str:
        return (f"{self.filename}:{self.first + node.lineno - 1} "
                f"({self.name})")

    def nested(self, name: str) -> "_Scope":
        """The scope of a nested def: the enclosing function's names and
        taint (its closure), under its own name."""
        child = object.__new__(_Scope)
        child.__dict__.update(self.__dict__, name=name)
        return child


def _parse(fn) -> Optional[Tuple[ast.AST, str, int, dict]]:
    """(function node, file, first line, globals) of ``fn``'s source."""
    fn = inspect.unwrap(fn)
    if not isinstance(fn, types.FunctionType):
        return None
    try:
        lines, first = inspect.getsourcelines(fn)
        filename = inspect.getsourcefile(fn) or fn.__code__.co_filename
    except (OSError, TypeError):
        return None
    try:
        tree = ast.parse(textwrap.dedent("".join(lines)))
    except SyntaxError:
        return None
    node = next((n for n in tree.body
                 if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))),
                None)
    if node is None:
        return None
    env = dict(fn.__globals__)
    if fn.__closure__:
        for name, cell in zip(fn.__code__.co_freevars, fn.__closure__):
            try:
                env[name] = cell.cell_contents
            except ValueError:
                pass
    return node, filename, first, env


class _Pass:
    def __init__(self) -> None:
        self.events: List[CollectiveEvent] = []
        self.sites = 0
        self.seen: Set[int] = set()

    # -- collectives ------------------------------------------------------

    def _op_of(self, call: ast.Call, scope: _Scope) -> Optional[str]:
        """The verb a call issues, or None.  A call that resolves through
        the globals to this package or ``torch.distributed`` is known by
        its function's own name (an alias like ``ar =
        allreduce_rank_major`` included); an unresolved one by the name
        it is called by, where that is unambiguous."""
        target = _resolve(call.func, scope.env)
        if target is not None and _ours(target):
            name = getattr(target, "__name__", "")
            mod = getattr(target, "__module__", "") or ""
            if mod.startswith("torch.distributed"):
                return _DIST.get(name)
            if name in VERBS or name == "barrier":
                return name
        else:
            name = _call_name(call)
        return _FORMS.get(name) or _LIBRARY.get(name)

    def _emit(self, call: ast.Call, op: str, scope: _Scope,
              stack: Tuple[CondFrame, ...]) -> None:
        red = _reduction(call)
        self.events.append(CollectiveEvent(
            index=len(self.events),
            primitive=op if not red or red == "sum" else f"{op}[{red}]",
            axes=_literal_axes(call), nbytes=0, dtype="", path="static",
            source=scope.line(call), bound_axes=frozenset(),
            cond_stack=stack))

    def _callee(self, call: ast.Call, scope: _Scope):
        """A function called by plain name in the same module (or a
        nested def), as (node, scope) to descend into."""
        if not isinstance(call.func, ast.Name):
            return None
        name = call.func.id
        if name in scope.defs:
            return scope.defs[name], scope.nested(name)
        obj = scope.env.get(name)
        if isinstance(obj, types.FunctionType) and \
                obj.__code__.co_filename == scope.filename:
            parsed = _parse(obj)
            if parsed is not None:
                node, filename, first, env = parsed
                return node, _Scope(node, filename, first, env, obj.__name__)
        return None

    # -- expressions (evaluation order: a call after its arguments) --------

    def expr(self, node: ast.AST, scope: _Scope,
             stack: Tuple[CondFrame, ...], depth: int) -> None:
        if node is None:
            return
        if isinstance(node, ast.IfExp):
            self.expr(node.test, scope, stack, depth)
            site = self._site()
            tainted = scope.is_tainted(node.test)
            for b, sub in enumerate((node.body, node.orelse)):
                self.expr(sub, scope, stack + (CondFrame(
                    site, b, 2, tainted, scope.line(node)),), depth)
            return
        if isinstance(node, ast.Lambda):
            self.expr(node.body, scope, stack, depth)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return
        for child in ast.iter_child_nodes(node):
            self.expr(child, scope, stack, depth)
        if isinstance(node, ast.Call):
            op = self._op_of(node, scope)
            if op is not None:
                self._emit(node, op, scope, stack)
            elif depth < MAX_DEPTH:
                callee = self._callee(node, scope)
                if callee is not None and id(callee[0]) not in self.seen:
                    self.seen.add(id(callee[0]))
                    try:
                        self.stmts(callee[0].body, callee[1], stack,
                                   depth + 1)
                    finally:
                        self.seen.discard(id(callee[0]))

    def _site(self) -> int:
        self.sites += 1
        return self.sites - 1

    # -- statements -------------------------------------------------------

    def stmts(self, body: Sequence[ast.stmt], scope: _Scope,
              stack: Tuple[CondFrame, ...], depth: int) -> None:
        for st in body:
            self.stmt(st, scope, stack, depth)

    def stmt(self, st: ast.stmt, scope: _Scope,
             stack: Tuple[CondFrame, ...], depth: int) -> None:
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.ClassDef)):
            return
        if isinstance(st, ast.If):
            branches, tests, node = [], [], st
            while True:
                tests.append(node.test)
                branches.append(node.body)
                if len(node.orelse) == 1 and isinstance(node.orelse[0],
                                                        ast.If):
                    node = node.orelse[0]
                    continue
                branches.append(node.orelse)
                break
            tainted = any(scope.is_tainted(t) for t in tests)
            site = self._site()
            for t in tests:
                self.expr(t, scope, stack, depth)
            for b, sub in enumerate(branches):
                self.stmts(sub, scope, stack + (CondFrame(
                    site, b, len(branches), tainted, scope.line(st)),),
                    depth)
            return
        if isinstance(st, ast.While):
            self.expr(st.test, scope, stack, depth)
            site = self._site()
            tainted = scope.is_tainted(st.test)
            self.stmts(st.body, scope, stack + (CondFrame(
                site, 0, 2, tainted, scope.line(st)),), depth)
            self.stmts(st.orelse, scope, stack, depth)
            return
        if isinstance(st, (ast.For, ast.AsyncFor)):
            self.expr(st.iter, scope, stack, depth)
            self.stmts(st.body, scope, stack, depth)
            self.stmts(st.orelse, scope, stack, depth)
            return
        if isinstance(st, (ast.With, ast.AsyncWith)):
            for item in st.items:
                self.expr(item.context_expr, scope, stack, depth)
            self.stmts(st.body, scope, stack, depth)
            return
        if isinstance(st, ast.Try):
            for part in (st.body, *(h.body for h in st.handlers),
                         st.orelse, st.finalbody):
                self.stmts(part, scope, stack, depth)
            return
        for child in ast.iter_child_nodes(st):
            self.expr(child, scope, stack, depth)


def scan(fns: Sequence) -> List[CollectiveEvent]:
    """The static collective events of ``fns`` (each a Python function;
    the others are skipped), in source order."""
    p = _Pass()
    for fn in fns:
        parsed = _parse(fn)
        if parsed is None:
            continue
        node, filename, first, env = parsed
        scope = _Scope(node, filename, first, env,
                       getattr(fn, "__name__", ""))
        p.seen.add(id(node))
        p.stmts(node.body, scope, (), 0)
    return p.events


__all__ = ["scan", "VERBS", "RANK_SOURCES", "MAX_DEPTH"]
