"""Host-side static analysis: the H rule pack (the JAX package's
``analysis/hostcheck.py``, pointed at the port's tree and docs).

The recurring bug classes of the host protocol layers — an eagerly
imported off-by-default module, a ``tm_*`` counter the metric catalog
forgot, a ``Config`` field that drifted out of ``set_config``, a payload
seam the fault layer cannot reach, a lock-order inversion — are found by
one systematic pass:

=====  ==============================================================
rule   checks
=====  ==============================================================
H1     import discipline: no off-by-default subsystem (``analysis``,
       ``obs``, ``faults``, ``elastic``, ``hotstate``, ``guard``,
       ``serving``, ``watchdog``, ``utils.durable``) is reachable in
       the *eager* import closure of ``import torchmpi_tpu_torch`` —
       only through its documented gate (the package ``__getattr__``,
       a ``sys.modules`` probe, or a config-string branch inside a
       function)
H2     telemetry drift: every ``tm_*`` metric emitted in code appears
       in ``docs/OBSERVABILITY_TORCH.md``, and every metric the
       catalog names is actually emitted
H3     config drift: every ``Config`` field has a ``docs/API_TORCH.md``
       row; every env-mapped field of an off-by-default subsystem
       family has the any-config env pickup in ``runtime.init`` and a
       ``set_config`` validation/trigger branch
H4     fault-surface coverage: every ``fire()``/``run_site()`` call
       names a site registered in ``faults/inject.py``, and the
       ``docs/FAULTS_TORCH.md`` site table matches the registry both
       ways
H5     lock order: the ``with <lock>``/``acquire()`` nesting graph of
       each module is acyclic
=====  ==============================================================

One difference of layout from the JAX package: the port's runtime keeps
its env pickups and ``set_config`` checks in ``config.py`` helpers
(``resolve_*``, ``check_*_override``) that ``runtime.init`` and
``runtime.set_config`` call.  H3 therefore reads, beside the bodies of
``init`` and ``set_config``, the top-level functions and assignments of
``runtime.py`` and ``config.py`` that those bodies name (one level).  A
tree laid out as the JAX package's gives the JAX package's findings.

Everything here is **pure AST + text**: no torch import, no
``torchmpi_tpu_torch`` import, no code execution — ``analysis/tool.py
--host`` loads this file standalone so the lint itself cannot trip the
very import discipline it checks.  The doc file names are parameters
(``docs=``), so the same pass reads the JAX package's catalogs.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple


def _load_findings():
    """The findings module: relative when running inside the package,
    loaded by file path when this module is exec'd standalone (the
    no-torch CLI path)."""
    try:
        from . import findings  # type: ignore[no-redef]

        return findings
    except ImportError:
        import importlib.util

        path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "findings.py")
        import sys

        name = "_torchmpi_tpu_torch_hostcheck_findings"
        if name in sys.modules:
            return sys.modules[name]
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        assert spec.loader is not None
        # Registered BEFORE exec: dataclass processing looks the module
        # up in sys.modules.
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
        return mod


_findings = _load_findings()
Finding = _findings.Finding
ERROR = _findings.ERROR
WARNING = _findings.WARNING
INFO = _findings.INFO
sort_findings = _findings.sort_findings
format_findings = _findings.format_findings
has_errors = _findings.has_errors
max_severity = _findings.max_severity

# The off-by-default subsystems: importing the package must not import
# them (H1), and their Config knob families follow the full
# env-pickup + set_config contract (H3).  Dotted names are relative to
# the package root.
GATED_MODULES = (
    "analysis", "obs", "faults", "elastic", "hotstate", "guard",
    "serving", "watchdog", "utils.durable",
)

# Config-field families owned by the gated subsystems ("fault" covers
# the fault_retries/... knobs next to the "faults" mode switch, "ckpt"
# is the durable-checkpoint surface of utils.durable).
GATED_FIELD_FAMILIES = (
    "analysis", "obs", "faults", "fault", "guard", "watchdog",
    "elastic", "hotstate", "serving", "ckpt",
)

# The catalogs the drift rules read, by role, under the docs root: the
# port's own.  ``run_hostcheck(docs=JAX_DOCS)`` reads the JAX package's.
DOCS = {"observability": "OBSERVABILITY_TORCH.md",
        "api": "API_TORCH.md",
        "faults": "FAULTS_TORCH.md"}
JAX_DOCS = {"observability": "OBSERVABILITY.md",
            "api": "API.md",
            "faults": "FAULTS.md"}

# Registry methods whose first argument is a metric name (obs/__init__
# is the only emitter, but the scan covers the whole package).
_EMIT_FUNCS = ("counter_inc", "hist_observe", "counter_handle",
               "hist_handle")

# Doc tokens that look like metrics but are not registry metric names
# (reviewed by hand; keep this list short and commented).
H2_DOC_IGNORE = frozenset({
    # The PS server's native stats-struct name, mentioned in the
    # tm_ps_{...}_total row's description — not itself a metric.
    "tm_ps_server_stats",
    # Per-stage ladder outcome counters: the bench supervisor writes
    # these BY HAND in the obs dump format (it never imports the
    # package, so they are not registry metrics — see bench.py
    # bank_stage_counters).
    "tm_bench_stage_live_total",
    "tm_bench_stage_banked_total",
    "tm_bench_stage_wedged_total",
})

# Fault-injection wrapper spellings whose first literal argument is a
# site name (faults.fire / membership's self._fire / policy run_site).
_SITE_FUNCS = ("fire", "_fire", "run_site")
_SITE_SHAPE = re.compile(r"^[a-z_]+\.[a-z_]+$")


# --------------------------------------------------------------------
# shared AST plumbing
# --------------------------------------------------------------------

def _iter_py(root: str) -> Iterable[str]:
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                yield os.path.join(dirpath, fn)


def _parse(path: str) -> Optional[ast.Module]:
    try:
        with open(path, "r", encoding="utf-8") as fh:
            return ast.parse(fh.read(), filename=path)
    except (OSError, SyntaxError):
        return None


def _module_name(pkg_root: str, path: str) -> str:
    """Dotted module name of ``path`` relative to the package root
    (``pkg_root`` names the package directory itself)."""
    pkg = os.path.basename(os.path.normpath(pkg_root))
    rel = os.path.relpath(path, pkg_root)
    parts = rel[:-3].split(os.sep)  # strip .py
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join([pkg] + [p for p in parts if p])


def _package_modules(pkg_root: str) -> Dict[str, str]:
    return {_module_name(pkg_root, p): p for p in _iter_py(pkg_root)}


def _is_type_checking_if(node: ast.If) -> bool:
    return "TYPE_CHECKING" in ast.dump(node.test)


def _eager_imports(tree: ast.Module, modname: str, is_pkg: bool,
                   known: Set[str], pkg: str) -> List[Tuple[str, int]]:
    """Package-internal modules imported when ``modname`` is imported:
    module-level statements only (functions are the lazy gates), with
    ``if TYPE_CHECKING:`` blocks excluded.  Class bodies and
    module-level ``try``/``if`` blocks DO run at import and count."""
    out: List[Tuple[str, int]] = []

    def resolve_from(node: ast.ImportFrom) -> Optional[str]:
        if node.level == 0:
            return node.module
        anchor = modname if is_pkg else modname.rsplit(".", 1)[0]
        for _ in range(node.level - 1):
            if "." not in anchor:
                return None
            anchor = anchor.rsplit(".", 1)[0]
        return f"{anchor}.{node.module}" if node.module else anchor

    def visit(body) -> None:
        for node in body:
            if isinstance(node, ast.Import):
                for alias in node.names:
                    if alias.name == pkg or alias.name.startswith(pkg + "."):
                        out.append((alias.name, node.lineno))
            elif isinstance(node, ast.ImportFrom):
                base = resolve_from(node)
                if base and (base == pkg or base.startswith(pkg + ".")):
                    out.append((base, node.lineno))
                    for alias in node.names:
                        sub = f"{base}.{alias.name}"
                        if sub in known:
                            out.append((sub, node.lineno))
            elif isinstance(node, ast.If):
                if not _is_type_checking_if(node):
                    visit(node.body)
                    visit(node.orelse)
            elif isinstance(node, ast.Try):
                visit(node.body)
                for h in node.handlers:
                    visit(h.body)
                visit(node.orelse)
                visit(node.finalbody)
            elif isinstance(node, ast.ClassDef):
                visit(node.body)
            elif isinstance(node, (ast.With,)):
                visit(node.body)

    visit(tree.body)
    return out


# --------------------------------------------------------------------
# H1 — import discipline
# --------------------------------------------------------------------

def check_imports(pkg_root: str,
                  gated: Sequence[str] = GATED_MODULES) -> List[Finding]:
    """H1: the eager import closure of the package root must not reach
    any gated subsystem."""
    modules = _package_modules(pkg_root)
    pkg = os.path.basename(os.path.normpath(pkg_root))
    known = set(modules)
    if pkg not in modules:
        return []
    graph: Dict[str, List[Tuple[str, int]]] = {}
    for name, path in modules.items():
        tree = _parse(path)
        if tree is None:
            continue
        is_pkg = os.path.basename(path) == "__init__.py"
        imps = _eager_imports(tree, name, is_pkg, known, pkg)
        # A dotted import implies its parent packages.
        full: List[Tuple[str, int]] = []
        for target, line in imps:
            parts = target.split(".")
            for k in range(1, len(parts) + 1):
                prefix = ".".join(parts[:k])
                if prefix in known:
                    full.append((prefix, line))
        graph[name] = full

    # BFS from the package root, keeping one witness chain per module.
    parent: Dict[str, Tuple[str, int]] = {}
    seen = {pkg}
    frontier = [pkg]
    while frontier:
        nxt: List[str] = []
        for mod in frontier:
            for target, line in graph.get(mod, ()):
                if target not in seen:
                    seen.add(target)
                    parent[target] = (mod, line)
                    nxt.append(target)
        frontier = nxt

    gated_full = [f"{pkg}.{g}" for g in gated]
    findings: List[Finding] = []
    for g in gated_full:
        hits = sorted(m for m in seen
                      if m == g or m.startswith(g + "."))
        if not hits:
            continue
        # Report the shallowest reachable module of the subsystem, with
        # its witness import chain.
        mod = hits[0]
        chain = [mod]
        line = 0
        while chain[-1] in parent:
            via, ln = parent[chain[-1]]
            line = line or ln
            chain.append(via)
        chain.reverse()
        importer = chain[-2] if len(chain) > 1 else pkg
        findings.append(Finding(
            rule="H1", severity=ERROR,
            message=(
                f"off-by-default module {mod!r} is in the eager import "
                f"closure of {pkg!r} (chain: {' -> '.join(chain)}); it "
                f"must only load through its gate — the package "
                f"__getattr__, a sys.modules probe, or a config branch "
                f"inside a function"),
            source=f"{modules.get(importer, importer)}:{line}"))
    return findings


# --------------------------------------------------------------------
# H2 — telemetry drift
# --------------------------------------------------------------------

def _fstring_regex(node: ast.JoinedStr) -> str:
    pat = ""
    for v in node.values:
        if isinstance(v, ast.Constant):
            pat += re.escape(str(v.value))
        else:
            pat += r"[a-z0-9_]+"
    return pat


def _emitted_metrics(pkg_root: str):
    """(literal names, {template regex: (file, line, src)}) for every
    registry emit call in the package."""
    lits: Dict[str, Tuple[str, int]] = {}
    templates: Dict[str, Tuple[str, int, str]] = {}
    for path in _iter_py(pkg_root):
        tree = _parse(path)
        if tree is None:
            continue
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call) and node.args):
                continue
            fn = node.func
            name = (fn.attr if isinstance(fn, ast.Attribute)
                    else getattr(fn, "id", ""))
            if name not in _EMIT_FUNCS:
                continue
            a0 = node.args[0]
            if (isinstance(a0, ast.Constant) and isinstance(a0.value, str)
                    and a0.value.startswith("tm_")):
                lits.setdefault(a0.value, (path, node.lineno))
            elif isinstance(a0, ast.JoinedStr):
                src = ast.unparse(a0)
                if "tm_" in src:
                    templates.setdefault(_fstring_regex(a0),
                                         (path, node.lineno, src))
    return lits, templates


_DOC_TOKEN = re.compile(
    r"tm_[a-z0-9_]*(?:\{[a-z0-9_,]+\}[a-z0-9_]+)*(?:\{[a-z0-9_,]+\})?")


def _doc_metric_tokens(text: str) -> Set[str]:
    """``tm_*`` names in the catalog, with ``{a,b,c}`` mid-name groups
    expanded and a trailing ``{label,...}`` annotation stripped."""
    tokens: Set[str] = set()
    for m in _DOC_TOKEN.finditer(text):
        t = re.sub(r"\{[a-z0-9_,]+\}$", "", m.group(0))
        outs = [""]
        for part in re.split(r"(\{[a-z0-9_,]+\})", t):
            if part.startswith("{"):
                outs = [o + alt for o in outs
                        for alt in part[1:-1].split(",")]
            else:
                outs = [o + part for o in outs]
        tokens.update(o for o in outs if len(o) > len("tm_"))
    return tokens


def check_telemetry(pkg_root: str, docs_root: str,
                    doc: str = DOCS["observability"]) -> List[Finding]:
    """H2: code-emitted ``tm_*`` metrics vs the ``docs/<doc>`` catalog
    (docs/OBSERVABILITY_TORCH.md), both directions."""
    doc_path = os.path.join(docs_root, doc)
    try:
        with open(doc_path, "r", encoding="utf-8") as fh:
            tokens = _doc_metric_tokens(fh.read())
    except OSError:
        tokens = set()
    lits, templates = _emitted_metrics(pkg_root)
    findings: List[Finding] = []
    for name, (path, line) in sorted(lits.items()):
        if name not in tokens:
            findings.append(Finding(
                rule="H2", severity=ERROR,
                message=(f"metric {name!r} is emitted but missing from "
                         f"docs/{doc}'s catalog"),
                source=f"{path}:{line}"))
    for pat, (path, line, src) in sorted(templates.items()):
        if not any(re.fullmatch(pat, t) for t in tokens):
            findings.append(Finding(
                rule="H2", severity=ERROR,
                message=(f"metric family {src} has no instantiation in "
                         f"docs/{doc}'s catalog"),
                source=f"{path}:{line}"))
    for t in sorted(tokens - set(lits) - H2_DOC_IGNORE):
        if any(re.fullmatch(p, t) for p in templates):
            continue
        findings.append(Finding(
            rule="H2", severity=ERROR,
            message=(f"docs/{doc} documents {t!r} but no "
                     f"code emits it"),
            source=doc_path))
    return findings


# --------------------------------------------------------------------
# H3 — config drift
# --------------------------------------------------------------------

def _config_surface(pkg_root: str):
    """(ordered Config fields, field -> env var from ``from_env``)."""
    tree = _parse(os.path.join(pkg_root, "config.py"))
    fields: List[str] = []
    env: Dict[str, str] = {}
    if tree is None:
        return fields, env
    cls = next((n for n in tree.body
                if isinstance(n, ast.ClassDef) and n.name == "Config"),
               None)
    if cls is None:
        return fields, env

    def env_of(call: ast.AST) -> Optional[str]:
        for node in ast.walk(call):
            if isinstance(node, ast.Constant) \
                    and isinstance(node.value, str) \
                    and node.value.startswith("TORCHMPI_TPU_"):
                return node.value
        return None

    for stmt in cls.body:
        if isinstance(stmt, ast.AnnAssign) and isinstance(stmt.target,
                                                          ast.Name):
            fields.append(stmt.target.id)
        if isinstance(stmt, ast.FunctionDef) and stmt.name == "from_env":
            for node in ast.walk(stmt):
                if isinstance(node, ast.keyword) and node.arg in fields:
                    name = env_of(node.value)
                    if name:
                        env[node.arg] = name
                # The tail `cfg.field = ...os.environ.get("X")...` form.
                if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                        and isinstance(node.targets[0], ast.Attribute):
                    name = env_of(node.value)
                    if name:
                        env.setdefault(node.targets[0].attr, name)
    return fields, env


def _top_level(trees: Sequence[Optional[ast.Module]]
               ) -> Dict[str, List[ast.AST]]:
    """Top-level functions and assignments of ``trees``, by name."""
    out: Dict[str, List[ast.AST]] = {}
    for tree in trees:
        if tree is None:
            continue
        for node in tree.body:
            if isinstance(node, ast.FunctionDef):
                out.setdefault(node.name, []).append(node)
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for t in targets:
                    if isinstance(t, ast.Name):
                        out.setdefault(t.id, []).append(node)
    return out


def _reach(fn_name: str, runtime_tree: ast.Module,
           helper_trees: Sequence[Optional[ast.Module]]) -> List[ast.AST]:
    """``runtime.<fn_name>`` and the top-level definitions of the
    runtime and helper modules it names: the body a rule reads."""
    fn = next((n for n in runtime_tree.body
               if isinstance(n, ast.FunctionDef)
               and n.name == fn_name), None)
    if fn is None:
        return []
    defs = _top_level([runtime_tree, *helper_trees])
    names = {n.id for n in ast.walk(fn) if isinstance(n, ast.Name)}
    return [fn] + [d for name in sorted(names) if name != fn_name
                   for d in defs.get(name, ())]


def _strings(nodes: Sequence[ast.AST]) -> Set[str]:
    return {node.value for root in nodes for node in ast.walk(root)
            if isinstance(node, ast.Constant)
            and isinstance(node.value, str)}


def _set_config_literals(runtime_tree: ast.Module,
                         helper_trees: Sequence[Optional[ast.Module]] = ()
                         ) -> Set[str]:
    return _strings(_reach("set_config", runtime_tree, helper_trees))


def check_config(pkg_root: str, docs_root: str,
                 doc: str = DOCS["api"]) -> List[Finding]:
    """H3: Config fields vs their three host surfaces — the
    ``docs/<doc>`` table (docs/API_TORCH.md; every field), and for the
    gated-subsystem knob families the any-config env pickup in
    ``runtime.init`` plus a ``set_config`` branch (each read with the
    ``config.py`` helpers it names)."""
    fields, env_map = _config_surface(pkg_root)
    if not fields:
        return []
    runtime_path = os.path.join(pkg_root, "runtime.py")
    runtime_tree = _parse(runtime_path)
    if runtime_tree is None:
        return []
    config_tree = _parse(os.path.join(pkg_root, "config.py"))
    with open(runtime_path, "r", encoding="utf-8") as fh:
        runtime_envs = set(re.findall(r"TORCHMPI_TPU_[A-Z0-9_]+",
                                      fh.read()))
    for v in _strings(_reach("init", runtime_tree, [config_tree])):
        runtime_envs.update(re.findall(r"TORCHMPI_TPU_[A-Z0-9_]+", v))
    sc_lits = _set_config_literals(runtime_tree, [config_tree])
    try:
        with open(os.path.join(docs_root, doc), "r",
                  encoding="utf-8") as fh:
            api = fh.read()
    except OSError:
        api = ""

    findings: List[Finding] = []
    config_path = os.path.join(pkg_root, "config.py")
    for f in fields:
        if f"`{f}`" not in api and f"Config.{f}" not in api:
            findings.append(Finding(
                rule="H3", severity=ERROR,
                message=f"Config.{f} has no docs/{doc} table row",
                source=config_path))
        if f.split("_")[0] not in GATED_FIELD_FAMILIES:
            continue
        env = env_map.get(f)
        if env and env not in runtime_envs:
            findings.append(Finding(
                rule="H3", severity=ERROR,
                message=(
                    f"Config.{f} maps to {env} in Config.from_env but "
                    f"runtime.init never picks it up for an explicit "
                    f"config (the any-config _env_default_pickup "
                    f"contract its subsystem siblings follow)"),
                source=runtime_path))
        if f not in sc_lits:
            findings.append(Finding(
                rule="H3", severity=ERROR,
                message=(
                    f"Config.{f} has no set_config validation or "
                    f"activation branch — a runtime switch of it is "
                    f"applied unchecked"),
                source=runtime_path))
    return findings


# --------------------------------------------------------------------
# H4 — fault-surface coverage
# --------------------------------------------------------------------

def _registered_sites(pkg_root: str) -> Set[str]:
    tree = _parse(os.path.join(pkg_root, "faults", "inject.py"))
    if tree is None:
        return set()
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id == "SITES":
            return {elt.value for elt in ast.walk(node.value)
                    if isinstance(elt, ast.Constant)
                    and isinstance(elt.value, str)}
    return set()


def check_faults(pkg_root: str, docs_root: str,
                 doc: str = DOCS["faults"]) -> List[Finding]:
    """H4: every literal ``fire()``/``run_site()`` site exists in the
    ``SITES`` registry, and the ``docs/<doc>`` site table
    (docs/FAULTS_TORCH.md) matches the registry in both directions."""
    sites = _registered_sites(pkg_root)
    inject_path = os.path.join(pkg_root, "faults", "inject.py")
    if not sites:
        return []
    findings: List[Finding] = []
    for path in _iter_py(pkg_root):
        if path == inject_path:
            continue
        tree = _parse(path)
        if tree is None:
            continue
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call) and node.args):
                continue
            fn = node.func
            name = (fn.attr if isinstance(fn, ast.Attribute)
                    else getattr(fn, "id", ""))
            if name not in _SITE_FUNCS:
                continue
            a0 = node.args[0]
            if isinstance(a0, ast.Constant) and isinstance(a0.value, str) \
                    and _SITE_SHAPE.match(a0.value) \
                    and a0.value not in sites:
                findings.append(Finding(
                    rule="H4", severity=ERROR,
                    message=(
                        f"{name}({a0.value!r}) targets a site missing "
                        f"from faults/inject.py SITES — the seam is "
                        f"invisible to every fault plan"),
                    source=f"{path}:{node.lineno}"))
    doc_path = os.path.join(docs_root, doc)
    try:
        with open(doc_path, "r", encoding="utf-8") as fh:
            text = fh.read()
    except OSError:
        text = ""
    doc_sites = {m.group(1)
                 for m in re.finditer(r"^\|\s*`([a-z_]+\.[a-z_]+)`",
                                      text, re.M)}
    for s in sorted(doc_sites - sites):
        findings.append(Finding(
            rule="H4", severity=ERROR,
            message=(f"docs/{doc} documents site {s!r} which is "
                     f"not registered in faults/inject.py SITES"),
            source=doc_path))
    for s in sorted(sites - doc_sites):
        if text:
            findings.append(Finding(
                rule="H4", severity=ERROR,
                message=(f"site {s!r} is registered in faults/inject.py "
                         f"but missing from the docs/{doc} site "
                         f"table"),
                source=inject_path))
    return findings


# --------------------------------------------------------------------
# H5 — lock order
# --------------------------------------------------------------------

def _lockish(expr: ast.AST) -> Optional[str]:
    """A lock-identity key for a with/acquire target, or None.  Keys
    are textual per module; ``self.X`` is qualified by the enclosing
    class later."""
    target = expr
    # with lock.acquire() / lock.acquire(timeout=...) — unwrap the call
    if isinstance(target, ast.Call) and isinstance(target.func,
                                                   ast.Attribute) \
            and target.func.attr == "acquire":
        target = target.func.value
    if isinstance(target, (ast.Name, ast.Attribute)):
        tail = target.attr if isinstance(target, ast.Attribute) \
            else target.id
        if "lock" in tail.lower():
            try:
                return ast.unparse(target)
            except Exception:  # noqa: BLE001
                return None
    return None


def _module_lock_edges(tree: ast.Module):
    """Directed edges (outer held -> inner acquired), with one witness
    line per edge."""
    edges: Dict[Tuple[str, str], int] = {}

    def key(name: str, cls: Optional[str]) -> str:
        return f"{cls}.{name}" if cls and name.startswith("self.") \
            else name

    def visit(node, held: Tuple[str, ...], cls: Optional[str]) -> None:
        if isinstance(node, ast.ClassDef):
            cls = node.name
        acquired: List[str] = []
        if isinstance(node, ast.With):
            for item in node.items:
                lk = _lockish(item.context_expr)
                if lk:
                    acquired.append(key(lk, cls))
        elif isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "acquire":
            lk = _lockish(node)
            if lk:
                held_k = key(lk, cls)
                for h in held:
                    if h != held_k:
                        edges.setdefault((h, held_k), node.lineno)
        for a in acquired:
            for h in held:
                if h != a:
                    edges.setdefault((h, a), node.lineno)
        inner = held + tuple(acquired)
        for child in ast.iter_child_nodes(node):
            # A nested def runs later, under whatever locks its CALLER
            # holds — not the ones held at definition site.
            child_held = () if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef,
                        ast.Lambda)) else inner
            visit(child, child_held, cls)

    visit(tree, (), None)
    return edges


def _find_cycle(edges) -> Optional[List[str]]:
    graph: Dict[str, List[str]] = {}
    for (a, b) in edges:
        graph.setdefault(a, []).append(b)
    WHITE, GREY, BLACK = 0, 1, 2
    color: Dict[str, int] = {}
    stack: List[str] = []

    def dfs(n: str) -> Optional[List[str]]:
        color[n] = GREY
        stack.append(n)
        for m in graph.get(n, ()):
            c = color.get(m, WHITE)
            if c == GREY:
                return stack[stack.index(m):] + [m]
            if c == WHITE:
                cyc = dfs(m)
                if cyc:
                    return cyc
        stack.pop()
        color[n] = BLACK
        return None

    for n in sorted(graph):
        if color.get(n, WHITE) == WHITE:
            cyc = dfs(n)
            if cyc:
                return cyc
    return None


def check_locks(pkg_root: str) -> List[Finding]:
    """H5: per-module lock-acquisition graphs must be acyclic.  Lock
    identity is textual (``self._lock`` qualified by class), so the
    check is per module — exactly the scope where the planner table,
    obs registry, hotstate store, and membership board locks live."""
    findings: List[Finding] = []
    for path in _iter_py(pkg_root):
        tree = _parse(path)
        if tree is None:
            continue
        edges = _module_lock_edges(tree)
        if not edges:
            continue
        cyc = _find_cycle(edges)
        if cyc:
            line = min(ln for (a, b), ln in edges.items()
                       if a in cyc and b in cyc)
            findings.append(Finding(
                rule="H5", severity=ERROR,
                message=(
                    f"lock-order cycle {' -> '.join(cyc)}: two threads "
                    f"taking these locks in different orders can "
                    f"deadlock"),
                source=f"{path}:{line}"))
    return findings


# --------------------------------------------------------------------
# entry
# --------------------------------------------------------------------

HOST_RULES = {
    "H1": "off-by-default module imported outside its documented gate",
    "H2": "tm_* metric catalog drift between code and "
          "docs/OBSERVABILITY_TORCH.md",
    "H3": "Config field missing API_TORCH.md row / env pickup / "
          "set_config branch",
    "H4": "fault-injection site drift between call sites, "
          "faults/inject.py and docs/FAULTS_TORCH.md",
    "H5": "lock-order cycle inside a module",
}


def run_hostcheck(package_root: Optional[str] = None,
                  docs_root: Optional[str] = None,
                  rules: Optional[Sequence[str]] = None,
                  docs: Optional[Dict[str, str]] = None) -> List[Finding]:
    """Run the H rule pack; returns sorted findings.

    ``package_root`` is the package *directory* (default: the
    ``torchmpi_tpu_torch`` tree this file lives in); ``docs_root`` the
    docs directory next to it; ``docs`` the catalogs' file names by role
    (default :data:`DOCS`).  All are parameters so the rule fixtures can
    point the pass at synthetic trees."""
    docs = dict(DOCS, **(docs or {}))
    if package_root is None:
        package_root = os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))
    if docs_root is None:
        docs_root = os.path.join(os.path.dirname(package_root), "docs")
    selected = set(rules) if rules is not None else set(HOST_RULES)
    out: List[Finding] = []
    if "H1" in selected:
        out.extend(check_imports(package_root))
    if "H2" in selected:
        out.extend(check_telemetry(package_root, docs_root,
                              docs["observability"]))
    if "H3" in selected:
        out.extend(check_config(package_root, docs_root,
                              docs["api"]))
    if "H4" in selected:
        out.extend(check_faults(package_root, docs_root,
                              docs["faults"]))
    if "H5" in selected:
        out.extend(check_locks(package_root))
    return sort_findings(out)


__all__ = [
    "run_hostcheck", "check_imports", "check_telemetry", "check_config",
    "check_faults", "check_locks", "HOST_RULES", "GATED_MODULES",
    "GATED_FIELD_FAMILIES", "DOCS", "JAX_DOCS",
    "Finding", "format_findings", "has_errors", "max_severity",
]
