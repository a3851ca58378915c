"""The port's host-side lint pack (torchmpi_tpu_torch/analysis/: H1-H5,
docs/API_TORCH.md) against the JAX package's.

JAX's tests/test_hostcheck.py ported case for case onto synthetic trees
(seeded-bad fixtures that must error, near misses that must stay silent),
reading the port's catalogs (docs/OBSERVABILITY_TORCH.md, API_TORCH.md,
FAULTS_TORCH.md).  Then: on every fixture tree the JAX package's checker
and the port's (reading the JAX package's catalog names) give the same
findings, rule, severity, message and source; the port's real tree and
docs get a clean bill; the CLI runs in a subprocess that imports neither
torch nor the package it checks; the chaos tool's ``lint`` prints and
emits what the JAX tool does, now through the port's ``Finding``.
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

from torchmpi_tpu_torch.analysis import hostcheck

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_TOOL = os.path.join(_REPO, "torchmpi_tpu_torch", "analysis", "tool.py")


def _write_tree(root, files):
    for rel, src in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))
    return str(root)


def _pkg(tmp_path, files):
    return _write_tree(tmp_path / "fakepkg", files)


def _docs(tmp_path, files):
    return _write_tree(tmp_path / "docs", files)


def _rules(findings, rule):
    return [f for f in findings if f.rule == rule]


# -- H1: import discipline ------------------------------------------------

_H1_BAD = {"__init__.py": "from . import core\n",
           "core.py": "from . import obs\n",
           "obs.py": "X = 1\n"}
_H1_TRY = {"__init__.py": """\
    try:
        from . import obs
    except ImportError:
        pass
""", "obs.py": "X = 1\n"}
_H1_OK = {"__init__.py": """\
    from typing import TYPE_CHECKING

    if TYPE_CHECKING:
        from . import obs


    def _gate():
        from . import obs
        return obs
""", "obs.py": "X = 1\n"}


def test_h1_eager_gated_import_errors(tmp_path):
    found = _rules(hostcheck.check_imports(_pkg(tmp_path, _H1_BAD)), "H1")
    assert len(found) == 1
    assert found[0].severity == hostcheck.ERROR
    assert "fakepkg -> fakepkg.core -> fakepkg.obs" in found[0].message


def test_h1_class_and_try_bodies_count_as_eager(tmp_path):
    assert _rules(hostcheck.check_imports(_pkg(tmp_path, _H1_TRY)), "H1")


def test_h1_near_miss_lazy_and_type_checking_imports_pass(tmp_path):
    assert hostcheck.check_imports(_pkg(tmp_path, _H1_OK)) == []


# -- H2: telemetry drift --------------------------------------------------

_EMITTER = """\
    def step(reg):
        reg.counter_inc("tm_widget_total")
"""
_TEMPLATE = """\
    def step(reg, phase):
        reg.counter_inc(f"tm_{phase}_total")
"""
_EMITTER_OK = """\
    def step(reg, phase):
        reg.counter_inc("tm_widget_total")
        reg.hist_observe(f"tm_{phase}_seconds", 1.0)
"""
_CATALOG_OK = """\
    | `tm_widget_total` | count | widgets |
    | `tm_fwd_seconds` | s | forward wall time |
"""
OBS = "OBSERVABILITY_TORCH.md"


def test_h2_undocumented_metric_errors(tmp_path):
    pkg = _pkg(tmp_path, {"m.py": _EMITTER})
    docs = _docs(tmp_path, {OBS: "| `tm_other` | x |\n"})
    found = _rules(hostcheck.check_telemetry(pkg, docs), "H2")
    msgs = "\n".join(f.message for f in found)
    assert "tm_widget_total" in msgs      # emitted, not catalogued
    assert "tm_other" in msgs             # catalogued, never emitted
    assert OBS in msgs


def test_h2_fstring_template_must_have_doc_instantiation(tmp_path):
    pkg = _pkg(tmp_path, {"m.py": _TEMPLATE})
    docs = _docs(tmp_path, {OBS: "nothing here\n"})
    found = _rules(hostcheck.check_telemetry(pkg, docs), "H2")
    assert any("tm_" in f.message and "family" in f.message
               for f in found)


def test_h2_near_miss_catalogued_metrics_pass(tmp_path):
    pkg = _pkg(tmp_path, {"m.py": _EMITTER_OK})
    docs = _docs(tmp_path, {OBS: _CATALOG_OK})
    assert hostcheck.check_telemetry(pkg, docs) == []


# -- H3: config drift -----------------------------------------------------

_CONFIG = """\
    import os


    class Config:
        obs_dump_every: int = 0
        plain_knob: int = 1

        @classmethod
        def from_env(cls):
            return cls(
                obs_dump_every=int(
                    os.environ.get("TORCHMPI_TPU_OBS_DUMP_EVERY", "0")),
            )
"""
_RUNTIME_OK = """\
    def init(cfg):
        _env_default_pickup(cfg, "obs_dump_every",
                            "TORCHMPI_TPU_OBS_DUMP_EVERY", int)


    def set_config(**kw):
        for k, v in kw.items():
            if k == "obs_dump_every":
                v = int(v)
"""
_RUNTIME_BARE = """\
    def init(cfg):
        pass


    def set_config(**kw):
        pass
"""
API = "API_TORCH.md"
_API_ALL = "| `obs_dump_every` | 0 | x |\n| `plain_knob` | 1 | x |\n"


def test_h3_missing_api_row_errors(tmp_path):
    pkg = _pkg(tmp_path, {"config.py": _CONFIG, "runtime.py": _RUNTIME_OK})
    docs = _docs(tmp_path, {API: "| `plain_knob` | 1 | x |\n"})
    found = _rules(hostcheck.check_config(pkg, docs), "H3")
    assert len(found) == 1
    assert "obs_dump_every" in found[0].message
    assert API in found[0].message


def test_h3_gated_family_needs_env_pickup_and_set_config(tmp_path):
    pkg = _pkg(tmp_path, {"config.py": _CONFIG,
                          "runtime.py": _RUNTIME_BARE})
    docs = _docs(tmp_path, {API: _API_ALL})
    found = _rules(hostcheck.check_config(pkg, docs), "H3")
    msgs = "\n".join(f.message for f in found)
    assert "never picks it up" in msgs
    assert "set_config" in msgs
    assert "plain_knob" not in msgs


def test_h3_near_miss_fully_wired_field_passes(tmp_path):
    pkg = _pkg(tmp_path, {"config.py": _CONFIG, "runtime.py": _RUNTIME_OK})
    docs = _docs(tmp_path, {API: _API_ALL})
    assert hostcheck.check_config(pkg, docs) == []


def test_h3_reads_the_config_helpers_runtime_names(tmp_path):
    """The port's layout: ``init`` and ``set_config`` call helpers in
    ``config.py`` that hold the pickup and the check (one level)."""
    config = textwrap.dedent(_CONFIG) + textwrap.dedent("""\


        def resolve_obs(cfg):
            _env_default_pickup(cfg, "obs_dump_every",
                                "TORCHMPI_TPU_OBS_DUMP_EVERY", int)


        def check_obs_override(k, v):
            if k == "obs_dump_every":
                return int(v)
            return v
    """)
    runtime = """\
        from .config import check_obs_override, resolve_obs


        def init(cfg):
            resolve_obs(cfg)


        def set_config(**kw):
            for k in kw:
                kw[k] = check_obs_override(k, kw[k])
    """
    pkg = _pkg(tmp_path, {"config.py": config, "runtime.py": runtime})
    docs = _docs(tmp_path, {API: _API_ALL})
    assert hostcheck._config_surface(pkg)[0] == ["obs_dump_every",
                                                 "plain_knob"]
    assert hostcheck.check_config(pkg, docs) == []
    pkg = _pkg(tmp_path, {"config.py": config, "runtime.py": _RUNTIME_BARE})
    msgs = "\n".join(f.message for f in hostcheck.check_config(pkg, docs))
    assert "never picks it up" in msgs and "set_config" in msgs


# -- H4: fault-surface coverage -------------------------------------------

_INJECT = """\
    SITES = (
        "ckpt.write",
        "ps.request",
    )


    def fire(site):
        return site
"""
FAULTS = "FAULTS_TORCH.md"
_SITES_DOC = "| `ckpt.write` | x |\n| `ps.request` | x |\n"


def test_h4_unregistered_fire_site_errors(tmp_path):
    pkg = _pkg(tmp_path, {
        "faults/inject.py": _INJECT,
        "m.py": "def f(inj):\n    inj.fire('ghost.site')\n"})
    docs = _docs(tmp_path, {FAULTS: _SITES_DOC})
    found = _rules(hostcheck.check_faults(pkg, docs), "H4")
    assert len(found) == 1
    assert "ghost.site" in found[0].message


def test_h4_doc_table_drift_errors_both_directions(tmp_path):
    pkg = _pkg(tmp_path, {
        "faults/inject.py": _INJECT,
        "m.py": "def f(inj):\n    inj.fire('ckpt.write')\n"})
    docs = _docs(tmp_path, {FAULTS: "| `ckpt.write` | x |\n"
                                    "| `stale.doc` | x |\n"})
    found = _rules(hostcheck.check_faults(pkg, docs), "H4")
    msgs = "\n".join(f.message for f in found)
    assert "'stale.doc'" in msgs          # documented, unregistered
    assert "'ps.request'" in msgs         # registered, undocumented
    assert FAULTS in msgs


def test_h4_near_miss_aligned_registry_passes(tmp_path):
    pkg = _pkg(tmp_path, {
        "faults/inject.py": _INJECT,
        "m.py": "def f(inj):\n    inj.fire('ckpt.write')\n"})
    docs = _docs(tmp_path, {FAULTS: _SITES_DOC})
    assert hostcheck.check_faults(pkg, docs) == []


# -- H5: lock-order cycles ------------------------------------------------

_LOCKS_BAD = {"m.py": """\
    import threading

    a_lock = threading.Lock()
    b_lock = threading.Lock()


    def fwd():
        with a_lock:
            with b_lock:
                pass


    def rev():
        with b_lock:
            with a_lock:
                pass
"""}
_LOCKS_OK = {"m.py": """\
    import threading

    a_lock = threading.Lock()
    b_lock = threading.Lock()


    def fwd():
        with a_lock:
            with b_lock:
                pass


    def also_fwd():
        with b_lock:
            def cb():
                with a_lock:
                    pass
"""}


def test_h5_opposite_order_acquisition_errors(tmp_path):
    found = _rules(hostcheck.check_locks(_pkg(tmp_path, _LOCKS_BAD)), "H5")
    assert len(found) == 1
    assert "cycle" in found[0].message


def test_h5_near_miss_consistent_order_and_nested_defs_pass(tmp_path):
    assert hostcheck.check_locks(_pkg(tmp_path, _LOCKS_OK)) == []


# -- the same findings as the JAX package's checker -------------------------

_JAX_DOCS_ALL = {"OBSERVABILITY.md": "| `tm_other` | x |\n",
                 "API.md": "| `plain_knob` | 1 | x |\n",
                 "FAULTS.md": "| `ckpt.write` | x |\n| `stale.doc` | x |\n"}
_FIXTURES = {
    "h1_bad": (_H1_BAD, {}), "h1_try": (_H1_TRY, {}), "h1_ok": (_H1_OK, {}),
    "h2_bad": ({"m.py": _EMITTER}, _JAX_DOCS_ALL),
    "h2_template": ({"m.py": _TEMPLATE}, {"OBSERVABILITY.md": "none\n"}),
    "h2_ok": ({"m.py": _EMITTER_OK}, {"OBSERVABILITY.md": _CATALOG_OK}),
    "h3_api": ({"config.py": _CONFIG, "runtime.py": _RUNTIME_OK},
               _JAX_DOCS_ALL),
    "h3_bare": ({"config.py": _CONFIG, "runtime.py": _RUNTIME_BARE},
                {"API.md": _API_ALL}),
    "h3_ok": ({"config.py": _CONFIG, "runtime.py": _RUNTIME_OK},
              {"API.md": _API_ALL}),
    "h4_ghost": ({"faults/inject.py": _INJECT,
                  "m.py": "def f(inj):\n    inj.fire('ghost.site')\n"},
                 {"FAULTS.md": _SITES_DOC}),
    "h4_drift": ({"faults/inject.py": _INJECT,
                  "m.py": "def f(inj):\n    inj.fire('ckpt.write')\n"},
                 _JAX_DOCS_ALL),
    "h5_bad": (_LOCKS_BAD, {}), "h5_ok": (_LOCKS_OK, {}),
}


def _key(findings):
    return [(f.rule, f.severity, f.message, f.source) for f in findings]


@pytest.mark.parametrize("name", sorted(_FIXTURES))
def test_same_findings_as_jax_checker(tmp_path, name):
    from torchmpi_tpu.analysis import hostcheck as jhostcheck

    files, docs = _FIXTURES[name]
    pkg = _pkg(tmp_path, files)
    droot = _docs(tmp_path, docs)
    ours = hostcheck.run_hostcheck(pkg, droot, docs=hostcheck.JAX_DOCS)
    theirs = jhostcheck.run_hostcheck(pkg, droot)
    assert _key(ours) == _key(theirs)
    assert bool(ours) == (not name.endswith("_ok"))


# -- the real tree and the CLI ----------------------------------------------

def test_real_tree_clean_bill():
    """The port's package and docs pass every H rule."""
    from torchmpi_tpu_torch import analysis

    assert analysis.lint_full() == []


def test_rule_subset_selection():
    found = hostcheck.run_hostcheck(rules=["H5"])
    assert all(f.rule == "H5" for f in found)


def test_cli_host_mode_clean_jsonable_and_import_free():
    probe = (
        "import runpy, sys, json\n"
        f"sys.argv = ['tool.py', '--host', '--json']\n"
        "try:\n"
        f"    runpy.run_path({_TOOL!r}, run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    rc = e.code\n"
        "bad = sorted(m for m in sys.modules if m == 'torch'\n"
        "             or m.startswith(('torch.', 'torchmpi_tpu')))\n"
        "print('RC', rc, 'IMPORTED', json.dumps(bad))\n")
    proc = subprocess.run([sys.executable, "-c", probe],
                          capture_output=True, text=True, timeout=120,
                          cwd=_REPO)
    assert proc.returncode == 0, proc.stderr
    body, _, tail = proc.stdout.rpartition("RC ")
    assert json.loads(body) == []
    assert tail.split() == ["0", "IMPORTED", "[]"]
    # Text mode, and a seeded-bad tree exits 1.
    proc = subprocess.run([sys.executable, _TOOL, "--host"],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and "[clean]" in proc.stdout


def test_cli_exits_nonzero_on_errors(tmp_path):
    pkg = _pkg(tmp_path, _H1_BAD)
    proc = subprocess.run([sys.executable, _TOOL, "--host", "--rules", "H1",
                           "--package", pkg, "--json"],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1, proc.stderr
    out = json.loads(proc.stdout)
    assert [f["rule"] for f in out] == ["H1"]


def test_chaos_tool_lint_output_unchanged(tmp_path, capsys):
    """The chaos tool's ``lint`` through the port's ``Finding``: the same
    text and JSON as the JAX tool's on a plan with problems."""
    import importlib.util

    from torchmpi_tpu_torch.analysis import findings
    from torchmpi_tpu_torch.faults import tool as ftool

    assert ftool.Finding is findings.Finding
    spec = importlib.util.spec_from_file_location(
        "_chaos_tool_hostcheck", os.path.join(_REPO, "scripts",
                                              "chaos_tool.py"))
    jtool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jtool)
    bad = tmp_path / "bad.json"
    with open(bad, "w") as f:
        json.dump({"version": 1, "seed": 3, "rules": [
            {"site": "no.such.site", "kind": "drop"},
            {"site": "runtime.barrier", "kind": "corrupt"},
            {"site": "ps.request", "kind": "drop", "prob": 0.0}]}, f)
    for argv in (["lint", str(bad)], ["lint", "--json", str(bad)]):
        outs = []
        for t in (jtool, ftool):
            rc = t.main(list(argv))
            outs.append((rc, capsys.readouterr().out))
        assert outs[0] == outs[1] and outs[0][0] == 1
