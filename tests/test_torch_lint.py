"""nomadlint's determinism, excepts and observatory passes over the port.

The passes name nomad_tpu's tree in their scopes; here each scope is
remapped to ``nomad_tpu_torch/`` for the test's duration (``tools/`` is
not changed) and run over the port's modules, which must give no
finding. The remap is shown live by a scratch tree with one seeded fault
a rule, which each remapped pass must report.
"""

import ast
import textwrap

import pytest

from tools.nomadlint import determinism, excepts, observatory
from tools.nomadlint.project import Project
from tools.nomadlint.registry import Finding

PORT = "nomad_tpu_torch"


def _remap(scope):
    return tuple(PORT + s[len("nomad_tpu"):] if s.startswith("nomad_tpu/")
                 else s for s in scope)


@pytest.fixture
def port_scopes(monkeypatch):
    monkeypatch.setattr(determinism, "DECISION_SCOPE",
                        _remap(determinism.DECISION_SCOPE))
    monkeypatch.setattr(determinism, "TIME_SCOPE",
                        _remap(determinism.TIME_SCOPE))
    monkeypatch.setattr(excepts, "HOT_SCOPE", _remap(excepts.HOT_SCOPE))
    monkeypatch.setattr(observatory, "OBSERVATORY_SCOPE",
                        _remap(observatory.OBSERVATORY_SCOPE))
    monkeypatch.setattr(observatory, "COMPOSITION_ROOTS",
                        _remap(observatory.COMPOSITION_ROOTS))
    monkeypatch.setattr(observatory, "TARGET_MODULES", tuple(
        PORT + m[len("nomad_tpu"):] for m in observatory.TARGET_MODULES))


def _port_from_imports(project):
    """OBS001's ``from nomad_tpu import capacity`` arm names the package
    literally; the port's form of it, ``from nomad_tpu_torch import
    capacity``, is checked here with the same scope and roots."""
    out = []
    for mod in project.scoped(observatory.OBSERVATORY_SCOPE):
        if mod.relpath in observatory.COMPOSITION_ROOTS:
            continue
        raw = [
            Finding("OBS001", mod.relpath, node.lineno, mod.modname,
                    f"decision-path module imports {PORT}.{alias.name}",
                    snippet=mod.snippet(node.lineno))
            for node in ast.walk(mod.tree)
            if isinstance(node, ast.ImportFrom) and node.module == PORT
            for alias in node.names
            if alias.name in observatory._TARGET_LEAVES
        ]
        out.extend(project.filter_allowed(mod, raw))
    return out


PASSES = {
    "determinism": determinism.run,
    "excepts": excepts.run,
    "observatory": lambda p: observatory.run(p) + _port_from_imports(p),
    "meta": lambda p: p.meta_findings(),
}


@pytest.fixture(scope="module")
def port_project():
    project = Project(roots=(PORT,))
    assert not project.errors, project.errors
    return project


@pytest.mark.parametrize("name", sorted(PASSES))
def test_port_has_no_finding(name, port_scopes, port_project):
    findings = PASSES[name](port_project)
    assert findings == [], "\n".join(
        f"{f.file}:{f.line} {f.rule_id} {f.message}" for f in findings)


def test_decision_scope_covers_the_update_path(port_scopes, port_project):
    """Every module of the job-update path sits in the decision scope."""
    for rel in ("structs.py", "network.py", "scheduler/util.py",
                "scheduler/generic.py", "tpu/solver.py", "tpu/mirror.py",
                "server/plan_apply.py", "server/plan_pipeline.py",
                "server/fsm.py", "state/store.py", "server/eval_broker.py",
                "simcluster/scenario.py"):
        path = f"{PORT}/{rel}"
        assert path in port_project.modules, path
        assert port_project.in_scope(path, determinism.DECISION_SCOPE), path


SEEDED = {
    f"{PORT}/scheduler/bad.py": """
        import random
        import time

        def pick(xs):
            s = set(xs)
            for x in s:
                return x, random.random(), time.time()
    """,
    f"{PORT}/server/fsm.py": """
        def apply(x):
            try:
                return x()
            except Exception:
                return None
    """,
    f"{PORT}/tpu/bad_obs.py": """
        from nomad_tpu_torch import capacity
        import nomad_tpu_torch.raft_observe
    """,
    f"{PORT}/state/bad_meta.py": """
        import time

        def f():
            return time.time()  # nomadlint: allow(DET002)
    """,
}


@pytest.mark.parametrize("name, rules", [
    ("determinism", {"DET001", "DET002", "DET003"}),
    ("excepts", {"EXC001"}),
    ("observatory", {"OBS001"}),
    ("meta", {"META001"}),
])
def test_remapped_pass_reports_a_seeded_fault(name, rules, port_scopes,
                                              tmp_path):
    for rel, src in SEEDED.items():
        path = tmp_path / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(textwrap.dedent(src))
    project = Project(repo=str(tmp_path), roots=(PORT,))
    got = {f.rule_id for f in PASSES[name](project)}
    assert rules <= got, got
    if name == "observatory":
        obs = [f for f in PASSES[name](project) if f.rule_id == "OBS001"]
        assert len(obs) == 2, obs
