"""torchlint (``pdnlp_tpu_torch.analysis``), the port's static analyzer, on
the CPU: pure ``ast``, no card, no torch import in the package.

- the concurrency (T1-T3) and lifecycle (L1-L4) suites against JAX's
  analyzer: both run on JAX's ``tests/fixtures/jaxlint/t*_*.py`` and on
  the port's twins of ``l*_*.py`` and of the suppression fixtures (the
  same files with ``pdnlp_tpu`` imports and ``# jaxlint:`` markers
  renamed), and give the same (rule id, line) findings;
- each of R1-R9 fires on its positive fixture (``tests/fixtures/
  torchlint/``) at the marked lines and stays quiet on its negative;
  R3 flags the port's remat as it was before its recompute became
  graph-safe, and the repaired ``models.bert`` / ``train.steps`` carry
  no capture hazard;
- the captured set, suppressions, the CLI's exit codes, the baseline
  ratchet (surviving a line shift), SARIF round trips and the partial
  scan's ``--write-baseline`` refusal, as ``tests/test_jaxlint.py`` holds
  JAX's;
- the ratchet itself: the port's default surface (``pdnlp_tpu_torch`` and
  ``chip_smoke.py``) has no finding beyond ``pdnlp_tpu_torch/analysis/
  baseline.json``.
"""
import json
import os
import shutil
import subprocess
import sys

import pytest

from pdnlp_tpu.analysis import analyze_paths as jax_analyze
from pdnlp_tpu_torch.analysis import analyze_paths, baseline, default_paths
from pdnlp_tpu_torch.analysis.core import all_rules, parse_module

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_FIXTURES = os.path.join(REPO, "tests", "fixtures", "jaxlint")
FIXTURES = os.path.join(REPO, "tests", "fixtures", "torchlint")


def hits(name, rule_id=None, suite="all"):
    """(rule_id, line) findings for one of the port's fixtures."""
    found = analyze_paths([os.path.join(FIXTURES, name)], root=REPO,
                          suite=suite)
    return [(f.rule_id, f.line) for f in found
            if rule_id is None or f.rule_id == rule_id]


def cli(*argv, cwd=REPO):
    return subprocess.run(
        [sys.executable, "-m", "pdnlp_tpu_torch.analysis", *argv],
        capture_output=True, text=True, cwd=cwd,
        env={**os.environ, "PYTHONPATH": REPO})


# ------------------------------------------- T and L suites against JAX's

_T_AND_L = sorted(f for f in os.listdir(JAX_FIXTURES)
                  if f[0] in "tl" and f.endswith(".py"))


def _twin(name):
    """The port's copy of a JAX fixture where it needs one (a renamed
    import or marker), else JAX's own file."""
    own = os.path.join(FIXTURES, name)
    return own if os.path.exists(own) else os.path.join(JAX_FIXTURES, name)


@pytest.mark.parametrize("name", _T_AND_L)
def test_t_and_l_suites_match_jax(name):
    """The same (rule id, line) findings from both analyzers, under each
    suite, on every T and L fixture (the positives are not empty)."""
    for suite in ("concurrency", "lifecycle"):
        want = [(f.rule_id, f.line) for f in jax_analyze(
            [os.path.join(JAX_FIXTURES, name)], root=REPO, suite=suite)]
        got = [(f.rule_id, f.line) for f in analyze_paths(
            [_twin(name)], root=REPO, suite=suite)]
        assert got == want, (suite, got, want)
    if "pos" in name:
        assert want or got == want


@pytest.mark.parametrize("name", sorted(
    f for f in os.listdir(FIXTURES) if f[0] in "tl" and f.endswith(".py")))
def test_twins_are_the_jax_fixtures_renamed(name):
    """Each twin is JAX's fixture with the package and the marker renamed,
    line for line."""
    with open(os.path.join(JAX_FIXTURES, name), encoding="utf-8") as f:
        jax_src = f.read()
    with open(os.path.join(FIXTURES, name), encoding="utf-8") as f:
        src = f.read()
    want = jax_src.replace("pdnlp_tpu.", "pdnlp_tpu_torch.").replace(
        "jaxlint: disable=", "torchlint: disable=")
    assert src == want


def test_terminal_hops_pinned_to_the_port():
    from pdnlp_tpu_torch.analysis.lifecycle.l2_terminal_coverage import (
        TERMINAL_HOPS,
    )
    from pdnlp_tpu_torch.obs.request import TERMINAL_HOPS as runtime

    assert TERMINAL_HOPS == runtime


# ------------------------------------------------------- R1-R9 fixtures

POSITIVE = {
    "R1": ("r1_pos.py", [10, 15, 20, 26, 30]),
    "R2": ("r2_pos.py", [9, 16, 23, 29]),
    "R3": ("r3_pos.py", [11, 15, 16, 20, 25]),
    "R4": ("r4_pos.py", [10, 17]),
    "R5": ("r5_pos.py", [12, 21]),
    "R6": ("r6_pos.py", [5, 10, 11, 15, 16]),
    "R7": ("r7_pos.py", [8, 13, 20, 21]),
    "R8": ("r8_pos.py", [8, 11, 17, 20]),
    "R9": ("r9_pos.py", [10, 11, 17]),
}
NEGATIVE = {rid: [f"{rid.lower()}_neg.py"] for rid in POSITIVE}
NEGATIVE["R5"].append("r5_single.py")


@pytest.mark.parametrize("rid", sorted(POSITIVE))
def test_rule_fires_on_its_positive_fixture(rid):
    """Exactly the marked lines, and no other rule's finding."""
    name, lines = POSITIVE[rid]
    assert hits(name) == [(rid, n) for n in lines]


@pytest.mark.parametrize("rid", sorted(NEGATIVE))
def test_rule_quiet_on_its_negative_fixture(rid):
    for name in NEGATIVE[rid]:
        assert hits(name) == [], name


def test_r3_flags_the_remat_before_its_repair():
    """``models.bert._remat`` as it was, reached from a captured step: the
    forward's ``get_state`` and the recompute's ``get_state`` /
    ``set_state`` pairs are host reads and writes no replay repeats."""
    assert hits("r3_remat.py") == [("R3", 12), ("R3", 22), ("R3", 23),
                                   ("R3", 29)]
    found = analyze_paths([os.path.join(FIXTURES, "r3_remat.py")],
                          root=REPO)
    assert all("graphsafe_set_state" in f.hint
               and "register_generator_state" in f.hint for f in found)


def test_the_repaired_remat_and_the_captured_step_are_clean():
    paths = [os.path.join(REPO, "pdnlp_tpu_torch", p)
             for p in ("models/bert.py", "train/steps.py",
                       "serve/engine.py")]
    assert analyze_paths(paths, root=REPO, suite="tracing") == []


@pytest.mark.parametrize("rid,words", [
    ("R1", "after the replay"), ("R3", "generator="),
    ("R4", "torch.cuda.synchronize"), ("R5", "pool="),
    ("R6", "KNOWN_AXES"), ("R7", "data.pipeline"),
    ("R8", "--attention_impl"), ("R9", "async_ckpt")])
def test_hints_name_the_fix(rid, words):
    name, _ = POSITIVE[rid]
    f = [x for x in analyze_paths([os.path.join(FIXTURES, name)],
                                  root=REPO) if x.rule_id == rid][0]
    assert words in f.hint + f.message


# ------------------------------------------------------- the captured set

def _captured(src, tmp_path):
    path = tmp_path / "m.py"
    path.write_text(src)
    mod = parse_module(str(path), "m.py")
    return sorted(getattr(n, "name", "<lambda>")
                  for n in mod.captured_functions())


@pytest.mark.parametrize("src,want", [
    # the builder idiom: the def build_train_step returns is captured
    ("from pdnlp_tpu_torch.train.steps import build_multi_step\n"
     "def build_train_step(a):\n"
     "    def train_step(s, b):\n"
     "        return helper(b)\n"
     "    return train_step\n"
     "def helper(b):\n"
     "    return b\n"
     "multi = build_multi_step(build_train_step(1), 'cuda')\n",
     ["helper", "train_step"]),
    # torch.compile's decorator, make_graphed_callables' argument, and a
    # lambda
    ("import torch\n"
     "@torch.compile\n"
     "def f(x):\n"
     "    return x\n"
     "def g(x):\n"
     "    return x\n"
     "h = torch.cuda.make_graphed_callables(g, (1,))\n"
     "k = torch.compile(lambda x: x)\n",
     ["<lambda>", "f", "g"]),
    # a graph block reaches a method on self, and a local bound to one
    ("import torch\n"
     "class E:\n"
     "    def run(self, fn=None):\n"
     "        fn = fn or self._forward\n"
     "        with torch.cuda.graph(self.g, pool=None):\n"
     "            fn(1)\n"
     "            self._post()\n"
     "    def _forward(self, x):\n"
     "        return x\n"
     "    def _post(self):\n"
     "        pass\n"
     "    def eager(self):\n"
     "        pass\n",
     ["_forward", "_post"]),
])
def test_captured_set(src, want, tmp_path):
    assert _captured(src, tmp_path) == want


def test_the_engine_forward_is_captured():
    path = os.path.join(REPO, "pdnlp_tpu_torch", "serve", "engine.py")
    mod = parse_module(path, "pdnlp_tpu_torch/serve/engine.py")
    assert "_model_forward" in {getattr(n, "name", "")
                                for n in mod.captured_functions()}
    assert len(mod.graph_blocks()) == 1


# ---------------------------------------------------- suppressions, suites

def test_inline_suppression_honored():
    # same-line (9), comment-line (14-15) and disable=all (25) silenced;
    # a wrong rule id (20) and JAX's marker (30) are not ours
    assert hits("suppressed.py") == [("R1", 20), ("R1", 30)]


def test_suite_selection_partitions_rules():
    t1 = os.path.join(JAX_FIXTURES, "t1_pos.py")
    assert analyze_paths([t1], root=REPO, suite="tracing") == []
    assert {f.rule_id for f in analyze_paths(
        [t1], root=REPO, suite="concurrency")} == {"T1"}
    r1 = os.path.join(FIXTURES, "r1_pos.py")
    assert analyze_paths([r1], root=REPO, suite="concurrency") == []
    assert {f.rule_id for f in analyze_paths(
        [r1], root=REPO, suite="tracing")} == {"R1"}


def test_rule_registry():
    """R1-R9, T1-T3 and L1-L4 (R10-R18 are not ported yet), each in its
    suite."""
    rules = all_rules()
    assert list(rules) == ["L1", "L2", "L3", "L4", "R1", "R2", "R3", "R4",
                           "R5", "R6", "R7", "R8", "R9", "T1", "T2", "T3"]
    want = {"L": "lifecycle", "R": "tracing", "T": "concurrency"}
    assert all(r.suite == want[rid[0]] for rid, r in rules.items())
    assert all(r.hint and r.name for r in rules.values())


def test_findings_carry_exact_location_and_hint():
    f = analyze_paths([os.path.join(FIXTURES, "r1_pos.py")], root=REPO)[0]
    assert f.path == "tests/fixtures/torchlint/r1_pos.py"
    assert f.location == f"{f.path}:10"
    assert f.hint and f.snippet == "return float(x.sum())          " \
        "# line 10: float() on a tensor"


# ---------------------------------------------------------------- the CLI

def test_cli_exit_codes(tmp_path):
    """0 on a clean tree, 1 on a new finding, 2 on a missing path or an
    unknown rule."""
    tree = tmp_path / "t"
    tree.mkdir()
    (tree / "ok.py").write_text("x = 1\n")
    assert cli("--json", "--no-baseline", str(tree)).returncode == 0
    (tree / "bad.py").write_text(
        "import time, torch\n"
        "def go(step, s, b):\n"
        "    t0 = time.time()\n"
        "    step(s, b)\n"
        "    return time.time() - t0\n")
    out = cli("--json", "--no-baseline", str(tree))
    assert out.returncode == 1
    report = json.loads(out.stdout)
    assert [(f["rule"], f["line"]) for f in report["new_findings"]] == \
        [("R4", 5)]
    assert cli(str(tmp_path / "missing")).returncode == 2
    assert cli("--rules", "R99", str(tree)).returncode == 2
    listed = cli("--list-rules")
    assert listed.returncode == 0 and "R3" in listed.stdout


def test_partial_scan_scopes_the_baseline_and_refuses_to_write_it(tmp_path):
    tree = tmp_path / "t"
    tree.mkdir()
    shutil.copy(os.path.join(FIXTURES, "r1_pos.py"), tree / "a.py")
    shutil.copy(os.path.join(JAX_FIXTURES, "t3_pos.py"), tree / "b.py")
    base = tmp_path / "base.json"

    def run(*extra):
        return cli("--baseline", str(base), *extra, str(tree),
                   cwd=str(tmp_path))

    assert run("--write-baseline").returncode == 0
    out = run("--suite", "concurrency", "--json")
    assert out.returncode == 0
    report = json.loads(out.stdout)
    assert report["summary"]["new"] == 0
    assert report["summary"]["fixed_vs_baseline"] == 0
    refused = run("--suite", "concurrency", "--write-baseline")
    assert refused.returncode == 2 and "refusing" in refused.stderr
    refused = run("--rules", "R1", "--write-baseline")
    assert refused.returncode == 2


# -------------------------------------------------------------- the ratchet

def test_baseline_ratchet_flags_only_new(tmp_path):
    tree = tmp_path / "tree"
    tree.mkdir()
    shutil.copy(os.path.join(FIXTURES, "r3_pos.py"), tree / "old.py")
    base = tmp_path / "base.json"
    baseline.write(analyze_paths([str(tree)], root=str(tmp_path)),
                   str(base))
    new, fixed = baseline.compare(
        analyze_paths([str(tree)], root=str(tmp_path)),
        baseline.load(str(base)))
    assert new == [] and fixed == 0
    (tree / "fresh.py").write_text(
        "import torch\n\n\n"
        "def f(x):\n"
        "    return x + torch.rand(x.shape)\n")
    new, _ = baseline.compare(
        analyze_paths([str(tree)], root=str(tmp_path)),
        baseline.load(str(base)))
    assert [(f.rule_id, f.path, f.line) for f in new] == \
        [("R3", "tree/fresh.py", 5)]
    (tree / "old.py").write_text("x = 1\n")
    (tree / "fresh.py").unlink()
    new, fixed = baseline.compare(
        analyze_paths([str(tree)], root=str(tmp_path)),
        baseline.load(str(base)))
    assert new == [] and fixed == 5


def test_baseline_survives_line_shift_and_keeps_reasons(tmp_path):
    src = ("import torch\n\n\n"
           "def noise(x):\n"
           "    return x + torch.randn(x.shape)\n")
    f = tmp_path / "mod.py"
    f.write_text(src)
    base = tmp_path / "b.json"
    baseline.write(analyze_paths([str(f)], root=str(tmp_path)), str(base))
    payload = json.loads(base.read_text())
    payload["findings"][0]["reason"] = "a seeded probe"
    base.write_text(json.dumps(payload))
    f.write_text("# a new comment\n# another\n" + src)
    new, _ = baseline.compare(analyze_paths([str(f)], root=str(tmp_path)),
                              baseline.load(str(base)))
    assert new == []
    f.write_text(src)
    baseline.write(analyze_paths([str(f)], root=str(tmp_path)), str(base))
    assert baseline.load(str(base))[0]["reason"] == "a seeded probe"


def test_sarif_round_trips_a_mixed_report(tmp_path):
    """--format sarif on a tree with tracing and concurrency findings: the
    results map 1:1 onto analyze_paths' findings, the rules ride along."""
    tree = tmp_path / "t"
    tree.mkdir()
    shutil.copy(os.path.join(FIXTURES, "r1_pos.py"), tree / "a.py")
    shutil.copy(os.path.join(JAX_FIXTURES, "t3_pos.py"), tree / "b.py")
    out = cli("--format", "sarif", "--no-baseline", str(tree),
              cwd=str(tmp_path))
    assert out.returncode == 1
    sarif = json.loads(out.stdout)
    assert sarif["version"] == "2.1.0"
    run = sarif["runs"][0]
    assert run["tool"]["driver"]["name"] == "torchlint"
    got = {(r["ruleId"],
            r["locations"][0]["physicalLocation"]["artifactLocation"]["uri"],
            r["locations"][0]["physicalLocation"]["region"]["startLine"],
            r["locations"][0]["physicalLocation"]["region"]["startColumn"])
           for r in run["results"]}
    want = {(f.rule_id, f.path, f.line, f.col + 1)
            for f in analyze_paths([str(tree)], root=str(tmp_path))}
    assert got == want and {g[0] for g in got} == {"R1", "T3"}
    declared = {r["id"] for r in run["tool"]["driver"]["rules"]}
    assert {r["ruleId"] for r in run["results"]} <= declared
    assert all(r["level"] == "error" for r in run["results"])


def test_sarif_baseline_marks_grandfathered_as_notes(tmp_path):
    tree = tmp_path / "t"
    tree.mkdir()
    shutil.copy(os.path.join(JAX_FIXTURES, "t3_pos.py"), tree / "b.py")
    base = tmp_path / "base.json"
    assert cli("--write-baseline", "--baseline", str(base), str(tree),
               cwd=str(tmp_path)).returncode == 0
    out = cli("--format", "sarif", "--baseline", str(base), str(tree),
              cwd=str(tmp_path))
    assert out.returncode == 0
    results = json.loads(out.stdout)["runs"][0]["results"]
    assert results and all(r["level"] == "note" for r in results)


def test_default_surface_is_the_port():
    assert [os.path.relpath(p, REPO) for p in default_paths(REPO)] == \
        ["pdnlp_tpu_torch", "chip_smoke.py"]


def test_repo_surface_has_no_new_violations():
    """THE ratchet: the committed baseline covers the port's surface, and
    every entry in it says why it stays."""
    base_path = os.path.join(REPO, baseline.DEFAULT_BASELINE)
    assert os.path.exists(base_path)
    entries = baseline.load(base_path)
    assert all(e.get("reason") for e in entries)
    findings = analyze_paths(default_paths(REPO), root=REPO)
    new, _ = baseline.compare(findings, entries)
    assert new == [], (
        "NEW torchlint findings (fix them or, if truly intended, add an "
        "inline `# torchlint: disable=<id>` with a reason):\n" + "\n".join(
            f"  {f.path}:{f.line}: {f.rule_id} {f.message}" for f in new))
