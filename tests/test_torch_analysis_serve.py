"""torchlint's serving, decoding and fleet rules R10-R18 on the CPU (pure
``ast``), as ``tests/test_jaxlint.py`` holds JAX's:

- each rule fires on its positive fixture (``tests/fixtures/torchlint/
  r1*_pos.py``) at exactly the marked lines, with no other rule's finding,
  and stays quiet on its negative;
- R11, R13 and R15 read no framework: on the twins of JAX's fixtures (the
  same files with ``pdnlp_tpu.`` renamed) both analyzers give the same
  (rule id, line) findings;
- each rule's scope (serve modules, torch modules, the controller's or
  the fleet's importers, decode-shaped loops, the sanctioned sites) and
  its hint;
- one scan of the port's default surface (``pdnlp_tpu_torch`` and
  ``chip_smoke.py``), shared by the surface tests: no unsuppressed
  finding, every suppression of R10-R18 says why, and the engine's own
  shapes (the span around ``_replay``, the padded handoff rows, the verify
  program per k, the prefill's one-time stack) stay clean;
- the analysis package imports neither torch, JAX nor ``pdnlp_tpu``.
"""
import ast
import os
import re

import pytest

from pdnlp_tpu.analysis import analyze_paths as jax_analyze
from pdnlp_tpu_torch.analysis import analyze_paths, default_paths
from pdnlp_tpu_torch.analysis.core import parse_module
from pdnlp_tpu_torch.analysis.rules.r10_unspanned_serve_block import (
    spanned_functions,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_FIXTURES = os.path.join(REPO, "tests", "fixtures", "jaxlint")
FIXTURES = os.path.join(REPO, "tests", "fixtures", "torchlint")
SERVE_RULES = [f"R{i}" for i in range(10, 19)]


def hits(path, rule_id=None, root=REPO):
    """(rule_id, line) findings of every suite for one file."""
    return [(f.rule_id, f.line) for f in analyze_paths([str(path)],
                                                       root=str(root))
            if rule_id is None or f.rule_id == rule_id]


def write(tmp_path, name, src):
    p = tmp_path / name
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(src)
    return p


# ------------------------------------------------------------ the fixtures

POSITIVE = {
    # var read (10), inline read (14), a bare sync after a replay (19),
    # float() of a decode step (25), a stream's sync after a program (30)
    "R10": [10, 14, 19, 25, 30],
    # JAX's: bare dict (11), constant-tuple comprehension (21),
    # segment_ids without cls_positions (30)
    "R11": [11, 21, 30],
    # a live tensor (8), float() at the span (15), a forward's output in
    # a record (23), the same through a propagated name (30)
    "R12": [8, 15, 23, 30],
    # JAX's: knob write (7), apply_knob (11), nested threshold (15), raw
    # scale call (19), augmented write (23)
    "R13": [7, 11, 15, 19, 23],
    # segment_bias (10), ID outer product (18), literal [.., 512, 512]
    # zeros (25), .expand to [.., 1024, 1024] (30)
    "R14": [10, 18, 25, 30],
    # JAX's: canary write (7), augmented shadow write (11), rollback
    # drain (15), extract/adopt re-home (19, 20)
    "R15": [7, 11, 15, 19, 20],
    # cat of the slot caches (9, 10), a stacked list (18) and its
    # append (19), stack rebuild (26), the paged table and pool (33, 34)
    "R16": [9, 10, 18, 19, 26, 33, 34],
    # verify window sliced to the accepted length (10), draft window to
    # an adaptive k (17), verify to runtime start:end (24)
    "R17": [10, 17, 24],
    # export of a filtered page list (11), import sliced to the runtime
    # count (16), inline comprehension (20), filter()-built dst (26)
    "R18": [11, 16, 20, 26],
}


@pytest.mark.parametrize("rid", SERVE_RULES)
def test_serve_rule_fires_on_its_positive_fixture(rid):
    """Exactly the marked lines, and no other rule's finding."""
    path = os.path.join(FIXTURES, f"{rid.lower()}_pos.py")
    assert hits(path) == [(rid, n) for n in POSITIVE[rid]]


@pytest.mark.parametrize("rid", SERVE_RULES)
def test_serve_rule_quiet_on_its_negative_fixture(rid):
    assert hits(os.path.join(FIXTURES, f"{rid.lower()}_neg.py")) == []


_TWINS = [f"r{r}_{k}.py" for r in (11, 13, 15) for k in ("pos", "neg")]


@pytest.mark.parametrize("name", _TWINS)
def test_framework_free_rules_match_jax(name):
    """R11, R13 and R15 on the renamed twins of JAX's fixtures: the same
    (rule id, line) findings from both analyzers, each rule's own."""
    rid = f"R{name[1:3]}"
    want = [(f.rule_id, f.line) for f in jax_analyze(
        [os.path.join(JAX_FIXTURES, name)], root=REPO, rule_ids=[rid])]
    got = hits(os.path.join(FIXTURES, name), rid)
    assert got == want
    assert bool(got) == ("pos" in name)


@pytest.mark.parametrize("name", _TWINS)
def test_framework_free_twins_are_the_jax_fixtures_renamed(name):
    with open(os.path.join(JAX_FIXTURES, name), encoding="utf-8") as f:
        want = f.read().replace("pdnlp_tpu.", "pdnlp_tpu_torch.")
    with open(os.path.join(FIXTURES, name), encoding="utf-8") as f:
        assert f.read() == want


# --------------------------------------------------------------- the scopes

def test_r10_requires_serve_context(tmp_path):
    """A module that neither lives under ``serve/`` nor imports it is R4's
    territory, never R10's."""
    p = write(tmp_path, "plain.py",
              "import torch\n\n"
              "def f(engine, x):\n"
              "    out = engine._model_forward(x)\n"
              "    return out.cpu()\n")
    assert hits(p, "R10", tmp_path) == []
    p = write(tmp_path, "pdnlp_tpu_torch/serve/m.py", p.read_text())
    assert hits(p, "R10", tmp_path) == [("R10", 5)]


def test_r10_a_span_over_the_only_caller_covers_the_callee(tmp_path):
    """``_replay``-shaped: a sync in a def spans when every call of it is
    under a span; a second, unspanned caller takes the cover away."""
    src = ("import torch\n"
           "from pdnlp_tpu_torch.serve import engine\n\n"
           "class E:\n"
           "    def run(self, k):\n"
           "        with self.tracer.span('forward'):\n"
           "            return self._go(k)\n\n"
           "    def _go(self, k):\n"
           "        self.g[k].replay()\n"
           "        torch.cuda.synchronize()\n")
    p = write(tmp_path, "m.py", src)
    assert hits(p, "R10", tmp_path) == []
    p = write(tmp_path, "m.py", src + "\n    def bare(self, k):\n"
                                      "        return self._go(k)\n")
    assert hits(p, "R10", tmp_path) == [("R10", 11)]


def test_r11_requires_serve_context(tmp_path):
    p = write(tmp_path, "plain.py",
              "from pdnlp_tpu_torch.ops.attention import routed_impl\n\n"
              "def f(forward, x, seq):\n"
              "    impl = routed_impl('auto', seq, segmented=True)\n"
              "    batch = {'input_ids': x, 'attention_mask': x,\n"
              "             'token_type_ids': x}\n"
              "    return forward(batch), impl\n")
    assert hits(p, "R11", tmp_path) == []


def test_r12_requires_torch_module(tmp_path):
    """A module that never imports torch holds no device tensors."""
    p = write(tmp_path, "hostonly.py",
              "def f(tracer, step, state, batch):\n"
              "    metrics = step(state, batch)\n"
              "    with tracer.span('log', loss=metrics['loss']):\n"
              "        pass\n")
    assert hits(p, "R12", tmp_path) == []


def test_r13_requires_controller_context(tmp_path):
    """The router and the batcher own their knobs until a controller is
    in play."""
    p = write(tmp_path, "plain.py",
              "def build(router):\n"
              "    router.hedge_ms = 25.0\n"
              "    router.apply_knob('max_wait_ms', 10.0)\n")
    assert hits(p, "R13", tmp_path) == []


def test_r14_sanctioned_site_and_scope(tmp_path):
    """``ops/attention.py``'s plain route is the one sanctioned caller of
    ``segment_bias``; a module without torch is out of scope."""
    src = ("import torch\n"
           "from pdnlp_tpu_torch.data.packing import segment_bias\n\n"
           "def forward(q, seg):\n"
           "    return segment_bias(seg)\n")
    p = write(tmp_path, "pdnlp_tpu_torch/ops/attention.py", src)
    assert hits(p, "R14", tmp_path) == []
    p = write(tmp_path, "pdnlp_tpu_torch/models/m.py", src)
    assert hits(p, "R14", tmp_path) == [("R14", 5)]
    p = write(tmp_path, "host.py", src.replace("import torch\n", ""))
    assert hits(p, "R14", tmp_path) == []


def test_r15_requires_fleet_context(tmp_path):
    p = write(tmp_path, "plain.py",
              "def build(thing):\n"
              "    thing.canary_fraction = 0.5\n"
              "    thing.extract_queued()\n")
    assert hits(p, "R15", tmp_path) == []


def test_r15_the_fleet_and_the_router_are_their_own_setters():
    paths = [os.path.join(REPO, "pdnlp_tpu_torch", "serve", f)
             for f in ("fleet.py", "router.py")]
    assert [f for f in analyze_paths(paths, root=REPO,
                                     rule_ids=["R13", "R15"])] == []


def test_r16_requires_decode_dispatch(tmp_path):
    p = write(tmp_path, "plain.py",
              "import torch\n"
              "def gather(batches, kv_cache):\n"
              "    for b in batches:\n"
              "        kv_cache = torch.cat([kv_cache, b])\n"
              "    return kv_cache\n")
    assert hits(p, "R16", tmp_path) == []


def test_r17_requires_decode_loop(tmp_path):
    p = write(tmp_path, "plain.py",
              "import torch\n"
              "def score(batches, verify_ids, kv, a):\n"
              "    out = []\n"
              "    for b in batches:\n"
              "        out.append(len(b))\n"
              "    return verify_ids(kv[:, : a + 1])\n")
    assert hits(p, "R17", tmp_path) == []


def test_r18_requires_torch_module(tmp_path):
    p = write(tmp_path, "host.py",
              "def f(export_fn, row, n):\n"
              "    return export_fn(row[:n])\n")
    assert hits(p, "R18", tmp_path) == []
    p = write(tmp_path, "dev.py", "import torch\n" + p.read_text())
    assert hits(p, "R18", tmp_path) == [("R18", 3)]


@pytest.mark.parametrize("rid,words", [
    ("R10", ("span", "_replay", "pdnlp_tpu_torch.obs")),
    ("R11", ("cls_positions", "pack_id_lists")),
    ("R12", ("barrier", "Tracer.block")),
    ("R13", ("_actuate", "pdnlp_tpu_torch.obs.decision")),
    ("R14", ("segment_ids", "ops.attention")),
    ("R15", ("_actuate", "canary_fraction")),
    ("R16", ("index_copy_", "slice assignment", "in place")),
    ("R17", ("verify_ids", "data argument", "warmup_verify")),
    ("R18", ("pages_per_stream", "export_pages", "n_pages")),
])
def test_serve_hints_name_the_fix(rid, words):
    path = os.path.join(FIXTURES, f"{rid.lower()}_pos.py")
    f = [x for x in analyze_paths([path], root=REPO) if x.rule_id == rid][0]
    assert all(w in f.hint for w in words), f.hint


def test_r16_hint_names_the_port_fix_not_jax():
    """The fix is an in-place write, not JAX's update-slice or donation."""
    path = os.path.join(FIXTURES, "r16_pos.py")
    f = [x for x in analyze_paths([path], root=REPO)
         if x.rule_id == "R16"][0]
    assert "dynamic_update_slice" not in f.hint
    assert "donat" not in f.hint.lower()


# ---------------------------------------------------------- the port itself

@pytest.fixture(scope="module")
def surface():
    """One scan of the port's default surface under R10-R18."""
    return analyze_paths(default_paths(REPO), root=REPO,
                         rule_ids=SERVE_RULES)


def test_the_surface_is_clean_under_the_serve_rules(surface):
    assert surface == [], "\n".join(
        f"{f.path}:{f.line}: {f.rule_id} {f.message}" for f in surface)


_MARKER = re.compile(r"#\s*torchlint:\s*disable=([A-Za-z0-9_,]+)(.*)")


def test_every_serve_rule_suppression_says_why():
    """Each in-place ``# torchlint: disable=R1x`` on the surface carries a
    reason after its rule ids."""
    seen = 0
    for root in default_paths(REPO):
        files = [root] if root.endswith(".py") else [
            os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs
            if f.endswith(".py")]
        for path in files:
            with open(path, encoding="utf-8") as fh:
                for n, line in enumerate(fh, 1):
                    m = _MARKER.search(line)
                    if m and set(m.group(1).split(",")) & set(SERVE_RULES):
                        seen += 1
                        assert len(m.group(2).strip(" —-")) > 10, \
                            f"{path}:{n}"
    assert seen >= 15


def test_the_comparison_forward_is_the_one_suppressed_engine_read():
    """``forward_eager`` reads outside every span on purpose, and is the
    only R10 finding in the serving package once markers are ignored."""
    path = os.path.join(REPO, "pdnlp_tpu_torch", "serve", "engine.py")
    mod = parse_module(path, "pdnlp_tpu_torch/serve/engine.py")
    from pdnlp_tpu_torch.analysis.core import all_rules

    raw = list(all_rules()["R10"].check(mod))
    assert [f.snippet for f in raw] == [
        "return self._model_forward(fwd).cpu().numpy()"]
    assert mod.suppressions.is_suppressed(raw[0].line, "R10")
    names = {getattr(n, "name", "") for n in spanned_functions(mod)}
    assert "_replay" in names


def test_the_decoders_span_and_fixed_programs_are_clean():
    """The decode engine's shapes: ``_eager`` spanned by ``_program``
    (``_replay`` is the engine's), the handoff on full sentinel-padded
    rows, the verify program keyed per k; the prefill's per-layer stack
    runs once."""
    path = os.path.join(REPO, "pdnlp_tpu_torch", "serve", "decode.py")
    mod = parse_module(path, "pdnlp_tpu_torch/serve/decode.py")
    assert "_eager" in {getattr(n, "name", "")
                        for n in spanned_functions(mod)}
    paths = [path, os.path.join(REPO, "pdnlp_tpu_torch", "models",
                                "decoder.py")]
    assert analyze_paths(paths, root=REPO, rule_ids=SERVE_RULES) == []


def test_the_analysis_package_imports_no_framework():
    pkg = os.path.join(REPO, "pdnlp_tpu_torch", "analysis")
    banned = ("torch", "jax", "pdnlp_tpu")
    for d, _, fs in os.walk(pkg):
        for f in fs:
            if not f.endswith(".py"):
                continue
            with open(os.path.join(d, f), encoding="utf-8") as fh:
                tree = ast.parse(fh.read())
            for n in ast.walk(tree):
                names = [a.name for a in n.names] if isinstance(
                    n, ast.Import) else [n.module or ""] if isinstance(
                    n, ast.ImportFrom) else []
                for name in names:
                    top = name.split(".")[0]
                    assert top not in banned, (f, name)
