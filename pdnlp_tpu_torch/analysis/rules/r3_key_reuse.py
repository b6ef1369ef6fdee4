"""R3 — generator hazards: draws from the default stream, and host reads
or writes of a generator's state inside a captured region.

JAX threads explicit keys; the port threads explicit ``torch.Generator``
objects (the train state's dropout generator, the seeded inits), so a run
is reproducible from its seed and a resume restores every stream.  Two
ways to break that:

- **a draw with no ``generator=``** — ``torch.rand*`` / ``randn*`` /
  ``randint*`` / ``bernoulli`` / ``multinomial`` / ``randperm`` /
  ``normal`` / ``poisson``, the in-place ``uniform_`` / ``normal_`` /
  ``bernoulli_`` / ``random_`` / ``exponential_`` / ``geometric_`` /
  ``log_normal_`` / ``cauchy_``, ``torch.nn.init``'s random fills, and
  dropout in training (``F.dropout`` / ``nn.Dropout`` take no generator
  at all) draw from the process-global default stream: another module's
  draw shifts it, no snapshot holds it, and a captured graph advances it
  behind the host's back;
- **a generator's state on the host inside a captured region** —
  ``get_state`` / ``set_state`` / ``manual_seed`` / ``seed`` /
  ``get_offset`` / ``set_offset`` / ``initial_seed`` (and
  ``torch.manual_seed``, ``torch.cuda.get_rng_state`` and friends) read
  or write host values that a replay never repeats: the capture's offset
  is a device value read at each replay, so a recompute that "restores"
  the state this way draws other masks from the second replay on (the
  fault of the port's remat before ``models.bert.RematRng``).  The
  graph-safe forms — ``graphsafe_get_state`` / ``graphsafe_set_state`` on
  states registered with the graph — are not flagged.
"""
from __future__ import annotations

import ast
from typing import Iterator

from pdnlp_tpu_torch.analysis.core import (
    Finding, ModuleInfo, Rule, dotted_name, register,
)

#: functions that draw (their ``generator=`` keyword picks the stream)
_DRAW_FUNCS = {
    f"torch.{n}" for n in (
        "rand", "rand_like", "randn", "randn_like", "randint",
        "randint_like", "bernoulli", "multinomial", "randperm", "normal",
        "poisson")} | {
    f"torch.nn.init.{n}" for n in (
        "uniform_", "normal_", "trunc_normal_", "xavier_uniform_",
        "xavier_normal_", "kaiming_uniform_", "kaiming_normal_",
        "orthogonal_", "sparse_")}
#: in-place tensor methods that draw
_DRAW_METHODS = {"uniform_", "normal_", "bernoulli_", "random_",
                 "exponential_", "geometric_", "log_normal_", "cauchy_"}
#: dropout: no generator parameter at all
_DROPOUT_FUNCS = {"torch.nn.functional.dropout", "torch.dropout",
                  "torch.nn.functional.dropout1d",
                  "torch.nn.functional.dropout2d",
                  "torch.nn.functional.alpha_dropout"}
_DROPOUT_MODULES = {"torch.nn.Dropout", "torch.nn.Dropout1d",
                    "torch.nn.Dropout2d", "torch.nn.AlphaDropout"}
#: host reads and writes of a generator's state
_STATE_METHODS = {"get_state", "set_state", "manual_seed", "seed",
                  "get_offset", "set_offset", "initial_seed"}
_STATE_FUNCS = {
    "torch.manual_seed", "torch.seed", "torch.get_rng_state",
    "torch.set_rng_state", "torch.random.manual_seed",
    "torch.random.get_rng_state", "torch.random.set_rng_state",
    "torch.cuda.manual_seed", "torch.cuda.manual_seed_all",
    "torch.cuda.seed", "torch.cuda.seed_all", "torch.cuda.get_rng_state",
    "torch.cuda.set_rng_state", "torch.cuda.get_rng_state_all",
    "torch.cuda.set_rng_state_all"}


def _has_generator(call: ast.Call) -> bool:
    return any(k.arg == "generator" or k.arg is None for k in call.keywords)


def _training_off(call: ast.Call) -> bool:
    """``F.dropout(x, p, training=False)`` / positional ``False``."""
    for k in call.keywords:
        if k.arg == "training":
            return isinstance(k.value, ast.Constant) and k.value.value is False
    return len(call.args) >= 3 and isinstance(call.args[2], ast.Constant) \
        and call.args[2].value is False


@register
class GeneratorHazard(Rule):
    rule_id = "R3"
    name = "generator-hazard"
    hint = ("draw from an explicit torch.Generator (generator=...); inside "
            "a capture, swap states with graphsafe_get_state / "
            "graphsafe_set_state on a state registered with the graph")

    def check(self, mod: ModuleInfo) -> Iterator[Finding]:
        if mod.imports_torch():
            for node in ast.walk(mod.tree):
                if isinstance(node, ast.Call):
                    yield from self._check_draw(mod, node)
        for _, body in mod.captured_regions():
            for stmt in body:
                for node in ast.walk(stmt):
                    if isinstance(node, ast.Call):
                        yield from self._check_state(mod, node)

    def _check_draw(self, mod: ModuleInfo, call: ast.Call):
        target = mod.resolve(call.func)
        name = dotted_name(call.func) or "<draw>"
        if target in _DRAW_FUNCS or (
                target not in _DRAW_FUNCS and isinstance(
                    call.func, ast.Attribute)
                and call.func.attr in _DRAW_METHODS
                and not (target or "").startswith("numpy.")):
            if not _has_generator(call):
                yield self.finding(
                    mod, call,
                    f"`{name}` draws from the default generator: no "
                    "snapshot or resume holds that stream, and any other "
                    "draw shifts it",
                    "pass generator=<the run's torch.Generator>")
        elif target in _DROPOUT_FUNCS and not _training_off(call):
            yield self.finding(
                mod, call,
                f"`{name}` in training draws its mask from the default "
                "generator (dropout takes none)",
                "draw the mask with torch.rand(..., generator=g) and "
                "select with torch.where (models.bert._dropout)")
        elif target in _DROPOUT_MODULES:
            yield self.finding(
                mod, call,
                f"`{name}` draws its masks from the default generator",
                "use an explicit-generator dropout (models.bert._dropout)")

    def _check_state(self, mod: ModuleInfo, call: ast.Call):
        target = mod.resolve(call.func)
        if target in _STATE_FUNCS or (
                isinstance(call.func, ast.Attribute)
                and call.func.attr in _STATE_METHODS):
            yield self.finding(
                mod, call,
                f"`{dotted_name(call.func) or call.func.attr}` reads or "
                "writes a generator's state on the host inside a captured "
                "region: a replay never repeats it, so the draws after it "
                "differ from the second replay on",
                "clone the state before the capture, register it with the "
                "graph (CUDAGraph.register_generator_state) and switch to "
                "it with graphsafe_set_state (models.bert.RematRng)")
