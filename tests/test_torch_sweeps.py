"""The port's sweep-row selection (``pdnlp_tpu_torch.utils.sweeps``)
against JAX's (``pdnlp_tpu.utils.sweeps``): the same tokens on the same
grids select the same rows, warn on the same tokens, and split the same
way — on the grid of ``tests/test_sweeps.py`` and on generated ones."""
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from pdnlp_tpu.utils import sweeps as jsweeps
from pdnlp_tpu_torch.utils import sweeps

GRID = ["b64_lr6e-05_ema0.99_3ep", "tanh_b64_lr6e-05_ema0.99_3ep",
        "tanh_b64_lr8e-05_ema0.99_1ep"]


def _both(tokens, grid, capsys):
    """Each module's selection of every row and what it printed."""
    out = []
    for mod in (jsweeps, sweeps):
        s = mod.make_selected(tokens, grid)
        out.append(([s(n) for n in grid], capsys.readouterr().err))
    return out


@pytest.mark.parametrize("tokens", [
    [], ["b64_lr6e-05_ema0.99_3ep"], ["tanh"], ["8e-05"],
    ["b64_lr6e-05_ema0.99_3ep", "8e-05"], ["tanh_b64_lr8e-05_ema0.99_1ep"],
    ["nope"], ["3ep", "nope"]])
def test_selection_matches_jax_on_the_sweep_grid(tokens, capsys):
    (jsel, jerr), (sel, err) = _both(tokens, GRID, capsys)
    assert sel == jsel and err == jerr
    assert bool(err) == any(t not in GRID and not any(t in n for n in GRID)
                            for t in tokens)


@pytest.mark.parametrize("raw", [
    [], ["a,b", "c", ""], [",,"], ["tanh_b64_lr8e-05_ema0.99_1ep,3ep"],
    ["x", "y,z,"]])
def test_parse_only_matches_jax(raw):
    assert sweeps.parse_only(raw) == jsweeps.parse_only(raw)


_names = st.text(alphabet="ab_01", min_size=1, max_size=6)


@settings(max_examples=60, deadline=None)
@given(grid=st.lists(_names, min_size=1, max_size=6, unique=True),
       raw=st.lists(st.text(alphabet="ab_01,", max_size=8), max_size=4))
def test_selection_matches_jax_on_generated_grids(grid, raw):
    tokens = sweeps.parse_only(raw)
    assert tokens == jsweeps.parse_only(raw)
    s, js = sweeps.make_selected(tokens, grid), \
        jsweeps.make_selected(tokens, grid)
    assert [s(n) for n in grid] == [js(n) for n in grid]
    # an exact row token selects that row and no row it is a substring of
    for t in tokens:
        if t in grid:
            assert s(t)
