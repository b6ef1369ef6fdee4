"""What a run may import: no module whose top-level name is ``jax``,
``jaxlib``, ``flax`` or the JAX package ``pdnlp_tpu`` (compared whole:
the port ``pdnlp_tpu_torch`` is allowed), and a reference that imports
nothing of the program."""
import os
import subprocess
import sys

import pytest

from gpubench import spec
from gpubench.tests import tiny

DRY = """
import json, sys, torch
torch.set_num_threads(2)
from gpubench import harness
from gpubench.run import forbidden_modules
from gpubench.tests import tiny
harness.run(tiny.cell(sys.argv[1]), 2 ** 31 + 5, 0.2, False, device="cpu")
print(json.dumps(forbidden_modules()))
"""


def _run(code, *args):
    env = dict(os.environ, USE_FLAX="0")
    out = subprocess.run([sys.executable, "-c", code, *args], cwd=spec.ROOT,
                         capture_output=True, text=True, env=env,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.strip().splitlines()[-1]


@pytest.mark.parametrize("name", tiny.cells())
def test_a_run_loads_no_jax(name):
    assert _run(DRY, name) == "[]"


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys, json\n"
            "import gpubench.reference.data, gpubench.reference.model\n"
            "import gpubench.reference.run\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules}"
            " & {'pdnlp_tpu_torch', 'pdnlp_tpu', 'jax'})))")
    assert _run(code) == "[]"


def test_forbidden_names_are_compared_whole():
    from gpubench.run import FORBIDDEN

    assert "pdnlp_tpu_torch" not in FORBIDDEN
    assert "pdnlp_tpu" in FORBIDDEN and "jax" in FORBIDDEN
