"""Import rules of the PyTorch port: it never imports JAX, flax, msgpack or the JAX
package, it imports on a CPU-only PyTorch, and its entry points run on
``cuda`` unless asked for the CPU — raising, never falling back, when
there is no card."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "pdnlp_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "msgpack", "pdnlp_tpu")


def _modules():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(encoding="utf-8"))):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    paths = _modules()
    assert len(paths) > 15
    rel = {str(p.relative_to(REPO)) for p in paths}
    assert {"pdnlp_tpu_torch/data/pipeline.py",
            "pdnlp_tpu_torch/data/packing.py",
            "pdnlp_tpu_torch/data/sampler.py",
            "pdnlp_tpu_torch/train/setup.py",
            "pdnlp_tpu_torch/parallel/runtime.py",
            "pdnlp_tpu_torch/parallel/mesh.py",
            "pdnlp_tpu_torch/parallel/collectives.py",
            "pdnlp_tpu_torch/parallel/sharding.py",
            "pdnlp_tpu_torch/parallel/execution.py",
            "pdnlp_tpu_torch/parallel/local.py",
            "pdnlp_tpu_torch/train/run.py",
            "pdnlp_tpu_torch/train/multi.py",
            "pdnlp_tpu_torch/train/spawn.py",
            "pdnlp_tpu_torch/train/checkpoint.py",
            "pdnlp_tpu_torch/train/msgpack.py",
            "pdnlp_tpu_torch/train/async_ckpt.py",
            "pdnlp_tpu_torch/train/trainer.py",
            "pdnlp_tpu_torch/train/steps.py",
            "pdnlp_tpu_torch/obs/trace.py",
            "pdnlp_tpu_torch/obs/export.py",
            "pdnlp_tpu_torch/obs/phases.py",
            "pdnlp_tpu_torch/obs/regress.py",
            "pdnlp_tpu_torch/obs/memory.py",
            "pdnlp_tpu_torch/utils/profiling.py",
            "pdnlp_tpu_torch/tools/evaluate.py",
            "pdnlp_tpu_torch/tools/predict.py",
            "pdnlp_tpu_torch/tools/quantize_ckpt.py",
            "pdnlp_tpu_torch/serve/quant.py",
            "pdnlp_tpu_torch/serve/router.py",
            "pdnlp_tpu_torch/serve/metrics.py",
            "pdnlp_tpu_torch/serve/batcher.py",
            "pdnlp_tpu_torch/serve/engine.py",
            "pdnlp_tpu_torch/serve/cli.py",
            "pdnlp_tpu_torch/obs/request.py",
            "pdnlp_tpu_torch/obs/exporter.py",
            "pdnlp_tpu_torch/parallel/watchdog.py",
            "pdnlp_tpu_torch/data/native.py",
            "pdnlp_tpu_torch/models/decoder.py",
            "pdnlp_tpu_torch/serve/decode.py",
            "pdnlp_tpu_torch/serve/kvpage.py",
            "pdnlp_tpu_torch/train/pretrain.py",
            "pdnlp_tpu_torch/train/auto.py",
            "pdnlp_tpu_torch/train/accel.py",
            "pdnlp_tpu_torch/models/bert.py",
            "pdnlp_tpu_torch/models/convert.py",
            "pdnlp_tpu_torch/models/config.py",
            "pdnlp_tpu_torch/utils/config.py"} <= rel
    bad = {f"{p.relative_to(REPO)}: {root}" for p in paths
           for root in _imported_roots(p) if root in FORBIDDEN}
    assert not bad, sorted(bad)


def _dotted(path: Path) -> str:
    rel = path.relative_to(REPO).with_suffix("")
    parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
    return ".".join(parts)


def test_importing_every_module_loads_no_jax():
    mods = [_dotted(p) for p in sorted(PORT.rglob("*.py"))]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r})\n"
            "assert not bad, bad\n"
            "print(len(sys.modules))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=str(REPO),
                       env={**os.environ, "PYTHONPATH": str(REPO)})
    assert r.returncode == 0, r.stderr


def test_the_analyzer_imports_neither_jax_nor_torch():
    """``pdnlp_tpu_torch.analysis`` is pure ``ast``: importing it (and
    running it on a file) loads neither JAX, the JAX package nor torch —
    it runs on any machine — and no module of it names one."""
    paths = sorted((PORT / "analysis").rglob("*.py"))
    assert len(paths) > 25
    bad = {f"{p.relative_to(REPO)}: {root}" for p in paths
           for root in _imported_roots(p) if root in FORBIDDEN + ("torch",)}
    assert not bad, sorted(bad)
    code = ("import sys\n"
            "from pdnlp_tpu_torch.analysis import analyze_paths\n"
            "analyze_paths(['pdnlp_tpu_torch/models/bert.py'])\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN + ('torch',)!r})\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=str(REPO),
                       env={**os.environ, "PYTHONPATH": str(REPO)})
    assert r.returncode == 0, r.stderr


def test_kernel_build_is_content_addressed_and_lazy(monkeypatch):
    """Importing builds nothing; the library name hashes the source and the
    flags, so an edited kernel never loads a stale build; without nvcc the
    build raises instead of falling back."""
    from pdnlp_tpu_torch.ops import cuda_lib

    target = cuda_lib._target("flash_fwd")
    assert target.parent == cuda_lib.BUILD_DIR
    assert target.name.startswith("libflash_fwd-") and target.suffix == ".so"
    assert "flash_fwd" not in cuda_lib._LOADED
    monkeypatch.setattr(cuda_lib, "NVCC_FLAGS", cuda_lib.NVCC_FLAGS + ("-g",))
    assert cuda_lib._target("flash_fwd") != target
    if os.path.exists(target) or cuda_lib.shutil.which("nvcc") \
            or os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc or a finished build is present: nothing to refuse")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_lib.build_all(["flash_fwd"])


def test_entry_points_default_to_cuda_and_raise_without_a_card(tmp_path):
    from pdnlp_tpu_torch.data.tokenizer import WordPieceTokenizer, build_vocab
    from pdnlp_tpu_torch.serve.engine import InferenceEngine
    from pdnlp_tpu_torch.utils.config import Args, parse_cli

    from pdnlp_tpu_torch.train import multi

    assert Args().device == "cuda" and parse_cli([]).device == "cuda"
    for strategy in ("tp", "ep"):
        assert multi.parse(["--strategy", strategy])[0].device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present: cuda is available, nothing to refuse")
    tok = WordPieceTokenizer(build_vocab(["天地人"], size=16))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(Args(model="bert-tiny"), tokenizer=tok)
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(tok.vocab_list) + "\n", encoding="utf-8")
    r = subprocess.run(
        [sys.executable, "-m", "pdnlp_tpu_torch.serve.cli", "--model",
         "bert-tiny", "--vocab_path", str(vocab), "--device", "cuda"],
        input="天地\n", capture_output=True, text=True, timeout=120,
        cwd=str(tmp_path), env={**os.environ, "PYTHONPATH": str(REPO)})
    assert r.returncode != 0 and "no CUDA device" in r.stderr
    assert r.stdout == ""


def test_decode_cli_raises_without_a_card(tmp_path):
    """``serve.cli --decode`` defaults to cuda too, and exits through
    ``resolve_device`` where there is none — no decode on the CPU unless
    asked for."""
    from pdnlp_tpu_torch.data.tokenizer import build_vocab

    if torch.cuda.is_available():
        pytest.skip("a card is present: cuda is available, nothing to refuse")
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(build_vocab(["天地人"], size=16)) + "\n",
                     encoding="utf-8")
    r = subprocess.run(
        [sys.executable, "-m", "pdnlp_tpu_torch.serve.cli", "--decode",
         "--model", "bert-tiny", "--vocab_path", str(vocab)],
        input="天地\n", capture_output=True, text=True, timeout=120,
        cwd=str(tmp_path), env={**os.environ, "PYTHONPATH": str(REPO)})
    assert r.returncode != 0 and "no CUDA device" in r.stderr
    assert r.stdout == ""


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Run alone, or on a machine without a card, the smoke script prints
    no result and exits non-zero."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the smoke script would run")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((REPO / "chip_smoke.py").read_text(encoding="utf-8"),
                     encoding="utf-8")
    for cwd, script in ((REPO, REPO / "chip_smoke.py"), (tmp_path, alone)):
        r = subprocess.run([sys.executable, str(script)], capture_output=True,
                           text=True, timeout=120, cwd=str(cwd),
                           env={k: v for k, v in os.environ.items()
                                if k != "PYTHONPATH"})
        assert r.returncode != 0
        assert '"ok"' not in r.stdout
