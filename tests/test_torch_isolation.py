"""The port stands alone: no module of bioscan_clip_tpu_torch, and not
chip_smoke.py, imports JAX or the JAX package; importing the whole port
leaves them (and the optional host libraries the card's machine lacks) out
of sys.modules; and entry points refuse to fall back to the CPU silently."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "bioscan_clip_tpu"}


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno


def test_no_forbidden_imports():
    files = sorted((ROOT / "bioscan_clip_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    names = {p.relative_to(ROOT).as_posix() for p in files}
    # the OpenCLIP slices' modules, the probe, the training CLI with its
    # loader and logger, the parallel layer, and the INSECT, fine-tune and
    # BZSL modules with their CLIs are among those checked
    assert {f"bioscan_clip_tpu_torch/{m}.py" for m in (
        "models/openclip", "models/mlp", "models/heads",
        "data/clip_tokenizer", "tools/bench_topk_variants",
        "train/checkpoint", "cli/train_cl", "utils/logging",
        "data/pipeline", "parallel/mesh", "parallel/distributed",
        "data/insect", "train/fine_tuning", "retrieval/methods",
        "retrieval/bzsl", "retrieval/bzsl_classifier",
        "cli/extract_feature_for_insect_dataset", "cli/bzsl_eval",
        "cli/fine_tune_vitb_on_insect",
        "cli/supervised_fine_tune_bioscan_clip_model_on_insect",
        "cli/method_one_eval", "cli/method_two_fine_tuning_and_eval",
        "utils/flops", "data/splits", "data/native_io", "cli/generate_hdf5",
        "cli/process_insect_dataset", "cli/get_species_taxo_labels",
        "cli/flatten_csv", "cli/read_image_with_image_file_as_name",
        "cli/loading_speed_test", "utils/viz", "interop/torch_export")
    } <= names
    bad = [f"{p.relative_to(ROOT)}:{line} imports {mod}"
           for p in files for mod, line in _imported_roots(p)
           if mod in FORBIDDEN]
    assert not bad, bad


def test_import_leaves_jax_out():
    code = (
        "import importlib, pkgutil, sys\n"
        "import bioscan_clip_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import bioscan_clip_tpu_torch.retrieval.service\n"
        "import chip_smoke\n"
        "print(' '.join(sorted(sys.modules)))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout.split()
    roots = {m.split(".")[0] for m in out}
    assert "bioscan_clip_tpu_torch" in roots
    # JAX, the JAX package, and the host libraries the card's machine lacks
    leaked = roots & (FORBIDDEN | {"yaml", "PIL", "cv2", "h5py",
                                   "transformers", "wandb", "pandas"})
    assert not leaked, sorted(leaked)


# what the card's machine lacks: a module of the port imports these only
# inside the functions that need them
HOST_LIBRARIES = ("pandas", "h5py", "PIL", "cv2", "matplotlib", "sklearn",
                  "seaborn", "psutil", "yaml", "transformers", "Bio", "umap")


def test_import_without_the_host_libraries():
    """Every module of the port, and chip_smoke.py, imports with the host
    libraries the card's machine lacks made unimportable."""
    code = (
        "import importlib, pkgutil, sys\n"
        f"for name in {HOST_LIBRARIES!r}:\n"
        "    sys.modules[name] = None\n"
        "import bioscan_clip_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    pkg.__path__, pkg.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "print(len(names))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert int(r.stdout.split()[-1]) > 60


def test_entry_points_need_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    from bioscan_clip_tpu_torch.device import resolve_device
    from bioscan_clip_tpu_torch.models.clip import MultiModalCLIP, load_clip_model
    from bioscan_clip_tpu_torch.retrieval.engine import PreparedKeys
    from bioscan_clip_tpu_torch.retrieval.service import RetrievalService

    with pytest.raises(RuntimeError, match="CUDA"):
        RetrievalService(MultiModalCLIP())
    with pytest.raises(RuntimeError, match="CUDA"):
        PreparedKeys([[1.0, 0.0]])
    with pytest.raises(RuntimeError, match="CUDA"):
        load_clip_model(None)
    assert resolve_device("cpu").type == "cpu"
    assert RetrievalService(MultiModalCLIP(), device="cpu").info()[
        "backend"] == "cpu"


@pytest.mark.parametrize("name", [
    "extract_feature_for_insect_dataset", "fine_tune_vitb_on_insect",
    "supervised_fine_tune_bioscan_clip_model_on_insect", "method_one_eval",
    "method_two_fine_tuning_and_eval"])
def test_insect_and_method_clis_need_cuda_unless_cpu_is_asked(name):
    """The INSECT, fine-tune and method CLIs run on the card by default:
    without CUDA they raise before reading anything (their CPU runs:
    tests/test_torch_{insect,methods}.py)."""
    import importlib

    from bioscan_clip_tpu_torch.config.core import ConfigNode

    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    cli = importlib.import_module(f"bioscan_clip_tpu_torch.cli.{name}")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.run(ConfigNode({"model_config": {}}))
