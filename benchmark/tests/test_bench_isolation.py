"""Nothing the benchmark runs imports JAX or the JAX package (top-level
module names compared whole: the port's name begins with the JAX
package's), and the reference side imports nothing of the program."""

import ast
import subprocess
import sys

from benchmark.tests.tiny import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "bioscan_clip_tpu"}
PROGRAM = "bioscan_clip_tpu_torch"
# the yardstick and the reference: no import of the program at all
PLAIN = ("reference.py", "weights.py", "gen.py", "flops.py",
         "trace_agg.py")


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            names.add(node.module.split(".")[0])
    return names


def _sources():
    b = ROOT / "benchmark"
    return [p for p in b.rglob("*.py") if "tests" not in p.parts]


def test_no_source_imports_jax_or_the_jax_package():
    for p in _sources():
        assert not _imports(p) & FORBIDDEN, p


def test_the_reference_imports_nothing_of_the_program():
    for name in PLAIN:
        assert PROGRAM not in _imports(ROOT / "benchmark" / name), name
    for p in (ROOT / "benchmark" / "metrics").glob("*.py"):
        assert PROGRAM not in _imports(p), p


def test_a_run_loads_no_jax():
    """A whole small run of each cell in a fresh process, then every
    top-level module name it loaded."""
    code = (
        "import sys, pytest, json\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from benchmark.tests import tiny\n"
        "mp = pytest.MonkeyPatch(); tiny.patch_towers(mp)\n"
        "for w in (tiny.TRAIN, tiny.SEARCH):\n"
        "    tiny.run(w, seconds=0.1, trace=True)\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=600)
    loaded = set(__import__("json").loads(out.stdout.strip().splitlines()[-1]))
    assert PROGRAM in loaded
    assert not loaded & FORBIDDEN
