"""What the benchmark imports: no module whose top-level name is ``jax``,
``jaxlib``, ``flax`` or ``pfd_tpu`` (compared as whole names, so the port
``pfd_tpu_torch`` passes), nothing of the program in the reference, and a
run's process free of them; without a card the command exits with no
result."""

import ast
import json
import subprocess
import sys
from pathlib import Path

from pfdbench import run

ROOT = Path(__file__).resolve().parents[2]
BENCH_DIR = ROOT / "pfdbench"


def _top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_sources_import_no_jax():
    files = [p for p in BENCH_DIR.rglob("*.py") if "tests" not in p.parts]
    assert len(files) > 10
    for p in files:
        bad = _top_level_imports(p) & set(run.FORBIDDEN)
        assert not bad, (p, bad)
    for p in (BENCH_DIR / "reference").glob("*.py"):
        assert not _top_level_imports(p) & {"pfd_tpu_torch", "pfd_tpu", "jax"}, p


def test_whole_names():
    code = ("import sys, types; sys.modules['pfd_tpu_torch_x'] = types.ModuleType('a');"
            "sys.modules['jaxtyping'] = types.ModuleType('b');"
            "from pfdbench import run; print(run.forbidden_modules());"
            "sys.modules['pfd_tpu.ops'] = types.ModuleType('c'); print(run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True).stdout.split("\n")
    assert out[0] == "[]" and out[1] == "['pfd_tpu']"


def test_a_run_loads_no_jax():
    code = ("import json; from pfdbench import run, traffic; from pfdbench.tests import tiny;"
            "b = run.load_json(run.ROOT / 'BENCHMARK.json'); c = b['workloads'][3];"
            "r, _ = run.run(b, c, 9, 0.1, True, 'cpu', tiny.overrides(c, traffic.load(c['traffic'])));"
            "import sys; print(json.dumps([run.forbidden_modules(), r['correct'],"
            " 'pfd_tpu_torch' in sys.modules]))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True, timeout=600).stdout.strip().split("\n")[-1]
    assert json.loads(out) == [[], True, True]


def test_no_card_no_result():
    p = subprocess.run([sys.executable, "-m", "pfdbench.run", "--workload",
                        "pfd_seecoder.b1-turbo-bf16", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == "" and "CUDA" in p.stderr


def test_benchmark_file_names():
    bench = run.load_json(ROOT / "BENCHMARK.json")
    for w in bench["workloads"]:
        assert (BENCH_DIR / "traffic" / f"{w['traffic']}.json").exists()
        assert (BENCH_DIR / "workloads" / f"{w['name']}.json").exists()
    for m in bench["per_layer"]:
        assert (BENCH_DIR / "metrics" / f"{m['name']}.py").exists()
    for m in bench["end_to_end"]:
        assert (BENCH_DIR / "e2e" / f"{m['name']}.py").exists()
    for c in bench["configs"]:
        assert (ROOT / c["file"]).exists()
