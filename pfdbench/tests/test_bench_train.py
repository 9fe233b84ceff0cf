"""The training cell end to end at tiny widths on the CPU, in 4 gloo ranks
started as ``torchrun`` starts them (``run.run`` past the look for a card):
it runs and is correct, its trace is read, its control fails a limit, each
planted fault (``pfdbench/faults.py``) fails the check, and a rank that fails
or hangs ends the run with no result. Then the harness's contract for a new
cell: an entry, a reference, a configuration, a mix and limits added as new
files outside the harness run through ``run.run`` with no other change."""

import json
import textwrap

import pytest
import torch

from pfdbench import control, faults, ranks, run, traffic
from pfdbench.tests import tiny

torch.set_num_threads(2)
HELD = "pfdbench/held_back.json"
BENCH = run.load_json(run.ROOT / HELD)
CELL = "pfd_seecoder.train-dp2sp2-fp32"
SEED = 2 ** 31 + 11
COMPARED = {"batch_err", "loss_err", "grad_norm_err", "grad1_leaf_err", "delta_leaf_err",
            "ema_leaf_err"}


def _overrides():
    cell = run.cell_of(BENCH, CELL)
    return tiny.overrides(cell, traffic.load(cell["traffic"]))


def _run(trace=False, plant=None, timeout=300):
    return run.run(BENCH, run.cell_of(BENCH, CELL), SEED, 0.3, trace, "cpu", _overrides(),
                   timeout=timeout, plant=plant)


def test_train_cell_runs_and_is_correct():
    result, compared = _run()
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 1
    assert result["device"]["count"] == 4
    assert set(result["metrics"]) == {"img_per_s", "setup_s"}
    assert all(v["value"] > 0 for v in result["metrics"].values())
    assert list(result)[-1] == "compared" and set(compared) == COMPARED
    assert all(v < lim for v, lim in compared.values())
    assert compared["batch_err"][0] > 0 and compared["grad_norm_err"][0] > 0
    json.dumps(result)


def test_train_traced_run_reads_its_trace():
    result, _ = _run(trace=True)
    assert result["correct"]
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    # the CPU trace holds no device activity: every reader returns nothing
    assert result["metrics"] == {}


def test_train_control_fails_a_limit():
    """The reference with its gradients rounded to bfloat16 (TF32's stand-in
    on the CPU) and float8 encoders, held to the float32 reference."""
    cell = run.cell_of(BENCH, CELL)
    ov = _overrides()
    rows = control.control_readings(cell, [SEED], "cpu", ov, timeout=300)
    ctl = rows[0]["control"]
    assert any(ctl[k] > 2 * lim for k, lim in ov["limits"].items()), ctl
    assert all(rows[0]["sound"][k] < lim for k, lim in ov["limits"].items())


@pytest.mark.parametrize("fault", sorted(faults.TRAIN))
def test_train_fault_fails_the_check(fault):
    result, compared = _run(plant=f"pfdbench.faults:{fault}")
    assert not result["correct"], compared


@pytest.mark.parametrize("plant,code", [("die_on_rank_2", 1), ("hang_on_rank_1", 124)])
def test_a_failing_rank_ends_the_run(plant, code):
    with pytest.raises(ranks.RankFailed) as e:
        _run(plant=f"pfdbench.tests.tiny:{plant}", timeout=60)
    assert e.value.code == code


ENTRY = '''
    """A throwaway entry: one matrix product a request."""
    import numpy as np
    import torch

    from pfdbench import entries


    class Entry(entries.Entry):
        warmup = 1

        def __init__(self, cell):
            self.cell, n = cell, cell.model_cfg["width"]
            gen = torch.Generator().manual_seed(cell.seed)
            self.w = torch.randn(n, n, generator=gen)

        def warmup_request(self, j):
            return self.request(-1 - j)

        def request(self, i):
            rng = np.random.default_rng([self.cell.seed, i + 2])
            return rng.standard_normal((self.cell.traffic["batch"], self.cell.model_cfg["width"]))

        def __call__(self, x):
            return (torch.as_tensor(x, dtype=torch.float32) @ self.w).numpy()

        def work(self):
            n, b = self.cell.model_cfg["width"], self.cell.traffic["batch"]
            return entries.Work([], 2.0 * b * n * n, b)

        def check(self, outputs):
            ref = self.cell.reference_module().Reference(self.cell.model_cfg)
            return {"max_abs_err": max(float(np.abs(o - ref(self.request(i), self.cell.seed)).max())
                                       for i, o in enumerate(outputs))}
'''
REFERENCE = '''
    """The throwaway entry's reference, in float64."""
    import torch


    class Reference:
        def __init__(self, cfg):
            self.n = cfg["width"]

        def __call__(self, x, seed):
            w = torch.randn(self.n, self.n, generator=torch.Generator().manual_seed(seed))
            return (torch.as_tensor(x).double() @ w.double()).numpy()
'''


def test_a_new_cell_is_new_files(tmp_path, monkeypatch):
    pkg = tmp_path / "lib" / "toybench_entry"
    pkg.mkdir(parents=True)
    (pkg / "__init__.py").write_text("")
    (pkg / "entry.py").write_text(textwrap.dedent(ENTRY))
    (pkg / "reference.py").write_text(textwrap.dedent(REFERENCE))
    monkeypatch.syspath_prepend(str(tmp_path / "lib"))
    home = tmp_path / "home"
    files = {"configs/toy.json": {"model": {"width": 16}, "weights": {},
                                  "reference": "toybench_entry.reference"},
             "traffic/b4.json": {"entry": "toybench_entry.entry", "batch": 4,
                                 "trace_requests": 1},
             "workloads/toy.b4.json": {"limits": {"max_abs_err": 1e-4}}}
    for name, body in files.items():
        (home / name).parent.mkdir(parents=True, exist_ok=True)
        (home / name).write_text(json.dumps(body))
    cell = {"name": "toy.b4", "config": "toy", "traffic": "b4", "chips": 1, "why": "a test"}
    bench = {"workloads": [cell], "per_layer": [],
             "end_to_end": [dict(m, workloads=["toy.b4"]) for m in BENCH["end_to_end"]
                            if m["name"] in ("img_per_s", "setup_s")]}
    for trace in (False, True):
        result, compared = run.run(bench, cell, SEED, 0.2, trace, "cpu", home=home)
        assert result["correct"] and result["attempted"] >= 1, result
        assert 0 <= compared["max_abs_err"][0] < 1e-4
        if not trace:
            assert set(result["metrics"]) == {"img_per_s", "setup_s"}
    broken = dict(files["workloads/toy.b4.json"], limits={"max_abs_err": 0.0})
    (home / "workloads/toy.b4.json").write_text(json.dumps(broken))
    assert not run.run(bench, cell, SEED, 0.2, False, "cpu", home=home)[0]["correct"]


@pytest.mark.cuda
def test_train_cell_on_four_cards():
    """The training cell at full size for a few seconds through the command
    (skips without 4 CUDA cards): every rank exits 0, and the last line of
    standard output is the result."""
    import subprocess
    import sys

    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA cards")
    p = subprocess.run([sys.executable, "-m", "pfdbench.run", "--workload", CELL, "--seed",
                        str(SEED), "--seconds", "3", "--trace", "0", "--bench", HELD], cwd=run.ROOT,
                       capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-4000:]
    result = json.loads(p.stdout.strip().split("\n")[-1])
    assert result["correct"] and result["device"]["count"] == 4, result
