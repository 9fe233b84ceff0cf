"""Every cell end to end at tiny widths on the CPU (``run.run`` past the look
for a card), its control, and the faults its check must catch: a DDIM step
that returns its state unchanged, half of a batch left out (its images
copied from the other half), an image altered where the VAE produces it.
A one-card cell has no exchange between chips to leave out."""

import json

import numpy as np
import pytest
import torch

from pfdbench import control, run, traffic
from pfdbench.tests import tiny

torch.set_num_threads(2)
BENCH = run.load_json(run.ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]
SEED = 2 ** 31 + 11


def _run(name, seed=SEED, trace=False, **kw):
    cell = run.cell_of(BENCH, name)
    return run.run(BENCH, cell, seed, 0.2, trace, "cpu",
                   tiny.overrides(cell, traffic.load(cell["traffic"]), **kw))


@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_and_is_correct(name):
    result, compared = _run(name)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 1
    want = {m["name"] for m in run.metric_names(BENCH, run.cell_of(BENCH, name), "end_to_end")}
    assert set(result["metrics"]) == want and "setup_s" in want
    assert all(v["value"] > 0 for v in result["metrics"].values())
    assert list(result)[-1] == "compared"
    assert set(compared) == {"image_err"} and compared["image_err"][0] > 0
    json.dumps(result)


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reads_its_trace(name):
    result, _ = _run(name, trace=True)
    assert result["correct"]
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    # the CPU trace holds no device activity: every reader returns nothing
    assert result["metrics"] == {}


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_limit(name):
    cell = run.cell_of(BENCH, name)
    t = traffic.load(cell["traffic"])
    ov = tiny.overrides(cell, t)
    readings = control.control_readings(cell, [SEED, 5], "cpu", ov)
    limit = ov["limits"]["image_err"]
    assert min(max(v) for v in readings.values()) > 2 * limit


def _step_unchanged(monkeypatch):
    from pfd_tpu_torch.diffusion import ddim
    monkeypatch.setattr(ddim, "ddim_step", lambda xt, row, e_t: (xt.float(), xt.float()))


def _half_batch(monkeypatch):
    from pfdbench.entries import serving
    call = serving.Serving.__call__

    def half(self, req):
        out = call(self, req)
        n = len(out) // 2
        if n:
            out[n:2 * n] = out[:n]
        return out

    monkeypatch.setattr(serving.Serving, "__call__", half)


def _answer_altered(monkeypatch):
    from pfd_tpu_torch.models import pfd
    decode = pfd.PromptFreeDiffusion.vae_decode

    def altered(self, z, which="image"):
        img = decode(self, z, which).clone()
        h = img.shape[-2] // 4
        img[..., :h, :h] = 1.0 - img[..., :h, :h]
        return img

    monkeypatch.setattr(pfd.PromptFreeDiffusion, "vae_decode", altered)


FAULTS = {"step_unchanged": _step_unchanged, "half_batch": _half_batch,
          "answer_altered": _answer_altered}


def _faults_of(name):
    """The faults a cell can have: half a batch only where it has one."""
    batch = traffic.load(run.cell_of(BENCH, name)["traffic"])["batch"]
    return [f for f in sorted(FAULTS) if f != "half_batch" or batch > 1]


@pytest.mark.parametrize("name,fault", [(n, f) for n in CELLS for f in _faults_of(n)])
def test_fault_fails_the_check(name, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    result, compared = _run(name)
    assert not result["correct"], compared


def test_same_seed_same_inputs():
    t = traffic.load("b8-ddim50-bf16")
    a, b = traffic.pools(SEED, dict(t, size=64)), traffic.pools(SEED, dict(t, size=64))
    np.testing.assert_array_equal(a[0], b[0])
    r1, r2 = traffic.request(SEED, 4, t), traffic.request(SEED, 4, t)
    assert r1["seed"] == r2["seed"] and list(r1["refs"]) == list(r2["refs"])
    assert len(set(r1["refs"])) == t["batch"]
    assert traffic.request(SEED + 1, 4, t)["seed"] != r1["seed"]


@pytest.mark.cuda
def test_cell_on_the_card():
    """The harness at tiny widths on a CUDA card (skips without one)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    cell = run.cell_of(BENCH, "pfd_seecoder.b1-turbo-bf16")
    result, _ = run.run(BENCH, cell, SEED, 1.0, True, "cuda",
                        tiny.overrides(cell, traffic.load(cell["traffic"])))
    assert result["correct"] and result["device"]["busy_s"] > 0
