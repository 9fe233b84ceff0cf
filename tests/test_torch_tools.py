"""The port's kernel labs (``pfd_tpu_torch.tools``): they import neither JAX
nor pfd_tpu, refuse to measure without a card, and one small section of
each runs on the CPU when asked to (``device="cpu"``, tiny sizes, rows that
say so and carry no device rate)."""

import os
import subprocess
import sys

os.environ["PFD_COMPILE_CACHE"] = ""  # no pfd_tpu.tools import may write a cache

import pytest  # noqa: E402
import torch  # noqa: E402

from pfd_tpu_torch.ops import flash_attention as fa  # noqa: E402
from pfd_tpu_torch.ops import fused_conv, int8_matmul  # noqa: E402
from pfd_tpu_torch.tools import attn_lab, int8_lab, perf_audit  # noqa: E402

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_tools_import_no_jax():
    code = (
        "import sys\n"
        "import pfd_tpu_torch.tools.perf_audit, pfd_tpu_torch.tools.attn_lab\n"
        "import pfd_tpu_torch.tools.int8_lab\n"
        "bad = [n for n in sys.modules if n == 'jax' or n.startswith('jax.')\n"
        "       or n == 'pfd_tpu' or n.startswith('pfd_tpu.')]\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("lab", [perf_audit, attn_lab, int8_lab])
def test_labs_refuse_to_run_without_a_card(monkeypatch, lab):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lab.main()


def _cpu_rows(rows, n):
    assert len(rows) == n
    for r in rows:
        assert r["device"] == "cpu" and r["ms"] > 0
        assert not {"mfu_pct", "tflops_s", "eff_pct", "gb_s"} & set(r)


def test_perf_audit_fused_section_on_cpu():
    rows = []
    before = fused_conv.conv3x3_fused.launches
    perf_audit.audit_fused(1, 8, 1, rows, device="cpu", levels=[(8, 32)])
    _cpu_rows(rows, 3)
    assert [r["op"] for r in rows] == ["gnsiluconv_plain_8x8x32", "gnsiluconv_fused_8x8x32",
                                       "gnsiluconv_fused_kernel_only_8x8x32"]
    assert fused_conv.conv3x3_fused.launches == before


def test_attn_lab_on_cpu():
    before = fa.flash_attention_pipe.launches
    rows = attn_lab.run(1, 1, shapes=[(128, 40, 2)], device="cpu")
    _cpu_rows(rows, 3)
    assert [r["case"] for r in rows] == ["b1_s128_d40_flash", "b1_s128_d40_flash_pipe",
                                         "b1_s128_d40_sdpa_yardstick"]
    assert fa.flash_attention_pipe.launches == before


def test_attn_lab_cross_on_cpu():
    before = fa.cross_attention.launches
    rows = attn_lab.cross(1, 1, shapes=[(128, 20, 40, 2)], device="cpu", calls=2)
    _cpu_rows(rows, 2)
    assert [r["case"] for r in rows] == ["b1_cross_s128_kv20_d40_cross",
                                         "b1_cross_s128_kv20_d40_sdpa_yardstick"]
    assert all(r["host_us"] > 0 for r in rows)
    assert fa.cross_attention.launches == before


def test_int8_lab_sections_on_cpu():
    before = int8_matmul.matmul_int8.launches
    _cpu_rows(int8_lab.pallas_mm([(64, 32, 48)], 1, device="cpu"), 1)
    rows = int8_lab.convs(1, 8, 32, 48, 1, device="cpu")
    assert [r["case"] for r in rows] == [
        "torch_conv_int8_8x8_32to48", "torch_conv_bf16_8x8_32to48",
        "conv_int8_kernel_8x8_32to48", "conv3x3_bf16_kernel_8x8_32to48"]
    _cpu_rows([r for r in rows if "error" not in r], sum("error" not in r for r in rows))
    assert int8_matmul.matmul_int8.launches == before


def test_timeit_counts_every_call():
    calls = []
    sec = perf_audit.timeit(lambda x: calls.append(1) or x + 1, torch.zeros(1), 4, reps=3,
                            warmup=2, device="cpu")
    assert sec > 0 and len(calls) == 2 + 3 * 4
    calls.clear()
    perf_audit.timeit_dispatch(lambda: calls.append(1), iters=5, reps=2, warmup=1,
                               device="cpu")
    assert len(calls) == 1 + 2 * 5
