"""The benchmark's counts of work: the model FLOPs against PyTorch's FLOP
counter on the reference at two shapes each, the kernels' operations, bytes
and bounds against hand counts, and the launch arithmetic against the smoke
test's ``LaunchPlan`` on the program's own model for each cell's schedule
(a training step's: the batcher's one VAE encode, phase 15's K1 a batch)."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from pfdbench import run, traffic, work
from pfdbench.reference.model import Reference
from pfdbench.tests import tiny

torch.set_num_threads(2)
BENCH = run.load_json(run.ROOT / "BENCHMARK.json")
HELD = run.load_json(run.HERE / "held_back.json")
CELLS = {w["name"]: w for w in BENCH["workloads"] + HELD["workloads"]}


def _flops(fn, *args):
    with FlopCounterMode(display=False) as m:
        fn(*args)
    return m.get_total_flops()


@pytest.fixture(scope="module")
def ref():
    torch.manual_seed(0)
    r = Reference(tiny.PFD_CTL)
    for p in r.parameters():
        torch.nn.init.normal_(p, std=0.05)
    return r


@pytest.mark.parametrize("lat", [8, 16])
def test_unet_and_controlnet_flops(ref, lat):
    a = tiny.PFD_CTL["args"]
    x, t, c = torch.randn(1, 4, lat, lat), torch.tensor([10]), torch.randn(1, 16, 128)
    u = work.UNetWork(work.unet_args(tiny.PFD_CTL), lat, lat, 16, up_taps=9)
    net = ref.diffuser["image"]
    assert _flops(net.full, x, t, c) == u.full_flops
    _, deep, skips = net.full(x, t, c)
    assert _flops(net.shallow, deep, skips, t, c) == u.shallow_flops
    cf, _, hf, _ = work.controlnet_work(a["ctl_cfg"]["args"], lat, lat, 16, (8 * lat, 8 * lat))
    hint = torch.rand(1, 3, 8 * lat, 8 * lat)
    assert _flops(ref.ctl.hint_embed, hint) == hf
    g = ref.ctl.hint_embed(hint)
    assert _flops(ref.ctl, x, g, t, c) == cf


@pytest.mark.parametrize("size", [64, 96])
def test_seecoder_and_vae_flops(ref, size):
    a = tiny.PFD_CTL["args"]
    img = torch.rand(1, 3, size, size)
    assert _flops(ref.context, img) == work.seecoder_flops(dict(a["ctx_cfg_list"])["image"]["args"],
                                                           size, size)
    z = torch.randn(1, 4, size // 8, size // 8)
    want = work.vae_decoder_work(dict(a["vae_cfg_list"])["image"]["args"], size // 8, size // 8,
                                 up_taps=9)[0]
    assert _flops(ref.vae["image"].decode, z) == want


def test_kernel_counts_by_hand():
    k1 = work._attn_calls([("attn", 320, 8, 64, 64)], 2, 148, False)
    assert [c.kernel for c in k1] == ["flash_attention", "cross_attention"]
    assert k1[0].ops_bf16 == 4 * 2 * 8 * 4096 * 4096 * 40
    assert k1[0].nbytes == 2 * 4 * 2 * 8 * 4096 * 40
    assert abs(k1[0].bound_s() - 4 * 2 * 8 * 4096 ** 2 * 40 / 989e12) < 1e-12
    assert k1[1].nbytes == 2 * 2 * 8 * 40 * (2 * 4096 + 2 * 148)
    assert k1[1].bound_s() == k1[1].nbytes / 3.35e12          # bound by bytes
    pv8 = work._attn_calls([("attn", 640, 8, 32, 32)], 16, 148, True)[0]
    assert pv8.kernel == "flash_attention_pv8" and pv8.ops_int8 == pv8.ops_bf16
    assert pv8.ops_bf16 + pv8.ops_int8 == 4 * 16 * 8 * 1024 * 1024 * 80
    assert work._attn_calls([("attn", 1280, 8, 16, 16)], 2, 148, False) == []
    conv = work._conv_calls([("conv", 320, 320, 64, 64, 3, 1, False)], 2)[0]
    assert conv.ops_int8 == 2 * 2 * 64 * 64 * 320 * 320 * 9
    assert abs(conv.bound_s() - 0.00763e-3) < 0.00001e-3     # the kernel table's bound
    up = work._conv_calls([("conv", 640, 640, 64, 64, 3, 1, True)], 1)[0]
    assert up.ops_int8 == 2 * 64 * 64 * 640 * 640 * 4
    assert up.nbytes == 640 * 32 * 32 + 4 * 640 * 640 * 4 + 4 * 640 * 64 * 64
    assert work._conv_calls([("conv", 4, 320, 64, 64, 3, 1, False),
                             ("conv", 320, 320, 64, 64, 1, 1, False)], 1) == []


def _train_launches(t):
    """A step's calls against the program's VAE encoder: one mid-block
    attention an encode, at the mix's size (the tiny VAE's map at 64^2
    scaled up; the CPU holds no 512^2 attention of a whole batch)."""
    from pfd_tpu_torch.models.build import build_model
    from pfd_tpu_torch.policy import FP32

    from pfdbench.entries import train

    net = build_model(tiny.PFD, policy=FP32, device="cpu")
    seen = []
    net.vae["image"].encoder.mid.attn_1.register_forward_pre_hook(
        lambda m, a: seen.append(tuple(a[0].shape)))
    with torch.no_grad():
        net.vae_encode(torch.rand(2, 3, 64, 64), "image",
                       generator=torch.Generator().manual_seed(0), sample=True)
    (_, c, h, w), = seen
    calls = train.kernel_calls(tiny.PFD, t)
    k = t["size"] // 64
    assert work.launches(calls) == {"flash_attention": 1}
    assert calls[0].shape == (t["batch"], 1, h * w * k * k, h * w * k * k, c)


@pytest.mark.parametrize("name", list(CELLS))
def test_launches_match_the_launch_plan(name):
    import chip_smoke
    from pfd_tpu_torch.models.build import build_model
    from pfd_tpu_torch.ops import quant
    from pfd_tpu_torch.policy import FP32

    cell = CELLS[name]
    t = traffic.load(cell["traffic"])
    if t["entry"] == "train":
        return _train_launches(t)
    req = work.request_of(t)
    net = build_model(tiny.PFD_CTL, policy=FP32, device="cpu")
    if req.int8:
        for part in (net.diffuser, net.vae, net.ctl):
            quant.quantize_params(part)
    want = chip_smoke.LaunchPlan(net, size=512).expected(
        steps=t["steps"], control=req.hint, quantized=req.int8, attn8=req.int8,
        phases=t.get("phases"))
    got = work.launches(work.kernel_work(tiny.PFD_CTL, req))
    assert got == {k: v for k, v in want.items() if v}


def test_full_width_counts():
    """At published widths: the counts the kernel table and PERF.md quote."""
    cfg = run.load_json(run.HERE / "configs" / "pfd_seecoder.json")["model"]
    ctl = run.load_json(run.HERE / "configs" / "pfd_seecoder_with_controlnet.json")["model"]
    table = work.unet_flops_table(ctl)
    assert 760 < table["unet_call"] < 780 and 2000 < table["vae_decoder"] < 2200
    launches = {n: work.launches(work.kernel_work(ctl if n == "f" else cfg,
                                                  work.request_of(traffic.load(t))))
                for n, t in (("a", "b8-ddim50-bf16"), ("f", "b1-canny-ddim50-bf16"),
                             ("h", "b1-turbo-bf16"), ("i", "b8-turbo-int8"))}
    assert launches["a"] == {"flash_attention": 501, "cross_attention": 500}
    assert launches["f"] == {"flash_attention": 701, "cross_attention": 700}
    assert launches["h"] == {"flash_attention": 193, "cross_attention": 192}
    assert launches["i"] == {"flash_attention_pv8": 192, "cross_attention": 192,
                             "conv_int8": 639, "flash_attention": 1}
    from pfdbench.entries import train
    step = train.kernel_calls(cfg, traffic.load("train-dp2sp2-fp32"))
    assert [c.shape for c in step] == [(8, 1, 4096, 4096, 512)]
