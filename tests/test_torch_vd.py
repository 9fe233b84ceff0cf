"""Versatile Diffusion's four-flow model, dual-guided, on the CPU: the port
against the benchmark's plain float32 reference (``pfdbench.reference.vd``,
which imports neither JAX nor either package), at tiny widths with seeded
random weights (``pfdbench.weights``, the benchmark's recipe): each CLIP
tower's context, one dual-context UNet call (a 2d_next image diffuser whose
context blocks mix with a 0d_next text diffuser's), and a 4-step dual-guided
CFG request end to end through the facade (``action_dual_guided``). Also:
the published configuration's parameter counts on the meta device, the
bucket keys of dual-guided and single-context requests, and ``sample_fn``
with one context against the loop it ran before several contexts came in,
bit for bit. Imports no JAX.

Tolerances, each from what float32 leaves between two orders of the same
sums (the port's and the reference's own ops): the towers' contexts max-abs
1e-5 (each token is unit-scaled by the pooled norm, so its entries are
~0.1; the resize's weights are float32 against float64 rounded once; sound
readings 1.6e-7 to 1.8e-7 for the image tower, 0 for the text tower); the
UNet's eps and the request's image relative L2 1e-5 (sound readings 4.7e-7
to 6.8e-7 on two weight seeds). Rounding the reference's eps to bf16
(relative error 1.7e-3) fails them; its fp8 control reads ``image_err``
0.11-0.12 on the request.
"""

import copy

import numpy as np
import pytest
import torch

from pfd_tpu_torch import config, registry
from pfd_tpu_torch.diffusion.ddim import ddim_step, step_rows
from pfd_tpu_torch.pipeline import PromptFreeDiffusionPipeline, clip_prompt
from pfdbench import traffic, weights
from pfdbench.entries import serving
from pfdbench.reference.vd import Reference
from pfdbench.tests.tiny_vd import VD

torch.set_num_threads(2)

RECIPE = {"gain": 1.0, "zero_gain": 0.2, "norm_std": 0.04, "bias_std": 0.04, "embed_std": 1.0,
          "bias_table_std": 0.02}
STEPS, RATIO, SCALE = 4, 0.6, 7.5


def _rel(got, want):
    got, want = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    return ((got - want).norm() / want.norm()).item()


@pytest.fixture(scope="module")
def pair():
    """(the facade over the tiny VD in fp32, the reference with the same
    weights, a reference image, a prompt's ids)."""
    with torch.device("meta"):
        table = weights.rules(Reference(VD))
    w = weights.make(table, RECIPE, 5, "cpu", dtype=torch.float32)
    pipe = PromptFreeDiffusionPipeline(fp16=False, device="cpu", config_override=copy.deepcopy(VD),
                                       with_control=False, tag_ctx="CLIP", tag_ctl="none",
                                       pretrained_root="/nonexistent")
    pipe.ddim_steps = STEPS
    pipe._load(pipe.net, w)
    with torch.device("meta"):
        ref = Reference(VD)
    ref = ref.to_empty(device="cpu")
    ref.load_state_dict(w)
    ref.set_precision(None)
    rng = np.random.default_rng(3)
    img = traffic.reference_image(rng, 64)
    ids = clip_prompt(rng.integers(0, 49406, size=12))
    return pipe, ref, img, ids


def test_vd_config_builds_at_the_published_widths():
    """``vd_four_flow`` on the meta device: the image UNet 859.5 M, the text
    UNet 1,708.8 M, the CLIP towers 304.0 M and 123.7 M parameters; the
    two diffusers' context blocks pair up channel for channel."""
    cfg = config.model_cfg("vd_four_flow")
    with torch.device("meta"):
        net = registry.get(cfg["type"])(**cfg["args"])

    def millions(m):
        return round(sum(p.numel() for p in m.parameters()) / 1e6, 1)

    assert (millions(net.diffuser["image"]), millions(net.diffuser["text"])) == (859.5, 1708.8)
    assert (millions(net.ctx["image"]), millions(net.ctx["text"])) == (304.0, 123.7)
    assert [s.ch for s in net.diffuser["image"].plan.context_specs] == [
        s[0] for s in net.diffuser["text"].context_specs]
    assert sorted(net.vae) == ["image"]


@pytest.mark.parametrize("which", ["image", "text"])
def test_clip_tower_matches_the_reference(pair, which):
    pipe, ref, img, ids = pair
    with torch.no_grad():
        if which == "image":
            x = pipe.reference(img)
            got, want = pipe.net.ctx_encode(x, "image"), ref.ctx["image"](x)
            assert got.shape == (1, 5, 128)
        else:
            x = pipe.prompt_ids(ids)
            got, want = pipe.net.ctx_encode(x, "text"), ref.ctx["text"](x)
            assert got.shape == (1, 77, 128)
    assert (got - want).abs().max().item() < 1e-5
    assert want.abs().max().item() > 0.05


def _eps_inputs():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 4, 8, 8, generator=g)
    c_img, c_txt = torch.randn(2, 5, 128, generator=g), torch.randn(2, 77, 128, generator=g)
    return x, torch.tensor([500, 500]), c_img, c_txt


def test_dual_context_unet_call_matches_the_reference(pair):
    """One call: the image UNet's data blocks, each context block mixed
    0.6 / 0.4 between the image UNet's over one context and the text UNet's
    over the other. The reference's eps rounded to bf16 fails the
    tolerance."""
    pipe, ref = pair[:2]
    x, t, c_img, c_txt = _eps_inputs()
    with torch.no_grad():
        got = pipe.net.apply_model_multicontext(
            {"type": "image", "x": x}, t, [{"type": "image", "c": c_img, "ratio": RATIO},
                                           {"type": "text", "c": c_txt, "ratio": 1 - RATIO}])
        want = ref.eps(x, t, [(c_img, RATIO), (c_txt, 1 - RATIO)])
        alone = ref.eps(x, t, [(c_img, 1.0), (c_txt, 0.0)])
    assert _rel(got, want) < 1e-5
    assert _rel(alone, want) > 1e-2  # the text pathway moves eps
    assert _rel(want.bfloat16().float(), want) > 1e-5


def test_dual_guided_request_matches_the_reference(pair):
    """A 4-step dual-guided request at CFG 7.5 through the facade against the
    reference's: the image within relative L2 1e-5; the same request again
    bit for bit (the unconditional pair from the cache)."""
    pipe, ref, img, ids = pair
    got = np.stack(pipe.action_dual_guided(img, ids, RATIO, 64, 64, SCALE, 123))
    x = serving.start_latent(123, 1, 64, "cpu")
    want = ref.generate(torch.as_tensor(img).permute(2, 0, 1)[None],
                        torch.as_tensor(ids)[None], x, ratio=RATIO, scale=SCALE,
                        steps=STEPS)[0].permute(1, 2, 0).numpy()
    assert got.shape == (1, 64, 64, 3)
    assert _rel(got[0], want) < 1e-5 and serving.image_err(got[0], want) < 1e-5
    assert want.std() > 0.05
    assert sorted(pipe._uncond) == [("image", (1, 3, 64, 64)), ("text", (1, 77))]
    assert np.array_equal(np.stack(pipe.action_dual_guided(img, ids, RATIO, 64, 64, SCALE, 123)),
                          got)


def test_dual_guided_and_single_context_buckets_differ(pair):
    """A dual-guided request's bucket is keyed apart from a single-context
    request's of the same shape, and by its contexts' lengths; not by their
    ratios, which are inputs of the graph."""
    pipe = pair[0]
    single = pipe._sample_decode_fn(64, 64, 1, False, STEPS, 0.0)
    mixed = (("image", 5), ("text", 77))
    dual = pipe._sample_decode_fn(64, 64, 1, False, STEPS, 0.0, mixed)
    assert dual is not single
    assert pipe._sample_decode_fn(64, 64, 1, False, STEPS, 0.0, mixed) is dual
    assert pipe._sample_decode_fn(64, 64, 1, False, STEPS, 0.0, (("image", 5), ("text", 9))) \
        is not dual
    assert (64, 64, 1, False, STEPS, 0.0) in pipe._graphs
    assert (64, 64, 1, False, STEPS, 0.0, mixed) in pipe._graphs


def _want(ref, img, ids, ratio, seed=123):
    x = serving.start_latent(seed, 1, 64, "cpu")
    return ref.generate(torch.as_tensor(img).permute(2, 0, 1)[None], torch.as_tensor(ids)[None],
                        x, ratio=ratio, scale=SCALE, steps=STEPS)[0].permute(1, 2, 0).numpy()


def test_a_ratio_is_an_input_of_the_bucket(pair):
    """Requests at two ratios run one bucket, each giving the reference's
    image at its own ratio (relative L2 1e-5, as above); the two images
    differ."""
    pipe, ref, img, ids = pair
    got, buckets = {}, []
    for r in (RATIO, 0.3):
        got[r] = pipe.action_dual_guided(img, ids, r, 64, 64, SCALE, 123)[0]
        assert _rel(got[r], _want(ref, img, ids, r)) < 1e-5
        buckets.append(dict(pipe._graphs))
    assert buckets[0] == buckets[1]
    assert (64, 64, 1, False, STEPS, 0.0, (("image", 5), ("text", 77))) in buckets[0]
    assert _rel(got[0.3], got[RATIO]) > 1e-3


def test_loading_weights_drops_the_unconditional_pair(pair):
    """The unconditional pair is cached once a shape, and ``_load`` drops
    it: after other weights are loaded, a request matches the reference
    with those weights (relative L2 1e-5), where the pair of the old
    weights puts it off by more than 1e-3."""
    pipe, ref, img, ids = pair
    pipe.action_dual_guided(img, ids, RATIO, 64, 64, SCALE, 123)
    stale = dict(pipe._uncond)
    with torch.device("meta"):
        table = weights.rules(Reference(VD))
    old = {k: v.clone() for k, v in ref.state_dict().items()}
    try:
        other = weights.make(table, RECIPE, 6, "cpu", dtype=torch.float32)
        pipe._load(pipe.net, other)
        ref.load_state_dict(other)
        assert not pipe._uncond
        got = pipe.action_dual_guided(img, ids, RATIO, 64, 64, SCALE, 123)[0]
        want = _want(ref, img, ids, RATIO)
        assert _rel(got, want) < 1e-5
        pipe._uncond.update(stale)
        assert _rel(pipe.action_dual_guided(img, ids, RATIO, 64, 64, SCALE, 123)[0], want) > 1e-3
    finally:
        pipe._load(pipe.net, old)
        ref.load_state_dict(old)


def test_sample_fn_with_one_context_is_the_loop_it_was(pair):
    """``sample_fn`` with one context (CFG 7.5, 4 exact steps) is the loop
    it ran before it took several contexts, bit for bit: per step the CFG-
    doubled ``apply_model``, the guidance and ``ddim_step``. The same
    context as the only one of ``c_info['contexts']`` at ratio 1 gives the
    same latent bit for bit."""
    pipe = pair[0]
    net, sampler = pipe.net, pipe.sampler
    x, _, c, _ = _eps_inputs()
    x, c, u = x[:1], c[:1], torch.zeros_like(c[:1])
    tables = sampler.make_tables(STEPS)
    with torch.no_grad():
        got, _ = sampler.sample_fn(x, {"conditioning": c, "unconditional_conditioning": u,
                                       "unconditional_guidance_scale": SCALE}, tables)
        want = x
        for row in step_rows(tables):
            t = torch.full((2,), int(row[0]), dtype=torch.long)
            e = net.apply_model({"type": "image", "x": torch.cat([want, want])}, t,
                                {"type": "image", "c": torch.cat([u, c])}).float()
            e_uc, e_c = e.chunk(2)
            want = ddim_step(want, row, e_uc + float(np.float32(SCALE)) * (e_c - e_uc))[0]
        one, _ = sampler.sample_fn(x, {"contexts": [
            {"type": "image", "conditioning": c, "unconditional_conditioning": u, "ratio": 1.0}],
            "unconditional_guidance_scale": SCALE}, tables)
    assert torch.equal(got, want) and torch.equal(one, got)


def test_several_contexts_refuse_the_turbo_modes(pair):
    pipe = pair[0]
    x, _, c, _ = _eps_inputs()
    ci = {"contexts": [{"type": "image", "conditioning": c[:1], "ratio": 1.0,
                        "unconditional_conditioning": torch.zeros_like(c[:1])}],
          "unconditional_guidance_scale": 2.0}
    with pytest.raises(ValueError, match="exact steps"):
        pipe.sampler.sample_fn(x[:1], ci, pipe.sampler.make_tables(STEPS), cfg_interval=2)


def test_a_string_prompt_needs_the_vocabulary(pair):
    with pytest.raises(FileNotFoundError, match="BPE"):
        pair[0].action_dual_guided(pair[2], "a photo", RATIO, 64, 64, SCALE, 1)


CELL = "vd_four_flow.b4-dual-ddim50-bf16"
HARNESS_SEED = 2 ** 31 + 11


def _overrides(limit):
    """The cell at the tiny widths above: 64^2, 4 steps, b4 as the cell."""
    return {"model": copy.deepcopy(VD), "traffic": {"size": 64, "steps": STEPS,
                                                    "trace_requests": 1},
            "limits": {"image_err": limit}}


def test_the_cell_runs_through_the_harness():
    """The benchmark's cell end to end on the CPU at tiny widths (``run.run``
    past the look for a card): the facade's bf16 dual-guided requests,
    correct against the reference; a traced run reads nothing on the CPU;
    the request's work (K1 and K2 on both pathways of every long block).
    ``image_err`` limit 0.04, the tiny bf16 cells' (``pfdbench/tests/tiny.py``;
    sound runs read 0.0106-0.0118 here on four seeds); ``cross_attention_err``
    under the cell's limit (sound runs read 0.0028-0.0029 here)."""
    from pfdbench import run

    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    cell = run.cell_of(bench, CELL)
    result, compared = run.run(bench, cell, HARNESS_SEED, 0.2, False, "cpu", _overrides(0.04))
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 1
    assert set(result["metrics"]) == {"img_per_s", "setup_s"}
    assert 0 < compared["image_err"][0] < 0.04
    assert set(compared) == {"image_err", "cross_attention_err"}
    assert 0 < compared["cross_attention_err"][0] < compared["cross_attention_err"][1]
    result, _ = run.run(bench, cell, HARNESS_SEED, 0.2, True, "cpu", _overrides(0.04))
    assert result["correct"] and result["metrics"] == {}


def test_the_cells_control_fails_its_limit():
    """The float8 reference against the float32 one on the tiny cell reads
    well above the limit (0.113-0.132 on both seeds)."""
    from pfdbench import control, run

    cell = run.cell_of(run.load_json(run.ROOT / "BENCHMARK.json"), CELL)
    readings = control.control_readings(cell, [HARNESS_SEED, 5], "cpu", _overrides(0.04))
    assert min(max(v) for v in readings.values()) > 2 * 0.04


@pytest.mark.parametrize("fault", [None, "stale_unconditional", "text_cross_attention_zeroed"])
def test_the_cells_check_refuses_a_wrong_context(fault):
    """The check on two weight seeds read in one pipeline
    (``entries.vd.sound``): sound, both numbers under the cell's limits;
    with the unconditional pair of the first seed's weights kept for the
    second (the cache outliving ``_load``), or the cross-attention over the
    text context zeroed, ``cross_attention_err`` reads far above its limit
    (1.08 and 0.88 here, against sound 0.0028-0.0029), where ``image_err``
    hardly moves (0.0232 and 0.0124, against 0.0117-0.0118)."""
    from pfdbench import run
    from pfdbench.entries import vd

    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    c = run.make_cell(run.cell_of(bench, CELL), HARNESS_SEED, "cpu", _overrides(0.04))
    readings = vd.sound(c, [HARNESS_SEED, 5], fault)[5]
    limit = c.limits["cross_attention_err"]
    if fault is None:
        assert all(readings[k] < c.limits[k] for k in readings)
    else:
        assert readings["cross_attention_err"] > 10 * limit


def test_the_cells_work_at_published_widths():
    """One request at 512^2, b4: 1,165.6 GFLOP a sample and UNet call (780.7
    the image pathway over 257 keys, 384.9 the text pathway's 16
    transformers over 77), ~475 TFLOP a request; K1 1,000 launches for the
    UNet and 1 for the VAE's mid-block, K2 1,000 (500 over 257 keys, 500
    over 77)."""
    from pfdbench import run, traffic as traffic_lib, work
    from pfdbench.entries import vd

    cfg = run.load_json(run.HERE / "configs" / "vd_four_flow.json")["model"]
    t = traffic_lib.load("b4-dual-ddim50-bf16")
    u, blocks, txt = vd.dual_unet(cfg, 512)
    assert (round(u.full_flops / 1e9, 1), round(txt / 1e9, 1)) == (780.7, 384.9)
    assert len(blocks) == 16
    assert 474e12 < vd.request_flops(cfg, t) < 476e12
    calls = vd.kernel_work(cfg, t)
    assert work.launches(calls) == {"flash_attention": 1001, "cross_attention": 1000}
    keys = sorted(c.shape[3] for c in calls if c.kernel == "cross_attention")
    assert keys.count(77) == keys.count(257) == 500
