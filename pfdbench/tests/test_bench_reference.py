"""The reference against the program at tiny widths on the CPU, both in
float32: the image of a request (SeeCoder, DDIM with guidance exact and in
the turbo phases, the ControlNet on a canny hint, the VAE decode), the int8
rule of the integer mode, and the canny hint itself."""

import numpy as np
import pytest
import torch

from pfdbench import traffic, weights
from pfdbench.entries import serving
from pfdbench.reference import canny
from pfdbench.reference.model import Reference, ddim_rows, turbo_schedule
from pfdbench.tests import tiny

torch.set_num_threads(2)
RECIPE = {"gain": 1.0, "zero_gain": 0.2, "norm_std": 0.04, "bias_std": 0.04, "embed_std": 1.0,
          "bias_table_std": 0.02}


def _pair(cfg, seed, precision=None, **pipe_kw):
    from pfd_tpu_torch.pipeline import PromptFreeDiffusionPipeline

    with torch.device("meta"):
        table = weights.rules(Reference(cfg))
    w = weights.make(table, RECIPE, seed, "cpu", dtype=torch.float32)
    pipe = PromptFreeDiffusionPipeline(fp16=False, device="cpu", config_override=cfg,
                                       tag_ctl="canny" if "ctl_cfg" in cfg["args"] else "none",
                                       pretrained_root="/nonexistent", **pipe_kw)
    pipe.ddim_steps = 10
    pipe._load(pipe.net, w)
    with torch.device("meta"):
        ref = Reference(cfg)
    ref = ref.to_empty(device="cpu")
    ref.load_state_dict(w)
    ref.set_precision(precision)
    return pipe, ref


@pytest.mark.parametrize("case", ["exact", "turbo", "canny", "int8"])
def test_reference_matches_the_program_in_fp32(case):
    """The same request through both; in the int8 mode the trajectory parts
    by a code that rounding flips (a step of the activation's amax / 127),
    so the whole request is held to ``image_err`` and each call to
    ``test_int8_calls_match_the_program``."""
    cfg = tiny.PFD_CTL if case == "canny" else tiny.PFD
    phases = tiny.TURBO_PHASES if case in ("turbo", "int8") else None
    kw = {"phases": phases, "quantized": case == "int8",
          "with_control": case == "canny"}
    pipe, ref = _pair(cfg, 7, "int8" if case == "int8" else None, **kw)
    rng = np.random.default_rng(3)
    img = traffic.reference_image(rng, 64)
    hint_img = traffic.hint_image(rng, 64) if case == "canny" else None
    got = pipe.action_inference(img, hint_img, "canny", True, 64, 64, 2.0, 123)[0]
    x = serving.start_latent(123, 1, 64, "cpu")
    hints = None
    if hint_img is not None:
        hints = torch.as_tensor(canny.hint(hint_img)).permute(2, 0, 1)[None]
    want = ref.generate(torch.as_tensor(img).permute(2, 0, 1)[None], x, hints, scale=2.0,
                        steps=10, phases=phases)[0].permute(1, 2, 0).numpy()
    if case == "int8":
        assert serving.image_err(got, want) < 0.03
    else:
        assert np.abs(got - want).max() < 2e-5
    assert want.std() > 0.05


def test_int8_calls_match_the_program():
    """One int8 UNet call and one int8 VAE decode: the same codes, the same
    values to float32 rounding (and the odd code that rounding flips)."""
    pipe, ref = _pair(tiny.PFD, 7, "int8", quantized=True)
    gen = torch.Generator().manual_seed(0)
    x, c = torch.randn(2, 4, 8, 8, generator=gen), torch.randn(2, 16, 128, generator=gen)
    t = torch.tensor([500, 500])
    e_p = pipe.net.apply_model({"type": "image", "x": x}, t, {"type": "image", "c": c})
    e_r = ref.diffuser["image"].full(x, t, c)[0]
    assert ((e_p - e_r).norm() / e_r.norm()).item() < 2e-4   # a code rounding flips
    z = torch.randn(1, 4, 8, 8, generator=gen)
    assert (pipe.net.vae_decode(z) - ref.vae["image"].decode(z / 0.18215)).abs().max() < 1e-5


def test_canny_hint_matches_the_program():
    from pfd_tpu_torch import annotators
    img = traffic.hint_image(np.random.default_rng(4), 128)
    np.testing.assert_array_equal(canny.hint(img), annotators.preprocess(img, "canny"))
    assert canny.hint(img).mean() > 0.001


def test_schedule_tables():
    rows = ddim_rows(50, 0.00085, 0.012)
    assert [r[0] for r in rows][:2] == [981, 961] and rows[-1][0] == 1
    kinds = [k for _, k in turbo_schedule(50, [[8, 2], [42, 21]])]
    assert kinds.count("full") == 6 and kinds.count("reuse") == 44
    assert kinds[:4] == ["full", "reuse", "full", "reuse"] and kinds[8] == "full"
    assert kinds[29] == "full" and kinds[30] == "reuse"
    with pytest.raises(ValueError):
        turbo_schedule(50, [[8, 2]])


def test_weights_are_the_seeds():
    with torch.device("meta"):
        table = weights.rules(Reference(tiny.PFD))
    a = weights.make(table, RECIPE, 5, "cpu")
    b = weights.make(table, RECIPE, 5, "cpu")
    c = weights.make(table, RECIPE, 6, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a) and not torch.equal(a[table[0][0]],
                                                                       c[table[0][0]])
    kinds = {name: kind for name, _, kind, _ in table}
    norm = [k for k, v in kinds.items() if v == "norm_weight"][0]
    assert abs(a[norm].float().mean().item() - 1.0) < 0.05
    zero = [k for k, v in kinds.items() if v == "zero_weight"]
    assert zero and all(a[k].abs().max() > 0 for k in zero)
