"""The port's quality gates (``pfd_tpu_torch/tools/e2e_gate.py``,
``tools/quant_gate.py``, ``training/evaluator.ssim``) against ``pfd_tpu``'s:
the metric, the weights, the draws, the gate's run at a tiny config, the
fan-in init. The slow tests are the CPU half of the gate at full width."""

import importlib
import os
import time

import jax
import numpy as np
import pytest
import torch

from pfd_tpu import registry as jreg
from pfd_tpu.training.evaluator import ssim as jssim
from pfd_tpu_torch.ops import flash_attention as tfa
from pfd_tpu_torch.policy import FP32
from pfd_tpu_torch.tools import e2e_gate, quant_gate
from pfd_tpu_torch.training.evaluator import ssim
from tests import torch_gate_reference as tgr
from tests.test_torch_pipeline import PFD, PFD_CTL, VAE8

torch.set_num_threads(1)

# the tiny sets: an f=8 VAE on both (the hint pyramid is fixed 8x)
TINY = {"plain": {"type": "pfd", "args": dict(PFD["args"], vae_cfg_list=[["image", VAE8]])},
        "control": PFD_CTL}
TINY_SIZE, TINY_STEPS = 128, 4


def _pfd_tpu_quant_gate(monkeypatch):
    """``pfd_tpu``'s quant gate module, without its persistent compile cache."""
    monkeypatch.setenv("PFD_COMPILE_CACHE", "")
    return importlib.import_module("pfd_tpu.tools.quant_gate")


@pytest.mark.parametrize("case", ["random", "identical", "shifted", "2d"])
def test_ssim_matches_pfd_tpu(case):
    torch.set_num_threads(1)
    rng = np.random.default_rng(3)
    a = rng.random((48, 40, 3))
    b = {"random": rng.random((48, 40, 3)), "identical": a.copy(),
         "shifted": np.roll(a, 3, axis=1), "2d": None}[case]
    if case == "2d":
        a, b = a[..., 0], np.clip(a[..., 0] + 0.05 * rng.standard_normal((48, 40)), 0, 1)
    got, want = ssim(a, b, data_range=1.0), jssim(a, b, data_range=1.0)
    assert abs(got - want) <= 1e-12
    if case == "identical":
        assert got == pytest.approx(1.0, abs=1e-12)


def test_reference_weights_round_trip():
    """dict -> pfd_tpu's pytree -> the port's walk back: the same keys and
    arrays; every float parameter of the port (the Swin bias tables too) and
    no buffer; the same dict on a second call, and on any device (numpy)."""
    torch.set_num_threads(1)
    from pfd_tpu.io.convert import torch_sd_to_pytree
    from pfd_tpu_torch.io.convert import pytree_to_torch_sd

    cfg = TINY["control"]
    sd = e2e_gate.reference_weights(cfg)
    assert all(v.dtype == np.float32 for v in sd.values())
    back = pytree_to_torch_sd(torch_sd_to_pytree(sd))
    assert set(back) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k], sd[k], err_msg=k)
    again = e2e_gate.reference_weights(cfg)
    assert list(again) == sorted(sd) and all(np.array_equal(again[k], sd[k]) for k in sd)
    model = e2e_gate.assemble(cfg, e2e_gate.to_device(sd, "cpu"), FP32)
    assert set(dict(model.named_parameters())) == set(sd)
    assert any("relative_position_bias_table" in k for k in sd)
    assert not any(k.endswith(("relative_position_index", "attn_mask")) for k in sd)
    for k, p in model.named_parameters():
        assert np.array_equal(p.numpy(), sd[k]), k
    # the scale and the stream: 0.04 normals, drawn in sorted key order
    first = sorted(sd)[0]
    want = np.random.default_rng(42).standard_normal(sd[first].shape, dtype=np.float32)
    np.testing.assert_array_equal(sd[first], want * np.float32(0.04))


def test_int8_codes_match_pfd_tpu():
    """Quantizing the gate's fp32 weights after loading gives pfd_tpu's int8
    codes and scales bit for bit (diffuser, VAE and ControlNet)."""
    torch.set_num_threads(1)
    from pfd_tpu.io.convert import torch_sd_to_pytree
    from pfd_tpu.ops import quant as jquant
    from pfd_tpu_torch.io.convert import pytree_to_torch_sd

    cfg = TINY["control"]
    sd = e2e_gate.reference_weights(cfg)
    tree = torch_sd_to_pytree(sd)
    want = {}
    for part in ("diffuser", "vae", "ctl"):
        want.update(pytree_to_torch_sd(jquant.quantize_params(tree[part]), prefix=part + "."))
    model = e2e_gate.assemble(cfg, e2e_gate.to_device(sd, "cpu"), e2e_gate.GATE_BF16,
                              quantized=True)
    got = {k: v for k, v in model.state_dict().items() if k.endswith(("weight_q", "weight_scale"))}
    assert got and set(got) == {k for k in want if k.endswith(("weight_q", "weight_scale"))}
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("gate_set", ["plain", "control"])
def test_e2e_draws_match_pfd_tpu(gate_set):
    """pfd_tpu e2e_gate.py's draws (:139-145, :236-243, the eps latent
    :291-300), as it writes them, against the port's, after layout."""
    torch.set_num_threads(1)
    rng = np.random.default_rng(5)
    ref_img = rng.random((1, 512, 512, 3), dtype=np.float32)
    x_start = rng.standard_normal((1, 4, 64, 64)).astype(np.float32).transpose(0, 2, 3, 1)
    got = e2e_gate.inputs(gate_set)
    np.testing.assert_array_equal(got["ref_img"], ref_img)
    np.testing.assert_array_equal(got["x_start"].transpose(0, 2, 3, 1), x_start)
    if gate_set == "control":
        hint = rng.random((1, 3, 512, 512), dtype=np.float32).transpose(0, 2, 3, 1)
        np.testing.assert_array_equal(got["hint"].transpose(0, 2, 3, 1), hint)
    else:
        assert "hint" not in got
    eps_x = np.asarray(jax.numpy.asarray(x_start) + 1e-3 * jax.numpy.asarray(
        np.random.default_rng(11).standard_normal(x_start.shape), jax.numpy.float32))
    np.testing.assert_array_equal(e2e_gate.eps_latent(got["x_start"]).transpose(0, 2, 3, 1),
                                  eps_x)


@pytest.mark.parametrize("n", [1, 8])
def test_quant_gate_draws_match_pfd_tpu(n, monkeypatch):
    """pfd_tpu quant_gate.py's own ``_sample_grid`` with its draws (:154-165,
    control hints :371-390) against the port's, after layout."""
    torch.set_num_threads(1)
    from pfd_tpu import annotators as jann

    jq = _pfd_tpu_quant_gate(monkeypatch)
    for control in (False, True):
        rng, rng2 = np.random.default_rng(5), np.random.default_rng(1005)
        ref, x = jq._sample_grid(
            n,
            lambda: (np.asarray(rng.random((1, 512, 512, 3)), np.float32),
                     np.asarray(rng.standard_normal((1, 64, 64, 4)), np.float32)),
            lambda k: [np.asarray(rng2.random((1, 512, 512, 3)), np.float32)
                       for _ in range(k)],
            lambda k: [np.asarray(rng2.standard_normal((1, 64, 64, 4)), np.float32)
                       for _ in range(k)])
        got = quant_gate.samples(n, control)
        np.testing.assert_array_equal(got["ref_img"], ref)
        np.testing.assert_array_equal(got["x_start"].transpose(0, 2, 3, 1), x)
        if control:
            srcs = [rng.random((512, 512, 3), dtype=np.float32)]
            if n > 1:
                srcs.append(rng2.random((512, 512, 3), dtype=np.float32))
            hints = np.stack([np.asarray(jann.preprocess(h, method="canny", size=(512, 512)))
                              for h in srcs])
            hint = np.repeat(hints, n // len(srcs), axis=0)
            np.testing.assert_array_equal(got["hint"].transpose(0, 2, 3, 1), hint)
            assert 0.01 < (hint[..., 0] > 0).mean() < 0.5
        eps = np.asarray(jax.numpy.asarray(x) + 1e-3 * jax.numpy.asarray(
            np.random.default_rng(11).standard_normal(x.shape), jax.numpy.float32))
        np.testing.assert_array_equal(
            e2e_gate.eps_latent(got["x_start"]).transpose(0, 2, 3, 1), eps)


@pytest.mark.parametrize("gate_set", ["plain", "control"])
def test_gate_run_matches_pfd_tpu(gate_set):
    """The gate's ``run`` (FP32, plain attention) at a tiny config gives
    pfd_tpu's fp32 image of the reference maker's recipe: SSIM >= 0.9999 and
    max-abs 1e-4, and its final latent within 1e-5 relative L2."""
    torch.set_num_threads(1)
    cfg = TINY[gate_set]
    sd = e2e_gate.reference_weights(TINY["control"])
    inp = e2e_gate.inputs(gate_set, size=TINY_SIZE)
    drop = gate_set == "plain"
    _, want, want_lat = tgr.pfd_tpu_run(cfg, tgr.pfd_tpu_params(sd, drop_control=drop), inp,
                                        steps=TINY_STEPS)
    model = e2e_gate.assemble(cfg, e2e_gate.to_device(sd, "cpu", drop_control=drop), FP32)
    got, lat = e2e_gate.run(model, inp, steps=TINY_STEPS)
    assert got.shape == want.shape == (1, TINY_SIZE, TINY_SIZE, 3)
    assert np.isfinite(got).all() and want.std() > 1e-3
    assert ssim(got[0], want[0], data_range=1.0) >= 0.9999
    assert np.abs(got - want).max() <= 1e-4
    assert np.linalg.norm(lat - want_lat) / np.linalg.norm(want_lat) <= 1e-5


def test_fan_in_weights_match_pfd_tpu_init(monkeypatch):
    """The quant gate's weights (numpy draws by the port's copy of the init
    rules, then de-zeroed) against pfd_tpu's ``init(PRNGKey(1))`` +
    ``_dezero`` (quant_gate.py:152), both BF16, for the parts the int8 mode
    quantizes, the diffuser and the ControlNet (pfd_tpu's eager init of the
    tiny SeeCoder and VAE would take another half minute): the same leaves,
    each leaf's standard deviation within 10% (leaves of 1,024 values or
    more), the norms' unit weights equal."""
    torch.set_num_threads(1)
    from pfd_tpu.policy import BF16 as JBF16
    from pfd_tpu_torch.io.convert import pytree_to_torch_sd

    jq = _pfd_tpu_quant_gate(monkeypatch)
    cfg = TINY["control"]
    parts = {"diffuser.image.": cfg["args"]["diffuser_cfg_list"][0][1],
             "ctl.": cfg["args"]["ctl_cfg"]}
    want = {}
    for prefix, part in parts.items():
        jm = jreg.get(part["type"])(**part["args"], policy=JBF16)
        want.update(pytree_to_torch_sd(jq._dezero(jm.init(jax.random.PRNGKey(1))),
                                       prefix=prefix))
    got = {k: p.float().numpy() for k, p in quant_gate.fan_in_model(cfg, "cpu").named_parameters()
           if k.startswith(tuple(parts))}
    assert set(got) == set(want)
    compared = 0
    for k, g in got.items():
        w = np.asarray(want[k], np.float32)
        assert g.shape == w.shape, k
        assert np.any(g), k  # nothing is left at zero
        if w.std() == 0:  # the norms' unit weights
            np.testing.assert_array_equal(g, w, err_msg=k)
        elif g.size >= 1024:
            assert abs(g.std() / w.std() - 1) <= 0.1, (k, g.std(), w.std())
            compared += 1
    assert compared >= 20


@pytest.mark.parametrize("name", ["int8_turbo3_cfg3_deep3", "int8_tome5", "int8_cfg2",
                                  "int8_ph10x2_40x20_kv2", "ctl_int8_turbo2_cfg2"])
def test_unported_rows_fail_with_their_roadmap_items(name, monkeypatch):
    """pfd_tpu's turbo, KV-pool and ToMe rows, once refused by name, are rows
    of both gates now (a composition of them, as int8_ph10x2_40x20_kv2, too):
    ``check_names`` and ``gate_names`` take them, and an unknown row, a row
    of the other set or a precision the set lacks is still refused."""
    torch.set_num_threads(1)
    control = name.startswith("ctl_")
    e2e_valid = e2e_gate.CTL_ROWS if control else e2e_gate.ROWS
    quant_valid = quant_gate.CTL_ROW_NAMES if control else quant_gate.ROW_NAMES
    assert e2e_gate.check_names([name], e2e_valid) == [name]
    assert e2e_gate.check_names([name], quant_valid) == [name]
    monkeypatch.setenv("GATE_ONLY", f"{'ctl_' if control else ''}int8,{name}")
    assert quant_gate.gate_names(quant_valid) == [
        f"{'ctl_' if control else ''}int8", name]
    with pytest.raises(SystemExit, match="unknown row 'fp32_flash'"):
        e2e_gate.check_names(["fp32", "fp32_flash"], e2e_gate.ROWS)
    other = name.removeprefix("ctl_") if control else "ctl_" + name
    with pytest.raises(SystemExit, match="unknown row"):
        e2e_gate.check_names([other], e2e_valid)
    monkeypatch.setenv("GATE_ONLY", "bf16eps,fp32_turbo2")
    with pytest.raises(SystemExit, match="unknown row 'fp32_turbo2'"):
        quant_gate.gate_names()
    monkeypatch.setenv("GATE_ONLY", "bf16eps,int8")
    assert quant_gate.gate_names() == ["bf16eps", "int8"]


def test_quant_rows_are_pfd_tpus(monkeypatch):
    """The quant gate's row names are pfd_tpu's, in both sets."""
    jq = _pfd_tpu_quant_gate(monkeypatch)
    assert quant_gate.ROW_NAMES == jq.ROW_NAMES
    assert quant_gate.CTL_ROW_NAMES == jq.CTL_ROW_NAMES


@pytest.mark.parametrize("name,want", [
    ("int8_turbo2", ("int8", {"encoder_interval": 2})),
    ("int8_cfg3lin", ("int8", {"cfg_interval": 3, "cfg_extrapolate": "linear"})),
    ("int8_turbo3_cfg3lin_deep3", ("int8", {"encoder_interval": 3, "cfg_interval": 3,
                                            "cfg_extrapolate": "linear", "deep_interval": 3})),
    ("bf16_ph10x2_40x20", ("bf16", {"phases": [(10, 2), (40, 20)]})),
    ("int8_ph10x2_40x8lin", ("int8", {"phases": [(10, 2), (40, 8)],
                                      "cfg_extrapolate": "linear"})),
    ("int8_ph5x1_45x5", ("int8", {"phases": [(5, 1), (45, 5)]})),
    ("ctl_int8_ph10x2_40x20_kv2", ("int8", {"phases": [(10, 2), (40, 20)], "kv": 2})),
    ("int8_ph8x2_42x21_kv4", ("int8", {"phases": [(8, 2), (42, 21)], "kv": 4})),
    ("int8_tome3", ("int8", {"tome": 0.25})),
    ("int8_tome5_turbo2_cfg2", ("int8", {"tome": 0.5, "encoder_interval": 2,
                                         "cfg_interval": 2})),
    ("fp32_ph8x2_42x21", ("fp32", {"phases": [(8, 2), (42, 21)]})),
])
def test_row_recipes_are_pfd_tpus_definitions(name, want, monkeypatch):
    """A row's name gives pfd_tpu's definition of it (e2e_gate.py:284-383,
    quant_gate.py:219-350): the precision, the sampler's turbo arguments, the
    KV pool's p x p cells on the 64x64 grid around K1/K2's ``self_attn_fn``,
    ToMe's ratio around it."""
    torch.set_num_threads(1)
    made = {}
    monkeypatch.setattr(e2e_gate, "make_kvpool_attn", lambda inner, grid, pool: made.update(
        kv=(inner, grid, pool)) or "kv")
    monkeypatch.setattr(e2e_gate, "make_tome_attn", lambda inner, grid, ratio: made.update(
        tome=(inner, grid, ratio)) or "tome")
    prec, attn, turbo = e2e_gate.row_recipe(name)
    exp = dict(want[1])
    kv, tome = exp.pop("kv", None), exp.pop("tome", None)
    assert prec == want[0]
    assert attn == ("tome" if tome else None if prec == "fp32" else tfa.self_attn_fn)
    if kv:
        exp["reuse_self_attn_fn"] = "kv"
        assert made["kv"] == (tfa.self_attn_fn, (64, 64), kv)
    if tome:
        assert made["tome"] == (tfa.self_attn_fn, (64, 64), tome)
    assert turbo == exp
    with pytest.raises(ValueError):
        e2e_gate.row_recipe(name + "_warp9")


@pytest.mark.parametrize("gate_set", ["plain", "control"])
def test_gate_turbo_run_matches_pfd_tpu(gate_set):
    """The gate's ``run`` under a phased schedule (an exact head, then one
    group of the full composition) at the tiny config, FP32: pfd_tpu's fp32
    image of the turbo reference maker's recipe within max-abs 1e-4, its
    final latent within 1e-5 relative L2."""
    torch.set_num_threads(1)
    cfg = TINY[gate_set]
    sd = e2e_gate.reference_weights(TINY["control"])
    inp = e2e_gate.inputs(gate_set, size=TINY_SIZE)
    drop = gate_set == "plain"
    phases = [(1, 1), (3, 3)]
    _, want, want_lat = tgr.pfd_tpu_run(cfg, tgr.pfd_tpu_params(sd, drop_control=drop), inp,
                                        steps=TINY_STEPS, phases=phases)
    model = e2e_gate.assemble(cfg, e2e_gate.to_device(sd, "cpu", drop_control=drop), FP32)
    got, lat = e2e_gate.run(model, inp, steps=TINY_STEPS, phases=phases)
    exact, exact_lat = e2e_gate.run(model, inp, steps=TINY_STEPS)
    assert np.isfinite(got).all() and want.std() > 1e-3
    assert np.abs(got - want).max() <= 1e-4
    assert np.linalg.norm(lat - want_lat) / np.linalg.norm(want_lat) <= 1e-5
    # the schedule moves the latent further than the limit
    assert np.linalg.norm(lat - exact_lat) / np.linalg.norm(exact_lat) > 1e-5


def test_turbo_reference_file():
    """The committed turbo reference: both sets' images and latents, made by
    tests/torch_gate_reference.py --turbo under ``TURBO_PHASES``, small."""
    ref = e2e_gate.load_reference()["turbo"]
    assert os.path.getsize(e2e_gate.TURBO_REF_PATH) < 3e6
    assert ref["recipe"]["sampler"]["phases"] == {
        k: [list(p) for p in v] for k, v in e2e_gate.TURBO_PHASES.items()}
    for tag in ("plain", "control"):
        assert ref[f"img_{tag}"].shape == (1, 512, 512, 3)
        assert ref[f"latent_{tag}"].shape == (1, 4, 64, 64)
        assert np.isfinite(ref[f"latent_{tag}"]).all()


# ---- full width on the CPU (-m slow): the CPU half of the gate ------------

@pytest.fixture(scope="module")
def full_weights():
    return e2e_gate.reference_weights()


def _timed(label, t0):
    print(f"{label}: {time.perf_counter() - t0:.1f} s", flush=True)


@pytest.mark.slow
def test_reference_file_regenerates(tmp_path):
    """tests/torch_gate_reference.py made the committed file: a fresh run
    gives the images within one uint8 level and the latents within 1e-5
    relative L2."""
    t0 = time.perf_counter()
    new = tgr.make(str(tmp_path / "ref.npz"))
    with np.load(e2e_gate.REF_PATH) as old:
        assert os.path.getsize(e2e_gate.REF_PATH) < 3e6
        for tag in ("plain", "control"):
            d = np.abs(new[f"img_{tag}"].astype(int) - old[f"img_{tag}"].astype(int))
            assert d.max() <= 1, tag
            lo = old[f"latent_{tag}"]
            assert np.linalg.norm(new[f"latent_{tag}"] - lo) / np.linalg.norm(lo) <= 1e-5
        assert np.abs(new["tokens"].astype(np.float32) - old["tokens"].astype(np.float32)
                      ).max() <= 1e-3
    _timed("reference regeneration", t0)


@pytest.mark.slow
def test_fullsize_unet_eps_matches_pfd_tpu(full_weights):
    """One UNet call at SD-1.5 widths (b2 with CFG's zero context, 64x64
    latent, t = 501), port FP32 against pfd_tpu fp32 on the gate's weights."""
    import jax.numpy as jnp

    t0 = time.perf_counter()
    torch.set_num_threads(os.cpu_count() or 1)
    cfg = e2e_gate.gate_config(e2e_gate.PLAIN)
    inp = e2e_gate.inputs("plain")
    rng = np.random.default_rng(7)
    x = np.concatenate([inp["x_start"]] * 2)
    c = (rng.standard_normal((1, 148, 768)) * 0.5).astype(np.float32)
    c = np.concatenate([np.zeros_like(c), c])
    t = np.array([501, 501])
    params = tgr.pfd_tpu_params(full_weights, drop_control=True)
    jm = jreg.get(cfg["type"])(**cfg["args"])
    eps = jax.jit(lambda p, xx, tt, cc: jm.apply_model(p, {"type": "image", "x": xx}, tt,
                                                       {"type": "image", "c": cc}))
    want = np.asarray(eps(params, jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.asarray(t),
                          jnp.asarray(c))).transpose(0, 3, 1, 2)
    del params
    model = e2e_gate.assemble(cfg, e2e_gate.to_device(full_weights, "cpu", drop_control=True),
                              FP32)
    with torch.no_grad():
        got = model.apply_model({"type": "image", "x": torch.from_numpy(x)},
                                torch.from_numpy(t), {"type": "image",
                                                      "c": torch.from_numpy(c)}).numpy()
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    print(f"unet eps rel_l2 {rel:.3e}, max_abs {np.abs(got - want).max():.3e}")
    _timed("fullsize unet eps", t0)
    assert np.isfinite(got).all() and rel <= 1e-4


@pytest.mark.slow
def test_fullsize_seecoder_tokens_match_pfd_tpu(full_weights):
    """SeeCoder at full width, (1, 148, 768) tokens of the gate's reference
    image, port FP32 against pfd_tpu fp32."""
    t0 = time.perf_counter()
    torch.set_num_threads(os.cpu_count() or 1)
    cfg = e2e_gate.gate_config(e2e_gate.PLAIN)
    inp = e2e_gate.inputs("plain")
    params = tgr.pfd_tpu_params(full_weights, drop_control=True)
    jm = jreg.get(cfg["type"])(**cfg["args"])
    want = np.asarray(jax.jit(jm.ctx_encode)(params, jax.numpy.asarray(inp["ref_img"])))
    del params
    model = e2e_gate.assemble(cfg, e2e_gate.to_device(full_weights, "cpu", drop_control=True),
                              FP32)
    with torch.no_grad():
        got = model.ctx_encode(torch.from_numpy(inp["ref_img"]).permute(0, 3, 1, 2)).numpy()
    err = np.abs(got - want).max()
    print(f"seecoder tokens max_abs {err:.3e} (max |tokens| {np.abs(want).max():.3e})")
    _timed("fullsize seecoder tokens", t0)
    assert got.shape == want.shape == (1, 148, 768)
    assert err <= 1e-4 * max(1.0, np.abs(want).max())


@pytest.mark.slow
def test_fullsize_bf16_vae_decode_matches_pfd_tpu_bf16(full_weights):
    """Where the bf16 rows' 8-bit SSIM goes: pfd_tpu's own fp32 final latent
    (the reference's) decoded by the port's bf16 VAE and by pfd_tpu's bf16
    VAE on the CPU scores the same against pfd_tpu's fp32 image, within
    1e-3; the two fp32 VAEs reproduce the image."""
    import jax.numpy as jnp
    from pfd_tpu.io.convert import torch_sd_to_pytree
    from pfd_tpu.policy import BF16 as JBF16, FP32 as JFP32
    from pfd_tpu_torch import registry as treg

    t0 = time.perf_counter()
    torch.set_num_threads(os.cpu_count() or 1)
    ref = e2e_gate.load_reference()
    vae = e2e_gate.gate_config(e2e_gate.PLAIN)["args"]["vae_cfg_list"][0][1]
    sd = {k[len("vae.image."):]: v for k, v in full_weights.items() if k.startswith("vae.image.")}
    z = ref["latent_plain"] / np.float32(0.18215)

    def port(policy):
        with torch.device("meta"):
            m = treg.get(vae["type"])(**vae["args"], policy=policy)
        m.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, assign=True)
        with torch.no_grad():
            return m.decode(torch.from_numpy(z)).permute(0, 2, 3, 1).float().numpy()[0]

    def pfd_tpu(policy):
        m = jreg.get(vae["type"])(**vae["args"], policy=policy)
        img = jax.jit(m.decode)(torch_sd_to_pytree(sd), jnp.asarray(z.transpose(0, 2, 3, 1)))
        return np.asarray(img, np.float32)[0]

    got = {"port_fp32": port(FP32), "port_bf16": port(e2e_gate.GATE_BF16),
           "pfd_tpu_fp32": pfd_tpu(JFP32), "pfd_tpu_bf16": pfd_tpu(JBF16)}
    scores = {k: e2e_gate.score(v, ref["img_plain"][0]) for k, v in got.items()}
    print(f"vae decode of pfd_tpu's latent, 8-bit ssim vs its fp32 image: {scores}; the port's "
          f"fp32 image in float vs the 8-bit reference: "
          f"{e2e_gate._ssim(got['port_fp32'], ref['img_plain'][0])}")
    _timed("fullsize vae decode", t0)
    assert scores["port_fp32"] >= 0.9999 and scores["pfd_tpu_fp32"] >= 0.9999
    assert abs(scores["port_bf16"] - scores["pfd_tpu_bf16"]) <= 1e-3


@pytest.mark.slow
@pytest.mark.parametrize("gate_set", ["plain", "control"])
def test_fullsize_port_fp32_cpu_matches_reference(gate_set, full_weights):
    """The gate's fp32 row on the CPU at full width against the committed
    reference: SSIM >= 0.9999."""
    t0 = time.perf_counter()
    torch.set_num_threads(os.cpu_count() or 1)
    ref = e2e_gate.load_reference()
    control = gate_set == "control"
    cfg = e2e_gate.gate_config(e2e_gate.FULL if control else e2e_gate.PLAIN)
    model = e2e_gate.assemble(cfg, e2e_gate.to_device(full_weights, "cpu",
                                                      drop_control=not control), FP32)
    img, lat = e2e_gate.run(model, e2e_gate.inputs(gate_set))
    s = e2e_gate.score(img[0], ref[f"img_{gate_set}"][0])
    rel = np.linalg.norm(lat - ref[f"latent_{gate_set}"]) / np.linalg.norm(
        ref[f"latent_{gate_set}"])
    print(f"{gate_set}: ssim {s:.6f}, latent rel_l2 {rel:.3e}")
    _timed(f"fullsize port fp32 {gate_set}", t0)
    assert np.isfinite(img).all() and s >= 0.9999


@pytest.mark.slow
@pytest.mark.parametrize("gate_set", ["plain", "control"])
def test_fullsize_port_fp32_turbo_cpu_matches_turbo_reference(gate_set, full_weights):
    """The gate's fp32 turbo row on the CPU at full width (``TURBO_PHASES``:
    [(8, 2), (42, 21)] plain, [(10, 2), (40, 20)] with the hint) against
    pfd_tpu's fp32 run of the same schedule: SSIM >= 0.999 and latent
    relative L2 <= 1e-5, the limits of the exact fp32 row; and further from
    the exact reference than that."""
    t0 = time.perf_counter()
    torch.set_num_threads(os.cpu_count() or 1)
    ref = e2e_gate.load_reference()
    control = gate_set == "control"
    cfg = e2e_gate.gate_config(e2e_gate.FULL if control else e2e_gate.PLAIN)
    model = e2e_gate.assemble(cfg, e2e_gate.to_device(full_weights, "cpu",
                                                      drop_control=not control), FP32)
    phases = [tuple(p) for p in e2e_gate.TURBO_PHASES[gate_set]]
    img, lat = e2e_gate.run(model, e2e_gate.inputs(gate_set), phases=phases)
    want = ref["turbo"][f"latent_{gate_set}"]
    s = e2e_gate.score(img[0], ref["turbo"][f"img_{gate_set}"][0])
    rel = np.linalg.norm(lat - want) / np.linalg.norm(want)
    exact = ref[f"latent_{gate_set}"]
    print(f"{gate_set} turbo: ssim {s:.6f}, latent rel_l2 {rel:.3e} (vs exact "
          f"{np.linalg.norm(lat - exact) / np.linalg.norm(exact):.3e})")
    _timed(f"fullsize port fp32 turbo {gate_set}", t0)
    assert np.isfinite(img).all() and s >= 0.999 and rel <= 1e-5
    assert np.linalg.norm(lat - exact) / np.linalg.norm(exact) > 1e-4
