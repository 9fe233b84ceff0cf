"""The compiled hot path (``pfd_tpu_torch/ops/graphs.py`` and the buckets of
the pipeline and the servers) against ``pfd_tpu``'s jitted programs, on a
tiny ``pfd_with_control`` in fp32 on the CPU, where a bucket runs eagerly.

- The port's ``warmup`` returns ``pfd_tpu``'s list of bucket keys.
- A ``_sample_decode_fn`` bucket gives ``pfd_tpu``'s image from the same
  weights, reference and start latent (drawn as ``pfd_tpu``'s program draws
  it) at two guidance scales through one bucket, with and without a hint
  (relative L2 at most 1e-5, the hot-swap test's limit).
- The guidance scale as a 0-d fp32 tensor gives the Python float's numbers
  bit for bit, and pre-drawn eta noise gives the loop's own draws.
- An int8 ``load_state_dict`` keeps every tensor where it was (a captured
  graph reads those addresses), the upsample phase kernels a fresh
  quantize of the new codes.
- ToMe's cached index tensors give ``pfd_tpu``'s merge.
- A replay adds the launches its capture counted (on stand-in counters);
  the serving path's counters are ``graphs.counters()``' by name, and
  ``chip_smoke.py`` names the port's kernels in a profile by those counters.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfd_tpu.ops import tome as jtome
from pfd_tpu_torch.io.convert import params_from_jax
from pfd_tpu_torch.models.build import build_model
from pfd_tpu_torch.ops import graphs, quant
from pfd_tpu_torch.ops import tome as ttome
from tests.test_pipeline_hotswap import TINY_PFD
from tests.test_torch_hotswap import _pipes

torch.set_num_threads(1)

H = W = 64
STEPS = 2
SEED = 3


@pytest.fixture(scope="module")
def pipes(tmp_path_factory):
    """Both pipelines on the tiny config (no checkpoint files: pfd_tpu's
    numpy weights), the port holding pfd_tpu's weights."""
    jp, tp = _pipes(str(tmp_path_factory.mktemp("no_zoo")))
    tp.net.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jp.params)), strict=True)
    jp.ddim_steps = tp.ddim_steps = STEPS
    return jp, tp


def test_warmup_returns_pfd_tpus_buckets(pipes):
    jp, tp = pipes
    for kw in ({}, {"sizes": ((64, 64), (64, 128)), "batch": 2, "with_control": False},
               {"sizes": ((128, 64),), "steps": 4}):
        assert tp.warmup(**kw) == jp.warmup(**kw)
    assert all(len(k) == 6 for k in tp.warmup())


def _hint(seed):
    rng = np.random.default_rng(seed)
    hint = np.zeros((H, W, 3), np.float32)
    hint[12:44, 16:52] = 1.0
    return hint + 0.05 * rng.random((H, W, 3), dtype=np.float32)


@pytest.mark.parametrize("has_control", [False, True])
def test_bucket_matches_pfd_tpu_at_two_scales(pipes, has_control):
    """One bucket of each side serves guidance 2.0 and 3.7: the port's image
    is pfd_tpu's within relative L2 1e-5 at both, and the port holds one
    bucket for them."""
    jp, tp = pipes
    ref = np.random.default_rng(0).random((H, W, 3), dtype=np.float32)
    hint = _hint(1) if has_control else None
    _, init_rng = jax.random.split(jax.random.PRNGKey(SEED))
    x = np.asarray(jax.random.normal(init_rng, (1, H // 8, W // 8, 4), jnp.float32))
    cj = jp._ctx_encode_jit(jp.params, jnp.asarray(ref)[None])
    jfn = jp._sample_decode_fn(H, W, 1, has_control, STEPS, 0.0)
    c = tp.context_graph()(tp.reference(ref))
    n_buckets = len(tp._graphs)
    tfn = tp._sample_decode_fn(H, W, 1, has_control, STEPS, 0.0)
    control = None if hint is None else torch.from_numpy(hint.transpose(2, 0, 1)[None].copy())
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    images = []
    for scale in (2.0, 3.7):
        want = np.asarray(jfn(jp.params, jax.random.PRNGKey(SEED), cj, jnp.zeros_like(cj),
                              jnp.float32(scale), None if hint is None else jnp.asarray(hint)[None]))
        got = tfn(c, torch.zeros_like(c), xt, scale, control, None)[0].permute(1, 2, 0).numpy()
        assert want.std() > 0.02  # the image depends on the weights
        rel = np.linalg.norm(got - want[0]) / np.linalg.norm(want[0])
        assert rel <= 1e-5, (scale, rel)
        images.append(got)
    assert not np.array_equal(*images)
    assert len(tp._graphs) == n_buckets + 1  # one new bucket served both scales
    assert tp._sample_decode_fn(H, W, 1, has_control, STEPS, 0.0) is tfn


@pytest.mark.parametrize("mode", ["exact", "cfg_reuse", "no_cfg"])
def test_scale_tensor_equals_the_float(pipes, mode):
    """Guidance 1.7 (not exact in fp32; ``scale - 1`` rounds) as a Python
    float and as a 0-d fp32 tensor: the same latent bit for bit, in the
    exact loop, on CFG-delta reuse steps (which take ``scale - 1``) and in
    the no-unconditional quirk."""
    _, tp = pipes
    rng = np.random.default_rng(4)
    c = torch.from_numpy(rng.standard_normal((1, 4, 768)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((1, 4, H // 8, W // 8)).astype(np.float32))
    tables = tp.sampler.make_tables(4)
    kw = {"cfg_interval": 2} if mode == "cfg_reuse" else {}
    lat = []
    for scale in (1.7, torch.tensor(1.7, dtype=torch.float32)):
        ci = {"conditioning": c, "unconditional_guidance_scale": scale,
              "unconditional_conditioning": None if mode == "no_cfg" else torch.zeros_like(c)}
        with torch.no_grad():
            lat.append(tp.sampler.sample_fn(x, ci, tables, **kw)[0])
    assert torch.equal(*lat)


def test_eta_noise_equals_the_loops_draws(pipes):
    """eta > 0: the loop's per-step draws from a generator, and the same
    draws made ahead (``DDIMSampler.eta_noise``) from a generator in the
    same state, give one latent bit for bit."""
    _, tp = pipes
    rng = np.random.default_rng(5)
    c = torch.from_numpy(rng.standard_normal((1, 4, 768)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((1, 4, H // 8, W // 8)).astype(np.float32))
    tables = tp.sampler.make_tables(4, eta=0.5)
    ci = {"conditioning": c, "unconditional_conditioning": torch.zeros_like(c),
          "unconditional_guidance_scale": 2.0}
    with torch.no_grad():
        drawn = tp.sampler.sample_fn(x, ci, tables, generator=torch.Generator().manual_seed(9))[0]
        noise = tp.sampler.eta_noise(4, 0.5, x.shape, torch.Generator().manual_seed(9))
        assert noise.shape == (4, *x.shape) and tp.sampler.eta_noise(4, 0.0, x.shape) is None
        ahead = tp.sampler.sample_fn(x, ci, tables, eta_noise=noise)[0]
        none = tp.sampler.sample_fn(x, ci, tables, eta_noise=torch.zeros_like(noise))[0]
    assert torch.equal(drawn, ahead) and not torch.equal(drawn, none)


def test_int8_load_keeps_every_address():
    """An int8 model loads another float state dict (quantized again):
    every parameter and buffer, the non-persistent phase kernels too, keeps
    its data_ptr, the codes are a fresh quantize of the loaded weights and
    the phase kernels a fresh quantize of the new codes."""
    net = build_model(TINY_PFD, device="cpu")
    quant.quantize_params(net.diffuser)
    mod = net.diffuser
    ups = {n: m for n, m in mod.named_modules() if "phase_q" in m._buffers}
    assert ups
    ptrs = {n: t.data_ptr() for n, t in [*mod.named_parameters(), *mod.named_buffers()]}
    before = {n: m.phase_q.clone() for n, m in ups.items()}
    sd = build_model(TINY_PFD, device="cpu", generator=np.random.default_rng(1)).diffuser.state_dict()
    mod.load_state_dict(quant.quantize_state_dict(mod, sd), strict=True)
    assert {n: t.data_ptr() for n, t in [*mod.named_parameters(), *mod.named_buffers()]} == ptrs
    for n, m in ups.items():
        q, s = quant.quantize_weight(sd[f"{n}.weight"])
        assert torch.equal(m.weight_q, q) and torch.equal(m.weight_scale, s), n
        pq, ps = quant.quantize_weight(quant.phase_kernel(m.weight_q.float()
                                                          * m.weight_scale[:, None, None, None]))
        assert torch.equal(m.phase_q, pq) and torch.equal(m.phase_scale, ps), n
        assert m.phase_q.is_contiguous(memory_format=torch.channels_last)
        assert not torch.equal(m.phase_q, before[n]), n


def test_tome_cached_indices_give_pfd_tpus_merge(monkeypatch):
    """The src/dst index tensors are copied to the device once per grid:
    a second merge on the grid copies nothing from the host, and both give
    pfd_tpu's merge and unmerge."""
    rng = np.random.default_rng(2)
    metric = rng.standard_normal((2, 64, 16)).astype(np.float32)
    x = rng.standard_normal((2, 64, 10)).astype(np.float32)
    jm, ju = jtome.compute_merge(jnp.asarray(metric), 8, 8, 24)
    want_m = np.asarray(jm(jnp.asarray(x)))
    want_u = np.asarray(ju(jm(jnp.asarray(x))))
    first = ttome._partition_indices(8, 8, 2, 2, 0, 0, torch.device("cpu"))
    copies = []
    as_tensor = torch.as_tensor
    monkeypatch.setattr(torch, "as_tensor", lambda *a, **k: copies.append(a) or as_tensor(*a, **k))
    for _ in range(2):
        tm_, tu = ttome.compute_merge(torch.from_numpy(metric), 8, 8, 24)
        got_m = tm_(torch.from_numpy(x))
        np.testing.assert_allclose(got_m.numpy(), want_m, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(tu(got_m).numpy(), want_u, rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(tm_.sizes.numpy(), np.asarray(jm.sizes))
    assert copies == []
    assert ttome._partition_indices(8, 8, 2, 2, 0, 0, torch.device("cpu")) is first


def test_replay_adds_the_captured_launches(monkeypatch):
    """A capture counts launches it does not make: ``take_launches`` hands
    them back and restores the counts, and each replay adds them."""
    assert set(graphs.counters()) == {"flash_attention", "flash_attention_pipe",
                                      "cross_attention", "flash_attention_pv8",
                                      "flash_attention_int8", "conv_int8", "conv3x3_bf16",
                                      "matmul_int8"}
    wrappers = {"k1": types.SimpleNamespace(launches=5), "conv": types.SimpleNamespace(launches=0)}
    monkeypatch.setattr(graphs, "counters", lambda: wrappers)
    before = graphs.launch_counts()
    wrappers["k1"].launches += 3  # what a capture's run counts
    wrappers["conv"].launches += 7
    delta = graphs.take_launches(before)
    assert delta == {"k1": 3, "conv": 7} and graphs.launch_counts() == before
    for _ in range(4):
        graphs.add_launches(delta)
    assert graphs.launch_counts() == {"k1": 5 + 4 * 3, "conv": 4 * 7}


def test_serving_counters_are_graphs_counters():
    """``flash_attention.launches()`` reads ``graphs.counters()``' serving
    wrappers by name; a pool measures its captures only when asked."""
    from pfd_tpu_torch.ops import flash_attention as fa

    assert set(fa.SERVING) < set(graphs.counters())
    assert fa.launches() == {k: v for k, v in graphs.launch_counts().items()
                             if k in fa.SERVING}
    assert not graphs.GraphPool("cpu").measure


def test_smoke_counts_kernels_by_name():
    """``chip_smoke.kernel_counts`` names each of the port's kernels in a
    profile by the counter its wrapper keeps (K1-K5 by their template
    arguments) and leaves out PyTorch's own."""
    import chip_smoke

    rows = [("void pfd::sm90::flash_sm90_kernel<1, 2, false, false, 1, false, false>(CUt", 250),
            ("void pfd::sm90::flash_sm90_kernel<2, 1, false, true, 2, false, false>(CUt", 100),
            ("void pfd::sm90::flash_sm90_kernel<1, 2, false, false, 1, true, false>(CUt", 7),
            ("void pfd::sm90::flash_sm90_kernel<1, 2, false, false, 1, true, true>(CUt", 3),
            ("void pfd::sm90::flash_sm90_kernel<1, 2, true, false, 1, false, false>(CUt", 2),
            ("void (anonymous namespace)::conv_int8_kernel<160>(CUtensorMap_st", 9),
            ("void (anonymous namespace)::conv3x3_kernel<128, 2>(CUtensorMap_st", 4),
            ("void (anonymous namespace)::matmul_int8_kernel<160>(CUtensorMap_st", 5),
            ("void at::native::elementwise_kernel<128, 4>(int)", 99)]
    events = [types.SimpleNamespace(key=k, count=n) for k, n in rows]
    assert chip_smoke.kernel_counts(events) == {
        "flash_attention": 250, "cross_attention": 100, "flash_attention_pv8": 7,
        "flash_attention_int8": 3, "flash_attention_pipe": 2, "conv_int8": 9,
        "conv3x3_bf16": 4, "matmul_int8": 5}
    assert set(chip_smoke.kernel_counts(events)) == set(graphs.counters())


def test_graphed_runs_eagerly_on_the_cpu():
    """On the CPU a call runs the function with its numbers as 0-d fp32
    tensors, and a capture does nothing."""
    seen = []
    fn = graphs.Graphed(lambda a, s, n: seen.append((s, n)) or a * s,
                        graphs.GraphPool("cpu"))
    assert fn.capture(torch.ones(2), 1.5, None) is None and not seen
    out = fn(torch.ones(2), 1.5, None)
    (s, n), = seen
    assert s.dtype == torch.float32 and s.ndim == 0 and n is None
    assert torch.equal(out, torch.full((2,), 1.5)) and fn.stats == []


def test_knob_change_and_pa_swap_drop_graphs(pipes):
    """A changed turbo knob drops the buckets (their graphs bake it in); a
    SeeCoder-PA swap rebuilds the encoder and its graph, a diffuser swap
    keeps both."""
    _, tp = pipes
    fn = tp._sample_decode_fn(H, W, 1, False, STEPS, 0.0)
    ctx = tp.context_graph()
    assert tp._sample_decode_fn(H, W, 1, False, STEPS, 0.0) is fn
    tp.action_load_diffuser("Deliberate-v2.0")
    assert tp.context_graph() is ctx and tp._sample_decode_fn(H, W, 1, False, STEPS, 0.0) is fn
    tp.cfg_interval = 2
    try:
        assert tp._sample_decode_fn(H, W, 1, False, STEPS, 0.0) is not fn
        assert list(tp._graphs) == [(H, W, 1, False, STEPS, 0.0)]
    finally:
        tp.cfg_interval = 1
    tp.action_load_ctx("SeeCoder-PA")
    try:
        assert tp.context_graph() is not ctx
    finally:
        tp.action_load_ctx("SeeCoder")
