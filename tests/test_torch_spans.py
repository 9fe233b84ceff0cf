"""The program's spans on the CPU (``utils/profiling.py``): a tiny pipeline
request with a hint and a tiny int8 ``DataParallelServer`` request under
``torch.profiler``. The ``pfd.*`` host spans nest as the layers call each
other, one ``pfd.step`` a sampler step with the UNet's calls inside it,
one ``pfd.quantize`` an activation pass; and no span marker is launched
where the work runs on the CPU. Imports no JAX."""

import numpy as np
import torch

from pfd_tpu_torch.models.build import build_model
from pfd_tpu_torch.ops import flash_attention as fa
from pfd_tpu_torch.ops import quant
from pfd_tpu_torch.parallel.serve import DataParallelServer
from pfd_tpu_torch.pipeline import PromptFreeDiffusionPipeline
from pfd_tpu_torch.utils import profiling
from pfdbench.tests.tiny import MODELS

torch.set_num_threads(2)


def _spans(prof):
    """[(name, start, end, parent)] of the profile's ``pfd.*`` host events,
    each with the innermost other such event that holds it (None)."""
    evs = sorted(((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                  if e.name.startswith(profiling.PREFIX)), key=lambda r: (r[1], -r[2]))
    out = []
    for i, (n, s, e) in enumerate(evs):
        holders = [o for j, o in enumerate(evs) if j != i and o[1] <= s and e <= o[2]
                   and (o[1], -o[2]) < (s, -e)]
        out.append((n, s, e, max(holders, key=lambda o: o[1])[0] if holders else None))
    return out


def _parents(spans, name):
    return [p for n, _, _, p in spans if n == "pfd." + name]


def _profiled(call, monkeypatch):
    marks = []
    monkeypatch.setattr(profiling, "_mark", lambda *a: marks.append(a))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = call()
    assert marks == []
    assert not [e.name for e in prof.events() if e.name.startswith("pfd_span_")]
    return out, _spans(prof)


def test_pipeline_request_spans_nest(monkeypatch):
    """A b1 request with a canny hint, 4 DDIM steps: the facade's host spans
    under ``pfd.request``, SeeCoder under ``pfd.context``, each step's UNet
    under its ``pfd.step`` and each ControlNet call under its UNet, the hint
    pyramid once, before the steps."""
    pipe = PromptFreeDiffusionPipeline(
        fp16=False, with_control=True, config_override=MODELS["pfd_seecoder_with_controlnet"],
        tag_ctl="canny", device="cpu", self_attn_fn=fa.self_attn_fn)
    pipe.ddim_steps = 4
    rng = np.random.default_rng(0)
    ref, hint = rng.random((64, 64, 3), dtype=np.float32), rng.random((64, 64, 3),
                                                                      dtype=np.float32)
    out, spans = _profiled(lambda: pipe.action_inference(ref, hint, "canny", True, 64, 64, 2.0,
                                                         1), monkeypatch)
    assert len(out) == 2 and out[0].shape == (64, 64, 3)
    assert _parents(spans, "request") == [None]
    for name in ("context", "hint", "start_latent", "copy_out", "vae_decode"):
        assert _parents(spans, name) == ["pfd.request"], name
    assert _parents(spans, "seecoder") == ["pfd.context"]
    assert _parents(spans, "step") == ["pfd.request"] * 4
    assert _parents(spans, "unet") == ["pfd.step"] * 4
    assert sorted(_parents(spans, "controlnet")) == ["pfd.request"] + ["pfd.unet"] * 4
    assert not _parents(spans, "quantize") and not _parents(spans, "replay")
    for name in ("clip", "context_image", "context_text"):  # the multi-context walk's alone
        assert not _parents(spans, name), name
    names = [n for n, *_ in spans]
    assert names.index("pfd.hint") < names.index("pfd.step") < names.index("pfd.vae_decode")


def test_int8_server_request_counts_each_quantize_pass(monkeypatch):
    """A b2 int8 request through ``DataParallelServer`` on the turbo phases
    (a key and a reuse step a phase): one ``pfd.step`` a step, every UNet
    part inside a step, and one ``pfd.quantize`` a ``quantize_act`` call,
    inside the UNet or the VAE decode."""
    net = build_model(MODELS["pfd_seecoder"], device="cpu",
                      generator=torch.Generator().manual_seed(0))
    for part in (net.diffuser, net.vae):
        quant.quantize_params(part)
    server = DataParallelServer(net, ["cpu"], steps=4, self_attn_fn=fa.self_attn_fn_int8,
                                phases=[(2, 2), (2, 2)])
    calls = []
    act = quant.quantize_act

    def counted(*a, **k):
        calls.append(1)
        return act(*a, **k)

    monkeypatch.setattr(quant, "quantize_act", counted)
    refs = np.random.default_rng(1).random((2, 64, 64, 3), dtype=np.float32)
    out, spans = _profiled(lambda: server.generate(refs, h=64, w=64, seed=3), monkeypatch)
    assert out.shape == (2, 64, 64, 3)
    assert _parents(spans, "request") == [None]
    assert _parents(spans, "seecoder") == _parents(spans, "vae_decode") == ["pfd.request"]
    assert _parents(spans, "step") == ["pfd.request"] * 4
    # two key steps of three UNet parts, two reuse steps of one
    assert _parents(spans, "unet") == ["pfd.step"] * 8
    q = _parents(spans, "quantize")
    assert len(q) == len(calls) > 0 and set(q) == {"pfd.unet", "pfd.vae_decode"}


def test_dual_guided_request_books_clip_and_each_context_pathway(monkeypatch):
    """A tiny dual-guided request (two steps, a UNet of 7 context blocks):
    both CLIP towers under ``pfd.clip`` in ``pfd.context`` (the reference and
    the prompt, and on the first request the unconditional pair), no
    ``pfd.seecoder``; each step's ``pfd.unet`` holding one
    ``pfd.context_image`` and one ``pfd.context_text`` a context block. A
    single-context request on the same pipeline opens no context span."""
    import copy

    from pfd_tpu_torch.pipeline import clip_prompt
    from pfdbench.tests.tiny_vd import VD

    pipe = PromptFreeDiffusionPipeline(fp16=False, with_control=False, tag_ctx="CLIP",
                                       tag_ctl="none", config_override=copy.deepcopy(VD),
                                       device="cpu", self_attn_fn=fa.self_attn_fn)
    pipe.ddim_steps = 2
    rng = np.random.default_rng(0)
    ref, ids = rng.random((64, 64, 3), dtype=np.float32), clip_prompt(range(10))
    for first in (True, False):
        out, spans = _profiled(lambda: pipe.action_dual_guided(ref, ids, 0.6, 64, 64, 7.5, 1),
                               monkeypatch)
        assert len(out) == 1 and out[0].shape == (64, 64, 3)
        assert _parents(spans, "clip") == ["pfd.context"] * (4 if first else 2)
        assert not _parents(spans, "seecoder")
        assert _parents(spans, "unet") == ["pfd.step"] * 2
        for name in ("context_image", "context_text"):
            assert _parents(spans, name) == ["pfd.unet"] * 14, name
    out, spans = _profiled(lambda: pipe.action_inference(ref, None, "canny", True, 64, 64, 2.0,
                                                         1), monkeypatch)
    assert _parents(spans, "clip") == ["pfd.context"]
    assert _parents(spans, "unet") == ["pfd.step"] * 2
    assert not _parents(spans, "context_image") and not _parents(spans, "context_text")
