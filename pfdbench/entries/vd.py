"""Versatile Diffusion's dual-guided image generation through the facade a
WebUI or ``serve.py`` request goes through:
``PromptFreeDiffusionPipeline(config_override=<vd_four_flow>)
.action_dual_guided(reference, prompt ids, ratio, ...)``, with
``n_sample_image`` the batch (``serving.py``: the weights, the check's
arithmetic).

A request is one reference image of the seeded pool, one prompt and one
start-latent seed, all drawn from ``numpy.random.default_rng([seed, i])``:
the prompt is ``prompt_tokens`` (low, high) token ids below CLIP's BOS,
between BOS and EOS and padded with EOS to the text tower's length. The
call returns the batch's images as a float32 (n, size, size, 3) array.

The check: the reference (``pfdbench.reference.vd``, float32, TF32 off)
recomputes a sample of the finished requests drawn from the seed, from the
same weights and inputs; ``image_err`` is the largest. With fan-in random
weights the contexts move each step's eps by about a hundredth, no more
than bfloat16's own error, so the images barely see a wrong context. The
check therefore also reads the contexts where they enter the UNet: before
the program is dropped, its first step on the checked images (the
facade's contexts, as the requests take them, through one CFG-doubled
``apply_model_multicontext``), every context block's cross-attention
(query input and output); ``cross_attention_err`` is the largest
||output - reference|| / ||reference|| of a request, the reference's
module of that name on the same query input over the reference's own
contexts.

``sound(cell, seeds, fault)`` reads the program against the reference on
many seeds in one process (the weights of each seed loaded into the same
pipeline, whose graphs stay valid): the sound readings a limit is set
from, beside ``control``'s; with one of ``FAULTS`` planted, the readings
the check must refuse.

    python3 -m pfdbench.entries.vd --workload <cell> --seeds 1,2,3 [--fault <name>]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from pfdbench import entries, traffic as traffic_lib, weights, work
from pfdbench.entries import serving
from pfdbench.reference.model import ddim_rows
from pfdbench.reference.vd import BOS, EOS

CONTROL = "fp8"


def prompt(rng, traffic, length):
    """A prompt's ids drawn from ``rng``: BOS, ``prompt_tokens`` token ids,
    EOS, EOS padding to ``length``."""
    lo, hi = traffic["prompt_tokens"]
    n = int(rng.integers(lo, hi + 1))
    tokens = rng.integers(0, BOS, size=n)
    return np.concatenate([[BOS], tokens, [EOS] * (length - 1 - n)]).astype(np.int64)


def request(seed, i, traffic, length):
    """Request i of a run: {"ref": pool index, "ids": prompt ids, "seed":
    the start latent's seed}."""
    rng = np.random.default_rng([int(seed), int(i)])
    ref = int(rng.integers(traffic_lib.POOL))
    ids = prompt(rng, traffic, length)
    return {"ref": ref, "ids": ids, "seed": int(rng.integers(0, 2 ** 31 - 1))}


def warmup_request(traffic, length):
    """The set-up's request: pool entry 0, a prompt from a fixed draw, seed 0."""
    return {"ref": 0, "ids": prompt(np.random.default_rng(1 << 21), traffic, length), "seed": 0}


def text_length(cfg):
    return dict(cfg["args"]["ctx_cfg_list"])["text"]["args"]["max_length"]


def image_tokens(cfg):
    a = dict(cfg["args"]["ctx_cfg_list"])["image"]["args"]
    return (a["image_size"] // a["patch"]) ** 2 + 1


def clip_flops(cfg):
    """(FLOPs of the image tower on one image, of the text tower on one
    prompt): convs and matmuls, 2 a multiply-add."""
    ctx = dict(cfg["args"]["ctx_cfg_list"])
    a = ctx["image"]["args"]
    hid, inter, patch, s = a["hidden"], a["intermediate"], a["patch"], image_tokens(cfg)
    layer = 8 * s * hid * hid + 4 * s * hid * inter + 4 * s * s * hid
    img = (work.conv(1, 3, hid, a["image_size"] // patch, a["image_size"] // patch, patch)
           + a["layers"] * layer + work.linear(s, hid, a["projection_dim"]))
    t = ctx["text"]["args"]
    hid, inter, s = t["hidden"], t["intermediate"], t["max_length"]
    layer = 8 * s * hid * hid + 4 * s * hid * inter + 4 * s * s * hid
    txt = t["layers"] * layer + work.linear(s + 1, hid, t["projection_dim"])
    return float(img), float(txt)


def text_context_channels(args):
    """The channels of ``openai_unet_0d_next``'s context blocks in walk order
    (input levels, the middle, output levels)."""
    mc, mult, nrb, attn = (args["model_channels"], args["channel_mult"],
                           args["num_noattn_blocks"], args["with_attn"])
    out = [mc * m for lv, m in enumerate(mult) if attn[lv] for _ in range(nrb[lv])]
    out.append(mc * mult[-1])
    out += [mc * m for lv, m in reversed(list(enumerate(mult))) if attn[lv]
            for _ in range(nrb[lv] + 1)]
    return out


def dual_unet(cfg, size):
    """(the image UNet's ``UNetWork`` over the CLIP-image context, its
    transformer blocks, the text pathway's FLOPs a sample and call): the
    text UNet's context blocks run on the image walk's maps, block for
    block, over the CLIP-text context."""
    dif = dict(cfg["args"]["diffuser_cfg_list"])
    lat = size // 8
    u = work.UNetWork(dif["image"]["args"], lat, lat, image_tokens(cfg))
    blocks = [b for b in u.full_blocks if b[0] == "attn"]
    targs = dif["text"]["args"]
    if [b[1] for b in blocks] != text_context_channels(targs):
        raise ValueError("the text UNet's context blocks do not pair with the image UNet's")
    txt = sum(work._transformer(ch, h, w, text_length(cfg), targs["context_dim"], heads)
              for _, ch, heads, h, w in blocks)
    return u, blocks, txt


def request_flops(cfg, traffic):
    """Model FLOPs of one request: the UNet's two pathways on every step's
    CFG-doubled batch, the VAE decode of each latent, the CLIP towers on
    the request's reference and prompt (the unconditional pair is computed
    once a shape, not a request)."""
    n, size, steps = traffic["batch"], traffic["size"], traffic["steps"]
    u, _, txt = dual_unet(cfg, size)
    lat = size // 8
    vae = work.vae_decoder_work(dict(cfg["args"]["vae_cfg_list"])["image"]["args"], lat, lat)[0]
    return n * steps * 2 * (u.full_flops + txt) + n * vae + sum(clip_flops(cfg))


def kernel_work(cfg, traffic):
    """[work.Call] of one request: on every step each long transformer block
    of both pathways at the CFG-doubled batch (the self-attention kernel
    and the cross-attention kernel, over 257 and 77 keys), the VAE's
    mid-block attention once."""
    n, size = traffic["batch"], traffic["size"]
    u, blocks, _ = dual_unet(cfg, size)
    step = (work._attn_calls(blocks, 2 * n, image_tokens(cfg), False)
            + work._attn_calls(blocks, 2 * n, text_length(cfg), False))
    lat = size // 8
    _, vblocks = work.vae_decoder_work(dict(cfg["args"]["vae_cfg_list"])["image"]["args"],
                                       lat, lat)
    return step * traffic["steps"] + work._attn_calls(vblocks, n, 0, False)


def first_step(cfg, traffic):
    """The timestep of the DDIM loop's first step."""
    a = cfg["args"]
    return ddim_rows(traffic["steps"], a["beta_linear_start"], a["beta_linear_end"],
                     a.get("timesteps", 1000))[0][0]


def attention_names(model):
    """The names of the cross-attention modules of every context block of
    ``model``'s diffusers (the program's and the reference's alike), the
    pathway's type second: ``diffuser.<type>.context_blocks.<i>...attn2``."""
    return [n for n, _ in model.named_modules()
            if n.startswith("diffuser.") and ".context_blocks." in n and n.endswith(".attn2")]


def attention_calls(model, call):
    """[(module name, query input, output)] of every context block's
    cross-attention of ``model`` while ``call()`` runs, in call order, on
    the host."""
    seen = []

    def keep(name):
        return lambda m, args, out: seen.append((name, args[0].cpu(), out.cpu()))

    hooks = [model.get_submodule(n).register_forward_hook(keep(n)) for n in attention_names(model)]
    try:
        call()
    finally:
        for h in hooks:
            h.remove()
    return seen


def doubled(contexts, b):
    """{pathway type: its CFG-doubled context, unconditional rows first} of
    (image, unconditional image, text, unconditional text) contexts of one
    row each, for a batch of b."""
    c_img, u_img, c_txt, u_txt = contexts
    return {kind: torch.cat([u.expand(b, -1, -1), c.expand(b, -1, -1)])
            for kind, c, u in (("image", c_img, u_img), ("text", c_txt, u_txt))}


@torch.no_grad()
def program_attention(pipe, im, ids, x, ratio, t):
    """``attention_calls`` of the program's first step from start latents x
    at timestep ``t``: the facade's contexts of one request
    (``dual_contexts``: the CLIP graphs and the cached unconditional pair
    the requests use) through one CFG-doubled ``apply_model_multicontext``
    on the pipeline's attention kernels."""
    kv = doubled(pipe.dual_contexts(im, ids), x.shape[0])
    ts = torch.full((2 * x.shape[0],), int(t), dtype=torch.long, device=x.device)
    contexts = [{"type": "image", "c": kv["image"], "ratio": ratio},
                {"type": "text", "c": kv["text"], "ratio": 1.0 - ratio}]
    return attention_calls(pipe.net, lambda: pipe.net.apply_model_multicontext(
        {"type": "image", "x": torch.cat([x, x])}, ts, contexts, "attention",
        self_attn_fn=pipe.self_attn_fn))


@torch.no_grad()
def attention_err(ref, calls, kv):
    """[||out - want|| / ||want||] of each call of ``calls`` ((name, query
    input, output)), ``want`` the float32 reference's module of that name on
    the same query input over its own CFG-doubled context ``kv`` of that
    pathway: the cross-attention's inputs from the contexts (the K and V
    projections, K2 over 257 and 77 keys, the output projection)."""
    dev = next(ref.parameters()).device
    mode, out = ref.qmode, []
    ref.set_precision(None)
    for name, h, got in calls:
        heads = ref.get_submodule(name.rsplit(".transformer_blocks", 1)[0]).n_heads
        want = ref.get_submodule(name)(h.to(dev).float(), kv[name.split(".")[1]], heads, None)
        want, got = want.double().cpu(), got.double()
        out.append(((got - want).norm() / want.norm().clamp_min(1e-12)).item())
    ref.set_precision(mode)
    return out


def reference_readings(ref, seed, traffic, pools, picks, precision, length):
    """{request index: (image indices, (n, S, S, 3) images, the contexts
    CFG-doubled for the image indices (``doubled``), the start latents)} of
    the picked requests, the reference ``ref`` computing in ``precision``."""
    ref.set_precision(precision)
    dev = next(ref.parameters()).device
    s, out = traffic["size"], {}
    for i, idx in picks:
        req = request(seed, i, traffic, length)
        x = serving.start_latent(req["seed"], traffic["batch"], s, dev)[idx]
        im = torch.as_tensor(pools[0][req["ref"]], device=dev).permute(2, 0, 1)[None]
        ids = torch.as_tensor(req["ids"], device=dev)[None]
        ctx = ref.contexts(im, ids)
        img = ref.sample(ctx, x, ratio=traffic["ratio"], scale=traffic["guidance"],
                         steps=traffic["steps"])
        c_img, c_txt, u_img, u_txt = ctx
        out[i] = (idx, img.permute(0, 2, 3, 1).cpu().numpy(),
                  doubled((c_img, u_img, c_txt, u_txt), len(idx)), x)
    return out


class Entry(serving.Serving):
    def build(self, weights):
        from pfd_tpu_torch.pipeline import PromptFreeDiffusionPipeline

        from pfdbench import run

        if not hasattr(PromptFreeDiffusionPipeline, "action_dual_guided"):
            raise SystemExit("this program has no dual-guided request")
        t = self.traffic
        self.length = text_length(self.cell.model_cfg)
        self.pipe = PromptFreeDiffusionPipeline(
            fp16=True, with_control=False, self_attn_fn=self.attn,
            config_override=self.cell.model_cfg, tag_ctx="CLIP", tag_diffuser="none",
            tag_ctl="none", pretrained_root=str(run.BUILD / "no-weights"), device=self.device)
        self.pipe.ddim_steps = t["steps"]
        self.pipe.n_sample_image = t["batch"]
        self.pipe._load(self.pipe.net, weights)
        self.net = self.pipe.net

    def _inputs(self, req):
        return self.pools[0][req["ref"]], req["ids"], req["seed"]

    def warmup_request(self, j):
        return self._inputs(warmup_request(self.traffic, self.length))

    def request(self, i):
        self.n_requested = i + 1
        return self._inputs(request(self.cell.seed, i, self.traffic, self.length))

    def generate(self, ref, ids, seed):
        """ref: (S, S, 3) float32 in [0, 1]; ids: the prompt's ids ->
        (n, S, S, 3) float32 images on the host."""
        t, s = self.traffic, self.traffic["size"]
        out = self.pipe.action_dual_guided(ref, ids, t["ratio"], s, s, t["guidance"], seed)
        return np.stack(out[:t["batch"]])

    def work(self):
        cfg = self.cell.model_cfg
        return entries.Work(kernel_work(cfg, self.traffic), request_flops(cfg, self.traffic),
                            self.traffic["batch"])

    def attention(self, n_done):
        """{request index: the program's ``program_attention`` calls on its
        checked images} of the requests the check picks among ``n_done``."""
        cell, traffic = self.cell, self.traffic
        t, out = first_step(cell.model_cfg, traffic), {}
        for i, idx in serving.pick_requests(cell.seed, n_done, traffic):
            req = request(cell.seed, i, traffic, self.length)
            x = serving.start_latent(req["seed"], traffic["batch"], traffic["size"],
                                     self.device)[idx]
            out[i] = program_attention(self.pipe, *self._inputs(req)[:2], x, traffic["ratio"], t)
        return out

    def close(self):
        """Read the program's cross-attention for the check (which runs once
        the program is gone), then drop the program."""
        if "pipe" in self.__dict__:
            self._attention = self.attention(self.n_requested)
        super().close()

    def check(self, outputs):
        cell, traffic = self.cell, self.traffic
        picks = serving.pick_requests(cell.seed, len(outputs), traffic)
        calls = self.__dict__.pop("_attention", None) or self.attention(len(outputs))
        t_check = time.perf_counter()
        ref = serving.build_reference(cell, self.device)
        want = reference_readings(ref, cell.seed, traffic, self.pools, picks, None, self.length)
        errs = serving.compare(outputs, {i: v[:2] for i, v in want.items()})
        a_errs = [max(attention_err(ref, calls[i], want[i][2])) for i, _ in picks]
        del ref
        imgs = np.concatenate([v[1] for v in want.values()])
        print(f"check: {len(errs)} images of {len(picks)} requests in "
              f"{time.perf_counter() - t_check:.1f} s; image_err each "
              f"{[round(e, 6) for e in errs]}; cross_attention_err each request "
              f"{[round(e, 6) for e in a_errs]} ({len(calls[picks[0][0]])} calls); "
              f"reference images: std {imgs.std():.4f}, "
              f"at 0 or 1 {np.mean((imgs <= 0) | (imgs >= 1)):.4f}", file=sys.stderr, flush=True)
        return {"image_err": max(errs), "cross_attention_err": max(a_errs)}


def _picks(seed, traffic):
    rng = np.random.default_rng([int(seed), 1 << 22])
    return [(i, serving.check_indices(rng, traffic["batch"], traffic["check"]["images"]))
            for i in range(traffic["check"]["requests"])]


def control(cell, seeds, spec=None, group=None):
    """{seed: [image_err of each checked image]} of the control: the
    reference in float8 against the reference, on the first
    ``check["requests"]`` requests of each seed; each seed's line also
    gives the float8 reference's ``cross_attention_err`` (its first step's
    cross-attention calls, ``attention_calls``, against the float32
    module's on the same query inputs over the float32 contexts)."""
    traffic, length = cell.traffic, text_length(cell.model_cfg)
    t = first_step(cell.model_cfg, traffic)
    out = {}
    for seed in seeds:
        t0 = time.perf_counter()
        c = dataclasses.replace(cell, seed=seed)
        pools = traffic_lib.pools(seed, traffic)
        picks = _picks(seed, traffic)
        ref = serving.build_reference(c, cell.device)
        want = reference_readings(ref, seed, traffic, pools, picks, None, length)
        low = reference_readings(ref, seed, traffic, pools, picks, CONTROL, length)
        out[seed] = serving.compare({i: v[1] for i, v in low.items()},
                                    {i: (list(range(len(v[0]))), v[1]) for i, v in want.items()})
        a_errs = []
        ref.set_precision(CONTROL)
        for i, _ in picks:
            kv, x = low[i][2:]
            ts = torch.full((2 * x.shape[0],), t, dtype=torch.long, device=x.device)
            with torch.no_grad():
                calls = attention_calls(ref, lambda: ref.eps(
                    torch.cat([x, x]), ts, [(kv["image"], traffic["ratio"]),
                                            (kv["text"], 1.0 - traffic["ratio"])]))
            a_errs.append(max(attention_err(ref, calls, want[i][2])))
        del ref
        print(json.dumps({"workload": cell.name, "seed": seed, "precision": CONTROL,
                          "image_err": out[seed], "cross_attention_err": a_errs,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return out


def _stale_unconditional(entry):
    """Keep the unconditional pair cached from the weights loaded before (a
    cache that outlives ``_load``)."""
    pipe, load = entry.pipe, entry.pipe._load

    def stale(module, sd):
        kept = dict(pipe._uncond)
        load(module, sd)
        pipe._uncond.update(kept)

    pipe._load = stale
    return lambda: pipe.__dict__.pop("_load")


def _text_cross_attention_zeroed(entry):
    """The cross-attention over the 77 text tokens returns zeros."""
    from pfd_tpu_torch.ops import flash_attention as fa

    real = fa.cross_attn_fn

    def zeroed(q, k, v, **kw):
        return torch.zeros_like(q) if k.shape[2] == 77 else real(q, k, v, **kw)

    fa.cross_attn_fn = zeroed
    return lambda: setattr(fa, "cross_attn_fn", real)


# faults planted in a built entry's program before its warm-up (``sound``'s
# ``fault``), which the check must catch; each returns its undo
FAULTS = {"stale_unconditional": _stale_unconditional,
          "text_cross_attention_zeroed": _text_cross_attention_zeroed}


def sound(cell, seeds, fault=None):
    """{seed: the check's numbers} of the program against the reference,
    each seed's weights loaded into one entry's pipeline (module
    docstring), on the first ``check["requests"]`` requests of each seed;
    ``fault`` one of ``FAULTS``, planted for the call (the stale pair shows
    from the second seed on)."""
    entry = Entry(dataclasses.replace(cell, seed=seeds[0]))
    undo = FAULTS[fault](entry) if fault else (lambda: None)
    try:
        for j in range(entry.warmup):
            entry.warm(j)
        with torch.device("meta"):
            table = weights.rules(cell.reference_module().Reference(cell.model_cfg))
        out = {}
        for seed in seeds:
            t0 = time.perf_counter()
            entry.cell = c = dataclasses.replace(cell, seed=seed)
            entry.pipe._load(entry.net, weights.make(table, c.recipe, seed, entry.device))
            entry.pools = traffic_lib.pools(seed, entry.traffic)
            outputs = [entry(entry.request(i))
                       for i in range(entry.traffic["check"]["requests"])]
            out[seed] = entry.check(outputs)
            print(json.dumps({"workload": cell.name, "seed": seed, "fault": fault, **out[seed],
                              "seconds": time.perf_counter() - t0}), flush=True)
    finally:
        undo()
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description="the sound readings of a dual-guided cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--fault", choices=sorted(FAULTS), default=None,
                   help="a fault planted in the program, which every reading should show")
    args = p.parse_args(argv)
    from pfdbench import run

    run.fix_caches()
    cell = run.cell_of(run.load_json(run.ROOT / "BENCHMARK.json"), args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    readings = sound(run.make_cell(cell, seeds[0], "cuda"), seeds, args.fault)
    print(json.dumps({"workload": cell["name"], "fault": args.fault,
                      **{f"max_{k}": max(r[k] for r in readings.values())
                         for k in next(iter(readings.values()))}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
