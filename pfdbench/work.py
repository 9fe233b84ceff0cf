"""The work a request needs, counted from the configuration's published widths
and the cell's schedule (never read from the program), and the chip's peaks.

- ``request_flops``: the model FLOPs of one request (2 per multiply-add):
  SeeCoder on each reference, the UNet on every step's calls (the guided
  step at twice the batch; a turbo reuse step the last level of the decoder
  at the batch), the ControlNet on every guided step and its hint pyramid
  once a request, the VAE decoder on each latent. Elementwise work (norms,
  softmax, activations) is not counted. A nearest-2x upsample conv counts the
  four taps a phase of its output reads, the least its inputs need.
- ``kernel_work``: each hand-written kernel's calls in one request, as
  ``Call``s with the shape, the operations and the bytes (each input read
  once, each output written once), and the calls' least time on the chip.
  ``launches`` counts them, the arithmetic of the launch plan: a
  transformer block on a map of at least ``KERNEL_MIN_S`` tokens launches
  the cross-attention kernel and the self-attention kernel (int8 P.V in the
  integer mode), the VAE's mid-block attention the self-attention kernel,
  each integer conv (the quantized set: ``reference.model.INT_MIN_CH``) the
  int8 conv kernel.
"""

from __future__ import annotations

import dataclasses

from pfdbench.reference.unet import build_plan

# NVIDIA H100 SXM data sheet, dense
PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12
PEAK_FP32 = 67e12          # float32 outside the tensor cores
PEAK_BYTES = 3.35e12

KERNEL_MIN_S = 1024        # sequence length from which attention runs the kernels
CROSS_MAX_KV = 512         # the cross-attention kernel's longest context
INT_MIN_CH = 64


def conv(n, cin, cout, h, w, k):
    """FLOPs of a k x k conv with an (h, w) output."""
    return 2 * n * h * w * cout * cin * k * k


def linear(n_tokens, cin, cout):
    return 2 * n_tokens * cin * cout


def attention(b, heads, sq, skv, d):
    """FLOPs of QK^T and P.V."""
    return 4 * b * heads * sq * skv * d


# ---- the UNet and the ControlNet -------------------------------------------

def unet_args(cfg):
    return dict(cfg["args"]["diffuser_cfg_list"])["image"]["args"]


def _res_block(cin, cout, h, w, emb_ch):
    f = conv(1, cin, cout, h, w, 3) + conv(1, cout, cout, h, w, 3) + linear(1, emb_ch, cout)
    return f + (conv(1, cin, cout, h, w, 1) if cin != cout else 0)


def _transformer(ch, h, w, ctx_len, ctx_dim, heads):
    s = h * w
    return (40 * s * ch * ch + 2 * linear(ctx_len, ctx_dim, ch)
            + attention(1, heads, s, s, ch // heads) + attention(1, heads, s, ctx_len, ch // heads))


class UNetWork:
    """Per-sample FLOPs of the UNet's whole call and of its last decoder
    level, and the shapes of its blocks, at latent (h, w)."""

    def __init__(self, args, h, w, ctx_len, up_taps=4):
        self.args = args
        mc, ctx_dim = args["model_channels"], args["context_dim"]
        self.plan = build_plan(args["in_channels"], mc, args["out_channels"],
                               args["num_res_blocks"], tuple(args["attention_resolutions"]),
                               tuple(args["channel_mult"]), args["num_heads"])
        i_ops, m_ops, o_ops, specs, ctx = self.plan
        ups = [i for i, op in enumerate(o_ops) if op[0] == "d" and specs[op[1]].kind == "up"]
        self.up_taps = up_taps
        emb = linear(1, mc, 4 * mc) + linear(1, 4 * mc, 4 * mc)
        full, res_in = self._walk(i_ops + m_ops + o_ops, h, w, ctx_len, ctx_dim)
        shallow_ops = o_ops[ups[-1]:]
        shallow, _ = self._walk(shallow_ops, h >> 1, w >> 1, ctx_len, ctx_dim)
        self.full_flops, self.shallow_flops = full + emb, shallow + emb
        self.full_blocks = res_in
        self.shallow_blocks = self._walk(shallow_ops, h >> 1, w >> 1, ctx_len, ctx_dim)[1]

    def _walk(self, ops, h, w, ctx_len, ctx_dim):
        """(FLOPs, [("attn", ch, heads, h, w) | ("conv", cin, cout, h, w, k, stride, up)])."""
        _, _, _, specs, ctx = self.plan
        emb_ch = 4 * self.args["model_channels"]
        f, blocks = 0, []
        for op in ops:
            if op[0] == "c":
                ch, heads, _ = ctx[op[1]]
                f += _transformer(ch, h, w, ctx_len, ctx_dim, heads)
                blocks.append(("attn", ch, heads, h, w))
            elif op[0] == "d":
                s = specs[op[1]]
                if s.kind == "conv_in" or s.kind == "out":
                    f += conv(1, s.cin, s.cout, h, w, 3)
                    blocks.append(("conv", s.cin, s.cout, h, w, 3, 1, False))
                elif s.kind == "res":
                    f += _res_block(s.cin, s.cout, h, w, emb_ch)
                    blocks += [("conv", s.cin, s.cout, h, w, 3, 1, False),
                               ("conv", s.cout, s.cout, h, w, 3, 1, False)]
                elif s.kind == "down":
                    h, w = h // 2, w // 2
                    f += conv(1, s.cin, s.cout, h, w, 3)
                    blocks.append(("conv", s.cin, s.cout, h, w, 3, 2, False))
                else:
                    h, w = h * 2, w * 2
                    f += 2 * h * w * s.cout * s.cin * self.up_taps
                    blocks.append(("conv", s.cin, s.cout, h, w, 3, 1, True))
        return f, blocks


def controlnet_work(args, h, w, ctx_len, hint_hw):
    """(per-sample FLOPs of a call, the blocks of a call, the hint pyramid's
    FLOPs and blocks per hint image)."""
    mc, ctx_dim, heads = args["model_channels"], args["context_dim"], args["num_heads"]
    nrb = args["num_res_blocks"]
    nrb = [nrb] * len(args["channel_mult"]) if isinstance(nrb, int) else nrb
    emb_ch = 4 * mc
    f = linear(1, mc, emb_ch) + linear(1, emb_ch, emb_ch)
    f += conv(1, args["in_channels"], mc, h, w, 3) + conv(1, mc, mc, h, w, 1)
    blocks = [("conv", args["in_channels"], mc, h, w, 3, 1, False)]
    ch, ds = mc, 1
    for level, mult in enumerate(args["channel_mult"]):
        for _ in range(nrb[level]):
            cout = mult * mc
            f += _res_block(ch, cout, h, w, emb_ch) + conv(1, cout, cout, h, w, 1)
            blocks += [("conv", ch, cout, h, w, 3, 1, False), ("conv", cout, cout, h, w, 3, 1, False)]
            ch = cout
            if ds in args["attention_resolutions"]:
                f += _transformer(ch, h, w, ctx_len, ctx_dim, heads)
                blocks.append(("attn", ch, heads, h, w))
        if level != len(args["channel_mult"]) - 1:
            h, w, ds = h // 2, w // 2, ds * 2
            f += conv(1, ch, ch, h, w, 3) + conv(1, ch, ch, h, w, 1)
            blocks.append(("conv", ch, ch, h, w, 3, 2, False))
    f += 2 * _res_block(ch, ch, h, w, emb_ch) + _transformer(ch, h, w, ctx_len, ctx_dim, heads)
    f += conv(1, ch, ch, h, w, 1)
    blocks += [("conv", ch, ch, h, w, 3, 1, False)] * 2 + [("attn", ch, heads, h, w)]
    blocks += [("conv", ch, ch, h, w, 3, 1, False)] * 2
    hf, hb = 0, []
    hh, hw_, cin = hint_hw[0], hint_hw[1], args["hint_channels"]
    for cout, stride in [(16, 1), (16, 1), (32, 2), (32, 1), (96, 2), (96, 1), (256, 2), (mc, 1)]:
        hh, hw_ = hh // stride, hw_ // stride
        hf += conv(1, cin, cout, hh, hw_, 3)
        hb.append(("conv", cin, cout, hh, hw_, 3, stride, False))
        cin = cout
    return f, blocks, hf, hb


# ---- SeeCoder and the VAE decoder --------------------------------------------

def seecoder_flops(args, h, w):
    """FLOPs of SeeCoder on one (h, w) reference: Swin over zero-padded
    windows, the decoder over res3..res5, the query transformer."""
    sw = args["imencoder_cfg"]["args"]
    dec = args["imdecoder_cfg"]["args"]
    qt = args["qtransformer_cfg"]["args"]
    e, win, heads = sw["embed_dim"], sw["window_size"], sw["num_heads"]
    r_h, r_w = -(-h // 4), -(-w // 4)
    f = conv(1, 3, e, r_h, r_w, 4)
    res = {}
    for i, depth in enumerate(sw["depths"]):
        c = e * 2 ** i
        n = r_h * r_w
        npad = (-(-r_h // win) * win) * (-(-r_w // win) * win)
        blk = (linear(npad, c, 3 * c) + attention(npad // (win * win), heads[i], win * win,
                                                    win * win, c // heads[i])
               + linear(npad, c, c) + 2 * linear(n, c, 4 * c))
        f += depth * blk
        res[f"res{i + 2}"] = (r_h, r_w, c)
        if i < len(sw["depths"]) - 1:
            r_h, r_w = -(-r_h // 2), -(-r_w // 2)
            f += linear(r_h * r_w, 4 * c, 2 * c)
    d, ff = dec["trans_dim"], dec["trans_feedforward_dim"]
    tags = sorted(dec["inchannels"])
    tokens = sum(res[t][0] * res[t][1] for t in dec["trans_input_tags"])
    for t in tags:
        rh, rw, c = res[t]
        f += conv(1, c, d, rh, rw, 1)           # the lateral conv
        f += (conv(1, c, d, rh, rw, 1) if t in dec["trans_input_tags"]   # the input projection
              else conv(1, d, d, rh, rw, 3))    # the output conv of a level the transformer skips
    f += dec["trans_num_layers"] * (2 * linear(tokens, d, d) + 2 * linear(tokens, d, ff))
    hd, nq, ng = qt["hidden_dim"], sum(qt["num_queries"]), qt["num_queries"][0]
    levels = [res[t][0] * res[t][1] for t in ("res3", "res4", "res5")]
    for i in range(qt["num_layers"]):
        s = levels[i % qt["num_feature_levels"]]
        nl = nq - ng
        f += (2 * linear(nl, hd, hd) + 2 * linear(s, hd, hd)
              + attention(1, qt["nheads"], nl, s, hd // qt["nheads"]))
        f += 4 * linear(nq, hd, hd) + attention(1, qt["nheads"], nq, nq, hd // qt["nheads"])
        f += 2 * linear(nq, hd, qt["feedforward_dim"])
    return f


def vae_decoder_work(args, h, w, up_taps=4):
    """(FLOPs, blocks) of the VAE decode of one (h, w) latent."""
    dd = args["ddconfig"]
    ch, mult, nrb = dd["ch"], dd["ch_mult"], dd["num_res_blocks"]
    cmid = ch * mult[-1]
    f = conv(1, args["embed_dim"], dd["z_channels"], h, w, 1)
    f += conv(1, dd["z_channels"], cmid, h, w, 3)
    blocks = [("conv", dd["z_channels"], cmid, h, w, 3, 1, False)]

    def res(cin, cout, h, w):
        nonlocal f
        f += conv(1, cin, cout, h, w, 3) + conv(1, cout, cout, h, w, 3)
        f += conv(1, cin, cout, h, w, 1) if cin != cout else 0
        blocks.extend([("conv", cin, cout, h, w, 3, 1, False), ("conv", cout, cout, h, w, 3, 1, False)])

    res(cmid, cmid, h, w)
    f += 4 * conv(1, cmid, cmid, h, w, 1) + attention(1, 1, h * w, h * w, cmid)
    blocks.append(("vae_attn", cmid, 1, h, w))
    res(cmid, cmid, h, w)
    cin = cmid
    for i in reversed(range(len(mult))):
        for _ in range(nrb + 1):
            res(cin, ch * mult[i], h, w)
            cin = ch * mult[i]
        if i:
            h, w = h * 2, w * 2
            f += 2 * h * w * cin * cin * up_taps
            blocks.append(("conv", cin, cin, h, w, 3, 1, True))
    f += conv(1, ch * mult[0], dd["out_ch"], h, w, 3)
    blocks.append(("conv", ch * mult[0], dd["out_ch"], h, w, 3, 1, False))
    return f, blocks


# ---- one request -------------------------------------------------------------

def turbo_kinds(steps, phases):
    """["full" | "reuse"] of each step (``reference.model.turbo_schedule``)."""
    from pfdbench.reference.model import turbo_schedule
    return [k for _, k in turbo_schedule(steps, phases)]


@dataclasses.dataclass
class Request:
    """The shape of one request: ``n`` images of (size, size), ``steps``
    DDIM steps in ``phases``, a hint or not, the mode."""
    n: int
    size: int
    steps: int
    phases: list | None
    hint: bool
    int8: bool
    ctx_len: int = 148


def request_of(traffic):
    return Request(n=traffic["batch"], size=traffic["size"], steps=traffic["steps"],
                   phases=traffic.get("phases"), hint=traffic.get("hint") is not None,
                   int8=traffic["mode"] == "int8")


def request_flops(cfg, req, up_taps=4):
    """Model FLOPs of one request (module docstring)."""
    a = cfg["args"]
    lat = req.size // 8
    u = UNetWork(unet_args(cfg), lat, lat, req.ctx_len, up_taps)
    kinds = turbo_kinds(req.steps, req.phases)
    f = req.n * seecoder_flops(dict(a["ctx_cfg_list"])["image"]["args"], req.size, req.size)
    f += req.n * sum(2 * u.full_flops if k == "full" else u.shallow_flops for k in kinds)
    if req.hint:
        cf, _, hf, _ = controlnet_work(a["ctl_cfg"]["args"], lat, lat, req.ctx_len,
                                       (req.size, req.size))
        f += req.n * (hf + 2 * cf * kinds.count("full"))
    f += req.n * vae_decoder_work(dict(a["vae_cfg_list"])["image"]["args"], lat, lat, up_taps)[0]
    return f


@dataclasses.dataclass(frozen=True)
class Call:
    """One launch of a kernel: its shape, operations (bf16-rate and
    int8-rate separately) and bytes."""
    kernel: str
    shape: tuple
    ops_bf16: float
    ops_int8: float
    nbytes: float

    def bound_s(self):
        return max(self.ops_bf16 / PEAK_BF16 + self.ops_int8 / PEAK_INT8,
                   self.nbytes / PEAK_BYTES)


def _attn_calls(blocks, b, ctx_len, int8):
    out = []
    for blk in blocks:
        if blk[0] == "vae_attn":
            _, c, heads, h, w = blk
            s = h * w
            if s >= KERNEL_MIN_S:
                out.append(Call("flash_attention", (b, 1, s, s, c), attention(b, 1, s, s, c), 0,
                                2 * 4 * b * s * c))
        if blk[0] != "attn":
            continue
        _, ch, heads, h, w = blk
        s, d = h * w, ch // heads
        if s < KERNEL_MIN_S:
            continue
        if int8:
            half = attention(b, heads, s, s, d) / 2
            out.append(Call("flash_attention_pv8", (b, heads, s, s, d), half, half,
                            b * heads * s * d * (2 + 2 + 1 + 2)))
        else:
            out.append(Call("flash_attention", (b, heads, s, s, d), attention(b, heads, s, s, d),
                            0, 2 * 4 * b * heads * s * d))
        if ctx_len <= CROSS_MAX_KV:
            out.append(Call("cross_attention", (b, heads, s, ctx_len, d),
                            attention(b, heads, s, ctx_len, d), 0,
                            2 * b * heads * d * (2 * s + 2 * ctx_len)))
    return out


def _conv_calls(blocks, b):
    out = []
    for blk in blocks:
        if blk[0] != "conv":
            continue
        _, cin, cout, h, w, k, stride, up = blk
        if k * k < 9 or min(cin, cout) < INT_MIN_CH:
            continue
        taps = 4 if up else k * k
        hin, win = (h // 2, w // 2) if up else (h * stride, w * stride)
        ops = 2 * b * h * w * cout * cin * taps
        nbytes = b * cin * hin * win + cout * cin * taps * (4 if up else 1) + 4 * b * cout * h * w
        out.append(Call("conv_int8", (b, cin, cout, h, w, k, stride, up), 0, ops, nbytes))
    return out


def vae_encoder_calls(cfg, size, n):
    """[Call] of the VAE encode of ``n`` ``size``^2 images: the encoder's
    mid-block attention, at the latent's resolution."""
    dd = dict(cfg["args"]["vae_cfg_list"])["image"]["args"]["ddconfig"]
    lat = size >> (len(dd["ch_mult"]) - 1)
    return _attn_calls([("vae_attn", dd["ch"] * dd["ch_mult"][-1], 1, lat, lat)], n, 0, False)


def kernel_work(cfg, req):
    """[Call] of one request, in no particular order."""
    a = cfg["args"]
    lat = req.size // 8
    u = UNetWork(unet_args(cfg), lat, lat, req.ctx_len)
    kinds = turbo_kinds(req.steps, req.phases)
    calls = []
    ctl = None
    if req.hint:
        _, cblocks, _, hblocks = controlnet_work(a["ctl_cfg"]["args"], lat, lat, req.ctx_len,
                                                 (req.size, req.size))
        ctl = cblocks
        if req.int8:
            calls += _conv_calls(hblocks, req.n)
    for k in kinds:
        b = 2 * req.n if k == "full" else req.n
        blocks = u.full_blocks if k == "full" else u.shallow_blocks
        if k == "full" and ctl is not None:
            blocks = blocks + ctl
        calls += _attn_calls(blocks, b, req.ctx_len, req.int8)
        if req.int8:
            calls += _conv_calls(blocks, b)
    _, vblocks = vae_decoder_work(dict(a["vae_cfg_list"])["image"]["args"], lat, lat)
    calls += _attn_calls(vblocks, req.n, req.ctx_len, False)
    if req.int8:
        calls += _conv_calls(vblocks, req.n)
    return calls


def launches(calls):
    """{kernel: launches} of ``kernel_work``'s calls."""
    out = {}
    for c in calls:
        out[c.kernel] = out.get(c.kernel, 0) + 1
    return out


def unet_flops_table(cfg, size=512, ctx_len=148):
    """{part: GFLOP per sample and call} at ``size``^2: the UNet's whole call,
    its last decoder level, the ControlNet's call and hint pyramid, SeeCoder,
    the VAE decoder (``PERF.md``'s table beside the program's estimate)."""
    a = cfg["args"]
    lat = size // 8
    u = UNetWork(unet_args(cfg), lat, lat, ctx_len)
    out = {"unet_call": u.full_flops / 1e9, "unet_last_level": u.shallow_flops / 1e9,
           "seecoder": seecoder_flops(dict(a["ctx_cfg_list"])["image"]["args"], size, size) / 1e9,
           "vae_decoder": vae_decoder_work(dict(a["vae_cfg_list"])["image"]["args"], lat,
                                           lat)[0] / 1e9}
    if "ctl_cfg" in a:
        cf, _, hf, _ = controlnet_work(a["ctl_cfg"]["args"], lat, lat, ctx_len, (size, size))
        out.update(controlnet_call=cf / 1e9, hint_pyramid=hf / 1e9)
    return {k: round(v, 3) for k, v in out.items()}

