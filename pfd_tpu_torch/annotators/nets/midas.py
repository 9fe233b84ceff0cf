"""MiDaS DPT-Hybrid depth annotator (the port of
``pfd_tpu/annotators/nets/midas.py``): DPTDepthModel with the
``vitb_rn50_384`` hybrid backbone (reference dpt_depth.py:26-110,
vit.py:343-476) and the depth + Sobel-normal outputs (midas/__init__.py:15-46).

The backbone (a ResNetV2-50 stem with weight-standardised convs and
GroupNorm, ViT-Base over the port's ``dot_product_attention`` with fp32
logits and softmax, resizable position embeddings, the DPT readout and
reassemble) and the DPT decoder follow ``pfd_tpu`` op for op, with its
parameter names (those of the dpt_hybrid-midas checkpoint).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from pfd_tpu_torch.annotators import imageops
from pfd_tpu_torch.annotators.nets import device_of, load_torch_params, network
from pfd_tpu_torch.annotators.nets import pretrained_path, tree_shapes
from pfd_tpu_torch.annotators.nets.mlsd import upsample2x_align_corners
from pfd_tpu_torch.ops import nn as ops_nn

# ResNetV2-50 stem stages used by the hybrid: (blocks, mid, out, stride)
_RN_STAGES = [(3, 64, 256, 1), (4, 128, 512, 2), (9, 256, 1024, 2)]
_VIT_DEPTH, _VIT_DIM, _VIT_HEADS = 12, 768, 12
_HOOKS = (8, 11)  # transformer blocks tapped for layer_3 / layer_4
_FEATURES = 256
# the upstream checkpoint's classifier-only leaves, which the DPT path never
# reads and ``pfd_tpu``'s pytree does not hold (timm's final norm and head)
_CLASSIFIER = ("pretrained.model.norm.", "pretrained.model.head.")


def _same_pad(x, k, stride):
    """TF "SAME" padding of ``pfd_tpu``'s ``padding="SAME"`` (and timm's
    StdConv2dSame): the total split low = total // 2, high = the rest."""
    pads = []
    for n in (x.shape[3], x.shape[2]):
        total = max((-(-n // stride) - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


def _std_conv(p, x, *, stride=1):
    """Weight-standardised conv (timm StdConv2dSame), SAME padding."""
    w = p.weight.float()
    mean = w.mean((1, 2, 3), keepdim=True)
    var = w.var((1, 2, 3), unbiased=False, keepdim=True)
    w = ((w - mean) * torch.rsqrt(var + 1e-6)).to(x.dtype)
    return ops_nn.conv2d_raw(_same_pad(x, w.shape[-1], stride), w, stride=stride)


def _gn_relu(p, x, relu=True):
    x = ops_nn.group_norm(x, p, groups=32, eps=1e-5)
    return torch.relu(x) if relu else x


def _bottleneck(p, x, stride):
    """timm ResNetV2 Bottleneck (preact=False): conv-GN-ReLU x3 + shortcut."""
    if "downsample" in p._modules:
        shortcut = _std_conv(p.get_submodule("downsample.conv"), x, stride=stride)
        shortcut = _gn_relu(p.get_submodule("downsample.norm"), shortcut, relu=False)
    else:
        shortcut = x
    h = _gn_relu(p.norm1, _std_conv(p.conv1, x))
    h = _gn_relu(p.norm2, _std_conv(p.conv2, h, stride=stride))
    h = _gn_relu(p.norm3, _std_conv(p.conv3, h), relu=False)
    return torch.relu(h + shortcut)


def _rn_backbone(p, x):
    """Stem + 3 stages; returns (stage0 act, stage1 act, final)."""
    h = _std_conv(p.get_submodule("stem.conv"), x, stride=2)
    h = _gn_relu(p.get_submodule("stem.norm"), h)
    # maxpool 3x3 stride 2, SAME padding
    h = F.max_pool2d(F.pad(h, (0, 1, 0, 1), value=-torch.inf), 3, 2)
    feats = []
    for si, (nblk, _, _, stride) in enumerate(_RN_STAGES):
        for bi in range(nblk):
            h = _bottleneck(p.get_submodule(f"stages.{si}.blocks.{bi}"), h,
                            stride if bi == 0 else 1)
        feats.append(h)
    return feats


def _vit_block(p, x, heads=_VIT_HEADS):
    h = ops_nn.layer_norm(x, p.norm1)
    q, k, v = ops_nn.linear(h, p.get_submodule("attn.qkv")).chunk(3, dim=-1)
    o = ops_nn.dot_product_attention(ops_nn.split_heads(q, heads), ops_nn.split_heads(k, heads),
                                     ops_nn.split_heads(v, heads))
    x = x + ops_nn.linear(ops_nn.merge_heads(o), p.get_submodule("attn.proj"))
    h = ops_nn.gelu(ops_nn.linear(ops_nn.layer_norm(x, p.norm2), p.get_submodule("mlp.fc1")))
    return x + ops_nn.linear(h, p.get_submodule("mlp.fc2"))


def _resize_pos_embed(pos_embed, gh, gw):
    """vit.py:100-115: bilinear-resize the grid part, keep the cls token;
    unantialiased, as torch's F.interpolate (and ``pfd_tpu``) resize it."""
    tok, grid = pos_embed[:, :1], pos_embed[0, 1:]
    gs = int(np.sqrt(grid.shape[0]))
    grid = grid.reshape(gs, gs, -1).permute(2, 0, 1)
    grid = imageops.resize(grid, (gh, gw), "linear", antialias=False)
    return torch.cat([tok, grid.permute(1, 2, 0).reshape(1, gh * gw, -1)], dim=1)


def _project_readout(p, x):
    """ProjectReadout (vit.py:31-42): concat cls token, linear+gelu."""
    readout = x[:, :1].expand_as(x[:, 1:])
    feats = torch.cat([x[:, 1:], readout], dim=-1)
    return ops_nn.gelu(ops_nn.linear(feats, p.get_submodule("0")))


def _rcu(p, x):
    """ResidualConvUnit_custom (blocks.py:231-289, bn=False)."""
    h = ops_nn.conv2d(torch.relu(x), p.conv1, padding=1)
    return ops_nn.conv2d(torch.relu(h), p.conv2, padding=1) + x


def _fusion(p, x, skip=None):
    """FeatureFusionBlock_custom (blocks.py:291-341)."""
    if skip is not None:
        x = x + _rcu(p.resConfUnit1, skip)
    x = upsample2x_align_corners(_rcu(p.resConfUnit2, x))
    return ops_nn.conv2d(x, p.out_conv)


def dpt_decode(sc, layer_1, layer_2, layer_3, layer_4):
    """DPT decoder: scratch RN convs + 4 fusion stages + output head
    (dpt_depth.py:57-101) -> (B, H, W)."""
    l1 = ops_nn.conv2d(layer_1, sc.layer1_rn, padding=1)
    l2 = ops_nn.conv2d(layer_2, sc.layer2_rn, padding=1)
    l3 = ops_nn.conv2d(layer_3, sc.layer3_rn, padding=1)
    l4 = ops_nn.conv2d(layer_4, sc.layer4_rn, padding=1)
    p4 = _fusion(sc.refinenet4, l4)
    p3 = _fusion(sc.refinenet3, p4, l3)
    p2 = _fusion(sc.refinenet2, p3, l2)
    p1 = _fusion(sc.refinenet1, p2, l1)
    h = ops_nn.conv2d(p1, sc.get_submodule("output_conv.0"), padding=1)
    h = upsample2x_align_corners(h)
    h = torch.relu(ops_nn.conv2d(h, sc.get_submodule("output_conv.2"), padding=1))
    h = torch.relu(ops_nn.conv2d(h, sc.get_submodule("output_conv.4")))  # non_negative
    return h[:, 0]


def dpt_hybrid_forward(net, x):
    """x: (1, 3, H, W) normalized (x/127.5 - 1), H and W multiples of 32.
    Returns (1, H, W) inverse depth."""
    b = x.shape[0]
    pm = net.get_submodule("pretrained.model")
    layer_1, layer_2, feat = _rn_backbone(pm.get_submodule("patch_embed.backbone"), x)
    h = ops_nn.conv2d(feat, pm.get_submodule("patch_embed.proj"))  # 1024 -> 768
    gh, gw = h.shape[2:]
    tokens = h.flatten(2).transpose(1, 2)
    cls = pm.cls_token.reshape(1, 1, _VIT_DIM).to(h.dtype).expand(b, 1, _VIT_DIM)
    t = torch.cat([cls, tokens], dim=1) + _resize_pos_embed(pm.pos_embed.to(h.dtype), gh, gw)
    acts = {}
    for i in range(_VIT_DEPTH):
        t = _vit_block(pm.get_submodule(f"blocks.{i}"), t)
        if i in _HOOKS:
            acts[i] = t
    # (the final norm serves only the classifier, which DPT does not run)

    def reassemble(act, post, extra_conv=False):
        y = _project_readout(post.get_submodule("0.project"), act)
        y = y.transpose(1, 2).reshape(b, _VIT_DIM, gh, gw)
        y = ops_nn.conv2d(y, post.get_submodule("3"))
        return ops_nn.conv2d(y, post.get_submodule("4"), stride=2, padding=1) if extra_conv else y

    layer_3 = reassemble(acts[_HOOKS[0]], net.get_submodule("pretrained.act_postprocess3"))
    layer_4 = reassemble(acts[_HOOKS[1]], net.get_submodule("pretrained.act_postprocess4"), True)
    return dpt_decode(net.scratch, layer_1, layer_2, layer_3, layer_4)


def _params(draw):
    """The DPT-hybrid pytree (``pfd_tpu``'s ``init_params`` structure,
    midas.py:229-320), each leaf ``draw(kind, shape)``: kind "conv_w",
    "conv_b", "lin_w", "lin_b" (fan-in-scaled uniform, as ``nn.init_conv``
    / ``nn.init_linear``; the shape's fan-in is the product of all but its
    last axis), "ones", "zeros" or "pos" (N(0, 0.02^2))."""
    def conv(ks, cin, cout, bias=True):
        p = {"kernel": draw("conv_w", (ks, ks, cin, cout))}
        if bias:
            p["bias"] = draw("conv_b", (ks * ks * cin, cout))
        return p

    def lin(cin, cout):
        return {"kernel": draw("lin_w", (cin, cout)), "bias": draw("lin_b", (cin, cout))}

    def norm(c):
        return {"scale": draw("ones", (c,)), "bias": draw("zeros", (c,))}

    stages, cin = {}, 64
    for si, (nblk, mid, cout, _) in enumerate(_RN_STAGES):
        blocks = {}
        for bi in range(nblk):
            b = {"conv1": conv(1, cin if bi == 0 else cout, mid, bias=False), "norm1": norm(mid),
                 "conv2": conv(3, mid, mid, bias=False), "norm2": norm(mid),
                 "conv3": conv(1, mid, cout, bias=False), "norm3": norm(cout)}
            if bi == 0:
                b["downsample"] = {"conv": conv(1, cin, cout, bias=False), "norm": norm(cout)}
            blocks[str(bi)] = b
        stages[str(si)] = {"blocks": blocks}
        cin = cout
    vit_blocks = {str(i): {"norm1": norm(_VIT_DIM),
                           "attn": {"qkv": lin(_VIT_DIM, 3 * _VIT_DIM),
                                    "proj": lin(_VIT_DIM, _VIT_DIM)},
                           "norm2": norm(_VIT_DIM),
                           "mlp": {"fc1": lin(_VIT_DIM, 4 * _VIT_DIM),
                                   "fc2": lin(4 * _VIT_DIM, _VIT_DIM)}}
                  for i in range(_VIT_DEPTH)}

    def postprocess(extra=False):
        p = {"0": {"project": {"0": lin(2 * _VIT_DIM, _VIT_DIM)}}, "3": conv(1, _VIT_DIM, 768)}
        if extra:
            p["4"] = conv(3, 768, 768)
        return p

    def rcu():
        return {"conv1": conv(3, _FEATURES, _FEATURES), "conv2": conv(3, _FEATURES, _FEATURES)}

    def fusion():
        return {"out_conv": conv(1, _FEATURES, _FEATURES), "resConfUnit1": rcu(),
                "resConfUnit2": rcu()}

    return {
        "pretrained": {
            "model": {
                "patch_embed": {"backbone": {"stem": {"conv": conv(7, 3, 64, bias=False),
                                                      "norm": norm(64)},
                                             "stages": stages},
                                "proj": conv(1, 1024, _VIT_DIM)},
                "cls_token": draw("zeros", (1, 1, _VIT_DIM)),
                "pos_embed": draw("pos", (1, 577, _VIT_DIM)),
                "blocks": vit_blocks,
            },
            "act_postprocess3": postprocess(),
            "act_postprocess4": postprocess(extra=True),
        },
        "scratch": {
            "layer1_rn": conv(3, 256, _FEATURES, bias=False),
            "layer2_rn": conv(3, 512, _FEATURES, bias=False),
            "layer3_rn": conv(3, 768, _FEATURES, bias=False),
            "layer4_rn": conv(3, 768, _FEATURES, bias=False),
            "refinenet1": fusion(), "refinenet2": fusion(),
            "refinenet3": fusion(), "refinenet4": fusion(),
            "output_conv": {"0": conv(3, _FEATURES, _FEATURES // 2),
                            "2": conv(3, _FEATURES // 2, 32),
                            "4": conv(1, 32, 1)},
        },
    }


def _shape_of(kind, shape):
    return shape[-1:] if kind in ("conv_b", "lin_b") else shape


SHAPES = tree_shapes(_params(_shape_of))


def init_params(seed, dtype=np.float32):
    """Random DPT-hybrid params (``pfd_tpu``'s pytree, numpy) drawn from
    ``numpy.random.default_rng(seed)``: convs and linears fan-in-scaled
    uniform with their biases, norms ones and zeros, the cls token zero,
    the position embedding N(0, 0.02^2), as ``pfd_tpu``'s ``init_params``
    draws them from ``jax.random``."""
    rng = np.random.default_rng(seed)

    def draw(kind, shape):
        if kind in ("ones", "zeros"):
            return (np.ones if kind == "ones" else np.zeros)(shape, dtype)
        if kind == "pos":
            return (rng.standard_normal(shape) * 0.02).astype(dtype)
        bound = 1.0 / np.sqrt(np.prod(shape[:-1]))
        if kind.endswith("_w"):
            return rng.uniform(-np.sqrt(3.0) * bound, np.sqrt(3.0) * bound, shape).astype(dtype)
        return rng.uniform(-bound, bound, shape[-1:]).astype(dtype)

    return _params(draw)


def convert_sd(sd) -> dict:
    """An upstream state dict -> the port's: the classifier-only leaves
    dropped (``_CLASSIFIER``)."""
    return {k: v for k, v in sd.items() if not k.startswith(_CLASSIFIER)}


def get_params(root=None):
    return load_torch_params(pretrained_path("midas", "dpt_hybrid-midas-501f0c75.pt", root=root),
                             convert_sd)


def depth_map(net, image01: np.ndarray) -> np.ndarray:
    """image01: (H, W, 3) [0,1] -> the (H, W) float32 inverse depth of the
    edge-padded (to multiples of 32) input."""
    h, w = image01.shape[:2]
    pad_h, pad_w = (32 - h % 32) % 32, (32 - w % 32) % 32
    x = np.asarray(image01, np.float32) * 255.0 / 127.5 - 1.0
    if pad_h or pad_w:
        x = np.pad(x, ((0, pad_h), (0, pad_w), (0, 0)), mode="edge")
    t = torch.as_tensor(x.transpose(2, 0, 1)[None].copy(), device=device_of(net))
    with torch.no_grad():
        return dpt_hybrid_forward(net, t)[0, :h, :w].cpu().numpy()


def apply_midas(image01: np.ndarray, params=None, a=np.pi * 2.0, bg_th=0.1, root=None,
                device="cuda"):
    """image01: (H, W, 3) [0,1]. Returns (depth uint8 (H,W), normal uint8
    (H,W,3) BGR-flipped) from one forward (reference midas/__init__.py:15-46)."""
    depth = depth_map(network("midas", SHAPES, params, root, device, get_params), image01)
    depth_pt = depth - depth.min()
    depth_pt = depth_pt / max(depth_pt.max(), 1e-8)
    depth_image = (depth_pt * 255.0).clip(0, 255).astype(np.uint8)

    gx, gy = imageops.sobel(depth)
    z = np.ones_like(gx) * a
    gx[depth_pt < bg_th] = 0
    gy[depth_pt < bg_th] = 0
    normal = np.stack([gx, gy, z], axis=2)
    normal /= np.sum(normal ** 2.0, axis=2, keepdims=True) ** 0.5
    normal_image = (normal * 127.5 + 127.5).clip(0, 255).astype(np.uint8)[:, :, ::-1]
    return depth_image, normal_image
