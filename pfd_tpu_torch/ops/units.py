"""Unit/activation registry with spec-string parsing (the port of
``pfd_tpu/ops/units.py``).

The reference's ``get_unit`` surface (lib/model_zoo/common/utils.py:41-292):
a name registry resolved from spec strings like ``"lrelu_agc(alpha=0.1,
gain=sqrt_2, clamp=256)"``. ``get_unit(spec)`` returns the registered unit
(for a bare name) or a ``functools.partial`` factory over the parsed kwargs,
and ``get_unit(spec)()`` always yields the callable: class units construct,
function units return the function from a zero-arg factory. The grammar is
``pfd_tpu``'s, copied (pure Python).

Units (reference utils.py lines): none (45), relu/relu6/lrelu (48-50),
dropout/dropout2d (51-52; the identity at inference, as in ``pfd_tpu``),
sine (96-106) / relusine (108-115), lrelu_agc (117-149), se =
``SpatialEncoding`` log-spaced Fourier features (152-211), rffe =
``RFFEncoding`` random Fourier features (213-236). The Fourier units are
``nn.Module``s whose bank ``emb`` is a persistent buffer, or an
``nn.Parameter`` with ``require_grad`` (the reference's trainable bank), so
``pfd_tpu``'s ``params()`` loads into them through ``params_from_jax``. Their
``'[bs x c x 2D]'`` format takes NCHW feature maps, as the reference does
(``pfd_tpu`` reads NHWC there). The reference's ``conv``/``bn`` entries are
layers with parameters, not units, and are left out as in ``pfd_tpu``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def _str2value(v):
    """Reference utils.py:23-37 semantics: int, then float, then bool, else str."""
    v = v.strip()
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            pass
    if v in ("True", "true"):
        return True
    if v in ("False", "false"):
        return False
    return v


def _parse_kwargs(argstr):
    """Parse ``k=v, k2=(1,2), k3=[a,b]`` (the grammar of utils.py:73-88)."""
    kwargs = {}
    depth = 0
    parts, cur = [], []
    for ch in argstr:
        if ch in "([":
            depth += 1
        elif ch in ")]":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if cur:
        parts.append("".join(cur))
    for part in parts:
        if not part.strip():
            continue
        k, _, v = part.partition("=")
        k, v = k.strip(), v.strip()
        if v[:1] == "(" and v[-1:] == ")":
            kwargs[k] = tuple(_str2value(i) for i in v[1:-1].split(","))
        elif v[:1] == "[" and v[-1:] == "]":
            kwargs[k] = [_str2value(i) for i in v[1:-1].split(",")]
        else:
            kwargs[k] = _str2value(v)
    return kwargs


_UNITS = {}


def register(name):
    def wrapper(obj):
        _UNITS[name] = obj
        return obj
    return wrapper


def get_unit(spec):
    """Resolve a unit spec string (reference utils.py:62-88): ``None`` or
    'none' -> None; a bare name -> the registered unit factory; a name with
    an argument list -> ``functools.partial(factory, **parsed_kwargs)``."""
    if spec is None:
        return None
    i = spec.find("(")
    i = len(spec) if i == -1 else i
    unit = _UNITS[spec[:i].strip()]
    # one layer of parens: a tuple value in final position keeps its own
    argstr = "" if i == len(spec) else spec[i + 1:spec.rfind(")")]
    if not argstr.strip():
        return unit
    return functools.partial(unit, **_parse_kwargs(argstr))


def _fn_unit(name, fn):
    """Register a plain function as a zero-arg factory."""
    register(name)(lambda: fn)
    return fn


register("none")(None)
relu = _fn_unit("relu", F.relu)
relu6 = _fn_unit("relu6", F.relu6)


@register("lrelu")
def lrelu(negative_slope=0.01):
    """Factory: lrelu(negative_slope=a)() -> leaky-relu callable."""
    return lambda x: F.leaky_relu(x, negative_slope)


@register("dropout")
@register("dropout2d")
def dropout_eval(p=0.5):
    """Inference-mode dropout: the identity."""
    del p
    return lambda x: x


@register("sine")
class Sine:
    """sin(freq*x)*gain (reference utils.py:96-106)."""

    def __init__(self, freq, gain=1):
        self.freq, self.gain = freq, gain

    def __call__(self, x, gain=1):
        return torch.sin(self.freq * x) * (self.gain * gain)

    def __repr__(self):
        return f"sine(freq={self.freq}, gain={self.gain})"


def relusine(x):
    """sin(30x) + relu(x) (reference utils.py:108-115)."""
    return torch.sin(30.0 * x) + F.relu(x)


_fn_unit("relusine", relusine)


@register("lrelu_agc")
class LReluAGC:
    """Leaky ReLU with alpha / gain / clamp (reference utils.py:117-149):
    ``gain='sqrt_2'`` is sqrt(2); the clamp scales with the call-time gain."""

    def __init__(self, alpha=0.1, gain=1, clamp=None):
        self.alpha = alpha
        self.gain = float(np.sqrt(2)) if gain == "sqrt_2" else gain
        self.clamp = clamp

    def __call__(self, x, gain=1):
        x = F.leaky_relu(x, self.alpha)
        act_gain = self.gain * gain
        if act_gain != 1:
            x = x * act_gain
        if self.clamp is not None:
            c = self.clamp * gain
            x = torch.clamp(x, -c, c)
        return x

    def __repr__(self):
        return (f"lrelu_agc(alpha={self.alpha}, gain={self.gain}, "
                f"clamp={self.clamp})")


@register("se")
class SpatialEncoding(nn.Module):
    """Log-spaced Fourier spatial encoding (reference utils.py:152-211):
    ``emb`` rows are 2**linspace(0, sigma, out_dim/2/in_dim) frequencies
    placed per input dimension; forward is ``cat([x,] sin(x @ emb.T),
    cos(x @ emb.T))`` on ``(n, c)`` inputs, or per pixel of an NCHW map with
    ``format='[bs x c x 2D]'``."""

    def __init__(self, in_dim, out_dim, sigma=6, cat_input=True, require_grad=False):
        super().__init__()
        assert out_dim % (2 * in_dim) == 0, "dimension must be dividable"
        self.in_dim, self.out_dim, self.sigma = in_dim, out_dim, sigma
        self.cat_input = cat_input
        self.require_grad = require_grad
        self._set_bank(self.bank())

    def bank(self):
        n = self.out_dim // 2 // self.in_dim
        m = 2.0 ** np.linspace(0, self.sigma, n)
        m = np.stack([m] + [np.zeros_like(m)] * (self.in_dim - 1), axis=-1)
        return np.concatenate([np.roll(m, i, axis=-1) for i in range(self.in_dim)], axis=0)

    def _set_bank(self, m):
        emb = torch.as_tensor(np.asarray(m, np.float32))
        if self.require_grad:
            self.emb = nn.Parameter(emb)
        else:
            self.register_buffer("emb", emb)

    def forward(self, x, format="[n x c]"):
        if format == "[bs x c x 2D]":
            b, _, h, w = x.shape
            flat = x.permute(0, 2, 3, 1).reshape(-1, x.shape[1])
        elif format == "[n x c]":
            flat = x
        else:
            raise ValueError(format)
        y = flat @ self.emb.to(flat.dtype).T
        z = torch.cat(([flat] if self.cat_input else []) + [torch.sin(y), torch.cos(y)], dim=-1)
        if format == "[bs x c x 2D]":
            z = z.reshape(b, h, w, -1).permute(0, 3, 1, 2)
        return z


@register("rffe")
class RFFEncoding(SpatialEncoding):
    """Random Fourier features (reference utils.py:213-236): ``emb`` ~
    N(0, sigma), drawn from ``numpy.random.default_rng(seed)`` as
    ``pfd_tpu`` draws it, so the two banks are equal."""

    def __init__(self, in_dim, out_dim, sigma=6, cat_input=True, require_grad=False,
                 seed=0):
        self.seed = seed
        super().__init__(in_dim, out_dim, sigma, cat_input, require_grad)

    def bank(self):
        rng = np.random.default_rng(self.seed)
        return rng.normal(0.0, self.sigma, size=(self.out_dim // 2, self.in_dim))
