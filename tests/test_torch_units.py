"""The unit registry (``ops/units.py``): the port against pfd_tpu on the CPU.

The spec-string grammar gives pfd_tpu's keywords on every spec of a list
(tuples, lists, bools, numbers, strings, a tuple in final position); each
unit gives pfd_tpu's output on the same numpy input (fp32, atol 1e-6):
relu, relu6, lrelu, the dropouts (the identity at inference), sine,
relusine, lrelu_agc, and the Fourier encodings ``se`` and ``rffe`` on
(n, c) inputs and on feature maps (NCHW in the port, NHWC in pfd_tpu), their
banks equal to pfd_tpu's (``rffe``'s drawn from the same numpy seed) and,
with ``require_grad``, an ``nn.Parameter`` that pfd_tpu's ``params()``
loads into through ``params_from_jax``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfd_tpu.ops import units as junits
from pfd_tpu_torch.io.convert import params_from_jax
from pfd_tpu_torch.ops import units

torch.set_num_threads(1)

SPECS = ["none", "relu", "lrelu", "lrelu(negative_slope=0.2)",
         "lrelu_agc(alpha=0.2, gain=sqrt_2, clamp=256)", "lrelu_agc(alpha=0.1, gain=2)",
         "sine(freq=30, gain=1.5)", "se(in_dim=2, out_dim=8, cat_input=False)",
         "se(in_dim=2, out_dim=8, k=(1,2))", "rffe(in_dim=3, out_dim=12, sigma=2.5, seed=7)",
         "dropout(p=0.1)", "x(a=[1, 2.5, true], b=(x, False), c=-3, d=1e-3)"]


@pytest.mark.parametrize("spec", SPECS)
def test_spec_string_grammar(spec):
    i = spec.find("(")
    if i != -1:
        argstr = spec[i + 1:spec.rfind(")")]
        assert units._parse_kwargs(argstr) == junits._parse_kwargs(argstr)
    name = spec if i == -1 else spec[:i]
    if name not in units._UNITS:
        return  # the grammar alone
    got, want = units.get_unit(spec), junits.get_unit(spec)
    if want is None or i == -1:
        assert (got is None) == (want is None)
        return
    assert got.keywords == want.keywords


def test_registry_names_and_bare_units():
    assert set(units._UNITS) == set(junits._UNITS)
    assert units.get_unit(None) is None and units.get_unit("none") is None
    assert units.get_unit("relusine")() is units.relusine


X = np.random.default_rng(0).standard_normal((4, 8)).astype(np.float32) * 2


@pytest.mark.parametrize("spec,gain", [
    ("relu", None), ("relu6", None), ("lrelu", None), ("lrelu(negative_slope=0.2)", None),
    ("dropout", None), ("dropout2d(p=0.3)", None), ("relusine", None),
    ("sine(freq=3, gain=2)", 0.5),
    ("lrelu_agc(alpha=0.2, gain=sqrt_2, clamp=1.5)", 0.7), ("lrelu_agc(alpha=0.1, gain=2)", 0.7),
    ("lrelu_agc", 0.7)])
def test_unit_matches_pfd_tpu(spec, gain):
    kw = {} if gain is None else {"gain": gain}
    got = units.get_unit(spec)()(torch.from_numpy(X), **kw).numpy()
    want = np.asarray(junits.get_unit(spec)()(jnp.asarray(X), **kw))
    assert np.abs(want).max() > 1e-2
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("spec", ["se(in_dim=2, out_dim=16, sigma=4)",
                                  "se(in_dim=3, out_dim=12, cat_input=False)",
                                  "rffe(in_dim=2, out_dim=32, sigma=6)",
                                  "rffe(in_dim=3, out_dim=12, sigma=2.5, seed=7)"])
@pytest.mark.parametrize("require_grad", [False, True])
def test_fourier_encodings_match_pfd_tpu(spec, require_grad):
    tu = units.get_unit(spec)(require_grad=require_grad)
    ju = junits.get_unit(spec)(require_grad=require_grad)
    np.testing.assert_array_equal(tu.emb.detach().numpy(), np.asarray(ju.emb))
    assert isinstance(tu.emb, torch.nn.Parameter) == require_grad
    tu.load_state_dict(params_from_jax(ju.params()), strict=True)
    rng = np.random.default_rng(len(spec))
    x = rng.random((5, ju.in_dim)).astype(np.float32)
    with torch.no_grad():
        got = tu(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(ju(jnp.asarray(x))), rtol=0, atol=1e-5)
    # feature maps: NCHW in the port, NHWC in pfd_tpu
    fm = rng.random((2, 3, 4, ju.in_dim)).astype(np.float32)
    with torch.no_grad():
        got = tu(torch.from_numpy(fm.transpose(0, 3, 1, 2).copy()), format="[bs x c x 2D]")
    want = np.asarray(ju(jnp.asarray(fm), format="[bs x c x 2D]"))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want, rtol=0, atol=1e-5)
    with pytest.raises(ValueError):
        tu(torch.from_numpy(x), format="[n x c x t]")
