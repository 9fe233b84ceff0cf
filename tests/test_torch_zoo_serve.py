"""The port's batched servers (``pfd_tpu_torch/parallel``) against
``pfd_tpu/parallel``'s, on a tiny ``pfd_with_control`` with ``pfd_tpu``'s
random weights, fp32 on the CPU.

``_sample_body`` of both servers (SeeCoder -> CFG DDIM -> VAE decode, with
per-request hints and control mask) gives ``pfd_tpu``'s images from the same
weights, refs, hints, mask and start latent (max-abs 1e-4; one program
against the other in fp32). Then the port's own contracts, as
``tests/test_zoo_serve.py`` pins ``pfd_tpu``'s: a mixed batch equals its
requests served one by one (``pfd_tpu``'s limits, rtol 1e-4 / atol 1e-5:
another batch size sums in another order); the sharded mode
(``devices=[cpu, cpu]``) equals the grouped one; a request with control
off equals the no-hint request exactly; the guards and errors.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfd_tpu import registry as jreg
from pfd_tpu.parallel import mesh as mesh_lib
from pfd_tpu.parallel.serve import DataParallelServer as JDP
from pfd_tpu.parallel.zoo_serve import ZooServer as JZoo
from pfd_tpu_torch.io.convert import params_from_jax
from pfd_tpu_torch.models.build import build_model
from pfd_tpu_torch.parallel import DataParallelServer, ZooServer
from pfd_tpu_torch.parallel.serve import nchw
from tests.test_pipeline_hotswap import TINY_PFD
from tests.test_torch_nn import numpy_params

torch.set_num_threads(1)

STEPS, H, W = 2, 64, 64


@pytest.fixture(scope="module")
def tiny():
    """pfd_tpu's model and two weight sets (their diffusers: tags "a", "b"),
    the port's model holding the first, and seeded refs and hints."""
    jm = jreg.get(TINY_PFD["type"])(**TINY_PFD["args"])
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    params = numpy_params(jm, 0, shapes)
    params_b = numpy_params(jm, 1, shapes)
    tm = build_model(TINY_PFD, device="cpu")
    tm.load_state_dict(params_from_jax(params), strict=True)
    zoo = {"a": params_from_jax(params["diffuser"]), "b": params_from_jax(params_b["diffuser"])}
    rng = np.random.default_rng(0)
    refs = rng.random((4, H, W, 3), dtype=np.float32)
    hints = np.zeros((4, H, W, 3), np.float32)
    for i in range(4):
        hints[i, 8 + 4 * i:40 + 4 * i, 12:52 - 4 * i] = 1.0
    return jm, params, params_b, tm, zoo, refs, hints


def _close(got, want, atol=1e-4):
    got = got.permute(0, 2, 3, 1).numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape and want.std() > 0.02
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def test_dp_sample_body_matches_pfd_tpu(tiny):
    """pfd_tpu's DataParallelServer.generate (one device; its start latent
    from split(PRNGKey(seed))) against the port's ``_sample_body`` on that
    latent, with hints."""
    jm, params, _, tm, zoo, refs, hints = tiny
    tm.diffuser.load_state_dict(zoo["a"], strict=True)  # the weights pfd_tpu's server holds
    jdp = JDP(jm, params, mesh_lib.make_mesh(jax.devices()[:1]), steps=STEPS)
    want = jdp.generate(refs[:2], hints[:2], h=H, w=W, seed=4)
    _, init_rng = jax.random.split(jax.random.PRNGKey(4))
    x = np.array(jax.random.normal(init_rng, (2, H // 8, W // 8, 4), jnp.float32))
    dp = DataParallelServer(tm, ["cpu"], steps=STEPS)
    got = dp._sample_body(nchw(refs[:2], "cpu"), nchw(hints[:2], "cpu"), nchw(x, "cpu"), 2.0)
    _close(got, want)


def test_zoo_sample_body_matches_pfd_tpu(tiny):
    """pfd_tpu's ZooServer._sample_body with diffuser "b", hints and a
    mixed control mask, against the port's with "b" swapped in."""
    jm, params, params_b, tm, zoo, refs, hints = tiny
    jzs = JZoo(jm, params, {"a": params["diffuser"], "b": params_b["diffuser"]},
               mesh=mesh_lib.make_mesh(jax.devices()[:1]), steps=STEPS)
    x = jzs.init_noise(jax.random.PRNGKey(6), 3, H, W)
    mask = np.asarray([1.0, 0.0, 1.0], np.float32)
    p = dict(params, diffuser=params_b["diffuser"])
    body = jax.jit(functools.partial(jzs._sample_body, h=H, w=W, batch=3, has_control=True))
    want = body(p, jax.random.PRNGKey(6), x, jnp.asarray(refs[:3]), jnp.asarray(hints[:3]),
                jnp.asarray(mask), jnp.float32(2.0))
    zs = ZooServer(tm, zoo, devices=["cpu"], steps=STEPS)
    zs._swap(tm, "b", None)
    got = zs._sample_body(nchw(np.array(x), "cpu"), nchw(refs[:3], "cpu"),
                          nchw(hints[:3], "cpu"), torch.from_numpy(mask), 2.0)
    _close(got, want)


@pytest.fixture(scope="module")
def zoo_server(tiny):
    _, _, _, tm, zoo, _, _ = tiny
    return ZooServer(tm, zoo, devices=["cpu"], steps=STEPS)


def _single(zs, tag, ref, x, hint=None):
    """One request alone: its tag swapped in, batch 1, no mask."""
    zs._swap(zs.model, tag, None)
    return zs._sample_body(x[None], nchw(ref[None], "cpu"),
                           None if hint is None else nchw(hint[None], "cpu"), None, 2.0)


def test_mixed_batch_equals_single_requests(tiny, zoo_server):
    _, _, _, _, _, refs, hints = tiny
    tags, on = ["a", "b", "a", "b"], [1, 0, 0, 1]
    out = zoo_server.generate(refs, tags, hints=hints, control_on=on, h=H, w=W, seed=3)
    assert out.shape == (4, H, W, 3) and torch.isfinite(out).all()
    x = zoo_server.init_noise(3, 4, H, W)
    for i in range(4):
        want = _single(zoo_server, tags[i], refs[i], x[i], hints[i] if on[i] else None)
        np.testing.assert_allclose(out[i].numpy(), want[0].permute(1, 2, 0).numpy(),
                                   rtol=1e-4, atol=1e-5)
    assert not torch.allclose(out[0], out[2], atol=1e-3)  # the hint matters
    assert not torch.allclose(out[1], out[2], atol=1e-3)  # so does the checkpoint


def test_control_off_equals_no_hint_exactly(tiny, zoo_server):
    _, _, _, _, _, refs, hints = tiny
    x = zoo_server.init_noise(8, 1, H, W)
    zoo_server._swap(zoo_server.model, "a", None)
    off = zoo_server._sample_body(x, nchw(refs[:1], "cpu"), nchw(hints[:1], "cpu"),
                                  torch.zeros(1), 2.0)
    assert torch.equal(off, _single(zoo_server, "a", refs[0], x[0]))


def test_sharded_equals_grouped(tiny):
    """Two requests on devices=[cpu, cpu] (a replica each: sharded mode)
    against the same requests grouped on one device."""
    _, _, _, tm, zoo, refs, hints = tiny
    two = ZooServer(tm, zoo, devices=["cpu", "cpu"], steps=STEPS)
    assert len(two.replicas) == 2 and two.replicas[1] is not two.model
    tags, on = ["b", "a"], [1, 1]
    sharded = two.generate(refs[:2], tags, hints=hints[:2], control_on=on, h=H, w=W, seed=9)
    one = ZooServer(tm, zoo, devices=["cpu"], steps=STEPS)
    grouped = one.generate(refs[:2], tags, hints=hints[:2], control_on=on, h=H, w=W, seed=9)
    assert torch.equal(sharded, grouped)
    # a batch of 1 on one device is the sharded mode: the same request grouped
    x = one.init_noise(9, 1, H, W)
    b1 = one._generate_grouped(x, nchw(refs[:1], "cpu"), ["b"], [None],
                               nchw(hints[:1], "cpu"), np.ones(1, np.float32), 2.0)
    assert torch.equal(one.generate(refs[:1], ["b"], hints=hints[:1], h=H, w=W, seed=9),
                       b1.permute(0, 2, 3, 1))


def test_dp_splits_the_batch_over_devices(tiny):
    """devices=[cpu, cpu]: each replica runs half the batch, from the start
    latents the one-device server draws."""
    _, _, _, tm, _, refs, _ = tiny
    one = DataParallelServer(tm, ["cpu"], steps=STEPS).generate(refs, h=H, w=W, seed=2)
    two = DataParallelServer(tm, ["cpu", "cpu"], steps=STEPS).generate(refs, h=H, w=W, seed=2)
    assert one.shape == (4, H, W, 3) and torch.isfinite(one).all()
    np.testing.assert_allclose(two.numpy(), one.numpy(), rtol=1e-4, atol=1e-5)


def test_guards_and_errors(tiny, zoo_server):
    _, _, _, tm, zoo, refs, _ = tiny
    with pytest.raises(ValueError, match="one diffuser tag"):
        zoo_server.generate(refs[:2], ["a"], h=H, w=W)
    with pytest.raises(ValueError, match="no hints"):
        zoo_server.generate(refs[:2], ["a", "a"], control_on=[True, False], h=H, w=W)
    with pytest.raises(KeyError):
        zoo_server.generate(refs[:2], ["a", "nope"], h=H, w=W)
    with pytest.raises(ValueError, match="divide"):
        DataParallelServer(tm, ["cpu", "cpu"], steps=STEPS).generate(refs[:3], h=H, w=W)
    with pytest.raises(ValueError, match="does not fit"):
        ZooServer(tm, {"a": {k: v for k, v in zoo["a"].items() if "out" not in k}},
                  devices=["cpu"])
    turbo = DataParallelServer(tm, ["cpu"], steps=4, encoder_interval=2, cfg_interval=2,
                               deep_interval=2, phases=None)
    assert turbo._intervals(True) == (1, 1, 1, None)  # control samples exactly
    assert turbo._intervals(False) == (2, 2, 2, None)
    turbo.control_turbo = True
    assert turbo._intervals(True) == (2, 2, 2, None)
    assert turbo.warmup([(64, 64), (64, 128)], batch=8) == [(64, 64, 8, False),
                                                            (64, 128, 8, False)]
