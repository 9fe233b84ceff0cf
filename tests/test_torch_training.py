"""The training path: the port's p_losses, optimizers, schedulers, EMA, train
step, Trainer and checkpoints against pfd_tpu's, fp32 on the CPU.

pfd_tpu's ``TINY_UNET`` diffuser (tests/test_training.py) with one numpy
weight set, loaded into the port through ``params_from_jax``; the same numpy
batches go through both (NHWC for pfd_tpu, NCHW for the port), and pfd_tpu
runs on a one-device mesh. Tolerances are stated at each check: relative
1e-6 for losses, relative L2 1e-5 per gradient leaf (a leaf whose exact
gradient is 0, as where a GroupNorm of one channel a group cancels a bias or
the time embedding before it, is rounding noise of ~1e-9: it is held to
1e-7 of the whole gradient's norm), relative L2 1e-6 per leaf for the
optimizers on given gradients and 1e-5 for parameters after train steps at
lr 1e-4 (AdamW's first step is sign-like: an element whose gradient is as
small as its rounding moves by up to lr either way, so a train step is held
per leaf, not per element), equality for schedules and for
what a resume restores.
"""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pfd_tpu import registry as jreg
from pfd_tpu.io.convert import pytree_to_torch_sd as jax_to_sd
from pfd_tpu.parallel import mesh as mesh_lib
from pfd_tpu.parallel import train as jtrain
from pfd_tpu.training import ema as jema
from pfd_tpu.training import optimizers as jopt
from pfd_tpu.training import schedulers as jsched
from pfd_tpu.training.harness import TrainConfig as JConfig, Trainer as JTrainer
from pfd_tpu_torch.io import checkpoint as tckpt
from pfd_tpu_torch.io.convert import params_from_jax, pytree_to_torch_sd
from pfd_tpu_torch.io.loader import load_safetensors
from pfd_tpu_torch.models.build import build_model
from pfd_tpu_torch.parallel import train as ttrain
from pfd_tpu_torch.policy import FP32
from pfd_tpu_torch.training import ema as tema
from pfd_tpu_torch.training import evaluator as teval
from pfd_tpu_torch.training import optimizers as topt
from pfd_tpu_torch.training import schedulers as tsched
from pfd_tpu_torch.training.harness import TrainConfig, Trainer
from tests.test_torch_nn import numpy_params
from tests.test_training import TINY_UNET

torch.set_num_threads(1)

PFD = {"type": "pfd", "args": dict(
    vae_cfg_list=[], ctx_cfg_list=[], diffuser_cfg_list=[["image", TINY_UNET]],
    beta_linear_start=0.00085, beta_linear_end=0.012, timesteps=1000)}
# the update tests' diffuser: TINY_UNET at 64 channels. At 32, GroupNorm's 32
# groups hold one channel each, so the biases and time embeddings ahead of a
# norm have an exact gradient of 0: fp32 noise, which AdamW's sign-like step
# turns into updates of up to lr that no two implementations share.
UNET64 = copy.deepcopy(TINY_UNET)
UNET64["args"]["model_channels"] = 64
PFD64 = copy.deepcopy(PFD)
PFD64["args"]["diffuser_cfg_list"] = [["image", UNET64]]


@pytest.fixture(scope="module")
def weights():
    jm = jreg.get("pfd")(**PFD["args"])
    return numpy_params(jm, 0)


@pytest.fixture(scope="module")
def weights64():
    jm = jreg.get("pfd")(**PFD64["args"])
    return numpy_params(jm, 0)


def _pair(params, cfg=PFD, **args):
    cfg = copy.deepcopy(cfg)
    cfg["args"].update(args)
    jm = jreg.get("pfd")(**cfg["args"])
    tm = build_model(cfg, policy=FP32, device="cpu")
    tm.load_state_dict(params_from_jax(params), strict=True)
    return jm, tm


def _batch(seed, b=2, lead=()):
    """A numpy batch, NHWC (pfd_tpu's) with optional leading dims."""
    rng = np.random.default_rng(seed)
    return {"x0": rng.standard_normal(lead + (b, 8, 8, 4)).astype(np.float32),
            "cond": rng.standard_normal(lead + (b, 8, 64)).astype(np.float32),
            "t": rng.integers(0, 1000, lead + (b,)).astype(np.int32),
            "noise": rng.standard_normal(lead + (b, 8, 8, 4)).astype(np.float32)}


def _nchw(batch):
    out = dict(batch)
    for k in ("x0", "noise"):
        a = batch[k]
        out[k] = np.ascontiguousarray(np.moveaxis(a, -1, -3))
    return out


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def assert_grads_close(named, want, tol):
    """Each parameter's gradient within relative L2 ``tol`` of ``want[name]``;
    a leaf whose exact gradient is 0 (its norm under 1e-4 of the whole
    gradient's) is rounding noise, held to 1e-7 of the whole gradient's norm."""
    named = list(named)
    total = np.sqrt(sum(np.sum(np.square(want[n], dtype=np.float64)) for n, _ in named))
    for name, p in named:
        if np.linalg.norm(want[name]) >= 1e-4 * total:
            assert _rel(p.grad.numpy(), want[name]) <= tol, name
        else:
            assert np.linalg.norm(p.grad.numpy() - want[name]) <= 1e-7 * total, name


def _assert_params_close(tparams, jparams, tol):
    """Each leaf within relative L2 ``tol`` of pfd_tpu's."""
    want = jax_to_sd(jax.tree.map(np.asarray, jparams))
    for name, p in tparams.items():
        assert _rel(p.detach().numpy(), want[name]) <= tol, name


def test_p_losses_and_gradients_match_pfd_tpu(weights):
    """l1 and l2, eps and x0 parameterisation, with the VLB term on: loss and
    aux within 1e-6 relative, every gradient leaf within relative L2 1e-5 of
    ``jax.grad``'s."""
    batch = _batch(3)
    tb = {k: torch.from_numpy(v) for k, v in _nchw(batch).items()}
    tb["t"] = tb["t"].long()
    combos = [(lt, par) for lt in ("l1", "l2") for par in ("eps", "x0")]
    pairs = [_pair(weights, loss_type=lt, parameterization=par, l_elbo_weight=0.5)
             for lt, par in combos]

    def all_losses(p):
        return [jax.value_and_grad(lambda q, m=jm: m.p_losses(
            q, batch["x0"], batch["t"], batch["cond"], batch["noise"]), has_aux=True)(p)
            for jm, _ in pairs]

    results = jax.jit(all_losses)(weights)
    for (lt, par), (_, tm), ((jloss, jaux), jgrads) in zip(combos, pairs, results):
        tm.requires_grad_(True)
        loss, aux = tm.p_losses(tb["x0"], tb["t"], tb["cond"], tb["noise"])
        loss.backward()
        for got, want in [(loss, jloss), (aux["loss_simple"], jaux["loss_simple"]),
                          (aux["loss_vlb"], jaux["loss_vlb"])]:
            np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6,
                                       err_msg=f"{lt} {par}")
        assert_grads_close(tm.named_parameters(), jax_to_sd(jax.tree.map(np.asarray, jgrads)),
                           1e-5)


# ---- the optimizer factory ----------------------------------------------------

def _opt_tree(rng):
    def leaf(*s):
        return rng.standard_normal(s).astype(np.float32)
    return {"diffuser": {"image": {"time_embed": {"0": {"kernel": leaf(4, 3), "bias": leaf(3)}},
                                   "data_blocks": {"0": {"kernel": leaf(3, 3, 2, 5)}},
                                   "context_blocks": {"0": {"kernel": leaf(5, 2)}},
                                   "out": {"scale": leaf(6)}}},
            "vae": {"image": {"w": {"kernel": leaf(2, 4)}}},
            "ctl": {"w": {"kernel": leaf(3, 2)}}}


@pytest.mark.parametrize("opt_type,args", [
    ("sgd", {"lr": 1e-2, "momentum": 0.9, "weight_decay": 0.3}),
    ("adam", {"lr": 1e-2, "betas": (0.8, 0.99), "weight_decay": 0.3}),
    ("adamw", {"lr": 1e-2, "weight_decay": 0.3}),
])
@pytest.mark.parametrize("clip", [0.5, 1e3])
@pytest.mark.parametrize("schedule", [False, True])
def test_build_optimizer_matches_optax(opt_type, args, clip, schedule):
    """Three updates of labelled groups with lr scales, a frozen label,
    clipping binding (0.5) or not (1e3) and a float or callable lr: every
    parameter leaf within relative L2 1e-6 of optax's, the frozen ones equal."""
    rng = np.random.default_rng(7)
    params = _opt_tree(rng)
    grads = [jax.tree.map(lambda a: 3 * rng.standard_normal(a.shape).astype(np.float32),
                          params) for _ in range(3)]
    jlabels = jopt.pfd_parameter_groups(params)
    scales = {"diffuser_image_data": 0.5, "ctl": 2.0}
    lr = (lambda step: 1e-2 * 0.7 ** step) if schedule else None

    tx = jopt.build_optimizer(opt_type, args, labels=jlabels, lr_scales=scales,
                              learning_rate=lr, grad_clip=clip)
    jp, st = jax.tree.map(jnp.asarray, params), None
    st = tx.init(jp)
    for g in grads:
        upd, st = tx.update(g, st, jp)
        jp = optax.apply_updates(jp, upd)

    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
               for k, v in pytree_to_torch_sd(params).items()}
    labels = topt.pfd_parameter_groups(tparams.items())
    assert labels == {k: str(v) for k, v in pytree_to_torch_sd(jlabels).items()}
    opt = topt.build_optimizer(opt_type, args, labels=labels, lr_scales=scales,
                               learning_rate=lr, grad_clip=clip)
    state = opt.init(tparams)
    for g in grads:
        for k, v in pytree_to_torch_sd(g).items():
            tparams[k].grad = torch.from_numpy(v.copy())
        opt.update(state)

    want = jax_to_sd(jax.tree.map(np.asarray, jp))
    for k, p in tparams.items():
        if labels[k] == "frozen":
            assert np.array_equal(p.detach().numpy(), pytree_to_torch_sd(params)[k]), k
        assert _rel(p.detach().numpy(), want[k]) <= 1e-6, k
    moved = [k for k in tparams if labels[k] != "frozen"]
    assert all(not np.array_equal(tparams[k].detach().numpy(), pytree_to_torch_sd(params)[k])
               for k in moved)


def test_global_norm_clip_is_optaxs_rule():
    """Clipping scales by max_norm / norm where norm >= max_norm (optax), not
    by max_norm / (norm + 1e-6) (``clip_grad_norm_``), and leaves a norm
    below the bound as it is."""
    for g0, clip in ((np.array([3.0, 4.0], np.float32), 1.0), (np.array([0.3, 0.4]), 1.0)):
        p = torch.nn.Parameter(torch.zeros(2))
        opt = topt.build_optimizer("sgd", {"lr": 1.0}, grad_clip=clip)
        state = opt.init({"p": p})
        p.grad = torch.from_numpy(g0.astype(np.float32))
        opt.update(state)
        want = optax.clip_by_global_norm(clip).update(jnp.asarray(g0, jnp.float32), None)[0]
        assert np.array_equal(-p.detach().numpy(), np.asarray(want))


def test_scheduler_bank_matches_pfd_tpu():
    """Every scheduler of the bank, composed lists and the cosine warm-ups:
    the same value at each of 200 steps."""
    cfgs = [
        {"type": "constant", "args": {"lr": 0.1, "step": 200}},
        {"type": "poly", "args": {"start_lr": 1.0, "end_lr": 0.01, "power": 2, "step": 200}},
        {"type": "linear", "args": {"start_lr": 1.0, "end_lr": 0.0, "step": 200}},
        {"type": "multistage", "args": {"start_lr": 1.0, "milestones": [50, 120],
                                        "gamma": 0.3, "step": 200}},
        [{"type": "constant", "args": {"lr": 1.0, "step": 50}},
         {"type": "linear", "args": {"start_lr": 1.0, "end_lr": 0.0, "step": 150}}],
        {"type": "stable_diffusion_linear", "args": {
            "base_lr": 1e-4, "warm_up_steps": [20, 10], "f_min": [0.1, 0.05],
            "f_max": [1.0, 0.5], "f_start": [0.0, 0.1], "cycle_lengths": [100, 100]}},
    ]
    pairs = [(jsched.build(c), tsched.build(c)) for c in cfgs]
    pairs += [(jsched.LambdaWarmUpCosine(1e-4, 30, 0.1, 1.0, 0.0, 200),
               tsched.LambdaWarmUpCosine(1e-4, 30, 0.1, 1.0, 0.0, 200))]
    pairs += [(jsched.LambdaWarmUpCosine2(1e-4, [20, 10], [0.1, 0.05], [1.0, 0.5], [0.0, 0.1],
                                          [100, 100]),
               tsched.LambdaWarmUpCosine2(1e-4, [20, 10], [0.1, 0.05], [1.0, 0.5], [0.0, 0.1],
                                          [100, 100]))]
    assert sorted(jsched._BANK) == sorted(tsched._BANK)
    for js, ts in pairs:
        assert ts.step == js.step
        assert [ts(i) for i in range(200)] == [js(i) for i in range(200)]


def test_ema_matches_pfd_tpu():
    """init, five updates toward moving parameters (the warm-up decay, and a
    fixed decay) and copy_to: within 1e-7; the shadows keep their dtype."""
    rng = np.random.default_rng(5)
    for use_n in (True, False):
        p0 = {"a": rng.standard_normal((4, 3)).astype(np.float32),
              "b": rng.standard_normal(7).astype(np.float32)}
        js = jema.init(jax.tree.map(jnp.asarray, p0))
        tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
        ts = tema.init(tp)
        for _ in range(5):
            new = {k: v + rng.standard_normal(v.shape).astype(np.float32) for k, v in p0.items()}
            js = jema.update(js, jax.tree.map(jnp.asarray, new), decay=0.9, use_num_updates=use_n)
            tema.update(ts, {k: torch.from_numpy(v) for k, v in new.items()}, decay=0.9,
                        use_num_updates=use_n)
        assert ts["num_updates"] == int(js["num_updates"]) == 5
        got = tema.copy_to(ts, tp)
        want = jema.copy_to(js, jax.tree.map(jnp.asarray, p0))
        for k in p0:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-7, atol=1e-7)
    half = {"h": torch.ones(3, dtype=torch.bfloat16)}
    st = tema.init(half)
    tema.update(st, {"h": torch.zeros(3, dtype=torch.bfloat16)})
    assert st["shadow"]["h"].dtype == torch.bfloat16
    assert torch.equal(st["shadow"]["h"].float(),
                       torch.full((3,), 2 / 11, dtype=torch.bfloat16).float())


def test_ema_swapped_restores_the_module():
    m = torch.nn.Linear(2, 2)
    own = m.weight.detach().clone()
    with tema.swapped(m, {"weight": torch.zeros(2, 2)}):
        assert not torch.any(m.weight)
    assert torch.equal(m.weight, own)


@pytest.mark.parametrize("masked", [False, True])
def test_make_train_step_matches_pfd_tpu(weights64, masked):
    """Two AdamW steps (weight decay 0.1), with and without a mask that
    freezes the context blocks: loss and grad_norm within 1e-5 relative,
    parameter leaves within relative L2 1e-5; frozen parameters bit for bit
    in both packages."""
    weights = weights64
    jm, tm = _pair(weights, PFD64)
    jmask = tmask = None
    if masked:
        jmask = jax.tree_util.tree_map_with_path(
            lambda path, _: "context_blocks" not in [getattr(p, "key", "") for p in path],
            weights)
        tmask = {k: bool(v) for k, v in jax_to_sd(jmask).items()}
    mesh = mesh_lib.make_mesh(jax.devices()[:1], tp=1)
    j_init, j_step = jtrain.make_train_step(
        jm, jtrain.make_optimizer(lr=1e-4, weight_decay=0.1), mesh, train_mask=jmask,
        donate=False)
    t_init, t_step = ttrain.make_train_step(
        tm, ttrain.make_optimizer(lr=1e-4, weight_decay=0.1), "cpu", train_mask=tmask)
    jstate, tstate = j_init(weights), t_init()
    before = {k: p.detach().clone() for k, p in tstate.params.items()}
    shard = {"x0": mesh_lib.data_sharding(mesh), "noise": mesh_lib.data_sharding(mesh),
             "cond": mesh_lib.batch_only_sharding(mesh), "t": mesh_lib.batch_only_sharding(mesh)}
    for i in range(2):
        batch = _batch(10 + i)
        jb = {k: jax.device_put(v, shard[k]) for k, v in batch.items()}
        jstate, jm_ = j_step(jstate, jb, jax.random.PRNGKey(i))
        tstate, tm_ = t_step(tstate, _nchw(batch))
        for key in ("loss", "loss_simple", "loss_vlb", "grad_norm"):
            np.testing.assert_allclose(float(tm_[key]), float(jm_[key]), rtol=1e-5, err_msg=key)
    assert tstate.step == int(jstate.step) == 2
    _assert_params_close(tstate.params, jstate.params, 1e-5)
    jafter = jax_to_sd(jax.tree.map(np.asarray, jstate.params))
    jbefore = jax_to_sd(jax.tree.map(lambda a: np.asarray(a, np.float32), weights))
    for k, p in tstate.params.items():
        if tmask is not None and not tmask[k]:
            assert torch.equal(p, before[k]) and np.array_equal(jafter[k], jbefore[k]), k
            assert not p.requires_grad
        else:
            assert not torch.equal(p, before[k]), k


def test_trainer_fit_matches_pfd_tpu(weights64, tmp_path):
    """Four steps at grad_acc=2 with EMA, logging every step, the evaluator
    hook (a held-out batch's loss under the EMA weights) and checkpoints
    every 2 steps, against pfd_tpu's Trainer on the same batches: parameter
    and EMA shadow leaves within relative L2 1e-5, the evaluator's losses within 1e-5
    relative; a resume into a fresh model restores parameters and optimizer
    state bit for bit; metrics.jsonl holds each step's record."""
    jm, tm = _pair(weights64, PFD64)
    batches = [_batch(20 + i, b=2, lead=(2,)) for i in range(5)]
    held = _batch(99)
    sched = tsched.LambdaWarmUpCosine(1e-4, 2, 0.1, 1.0, 0.1, 4)
    jsch = jsched.LambdaWarmUpCosine(1e-4, 2, 0.1, 1.0, 0.1, 4)

    jcfg = JConfig(max_steps=4, grad_acc=2, log_every=1, eval_every=2, ckpt_every=2,
                   use_ema=True, ema_decay=0.99)
    # optax reads a schedule inside jit, so pfd_tpu's is given as a table lookup
    table = jnp.asarray([jsch(i) for i in range(8)], jnp.float32)
    jtx = jopt.build_optimizer("adamw", {}, learning_rate=lambda s: table[s],
                               grad_clip=1.0)
    jtr = JTrainer(jm, jtx, mesh_lib.make_mesh(jax.devices()[:1], tp=1), jcfg)
    jloss = jax.jit(lambda p: jm.p_losses(p, held["x0"], held["t"], held["cond"],
                                          held["noise"])[0])
    j_evals = []
    jstate = jtr.init_state(weights64)
    jstate = jtr.fit(jstate, iter(batches),
                     evaluator=lambda p, s: j_evals.append(float(jloss(p))) or {})

    cfg = TrainConfig(max_steps=4, grad_acc=2, log_every=1, eval_every=2, ckpt_every=2,
                      use_ema=True, ema_decay=0.99, ckpt_dir=str(tmp_path / "ckpt"),
                      log_dir=str(tmp_path / "logs"))
    opt = topt.build_optimizer("adamw", {}, learning_rate=sched, grad_clip=1.0)
    tr = Trainer(tm, opt, cfg, lr_schedule=sched, device="cpu")
    hb = {k: torch.from_numpy(v) for k, v in _nchw(held).items()}
    hb["t"] = hb["t"].long()
    t_evals = []

    def evaluate(params, step):
        with torch.no_grad(), tema.swapped(tm, params):
            t_evals.append(float(tm.p_losses(hb["x0"], hb["t"], hb["cond"], hb["noise"])[0]))
        return {"held_loss": t_evals[-1]}

    state = tr.init_state()
    state = tr.fit(state, iter([_nchw(b) for b in batches]), evaluator=evaluate)
    assert state.step == 4 and int(jstate.step) == 4
    _assert_params_close(state.params, jstate.params, 1e-5)
    _assert_params_close(tr.ema_state["shadow"], jtr.ema_state["shadow"], 1e-5)
    np.testing.assert_allclose(t_evals, j_evals, rtol=1e-5)

    assert tckpt.saved_steps(cfg.ckpt_dir) == [2, 4]
    recs = [json.loads(line) for line in open(tmp_path / "logs" / "metrics.jsonl")]
    assert [r["step"] for r in recs if "loss" in r] == [1, 2, 3, 4]
    assert sorted(r["step"] for r in recs if "eval/held_loss" in r) == [2, 4]

    # a fresh model, resumed: parameters and optimizer state bit for bit
    _, tm2 = _pair(numpy_params(jm, 1), PFD64)
    tr2 = Trainer(tm2, topt.build_optimizer("adamw", {}, learning_rate=sched, grad_clip=1.0),
                  cfg, device="cpu")
    restored = tr2.resume(tr2.init_state())
    assert restored.step == 4
    for k, p in restored.params.items():
        assert torch.equal(p, state.params[k]), k
    a, b = state.opt_state.state_dict(), restored.opt_state.state_dict()
    assert a["param_groups"] == b["param_groups"]
    for i, s in a["state"].items():
        for key, v in s.items():
            assert torch.equal(v, b["state"][i][key]), (i, key)


def test_checkpoint_files_and_param_exports(weights, tmp_path):
    """The training state's round trip; the params export read back by the
    port's own reader, its key set that of pfd_tpu's export of the same
    parameters; the npz's keys the state dict's."""
    from pfd_tpu.io import checkpoint as jckpt

    _, tm = _pair(weights)
    state = ttrain.init_train_state(tm, ttrain.make_optimizer())
    tckpt.save_train_state(str(tmp_path / "c"), state, 3)
    tckpt.save_train_state(str(tmp_path / "c"), state, 2)  # not after the latest: skipped
    assert tckpt.saved_steps(str(tmp_path / "c")) == [3]
    with torch.no_grad():
        for p in state.params.values():
            p.add_(1.0)
    back = tckpt.restore_train_state(str(tmp_path / "c"), state)
    assert back.step == 3
    want = params_from_jax(weights)
    assert all(torch.equal(p, want[k]) for k, p in back.params.items())

    tckpt.save_params_safetensors(str(tmp_path / "t.safetensors"), tm, prefix="model.")
    jckpt.save_params_safetensors(str(tmp_path / "j.safetensors"), weights, prefix="model.")
    got = load_safetensors(str(tmp_path / "t.safetensors"))
    assert set(got) == set(load_safetensors(str(tmp_path / "j.safetensors")))
    assert all(torch.equal(got["model." + k], v) for k, v in tm.state_dict().items())
    tckpt.save_params_npz(str(tmp_path / "t.npz"), tm)
    assert set(np.load(tmp_path / "t.npz").files) == set(tm.state_dict())


def test_psnr_and_image_quality_match_pfd_tpu():
    from pfd_tpu.training import evaluator as jeval

    rng = np.random.default_rng(2)
    a = rng.random((2, 24, 24, 3))
    b = np.clip(a + 0.05 * rng.standard_normal(a.shape), 0, 1)
    np.testing.assert_allclose(teval.psnr(a[0], b[0]), jeval.psnr(a[0], b[0]), rtol=1e-6)
    assert teval.psnr(a, a) == float("inf")
    got, want = teval.image_quality_evaluator(a, b), jeval.image_quality_evaluator(a, b)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6)
    assert teval.get_evaluator("image_quality") is teval.image_quality_evaluator


# ---- the kernels are forward-only ---------------------------------------------

def test_launch_wrappers_refuse_inputs_that_autograd_records():
    """The shared check every launch wrapper calls before its launch raises
    where grad is enabled and an input requires grad, and passes under
    no_grad or on detached inputs (None inputs allowed)."""
    from pfd_tpu_torch.ops import cuda_build

    x = torch.zeros(2, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        cuda_build.forward_only("flash_attention", x.detach(), x, None)
    with torch.no_grad():
        cuda_build.forward_only("flash_attention", x)
    cuda_build.forward_only("flash_attention", x.detach(), None)


def test_kernel_takes_is_false_under_grad():
    """The dispatchers send a call autograd records to plain attention, on
    either device: it differentiates like pfd_tpu's plain attention."""
    from pfd_tpu_torch.ops import flash_attention as tfa
    from pfd_tpu_torch.ops import nn as tnn

    q = torch.randn(1, 2, 1024, 8, requires_grad=True)
    k, v = torch.randn(1, 2, 1024, 8), torch.randn(1, 2, 1024, 8)
    assert not tfa.kernel_takes(q, k, v, tfa.K1_MAX_D)
    assert not tfa.kernel_takes(k, q, v, tfa.K1_MAX_D)
    with torch.no_grad():
        assert tfa.kernel_takes(q, k, v, tfa.K1_MAX_D)
    out = tfa.self_attn_fn(q, k, v)
    out.sum().backward()
    want = tnn.dot_product_attention(q.detach().requires_grad_(), k, v)
    assert torch.equal(out, want)
    assert q.grad is not None and torch.isfinite(q.grad).all()


_CONV_KW = [dict(padding=1), dict(stride=2, dilation=2), dict(groups=2, padding=(1, 0))]


@pytest.mark.parametrize("kw", _CONV_KW)
def test_conv2d_raw_gradient_equals_f_conv2d(kw):
    """The fp32 conv that runs without TF32 on the card, backward included:
    on the CPU ``conv2d_raw`` and the route it takes on the card for a conv
    autograd records (``conv2d_fp32``) give ``F.conv2d``'s output and
    gradients (input, weight, bias), and its second derivative too."""
    from pfd_tpu_torch.ops import nn as tnn

    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 4, 9, 9, generator=g, requires_grad=True)
    w = torch.randn(6, 4 // kw.get("groups", 1), 3, 3, generator=g, requires_grad=True)
    b = torch.randn(6, generator=g, requires_grad=True)
    want = torch.nn.functional.conv2d(x, w, b, **kw)
    gy = torch.randn(want.shape, generator=g)
    grads = torch.autograd.grad(want, (x, w, b), gy, create_graph=True)
    gw = torch.autograd.grad(want.square().sum(), w, create_graph=True)[0]
    second = torch.autograd.grad(gw.norm(), (x, w))
    for conv in (tnn.conv2d_raw, tnn.conv2d_fp32):
        y = conv(x, w, b, **kw)
        assert torch.equal(y, want)
        for a, c in zip(torch.autograd.grad(y, (x, w, b), gy, create_graph=True), grads):
            assert torch.equal(a, c)
        gw = torch.autograd.grad(conv(x, w, b, **kw).square().sum(), w, create_graph=True)[0]
        for a, c in zip(torch.autograd.grad(gw.norm(), (x, w)), second):
            assert torch.equal(a, c)


@pytest.mark.parametrize("kw", _CONV_KW)
def test_conv2d_fp32_second_derivative_passes_gradgradcheck(kw):
    """``conv2d_fp32``'s backward is itself differentiable (the GAN loss's
    adaptive weight differentiates a gradient): first and second derivatives
    in float64 against finite differences (gradcheck's own tolerances),
    with and without a bias."""
    from pfd_tpu_torch.ops import nn as tnn

    g = torch.Generator().manual_seed(1)
    x = torch.randn(1, 4, 6, 6, generator=g, dtype=torch.float64, requires_grad=True)
    w = torch.randn(2, 4 // kw.get("groups", 1), 3, 3, generator=g, dtype=torch.float64,
                    requires_grad=True)
    b = torch.randn(2, generator=g, dtype=torch.float64, requires_grad=True)
    for args in ((x, w, b), (x, w)):
        assert torch.autograd.gradcheck(lambda *a: tnn.conv2d_fp32(*a, **kw), args)
        assert torch.autograd.gradgradcheck(lambda *a: tnn.conv2d_fp32(*a, **kw), args)


# ---- utils: logging, profiling, experiment directories ------------------------

def test_metric_logger_matches_pfd_tpu(tmp_path, capsys):
    """Weighted means, the JSONL record (but its wall time) and print_log's
    line and file, as pfd_tpu's."""
    from pfd_tpu.utils import logging as jlog
    from pfd_tpu_torch.utils import logging as tlog

    recs = []
    for mod, d in ((jlog, tmp_path / "j"), (tlog, tmp_path / "t")):
        lg = mod.MetricLogger(str(d), use_tensorboard=False)
        lg.accumulate({"loss": 1.0, "grad_norm": np.float32(2.0)}, weight=1.0)
        lg.accumulate({"loss": torch.tensor(4.0) if mod is tlog else 4.0}, weight=3.0)
        rec = lg.tick(7, extra={"eval/x": 0.5})
        line = json.loads(open(d / "metrics.jsonl").read())
        assert rec == line
        recs.append({k: v for k, v in rec.items() if k != "time"})
        mod.print_log("step", 7, log_file=str(d / "train.log"))
        assert open(d / "train.log").read() == "step 7\n"
    assert recs[0] == recs[1] == {"step": 7, "loss": 3.25, "grad_norm": 2.0, "eval/x": 0.5}
    assert capsys.readouterr().out == "step 7\nstep 7\n"


def test_span_and_trace_on_the_cpu(tmp_path):
    """``span`` records ``pfd.<name>`` as a context manager and as a
    decorator, nested as called, and launches no marker on the CPU;
    ``trace`` writes a Chrome trace of what ran, the spans in it."""
    from pfd_tpu_torch.utils import profiling as tprof

    @tprof.span("unet")
    def twice(x):
        return x * 2

    with tprof.trace(str(tmp_path / "tr")) as prof:
        with tprof.span("request"):
            torch.matmul(torch.ones(8, 8), torch.ones(8, 8))
            twice(torch.ones(4))
    spans = {e.name: e.time_range for e in prof.events() if e.name.startswith("pfd.")}
    assert set(spans) == {"pfd.request", "pfd.unet"}
    assert spans["pfd.request"].start <= spans["pfd.unet"].start
    assert spans["pfd.unet"].end <= spans["pfd.request"].end
    text = (tmp_path / "tr" / "trace.json").read_text()
    assert '"pfd.unet"' in text and "pfd_span_" not in text
    assert any("matmul" in e.key for e in prof.key_averages())


def test_experiment_dirs_match_pfd_tpu(tmp_path):
    """The command line's flags and defaults are pfd_tpu's; ``init_experiment``
    writes the config and a snapshot of the port's code, and a resume
    reuses the directory and its id."""
    from pfd_tpu.utils import experiment as jexp
    from pfd_tpu_torch.utils import experiment as texp

    argv = ["--config", "pfd_seecoder", "--log_dir", str(tmp_path), "--grad_acc", "2"]
    assert vars(texp.get_command_line_args(argv)) == vars(jexp.get_command_line_args(argv))
    out = texp.init_experiment(texp.get_command_line_args(argv), {"lr": 1e-4})
    assert out["log_dir"].endswith("-pfd_seecoder") and os.path.isdir(out["ckpt_dir"])
    assert os.path.isfile(os.path.join(out["log_dir"], "code", "pfd_tpu_torch", "data.py"))
    saved = json.load(open(os.path.join(out["log_dir"], "config.json")))
    assert saved["cfg"] == {"lr": 1e-4} and saved["expid"] == out["expid"]
    again = texp.init_experiment(texp.get_command_line_args(
        argv + ["--resume_dir", out["log_dir"]]))
    assert again == out


@pytest.mark.parametrize("flag", ["tp", "coordinator"])
def test_command_line_flags_reach_the_mesh(flag, tmp_path, monkeypatch):
    """``--tp`` and ``--coordinator`` are consumed, not ignored:
    ``mesh_from_args`` joins the coordinator's process group
    (``distributed.initialize``, the rank and world size from the
    environment) and hands ``--tp`` to ``make_mesh``, which refuses a degree
    the world does not take instead of carrying on at world size 1."""
    import torch.distributed as dist

    from pfd_tpu_torch.utils import experiment as texp

    if flag == "tp":
        mesh = texp.mesh_from_args(texp.get_command_line_args(["--tp", "1"]), device="cpu")
        assert (mesh.dp, mesh.sp, mesh.tp) == (1, 1, 1) and not dist.is_initialized()
        with pytest.raises(ValueError, match=r"tp\(4\)"):
            texp.mesh_from_args(texp.get_command_line_args(["--tp", "4"]), device="cpu")
        return
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    args = texp.get_command_line_args(["--coordinator", f"file://{tmp_path}/store"])
    try:
        mesh = texp.mesh_from_args(args, device="cpu")
        assert dist.is_initialized() and dist.get_backend() == "gloo"
        assert (mesh.dp, mesh.tp, mesh.rank) == (1, 1, 0)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_trainer_refuses_a_schedule_the_optimizer_does_not_read():
    """``lr_schedule`` is the optimizer's own schedule or nothing: another
    one would never set a learning rate, so the Trainer raises."""
    sched = tsched.LambdaWarmUpCosine(1e-4, 2, 0.1, 1.0, 0.1, 4)
    opt = topt.build_optimizer("adamw", {}, learning_rate=sched)
    net = torch.nn.Linear(2, 2)
    Trainer(net, opt, TrainConfig(), lr_schedule=sched, device="cpu")
    Trainer(net, opt, TrainConfig(), device="cpu")
    with pytest.raises(ValueError, match="lr_schedule"):
        Trainer(net, opt, TrainConfig(),
                lr_schedule=tsched.LambdaWarmUpCosine(1e-3, 2, 0.1, 1.0, 0.1, 4), device="cpu")
    with pytest.raises(ValueError, match="lr_schedule"):
        Trainer(net, topt.build_optimizer("adamw", {"lr": 1e-4}), TrainConfig(),
                lr_schedule=sched, device="cpu")
