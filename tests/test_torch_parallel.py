"""The multi-device path: the port's mesh, sharding rules, collectives,
sharded forward, sharded train step and Trainer against pfd_tpu's, fp32 on
the CPU.

pfd_tpu runs its 8-device virtual CPU mesh (tests/conftest.py) in this
process; the port runs one process per device, spawned with gloo over a
``file://`` store in ``tmp_path`` (``tests/torch_parallel_workers.py``,
which imports no JAX; so this module imports JAX only inside its tests).
The forward is ``tests/test_sharding_equality.py``'s tiny config (32
channels, [1, 1] blocks, mult [1, 2], attention at ds 1 and 2, 16x16
latents, batch 8, a 148x768 context) held to pfd_tpu's rtol/atol 2e-5; the
train steps run it at 64 channels (at 32, GroupNorm's 32 groups hold one
channel each and AdamW's sign-like first step turns the exact-zero
gradients' rounding noise into updates of up to lr, tests/test_torch_training.py)
and are held to relative 1e-5 (loss, grad_norm) and relative L2 1e-5 per
parameter, frozen parameters bit for bit. Each spawning test has its own
time limit.
"""

import copy
import functools
import os

import numpy as np
import pytest
import torch

from pfd_tpu_torch.io import checkpoint as tckpt
from pfd_tpu_torch.models.build import build_model, dezero_
from pfd_tpu_torch.parallel import distributed, mesh as tmesh, sharding
from pfd_tpu_torch.policy import FP32
from pfd_tpu_torch.tools import mesh_check
from tests import torch_parallel_workers as workers

torch.set_num_threads(1)

UNET = {"type": "openai_unet_2d_next",
        "args": dict(in_channels=4, out_channels=4, model_channels=32,
                     attention_resolutions=[1, 2], num_res_blocks=[1, 1],
                     channel_mult=[1, 2], num_heads=8, context_dim=768)}
PFD = {"type": "pfd", "args": dict(
    vae_cfg_list=[], ctx_cfg_list=[], diffuser_cfg_list=[["image", UNET]],
    beta_linear_start=0.00085, beta_linear_end=0.012, timesteps=1000)}
PFD64 = copy.deepcopy(PFD)
PFD64["args"]["diffuser_cfg_list"][0][1]["args"]["model_channels"] = 64


def _jax_pair(cfg, seed=0):
    """pfd_tpu's model and a numpy weight pytree, and the port's state dict
    of the same weights."""
    from pfd_tpu import registry as jreg
    from pfd_tpu_torch.io.convert import params_from_jax
    from tests.test_torch_nn import numpy_params

    jm = jreg.get("pfd")(**cfg["args"])
    weights = numpy_params(jm, seed)
    return jm, weights, params_from_jax(weights)


def _batch(seed, b=8, res=16, lead=()):
    """A numpy batch, NHWC (pfd_tpu's), 148x768 context."""
    rng = np.random.default_rng(seed)
    return {"x0": rng.standard_normal(lead + (b, res, res, 4)).astype(np.float32),
            "cond": rng.standard_normal(lead + (b, 148, 768)).astype(np.float32),
            "t": rng.integers(0, 1000, lead + (b,)).astype(np.int32),
            "noise": rng.standard_normal(lead + (b, res, res, 4)).astype(np.float32)}


def _nchw(batch):
    return {k: np.ascontiguousarray(np.moveaxis(v, -1, -3)) if k in ("x0", "noise") else v
            for k, v in batch.items()}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _save_inputs(root, **kw):
    os.makedirs(root, exist_ok=True)
    torch.save(kw, os.path.join(root, "inputs.pt"))


def _flat_specs(tree_specs):
    """pfd_tpu's PartitionSpec pytree -> {torch name: spec flipped to torch
    layouts} (a 2-D kernel (in, out) is the torch weight (out, in))."""
    import jax
    from jax.sharding import PartitionSpec as P

    out = {}
    leaves = jax.tree_util.tree_flatten_with_path(tree_specs,
                                                  is_leaf=lambda x: isinstance(x, P))[0]
    for path, spec in leaves:
        names = [str(getattr(p, "key", p)) for p in path]
        spec = tuple(spec)
        if names[-1] == "kernel":
            names[-1] = "weight"
            spec = spec[::-1]
        elif names[-1] == "scale":
            names[-1] = "weight"
        out[".".join(names)] = spec
    return out


def test_spec_for_param_matches_pfd_tpu():
    """Every parameter of openai_unet_2d_v1 (its shapes read by
    ``jax.eval_shape``, no memory spent) gets pfd_tpu's PartitionSpec,
    flipped for torch's (out, in) weights; replicated ones ()."""
    import jax

    from pfd_tpu import config as jconfig, registry as jreg
    from pfd_tpu.parallel import sharding as jshard
    from pfd_tpu_torch import config as tconfig, registry as treg

    cfg = jconfig.model_cfg("openai_unet_2d_v1")
    shapes = jax.eval_shape(jreg.get(cfg["type"])(**cfg["args"]).init,
                            jax.random.PRNGKey(0))
    want = _flat_specs(jshard.param_specs(shapes))
    tcfg = tconfig.model_cfg("openai_unet_2d_v1")
    with torch.device("meta"):
        names = [n for n, _ in treg.get(tcfg["type"])(**tcfg["args"]).named_parameters()]
    assert sorted(names) == sorted(want)
    got = {n: sharding.spec_for_param(n) for n in names}
    assert got == want
    # 16 transformer blocks, each: q, k, v, out of two attentions, the
    # GEGLU's weight and bias, the FF's down-projection
    assert sum(1 for v in got.values() if v) == 16 * 11


class _Rank:
    """A mesh's coordinates without process groups, for ``place_params``."""

    def __init__(self, tp, r):
        self.tp, self.coords = tp, {"model": r}


@pytest.mark.parametrize("tp", [2, 4])
def test_geglu_shard_is_the_slice_of_the_full_output(tp):
    """Rank r's GEGLU up-projection shard is ``[value_r | gate_r]``: its local
    GEGLU output equals columns r of the full output (a contiguous split of
    ``[value | gate]`` would not), and the column- and row-parallel shards
    of one transformer block reassemble its weights."""
    from pfd_tpu_torch.ops import nn as tnn

    torch.manual_seed(0)
    proj = torch.nn.Linear(32, 2 * 128)
    x = torch.randn(2, 5, 32)
    full = tnn.geglu(x, proj)
    n = 128 // tp
    for r in range(tp):
        local = sharding.place_params({"b.ff.net.0.proj.weight": proj.weight.data,
                                       "b.ff.net.0.proj.bias": proj.bias.data}, _Rank(tp, r))
        m = torch.nn.Linear(32, 2 * n)
        m.weight.data, m.bias.data = local["b.ff.net.0.proj.weight"], local["b.ff.net.0.proj.bias"]
        assert torch.allclose(tnn.geglu(x, m), full[..., r * n:(r + 1) * n], rtol=0, atol=1e-6)
    w = torch.randn(64, 32)
    parts = [sharding.place_params({"attn1.to_q.weight": w, "attn1.to_out.0.weight": w.T,
                                    "attn1.to_out.0.bias": w[0]}, _Rank(tp, r))
             for r in range(tp)]
    assert torch.equal(torch.cat([p["attn1.to_q.weight"] for p in parts], 0), w)
    assert torch.equal(torch.cat([p["attn1.to_out.0.weight"] for p in parts], 1), w.T)
    assert all(torch.equal(p["attn1.to_out.0.bias"], w[0]) for p in parts)


def test_seq_split_attention_reads_the_whole_sequence(monkeypatch):
    """Split over 'seq', a rank's self-attention (its queries over the keys
    gathered from every rank, Sq < Skv) goes to K2, whose key loop takes any
    number of keys, and K1 (Sq == Skv only) is never asked; the sequence
    thresholds read the whole sequence: the gathered keys for the
    self-attention, sp times the local queries for the cross-attention (a ds2 rank at sp=2
    holds 512 of 1,024 tokens, and pfd_tpu's global view sends those to
    K2). On the CPU the wrappers run their plain versions; the calls are
    recorded here."""
    from pfd_tpu_torch.ops import flash_attention as fa

    calls = []

    def record(name, plain):
        return lambda q, k, v, **kw: calls.append((name, q.shape[2], k.shape[2])) or plain(
            q, k, v, **kw)

    monkeypatch.setattr(fa, "cross_attention", record("K2", fa.cross_attention))
    monkeypatch.setattr(fa, "flash_attention", record("K1", fa.flash_attention))
    g = torch.Generator().manual_seed(0)
    q, k, kv = (torch.randn(s, generator=g) for s in ((1, 2, 512, 8), (1, 2, 1024, 8),
                                                       (1, 2, 148, 8)))
    got = fa.gathered_self_attn_fn(q, k, k)
    assert calls == [("K2", 512, 1024)]
    torch.testing.assert_close(got, fa.attention_plain(q, k, k), rtol=0, atol=1e-6)
    fa.gathered_self_attn_fn(q[:, :, :256], k[:, :, :512], k[:, :, :512])
    fa.cross_attn_fn(q, kv, kv)
    assert calls == [("K2", 512, 1024)]
    fa.split_cross_attn_fn(q, kv, kv, sp=2)
    assert calls == [("K2", 512, 1024), ("K2", 512, 148)]


def test_initialize_without_a_coordinator_is_a_no_op():
    """``distributed.initialize()`` joins nothing: one process, rank 0 of a
    world of one, and a mesh of one device has no group."""
    import torch.distributed as dist

    distributed.initialize()
    assert not dist.is_initialized()
    assert distributed.is_rank0() and distributed.world_size() == 1
    mesh = tmesh.make_mesh(device="cpu")
    assert (mesh.dp, mesh.sp, mesh.tp) == (1, 1, 1)
    assert all(g is None for g in mesh.groups.values())
    with pytest.raises(ValueError):
        tmesh.make_mesh(tp=2, device="cpu")


@pytest.mark.parametrize("env, process_id, card", [
    ({"LOCAL_RANK": "2", "LOCAL_WORLD_SIZE": "4"}, 6, 2),  # torchrun's local rank
    ({}, 5, 1),                                           # else the rank modulo the cards
    ({"LOCAL_RANK": "4"}, 4, None),                       # past the host's cards
    ({"LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "8"}, 1, None),  # two ranks a card
])
def test_nccl_rank_takes_a_card_of_its_own(env, process_id, card, monkeypatch):
    """Under NCCL ``initialize`` binds the rank to its card before joining
    (``local_card`` on a host of 4 cards), so ranks started by torchrun on a
    host of several cards do not all land on card 0; more ranks than cards
    raise before the group is joined."""
    import torch.distributed as dist

    calls = {}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: calls.setdefault("set", d))
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: calls.update(backend=backend, **kw))
    for k in ("LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in {**env, "RANK": str(process_id), "WORLD_SIZE": "8"}.items():
        monkeypatch.setenv(k, v)
    if card is None:
        with pytest.raises(ValueError, match="one card a rank"):
            distributed.initialize("localhost:29500")
        assert not calls
        return
    distributed.initialize("localhost:29500")
    dev = torch.device("cuda", card)
    assert calls == {"set": dev, "backend": "nccl", "init_method": "tcp://localhost:29500",
                     "world_size": 8, "rank": process_id, "device_id": dev}


def test_collectives_hand_contiguous_buffers(tmp_path, monkeypatch):
    """NCCL takes only contiguous tensors (gloo takes others): every
    collective, forward and backward, hands ``torch.distributed`` contiguous
    buffers, here the transposed heads of an attention layer, in a world of
    one gloo process whose group is passed explicitly."""
    import torch.distributed as dist

    seen = []
    for name in ("all_reduce", "all_gather"):
        real = getattr(dist, name)

        def spy(*args, real=real, **kw):
            tensors = args[0] if isinstance(args[0], list) else [args[0]]
            seen.extend(t.is_contiguous() for t in tensors + list(args[1:2]))
            return real(*args, **kw)

        monkeypatch.setattr(dist, name, spy)
    distributed.initialize(f"file://{tmp_path}/store", 1, 0, backend="gloo")
    try:
        g = dist.group.WORLD
        x = torch.randn(2, 6, 3, 4).transpose(1, 2).requires_grad_()
        y = (distributed.all_gather(x, 2, g) + distributed.copy_in(x, g)
             + distributed.reduce_out(x, g) + distributed.all_reduce_sum(x, g))
        (distributed.halo_exchange(y, g) * torch.randn(2, 3, 8, 4)).sum().backward()
        distributed.all_reduce_(torch.randn(4, 2).bfloat16().t(), g)
    finally:
        dist.destroy_process_group()
    assert len(seen) >= 8 and all(seen)


@pytest.mark.parametrize("world", [2, 4])
def test_world_and_place_gather_round_trip(world, tmp_path):
    """In ``world`` gloo processes: ``is_rank0`` and ``world_size`` per
    rank, and ``gather_params(place_params(sd))`` gives openai_unet's tiny
    state dict back bit for bit at tp = 2 and 4 (the GEGLU interleave
    undone), every sharded tensor split."""
    model = build_model(PFD, policy=FP32, device="cpu")
    _save_inputs(tmp_path, sd={k: v.clone() for k, v in model.state_dict().items()})
    tps = [t for t in (2, 4) if t <= world]
    workers.run_ranks(workers.world_and_round_trip, world, tmp_path, tps, timeout=60)
    for r in range(world):
        rec = torch.load(tmp_path / f"rank{r}.pt")
        assert rec["rank"] == r and rec["is_rank0"] == (r == 0) and rec["world"] == world
        assert all(rec[t] for t in tps), rec


def test_sharded_forward_matches_pfd_tpu(tmp_path):
    """The sharded forward at (dp, sp, tp) = (8, 1, 1) and (2, 2, 2), in 8
    processes, within pfd_tpu's rtol/atol 2e-5 of its one-device
    ``apply_model`` on the same weights (``params_from_jax``)."""
    import jax
    import jax.numpy as jnp

    jm, weights, sd = _jax_pair(PFD)
    b = _batch(0)
    nb = _nchw(b)
    _save_inputs(tmp_path, cfg=PFD, sd=sd, x=torch.from_numpy(nb["x0"]),
                 t=torch.from_numpy(b["t"]).long(), c=torch.from_numpy(b["cond"]))
    procs = mesh_check.start(workers.forward_layouts, 8, tmp_path, [(8, 1, 1), (2, 2, 2)])
    f1 = jax.jit(lambda p, x, t, c: jm.apply_model(
        p, {"type": "image", "x": x}, t, {"type": "image", "c": c}))
    golden = np.asarray(f1(weights, jnp.asarray(b["x0"]), jnp.asarray(b["t"]),
                           jnp.asarray(b["cond"])))
    mesh_check.wait(procs, tmp_path, timeout=90)
    out = torch.load(tmp_path / "forward.pt")
    for layout, eps in out.items():
        np.testing.assert_allclose(np.moveaxis(eps.numpy(), 1, -1), golden, rtol=2e-5,
                                   atol=2e-5, err_msg=str(layout))


def _jax_steps(jm, weights, jmask, batches):
    """pfd_tpu's make_train_step on its mesh of one device: the metrics of
    each step and the final parameters. The state is put back on its first
    shardings between steps, so the second step reuses the first one's
    program."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding

    from pfd_tpu.parallel import mesh as jmesh
    from pfd_tpu.parallel import train as jtrain

    mesh = jmesh.make_mesh(jax.devices()[:1], dp=1, tp=1, sp=1)
    init, step = jtrain.make_train_step(jm, jtrain.make_optimizer(lr=1e-4, weight_decay=0.1),
                                        mesh, train_mask=jmask, donate=False)
    state = init(weights)
    first = jax.tree.map(lambda a: a.sharding, state)
    shard = {"x0": jmesh.data_sharding(mesh), "noise": jmesh.data_sharding(mesh),
             "cond": jmesh.batch_only_sharding(mesh), "t": jmesh.batch_only_sharding(mesh)}
    metrics = []
    for i, batch in enumerate(batches):
        jb = {k: jax.device_put(v, shard[k]) for k, v in batch.items()}
        state, m = step(state, jb, jax.random.PRNGKey(i))
        metrics.append({k: float(v) for k, v in m.items()})
        state = jax.tree.map(lambda a, s: jax.device_put(a, s) if isinstance(s, NamedSharding)
                             else jnp.asarray(np.asarray(a)), state, first)
    return metrics, state.params


@functools.cache
def _train_inputs():
    """PFD64's weights (pfd_tpu's and the port's), two batches and the mask
    that freezes the context blocks (pfd_tpu's and the port's)."""
    import jax

    from pfd_tpu_torch.io.convert import pytree_to_torch_sd

    jm, weights, sd = _jax_pair(PFD64)
    jmask = jax.tree_util.tree_map_with_path(
        lambda path, _: "context_blocks" not in [getattr(p, "key", "") for p in path], weights)
    tmask = {k: bool(v) for k, v in pytree_to_torch_sd(jmask).items()}
    return jm, weights, sd, [_batch(10 + i) for i in range(2)], jmask, tmask


@functools.cache
def _train_reference():
    """{masked: (metrics of each step, torch state dict after them)} of
    pfd_tpu's one-device step on ``_train_inputs``, computed once for every
    layout."""
    import jax

    from pfd_tpu_torch.io.convert import pytree_to_torch_sd

    jm, weights, _, batches, jmask, _ = _train_inputs()
    out = {}
    for masked in (False, True):
        metrics, params = _jax_steps(jm, weights, jmask if masked else None, batches)
        out[masked] = (metrics, pytree_to_torch_sd(jax.tree.map(np.asarray, params)))
    return out


@pytest.mark.parametrize("layout", [(2, 2, 2), (1, 1, 2)])
def test_sharded_train_steps_match_pfd_tpu(layout, tmp_path):
    """Two AdamW steps (weight decay 0.1) of the port's sharded step at
    ``layout`` (dp, sp, tp), with and without a mask that freezes the
    context blocks, against pfd_tpu's one-device make_train_step: loss and
    grad_norm within relative 1e-5, parameters within relative L2 1e-5 per
    leaf, frozen ones bit for bit in both. The reference is pfd_tpu's
    one-device step, the function its sharded step computes, because
    pfd_tpu's sharded gradients are wrong where 'seq' and 'model' are both
    split (``test_pfd_tpu_gradients_on_a_seq_and_model_mesh``); one
    reference serves every layout."""
    _, _, sd, batches, _, tmask = _train_inputs()
    _save_inputs(tmp_path, cfg=PFD64, sd=sd, mask=tmask, batches=[_nchw(b) for b in batches])
    procs = mesh_check.start(workers.train_layouts, int(np.prod(layout)), tmp_path,
                             [(layout, False), (layout, True)])
    want = _train_reference()
    mesh_check.wait(procs, tmp_path, timeout=150)
    out = torch.load(tmp_path / "train.pt")
    for (lay, masked), (metrics, params) in out.items():
        jmetrics, jsd = want[masked]
        for tm_, jm_ in zip(metrics, jmetrics):
            for key in ("loss", "loss_simple", "loss_vlb", "grad_norm"):
                np.testing.assert_allclose(tm_[key], jm_[key], rtol=1e-5, err_msg=key)
        for k, p in params.items():
            if masked and not tmask[k]:
                assert torch.equal(p, sd[k]) and np.array_equal(jsd[k], sd[k].numpy()), k
            else:
                assert _rel(p.numpy(), jsd[k]) <= 1e-5, (lay, masked, k)
                assert not torch.equal(p, sd[k]), k


def test_pfd_tpu_gradients_on_a_seq_and_model_mesh():
    """Why the (2, 2, 2) train step is held to pfd_tpu's one-device step:
    on pfd_tpu's CPU mesh with 'seq' and 'model' both split (1, 2, 2), the
    loss is the one-device loss and every gradient but the 3x3 convs'
    weights is within relative L2 1e-5 of the one-device gradient, while
    each 3x3 conv weight's gradient is tp = 2 times it (XLA sums the
    'model' replicas' copies of the seq-split conv's weight gradient)."""
    import jax

    from pfd_tpu.parallel import mesh as jmesh
    from pfd_tpu.parallel import sharding as jshard
    from pfd_tpu_torch.io.convert import pytree_to_torch_sd

    jm, weights, _ = _jax_pair(PFD64)
    b = _batch(10)

    def lossf(p, b):
        return jm.p_losses(p, b["x0"], b["t"], b["cond"], b["noise"])[0]

    grad = jax.jit(jax.value_and_grad(lossf))
    loss1, g1 = grad(weights, b)
    g1 = pytree_to_torch_sd(jax.tree.map(np.asarray, g1))
    sp = tp = 2
    mesh = jmesh.make_mesh(jax.devices()[:sp * tp], dp=1, tp=tp, sp=sp)
    latent, rows = jmesh.data_sharding(mesh), jmesh.batch_only_sharding(mesh)
    jb = {k: jax.device_put(v, latent if k in ("x0", "noise") else rows) for k, v in b.items()}
    loss, g = grad(jshard.place_params(weights, mesh), jb)
    g = pytree_to_torch_sd(jax.tree.map(np.asarray, g))
    np.testing.assert_allclose(float(loss), float(loss1), rtol=1e-6)
    for k, v in g.items():
        conv = v.ndim == 4 and v.shape[2:] == (3, 3)
        assert _rel(v, (tp if conv else 1) * g1[k]) <= 1e-5, k


def test_trainer_on_a_mesh_resumes_at_world_size_1(tmp_path):
    """The Trainer at (dp, sp, tp) = (2, 1, 2) with grad_acc=2, EMA and a
    checkpoint every step: it matches the one-device Trainer on the same
    batches (parameters and EMA shadows within relative L2 1e-5 per leaf);
    its checkpoint is in the world-size-1 layout, so a one-device resume
    restores every parameter and optimizer state bit for bit (and a resume
    on the mesh restores each rank's shards bit for bit, in the workers)."""
    from pfd_tpu_torch.training.harness import TrainConfig, Trainer
    from pfd_tpu_torch.training.optimizers import build_optimizer

    model = build_model(PFD64, policy=FP32, device="cpu", generator=np.random.default_rng(0))
    dezero_(model, np.random.default_rng(1))
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    batches = [_nchw(_batch(20 + i, b=4, lead=(2,))) for i in range(2)]
    kw = dict(max_steps=2, grad_acc=2, log_every=1, eval_every=1000, ckpt_every=1,
              use_ema=True, ema_decay=0.99, ckpt_dir=str(tmp_path / "ckpt"),
              log_dir=str(tmp_path / "logs"))
    _save_inputs(tmp_path, cfg=PFD64, sd=sd, batches=batches)
    procs = mesh_check.start(workers.trainer_on_mesh, 4, tmp_path, (2, 1, 2), kw)

    def trainer(cfg):
        m = build_model(PFD64, policy=FP32, device="cpu")
        m.load_state_dict(sd)
        return Trainer(m, build_optimizer("adamw", {"lr": 1e-4, "weight_decay": 0.1},
                                          grad_clip=1.0), cfg, device="cpu")

    one = trainer(TrainConfig(**{**kw, "ckpt_dir": None, "log_dir": None}))
    state = one.fit(one.init_state(), iter(batches))
    mesh_check.wait(procs, tmp_path, timeout=120)
    got = torch.load(tmp_path / "trainer.pt")
    assert got["step"] == state.step == 2
    for k, p in state.params.items():
        assert _rel(got["params"][k].numpy(), p.detach().numpy()) <= 1e-5, k
        assert _rel(got["ema"][k].numpy(), one.ema_state["shadow"][k].numpy()) <= 1e-5, k
    assert tckpt.saved_steps(kw["ckpt_dir"]) == [1, 2]
    resumed = trainer(TrainConfig(**kw))
    restored = resumed.resume(resumed.init_state())
    assert restored.step == 2
    for k, p in restored.params.items():
        assert torch.equal(p, got["params"][k]), k
    b = restored.opt_state.state_dict()
    assert b["param_groups"] == got["opt"]["param_groups"]
    for i, st in got["opt"]["state"].items():
        for key, v in st.items():
            assert torch.equal(v, b["state"][i][key]), (i, key)


def test_mesh_check_on_four_cpu_ranks(tmp_path):
    """``tools/mesh_check`` (the multi-card check) at a tiny size on the CPU,
    in 4 gloo processes started as torchrun starts ranks, at the layouts of
    4 ranks no other test runs (sp4, tp4): ``check`` holds the sharded
    forward within relative L2 1e-5 and one FP32 step's loss and
    ``grad_norm`` (every rank) and parameters (rank 0) within 1e-5 of the
    one-device ones, and every rank reports."""
    lay = {"tp4": (1, 1, 4), "sp4": (1, 4, 1)}
    mesh_check.reference(str(tmp_path), PFD64, 4, "cpu", FP32, None, latent=16, train_latent=16)
    rows = mesh_check.run(4, str(tmp_path), lay, backend="gloo", cfg=PFD64, eps_policy="FP32",
                          attn=None, device_type="cpu", timeout=120)
    assert set(rows) == set(lay)
    mesh_check.check(rows, 4, eps_limit=1e-5)
    assert all(r["backend"] == "gloo" and r["device"] == "cpu"
               for ranks in rows.values() for r in ranks)
    assert mesh_check.layouts(4) == {
        "dp4_sp1_tp1": (4, 1, 1), "dp2_sp2_tp1": (2, 2, 1), "dp1_sp4_tp1": (1, 4, 1),
        "dp2_sp1_tp2": (2, 1, 2), "dp1_sp2_tp2": (1, 2, 2), "dp1_sp1_tp4": (1, 1, 4)}
