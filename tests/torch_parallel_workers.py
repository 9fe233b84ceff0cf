"""The ranks of the multi-process CPU tests (``tests/test_torch_parallel.py``):
each function runs in a spawned process joined over gloo through a
``file://`` store, imports no JAX and nothing of ``pfd_tpu``, and rank 0
writes what the test compares with ``torch.save``.

Each takes (rank, world, root, ...) and joins the group itself;
``run_ranks`` spawns the world through ``tools/mesh_check.start``, waits
for it under a time limit, kills what is left at the limit and raises with
the first rank's traceback.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from pfd_tpu_torch.models.build import build_model
from pfd_tpu_torch.parallel import distributed, sharding
from pfd_tpu_torch.parallel import train as ttrain
from pfd_tpu_torch.parallel.mesh import make_mesh
from pfd_tpu_torch.policy import FP32
from pfd_tpu_torch.tools import mesh_check


def _join(rank, world, root):
    """One thread; the gloo group joined through ``root``'s store."""
    torch.set_num_threads(1)
    distributed.initialize(f"file://{root}/store", world, rank, backend="gloo")


def run_ranks(fn, world, root, *args, timeout=60.0):
    """``fn(rank, world, root, *args)`` in ``world`` spawned processes,
    waited for under ``timeout`` seconds."""
    mesh_check.wait(mesh_check.start(fn, world, root, *args), root, timeout)


def _model(inputs):
    model = build_model(inputs["cfg"], policy=FP32, device="cpu")
    model.load_state_dict(inputs["sd"], strict=True)
    return model


def forward_layouts(rank, world, root, layouts):
    """The sharded forward at each (dp, sp, tp) of ``layouts`` on
    ``inputs.pt``'s model and batch; rank 0 saves {layout: eps}."""
    _join(rank, world, root)
    inputs = torch.load(os.path.join(root, "inputs.pt"), weights_only=False)
    out = {}
    for dp, sp, tp in layouts:
        model = _model(inputs)
        mesh = make_mesh(dp=dp, tp=tp, sp=sp, device="cpu")
        sharding.shard_module_(model, mesh)
        with torch.no_grad():
            out[(dp, sp, tp)] = sharding.apply_model(model, mesh, inputs["x"], inputs["t"],
                                                     inputs["c"])
    if rank == 0:
        torch.save(out, os.path.join(root, "forward.pt"))
    dist.destroy_process_group()


def train_layouts(rank, world, root, cases):
    """Two AdamW steps of the sharded train step at each ((dp, sp, tp),
    masked) of ``cases`` on ``inputs.pt``'s model and batches; rank 0 saves
    {case: (metrics of each step, the gathered parameters)}."""
    _join(rank, world, root)
    inputs = torch.load(os.path.join(root, "inputs.pt"), weights_only=False)
    out = {}
    for (dp, sp, tp), masked in cases:
        model = _model(inputs)
        mesh = make_mesh(dp=dp, tp=tp, sp=sp, device="cpu")
        init, step = ttrain.make_train_step(
            model, ttrain.make_optimizer(lr=1e-4, weight_decay=0.1), mesh,
            train_mask=inputs["mask"] if masked else None)
        state = init()
        metrics = []
        for batch in inputs["batches"]:
            state, m = step(state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
        params = sharding.gather_params({k: p.detach() for k, p in state.params.items()},
                                        mesh)
        out[((dp, sp, tp), masked)] = (metrics, params)
    if rank == 0:
        torch.save(out, os.path.join(root, "train.pt"))
    dist.destroy_process_group()


def world_and_round_trip(rank, world, root, tps):
    """The world as ``distributed`` reports it, and at each tp of ``tps``
    (data-parallel over the rest) whether ``gather_params`` of
    ``place_params`` gives ``inputs.pt``'s state dict back bit for bit,
    with every sharded tensor split; each rank saves its own record."""
    _join(rank, world, root)
    inputs = torch.load(os.path.join(root, "inputs.pt"), weights_only=False)
    sd = inputs["sd"]
    rec = {"rank": distributed.rank(), "is_rank0": distributed.is_rank0(),
           "world": distributed.world_size()}
    for tp in tps:
        mesh = make_mesh(tp=tp, device="cpu")
        local = sharding.place_params(sd, mesh)
        back = sharding.gather_params(local, mesh)
        split = all(local[k].numel() * tp == v.numel() for k, v in sd.items()
                    if sharding.sharded_dim(k) is not None)
        rec[tp] = split and back.keys() == sd.keys() and all(
            torch.equal(back[k], v) for k, v in sd.items())
    torch.save(rec, os.path.join(root, f"rank{rank}.pt"))
    dist.destroy_process_group()


def trainer_on_mesh(rank, world, root, layout, cfg_kw):
    """``Trainer.fit`` at ``layout`` (dp, sp, tp) on ``inputs.pt``'s model
    and micro-batched host batches, checkpointing to ``root/ckpt``; a second
    Trainer on the same mesh resumes and must hold this rank's shards and
    optimizer state bit for bit. Rank 0 saves the gathered parameters,
    optimizer state and EMA shadows."""
    from pfd_tpu_torch.io import checkpoint as ckpt_lib
    from pfd_tpu_torch.training.harness import TrainConfig, Trainer
    from pfd_tpu_torch.training.optimizers import build_optimizer

    _join(rank, world, root)
    inputs = torch.load(os.path.join(root, "inputs.pt"), weights_only=False)
    dp, sp, tp = layout
    mesh = make_mesh(dp=dp, tp=tp, sp=sp, device="cpu")
    cfg = TrainConfig(**cfg_kw)

    def trainer(model):
        opt = build_optimizer("adamw", {"lr": 1e-4, "weight_decay": 0.1}, grad_clip=1.0)
        return Trainer(model, opt, cfg, device="cpu", mesh=mesh)

    tr = trainer(_model(inputs))
    state = tr.fit(tr.init_state(), iter(inputs["batches"]))
    tr2 = trainer(_model(inputs))
    restored = tr2.resume(tr2.init_state())
    assert restored.step == state.step
    for k, p in state.params.items():
        assert torch.equal(restored.params[k], p), k
    a, b = state.opt_state.state_dict(), restored.opt_state.state_dict()
    for i, st in a["state"].items():
        for key, v in st.items():
            assert torch.equal(v, b["state"][i][key]), (i, key)
    full, opt_sd = ckpt_lib.world_size_1_state(state, mesh)
    ema = sharding.gather_params(tr.ema_state["shadow"], mesh)
    if rank == 0:
        torch.save({"params": full, "opt": opt_sd, "ema": ema, "step": state.step},
                   os.path.join(root, "trainer.pt"))
    dist.destroy_process_group()

