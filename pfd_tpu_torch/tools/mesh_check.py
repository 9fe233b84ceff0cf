"""Multi-device check of the sharded path (``parallel/``): the sharded UNet
forward and train step at several (dp, sp, tp) layouts against the
one-device forward and step, one process per rank.

    python -m pfd_tpu_torch.tools.mesh_check    # every visible card over NCCL, a card a rank

The model is ``pfd`` over config #1's diffuser (``openai_unet_2d_v1``) at
full width, from seeded, de-zeroed weights (the same in every process). The
one-device side runs first, in this process on the first card: the bf16 eps
at 512^2 (latent (B, 4, 64, 64), B the world size, a (B, 148, 768) context)
through K1 and K2 (``self_attn_fn``), and one FP32 AdamW step at 256^2 on B
images. Then each rank, at each layout: the sharded eps (``sharding.apply_model``)
with its launches, and the sharded step (``parallel.train.make_train_step``
on the mesh) with its seconds. Each rank's record is one JSON line; ``check``
holds every record to the limits below and raises on the first miss. The
ranks are spawned as ``torchrun`` starts them (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK`` in the environment) and join through
``distributed.initialize``, which gives each NCCL rank its own card, as a
user's run does. Over gloo on the card (``chip_smoke.py``'s phase 17) the
ranks share the first card: a check of the layouts, not of speed. The cards'
names and power limits come first.

The limits: the eps within relative L2 ``EPS_LIMIT`` (bf16 through the
kernels at another batch split), the step's loss and ``grad_norm`` within
relative ``STEP_LIMIT`` on every rank and each parameter after it within
relative L2 ``STEP_LIMIT`` (rank 0). AdamW's first update is about
lr * sign(g) and does not see a gradient's scale, so ``grad_norm`` is what
catches a fault of scale (a gradient summed or averaged once too often).
Rounding that flips the sign of a near-zero gradient moves a parameter by
2 * lr, so the step runs at ``LR``, where such flips stay far under the
parameters' limit.

``run`` is the entry point of ``chip_smoke.py``'s phase 17 and, with a tiny
config on the CPU, of the CPU test.
"""

from __future__ import annotations

import json
import os
import subprocess
import tempfile
import time

import torch

HEADS = 8       # openai_unet_2d_v1's: tp must divide them
LEVELS = 4      # and its levels: H must divide by sp * 2^(LEVELS - 1)
LATENT = 64     # the eps call at 512^2
TRAIN_LATENT = 32  # the step at 256^2
LR = 1e-5          # the step's learning rate (module docstring)
EPS_LIMIT = 5e-2   # relative L2 of the bf16 eps through the kernels
STEP_LIMIT = 1e-5  # relative: loss, grad_norm; relative L2: each parameter


def layouts(world: int) -> dict:
    """{"dp<d>_sp<s>_tp<t>": (dp, sp, tp)} of every layout of ``world``
    ranks the model takes."""
    out = {}
    for tp in (t for t in range(1, world + 1) if world % t == 0 and HEADS % t == 0):
        for sp in (s for s in range(1, world // tp + 1) if (world // tp) % s == 0):
            if TRAIN_LATENT % (sp * 2 ** (LEVELS - 1)) == 0:
                dp = world // (tp * sp)
                out[f"dp{dp}_sp{sp}_tp{tp}"] = (dp, sp, tp)
    return out


def default_cfg() -> dict:
    from pfd_tpu_torch import config

    return {"type": "pfd", "args": {
        "vae_cfg_list": [], "ctx_cfg_list": [],
        "diffuser_cfg_list": [["image", config.model_cfg("openai_unet_2d_v1")]],
        "beta_linear_start": 0.00085, "beta_linear_end": 0.012, "timesteps": 1000}}


def build(cfg, policy, seed, device):
    """``cfg``'s model from ``seed``, de-zeroed, on ``device``: the same
    weights in every process."""
    from pfd_tpu_torch.models.build import build_model, dezero_

    model = build_model(cfg, policy=policy, device=device,
                        generator=torch.Generator(device=device).manual_seed(seed))
    return dezero_(model, torch.Generator(device=device).manual_seed(seed + 1))


def inputs(batch, latent, train_latent, context, device, seed=17):
    """The eps call's (x, t, context) and the step's batch, from ``seed``."""
    g = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=device)

    x = randn(batch, 4, latent, latent)
    t = torch.randint(0, 1000, (batch,), generator=g, device=device)
    c = randn(batch, *context)
    step = {"x0": randn(batch, 4, train_latent, train_latent),
            "noise": randn(batch, 4, train_latent, train_latent),
            "cond": randn(batch, *context),
            "t": torch.randint(0, 1000, (batch,), generator=g, device=device)}
    return x, t, c, step


def one_step(model, mesh_or_device, batch):
    """One FP32 AdamW step (lr ``LR``, weight decay 0.1) of ``model`` ->
    (loss, grad_norm, the parameters after it, whole, the step's seconds)."""
    from pfd_tpu_torch.parallel import sharding
    from pfd_tpu_torch.parallel import train as train_lib
    from pfd_tpu_torch.parallel.mesh import Mesh

    init, step = train_lib.make_train_step(
        model, train_lib.make_optimizer(lr=LR, weight_decay=0.1), mesh_or_device)
    state = init()
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
    sync()
    t0 = time.perf_counter()
    state, metrics = step(state, batch)
    sync()
    sec = time.perf_counter() - t0
    params = {k: p.detach() for k, p in state.params.items()}
    if isinstance(mesh_or_device, Mesh):
        params = sharding.gather_params(params, mesh_or_device)
    return metrics["loss"].item(), metrics["grad_norm"].item(), params, sec


def rel(got: float, want: float) -> float:
    return abs(got - want) / abs(want)


def rel_per_leaf(got: dict, want: dict) -> float:
    """The largest relative L2 of a tensor of ``got`` from ``want``'s."""
    return max(((got[k].float().cpu() - w.float().cpu()).norm()
                / w.float().norm().clamp_min(1e-30)).item() for k, w in want.items())


def reference(root, cfg, world, device, eps_policy, attn, context=(148, 768),
              latent=LATENT, train_latent=TRAIN_LATENT):
    """The one-device side, saved under ``root`` for the ranks: the inputs,
    the eps, the step's loss and grad_norm (``ref.pt``) and parameters
    (``ref_params.pt``). Returns (eps, loss, grad_norm, params, step
    seconds)."""
    from pfd_tpu_torch.policy import FP32

    x, t, c, batch = inputs(world, latent, train_latent, context, device)
    with torch.no_grad():
        eps = build(cfg, eps_policy, 170, device).apply_model(
            {"type": "image", "x": x}, t, {"type": "image", "c": c}, self_attn_fn=attn).float()
    loss, gnorm, params, sec = one_step(build(cfg, FP32, 171, device), device, batch)
    params = {k: v.cpu() for k, v in params.items()}
    torch.save({"x": x.cpu(), "t": t.cpu(), "c": c.cpu(), "eps": eps.cpu(), "loss": loss,
                "grad_norm": gnorm, "batch": {k: v.cpu() for k, v in batch.items()}},
               os.path.join(root, "ref.pt"))
    torch.save(params, os.path.join(root, "ref_params.pt"))
    return eps, loss, gnorm, params, sec


def rank_main(rank, world, root, backend, cfg, layout_map, eps_policy_name, attn_name,
              device_type):
    """One rank: joins the group through ``distributed.initialize`` (the
    rank, the world and the local rank from the environment, as ``start``
    sets them), and at each layout writes its record."""
    from pfd_tpu_torch import policy as policy_lib
    from pfd_tpu_torch.ops import flash_attention as fa
    from pfd_tpu_torch.parallel import distributed, sharding
    from pfd_tpu_torch.parallel.mesh import make_mesh

    if device_type == "cpu":
        torch.set_num_threads(1)
    elif backend != "nccl":  # gloo ranks share the first card: a layout check
        torch.cuda.set_device(0)
    distributed.initialize(f"file://{root}/store", backend=backend)
    device = (torch.device("cpu") if device_type == "cpu"
              else torch.device("cuda", torch.cuda.current_device()))
    ref = torch.load(os.path.join(root, "ref.pt"), map_location=device)
    want = torch.load(os.path.join(root, "ref_params.pt")) if rank == 0 else None
    eps_policy = getattr(policy_lib, eps_policy_name)
    attn = getattr(fa, attn_name) if attn_name else None
    for name, (dp, sp, tp) in layout_map.items():
        mesh = make_mesh(dp=dp, tp=tp, sp=sp, device=device)
        model = sharding.shard_module_(build(cfg, eps_policy, 170, device), mesh)
        before = fa.launches()
        with torch.no_grad():
            eps = sharding.apply_model(model, mesh, ref["x"], ref["t"], ref["c"],
                                       self_attn_fn=attn).float()
        launches = {k: v - before[k] for k, v in fa.launches().items()}
        del model
        eps_rel = ((eps - ref["eps"]).norm() / ref["eps"].norm()).item()
        loss, gnorm, params, sec = one_step(build(cfg, policy_lib.FP32, 171, device), mesh,
                                            ref["batch"])
        row = {"layout": name, "rank": rank, "coords": mesh.coords, "device": str(device),
               "eps_rel_l2": eps_rel, "launches": launches, "loss": loss,
               "loss_rel": rel(loss, ref["loss"]), "grad_norm": gnorm,
               "grad_norm_rel": rel(gnorm, ref["grad_norm"]), "step_s": sec,
               "backend": backend}
        if rank == 0:
            row["params_rel_l2_max"] = rel_per_leaf(params, want)
        with open(os.path.join(root, f"rank{rank}.jsonl"), "a") as f:
            f.write(json.dumps(row) + "\n")
        del params
        if device_type == "cuda":
            torch.cuda.empty_cache()
    import torch.distributed as dist
    dist.destroy_process_group()


def _entry(target, rank, world, root, args):
    # the environment torchrun gives a rank on one host
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world))
    try:
        target(rank, world, root, *args)
    except BaseException:
        import traceback
        with open(os.path.join(root, f"error{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def start(target, world, root, *args):
    """``target(rank, world, root, *args)`` in ``world`` spawned processes
    (``target`` importable by name), each with ``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE`` set as ``torchrun`` sets them on
    one host; returns them for ``wait``."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(target, r, world, str(root), args))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs


def wait(procs, root, timeout):
    """Wait for ``start``'s processes until ``timeout`` seconds from now,
    kill what is left, and raise with the first failed rank's traceback
    (``error<rank>.txt``), or if any was late or failed."""
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    late = [p for p in procs if p.is_alive()]
    for p in late:
        p.kill()
        p.join()
    errors = sorted(f for f in os.listdir(root) if f.startswith("error"))
    if errors:
        with open(os.path.join(root, errors[0])) as f:
            raise RuntimeError(f"{errors[0]}:\n{f.read()}")
    if late or any(p.exitcode for p in procs):
        raise RuntimeError(f"rank exit codes {[p.exitcode for p in procs]}"
                           f"{f', killed at {timeout} s' if late else ''}")


def run(world, root, layout_map, *, backend="nccl", cfg=None, eps_policy="BF16",
        attn="self_attn_fn", device_type="cuda", timeout=600.0):
    """Spawn ``world`` ranks (``rank_main``) against ``reference``'s files
    in ``root``; returns {layout: [each rank's record]}. A rank that fails
    or outlives ``timeout`` raises (the others are killed)."""
    wait(start(rank_main, world, root, backend, cfg or default_cfg(), layout_map,
               eps_policy, attn, device_type), root, timeout)
    out = {name: [] for name in layout_map}
    for r in range(world):
        with open(os.path.join(root, f"rank{r}.jsonl")) as f:
            for line in f:
                row = json.loads(line)
                out[row["layout"]].append(row)
    return out


def check(rows, world, eps_limit=EPS_LIMIT):
    """Raise unless every rank reported at every layout of ``run``'s
    ``rows``, each within the limits (module docstring)."""
    bad = []
    for name, ranks in rows.items():
        if sorted(r["rank"] for r in ranks) != list(range(world)):
            bad.append(f"{name}: ranks {sorted(r['rank'] for r in ranks)} reported")
        for r in ranks:
            held = (r["eps_rel_l2"] < eps_limit and r["loss_rel"] <= STEP_LIMIT
                    and r["grad_norm_rel"] <= STEP_LIMIT
                    and r.get("params_rel_l2_max", 0.0) <= STEP_LIMIT)
            if not held:
                bad.append(f"{name} rank {r['rank']}: {r}")
    if bad:
        raise AssertionError("off the one-device path: " + "; ".join(bad))


def main():
    from pfd_tpu_torch.ops import cuda_build
    from pfd_tpu_torch.ops import flash_attention as fa
    from pfd_tpu_torch.policy import BF16

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the check runs on the cards")
    world = torch.cuda.device_count()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    cuda_build.build(("flash_attention", "cross_attention"))
    with tempfile.TemporaryDirectory(prefix="pfd_mesh_check_") as root:
        _, loss, gnorm, _, sec = reference(root, default_cfg(), world, "cuda", BF16,
                                           fa.self_attn_fn)
        torch.cuda.empty_cache()
        print(json.dumps({"one_device": {"loss": loss, "grad_norm": gnorm, "step_s": sec,
                                         "batch": world}}), flush=True)
        rows = run(world, root, layouts(world))
    for name, ranks in rows.items():
        print(json.dumps({name: ranks}), flush=True)
    check(rows, world)
    print(json.dumps({"ok": True, "layouts": list(rows), "world": world}), flush=True)
    return rows


if __name__ == "__main__":
    main()
