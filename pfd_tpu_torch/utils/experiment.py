"""Experiment management — CLI flags, experiment ids, log-dir layout, resume
(the port's copy of ``pfd_tpu/utils/experiment.py``; the code snapshot is of
``pfd_tpu_torch``).

The working equivalent of the reference's cfg_helper entry machinery:
get_command_line_args (cfg_helper.py:335-423), experiment-id minting from
wall clock (:309-324), log-dir layout + config archiving (:425-640), resume
cfg reconstruction (:354-369). ``--tp`` and ``--coordinator`` are
``pfd_tpu``'s multi-device flags; ``mesh_from_args`` consumes them: it joins
the process group at the coordinator (``parallel.distributed.initialize``,
the rank and world size from ``RANK`` and ``WORLD_SIZE`` as ``torchrun``
sets them) and lays its ranks out with ``--tp`` model-parallel
(``parallel.mesh.make_mesh``), the mesh the sharded train step and
``Trainer`` take.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import time


def get_experiment_id(ref_time=None) -> str:
    """Wall-clock-derived unique id (cfg_helper.py:309-324 semantics)."""
    return time.strftime("%Y%m%d%H%M%S", time.localtime(ref_time))


def get_command_line_args(argv=None):
    p = argparse.ArgumentParser("pfd_tpu_torch")
    p.add_argument("--config", type=str, help="named config (pfd_tpu_torch.config bank)")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--eval", action="store_true")
    p.add_argument("--pretrained_root", type=str, default=None)
    p.add_argument("--log_dir", type=str, default="log")
    p.add_argument("--resume_dir", type=str, default=None)
    p.add_argument("--resume_step", type=int, default=None)
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--grad_acc", type=int, default=1)
    p.add_argument("--tp", type=int, default=1, help="model-parallel degree")
    p.add_argument("--coordinator", type=str, default=None,
                   help="multi-host coordinator address")
    return p.parse_args(argv)


def mesh_from_args(args, device=None):
    """The mesh of ``--coordinator`` and ``--tp``: the process group joined
    (a no-op without a coordinator), then ``make_mesh(tp=args.tp)`` over its
    ranks, data-parallel over the rest; a ``--tp`` the world does not take
    raises."""
    from pfd_tpu_torch.parallel import distributed
    from pfd_tpu_torch.parallel.mesh import make_mesh

    distributed.initialize(args.coordinator)
    return make_mesh(tp=args.tp, device=device)


def init_experiment(args, cfg: dict | None = None) -> dict:
    """Mint an experiment dir, archive the resolved config, snapshot code.
    Returns {'expid', 'log_dir', 'ckpt_dir'}. On resume, reuses the saved dir
    and config (cfg_helper.py:445-470 semantics)."""
    if args.resume_dir:
        log_dir = args.resume_dir
        with open(os.path.join(log_dir, "config.json")) as f:
            saved = json.load(f)
        expid = saved.get("expid", os.path.basename(log_dir))
    else:
        expid = get_experiment_id()
        name = (args.config or "exp")
        log_dir = os.path.join(args.log_dir, f"{expid}-{name}")
        os.makedirs(log_dir, exist_ok=True)
        with open(os.path.join(log_dir, "config.json"), "w") as f:
            json.dump({"expid": expid, "args": vars(args), "cfg": cfg}, f,
                      indent=2, default=str)
        _snapshot_code(log_dir)
    ckpt_dir = os.path.join(log_dir, "weight")
    os.makedirs(ckpt_dir, exist_ok=True)
    return {"expid": expid, "log_dir": log_dir, "ckpt_dir": ckpt_dir}


def _snapshot_code(log_dir):
    """Archive the pfd_tpu_torch source into the log dir (cfg_helper.py:608-628)."""
    import pfd_tpu_torch

    src = os.path.dirname(pfd_tpu_torch.__file__)
    dst = os.path.join(log_dir, "code", "pfd_tpu_torch")
    if not os.path.exists(dst):
        shutil.copytree(src, dst,
                        ignore=shutil.ignore_patterns("__pycache__", "*.pyc"))
