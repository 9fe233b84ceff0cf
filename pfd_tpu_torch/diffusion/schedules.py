"""DDPM β-schedules and DDIM sampling tables.

The port's own copy of ``pfd_tpu/diffusion/schedules.py``. Pure NumPy
(fp64), computed once at model build time; the sampler reads the tables as
fp32 scalars. Formula parity with the reference:
- make_beta_schedule: reference diffusion_utils.py:8-30
- DDPM derived buffers: reference pfd.py:110-168 (register_schedule)
- DDIM timestep subset + α/σ tables: reference diffusion_utils.py:32-59
"""

from __future__ import annotations

import dataclasses

import numpy as np


def make_beta_schedule(schedule: str, n_timestep: int, linear_start=1e-4,
                       linear_end=2e-2, cosine_s=8e-3) -> np.ndarray:
    if schedule == "linear":
        betas = np.linspace(linear_start ** 0.5, linear_end ** 0.5, n_timestep,
                            dtype=np.float64) ** 2
    elif schedule == "cosine":
        timesteps = np.arange(n_timestep + 1, dtype=np.float64) / n_timestep + cosine_s
        alphas = np.cos(timesteps / (1 + cosine_s) * np.pi / 2) ** 2
        alphas = alphas / alphas[0]
        betas = 1 - alphas[1:] / alphas[:-1]
        betas = np.clip(betas, 0, 0.999)
    elif schedule == "sqrt_linear":
        betas = np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64)
    elif schedule == "sqrt":
        betas = np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64) ** 0.5
    else:
        raise ValueError(f"schedule {schedule!r} unknown")
    return betas


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """All DDPM buffers the composite model registers (pfd.py:110-168)."""

    betas: np.ndarray
    alphas_cumprod: np.ndarray
    alphas_cumprod_prev: np.ndarray
    sqrt_alphas_cumprod: np.ndarray
    sqrt_one_minus_alphas_cumprod: np.ndarray
    log_one_minus_alphas_cumprod: np.ndarray
    sqrt_recip_alphas_cumprod: np.ndarray
    sqrt_recipm1_alphas_cumprod: np.ndarray
    posterior_variance: np.ndarray
    posterior_log_variance_clipped: np.ndarray
    posterior_mean_coef1: np.ndarray
    posterior_mean_coef2: np.ndarray
    lvlb_weights: np.ndarray

    @property
    def num_timesteps(self) -> int:
        return int(self.betas.shape[0])


def make_diffusion_schedule(beta_schedule="linear", timesteps=1000,
                            linear_start=1e-4, linear_end=2e-2, cosine_s=8e-3,
                            given_betas=None, v_posterior=0.0,
                            parameterization="eps") -> DiffusionSchedule:
    betas = np.asarray(given_betas, np.float64) if given_betas is not None else \
        make_beta_schedule(beta_schedule, timesteps, linear_start, linear_end, cosine_s)
    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas, axis=0)
    alphas_cumprod_prev = np.append(1.0, alphas_cumprod[:-1])

    posterior_variance = (1 - v_posterior) * betas * (1.0 - alphas_cumprod_prev) / (
        1.0 - alphas_cumprod) + v_posterior * betas

    if parameterization == "eps":
        with np.errstate(divide="ignore"):
            # element 0 divides by posterior_variance[0] == 0; it is
            # overwritten below exactly as the reference does (pfd.py:163)
            lvlb_weights = betas ** 2 / (
                2 * posterior_variance * alphas * (1 - alphas_cumprod))
    elif parameterization == "x0":
        lvlb_weights = 0.5 * np.sqrt(alphas_cumprod) / (2.0 * 1 - alphas_cumprod)
    else:
        raise NotImplementedError(parameterization)
    lvlb_weights = lvlb_weights.copy()
    lvlb_weights[0] = lvlb_weights[1]

    return DiffusionSchedule(
        betas=betas,
        alphas_cumprod=alphas_cumprod,
        alphas_cumprod_prev=alphas_cumprod_prev,
        sqrt_alphas_cumprod=np.sqrt(alphas_cumprod),
        sqrt_one_minus_alphas_cumprod=np.sqrt(1.0 - alphas_cumprod),
        log_one_minus_alphas_cumprod=np.log(1.0 - alphas_cumprod),
        sqrt_recip_alphas_cumprod=np.sqrt(1.0 / alphas_cumprod),
        sqrt_recipm1_alphas_cumprod=np.sqrt(1.0 / alphas_cumprod - 1),
        posterior_variance=posterior_variance,
        posterior_log_variance_clipped=np.log(np.maximum(posterior_variance, 1e-20)),
        posterior_mean_coef1=betas * np.sqrt(alphas_cumprod_prev) / (1.0 - alphas_cumprod),
        posterior_mean_coef2=(1.0 - alphas_cumprod_prev) * np.sqrt(alphas) / (1.0 - alphas_cumprod),
        lvlb_weights=lvlb_weights,
    )


def make_ddim_timesteps(num_ddim_timesteps: int, num_ddpm_timesteps: int,
                        method="uniform") -> np.ndarray:
    if method == "uniform":
        c = num_ddpm_timesteps // num_ddim_timesteps
        ddim_timesteps = np.asarray(list(range(0, num_ddpm_timesteps, c)))
        if ddim_timesteps[-1] + 1 >= num_ddpm_timesteps:
            # the reference grid overflows alphas_cumprod for step counts that
            # don't divide the DDPM horizon (diffusion_utils.py:34-36 would
            # index alphacums[1000]); fail with a clear message instead.
            raise ValueError(
                f"num_ddim_timesteps={num_ddim_timesteps} must divide "
                f"num_ddpm_timesteps={num_ddpm_timesteps} (reference grid "
                "constraint)")
    elif method == "quad":
        ddim_timesteps = ((np.linspace(0, np.sqrt(num_ddpm_timesteps * 0.8),
                                       num_ddim_timesteps)) ** 2).astype(int)
    else:
        raise NotImplementedError(method)
    # +1 to get final alphas right (reference diffusion_utils.py:44)
    return ddim_timesteps + 1


@dataclasses.dataclass(frozen=True)
class DDIMTables:
    timesteps: np.ndarray        # ascending ddpm step indices used by ddim
    alphas: np.ndarray           # ᾱ at those steps
    alphas_prev: np.ndarray
    sqrt_one_minus_alphas: np.ndarray
    sigmas: np.ndarray


def make_ddim_tables(schedule: DiffusionSchedule, num_steps: int, eta=0.0,
                     method="uniform") -> DDIMTables:
    ts = make_ddim_timesteps(num_steps, schedule.num_timesteps, method)
    alphacums = schedule.alphas_cumprod
    alphas = alphacums[ts]
    alphas_prev = np.asarray([alphacums[0]] + alphacums[ts[:-1]].tolist())
    sigmas = eta * np.sqrt((1 - alphas_prev) / (1 - alphas) * (1 - alphas / alphas_prev))
    return DDIMTables(
        timesteps=ts,
        alphas=alphas,
        alphas_prev=alphas_prev,
        sqrt_one_minus_alphas=np.sqrt(1.0 - alphas),
        sigmas=sigmas,
    )
