"""Dtype policy (the port of ``pfd_tpu/policy.py``).

bf16 weights and activations, fp32 GroupNorm/LayerNorm statistics and fp32
softmax, tanh-approximate GELU in the UNet GEGLU feed-forward under BF16;
fp32 everywhere (exact GELU) under FP32, which the parity tests use.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Policy:
    compute_dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.bfloat16
    norm_dtype: torch.dtype = torch.float32
    softmax_dtype: torch.dtype = torch.float32
    gelu_approx: bool = True

    def cast(self, x):
        return x.to(self.compute_dtype)


FP32 = Policy(
    compute_dtype=torch.float32,
    param_dtype=torch.float32,
    norm_dtype=torch.float32,
    softmax_dtype=torch.float32,
    gelu_approx=False,
)

BF16 = Policy()

DEFAULT = BF16
