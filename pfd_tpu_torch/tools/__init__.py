"""Measurement tools of the port, run on one CUDA card (the port of
``pfd_tpu/tools``' kernel labs):

- ``perf_audit``: per-op attribution and roofline rows of the DDIM hot loop
  (``python -m pfd_tpu_torch.tools.perf_audit``);
- ``attn_lab``: K1 against K3 (``flash_attention(pipelined=...)``) with SDPA
  as the yardstick (``python -m pfd_tpu_torch.tools.attn_lab``);
- ``int8_lab``: int8 against bf16 matmuls and convs, the int8 matmul kernel
  (K7b) and the conv kernels (``python -m pfd_tpu_torch.tools.int8_lab``);
- ``vae_lab``: the VAE decode in int8, bf16 and int8 with a strided
  activation abs-max (``python -m pfd_tpu_torch.tools.vae_lab``).

Each prints the card's name and power limit, then one JSON row per case.

The quality gates (the port of ``pfd_tpu``'s) print one JSON row per gate row:

- ``e2e_gate``: the port's full-width image against ``pfd_tpu``'s own fp32
  image of the same weights and inputs (``python -m pfd_tpu_torch.tools.e2e_gate``);
- ``quant_gate``: the int8 mode against the bf16 sampler on fan-in weights
  (``python -m pfd_tpu_torch.tools.quant_gate``).

``golden_examples`` runs the reference's 11 cached examples through the
pipeline and gates each on SSIM against its recorded golden
(``python -m pfd_tpu_torch.tools.golden_examples``); ``mesh_check`` holds the
sharded forward and train step at every layout of the visible cards against
the one-device ones (``python -m pfd_tpu_torch.tools.mesh_check``).
"""
