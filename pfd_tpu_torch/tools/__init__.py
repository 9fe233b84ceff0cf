"""Measurement tools of the port, run on one CUDA card (the port of
``pfd_tpu/tools``' kernel labs):

- ``perf_audit``: per-op attribution and roofline rows of the DDIM hot loop
  (``python -m pfd_tpu_torch.tools.perf_audit``);
- ``attn_lab``: K1 against K3 (``flash_attention(pipelined=...)``) with SDPA
  as the yardstick (``python -m pfd_tpu_torch.tools.attn_lab``);
- ``int8_lab``: int8 against bf16 matmuls and convs, the int8 matmul kernel
  (K7b) and the conv kernels (``python -m pfd_tpu_torch.tools.int8_lab``).

Each prints the card's name and power limit, then one JSON row per case.
"""
