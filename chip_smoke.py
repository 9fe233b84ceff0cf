#!/usr/bin/env python3
"""Drive the PyTorch port (``pfd_tpu_torch``) on one CUDA card, end to end.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits non-zero:

1. device: the card's name and power limit (nvidia-smi), CUDA and nvcc
   versions; no CUDA device -> exit 2, no ``pfd_tpu_torch`` beside this
   script -> exit 3, and no result is printed;
2. build: K1 (``csrc/flash_attention.cu``), K2 (``csrc/cross_attention.cu``),
   K4 (``csrc/flash_attention_pv8.cu``), K5 (``csrc/flash_attention_int8.cu``),
   the int8 conv (``csrc/conv_int8.cu``), K3 (``csrc/flash_attention_pipe.cu``),
   the bf16 conv3x3 of K6 and K7a's bf16 mode (``csrc/conv3x3_bf16.cu``) and
   K7b (``csrc/matmul_int8.cu``) with nvcc for sm_90a, one process per source,
   all at once. The compiler's report is printed: registers and spills, any C7515
   (serialised wgmma) or C7517 (injected wait) line, and one count of C7519
   (injected ``warpgroup.arrive``) per kernel instantiation; a spill, C7515
   or C7517 in K4, K5, the int8 conv or K7b fails the run;
3. K1 against its plain PyTorch version in bf16 at the serving shapes, at
   D = 8, at a ragged S = 4097, and at ragged S on grids wide enough for
   128-row blocks (B*H = 16, S = 5184 and 1296: the last block's second
   warpgroup has no row inside S), and at ToMe's merged ds1 (2,048 tokens,
   the 41-wide head padded to 48, at the scale 41^-0.5), within
   ``kernel_tolerance`` (a tenth of
   the output's RMS, at most 2e-2), with kernel, plain, library
   (``scaled_dot_product_attention``, a yardstick only) and bound times;
4. the same for K2, at the serving shapes over the 148 context tokens, at
   Sq = 5184 (ragged against 128-row blocks, each block walking 5-6 q-tiles)
   and over 512 and 1,024 keys (K1's key loop), at ``attn_lab``'s batch 16,
   and at the KV pool's reuse steps (B*H = 8, 4,096 queries over 1,024 and
   256 pooled keys),
   each row with the variant
   the launcher picks (rows a block, key tile, blocks a head) and the host's
   cost of one call (1,000 calls without a sync); then the dispatchers'
   routes: fp32 to plain attention with no launch, a head of 36 padded to 40
   through K1;
5. the slice at full published width (``pfd_seecoder_with_controlnet``, BF16,
   random weights from a seed with the zero-initialised layers de-zeroed),
   served in phases 5-8b through ``action_inference`` with each graph's
   body run eagerly in its place (``eager_request``: SeeCoder, then
   ``sample_decode``), the yardstick phase 8c holds the graphs to, with
   per-stage CUDA-event times: request A (512x512 reference image, no hint, 50 DDIM steps, guidance 2.0,
   seed 42) must give a finite image in [0, 1] and launch K1 501 times and K2
   500 times; request B (= A) must repeat it bit for bit; request C (seed 7,
   10 steps) must differ; one UNet call through the kernels is held against
   the same call through plain attention, and profiled; request F (as A, with
   a canny hint of a seeded 512^2 image with structure, whose edge fraction
   must lie in [0.003, 0.02]) must give a finite image in [0, 1] that differs
   from A and launch K1 701 and K2 700 times (the ControlNet's 4 long
   transformer blocks a step besides the UNet's 10); F' (= F) must repeat it
   bit for bit; one ControlNet call through the kernels is held against the
   same call through plain attention (its 13 residuals and the eps with them,
   relative L2 <= 5e-2), and one UNet + ControlNet step is profiled;
6. K4 and K5 (the int8 mode's attention) against their plain versions within
   ``kernel_tolerance`` and against float attention within ``pfd_tpu``'s
   bounds (max-abs / max|want| < 0.08, mean-abs / max|want| < 0.01; where the
   plain version itself is further off in max-abs, as at S = 4096, within
   its error plus ``kernel_tolerance``), at the serving shapes and at
   ``pfd_tpu``'s own test shapes; K4's and K5's rows time the kernel alone,
   the wrapper (with the V8^T layout copy, and K5's q8 / k8 row padding) and
   the V8^T copy;
7. the int8 conv against its plain version, bit for bit, at every int8 conv
   geometry of a 512^2 request (the ControlNet's hint pyramid's three at
   batch 1 too), each row with its plan (box, tile width, tiles, depth split);
8. the int8 serving mode at full width (``quantized=True``,
   ``self_attn_fn_int8``): request D (as A) must give a finite image in
   [0, 1] and launch K4 500, K2 500, K1 1 and the int8 conv the number of
   quantized convs the plan runs; request D' (= D) must repeat it bit for
   bit; request E (mode "full", 10 steps) must launch ``LaunchPlan``'s count, K5
   100 times; request G
   (F's hint, 10 steps) must give a finite image in [0, 1] and launch K4 140,
   K2 140, K1 1 and the int8 conv 764 times (10 x (50 + the ControlNet's 23)
   + the hint pyramid's 3 + the decoder's 31); one int8 UNet call through
   the kernels is held against the same call through the plain versions
   (relative L2 <= 5e-2); one int8 UNet + ControlNet call (from the raw hint)
   through the kernels is held against the same call with the int8 conv's
   plain version, bit for bit, and against the call through every plain
   version within relative L2 5e-2 or the int8 function's own spread where
   that is larger (K4's plain version on a 1,024-key tile against on K4's);
   both calls are profiled; one line of throughput, 8 images of 10 steps, bf16
   against int8, and a profile of one UNet call at that batch in each mode;
8b. the turbo serving modes at full width, each request's launches held to
   the counts ``LaunchPlan`` derives from the model's plans
   (``decoder_split``'s cut; the transformer blocks at S >= 1024): request H
   (bf16, no hint, ``phases=[(8, 2), (42, 21)]``: 6 key steps, 44 reuse steps
   on the shallow suffix; K1 193, K2 192) must give a finite image in [0, 1]
   that differs from A, and H' must repeat it bit for bit; H_kv (H with
   ``kv_pool=2``: the reuse steps' ds1 self-attention on K2 over 1,024
   pooled keys; K1 61, K2 324); H_tome (the exact sampler with
   ``tome_ratio=0.5``: K1 on 2,048 merged tokens, a 41-wide head padded to
   48; K1 501, K2 500); H's final latent through the kernels held against H
   through plain attention (relative L2 <= 5e-2); request I (int8, H's
   phases; K4 192, K2 192, K1 1, ``conv_int8`` 639); J (F's hint,
   ``control_turbo=True``, ``phases=[(10, 2), (40, 20)]``; K1 228, K2 227)
   must differ from F; J0 (``control_turbo=False``) must be F bit for bit;
   a key step and a reuse step profiled; s/img of A (again), H, H_kv,
   H_tome, I and J at b1, and of 8 images of 50 steps, int8 exact against
   ``ph8x2_42x21`` and ``ph8x2_42x21_kv2``, bf16 exact against
   ``ph8x2_42x21``;
8c. the compiled hot path through ``action_inference`` (``ops/graphs.py``:
   one captured CUDA graph a bucket; both pipelines' pools measure their
   captures, ``GraphPool.measure``, where phase 12's capture as a request
   does): ``warmup`` of the A, F, H, H_kv, H_tome, J0, J,
   D, E, G, I and both b8 buckets with each one's seconds (eager warm-up
   run, capture, instantiation), node count and pool growth; graphed A, F,
   H, H_kv, H_tome, J0, J, D, E and G (10 steps), I and b8 x 50 int8 and
   bf16 ``ph8x2_42x21`` each equal to its eager twin above bit for bit
   (every image of the batch) and launching ``LaunchPlan``'s count per
   replay; A at guidance 3.0 through A's bucket (its eager twin bit for
   bit); a bf16 and an int8 diffuser swap in place followed by a replay of
   the old graph (the eager request after the swap bit for bit), then the
   weights put back (the image before); s/img eager against graphed in 3
   turns for A, F, H, D, I and the int8 b8 line, the graphed ones also by
   CUDA events; a profile of one graphed A, E, F, G and H request (device
   busy and idle share), where the port's kernels the profiler saw run, by
   name, must be the launches a replay adds to the counters; a SeeCoder-PA
   swap, which captures SeeCoder anew (J's bucket against its eager twin
   under the new encoder);
9. K3 (``flash_attention(pipelined=True)``) against its plain version and
   against K1 within ``kernel_tolerance``, at K1's wide-grid ragged shapes
   among others; K6 (``conv3x3_fused``, with the
   ResBlock shift folded into its affine and a residual) and its conv-only
   mode against their plain version within relative L2 2e-3 and max-abs one
   bf16 ulp of the largest output, each row with its plan (box, tiles, depth
   split), at (2,1280,8,8) too, where one box spans two images, and at the
   model's output convs 320 -> 4 and 128 -> 3, whose Cout the wrapper pads;
   K7b (``matmul_int8``) against its plain version and ``torch._int_mm``,
   bit for bit, each row with its tile width and waves; each with kernel,
   plain, library and bound times;
10. the kernel labs through their entry points, a few iterations each:
   ``perf_audit`` (``AUDIT_SECTIONS=fused``), ``attn_lab`` and ``int8_lab``
   (``LAB_SECTIONS=pallas_mm,convs``), with the launch counts set to 0 just
   before and read just after: K3, the conv3x3 kernel and K7b must each
   launch;
11. the quality gates at full width, through the tools' own functions:
   ``tools/e2e_gate.py``'s rows of both sets (``fp32``, ``fp32_eps``,
   ``bf16``, ``bf16_plain_attn``, ``int8``, ``int8_attn8``; ``ctl_fp32``,
   ``ctl_bf16``, ``ctl_int8``), each scored against ``pfd_tpu``'s own fp32
   image of the same weights and inputs (the committed reference), with the
   floor rows and the SeeCoder tokens' error, ``fp32`` once more with
   cuDNN's TF32 convs (``fp32_tf32``, the fault the fp32 rows must catch),
   and ``tools/quant_gate.py``'s ``int8`` and ``ctl_int8`` rows at 8
   samples; with them ``pfd_tpu``'s turbo, KV-pool and ToMe rows
   (``DIRECT_TURBO``, ``QUANT_TURBO``) and the fp32 rows under the phased
   schedules (``fp32_ph8x2_42x21``, ``ctl_fp32_ph10x2_40x20``), scored
   against ``pfd_tpu``'s fp32 run of the same schedule. It fails unless
   every image is finite, ``fp32``, ``ctl_fp32`` and the fp32 turbo rows
   reach SSIM 0.999 and latent relative L2 1e-5 while ``fp32_tf32`` exceeds
   1e-5, the other direct rows SSIM 0.95 (the exact bf16 and int8 ones also
   latent relative L2 1e-2), the quant rows a minimum SSIM of 0.95 over
   their samples, and each row launched exactly the kernels of its route
   (``gate_route``: no attention kernel under fp32; the VAE's mid-block K1
   alone in ``bf16_plain_attn``; ``LaunchPlan``'s count otherwise);
12. the checkpoint loader and the serving entry points at full width, on a
   zoo written to a temporary ``pretrained_root`` (removed at the end): fp16
   ``.safetensors`` files of ``SD-v1.5``, ``Deliberate-v2.0`` (its context
   blocks under ``diffuser.text.``), the ``SeeCoder`` (with its Swin
   buffers) and the ``canny`` ControlNet, the VAE as an fp32 ``.pth`` and
   ``assets/anime_ug.pth``, each from its own seed (the bytes and seconds of
   each write, load and swap printed); after each load and swap every
   tensor of the part must equal the file's cast to its dtype, bit for bit
   (int8 codes, scales and upsample phase kernels a fresh quantize); requests
   S1-S5 over HTTP (``serve._Handler`` on 127.0.0.1, nested-list payloads,
   10 steps, seed 42), each beside the same request made directly (same
   8-bit image): S1 ``SD-v1.5``, S2 ``Deliberate-v2.0`` (must differ), S3
   ``SD-v1.5`` (= S1 bit for bit), S4 with a canny hint (returns it), S5
   ``SeeCoder-Anime`` (no file: the weights stay, the anime negative
   context; must differ), each launching ``LaunchPlan``'s count, the
   pipeline's two 10-step buckets captured by ``warmup`` first; the int8
   pipeline's swap SD -> Deliberate -> SD through its graph (its requests
   launch K4, K2, ``conv_int8`` at ``LaunchPlan``'s counts, differ, then
   repeat bit for bit); ``ZooServer`` b4 grouped over both tags with canny
   hints and ``control_on=[1, 0, 0, 1]``, both groups on one captured graph
   (equal to the eager body group by group bit for bit; each image within
   max(2x the batch-2 vs batch-1 spread, 1e-3) relative L2 of its request
   alone; b1 sharded = grouped bit for bit) and ``DataParallelServer`` b8
   captured by its ``warmup`` (equal to its eager body bit for bit), with
   s/img graphed against eager in 3 turns;
13. config #4, the annotator networks and the full preprocess stack into
   the ControlNet path, on files written to a temporary ``pretrained_root``
   (removed at the end): seeded random-init files of HED, PiDiNet, MLSD,
   MiDaS and OpenPose's body, hand and face nets at their published widths,
   in the upstream layouts ``pfd_tpu`` reads (the bytes and seconds of each
   write and load printed; each load equal to the weights written); every
   network method of ``zoo.PREPROCESS_METHODS`` at 512^2 on the card, each
   hint finite, not constant, with its share of saturated levels (the
   OpenPose body decode's peaks, people and seconds, bounded by
   ``DECODE_BOUND_S``; ``openpose_withfacehand`` must run the hand and face
   nets); each network on the card against itself on the CPU, same weights,
   at the input a 512^2 request gives it, within relative L2 1e-4, and its
   ms there (CUDA events); one bf16 10-step request per method (canny, hed,
   depth, normal, mlsd, openpose_withfacehand, scribble) through
   ``action_inference`` on one captured 10-step bucket, each a finite image
   in [0, 1] equal to its eager twin bit for bit (image and hint), launching
   ``LaunchPlan``'s K1 and K2, and each network's image differing from
   canny's; one int8 request with the depth hint at ``LaunchPlan``'s
   ``conv_int8``, K4, K2 and K1 count, equal to its eager twin;
14. (run after phase 10, on phase 5's bf16 pipeline: config #1's path, no
   hint) the CLIP and OpenCLIP context encoders, multi-context mixing and
   Euler-ancestral sampling at 512^2, b1, CFG 2.0: K2 at the new key counts
   (77: a CLIP text context, 83 of the resident tile's keys masked; 257: a
   CLIP image context, K1's key loop with a one-key last tile) at ds1 and
   ds2 against its plain version, with the softmax row sums (all-ones
   values: 1 within one bf16 ulp); the eleven encoders at published width
   (CLIP ViT-L/14 vision, plain, masked and position-agnostic, and text:
   SD-v1, projected, customized embedding; OpenCLIP ViT-H-14 text:
   penultimate, projected, tokenizers v1, v2 and v3, v3 with rank-4 LoRA
   adapters, and visual with and without masks) from numpy-seeded weights in
   fp32, each on the card within relative L2 1e-5 of the host's run of the
   same weights and inputs, with its forward ms (CUDA events, median of 3),
   and v3's adapters against its merged weights; then five requests, each a
   finite image in [0, 1], the same seed bit for bit, the 10-step final
   latent through the kernels within ``compare_eps``'s bound of plain
   attention, at ``LaunchPlan``'s K1 and K2 count (``contexts``), with its
   s/img: ``clip_image`` (DDIM-50 on the reference's 257 CLIP image tokens,
   zero unconditional context), ``clip_text`` (DDIM-50 on fixed ids' 77 CLIP
   text tokens, the empty prompt's as the unconditional context),
   ``multi_attn`` (DDIM-50, SeeCoder of the reference at 0.6 and CLIP image
   of the hint image at 0.4, ``"attention"`` mixing: each long block twice),
   ``multi_layer`` (the same, ``"layer"`` mixing, 10 steps, the pathways
   from the generator) and ``euler_a`` (Euler-ancestral, 50 steps, eta 1.0,
   on SeeCoder's context); the encoders are freed at its end;
15. (run after phases 12 and 13, their graph pools released) the training
   path at full width, printing ``torch.cuda.memory_allocated`` at its start:
   (a) the guards: K1 on a bf16 input that requires grad raises; a bf16 VAE
   encoder forward at 512^2 with grad enabled launches no K1 (plain
   attention) and gives a finite, non-zero input gradient;
   ``ops.nn.conv2d_raw``'s fp32 backward and second derivative at
   full-width UNet convs (``CONV_ROWS``: grad input at (2,320,64,64) -> 320,
   grad weight at (2,640,32,32) -> 640, the second derivative at
   (2,320,64,64)), within relative L2 1e-5 of a float64 host reference,
   each beside a control row with cuDNN's TF32 allowed that must read above
   it in the quantity its row holds;
   (b) ``DiffusionBatcher`` over ``data.synthetic(512, seed=0)``, batch 2, on
   a bf16 ``pfd_seecoder`` VAE and SeeCoder: 9 batches, x0 (2,4,64,64) and
   cond (2,148,768) finite, K1 once a batch at (2,1,4096,512) (its launches
   are ``train_batch`` in the ``kernels`` line), t and noise those of numpy
   ``default_rng(0)``; (c) config #1's diffuser alone (``openai_unet_2d_v1``,
   859.5 M parameters, FP32, seeded and de-zeroed) through ``Trainer.fit``:
   AdamW over ``pfd_parameter_groups`` with clipping at 1.0 and a
   ``LambdaWarmUpCosine`` schedule, 4 steps of 2 micro-batches of 2 at 512^2,
   EMA, a log line a step, the evaluator (the held-out batch's loss under
   the EMA weights) and a checkpoint at step 4 in a temporary directory
   (removed at the end): every loss and grad_norm finite, the EMA shadows
   differ from the parameters and lie inside their trajectory's envelope, a
   fresh model's ``resume`` restores every tensor bit for bit; the step
   seconds (median of steps 2-4), images/s, peak allocated GB, the
   checkpoint's GB and write and read seconds; (d) one ``make_train_step``
   step at b1, 256^2 on the card and on the host from the same weights and
   batch: loss within relative 1e-5, the pre-clip gradient within relative
   L2 1e-4; (e) two steps with only ``diffuser_image_context`` trainable:
   every other parameter bit for bit, every trained tensor moved; (f) the
   VAE's GAN step (``autokl_v2`` FP32, LPIPS at VGG16 widths, the
   discriminator at ndf 64 x 3 layers, numpy-seeded) at b2, 256^2:
   ``generator_loss`` and ``discriminator_loss`` finite, ``d_weight``
   finite, gradients non-zero, one AdamW step each moving every tensor, and
   each side's ms; then ``generator_loss`` at b1, 128^2 with ``d_weight``
   unclamped (the discriminator's last conv x1e3): the gradients of
   ``d_weight`` (second order) and of the loss within relative L2 1e-3 of
   a float64 host run, beside a control row with TF32 in every fp32 conv
   that must read above it (``gan_second_order_rows``);
16. (run after phase 15) the classic and legacy UNet family and the
   sdwebui converter, BF16 at full published width from seeded, de-zeroed
   weights unless a line says otherwise, its files in a temporary root
   (removed at the end): (a) ``openai_unet_sd`` (the classic layout, 859.5 M
   parameters) built by ``build_model``, one eps call at 512^2 (latent
   (2,4,64,64), t = [981, 21], a (2,148,768) context) through the kernels
   within ``compare_eps``'s bound of plain attention, launching K1 10 and K2
   10, with its ms (CUDA events, median of 3); (b) its state dict under
   ``model.diffusion_model.`` written as fp32 ``.safetensors``, converted by
   the port's CLI in a subprocess (``python -m
   pfd_tpu_torch.tools.model_conversion sdwebui_diffuser src dst``), loaded
   into an ``openai_unet_2d_v1`` diffuser through
   ``io/loader.diffuser_sd_to_params``: its eps through the kernels within
   relative L2 1e-3 of (a)'s (whether bit-exact printed), and ``--reverse``
   back to the source's tensors bit for bit; (c) the converted file at
   ``SD-v1.5``'s zoo path, swapped into a bf16 ``pfd_seecoder`` pipeline by
   ``action_load_diffuser`` (every tensor equal to the file's), one graphed
   10-step b1 request at 512^2, CFG 2.0, finite in [0, 1], at
   ``LaunchPlan``'s K1 and K2, repeating bit for bit, with its s/img; (d)
   ``openai_unet_dual_context`` with branch 0 holding (a)'s weights: which
   = 0.5 over two 148x768 contexts within ``compare_eps``'s bound of plain
   attention at K1 20 and K2 20, and which = 0 equal to (a)'s eps bit for
   bit; (e) the other nine registry names at the tiny configs of the CPU
   tests (``TINY_CASES``: both nocontext attentions, the encoder's four
   pools in both head orders, VD's streams and its blend), fp32, the card
   within relative L2 1e-5 of the host on the same weights and inputs
   (``openai_unet_0d`` held at 64 channels: at 32 its first level's
   GroupNorms see groups of one value, where the host gives 0 and the card
   rounding times 1/sqrt(eps); that row is printed), the first module off
   by 1e-6 named on a failure;
17. (run after phase 16, its models and graph pools released; the memory
   allocated at its start printed) the multi-device path, the VAE lab and
   the golden harness, its files in a temporary root (removed at the end):
   K1 at the tp=2 shard (2,4,4096,4096,40) and K2 at the sp=2
   self-attention (2,8,2048,4096,40) and (2,8,512,1024,80) against their
   plain versions, with their rows; (a) ``tools/vae_lab.run`` at b8, 512^2:
   the int8, bf16 and int8 stride-4 decodes, each finite, the int8 rows
   launching ``conv_int8`` and every row K1, with their ms; (b)
   ``tools/golden_examples.run``: the tiny smoke's cases 0 and 7 recorded,
   then compared at SSIM 1.0; then at full width (fp16, random de-zeroed
   weights, an empty pretrained root, K1/K2 through ``self_attn_fn``) on
   synthetic images written at cases 0's and 7's asset paths with an anime
   negative context: recorded, then compared at SSIM >= 0.95, whether bit
   for bit and the s/img printed; (c) ``distributed.initialize`` over NCCL
   at world size 1 and ``make_mesh()``: every group None, the sharded
   ``openai_unet_2d_v1`` bf16 eps at 512^2 (latent (2,4,64,64), a
   (2,148,768) context) through the kernels equal to the one-device eps bit
   for bit at K1 10 / K2 10, and one FP32 sharded AdamW step at 256^2, b2
   (lr ``mesh_check.LR``), within relative 1e-5 (loss, ``grad_norm``) and
   relative L2 1e-5 per parameter of ``parallel/train``'s one-device step
   (whether bit for bit printed, and a second one-device step's distance
   from the first), the one-device side from ``tools/mesh_check.reference``;
   (d) two spawned processes on the one card over gloo
   (``tools/mesh_check.run``), at dp2, tp2 and sp2 (``MESH_LAYOUTS``): each
   rank's K1/K2 launches (``MESH_LAUNCHES``: K1 at 4 heads under tp2, K2 for
   the self-attention under sp2), and ``mesh_check.check``: each rank's eps
   within ``compare_eps``'s bound of (c)'s, its step's loss and
   ``grad_norm`` within relative 1e-5 of (c)'s one-device step and rank 0's
   parameters within relative L2 1e-5; each layout's step seconds,
   labelled a layout check;
18. a ``kernels`` JSON line (``launches``: the graphed requests of phase
   8c, F for the bf16 kernels, G for the int8 ones and E for K5; every
   serving request's counts, the turbo ones', the graphed ones' and phases
   12's, 13's, 14's, 15's, 16's and 17's too, in ``launches_by_request``;
   K1's and K2's rows phase 17's, K2's phase 14's too), the card's name and
   power limit, then the device JSON as the last line.

Imports neither JAX nor ``pfd_tpu``.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import json
import os
import re
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_INT8_OPS = 1979e12    # H100 SXM dense int8
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
MUFU_PER_SM_CLK = 16       # exp2 (MUFU.EX2) results per SM per clock on Hopper
SLEEP_CYCLES_PER_CALL = 400_000  # 0.2 ms at 1,980 MHz: ahead of a timed call's enqueue
# the s8 wgmma kernels whose build fails on a spill, C7515 or C7517 (a spill
# of the accumulator, or wgmmas that ptxas serialised or waits on)
GUARDED = ("flash_attention_pv8", "flash_attention_int8", "conv_int8", "matmul_int8")


def sh(cmd):
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, iters):
    """Mean ms per call over ``iters`` calls after 3 warm-up calls (CUDA events).
    A sleep kernel ahead of the first event keeps the device busy while the
    host enqueues the calls, so that the host's cost of a call (15-40 us for
    a wrapper here) does not set the time of a kernel shorter than it."""
    import torch
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES_PER_CALL * iters)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound_ms(b, h, sq, skv, d, mufu_rate):
    """Least time for the function: q, k, v read once and o written once over
    the memory rate; the two products' FLOPs over the bf16 tensor-core rate;
    the exp2 count over the MUFU rate. Returns (ms, 'bytes' | 'operations')."""
    nbytes = 2 * b * h * d * (2 * sq + 2 * skv)
    flops = 4 * b * h * sq * skv * d
    t_bytes = nbytes / PEAK_BYTES
    t_ops = max(flops / PEAK_BF16_FLOPS, b * h * sq * skv / mufu_rate)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check_kernel(name, kernel, qshape, skv, mufu_rate, gen, variant=None, scale=None):
    """A bf16 attention kernel against ``attention_plain`` (at ``scale``, by
    default the head's own); ``variant``: the launcher's pick to print (K2),
    whose rows also time the host's cost of one call."""
    import torch
    import torch.nn.functional as F
    from pfd_tpu_torch.ops import flash_attention as fa
    from pfd_tpu_torch.tools import attn_lab

    b, h, sq, d = qshape
    q = torch.randn(qshape, generator=gen, device="cuda").bfloat16()
    k = torch.randn((b, h, skv, d), generator=gen, device="cuda").bfloat16()
    v = torch.randn((b, h, skv, d), generator=gen, device="cuda").bfloat16()
    if scale is not None:
        kernel = functools.partial(kernel, scale=scale)
    got = kernel(q, k, v)
    want = fa.attention_plain(q, k, v, scale=scale)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    tol = fa.kernel_tolerance(want)
    if not err <= tol:
        raise AssertionError(f"{name} {qshape} skv={skv}: max_abs_err {err} > {tol}")
    big = b * h * sq * skv > 2 ** 28
    row = {
        "shape": [b, h, sq, skv, d],
        "max_abs_err": err,
        "tol": tol,
        "err_over_tol": err / tol,
        "kernel_ms": cuda_ms(lambda: kernel(q, k, v), 20),
        "plain_ms": cuda_ms(lambda: fa.attention_plain(q, k, v, scale=scale), 3 if big else 10),
        "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale), 20),
    }
    if scale is not None:
        row["scale"] = scale
    if variant is not None:
        row["variant"] = variant
        row["host_us"] = attn_lab.host_us(kernel, q, k, v)
    row["bound_ms"], row["bound_by"] = attention_bound_ms(b, h, sq, skv, d, mufu_rate)
    print(f"{name} {json.dumps(row)}  bound_us={row['bound_ms'] * 1e3:.1f}", flush=True)
    return row


def check_dispatch(gen):
    """The dispatchers' routes on the card: fp32 q, k, v go to plain
    attention and launch nothing; a bf16 head of 36 is zero-padded to 40,
    runs K1 once and matches unpadded plain attention within
    ``kernel_tolerance``."""
    import torch
    from pfd_tpu_torch.ops import flash_attention as fa
    from pfd_tpu_torch.ops import nn as tnn

    q32 = torch.randn((2, 8, 1024, 40), generator=gen, device="cuda")
    before = fa.flash_attention.launches
    if not torch.equal(fa.self_attn_fn(q32, q32, q32), tnn.dot_product_attention(q32, q32, q32)):
        raise AssertionError("dispatch: fp32 self-attention is not plain attention")
    if fa.flash_attention.launches != before:
        raise AssertionError("dispatch: fp32 self-attention launched K1")
    q, k, v = (torch.randn((2, 8, 1024, 36), generator=gen, device="cuda").bfloat16()
               for _ in range(3))
    got = fa.self_attn_fn(q, k, v)
    want = fa.attention_plain(q, k, v)
    err = (got.float() - want.float()).abs().max().item()
    if fa.flash_attention.launches != before + 1 or not err <= fa.kernel_tolerance(want):
        raise AssertionError(f"dispatch: D = 36 through K1: launches "
                             f"{fa.flash_attention.launches - before}, max_abs_err {err}")
    print(f"dispatch: fp32 -> plain attention (no launch); D=36 -> K1 on 40 columns, "
          f"max_abs_err {err:.3e}", flush=True)


def int8_attention_bound_ms(b, h, s, d, mufu_rate, full):
    """Least time for K4 (full=False) or K5: q, k (bf16, or int8 for K5) and
    the int8 v read once, the bf16 output written once, over the memory
    rate; QK^T at the bf16 rate (int8 for K5) plus int8 P.V at the int8
    rate; the exp2 count over the MUFU rate."""
    qk_bytes = 1 if full else 2
    nbytes = b * h * s * d * (2 * qk_bytes + 1 + 2)
    prod = 2 * b * h * s * s * d
    t_mma = prod / (PEAK_INT8_OPS if full else PEAK_BF16_FLOPS) + prod / PEAK_INT8_OPS
    t_ops = max(t_mma, b * h * s * s / mufu_rate)
    t_bytes = nbytes / PEAK_BYTES
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check_int8_attention(name, quant, shape, mufu_rate, gen):
    """K4 (quant="pv") or K5 (quant=True) against its plain version, and
    the int8 attention against float attention."""
    import torch
    import torch.nn.functional as F
    from pfd_tpu_torch.ops import flash_attention as fa
    from pfd_tpu_torch.ops import nn as tnn
    from pfd_tpu_torch.ops import quant as tq
    from pfd_tpu_torch.ops.int8_matmul import pad_depth

    b, h, s, d = shape
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").bfloat16() for _ in range(3))
    got = fa.flash_attention(q, k, v, quant=quant)
    want = fa.attention_int8_plain(q, k, v, quant=quant)
    ref = tnn.dot_product_attention(q.float(), k.float(), v.float())
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    tol = fa.kernel_tolerance(want)
    if not err <= tol:
        raise AssertionError(f"{name} {shape}: max_abs_err {err} > {tol}")
    # pfd_tpu's bounds against float attention (tests/test_flash_attention.py
    # :95-98, S <= 520): max-abs / max|ref| < 0.08, mean-abs / max|ref| < 0.01.
    # On unit-normal inputs at S >= 4096 the int8 function itself (the plain
    # version) is further off in max-abs than 0.08, so there the kernel may
    # be off by the plain version's own error plus kernel_tolerance.
    top = ref.abs().max().item()
    e = (got.float() - ref).abs()
    vs_float = (e.max().item() / top, e.mean().item() / top)
    plain_vs_float = (want.float() - ref).abs().max().item() / top
    max_limit = max(0.08, plain_vs_float + tol / top)
    if not (vs_float[0] < max_limit and vs_float[1] < 0.01):
        raise AssertionError(f"{name} {shape}: off float attention {vs_float}, "
                             f"limit ({max_limit}, 0.01)")
    # the kernel alone (and its plain version) on the quantized inputs
    scale = d ** -0.5
    v8, _ = tq.quantize_act(v, amax_dims=(1, 2))
    if quant is True:
        q8, sq = tq.quantize_act(q, amax_dims=(1, 2))
        k8, sk = tq.quantize_act(k, amax_dims=(1, 2))
        c = (sq * sk * (scale * fa.LOG2E)).reshape(1)
        q8p, k8p, v8t = pad_depth(q8, 3), pad_depth(k8, 3), fa.v8_keys_major(v8)
        kern = lambda: fa.launch_int8(q8p, k8p, v8t, c)  # noqa: E731
        plain = lambda: fa.int8_plain(q8, k8, v8, c, out_dtype=q.dtype)  # noqa: E731
        wrapper = lambda: fa.flash_attention_int8(q8, k8, v8, c, out_dtype=q.dtype)  # noqa: E731
    else:
        qs = fa._qscale(q, scale)
        v8t = fa.v8_keys_major(v8)
        kern = lambda: fa.launch_pv8(q, k, v8t, qs)  # noqa: E731
        plain = lambda: fa.pv8_plain(q, k, v8, qscale=qs)  # noqa: E731
        wrapper = lambda: fa.flash_attention_pv8(q, k, v8, qscale=qs)  # noqa: E731
    big = b * h * s * s > 2 ** 28
    row = {
        "shape": [b, h, s, s, d],
        "max_abs_err": err,
        "tol": tol,
        "err_over_tol": err / tol,
        "vs_float_max_mean": list(vs_float),
        "plain_vs_float_max": plain_vs_float,
        "kernel_ms": cuda_ms(kern, 20),
        "plain_ms": cuda_ms(plain, 3 if big else 10),
        "sdpa_bf16_ms_yardstick_other_function": cuda_ms(
            lambda: F.scaled_dot_product_attention(q, k, v), 20),
        "library_ms": None,
    }
    row["wrapper_ms"] = cuda_ms(wrapper, 20)
    row["v8_layout_ms"] = cuda_ms(lambda: fa.v8_keys_major(v8), 20)
    row["bound_ms"], row["bound_by"] = int8_attention_bound_ms(b, h, s, d, mufu_rate,
                                                               quant is True)
    print(f"{name} {json.dumps(row)}  bound_us={row['bound_ms'] * 1e3:.1f}", flush=True)
    return row


def conv_bound_ms(n, c, h, w, k, kh, ho, wo):
    """Least time for the int8 conv: x and w (int8) read once and y (int32)
    written once over the memory rate; 2*M*N*K operations over the int8
    rate."""
    nbytes = n * c * h * w + k * c * kh * kh + 4 * n * k * ho * wo
    ops = 2 * n * ho * wo * k * kh * kh * c
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_INT8_OPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check_conv(label, xshape, cout, ksize, stride, padding, gen):
    """The int8 conv against its plain version (bit for bit), with kernel,
    plain, cuDNN bf16 (same geometry, a yardstick) and bound times."""
    import torch
    import torch.nn.functional as F
    from pfd_tpu_torch.ops import int8_conv

    def codes(shape):
        return torch.randint(-127, 128, shape, generator=gen, device="cuda",
                             dtype=torch.int8).contiguous(memory_format=torch.channels_last)

    x8, w8 = codes(xshape), codes((cout, xshape[1], ksize, ksize))
    got = int8_conv.conv_int8(x8, w8, stride=stride, padding=padding)
    want = int8_conv.conv_int8_plain(x8, w8, stride=stride, padding=padding)
    torch.cuda.synchronize()
    if got.shape != want.shape or not torch.equal(got, want):
        bad = (got != want).sum().item() if got.shape == want.shape else "shape"
        raise AssertionError(f"conv_int8 {label}: not bit-exact ({bad} differ)")
    xb = F.pad(x8.to(torch.bfloat16), int8_conv.pads(padding))
    wb = w8.to(torch.bfloat16)
    n, c, h, w = xshape
    ho, wo = got.shape[2:]
    plan = int8_conv.conv_int8_plan(n, ho, wo, -(-c // 16) * 16, cout, ksize * ksize, stride,
                                    torch.cuda.get_device_properties(0).multi_processor_count)
    row = {"shape": label, "plan": plan, "max_abs_err": 0.0,
           "kernel_ms": cuda_ms(lambda: int8_conv.conv_int8(x8, w8, stride=stride,
                                                            padding=padding), 20),
           "plain_ms": cuda_ms(lambda: int8_conv.conv_int8_plain(
               x8, w8, stride=stride, padding=padding), 3),
           "cudnn_bf16_ms_yardstick": cuda_ms(lambda: F.conv2d(xb, wb, stride=stride), 20),
           "library_ms": None}
    row["bound_ms"], row["bound_by"] = conv_bound_ms(n, c, h, w, cout, ksize, ho, wo)
    print(f"conv_int8 {json.dumps(row)}  bound_us={row['bound_ms'] * 1e3:.1f}", flush=True)
    return row


def launch_counts(labs=False):
    """The serving path's launch counters (``ops.flash_attention.launches``);
    with ``labs`` the others of ``graphs.counters()``, the kernels that only
    the labs reach."""
    from pfd_tpu_torch.ops import flash_attention as fa
    from pfd_tpu_torch.ops import graphs
    if labs:
        return {k: v for k, v in graphs.launch_counts().items() if k not in fa.SERVING}
    return fa.launches()


def kernel_counts(events):
    """{launch counter: kernels run} of a profile's device rows: each of the
    port's kernels by its name, ``flash_sm90_kernel``'s template arguments
    (PIPE, QSLOTS, PV8, QK8) telling K1-K5 apart."""
    n = collections.Counter()
    for e in events:
        m = re.search(r"flash_sm90_kernel<\d+, \d+, (\w+), \w+, (\d+), (\w+), (\w+)>", e.key)
        if m:
            pipe, qslots, pv8, qk8 = m.groups()
            name = ("flash_attention_pipe" if pipe == "true" else
                    "flash_attention_int8" if qk8 == "true" else
                    "flash_attention_pv8" if pv8 == "true" else
                    "cross_attention" if qslots == "2" else "flash_attention")
        else:
            name = next((c for k, c in (("conv_int8_kernel", "conv_int8"),
                                        ("conv3x3_kernel", "conv3x3_bf16"),
                                        ("matmul_int8_kernel", "matmul_int8")) if k in e.key),
                        None)
        if name:
            n[name] += e.count
    return dict(n)


def reset_counts():
    from pfd_tpu_torch.ops import graphs
    for wrapper in graphs.counters().values():
        wrapper.launches = 0


def check_pipe(shape, mufu_rate, gen):
    """K3 against its plain version and against K1, within
    ``kernel_tolerance`` of the plain output."""
    import torch
    import torch.nn.functional as F
    from pfd_tpu_torch.ops import flash_attention as fa

    b, h, s, d = shape
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").bfloat16() for _ in range(3))
    got = fa.flash_attention(q, k, v, pipelined=True)
    want = fa.attention_pipe_plain(q, k, v)
    k1 = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    tol = fa.kernel_tolerance(want)
    err = (got.float() - want.float()).abs().max().item()
    err_k1 = (got.float() - k1.float()).abs().max().item()
    if not (err <= tol and err_k1 <= tol):
        raise AssertionError(f"K3 {shape}: max_abs_err {err} (vs plain), {err_k1} (vs K1) "
                             f"> {tol}")
    big = b * h * s * s > 2 ** 28
    row = {"shape": [b, h, s, s, d], "max_abs_err": err, "max_abs_err_vs_k1": err_k1,
           "tol": tol, "err_over_tol": err / tol,
           "kernel_ms": cuda_ms(lambda: fa.flash_attention(q, k, v, pipelined=True), 20),
           "k1_ms": cuda_ms(lambda: fa.flash_attention(q, k, v), 20),
           "plain_ms": cuda_ms(lambda: fa.attention_pipe_plain(q, k, v), 2 if big else 5),
           "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), 20)}
    row["bound_ms"], row["bound_by"] = attention_bound_ms(b, h, s, s, d, mufu_rate)
    print(f"K3 {json.dumps(row)}  bound_us={row['bound_ms'] * 1e3:.1f}", flush=True)
    return row


def conv3x3_bound_ms(n, c, h, w, k, fused, residual=True):
    """Least time for the bf16 conv3x3: x, the weight (bf16), the output and,
    fused, the residual (bf16, where there is one) and the fp32 affine and
    bias, each read or written once, over the memory rate; 2*M*N*K FLOP
    over the bf16 rate."""
    nbytes = 2 * (n * c * h * w + 9 * k * c + n * k * h * w)
    if fused:
        nbytes += 2 * n * k * h * w * residual + 4 * (2 * n * c + k)
    t_bytes = nbytes / PEAK_BYTES
    t_ops = 2 * n * h * w * k * 9 * c / PEAK_BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check_conv3x3(xshape, fused, gen, cout=None):
    """The bf16 conv3x3 kernel against its plain version: fused (K6, the
    GroupNorm affine with a ResBlock shift folded in, bias, residual) or
    conv only (K7a's bf16 mode). Relative L2 at most 2e-3 and max-abs at
    most one bf16 ulp of the largest output (both round an fp32 sum to
    bf16). Yardsticks: cuDNN's bf16 conv for the conv-only mode (the same
    function), the eager GroupNorm -> SiLU -> conv -> add chain for the
    fused mode."""
    import torch
    import torch.nn.functional as F
    from pfd_tpu_torch.ops import fused_conv
    from pfd_tpu_torch.ops import nn as tnn

    n, c, h, w = xshape
    cout = cout or c
    cl = torch.channels_last
    x = torch.randn(xshape, generator=gen, device="cuda").bfloat16().contiguous(memory_format=cl)
    norm = torch.nn.GroupNorm(32, c, device="cuda").requires_grad_(False)
    conv = torch.nn.Conv2d(c, cout, 3, padding=1, device="cuda").requires_grad_(False)
    norm.weight.copy_(1 + 0.2 * torch.randn(c, generator=gen, device="cuda"))
    norm.bias.copy_(0.2 * torch.randn(c, generator=gen, device="cuda"))
    conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen, device="cuda")
                      / (9 * c) ** 0.5)
    conv.bias.copy_(0.1 * torch.randn(cout, generator=gen, device="cuda"))
    norm, conv = norm.bfloat16(), conv.bfloat16().to(memory_format=cl)
    if fused:
        shift = torch.randn((n, c), generator=gen, device="cuda").bfloat16()
        a, cc = tnn.group_norm_affine(x, norm.weight, norm.bias, eps=1e-5, shift=shift)
        args = (x, conv.weight, a, cc, conv.bias)
        kw = {"residual": x} if cout == c else {}
    else:
        args, kw = (x, conv.weight, None, None, None), {}
    got = fused_conv.conv3x3_fused(*args, **kw)
    want = fused_conv.conv3x3_fused_plain(*args, **kw)
    torch.cuda.synchronize()
    g, wf = got.float(), want.float()
    rel = ((g - wf).norm() / wf.norm()).item()
    err = (g - wf).abs().max().item()
    ulp = 2.0 ** (torch.floor(torch.log2(wf.abs().max())).item() - 7)
    label = f"{'fused' if fused else 'conv'} {list(xshape)}->{cout}"
    plan = fused_conv.conv3x3_plan(n, h, w, c, cout, torch.cuda.get_device_properties(0)
                                   .multi_processor_count)
    if not (rel <= 2e-3 and err <= ulp):
        raise AssertionError(f"conv3x3_bf16 {label}: rel_l2 {rel} (limit 2e-3), max_abs "
                             f"{err} (limit {ulp})")
    if fused:
        def yardstick():
            hh = tnn.group_norm(x + shift[:, :, None, None], norm, eps=1e-5)
            y = tnn.conv2d(tnn.silu(hh), conv, padding=1)
            return y + x if cout == c else y
        ykey = "eager_gn_silu_conv_add_ms"
    else:
        def yardstick():
            return F.conv2d(x, conv.weight, padding=1)
        ykey = "library_ms"
    row = {"shape": label, "plan": plan, "max_abs_err": err, "rel_l2": rel, "ulp_limit": ulp,
           "kernel_ms": cuda_ms(lambda: fused_conv.conv3x3_fused(*args, **kw), 20),
           "plain_ms": cuda_ms(lambda: fused_conv.conv3x3_fused_plain(*args, **kw), 5),
           ykey: cuda_ms(yardstick, 20)}
    row.setdefault("library_ms", None)
    row["bound_ms"], row["bound_by"] = conv3x3_bound_ms(n, c, h, w, cout, fused,
                                                        residual=cout == c)
    print(f"conv3x3_bf16 {json.dumps(row)}  bound_us={row['bound_ms'] * 1e3:.1f}",
          flush=True)
    return row


def check_matmul(m, k, n, gen):
    """K7b against its plain version and ``torch._int_mm``, bit for bit.
    Bound: x, w (int8) read and y (int32) written once over the memory
    rate; 2*M*N*K over the int8 rate."""
    import torch
    from pfd_tpu_torch.ops import int8_matmul

    x8 = torch.randint(-127, 128, (m, k), generator=gen, device="cuda", dtype=torch.int8)
    w8 = torch.randint(-127, 128, (n, k), generator=gen, device="cuda", dtype=torch.int8)
    got = int8_matmul.matmul_int8(x8, w8)
    want = int8_matmul.matmul_int8_plain(x8, w8)
    lib = torch._int_mm(x8, w8.t())
    torch.cuda.synchronize()
    if not (torch.equal(got, want) and torch.equal(got, lib)):
        raise AssertionError(f"matmul_int8 {m}x{k}x{n}: not bit-exact "
                             f"({(got != want).sum().item()} differ from plain, "
                             f"{(got != lib).sum().item()} from torch._int_mm)")
    t_bytes = (m * k + n * k + 4 * m * n) / PEAK_BYTES
    t_ops = 2 * m * n * k / PEAK_INT8_OPS
    plan = int8_matmul.matmul_int8_plan(m, n, torch.cuda.get_device_properties(0)
                                        .multi_processor_count)
    row = {"shape": f"{m}x{k}x{n}", "plan": plan, "max_abs_err": 0.0,
           "kernel_ms": cuda_ms(lambda: int8_matmul.matmul_int8(x8, w8), 20),
           "plain_ms": cuda_ms(lambda: int8_matmul.matmul_int8_plain(x8, w8), 3),
           "library_ms": cuda_ms(lambda: torch._int_mm(x8, w8.t()), 20),
           "bound_ms": max(t_bytes, t_ops) * 1e3,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    print(f"matmul_int8 {json.dumps(row)}  bound_us={row['bound_ms'] * 1e3:.1f}", flush=True)
    return row


def run_labs():
    """The kernel labs through their entry points (``main``), a few
    iterations each, with every launch count set to 0 just before; returns
    the counts just after."""
    import torch
    from pfd_tpu_torch.tools import attn_lab, int8_lab, perf_audit

    env = {"AUDIT_SECTIONS": "fused", "AUDIT_ITERS": "3", "LAB_ITERS": "3",
           "LAB_SECTIONS": "pallas_mm,convs"}
    saved = {key: os.environ.get(key) for key in env}
    os.environ.update(env)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    try:
        perf_audit.main()
        attn_lab.main()
        int8_lab.main()
        torch.cuda.synchronize()
    finally:
        for key, val in saved.items():
            if val is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = val
    counts = launch_counts(labs=True)
    print(f"labs: {time.perf_counter() - t0:.1f} s, launches {json.dumps(counts)}", flush=True)
    missing = [name for name, n in counts.items() if n <= 0]
    if missing:
        raise AssertionError(f"labs: {missing} never launched")
    return counts


class LaunchPlan:
    """The kernel launches a 512^2 request must make, derived from the model's
    plans (``unet.decoder_split`` for the DeepCache cut): each transformer
    block at S >= 1024 (ds1 and ds2) launches K2 for its cross-attention and
    K1 for its self-attention (K4 in the int8 attention mode; K2 over the
    pooled keys on a KV-pooled reuse step at ds1, the pool's grid); each int8
    conv one ``conv_int8``; the VAE decode one K1 and its int8 convs, the
    hint pyramid its own once per request. A step runs one of the calls
    ``full`` (the UNet, and the ControlNet with a hint), ``dec`` (the decoder
    on the cached encoder state), ``enc_sh`` + ``dec_sh`` (DeepCache's fresh
    shallow skips and its shallow suffix) or ``dec_sh``."""

    def __init__(self, net, size=512):
        import collections as co
        from pfd_tpu_torch.ops import quant as tq

        unet, self.lat = net.diffuser["image"], size // 8
        plan = unet.plan
        _, o_shallow, n_sh = unet.decoder_split()

        def convs(mod):
            return sum(tq.is_quantized(m) for m in mod.modules())

        def walk(ops, res):
            n = co.Counter()
            for op in ops:
                if op[0] == "d":
                    kind = plan.data_specs[op[1]].kind
                    n["conv"] += convs(unet.data_blocks[op[1]])
                    res = res // 2 if kind == "down" else res * 2 if kind == "up" else res
                elif op[0] == "c":
                    n["ctx_conv"] += convs(unet.context_blocks[op[1]])
                    if res * res >= 1024:
                        n["ds1" if res == self.lat else "ds2"] += 1
            return n

        saves = [i for i, op in enumerate(plan.i_ops) if op[0] == "save"]
        low = self.lat >> sum(plan.data_specs[op[1]].kind == "down"
                              for op in plan.i_ops if op[0] == "d")
        self.calls = {"full": walk(plan.ops, self.lat), "dec": walk(plan.o_ops, low),
                      "enc_sh": walk(plan.i_ops[:saves[n_sh - 1] + 1], self.lat),
                      "dec_sh": walk(o_shallow, self.lat // 2)}
        ctl = getattr(net, "ctl", None)
        self.ctl, self.hint_convs = co.Counter(), 0
        if ctl is not None:
            res = self.lat
            for kind, _, _, with_attn in ctl.plan:
                res = res // 2 if kind == "down" else res
                if with_attn and res * res >= 1024:
                    self.ctl["ds1" if res == self.lat else "ds2"] += 1
            self.hint_convs = convs(ctl.input_hint_block)
            self.ctl["conv"] = convs(ctl) - self.hint_convs
        self.vae_convs = convs(net.vae["image"].decoder)

    @staticmethod
    def schedule(steps, encoder_interval=1, cfg_interval=1, deep_interval=1, phases=None):
        """[(call, reuse step?)] of each step, as the sampler runs them (CFG)."""
        def groups(n, k, reuse_call):
            out = []
            for g in range(0, n, k):
                out += [("full", False)] + [(reuse_call, True)] * (min(k, n - g) - 1)
            return out

        if phases:
            out = []
            for n, k in phases:
                out += [("full", False)] * n if k == 1 else groups(n, k, "dec_sh")
            return out
        if cfg_interval > 1:
            reuse = (("dec_sh" if encoder_interval > 1 else "enc_sh+dec_sh")
                     if deep_interval > 1 else "dec" if encoder_interval > 1 else "full")
            return groups(steps, cfg_interval, reuse)
        if encoder_interval > 1:
            return [("full" if i % encoder_interval == 0 else "dec", False) for i in range(steps)]
        return [("full", False)] * steps

    def expected(self, steps=50, control=False, quantized=False, attn8=False, kv=False,
                 contexts=1, **turbo):
        """{counter: launches} of one request (``launch_counts()``'s keys);
        ``attn8``: the int8 self-attention, K4 (True) or K5 ("full");
        ``contexts``: the times each context block runs a call (multicontext
        ``"attention"`` mixing runs it once per context, ``"layer"`` once)."""
        self_attn = {False: "flash_attention", True: "flash_attention_pv8",
                     "full": "flash_attention_int8"}[attn8]
        n = dict.fromkeys(("flash_attention", "cross_attention", "flash_attention_pv8",
                           "flash_attention_int8", "conv_int8"), 0)
        for call, reuse in self.schedule(steps, **turbo):
            parts = [self.calls[c] for c in call.split("+")]
            if call == "full" and control:
                parts.append(self.ctl)
            for p in parts:
                n["cross_attention"] += (p["ds1"] + p["ds2"]) * contexts
                n["cross_attention" if kv and reuse else self_attn] += p["ds1"] * contexts
                n[self_attn] += p["ds2"] * contexts
                n["conv_int8"] += p["conv"] + p["ctx_conv"] * contexts if quantized else 0
        n["flash_attention"] += 1  # the VAE's mid-block attention
        if quantized:
            n["conv_int8"] += self.vae_convs + (self.hint_convs if control else 0)
        return n


def eager_request(pipe, ref, seed, steps, imctl=None, ugscale=2.0, method="canny"):
    """``action_inference``'s 512^2 request with each graph's body (SeeCoder's,
    the bucket's ``sample_decode``) run eagerly in its place
    (``Graphed.eager``): the yardstick a graphed request is held to. Returns
    the images, then the hints."""
    from unittest import mock
    from pfd_tpu_torch.ops import graphs

    with mock.patch.object(graphs.Graphed, "__call__", graphs.Graphed.eager):
        return pipe.action_inference(ref, imctl, method, True, 512, 512, ugscale, seed,
                                     steps=steps)


def serve(pipe, ref, seed, steps, label, imctl=None):
    """One request through the eager bodies (``eager_request``; a canny hint
    ``imctl`` runs the ControlNet) with the launch counts set to 0 just
    before it; per-stage device times from CUDA events. Returns (outputs:
    the images, then the hints; stats)."""
    import torch

    timings = {"ctx_encode": [], "apply_model": [], "vae_decode": []}
    net = pipe.net

    def timed(name, fn):
        def run(*args, **kwargs):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            out = fn(*args, **kwargs)
            e.record()
            timings[name].append((s, e))
            return out
        return run

    for name in timings:
        setattr(net, name, timed(name, getattr(net, name)))
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    try:
        out = eager_request(pipe, ref, seed, steps, imctl)
        torch.cuda.synchronize()
    finally:
        for name in timings:
            delattr(net, name)
    s_per_img = time.perf_counter() - t0
    launches = launch_counts()
    ms = {k: [s.elapsed_time(e) for s, e in v] for k, v in timings.items()}
    stats = {"seecoder_ms": ms["ctx_encode"][0],
             "step_ms_median": (statistics.median(ms["apply_model"]) if ms["apply_model"]
                                else float("nan")),  # a turbo request runs the split forwards
             "steps": len(ms["apply_model"]), "vae_decode_ms": ms["vae_decode"][0],
             "s_per_img": s_per_img,
             "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
             "launches": launches}
    print(f"request {label}: seecoder_ms={stats['seecoder_ms']:.3f} "
          f"step_ms_median={stats['step_ms_median']:.3f} (n={stats['steps']}) "
          f"vae_decode_ms={stats['vae_decode_ms']:.3f} s_per_img={s_per_img:.4f} "
          f"peak_mem_gb={stats['peak_mem_gb']:.3f} launches={json.dumps(launches)}",
          flush=True)
    return out, stats


def serve_graphed(pipe, ref, seed, steps, label, imctl=None, ugscale=2.0, method="canny"):
    """One request through ``action_inference`` (SeeCoder's graph and the
    bucket's graph replayed) with the launch counts set to 0 just before
    it; host wall time and CUDA-event time around the call. Returns
    (outputs, stats)."""
    import torch

    torch.cuda.synchronize()
    reset_counts()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    s.record()
    out = pipe.action_inference(ref, imctl, method, True, 512, 512, ugscale, seed, steps=steps)
    e.record()
    torch.cuda.synchronize()
    stats = {"s": time.perf_counter() - t0, "event_s": s.elapsed_time(e) / 1e3,
             "launches": launch_counts()}
    print(f"graphed request {label}: s={stats['s']:.4f} event_s={stats['event_s']:.4f} "
          f"launches={json.dumps(stats['launches'])}", flush=True)
    return out, stats


def check_image(img, label):
    import numpy as np
    if img.shape != (512, 512, 3) or not np.isfinite(img).all():
        raise AssertionError(f"request {label}: bad image {img.shape}")
    if not (img.min() >= 0.0 and img.max() <= 1.0):
        raise AssertionError(f"request {label}: image outside [0, 1]")


@contextlib.contextmanager
def plain_versions(attention=True, pv8_block_k=None):
    """Route the int8 path's kernel wrappers to their plain versions (the
    on-card oracle of a whole UNet call): the int8 conv, and with
    ``attention`` K4 (on key tiles of ``pv8_block_k``, K4's by default)
    and K2 as well."""
    from pfd_tpu_torch.ops import flash_attention as fa
    from pfd_tpu_torch.ops import int8_conv

    saved = (fa.flash_attention_pv8, fa.cross_attention, int8_conv.conv_int8)
    if attention:
        fa.flash_attention_pv8 = lambda q, k, v8, *, qscale: fa.pv8_plain(
            q, k, v8, qscale=qscale, block_k=pv8_block_k)
        fa.cross_attention = lambda q, k, v, *, scale=None: fa.attention_plain(q, k, v,
                                                                              scale=scale)
    int8_conv.conv_int8 = int8_conv.conv_int8_plain
    try:
        yield
    finally:
        fa.flash_attention_pv8, fa.cross_attention, int8_conv.conv_int8 = saved


def compare_eps(label, e_k, e_p):
    """A UNet eps (or a ControlNet residual) through the kernels against the
    same call through plain versions: relative L2 at most 5e-2."""
    rel = ((e_k - e_p).norm() / e_p.norm()).item()
    print(f"{label}: rel_l2={rel:.3e} max_abs={(e_k - e_p).abs().max().item():.3e} "
          f"|eps|_rms={e_p.pow(2).mean().sqrt().item():.3e}", flush=True)
    if not rel < 5e-2:
        raise AssertionError(f"{label}: rel_l2 {rel}")
    return rel


def hint_image():
    """A seeded 512^2 hint image with structure: a white rectangle and a
    grey bar on black, with faint noise."""
    import numpy as np
    rng = np.random.default_rng(11)
    img = 0.02 * rng.random((512, 512, 3), dtype=np.float32)
    y0, x0 = rng.integers(96, 160, size=2)
    img[y0:y0 + 256, x0:x0 + 224] = 1.0
    img[y0 + 100:y0 + 140, 40:480] = 0.5
    return img


def profile_unet(label, call):
    """Where one UNet call's device time goes (torch.profiler, CUPTI):
    (wall ms, device busy ms, ``kernel_counts``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad():
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side rows only (kernels, copies): a CPU op's row repeats the
    # device time of the kernels it launched
    events = [e for e in prof.key_averages()
              if str(getattr(e, "device_type", "")).endswith("CUDA")
              and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    print(f"{label}: wall {wall_ms:.3f} ms (profiled), device busy {busy_ms:.3f} ms, "
          f"idle share {max(0.0, 1 - busy_ms / wall_ms):.3f}", flush=True)
    for e in sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:12]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:90]}",
              flush=True)
    return wall_ms, busy_ms, kernel_counts(events)


def tf32_control(sd, ref):
    """The plain ``fp32`` row with ``ops.nn``'s convs as cuDNN runs fp32 by
    default, in TF32: the fault the FP32 repair removed, which the fp32 rows'
    latent limit must tell apart from a sound run. Returns its row."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from pfd_tpu_torch.ops import nn
    from pfd_tpu_torch.policy import FP32
    from pfd_tpu_torch.tools import e2e_gate

    model = e2e_gate.assemble(e2e_gate.gate_config(e2e_gate.PLAIN),
                              e2e_gate.to_device(sd, "cuda", drop_control=True), FP32)
    guarded = nn.conv2d_raw
    nn.conv2d_raw = lambda x, w, b=None, **kw: F.conv2d(x, w, b, **kw)
    try:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=True):
            img, lat = e2e_gate.run(model, e2e_gate.inputs("plain"))
    finally:
        nn.conv2d_raw = guarded
    lat_ref = ref["latent_plain"]
    row = {"variant": "fp32_tf32", "what": "fp32 with cuDNN's TF32 convs vs pfd_tpu's fp32",
           "ssim_vs_pfd_tpu_fp32": e2e_gate.score(img[0], ref["img_plain"][0]),
           "latent_rel_l2_vs_pfd_tpu": float(np.linalg.norm(lat - lat_ref) / np.linalg.norm(lat_ref)),
           "finite": bool(np.isfinite(img).all() and np.isfinite(lat).all())}
    print(json.dumps(row), flush=True)
    return row


# the turbo, KV-pool and ToMe rows phase 11 runs: direct (SSIM >= 0.95
# against pfd_tpu's exact fp32 image) and quant (min over 8 samples >= 0.95)
DIRECT_TURBO = {"plain": ("int8_turbo2", "int8_cfg2_deep2", "int8_turbo3_cfg3lin_deep3",
                          "int8_ph8x2_42x21", "int8_ph8x2_42x21_kv2", "int8_tome5_turbo2",
                          "bf16_ph10x2_40x10"),
                "control": ("ctl_int8_turbo2_cfg2_deep2", "ctl_int8_ph10x2_40x20",
                            "ctl_int8_ph10x2_40x20_kv2")}
QUANT_TURBO = {"plain": ("int8_ph8x2_42x21", "int8_ph8x2_42x21_kv2"),
               "control": ("ctl_int8_ph10x2_40x20",)}


def gate_route(lp, name):
    """The launches of a gate row's route: none under fp32 (plain attention);
    the VAE's K1 alone without the UNet's kernels (``bf16_plain_attn``); else
    the ``LaunchPlan``'s count for the row's recipe (``e2e_gate.row_recipe``)."""
    from pfd_tpu_torch.tools import e2e_gate

    if name.removeprefix("ctl_").startswith("fp32"):
        return lp.expected(steps=0) | {"flash_attention": 0}
    if name == "bf16_plain_attn":
        return lp.expected(steps=0)
    prec, _, turbo = e2e_gate.row_recipe(name.replace("_attn8", ""))
    kv = turbo.pop("reuse_self_attn_fn", None) is not None
    turbo.pop("cfg_extrapolate", None)
    return lp.expected(control=name.startswith("ctl_"), quantized=prec == "int8",
                       attn8=name.endswith("_attn8"), kv=kv, **turbo)


def quality_gates(lp):
    """The quality gates at full width (phase 11) through the tools' own
    ``evaluate``; raises unless every row passes its limit and launched the
    kernels of its route (``lp``: the ``LaunchPlan`` of the int8 model)."""
    import torch
    from pfd_tpu_torch.tools import e2e_gate, quant_gate

    t0 = time.perf_counter()
    ref = e2e_gate.load_reference()
    recipe = dict(ref["recipe"], configs=sorted(ref["recipe"]["configs"]))
    print(f"gates: reference recipe {json.dumps(recipe)}; turbo reference sampler "
          f"{json.dumps(ref['turbo']['recipe']['sampler'])}", flush=True)
    print(f"gates: TF32 flags {json.dumps(e2e_gate.tf32_flags())} (ops.nn's fp32 convs "
          f"turn cuDNN's off per call)", flush=True)
    sd = e2e_gate.reference_weights()
    print(f"gates: weights {sum(v.size for v in sd.values()) / 1e9:.3f} G floats, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    direct = {}
    for gate_set, base in (("plain", e2e_gate.BASE_ROWS), ("control", e2e_gate.CTL_BASE_ROWS)):
        names = base + DIRECT_TURBO[gate_set] + (e2e_gate.FP32_TURBO[gate_set],)
        direct.update(e2e_gate.evaluate(gate_set, names, sd=sd, ref=ref)["rows"])
        torch.cuda.empty_cache()
    tf32 = tf32_control(sd, ref)
    torch.cuda.empty_cache()
    del sd
    t1 = time.perf_counter()
    quant = {**quant_gate.evaluate("plain", ["int8", *QUANT_TURBO["plain"]], 8),
             **quant_gate.evaluate("control", ["ctl_int8", *QUANT_TURBO["control"]], 8)}
    torch.cuda.empty_cache()
    print(f"gates: {t1 - t0:.1f} s direct, {time.perf_counter() - t1:.1f} s quant", flush=True)

    def route(name):
        return gate_route(lp, name)

    # limits: SSIM 0.999 for the fp32 controls (the turbo ones against
    # pfd_tpu's fp32 run of the same schedule) and BASELINE's 0.95; the
    # latent relative L2 of the exact rows between the sound readings (fp32
    # ~5e-7, bf16/int8 4e-4 to 1.5e-3) and the faults to catch (TF32:
    # fp32_tf32; chance 1.4). A turbo row's latent is read, not limited: it
    # lies ~3e-3 from the exact one by design.
    fp32_latent, latent = 1e-5, 1e-2
    fp32_rows = ("fp32", "ctl_fp32") + tuple(e2e_gate.FP32_TURBO.values())
    exact_rows = e2e_gate.BASE_ROWS + e2e_gate.CTL_BASE_ROWS
    bad = []
    if not tf32["latent_rel_l2_vs_pfd_tpu"] > fp32_latent:
        bad.append(f"fp32_tf32: latent rel_l2 {tf32['latent_rel_l2_vs_pfd_tpu']} within the "
                   f"fp32 limit {fp32_latent}: the fp32 rows would not catch TF32")
    for name, row in direct.items():
        s, rel = row["ssim_vs_pfd_tpu_fp32"], row["latent_rel_l2_vs_pfd_tpu"]
        if not row["finite"]:
            bad.append(f"{name}: not finite")
        if name in fp32_rows and not (s >= 0.999 and rel <= fp32_latent):
            bad.append(f"{name}: ssim {s} (limit 0.999), latent rel_l2 {rel} "
                       f"(limit {fp32_latent})")
        if name != "fp32_eps" and not s >= 0.95:
            bad.append(f"{name}: ssim {s} (limit 0.95)")
        if name in exact_rows and "fp32" not in name and not rel <= latent:
            bad.append(f"{name}: latent rel_l2 {rel} (limit {latent})")
        if row["launches"] != route(name):
            bad.append(f"{name}: launches {row['launches']}, want {route(name)}")
    for name, row in quant.items():
        low = row[f"fullsize_ddim50_ssim_{name}_vs_bf16"]
        if not (row["finite"] and low >= 0.95):
            bad.append(f"quant {name}: min ssim {low} (limit 0.95), finite {row['finite']}")
        if row["launches"] != route(name):
            bad.append(f"quant {name}: launches {row['launches']}, want {route(name)}")
    if bad:
        raise AssertionError("quality gates: " + "; ".join(bad))
    print(f"gates: all {len(direct)} direct and {len(quant)} quant rows pass", flush=True)
    return direct, quant


def _synced(fn, *args, **kwargs):
    """(fn's result, seconds) with the device synchronised on both sides."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


@contextlib.contextmanager
def knobs(pipe, **kw):
    """The pipeline's attributes ``kw`` set for the block, restored after."""
    saved = {k: getattr(pipe, k) for k in kw}
    for k, v in kw.items():
        setattr(pipe, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(pipe, k, v)


def other_weights(module, seed):
    """A float state dict for ``module`` as a checkpoint swap loads it: each
    float tensor of its own times (1 + 0.05 N(0, 1)), a quantized layer's
    weight dequantized from its codes first (``quant.quantize_state_dict``
    quantizes it again)."""
    import torch
    from pfd_tpu_torch.ops import quant as tq

    g = torch.Generator(device="cuda").manual_seed(seed)

    def jitter(v):
        return (v.float() * (1 + 0.05 * torch.randn(v.shape, generator=g, device=v.device))
                ).to(v.dtype)

    quantized = {n for n, m in module.named_modules() if tq.is_quantized(m)}
    sd = {}
    for k, v in module.state_dict().items():
        base, _, leaf = k.rpartition(".")
        if base in quantized and leaf in ("weight_q", "weight_scale"):
            if leaf == "weight_q":
                m = module.get_submodule(base)
                sd[f"{base}.weight"] = jitter(m.weight_q.float()
                                              * m.weight_scale[:, None, None, None])
        else:
            sd[k] = jitter(v) if v.is_floating_point() else v
    return sd


def compiled_hot_path(card, pipe, pipe8, ref, hint_src, lp, lp8, eager, full8):
    """Phase 8c: the compiled hot path at full width. Each bucket is one
    captured CUDA graph (``ops/graphs.py``): its cost (the warm-up run, the
    capture, the instantiation, its nodes, the pool's growth); each graphed
    request against its eager twin ``eager[label]`` (its images) bit for bit
    and at ``LaunchPlan``'s launches; the kernels the card ran in graphed A,
    F, G and H, counted by the profiler, equal to the launches a replay adds;
    a second guidance scale through one graph; a bf16 and an int8 diffuser
    swap, then a replay of the old graph; s/img graphed against eager over 3
    turns each; b8 int8 and bf16 ``ph8x2_42x21``; a SeeCoder-PA swap, which
    captures SeeCoder anew. ``full8`` is E's self-attention (K5). Returns
    {request: launches}."""
    import numpy as np
    import torch

    ph_h, ph_j = [(8, 2), (42, 21)], [(10, 2), (40, 20)]
    served, cost, times = {}, {}, {}

    def same(a, b):
        return len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))

    def capture(p, label, with_control, steps=50):
        n0 = len(p.context_graph().stats)
        _, dt = _synced(p.warmup, batch=p.n_sample_image, with_control=with_control,
                        steps=steps)
        st = p._graphs[(512, 512, p.n_sample_image, with_control, steps, 0.0)].stats[0]
        cost[label] = {"warmup_call_s": dt, **st,
                       **({"seecoder": p.context_graph().stats[0]} if n0 == 0 else {})}
        print(f"graph bucket {label}: {json.dumps(cost[label])} ({card})", flush=True)

    def replay(p, label, want_launches, steps=50, imctl=None, ugscale=2.0, want=None):
        out, st = serve_graphed(p, ref, 42, steps, label, imctl, ugscale)
        n = p.n_sample_image
        want = eager[label] if want is None else want
        for img in out[:n]:
            check_image(img, f"graphed {label}")
        if not same(out[:n], want):
            raise AssertionError(f"graphed {label}: not its eager twin bit for bit (max abs "
                                 f"{max(np.abs(a - b).max() for a, b in zip(out, want)):.3e})")
        if st["launches"] != want_launches:
            raise AssertionError(f"graphed {label}: launches {st['launches']}, want "
                                 f"{want_launches}")
        served[f"graphed {label}"] = st["launches"]
        return out

    def profiled(p, label, steps=50, imctl=None):
        """One graphed request profiled: the port's kernels the card ran,
        by name, must be the launches a replay adds to the counters."""
        _, _, ran = profile_unet(f"graphed request {label} profile", lambda: p.action_inference(
            ref, imctl, "canny", True, 512, 512, 2.0, 42, steps=steps))
        want = {k: v for k, v in served[f"graphed {label}"].items() if v}
        if ran != want:
            raise AssertionError(f"graphed {label}: the profiler saw the kernels {ran} run, "
                                 f"the counters say {want}")
        print(f"graphed request {label}: the profiler's kernel counts are the replay's "
              f"launches {json.dumps(ran)}", flush=True)

    def timing(p, label, steps=50, imctl=None, turns=3):
        """s/img eager against graphed, in turns (eager, graphed) x ``turns``."""
        rows = {"eager": [], "graphed": [], "graphed_event": []}
        for _ in range(turns):
            _, dt = _synced(eager_request, p, ref, 42, steps, imctl)
            rows["eager"].append(dt / p.n_sample_image)
            _, st = serve_graphed(p, ref, 42, steps, f"{label} (timing)", imctl)
            rows["graphed"].append(st["s"] / p.n_sample_image)
            rows["graphed_event"].append(st["event_s"] / p.n_sample_image)
        times[label] = rows
        e, g = rows["eager"], rows["graphed"]
        print(f"graphs timing {label}: s/img eager {json.dumps(e)} (spread "
              f"{max(e) / min(e):.3f}), graphed {json.dumps(g)} (spread {max(g) / min(g):.3f}), "
              f"graphed by events {json.dumps(rows['graphed_event'])}; eager / graphed median "
              f"{statistics.median(e) / statistics.median(g):.3f} ({card})", flush=True)

    def swap_and_replay(p, label, want_launches, seed):
        """A diffuser swap in place, then the old graph: its eager twin after
        the swap bit for bit, not the image before; the weights then put back
        bit for bit, and the graph gives the image before again."""
        diffuser = p.net.diffuser
        saved = {k: v.clone() for k, v in diffuser.state_dict().items()}
        _, dt = _synced(p._load, diffuser, other_weights(diffuser, seed))
        want = eager_request(p, ref, 42, 50)[:p.n_sample_image]
        if same(want, eager[label]):
            raise AssertionError(f"swap {label}: the swapped weights did not change the image")
        replay(p, f"{label} after a swap", want_launches, want=want)
        diffuser.load_state_dict(saved, strict=True)
        replay(p, f"{label} swapped back", want_launches, want=eager[label])
        print(f"graphs swap {label}: the diffuser swap ({dt:.2f} s) kept the graph valid: its "
              f"replay is the eager request after the swap bit for bit, mean |after - before| "
              f"{np.abs(want[0] - eager[label][0]).mean():.5f}; swapped back = before",
              flush=True)

    # bf16, no turbo: A and F, a second scale, a swap
    capture(pipe, "A", False)
    capture(pipe, "F", True)
    replay(pipe, "A", lp.expected())
    replay(pipe, "F", lp.expected(control=True), imctl=hint_src)
    profiled(pipe, "F", imctl=hint_src)
    want3 = eager_request(pipe, ref, 42, 50, ugscale=3.0)[:1]
    img3 = replay(pipe, "A at guidance 3.0", lp.expected(), ugscale=3.0, want=want3)[:1]
    if same(img3, eager["A"]) or len(pipe._graphs) != 2:
        raise AssertionError("graphs: guidance 3.0 must change A's image through A's bucket")
    print("graphs: guidance 2.0 and 3.0 through one bucket, each its eager twin bit for bit",
          flush=True)
    swap_and_replay(pipe, "A", lp.expected(), 501)
    timing(pipe, "A")
    timing(pipe, "F", imctl=hint_src)
    profiled(pipe, "A")
    # bf16 turbo: H, H_kv, b8 H, H_tome; J0 (the exact-control guard), then J
    with knobs(pipe, phases=ph_h):
        capture(pipe, "H", False)
        replay(pipe, "H", lp.expected(phases=ph_h))
        timing(pipe, "H")
        profiled(pipe, "H")
        with knobs(pipe, kv_pool=2):
            capture(pipe, "H_kv", False)
            replay(pipe, "H_kv", lp.expected(kv=True, phases=ph_h))
        with knobs(pipe, n_sample_image=8):
            capture(pipe, "bf16 b8 ph8x2_42x21", False)
            replay(pipe, "bf16 b8 ph8x2_42x21", lp.expected(phases=ph_h))
    with knobs(pipe, tome_ratio=0.5):
        capture(pipe, "H_tome", False)
        replay(pipe, "H_tome", lp.expected())
    with knobs(pipe, phases=ph_j, control_turbo=False):
        capture(pipe, "J0", True)
        replay(pipe, "J0", lp.expected(control=True), imctl=hint_src)
    with knobs(pipe, phases=ph_j, control_turbo=True):
        capture(pipe, "J", True)
        replay(pipe, "J", lp.expected(control=True, phases=ph_j), imctl=hint_src)
        # SeeCoder-PA rebuilds the context encoder: its graph goes, the
        # bucket's stays; last, since the rebuilt encoder has new weights
        ctx_graph = pipe.context_graph()
        pipe.action_load_ctx("SeeCoder-PA")
        if pipe.context_graph() is ctx_graph:
            raise AssertionError("graphs: the SeeCoder-PA swap kept the old SeeCoder graph")
        want = eager_request(pipe, ref, 42, 50, hint_src)[:1]
        replay(pipe, "J with SeeCoder-PA", lp.expected(control=True, phases=ph_j),
               imctl=hint_src, want=want)
        print(f"graphs: SeeCoder-PA swap captured SeeCoder anew "
              f"{json.dumps(pipe.context_graph().stats)}; J's bucket replayed to its eager twin",
              flush=True)
    # int8: D, a swap, E (K5), G with the hint, I, then b8 x 50 ph8x2_42x21
    capture(pipe8, "D", False)
    replay(pipe8, "D", lp8.expected(quantized=True, attn8=True))
    swap_and_replay(pipe8, "D", lp8.expected(quantized=True, attn8=True), 502)
    timing(pipe8, "D")
    with knobs(pipe8, self_attn_fn=full8):
        capture(pipe8, "E", False, steps=10)
        replay(pipe8, "E", lp8.expected(steps=10, quantized=True, attn8="full"), steps=10)
        profiled(pipe8, "E", steps=10)
    capture(pipe8, "G", True, steps=10)
    replay(pipe8, "G", lp8.expected(steps=10, control=True, quantized=True, attn8=True),
           steps=10, imctl=hint_src)
    profiled(pipe8, "G", steps=10, imctl=hint_src)
    with knobs(pipe8, phases=ph_h):
        capture(pipe8, "I", False)
        replay(pipe8, "I", lp8.expected(quantized=True, attn8=True, phases=ph_h))
        timing(pipe8, "I")
        with knobs(pipe8, n_sample_image=8):
            capture(pipe8, "int8 b8 ph8x2_42x21", False)
            replay(pipe8, "int8 b8 ph8x2_42x21",
                   lp8.expected(quantized=True, attn8=True, phases=ph_h))
            timing(pipe8, "int8 b8 ph8x2_42x21")
    print(f"graphs summary: {json.dumps({'cost': cost, 'times': times})}", flush=True)
    return served


def write_zoo(root):
    """Checkpoint files at the zoo paths of ``SD-v1.5`` (``diffuser.image.*``),
    ``Deliberate-v2.0`` (its context blocks spelled
    ``diffuser.text.context_blocks.*``, which the loader renames), the
    ``SeeCoder`` (``ctx.image.*``, with the Swin's ``relative_position_index``
    buffers a published checkpoint carries) and the ``canny`` ControlNet (bare
    keys), in fp16 ``.safetensors``; the VAE (fp32 ``.pth``, bare keys) and
    ``assets/anime_ug.pth`` (77 x 768). Each part is the port's random weights
    at full published width from its own seed, de-zeroed. Returns
    {name: (path, {key of the part's module: the tensor written})}."""
    import torch
    from pfd_tpu_torch import config, zoo
    from pfd_tpu_torch.io.loader import save_safetensors
    from pfd_tpu_torch.models.build import build_model, dezero_
    from pfd_tpu_torch.policy import FP32

    args = config.model_cfg("pfd_seecoder_with_controlnet")["args"]
    cfgs = {"diffuser": dict(args["diffuser_cfg_list"])["image"],
            "ctx": dict(args["ctx_cfg_list"])["image"],
            "vae": dict(args["vae_cfg_list"])["image"], "ctl": args["ctl_cfg"]}
    files = {}

    def part(kind, seed):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        m = build_model(cfgs[kind], policy=FP32, device="cuda", generator=gen)
        return dezero_(m, torch.Generator(device="cuda").manual_seed(seed + 1))

    def put(name, rel, sd, file_sd, fmt="safetensors"):
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        t0 = time.perf_counter()
        if fmt == "safetensors":
            n = save_safetensors(path, file_sd)
        else:
            torch.save(file_sd, path)
            n = os.path.getsize(path)
        dt = time.perf_counter() - t0
        print(f"zoo write {name}: {rel}, {n / 1e9:.3f} GB in {dt:.2f} s "
              f"({n / 1e9 / dt:.2f} GB/s)", flush=True)
        files[name] = (path, sd)

    for tag, seed, text in (("SD-v1.5", 101, False), ("Deliberate-v2.0", 103, True)):
        sd = {f"image.{k}": v.half().cpu() for k, v in part("diffuser", seed).state_dict().items()}
        keys = {k: "diffuser." + (k.replace("image.context_blocks.", "text.context_blocks.", 1)
                                  if text else k) for k in sd}
        if text and not any(v.startswith("diffuser.text.") for v in keys.values()):
            raise AssertionError("zoo: the diffuser has no context blocks to spell as text")
        put(tag, zoo.DIFFUSER_PATH[tag], sd, {keys[k]: v for k, v in sd.items()})
    m = part("ctx", 105)
    sd = {f"image.{k}": v.half().cpu() for k, v in m.state_dict().items()}
    bufs = {f"ctx.image.{k}": v.cpu() for k, v in m.named_buffers()
            if k.endswith("relative_position_index")}
    if not bufs:
        raise AssertionError("zoo: the SeeCoder has no Swin buffers to write")
    put("SeeCoder", zoo.CTXENCODER_PATH["SeeCoder"], sd,
        {**{f"ctx.{k}": v for k, v in sd.items()}, **bufs})
    sd = {k: v.half().cpu() for k, v in part("ctl", 107).state_dict().items()}
    put("canny", zoo.CONTROLNET_PATH["canny"][1], sd, sd)
    sd = {k: v.float().cpu() for k, v in part("vae", 109).state_dict().items()}
    put("vae", zoo.VAE_PATH, sd, sd, fmt="pth")
    ug = torch.randn((77, 768), generator=torch.Generator().manual_seed(111))
    put("anime_ug", zoo.ANIME_UG_PATH, ug, ug, fmt="pth")
    del m
    torch.cuda.empty_cache()
    return files


def check_part(label, module, want):
    """Every tensor of ``module`` equals the file's tensor cast to its dtype,
    bit for bit; a quantized layer's codes and scales equal a fresh quantize
    of the file's weight (cast to the layer's float dtype), and an upsample
    conv's phase kernel a fresh one of those codes."""
    import torch
    from pfd_tpu_torch.ops import quant as tq

    own, n_q = module.state_dict(), 0
    for name, m in module.named_modules():
        if not tq.is_quantized(m):
            continue
        n_q += 1
        w = want[f"{name}.weight"].to(m.weight_q.device, tq.float_dtype(m))
        q, sc = tq.quantize_weight(w)
        if not (torch.equal(m.weight_q, q) and torch.equal(m.weight_scale, sc)):
            raise AssertionError(f"{label}: {name}'s int8 codes are not the file's weight's")
        if "phase_q" in m._buffers:
            deq = m.weight_q.float() * m.weight_scale[:, None, None, None]
            pq, ps = tq.quantize_weight(tq.phase_kernel(deq))
            if not (torch.equal(m.phase_q, pq) and torch.equal(m.phase_scale, ps)):
                raise AssertionError(f"{label}: {name}'s phase kernel does not follow its codes")
        own = {k: v for k, v in own.items() if not k.startswith(f"{name}.weight")}
    floats = {k: v for k, v in want.items() if k in own}
    if set(floats) != set(own):
        raise AssertionError(f"{label}: the module's keys are not the file's")
    bad = [k for k, v in own.items() if not torch.equal(v, floats[k].to(v.device, v.dtype))]
    if bad:
        raise AssertionError(f"{label}: {len(bad)} tensors differ from the file's, e.g. {bad[:3]}")
    print(f"{label}: {len(own)} tensors equal the file's bit for bit"
          + (f", {n_q} int8 layers' codes a fresh quantize of its weights" if n_q else ""),
          flush=True)


def serving_entry_points(card, ref, hint_src):
    """Phase 12: the checkpoint loader, the hot-swaps and the serving entry
    points at full width, on a zoo written to a temporary
    ``pretrained_root``. Returns {request: launches}."""
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="pfd_zoo_")
    free = shutil.disk_usage(root).free
    print(f"zoo: pretrained_root {root}, {free / 1e9:.1f} GB free", flush=True)
    try:
        return _serving_entry_points(card, ref, hint_src, root)
    finally:
        shutil.rmtree(root)


def _serving_entry_points(card, ref, hint_src, root):
    import threading
    import urllib.error
    import urllib.request
    from http.server import ThreadingHTTPServer

    import numpy as np
    import torch
    from pfd_tpu_torch import annotators
    from pfd_tpu_torch import serve as tserve
    from pfd_tpu_torch.io import loader
    from pfd_tpu_torch.ops import flash_attention as fa
    from pfd_tpu_torch.parallel import DataParallelServer, ZooServer
    from pfd_tpu_torch.parallel.serve import nchw
    from pfd_tpu_torch.pipeline import PromptFreeDiffusionPipeline

    t_phase = time.perf_counter()
    files = write_zoo(root)
    for name in ("SD-v1.5", "vae"):
        path = files[name][0]
        _, dt = _synced(loader.load_sd_file, path)
        print(f"zoo read {name}: load_sd_file {os.path.getsize(path) / 1e9:.3f} GB in "
              f"{dt:.2f} s", flush=True)
    served = {}
    tags = dict(tag_ctx="SeeCoder", tag_diffuser="SD-v1.5", tag_ctl="canny")

    # ---- the bf16 pipeline on the zoo, its swaps ------------------------------
    pipe, dt = _synced(PromptFreeDiffusionPipeline, fp16=True, device="cuda", seed=0,
                       pretrained_root=root, self_attn_fn=fa.self_attn_fn, **tags)
    print(f"zoo: bf16 pipeline built and loaded (SeeCoder, SD-v1.5, canny) in {dt:.2f} s",
          flush=True)
    check_part("zoo load SeeCoder", pipe.net.ctx, files["SeeCoder"][1])
    check_part("zoo load SD-v1.5", pipe.net.diffuser, files["SD-v1.5"][1])
    check_part("zoo load canny", pipe.net.ctl, files["canny"][1])
    _, dt = _synced(pipe.load_vae, files["vae"][0])
    print(f"zoo swap: load_vae {dt:.2f} s", flush=True)
    check_part("zoo load_vae", pipe.net.vae["image"], files["vae"][1])
    for tag in ("Deliberate-v2.0", "SD-v1.5"):
        _, dt = _synced(pipe.action_load_diffuser, tag)
        print(f"zoo swap: action_load_diffuser({tag!r}) {dt:.2f} s", flush=True)
        check_part(f"zoo swap {tag}", pipe.net.diffuser, files[tag][1])
    lp = LaunchPlan(pipe.net)
    for with_control in (False, True):  # the requests' two buckets, captured ahead
        keys, dt = _synced(pipe.warmup, with_control=with_control, steps=10)
        print(f"zoo: bf16 pipeline warmup {keys[-1] if with_control else keys[0]} {dt:.2f} s "
              f"{json.dumps(pipe._graphs[(512, 512, 1, with_control, 10, 0.0)].stats)}",
              flush=True)

    # ---- HTTP: S1-S5 through serve._Handler, each beside the direct request ----
    tserve._Handler.pipeline = pipe
    srv = ThreadingHTTPServer(("127.0.0.1", 0), tserve._Handler)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}/inference"
    ref_list, hint_list = ref.tolist(), hint_src.tolist()

    def decode(payload):
        img = np.asarray(tserve._decode_image(payload), np.float32)
        return img / 255.0 if isinstance(payload, list) else img

    def post(label, **req):
        body = {"image": ref_list, "steps": 10, "seed": 42, **req}
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        data = json.dumps(body).encode()
        rq = urllib.request.Request(url, data, {"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(rq, timeout=300) as r:
                out = json.loads(r.read())
        except urllib.error.HTTPError as e:
            raise AssertionError(f"HTTP {label}: {e.code} {e.read()[:500]!r}") from e
        s_http = time.perf_counter() - t0
        launches = launch_counts()
        img = decode(out["image"])
        check_image(img, f"HTTP {label}")
        direct, s_direct = _synced(
            pipe.action_inference, ref, hint_src if "control_image" in req else None, "canny",
            True, 512, 512, 2.0, 42, tag_ctx=req.get("tag_ctx"),
            tag_diffuser=req.get("tag_diffuser"), steps=10)
        if not np.array_equal(np.round(img * 255), np.floor(np.clip(direct[0], 0, 1) * 255)):
            raise AssertionError(f"HTTP {label}: the image is not the direct request's")
        want = lp.expected(steps=10, control="control_image" in req)
        if launches != want:
            raise AssertionError(f"HTTP {label}: launches {launches}, want {want}")
        served[label] = launches
        print(f"HTTP {label}: {json.dumps({k: v for k, v in req.items() if 'image' not in k})} "
              f"s_http={s_http:.4f} s_direct={s_direct:.4f} overhead_s={s_http - s_direct:.4f} "
              f"({len(data) / 1e6:.1f} MB request, {card}) launches={json.dumps(launches)}",
              flush=True)
        return img, out

    try:
        s1, _ = post("S1", tag_diffuser="SD-v1.5")
        s2, _ = post("S2", tag_diffuser="Deliberate-v2.0")
        s3, _ = post("S3", tag_diffuser="SD-v1.5")
        s4, out4 = post("S4", tag_diffuser="SD-v1.5", control_image=hint_list,
                        ctl_method="canny")
        s5, _ = post("S5", tag_ctx="SeeCoder-Anime")
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
    if np.array_equal(s2, s1) or not np.array_equal(s3, s1):
        raise AssertionError("HTTP: S2 (Deliberate) must differ from S1 and S3 (SD again) "
                             "repeat it bit for bit")
    if "hint" not in out4 or np.array_equal(s4, s1):
        raise AssertionError("HTTP S4: no hint returned, or the image equals S1's")
    if np.array_equal(s5, s1) or pipe.tag_ctx != "SeeCoder-Anime":
        raise AssertionError("HTTP S5: the anime negative context did not change the image")
    print(f"HTTP: S2 differs from S1 (mean |S2-S1| {np.abs(s2 - s1).mean():.5f}), S3 = S1 bit "
          f"for bit, S4 returned its hint, S5 differs (mean |S5-S1| "
          f"{np.abs(s5 - s1).mean():.5f})", flush=True)
    pipe.action_load_ctx("SeeCoder")

    # ---- the int8 mode's swap -----------------------------------------------------
    pipe8, dt = _synced(PromptFreeDiffusionPipeline, fp16=True, quantized=True, device="cuda",
                        seed=0, pretrained_root=root, self_attn_fn=fa.self_attn_fn_int8, **tags)
    print(f"zoo: int8 pipeline built and loaded in {dt:.2f} s", flush=True)
    check_part("zoo int8 load SD-v1.5", pipe8.net.diffuser, files["SD-v1.5"][1])
    check_part("zoo int8 load canny", pipe8.net.ctl, files["canny"][1])
    pipe8.load_vae(files["vae"][0])
    check_part("zoo int8 load_vae", pipe8.net.vae["image"], files["vae"][1])
    lp8 = LaunchPlan(pipe8.net)
    want8 = lp8.expected(steps=10, quantized=True, attn8=True)
    pipe8.warmup(with_control=False, steps=10)
    imgs8 = {}
    for label, tag in (("int8 SD", "SD-v1.5"), ("int8 swap", "Deliberate-v2.0"),
                       ("int8 SD again", "SD-v1.5")):
        _, dt = _synced(pipe8.action_load_diffuser, tag)
        print(f"zoo swap: int8 action_load_diffuser({tag!r}) {dt:.2f} s", flush=True)
        check_part(f"zoo int8 swap {tag}", pipe8.net.diffuser, files[tag][1])
        [imgs8[label]], st = serve_graphed(pipe8, ref, 42, 10, label)
        check_image(imgs8[label], label)
        if st["launches"] != want8:
            raise AssertionError(f"request {label}: launches {st['launches']}, want {want8}")
        served[label] = st["launches"]
    if (np.array_equal(imgs8["int8 swap"], imgs8["int8 SD"])
            or not np.array_equal(imgs8["int8 SD again"], imgs8["int8 SD"])):
        raise AssertionError("int8 swap: the swapped request must differ, and swapping back "
                             "must repeat the first bit for bit")
    print("int8 swap: Deliberate's request differs, SD again = SD bit for bit", flush=True)
    del pipe8
    torch.cuda.empty_cache()

    # ---- ZooServer: b4 grouped over two tags, canny hints, mixed control --------
    zoo_sd, dt = _synced(lambda: {t: loader.diffuser_sd_to_params(loader.load_sd_file(
        files[t][0])) for t in ("SD-v1.5", "Deliberate-v2.0")})
    zs, dt2 = _synced(ZooServer, pipe.net, zoo_sd, devices=["cuda"], steps=10,
                      self_attn_fn=fa.self_attn_fn)
    del zoo_sd
    print(f"ZooServer: 2 diffuser tags read in {dt:.2f} s, onto the card in {dt2:.2f} s",
          flush=True)
    hint = annotators.preprocess(hint_src, method="canny", size=(512, 512))
    refs4 = np.stack([ref] + [np.random.default_rng(200 + i).random((512, 512, 3),
                                                                    dtype=np.float32)
                              for i in range(3)])
    hints4 = np.stack([hint, hint[:, ::-1], hint[::-1], hint[::-1, ::-1]]).copy()
    ztags, on = ["SD-v1.5", "Deliberate-v2.0", "SD-v1.5", "Deliberate-v2.0"], [1, 0, 0, 1]
    swaps, swap = [], zs._swap

    def timed_swap(*a):
        swaps.append(_synced(swap, *a)[1])
    zs._swap = timed_swap
    # captures the group bucket (2 requests with the ControlNet) both groups replay
    zs.generate(refs4, ztags, hints=hints4, control_on=on, h=512, w=512, seed=0)
    print(f"ZooServer: group bucket {json.dumps(zs._group_fn(512, 512, 2, True).stats)}",
          flush=True)
    swaps.clear()
    torch.cuda.synchronize()
    reset_counts()
    out4, s_b4 = _synced(zs.generate, refs4, ztags, hints=hints4, control_on=on, h=512, w=512,
                         seed=42)
    served["zoo b4"] = launch_counts()
    want = {k: 2 * v for k, v in lp.expected(steps=10, control=True).items()}
    if served["zoo b4"] != want:
        raise AssertionError(f"ZooServer b4: launches {served['zoo b4']}, want {want} (two "
                             f"groups of two with the ControlNet)")
    if not bool(torch.isfinite(out4).all()) or out4.shape != (4, 512, 512, 3):
        raise AssertionError("ZooServer b4: bad images")
    zs._swap = swap
    x4 = zs.init_noise(42, 4, 512, 512)
    r4, h4 = nchw(refs4, "cuda"), nchw(hints4, "cuda")
    mask4 = np.asarray(on, np.float32)

    def zoo_eager():
        """The b4 request through the eager body, group by group as
        ``_generate_grouped`` runs it."""
        groups = {}
        for i, tag in enumerate(ztags):
            groups.setdefault((tag, None), []).append(i)
        out = [None] * 4
        for (tag, _), idx in sorted(groups.items(), key=lambda kv: str(kv[0])):
            zs._swap(zs.model, tag, None)
            imgs = zs._sample_body(x4[idx], r4[idx], h4[idx],
                                   torch.as_tensor(mask4[idx], device="cuda"), 2.0)
            for j, i in enumerate(idx):
                out[i] = imgs[j]
        return torch.stack(out).permute(0, 2, 3, 1)

    b4_times = {"eager": [], "graphed": []}
    for _ in range(3):
        eager4, dt = _synced(zoo_eager)
        b4_times["eager"].append(dt / 4)
        _, dt = _synced(zs.generate, refs4, ztags, hints=hints4, control_on=on, h=512, w=512,
                        seed=42)
        b4_times["graphed"].append(dt / 4)
    if not torch.equal(out4, eager4):
        raise AssertionError("ZooServer b4: the graphed batch is not the eager one bit for bit")
    print(f"ZooServer b4 10 steps, s/img: {json.dumps(b4_times)}; graphed = eager bit for bit "
          f"({card})", flush=True)
    out4 = out4.float()

    def rel(a, b):
        return ((a.float() - b.float()).norm() / b.float().norm()).item()

    readings, spreads = [], []
    for i in range(4):
        zs._swap(zs.model, ztags[i], None)
        hi = h4[[i]] if on[i] else None
        single = zs._sample_body(x4[[i]], r4[[i]], hi, None, 2.0)[0].permute(1, 2, 0)
        dup = zs._sample_body(x4[[i, i]], r4[[i, i]], None if hi is None else h4[[i, i]],
                              None, 2.0)[0].permute(1, 2, 0)
        readings.append(rel(out4[i], single))
        spreads.append(rel(dup, single))
    bound = max(2 * max(spreads), 1e-3)
    print(f"ZooServer b4 vs each request alone (same tag, hint, start latent), rel L2: "
          f"{', '.join(f'{r:.3e}' for r in readings)}; batch 2 vs batch 1 of the same request: "
          f"{', '.join(f'{r:.3e}' for r in spreads)}; bound max(2 x spread, 1e-3) = "
          f"{bound:.3e}", flush=True)
    if not max(readings) <= bound:
        raise AssertionError(f"ZooServer b4: rel L2 {readings} above {bound}")
    b1_sharded = zs.generate(refs4[:1], ztags[:1], hints=hints4[:1], h=512, w=512, seed=42)
    b1_grouped = zs._generate_grouped(x4[[0]], r4[[0]], ztags[:1], [None], h4[[0]],
                                      np.ones(1, np.float32), 2.0).permute(0, 2, 3, 1)
    if not torch.equal(b1_sharded, b1_grouped):
        raise AssertionError("ZooServer b1: sharded and grouped differ")
    print(f"ZooServer: b4 grouped {s_b4 / 4:.4f} s/img ({s_b4:.3f} s), swap per group "
          f"{', '.join(f'{s:.4f}' for s in swaps)} s; b1 sharded = grouped bit for bit "
          f"({card})", flush=True)
    del zs
    torch.cuda.empty_cache()

    # ---- DataParallelServer: b8 ---------------------------------------------------
    dp = DataParallelServer(pipe.net, ["cuda"], steps=10, self_attn_fn=fa.self_attn_fn)
    buckets, dt = _synced(dp.warmup, [(512, 512)], batch=8)
    print(f"DataParallelServer: warmup {dt:.2f} s {json.dumps(dp._fn(512, 512, 8, False)[0].stats)}",
          flush=True)
    refs8 = np.stack([np.random.default_rng(300 + i).random((512, 512, 3), dtype=np.float32)
                      for i in range(8)])
    torch.cuda.synchronize()
    reset_counts()
    out8, s_b8 = _synced(dp.generate, refs8, h=512, w=512, seed=42)
    served["dp b8"] = launch_counts()
    if served["dp b8"] != lp.expected(steps=10):
        raise AssertionError(f"DataParallelServer b8: launches {served['dp b8']}, want "
                             f"{lp.expected(steps=10)}")
    x8 = torch.randn((8, 4, 64, 64), device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(42))
    b8_times = {"eager": [], "graphed": []}
    for _ in range(3):
        eager8, dt = _synced(dp._sample_body, nchw(refs8, "cuda"), None, x8, 2.0)
        b8_times["eager"].append(dt / 8)
        _, dt = _synced(dp.generate, refs8, h=512, w=512, seed=42)
        b8_times["graphed"].append(dt / 8)
    if not torch.equal(out8, eager8.permute(0, 2, 3, 1)):
        raise AssertionError("DataParallelServer b8: the graphed batch is not the eager one bit "
                             "for bit")
    print(f"DataParallelServer b8 10 steps, s/img: {json.dumps(b8_times)}; graphed = eager bit "
          f"for bit ({card})", flush=True)
    out8 = out8.float()
    if (out8.shape != (8, 512, 512, 3) or not bool(torch.isfinite(out8).all())
            or out8.min() < 0 or out8.max() > 1):
        raise AssertionError("DataParallelServer b8: bad images")
    print(f"DataParallelServer: buckets {buckets}; b8 10 steps {s_b8 / 8:.4f} s/img "
          f"({s_b8:.3f} s, {card}); phase 12 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return served


# phase 13's OpenPose file: the body net's last heatmap conv scaled by this
# gain (its seeds 160-162), so that on the random weights the body decode
# finds a few people, one with a hand box and a face box (the decode pairs
# every two peaks of a limb: unscaled, ~1,000 peaks and ~70 people); and the
# bound on one body decode's seconds
POSE_HEAT_GAIN = 0.2
POSE_SEED = 160
DECODE_BOUND_S = 30.0
# zoo.PREPROCESS_METHODS's network methods, and the ones phase 13 serves
NET_METHODS = ("hed", "depth", "normal", "mlsd", "openpose", "openpose_withface",
               "openpose_withfacehand", "scribble")
SERVED_METHODS = ("hed", "depth", "normal", "mlsd", "openpose_withfacehand", "scribble")


def write_annotators(root):
    """Seeded random-init files of the seven annotator networks at their
    published widths under ``root``'s ``pretrained/controlnet/preprocess/``,
    in the upstream layouts ``pfd_tpu`` reads (``torch.save``): HED with its
    (1, 3, 1, 1) ``norm``, PiDiNet ``module.``-prefixed with 3x3
    pixel-difference kernels, MLSD with BatchNorm's ``num_batches_tracked``,
    MiDaS (``.pt``) with timm's classifier-only norm and head, OpenPose's
    body, hand and face nets. Fan-in-scaled weights (``init_from_spec``'s
    ``gain``: sqrt(2) for the ReLU stacks, 1 for PiDiNet's residual one; MiDaS its own
    ``init_params``), so that no map saturates or
    vanishes everywhere. Returns {network: the port's state dict the file
    must load to}."""
    import torch
    from pfd_tpu_torch.annotators import nets
    from pfd_tpu_torch.annotators.nets import _specs, hed, midas, mlsd, openpose, pidinet
    from pfd_tpu_torch.io.convert import params_from_jax, pytree_to_torch_sd

    out = {}

    def put(name, rel, file_sd, sd):
        path = nets.pretrained_path(*rel, root=root)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        t0 = time.perf_counter()
        torch.save(file_sd, path)
        dt = time.perf_counter() - t0
        n = os.path.getsize(path)
        print(f"annotator write {name}: {'/'.join(rel)}, {n / 1e6:.1f} MB, "
              f"{sum(v.numel() for v in sd.values()) / 1e6:.2f} M parameters, {dt:.2f} s",
              flush=True)
        out[name] = sd

    sd = params_from_jax(hed.init_params(141, gain=2 ** 0.5))
    put("hed", ("hed", "ControlNetHED.pth"), dict(sd, norm=sd["norm"].reshape(1, 3, 1, 1)), sd)
    raw = {f"module.{k}": torch.from_numpy(v) for k, v in pytree_to_torch_sd(
        nets.init_from_spec(142, pidinet.upstream_spec(), gain=1.0)).items()}
    put("pidinet", ("pidinet", "table5_pidinet.pth"), raw, pidinet.convert_sd(raw))
    sd = params_from_jax(mlsd.init_params(143, gain=2 ** 0.5))
    counters = {k.replace("running_var", "num_batches_tracked"): torch.tensor(0)
                for k in sd if k.endswith("running_var")}
    put("mlsd", ("mlsd", "mlsd_large_512_fp32.pth"), {**sd, **counters}, sd)
    sd = params_from_jax(midas.init_params(144))
    head = {"pretrained.model.norm.weight": torch.ones(768),
            "pretrained.model.norm.bias": torch.zeros(768),
            "pretrained.model.head.weight": torch.zeros(1000, 768),
            "pretrained.model.head.bias": torch.zeros(1000)}
    put("midas", ("midas", "dpt_hybrid-midas-501f0c75.pt"), {**sd, **head}, sd)
    for i, part in enumerate(("body", "hand", "face")):
        sd = params_from_jax(nets.init_from_spec(
            POSE_SEED + i, getattr(_specs, f"OPENPOSE_{part.upper()}"), gain=2 ** 0.5))
        if part == "body":
            sd = {k: v * POSE_HEAT_GAIN if k.startswith("model6_2.Mconv7_stage6_L2.") else v
                  for k, v in sd.items()}
        put(f"openpose_{part}", ("openpose", openpose._FILES[part]), sd, sd)
    return out


def rel_l2(a, b):
    import torch
    a, b = torch.as_tensor(a).double().cpu(), torch.as_tensor(b).double().cpu()
    return ((a - b).norm() / b.norm()).item()


def preprocess_stack(card, ref, hint_src):
    """Phase 13: config #4, the annotator networks and the full preprocess
    stack into the ControlNet path, at full width, on files written to a
    temporary ``pretrained_root`` (removed at the end). Returns {request:
    launches}."""
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="pfd_annotators_")
    try:
        return _preprocess_stack(card, ref, hint_src, root)
    finally:
        shutil.rmtree(root)


def _preprocess_stack(card, ref, hint_src, root):
    import numpy as np
    import torch
    from pfd_tpu_torch import annotators
    from pfd_tpu_torch.annotators import imageops, nets
    from pfd_tpu_torch.annotators.nets import hed, midas, mlsd, openpose, pidinet
    from pfd_tpu_torch.models.build import dezero_
    from pfd_tpu_torch.ops import flash_attention as fa
    from pfd_tpu_torch.pipeline import PromptFreeDiffusionPipeline

    t_phase = time.perf_counter()
    files = write_annotators(root)
    shapes = {"hed": hed.SHAPES, "pidinet": pidinet.SHAPES, "mlsd": mlsd.SHAPES,
              "midas": midas.SHAPES, **{f"openpose_{p}": s for p, s in openpose.SHAPES.items()}}
    readers = {"hed": hed.get_params, "pidinet": pidinet.get_params, "mlsd": mlsd.get_params,
               "midas": midas.get_params,
               **{f"openpose_{p}": (lambda r, f=f: nets.load_torch_params(
                   nets.pretrained_path("openpose", f, root=r), dict))
                  for p, f in openpose._FILES.items()}}
    for name, want in files.items():
        got, dt = _synced(readers[name], root)
        if set(got) != set(want) or not all(torch.equal(got[k], want[k]) for k in want):
            raise AssertionError(f"annotator load {name}: not the weights written")
        print(f"annotator load {name}: {len(got)} tensors equal the written ones, read and "
              f"converted in {dt:.2f} s", flush=True)

    # ---- every network method at 512^2 on the card -------------------------------
    pose, calls = [], collections.Counter()
    real = {"decode_body": openpose.decode_body, "hand_forward": openpose.hand_forward,
            "face_forward": openpose.face_forward}

    def decode_body(heat, paf, img_h, **kw):
        out, dt = _synced(real["decode_body"], heat, paf, img_h, **kw)
        pose.append({"peaks": len(out[0]), "people": len(out[1]), "decode_s": dt})
        return out

    def counted(name):
        def run(*a):
            calls[name] += 1
            return real[name](*a)
        return run

    openpose.decode_body = decode_body
    openpose.hand_forward, openpose.face_forward = counted("hand_forward"), counted("face_forward")
    try:
        for method in NET_METHODS:
            pose.clear()
            calls.clear()
            y, dt = _synced(annotators.preprocess, hint_src, method, size=(512, 512), root=root,
                            device="cuda")
            levels = np.round(y if method == "normal" else y * 255)  # normal: 0..255 (pfd_tpu)
            if y.shape != (512, 512, 3) or not np.isfinite(y).all():
                raise AssertionError(f"preprocess {method}: bad hint {y.shape}")
            if levels.min() == levels.max():
                raise AssertionError(f"preprocess {method}: the hint is constant ({levels.min()})")
            print(f"preprocess {method} at 512^2 on the card: {dt:.3f} s (the first call reads "
                  f"and builds its network), {len(np.unique(levels))} levels, saturated (level "
                  f"0 or 255) {np.isin(levels, (0, 255)).mean():.4f}, mean level "
                  f"{levels.mean():.2f}" + (f", body decode {json.dumps(pose)}, net calls "
                                              f"{json.dumps(dict(calls))}" if pose else ""),
                  flush=True)
            if any(p["decode_s"] > DECODE_BOUND_S for p in pose):
                raise AssertionError(f"preprocess {method}: a body decode took over "
                                     f"{DECODE_BOUND_S} s: {pose}")
            if method == "openpose_withfacehand" and not (
                    pose[0]["people"] and calls["hand_forward"] and calls["face_forward"]):
                raise AssertionError(f"preprocess {method}: no person, hand or face ran "
                                     f"({pose}, {dict(calls)})")
    finally:
        openpose.decode_body = real["decode_body"]
        openpose.hand_forward, openpose.face_forward = real["hand_forward"], real["face_forward"]

    # ---- each network on the card against itself on the CPU ---------------------
    img_bgr = (np.clip(hint_src, 0, 1) * 255).astype(np.float32)[:, :, ::-1]
    scale = 0.5 * 368 / 512
    body_in, _ = openpose.pad_right_down(
        openpose.smart_resize(img_bgr, (512 * scale, 512 * scale)), 8, 128)
    crop = img_bgr[96:352, 128:384]
    hand_in = openpose.smart_resize(imageops.gaussian_blur(crop, 0.8), (368, 368))
    face_in = openpose.smart_resize(crop, (384, 384))

    def nchw(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32)).permute(2, 0, 1)[None]

    mlsd_in = np.concatenate([imageops.resize_image(hint_src * 255.0, (512, 512), "bilinear"),
                              np.ones((512, 512, 1), np.float32)], -1) / 127.5 - 1.0
    inputs = {  # network: (forward, its input at the shape a 512^2 request gives it)
        "hed": (hed.hed_forward, nchw(hint_src) * 255.0),
        "pidinet": (pidinet.pidinet_forward, nchw(hint_src[:, :, ::-1])),
        "mlsd": (mlsd.mlsd_forward, nchw(mlsd_in)),
        "midas": (midas.dpt_hybrid_forward, nchw(hint_src * 255.0 / 127.5 - 1.0)),
        "openpose_body": (openpose.body_forward, nchw(body_in) / 256.0 - 0.5),
        "openpose_hand": (openpose.hand_forward, nchw(hand_in) / 256.0 - 0.5),
        "openpose_face": (openpose.face_forward, nchw(face_in) / 256.0 - 0.5)}
    net_ms = {}
    for name, (fwd, x) in inputs.items():
        card_net, cpu_net = (nets.build(shapes[name], files[name], d) for d in ("cuda", "cpu"))
        xc = x.cuda()
        with torch.no_grad():
            outs = [fwd(card_net, xc), fwd(cpu_net, x)]
            outs = [o if isinstance(o, (list, tuple)) else [o] for o in outs]
            errs = [rel_l2(a, b) for a, b in zip(*outs)]
            ms = cuda_ms(lambda: fwd(card_net, xc), 5)
        net_ms[name] = {"input": list(x.shape), "ms": ms}
        print(f"annotator {name}: card vs CPU (fp32, same weights) rel L2 per output "
              f"{', '.join(f'{e:.2e}' for e in errs)}; {ms:.3f} ms a forward at "
              f"{tuple(x.shape)} ({card})", flush=True)
        if not max(errs) <= 1e-4:
            raise AssertionError(f"annotator {name}: card vs CPU rel L2 {errs} above 1e-4")
        del card_net, cpu_net
    print(f"annotator ms at a 512^2 request's shapes: {json.dumps(net_ms)} ({card})", flush=True)

    # ---- the ControlNet requests, one 10-step bucket -----------------------------
    served = {}

    def pipeline(label, **kw):
        p, dt = _synced(PromptFreeDiffusionPipeline, fp16=True, device="cuda", seed=0,
                        pretrained_root=root, **kw)
        dezero_(p.net, torch.Generator(device="cuda").manual_seed(1))
        keys, dt_w = _synced(p.warmup, with_control=True, steps=10)
        print(f"{label}: built in {dt:.2f} s, bucket {keys[0]} captured in {dt_w:.2f} s",
              flush=True)
        return p, LaunchPlan(p.net)

    def request(p, lp, label, method, **plan):
        out, st = serve_graphed(p, ref, 42, 10, label, hint_src, method=method)
        check_image(out[0], label)
        want = lp.expected(steps=10, control=True, **plan)
        if st["launches"] != want:
            raise AssertionError(f"request {label}: launches {st['launches']}, want {want}")
        twin, dt = _synced(eager_request, p, ref, 42, 10, hint_src, method=method)
        if not all(np.array_equal(a, b) for a, b in zip(out, twin)):
            raise AssertionError(f"request {label}: the graphed image or hint is not its eager "
                                 f"twin's bit for bit")
        served[label] = st["launches"]
        print(f"request {label}: ctl_method={method} graphed s/img={st['s']:.4f} (eager twin "
              f"{dt:.4f} s, bit for bit) ({card})", flush=True)
        return out

    pipe, lp = pipeline("config #4 bf16 pipeline", self_attn_fn=fa.self_attn_fn)
    canny = request(pipe, lp, "net canny", "canny")[0]
    for method in SERVED_METHODS:
        img = request(pipe, lp, f"net {method}", method)[0]
        if np.array_equal(img, canny):
            raise AssertionError(f"request net {method}: the image equals the canny request's")
    del pipe
    torch.cuda.empty_cache()
    pipe8, lp8 = pipeline("config #4 int8 pipeline", quantized=True,
                          self_attn_fn=fa.self_attn_fn_int8)
    request(pipe8, lp8, "net int8 depth", "depth", quantized=True, attn8=True)
    del pipe8
    torch.cuda.empty_cache()
    print(f"phase 13 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return served


# phase 14: a fixed prompt's CLIP token ids (start, words, end of text) and
# the empty prompt's, each padded with end-of-text ids to 77; the custom
# tokens of the customized tokenizers take the ids after the vocabulary's
CLIP_PROMPT_IDS = [49406, 320, 1125, 539, 320, 2368, 530, 518, 3144, 49407]
CLIP_VOCAB = 49408
CLIP_EOT = 49407


def clip_ids(ids, n=77):
    import numpy as np
    return np.array([list(ids) + [CLIP_EOT] * (n - len(ids))], np.int64)


def clip_encoders(seed=0):
    """Phase 14's encoders on the host at published widths, from numpy-seeded
    trees (``models/clip.py``'s inits, carried across by ``params_from_jax``):
    CLIP ViT-L/14 vision (24 x 1024, 16 heads, patch 14, 224^2, projection
    768) and text (12 x 768, 12 heads, vocabulary 49408, 77 positions,
    projection 768), OpenCLIP ViT-H-14 text (24 x 1024, 16 heads) and visual
    (32 x 1280, 16 heads, embed 1024, exact GELU). The eleven encoders share
    their tower's modules; the customized ones add their learned tables
    (N(0, 0.02^2), as ``pfd_tpu``'s ``init_custom``). Returns {name: module}."""
    import gc

    import numpy as np
    import torch
    from pfd_tpu_torch import registry
    from pfd_tpu_torch.io.convert import params_from_jax
    from pfd_tpu_torch.models import clip
    from pfd_tpu_torch.models.build import materialize

    rng = np.random.default_rng(seed)

    def meta(name, **args):
        with torch.device("meta"):
            return registry.get(name)(**args)

    def load(name, tree, **args):
        m = materialize(meta(name, **args), "cpu")
        m.load_state_dict(params_from_jax(tree), strict=True)
        return m

    def share(name, base, **args):
        m = meta(name, **args)
        for key in list(m._modules) + list(m._parameters):
            if key in base._modules or key in base._parameters:
                setattr(m, key, getattr(base, key))
        for key, mod in list(m._modules.items()):
            if isinstance(mod, torch.nn.Embedding) and mod.weight.is_meta:
                table = rng.standard_normal(tuple(mod.weight.shape), dtype=np.float32) * 0.02
                setattr(m, key, torch.nn.Embedding.from_pretrained(torch.from_numpy(table)))
        if any(p.is_meta for p in m.parameters()):
            raise AssertionError(f"{name}: a parameter is neither shared nor drawn")
        return m

    enc = {}
    enc["clip_image"] = load("clip_image_context_encoder", clip.init_clip_vision(rng))
    enc["clip_image_pa"] = share("clip_image_context_encoder_position_agnostic",
                                 enc["clip_image"])
    gc.collect()
    enc["clip_text"] = load("clip_text_context_encoder", clip.init_clip_text(rng))
    enc["clip_text_sdv1"] = share("clip_text_context_encoder_sdv1", enc["clip_text"])
    enc["clip_text_ce"] = share("clip_text_sdv1_customized_embedding", enc["clip_text"])
    gc.collect()
    enc["openclip_text"] = load("openclip_text_context_encoder", clip.init_openclip_text(rng))
    enc["openclip_text_sdv2"] = share("openclip_text_context_encoder_sdv2",
                                      enc["openclip_text"], layer="penultimate")
    for v, kw in (("v1", {}), ("v2", {}), ("v3", {"texpand": 4, "lora_rank": 4})):
        enc[f"openclip_text_{v}"] = share(
            f"openclip_text_context_encoder_sdv2_customized_tokenizer_{v}",
            enc["openclip_text"], customized_tokens=["<a>", "<b>"], **kw)
    gc.collect()
    enc["openclip_image"] = load("openclip_image_context_encoder",
                                 clip.init_openclip_visual(rng))
    gc.collect()
    for m in enc.values():
        m.eval().requires_grad_(False)
    return enc


def clip_inputs(ref, hint_src):
    """Phase 14's encoder inputs (host tensors): the reference and hint
    images NCHW, a 0/1 mask of the hint's bright shapes, the prompt's and the
    empty prompt's ids, the customized-embedding pair (4 marker slots) and
    the customized tokenizers' id triples (two custom tokens, texpand 1 and
    4; ``pfd_tpu``'s ``_split_custom_tokens`` and ``_pad_rows``)."""
    import numpy as np
    import torch
    from pfd_tpu_torch.models import clip

    def nchw(a):
        return torch.from_numpy(np.ascontiguousarray(a.transpose(2, 0, 1)))[None]

    ce_ids = clip_ids([49406, 320, 0, 1, 2, 3, 2368, CLIP_EOT])
    ce_mask = np.zeros_like(ce_ids)
    ce_mask[0, 2:6] = 1
    rows = [[49406, 320, CLIP_VOCAB, 539, CLIP_VOCAB + 1, 2368, CLIP_EOT]]

    def triple(texpand):
        r, c, m = clip._split_custom_tokens(rows, CLIP_VOCAB, texpand)
        return (clip._pad_rows(r, 77, eot=CLIP_EOT), clip._pad_rows(c, 77),
                clip._pad_rows(m, 77))

    return {"ref": nchw(ref), "hint": nchw(hint_src),
            "mask": nchw((hint_src[..., :1] > 0.25).astype(np.float32)),
            "ids": clip_ids(CLIP_PROMPT_IDS), "empty": clip_ids([49406]),
            "ce": (ce_ids, ce_mask), "t1": triple(1), "t4": triple(4)}


def check_row_sums(qshape, skv, gen):
    """K2's softmax row sums: with all-ones values its output is
    sum(p) / l, 1 wherever no masked key leaks into a row (the resident
    tile's padding at 77 keys, the key loop's one-key tail at 257). A
    leak biases the output by far more than one bf16 ulp above 1 (2^-7)."""
    import torch
    from pfd_tpu_torch.ops import flash_attention as fa

    b, h, sq, d = qshape
    q = torch.randn(qshape, generator=gen, device="cuda").bfloat16()
    k = torch.randn((b, h, skv, d), generator=gen, device="cuda").bfloat16()
    ones = torch.ones((b, h, skv, d), device="cuda", dtype=torch.bfloat16)
    err = (fa.cross_attention(q, k, ones).float() - 1).abs().max().item()
    err_plain = (fa.attention_plain(q, k, ones).float() - 1).abs().max().item()
    print(f"K2 row sums {list(qshape)} skv={skv}: max |o - 1| kernel {err:.3e}, plain "
          f"{err_plain:.3e} (limit {2 ** -7:.3e})", flush=True)
    if not max(err, err_plain) <= 2 ** -7:
        raise AssertionError(f"K2 {qshape} skv={skv}: row sums off 1 by {err}")
    return err


def clip_paths(card, pipe, lp, ref, hint_src, mufu_rate, gen, sms):
    """Phase 14: the CLIP and OpenCLIP context encoders at published width,
    multi-context mixing and Euler-ancestral sampling at 512^2, b1, CFG 2.0,
    on phase 5's bf16 pipeline, through K1 and K2; K2 at the new key counts.
    Returns (K2's new rows, {request: launches})."""
    import torch

    t_phase = time.perf_counter()
    try:
        return _clip_paths(card, pipe, lp, ref, hint_src, mufu_rate, gen, sms)
    finally:
        torch.cuda.empty_cache()
        print(f"phase 14 took {time.perf_counter() - t_phase:.1f} s", flush=True)


def _clip_paths(card, pipe, lp, ref, hint_src, mufu_rate, gen, sms):
    import gc

    import numpy as np
    import torch
    from pfd_tpu_torch.diffusion.kdiffusion import KDiffusionSampler
    from pfd_tpu_torch.ops import flash_attention as fa
    from pfd_tpu_torch.training import lora

    # K2 at the CLIP contexts' key counts: 77 (83 of the resident tile's 160
    # keys masked) and 257 (K1's key loop, a one-key last tile)
    k2_rows = []
    for qshape, skv in [((2, 8, 4096, 40), 77), ((2, 8, 1024, 80), 77),
                        ((2, 8, 4096, 40), 257), ((2, 8, 1024, 80), 257)]:
        k2_rows.append(check_kernel("K2", fa.cross_attention, qshape, skv, mufu_rate, gen,
                                    fa.cross_variant(qshape[0] * qshape[1], qshape[2], skv,
                                                     qshape[3], sms)))
        k2_rows[-1]["row_sum_err"] = check_row_sums(qshape, skv, gen)

    # the encoders: the host's run, then the card's, of the same weights and inputs
    t0 = time.perf_counter()
    enc = clip_encoders()
    inp = clip_inputs(ref, hint_src)
    n_params = {k: sum(p.numel() for p in m.parameters()) / 1e6 for k, m in enc.items()}
    print(f"phase 14 encoders built on the host in {time.perf_counter() - t0:.1f} s (M "
          f"parameters with the shared towers: {json.dumps(n_params)})", flush=True)
    adapters = enc["openclip_text_v3"].init_lora(torch.Generator().manual_seed(3))
    lgen = torch.Generator().manual_seed(4)
    for a in adapters.values():  # trained-looking adapters: B away from its zero init
        a["lora_B"] = 0.02 * torch.randn(a["lora_B"].shape, generator=lgen)

    def calls(dev, ad):
        def on(t):
            return t.to(dev) if torch.is_tensor(t) else t
        return {
            "clip_image": lambda: enc["clip_image"].encode(on(inp["ref"])),
            "clip_image masked": lambda: enc["clip_image"].encode(on(inp["ref"]), on(inp["mask"])),
            "clip_image_position_agnostic": lambda: enc["clip_image_pa"].encode(on(inp["ref"])),
            "clip_text_sdv1": lambda: enc["clip_text_sdv1"].encode(inp["ids"]),
            "clip_text": lambda: enc["clip_text"].encode(inp["ids"]),
            "clip_text_sdv1_customized_embedding": lambda: enc["clip_text_ce"].encode(inp["ce"]),
            "openclip_text_sdv2 penultimate": lambda: enc["openclip_text_sdv2"].encode(inp["ids"]),
            "openclip_text": lambda: enc["openclip_text"].encode(inp["ids"]),
            "openclip_text_v1": lambda: enc["openclip_text_v1"].encode(inp["t1"]),
            "openclip_text_v2": lambda: enc["openclip_text_v2"].encode(inp["t1"]),
            "openclip_text_v3": lambda: enc["openclip_text_v3"].encode(inp["t4"]),
            "openclip_text_v3 lora4": lambda: enc["openclip_text_v3"].encode(inp["t4"],
                                                                             adapters=ad),
            "openclip_image": lambda: enc["openclip_image"].encode(on(inp["ref"])),
            "openclip_image masked": lambda: enc["openclip_image"].encode(on(inp["ref"]),
                                                                          on(inp["mask"])),
        }

    t0 = time.perf_counter()
    with torch.no_grad():
        host = {k: fn() for k, fn in calls("cpu", adapters).items()}
    print(f"phase 14 encoders' host run: {time.perf_counter() - t0:.1f} s", flush=True)
    for m in enc.values():
        m.to("cuda")
    ad_card = {k: {n: t.to("cuda") for n, t in a.items()} for k, a in adapters.items()}
    card_calls = calls("cuda", ad_card)
    rows = {}
    with torch.no_grad():
        for name, fn in card_calls.items():
            out = fn()
            times = []
            for _ in range(3):
                s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                s.record()
                fn()
                e.record()
                torch.cuda.synchronize()
                times.append(s.elapsed_time(e))
            rel = rel_l2(out, host[name])
            rows[name] = {"shape": list(out.shape), "rel_l2_card_vs_host": rel,
                          "ms": statistics.median(times), "finite": bool(torch.isfinite(out).all())}
            print(f"encoder {name}: {json.dumps(rows[name])}", flush=True)
            if not (rel <= 1e-5 and rows[name]["finite"]):
                raise AssertionError(f"encoder {name}: card against host rel_l2 {rel}")
        # v3's adapters against its merged weights, loaded in place and put back
        v3 = enc["openclip_text_v3"]
        merged = lora.merge(v3, ad_card)
        saved = {k: v.detach().clone() for k, v in v3.state_dict().items() if k in merged}
        v3.load_state_dict(merged, strict=False)
        out_merged = v3.encode(inp["t4"])
        v3.load_state_dict(saved, strict=False)
        out_ad = card_calls["openclip_text_v3 lora4"]()
        rel = rel_l2(out_ad, out_merged)
        print(f"openclip_text_v3: adapters against merged weights rel_l2 {rel:.3e}, "
              f"bit for bit {torch.equal(out_ad, out_merged)}; against no adapters "
              f"{rel_l2(out_ad, card_calls['openclip_text_v3']()):.3e}", flush=True)
        if not rel <= 1e-6:
            raise AssertionError(f"openclip_text_v3: adapters against merged rel_l2 {rel}")
        c_clip_img = card_calls["clip_image"]()
        c_clip_hint = enc["clip_image"].encode(inp["hint"].to("cuda"))
        c_text = card_calls["clip_text_sdv1"]()
        u_text = enc["clip_text_sdv1"].encode(inp["empty"])
        c_see = pipe.encode_context(ref)
    del enc, host, card_calls, ad_card, adapters, merged, saved
    gc.collect()
    torch.cuda.empty_cache()

    # the five named requests, on phase 5's bf16 pipeline
    net = pipe.net
    see = {"conditioning": c_see, "unconditional_conditioning": pipe.negative_context(c_see),
           "unconditional_guidance_scale": 2.0}
    mix = [{"type": "image", "conditioning": c, "unconditional_conditioning": torch.zeros_like(c),
            "unconditional_guidance_scale": 2.0, "ratio": r}
           for c, r in ((c_see, 0.6), (c_clip_hint, 0.4))]

    def ddim(c, u):
        def run(attn, steps):
            x = pipe.start_latent(42, 512, 512, steps)[0]
            ci = {"conditioning": c, "unconditional_conditioning": u,
                  "unconditional_guidance_scale": 2.0}
            return pipe.sampler.sample_fn(x, ci, pipe.sampler.make_tables(steps),
                                          self_attn_fn=attn)[0]
        return run

    def multi(mixing):
        def run(attn, steps):
            g = torch.Generator(device="cuda").manual_seed(42)
            x = torch.randn((1, 4, 64, 64), generator=g, device="cuda")
            return pipe.sampler.sample_multicontext(x.shape, {"xt": x}, mix, steps=steps,
                                                    mixing_type=mixing, generator=g,
                                                    self_attn_fn=attn)[0]
        return run

    def euler(attn, steps):
        g = torch.Generator(device="cuda").manual_seed(42)
        return KDiffusionSampler(net).sample_euler_ancestral((1, 4, 64, 64), see, steps=steps,
                                                             eta=1.0, generator=g,
                                                             self_attn_fn=attn)

    requests = {"clip_image": (ddim(c_clip_img, torch.zeros_like(c_clip_img)), 50, 1),
                "clip_text": (ddim(c_text, u_text), 50, 1),
                "multi_attn": (multi("attention"), 50, 2),
                "multi_layer": (multi("layer"), 10, 1),
                "euler_a": (euler, 50, 1)}
    print(f"phase 14 contexts: clip_image {list(c_clip_img.shape)}, clip_text "
          f"{list(c_text.shape)}, SeeCoder {list(c_see.shape)}, hint's clip_image "
          f"{list(c_clip_hint.shape)}", flush=True)

    def serve_one(label, sample, steps, contexts):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        with torch.no_grad():
            img = net.vae_decode(sample(fa.self_attn_fn, steps), "image")
        img = img[0].permute(1, 2, 0).float().cpu().numpy()
        s = time.perf_counter() - t0
        launches = launch_counts()
        check_image(img, label)
        want = lp.expected(steps=steps, contexts=contexts)
        if launches != want:
            raise AssertionError(f"request {label}: launches {launches}, want {want}")
        return img, s, launches

    served, summary = {}, {}
    for label, (sample, steps, contexts) in requests.items():
        img, s, launches = serve_one(label, sample, steps, contexts)
        img2, s2, _ = serve_one(label, sample, steps, contexts)
        if not np.array_equal(img, img2):
            raise AssertionError(f"request {label}: the same seed is not bit-identical")
        with torch.no_grad():
            lat_k = sample(fa.self_attn_fn, 10).float()
            lat_p = sample(None, 10).float()
        rel = compare_eps(f"request {label}'s 10-step final latent, kernels vs plain attention",
                          lat_k, lat_p)
        served[label] = launches
        summary[label] = {"steps": steps, "s_per_img": [s, s2], "launches": launches,
                          "latent_rel_l2_vs_plain_10": rel, "image_mean": float(img.mean()),
                          "image_std": float(img.std())}
        print(f"request {label}: {json.dumps(summary[label])}", flush=True)
    print(f"phase 14 on {card}: {json.dumps({k: v['s_per_img'] for k, v in summary.items()})}",
          flush=True)
    return k2_rows, served


# phase 15: the training path. The full-width diffuser (config #1's
# openai_unet_2d_v1 plan alone, as __graft_entry__.py builds its
# diffuser-only pfd), the batcher's encoders, and its held-out batch; the
# card-against-host step runs at b1, 256^2 (32^2 latents)
TRAIN_STEPS, TRAIN_GRAD_ACC, TRAIN_MICRO = 4, 2, 2
HOST_LATENT = 32


# (a)'s fp32 conv rows: (name, x shape, out channels, what is held). At
# (2,320,64,64) cuDNN's TF32-allowed weight gradient picks an algorithm
# without TF32 (it reads as fp32's), so grad weight is held where it does
# not: the full-width UNet's level-2 conv, (2,640,32,32) -> 640
CONV_ROWS = (("ds1_backward", (2, 320, 64, 64), 320, "grad_input"),
             ("ds2_backward", (2, 640, 32, 32), 640, "grad_weight"),
             ("ds1_second_derivative", (2, 320, 64, 64), 320, "second"))


def conv_backward_rows(gen):
    """``ops.nn.conv2d_raw``'s backward and second derivative at full-width
    UNet convs, fp32, 3x3 (``CONV_ROWS``), against a float64 host reference,
    each beside a control row with cuDNN's TF32 allowed: ``conv2d_raw``
    within relative L2 1e-5 everywhere, the control above 1e-5 in the
    quantity its row holds. The second derivative is that of
    ``|dL/dx|^2 + |dL/dw|^2`` (``L = <conv(x, w), gy>``) to x and w, as the
    GAN loss's adaptive weight differentiates a gradient."""
    import torch
    import torch.nn.functional as F
    from pfd_tpu_torch.ops import nn as tnn

    def grads(conv, x, w, gy, second):
        x, w = x.clone().requires_grad_(), w.clone().requires_grad_()
        gx, gw = torch.autograd.grad(conv(x, w), (x, w), gy, create_graph=second)
        if second:
            gx, gw = torch.autograd.grad(gx.square().sum() + gw.square().sum(), (x, w))
        return gx, gw

    bad = []
    for name, shape, cout, held in CONV_ROWS:
        second = held == "second"
        x = torch.randn(shape, generator=gen, device="cuda")
        w = torch.randn((cout, shape[1], 3, 3), generator=gen, device="cuda") / (9 * shape[1]) ** 0.5
        gy = torch.randn((shape[0], cout) + shape[2:], generator=gen, device="cuda")
        ref = grads(lambda a, b: F.conv2d(a, b, padding=1), x.double().cpu(), w.double().cpu(),
                    gy.double().cpu(), second)
        rows = {}
        for label, conv, flags in (
                ("conv2d_raw", lambda a, b: tnn.conv2d_raw(a, b, padding=1), {}),
                ("F.conv2d_tf32", lambda a, b: F.conv2d(a, b, padding=1),
                 {"enabled": True, "allow_tf32": True})):
            with torch.backends.cudnn.flags(**flags) if flags else contextlib.nullcontext():
                gx, gw = grads(conv, x, w, gy, second)
                torch.cuda.synchronize()
            keys = ("second_x", "second_w") if second else ("grad_input", "grad_weight")
            rows[label] = {keys[0] + "_rel_l2": rel_l2(gx, ref[0]),
                           keys[1] + "_rel_l2": rel_l2(gw, ref[1])}
            print(json.dumps({"phase": 15, "conv_backward": label, "row": name,
                              "shape": [*shape, cout], **rows[label]}), flush=True)
        if max(rows["conv2d_raw"].values()) > 1e-5:
            bad.append(f"{name}: conv2d_raw is off float64: {rows['conv2d_raw']}")
        control = rows["F.conv2d_tf32"]
        held_keys = [k for k in control if k.startswith(held)]
        if min(control[k] for k in held_keys) <= 1e-5:
            bad.append(f"{name}: the TF32 control's {held} does not read above 1e-5, so the "
                       f"bound cannot tell TF32 apart: {control}")
    if bad:
        raise AssertionError("; ".join(bad))


# (f)'s second-order row: b1 at 128^2 (the host's float64 run takes ~15 s
# there), the discriminator's last conv scaled so that ``d_weight`` stays
# under its 1e4 clamp and its gradient flows
GAN_HOST_RES, GAN_DISC_SCALE, GAN_GRAD_LIMIT = 128, 1e3, 1e-3


def gan_second_order_rows(card):
    """``generator_loss`` on the full-width ``autokl_v2`` VAE (FP32), LPIPS and
    the discriminator, b1 at ``GAN_HOST_RES``^2, with ``d_weight`` unclamped:
    the gradients of ``d_weight`` (the second-order path: it differentiates
    two gradient norms) and of the loss against a float64 host run of the
    same weights and inputs, within relative L2 ``GAN_GRAD_LIMIT``, beside a
    control row with cuDNN's TF32 allowed in every fp32 conv that must read
    above it. The limit is not tighter because LPIPS and the discriminator
    are piecewise linear (ReLU, leaky ReLU, max pool, and the L1 term):
    fp32 rounding moves a pre-activation within ~1e-6 of zero across its
    kink, which changes the gradient by a step no precision removes (the
    conv rows of (a) hold the conv's second derivative itself to 1e-5)."""
    import numpy as np
    import torch
    from pfd_tpu_torch import config
    from pfd_tpu_torch.models import autokl_losses as losses
    from pfd_tpu_torch.models.build import build_model
    from pfd_tpu_torch.ops import nn as tnn
    from pfd_tpu_torch.policy import FP32, Policy

    fp64 = Policy(torch.float64, torch.float64, torch.float64, torch.float64, False)
    res = GAN_HOST_RES
    vae = build_model(config.model_cfg("autokl_v2"), policy=FP32, device="cuda",
                      generator=np.random.default_rng(10))
    host = build_model(config.model_cfg("autokl_v2"), policy=fp64, device="cpu")
    host.load_state_dict({k: v.cpu() for k, v in vae.state_dict().items()})

    def nets(device, dtype):
        lp = losses.init_lpips(np.random.default_rng(11), device=device).to(dtype)
        disc = losses.init_discriminator(np.random.default_rng(12), device=device).to(dtype)
        with torch.no_grad():
            disc.main[str(max(int(k) for k in disc.main))].weight.mul_(GAN_DISC_SCALE)
        return lp, disc

    imgs = np.random.default_rng(13).random((1, 3, res, res))
    noise = np.random.default_rng(14).standard_normal((1, 4, res // 8, res // 8))

    def grads(net, device, dtype):
        lp, disc = nets(device, dtype)
        net.requires_grad_(True)
        params = list(net.parameters())
        t0 = time.perf_counter()
        loss, aux = losses.generator_loss(
            lp, disc, net, torch.from_numpy(imgs).to(device, dtype), global_step=10,
            noise=torch.from_numpy(noise).to(device, dtype))
        flat = []
        for out, keep in ((aux["d_weight"], True), (loss, False)):
            gs = torch.autograd.grad(out, params, retain_graph=keep, allow_unused=True)
            flat.append(torch.cat([(g if g is not None else torch.zeros_like(p)).flatten()
                                   for g, p in zip(gs, params)]).double().cpu())
        if device == "cuda":
            torch.cuda.synchronize()
        net.requires_grad_(False)
        return aux["d_weight"].item(), flat, time.perf_counter() - t0

    d_host, ref, host_s = grads(host, "cpu", torch.float64)
    rows = {}
    no_tf32 = tnn._no_tf32
    for label in ("conv2d_raw", "tf32_control"):
        if label == "tf32_control":  # every fp32 conv, forward to second order, in TF32
            tnn._no_tf32 = lambda: torch.backends.cudnn.flags(enabled=True, allow_tf32=True)
        try:
            d_card, got, card_s = grads(vae, "cuda", torch.float32)
        finally:
            tnn._no_tf32 = no_tf32
        rows[label] = {"d_weight": d_card, "d_weight_grad_rel_l2": rel_l2(got[0], ref[0]),
                       "loss_grad_rel_l2": rel_l2(got[1], ref[1]), "card_s": card_s}
    print(json.dumps({"phase": 15, "vae_gan_second_order": f"b1 at {res}^2, discriminator's "
                      f"last conv x{GAN_DISC_SCALE:g}", "d_weight_host": d_host,
                      "host_s": host_s, **rows, "limit": GAN_GRAD_LIMIT, "card": card}),
          flush=True)
    clean, control = rows["conv2d_raw"], rows["tf32_control"]
    if not d_host < 1e4:
        raise AssertionError(f"d_weight {d_host} is at its clamp: no gradient flows through it")
    if max(clean["d_weight_grad_rel_l2"], clean["loss_grad_rel_l2"]) > GAN_GRAD_LIMIT:
        raise AssertionError(f"the GAN loss's gradients are off float64: {clean}")
    if min(control["d_weight_grad_rel_l2"], control["loss_grad_rel_l2"]) <= GAN_GRAD_LIMIT:
        raise AssertionError(f"the TF32 control reads within {GAN_GRAD_LIMIT}: {control}")


def training_path(card, gen):
    """Phase 15: the training path at full width (module docstring), its
    checkpoint in a temporary directory (removed at the end). Returns the
    batcher's launches."""
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="pfd_train_")
    try:
        return _training_path(card, gen, root)
    finally:
        shutil.rmtree(root)


def _training_path(card, gen, root):
    import numpy as np
    import torch
    from pfd_tpu_torch import config, data, registry
    from pfd_tpu_torch.io import checkpoint as ckpt_lib
    from pfd_tpu_torch.models import autokl_losses as losses
    from pfd_tpu_torch.models.build import build_model, dezero_, materialize
    from pfd_tpu_torch.ops import flash_attention as fa
    from pfd_tpu_torch.parallel import train as train_lib
    from pfd_tpu_torch.policy import BF16, FP32
    from pfd_tpu_torch.training import ema as ema_lib
    from pfd_tpu_torch.training import optimizers, schedulers
    from pfd_tpu_torch.training.harness import TrainConfig, Trainer

    t_phase = time.perf_counter()
    print(f"phase 15: {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated at its start "
          f"({card})", flush=True)

    def seeded(seed):
        return torch.Generator(device="cuda").manual_seed(seed)

    def synced():
        torch.cuda.synchronize()
        return time.perf_counter()

    # ---- (a) the guards -------------------------------------------------------
    q = torch.randn((1, 1, 4096, 512), generator=gen, device="cuda").bfloat16()
    before = fa.launches()
    try:
        fa.flash_attention(q.clone().requires_grad_(), q, q)
    except RuntimeError as e:
        print(f"phase 15 guard: K1 on a requires-grad input raises: {e}", flush=True)
    else:
        raise AssertionError("K1 took an input that requires grad")
    enc_cfg = config.model_cfg("pfd_seecoder")
    enc_cfg["args"]["diffuser_cfg_list"] = []
    enc = build_model(enc_cfg, policy=BF16, device="cuda", generator=seeded(0))
    dezero_(enc, seeded(1))
    x = torch.rand((1, 3, 512, 512), generator=gen, device="cuda").requires_grad_()
    mean, _ = enc.vae["image"].encode_moments(x)
    mean.float().square().mean().backward()
    torch.cuda.synchronize()
    if fa.launches() != before:
        raise AssertionError(f"the VAE encoder under grad launched {fa.launches()}, "
                             f"before {before}")
    gnorm = x.grad.float().norm().item()
    if not (np.isfinite(gnorm) and gnorm > 0):
        raise AssertionError(f"the VAE encoder's input gradient is {gnorm}")
    print(f"phase 15 guard: bf16 VAE encoder at 512^2 under grad: no K1 launch (plain "
          f"attention), |dx| {gnorm:.4e}", flush=True)
    conv_backward_rows(gen)

    # ---- (b) the batcher: the bf16 VAE (K1 in its mid-block) and SeeCoder -----
    seen = []
    hook = enc.vae["image"].encoder.mid.attn_1.register_forward_pre_hook(
        lambda m, a: seen.append(tuple(a[0].shape)))
    batcher = iter(data.DiffusionBatcher(enc, data.synthetic(512, seed=0), TRAIN_MICRO, seed=0,
                                         device="cuda"))
    rng = np.random.default_rng(0)
    reset_counts()
    batches, t0 = [], synced()
    for i in range(TRAIN_STEPS * TRAIN_GRAD_ACC + 1):
        k1 = fa.flash_attention.launches
        b = next(batcher)
        torch.cuda.synchronize()
        t_want = rng.integers(0, 1000, (TRAIN_MICRO,))
        n_want = rng.standard_normal((TRAIN_MICRO, 64, 64, 4)).astype(np.float32)
        if fa.flash_attention.launches != k1 + 1 or seen[-1] != (TRAIN_MICRO, 512, 64, 64):
            raise AssertionError(f"batch {i}: K1 launches {fa.flash_attention.launches - k1} "
                                 f"(want 1), mid-block input {seen[-1]}")
        if (tuple(b["x0"].shape) != (TRAIN_MICRO, 4, 64, 64)
                or tuple(b["cond"].shape) != (TRAIN_MICRO, 148, 768)
                or not all(bool(torch.isfinite(b[k]).all()) for k in ("x0", "cond"))):
            raise AssertionError(f"batch {i}: x0 {tuple(b['x0'].shape)}, cond "
                                 f"{tuple(b['cond'].shape)}, or not finite")
        if (not np.array_equal(b["t"].cpu().numpy(), t_want)
                or not np.array_equal(b["noise"].cpu().numpy(), n_want.transpose(0, 3, 1, 2))):
            raise AssertionError(f"batch {i}: t or noise is not numpy default_rng(0)'s")
        batches.append(b)
    s_batches = synced() - t0
    hook.remove()
    batch_launches = launch_counts()
    print(f"phase 15 batcher: {len(batches)} batches of {TRAIN_MICRO} at 512^2, K1 once each "
          f"at (2,1,4096,512): {batch_launches}, {s_batches / len(batches):.3f} s a batch "
          f"({card})", flush=True)
    del enc, x, mean, batcher

    # ---- (c) the full-width trainer: config #1's diffuser alone ---------------
    cfg_d = {"type": "pfd", "args": dict(
        vae_cfg_list=[], ctx_cfg_list=[],
        diffuser_cfg_list=[["image", config.model_cfg("openai_unet_2d_v1")]],
        beta_linear_start=0.00085, beta_linear_end=0.012, timesteps=1000)}
    model = build_model(cfg_d, policy=FP32, device="cuda", generator=seeded(2))
    dezero_(model, seeded(3))
    n_params = sum(p.numel() for p in model.parameters())
    labels = optimizers.pfd_parameter_groups(model)

    def make_opt():
        sched = schedulers.LambdaWarmUpCosine(1e-4, 2, 0.1, 1.0, 0.1, TRAIN_STEPS)
        return optimizers.build_optimizer("adamw", {"lr": 1e-4}, labels=labels,
                                          learning_rate=sched, grad_clip=1.0)

    cfg = TrainConfig(max_steps=TRAIN_STEPS, grad_acc=TRAIN_GRAD_ACC, use_ema=True,
                      log_every=1, eval_every=TRAIN_STEPS, ckpt_every=TRAIN_STEPS,
                      ckpt_dir=os.path.join(root, "ckpt"), log_dir=os.path.join(root, "logs"))
    trainer = Trainer(model, make_opt(), cfg, device="cuda")
    state = trainer.init_state()
    lo = {n: p.detach().clone() for n, p in state.params.items()}
    hi = {n: p.detach().clone() for n, p in state.params.items()}

    def envelope():
        with torch.no_grad():
            for n, p in state.params.items():
                torch.minimum(lo[n], p, out=lo[n])
                torch.maximum(hi[n], p, out=hi[n])

    def stream():  # the stacked micro-batches; between steps, the trajectory's envelope
        for i in range(TRAIN_STEPS):
            mbs = batches[i * TRAIN_GRAD_ACC:(i + 1) * TRAIN_GRAD_ACC]
            yield {k: torch.stack([mb[k] for mb in mbs]) for k in mbs[0]}
            envelope()

    held = batches[-1]
    held_losses = []

    def evaluator(params, step):
        with torch.no_grad(), ema_lib.swapped(model, params):
            held_losses.append(float(model.p_losses(held["x0"], held["t"], held["cond"],
                                                    held["noise"])[0]))
        return {"held_loss": held_losses[-1]}

    step_s, ckpt_s = [], []

    def timed(fn, out):
        def run(*a, **kw):
            t0 = synced()
            r = fn(*a, **kw)
            out.append(synced() - t0)
            return r
        return run

    torch.cuda.reset_peak_memory_stats()
    step_fn, save_fn = train_lib.train_step, ckpt_lib.save_train_state
    train_lib.train_step, ckpt_lib.save_train_state = timed(step_fn, step_s), timed(save_fn, ckpt_s)
    try:
        t0 = synced()
        state = trainer.fit(state, stream(), evaluator=evaluator)
        s_fit = synced() - t0
    finally:
        train_lib.train_step, ckpt_lib.save_train_state = step_fn, save_fn
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    recs = [json.loads(line) for line in open(os.path.join(cfg.log_dir, "metrics.jsonl"))]
    steps = [r for r in recs if "loss" in r]
    if (state.step != TRAIN_STEPS or len(steps) != TRAIN_STEPS or not all(
            np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in steps)
            or not np.isfinite(held_losses).all()):
        raise AssertionError(f"trainer: step {state.step}, records {recs}")
    shadow = trainer.ema_state["shadow"]
    with torch.no_grad():
        outside = sum(int(((shadow[n] < lo[n] - 1e-6) | (shadow[n] > hi[n] + 1e-6)).sum())
                      for n in shadow)
        moved = sum(not torch.equal(shadow[n], p) for n, p in state.params.items())
    if outside or moved < 0.9 * len(shadow):
        raise AssertionError(f"EMA: {outside} values outside the trajectory's envelope, "
                             f"{moved} of {len(shadow)} shadows differ from the parameters")
    del lo, hi
    for p in state.params.values():
        p.grad = None
    step_dir = os.path.join(cfg.ckpt_dir, str(TRAIN_STEPS))
    ckpt_gb = sum(os.path.getsize(os.path.join(step_dir, f)) for f in os.listdir(step_dir)) / 1e9

    # a fresh model resumes from the checkpoint: every tensor bit for bit
    model2 = build_model(cfg_d, policy=FP32, device="cuda", generator=seeded(4))
    trainer2 = Trainer(model2, make_opt(), TrainConfig(ckpt_dir=cfg.ckpt_dir), device="cuda")
    t0 = synced()
    restored = trainer2.resume(trainer2.init_state())
    s_read = synced() - t0
    a, b = state.opt_state.state_dict(), restored.opt_state.state_dict()
    same = (restored.step == TRAIN_STEPS and a["param_groups"] == b["param_groups"]
            and all(torch.equal(p, state.params[n]) for n, p in restored.params.items())
            and all(torch.equal(v, b["state"][i][k]) for i, s in a["state"].items()
                    for k, v in s.items()))
    if not same:
        raise AssertionError("resume did not restore the state bit for bit")
    del model2, trainer2, restored, a, b
    med = statistics.median(step_s[1:])
    print(json.dumps({"phase": 15, "trainer": "openai_unet_2d_v1 fp32, AdamW + clip 1.0 "
                      "(LambdaWarmUpCosine), EMA, grad_acc 2 x micro-batch 2 at 512^2",
                      "parameters_M": n_params / 1e6, "step_s": step_s,
                      "step_s_median_2_4": med,
                      "images_per_s": TRAIN_GRAD_ACC * TRAIN_MICRO / med,
                      "fit_s": s_fit, "peak_allocated_GB": peak_gb,
                      "losses": [r["loss"] for r in steps],
                      "grad_norms": [r["grad_norm"] for r in steps],
                      "held_loss_ema": held_losses, "checkpoint_GB": ckpt_gb,
                      "checkpoint_write_s": ckpt_s, "checkpoint_read_s": s_read,
                      "resume": "bit for bit", "card": card}), flush=True)
    del trainer, state, shadow
    torch.cuda.empty_cache()

    # ---- (d) the card against the host: one step at b1, 256^2 ----------------
    hl = HOST_LATENT
    rng = np.random.default_rng(7)
    batch = {"x0": rng.standard_normal((1, 4, hl, hl)).astype(np.float32),
             "cond": rng.standard_normal((1, 148, 768)).astype(np.float32),
             "t": np.array([500]), "noise": rng.standard_normal((1, 4, hl, hl)).astype(np.float32)}
    with torch.device("meta"):
        host = registry.get(cfg_d["type"])(**cfg_d["args"], policy=FP32)
    host = materialize(host, "cpu")
    host.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    out = {}
    for dev, m in (("cpu", host), ("cuda", model)):
        init, step = train_lib.make_train_step(m, train_lib.make_optimizer(grad_clip=None), dev)
        st = init()
        t0 = synced()
        _, metrics = step(st, batch)
        out[dev] = ({k: float(v) for k, v in metrics.items()}, synced() - t0)
    num = den = 0.0
    hp = dict(host.named_parameters())
    for n, p in model.named_parameters():
        g, gh = p.grad.double().cpu(), hp[n].grad.double()
        num += float((g - gh).square().sum())
        den += float(gh.square().sum())
    grad_rel = (num / den) ** 0.5
    loss_rel = abs(out["cuda"][0]["loss"] - out["cpu"][0]["loss"]) / abs(out["cpu"][0]["loss"])
    print(json.dumps({"phase": 15, "card_vs_host": f"one step, b1, {8 * hl}^2",
                      "loss_card": out["cuda"][0]["loss"], "loss_host": out["cpu"][0]["loss"],
                      "loss_rel": loss_rel, "grad_rel_l2": grad_rel,
                      "grad_norm_card": out["cuda"][0]["grad_norm"],
                      "grad_norm_host": out["cpu"][0]["grad_norm"],
                      "step_s_card": out["cuda"][1], "step_s_host": out["cpu"][1],
                      "card": card}), flush=True)
    if not (loss_rel <= 1e-5 and grad_rel <= 1e-4):
        raise AssertionError(f"card against host: loss {loss_rel:.3e} (limit 1e-5), gradient "
                             f"{grad_rel:.3e} (limit 1e-4)")
    del host, hp
    for p in model.parameters():
        p.grad = None

    # ---- (e) the train mask: only diffuser_image_context trains ---------------
    mask = {n: lab == "diffuser_image_context" for n, lab in labels.items()}
    init, step = train_lib.make_train_step(model, train_lib.make_optimizer(), "cuda",
                                           train_mask=mask)
    st = init()
    before = {n: p.detach().clone() for n, p in st.params.items()}
    for i in range(2):
        st, _ = step(st, dict(batch, t=np.array([200 + 300 * i])))
    frozen_same = all(torch.equal(p, before[n]) for n, p in st.params.items() if not mask[n])
    trained_moved = all(not torch.equal(p, before[n]) for n, p in st.params.items() if mask[n])
    n_train = sum(p.numel() for n, p in st.params.items() if mask[n])
    print(f"phase 15 mask: {n_train / 1e6:.1f} M of {n_params / 1e6:.1f} M parameters train "
          f"(diffuser_image_context); after 2 steps the others are bit for bit "
          f"{frozen_same}, every trained tensor moved {trained_moved}", flush=True)
    if not (frozen_same and trained_moved):
        raise AssertionError("the train mask let a frozen parameter move or a trained one stay")
    del model, st, before, init, step
    torch.cuda.empty_cache()

    # ---- (f) the VAE's GAN step at full width, b2, 256^2 ----------------------
    vae = build_model(config.model_cfg("autokl_v2"), policy=FP32, device="cuda",
                      generator=np.random.default_rng(10))
    lp = losses.init_lpips(np.random.default_rng(11), device="cuda")
    disc = losses.init_discriminator(np.random.default_rng(12), device="cuda")
    imgs = torch.from_numpy(np.random.default_rng(13).random((2, 3, 256, 256),
                                                             dtype=np.float32)).cuda()
    noise = seeded(14)
    rows = {}
    for side, net in (("generator", vae), ("discriminator", disc)):
        net.requires_grad_(True)
        opt = optimizers.build_optimizer("adamw", {"lr": 1e-4})
        opt_state = opt.init(dict(net.named_parameters()))
        t0 = synced()
        if side == "generator":
            loss, aux = losses.generator_loss(lp, disc, vae, imgs, global_step=10,
                                              generator=noise)
        else:
            loss, aux = losses.discriminator_loss(disc, vae, imgs, global_step=10,
                                                  generator=noise)
        loss.backward()
        ms = (synced() - t0) * 1e3
        gnorm = float(optimizers.global_norm(p.grad for p in net.parameters()))
        w0 = [p.detach().clone() for p in net.parameters()]
        opt.update(opt_state)
        moved = sum(not torch.equal(a, p) for a, p in zip(w0, net.parameters()))
        rows[side] = {"loss": loss.item(), **{k: v.item() for k, v in aux.items()},
                      "grad_norm": gnorm, "ms": ms, "tensors_moved": moved}
        net.requires_grad_(False)
        if not (np.isfinite(list(rows[side].values())).all() and gnorm > 0
                and moved == len(w0)):
            raise AssertionError(f"the VAE GAN step, {side}: {rows[side]}")
        del loss, aux, opt_state, w0
    print(json.dumps({"phase": 15, "vae_gan": "autokl_v2 fp32, LPIPS (VGG16), "
                      "NLayerDiscriminator ndf 64 x 3, b2 at 256^2, first call each",
                      **rows, "card": card}), flush=True)
    del vae, lp, disc, imgs
    torch.cuda.empty_cache()
    gan_second_order_rows(card)
    print(f"phase 15 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return batch_launches


# phase 16: the classic and legacy UNet family and the sdwebui converter.
# The tiny configs of each registry name at pfd_tpu's own test sizes
# (tests/test_unet.py, tests/test_unet_variants.py): the CPU tests
# (tests/test_torch_unet_{classic,variants}.py) hold the port against
# pfd_tpu at them, and (e) holds the card against the host
TINY_SD = dict(image_size=None, in_channels=4, out_channels=4, model_channels=32,
               attention_resolutions=[1, 2], num_res_blocks=1, channel_mult=[1, 2], num_heads=4,
               use_spatial_transformer=True, transformer_depth=1, context_dim=64,
               use_checkpoint=False, legacy=False)
TINY_2D = dict(input_channels=4, model_channels=32, output_channels=4, context_dim=64,
               num_noattn_blocks=(1, 1), channel_mult=(1, 2), with_attn=[True, False],
               num_heads=4, use_checkpoint=False)
TINY_0D = dict(TINY_2D, input_channels=24, output_channels=24)
TINY_0DMD = dict(TINY_0D, second_dim=(2, 2))
TINY_NOCTX = dict(image_size=None, in_channels=4, model_channels=32, out_channels=4,
                  num_res_blocks=1, attention_resolutions=[1, 2], channel_mult=[1, 2],
                  num_heads=4, legacy=False)
TINY_NOATT = dict(in_channels=4, model_channels=32, out_channels=4, num_res_blocks=1,
                  channel_mult=[1, 2])
TINY_DECODER = dict(in_channels=4, out_channels=3, model_channels=32, num_res_blocks=1,
                    channel_mult=[2, 1])
TINY_ENCODER = dict(image_size=16, in_channels=4, model_channels=32, out_channels=10,
                    num_res_blocks=1, attention_resolutions=[2], channel_mult=[1, 2],
                    num_heads=4)
TINY_VD = dict(unet_image_cfg={"type": "openai_unet_2d", "args": TINY_2D},
               unet_text_cfg={"type": "openai_unet_0dmd", "args": TINY_0DMD})
ENCODER_POOLS = ("adaptive", "attention", "spatial", "spatial_v2")
# label: (registry name, args, inputs, forward keywords). Inputs: "latent"
# (2,4,16,16) with a (2,9,64) context; "noctx" and "noctx8" the latent alone
# (16^2, 8^2); "vector" (2,24) with the context. The attention pool takes
# its heads from num_head_channels.
TINY_CASES = {
    "openai_unet_2d": ("openai_unet_2d", TINY_2D, "latent", {}),
    "openai_unet_0d_next": ("openai_unet_0d_next", TINY_0DMD, "vector", {}),
    "openai_unet_nocontext": ("openai_unet_nocontext",
                              dict(TINY_NOCTX, use_spatial_transformer=False), "noctx", {}),
    "openai_unet_nocontext st": ("openai_unet_nocontext",
                                 dict(TINY_NOCTX, use_spatial_transformer=True), "noctx", {}),
    "openai_unet_nocontext_noatt": ("openai_unet_nocontext_noatt", TINY_NOATT, "noctx", {}),
    "openai_unet_nocontext_noatt_decoderonly": ("openai_unet_nocontext_noatt_decoderonly",
                                                TINY_DECODER, "noctx8", {}),
    **{f"openai_unet_encoder {pool} {order}": (
        "openai_unet_encoder",
        dict(TINY_ENCODER, pool=pool, use_new_attention_order=order == "new",
             **({"num_head_channels": 16} if pool == "attention" else {})), "noctx", {})
       for pool in ENCODER_POOLS for order in ("legacy", "new")},
    "openai_unet_0d": ("openai_unet_0d", TINY_0D, "vector", {}),
    "openai_unet_0dmd": ("openai_unet_0dmd", TINY_0DMD, "vector", {}),
    "openai_unet_vd image prompt": ("openai_unet_vd", TINY_VD, "latent", {"ctype": "prompt"}),
    "openai_unet_vd image vision": ("openai_unet_vd", TINY_VD, "latent", {"ctype": "vision"}),
    "openai_unet_vd text prompt": ("openai_unet_vd", TINY_VD, "vector",
                                   {"xtype": "text", "ctype": "prompt"}),
    "openai_unet_vd image mixed": ("openai_unet_vd", TINY_VD, "latent",
                                   {"ctype": "vision", "context2": "prompt", "mixed_ratio": 0.4}),
}


def tiny_inputs(kind, seed):
    """A tiny case's inputs (``TINY_CASES``), numpy, in the port's layouts:
    {"x", "t"[, "context", "context2"]}."""
    import numpy as np
    rng = np.random.default_rng(seed)
    shape = {"latent": (2, 4, 16, 16), "noctx": (2, 4, 16, 16), "noctx8": (2, 4, 8, 8),
             "vector": (2, 24)}[kind]
    out = {"x": rng.standard_normal(shape).astype(np.float32),
           "t": np.array([981, 21], np.int64)}
    if kind in ("latent", "vector"):
        out["context"] = rng.standard_normal((2, 9, 64)).astype(np.float32)
        out["context2"] = rng.standard_normal((2, 7, 64)).astype(np.float32)
    return out


def tiny_forward(model, kind, inputs, kw):
    """The port's forward of a tiny case on the model's device (fp32)."""
    import torch
    dev = next(model.parameters()).device
    x, t = (torch.as_tensor(inputs[k], device=dev) for k in ("x", "t"))
    with torch.no_grad():
        if "context" not in inputs:
            return model(x, t)
        kw = dict(kw)
        c = torch.as_tensor(inputs["context"], device=dev)
        if "context2" in kw:
            kw["context2"] = (torch.as_tensor(inputs["context2"], device=dev), kw["context2"])
        return model(x, t, c, **kw)


def first_divergence(host, dev, kind, inputs, kw, limit=1e-6):
    """The first module (in call order) whose output on the card is off the
    host's by more than ``limit`` relative L2, with its input's error: where
    a card-against-host difference starts."""
    import torch

    def trace(model):
        outs = []
        hooks = [m.register_forward_hook(
            lambda mod, a, o, n=n: outs.append((n, a[0].detach().double().cpu()
                                                if a and torch.is_tensor(a[0]) else None,
                                                o.detach().double().cpu()))
            if torch.is_tensor(o) else None) for n, m in model.named_modules() if n]
        try:
            tiny_forward(model, kind, inputs, kw)
        finally:
            for h in hooks:
                h.remove()
        return outs

    for (n, a_h, o_h), (_, a_d, o_d) in zip(trace(host), trace(dev)):
        if o_h.norm() > 0 and rel_l2(o_d, o_h) > limit:
            into = rel_l2(a_d, a_h) if a_h is not None and a_h.norm() > 0 else float("nan")
            return (f"{n} ({type(host.get_submodule(n)).__name__}): out "
                    f"{rel_l2(o_d, o_h):.3e}, in {into:.3e}")
    return None


def classic_unets(card, gen):
    """Phase 16: the classic and legacy UNet family and the sdwebui
    converter at full width (module docstring), its files in a temporary
    root (removed at the end). Returns {request: launches}."""
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="pfd_classic_")
    try:
        return _classic_unets(card, gen, root)
    finally:
        shutil.rmtree(root)


def _classic_unets(card, gen, root):
    import copy

    import numpy as np
    import torch
    from pfd_tpu_torch import config, zoo
    from pfd_tpu_torch.io import loader
    from pfd_tpu_torch.models.build import build_model, dezero_
    from pfd_tpu_torch.models.unet_classic import classic_to_dual_key
    from pfd_tpu_torch.ops import flash_attention as fa
    from pfd_tpu_torch.pipeline import PromptFreeDiffusionPipeline
    from pfd_tpu_torch.policy import BF16, FP32

    t_phase = time.perf_counter()
    served = {}

    def seeded(seed):
        return torch.Generator(device="cuda").manual_seed(seed)

    def counted(label, fn, want=None):
        torch.cuda.synchronize()
        reset_counts()
        with torch.no_grad():
            out = fn()
        torch.cuda.synchronize()
        n = launch_counts()
        if want is not None:
            got = {k: n[k] for k in want}
            if got != want:
                raise AssertionError(f"{label}: launches {got}, want {want}")
            served[label] = n
        return out

    def cli(*args):
        cmd = [sys.executable, "-m", "pfd_tpu_torch.tools.model_conversion", *args]
        t0 = time.perf_counter()
        r = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True, timeout=300)
        if r.returncode:
            raise AssertionError(f"converter {args}: exit {r.returncode}: {r.stderr[-2000:]}")
        print(f"phase 16 converter {args[0]}{' --reverse' if '--reverse' in args else ''}: "
              f"{r.stdout.strip()} ({time.perf_counter() - t0:.2f} s)", flush=True)

    # ---- (a) openai_unet_sd at 512^2, b2, through K1 and K2 ---------------------
    sd_cfg = config.model_cfg("openai_unet_sd")
    classic = dezero_(build_model(sd_cfg, policy=BF16, device="cuda", generator=seeded(160)),
                      seeded(161))
    n_params = sum(p.numel() for p in classic.parameters())
    x = torch.randn((2, 4, 64, 64), generator=gen, device="cuda")
    t = torch.tensor([981, 21], device="cuda")
    ctx = torch.randn((2, 148, 768), generator=gen, device="cuda").bfloat16()
    ctx2 = torch.randn((2, 148, 768), generator=gen, device="cuda").bfloat16()
    k1k2 = {"flash_attention": 10, "cross_attention": 10}
    e_a = counted("openai_unet_sd eps", lambda: classic(x, t, ctx, self_attn_fn=fa.self_attn_fn),
                  k1k2)
    with torch.no_grad():
        e_plain = classic(x, t, ctx)
        ms = statistics.median(cuda_ms(lambda: classic(x, t, ctx, self_attn_fn=fa.self_attn_fn),
                                       1) for _ in range(3))
    compare_eps("phase 16 (a) openai_unet_sd eps, kernels vs plain attention at 512^2",
                e_a.float(), e_plain.float())
    print(f"phase 16 (a): openai_unet_sd {n_params / 1e6:.1f} M parameters, eps "
          f"{list(e_a.shape)} at 512^2 b2, K1 10, K2 10, {ms:.3f} ms (CUDA events, median "
          f"of 3; {card})", flush=True)

    # ---- (b) the converter's round trip ---------------------------------------------
    src, back = os.path.join(root, "sdwebui.safetensors"), os.path.join(root, "back.safetensors")
    dst = os.path.join(root, zoo.DIFFUSER_PATH["SD-v1.5"])
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    src_sd = {f"model.diffusion_model.{k}": v.float().cpu()
              for k, v in classic.state_dict().items()}
    n_bytes, dt = _synced(loader.save_safetensors, src, src_sd)
    print(f"phase 16 (b): sdwebui source {len(src_sd)} tensors, {n_bytes / 1e9:.3f} GB fp32 "
          f"written in {dt:.2f} s", flush=True)
    cli("sdwebui_diffuser", src, dst)
    diffuser = build_model(config.model_cfg("openai_unet_2d_v1"), policy=BF16, device="cuda",
                           generator=seeded(162))
    params = loader.diffuser_sd_to_params(loader.load_sd_file(dst))
    diffuser.load_state_dict({k[len("image."):]: v for k, v in params.items()}, strict=True)
    e_b = counted("converted eps", lambda: diffuser(x, t, ctx, self_attn_fn=fa.self_attn_fn),
                  k1k2)
    rel, exact = rel_l2(e_b.float(), e_a.float()), torch.equal(e_b, e_a)
    print(f"phase 16 (b): the converted openai_unet_2d_v1's eps against openai_unet_sd's: "
          f"rel_l2 {rel:.3e} (limit 1e-3), bit-exact {exact}", flush=True)
    if not rel <= 1e-3:
        raise AssertionError(f"phase 16 (b): the converted diffuser's eps is off by {rel}")
    cli("sdwebui_diffuser", dst, back, "--reverse")
    got = loader.load_sd_file(back)
    if set(got) != set(src_sd) or not all(torch.equal(got[k], v) for k, v in src_sd.items()):
        raise AssertionError("phase 16 (b): --reverse does not give the source's tensors back")
    print(f"phase 16 (b): --reverse gives the source's {len(got)} tensors back bit for bit",
          flush=True)
    del diffuser, got, src_sd, e_b

    # ---- (c) serve the converted weights ----------------------------------------------
    pipe = PromptFreeDiffusionPipeline(fp16=True, device="cuda", seed=0, with_control=False,
                                       pretrained_root=root, tag_diffuser="Deliberate-v2.0",
                                       self_attn_fn=fa.self_attn_fn)
    dezero_(pipe.net, seeded(1))
    _, dt = _synced(pipe.action_load_diffuser, "SD-v1.5")
    check_part("phase 16 (c) action_load_diffuser('SD-v1.5')", pipe.net.diffuser, params)
    del params
    _, dt_w = _synced(pipe.warmup, with_control=False, steps=10)
    ref = np.random.default_rng(0).random((512, 512, 3), dtype=np.float32)
    want = {k: v for k, v in LaunchPlan(pipe.net).expected(steps=10).items()
            if k in ("flash_attention", "cross_attention")}
    outs = []
    for label in ("converted request", "converted request again"):
        [img], st = serve_graphed(pipe, ref, 42, 10, f"phase 16 (c) {label}")
        check_image(img, label)
        got = {k: st["launches"][k] for k in want}
        if got != want:
            raise AssertionError(f"phase 16 (c) {label}: launches {got}, want {want}")
        outs.append((img, st["s"]))
    served["converted request"] = st["launches"]
    if not np.array_equal(outs[0][0], outs[1][0]):
        raise AssertionError("phase 16 (c): the request does not repeat bit for bit")
    print(f"phase 16 (c): the converted SD-v1.5 swapped in ({dt:.2f} s), 10-step bucket "
          f"captured ({dt_w:.2f} s), 512^2 b1 CFG 2.0: {outs[0][1]:.4f} s/img, again "
          f"{outs[1][1]:.4f} (bit for bit), K1 {want['flash_attention']}, K2 "
          f"{want['cross_attention']}, image mean {outs[0][0].mean():.4f} ({card})", flush=True)
    del pipe, outs
    torch.cuda.empty_cache()

    # ---- (d) openai_unet_dual_context ---------------------------------------------------
    dual = dezero_(build_model({"type": "openai_unet_dual_context", "args": sd_cfg["args"]},
                               policy=BF16, device="cuda", generator=seeded(163)), seeded(164))
    missing, unexpected = dual.load_state_dict(
        {classic_to_dual_key(k, 0): v for k, v in classic.state_dict().items()}, strict=False)
    if unexpected or not missing or not all("_1." in k for k in missing):
        raise AssertionError(f"phase 16 (d): branch 0 does not take the classic UNet's keys "
                             f"({len(missing)} missing, {unexpected[:3]} unexpected)")
    e_d = counted("dual_context eps", lambda: dual(x, t, [ctx, ctx2], which=0.5,
                                                   self_attn_fn=fa.self_attn_fn),
                  {"flash_attention": 20, "cross_attention": 20})
    with torch.no_grad():
        e_dp = dual(x, t, [ctx, ctx2], which=0.5)
    compare_eps("phase 16 (d) dual_context eps at which=0.5, kernels vs plain attention",
                e_d.float(), e_dp.float())
    e_d0 = counted("dual_context eps which=0",
                   lambda: dual(x, t, ctx, which=0, self_attn_fn=fa.self_attn_fn), k1k2)
    if not torch.equal(e_d0, e_a):
        raise AssertionError("phase 16 (d): which=0 is not the classic UNet of branch 0's "
                             "weights bit for bit")
    n_dual = sum(p.numel() for p in dual.parameters())
    print(f"phase 16 (d): openai_unet_dual_context {n_dual / 1e6:.1f} "
          f"M parameters; which=0.5 over two 148x768 contexts: K1 20, K2 20; which=0 equals "
          f"openai_unet_sd with branch 0's weights bit for bit", flush=True)
    del dual, classic, e_a, e_plain, e_d, e_dp, e_d0
    torch.cuda.empty_cache()

    # ---- (e) the other nine names, fp32, the card against the host -------------------------
    # At the CPU tests' 32 channels openai_unet_0d's first level normalises
    # groups of one value (32 channels of a 1x1 map in 32 groups): GroupNorm
    # gives x - mean = 0 there on the host, and on the card ATen's fold of the
    # mean into an affine shift leaves its rounding, times 1/sqrt(1e-6). That
    # row is printed, not held; the name is held at 64 channels (groups of two)
    cases = dict(TINY_CASES, **{"openai_unet_0d 64 channels": (
        "openai_unet_0d", dict(TINY_0D, model_channels=64), "vector", {})})
    unheld = {"openai_unet_0d"}
    rows = {}
    for i, (label, (name, args, kind, kw)) in enumerate(cases.items()):
        host = build_model({"type": name, "args": args}, policy=FP32, device="cpu",
                           generator=np.random.default_rng(170 + i))
        dezero_(host, torch.Generator().manual_seed(170 + i))
        dev = copy.deepcopy(host).to("cuda")
        inputs = tiny_inputs(kind, 170 + i)
        want_h = tiny_forward(host, kind, inputs, kw)
        got_d = tiny_forward(dev, kind, inputs, kw)
        rows[label] = rel_l2(got_d, want_h)
        if label in unheld:
            print(f"phase 16 (e) {label} (not held): {rows[label]:.3e} of the host; first "
                  f"module off by 1e-6: {first_divergence(host, dev, kind, inputs, kw)}",
                  flush=True)
        if not (torch.isfinite(got_d).all() and want_h.abs().max() > 1e-2
                and (rows[label] <= 1e-5 or label in unheld)):
            raise AssertionError(f"phase 16 (e) {label}: the card's output is off the host's "
                                 f"by {rows[label]}; first module off by 1e-6: "
                                 f"{first_divergence(host, dev, kind, inputs, kw)}")
    names = {v[0] for v in cases.values()}
    print(json.dumps({"phase": 16, "card_vs_host_rel_l2": rows, "names": len(names),
                      "not_held": sorted(unheld), "card": card}), flush=True)
    print(f"phase 16 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return served


# ---- 17. the multi-device path, the VAE lab and the golden harness -------------

MESH_LAYOUTS = {"dp2": (2, 1, 1), "tp2": (1, 1, 2), "sp2": (1, 2, 1)}  # (dp, sp, tp)
# an eps call at 512^2 (b2): ds1 and ds2 hold 10 transformer blocks at S >= 1024.
# tp2 and dp2 run them all on every rank; split over 'seq' each self-attention
# is a rank's queries over the gathered keys, which K2 takes (Sq != Skv)
MESH_LAUNCHES = {"dp2": {"flash_attention": 10, "cross_attention": 10},
                 "tp2": {"flash_attention": 10, "cross_attention": 10},
                 "sp2": {"flash_attention": 0, "cross_attention": 20}}


def write_golden_assets(assets):
    """Synthetic images at golden cases 0's and 7's asset paths (an RGB
    reference with structure and a canny-like hint of white lines at the
    case's size) and an anime negative context (``assets/anime_ug.pth``)."""
    import numpy as np
    import torch
    from PIL import Image

    from pfd_tpu_torch.tools.golden_examples import EXAMPLES
    rng = np.random.default_rng(17)
    for i in (0, 7):
        im_p, ctl_p, _, _, h, w = EXAMPLES[i][:6]
        yy, xx = np.mgrid[0:512, 0:512] / 512.0
        ref = np.stack([np.sin(6 * xx + i), np.cos(5 * yy), xx * yy], -1) * 0.4 + 0.5
        ref = ref + 0.05 * rng.standard_normal(ref.shape)
        hint = np.zeros((h, w, 3))
        for _ in range(12):
            r, c0 = rng.integers(0, h), rng.integers(0, w // 2)
            hint[r, c0:c0 + w // 3] = 1.0
            c, r0 = rng.integers(0, w), rng.integers(0, h // 2)
            hint[r0:r0 + h // 3, c] = 1.0
        for rel, arr in ((im_p, ref), (ctl_p, hint)):
            path = os.path.join(assets, rel)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            Image.fromarray((np.clip(arr, 0, 1) * 255).astype(np.uint8)).save(path)
    os.makedirs(os.path.join(assets, "assets"), exist_ok=True)
    torch.save(torch.from_numpy(rng.standard_normal((4, 768)).astype(np.float32)),
               os.path.join(assets, "assets", "anime_ug.pth"))


def multi_card(card, mufu_rate, gen):
    """Phase 17 (module docstring), its files in a temporary root (removed
    at the end). Returns (K1 rows, K2 rows, {request: launches})."""
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="pfd_mesh_")
    try:
        return _multi_card(card, mufu_rate, gen, root)
    finally:
        shutil.rmtree(root)


def _multi_card(card, mufu_rate, gen, root):
    import numpy as np
    import torch
    import torch.distributed as dist
    from pfd_tpu_torch.models.build import dezero_
    from pfd_tpu_torch.ops import flash_attention as fa
    from pfd_tpu_torch.parallel import distributed, sharding
    from pfd_tpu_torch.parallel.mesh import make_mesh
    from pfd_tpu_torch.policy import BF16, FP32
    from pfd_tpu_torch.tools import golden_examples, mesh_check, vae_lab

    t_phase = time.perf_counter()
    print(f"phase 17: {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated at its start "
          f"({card})", flush=True)
    served = {}

    def counted(label, fn):
        torch.cuda.synchronize()
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        served[label] = launch_counts()
        return out

    # ---- the kernels at the shapes the mesh gives them ----------------------------
    k1_rows = [check_kernel("K1", fa.flash_attention, (2, 4, 4096, 40), 4096, mufu_rate, gen)]
    k2_rows = [check_kernel("K2", fa.cross_attention, s, skv, mufu_rate, gen,
                            fa.cross_variant(s[0] * s[1], s[2], skv, s[3],
                                             torch.cuda.get_device_properties(0)
                                             .multi_processor_count))
               for s, skv in (((2, 8, 2048, 40), 4096), ((2, 8, 512, 80), 1024))]

    # ---- (a) the VAE lab's rows at b8, 512^2 ------------------------------------------
    t0 = time.perf_counter()
    ms, lab_launches, images = vae_lab.run(8, 512, 3)
    for row, img in images.items():
        n = lab_launches[row]
        if not (torch.isfinite(img.float()).all() and n.get("flash_attention", 0) >= 1
                and (n.get("conv_int8", 0) > 0) == row.startswith("int8")):
            raise AssertionError(f"phase 17 (a) {row}: launches {n}, finite "
                                 f"{bool(torch.isfinite(img.float()).all())}")
        served[f"vae_lab {row}"] = {k: n.get(k, 0) for k in fa.SERVING}
    del images
    torch.cuda.empty_cache()
    print(json.dumps({"phase": 17, "vae_lab": {f"vae_decode_ms_{k}": v for k, v in ms.items()},
                      "batch": 8, "size": 512, "launches": lab_launches, "card": card}),
          flush=True)
    print(f"phase 17 (a) took {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- (b) the golden harness: tiny, then full width on synthetic assets ------------
    t0 = time.perf_counter()
    tiny = golden_examples.pipeline(os.path.join(root, "tiny"), tiny_smoke=True)
    for record in (True, False):
        res = golden_examples.run(None, os.path.join(root, "tiny"),
                                  os.path.join(root, "goldens_tiny"), record=record,
                                  tiny_smoke=True, cases=[0, 7], pipe=tiny)
    if not all(r["ssim"] == 1.0 for r in res.values()):
        raise AssertionError(f"phase 17 (b) tiny: {res}")
    del tiny
    assets, empty = os.path.join(root, "assets"), os.path.join(root, "pretrained")
    os.makedirs(empty)
    write_golden_assets(assets)
    pipe = golden_examples.pipeline(empty, self_attn_fn=fa.self_attn_fn)
    dezero_(pipe.net, torch.Generator(device="cuda").manual_seed(1))
    served_imgs, infer = [], pipe.action_inference

    def keep(*args, **kw):  # the harness keeps no compare image: keep each one here
        out = infer(*args, **kw)
        served_imgs.append(np.asarray(out[0]))
        return out

    pipe.action_inference = keep
    golden = {}
    for record in (True, False):
        for i in (0, 7):
            t1 = time.perf_counter()
            res = counted(f"golden {i} {'record' if record else 'compare'}",
                          lambda: golden_examples.run(assets, empty, os.path.join(root, "goldens"),
                                                      record=record, cases=[i], pipe=pipe))
            golden.setdefault(i, {})["record_s" if record else "s_per_img"] = (
                time.perf_counter() - t1)
            if not record:
                golden[i]["ssim"] = res[i]["ssim"]
    for i in (0, 7):
        img = np.load(os.path.join(root, "goldens", f"example_{i:02d}.npy"))
        h, w = golden_examples.EXAMPLES[i][4:6]
        golden[i]["shape"] = list(img.shape)
        if not (img.shape == (h, w, 3) and np.isfinite(img).all() and img.std() > 0.01
                and golden[i]["ssim"] >= 0.95):
            raise AssertionError(f"phase 17 (b) case {i}: {golden[i]}")
    # served in the order record 0, record 7, compare 0, compare 7
    for i, (rec, cmp) in zip((0, 7), zip(served_imgs[:2], served_imgs[2:])):
        golden[i]["bit_for_bit"] = bool(np.array_equal(rec, cmp))
    del pipe.action_inference  # no cycle through the bound method: the pool frees now
    del pipe, infer, keep, served_imgs
    torch.cuda.empty_cache()
    print(json.dumps({"phase": 17, "golden_fp16_full_width": golden, "card": card}), flush=True)
    print(f"phase 17 (b) took {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- (c) the mesh at world size 1 over NCCL -----------------------------------------
    t0 = time.perf_counter()
    mroot = os.path.join(root, "mesh")
    os.makedirs(mroot)
    cfg = mesh_check.default_cfg()
    e_one, loss1, gnorm1, params1, s1 = counted(
        "mesh ws1 eps, one device",
        lambda: mesh_check.reference(mroot, cfg, 2, "cuda", BF16, fa.self_attn_fn))
    torch.cuda.empty_cache()
    ref = torch.load(os.path.join(mroot, "ref.pt"), map_location="cuda")
    distributed.initialize(f"file://{root}/nccl_store", 1, 0)
    try:
        mesh = make_mesh()
        if dist.get_backend() != "nccl" or any(g is not None for g in mesh.groups.values()):
            raise AssertionError(f"phase 17 (c): backend {dist.get_backend()}, groups "
                                 f"{mesh.groups}")
        model = mesh_check.build(cfg, BF16, 170, "cuda")
        with torch.no_grad():
            e_mesh = counted("mesh ws1 eps", lambda: sharding.apply_model(
                model, mesh, ref["x"], ref["t"], ref["c"], self_attn_fn=fa.self_attn_fn).float())
        del model
        want = {"flash_attention": 10, "cross_attention": 10}
        for label in ("mesh ws1 eps, one device", "mesh ws1 eps"):
            if {k: served[label][k] for k in want} != want:
                raise AssertionError(f"phase 17 (c) {label}: launches {served[label]}")
        if not torch.equal(e_one, e_mesh):
            raise AssertionError("phase 17 (c): the sharded eps at world size 1 is not the "
                                 f"one-device eps bit for bit "
                                 f"({(e_one - e_mesh).abs().max().item()})")
        loss_m, gnorm_m, params_m, s_m = mesh_check.one_step(
            mesh_check.build(cfg, FP32, 171, "cuda"), mesh, ref["batch"])
        bitwise = loss_m == loss1 and gnorm_m == gnorm1 and all(
            torch.equal(params_m[k].cpu(), v) for k, v in params1.items())
        diff = {"loss_rel": mesh_check.rel(loss_m, loss1),
                "grad_norm_rel": mesh_check.rel(gnorm_m, gnorm1),
                "params_rel_l2_max": mesh_check.rel_per_leaf(params_m, params1)}
        del params_m
        # the one-device step against itself: what run-to-run rounding leaves
        _, gnorm_again, params_again, _ = mesh_check.one_step(
            mesh_check.build(cfg, FP32, 171, "cuda"), "cuda", ref["batch"])
        diff["one_device_repeat_grad_norm_rel"] = mesh_check.rel(gnorm_again, gnorm1)
        diff["one_device_repeat_params_rel_l2_max"] = mesh_check.rel_per_leaf(params_again,
                                                                              params1)
        del params_again, params1
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    print(json.dumps({"phase": 17, "mesh_ws1_nccl": {
        "eps_bit_for_bit": True, "launches": served["mesh ws1 eps"], "step_bit_for_bit": bitwise,
        **diff, "loss": loss1, "grad_norm": gnorm1, "lr": mesh_check.LR,
        "step_s_one_device": s1, "step_s_mesh": s_m}, "card": card}), flush=True)
    lim = mesh_check.STEP_LIMIT
    if not (diff["loss_rel"] <= lim and diff["grad_norm_rel"] <= lim
            and diff["params_rel_l2_max"] <= lim):
        raise AssertionError(f"phase 17 (c): the sharded step at world size 1 is off the "
                             f"one-device step by {diff}")
    print(f"phase 17 (c) took {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- (d) world size 2 on the one card over gloo ---------------------------------
    t0 = time.perf_counter()
    rows = mesh_check.run(2, mroot, MESH_LAYOUTS, backend="gloo")
    print(json.dumps({"phase": 17, "mesh_ws2_gloo_one_card": rows,
                      "note": "a layout check: two processes share one card over gloo; step_s "
                              "is no speed", "card": card}), flush=True)
    for name, ranks in rows.items():
        for row in ranks:
            want = MESH_LAUNCHES[name]
            if {k: row["launches"][k] for k in want} != want:
                raise AssertionError(f"phase 17 (d) {name} rank {row['rank']}: launches "
                                     f"{row['launches']}, want {want}")
            served[f"mesh {name} rank {row['rank']}"] = row["launches"]
    mesh_check.check(rows, 2)
    print(f"phase 17 (d) took {time.perf_counter() - t0:.1f} s; phase 17 took "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return k1_rows, k2_rows, served


def main() -> int:
    import torch

    # ---- 1. device -------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "pfd_tpu_torch")):
        print("chip_smoke: pfd_tpu_torch/ not found beside chip_smoke.py", file=sys.stderr)
        return 3
    sys.path.insert(0, HERE)
    card = sh(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    card = card.splitlines()[0]
    print(card, flush=True)
    max_clock_mhz = float(sh(["nvidia-smi", "--query-gpu=clocks.max.sm",
                              "--format=csv,noheader,nounits"]).splitlines()[0])
    props = torch.cuda.get_device_properties(0)
    mufu_rate = props.multi_processor_count * MUFU_PER_SM_CLK * max_clock_mhz * 1e6
    print(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
          f"{props.multi_processor_count} SMs, max SM clock {max_clock_mhz:.0f} MHz, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    from pfd_tpu_torch.ops import cuda_build
    from pfd_tpu_torch.ops import flash_attention as fa
    print("nvcc:", sh([cuda_build.nvcc_path(), "--version"]).splitlines()[-1], flush=True)

    # ---- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    log = cuda_build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s wall", flush=True)
    for name, entry in log.items():
        print(f"build {name}: {entry['seconds']:.1f} s -> {entry['path']}", flush=True)
        for line in entry["ptxas"].splitlines():  # C7519 lines: counted below
            if "C7519" not in line and any(
                    key in line for key in ("registers", "spill", "C7515", "C7517")):
                print(f"  ptxas {name}: {line.strip()}", flush=True)
        arrives = collections.Counter(re.findall(r"\(C7519\).*?function '(\w+)'",
                                                 entry["ptxas"]))
        for fn, n in sorted(arrives.items()):
            print(f"  ptxas {name}: C7519 (warpgroup.arrive injected) x{n} in {fn}", flush=True)
        if name in GUARDED:
            spills = [int(b) for b in re.findall(r"(\d+) bytes spill stores", entry["ptxas"])]
            print(f"  ptxas {name}: {len(spills)} instantiations, spill stores {spills}, "
                  f"C7519 x{sum(arrives.values())} in all", flush=True)
            if any(spills) or "C7515" in entry["ptxas"] or "C7517" in entry["ptxas"]:
                raise AssertionError(f"build {name}: ptxas reports spills, C7515 or C7517")

    # ---- 3./4. kernels against their plain versions -------------------------
    gen = torch.Generator(device="cuda").manual_seed(0)
    k1_rows = [check_kernel("K1", fa.flash_attention, s, s[2], mufu_rate, gen)
               for s in [(2, 8, 4096, 40), (2, 8, 1024, 80), (1, 1, 4096, 512),
                         (1, 2, 1000, 40), (2, 8, 2304, 160), (2, 8, 1024, 8),
                         (1, 2, 4097, 80), (2, 8, 5184, 40), (2, 8, 1296, 80)]]
    # ToMe's merged ds1 (b1 with CFG): 2,048 tokens, its 41-wide head padded to 48
    k1_rows.append(check_kernel("K1", fa.flash_attention, (2, 8, 2048, 48), 2048, mufu_rate,
                                gen, scale=41 ** -0.5))
    sms = props.multi_processor_count
    k2_rows = [check_kernel("K2", fa.cross_attention, s, skv, mufu_rate, gen,
                            fa.cross_variant(s[0] * s[1], s[2], skv, s[3], sms))
               for s, skv in [((2, 8, 4096, 40), 148), ((2, 8, 1024, 80), 148),
                              ((1, 2, 1024, 160), 512), ((2, 8, 5184, 40), 148),
                              ((2, 8, 4096, 40), 1024), ((16, 8, 4096, 40), 148),
                              ((1, 8, 4096, 40), 1024), ((1, 8, 4096, 40), 256)]]

    check_dispatch(gen)

    # ---- 5. the slice at full width -----------------------------------------
    import numpy as np
    from pfd_tpu_torch.models.build import dezero_
    from pfd_tpu_torch.ops import kvpool
    from pfd_tpu_torch.ops import quant as tq
    from pfd_tpu_torch.pipeline import PromptFreeDiffusionPipeline

    def build_pipe(label, **kw):
        t0 = time.perf_counter()
        pipe = PromptFreeDiffusionPipeline(fp16=True, device="cuda", seed=0, **kw)
        # the hint pyramid's last conv is zero-initialised: as built, its int8
        # codes are all zero and its scale finite (float: its weight is zero)
        last = pipe.net.ctl.input_hint_block[-1]
        zero = (not torch.any(last.weight_q) and bool(torch.isfinite(last.weight_scale).all())
                if tq.is_quantized(last) else not torch.any(last.weight))
        if not zero:
            raise AssertionError(f"{label}: the hint pyramid's zero conv is not zero as built")
        dezero_(pipe.net, torch.Generator(device="cuda").manual_seed(1))
        pipe._pool.measure = True  # phase 8c's bucket costs; phase 12 captures as served
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in pipe.net.parameters())
        n_buf = sum(b.numel() for b in pipe.net.buffers())
        print(f"{label}: pfd_seecoder_with_controlnet built, {n_params / 1e6:.1f} M "
              f"parameters, {n_buf / 1e6:.1f} M buffer values, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        return pipe

    pipe = build_pipe("slice", self_attn_fn=fa.self_attn_fn)
    net = pipe.net
    ref = np.random.default_rng(0).random((512, 512, 3), dtype=np.float32)
    eager_request(pipe, ref, 0, 2)  # warm-up

    [img_a], stats_a = serve(pipe, ref, 42, 50, "A")
    launches = stats_a["launches"]
    check_image(img_a, "A")
    want = {"flash_attention": 10 * 50 + 1, "cross_attention": 10 * 50,
            "flash_attention_pv8": 0, "flash_attention_int8": 0, "conv_int8": 0}
    if launches != want:
        raise AssertionError(f"request A: launches {launches}, want {want}")
    print(f"request A: image mean {img_a.mean():.4f} std {img_a.std():.4f}", flush=True)

    t0 = time.perf_counter()
    img_b = eager_request(pipe, ref, 42, 50)[0]
    s_b = time.perf_counter() - t0
    if not np.array_equal(img_a, img_b):
        raise AssertionError("request B (same as A) is not bit-identical")
    img_c = eager_request(pipe, ref, 7, 10)[0]
    if np.array_equal(img_a, img_c) or not np.isfinite(img_c).all():
        raise AssertionError("request C (other seed, 10 steps) did not differ")
    print(f"request B: bit-identical to A, s_per_img={s_b:.4f}; request C: differs "
          f"(max |C-A| {np.abs(img_c - img_a).max():.4f})", flush=True)

    # one UNet call through the kernels against the same call through plain attention
    with torch.no_grad():
        c = pipe.encode_context(ref)
        c2 = torch.cat([torch.zeros_like(c), c])
        x = torch.randn((2, 4, 64, 64), generator=gen, device="cuda")
        t = torch.full((2,), 501, device="cuda", dtype=torch.long)
        xi, ci = {"type": "image", "x": x}, {"type": "image", "c": c2}
        e_k = net.apply_model(xi, t, ci, self_attn_fn=fa.self_attn_fn).float()
        e_p = net.apply_model(xi, t, ci, self_attn_fn=None).float()
    compare_eps("unet eps, kernels vs plain attention at 512^2", e_k, e_p)
    profile_unet("unet call profile", lambda: net.apply_model(
        xi, t, ci, self_attn_fn=fa.self_attn_fn))

    # request F: the ControlNet path, a canny hint
    hint_src = hint_image()
    eager_request(pipe, ref, 0, 2, hint_src)  # warm-up
    [img_f, hint_f], stats_f = serve(pipe, ref, 42, 50, "F", hint_src)
    launches_f = stats_f["launches"]
    check_image(img_f, "F")
    edges = float((hint_f[..., 0] > 0).mean())
    print(f"request F: hint edge fraction {edges:.5f} (limit [0.003, 0.02])", flush=True)
    if not 0.003 <= edges <= 0.02:
        raise AssertionError(f"request F: hint edge fraction {edges}")
    want = {"flash_attention": 14 * 50 + 1, "cross_attention": 14 * 50,
            "flash_attention_pv8": 0, "flash_attention_int8": 0, "conv_int8": 0}
    if launches_f != want:
        raise AssertionError(f"request F: launches {launches_f}, want {want}")
    if np.array_equal(img_f, img_a):
        raise AssertionError("request F (with a hint) did not differ from A")
    img_f2 = eager_request(pipe, ref, 42, 50, hint_src)[0]
    if not np.array_equal(img_f, img_f2):
        raise AssertionError("request F' (same as F) is not bit-identical")
    print(f"request F': bit-identical to F; F image mean {img_f.mean():.4f} std "
          f"{img_f.std():.4f}, mean |F-A| {np.abs(img_f - img_a).mean():.5f}", flush=True)

    # one ControlNet call through the kernels against the same call through
    # plain attention, then the eps with its residuals (the hoisted embedding)
    with torch.no_grad():
        h1 = torch.as_tensor(hint_f.transpose(2, 0, 1).copy(), device="cuda")[None]
        hint2 = torch.cat([h1, h1])
        r_k = net.ctl(x, hint2, t, c2, self_attn_fn=fa.self_attn_fn)
        r_p = net.ctl(x, hint2, t, c2, self_attn_fn=None)
        rels = [((a.float() - b.float()).norm() / b.float().norm()).item()
                for a, b in zip(r_k, r_p)]
        emb = net.ctl.hint_embed(h1)
        ci_ctl = {"type": "image", "c": c2, "control_embed": torch.cat([emb, emb])}
        e_k = net.apply_model(xi, t, ci_ctl, self_attn_fn=fa.self_attn_fn).float()
        e_p = net.apply_model(xi, t, ci_ctl, self_attn_fn=None).float()
    print(f"controlnet residuals, kernels vs plain attention at 512^2: {len(rels)}, "
          f"rel_l2 max {max(rels):.3e} ({', '.join(f'{r:.2e}' for r in rels)})", flush=True)
    if len(rels) != 13 or not max(rels) < 5e-2:
        raise AssertionError(f"controlnet residuals: rel_l2 {rels}")
    compare_eps("unet + controlnet eps, kernels vs plain attention at 512^2", e_k, e_p)
    profile_unet("unet + controlnet step profile", lambda: net.apply_model(
        xi, t, ci_ctl, self_attn_fn=fa.self_attn_fn))

    # ---- 6. K4 and K5 against their plain versions ----------------------------
    # the serving shapes, then pfd_tpu's own test shapes for its float bounds
    int8_shapes = [(2, 8, 4096, 40), (2, 8, 1024, 80), (1, 2, 1000, 40), (2, 8, 2304, 160),
                   (2, 3, 256, 40), (2, 3, 520, 80)]
    k4_rows = [check_int8_attention("K4", "pv", s, mufu_rate, gen) for s in int8_shapes]
    k5_rows = [check_int8_attention("K5", True, s, mufu_rate, gen) for s in int8_shapes]

    # ---- 7. the int8 conv against its plain version, bit for bit -------------
    conv_rows = [check_conv(*case, gen) for case in [
        ("3x3s1 (2,320,64,64)->320", (2, 320, 64, 64), 320, 3, 1, 1),
        ("3x3s1 (2,640,32,32)->640", (2, 640, 32, 32), 640, 3, 1, 1),
        ("3x3s1 (2,1280,16,16)->1280", (2, 1280, 16, 16), 1280, 3, 1, 1),
        ("3x3s1 (2,1280,8,8)->1280", (2, 1280, 8, 8), 1280, 3, 1, 1),
        ("3x3s2 (2,320,64,64)->320", (2, 320, 64, 64), 320, 3, 2, 1),
        ("phase2x2 (2,1280,8,8)->5120", (2, 1280, 8, 8), 4 * 1280, 2, 1, 1),
        ("phase2x2 (2,1280,16,16)->5120", (2, 1280, 16, 16), 4 * 1280, 2, 1, 1),
        ("phase2x2 (2,640,32,32)->2560", (2, 640, 32, 32), 4 * 640, 2, 1, 1),
        ("vae 3x3s1 (1,128,512,512)->128", (1, 128, 512, 512), 128, 3, 1, 1),
        ("vae 3x3s1 (1,512,64,64)->512", (1, 512, 64, 64), 512, 3, 1, 1),
        ("hint 3x3s1 (1,96,128,128)->96", (1, 96, 128, 128), 96, 3, 1, 1),
        ("hint 3x3s2 (1,96,128,128)->256", (1, 96, 128, 128), 256, 3, 2, 1),
        ("hint 3x3s1 (1,256,64,64)->320", (1, 256, 64, 64), 320, 3, 1, 1),
    ]]

    # ---- 8. the int8 serving mode at full width --------------------------------
    pipe8 = build_pipe("int8 slice", quantized=True, self_attn_fn=fa.self_attn_fn_int8)
    net8 = pipe8.net
    per_unet = sum(tq.is_quantized(m) for m in net8.diffuser["image"].modules())
    per_decode = sum(tq.is_quantized(m) for m in net8.vae["image"].decoder.modules())
    per_hint = sum(tq.is_quantized(m) for m in net8.ctl.input_hint_block)
    per_ctl = sum(tq.is_quantized(m) for m in net8.ctl.modules()) - per_hint
    n_conv = 50 * per_unet + per_decode
    n_conv_g = 10 * (per_unet + per_ctl) + per_hint + per_decode
    print(f"int8 plan: {per_unet} int8 convs per UNet call, {per_ctl} per ControlNet "
          f"call, {per_hint} in its hint pyramid, {per_decode} in the VAE decoder -> "
          f"{n_conv} conv_int8 launches in 50 steps, {n_conv_g} in 10 with a hint",
          flush=True)
    if (per_unet, per_ctl, per_hint, per_decode) != (50, 23, 3, 31):
        raise AssertionError(f"int8 plan: want 50 convs per UNet call, 23 per ControlNet "
                             f"call, 3 in its hint pyramid and 31 in the decoder, got "
                             f"{per_unet}, {per_ctl}, {per_hint} and {per_decode}")
    eager_request(pipe8, ref, 0, 2)  # warm-up

    [img_d], stats_d = serve(pipe8, ref, 42, 50, "D")
    launches_d = stats_d["launches"]
    check_image(img_d, "D")
    want = {"flash_attention": 1, "cross_attention": 10 * 50,
            "flash_attention_pv8": 10 * 50, "flash_attention_int8": 0, "conv_int8": n_conv}
    if launches_d != want:
        raise AssertionError(f"request D: launches {launches_d}, want {want}")
    img_d2 = eager_request(pipe8, ref, 42, 50)[0]
    if not np.array_equal(img_d, img_d2):
        raise AssertionError("request D' (same as D) is not bit-identical")
    print(f"request D': bit-identical to D; D image mean {img_d.mean():.4f} std "
          f"{img_d.std():.4f}; mean |D-A| {np.abs(img_d - img_a).mean():.5f} "
          f"max |D-A| {np.abs(img_d - img_a).max():.4f} (information only)", flush=True)

    lp8 = LaunchPlan(net8)
    full8 = functools.partial(fa.self_attn_fn_int8, mode="full")
    with knobs(pipe8, self_attn_fn=full8):
        [img_e], stats_e = serve(pipe8, ref, 42, 10, "E")
    launches_e = stats_e["launches"]
    check_image(img_e, "E")
    want = lp8.expected(steps=10, quantized=True, attn8="full")
    if launches_e != want or want["flash_attention_int8"] != 10 * 10:
        raise AssertionError(f"request E: launches {launches_e}, want {want} (K5 100)")

    # request G: the int8 ControlNet path, F's hint
    eager_request(pipe8, ref, 0, 2, hint_src)  # warm-up
    [img_g, hint_g], stats_g = serve(pipe8, ref, 42, 10, "G", hint_src)
    launches_g = stats_g["launches"]
    check_image(img_g, "G")
    want = {"flash_attention": 1, "cross_attention": 14 * 10, "flash_attention_pv8": 14 * 10,
            "flash_attention_int8": 0, "conv_int8": n_conv_g}
    if launches_g != want:
        raise AssertionError(f"request G: launches {launches_g}, want {want}")
    if not np.array_equal(hint_g, hint_f):
        raise AssertionError("request G: its hint differs from F's")
    print(f"request G: image mean {img_g.mean():.4f} std {img_g.std():.4f}", flush=True)

    with torch.no_grad():
        e_k = net8.apply_model(xi, t, ci, self_attn_fn=fa.self_attn_fn_int8).float()
        with plain_versions():
            e_p = net8.apply_model(xi, t, ci, self_attn_fn=fa.self_attn_fn_int8).float()
    compare_eps("int8 unet eps, kernels vs plain versions at 512^2", e_k, e_p)
    profile_unet("int8 unet call profile", lambda: net8.apply_model(
        xi, t, ci, self_attn_fn=fa.self_attn_fn_int8))
    # with the ControlNet, from the raw hint (its int8 hint pyramid too): the
    # int8 conv's plain version in place of the kernel must give the same eps
    # bit for bit. Against every plain version the eps may be off by 5e-2
    # relative L2, as the UNet's, or by the int8 function's own spread where
    # that is larger: the plain versions with K4's plain version on
    # pfd_tpu's 1,024-key tile against on K4's (int8 codes flip under
    # last-bit differences, and p8 under another running max)
    ci_hint = {"type": "image", "c": c2, "control": hint2}
    with torch.no_grad():
        e_k = net8.apply_model(xi, t, ci_hint, self_attn_fn=fa.self_attn_fn_int8).float()
        with plain_versions(attention=False):
            e_c = net8.apply_model(xi, t, ci_hint, self_attn_fn=fa.self_attn_fn_int8).float()
        with plain_versions():
            e_p = net8.apply_model(xi, t, ci_hint, self_attn_fn=fa.self_attn_fn_int8).float()
        with plain_versions(pv8_block_k=1024):
            e_t = net8.apply_model(xi, t, ci_hint, self_attn_fn=fa.self_attn_fn_int8).float()
        emb8 = net8.ctl.hint_embed(h1)
    if not torch.equal(e_k, e_c):
        raise AssertionError("int8 unet + controlnet eps: the int8 conv kernel inside the "
                             "call is not bit-exact against its plain version")
    rel = ((e_k - e_p).norm() / e_p.norm()).item()
    spread = ((e_t - e_p).norm() / e_p.norm()).item()
    print(f"int8 unet + controlnet eps at 512^2: conv_int8 kernel vs plain version "
          f"bit-exact; kernels vs plain versions rel_l2={rel:.3e} "
          f"max_abs={(e_k - e_p).abs().max().item():.3e} (limit {max(5e-2, spread):.3e}: "
          f"the plain versions on a 1,024-key tile vs on K4's rel_l2={spread:.3e})",
          flush=True)
    if not rel <= max(5e-2, spread):
        raise AssertionError(f"int8 unet + controlnet eps: rel_l2 {rel}, spread {spread}")
    ci_ctl8 = {"type": "image", "c": c2, "control_embed": torch.cat([emb8, emb8])}
    profile_unet("int8 unet + controlnet step profile", lambda: net8.apply_model(
        xi, t, ci_ctl8, self_attn_fn=fa.self_attn_fn_int8))

    # one line of throughput: 8 images of 10 steps per request
    b8 = {}
    for label, p in (("bf16", pipe), ("int8", pipe8)):
        p.n_sample_image = 8
        eager_request(p, ref, 0, 2)  # warm-up
        _, st = serve(p, ref, 42, 10, f"{label} b8")
        p.n_sample_image = 1
        b8[label] = st["s_per_img"] / 8
    print(f"throughput b8 10 steps 512^2: bf16 {b8['bf16']:.4f} s/img, int8 "
          f"{b8['int8']:.4f} s/img, int8/bf16 {b8['int8'] / b8['bf16']:.3f}", flush=True)
    xi8 = {"type": "image", "x": x.repeat(8, 1, 1, 1)}
    ci8, t8 = {"type": "image", "c": c2.repeat(8, 1, 1)}, t.repeat(8)
    profile_unet("b8 unet call profile, bf16", lambda: net.apply_model(
        xi8, t8, ci8, self_attn_fn=fa.self_attn_fn))
    profile_unet("b8 unet call profile, int8", lambda: net8.apply_model(
        xi8, t8, ci8, self_attn_fn=fa.self_attn_fn_int8))

    # ---- 8b. the turbo serving modes at full width ----------------------------
    lp = LaunchPlan(net)
    ph_h, ph_j = [(8, 2), (42, 21)], [(10, 2), (40, 20)]
    turbo_served = {}

    def request(p, label, want, imctl=None, steps=50, **kw):
        """One request with the pipeline's turbo knobs set to ``kw``; its
        image(s) and stats; it must launch exactly ``want``."""
        with knobs(p, **kw):
            out, st = serve(p, ref, 42, steps, label, imctl)
        for img in out[:p.n_sample_image]:
            check_image(img, label)
        if st["launches"] != want:
            raise AssertionError(f"request {label}: launches {st['launches']}, want {want}")
        turbo_served[label] = st["launches"]
        return out, st

    print(f"turbo plan: long transformer blocks a call {json.dumps(lp.calls)}, ControlNet "
          f"{dict(lp.ctl)}; int8 convs a call {json.dumps(lp8.calls)}", flush=True)
    [img_h], st_h = request(pipe, "H", lp.expected(phases=ph_h), phases=ph_h)
    if np.array_equal(img_h, img_a):
        raise AssertionError("request H (phased turbo) did not differ from A")
    [img_h2], st_h2 = request(pipe, "H'", lp.expected(phases=ph_h), phases=ph_h)
    if not np.array_equal(img_h, img_h2):
        raise AssertionError("request H' (same as H) is not bit-identical")
    _, st_a2 = serve(pipe, ref, 42, 50, "A2")
    [img_hkv], st_hkv = request(pipe, "H_kv", lp.expected(kv=True, phases=ph_h), phases=ph_h,
                                kv_pool=2)
    [img_ht], st_ht = request(pipe, "H_tome", lp.expected(), tome_ratio=0.5)
    print(f"request H': bit-identical to H; mean |H-A| {np.abs(img_h - img_a).mean():.5f}, "
          f"|H_kv-H| {np.abs(img_hkv - img_h).mean():.5f}, |H_tome-A| "
          f"{np.abs(img_ht - img_a).mean():.5f}", flush=True)
    # H's final latent through the kernels against H through plain attention
    with torch.no_grad():
        cc = pipe.encode_context(ref)
        ci_req = {"conditioning": cc, "unconditional_conditioning": torch.zeros_like(cc),
                  "unconditional_guidance_scale": 2.0}
        x0 = torch.randn((1, 4, 64, 64), generator=torch.Generator(device="cuda").manual_seed(42),
                         device="cuda")
        lat = {name: pipe.sampler.sample_fn(x0, ci_req, pipe.sampler.make_tables(50),
                                            self_attn_fn=attn, phases=ph_h)[0].float()
               for name, attn in (("kernels", fa.self_attn_fn), ("plain", None))}
    compare_eps("request H's final latent, kernels vs plain attention", lat["kernels"],
                lat["plain"])

    [img_i], st_i = request(pipe8, "I", lp8.expected(quantized=True, attn8=True, phases=ph_h),
                            phases=ph_h)
    [img_j, hint_j], st_j = request(pipe, "J", lp.expected(control=True, phases=ph_j), hint_src,
                                    phases=ph_j, control_turbo=True)
    if np.array_equal(img_j, img_f) or not np.array_equal(hint_j, hint_f):
        raise AssertionError("request J: its image does not differ from F or its hint does")
    [img_j0, _], st_j0 = request(pipe, "J0", lp.expected(control=True), hint_src, phases=ph_j,
                                 control_turbo=False)
    if not np.array_equal(img_j0, img_f):
        raise AssertionError("request J0 (control_turbo=False) is not F bit for bit")
    print(f"request J0: the exact-control guard holds (F bit for bit); mean |J-F| "
          f"{np.abs(img_j - img_f).mean():.5f}; I image mean {img_i.mean():.4f}", flush=True)

    # a key step (the CFG-doubled call, split at the DeepCache cut) and a
    # reuse step (the shallow suffix on the cached state, the conditional half)
    n_sh = net.deep_split_skips("image")
    kv2 = kvpool.make_kvpool_attn(fa.self_attn_fn, (64, 64), pool=2)
    with torch.no_grad():
        h_mid, hs = net.apply_model_encoder(xi, t, ci, self_attn_fn=fa.self_attn_fn)
        h_deep = net.apply_model_decoder_deep(h_mid, hs[n_sh:], t, ci,
                                              self_attn_fn=fa.self_attn_fn)
    ci_1, hs_1 = {"type": "image", "c": c}, tuple(a[1:] for a in hs[:n_sh])

    def key_step():
        h0, s0 = net.apply_model_encoder(xi, t, ci, self_attn_fn=fa.self_attn_fn)
        d0 = net.apply_model_decoder_deep(h0, s0[n_sh:], t, ci, self_attn_fn=fa.self_attn_fn)
        return net.apply_model_decoder_shallow(d0, s0[:n_sh], t, ci,
                                               self_attn_fn=fa.self_attn_fn)

    def reuse_step(reuse):
        return net.apply_model_decoder_shallow(h_deep[1:], hs_1, t[1:], ci_1,
                                               self_attn_fn=fa.self_attn_fn if reuse is None
                                               else reuse)

    busy = {"key": profile_unet("turbo key step profile", key_step)[1],
            "reuse": profile_unet("turbo reuse step profile", lambda: reuse_step(None))[1],
            "reuse_kv2": profile_unet("turbo reuse step profile, kv2",
                                      lambda: reuse_step(kv2))[1]}
    print(f"turbo b1 512^2 50 steps: s/img A2 {st_a2['s_per_img']:.4f} (A "
          f"{stats_a['s_per_img']:.4f}), H {st_h['s_per_img']:.4f}, H' {st_h2['s_per_img']:.4f}, "
          f"H_kv {st_hkv['s_per_img']:.4f}, H_tome {st_ht['s_per_img']:.4f}, I "
          f"{st_i['s_per_img']:.4f}, J {st_j['s_per_img']:.4f} (F {stats_f['s_per_img']:.4f}); "
          f"busy ms a key step {busy['key']:.3f}, a reuse step {busy['reuse']:.3f}, with kv2 "
          f"{busy['reuse_kv2']:.3f}", flush=True)

    # 8 images of 50 steps per request: the exact sampler against the turbos
    b8t, b8_imgs = {}, {}
    for label, p, lpp, q in (("int8", pipe8, lp8, True), ("bf16", pipe, lp, False)):
        p.n_sample_image = 8
        for kv in (0, 2):  # warm-up: the turbos' batch-8 shapes
            p.phases, p.kv_pool = [(2, 2)], kv
            eager_request(p, ref, 0, 2)
        p.phases, p.kv_pool = None, 0
        modes = {"exact": {}, "ph8x2_42x21": {"phases": ph_h}}
        if q:
            modes["ph8x2_42x21_kv2"] = {"phases": ph_h, "kv_pool": 2}
        for mode, kw in modes.items():
            want = lpp.expected(quantized=q, attn8=q, kv=bool(kw.get("kv_pool")),
                                phases=kw.get("phases"))
            out, st = request(p, f"{label} b8 {mode}", want, **kw)
            b8t[f"{label}_{mode}"] = st["s_per_img"] / 8
            b8_imgs[f"{label}_{mode}"] = out
        p.n_sample_image = 1
    print(f"throughput b8 50 steps 512^2, s/img: {json.dumps(b8t)}; int8 exact / "
          f"ph8x2_42x21 {b8t['int8_exact'] / b8t['int8_ph8x2_42x21']:.3f}, / kv2 "
          f"{b8t['int8_exact'] / b8t['int8_ph8x2_42x21_kv2']:.3f}; bf16 exact / ph8x2_42x21 "
          f"{b8t['bf16_exact'] / b8t['bf16_ph8x2_42x21']:.3f}", flush=True)

    # ---- 8c. the compiled hot path: one CUDA graph a bucket -------------------
    eager_imgs = {"A": [img_a], "D": [img_d], "E": [img_e], "F": [img_f], "G": [img_g],
                  "H": [img_h], "H_kv": [img_hkv], "H_tome": [img_ht], "I": [img_i],
                  "J": [img_j], "J0": [img_j0],
                  **{f"{q} b8 ph8x2_42x21": b8_imgs[f"{q}_ph8x2_42x21"] for q in ("int8", "bf16")}}
    graph_served = compiled_hot_path(card, pipe, pipe8, ref, hint_src, lp, lp8, eager_imgs,
                                     full8)

    # ---- 9. K3, K6 and K7b against their plain versions ----------------------
    # At B = 2 and at the labs' own shapes (LAB_BATCH / AUDIT_BATCH 16):
    # attn_lab's two attention shapes, perf_audit's three fused shapes and
    # int8_lab's two bf16 conv shapes.
    k3_rows = [check_pipe(s, mufu_rate, gen) for s in
               [(2, 8, 4096, 40), (2, 8, 1024, 80), (1, 2, 1000, 40), (1, 1, 4096, 512),
                (16, 8, 4096, 40), (16, 8, 1024, 80), (2, 8, 5184, 40), (2, 8, 1296, 80)]]
    fused_shapes = [(2, 320, 64, 64), (2, 640, 32, 32), (2, 1280, 16, 16), (2, 1280, 8, 8)]
    lab_fused = [(16, 320, 64, 64), (16, 640, 32, 32), (16, 1280, 16, 16)]
    lab_conv = [(16, 320, 64, 64), (16, 1280, 16, 16)]
    k6_rows = ([check_conv3x3(s, False, gen) for s in fused_shapes + lab_conv]
               + [check_conv3x3(s, True, gen) for s in fused_shapes + lab_fused]
               + [check_conv3x3((2, 320, 64, 64), True, gen, cout=4),       # UNet out
                  check_conv3x3((1, 128, 512, 512), True, gen, cout=3)])    # VAE conv_out
    k7b_rows = [check_matmul(m, k, n, gen) for m, k, n in
                [(8192, 320, 2560), (8192, 1280, 320), (4096, 1280, 1280)]]

    # ---- 10. the kernel labs ---------------------------------------------------
    lab_launches = run_labs()

    # ---- 14. the CLIP/OpenCLIP encoders, multi-context, Euler-ancestral --------
    # on phase 5's pipeline, before phase 11 frees it
    k2_clip_rows, clip_served = clip_paths(card, pipe, lp, ref, hint_src, mufu_rate, gen, sms)
    k2_rows += k2_clip_rows

    # ---- 11. the quality gates -------------------------------------------------
    del pipe, pipe8, net, net8, p, h_mid, hs, h_deep, hs_1, key_step, reuse_step
    torch.cuda.empty_cache()
    quality_gates(lp8)

    # ---- 12. the zoo and the serving entry points ------------------------------
    zoo_served = serving_entry_points(card, ref, hint_src)

    # ---- 13. config #4: the annotator networks into the ControlNet path --------
    net_served = preprocess_stack(card, ref, hint_src)

    # ---- 15. the training path ---------------------------------------------------
    train_served = training_path(card, gen)

    # ---- 16. the classic and legacy UNets, the sdwebui converter -----------------
    classic_served = classic_unets(card, gen)

    # ---- 17. the multi-device path, the VAE lab, the golden harness ---------------
    torch.cuda.empty_cache()
    k1_mesh, k2_mesh, mesh_served = multi_card(card, mufu_rate, gen)
    k1_rows += k1_mesh
    k2_rows += k2_mesh

    # ---- 18. summary ---------------------------------------------------------
    served = {"A": launches, "D": launches_d, "E": launches_e, "F": launches_f,
              "G": launches_g, **{k: turbo_served[k] for k in ("H", "H_kv", "H_tome", "I", "J",
                                                               "J0")}, **graph_served,
              **zoo_served, **net_served, **clip_served, "train_batch": train_served,
              **classic_served, **mesh_served}
    # the main path's launches: the graphed requests F (bf16), G (int8) and E
    # (K5), each held to the kernels the profiler saw run
    launches_f, launches_g = graph_served["graphed F"], graph_served["graphed G"]
    launches_e = graph_served["graphed E"]

    def summary(name, source, replaces, rows, n):
        main_row = rows[0]
        by_request = ({"launches_by_request": {k: v[name] for k, v in served.items()}}
                      if name in launches else {})
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": n, **by_request,
                "max_abs_err": max(r["max_abs_err"] for r in rows),
                "ms": main_row["kernel_ms"], "plain_ms": main_row["plain_ms"],
                "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
                "library_ms": main_row["library_ms"]}

    print(json.dumps({"kernels": [
        summary("flash_attention", "pfd_tpu_torch/csrc/flash_attention.cu",
                "pfd_tpu/ops/flash_attention.py:277", k1_rows, launches_f["flash_attention"]),
        summary("cross_attention", "pfd_tpu_torch/csrc/cross_attention.cu",
                "pfd_tpu/ops/flash_attention.py:465", k2_rows, launches_f["cross_attention"]),
        summary("flash_attention_pv8", "pfd_tpu_torch/csrc/flash_attention_pv8.cu",
                "pfd_tpu/ops/flash_attention.py:359", k4_rows,
                launches_g["flash_attention_pv8"]),
        summary("flash_attention_int8", "pfd_tpu_torch/csrc/flash_attention_int8.cu",
                "pfd_tpu/ops/flash_attention.py:359", k5_rows,
                launches_e["flash_attention_int8"]),
        summary("conv_int8", "pfd_tpu_torch/csrc/conv_int8.cu",
                "pfd_tpu/tools/int8_lab.py:129", conv_rows, launches_g["conv_int8"]),
        summary("flash_attention_pipe", "pfd_tpu_torch/csrc/flash_attention_pipe.cu",
                "pfd_tpu/ops/flash_attention.py:108", k3_rows,
                lab_launches["flash_attention_pipe"]),
        summary("conv3x3_bf16", "pfd_tpu_torch/csrc/conv3x3_bf16.cu",
                "pfd_tpu/ops/fused_conv.py:102", k6_rows, lab_launches["conv3x3_bf16"]),
        summary("matmul_int8", "pfd_tpu_torch/csrc/matmul_int8.cu",
                "pfd_tpu/tools/int8_lab.py:192", k7b_rows, lab_launches["matmul_int8"]),
    ]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
