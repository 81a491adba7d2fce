#!/usr/bin/env python3
"""Smoke run of the PyTorch port (seedvr2_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

From the root of a checkout, on a machine with a CUDA GPU, `nvcc` and no
network. In order it:

 1. prints the card (nvidia-smi name and power limit), the torch and CUDA
    versions, and builds the hand-written kernels from csrc/ (nvcc time);
 2. holds each kernel against its plain PyTorch version at 3B shapes on the
    card: K1 (packed window attention) within bf16 tolerance, its norm /
    rope pre-pass alone within one bf16 ulp of `norm_rope_plain` (each
    timed K1 case prints the pre-pass's time beside the whole call's and
    PR 5's time of the earlier design; the largest window group of the
    1080p clip's plan is timed too), K2 (row
    gather) and K3 (int8 GEMM) exactly, K4 (rms_norm + ada + quantize) and
    K5 (silu*up + quantize) within one int8 step, at the shapes of the 720p
    clip and of the throughput requests (their token counts are the GEMM
    and quantize rows); K6 (Q8_0 dequantizing GEMM) within one bf16 ulp and
    K7 (affine) within one ulp almost everywhere, at every distinct (K, N)
    of the 3B DiT's converted linears and the quantised lanes' token
    counts, M = 1 and 58 included (each beside the earlier mma.sync
    design's time, its fold floor and, for K7, its pre-pass);
    K11 (int8 implicit-GEMM conv) within one bf16 ulp at every (Ci, Co, T,
    H, W) of the 720p clip's int8 decode (and exact on the last rows of a
    4K stage, whose input passes 2^31 bytes), and
    K12 (fused norm + SiLU + causal head) at every shape of that clip's
    fused-norm encode and decode, its two kernels held apart (the apply
    kernel on the plain moments within one ulp, head frames equal; the
    moments kernel's A and Bc against fp64 moments) and together (one ulp
    almost everywhere, a few at most), each kernel's device time apart; times
    each with CUDA events after an L2 flush, beside its plain version, the
    one PyTorch call that computes the same function where there is one
    (for K11 cuDNN's bf16 conv at the same shape), and its bound;
 2b. serving parallelism on the one card (nothing beyond one card is
    measured): K3, K6 and K7 with their fp32 epilogue (and K6 / K7's fp32
    split-K reduction) against their plain versions at every row shard of
    the 3B and the 7B at tp 2 and 4, on the text rows and 3600 / 7200 video
    rows,
    timed beside their bf16 form, the plain version, the library call and
    the bound; then two ranks started by this script (`--parallel-rank`)
    share cuda:0 over gloo: the full-width 3B in bf16, q8, q4 and w8a8 and
    the 7B in bf16, each rank's model forward (tp = 1) then its shard's (tp
    = 2, 10 / 12 heads a rank) on the 720p image's latent, held to each
    other (the relative L2 and the K1 / K3 / K6 / K7 launches printed; the
    fp32 variants' launches are their record's), and a 5x540x960 -> 1080p
    request at batch size 1 under dp2, bit-equal to rank 0's single-rank
    request; then the CLI under torchrun's environment at WORLD_SIZE=1 (one
    NCCL process group) bit-equal to the plain run;
 3. the default path: builds the 3B DiT (32 layers, width 2560) and VAE_V3
    with random weights drawn on the card from a seed, and serves three
    requests through the port's `process_frames` (a 360x640 image to 720p,
    a 5-frame 360x640 clip to 720p, the clip again), checking shapes and
    finiteness and that K1 and K2 were launched by that path;
 3b. the CLI surface through `cli.main(argv)` in-process on those models
    (both cache flags): a 9-frame 360x640 .npy clip to 720p unchunked
    (against the same request through `process_frames`), in chunks of 5
    with overlap 2 under --debug and --profile_dir (each frame written
    once, equal to the unchunked run away from the seam; each chunk's RSS
    and device deltas; a profiler trace per phase) and again without the
    profiler (its overhead), --skip_first_frames 2 --load_cap 5 against
    the same frames given directly, --attention_mode sdpa (no K1, K2 still;
    dit seconds beside flash; scored by --parity_check against the
    unchunked flash output; its whole DiT output against K1's, timed in
    turns), where OpenCV imports the clip as an mp4 through the chunk loop
    into PNGs (against the .npy path on the decoded frames), and --doctor
    in a subprocess beside that (rc 0, the card named); the launches of
    the CLI paths go into the kernels' record;
 3c. the ComfyUI node surface (seedvr2_tpu_torch/interfaces) at the 3B's
    published widths with `random` weights from the node's seed: the
    shipped examples/workflows/simple_image.json (a 540x960 frame to
    1080p) and 4k_image.json (a 1080x1920 frame to 2160p with the
    workflow's tiled decode, 1024 / 128 px) through the port's
    `run_workflow`, their model names set to `random` in memory only
    (latency, the runner's build, peak memory, K1 / K2 launches); a node
    request with the default widgets, and one with quant="q8" (K6
    launched), each bit-equal to the port's four phases called directly
    with the same seed on the node's runner, the progress callback
    monotone up to 1.0; two calls with cache_model=True and
    offload_device="cpu", the second on the first's cached runner (the
    same object), both timed; the phase's seconds;
 4. runs the whole 32-layer DiT once with the kernels and once with their
    plain versions on the clip's latent and bounds the relative L2 error;
 4b. the rest of the request surface on that runner: two RGBA requests
    (7x360x640x4 to 720p, batch 5, overlap 2, uniform batches, input and
    latent noise, wavelet_adaptive; a mostly 0 / 1 alpha and a soft one)
    checked for shape, range and K1 / K2 launches equal to the same request
    in RGB; the 720p clip served with each colour method; the six colour
    methods at 5x720x1280 and 5x1080x1920 and process_alpha_for_batch on
    one 720p batch with TF32 at torch's defaults, timed on the card with
    their peak memory and held against the same functions on the CPU; the
    clip's latent decoded with ref-mode tiles (512 px, 64 px overlap)
    against the planner and the untiled and uniform decodes, and the clip
    served with tile_debug="decode" (the overlay on the recorded tiles);
    one DiT forward under each of the t2v and i2v conditions;
 5. the throughput path (`--preset throughput`): the same weights converted
    to w8a8; on the 1080p clip's latent the whole w8a8 DiT with kernels
    against plain versions (bound) and against the bf16 DiT (it must lie
    closer to the former);
 6. the q8 lane (`--quant q8`): the same weights converted to Q8_0 on the
    card; the whole q8 DiT with kernels against plain versions on the 720p
    clip's latent, and one real layer whose K6 output must lie within an
    ulp of the plain q8 product and farther from the bf16 product of the
    unconverted weight; the q4 lane (`--preset throughput --quant q4`):
    PTQ to 4-bit affine on the card, the whole q4 DiT against its plain
    versions and against the bf16 DiT on the 1080p clip's latent;
 7. serves, checking shapes, range and that every kernel of the lane was
    launched by it: the throughput lane with the preset's VAE tiling (a
    5-frame 540x960 clip to 1080p, a 1080x1920 image to 4K); the q8 lane
    untiled (a 540x960 image to 1080p, the 5-frame 360x640 clip to 720p);
    the q4 lane with the preset's tiling (the 1080p clip); each request
    once;
 8. the GGUF lane: writes a full-size 3B GGUF file laid out as a Q4_K_M
    file is (the q8 lane's attention linears as Q8_0 with f16 scales,
    random valid Q4_K blocks for the MLP linears but random Q6_K for the
    first and last blocks' MLP output projections, F16/F32 for the rest)
    with a small writer of its own, loads it through
    `cli.make_runner(dit_model=..., quant="q4k")` with the host library
    and again with the numpy dequantizers (seconds side by side, the DiTs
    equal), checks every linear's module and the Q8 buffers, serves one
    720p request through K6 and K7, the same request through the numpy-
    loaded DiT (equal output), holds every Q8_0 / Q4_K / Q6_K tensor of
    the file bit for bit to numpy in four host threads meanwhile, and
    deletes the file;
 9. the VAE's opt-in lanes: the whole int8 decode (`--vae_quant int8`) of
    the 720p clip's latent with K11 against its plain versions (its own
    limit, below the int8-vs-bf16 gap) and against the bf16 decode; the
    fused-norm encode and decode (SEEDVR2_FUSED_NORM=1) against the unfused
    ones; then serves, checked as in 7, `--vae_quant int8` untiled (the
    720p clip), `--preset throughput --vae_quant int8` (the 1080p clip)
    and SEEDVR2_FUSED_NORM=1 (the 720p clip);
 10. the VAE's lowering switches: VideoVAEs built under
    SEEDVR2_UPSAMPLE_CONVT=0, SEEDVR2_HEAD_CORRECTION=1 and
    SEEDVR2_CONV_IM2COL=1, each alone, encode and decode the 720p clip
    against the default lowering and the fp32 VAE; then the default 3B
    path serves the 5-frame 540x960 clip to 1080p under the pixel-shuffle
    upsample: wall, phases, peak memory, a profiled decode's device time,
    peak memory and top kernels (the same request under the transposed
    conv, whose rows PERF.md keeps, is left out to make room for 10b-10c);
 10b. the legacy VAE family at VAE_V3's widths (conv2 (1, 3, 3), no mid
    attention, quant convs; random, written as an fp16 .safetensors and
    loaded through `load_vae_checkpoint`, its sniffed config checked): the
    5x720x1280 clip encoded and decoded in the default, int8 and fused-norm
    lanes (seconds, peaks; int8 against its plain versions, fused against
    the fp32 VAE; K11 / K12 launches against the module list's
    prediction), and a 720p clip request in each lane beside the 3B DiT
    (K1 / K2 as a VAE_V3 request);
 10c. `--vae_encode_tile_size auto --vae_decode_tile_size auto` on the
    1080p clip under SEEDVR2_UPSAMPLE_CONVT=0: untiled on the whole card;
    tiled under a memory fraction emulating a 24 GiB card, with no
    out-of-memory retry, the peak within the limit and the output equal to
    the same tiles given as ints; a second resolution from the probe cache
    with no run; every probe's seconds, bytes and fragmentation;
 11. the 7B family at full width (36 blocks, D = 3072, 24 heads, random
    weights from a seed), after every 3B model is freed: K1-K4, K6 and K7
    against their plain versions at the 7B's shapes (timed, bound, library
    call); the whole bf16 DiT with kernels against plain versions on the
    720p and 1080p clips' latents; the default path served (the 720p clip
    and a 540x960 image to 1080p; K1, K2); the w8a8 DiT against its plain
    versions and the bf16 DiT, and `--preset throughput` serving the 1080p
    clip (K1-K4, K5 never); a full-size 7B Q4_K_M-like GGUF written (free
    disk checked first), loaded through `cli.make_runner(quant="q4k")`
    with every linear checked, served on the 720p clip (K1, K2, K6, K7),
    loaded and served again through numpy and checked block by block as
    the 3B file in 8, and deleted; the whole DiTs' plain forwards are
    timed once;
 11b. BlockSwap and memory tiering on that 7B (no second init): its bf16
    DiT with 12 and with 36 of its blocks streamed from pinned host memory
    (ops/offload.StreamedNaDiT) serves the 720p clip and the 1080p image
    and runs one forward on the 1080p clip's latent, each bit-equal to the
    resident DiT, K1 and K2 launched from streamed blocks, with the
    copies' GB/s, each block's copy and stall ms, the dit seconds and the
    peak; under a per-process memory fraction emulating a
    24 GiB card, core/model_manager.configure_runner picks per-phase
    offload for a fresh 7B from the same seed and serves the 720p clip with
    auto tiles (no OOM retry, the reserved peak within the limit, the
    output equal to the resident 7B's with the same tiles as ints, the
    restore's seconds), and a second call with both cache flags returns
    the same runner in under 0.1 s; under a 16 GiB emulation it picks
    streaming (its keep printed); after the throughput lane the 7B w8a8
    tree streamed gives one forward bit-equal to its resident forward (K3,
    K4 launched);
 13. the trainer (seedvr2_tpu_torch/parallel/train.py), after every
    serving model is freed: K1's backward kernels (dq, dk/dv, the norm /
    rope pre-pass backward) each against its plain version, and the whole
    backward against its plain version, at the record shape (B=12 S=512
    kv_len=463) and the 1080p clip plan's largest window group, each timed
    after an L2 flush beside its plain version, its bound and torch SDPA's
    backward, K1's serving time printed beside them, and at every window
    group of the training plan at the 3B's 20 heads and at a tp 2 rank's
    10; K2's backward (K2 on the inverse index) bit-equal to
    index_select's gradient; K9's training launch and backward likewise at
    its record shape and the training plan's layers at 20 and 10 heads;
    then the full 32-layer 3B on a 64x64x16 latent (a 512x512 frame, 1024
    tokens) at batch 2 with the packaged text embedding: one backward with
    every parameter's gradient present and finite, three AdamW steps with
    the kernels on each plan (the path's forward and backward launches,
    the step seconds, the peak memory against the reckoning) and the same
    steps with the plain versions, the losses held to each other; two
    steps under attention_mode="xla" held to the flash mode's; then two
    ranks on cuda:0 over gloo training the same full 3B at fsdp 2 (bit-
    equal to one rank) and at tp 2 (losses, sampled parameters and their
    updates within bf16-class bounds; one step on the uniform plan too,
    held so against one rank's first step), each rank's peak against its
    reckoning, its
    gathers and launches, and the 3B's widths at 4 blocks at fsdp 2 with
    a checkpoint saved after step 2, restored onto the mesh and stepped
    again bit-equal;
 12. prints the kernels' JSON record (K1-K12 and the backward kernels,
    launches by path, the 7B paths included, and each 7B kernel's record
    under "7b"), the card line again, and last {"ok": true, "device":
    {...}}.

The uniform window plan and the last three kernels (K8 dense flash
attention, K9 windowed flash attention, K10 quantizing int8 GEMM) add, in
phase 2: K8 within bf16 tolerance at the 720p clip's largest window group
in dense form (its pre-pass timed alone beside it) and at a
cross-attention shape, both beside PR 5's times, driven once through the
dispatcher `ops.attention.attention` (its "dense" path, which no product
code takes); K9 within bf16 tolerance at every uniform layer of the 720p
and 1080p clips' latents (its pre-pass with the windows' tables within one
bf16 ulp and timed alone, the key tiles its step walks and skips); K10
bit-equal at the 1080p clip's DiT linears and at 1 and 58 rows (device
time with its quantize pass's share, the tiles planned), then once over
those linears (its "op" path); each timed beside the earlier design's
time, its plain version, its PyTorch yardstick and its bound. And after
phase 5 (5b): the 32-layer DiT on the uniform plan (`build_dit_plan(...,
uniform=True)`) on both clip latents, with kernels against plain versions
and against the grouped plan, in bf16 and with the w8a8 tree, its forward
times and peak memory beside the grouped plan's, and the launches of one
uniform forward (32 of K9, none of K1 or K2).

Each phase prints its seconds. Any failure ends the run with a non-zero exit and no last line. It imports
nothing of JAX.
"""

import concurrent.futures
import copy
import dataclasses
import json
import os
import subprocess
import sys
import time

# Tolerances, stated with their reasons:
# K1, K8 and K9 vs plain, per element: both round q/k and the probabilities
# to bf16 but at different points (the kernel folds scale*log2e into q
# before the bf16 cast, the plain version scales fp32 logits), and the
# output is bf16; the JAX package holds its Pallas kernels to its jnp
# composition at the same bound (tests/test_flash_attention.py).
K1_ATOL = K1_RTOL = 2e-2
# K1/K8's pre-pass vs its plain version (normed, roped, scaled q and k in
# bf16): the same fp32 arithmetic in another order (the norm's sum of
# squares, fused multiply-adds), so one bf16 rounding may land one ulp
# (<= 2^-7 of the value) apart.
PREPASS_RTOL, PREPASS_ATOL = 2.0 ** -7, 1e-6
# the whole 32-layer DiT on the uniform plan against the grouped plan, same
# weights and input: the two plans compute the same attention with the
# roundings in other places (the uniform plan rounds the normed q and k to
# bf16 before K9, K1 norms inside the kernel), a bf16-class difference.
UNIFORM_REL_L2 = 1e-2
# K4/K5 vs plain: the row sums and rsqrt run in another order, which can move
# y / scale across a .5 rounding boundary: q within 1 everywhere, equal in
# at least 99.9 % of entries; scales within rtol 1e-6.
Q_MAX_DIFF, Q_EQUAL_SHARE, S_RTOL = 1, 0.999, 1e-6
# whole 32-layer bf16 DiT, kernels vs plain versions: per-layer bf16-class
# differences of the attention output propagate through 32 residual blocks
# of a random-weight model; bounded as a bf16-class relative L2 error.
DIT_REL_L2 = 2e-2
# whole w8a8 DiT, kernels vs plain versions: the same bf16-class attention
# differences, which the per-row int8 quantizations downstream turn into
# +-1 steps wherever they move y / scale across a .5 boundary. Its own,
# tighter limit: it must sit below the w8a8-vs-bf16 gap on the same weights
# (about 9e-3 on the H100), so that a path that skipped the quantization
# fails; the smoke also requires the kernels' output to lie closer to the
# w8a8 plain output than to the bf16 DiT's.
W8A8_DIT_REL_L2 = 8e-3
# whole q8 and q4 DiTs, kernels vs plain versions: K6/K7 are within an ulp of
# their plain versions, so K1's bf16-class differences dominate (0.0038 on
# the H100, as for the bf16 DiT). Their own limit sits below the q8-vs-bf16
# gap on the same weights (about 5.8e-3), so a path that skipped the
# quantization fails; the smoke also requires each lane's kernel output to
# lie closer to its plain output than to the bf16 DiT's.
QUANT_DIT_REL_L2 = 5e-3
# K6 vs plain, per element: both round one fp32 sum of the same products to
# bf16, in different orders, so they differ by at most one bf16 ulp. The ulp
# is taken at max(|plain|, rms(plain) / 256): below that floor the sums'
# order-of-summation difference (~ sqrt(K) * 2^-24 * rms) can exceed the
# element's own ulp.
K6_MAX_ULPS = 1
# K7 vs plain: the min term, taken as group sums of x times m as in the JAX
# kernel, cancels against the q*s term, so a few elements move further:
# within one ulp in >= 99.9 % of elements, relative L2 <= 1e-3.
K7_ULP_SHARE, K7_REL_L2 = 0.999, 1e-3
# K12's apply kernel vs its plain version on the same (A, Bc) (the plain
# `_fold`'s): sigmoid's expf may differ from torch's by an fp32 ulp, which
# can move the bf16 rounding: within one bf16 ulp; the head frames (the
# processed frame 0, written again) equal frame 0 exactly.
K12_MAX_ULPS = 1
# K12's moments kernel: its sums run in another order than torch's, so A
# and Bc may lie up to K12_FOLD_RATIO times as far from fp64 moments as the
# plain `_fold`'s, plus K12_FOLD_ULPS fp32 ulps of the largest value (where
# `_fold` happens to land exactly).
K12_FOLD_RATIO, K12_FOLD_ULPS = 2, 4
# the whole K12 vs plain: the moments' fp32 ulps move some y = x * A + Bc
# across a bf16 rounding boundary, and one ulp of y is up to ~3.4 ulps of
# silu(y) in its negative lobe (y ~ -4): >= 99.9 % of elements within one
# bf16 ulp, none beyond 8, relative L2 <= 1e-3; head frames exact.
K12_ULP_SHARE, K12_WHOLE_MAX_ULPS, K12_REL_L2 = 0.999, 8, 1e-3
# whole int8 VAE decode of the 720p clip latent, kernels vs plain versions:
# K11 is exact and everything else runs the same code, so any difference is
# nondeterminism that later quantizations amplify. Its own limit sits below
# the int8-vs-bf16 gap on the same weights (checked), and the kernels'
# output must lie closer to the plain int8 decode than to the bf16 one.
INT8_DECODE_REL_L2 = 1e-3
# whole VAE encode + decode with SEEDVR2_FUSED_NORM=1 against the unfused
# path on the same weights: K12 folds the norm into x * A + B and rounds y to
# bf16 at another point, and every later bf16 rounding spreads such flips
# (0.015 encode, 0.032 decode measured on the H100). So the fused path is
# held to the fp32 VAE on the same weights: no farther from it than
# FUSED_FP32_RATIO times the unfused bf16 path is; and to the unfused path
# within FUSED_VAE_REL_L2.
FUSED_VAE_REL_L2 = 5e-2
FUSED_FP32_RATIO = 1.5
# whole VAE encode and decode of the 720p clip with one lowering switch set
# (SEEDVR2_UPSAMPLE_CONVT=0, SEEDVR2_HEAD_CORRECTION=1,
# SEEDVR2_CONV_IM2COL=1) against the default lowering, same bf16 weights:
# the same function with its bf16 roundings at other points (the matmul's
# output rounded before the bias where the transposed conv rounds once; the
# head frames' partial convs rounded apart and summed in bf16; the patch
# matmul's fp32 sums in another order), which later bf16 roundings spread
# as they spread K12's (FUSED_VAE_REL_L2). JAX holds the fp32 forms to
# 2e-5 of each other, as the CPU tests hold the port's. Held as the fused
# path is: within FUSED_VAE_REL_L2 of the default, and no farther from the
# fp32 VAE than FUSED_FP32_RATIO times the default bf16 path is.
LOWERING_SWITCHES = (("SEEDVR2_UPSAMPLE_CONVT", "0", "upsample_convt"),
                     ("SEEDVR2_HEAD_CORRECTION", "1", "head_correction"),
                     ("SEEDVR2_CONV_IM2COL", "1", "im2col_max_k"))
# phase 10b: the legacy VAE family's switches (VAE_V3's widths otherwise),
# the clip it encodes and decodes (frames, height, width), the request it
# serves, and the K1 / K2 launches of that request: a 5-frame 720p clip
# request's on the default path (PERF.md: 384 K1 / 99 K2 over three such
# requests, 256 / 66 for a two-batch RGBA one)
LEGACY_SWITCHES = dict(time_receptive_field="half", mid_attention=False,
                       use_quant_conv=True, use_post_quant_conv=True)
LEGACY_CLIP = (5, 720, 1280)
LEGACY_REQUEST = ("clip 5x360x640 -> 720", 5, 360, 640, 720)
LEGACY_K1_K2 = (128, 33)
# values a piece in the GGUF files' bit-for-bit check of the host library
GGUF_CHECK_VALUES = 1 << 20
# phase 10c: the auto-tiled request and the emulated smaller card's memory
AUTO_REQUEST = ("clip 5x540x960 -> 1080", 5, 540, 960, 1080)
AUTO_EMULATED_BYTES = 24 << 30
# phase 11b: the 7B's blocks kept on the card in each streamed run (36 of
# them resident is the reference), and the smaller card emulated to make
# configure_runner stream
BLOCKSWAP_KEEPS = (24, 0)
STREAM_EMULATED_BYTES = 16 << 30
# the 1080p clip served under both upsample forms (default 3B path)
UPSAMPLE_AB_REQUEST = ("clip 5x540x960 -> 1080", 5, 540, 960, 1080)
# the 7B's requests: the default path (bf16) and its throughput and GGUF
# lanes: (label, frames, height, width, short side)
DIT7B_REQUESTS = (("clip 5x360x640 -> 720", 5, 360, 640, 720),
                  ("image 1x540x960 -> 1080", 1, 540, 960, 1080))
DIT7B_FAST_REQUESTS = (("clip 5x540x960 -> 1080", 5, 540, 960, 1080),)
DIT7B_GGUF_REQUESTS = (("clip 5x360x640 -> 720", 5, 360, 640, 720),)
# free disk the 7B GGUF phase needs before it writes (the file is ~2.7x the
# 3B's 2.37 GiB, so this leaves room for twice its size)
GGUF_7B_FREE_BYTES = 14 << 30
# the (Ci, Co, T, H, W) of every int8 conv the 720p clip's decode launches
# (2 latent frames of 90 x 160; the decoder's channels 512, 512, 256, 128)
K11_SHAPES = ((512, 512, 2, 90, 160), (512, 512, 3, 180, 320),
              (512, 256, 5, 360, 640), (256, 256, 5, 360, 640),
              (256, 128, 5, 720, 1280), (128, 128, 5, 720, 1280))
# the (C, T, H, W) of every fused norm of the 720p clip's encode (first
# slice of 5 frames at 720 x 1280) and decode
K12_SHAPES = ((128, 5, 720, 1280), (128, 5, 360, 640), (256, 5, 360, 640),
              (256, 3, 180, 320), (512, 3, 180, 320), (512, 2, 90, 160),
              (512, 5, 360, 640), (256, 5, 720, 1280))
# the uniform plan's window layers: (label, latent (T, H, W)); windows of
# (1, 15, 27) for the 720p clip (grid 2 x 45 x 80), 463 rows with the text
UNIFORM_LATENTS = (("720p clip", (2, 90, 160)), ("1080p clip", (2, 136, 240)))
# K10 at the 1080p clip's DiT linears (M = 16320 tokens): (label, M, N, K)
K10_SHAPES = (("qkv", 16320, 7680, 2560), ("gate+up", 16320, 13824, 2560),
              ("proj_out", 16320, 2560, 2560), ("mlp out", 16320, 2560, 6912),
              ("qkv", 58, 7680, 2560), ("qkv", 1, 7680, 2560))
# the VAE lanes' requests: (label, frames, height, width, short side)
INT8_REQUESTS = (("clip 5x360x640 -> 720", 5, 360, 640, 720),)
INT8_FAST_REQUESTS = (("clip 5x540x960 -> 1080", 5, 540, 960, 1080),)
FUSED_REQUESTS = (("clip 5x360x640 -> 720", 5, 360, 640, 720),)
# the packaged positive text embedding's length (checked in phase 3)
TXT_LEN = 58
# phase 3b, the CLI surface: the .npy clip (frames, height, width) and its
# short side out, the chunking (frames a chunk, overlap), the frames the
# chunked run blends at its seam (its second chunk's batches start where
# the whole run's second and third do, so the frames away from the seam
# come from the same batches with the same inputs and are expected
# bit-equal under a colour method local to each pixel: wavelet, as in
# tests/test_cli.py's streaming check; lab matches histograms over each
# decoded batch, which the seam's blend changes), and skip / cap
CLI_CLIP = (9, 360, 640)
CLI_RES = 720
CLI_CHUNK, CLI_OVERLAP = 5, 2
CLI_SEAM = (3, 4)
CLI_SKIP, CLI_CAP = 2, 5
# runs expected bit-equal (chunked against whole away from the seam, skip /
# cap against the same frames given directly, the CLI against
# process_frames): if one is not, its largest difference is printed and
# held to a bf16-class step of a [0, 1] frame; the seam's frames, blended
# by the chunk loop after colour correction as the pipeline blends them,
# are held to it too
CLI_MAX_ABS = 2e-2
# the parity report's floor (dB) for the xla lane's output scored against
# the flash lane's on the same request: bf16-class differences (relative L2
# ~0.007 of the frames, ~48 dB)
CLI_PARITY_MIN_PSNR = 35.0
# phase 3c, the node surface: each shipped image workflow with its input
# frames (frames, height, width), the output shape it must give and the
# path its launches are recorded under; the node requests' input (the
# default widgets' resolution is 1080) and seed
NODE_WORKFLOWS = (
    ("simple_image.json", (1, 540, 960), (1, 1080, 1920, 3), "node_image"),
    ("4k_image.json", (1, 1080, 1920), (1, 2160, 3840, 3), "node_4k_image"))
NODE_IMAGE = (1, 540, 960)
NODE_SEED = 42

# phase 2b, serving parallelism on the one card. The tp2 lanes: two ranks
# share cuda:0 over gloo, each its model's full forward (tp = 1) then its
# shard's, on the 720p image's latent (3600 video tokens: gloo stages every
# all-reduce through the host, so the token count sets the phase's time);
# the kernel each lane must launch on its row-sharded projections
TP_LATENT = (1, 90, 160)
TP_LANES = (("dit_3b", "none"), ("dit_3b", "q8"), ("dit_3b", "q4"),
            ("dit_3b", "w8a8"), ("dit_7b", "none"))
TP_LANE_KERNEL = {"none": "K1", "q8": "K6f32", "q4": "K7f32",
                  "w8a8": "K3f32"}
TP_COUNTS = ("K1", "K2", "K3", "K3f32", "K4", "K5", "K6", "K6f32", "K7",
             "K7f32")
# tp2 against tp = 1, same weights and input: each row-sharded projection's
# one bf16 rounding now follows an fp32 sum of two partials in another
# order, so bf16-class flips propagate through the residual blocks as the
# kernels-vs-plain differences do (DIT_REL_L2). The w8a8 lane quantizes
# the row-sharded inputs over each rank's K slice (a finer grid): held as
# tests/test_tp.py holds it, to the bf16 DiT no farther than 2 dB (x 10^0.1)
# beyond the tp = 1 lane
TP_REL_L2 = DIT_REL_L2
TP_W8A8_RATIO = 10 ** (2 / 20)
# the fp32 variants of K6 / K7 against their plain fp32 products: the sums'
# order and K7's hi / lo min term apart, with no bf16 rounding left
TP_F32_REL_L2 = 1e-4
# the row shards (label, N, K before sharding) the fp32 variants take at tp
# 2 and 4, on the text rows, the tp lanes' video rows and a 720p clip's;
# the record's
TP_SHARDS = (("3B attn out", 2560, 2560), ("3B mlp out", 2560, 6912),
             ("7B attn out", 3072, 3072), ("7B mlp out", 3072, 12288))
TP_ROWS = (TXT_LEN, 3600, 7200)
TP_F32_RECORD = (2, "3B mlp out", 3600)
# the dp2 request, one batch a frame so the two ranks share five batches
DP_REQUEST = ("clip 5x540x960 -> 1080", 5, 540, 960, 1080)
DP_BATCH = 1
# the CLI's NCCL path at world size 1: the .npy clip (frames, height,
# width, short side out)
NCCL_CLIP = (5, 360, 640, 720)
PARALLEL_TIMEOUT = 420
# phase 13's two-rank worlds: the full 3B on two meshes and the checkpoint
# round trip
TRAIN_WORLD_TIMEOUT = 600

# the q8 lane's requests (untiled VAE) and the q4 lane's (preset tiling):
# (label, frames, height, width, short side)
Q8_REQUESTS = (("image 1x540x960 -> 1080", 1, 540, 960, 1080),
               ("clip 5x360x640 -> 720", 5, 360, 640, 720))
Q4_REQUESTS = (("clip 5x540x960 -> 1080", 5, 540, 960, 1080),)
# the throughput path's requests: (label, frames, height, width, short side)
FAST_REQUESTS = (("clip 5x540x960 -> 1080", 5, 540, 960, 1080),
                 ("image 1x1080x1920 -> 2160", 1, 1080, 1920, 2160))

# phase 4b, the rest of the request surface on the default 3B runner: the
# RGBA request (frames, height, width, short side) and its options, the
# colour methods' clip shapes, the ref-mode decode tiles (px)
RGBA_REQUEST = (7, 360, 640, 720)
RGBA_OPTIONS = dict(batch_size=5, temporal_overlap=2, uniform_batch_size=True,
                    input_noise_scale=0.3, latent_noise_scale=0.1,
                    color_correction="wavelet_adaptive")
COLOUR_SHAPES = ((5, 720, 1280), (5, 1080, 1920))
REF_TILE, REF_OVERLAP = 512, 64
# colour methods and alpha, card against the CPU, same fp32 function, TF32
# at torch's defaults: adain and wavelet reduce and fuse multiply-adds in
# another order (max abs COLOUR_EXACT_ABS); lab's pow may differ by an ulp
# and swap two ranks, moving each by a gap between neighbouring sorted
# values (the CPU tests' lab allowance: max LAB_MAX_ABS, at most
# BINNED_SHARE of values beyond 1e-4); hsv, wavelet_adaptive and the alpha's
# binary cascade decide by bins and thresholds, and a value an ulp away can
# take the neighbouring bin or the other side: at most BINNED_SHARE of
# values beyond 1e-4.
COLOUR_EXACT_ABS, LAB_MAX_ABS, BINNED_SHARE = 1e-5, 1e-2, 1e-3
# the ref-mode tiled decode against the untiled one: both tilings blend the
# same overlap with the same fades, but the stride sweep's edge tiles are
# narrower (34 and 48 latents at 720p against ~50), so their seams sit
# nearer the frame's edge: within REF_TILED_RATIO times the uniform grid's
# relative L2 distance to the untiled decode at the same tile and overlap.
REF_TILED_RATIO = 2.0

# phase 13, the trainer: the full 32-layer 3B on a 64 x 64 x 16 latent (one
# 512 x 512 frame, 1024 tokens) at batch 2 with the packaged text
# embedding, TRAIN_STEPS AdamW steps on one rank; then two ranks on cuda:0
# over gloo training the same full 3B from the same start on the same
# draws on each of TRAIN_MESHES (dp, fsdp, tp), TRAIN_STEPS steps on the
# grouped plan each and, on the tp mesh, TRAIN_TP_UNIFORM_STEPS on the
# uniform plan; and the 3B's widths at TRAIN_RANK_LAYERS blocks at fsdp 2
# for the checkpoint round trip (the full 3B's file would be 38 GiB). The
# peak reckoned for one rank (fp32 parameters, gradients and both moments
# 50.5 GiB; the bf16 weights now bound a block at a time; the activations a
# few GiB), and a rank's at fsdp 2 (fp32 pieces of the parameters, both
# moments and the gradients 25.3 GiB, at most two gathered blocks 0.6 GiB,
# the activations as one rank's: 28-33 GiB) and at tp 2 (the same pieces of
# the halved blocks and the whole rest 26.0 GiB, one block's bf16 weights,
# the activations at half the heads: 27-30 GiB; 31-37 GiB if the bf16 local
# weights and gradients stayed for the whole step, which they do not)
TRAIN_LATENT = (1, 64, 64)
TRAIN_BATCH = 2
TRAIN_STEPS = 3
TRAIN_TP = 2
TRAIN_MESHES = (("fsdp2", (1, 2, 1)), ("tp2", (1, 1, TRAIN_TP)))
TRAIN_TP_UNIFORM_STEPS = 1
TRAIN_RANK_LAYERS = 4
TRAIN_PEAK_GIB = (51, 56)
TRAIN_RANK_PEAK_GIB = {"fsdp2": (28, 33), "tp2": (27, 30)}
# a rank's peak may exceed the top of its reckoning by this much before
# the phase fails (the activations' share is a guess)
TRAIN_RANK_PEAK_SLACK_GIB = 3.0
# every TRAIN_SAMPLE-th element of each rank's parameter pieces after the
# steps is held against the same elements of one rank's run (one rank
# writes them, TRAIN_SAMPLE times fewer bytes than its state)
TRAIN_SAMPLE = 97
TRAIN_KERNELS = ("K1", "K2", "K1bwd_dq", "K1bwd_dkdv", "K1bwd_prepass",
                 "K2bwd")
# the uniform window plan's train path: K9's training launch and its three
# backward parts, and none of the grouped plan's kernels
TRAIN_UNIFORM_KERNELS = ("K9", "K9bwd_dq", "K9bwd_dkdv", "K9bwd_prepass")
# K9's backward record shape: the 720p clip's shifted layer (32 windows of
# S = 463 over 9 ids), as K9's own record
K9_RECORD = ("720p clip", (2, 90, 160), "shifted_window")
# K1's backward parts against their plain versions on the same inputs
# (relative L2): lse (K1's training launch against its plain version on the
# same bf16 q-hat and k-hat), delta and the table gradients are fp32 sums
# of the same products in another order (exp2f against torch.exp2, table
# partials folded over the batch rows): BWD_F32_REL; dv and the pre-pass's
# d q / d k are such sums rounded to bf16, where a sum an ulp away can round
# to the neighbouring bf16 value: BWD_BF16_REL (dv's P enters the tensor
# cores as bf16 hi + lo, about 16 bits, which keeps it there). dq-hat and
# dk-hat take dS rounded to bf16 where it becomes a tensor-core operand
# (one bf16 dS: about 1.7e-3 relative L2 in a float64 model of the record
# shape; the plain versions keep fp32): BWD_DQDK_REL, set from the H100's
# readings (0.00165-0.00168 over the record shape, the n = 32 group and the
# 13 training groups; bound about 3x that). The whole backward against
# its plain version, which keeps q-hat and k-hat in fp32 where the kernels
# take K1's bf16 pre-pass output: a bf16-class BWD_WHOLE_REL, as K1's own
# K1_ATOL.
BWD_F32_REL = 1e-5
BWD_BF16_REL = 1e-3
BWD_DQDK_REL = 5e-3
BWD_WHOLE_REL = 2e-2
# the full 3B's one backward with the kernels against the same backward
# through the plain versions (same bf16 model, batch and draws), relative
# L2 over every gradient at once and on each parameter's own: the two
# differ by K1's bf16 q-hat / k-hat and probabilities in the forward and
# backward of 32 layers, bf16-class. Read on the H100: 0.0027 over all,
# 0.0049 on the median leaf, 0.0089 on the worst (a qk-norm weight, reached
# only through K1's tables); bounds about 3.5x those
BWD_3B_REL = 1e-2
BWD_LEAF_REL = 3e-2
# the 3B's losses over three steps with the kernels against the same steps
# with the plain versions: the forward's bf16-class attention differences
# (DIT_REL_L2 on the DiT's output) and the gradients' move the loss far
# less than its size (2.2e-5 relative at most on the H100): within 1e-3
TRAIN_LOSS_REL = 1e-3
# two ranks at fsdp 2 against one rank, same card, same data: dp 1 means
# each rank computes one rank's arithmetic on weights gathered bit for
# bit, so the two agree unless a library reduction is not deterministic:
# losses and parameters within 1e-5 relative (bit-equality printed)
TRAIN_RANKS_REL = 1e-5
# two ranks at tp 2 against one rank: each row-sharded projection's fp32
# partials are summed over the two ranks before its one bf16 rounding, and
# the gradients at the column-sharded inputs are rounded to bf16 per rank
# and summed, so bf16-class differences move through 32 blocks and three
# AdamW steps as the kernels-vs-plain ones do (TRAIN_LOSS_REL on the
# losses; read on the H100: 5.1e-6 on the grouped plan's three steps,
# 5.7e-6 on the uniform plan's step); the parameters after three steps,
# each within about 3e-4 of its start, by relative L2 over the sampled
# elements: read 1.76e-4, bound about 3x that. The steps' updates
# themselves (the parameters' moves from the start, about 1.2 % of their
# norm; a missing update reads 1): read 0.0151 after the grouped plan's
# three steps, bound 3x that. The uniform plan's one step is held the same
# way against one rank's parameters after its first step: read 1.49e-4 on
# the parameters, 0.0261-0.0262 on the update (AdamW's first step moves an
# element by about lr times its gradient's sign, which bf16-class
# differences flip on the smallest gradients); the grouped plan's readings
# repeated to the digit over two runs
TRAIN_TP_LOSS_REL = TRAIN_LOSS_REL
TRAIN_TP_PARAM_REL = 5e-4
TRAIN_TP_UPDATE_REL = 0.045
# the xla attention mode's steps (SDPA, its backward by autograd) against
# the flash mode's (K1 and its backward) on the same start and draws: two
# bf16 attentions rounded at other points, as the kernels against their
# plain versions: TRAIN_LOSS_REL
TRAIN_XLA_STEPS = 2

# H100 SXM data-sheet peaks (dense), for the bounds
PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12
PEAK_FP32 = 67e12      # CUDA cores, outside the tensor cores
PEAK_BYTES = 3.35e12
# fp32 operations a K4 / K5 element costs (square-add, norm, scale, shift,
# abs-max, divide, round, clamp; K5: exp, add, divide, multiply, then the
# same quantization)
K4_OPS_PER_ELEM, K5_OPS_PER_ELEM = 10, 12

KERNELS = {
    "K1": ("packed_window_attention", "seedvr2_tpu_torch/csrc/packed_attention.cu",
           "comfyui-seedvr2_tpu/ops/flash_attention.py:224"),
    "K2": ("gather_rows", "seedvr2_tpu_torch/csrc/gather_rows.cu",
           "comfyui-seedvr2_tpu/ops/gather.py:70"),
    "K3": ("int8_matmul", "seedvr2_tpu_torch/csrc/int8_matmul.cu",
           "comfyui-seedvr2_tpu/ops/int8_matmul.py:32"),
    "K4": ("rms_ada_quantize", "seedvr2_tpu_torch/csrc/fused_quant.cu",
           "comfyui-seedvr2_tpu/ops/fused_quant.py:63"),
    "K5": ("silu_mul_quantize", "seedvr2_tpu_torch/csrc/fused_quant.cu",
           "comfyui-seedvr2_tpu/ops/fused_quant.py:123"),
    "K6": ("quant_matmul_q8", "seedvr2_tpu_torch/csrc/quant_matmul.cu",
           "comfyui-seedvr2_tpu/ops/quant_matmul.py:28"),
    "K7": ("quant_matmul_affine", "seedvr2_tpu_torch/csrc/quant_matmul.cu",
           "comfyui-seedvr2_tpu/ops/quant_matmul.py:113"),
    "K8": ("flash_attention", "seedvr2_tpu_torch/csrc/flash_attention.cu",
           "comfyui-seedvr2_tpu/ops/flash_attention.py:154"),
    "K9": ("flash_windowed_attention",
           "seedvr2_tpu_torch/csrc/flash_attention.cu",
           "comfyui-seedvr2_tpu/ops/flash_attention.py:333"),
    "K10": ("int8_matmul_qx", "seedvr2_tpu_torch/csrc/int8_matmul.cu",
            "comfyui-seedvr2_tpu/ops/int8_matmul.py:128"),
    "K11": ("int8_conv3d", "seedvr2_tpu_torch/csrc/int8_conv.cu",
            "comfyui-seedvr2_tpu/ops/int8_conv.py:40"),
    "K12": ("norm_silu_head", "seedvr2_tpu_torch/csrc/fused_norm.cu",
            "comfyui-seedvr2_tpu/ops/fused_norm.py:28"),
    # the fp32-output variants of the row-sharded projections under tensor
    # parallelism (the same Pallas kernels with out_dtype=float32)
    "K3f32": ("int8_matmul (fp32 out)",
              "seedvr2_tpu_torch/csrc/int8_matmul.cu",
              "comfyui-seedvr2_tpu/ops/int8_matmul.py:32"),
    "K6f32": ("quant_matmul_q8 (fp32 out)",
              "seedvr2_tpu_torch/csrc/quant_matmul.cu",
              "comfyui-seedvr2_tpu/ops/quant_matmul.py:28"),
    "K7f32": ("quant_matmul_affine (fp32 out)",
              "seedvr2_tpu_torch/csrc/quant_matmul.cu",
              "comfyui-seedvr2_tpu/ops/quant_matmul.py:113"),
    # the trainer's gradients of K1 and K2: the JAX package differentiates
    # the jnp compositions behind the same Pallas kernels (no backward
    # kernel), so they replace K1's and K2's gradients
    "K1bwd_dq": ("attention_backward_dq (K1's gradient, dq part)",
                 "seedvr2_tpu_torch/csrc/attention_backward.cu",
                 "comfyui-seedvr2_tpu/ops/flash_attention.py:224"),
    "K1bwd_dkdv": ("attention_backward_dkdv (K1's gradient, dk/dv part)",
                   "seedvr2_tpu_torch/csrc/attention_backward.cu",
                   "comfyui-seedvr2_tpu/ops/flash_attention.py:224"),
    "K1bwd_prepass": ("prepass_backward (K1's gradient, norm / rope part)",
                      "seedvr2_tpu_torch/csrc/attention_backward.cu",
                      "comfyui-seedvr2_tpu/ops/flash_attention.py:224"),
    "K2bwd": ("gather_rows on the inverse index (K2's gradient)",
              "seedvr2_tpu_torch/csrc/gather_rows.cu",
              "comfyui-seedvr2_tpu/ops/gather.py:70"),
    # the uniform plan's trainer: K9's gradient (the JAX package
    # differentiates the jnp composition behind the same Pallas kernel)
    "K9bwd_dq": ("windowed_backward_dq (K9's gradient, dq part)",
                 "seedvr2_tpu_torch/csrc/attention_backward.cu",
                 "comfyui-seedvr2_tpu/ops/flash_attention.py:333"),
    "K9bwd_dkdv": ("windowed_backward_dkdv (K9's gradient, dk/dv part)",
                   "seedvr2_tpu_torch/csrc/attention_backward.cu",
                   "comfyui-seedvr2_tpu/ops/flash_attention.py:333"),
    "K9bwd_prepass": ("windowed_rope_backward (K9's gradient, rope part)",
                      "seedvr2_tpu_torch/csrc/attention_backward.cu",
                      "comfyui-seedvr2_tpu/ops/flash_attention.py:333"),
}
# the design each kernel's record names
DESIGN = {
    "K1": "norm/rope pre-pass + Hopper step (TMA ring, wgmma)",
    "K2": "row gather, 16-byte copies",
    "K3": "K10's TMA ring / wgmma s8 GEMM on the pre-quantized rows (128 x "
          "256 tiles; 128 weights x 8 / 64 tokens at M <= 64)",
    "K4": "persistent blocks, a row a step; each thread's two 8-column "
          "chunks of scale / shift in registers; cp.async ring of the next "
          "3 rows; one barrier a reduction",
    "K5": "fused silu * up + per-row quantize",
    "K6": "int8 weights widened as wgmma's register A, TMA ring, exact "
          "per-group fold, split K at small M",
    "K7": "K6's body, min term after the K loop as wgmma SS",
    "K8": "K1's pre-pass + Hopper step",
    "K9": "pre-pass with per-window tables + Hopper step over each window's "
          "live key tiles",
    "K10": "row-quantize pass once + TMA ring / wgmma s8 GEMM (128 x 256 "
           "tiles; 128 weights x 8 / 64 tokens at M <= 64)",
    "K11": "implicit GEMM, persistent: TMA ring with one 64-byte-swizzled "
           "strip for the three dw taps, wgmma m64n256k32 s8 (256 positions "
           "x 128 channels a tile), staged 16-byte stores",
    "K12": "moments kernel (one read in 64 KB pieces, partials folded by "
           "each group's last block in fixed order) + the earlier apply "
           "pass, 16 KB pieces from the plan",
    "K3f32": "K3 with an fp32 epilogue store of the same accumulator",
    "K6f32": "K6 with an fp32 epilogue (TMA store of fp32 rows) and an fp32 "
             "split-K reduction",
    "K7f32": "K7 with K6's fp32 epilogue and fp32 split-K reduction",
    "K1bwd_dq": "K1's step: 1-2 warpgroups of 64 q rows a block (host "
                "plan), TMA ring of k-hat / v tiles, S and dP by wgmma SS, "
                "dS in fp32 registers from the forward's lse, dQ-hat += "
                "bf16(dS) k-hat by wgmma RS, one sweep",
    "K1bwd_dkdv": "64 keys a block, TMA ring of q-hat / dO tiles and their "
                  "lse / delta rows; two warpgroups split a q tile for S^T "
                  "and dP^T (wgmma SS), stage P^T (bf16 hi + lo) and dS^T "
                  "in shared memory, and split D for dK-hat and dV (wgmma "
                  "SS); the next tile's S^T issued first; dV into d qkv",
    "K1bwd_prepass": "D/8 threads a row over the heads as the forward "
                     "pre-pass; table partials a row, folded over the batch "
                     "rows in order",
    "K2bwd": "K2 itself on the inverse permutation",
    "K9bwd_dq": "K1bwd_dq MASKED: the window's validity words and live-tile "
                "list staged in shared memory behind a barrier (as K9's "
                "forward), only live key tiles loaded, a partly valid one "
                "masked on the fp32 scores",
    "K9bwd_dkdv": "K1bwd_dkdv MASKED: one barrier vote whether the block's "
                  "64 keys hold a valid key (none: zeros, exit), masked "
                  "keys P = 0",
    "K9bwd_prepass": "D/8 threads a row over the heads, the row's table "
                     "(picked by window id) read once; rot^T of dQ-hat * "
                     "scale and dK-hat * ln2 into bf16, no norm, no table "
                     "gradients",
}
# the path whose launches each kernel's record reports
DENSE_PATH, OP_PATH = "dense (no product caller)", "op (no product caller)"
MAIN_PATH = {"K1": "default", "K2": "default", "K3": "throughput",
             "K4": "throughput", "K5": "throughput", "K6": "q8", "K7": "q4",
             "K8": DENSE_PATH, "K9": "uniform", "K10": OP_PATH,
             "K11": "vae_int8", "K12": "fused_norm", "K3f32": "tp2",
             "K6f32": "tp2", "K7f32": "tp2", "K1bwd_dq": "train",
             "K1bwd_dkdv": "train", "K1bwd_prepass": "train",
             "K2bwd": "train", "K9bwd_dq": "train_uniform",
             "K9bwd_dkdv": "train_uniform",
             "K9bwd_prepass": "train_uniform"}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def format_record(timings: dict) -> str:
    """A request record on one line: spans in seconds, copies in bytes."""
    from seedvr2_tpu_torch.utils.spans import format_record as fmt
    return fmt(timings)


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if res.returncode != 0:
        fail(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    """Mean milliseconds per call of fn() over `iters` back-to-back calls,
    CUDA events (warm caches)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


_FLUSH = []


def kernel_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds of one call of fn(), each call timed alone with
    CUDA events after a 256 MB write that evicts the 50 MB L2, so inputs
    come from device memory as they would in the model."""
    if not _FLUSH:
        _FLUSH.append(torch.empty(256 << 20, dtype=torch.uint8,
                                  device="cuda"))
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(iters):
        _FLUSH[0].zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def queued_ms(torch, fn, iters: int = 10) -> float:
    """kernel_ms for a call of a few tens of microseconds: every timed call
    (after its L2-evicting write) and its events are enqueued behind a
    spin of the device (torch.cuda._sleep, ~50 ms), so the host's launch
    overhead, longer than such a call, never falls between two events.
    Late in this script torch.profiler records no device events, so
    device_ms cannot read there: phases 11a and 13 time with this."""
    if not _FLUSH:
        _FLUSH.append(torch.empty(256 << 20, dtype=torch.uint8,
                                  device="cuda"))
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    pairs = []
    for _ in range(iters):
        _FLUSH[0].zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


DEVICE_MS_SESSIONS = 3


def device_ms(torch, fn, iters: int = 10, only: str = "") -> float:
    """Mean device milliseconds of the kernels one call of fn() launches
    (those whose name holds `only`, when given), summed from a
    torch.profiler trace, the L2 evicted before each call as in kernel_ms.
    Unlike CUDA events around a call of a few tens of microseconds, it
    leaves out the host's launch overhead. A trace that holds fewer such
    device events than calls (the profiler dropped them; it has recorded
    none at all for a call now and then, and none late in this script) is
    taken again, up to DEVICE_MS_SESSIONS sessions, then the run fails:
    a reading of 0 is never returned."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    kernel_ms(torch, fn, 1)  # warm-up; allocates the flush buffer
    for _ in range(DEVICE_MS_SESSIONS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                _FLUSH[0].zero_()
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA and only in e.name
                  and not any(w in e.name.lower()
                              for w in ("fill", "memset"))]
        us = sum(e.device_time_total for e in events)
        if len(events) >= iters and us > 0:
            return us / iters / 1e3
    raise RuntimeError(
        f"device_ms: {DEVICE_MS_SESSIONS} profiler sessions recorded "
        f"{len(events)} device events of {iters} calls (name holding "
        f"{only!r}); time this call with queued_ms")


def timer_note(timer) -> str:
    """How a short call's time was read: device_ms's profiler trace, or
    queued_ms's events behind a device spin (where the profiler records
    nothing)."""
    return ("device time" if timer is device_ms
            else "events queued behind a device spin")


def bound_ms(ops: float, peak_ops: float, nbytes: float):
    """(least time in ms, what bounds it): the larger of ops over the peak
    rate for their type and bytes over the memory rate."""
    t_ops, t_bytes = ops / peak_ops, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")


def rope_tables(torch, gen, s: int, d: int, device):
    ang = torch.randn(s, d // 2, generator=gen, device=device)
    return (torch.cos(ang).repeat_interleave(2, -1).contiguous(),
            torch.sin(ang).repeat_interleave(2, -1).contiguous())


def sdpa_inputs(torch, qkv, heads, d, tabs, eps, kv_len):
    """The attention core's inputs as K1's plain version forms them
    (normed, roped q and k in bf16; v) in (B, H, S, D), and the key mask."""
    from seedvr2_tpu_torch.models.dit.rope import rotate_half_full

    b, s, _ = qkv.shape
    x = qkv.reshape(b, s, 3, heads, d)
    cq, sq, ck, sk = tabs

    def norm_rope(z, cos, sin):
        z = z.float()
        z = z * torch.rsqrt(torch.mean(z * z, dim=-1, keepdim=True) + eps)
        z = z * cos[:, None, :] + rotate_half_full(z) * sin[:, None, :]
        return z.to(qkv.dtype).transpose(1, 2).contiguous()

    q = norm_rope(x[:, :, 0], cq, sq)
    k = norm_rope(x[:, :, 1], ck, sk)
    v = x[:, :, 2].transpose(1, 2).contiguous()
    mask = (torch.arange(s, device=qkv.device) < kv_len)[None, None, None, :]
    return q, k, v, mask


def latent_shape(vae_cfg, t: int, h: int, w: int, res: int):
    """Latent (T, H, W) of a request of t frames h x w served at short side
    `res`: resized and padded to a multiple of 16 as
    utils.transforms.prepare_video does, then the VAE's temporal and spatial
    downsampling of the 4n+1 frame block."""
    from seedvr2_tpu_torch.utils.transforms import side_resize_dims

    nh, nw = side_resize_dims(h, w, res)
    sd, td = (vae_cfg.spatial_downsample_factor,
              vae_cfg.temporal_downsample_factor)
    return ((t - 1) // td + 1, -(-nh // 16) * 16 // sd,
            -(-nw // 16) * 16 // sd)


# Times of the redesigned kernels in their earlier design, by row name:
# (design, ms). K1, K8 and K9 on the mma.sync tile step, K6 and K7 on
# mma.sync m16n8k16 with one 32-group a cp.async stage, K10 on K3's
# mma.sync tile quantizing its x tile in every block; each timed by this
# script on a tree before its Hopper redesign (PERF.md: the kernel table,
# its notes and the K6 / K7 by_shape table; K10's "mlp out" and M = 1 rows,
# which PERF.md did not keep, from a later run of the same K10 code). K3
# (mma.sync m16n8k32 tiles) and K11 (mma.sync implicit GEMM): the mean of
# the two parent turns of seedvr2_tpu_torch/ab_int8.py on the tree before
# their redesign, timed the same way. K4 (one block a row) and K12
# (plain-torch moments + one pass): this script's final run on the tree
# before their redesign (946e4a5). NVIDIA H100 80GB HBM3, 700.00 W.
EARLIER_MS = {name: (design, ms) for design, times in (
    ("one-block-a-row design", {
        "K4 rows=16320 K=2560": 0.0971, "K4 rows=32400 K=2560": 0.1756,
        "K4 rows=58 K=2560": 0.0126,
    }),
    ("torch-moments + one-pass design", {
        "K12 C=128 T=5 720x1280": 2.7714, "K12 C=128 T=5 360x640": 0.7580,
        "K12 C=256 T=5 360x640": 1.4353, "K12 C=256 T=3 180x320": 0.3289,
        "K12 C=512 T=3 180x320": 0.4977, "K12 C=512 T=2 90x160": 0.1645,
        "K12 C=512 T=5 360x640": 2.7586, "K12 C=256 T=5 720x1280": 5.4437,
    }),
    ("mma.sync step design", {
        "K1 S=128 kv_len=91 B=16": 0.1123, "K1 S=128 kv_len=128 B=16": 0.1144,
        "K1 S=896 kv_len=859 B=4": 0.7412, "K1 S=896 kv_len=896 B=4": 0.7368,
        "K1 S=3712 kv_len=3675 B=2": 6.4220,
        "K1 S=3712 kv_len=3712 B=2": 6.3946,
        "K1 clip plan window n=12 wlen=405 S=512 kv_len=463": 0.7528,
        "K1 clip plan window n=6 wlen=390 S=512 kv_len=448": 0.3911,
        "K1 clip plan shifted_window n=4 wlen=91 S=256 kv_len=149": 0.0815,
        "K1 clip plan shifted_window n=8 wlen=195 S=256 kv_len=253": 0.1777,
        "K1 clip plan shifted_window n=4 wlen=104 S=256 kv_len=162": 0.0807,
        "K1 clip plan shifted_window n=4 wlen=189 S=256 kv_len=247": 0.0997,
        "K1 clip plan shifted_window n=8 wlen=405 S=512 kv_len=463": 0.5891,
        "K1 clip plan shifted_window n=4 wlen=216 S=384 kv_len=274": 0.2069,
        "K8 B=12 Sq=463 Sk=463 kv_len=463 H=20 D=128 shared table": 0.8811,
        "K8 B=4 Sq=512 Sk=1024 kv_len=1000 H=20 D=128 no rope": 0.4879,
        "K9 720p clip window nW=18 nU=2 S=463 H=20 D=128": 0.9404,
        "K9 720p clip shifted_window nW=32 nU=9 S=463 H=20 D=128": 1.5498,
        "K9 1080p clip window nW=50 nU=4 S=463 H=20 D=128": 2.4687,
        "K9 1080p clip shifted_window nW=60 nU=9 S=463 H=20 D=128": 2.9231,
    }),
    ("mma.sync per-block-quantize design", {
        "K10 qkv M=16320 N=7680 K=2560": 2.3483,
        "K10 gate+up M=16320 N=13824 K=2560": 4.1528,
        "K10 proj_out M=16320 N=2560 K=2560": 0.8846,
        "K10 mlp out M=16320 N=2560 K=6912": 2.1322,
        "K10 qkv M=58 N=7680 K=2560": 0.0739,
        "K10 qkv M=1 N=7680 K=2560": 0.0671,
    }),
    ("mma.sync m16n8k32 tile design", {
        "K3 clip 5x540x960 -> 1080 qkv M=16320 N=7680 K=2560": 1.4066,
        "K3 clip 5x540x960 -> 1080 gate+up M=16320 N=13824 K=2560": 2.6072,
        "K3 clip 5x540x960 -> 1080 mlp out M=16320 N=2560 K=6912": 1.1925,
        "K3 clip 5x540x960 -> 1080 attn out M=16320 N=2560 K=2560": 0.4788,
        "K3 image 1x1080x1920 -> 2160 qkv M=32400 N=7680 K=2560": 2.7031,
        "K3 image 1x1080x1920 -> 2160 gate+up M=32400 N=13824 K=2560": 5.1388,
        "K3 image 1x1080x1920 -> 2160 mlp out M=32400 N=2560 K=6912": 2.2885,
        "K3 image 1x1080x1920 -> 2160 attn out M=32400 N=2560 K=2560": 0.9143,
        "K3 txt_in M=58 N=2560 K=5120": 0.0588,
        "K3 emb proj_hid M=1 N=2560 K=2560": 0.0318,
        "K3 emb proj_out M=1 N=15360 K=2560": 0.0436,
    }),
    ("mma.sync implicit-GEMM design", {
        "K11 Ci=512 Co=512 T=2 90x160": 1.0755,
        "K11 Ci=512 Co=512 T=3 180x320": 4.7618,
        "K11 Ci=512 Co=256 T=5 360x640": 13.2015,
        "K11 Ci=256 Co=256 T=5 360x640": 6.8834,
        "K11 Ci=256 Co=128 T=5 720x1280": 13.7964,
        "K11 Ci=128 Co=128 T=5 720x1280": 7.3963,
    }),
    ("fp32-FMA design", {
        "K1bwd_dq B=12 S=512 kv_len=463": 3.0659,
        "K1bwd_dkdv B=12 S=512 kv_len=463": 3.2118,
        "K1bwd_dq 1080p clip plan largest group n=32 wlen=405 S=512 "
        "kv_len=463": 7.8661,
        "K1bwd_dkdv 1080p clip plan largest group n=32 wlen=405 S=512 "
        "kv_len=463": 8.2241,
    }),
    ("mma.sync design", {
        "K6 image 1080 qkv": 1.8952, "K6 image 1080 attn out": 0.6451,
        "K6 image 1080 gate/up": 1.6963, "K6 image 1080 mlp out": 1.6751,
        "K6 clip 720 qkv": 1.6586, "K6 clip 720 attn out": 0.594,
        "K6 clip 720 gate/up": 1.521, "K6 clip 720 mlp out": 1.5257,
        "K6 txt_in": 0.1777, "K6 text qkv": 0.0907,
        "K6 text mlp out": 0.2266, "K6 emb proj_hid": 0.0862,
        "K6 emb proj_out": 0.0889, "K7 clip 1080 qkv": 5.4306,
        "K7 clip 1080 attn out": 1.9501, "K7 clip 1080 gate/up": 4.8024,
        "K7 clip 1080 mlp out": 4.934, "K7 clip 720 qkv": 2.3719,
        "K7 clip 720 attn out": 0.858, "K7 clip 720 gate/up": 2.2234,
        "K7 clip 720 mlp out": 2.2082, "K7 txt_in": 0.2538,
        "K7 text qkv": 0.1234, "K7 text mlp out": 0.3111,
        "K7 emb proj_hid": 0.1185, "K7 emb proj_out": 0.1215,
    })) for name, ms in times.items()}


def earlier_note(name: str) -> str:
    """The earlier design's time of row `name` (EARLIER_MS), for a print."""
    if name not in EARLIER_MS:
        return "earlier design: not timed"
    design, ms = EARLIER_MS[name]
    return f"{design} {ms:.4f} ms (PERF.md)"


def check_k1(torch, fa, nadit, cfg, device, path_latents, tag="",
             random_tables=True, timer=device_ms):
    """K1 against its plain version: window lengths 128, 896 and 3712 with
    random tables (when `random_tables`), and every window group of
    `cfg`'s 720p clip plan with its real tables (all timed), then every
    group of the requests' plans `path_latents` (checked; the largest
    group of the 1080p clip's plan, the default path's 1080p clip too,
    timed). Each timed case prints the pre-pass's time alone beside the
    whole call's and the earlier design's time; `timer` reads the
    pre-pass (device_ms, or queued_ms where the profiler records nothing).
    Rows are named after `tag` (the 7B's "7B "). Returns the record of the
    720p clip plan's largest group."""
    import torch.nn.functional as F

    gen = torch.Generator(device).manual_seed(1)
    H, D, eps = cfg.heads, cfg.head_dim, cfg.norm_eps
    qscale = D ** -0.5 * 1.4426950408889634
    worst = 0.0
    cases = []
    for s, b in ((128, 16), (896, 4), (3712, 2)) if random_tables else ():
        for kv in (s - 37, s):
            cq, sq = rope_tables(torch, gen, s, D, device)
            ck, sk = rope_tables(torch, gen, s, D, device)
            cases.append([f"S={s} kv_len={kv} B={b}", b, s, kv,
                          (cq, sq, ck, sk), True])
    ones = torch.ones(D, device=device)
    main = None
    for label, shape in (("clip plan", (2, 90, 160)), *path_latents):
        timed = label == "clip plan"
        dplan = nadit.upload_plan(nadit.build_dit_plan(cfg, shape, TXT_LEN),
                                  cfg, device)
        largest = None
        for method, groups in dplan.groups.items():
            for g in groups:
                tabs = nadit._fold_norm_tables(g.cos, g.sin, ones, ones, ones,
                                               ones, g.wlen, g.skv)
                case = [f"{tag}{label} {method} n={g.n} wlen={g.wlen} "
                        f"S={g.sk_pad} kv_len={g.skv}", g.n, g.sk_pad, g.skv,
                        tabs, timed]
                cases.append(case)
                if largest is None or (g.n * g.sk_pad ** 2
                                       > largest[1] * largest[2] ** 2):
                    largest = case
        if timed:
            main = largest
        elif shape == (2, 136, 240):
            largest[5] = True
    for case in cases:
        name, b, s, kv, tabs, timed = case
        qkv = torch.randn(b, s, 3 * H * D, generator=gen, device=device).to(
            torch.bfloat16)
        out = fa.packed_window_attention(qkv, H, D, *tabs, eps, kv)
        torch.cuda.synchronize()
        ref = fa.packed_window_attention_plain(qkv, H, D, *tabs, eps, kv)
        err = (out.float() - ref.float()).abs().max().item()
        if not torch.isfinite(out).all():
            fail(f"K1 {name}: non-finite output")
        if not torch.allclose(out.float(), ref.float(), atol=K1_ATOL,
                              rtol=K1_RTOL):
            fail(f"K1 {name}: max abs err {err} beyond atol/rtol {K1_ATOL}")
        worst = max(worst, err)
        if not timed:
            say(f"K1 {name}: max_abs_err {err:.6g} (atol=rtol={K1_ATOL})")
            continue
        ms = kernel_ms(torch, lambda: fa.packed_window_attention(
            qkv, H, D, *tabs, eps, kv), 20)
        x = qkv.view(b, s, 3, H, D)
        hats = fa.attention_prepass(x[:, :, 0], x[:, :, 1], *tabs, eps,
                                    qscale)
        refs = (fa.norm_rope_plain(x[:, :, 0], *tabs[:2], eps, qscale),
                fa.norm_rope_plain(x[:, :, 1], *tabs[2:], eps))
        for side, hat, ref_hat in zip("qk", hats, refs):
            if not torch.allclose(hat.float(), ref_hat.float(),
                                  rtol=PREPASS_RTOL, atol=PREPASS_ATOL):
                fail(f"K1 {name}: pre-pass {side} beyond one bf16 ulp of "
                     "its plain version")
        prepass_ms = timer(torch, lambda: fa.attention_prepass(
            x[:, :, 0], x[:, :, 1], *tabs, eps, qscale))
        plain_ms = kernel_ms(torch, lambda: fa.packed_window_attention_plain(
            qkv, H, D, *tabs, eps, kv), 10)
        q, k, v, mask = sdpa_inputs(torch, qkv, H, D, tabs, eps, kv)
        lib_ms = kernel_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask), 20)
        flops = 4 * b * H * s * kv * D  # QK^T and PV over the kv_len keys
        nbytes = qkv.numel() * 2 + 4 * s * D * 4 + b * s * H * D * 2
        bound, by = bound_ms(flops, PEAK_BF16, nbytes)
        say(f"K1 {name}: max_abs_err {err:.6g} (atol=rtol={K1_ATOL}); "
            f"kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), "
            f"prepass_ms {prepass_ms:.4f} of it alone ({timer_note(timer)}),"
            f" {earlier_note('K1 ' + name)}"
            f"; plain {plain_ms:.4f} ms, sdpa (attention core only) "
            f"{lib_ms:.4f} ms, bound {bound:.4f} ms ({by})")
        if case is main:
            rec = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       library_ms=lib_ms, bound_ms=bound, bound_by=by)
    say(f"K1 worst max_abs_err over all cases {worst:.6g}; the record "
        f"below holds {main[0]}")
    return dict(rec, shape=main[0], heads=H)


def check_k2(torch, gather, nadit, cfg, device, path_latents):
    """K2 on the transitions of the clip plan and of the throughput
    requests' plans: exact. Times the clip plan's last transition."""
    gen = torch.Generator(device).manual_seed(2)
    errs = []
    for shape in [s for _, s in path_latents] + [(2, 90, 160)]:
        plan = nadit.build_dit_plan(cfg, shape, TXT_LEN)
        for key in (("canonical", "window"), ("window", "shifted_window")):
            index = gather.RowIndex(plan.transitions[key], device)
            x = torch.randn(1, plan.seq_len, cfg.vid_dim, generator=gen,
                            device=device).to(torch.bfloat16)
            out = gather.gather_rows(x, index)
            torch.cuda.synchronize()
            ref = gather.gather_rows_plain(x, index)
            if not torch.equal(out, ref):
                fail(f"K2 {key} L={plan.seq_len}: kernel output differs "
                     "from the plain gather")
            errs.append((out.float() - ref.float()).abs().max().item())
            say(f"K2 transition {key[0]}->{key[1]} L={plan.seq_len} "
                f"D={cfg.vid_dim}: exact")
    ms = kernel_ms(torch, lambda: gather.gather_rows(x, index), 50)
    plain_ms = kernel_ms(torch, lambda: gather.gather_rows_plain(x, index), 50)
    idx = index.tensor.long()
    lib_ms = kernel_ms(torch, lambda: torch.index_select(x, 1, idx), 50)
    warm_ms = cuda_ms(torch, lambda: gather.gather_rows(x, index), 50)
    nbytes = 2 * x.numel() * 2 + len(index) * 4
    bound, by = bound_ms(0, PEAK_BF16, nbytes)
    say(f"K2 timing, L={plan.seq_len} D={cfg.vid_dim}: kernel {ms:.4f} ms "
        f"({nbytes / ms / 1e6:.0f} GB/s), "
        f"plain {plain_ms:.4f} ms, torch.index_select {lib_ms:.4f} ms, "
        f"bound {bound:.4f} ms ({by}); back-to-back warm-L2 loop "
        f"{warm_ms:.4f} ms")
    return dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=bound, bound_by=by,
                shape=f"L={plan.seq_len} D={cfg.vid_dim}")


def mlp_dims(cfg, joined):
    """(name, N, hidden) of the MLP's input product: the 3B's swiglu gate
    and up, one gate+up product of N = 2 * hidden when `joined` (the w8a8
    lane joins them) and two gate/up products of N = hidden otherwise; the
    7B's proj_in."""
    from seedvr2_tpu_torch.ops.layers import swiglu_hidden_dim

    if cfg.mlp_type == "swiglu":
        hidden = swiglu_hidden_dim(cfg.vid_dim, cfg.expand_ratio)
        return ("gate+up", 2 * hidden, hidden) if joined else (
            "gate/up", hidden, hidden)
    hidden = cfg.vid_dim * cfg.expand_ratio
    return "mlp in", hidden, hidden


def check_k3(torch, im, cfg, device, path_rows, tag="", timer=device_ms):
    """K3 bit-exact against its plain version at every shape `cfg`'s w8a8
    DiT gives it on the throughput path: the video GEMMs at each request's
    token count `path_rows` [(label, M)], the text rows and the time
    embedding's single row; each timed (events, and device time at M <=
    58, where events carry the host's launch cost) beside the earlier
    design's time. The record holds the first request's MLP input product
    (the 3B's gate+up, the 7B's proj_in)."""
    D = cfg.vid_dim
    mlp_in, n_in, hidden = mlp_dims(cfg, joined=True)
    shapes = []
    for label, m in path_rows:
        shapes += [(f"{tag}{label} qkv", m, 3 * D, D),
                   (f"{tag}{label} {mlp_in}", m, n_in, D),
                   (f"{tag}{label} mlp out", m, D, hidden),
                   (f"{tag}{label} attn out", m, D, D)]
    shapes += [(f"{tag}txt_in", TXT_LEN, D, cfg.txt_in_dim),
               (f"{tag}emb proj_hid", 1, D, D),
               (f"{tag}emb proj_out", 1, 6 * D, D)]
    gen = torch.Generator(device).manual_seed(3)
    rec = None
    for name, m, n, k in shapes:
        xq = torch.randint(-127, 128, (m, k), generator=gen, device=device,
                           dtype=torch.int8)
        wq = torch.randint(-127, 128, (n, k), generator=gen, device=device,
                           dtype=torch.int8)
        xs = torch.rand(m, generator=gen, device=device) * 0.01
        ws = torch.rand(n, generator=gen, device=device) * 0.01
        out = im.int8_matmul(xq, wq, xs, ws)
        torch.cuda.synchronize()
        ref = im.int8_matmul_plain(xq, wq, xs, ws)
        if not torch.equal(out, ref):
            bad = (out != ref).sum().item()
            fail(f"K3 {name} M={m} N={n} K={k}: {bad} entries differ from "
                 "the plain version")
        ms = kernel_ms(torch, lambda: im.int8_matmul(xq, wq, xs, ws), 20)
        plain_ms = kernel_ms(torch, lambda: im.int8_matmul_plain(
            xq, wq, xs, ws), 5)
        lib_ms = None
        if m > 16:  # torch._int_mm takes M > 16
            wt = wq.t()
            try:  # a yardstick only: the port never calls it
                lib_ms = kernel_ms(torch, lambda: torch._int_mm(xq, wt), 20)
            except RuntimeError as e:
                say(f"K3 {name}: torch._int_mm refused: {e}")
        ops = 2 * m * n * k
        nbytes = m * k + n * k + 4 * (m + n) + 2 * m * n
        bound, by = bound_ms(ops, PEAK_INT8, nbytes)
        row = f"K3 {name} M={m} N={n} K={k}"
        dev = ""
        if m <= TXT_LEN:
            d = timer(torch, lambda: im.int8_matmul(xq, wq, xs, ws))
            dev = f"{timer_note(timer)} {d:.4f} ms, "
        swap, bt = im.plan_qx(m)
        say(f"{row}: exact; kernel {ms:.4f} ms ({ops / ms / 1e9:.1f} TOP/s; "
            f"{dev}tiles {'128 weights x ' if swap else '128 x '}{bt}"
            f"{' tokens' if swap else ' weights'}), {earlier_note(row)}; "
            f"plain {plain_ms:.4f} ms, torch._int_mm (int32 product only, no "
            f"epilogue) {'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}, "
            f"bound {bound:.4f} ms ({by})")
        if rec is None and name.endswith(mlp_in):
            rec = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                       library_ms=lib_ms, bound_ms=bound, bound_by=by,
                       shape=f"{name} M={m} N={n} K={k}")
    return rec


def q_error(torch, out, ref, name):
    """Max |q - q_plain|, failing beyond the stated tolerance."""
    diff = (out.q.int() - ref.q.int()).abs()
    worst = diff.max().item()
    equal = (diff == 0).float().mean().item()
    if worst > Q_MAX_DIFF or equal < Q_EQUAL_SHARE:
        fail(f"{name}: q off by up to {worst}, {equal:.6f} equal (needs "
             f"<= {Q_MAX_DIFF} and >= {Q_EQUAL_SHARE})")
    if not torch.allclose(out.s, ref.s, rtol=S_RTOL, atol=0):
        fail(f"{name}: scales beyond rtol {S_RTOL}")
    return worst, equal


def check_k4_k5(torch, fq, cfg, device, path_rows, timer=device_ms):
    """K4 on D-wide rows (2560 in the 3B, 3072 in the 7B) and, for a swiglu
    MLP (the 3B), K5 on the hidden-wide halves of a gate+up product, at the
    text length and at each throughput request's token count `path_rows`
    [(label, M)]; the records hold the first request."""
    gen = torch.Generator(device).manual_seed(4)
    D, hidden = cfg.vid_dim, mlp_dims(cfg, joined=True)[2]
    lengths = [m for _, m in path_rows]
    recs = {}
    for l in lengths + [TXT_LEN]:
        x = torch.randn(1, l, D, generator=gen, device=device).to(
            torch.bfloat16)
        scale = 1 + 0.2 * torch.randn(1, D, generator=gen, device=device)
        shift = 0.2 * torch.randn(1, D, generator=gen, device=device)
        out = fq.rms_ada_quantize(x, scale, shift, cfg.norm_eps)
        torch.cuda.synchronize()
        ref = fq.rms_ada_quantize_plain(x, scale, shift, cfg.norm_eps)
        worst, equal = q_error(torch, out, ref, f"K4 L={l}")
        ms = kernel_ms(torch, lambda: fq.rms_ada_quantize(
            x, scale, shift, cfg.norm_eps), 50, warmup=20)
        plain_ms = kernel_ms(torch, lambda: fq.rms_ada_quantize_plain(
            x, scale, shift, cfg.norm_eps), 20)
        m = l
        nbytes = m * D * 2 + 2 * D * 4 + m * D + 4 * m
        bound, by = bound_ms(K4_OPS_PER_ELEM * m * D, PEAK_FP32, nbytes)
        dev = "" if l != TXT_LEN else " ({} {:.4f} ms)".format(
            timer_note(timer), timer(torch, lambda: fq.rms_ada_quantize(
                x, scale, shift, cfg.norm_eps)))
        say(f"K4 rows={m} K={D}: q max diff {worst}, {equal * 100:.4f} % "
            f"equal; kernel {ms:.4f} ms{dev} ({nbytes / ms / 1e6:.0f} GB/s),"
            f" plain {plain_ms:.4f} ms, library none, bound {bound:.4f} ms "
            f"({by}); {earlier_note(f'K4 rows={m} K={D}')}")
        recs.setdefault("K4", dict(
            max_abs_err=float(worst), ms=ms, plain_ms=plain_ms,
            library_ms=None, bound_ms=bound, bound_by=by,
            shape=f"rows={m} K={D}"))
    for l in (lengths + [TXT_LEN]) if cfg.mlp_type == "swiglu" else ():
        gu = torch.randn(1, l, 2 * hidden, generator=gen, device=device).to(
            torch.bfloat16)
        g, u = gu[..., :hidden], gu[..., hidden:]
        out = fq.silu_mul_quantize(g, u)
        torch.cuda.synchronize()
        ref = fq.silu_mul_quantize_plain(g, u)
        worst, equal = q_error(torch, out, ref, f"K5 L={l}")
        ms = kernel_ms(torch, lambda: fq.silu_mul_quantize(g, u), 50)
        plain_ms = kernel_ms(torch, lambda: fq.silu_mul_quantize_plain(g, u),
                             20)
        m = l
        nbytes = 2 * m * hidden * 2 + m * hidden + 4 * m
        bound, by = bound_ms(K5_OPS_PER_ELEM * m * hidden, PEAK_FP32, nbytes)
        dev = "" if l != TXT_LEN else " ({} {:.4f} ms)".format(
            timer_note(timer), timer(torch,
                                     lambda: fq.silu_mul_quantize(g, u)))
        say(f"K5 rows={m} K={hidden}: q max diff {worst}, "
            f"{equal * 100:.4f} % equal; kernel {ms:.4f} ms{dev} "
            f"({nbytes / ms / 1e6:.0f} GB/s), plain {plain_ms:.4f} ms, "
            f"library none, bound {bound:.4f} ms ({by})")
        recs.setdefault("K5", dict(
            max_abs_err=float(worst), ms=ms, plain_ms=plain_ms,
            library_ms=None, bound_ms=bound, bound_by=by))
    return recs


def bf16_ulps(torch, out, ref):
    """|out - ref| in bf16 ulps of ref, the ulp taken at max(|ref|,
    rms(ref) / 256) (see K6_MAX_ULPS)."""
    ref32, out32 = ref.float(), out.float()
    floor = ref32.pow(2).mean().sqrt() / 256
    _, e = torch.frexp(torch.maximum(ref32.abs(), floor))
    return (out32 - ref32).abs() / torch.ldexp(torch.ones_like(ref32), e - 8)


def check_k6_k7(torch, qm, cfg, device, rows, main=None, tag="",
                timer=device_ms):
    """K6 and K7 against their plain versions at every distinct (K, N) of
    `cfg`'s converted linears: the video linears at each lane's token
    count (`rows` = {"K6": [(label, M)], "K7": [...]}), the text stream's at
    58 rows (txt_in 5120 -> D among them), the time embedding's at one.
    Random Q8_0 weights of a linear's magnitude for K6, affine ones with
    quants in [0, 15] for K7. Each shape timed (kernel, the earlier
    mma.sync design's time from EARLIER_MS, plain, and torch.matmul on the
    weight dequantized once to bf16, which the port never calls), with its
    bound (operations and bytes apart), the exact fold's FMA floor, the
    token width and K split the wrapper planned, at M <= 58 the call's
    device time (profiler: events around a call of tens of microseconds
    also hold the host's launch cost), and for K7 its pre-pass kernel
    alone (device time). The record holds the shapes `main` names (the q8
    lane's 1080p-image qkv (K6) and the q4 lane's 1080p-clip gate/up (K7)
    by default), with every shape under by_shape: this run's measurements
    and the bound only (the earlier design's time, the fold floor and the
    plan are printed, not recorded). Rows are named after `tag`."""
    D = cfg.vid_dim
    mlp_in, n_in, hidden = mlp_dims(cfg, joined=False)
    video = (("qkv", 3 * D, D), ("attn out", D, D), (mlp_in, n_in, D),
             ("mlp out", D, hidden))
    other = [("txt_in", TXT_LEN, D, cfg.txt_in_dim),
             ("text qkv", TXT_LEN, 3 * D, D),
             ("text mlp out", TXT_LEN, D, hidden),
             ("emb proj_hid", 1, D, D), ("emb proj_out", 1, 6 * D, D)]
    main = main or {"K6": "image 1080 qkv", "K7": "clip 1080 gate/up"}
    gen = torch.Generator(device).manual_seed(6)
    recs = {}
    for key in ("K6", "K7"):
        shapes = [(f"{label} {name}", m, n, k) for label, m in rows[key]
                  for name, n, k in video] + other
        by_shape = []
        for name, m, n, k in shapes:
            x = torch.randn(m, k, generator=gen, device=device).to(
                torch.bfloat16)
            if key == "K6":
                q = torch.randint(-127, 128, (n, k), generator=gen,
                                  device=device, dtype=torch.int8)
                tabs = (torch.rand(n, k // 32, generator=gen, device=device)
                        * (2 / k ** 0.5 / 127),)
                run, plain = qm.quant_matmul_q8, qm.quant_matmul_q8_plain
                w = qm.dequantize_q8(q, *tabs)
                wbytes = n * k * (1 + 4 / 32)
            else:
                q = torch.randint(0, 16, (n, k), generator=gen,
                                  device=device, dtype=torch.int8)
                tabs = (torch.rand(n, k // 32, generator=gen, device=device)
                        * (2 / k ** 0.5 / 15),
                        torch.rand(n, k // 32, generator=gen, device=device)
                        / k ** 0.5)
                run = qm.quant_matmul_affine
                plain = qm.quant_matmul_affine_plain
                w = qm.dequantize_affine(q, *tabs)
                wbytes = n * k * (1 + 8 / 32)
            out = run(x, q, *tabs)
            torch.cuda.synchronize()
            ref = plain(x, q, *tabs)
            ulps = bf16_ulps(torch, out, ref)
            worst = ulps.max().item()
            share = (ulps <= 1).float().mean().item()
            rel = rel_l2(out, ref)
            err = (out.float() - ref.float()).abs().max().item()
            if not torch.isfinite(out).all():
                fail(f"{key} {name}: non-finite output")
            if key == "K6" and worst > K6_MAX_ULPS:
                fail(f"{key} {name} M={m} N={n} K={k}: {worst} bf16 ulps "
                     f"from the plain version (limit {K6_MAX_ULPS})")
            if key == "K7" and (share < K7_ULP_SHARE or rel > K7_REL_L2):
                fail(f"{key} {name} M={m} N={n} K={k}: {share:.6f} within "
                     f"one ulp (needs {K7_ULP_SHARE}), rel L2 {rel} (limit "
                     f"{K7_REL_L2})")
            wb = w.to(torch.bfloat16)
            ms = kernel_ms(torch, lambda: run(x, q, *tabs), 10)
            plain_ms = kernel_ms(torch, lambda: plain(x, q, *tabs), 3)
            lib_ms = kernel_ms(torch, lambda: torch.matmul(x, wb.t()), 10)
            ops = 2 * m * n * k
            nbytes = m * k * 2 + wbytes + m * n * 2
            bound, by = bound_ms(ops, PEAK_BF16, nbytes)
            # the exact fold's own floor on the CUDA cores: one fp32 FMA a
            # (row, column, group); K7's min term runs on the tensor cores
            fold_ms = 2 * m * n * (k // 32) / PEAK_FP32 * 1e3
            bt, splits = qm.plan_tiles(m, n, k)
            extra = ""
            prepass = dev = None
            if m <= TXT_LEN:  # a call of tens of microseconds: device time
                dev = timer(torch, lambda: run(x, q, *tabs))
                extra = f", {dev:.4f} ms {timer_note(timer)}"
            if key == "K7":
                prepass = timer(torch, lambda: qm.k7_prepass(x, tabs[1]))
                extra += (f", pre-pass (xg and -m planes) {prepass:.4f} of "
                          f"it ({timer_note(timer)})")
            key_name = f"{key} {tag}{name}"
            say(f"{key_name} M={m} N={n} K={k} (tokens {bt}, splits "
                f"{splits}): max {worst:.3g} ulps, {share * 100:.4f} % within "
                f"one, rel L2 {rel:.3g}; kernel {ms:.4f} ms "
                f"({ops / ms / 1e9:.1f} TFLOP/s){extra}, "
                f"{earlier_note(key_name)}"
                f"; plain {plain_ms:.4f} ms, torch.matmul on the dequantized "
                f"bf16 weight {lib_ms:.4f} ms, bound {bound:.4f} ms ({by}; "
                f"ops {ops / PEAK_BF16 * 1e3:.4f}, bytes "
                f"{nbytes / PEAK_BYTES * 1e3:.4f}), fold floor "
                f"{fold_ms:.4f} ms")
            rec = dict(shape=tag + name, m=m, n=n, k=k, max_abs_err=err,
                       max_ulps=worst, ms=ms, plain_ms=plain_ms,
                       library_ms=lib_ms, bound_ms=bound, bound_by=by,
                       device_ms=dev, prepass_ms=prepass)
            by_shape.append(rec)
            if name == main[key]:
                recs[key] = {k2: rec[k2] for k2 in (
                    "max_abs_err", "ms", "plain_ms", "library_ms",
                    "bound_ms", "bound_by", "shape")}
        recs[key]["by_shape"] = by_shape
    return recs


def attention_core(torch, q, k, cos, sin):
    """q and k roped as the K8/K9 plain versions rope them (fp32, rounded to
    bf16), in SDPA's (B, H, S, D) layout; cos/sin broadcast over the rows'
    heads ((S, D) or (B, S, D))."""
    from seedvr2_tpu_torch.models.dit.rope import apply_rope_ext

    if cos is not None:
        q, k = apply_rope_ext(q, cos, sin), apply_rope_ext(k, cos, sin)
    return q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous()


def attention_case(torch, name, run, plain, sdpa, flops, nbytes,
                   prepass=None):
    """Hold one K8/K9 call against its plain version (finite, within
    K1_ATOL/RTOL), time kernel, plain and the SDPA yardstick (and the
    pre-pass alone, `prepass`, beside the earlier design's time), print and
    return the record."""
    out = run()
    torch.cuda.synchronize()
    ref = plain()
    err = (out.float() - ref.float()).abs().max().item()
    if not torch.isfinite(out).all():
        fail(f"{name}: non-finite output")
    if not torch.allclose(out.float(), ref.float(), atol=K1_ATOL,
                          rtol=K1_RTOL):
        fail(f"{name}: max abs err {err} beyond atol/rtol {K1_ATOL}")
    ms = kernel_ms(torch, run, 20)
    plain_ms = kernel_ms(torch, plain, 5)
    lib_ms = kernel_ms(torch, sdpa, 20)
    bound, by = bound_ms(flops, PEAK_BF16, nbytes)
    extra = ""
    if name.startswith(("K8", "K9")):
        extra = (", no pre-pass" if prepass is None else
                 f", prepass_ms {device_ms(torch, prepass):.4f} of it "
                 "alone (device time)")
        extra += f", {earlier_note(name)}"
    say(f"{name}: max_abs_err {err:.6g} (atol=rtol={K1_ATOL}); kernel "
        f"{ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s of needed work){extra}"
        f"; plain {plain_ms:.4f} ms, sdpa (attention core only) "
        f"{lib_ms:.4f} ms, bound {bound:.4f} ms ({by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound, bound_by=by)


def check_k8(torch, fa, nadit, cfg, device):
    """K8 at the 720p clip's largest grouped window group in dense form (its
    12 windows of 405 tokens + 58 text rows, S = 463, the group's real
    extended table shared by every row, kv_len = S) and at a cross-attention
    shape without rope (Sq = 512, Sk = 1024, kv_len = 1000). The record holds
    the first. Returns it and the first case's operands."""
    import torch.nn.functional as F

    gen = torch.Generator(device).manual_seed(8)
    H, D = cfg.heads, cfg.head_dim
    dplan = nadit.upload_plan(nadit.build_dit_plan(cfg, (2, 90, 160),
                                                   TXT_LEN), cfg, device)
    g = max((g for gs in dplan.groups.values() for g in gs),
            key=lambda g: g.n * g.skv ** 2)
    cos, sin = g.cos[:g.skv].contiguous(), g.sin[:g.skv].contiguous()
    rec = first = None
    for b, sq, sk, kv, tabs in ((g.n, g.skv, g.skv, g.skv, (cos, sin)),
                                (4, 512, 1024, 1000, (None, None))):
        q = torch.randn(b, sq, H, D, generator=gen, device=device).to(
            torch.bfloat16)
        k, v = (torch.randn(b, sk, H, D, generator=gen, device=device).to(
            torch.bfloat16) for _ in range(2))
        qr, kr = attention_core(torch, q, k, *tabs)
        vr = v.transpose(1, 2).contiguous()
        mask = None
        if kv < sk:
            mask = (torch.arange(sk, device=device) < kv)[None, None, None]
        name = (f"K8 B={b} Sq={sq} Sk={sk} kv_len={kv} H={H} D={D} "
                f"{'shared table' if tabs[0] is not None else 'no rope'}")
        prepass = None
        if tabs[0] is not None:
            def prepass(q=q, k=k, tabs=tabs):
                return fa.attention_prepass(q, k, *tabs, *tabs, None,
                                            D ** -0.5 * 1.4426950408889634)
        r = attention_case(
            torch, name,
            lambda: fa.flash_attention(q, k, v, None, *tabs, kv),
            lambda: fa.flash_attention_plain(q, k, v, None, *tabs, kv),
            lambda: F.scaled_dot_product_attention(qr, kr, vr,
                                                   attn_mask=mask),
            4 * b * H * sq * kv * D,
            2 * (2 * q.numel() + k.numel() + v.numel())
            + (0 if tabs[0] is None else 2 * cos.numel() * 4), prepass)
        if rec is None:
            rec, first = r, (q, k, v, cos, sin, g.skv)
    return rec, first


def check_k9(torch, fa, nadit, cfg, device):
    """K9 at every uniform window layer of the 720p and 1080p clips'
    latents (all windows of a forward's batch row, S = 405 + 58 = 463), with
    the plans' real tables, masks and ids; its pre-pass alone within one
    bf16 ulp of its plain version, and timed. Prints the key tiles the step
    walks (`live_key_tiles`) and skips per layer. The bound counts the work
    the data needs: valid query rows against valid keys. The record holds
    the 720p clip's shifted layer."""
    import torch.nn.functional as F

    gen = torch.Generator(device).manual_seed(9)
    H, D = cfg.heads, cfg.head_dim
    qscale = D ** -0.5 * 1.4426950408889634
    rec = None
    for label, shape in UNIFORM_LATENTS:
        dplan = nadit.upload_plan(nadit.build_dit_plan(
            cfg, shape, TXT_LEN, uniform=True), cfg, device)
        for method, u in dplan.uniform.items():
            ids = u.batch_ids(1)
            b, s = len(ids), u.cos.shape[1]
            q, k, v = (torch.randn(b, s, H, D, generator=gen,
                                   device=device).to(torch.bfloat16)
                       for _ in range(3))
            idx = ids.tensor.long()
            qr, kr = attention_core(torch, q, k, u.cos[idx], u.sin[idx])
            vr = v.transpose(1, 2).contiguous()
            mask = u.valid[idx][:, None, None, :]
            n_valid = u.valid[idx].sum(1).double()
            flops = 4 * H * D * (n_valid ** 2).sum().item()
            nbytes = (2 * 4 * q.numel() + 2 * 4 * u.cos.numel()
                      + u.valid.numel() + 4 * b)
            name = (f"K9 {label} {method} nW={b} nU={u.cos.shape[0]} S={s} "
                    f"H={H} D={D}")
            hats = fa.attention_prepass(q, k, u.cos, u.sin, u.cos, u.sin,
                                        None, qscale, ids)
            refs = (fa.norm_rope_plain(q, u.cos, u.sin, None, qscale,
                                       ids.tensor),
                    fa.norm_rope_plain(k, u.cos, u.sin, ids=ids.tensor))
            for side, hat, ref_hat in zip("qk", hats, refs):
                if not torch.allclose(hat.float(), ref_hat.float(),
                                      rtol=PREPASS_RTOL, atol=PREPASS_ATOL):
                    fail(f"{name}: pre-pass {side} beyond one bf16 ulp of "
                         "its plain version")
            del hats, refs
            r = attention_case(
                torch, name,
                lambda: fa.flash_windowed_attention(
                    q, k, v, None, u.cos, u.sin, ids, u.valid),
                lambda: fa.flash_windowed_attention_plain(
                    q, k, v, None, u.cos, u.sin, ids, u.valid),
                lambda: F.scaled_dot_product_attention(qr, kr, vr,
                                                       attn_mask=mask),
                flops, nbytes,
                lambda: fa.attention_prepass(q, k, u.cos, u.sin, u.cos,
                                             u.sin, None, qscale, ids))
            tiles = fa.live_key_tiles(u.valid)
            live = tiles[idx].sum().item()
            say(f"  {name}: {4 * b * H * s * s * D:.4g} flop over all S x S "
                f"slots, {flops:.4g} needed; key tiles walked {live} of "
                f"{b * tiles.shape[1]} a head ({b * tiles.shape[1] - live} "
                "wholly masked, skipped)")
            if label == "720p clip" and method == "shifted_window":
                rec = r
    return rec


def check_k10(torch, im, device):
    """K10 bit-equal to its plain version at the 1080p clip's DiT linears
    (K10_SHAPES); each timed (events, and device time with pass 1's share)
    beside the earlier design's time, its plain version, torch._int_mm on
    the pre-quantized operand (int32 product only, as for K3) and the
    two-step form (the plain quantize, then K3), with its bound. The record
    holds the qkv shape. Returns it and the shapes' operands."""
    gen = torch.Generator(device).manual_seed(10)
    rec, operands = None, []
    for name, m, n, k in K10_SHAPES:
        x = (3 * torch.randn(m, k, generator=gen, device=device)).to(
            torch.bfloat16)
        wq = torch.randint(-127, 128, (n, k), generator=gen, device=device,
                           dtype=torch.int8)
        ws = torch.rand(n, generator=gen, device=device) * 0.01
        out = im.int8_matmul_qx(x, wq, ws)
        torch.cuda.synchronize()
        ref = im.int8_matmul_qx_plain(x, wq, ws)
        if not torch.equal(out, ref):
            fail(f"K10 {name} M={m} N={n} K={k}: {(out != ref).sum().item()}"
                 " entries differ from the plain version")
        ms = kernel_ms(torch, lambda: im.int8_matmul_qx(x, wq, ws), 10)
        dev_ms = device_ms(torch, lambda: im.int8_matmul_qx(x, wq, ws))
        pass1_ms = device_ms(torch, lambda: im.int8_matmul_qx(x, wq, ws),
                             only="quantize_rows")
        plain_ms = kernel_ms(torch, lambda: im.int8_matmul_qx_plain(
            x, wq, ws), 3)
        xq, _ = im.quantize_rows_qx(x)

        def two_step():
            q, s = im.quantize_rows_qx(x)
            return im.int8_matmul(q, wq, s, ws)

        two_ms = kernel_ms(torch, two_step, 10)
        lib_ms = None
        if m > 16:  # torch._int_mm takes M > 16
            wt = wq.t()
            try:  # a yardstick only: the port never calls it
                lib_ms = kernel_ms(torch, lambda: torch._int_mm(xq, wt), 10)
            except RuntimeError as e:
                say(f"K10 {name}: torch._int_mm refused: {e}")
        ops = 2 * m * n * k
        bound, by = bound_ms(ops, PEAK_INT8, 2 * m * k + n * k + 4 * n
                             + 2 * m * n)
        row = f"K10 {name} M={m} N={n} K={k}"
        swap, bt = im.plan_qx(m)
        say(f"{row}: exact; kernel {ms:.4f} ms ({ops / ms / 1e9:.1f} TOP/s; "
            f"device {dev_ms:.4f}, pass 1 (quantize) {pass1_ms:.4f} of it; "
            f"tiles {'128 weights x ' if swap else '128 x '}{bt}"
            f"{' tokens' if swap else ' weights'}), {earlier_note(row)}; "
            f"plain {plain_ms:.4f} ms, two-step (plain quantize + K3) "
            f"{two_ms:.4f} ms, torch._int_mm (int32 product only) "
            f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
            f"{bound:.4f} ms ({by})")
        if rec is None:
            rec = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                       library_ms=lib_ms, bound_ms=bound, bound_by=by,
                       two_step_ms=two_ms)
        if m == K10_SHAPES[0][1]:
            operands.append((x, wq, ws))
    return rec, operands


def check_k11(torch, ic, device):
    """K11 against its plain version at every distinct (Ci, Co, T, H, W) of
    the 720p clip's int8 decode, through the VAE's NCDHW call with a bias,
    bit-equal (exact int32 sums, the same fp32 epilogue); each timed
    (kernel, the earlier design's time, plain, and cuDNN's bf16 F.conv3d on
    the dequantized operands at the same shape, what the bf16 lane runs
    there and the port never calls for it, with cuDNN's time over K11's),
    with its bound. The record holds the largest, (128, 128) at 720 x 1280,
    with every shape under by_shape."""
    import torch.nn.functional as F

    gen = torch.Generator(device).manual_seed(11)
    by_shape, rec = [], None
    for ci, co, t, h, w in K11_SHAPES:
        wp = -(-(w + 2) // 32) * 32
        x_ext = torch.randint(-127, 128, (t + 2, h + 2, wp, ci), generator=gen,
                              device=device, dtype=torch.int8)
        x_ext[:, 0] = 0
        x_ext[:, h + 1] = 0
        x_ext[:, :, 0] = 0
        x_ext[:, :, w + 1:] = 0
        wk = torch.randint(-127, 128, (co, 27 * ci), generator=gen,
                           device=device, dtype=torch.int8)
        xs = torch.rand(t, generator=gen, device=device) * 0.01
        ws = torch.rand(co, generator=gen, device=device) * 0.01
        bias = (0.1 * torch.randn(co, generator=gen, device=device)).to(
            torch.bfloat16)
        out = ic.int8_conv3d_ncdhw(x_ext, wk, xs, ws, bias, w)
        torch.cuda.synchronize()
        ref = ic.int8_conv3d_plain(x_ext, wk, xs, ws, bias, w)[None]
        ulps = bf16_ulps(torch, out, ref)
        worst = ulps.max().item()
        equal = (out == ref).float().mean().item()
        err = (out.float() - ref.float()).abs().max().item()
        del ulps, ref
        name = f"Ci={ci} Co={co} T={t} {h}x{w}"
        if not torch.isfinite(out).all() or equal < 1.0:
            fail(f"K11 {name}: {worst} bf16 ulps from the plain version, "
                 f"{equal:.6f} equal (must be bit-equal)")
        ms = kernel_ms(torch, lambda: ic.int8_conv3d_ncdhw(
            x_ext, wk, xs, ws, bias, w), 10)
        plain_ms = kernel_ms(torch, lambda: ic.int8_conv3d_plain(
            x_ext, wk, xs, ws, bias, w), 2, warmup=1)
        # the bf16 lane's conv at this shape: the same values in bf16
        xb = x_ext.permute(3, 0, 1, 2)[None, :, :, 1:h + 1, 1:w + 1].to(
            torch.bfloat16).contiguous()
        wb = wk.view(co, 3, 3, 3, ci).permute(0, 4, 1, 2, 3).to(
            torch.bfloat16).contiguous()
        lib_ms = kernel_ms(torch, lambda: F.conv3d(xb, wb, bias, 1,
                                                   (0, 1, 1)), 10)
        del xb, wb, out
        ops = 2 * 27 * t * h * w * ci * co
        nbytes = x_ext.numel() + wk.numel() + 4 * (t + co) + 2 * co \
            + 2 * t * h * w * co
        bound, by = bound_ms(ops, PEAK_INT8, nbytes)
        pix, cot, busy = ic.plan_conv(t, h, wp, w, co)
        say(f"K11 {name}: bit-equal; kernel {ms:.4f} ms ({ops / ms / 1e9:.1f}"
            f" TOP/s; {t * pix * cot} tiles, {busy * 100:.1f} % of the "
            f"positions computed stored), {earlier_note('K11 ' + name)}; "
            f"plain {plain_ms:.4f} ms, cuDNN bf16 F.conv3d {lib_ms:.4f} ms "
            f"(cuDNN / K11 = {lib_ms / ms:.2f}), bound {bound:.4f} ms ({by})")
        rec = dict(shape=name, max_abs_err=err, max_ulps=worst, ms=ms,
                   plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
                   bound_by=by, cudnn_over_k11=lib_ms / ms)
        by_shape.append(rec)
    # 64-bit offsets: a 4K frame's 128-channel stage puts x_ext past 2^31
    # bytes; the kernel's last rows against the plain version of them
    t, h, w, c = 1, 2160, 3840, 128
    x_ext = torch.randint(-127, 128, (t + 2, h + 2, 3872, c), generator=gen,
                          device=device, dtype=torch.int8)
    wk = torch.randint(-127, 128, (c, 27 * c), generator=gen, device=device,
                       dtype=torch.int8)
    xs = torch.rand(t, generator=gen, device=device) * 0.01
    ws = torch.rand(c, generator=gen, device=device) * 0.01
    out = ic.int8_conv3d_ncdhw(x_ext, wk, xs, ws, None, w)[0, :, :, h - 8:]
    ref = ic.int8_conv3d_plain(x_ext[:, h - 8:], wk, xs, ws, None, w)
    if not torch.equal(out, ref):
        fail(f"K11 4K stage ({x_ext.numel()} bytes of x_ext): the last rows "
             "differ from the plain version")
    say(f"K11 Ci=Co=128 T=1 2160x3840 ({x_ext.numel() / 2 ** 31:.2f} x 2^31 "
        "bytes of x_ext): the last 8 rows equal the plain version")
    del x_ext, out, ref
    torch.cuda.empty_cache()
    return {**{k: rec[k] for k in ("max_abs_err", "ms", "plain_ms",
                                    "library_ms", "bound_ms", "bound_by")},
            "by_shape": by_shape}


def k12_moments_error(torch, got, fold, truth):
    """(max |got - truth|, its limit): K12_FOLD_RATIO times the plain
    `_fold`'s own distance from the fp64 truth plus K12_FOLD_ULPS fp32 ulps
    of the truth's largest magnitude."""
    err = (got.double() - truth).abs().max().item()
    ref = (fold.double() - truth).abs().max().item()
    _, e = torch.frexp(truth.abs().max().float())
    return err, K12_FOLD_RATIO * ref + K12_FOLD_ULPS * 2.0 ** (e.item() - 24)


def check_k12_split(torch, fn, x, wt, bs, groups, name):
    """K12's two kernels held apart and together at one shape (the
    tolerances above), failing beyond them; returns what was measured."""
    eps = 1e-6
    a, bc = fn._fold(x, wt, bs, groups, eps)
    out = fn.norm_silu_apply(x, a, bc, 2)
    apply_ulps = bf16_ulps(torch, out, fn.norm_silu_apply_plain(
        x, a, bc, 2)).max().item()
    apply_head = all(torch.equal(out[:, :, f], out[:, :, 2]) for f in (0, 1))
    del out
    xr = x.double().reshape(x.shape[0], groups, x.shape[1] // groups,
                            x.shape[2], -1)
    mean = xr.mean(dim=(2, 4))[:, :, None]
    var = (xr.square().mean(dim=(2, 4))[:, :, None] - mean.square())
    del xr
    inv = torch.rsqrt(var.clamp_min(0) + eps)
    w64 = wt.double().view(1, groups, -1, 1)
    truth = ((inv * w64).reshape(a.shape),
             (bs.double().view(1, groups, -1, 1) - mean * inv * w64)
             .reshape(a.shape))
    moments = [k12_moments_error(torch, got, fold, want) for got, fold, want
               in zip(fn.norm_moments(x, wt, bs, groups, eps), (a, bc),
                      truth)]
    out = fn.norm_silu_head_ncdhw(x, wt, bs, groups, eps)
    torch.cuda.synchronize()
    ref = fn.norm_silu_head_plain(x, wt, bs, groups, eps)
    ulps = bf16_ulps(torch, out, ref)
    share = (ulps <= 1).float().mean().item()
    worst = ulps.max().item()
    del ulps
    rel = rel_l2(out, ref)
    err = (out.float() - ref.float()).abs().max().item()
    head = all(torch.equal(out[:, :, f], out[:, :, 2]) for f in (0, 1))
    finite = bool(torch.isfinite(out).all())
    del out, ref
    say(f"K12 {name}: apply on the plain moments max {apply_ulps:.3g} ulps "
        f"(limit {K12_MAX_ULPS}), head frames equal {apply_head}; moments "
        f"A {moments[0][0]:.3g} (limit {moments[0][1]:.3g}), Bc "
        f"{moments[1][0]:.3g} (limit {moments[1][1]:.3g}) from fp64; whole "
        f"{share * 100:.4f} % within 1 ulp (limit {K12_ULP_SHARE * 100} %), "
        f"max {worst:.3g} ulps (limit {K12_WHOLE_MAX_ULPS}), rel L2 "
        f"{rel:.3g} (limit {K12_REL_L2}), head frames equal {head}")
    if (apply_ulps > K12_MAX_ULPS or not apply_head
            or any(e > lim for e, lim in moments) or share < K12_ULP_SHARE
            or worst > K12_WHOLE_MAX_ULPS or rel > K12_REL_L2 or not head
            or not finite):
        fail(f"K12 {name}: beyond the limits above (finite {finite})")
    return dict(max_abs_err=err, max_ulps=worst, ulp_share=share,
                rel_l2=rel, apply_max_ulps=apply_ulps,
                moments_err=[e for e, _ in moments],
                moments_limit=[lim for _, lim in moments])


def check_k12(torch, fn, device):
    """K12 against its plain version at every distinct (C, T, H, W) of the
    720p clip's fused-norm encode and decode (`check_k12_split`), each
    timed whole with its bound (bytes: x read once, the T + 2 output frames
    written once) and each kernel's device time apart. All shapes are timed
    before any is checked, each after 20 warm-up calls: in a development
    run on the H100, the kernels measured ~17 % slower right after the
    checks' fp64 passes and an empty_cache. The record holds the largest,
    128 channels at 720 x 1280."""
    def inputs(i, c, t, h, w):
        gen = torch.Generator(device).manual_seed(12 + i)
        x = torch.randn(1, c, t, h, w, generator=gen, device=device).to(
            torch.bfloat16)
        return (x, 1 + 0.1 * torch.randn(c, generator=gen, device=device),
                0.1 * torch.randn(c, generator=gen, device=device))

    by_shape = []
    for i, (c, t, h, w) in enumerate(K12_SHAPES):
        x, wt, bs = inputs(i, c, t, h, w)

        def call():
            return fn.norm_silu_head_ncdhw(x, wt, bs, 32)

        nbytes = x.numel() * 2 * (2 * t + 2) / t + 8 * c * t
        bound, by = bound_ms(0, PEAK_FP32, nbytes)
        by_shape.append(dict(
            shape=f"C={c} T={t} {h}x{w}", key=(c, t, h, w),
            ms=kernel_ms(torch, call, 10, warmup=20),
            moments_ms=device_ms(torch, call, 5, only="k12_moments"),
            apply_ms=device_ms(torch, call, 5, only="k12_apply"),
            library_ms=None, bound_ms=bound, bound_by=by, nbytes=nbytes))
        del x
    for i, ((c, t, h, w), r) in enumerate(zip(K12_SHAPES, by_shape)):
        x, wt, bs = inputs(i, c, t, h, w)
        r.update(check_k12_split(torch, fn, x, wt, bs, 32, r["shape"]))
        torch.cuda.empty_cache()
        r["plain_ms"] = kernel_ms(torch, lambda: fn.norm_silu_head_plain(
            x, wt, bs, 32), 3, warmup=1)
        del x
        torch.cuda.empty_cache()
        say(f"K12 {r['shape']}: kernel (moments + apply) {r['ms']:.4f} ms "
            f"({r['nbytes'] / r['ms'] / 1e6:.0f} GB/s), device time moments "
            f"{r['moments_ms']:.4f} + apply {r['apply_ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library none, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}); "
            f"{earlier_note('K12 ' + r['shape'])}")
    rec = by_shape[0]
    return {**{k: rec[k] for k in ("max_abs_err", "ms", "plain_ms",
                                    "library_ms", "bound_ms", "bound_by")},
            "by_shape": by_shape}


def k12_request_sum(k12_rec, launches):
    """K12's time in one fused-norm request: each shape's launches
    {(C, T, H, W): (encode, decode)} times its measured ms and bound;
    fails on a launched shape that check_k12 did not time."""
    timed = {r["key"]: r for r in k12_rec["by_shape"]}
    missing = sorted(set(launches) - set(timed))
    if missing:
        fail(f"K12 launched at shapes K12_SHAPES lacks: {missing}")
    total = {"encode": [0.0, 0.0], "decode": [0.0, 0.0]}
    for key, (n_enc, n_dec) in sorted(launches.items()):
        r = timed[key]
        say(f"K12 {r['shape']}: launches a request encode {n_enc}, decode "
            f"{n_dec}; {r['ms']:.4f} ms each (bound {r['bound_ms']:.4f})")
        for what, n in (("encode", n_enc), ("decode", n_dec)):
            total[what][0] += n * r["ms"]
            total[what][1] += n * r["bound_ms"]
    say(f"K12 a fused-norm 720p clip request: encode {total['encode'][0]:.2f}"
        f" ms (bound {total['encode'][1]:.2f}), decode "
        f"{total['decode'][0]:.2f} ms (bound {total['decode'][1]:.2f}), sum "
        f"{total['encode'][0] + total['decode'][0]:.2f} ms (bound "
        f"{total['encode'][1] + total['decode'][1]:.2f})")


# GGUF writing (the file format's spec: a header, key/value metadata,
# tensor infos with innermost-first dims and offsets, aligned data)
GGUF_F32, GGUF_F16, GGUF_Q8_0, GGUF_Q4_K, GGUF_Q6_K = 0, 1, 8, 12, 14
GGUF_BLOCK = {GGUF_F32: (4, 1), GGUF_F16: (2, 1), GGUF_Q8_0: (34, 32),
              GGUF_Q4_K: (144, 256), GGUF_Q6_K: (210, 256)}


def write_gguf(path, infos, data):
    """infos: [(name, torch shape, type)]; data(i) -> the bytes of tensor i,
    made one at a time so the file is never held in memory. Returns
    [(name, type, file offset, bytes)]."""
    import struct

    def s(b):
        return struct.pack("<Q", len(b)) + b

    sizes = []
    for _, shape, qt in infos:
        nbytes, elems = GGUF_BLOCK[qt]
        n = 1
        for d in shape:
            n *= d
        sizes.append(n // elems * nbytes)
    with open(path, "wb") as f:
        f.write(b"GGUF" + struct.pack("<IQQ", 3, len(infos), 1))
        f.write(s(b"general.alignment") + struct.pack("<II", 4, 32))
        off = 0
        for (name, shape, qt), size in zip(infos, sizes):
            f.write(s(name.encode()) + struct.pack("<I", len(shape)))
            f.write(struct.pack(f"<{len(shape)}Q", *reversed(shape)))
            f.write(struct.pack("<IQ", qt, off))
            off += size + (-size) % 32
        f.write(b"\0" * ((-f.tell()) % 32))
        layout, at = [], f.tell()
        for (name, _, qt), size in zip(infos, sizes):
            layout.append((name, qt, at, size))
            at += size + (-size) % 32
        for i, size in enumerate(sizes):
            raw = data(i)
            if len(raw) != size:
                fail(f"GGUF writer: tensor {infos[i][0]} has {len(raw)} "
                     f"bytes, expected {size}")
            f.write(raw)
            f.write(b"\0" * ((-size) % 32))
    return layout


def q4k_random_blocks(torch, n_blocks, gen, device):
    """Random valid Q4_K blocks (144 bytes: f16 d, f16 dmin, 12 bytes of
    6-bit scales/mins, 128 bytes of 4-bit quants) with small positive d and
    dmin, so the weights have a linear's magnitude."""
    blocks = torch.randint(0, 256, (n_blocks, 144), generator=gen,
                           device=device, dtype=torch.uint8)
    for off, lo, hi in ((0, 2e-5, 5e-5), (2, 1e-5, 3e-5)):
        v = (lo + (hi - lo) * torch.rand(n_blocks, 1, generator=gen,
                                         device=device)).half()
        blocks[:, off:off + 2] = v.view(torch.uint8)
    return blocks


def q6k_random_blocks(torch, n_blocks, gen, device):
    """Random valid Q6_K blocks (210 bytes: 128 bytes of low and 64 of high
    quant bits, 16 int8 scales, f16 d) with a small positive d, so the
    weights have a linear's magnitude."""
    blocks = torch.randint(0, 256, (n_blocks, 210), generator=gen,
                           device=device, dtype=torch.uint8)
    d = (4e-6 + 8e-6 * torch.rand(n_blocks, 1, generator=gen,
                                  device=device)).half()
    blocks[:, 208:210] = d.view(torch.uint8)
    return blocks


def gguf_from_q8_runner(torch, qm, dit, path, device):
    """Write `dit` (a q8-converted 3B or 7B NaDiT) as a Q4_K_M-like GGUF
    file:
    its attention Q8Linears as Q8_0 (the int8 quants as they are, scales
    stored as f16), random Q4_K blocks for its MLP linears but the output
    projections of the first and the last block, which are random Q6_K (a
    Q4_K_M file keeps its outermost feed-forward down projections in
    Q6_K), every
    other linear F16 (dequantized where converted) and vectors F32, all
    under the `model.diffusion_model.` prefix. Returns ({layer: "q8" |
    "affine" | "q6k" | "dense"}, what the q4k lane must make of each linear
    ("q6k": a Q8 linear requantized on the host), and write_gguf's
    layout)."""
    prefix = "model.diffusion_model."
    infos, makers, expect = [], [], {}
    gen = torch.Generator(device).manual_seed(8)
    for name, mod in dit.named_modules():
        if not isinstance(mod, (qm.Q8Linear, torch.nn.Linear)):
            continue
        if isinstance(mod, qm.Q8Linear) and ".attn." in name:
            kind, qt = "q8", GGUF_Q8_0

            def make(mod=mod):
                n, k = mod.q8.shape
                sc = mod.scales.half().reshape(-1, 1).view(torch.uint8)
                qs = mod.q8.reshape(n * k // 32, 32).view(torch.uint8)
                return torch.cat([sc, qs], 1).cpu().numpy().tobytes()
        elif (isinstance(mod, qm.Q8Linear) and ".mlp." in name
              and name.endswith(".proj_out")
              and int(name.split(".")[1]) in (0, len(dit.blocks) - 1)):
            kind, qt = "q6k", GGUF_Q6_K

            def make(mod=mod):
                n, k = mod.q8.shape
                return q6k_random_blocks(torch, n * k // 256, gen,
                                         device).cpu().numpy().tobytes()
        elif isinstance(mod, qm.Q8Linear) and ".mlp." in name:
            kind, qt = "affine", GGUF_Q4_K

            def make(mod=mod):
                n, k = mod.q8.shape
                return q4k_random_blocks(torch, n * k // 256, gen,
                                         device).cpu().numpy().tobytes()
        else:
            kind, qt = "dense", GGUF_F16

            def make(mod=mod):
                w = (qm.dequantize_q8(mod.q8, mod.scales)
                     if isinstance(mod, qm.Q8Linear) else mod.weight)
                return w.half().cpu().numpy().tobytes()
        n, k = (mod.q8 if isinstance(mod, qm.Q8Linear) else mod.weight).shape
        infos.append((f"{prefix}{name}.weight", (n, k), qt))
        makers.append(make)
        expect[name] = kind
    linear_keys = {f"{name}.{leaf}" for name in expect
                   for leaf in ("weight", "q8", "scales")}
    for key, t in dit.state_dict().items():
        if key in linear_keys:
            continue
        qt = GGUF_F32 if t.dim() == 1 else GGUF_F16
        infos.append((prefix + key, tuple(t.shape), qt))
        makers.append(lambda t=t, qt=qt: (t.float() if qt == GGUF_F32
                                          else t.half()).cpu().numpy()
                      .tobytes())
    with torch.no_grad():
        layout = write_gguf(path, infos, lambda i: makers[i]())
    return expect, layout


def gguf_kinds(expect) -> str:
    n = {k: sum(v == k for v in expect.values())
         for k in ("q8", "affine", "q6k", "dense")}
    return (f"{n['q8']} Q8_0, {n['affine']} Q4_K, {n['q6k']} Q6_K and "
            f"{n['dense']} F16 linears")


def check_gguf_modules(torch, qm, dit, q8_dit, expect, label):
    """Every linear of the q4k-loaded GGUF DiT is the module its type calls
    for (a Q6_K one a Q8 linear requantized on the host), the Q8_0 layers'
    buffers equal the q8 DiT's with f16 scales, and biased linears keep
    their biases."""
    kinds = {qm.Q8Linear: "q8", qm.AffineLinear: "affine",
             torch.nn.Linear: "dense"}
    got = {name: kinds.get(type(m)) for name, m in dit.named_modules()
           if type(m) in kinds}
    want = {k: "q8" if v == "q6k" else v for k, v in expect.items()}
    if got != want:
        bad = sorted(k for k in want if got.get(k) != want[k])[:5]
        fail(f"{label} GGUF: linears not the modules their types call for: "
             f"{[(k, want[k], got.get(k)) for k in bad]}")
    src = dict(q8_dit.named_modules())
    for name, kind in expect.items():
        a, b = dit.get_submodule(name), src[name]
        if kind == "q8" and not (torch.equal(a.q8, b.q8) and torch.equal(
                a.scales, b.scales.half().float())):
            fail(f"{label} GGUF: {name}'s Q8 buffers differ from the q8 "
                 "DiT's with f16-rounded scales")
        if getattr(b, "bias", None) is not None and a.bias is None:
            fail(f"{label} GGUF: {name} lost its bias")
    say(f"{label} GGUF: every linear is the module its type calls for "
        f"({gguf_kinds(expect)}); the Q8_0 layers equal the q8 DiT's with "
        f"f16 scales; biases kept")


def grid_of(tiles):
    """'rows x cols of h x w px' for a list of (y, x, h, w) rectangles."""
    if not tiles:
        return "untiled"
    ys = sorted({t[0] for t in tiles})
    xs = sorted({t[1] for t in tiles})
    return f"{len(ys)}x{len(xs)} of {tiles[0][2]}x{tiles[0][3]} px"


def serve(torch, np, cli, runner, requests, device, embeds):
    """Serve (name, frames, resolution, expected shape) requests with the
    runner's VAE tiling; check shape, finiteness and range; print the tile
    grids, wall, phases and peak memory."""
    for name, frames, res, expect in requests:
        runner.vae.last_encode_tiles, runner.vae.last_decode_tiles = [], []
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        out, timings = cli.process_frames(runner, frames, embeds,
                                          resolution=res, seed=42)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
        finite = bool(np.isfinite(out).all())
        say(f"request {name}: out {out.shape} finite={finite} "
            f"range [{out.min():.4f}, {out.max():.4f}]; encode tiles "
            f"{grid_of(runner.vae.last_encode_tiles)}, decode tiles "
            f"{grid_of(runner.vae.last_decode_tiles)}; wall "
            f"{wall:.3f} s record " + format_record(timings)
            + f"; peak device memory {peak:.2f} GiB")
        if out.shape != expect or not finite:
            fail(f"request {name}: expected finite {expect}, got {out.shape}")
        if out.min() < 0.0 or out.max() > 1.0 or out.std() < 1e-3:
            fail(f"request {name}: output outside [0, 1] or degenerate")


def reset_counts(wrappers):
    for w in wrappers.values():
        w.launches = 0


def read_counts(wrappers, needed, path):
    counts = {k: w.launches for k, w in wrappers.items()}
    say(f"launches during the {path} path: {counts}")
    missing = [k for k in needed if counts[k] == 0]
    if missing:
        fail(f"kernels {missing} of the {path} path were never launched")
    return counts


def dit_bytes(torch, im, qm, dit) -> str:
    """The DiT's device bytes: its quantised linears' buffers by kind and
    the rest (bf16 parameters and float buffers)."""
    kinds = {im.W8A8Linear: "w8a8", qm.Q8Linear: "q8",
             qm.AffineLinear: "affine"}
    by, n = {}, {}
    for mod in dit.modules():
        kind = kinds.get(type(mod))
        if kind is not None:  # persistent buffers: a joined gate+up once
            by[kind] = by.get(kind, 0) + sum(
                t.numel() * t.element_size()
                for t in mod.state_dict().values())
            n[kind] = n.get(kind, 0) + 1
    rest = sum(t.numel() * t.element_size() for t in dit.parameters())
    total = sum(by.values()) + rest
    return (", ".join(f"{n[k]} {k} linears {v / 2 ** 30:.3f} GiB"
                      for k, v in by.items())
            + f"{', ' if by else ''}bf16 parameters {rest / 2 ** 30:.3f} GiB,"
            f" total {total / 2 ** 30:.3f} GiB ({total} bytes)")


def check_uniform(torch, nadit, cfg, device, wrappers, txt, tt, models,
                  inputs):
    """The whole DiT on the uniform plan (`build_dit_plan(...,
    uniform=True)`) for each tree of `models` {"bf16", "w8a8"} on each latent
    of UNIFORM_LATENTS, whose (DiT input, grouped plan) `inputs` holds by
    label: the launches of one forward with kernels (32 of K9, none of K1 or
    K2), relative L2 against the plain versions and against the grouped plan
    on the same weights (UNIFORM_REL_L2 for bf16; the w8a8 tree's int8
    quantizations turn bf16 flips into whole steps, so DIT_REL_L2 there),
    and both plans' forward times. Returns the counts of the bf16 forward on
    the 720p clip, the "uniform" path."""
    def forward(model, vid_in, dplan, use_kernels=True):
        with torch.no_grad():
            return nadit.nadit_forward(model, vid_in, txt, tt, dplan,
                                       use_kernels=use_kernels)

    main = None
    limits = {"bf16": UNIFORM_REL_L2, "w8a8": DIT_REL_L2}
    for label, shape in UNIFORM_LATENTS:
        vid_in, dplan_g = inputs[label]
        if dplan_g.plan.vid_shape != shape:
            fail(f"{label}: latent {dplan_g.plan.vid_shape} is not the "
                 f"{shape} K9 was checked at")
        dplan_u = nadit.upload_plan(nadit.build_dit_plan(
            cfg, shape, txt.shape[1], uniform=True), cfg, device)
        for tree, model in models.items():
            limit = limits[tree]
            path = f"uniform {tree} {label}"
            reset_counts(wrappers)
            out_u = forward(model, vid_in, dplan_u)
            torch.cuda.synchronize()
            c = read_counts(wrappers, ("K9",), path)
            if c["K9"] != cfg.num_layers or c["K1"] or c["K2"]:
                fail(f"{path}: {c['K9']} K9, {c['K1']} K1 and {c['K2']} K2 "
                     f"launches in one forward (expected {cfg.num_layers}, "
                     "0, 0)")
            if main is None:
                main = c
            out_p = forward(model, vid_in, dplan_u, use_kernels=False)
            out_g = forward(model, vid_in, dplan_g)
            rel_p, rel_g = rel_l2(out_u, out_p), rel_l2(out_u, out_g)
            del out_p, out_g
            ms_u = cuda_ms(torch, lambda: forward(model, vid_in, dplan_u), 3,
                           warmup=1)
            ms_g = cuda_ms(torch, lambda: forward(model, vid_in, dplan_g), 3,
                           warmup=1)
            peak = {}  # a forward's peak above what is resident before it
            for plan_name, dp in (("uniform", dplan_u), ("grouped", dplan_g)):
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                forward(model, vid_in, dp)
                torch.cuda.synchronize()
                peak[plan_name] = (torch.cuda.max_memory_allocated()
                                   - base) / 2 ** 30
            say(f"whole {tree} DiT on the uniform plan, {label} latent "
                f"{shape} ({dplan_u.plan.seq_len} tokens): relative L2 "
                f"kernels vs plain {rel_p:.6g}, uniform vs grouped plan "
                f"{rel_g:.6g} (bound {limit} each); forward {ms_u:.2f} ms "
                f"uniform, {ms_g:.2f} ms grouped; a forward's peak device "
                f"memory above the resident {base / 2 ** 30:.3f} GiB: "
                f"{peak['uniform']:.3f} GiB uniform, {peak['grouped']:.3f} "
                "GiB grouped")
            if not torch.isfinite(out_u).all() or rel_p > limit \
                    or rel_g > limit:
                fail(f"{path}: kernels vs plain {rel_p}, vs grouped {rel_g} "
                     f"(limit {limit})")
            del out_u
    torch.cuda.empty_cache()
    return main


def rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm()).item()


def env_set(name, value):
    """Set (value) or clear (None) an environment variable; returns its
    earlier value."""
    old = os.environ.get(name)
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value
    return old


def top_device_kernels(torch, fn, n=3):
    """Run fn() once under torch.profiler: its device busy seconds, the
    peak device memory of that run above what was allocated before it, and
    its `n` device events that took the most time [(name, ms)]."""
    from torch.profiler import ProfilerActivity, profile

    from seedvr2_tpu_torch.profile_requests import _device_us

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
    events = prof.key_averages()
    busy = sum(_device_us(e) for e in events) / 1e6
    top = sorted(events, key=_device_us, reverse=True)[:n]
    return busy, peak, [(e.key, _device_us(e) / 1e3) for e in top]


def check_vae_lowerings(torch, np, cli, pipeline, VideoVAE, vae_cfg, device,
                        embeds, clip):
    """Phase 10. VideoVAEs built under each lowering switch alone (the
    environment read at construction, over the default runner's VAE
    weights): encode and decode of the 720p clip against the default
    lowering and against the fp32 VAE (LOWERING_SWITCHES' bounds). Then the
    default 3B path serves the 1080p clip under SEEDVR2_UPSAMPLE_CONVT=0:
    request wall and phases, the request's peak memory, and a profiled
    decode of its latent (device seconds, the decode's peak memory, its
    top device kernels). The same request under the transposed conv (10 s
    of one int64 cuDNN kernel, rows kept in PERF.md) is left out to
    make room for phases 10b-10c."""
    import copy

    from seedvr2_tpu_torch.profile_requests import make_frames

    t0 = time.perf_counter()
    base = cli.make_runner(device, seed=0)
    model = base.vae.model
    default = base.vae
    if default.lowering != type(default.lowering)():
        fail(f"the default VAE lowering is {default.lowering}, not JAX's "
             "defaults")
    samples = []
    encode = base.vae_encode
    base.vae_encode = lambda s: (samples.extend(s), encode(s))[1]
    ctx = pipeline.encode_all_batches(
        base, pipeline.setup_generation_context(device), clip, resolution=720)
    del base.vae_encode
    x_in = samples[0][None]
    latent = ctx["all_latents"][0]
    z = (latent.float() / vae_cfg.scaling_factor
         + vae_cfg.shifting_factor)[None]
    del ctx, samples

    def both(vae, dtype=torch.bfloat16):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with torch.no_grad():
            enc = vae.encode(x_in.to(dtype))
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            dec = vae.decode(z.to(dtype))
            torch.cuda.synchronize()
        return enc, dec, t2 - t1, time.perf_counter() - t2

    ref = both(default)
    vae32 = VideoVAE(copy.deepcopy(model).float(), torch.float32)
    truth = both(vae32, torch.float32)[:2]
    del vae32
    err_default = [rel_l2(ref[i], truth[i]) for i in range(2)]
    say(f"VAE lowerings built in {time.perf_counter() - t0:.2f} s; default "
        f"{default.lowering}: encode {ref[2]:.3f} s, decode {ref[3]:.3f} s "
        f"(720p clip), relative L2 to the fp32 VAE {err_default[0]:.6g} / "
        f"{err_default[1]:.6g}")
    vaes = {}
    for env, value, field in LOWERING_SWITCHES:
        old = env_set(env, value)
        try:
            vae = VideoVAE(model, torch.bfloat16)
        finally:
            env_set(env, old)
        if getattr(vae.lowering, field) == getattr(default.lowering, field):
            fail(f"{env}={value} did not reach the VAE built under it")
        if VideoVAE(model, torch.bfloat16).lowering != default.lowering:
            fail(f"{env} leaked into a VAE built after it was cleared")
        vaes[env] = vae
        out = both(vae)
        bad = False
        for i, what in enumerate(("encode", "decode")):
            rel, err = rel_l2(out[i], ref[i]), rel_l2(out[i], truth[i])
            say(f"{env}={value} {what}, 720p clip: relative L2 to the "
                f"default lowering {rel:.6g} (bound {FUSED_VAE_REL_L2}), to "
                f"the fp32 VAE {err:.6g} (bound {FUSED_FP32_RATIO}x the "
                f"default's {err_default[i]:.6g}); {out[2 + i]:.3f} s "
                f"(default {ref[2 + i]:.3f} s)")
            bad |= (not torch.isfinite(out[i]).all()
                    or rel > FUSED_VAE_REL_L2
                    or err > FUSED_FP32_RATIO * err_default[i])
        if bad:
            fail(f"{env}={value}: the VAE beyond the limits above")
        del out
    del ref, truth, x_in, z
    torch.cuda.empty_cache()

    label, t, h, w, res = UPSAMPLE_AB_REQUEST
    frames = make_frames(t, h, w, seed=40)
    expect = (t, res, res * w // h, 3)
    for form, vae in (("SEEDVR2_UPSAMPLE_CONVT=0 (matmul + pixel shuffle)",
                       vaes["SEEDVR2_UPSAMPLE_CONVT"]),):
        base.vae = vae
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        held = torch.cuda.memory_allocated(device) / 2 ** 30
        t1 = time.perf_counter()
        out, timings = cli.process_frames(base, frames, embeds,
                                          resolution=res, seed=42)
        wall = time.perf_counter() - t1
        peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
        if out.shape != expect or not np.isfinite(out).all():
            fail(f"{form} {label}: expected finite {expect}, got "
                 f"{out.shape}")
        profiled = ""
        if vae is not default:
            ctx = pipeline.encode_all_batches(
                base, pipeline.setup_generation_context(device), frames,
                resolution=res)
            lat = ctx["all_latents"][0]
            del ctx
            busy, dec_peak, top = top_device_kernels(
                torch, lambda: base.vae_decode([lat]))
            del lat
            profiled = (
                f"; profiled decode: device {busy:.3f} s, decode peak "
                f"{dec_peak:.2f} GiB above the memory held before it, top "
                "kernels " + "; ".join(f"{ms:.1f} ms {name[:90]}"
                                       for name, ms in top))
        say(f"{form}, {label} (default 3B path): wall {wall:.3f} s, record "
            + format_record(timings)
            + f"; request peak {peak:.2f} GiB ({held:.2f} held before it: "
            f"the runner's models)" + profiled)
    del base, default, vaes, encode, out
    torch.cuda.empty_cache()


def check_7b_kernels(torch, fa, gather, im, fq, qm, nadit, device):
    """Phase 11a. The kernels of the 7B's lanes against their plain versions
    at its shapes (24 heads, D = 3072, MLP 3072 -> 12288 with bias), timed
    with bound and library call as at the 3B's: K1 at every window group of
    the 720p clip's plan and the 1080p clip's largest; K2 on both clips'
    transitions; K3 and K4 at the throughput lane's 1080p clip (16320
    rows); K6 and K7 at the GGUF lane's 720p clip (7200 rows). Returns
    {kernel: record} with each kernel's record at its 7B path's main
    shape (K6 and K7 with every shape under by_shape). The short calls'
    times (K1's pre-pass, K3 / K4 / K6 / K7 at the text's rows, K7's
    pre-pass) are read with queued_ms: this late in the run torch.profiler
    records no device events."""
    from seedvr2_tpu_torch.core.configs import DIT_7B, VAE_V3

    lat = {label: latent_shape(VAE_V3, t, h, w, res)
           for label, t, h, w, res in DIT7B_FAST_REQUESTS}
    rows = [(label, nadit.build_dit_plan(DIT_7B, shape, TXT_LEN).seq_len)
            for label, shape in lat.items()]
    (_, t, h, w, res), = DIT7B_GGUF_REQUESTS
    gguf_rows = [("clip 720", nadit.build_dit_plan(DIT_7B, latent_shape(
        VAE_V3, t, h, w, res), TXT_LEN).seq_len)]
    say(f"7B kernel checks: throughput rows {rows}, GGUF rows {gguf_rows}")
    recs = {"K1": check_k1(torch, fa, nadit, DIT_7B, device,
                           [("1080p clip", s) for s in lat.values()],
                           tag="7B ", random_tables=False, timer=queued_ms),
            "K2": check_k2(torch, gather, nadit, DIT_7B, device,
                           list(lat.items())),
            "K3": check_k3(torch, im, DIT_7B, device, rows, tag="7B ",
                           timer=queued_ms)}
    recs.update(check_k4_k5(torch, fq, DIT_7B, device, rows,
                            timer=queued_ms))
    recs.update(check_k6_k7(torch, qm, DIT_7B, device,
                            {"K6": gguf_rows, "K7": gguf_rows},
                            main={"K6": "clip 720 qkv",
                                  "K7": "clip 720 mlp in"}, tag="7B ",
                            timer=queued_ms))
    return recs


def rgba_frames(np, make_frames, t, h, w, seed, soft):
    """RGB from make_frames plus an alpha: a hard-edged disc (mostly 0 / 1,
    the binary path) or a soft diagonal ramp (the gradient path)."""
    yy, xx = np.mgrid[:h, :w] / max(h, w)
    if soft:
        alpha = np.clip(xx + 0.5 * yy - 0.2, 0.0, 1.0)
    else:
        alpha = ((yy - 0.28) ** 2 + (xx - 0.5) ** 2 < 0.04).astype(np.float32)
    alpha = np.broadcast_to(alpha[None, :, :, None], (t, h, w, 1))
    return np.concatenate([make_frames(t, h, w, seed), alpha],
                          -1).astype(np.float32)


def check_request_surface(torch, np, cli, pipeline, nadit, runner, device,
                          embeds, txt, tt, clip, wrappers):
    """Phase 4b on the default 3B runner. (a) RGBA requests (RGBA_REQUEST
    with RGBA_OPTIONS: uniform batches, both noise scales,
    wavelet_adaptive), binary and soft alpha, and the same request in RGB:
    shapes, ranges, K1 / K2 launches equal; each colour method on the 720p
    clip (the postprocess phase per method). (b) The six colour methods at
    COLOUR_SHAPES and process_alpha_for_batch on one 720p batch, with TF32
    at torch's defaults: card time (CUDA events, warm), peak memory above
    the inputs, held against the same function on the CPU. (c) The 720p
    clip's latent decoded tiled in ref mode, against the planner and the
    untiled and uniform decodes; the clip served with tile_debug="decode".
    (d) One DiT forward under each of the t2v and i2v conditions. Returns
    the RGBA request's launch counts and finish(), which holds (b)'s card
    results against the CPU's: those run in a worker thread, beside (c),
    (d) and the phases after this one."""
    from dataclasses import replace

    from seedvr2_tpu_torch.core import alpha as talpha
    from seedvr2_tpu_torch.models.vae import pipeline_vae
    from seedvr2_tpu_torch.profile_requests import make_frames
    from seedvr2_tpu_torch.utils import color_fix

    t, h, w, res = RGBA_REQUEST
    expect = (t, res, res * w // h, 4)
    post_peak = []  # the postprocess phase's peak above what it found
    postprocess = pipeline.postprocess_all_batches

    def measured_postprocess(*args, **kwargs):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        out = postprocess(*args, **kwargs)
        post_peak.append((torch.cuda.max_memory_allocated(device) - base)
                         / 2 ** 30)
        return out

    def request(label, frames, **options):
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        out, timings = cli.process_frames(runner, frames, embeds,
                                          resolution=res, seed=42, **options)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
        finite = bool(np.isfinite(out).all())
        say(f"request {label}: out {out.shape} finite={finite} rgb range "
            f"[{out[..., :3].min():.4f}, {out[..., :3].max():.4f}]; wall "
            f"{wall:.3f} s record " + format_record(timings)
            + f"; peak device memory {peak:.2f} GiB (postprocess "
            f"{post_peak[-1]:.2f} GiB above what it found)")
        if not finite or out.min() < 0.0 or out.max() > 1.0 \
                or out[..., :3].std() < 1e-3:
            fail(f"request {label}: not finite, outside [0, 1] or degenerate")
        return out

    # (a) RGBA requests, and the same request in RGB
    pipeline.postprocess_all_batches = measured_postprocess
    try:
        launches = {}
        for soft in (False, True):
            frames = rgba_frames(np, make_frames, t, h, w, 40, soft)
            label = (f"RGBA {'soft' if soft else 'binary'} alpha "
                     f"{t}x{h}x{w} -> {res}")
            reset_counts(wrappers)
            out = request(label, frames, **RGBA_OPTIONS)
            launches[label] = {k: wr.launches for k, wr in wrappers.items()}
            a = out[..., 3]
            share = float(((a < 0.01) | (a > 0.99)).mean())
            say(f"  alpha: range [{a.min():.4f}, {a.max():.4f}], "
                f"{share * 100:.2f} % of pixels within 0.01 of 0 or 1")
            if out.shape != expect or (share > 0.5) == soft:
                fail(f"{label}: shape {out.shape} (expected {expect}) or "
                     f"alpha not on its path ({share} near 0 / 1)")
        counts = launches[next(iter(launches))]
        reset_counts(wrappers)
        request(f"RGB {t}x{h}x{w} -> {res}", frames[..., :3], **RGBA_OPTIONS)
        rgb_counts = {k: wr.launches for k, wr in wrappers.items()}
        say(f"launches during the request_surface path: {counts}; the RGB "
            f"request's {rgb_counts}")
        if counts["K1"] == 0 or counts["K2"] == 0 or any(
                c[k] != rgb_counts[k] for c in launches.values()
                for k in ("K1", "K2")):
            fail("RGBA requests: K1 / K2 not launched, or not as often as "
                 "by the same request in RGB")
        for method in color_fix.METHODS:
            request(f"clip 5x360x640 -> 720, {method}", clip,
                    color_correction=method)
    finally:
        pipeline.postprocess_all_batches = postprocess

    # (b) the colour methods and alpha, TF32 at torch's defaults, on the
    # card; the same functions on the CPU run in a worker thread beside
    # the phases that follow (finish() compares)
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    jobs = []  # (label, kind, CPU function, its inputs, the card's output)
    try:
        for shape in COLOUR_SHAPES:
            gen = torch.Generator(device).manual_seed(sum(shape))
            content = torch.rand(*shape, 3, generator=gen,
                                 device=device) * 2 - 1
            style = (torch.rand(*shape, 3, generator=gen, device=device)
                     * 1.6 - 0.7).clamp(-1, 1)
            c_cpu, s_cpu = content.cpu(), style.cpu()
            for method in color_fix.METHODS:
                def fn(c, s, method=method):
                    return color_fix.apply_color_correction(method, c, s)
                ms = cuda_ms(torch, lambda: fn(content, style), 3, warmup=1)
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated(device)
                torch.cuda.reset_peak_memory_stats(device)
                out = fn(content, style)
                torch.cuda.synchronize()
                peak = (torch.cuda.max_memory_allocated(device)
                        - base) / 2 ** 30
                label = f"colour {method} at {shape}"
                say(f"{label}: {ms:.3f} ms on the card, peak {peak:.3f} GiB "
                    "above the inputs")
                if not torch.isfinite(out).all():
                    fail(f"{label}: non-finite output")
                jobs.append((label, method, fn, (c_cpu, s_cpu), out.cpu()))
                del out
            del content, style
        t1, h1, w1 = COLOUR_SHAPES[0]
        gen = torch.Generator(device).manual_seed(7)
        rgb_up = torch.rand(t1, h1, w1, 3, generator=gen,
                            device=device) * 2 - 1
        for soft in (False, True):
            alpha = rgba_frames(np, make_frames, t1, h1 // 2, w1 // 2, 41,
                                soft)[..., 3:]
            ms = cuda_ms(torch, lambda: talpha.process_alpha_for_batch(
                rgb_up, alpha), 3, warmup=1)
            out = talpha.process_alpha_for_batch(rgb_up, alpha)
            label = (f"alpha ({'gradient' if soft else 'binary'} path) at "
                     f"{tuple(rgb_up.shape)}")
            say(f"{label}: {ms:.3f} ms on the card")
            if not torch.isfinite(out).all():
                fail(f"{label}: non-finite output")
            jobs.append((label, "alpha", talpha.process_alpha_for_batch,
                         (rgb_up.cpu(), alpha), out.cpu()))
        del rgb_up, out
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved

    def cpu_references():
        rows = []
        for label, kind, fn, args, got in jobs:
            t0 = time.perf_counter()
            diff = (got - fn(*args)).abs()
            rows.append((label, kind, time.perf_counter() - t0,
                         diff.max().item(),
                         (diff > 1e-4).float().mean().item()))
        return rows

    pool = concurrent.futures.ThreadPoolExecutor(1)
    pending = pool.submit(cpu_references)

    def finish():
        """Hold the card's colour and alpha results against the CPU's."""
        try:
            rows = pending.result(timeout=900)
        finally:
            pool.shutdown()
        bad = []
        for label, kind, cpu_s, worst, share in rows:
            ok = {"adain": worst <= COLOUR_EXACT_ABS,
                  "wavelet": worst <= COLOUR_EXACT_ABS,
                  "none": worst == 0.0,
                  "lab": worst <= LAB_MAX_ABS and share <= BINNED_SHARE,
                  }.get(kind, share <= BINNED_SHARE)
            say(f"{label} against the CPU ({cpu_s:.2f} s there): max abs "
                f"{worst:.3g}, {share * 100:.4f} % beyond 1e-4")
            if not ok:
                bad.append(label)
        if bad:
            fail(f"{bad}: the card's result is not the CPU's within the "
                 "stated tolerance")
        jobs.clear()

    # (c) ref-mode tiles on the 720p clip's latent
    ctx = pipeline.encode_all_batches(
        runner, pipeline.setup_generation_context(device), clip,
        resolution=res)
    latent = ctx["all_latents"][0]
    del ctx
    z = (latent.float() / runner.config.vae.scaling_factor
         + runner.config.vae.shifting_factor).to(torch.bfloat16)[None]
    sf = runner.config.vae.spatial_downsample_factor
    lt, lo = REF_TILE // sf, REF_OVERLAP // sf
    plan = [(y * sf, x * sf, (ye - y) * sf, (xe - x) * sf)
            for y, ye, x, xe in pipeline_vae._plan_ref(
                z.shape[2], z.shape[3], lt, lt, lo, lo)]
    kw = dict(tiled=True, tile_size=(REF_TILE,) * 2,
              tile_overlap=(REF_OVERLAP,) * 2)
    with torch.no_grad():
        whole = runner.vae.decode(z)
        uniform = runner.vae.decode(z, tile_mode="uniform", **kw)
        uni_tiles = list(runner.vae.last_decode_tiles)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = runner.vae.decode(z, tile_mode="ref", **kw)
        torch.cuda.synchronize()
        ref_s = time.perf_counter() - t0
    tiles = list(runner.vae.last_decode_tiles)
    d_ref, d_uni = rel_l2(ref, whole), rel_l2(uniform, whole)
    say(f"ref-mode decode of latent {tuple(z.shape)} at {REF_TILE} px tiles, "
        f"{REF_OVERLAP} px overlap: {len(tiles)} tiles (y, x, h, w) "
        f"{tiles[:3]} .. {tiles[-1]}, shapes "
        f"{sorted({(t_[2], t_[3]) for t_ in tiles})}, in "
        f"{ref_s:.3f} s; relative L2 to the untiled decode {d_ref:.6g}, the "
        f"uniform grid's ({grid_of(uni_tiles)}) {d_uni:.6g} (bound "
        f"{REF_TILED_RATIO}x)")
    if tiles != plan or len({(t_[2], t_[3]) for t_ in tiles}) < 2 \
            or not torch.isfinite(ref).all() \
            or d_ref > REF_TILED_RATIO * d_uni:
        fail("ref-mode decode: tiles not the planner's, no edge tile of "
             "another shape, or farther from the untiled decode than the "
             "bound")
    del whole, uniform, ref
    tiling = runner.tiling
    runner.tiling = replace(tiling, decode_tiled=True,
                            decode_tile_size=(REF_TILE,) * 2,
                            decode_tile_overlap=(REF_OVERLAP,) * 2,
                            tile_mode="ref")
    try:
        pipeline.postprocess_all_batches = measured_postprocess
        out = request("clip 5x360x640 -> 720, ref tiles, tile_debug=decode",
                      clip, tile_debug="decode")
    finally:
        pipeline.postprocess_all_batches = postprocess
        runner.tiling = tiling
    colour = np.array([1.0, 0.2, 0.2], np.float32)
    on_lines = True
    for (y, x, th, tw) in runner.vae.last_decode_tiles:
        y2 = min(y + th, out.shape[1]) - 1
        x2 = min(x + tw, out.shape[2]) - 1
        for px in (out[:, y:y2 + 1, x], out[:, y:y2 + 1, x2],
                   out[:, y, x:x2 + 1], out[:, y2, x:x2 + 1]):
            on_lines &= bool((px == colour).all())
    if runner.vae.last_decode_tiles != plan or not on_lines:
        fail("tile_debug=decode: the overlay is not on the recorded ref "
             "tiles")
    say(f"tile_debug=decode: the overlay lies on all {len(plan)} recorded "
        "tile outlines")

    # (d) the t2v and i2v conditions, one forward each
    gen = torch.Generator(device).manual_seed(42)
    noise = torch.randn(latent.shape, generator=gen, device=device).to(
        torch.bfloat16)
    dplan = runner.plan(tuple(latent.shape[:3]), txt.shape[1])
    for task in ("t2v", "i2v"):
        cond = runner.get_condition(noise, latent, task)
        with torch.no_grad():
            pred = nadit.nadit_forward(runner.dit, torch.cat([noise, cond],
                                                             -1)[None],
                                       txt, tt, dplan)
        say(f"{task} condition: DiT forward on latent {tuple(latent.shape)} "
            f"-> {tuple(pred.shape)}, finite="
            f"{bool(torch.isfinite(pred).all())}, std "
            f"{pred.float().std().item():.4f}")
        if not torch.isfinite(pred).all() or pred.shape[1:] != noise.shape:
            fail(f"{task} condition: DiT output not finite or misshapen")
    del latent, z, noise, cond, pred, out
    torch.cuda.empty_cache()
    return counts, finish


def run_7b(torch, np, cli, nadit, im, qm, gguf, native, device, txt, tt,
           embeds, dit_inputs, dit_runs, lane, counts, phase_done, wrappers):
    """Phase 11. The full-width 7B (36 blocks, D = 3072, 24 heads) with
    random weights from a seed: the bf16 DiT's forward with kernels against
    plain versions on the 720p and 1080p clips' latents (DIT_REL_L2); the
    default path served (K1, K2); the same weights in w8a8, its forward on
    the 1080p latent (W8A8_DIT_REL_L2, closer to its plain version than to
    the bf16 DiT) and `--preset throughput` served (K1-K4, no K5: the 7B
    MLP has no gate); a full-size 7B Q4_K_M-like GGUF file written, loaded
    through cli.make_runner(quant="q4k") with every linear the module its
    type calls for, and served (K1, K2, K6, K7); loaded again through the
    numpy dequantizers (seconds side by side, the same DiT, the same
    output) while every Q8_0 / Q4_K / Q6_K tensor is held bit for bit to
    numpy in host threads. `lane` records each lane's launches in
    `counts`."""
    import shutil
    import tempfile

    from seedvr2_tpu_torch.core.configs import DIT_7B, VAE_V3
    from seedvr2_tpu_torch.profile_requests import make_frames

    t0 = time.perf_counter()
    r7 = cli.make_runner(device, seed=0, dit_cfg=DIT_7B)
    torch.cuda.synchronize()
    cfg = r7.dit.cfg
    n_dit = sum(p.numel() for p in r7.dit.parameters())
    if (cfg != DIT_7B or len(r7.dit.blocks) != 36 or cfg.vid_dim != 3072
            or cfg.heads != 24):
        fail(f"the 7B runner's DiT is not the full-width 7B: {cfg}")
    say(f"7B DiT built on the card in {time.perf_counter() - t0:.2f} s: "
        f"{n_dit / 1e9:.3f} B params ({cfg.num_layers} blocks, width "
        f"{cfg.vid_dim}, {cfg.heads} heads), {dit_bytes(torch, im, qm, r7.dit)}")
    inputs = {}
    for label, t, h, w, res in (DIT7B_REQUESTS[0], DIT7B_FAST_REQUESTS[0]):
        inputs[label] = dit_inputs(r7, make_frames(t, h, w, seed=50), res)
        if inputs[label][1].plan.vid_shape != latent_shape(VAE_V3, t, h, w,
                                                           res):
            fail(f"7B {label}: latent {inputs[label][1].plan.vid_shape}")
        dit_runs(r7.dit, f"7B bf16 ({label})", *inputs[label], DIT_REL_L2)
    phase_done("11 (whole 7B bf16 DiT)")
    lane("7b_default", r7, DIT7B_REQUESTS, ("K1", "K2"), "11c")
    label = DIT7B_FAST_REQUESTS[0][0]
    blockswap_phase(torch, np, cli, nadit, r7, device, embeds, wrappers,
                    counts, (label, *inputs[label], txt, tt))
    phase_done("11b (BlockSwap and memory tiering)")

    args = cli.parse_arguments(["unused.npy", "--preset", "throughput"])
    t0 = time.perf_counter()
    fast7 = cli.make_runner(device, seed=0, quant=args.quant,
                            tiling=cli.tiling_from_args(args),
                            dit_cfg=DIT_7B)
    torch.cuda.synchronize()
    w8 = [m for m in fast7.dit.modules() if isinstance(m, im.W8A8Linear)]
    say(f"7B w8a8 DiT built and converted in {time.perf_counter() - t0:.2f}"
        f" s: {dit_bytes(torch, im, qm, fast7.dit)}")
    if any(hasattr(m, "gate_up_w8a8") for m in w8) or not all(
            isinstance(b.mlp[br].proj_in, im.W8A8Linear)
            and b.mlp[br].proj_in.bias is not None
            for b in fast7.dit.blocks for br in ("vid", "txt")):
        fail("7B w8a8: the MLP linears are not biased w8a8 linears on their "
             "own")
    vid_in, dplan = inputs[DIT7B_FAST_REQUESTS[0][0]]
    outs, w8_rel = dit_runs(fast7.dit, "7B w8a8", vid_in, dplan,
                            W8A8_DIT_REL_L2)
    with torch.no_grad():
        dense = nadit.nadit_forward(r7.dit, vid_in, txt, tt, dplan)
    to_dense = rel_l2(outs[True], dense)
    say(f"7B w8a8 against the 7B bf16 DiT, same weights, 1080p clip latent: "
        f"relative L2 {to_dense:.6g}; w8a8 kernels vs plain {w8_rel:.6g} "
        f"must be the smaller")
    if not w8_rel < to_dense:
        fail(f"the 7B w8a8 DiT with kernels is no closer to its plain "
             f"version ({w8_rel}) than to the bf16 DiT ({to_dense})")
    del r7, outs, dense, inputs
    torch.cuda.empty_cache()
    lane("7b_throughput", fast7, DIT7B_FAST_REQUESTS,
         ("K1", "K2", "K3", "K4"), "11d")
    if counts["7b_throughput"]["K5"] != 0:
        fail("K5 launched on the 7B w8a8 lane, whose MLP has no gate")
    streamed_w8a8(torch, nadit, fast7, vid_in, dplan, txt, tt, device,
                  wrappers, counts)
    phase_done("11b (the 7B w8a8 tree streamed)")
    del fast7, w8, vid_in, dplan
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    q8 = cli.make_runner(device, seed=0, quant="q8", dit_cfg=DIT_7B)
    torch.cuda.synchronize()
    say(f"7B q8 DiT built in {time.perf_counter() - t0:.2f} s (the GGUF "
        f"file's source): {dit_bytes(torch, im, qm, q8.dit)}")
    with tempfile.TemporaryDirectory() as tmp:
        free = shutil.disk_usage(tmp).free
        say(f"free disk at {tmp}: {free / 2 ** 30:.1f} GiB (needs "
            f"{GGUF_7B_FREE_BYTES / 2 ** 30:.0f})")
        if free < GGUF_7B_FREE_BYTES:
            fail("not enough free disk for the 7B GGUF file")
        path = os.path.join(tmp, "seedvr2_ema_7b-Q4_K_M.gguf")
        t0 = time.perf_counter()
        expect, layout = gguf_from_q8_runner(torch, qm, q8.dit, path, device)
        size = os.path.getsize(path)
        say(f"7B GGUF written in {time.perf_counter() - t0:.2f} s: "
            f"{size / 2 ** 30:.3f} GiB, {gguf_kinds(expect)}")
        gg, gg_np, _ = gguf_loads(torch, cli, gguf, native, path, device,
                                  "7B")
        say(f"7B GGUF DiT on the card: {dit_bytes(torch, im, qm, gg.dit)}")
        finish = gguf_block_check(np, gguf, native, path, layout)
        if gg.dit.cfg != DIT_7B:
            fail(f"the 7B GGUF loaded as {gg.dit.cfg}")
        check_gguf_modules(torch, qm, gg.dit, q8.dit, expect, "7B")
        del q8
        torch.cuda.empty_cache()
        lane("7b_gguf", gg, DIT7B_GGUF_REQUESTS, ("K1", "K2", "K6", "K7"),
             "11e")
        label, t, h, w, res = DIT7B_GGUF_REQUESTS[0]
        same_request(torch, np, cli, (gg, gg_np),
                     make_frames(t, h, w, seed=20), res, embeds,
                     f"7B GGUF q4k {label}")
        del gg, gg_np
        torch.cuda.empty_cache()
        finish("7B")


def host_available() -> int:
    """MemAvailable of /proc/meminfo in bytes."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    fail("no MemAvailable in /proc/meminfo")


def swap_numbers(stats, since):
    """Per-block copy and stall ms (mean / max) of the swaps recorded after
    `since` = (copies, stalls) counts, and the copies' mean GB/s."""
    stats.summary()  # resolves the events
    copies = stats.copy_ms[since[0]:]
    stalls = stats.block_times[since[1]:]
    mean = sum(copies) / len(copies)
    return (f"{len(copies)} streamed blocks of {stats.block_bytes / 1e6:.1f}"
            f" MB: copy {mean:.3f} / {max(copies):.3f} ms (mean / max), "
            f"{stats.block_bytes / (mean * 1e6):.2f} GB/s; stall "
            f"{sum(stalls) / len(stalls):.3f} / {max(stalls):.3f} ms; one "
            f"synchronous upload {stats.measured_transfer_ms:.3f} ms")


def timed_forward(torch, fwd):
    """(output, wall ms) of one DiT forward, synchronised at both ends."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        out = fwd()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def blockswap_phase(torch, np, cli, nadit, r7, device, embeds, wrappers,
                    counts, forward_case):
    """Phase 11b on the resident 7B runner of phase 11 (random weights
    from seed 0). (a) Its bf16 DiT resident, then with BLOCKSWAP_KEEPS
    blocks kept on the card and the rest streamed from pinned host memory
    (StreamedNaDiT takes the same module over), serves the 720p clip and
    the 1080p image; each output must equal the resident one bit for bit,
    and K1 / K2 launch from streamed blocks (the keep-0 run's counts equal
    the resident lane's). Each also runs one forward on the 1080p clip's
    latent (forward_case: label, vid_in, dplan, txt, tt), bit-equal to the
    resident forward, with its copy and stall times. (b) Under a memory fraction emulating a 24 GiB
    card, configure_runner builds the 7B from seed 0 afresh and must pick
    per-phase offload; the 720p clip served with auto tiles may not retry
    on out-of-memory, and its reserved peak must stay within the limit;
    (d) a second call with both cache flags must return the same runner in
    under 0.1 s. Under a 16 GiB emulation it must pick streaming. Then the
    resident 7B serves the clip with (b)'s tiles as ints: equal output.
    r7's DiT ends resident again."""
    import tempfile

    from seedvr2_tpu_torch.core import model_cache, model_manager
    from seedvr2_tpu_torch.core.configs import DIT_7B
    from seedvr2_tpu_torch.core.runner import VAETiling, VideoDiffusionRunner
    from seedvr2_tpu_torch.ops import offload
    from seedvr2_tpu_torch.profile_requests import make_frames
    from seedvr2_tpu_torch.utils import memplan

    dit_bytes7 = offload.module_bytes(r7.dit)
    avail = host_available()
    say(f"host memory available before pinning the 7B DiT "
        f"({dit_bytes7 / 1e9:.2f} GB): {avail / 2 ** 30:.1f} GiB")
    if avail < 2.5 * dit_bytes7:
        fail(f"phase 11b pins the 7B DiT twice beside a host copy; "
             f"{avail / 2 ** 30:.1f} GiB of host memory is too small")
    requests = []
    for i, (label, t, h, w, res) in enumerate(DIT7B_REQUESTS):
        requests.append((label, make_frames(t, h, w, seed=60 + i), res))

    def serve_all(runner, name, stats=None):
        outs = []
        for label, frames, res in requests:
            since = ((len(stats.copy_ms), len(stats.block_times))
                     if stats is not None else None)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(device)
            t0 = time.perf_counter()
            out, timings = cli.process_frames(runner, frames, embeds,
                                              resolution=res, seed=42)
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
            say(f"7B {name}, {label}: wall {wall:.3f} s, dit "
                f"{timings['dit']:.4f} s, peak device memory {peak:.2f} GiB"
                + ("" if stats is None else "; " + swap_numbers(stats, since)))
            if not np.isfinite(out).all():
                fail(f"7B {name} {label}: non-finite output")
            outs.append(out)
        return outs

    ref = serve_all(r7, "resident (keep 36)")
    label_f, vid_f, plan_f, txt, tt = forward_case
    ref_f, ms = timed_forward(torch, lambda: nadit.nadit_forward(
        r7.dit, vid_f, txt, tt, plan_f))
    say(f"7B resident (keep 36) forward on the {label_f} latent: {ms:.2f} ms")
    for keep in BLOCKSWAP_KEEPS:
        t0 = time.perf_counter()
        sd = offload.StreamedNaDiT(r7.dit, keep_blocks=keep, device=device)
        say(f"StreamedNaDiT keep {keep}: {len(sd.host)} blocks packed into "
            f"pinned host memory in {time.perf_counter() - t0:.2f} s; the "
            f"card holds {sd.resident_bytes() / 2 ** 30:.2f} GiB of the DiT "
            f"(IO, kept blocks, two slots of {sd.slots[0].numel() / 1e6:.1f}"
            f" MB)")
        if not all(p.buffer.is_pinned() for p in sd.host):
            fail("a streamed block's host pack is not page-locked")
        runner = VideoDiffusionRunner(None, r7.vae, r7.config,
                                      compute_dtype=r7.compute_dtype,
                                      tiling=r7.tiling, streamed_dit=sd)
        reset_counts(wrappers)
        outs = serve_all(runner, f"streamed (keep {keep})", sd.stats)
        path = f"7b_blockswap_keep{keep}"
        counts[path] = read_counts(wrappers, ("K1", "K2"), path)
        same = [np.array_equal(o, r) for o, r in zip(outs, ref)]
        say(f"streamed keep {keep} against resident, bit for bit: {same}")
        if not all(same):
            fail(f"the streamed 7B (keep {keep}) differs from the resident "
                 "7B")
        if keep == 0 and any(counts[path][k] != counts["7b_default"][k]
                             for k in ("K1", "K2")):
            fail("the fully streamed 7B launched K1 / K2 other times than "
                 "the resident lane")
        since = (len(sd.stats.copy_ms), len(sd.stats.block_times))
        out_f, ms = timed_forward(torch, lambda: sd(vid_f, txt, tt, plan_f))
        same_f = torch.equal(out_f, ref_f)
        say(f"7B streamed (keep {keep}) forward on the {label_f} latent: "
            f"{ms:.2f} ms, bit-equal to resident {same_f}; "
            + swap_numbers(sd.stats, since))
        if not same_f:
            fail(f"the streamed 7B forward (keep {keep}) differs from the "
                 "resident one")
        del runner, sd, out_f
    torch.cuda.empty_cache()

    args = cli.parse_arguments([
        "unused.npy", "--vae_encode_tiled", "--vae_decode_tiled",
        "--vae_encode_tile_size", "auto", "--vae_decode_tile_size", "auto"])
    auto = cli.tiling_from_args(args)
    total = torch.cuda.get_device_properties(device).total_memory
    label, frames, res = requests[0]
    cache_env = os.environ.get("SEEDVR2_MEMPROBE_CACHE")
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["SEEDVR2_MEMPROBE_CACHE"] = os.path.join(tmp, "mp.json")
        memplan.reset_cache_for_tests()
        try:
            torch.cuda.set_per_process_memory_fraction(
                AUTO_EMULATED_BYTES / total, device)
            limit = memplan.memory_limit(device)
            kw = dict(device=device, seed=0, dit_cfg=DIT_7B, tiling=auto,
                      dit_cache=True, vae_cache=True)
            t0 = time.perf_counter()
            off = model_manager.configure_runner(**kw)
            build = time.perf_counter() - t0
            say(f"(b) {limit / 2 ** 30:.2f} GiB card: configure_runner built "
                f"the 7B in {build:.2f} s: phase offload "
                f"{off.phase_offload}, streamed {off.streamed_dit is not None}"
                f"; DiT {dit_bytes7 / 1e9:.2f} GB against "
                f"{model_manager._PHASE_OFFLOAD_FRACTION:.0%} / "
                f"{model_manager._AUTO_SWAP_FRACTION:.0%} of the limit")
            if not off.phase_offload or off.streamed_dit is not None:
                fail("(b) configure_runner did not pick per-phase offload on "
                     "the emulated 24 GiB card")
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
            t0 = time.perf_counter()
            out_b, timings = cli.process_frames(off, frames, embeds,
                                                resolution=res, seed=42)
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated(device)
            reserved = torch.cuda.max_memory_reserved(device)
            plans = dict(off._auto_tile_cache)
            say(f"(b) phase offload, {label}, auto tiles: wall {wall:.3f} s, "
                "record " + format_record(timings)
                + f"; plans {plans}; peak {peak / 2 ** 30:.2f} GiB "
                f"allocated, {reserved / 2 ** 30:.2f} GiB reserved (limit "
                f"{limit / 2 ** 30:.2f}); OOM retries {off.oom_retries}; "
                f"restores {off.restore_seconds}")
            if off.oom_retries or reserved > limit or not np.isfinite(
                    out_b).all() or "dit_restore" not in timings:
                fail("(b) an OOM retry, a peak beyond the limit, a "
                     "non-finite output or no restore")
            t0 = time.perf_counter()
            again = model_manager.configure_runner(**kw)
            hit = time.perf_counter() - t0
            say(f"(d) configure_runner again with --cache_dit --cache_vae: "
                f"the same runner {again is off} in {hit * 1e3:.3f} ms")
            if again is not off or hit >= 0.1:
                fail("(d) the cached runner was not returned in < 0.1 s")
            del again, off
            model_cache.get_global_cache().clear()
            torch.cuda.empty_cache()

            torch.cuda.set_per_process_memory_fraction(
                STREAM_EMULATED_BYTES / total, device)
            limit16 = memplan.memory_limit(device)
            kw.update(dit_cache=False, vae_cache=False)
            t0 = time.perf_counter()
            small = model_manager.configure_runner(**kw)
            sd = small.streamed_dit
            say(f"(b) {limit16 / 2 ** 30:.2f} GiB card: configure_runner "
                f"built the 7B in {time.perf_counter() - t0:.2f} s: streamed "
                f"{sd is not None}"
                + (f", keep {sd.keep_blocks}/{len(small.dit.blocks)} blocks "
                   f"on the card ({sd.resident_bytes() / 2 ** 30:.2f} GiB)"
                   if sd is not None else ""))
            if sd is None:
                fail("(b) configure_runner did not stream the 7B on the "
                     "emulated 16 GiB card")
            del small, sd
            torch.cuda.empty_cache()
        finally:
            torch.cuda.set_per_process_memory_fraction(1.0, device)
            if cache_env is None:
                os.environ.pop("SEEDVR2_MEMPROBE_CACHE", None)
            else:
                os.environ["SEEDVR2_MEMPROBE_CACHE"] = cache_env
            memplan.reset_cache_for_tests()

    offload.place(r7.dit, device)
    (enc_t, enc_s), = [v for (k, _), v in plans.items() if k == "encode"]
    (dec_t, dec_s), = [v for (k, _), v in plans.items() if k == "decode"]
    ints = VAETiling(encode_tiled=enc_t, encode_tile_size=enc_s,
                     encode_tile_overlap=auto.encode_tile_overlap,
                     decode_tiled=dec_t, decode_tile_size=dec_s,
                     decode_tile_overlap=auto.decode_tile_overlap)
    whole = VideoDiffusionRunner(r7.dit, r7.vae, r7.config,
                                 compute_dtype=r7.compute_dtype, tiling=ints)
    out_w, _ = cli.process_frames(whole, frames, embeds, resolution=res,
                                  seed=42)
    diff = float(np.abs(out_b - out_w).max())
    say(f"(b) the phase-offloaded 7B's {label} against the resident 7B's "
        f"with the tiles as ints {ints}: max abs difference {diff:.6g} "
        "(must be 0)")
    if diff != 0.0:
        fail("(b) the phase-offloaded 7B's output differs from the resident "
             "7B's")


def streamed_w8a8(torch, nadit, fast7, vid_in, dplan, txt, tt, device,
                  wrappers, counts):
    """Phase 11b (c): the 7B w8a8 tree of the throughput lane, all 36
    blocks streamed, one forward on the 1080p clip's latent bit-equal to
    its resident forward, K3 and K4 launched."""
    from seedvr2_tpu_torch.ops import offload

    with torch.no_grad():
        ref = nadit.nadit_forward(fast7.dit, vid_in, txt, tt, dplan)
    sd = offload.StreamedNaDiT(fast7.dit, keep_blocks=0, device=device)
    reset_counts(wrappers)
    out = sd(vid_in, txt, tt, dplan)
    torch.cuda.synchronize()
    counts["7b_w8a8_blockswap"] = read_counts(
        wrappers, ("K1", "K2", "K3", "K4"), "7b_w8a8_blockswap")
    same = torch.equal(out, ref)
    say(f"(c) 7B w8a8 streamed (keep 0, {len(sd.host)} packs of "
        f"{sd.stats.block_bytes / 1e6:.1f} MB) against resident, 1080p "
        f"clip latent: bit-equal {same}; " + swap_numbers(sd.stats, (0, 0)))
    if not same:
        fail("(c) the streamed 7B w8a8 forward differs from the resident")


def legacy_k12_prediction(model):
    """K12 launches of a first slice's encode and decode, from the module
    list: every resnet conv that is 3 frames deep, and conv_out."""
    def count(part):
        return 1 + sum(m.weight.shape[2] == 3
                       for name, m in part.named_modules()
                       if name.endswith((".conv1", ".conv2")))
    return count(model.encoder), count(model.decoder)


def legacy_vae_lanes(torch, np, cli, VideoVAE, vae_cfg, device, embeds,
                     make_frames, wrappers, fn, ic):
    """Phase 10b (a). A legacy-layout VAE at VAE_V3's widths (random from a
    seed, written as a reference-layout fp16 .safetensors) loaded through
    load_vae_checkpoint by cli.make_runner beside the 3B DiT; the
    5x720x1280 clip encoded and decoded in each lane (default,
    --vae_quant int8, SEEDVR2_FUSED_NORM=1) with seconds and peak; the int8
    decode held to its plain versions and the fused one to the fp32 VAE as
    phase 9 holds VAE_V3's; K11 / K12 launches against the module list's
    prediction; the 720p clip request served in each lane (K1 / K2 as a
    VAE_V3 request). Returns {path: launches}."""
    import tempfile

    from seedvr2_tpu_torch.core.loader import load_vae_checkpoint
    from seedvr2_tpu_torch.core.runner import VideoDiffusionRunner
    from seedvr2_tpu_torch.core.weights import write_safetensors
    from seedvr2_tpu_torch.models.vae.pipeline_vae import (init_vae_params,
                                                           int8_served_convs)

    cfg = dataclasses.replace(vae_cfg, **LEGACY_SWITCHES)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "legacy_video_vae_fp16.safetensors")
        gen = torch.Generator(device).manual_seed(11)
        t0 = time.perf_counter()
        src = init_vae_params(cfg, device, torch.float32, generator=gen)
        write_safetensors(path, {k: v.detach().half()
                                 for k, v in src.state_dict().items()})
        del src
        size = os.path.getsize(path)
        runner = cli.make_runner(device, seed=0, vae_model=path)
        int8_model = load_vae_checkpoint(path, device, torch.bfloat16,
                                         vae_quant="int8")
    torch.cuda.synchronize()
    model = runner.vae.model
    n = sum(p.numel() for p in model.parameters())
    say(f"legacy VAE written ({size / 2 ** 20:.1f} MiB fp16, {n / 1e6:.1f} M "
        f"params) and loaded beside the 3B DiT in "
        f"{time.perf_counter() - t0:.2f} s; sniffed {model.cfg}")
    if model.cfg != cfg or hasattr(model.encoder.mid_block, "attentions"):
        fail(f"the legacy VAE was sniffed as {model.cfg}, not {cfg}")
    k11_pred = len(dict(int8_served_convs(int8_model)))
    k12_pred = legacy_k12_prediction(model)
    say(f"predicted from the module list: K11 {k11_pred} a one-slice "
        f"decode (the decoder's conv1s; every conv2 is (1, 3, 3)), K12 "
        f"{k12_pred[0]} encode + {k12_pred[1]} decode (the 3-deep resnet "
        f"convs and conv_out of a first slice); K1 / K2 {LEGACY_K1_K2} a "
        f"720p clip request, as with VAE_V3")
    lanes = {"default": runner.vae,
             "int8": VideoVAE(int8_model, torch.bfloat16)}
    env = env_set("SEEDVR2_FUSED_NORM", "1")
    try:
        lanes["fused"] = VideoVAE(model, torch.bfloat16)
    finally:
        env_set("SEEDVR2_FUSED_NORM", env)
    if not lanes["fused"].lowering.fused_norm or any(
            lanes[k].lowering.fused_norm for k in ("default", "int8")):
        fail("SEEDVR2_FUSED_NORM=1 did not reach the legacy VAE built "
             "under it")
    t, h, w = LEGACY_CLIP
    x_in = (torch.from_numpy(make_frames(t, h, w, seed=60)).to(device)
            * 2 - 1).to(torch.bfloat16)[None]

    def run(vae, z=None):
        """encode x_in, decode z (else the encoding): outputs, seconds,
        peak above the models, K11 launches, K12 launches (enc, dec)."""
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        held = torch.cuda.memory_allocated(device)
        reset_counts(wrappers)
        t1 = time.perf_counter()
        with torch.no_grad():
            enc = vae.encode(x_in)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            peak_enc = torch.cuda.max_memory_allocated(device) - held
            torch.cuda.reset_peak_memory_stats(device)
            held_dec = torch.cuda.memory_allocated(device)
            k12_enc = fn.norm_silu_head.launches
            dec = vae.decode(enc if z is None else z)
            torch.cuda.synchronize()
        peak_dec = torch.cuda.max_memory_allocated(device) - held_dec
        return dict(enc=enc, dec=dec, s_enc=t2 - t1,
                    s_dec=time.perf_counter() - t2,
                    peak=(peak_enc / 2 ** 30, peak_dec / 2 ** 30),
                    k11=ic.int8_conv3d.launches,
                    k12=(k12_enc, fn.norm_silu_head.launches - k12_enc))

    run(lanes["default"])  # warm-up: the first call's cuDNN set-up
    outs = {"default": run(lanes["default"])}
    z = outs["default"]["enc"]
    outs["int8"] = run(lanes["int8"], z)
    outs["fused"] = run(lanes["fused"], z)
    for lane, o in outs.items():
        say(f"legacy VAE {lane} lane, {t}x{h}x{w} clip: encode "
            f"{o['s_enc']:.3f} s (peak {o['peak'][0]:.2f} GiB above what "
            f"it found), decode {o['s_dec']:.3f} s (peak "
            f"{o['peak'][1]:.2f} GiB); K11 {o['k11']}, K12 {o['k12'][0]} + "
            f"{o['k12'][1]}")
    if outs["int8"]["k11"] != k11_pred or outs["fused"]["k12"] != k12_pred \
            or outs["default"]["k11"] or sum(outs["default"]["k12"]):
        fail("legacy VAE: K11 / K12 launches differ from the module list's "
             "prediction")
    lanes["int8"].lowering = dataclasses.replace(lanes["int8"].lowering,
                                                 use_kernels=False)
    with torch.no_grad():
        dec_plain = lanes["int8"].decode(z)
    lanes["int8"].lowering = dataclasses.replace(lanes["int8"].lowering,
                                                 use_kernels=True)
    dec_b, dec_k = outs["default"]["dec"], outs["int8"]["dec"]
    rel, to_bf16, gap = (rel_l2(dec_k, dec_plain), rel_l2(dec_k, dec_b),
                         rel_l2(dec_plain, dec_b))
    say(f"legacy int8 decode: kernels vs plain {rel:.6g} (bound "
        f"{INT8_DECODE_REL_L2}), kernels vs the bf16 decode {to_bf16:.6g}, "
        f"plain int8 vs bf16 {gap:.6g}")
    if not torch.isfinite(dec_k).all() or rel > INT8_DECODE_REL_L2 \
            or not INT8_DECODE_REL_L2 < gap or not rel < to_bf16:
        fail("legacy int8 decode beyond the limits above")
    vae32 = VideoVAE(copy.deepcopy(model).float(), torch.float32)
    with torch.no_grad():
        truth = (vae32.encode(x_in.float()), vae32.decode(z.float()))
    del vae32
    bad = False
    for what in ("enc", "dec"):
        f, u, t32 = outs["fused"][what], outs["default"][what], truth[
            what == "dec"]
        rel, err_f, err_u = rel_l2(f, u), rel_l2(f, t32), rel_l2(u, t32)
        say(f"legacy fused-norm {what}ode: relative L2 to the default lane "
            f"{rel:.6g} (bound {FUSED_VAE_REL_L2}); to the fp32 VAE "
            f"{err_f:.6g} fused, {err_u:.6g} default (bound "
            f"{FUSED_FP32_RATIO}x the default)")
        bad |= (not torch.isfinite(f).all() or rel > FUSED_VAE_REL_L2
                or err_f > FUSED_FP32_RATIO * err_u)
    if bad:
        fail("legacy fused-norm VAE beyond the limits above")
    del outs, truth, dec_plain, dec_b, dec_k, x_in, z
    torch.cuda.empty_cache()

    counts = {}
    label, t, h, w, res = LEGACY_REQUEST
    frames = make_frames(t, h, w, seed=61)
    for lane, extra in (("default", {}), ("int8", {"K11": k11_pred}),
                        ("fused", {"K12": sum(k12_pred)})):
        r = VideoDiffusionRunner(runner.dit, lanes[lane], runner.config,
                                 compute_dtype=runner.compute_dtype)
        reset_counts(wrappers)
        serve(torch, np, cli, r, ((f"legacy VAE {lane} lane, {label}",
                                   frames, res, (t, res, res * w // h, 3)),),
              device, embeds)
        name = f"legacy_vae_{lane}"
        counts[name] = read_counts(wrappers, ("K1", "K2", *extra), name)
        want = dict(zip(("K1", "K2"), LEGACY_K1_K2), **extra)
        got = {k: counts[name][k] for k in want}
        if got != want:
            fail(f"legacy {lane} request: launches {got}, predicted {want}")
        del r
    del runner, lanes, model, int8_model
    torch.cuda.empty_cache()
    return counts


def auto_tile_phase(torch, np, cli, device, embeds, make_frames):
    """Phase 10c (b). `--vae_encode_tile_size auto --vae_decode_tile_size
    auto` (tiled flags on) on the default 3B path under
    SEEDVR2_UPSAMPLE_CONVT=0, the 5x540x960 -> 1080p request: (b1) on the
    whole card the plan is untiled; (b2) under a per-process memory
    fraction emulating a 24 GiB card the decode plan is tiled, the
    request's peak stays within the limit, the out-of-memory retry never
    fires, and the output equals the same request served with the resolved
    sizes as ints; (b3) a fresh runner resolves the same shapes from the
    probe cache with no run. Prints every probe (seconds, bytes, the
    fragmentation it keeps), each request's allocator gap (reserved beyond
    the allocated peak) and the planner's verdicts, and (b1) runs the
    untiled decode once more with little room (`untiled_under_pressure`).
    The probe cache is a fresh file; the fraction is restored."""
    import logging
    import tempfile

    from seedvr2_tpu_torch.core.runner import VAETiling, VideoDiffusionRunner
    from seedvr2_tpu_torch.utils import memplan

    args = cli.parse_arguments([
        "unused.npy", "--vae_encode_tiled", "--vae_decode_tiled",
        "--vae_encode_tile_size", "auto", "--vae_decode_tile_size", "auto"])
    tiling = cli.tiling_from_args(args)
    handler = logging.StreamHandler(sys.stdout)
    loggers = [logging.getLogger(n) for n in (
        "seedvr2_tpu_torch.utils.memplan", "seedvr2_tpu_torch.core.runner")]
    for lg in loggers:  # the planner's verdicts and the runner's plans
        lg.addHandler(handler)
        lg.setLevel(logging.INFO)
    old = env_set("SEEDVR2_UPSAMPLE_CONVT", "0")
    try:
        runner = cli.make_runner(device, seed=0, tiling=tiling)
    finally:
        env_set("SEEDVR2_UPSAMPLE_CONVT", old)
    if runner.vae.lowering.upsample_convt:
        fail("SEEDVR2_UPSAMPLE_CONVT=0 did not reach the VAE")
    probes, real_probe = [], memplan.probe_tile_bytes
    stage = ["b1"]  # the whole card, then (b2) the emulated smaller one
    gaps = {"b1": [], "b2": []}  # (gap bytes, allocated peak bytes)

    def recorded(vae, kind, batch, frames, th, tw):
        runs = memplan.probe_runs
        t0 = time.perf_counter()
        try:
            nbytes = real_probe(vae, kind, batch, frames, th, tw)
        except torch.cuda.OutOfMemoryError:
            nbytes = None
        gap = memplan.fragmentation(vae, kind, batch, frames, th, tw)
        ran = memplan.probe_runs > runs
        probes.append((kind, frames, th, tw, nbytes,
                       time.perf_counter() - t0, gap if ran else None, ran))
        if ran and nbytes is not None:
            gaps[stage[0]].append((gap, nbytes))
        say(f"  probe {kind} {frames} frames {th}x{tw} latent: "
            + ("out of memory" if nbytes is None else f"{nbytes / 2 ** 30:.3f}"
               " GiB") + f", {probes[-1][5]:.3f} s"
            + (f", fragmentation {gap / 2 ** 20:.1f} MiB" if ran
               else ", from the cache"))
        if nbytes is None:
            raise torch.cuda.OutOfMemoryError(f"probe {kind} {th}x{tw}")
        return nbytes

    label, t, h, w, res = AUTO_REQUEST
    frames = make_frames(t, h, w, seed=70)
    expect = (t, res, res * w // h, 3)

    def request(r, name):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        out, timings = cli.process_frames(r, frames, embeds, resolution=res,
                                          seed=42)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(device)
        gap = torch.cuda.max_memory_reserved(device) - peak
        gaps[stage[0]].append((gap, peak))
        say(f"{name}: wall {wall:.3f} s, record " + format_record(timings)
            + f"; encode tiles {grid_of(r.vae.last_encode_tiles)}, decode "
            f"tiles {grid_of(r.vae.last_decode_tiles)}; peak "
            f"{peak / 2 ** 30:.2f} GiB, reserved - allocated at the peak "
            f"{gap / 2 ** 20:.1f} MiB; plans {r._auto_tile_cache}; OOM "
            f"retries {r.oom_retries}")
        if out.shape != expect or not np.isfinite(out).all():
            fail(f"{name}: expected finite {expect}, got {out.shape}")
        return out, peak

    cache_env = os.environ.get("SEEDVR2_MEMPROBE_CACHE")
    memplan.probe_tile_bytes = recorded
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["SEEDVR2_MEMPROBE_CACHE"] = os.path.join(tmp, "mp.json")
        memplan.reset_cache_for_tests()
        try:
            total = memplan.memory_limit(device)
            say(f"(b1) whole card: limit {total / 2 ** 30:.2f} GiB, "
                f"{torch.cuda.memory_allocated(device) / 2 ** 30:.2f} GiB "
                f"held (the 3B runner)")
            request(runner, f"auto tiles, whole card, {label}")
            if any(tiled for tiled, _ in runner._auto_tile_cache.values()):
                fail("(b1) auto resolved to a tiled plan on the whole card")
            untiled_under_pressure(torch, memplan, runner, device, total)
            frac = AUTO_EMULATED_BYTES / total
            torch.cuda.set_per_process_memory_fraction(frac, device)
            stage[0] = "b2"
            limit = memplan.memory_limit(device)
            r2 = VideoDiffusionRunner(runner.dit, runner.vae, runner.config,
                                      compute_dtype=runner.compute_dtype,
                                      tiling=tiling)
            say(f"(b2) memory fraction {frac:.4f}: limit "
                f"{limit / 2 ** 30:.2f} GiB")
            out2, peak2 = request(r2, f"auto tiles, {AUTO_EMULATED_BYTES / 2 ** 30:.0f}"
                                  f" GiB card, {label}")
            plans = dict(r2._auto_tile_cache)
            dec_plan = [v for (kind, _), v in plans.items()
                        if kind == "decode"]
            if (not dec_plan or not dec_plan[0][0] or peak2 > limit
                    or r2.oom_retries):
                fail(f"(b2) plans {plans}, peak {peak2} > limit {limit} or "
                     f"{r2.oom_retries} OOM retries")
            (enc_t, enc_s), = [v for (k, _), v in plans.items()
                               if k == "encode"]
            ints = VAETiling(encode_tiled=enc_t, encode_tile_size=enc_s,
                             encode_tile_overlap=tiling.encode_tile_overlap,
                             decode_tiled=dec_plan[0][0],
                             decode_tile_size=dec_plan[0][1],
                             decode_tile_overlap=tiling.decode_tile_overlap)
            r3 = VideoDiffusionRunner(runner.dit, runner.vae, runner.config,
                                      compute_dtype=runner.compute_dtype,
                                      tiling=ints)
            out3, _ = request(r3, f"the same request, tiles given as ints "
                                  f"{ints}")
            diff = float(np.abs(out2 - out3).max())
            say(f"(b2) auto output against the ints' output: max abs "
                f"difference {diff:.6g} (must be 0)")
            if diff != 0.0:
                fail("(b2) the auto plan's output differs from the same "
                     "tiles given as ints")
            runs = memplan.probe_runs
            memplan.reset_cache_for_tests()  # re-read the file
            r4 = VideoDiffusionRunner(runner.dit, runner.vae, runner.config,
                                      compute_dtype=runner.compute_dtype,
                                      tiling=tiling)
            t0 = time.perf_counter()
            again = {key: r4._resolve_tile(key[0], torch.empty(key[1]))
                     for key in plans}
            say(f"(b3) the same shapes resolved again in "
                f"{time.perf_counter() - t0:.3f} s with "
                f"{memplan.probe_runs - runs} probe runs: {again}")
            if again != plans or memplan.probe_runs != runs:
                fail("(b3) the second resolution ran a probe or planned "
                     "otherwise")
        finally:
            memplan.probe_tile_bytes = real_probe
            torch.cuda.set_per_process_memory_fraction(1.0, device)
            if cache_env is None:
                os.environ.pop("SEEDVR2_MEMPROBE_CACHE", None)
            else:
                os.environ["SEEDVR2_MEMPROBE_CACHE"] = cache_env
            memplan.reset_cache_for_tests()
    say(f"auto tiles: {sum(p[7] for p in probes)} probe runs "
        f"({sum(p[5] for p in probes if p[7]):.2f} s), "
        f"{sum(p[4] is None for p in probes)} out of memory; allocator "
        f"gap (reserved beyond the allocated peak) of each probe run and "
        f"request, whole card: " + ", ".join(
            f"{g / 2 ** 20:.1f} MiB of {b / 2 ** 30:.2f} GiB"
            for g, b in gaps["b1"]) + f"; under the "
        f"{AUTO_EMULATED_BYTES / 2 ** 30:.0f} GiB fraction: " + ", ".join(
            f"{g / 2 ** 20:.1f} MiB of {b / 2 ** 30:.2f} GiB"
            for g, b in gaps["b2"]) + f" (margin {memplan._SAFETY_BYTES / 2 ** 20:.0f}"
        " MiB plus each probe's own gap)")
    for lg in loggers:
        lg.removeHandler(handler)
    del runner, r2, r3, r4, out2, out3
    torch.cuda.empty_cache()


def untiled_under_pressure(torch, memplan, runner, device, total):
    """(b1) What the whole card's fragmentation figure means: the untiled
    decode of (b1)'s latent run once more under a memory fraction that
    leaves it its probe's allocated peak plus 10 %, from an empty cache.
    Prints whether it ran and the allocator's gap then (a measurement
    only: nothing is planned from it)."""
    from seedvr2_tpu_torch.models.vae.pipeline_vae import _decode_slices

    (kind, shape), = [k for k in runner._auto_tile_cache if k[0] == "decode"]
    nbytes = memplan.probe_tile_bytes(runner.vae, kind, 1, *shape[:3])
    gap_free = memplan.fragmentation(runner.vae, kind, 1, *shape[:3])
    z = torch.randn((1,) + shape, device=device).to(runner.vae.dtype)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_reserved(device)
    torch.cuda.set_per_process_memory_fraction(
        (held + 1.1 * nbytes) / total, device)
    torch.cuda.reset_peak_memory_stats(device)
    try:
        with torch.no_grad():
            out = _decode_slices(runner.vae.model, z, runner.vae.lowering)
        torch.cuda.synchronize()
        ran = True
        del out
    except torch.cuda.OutOfMemoryError:
        ran = False
    gap = (torch.cuda.max_memory_reserved(device) - held
           - (torch.cuda.max_memory_allocated(device)
              - torch.cuda.memory_allocated(device)))
    torch.cuda.set_per_process_memory_fraction(1.0, device)
    torch.cuda.empty_cache()
    say(f"(b1) the untiled decode {shape} again with only its allocated "
        f"peak {nbytes / 2 ** 30:.2f} GiB + 10 % of room: "
        + (f"ran, the allocator reserving {gap / 2 ** 20:.1f} MiB beyond it"
           if ran else "out of memory")
        + f" (on the whole card it reserved {gap_free / 2 ** 20:.1f} MiB "
        "beyond it)")


def gguf_loads(torch, cli, gguf, native, path, device, label):
    """The GGUF DiT loaded through cli.make_runner(quant="q4k") with the host
    library, then with the numpy plain dequantizers (gguf.dequantize's
    plain path); both seconds printed side by side; the two DiTs' state
    dicts must be equal. Returns (native runner, numpy runner, seconds)."""
    secs, deq, runners = {}, {}, {}
    real = gguf.dequantize
    for way in ("native", "numpy"):
        spent = [0.0]

        def timed(*args, way=way, spent=spent):
            t = time.perf_counter()
            try:
                return real(*args, plain=way == "numpy")
            finally:
                spent[0] += time.perf_counter() - t

        gguf.dequantize = timed
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runners[way] = cli.make_runner(device, seed=0, dit_model=path,
                                           quant="q4k")
            torch.cuda.synchronize()
            secs[way] = time.perf_counter() - t0
        finally:
            gguf.dequantize = real
        deq[way] = spent[0]
    a, b = (r.dit.state_dict() for r in runners.values())
    same = a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    say(f"{label} GGUF DiT load (cli.make_runner(quant='q4k')): "
        f"{secs['native']:.2f} s with the host library (dequantizing "
        f"{deq['native']:.2f} s of it; library built in "
        f"{native.build_seconds:.2f} s this process), {secs['numpy']:.2f} s "
        f"with the numpy dequantizers (dequantizing {deq['numpy']:.2f} s); "
        f"the rest is the file read, the host requantization and the copy "
        f"to the card; host {host_cpu()}; DiTs equal: {same}")
    if not same:
        fail(f"{label} GGUF: the natively loaded DiT differs from the numpy "
             "loaded one")
    return runners["native"], runners["numpy"], secs


def host_cpu() -> str:
    """The host's CPU: lscpu's model name (else /proc/cpuinfo's), the
    architecture and the thread count."""
    import platform

    model = ""
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True,
                             timeout=10).stdout
        model = next((ln.split(":", 1)[1].strip() for ln in out.splitlines()
                      if ln.startswith("Model name")), "")
    except (OSError, subprocess.SubprocessError):
        pass
    if not model:
        try:
            with open("/proc/cpuinfo") as f:
                model = next((ln.split(":", 1)[1].strip() for ln in f
                              if ln.lower().startswith("model name")), "")
        except OSError:
            pass
    return (f"{model or 'CPU model not reported'} ({platform.machine()}), "
            f"{os.cpu_count()} threads")


def gguf_block_check(np, gguf, native, path, layout):
    """Start, in a pool of 4 host threads, every Q8_0 / Q4_K / Q6_K tensor
    of the GGUF file dequantized by the host library and by the numpy plain
    version, GGUF_CHECK_VALUES values at a time (numpy's temporaries then
    stay in cache), compared bit for bit. Returns finish(), which waits,
    prints the counts and seconds by type and fails on any difference."""
    import threading

    names = {GGUF_Q8_0: "Q8_0", GGUF_Q4_K: "Q4_K", GGUF_Q6_K: "Q6_K"}
    todo = [e for e in layout if e[1] in names]
    lock, stats = threading.Lock(), {}

    def one(entry):
        name, qt, off, size = entry
        nbytes = GGUF_BLOCK[qt][0]
        raw = np.fromfile(path, np.uint8, count=size, offset=off).reshape(
            -1, nbytes)
        s_nat = s_np = 0.0
        same = True
        step = max(1, GGUF_CHECK_VALUES // GGUF_BLOCK[qt][1])
        for i in range(0, raw.shape[0], step):
            chunk = raw[i:i + step]
            t0 = time.perf_counter()
            a = native.dequantize_blocks(chunk, qt)
            t1 = time.perf_counter()
            b = gguf._DEQUANT[qt](chunk)
            s_nat += t1 - t0
            s_np += time.perf_counter() - t1
            same &= np.array_equal(a.view(np.uint32), b.view(np.uint32))
        with lock:
            s = stats.setdefault(names[qt], [0, 0, 0.0, 0.0, []])
            s[0] += 1
            s[1] += raw.shape[0] * GGUF_BLOCK[qt][1]
            s[2] += s_nat
            s[3] += s_np
            if not same:
                s[4].append(name)

    pool = concurrent.futures.ThreadPoolExecutor(4)
    t_start = time.perf_counter()
    futures = [pool.submit(one, e) for e in todo]

    def finish(label):
        for f in futures:
            f.result()
        pool.shutdown()
        wall = time.perf_counter() - t_start
        for qt_name, (n, vals, s_nat, s_np, bad) in sorted(stats.items()):
            say(f"{label} GGUF {qt_name}: {n} tensors, {vals / 1e6:.1f} M "
                f"values, host library {s_nat:.2f} s, numpy {s_np:.2f} s "
                f"(summed over 4 threads), bit-equal: {not bad}")
        say(f"{label} GGUF block check: {len(todo)} tensors in {wall:.2f} s "
            f"of wall beside the card's work")
        bad = [x for s in stats.values() for x in s[4]]
        if bad or sum(s[0] for s in stats.values()) != len(todo):
            fail(f"{label} GGUF: the host library differs from numpy on "
                 f"{bad[:5]}")
    return finish


def same_request(torch, np, cli, runners, frames, res, embeds, label):
    """The same request through each runner: outputs must be equal."""
    outs = [cli.process_frames(r, frames, embeds, resolution=res,
                               seed=42)[0] for r in runners]
    diff = float(np.abs(outs[0] - outs[1]).max())
    say(f"{label}: the natively loaded and the numpy-loaded DiT serve the "
        f"same request, max abs difference {diff:.6g} (must be 0)")
    if diff != 0.0:
        fail(f"{label}: outputs differ")


def max_abs(np, a, b) -> float:
    return float(np.abs(a.astype(np.float64) - b).max())


def cli_surface_phase(torch, np, cli, nadit, pipeline, runner, device,
                      embeds, wrappers, counts, make_frames, here):
    """Phase 3b: the CLI surface driven through `cli.main(argv)` in-process
    on a 9-frame .npy clip at full width, on phase 3's models (both cache
    flags, so the 3B is built once): unchunked; chunked with --debug and
    --profile_dir, and again without the profiler; skip and cap against the
    same frames given directly; --attention_mode sdpa with --parity_check
    against the unchunked output; an mp4 through the chunk loop where
    OpenCV imports, beside --doctor in a subprocess. Fails on any check;
    clears the model cache at its end."""
    import contextlib
    import io
    import tempfile

    import importlib.util

    from seedvr2_tpu_torch.core.model_cache import get_global_cache
    from seedvr2_tpu_torch.utils import debug as debug_mod
    from seedvr2_tpu_torch.utils.debug import Debug

    found = {m: importlib.util.find_spec(m) is not None
             for m in ("cv2", "yaml", "psutil")}
    say(f"host modules: OpenCV {found['cv2']}, PyYAML {found['yaml']}, "
        f"psutil {found['psutil']} (Debug reads RSS from "
        f"{'psutil' if debug_mod.psutil else '/proc/self/statm'})")
    t, h, w = CLI_CLIP
    frames = make_frames(t, h, w, seed=21)
    expect = (t, CLI_RES, CLI_RES * w // h // 2 * 2, 3)  # even sides
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "clip.npy")
        np.save(src, frames)
        mid = os.path.join(tmp, "mid.npy")
        np.save(mid, frames[CLI_SKIP:CLI_SKIP + CLI_CAP])
        flags = ["--resolution", str(CLI_RES), "--seed", "0", "--dit_model",
                 "random", "--vae_model", "random", "--cache_dit",
                 "--cache_vae", "--temporal_overlap", str(CLI_OVERLAP),
                 "--device", "cuda"]

        def run(name, extra, inp=src, debug=None, path=None, needed=()):
            """cli.main on one request: (frames out, wall s, stdout)."""
            out_path = os.path.join(tmp, f"{name}.npy")
            argv = [inp, "--output", out_path, *flags, *extra]
            if path is not None:
                reset_counts(wrappers)
            buf = io.StringIO()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                got = cli.main(argv, debug=debug)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if path is not None:
                counts[path] = read_counts(wrappers, needed, path)
            out = np.load(got)
            say(f"cli {name} ({' '.join(extra) or 'no extra flags'}): out "
                f"{out.shape} in {wall:.3f} s")
            if out.shape[1:] != expect[1:] or not np.isfinite(out).all():
                fail(f"cli {name}: expected finite frames of {expect[1:]}, "
                     f"got {out.shape}")
            return out, wall, buf.getvalue()

        def held_to(label, got, ref):
            diff = max_abs(np, got, ref)
            say(f"{label}: max abs difference {diff:.6g} "
                f"({'bit-equal' if diff == 0 else 'not bit-equal'}; bound "
                f"{CLI_MAX_ABS})")
            if got.shape != ref.shape or diff > CLI_MAX_ABS:
                fail(f"{label}: {got.shape} vs {ref.shape}, max abs {diff}")
            return diff

        # 1. unchunked, and the same request through process_frames
        dbg_u = Debug()
        whole, wall_u, _ = run("unchunked", [], debug=dbg_u, path="cli",
                               needed=("K1", "K2"))
        if whole.shape != expect:
            fail(f"cli unchunked: {whole.shape}, expected {expect}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        direct, timings = cli.process_frames(
            runner, frames, embeds, resolution=CLI_RES, seed=0,
            temporal_overlap=CLI_OVERLAP)
        wall_pf = time.perf_counter() - t0
        say(f"the same request through process_frames: {wall_pf:.3f} s "
            "(record " + format_record(timings)
            + f"); the CLI's wall {wall_u:.3f} s, {wall_u - wall_pf:+.3f} s "
            "(reading, the runner from the cache, embeddings, writing)")
        held_to("cli unchunked against process_frames", whole, direct)

        # 2. unchunked and chunked in wavelet; chunked with --debug and the
        # profiler, then without
        wavelet = ["--color_correction", "wavelet"]
        whole_w, wall_w, _ = run("unchunked wavelet", wavelet)
        prof = os.path.join(tmp, "profile")
        dbg_c = Debug(enabled=True, profile_dir=prof)
        chunk_flags = wavelet + ["--chunk_size", str(CLI_CHUNK)]
        chunked, wall_c, log_c = run("chunked+profile", chunk_flags + [
            "--debug", "--profile_dir", prof], debug=dbg_c)
        plain_c, wall_p, _ = run("chunked", chunk_flags)
        say(f"chunked wall {wall_p:.3f} s against unchunked {wall_w:.3f} s "
            f"(wavelet); with --debug --profile_dir {wall_c:.3f} s (profiler "
            f"and checkpoints {wall_c - wall_p:+.3f} s)")
        for line in log_c.splitlines():
            if "[video]" in line or "chunk_written" in line:
                say(f"  {line}")
        written = [lbl for lbl, _ in dbg_c.checkpoints
                   if lbl.startswith("chunk_written")]
        want = [f"chunk_written[{CLI_CHUNK - CLI_OVERLAP}]",
                f"chunk_written[{t}]"]
        if written != want or chunked.shape[0] != t:
            fail(f"chunked run wrote {written}, {chunked.shape[0]} frames; "
                 f"expected {want}, each of the {t} frames once")
        prev = dbg_c.checkpoints[0][1]
        for lbl, state in dbg_c.checkpoints:
            if lbl.startswith("chunk_written"):
                say(f"  {lbl}: RSS {state['rss_gb']:.3f} GiB (delta "
                    f"{state['rss_gb'] - prev['rss_gb']:+.4f}), device "
                    f"{state['hbm_used_gb']:.3f} GiB allocated (delta "
                    f"{state['hbm_used_gb'] - prev['hbm_used_gb']:+.4f}), "
                    f"peak {state['hbm_peak_gb']:.3f}")
                prev = state
        away = [i for i in range(t) if i not in CLI_SEAM]
        held_to("chunked against unchunked away from the seam",
                chunked[away], whole_w[away])
        held_to("chunked against unchunked at the seam",
                chunked[list(CLI_SEAM)], whole_w[list(CLI_SEAM)])
        held_to("chunked with the profiler against without", chunked,
                plain_c)
        phases = ("phase1_encode", "phase2_upscale", "phase3_decode",
                  "phase4_postprocess")
        for name in phases:
            d = os.path.join(prof, name)
            files = sorted(os.listdir(d)) if os.path.isdir(d) else []
            size = sum(os.path.getsize(os.path.join(d, f)) for f in files)
            say(f"  profiler traces in {name}: {len(files)} "
                f"({size / 2 ** 20:.1f} MiB)")
            if not files:
                fail(f"no profiler trace written for {name}")

        # 3. skip and cap against the same frames given directly
        capped, _, _ = run("skip+cap", ["--skip_first_frames",
                                        str(CLI_SKIP), "--load_cap",
                                        str(CLI_CAP)])
        given, _, _ = run("direct", [], inp=mid)
        if capped.shape[0] != CLI_CAP:
            fail(f"skip/cap wrote {capped.shape[0]} frames, not {CLI_CAP}")
        held_to("skip/cap against the same frames given directly", capped,
                given)

        # 4. the xla lane (no K1, K2 still), scored by --parity_check against
        # the unchunked flash output; its DiT output against K1's
        dbg_x = Debug()
        sdpa, _, log_x = run("sdpa", [
            "--attention_mode", "sdpa", "--parity_check", "--parity_ref",
            os.path.join(tmp, "unchunked.npy"), "--parity_min_psnr",
            str(CLI_PARITY_MIN_PSNR)], debug=dbg_x, path="cli_sdpa",
            needed=("K2",))
        if counts["cli_sdpa"]["K1"] != 0:
            fail(f"--attention_mode sdpa launched K1 "
                 f"{counts['cli_sdpa']['K1']} times")
        dit_f = dbg_u.elapsed("phase2_upscaling")
        dit_x = dbg_x.elapsed("phase2_upscaling")
        say(f"dit phase, 9-frame clip (3 batches; each lane's first run): "
            f"flash {dit_f:.4f} s, sdpa {dit_x:.4f} s; output frames "
            f"relative L2 "
            f"{float(np.linalg.norm(sdpa - whole) / np.linalg.norm(whole)):.6g}")
        lines = [ln for ln in log_x.splitlines() if ln.startswith("{")]
        report = json.loads(lines[-1]) if lines else {}
        say(f"parity report: {json.dumps(report)}")
        if report.get("parity") != "ok" or report.get("passed") is not True:
            fail(f"--parity_check report {report}")
        ctx = pipeline.setup_generation_context(device)
        ctx = pipeline.encode_all_batches(runner, ctx, frames[:CLI_CHUNK],
                                          resolution=CLI_RES)
        latent = ctx["all_latents"][0]
        gen = torch.Generator(device).manual_seed(42)
        noise = torch.randn(latent.shape, generator=gen, device=device).to(
            torch.bfloat16)
        vid_in = torch.cat([noise, runner.get_condition(noise, latent)],
                           -1)[None]
        txt = torch.as_tensor(embeds["pos"], dtype=torch.bfloat16,
                              device=device)[None]
        dplan = runner.plan(tuple(latent.shape[:3]), txt.shape[1])
        tt = torch.full((1,), 1000.0, device=device)
        outs, ms = {}, {"flash": [], "xla": []}
        with torch.no_grad():
            fwds = {m: (lambda m=m: nadit.nadit_forward(
                runner.dit, vid_in, txt, tt, dplan, attention_mode=m))
                for m in ms}
            for mode, fwd in fwds.items():
                outs[mode] = fwd()  # also the warm-up
            # in turns, as the card's clock moves between calls
            for mode in ("flash", "xla", "xla", "flash"):
                ms[mode].append(cuda_ms(torch, fwds[mode], 3, warmup=0))
        rel = rel_l2(outs["xla"], outs["flash"])
        say(f"whole bf16 DiT on latent {dplan.plan.vid_shape}: xla (SDPA) "
            f"against flash (K1) relative L2 {rel:.6g} (bound {DIT_REL_L2});"
            f" forward ms in turns flash {ms['flash'][0]:.2f}, xla "
            f"{ms['xla'][0]:.2f}, xla {ms['xla'][1]:.2f}, flash "
            f"{ms['flash'][1]:.2f}")
        if not torch.isfinite(outs["xla"]).all() or rel > DIT_REL_L2:
            fail(f"xla lane DiT against flash: relative L2 {rel}")
        del outs, vid_in, noise, latent, ctx

        # 5. --doctor in its own process, beside the last step (timed ones
        # are done)
        import threading

        t_doc = time.perf_counter()
        doctor = subprocess.Popen(
            [sys.executable, "-m", "seedvr2_tpu_torch.cli", "--doctor"],
            cwd=here, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        doc_end = []  # when the doctor exits (its report is small: the
        # pipes do not fill before it does)
        threading.Thread(target=lambda: doc_end.append(
            (doctor.wait(), time.perf_counter())[1]), daemon=True).start()

        try:
            # 6. video IO, where OpenCV imports here: the clip as an mp4 through
            # the chunk loop into PNGs, against the .npy path on the frames the
            # mp4 decodes to (the same floats in, so the same uint8 out)
            if not found["cv2"]:
                say("OpenCV is not installed here: video IO not driven")
            else:
                from seedvr2_tpu_torch.utils import video_io

                mp4 = os.path.join(tmp, "clip.mp4")
                writer = video_io.VideoWriter(mp4, 30.0, (h, w))
                writer.write_frames(frames)
                writer.close()
                reader = video_io.VideoReader(mp4)
                np.save(os.path.join(tmp, "decoded.npy"), reader.read_frames(t))
                reader.close()
                png = os.path.join(tmp, "video", "out.png")
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(io.StringIO()):
                    cli.main([mp4, "--output", png, "--output_format", "png",
                              *flags, *chunk_flags])
                wall_v = time.perf_counter() - t0
                pngs = sorted(os.listdir(os.path.dirname(png)))
                from_npy, _, _ = run("decoded .npy", chunk_flags,
                                     inp=os.path.join(tmp, "decoded.npy"))
                got = np.stack([video_io.read_image(os.path.join(
                    os.path.dirname(png), f))[0] for f in pngs])
                want = np.clip(from_npy * 255.0, 0, 255).astype(np.uint8)
                same = np.array_equal(np.round(got * 255.0).astype(np.uint8),
                                      want)
                say(f"cli mp4 in, PNGs out, chunked: {len(pngs)} frames of "
                    f"{got.shape[1:]} in {wall_v:.3f} s; equal to the .npy path "
                    f"on the decoded frames: {same}")
                if len(pngs) != t or not same:
                    fail(f"video through the CLI: {len(pngs)} PNGs, equal to the "
                         f".npy path: {same}")
        finally:
            try:
                out, err = doctor.communicate(timeout=300)
            finally:
                if doctor.poll() is None:
                    doctor.kill()
                    doctor.wait()

    doc_s = (doc_end[0] if doc_end else time.perf_counter()) - t_doc
    for line in out.splitlines():
        say(f"  doctor: {line}")
    name = torch.cuda.get_device_name(0)
    say(f"--doctor: rc {doctor.returncode} in {doc_s:.2f} s (process start "
        "included; beside the video step)")
    if (doctor.returncode != 0 or "backend OK: cuda" not in out
            or name not in out):
        fail(f"--doctor returned {doctor.returncode} without 'backend OK: "
             f"cuda' and {name!r}: {err[-2000:]}")
    get_global_cache().clear()
    torch.cuda.empty_cache()


def node_phase(torch, np, pipeline, device, wrappers, counts, make_frames,
               here):
    """Phase 3c: the ComfyUI node surface at full width with random weights
    (module docstring). Every configure_runner call the nodes make is timed
    and its runner kept until its checks are done; the model cache is
    cleared at the end, so no runner of this phase outlives it."""
    from seedvr2_tpu_torch.core.model_cache import get_global_cache
    from seedvr2_tpu_torch.interfaces import nodes, workflow
    from seedvr2_tpu_torch.utils.text_embeds import load_text_embeddings

    built = []  # (runner, seconds) of each configure_runner call
    configure = nodes.configure_runner

    def recorded(**kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner = configure(**kw)
        torch.cuda.synchronize()
        built.append((runner, time.perf_counter() - t0))
        return runner

    def request(label, run, path=None, needed=()):
        """run() once: (output, wall s, peak GiB above what was held)."""
        if path is not None:
            reset_counts(wrappers)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated(device) - held) / 2 ** 30
        if path is not None:
            counts[path] = read_counts(wrappers, needed, path)
        if not np.isfinite(out).all() or out.min() < 0.0 or out.max() > 1.0:
            fail(f"node request {label}: output not finite or outside "
                 "[0, 1]")
        return out, wall, peak

    def four_phases(runner, frames):
        """The port's four phases called directly, with the arguments the
        upscaler node passes at its default widgets."""
        ctx = pipeline.setup_generation_context(runner.device)
        ctx["text_embeds"] = load_text_embeddings(
            ["./models", "."], txt_dim=runner.dit_cfg.txt_in_dim)
        ctx = pipeline.encode_all_batches(runner, ctx, frames,
                                          seed=NODE_SEED, resolution=1080)
        ctx = pipeline.upscale_all_batches(runner, ctx, seed=NODE_SEED)
        ctx = pipeline.decode_all_batches(runner, ctx)
        ctx = pipeline.postprocess_all_batches(ctx,
                                               color_correction="wavelet")
        return ctx["final_video"]

    nodes.configure_runner = recorded
    try:
        # the shipped image workflows, model names set to random in memory
        for name, (t, h, w), expect, path in NODE_WORKFLOWS:
            with open(os.path.join(here, "examples", "workflows", name)) as f:
                wf = json.load(f)
            for node in wf["nodes"]:
                if node["type"] in ("SeedVR2LoadDiTModel",
                                    "SeedVR2LoadVAEModel"):
                    node["params"]["model"] = "random"
            frames = make_frames(t, h, w, seed=31)
            out, wall, peak = request(
                name, lambda: workflow.run_workflow(
                    wf, {"image": frames})["up"], path, ("K1", "K2"))
            runner, build = built.pop()
            say(f"workflow {name}: {frames.shape} -> {out.shape} in "
                f"{wall:.3f} s (runner built in {build:.3f} s, request "
                f"{wall - build:.3f} s); encode tiles "
                f"{grid_of(runner.vae.last_encode_tiles)}, decode tiles "
                f"{grid_of(runner.vae.last_decode_tiles)}; peak device "
                f"memory {peak:.2f} GiB above what was held; K1 "
                f"{counts[path]['K1']}, K2 {counts[path]['K2']}")
            if out.shape != expect:
                fail(f"workflow {name}: expected {expect}, got {out.shape}")
            tiled = runner.tiling.decode_tiled
            if tiled != (name == "4k_image.json") or (
                    tiled and len(runner.vae.last_decode_tiles) < 2):
                fail(f"workflow {name}: decode tiling {tiled} with "
                     f"{len(runner.vae.last_decode_tiles)} tiles, against "
                     "the workflow's VAE node")
            del runner, out

        # the default widgets and quant="q8" against the four phases called
        # directly on the node's runner
        frames = make_frames(*NODE_IMAGE, seed=32)
        for path, quant, needed in (("node_default", "none", ("K1", "K2")),
                                    ("node_q8", "q8", ("K1", "K2", "K6"))):
            dit = nodes.SeedVR2LoadDiTModel.execute(model="random",
                                                    quant=quant)
            vae = nodes.SeedVR2LoadVAEModel.execute(model="random")
            progress = []
            out, wall, peak = request(
                path, lambda: nodes.SeedVR2VideoUpscaler.execute(
                    image=frames, dit=dit, vae=vae, seed=NODE_SEED,
                    progress_callback=progress.append), path, needed)
            runner, build = built.pop()
            direct, d_wall, _ = request(f"{path} direct",
                                        lambda: four_phases(runner, frames))
            diff = max_abs(np, out, direct)
            say(f"node request {path} (quant={quant}): {frames.shape} -> "
                f"{out.shape} in {wall:.3f} s (runner built in {build:.3f} "
                f"s), peak {peak:.2f} GiB; the four phases called directly "
                f"on its runner {d_wall:.3f} s, max abs difference {diff:.6g}"
                f"; launches "
                + ", ".join(f"{k} {counts[path][k]}" for k in needed)
                + f"; progress {len(progress)} reports, last "
                f"{progress[-1]!r}")
            if diff != 0:
                fail(f"node request {path}: not bit-equal to the four phases "
                     "on the same runner")
            if progress[-1] != 1.0 or any(b < a for a, b in
                                          zip(progress, progress[1:])):
                fail(f"node request {path}: progress {progress} is not "
                     "monotone up to 1.0")
            del runner, out, direct

        # the model cache: two calls with cache_model and an offload device
        dit = nodes.SeedVR2LoadDiTModel.execute(
            model="random", offload_device="cpu", cache_model=True)
        vae = nodes.SeedVR2LoadVAEModel.execute(
            model="random", offload_device="cpu", cache_model=True)
        walls = [request(f"cached {i}", lambda: nodes.SeedVR2VideoUpscaler.
                         execute(image=frames, dit=dit, vae=vae,
                                 seed=NODE_SEED))[1] for i in range(2)]
        (first, build), (again, lookup) = built[-2:]
        say(f"cache_model=True, offload_device=cpu: first call "
            f"{walls[0]:.3f} s (runner built in {build:.3f} s), second "
            f"{walls[1]:.3f} s (runner from the cache in {lookup:.4f} s, "
            f"the same object: {again is first})")
        if again is not first:
            fail("cache_model=True: the second node request built a new "
                 "runner instead of reusing the cached one")
        del first, again
    finally:
        nodes.configure_runner = configure
        built.clear()
        get_global_cache().clear()
        torch.cuda.empty_cache()


def check_fp32_variants(torch, im, qm, device):
    """K3, K6 and K7 with their fp32 epilogue (the partial product a
    row-sharded projection sums over the tp ranks) against their plain
    versions at every row shard of the 3B and the 7B at tp 2 and 4
    (TP_SHARDS) on the text rows, the tp lanes' video rows and a 720p
    clip's (TP_ROWS): K3 exact, K6 / K7 within TP_F32_REL_L2 and their bf16
    output the fp32 one rounded; each timed beside its bf16 form, its plain
    version, the library call and its bound. The records hold the 3B mlp
    proj_out at tp 2 on the tp lanes' video rows (TP_F32_RECORD)."""
    gen = torch.Generator(device).manual_seed(17)
    f32 = torch.float32
    recs = {}

    def put(key, record, row, err, ms, plain_ms, lib_ms, ops, nbytes, note):
        bound, by = bound_ms(ops, PEAK_INT8 if key == "K3f32" else PEAK_BF16,
                             nbytes)
        say(f"{key} {row}: {note}; kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, library "
            f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
            f"{bound:.4f} ms ({by})")
        if record:
            recs[key] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             library_ms=lib_ms, bound_ms=bound, bound_by=by,
                             shape=row)

    for tp in (2, 4):
        for label, n, k_full in TP_SHARDS:
            k = k_full // tp
            for m in TP_ROWS:
                row = f"{label} tp{tp} M={m} N={n} K={k}"
                record = (tp, label, m) == TP_F32_RECORD
                # K3
                xq = torch.randint(-127, 128, (m, k), generator=gen,
                                   device=device, dtype=torch.int8)
                wq = torch.randint(-127, 128, (n, k), generator=gen,
                                   device=device, dtype=torch.int8)
                xs = torch.rand(m, generator=gen, device=device) * 0.01
                ws = torch.rand(n, generator=gen, device=device) * 0.01
                out = im.int8_matmul(xq, wq, xs, ws, out_dtype=f32)
                ref = im.int8_matmul_plain(xq, wq, xs, ws, f32)
                if out.dtype != f32 or not torch.equal(out, ref):
                    fail(f"K3 fp32 out {row}: differs from the plain version")
                if not torch.equal(im.int8_matmul(xq, wq, xs, ws),
                                   out.to(torch.bfloat16)):
                    fail(f"K3 {row}: bf16 out is not the fp32 out rounded")
                lib = None
                if m > 16:
                    wt = wq.t()
                    lib = kernel_ms(torch, lambda: torch._int_mm(xq, wt), 10)
                put("K3f32", record, row, 0.0,
                    kernel_ms(torch, lambda: im.int8_matmul(
                        xq, wq, xs, ws, out_dtype=f32), 10),
                    kernel_ms(torch, lambda: im.int8_matmul_plain(
                        xq, wq, xs, ws, f32), 3), lib, 2 * m * n * k,
                    m * k + n * k + 4 * (m + n) + 4 * m * n,
                    "exact; bf16 out %.4f ms (torch._int_mm: int32 product "
                    "only)" % kernel_ms(torch, lambda: im.int8_matmul(
                        xq, wq, xs, ws), 10))
                del xq, wq, xs, ws, out, ref
                # K6 and K7
                x = torch.randn(m, k, generator=gen, device=device).to(
                    torch.bfloat16)
                q8 = torch.randint(-127, 128, (n, k), generator=gen,
                                   device=device, dtype=torch.int8)
                sc = torch.rand(n, k // 32, generator=gen,
                                device=device) * 0.02 / 127
                qa = torch.randint(0, 16, (n, k), generator=gen,
                                   device=device, dtype=torch.int8)
                s = torch.rand(n, k // 32, generator=gen,
                               device=device) * 0.04 / 15
                mn = torch.rand(n, k // 32, generator=gen,
                                device=device) * 0.02
                _, splits = qm.plan_tiles(m, n, k)
                for key, args, wrap, plain, deq, tab in (
                        ("K6f32", (q8, sc), qm.quant_matmul_q8,
                         qm.quant_matmul_q8_plain,
                         lambda: qm.dequantize_q8(q8, sc), 4),
                        ("K7f32", (qa, s, mn), qm.quant_matmul_affine,
                         qm.quant_matmul_affine_plain,
                         lambda: qm.dequantize_affine(qa, s, mn), 8)):
                    out = wrap(x, *args, out_dtype=f32)
                    ref = plain(x, *args, f32)
                    err = (out - ref).abs().max().item()
                    rel = rel_l2(out, ref)
                    if out.dtype != f32 or rel > TP_F32_REL_L2:
                        fail(f"{key} {row}: relative L2 {rel:.3g} from the "
                             f"plain version > {TP_F32_REL_L2}")
                    if not torch.equal(wrap(x, *args),
                                       out.to(torch.bfloat16)):
                        fail(f"{key} {row}: bf16 out is not the fp32 out "
                             "rounded")
                    wb = deq().to(torch.bfloat16)
                    ops = 2 * m * n * k
                    put(key, record, row, err,
                        kernel_ms(torch, lambda: wrap(x, *args,
                                                      out_dtype=f32), 10),
                        kernel_ms(torch, lambda: plain(x, *args, f32), 3),
                        kernel_ms(torch, lambda: torch.matmul(x, wb.t()),
                                  10), ops,
                        2 * m * k + n * k + tab * n * (k // 32) + 4 * m * n,
                        f"max abs {err:.3g}, relative L2 {rel:.3g}, "
                        f"{splits} K split(s); bf16 out "
                        f"{kernel_ms(torch, lambda: wrap(x, *args), 10):.4f} "
                        "ms (library: torch.matmul on the dequantized bf16 "
                        "weight, bf16 out)")
                    del out, ref, wb
                del x, q8, sc, qa, s, mn
    torch.cuda.empty_cache()
    return recs


def parallel_rank(torch, np, rank: int, port: int, out_dir: str) -> None:
    """One of the two ranks of phase 2b, both on cuda:0 over gloo: the tp2
    lanes (TP_LANES), each rank's full model forward (tp = 1) then its
    shard's (tp = 2), and the dp2 request against rank 0's single-rank
    run. Writes rank<N>.json into out_dir and exits non-zero on a miss."""
    import torch.distributed as dist

    from seedvr2_tpu_torch import cli
    from seedvr2_tpu_torch.core.configs import DIT_3B, DIT_7B
    from seedvr2_tpu_torch.core.loader import quantize_dit
    from seedvr2_tpu_torch.models.dit import nadit
    from seedvr2_tpu_torch.parallel.comm import TPComm
    from seedvr2_tpu_torch.parallel.mesh import make_mesh
    from seedvr2_tpu_torch.parallel.tp import tp_compatible, tp_shard_dit
    from seedvr2_tpu_torch.profile_requests import make_frames
    from seedvr2_tpu_torch.utils.text_embeds import load_text_embeddings

    def tell(msg):
        say(f"[rank{rank}] {msg}")

    wrappers, f32 = kernel_wrappers(), f32_wrappers()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank)
    tp_mesh = make_mesh(2, ("dp", "tp"), (1, 2), backend="gloo")
    dp_mesh = make_mesh(2, ("dp",), (2,), backend="gloo")
    report = {"lanes": [], "counts": {k: 0 for k in (*wrappers, *f32)}}
    bad = []
    bf16 = torch.bfloat16
    for family, quant in TP_LANES:
        cfg = DIT_3B if family == "dit_3b" else DIT_7B
        t0 = time.perf_counter()
        model = nadit.init_dit(cfg, device, bf16,
                               generator=torch.Generator(device).manual_seed(0))
        g = torch.Generator(device).manual_seed(1)
        vid = torch.randn((1, *TP_LATENT, cfg.vid_in_channels), generator=g,
                          device=device).to(bf16)
        txt = torch.randn((1, TXT_LEN, cfg.txt_in_dim), generator=g,
                          device=device).to(bf16)
        tt = torch.full((1,), 1000.0, device=device)
        dplan = nadit.upload_plan(nadit.build_dit_plan(cfg, TP_LATENT,
                                                       TXT_LEN), cfg, device)
        with torch.no_grad():
            dense = (nadit.nadit_forward(model, vid, txt, tt, dplan).float()
                     if quant == "w8a8" else None)
            quantize_dit(model, quant)
            one = nadit.nadit_forward(model, vid, txt, tt, dplan).float()
            if not tp_compatible(model, 2, device):
                bad.append(f"{family} {quant}: does not shard 2 ways")
                break
            tp_shard_dit(model, tp_mesh)
            spent = [0.0, 0]  # seconds in the all-reduces, their count

            class Timed(TPComm):
                """The tp line's collectives, each sum timed alone."""

                def __call__(self, t):
                    torch.cuda.synchronize()
                    t2 = time.perf_counter()
                    out = super().__call__(t)
                    torch.cuda.synchronize()
                    spent[0] += time.perf_counter() - t2
                    spent[1] += 1
                    return out

            timed = Timed(tp_mesh)

            torch.cuda.synchronize()
            reset_counts(wrappers)
            for w in f32.values():
                w.launches_f32 = 0
            t1 = time.perf_counter()
            got = nadit.nadit_forward(model, vid, txt, tt, dplan,
                                      tp=timed).float()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t1
        counts = {k: w.launches for k, w in wrappers.items()}
        counts.update({k: w.launches_f32 for k, w in f32.items()})
        for k, v in counts.items():
            report["counts"][k] += v
        qkv = next(iter(model.blocks[0].attn.proj_qkv.values()))
        heads = qkv.out_features // (3 * cfg.head_dim)
        rel = rel_l2(got, one)
        line = dict(lane=f"{family} {quant}", heads=heads, rel_l2=rel,
                    seconds=secs, allreduce_seconds=spent[0],
                    allreduces=spent[1],
                    counts={k: counts[k] for k in TP_COUNTS})
        if quant == "w8a8":
            line.update(tp1_to_bf16=rel_l2(one, dense),
                        tp2_to_bf16=rel_l2(got, dense))
            ok = (line["tp2_to_bf16"] <= TP_W8A8_RATIO * line["tp1_to_bf16"]
                  and torch.isfinite(got).all().item())
        else:
            ok = rel <= TP_REL_L2 and torch.isfinite(got).all().item()
        need = ["K1", TP_LANE_KERNEL[quant]]
        if heads != cfg.heads // 2 or not ok or any(counts[k] == 0
                                                   for k in need):
            bad.append(f"{family} {quant}: {line}")
        report["lanes"].append(line)
        tell(f"tp2 {family} {quant}: {heads} of {cfg.heads} heads a rank, "
             f"relative L2 to the tp = 1 forward {rel:.3g}"
             + (f" (to the bf16 DiT: tp1 {line['tp1_to_bf16']:.3g}, tp2 "
                f"{line['tp2_to_bf16']:.3g})" if quant == "w8a8" else "")
             + f"; tp2 forward {secs:.3f} s over gloo, of which "
             f"{spent[0]:.3f} s in its {spent[1]} host-staged all-reduces "
             f"(not a speed); launches {line['counts']}; built "
             f"and run in {time.perf_counter() - t0:.1f} s")
        del model, one, got, dense, vid, txt, dplan
        torch.cuda.empty_cache()

    # dp2: one request, rank 0's single-rank run first
    runner = cli.make_runner(device, seed=0)
    embeds = load_text_embeddings(txt_dim=DIT_3B.txt_in_dim)
    label, t, h, w, res = DP_REQUEST
    frames = make_frames(t, h, w, seed=8)
    kw = dict(resolution=res, seed=42, batch_size=DP_BATCH)
    single = cli.process_frames(runner, frames, embeds, **kw)[0] \
        if rank == 0 else None
    dist.barrier()
    runner.attach_mesh(dp_mesh)
    reset_counts(wrappers)
    runner.last_batch_sizes = []
    t0 = time.perf_counter()
    out, timings = cli.process_frames(runner, frames, embeds, **kw)
    wall = time.perf_counter() - t0
    dp = dict(wall=wall, timings=timings, dit_calls=runner.last_batch_sizes,
              counts={k: w.launches for k, w in wrappers.items()},
              shape=list(out.shape))
    if rank == 0:
        dp["max_diff"] = float(np.abs(out - single).max())
        dp["bit_equal"] = bool(np.array_equal(out, single))
        if not dp["bit_equal"]:
            bad.append(f"dp2 {label}: max diff {dp['max_diff']} from the "
                       "single-rank request")
    if not np.isfinite(out).all() or dp["counts"]["K1"] == 0:
        bad.append(f"dp2 {label}: non-finite output or no K1 launch")
    report["dp"] = dp
    tell(f"dp2 {label} (batch size {DP_BATCH}): out {out.shape}, this "
         f"rank's DiT calls {runner.last_batch_sizes}, wall {wall:.3f} s "
         "(two ranks share one card), "
         + ("bit-equal to the single-rank request" if rank == 0
            and dp["bit_equal"] else f"max diff {dp.get('max_diff')}")
         + f"; launches K1 {dp['counts']['K1']} K2 {dp['counts']['K2']}")
    report["bad"] = bad
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)
    dist.barrier()
    dist.destroy_process_group()
    if bad:
        fail(f"rank {rank}: {bad}")


def parallel_phase(torch, np, im, qm, cli, device, here, counts):
    """Phase 2b: the fp32 variants at the shard shapes, the two ranks
    sharing the card (parallel_rank, in two processes started and waited
    for here) and the CLI's NCCL path at world size 1. Returns the fp32
    variants' records with the tp2 path's launches; adds the path's
    launches (rank 0's) to `counts`."""
    say("phase 2b: serving parallelism on ONE card; nothing beyond one card "
        "is measured here (two ranks share cuda:0 over gloo: correctness, "
        "not speed)")
    recs = check_fp32_variants(torch, im, qm, device)
    torch.cuda.empty_cache()  # the ranks' models need the card's memory
    out_dir = os.path.join(here, "build", "parallel_smoke")
    os.makedirs(out_dir, exist_ok=True)
    for r in range(2):
        path = os.path.join(out_dir, f"rank{r}.json")
        if os.path.exists(path):
            os.remove(path)
    port = free_port()
    procs = [subprocess.Popen([sys.executable, os.path.join(
        here, "chip_smoke.py"), "--parallel-rank", str(r), str(port),
        out_dir]) for r in range(2)]
    deadline = time.time() + PARALLEL_TIMEOUT
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.time()))
    except subprocess.TimeoutExpired:
        fail(f"the two ranks did not finish in {PARALLEL_TIMEOUT} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode for p in procs):
        fail(f"a rank failed: exit codes {[p.returncode for p in procs]}")
    reports = [json.load(open(os.path.join(out_dir, f"rank{r}.json")))
               for r in range(2)]
    counts["tp2"] = reports[0]["counts"]
    say(f"tp2 path launches (rank 0, the tp2 forwards of {len(TP_LANES)} "
        f"lanes): {counts['tp2']}")
    for key, rec in recs.items():
        rec["launches"] = counts["tp2"][key]
        if rec["launches"] == 0:
            fail(f"{key} was never launched on the tp2 path")
    nccl_world_one(torch, np, cli, here)
    return recs


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def nccl_world_one(torch, np, cli, here):
    """The CLI under a launcher's environment at world size 1 (WORLD_SIZE=1,
    as torchrun sets it): it joins an NCCL process group, serves, and
    leaves the group; its output bit-equal to the plain run's on the same
    cached models."""
    import torch.distributed as dist

    from seedvr2_tpu_torch.core.model_cache import get_global_cache
    from seedvr2_tpu_torch.profile_requests import make_frames

    d = os.path.join(here, "build", "parallel_smoke")
    clip = os.path.join(d, "clip.npy")
    np.save(clip, make_frames(*NCCL_CLIP[:3], seed=9).astype(np.float32))
    base = [clip, "--resolution", str(NCCL_CLIP[3]), "--seed", "0",
            "--dit_model", "random", "--vae_model", "random", "--cache_dit",
            "--cache_vae"]
    seen = []
    init = dist.init_process_group

    def spy(*a, **kw):
        seen.append(kw.get("backend"))
        return init(*a, **kw)

    env = dict(WORLD_SIZE="1", RANK="0", LOCAL_RANK="0",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()))
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    cli.dist.init_process_group = spy
    try:
        t0 = time.perf_counter()
        a = cli.main([*base, "--output", os.path.join(d, "nccl.npy")])
        t_nccl = time.perf_counter() - t0
    finally:
        cli.dist.init_process_group = init
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if seen != ["nccl"] or dist.is_initialized():
        fail(f"the CLI under WORLD_SIZE=1 made the process groups {seen} "
             "(expected one NCCL group, left at the end)")
    t0 = time.perf_counter()
    b = cli.main([*base, "--output", os.path.join(d, "plain.npy")])
    t_plain = time.perf_counter() - t0
    get_global_cache().clear()
    torch.cuda.empty_cache()
    x, y = np.load(a), np.load(b)
    if not np.array_equal(x, y):
        fail(f"the CLI's NCCL path at world size 1 differs from the plain "
             f"run: max diff {np.abs(x - y).max()}")
    say(f"CLI under WORLD_SIZE=1: one NCCL process group, output {x.shape} "
        f"bit-equal to the plain run ({t_nccl:.2f} s, plain {t_plain:.2f} s; "
        "the first run built the cached models)")


# ----------------------------------------------------------- the trainer


def k1_bwd_case(torch, fa, b, s, kv, H, D, tabs, gen, device):
    """Inputs of K1's backward at one shape: qkv with its lane pad rows
    zero, K1's output and rows' lse from its training launch, an incoming
    gradient, K1's own pre-pass output; and whether the training launch's
    output is bit-equal to the serving launch's."""
    qkv = torch.randn(b, s, 3 * H * D, generator=gen, device=device).to(
        torch.bfloat16)
    qkv[:, kv:] = 0
    out, lse = fa.packed_window_attention_lse(qkv, H, D, *tabs, 1e-5, kv)
    same = torch.equal(out, fa.packed_window_attention(qkv, H, D, *tabs,
                                                       1e-5, kv))
    dout = torch.randn(b, s, H * D, generator=gen, device=device).to(
        torch.bfloat16)
    x = qkv.view(b, s, 3, H, D)
    qh, kh = fa.attention_prepass(x[:, :, 0], x[:, :, 1], *tabs, 1e-5,
                                  D ** -0.5 * 1.4426950408889634)
    return qkv, out, lse, same, dout, x, qh, kh


def check_k1_backward(torch, fa, nadit, cfg, device, k1_ms):
    """K1's backward, each part against its plain version on the same
    inputs (BWD_* tolerances) and the whole against its plain version, at
    the record shape (B=12 S=512 kv_len=463, random tables), at the 1080p
    clip plan's largest window group (its real tables) and at every window
    group of the training plan, window and shifted (the 3B at TRAIN_LATENT,
    B = TRAIN_BATCH windows of a group, its tables folded with random
    qk-norm weights): the shapes the train path launches. lse comes from
    K1's training launch, held against its plain version, its output
    bit-equal to the serving launch's. The first two shapes' parts are
    timed after an L2 flush beside their plain versions, their bounds and
    torch SDPA's backward at the same shape (all three gradients at once:
    the yardstick of the dq and dk/dv parts); at every training group the
    dq and dk/dv parts are timed too, and summed over one step's launches
    (each group once a layer of its kind). Returns the record shape's three
    records."""
    import torch.nn.functional as F

    D, eps = cfg.head_dim, cfg.norm_eps
    gen = torch.Generator(device).manual_seed(13)
    dplan = nadit.upload_plan(nadit.build_dit_plan(cfg, (2, 136, 240),
                                                   TXT_LEN), cfg, device)
    g = max((g for gs in dplan.groups.values() for g in gs),
            key=lambda g: g.n * g.sk_pad ** 2)
    ones = torch.ones(D, device=device)
    cases = [("B=12 S=512 kv_len=463", 12, 512, 463,
              (*rope_tables(torch, gen, 512, D, device),
               *rope_tables(torch, gen, 512, D, device)), cfg.heads),
             (f"1080p clip plan largest group n={g.n} wlen={g.wlen} "
              f"S={g.sk_pad} kv_len={g.skv}", g.n, g.sk_pad, g.skv,
              nadit._fold_norm_tables(g.cos, g.sin, ones, ones, ones, ones,
                                      g.wlen, g.skv), cfg.heads)]
    timed = len(cases)
    tplan = nadit.upload_plan(nadit.build_dit_plan(cfg, TRAIN_LATENT,
                                                   TXT_LEN), cfg, device)
    per_step = cfg.num_layers // len(tplan.groups)  # layers of each kind
    wgen = torch.Generator(device).manual_seed(15)
    norm_w = [1.0 + 0.1 * torch.randn(D, generator=wgen, device=device)
              for _ in range(4)]
    # every group at the 3B's heads, then at a tp 2 rank's (the sharded
    # trainer's launches, checked only)
    for H in (cfg.heads, cfg.heads // TRAIN_TP):
        for method, groups in tplan.groups.items():
            for i, g in enumerate(groups):
                cases.append((
                    f"train plan {method} group {i} n={g.n} wlen={g.wlen} "
                    f"S={g.sk_pad} kv_len={g.skv} B={TRAIN_BATCH * g.n} "
                    f"H={H}", TRAIN_BATCH * g.n, g.sk_pad, g.skv,
                    nadit._fold_norm_tables(g.cos, g.sin, *norm_w, g.wlen,
                                            g.skv), H))
    recs = {}
    worst = {}
    worst_local = {}
    step_calls = []  # (label, shape, flops, the two parts' calls)
    for n_case, (label, b, s, kv, tabs, H) in enumerate(cases):
        qkv, out, lse, same, dout, x, qh, kh = k1_bwd_case(
            torch, fa, b, s, kv, H, D, tabs, gen, device)
        v = x[:, :, 2]
        dq, delta = fa.attention_backward_dq(qh, kh, v, out, dout, lse, kv)
        dk, dv = fa.attention_backward_dkdv(qh, kh, v, dout, lse, delta, kv)
        pre = fa.prepass_backward(x[:, :, 0], x[:, :, 1], *tabs, eps, dq, dk,
                                  D ** -0.5, fa._LN2)
        whole = fa.packed_window_attention_backward(qkv, H, D, *tabs, eps,
                                                    kv, out, dout, lse)
        again = fa.packed_window_attention_backward(qkv, H, D, *tabs, eps,
                                                    kv, out, dout, lse)
        torch.cuda.synchronize()
        _, p_lse = fa.packed_window_attention_lse_plain(qkv, H, D, *tabs,
                                                        1e-5, kv)
        p_dq, p_delta = fa.attention_backward_dq_plain(qh, kh, v, out, dout,
                                                       lse, kv)
        p_dk, p_dv = fa.attention_backward_dkdv_plain(qh, kh, v, dout, lse,
                                                      delta, kv)
        p_pre = fa.prepass_backward_plain(x[:, :, 0], x[:, :, 1], *tabs, eps,
                                          dq, dk, D ** -0.5, fa._LN2)
        p_whole = fa.packed_window_attention_backward_plain(
            qkv, H, D, *tabs, eps, kv, out, dout)
        errs = {
            "dq": (rel_l2(dq, p_dq), BWD_DQDK_REL),
            "lse": (rel_l2(lse, p_lse), BWD_F32_REL),
            "delta": (rel_l2(delta, p_delta), BWD_F32_REL),
            "dk": (rel_l2(dk, p_dk), BWD_DQDK_REL),
            "dv": (rel_l2(dv, p_dv), BWD_BF16_REL),
            "pre-pass d q": (rel_l2(pre[0], p_pre[0]), BWD_BF16_REL),
            "pre-pass d k": (rel_l2(pre[1], p_pre[1]), BWD_BF16_REL),
            **{f"d {n}": (rel_l2(a, r), BWD_F32_REL) for n, a, r in zip(
                ("cos_q", "sin_q", "cos_k", "sin_k"), pre[2], p_pre[2])},
            **{f"whole d {n}": (rel_l2(a, r), BWD_WHOLE_REL)
               for n, a, r in zip(("qkv", "cos_q", "sin_q", "cos_k",
                                   "sin_k"), whole, p_whole)}}
        bad = {k: e for k, (e, tol) in errs.items()
               if not e <= tol or e != e}
        rerun = all(torch.equal(a, c) for a, c in zip(whole, again))
        pad = (whole[0][:, kv:].abs().max().item() if kv < s else 0.0)
        say(f"K1 backward {label}: relative L2 to the plain versions "
            + ", ".join(f"{k} {e:.3g}" for k, (e, _) in errs.items())
            + f" (bounds: fp32 sums {BWD_F32_REL}, bf16 outputs "
            f"{BWD_BF16_REL}, dq / dk {BWD_DQDK_REL}, whole "
            f"{BWD_WHOLE_REL}); rerun bit-equal {rerun}; d qkv at or past "
            f"kv_len max |.| {pad}; K1's training launch's output bit-equal "
            f"to the serving launch's {same}")
        if bad or not rerun or not same or pad != 0.0 or not all(
                torch.isfinite(t).all() for t in whole):
            fail(f"K1 backward {label}: beyond bounds {bad}, rerun equal "
                 f"{rerun}, training launch's output equal {same}, pad rows "
                 f"{pad}")
        ops = {"K1bwd_dq": 6.0 * b * H * kv * kv * D,
               "K1bwd_dkdv": 8.0 * b * H * kv * kv * D}
        if n_case >= timed and H != cfg.heads:
            for k, (e, _) in errs.items():
                worst_local[k] = max(worst_local.get(k, 0.0), e)
            del qkv, x, dq, dk, dv, pre, whole, again
            del p_lse, p_dq, p_dk, p_dv, p_pre, p_whole
            continue
        if n_case >= timed:
            for k, (e, _) in errs.items():
                worst[k] = max(worst.get(k, 0.0), e)
            # timed after the loop, with the other groups' launches
            step_calls.append((label, (b, s, kv), ops, (
                lambda qh=qh, kh=kh, v=v, out=out, dout=dout, lse=lse, kv=kv:
                fa.attention_backward_dq(qh, kh, v, out, dout, lse, kv),
                lambda qh=qh, kh=kh, v=v, dout=dout, lse=lse, delta=delta,
                kv=kv: fa.attention_backward_dkdv(qh, kh, v, dout, lse,
                                                  delta, kv))))
            del qkv, x, dq, dk, dv, pre, whole, again
            del p_lse, p_dq, p_dk, p_dv, p_pre, p_whole
            continue
        # times, bounds, the plain versions and SDPA's backward
        def max_abs(*pairs):
            return max((a.float() - r.float()).abs().max().item()
                       for a, r in pairs)

        nq = b * H * kv * D  # the rows below kv_len, every head
        parts = {
            "K1bwd_dq": (
                lambda: fa.attention_backward_dq(qh, kh, v, out, dout, lse,
                                                 kv),
                lambda: fa.attention_backward_dq_plain(qh, kh, v, out, dout,
                                                       lse, kv),
                ops["K1bwd_dq"], nq * 2 * 5 + nq * 4
                + 2 * b * H * kv * 4, max_abs((dq, p_dq))),
            "K1bwd_dkdv": (
                lambda: fa.attention_backward_dkdv(qh, kh, v, dout, lse,
                                                   delta, kv),
                lambda: fa.attention_backward_dkdv_plain(qh, kh, v, dout,
                                                         lse, delta, kv),
                ops["K1bwd_dkdv"], nq * 2 * 4 + 2 * b * H * kv * 4
                + nq * (4 + 2), max_abs((dk, p_dk), (dv, p_dv))),
            "K1bwd_prepass": (
                lambda: fa.prepass_backward(x[:, :, 0], x[:, :, 1], *tabs,
                                            eps, dq, dk, D ** -0.5,
                                            fa._LN2),
                lambda: fa.prepass_backward_plain(x[:, :, 0], x[:, :, 1],
                                                  *tabs, eps, dq, dk,
                                                  D ** -0.5, fa._LN2),
                0.0, nq * (2 * 2 + 2 * 4 + 2 * 2) + 8 * s * D * 4,
                max_abs(*zip(pre[:2], p_pre[:2]), *zip(pre[2], p_pre[2]))),
        }
        q, k, vv, mask = sdpa_inputs(torch, qkv, H, D, tabs, eps, kv)
        q, k, vv = (t.detach().requires_grad_() for t in (q, k, vv))
        o = F.scaled_dot_product_attention(q, k, vv, attn_mask=mask)
        do = dout.view(b, s, H, D).transpose(1, 2)
        lib_ms = kernel_ms(torch, lambda: torch.autograd.grad(
            o, (q, k, vv), do, retain_graph=True), 10)
        whole_ms = kernel_ms(
            torch, lambda: fa.packed_window_attention_backward(
                qkv, H, D, *tabs, eps, kv, out, dout, lse), 5)
        fwd_ms = {name: kernel_ms(torch, run, 10) for name, run in (
            ("serving", lambda: fa.packed_window_attention(
                qkv, H, D, *tabs, 1e-5, kv)),
            ("training (lse)", lambda: fa.packed_window_attention_lse(
                qkv, H, D, *tabs, 1e-5, kv)))}
        pair_ms = 0.0
        for key, (run, plain, n_ops, nbytes, err) in parts.items():
            ms = kernel_ms(torch, run, 10)
            plain_ms = kernel_ms(torch, plain, 3)
            bound, by = bound_ms(n_ops, PEAK_BF16, nbytes)
            lib = lib_ms if key != "K1bwd_prepass" else None
            queued = ""
            if lib is not None:
                pair_ms += ms
            else:
                # the pre-pass backward's two launches: the host's launch
                # gap between them is inside the events' reading
                q_ms = queued_ms(torch, run)
                queued = (f", {q_ms:.4f} ms queued behind a device spin "
                          f"({bound / q_ms * 100:.0f} % of the bound's rate)")
                if n_case == 0:
                    recs.setdefault(key, {})["queued_ms"] = q_ms
            say(f"{key} {label}: kernel {ms:.4f} ms"
                + (f" ({n_ops / ms / 1e9:.1f} TFLOP/s)" if n_ops else queued)
                + f", plain {plain_ms:.4f} ms, bound {bound:.4f} ms ({by})"
                + (f", SDPA backward (dq, dk, dv at once) {lib_ms:.4f} ms"
                   if lib is not None else ", no library call")
                + (f"; {earlier_note(f'{key} {label}')}"
                   if lib is not None else ""))
            if "ms" not in recs.get(key, {}):
                recs.setdefault(key, {}).update(
                    max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib,
                    bound_ms=bound, bound_by=by, shape=label)
        say(f"K1 backward {label}: dq + dk/dv {pair_ms:.4f} ms against SDPA's "
            f"backward {lib_ms:.4f} ms ({pair_ms / lib_ms:.2f}x); whole call "
            f"{whole_ms:.4f} ms (K1's pre-pass again, dq, dk/dv, pre-pass "
            f"backward); K1 forward here: serving "
            f"{fwd_ms['serving']:.4f} ms, training (lse) "
            f"{fwd_ms['training (lse)']:.4f} ms; K1 forward at the record "
            f"shape in phase 1 {k1_ms:.4f} ms (PERF.md row 1: 0.1621 ms)")
        del qkv, out, lse, dout, x, qh, kh, dq, dk, dv, pre, whole, again
        del p_lse, p_dq, p_dk, p_dv, p_pre, p_whole, q, k, vv, o
        torch.cuda.empty_cache()
    # the training groups' parts: these launches take 10-70 us, shorter
    # than the host's launch overhead between two CUDA events
    step_ms = {"K1bwd_dq": 0.0, "K1bwd_dkdv": 0.0}
    for label, (b, s, kv), ops, fns in step_calls:
        ms = {key: queued_ms(torch, fn) for key, fn in zip(step_ms, fns)}
        for key, t in ms.items():
            step_ms[key] += per_step * t
        plan = fa.backward_plan(b, s, cfg.heads, kv, fa._sm_count(device))
        say(f"K1 backward {label}: dq {ms['K1bwd_dq']:.4f} ms "
            f"({ops['K1bwd_dq'] / ms['K1bwd_dq'] / 1e9:.1f} TFLOP/s), dk/dv "
            f"{ms['K1bwd_dkdv']:.4f} ms ("
            f"{ops['K1bwd_dkdv'] / ms['K1bwd_dkdv'] / 1e9:.1f} TFLOP/s); dq "
            f"{plan.wg} warpgroup(s) a block, {plan.blocks * cfg.heads * b} "
            f"blocks; dk/dv {plan.kv_blocks * cfg.heads * b} blocks; "
            f"{per_step} launches of each a step")
    del step_calls
    torch.cuda.empty_cache()
    n_groups = (len(cases) - timed) // 2
    say(f"K1 backward over the training plan's {n_groups} window groups at "
        f"a tp {TRAIN_TP} rank's {cfg.heads // TRAIN_TP} heads (K1's "
        "training launch, its lse, and every backward part): worst relative "
        "L2 to the plain versions "
        + ", ".join(f"{k} {e:.3g}" for k, e in worst_local.items()))
    say(f"K1 backward over the training plan's {n_groups} window "
        "groups: worst relative L2 to the plain versions "
        + ", ".join(f"{k} {e:.3g}" for k, e in worst.items())
        + f"; one train step's {per_step * n_groups} launches of "
        f"each part: dq {step_ms['K1bwd_dq']:.3f} ms, dk/dv "
        f"{step_ms['K1bwd_dkdv']:.3f} ms, together "
        f"{sum(step_ms.values()):.3f} ms (each launch alone after an L2 "
        "flush, queued behind a device spin)")
    return recs


def check_k2_backward(torch, gather, nadit, cfg, device):
    """K2's gradient (K2 on the inverse index) bit-equal to index_select's
    gradient on the training plan's transitions (batch 2, width D), timed
    on the window -> shifted_window transition beside its plain version,
    the bound and index_add_ (index_select's gradient)."""
    gen = torch.Generator(device).manual_seed(14)
    plan = nadit.build_dit_plan(cfg, TRAIN_LATENT, TXT_LEN)
    for key in (("canonical", "window"), ("window", "shifted_window"),
                ("shifted_window", "canonical")):
        index = gather.RowIndex(plan.transitions[key], device)
        idx = index.tensor.long()
        x = torch.randn(TRAIN_BATCH, plan.seq_len, cfg.vid_dim, generator=gen,
                        device=device).to(torch.bfloat16).requires_grad_()
        g = torch.randn(TRAIN_BATCH, len(index), cfg.vid_dim, generator=gen,
                        device=device).to(torch.bfloat16)
        (ref,) = torch.autograd.grad(torch.index_select(x, 1, idx), x, g)
        (got,) = torch.autograd.grad(gather.gather_rows_grad(x, index), x, g)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            fail(f"K2 backward {key}: differs from index_select's gradient")
        say(f"K2 backward {key[0]}->{key[1]} B={TRAIN_BATCH} "
            f"L={plan.seq_len} D={cfg.vid_dim}: bit-equal to index_select's "
            "gradient")
    inv = index.inverse
    ms = kernel_ms(torch, lambda: gather.gather_rows(g, inv), 50)
    q_ms = queued_ms(torch, lambda: gather.gather_rows(g, inv))
    plain_ms = kernel_ms(torch, lambda: gather.gather_rows_plain(g, inv), 50)
    xz = torch.zeros_like(x, requires_grad=False)
    lib_ms = kernel_ms(torch, lambda: xz.zero_().index_add_(1, idx, g), 50)
    nbytes = 2 * g.numel() * 2 + len(index) * 4
    bound, by = bound_ms(0, PEAK_BF16, nbytes)
    say(f"K2bwd B={TRAIN_BATCH} L={plan.seq_len} D={cfg.vid_dim}: kernel "
        f"{ms:.4f} ms ({nbytes / ms / 1e6:.0f} GB/s; {q_ms:.4f} ms queued "
        f"behind a device spin, {bound_ms(0, PEAK_BF16, nbytes)[0] / q_ms * 100:.0f}"
        f" % of the bound's rate), plain {plain_ms:.4f} "
        f"ms, index_add_ {lib_ms:.4f} ms, bound {bound:.4f} ms ({by})")
    return dict(max_abs_err=0.0, ms=ms, queued_ms=q_ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=bound, bound_by=by,
                shape=f"B={TRAIN_BATCH} L={plan.seq_len} D={cfg.vid_dim}")


def check_k9_backward(torch, fa, nadit, cfg, device):
    """K9's backward, each part against its plain version on the same
    inputs (BWD_* tolerances: the same arithmetic as K1's backward) and the
    whole against its plain version, at the record shape (K9_RECORD, its
    real tables, masks and ids) and at every uniform window layer of the
    training plan (TRAIN_LATENT, TRAIN_BATCH rows of windows): the shapes
    the uniform train path launches. q, k, v and dO are random bf16, dO
    zero at each window's pad slots (the rows the DiT crops). lse comes
    from K9's training launch, held against its plain version, its output
    bit-equal to the serving launch's; every masked key's dk and dv zero;
    reruns bit-equal. At the record shape both K9 launches are timed, and
    each part (queued_ms) beside its plain version, its bound (the live
    key tiles' products; each input read and each output written once) and
    torch SDPA's backward with the boolean key mask on the same roped
    operands (dq, dk, dv at once: the yardstick of the dq and dk/dv
    parts). Returns the three records."""
    import torch.nn.functional as F

    D = cfg.head_dim
    scale = D ** -0.5
    gen = torch.Generator(device).manual_seed(19)
    label, latent, method = K9_RECORD
    cases = [(f"{label} {method}", nadit.upload_plan(nadit.build_dit_plan(
        cfg, latent, TXT_LEN, uniform=True), cfg, device).uniform[method], 1,
        cfg.heads)]
    tplan = nadit.upload_plan(nadit.build_dit_plan(
        cfg, TRAIN_LATENT, TXT_LEN, uniform=True), cfg, device)
    # the training plan's layers at the 3B's heads and at a tp 2 rank's
    cases += [(f"train plan {m}", u, TRAIN_BATCH, H)
              for H in (cfg.heads, cfg.heads // TRAIN_TP)
              for m, u in tplan.uniform.items()]
    recs, worst, worst_local = {}, {}, {}
    for n_case, (label, u, batch, H) in enumerate(cases):
        ids = u.batch_ids(batch)
        b, s = len(ids), u.cos.shape[1]
        idx = ids.tensor.long()
        keep = u.valid[idx]
        name = (f"{label} nW={b} nU={u.cos.shape[0]} S={s} H={H} D={D}")
        q, k, v, dout = (torch.randn(b, s, H, D, generator=gen,
                                     device=device).to(torch.bfloat16)
                         for _ in range(4))
        dout[~keep] = 0
        args = (None, u.cos, u.sin, ids, u.valid)
        out, lse = fa.flash_windowed_attention_lse(q, k, v, *args)
        same = torch.equal(out, fa.flash_windowed_attention(q, k, v, *args))
        qh, kh = fa.attention_prepass(q, k, u.cos, u.sin, u.cos, u.sin, None,
                                      scale * fa._LOG2E, ids)
        dq, delta = fa.windowed_backward_dq(qh, kh, v, out, dout, lse,
                                            u.valid, ids)
        dk, dv = fa.windowed_backward_dkdv(qh, kh, v, dout, lse, delta,
                                           u.valid, ids)
        rq, rk = fa.windowed_rope_backward(dq, dk, u.cos, u.sin, ids, scale,
                                           fa._LN2)
        whole = fa.flash_windowed_attention_backward(q, k, v, *args, out,
                                                     dout, lse)
        again = fa.flash_windowed_attention_backward(q, k, v, *args, out,
                                                     dout, lse)
        torch.cuda.synchronize()
        _, p_lse = fa.flash_windowed_attention_lse_plain(q, k, v, *args)
        p_dq, p_delta = fa.windowed_backward_dq_plain(qh, kh, v, out, dout,
                                                      lse, u.valid, ids)
        p_dk, p_dv = fa.windowed_backward_dkdv_plain(qh, kh, v, dout, lse,
                                                     delta, u.valid, ids)
        p_rq, p_rk = fa.windowed_rope_backward_plain(dq, dk, u.cos, u.sin,
                                                     ids, scale, fa._LN2)
        p_whole = fa.flash_windowed_attention_backward_plain(
            q, k, v, *args, out, dout)
        errs = {
            "lse": (rel_l2(lse, p_lse), BWD_F32_REL),
            "delta": (rel_l2(delta, p_delta), BWD_F32_REL),
            "dq": (rel_l2(dq, p_dq), BWD_DQDK_REL),
            "dk": (rel_l2(dk, p_dk), BWD_DQDK_REL),
            "dv": (rel_l2(dv, p_dv), BWD_BF16_REL),
            "rope d q": (rel_l2(rq, p_rq), BWD_BF16_REL),
            "rope d k": (rel_l2(rk, p_rk), BWD_BF16_REL),
            **{f"whole d {n}": (rel_l2(a, r), BWD_WHOLE_REL)
               for n, a, r in zip("qkv", whole, p_whole)}}
        bad = {k_: e for k_, (e, tol) in errs.items()
               if not e <= tol or e != e}
        rerun = all(torch.equal(a, c) for a, c in zip(whole, again))
        pad = max(t[~keep].abs().max().item() if (~keep).any() else 0.0
                  for t in (dk, dv, whole[1], whole[2]))
        tiles = fa.live_key_tiles(u.valid)[idx]
        say(f"K9 backward {name}: relative L2 to the plain versions "
            + ", ".join(f"{k_} {e:.3g}" for k_, (e, _) in errs.items())
            + f" (bounds: fp32 sums {BWD_F32_REL}, bf16 outputs "
            f"{BWD_BF16_REL}, dq / dk {BWD_DQDK_REL}, whole "
            f"{BWD_WHOLE_REL}); rerun bit-equal {rerun}; masked keys' dk / "
            f"dv max |.| {pad}; key tiles walked {tiles.sum().item()} of "
            f"{tiles.numel()} a head; K9's training launch's output "
            f"bit-equal to the serving launch's {same}")
        if bad or not rerun or not same or pad != 0.0 or not all(
                torch.isfinite(t).all() for t in whole):
            fail(f"K9 backward {name}: beyond bounds {bad}, rerun equal "
                 f"{rerun}, training launch's output equal {same}, masked "
                 f"keys {pad}")
        if n_case > 0:
            into = worst if H == cfg.heads else worst_local
            for k_, (e, _) in errs.items():
                into[k_] = max(into.get(k_, 0.0), e)
            continue
        # the record shape: times, bounds, the plain versions, SDPA
        def max_abs(*pairs):
            return max((a.float() - r.float()).abs().max().item()
                       for a, r in pairs)

        nq = b * s * H * D
        live_keys = 64 * tiles.sum().item()  # per head, over the windows
        rows = 2 * b * H * s * 4  # lse and delta
        mask_bytes = u.valid.numel() + 4 * b
        parts = {
            "K9bwd_dq": (
                lambda: fa.windowed_backward_dq(qh, kh, v, out, dout, lse,
                                                u.valid, ids),
                lambda: fa.windowed_backward_dq_plain(qh, kh, v, out, dout,
                                                      lse, u.valid, ids),
                6.0 * H * s * live_keys * D,
                nq * 2 * 5 + nq * 4 + rows + mask_bytes,
                max_abs((dq, p_dq), (delta, p_delta))),
            "K9bwd_dkdv": (
                lambda: fa.windowed_backward_dkdv(qh, kh, v, dout, lse,
                                                  delta, u.valid, ids),
                lambda: fa.windowed_backward_dkdv_plain(
                    qh, kh, v, dout, lse, delta, u.valid, ids),
                8.0 * H * s * live_keys * D,
                nq * 2 * 4 + rows + nq * (4 + 2) + mask_bytes,
                max_abs((dk, p_dk), (dv, p_dv))),
            "K9bwd_prepass": (
                lambda: fa.windowed_rope_backward(dq, dk, u.cos, u.sin, ids,
                                                  scale, fa._LN2),
                lambda: fa.windowed_rope_backward_plain(
                    dq, dk, u.cos, u.sin, ids, scale, fa._LN2),
                0.0, nq * 4 * 2 + nq * 2 * 2 + 2 * u.cos.numel() * 4 + 4 * b,
                max_abs((rq, p_rq), (rk, p_rk))),
        }
        fwd_ms = {key: kernel_ms(torch, run, 10) for key, run in (
            ("serving", lambda: fa.flash_windowed_attention(q, k, v, *args)),
            ("training (lse)",
             lambda: fa.flash_windowed_attention_lse(q, k, v, *args)))}
        qr, kr = attention_core(torch, q, k, u.cos[idx], u.sin[idx])
        qr, kr, vr = (t.detach().requires_grad_() for t in (
            qr, kr, v.transpose(1, 2).contiguous()))
        o = F.scaled_dot_product_attention(qr, kr, vr,
                                           attn_mask=keep[:, None, None, :])
        do = dout.transpose(1, 2)
        lib_ms = kernel_ms(torch, lambda: torch.autograd.grad(
            o, (qr, kr, vr), do, retain_graph=True), 10)
        whole_ms = kernel_ms(torch, lambda: fa.flash_windowed_attention_backward(
            q, k, v, *args, out, dout, lse), 5)
        pair_ms = 0.0
        for key, (run, plain, n_ops, nbytes, err) in parts.items():
            ms = queued_ms(torch, run)
            plain_ms = kernel_ms(torch, plain, 3)
            bound, by = bound_ms(n_ops, PEAK_BF16, nbytes)
            lib = lib_ms if key != "K9bwd_prepass" else None
            if lib is not None:
                pair_ms += ms
            say(f"{key} {name}: kernel {ms:.4f} ms (queued_ms)"
                + (f" ({n_ops / ms / 1e9:.1f} TFLOP/s of the live tiles' "
                   "work)" if n_ops else
                   f" ({nbytes / ms / 1e6:.0f} GB/s)")
                + f", plain {plain_ms:.4f} ms, bound {bound:.4f} ms ({by})"
                + (f", SDPA backward with the key mask (dq, dk, dv at once) "
                   f"{lib_ms:.4f} ms" if lib is not None
                   else ", no library call"))
            recs[key] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             library_ms=lib, bound_ms=bound, bound_by=by,
                             shape=name)
        say(f"K9 backward {name}: dq + dk/dv {pair_ms:.4f} ms against SDPA's "
            f"masked backward {lib_ms:.4f} ms ({pair_ms / lib_ms:.2f}x); "
            f"whole call {whole_ms:.4f} ms (K9's pre-pass again, dq, dk/dv, "
            f"rope backward); K9 forward here: serving "
            f"{fwd_ms['serving']:.4f} ms, training (lse) "
            f"{fwd_ms['training (lse)']:.4f} ms")
        del qr, kr, vr, o, do
    say(f"K9 backward over the training plan's {(len(cases) - 1) // 2} "
        "uniform layers: worst relative L2 to the plain versions "
        + ", ".join(f"{k_} {e:.3g}" for k_, e in worst.items()))
    say(f"K9 backward over the training plan's {(len(cases) - 1) // 2} "
        f"uniform layers at a tp {TRAIN_TP} rank's {cfg.heads // TRAIN_TP} "
        "heads (K9's training launch, its lse, and every backward part): "
        "worst relative L2 to the plain versions "
        + ", ".join(f"{k_} {e:.3g}" for k_, e in worst_local.items()))
    torch.cuda.empty_cache()
    return recs


def leaf_errors(model, grads):
    """Each parameter's gradient in `grads` against the one its .grad now
    holds (relative L2), and over every gradient at once: (overall, {name:
    rel}, names worst first)."""
    leaf, num, den = {}, 0.0, 0.0
    for k, p in model.named_parameters():
        d = (grads[k].float() - p.grad.float()).norm().item()
        n = p.grad.float().norm().item()
        leaf[k] = d / n if n > 0 else (0.0 if d == 0 else float("inf"))
        num, den = num + d * d, den + n * n
    return (num / den) ** 0.5, leaf, sorted(leaf, key=leaf.get, reverse=True)


def train_batch(torch, cfg, device, embeds, seed):
    """The training batch: a seeded (B, 1, 64, 64, 16) latent and condition
    channels, the packaged positive text embedding for every row."""
    gen = torch.Generator(device).manual_seed(seed)
    t, h, w = TRAIN_LATENT
    out = cfg.vid_out_channels
    latent = torch.randn((TRAIN_BATCH, t, h, w, out), generator=gen,
                         device=device)
    cond = torch.randn((TRAIN_BATCH, t, h, w, cfg.vid_in_channels - out),
                       generator=gen, device=device)
    txt = torch.as_tensor(embeds["pos"], device=device)[None].expand(
        TRAIN_BATCH, -1, -1).contiguous()
    return {"latent": latent, "cond": cond, "txt": txt}


def step_generator(torch, device, i):
    """The generator of training step i: every run and every rank draws
    step i's noise and timesteps alike."""
    return torch.Generator(device).manual_seed(5000 + i)


def piece_samples(torch, np, train, cfg, shape, rank, params):
    """Every TRAIN_SAMPLE-th element of each fp32 piece that world rank
    `rank` of the (dp, fsdp, tp) mesh `shape` holds of the whole tensors
    `params` under the trainer's layout (no process group needed), on the
    host."""
    from seedvr2_tpu_torch.parallel.mesh import Mesh

    names = ("dp", "fsdp", "tp")
    mesh = Mesh(names, dict(zip(names, shape)),
                tuple(range(int(np.prod(shape)))), rank)
    layout = train.TrainLayout(cfg, mesh, {k: tuple(v.shape)
                                           for k, v in params.items()})
    return {k: layout.piece(k, v).reshape(-1)[::TRAIN_SAMPLE].clone().cpu()
            for k, v in params.items()}


def sample_errors(torch, got, ref, start):
    """Sampled pieces after the steps (`got`) against one rank's (`ref`):
    (bit-equal, relative L2 of the parameters over every sample, of the
    steps' updates from `start`, the tensor worst on the parameters)."""
    same = all(torch.equal(got[k], ref[k]) for k in ref)
    d = sum(float((got[k] - ref[k]).double().norm()) ** 2 for k in ref)
    n = sum(float(ref[k].double().norm()) ** 2 for k in ref)
    du = sum(float(((got[k] - start[k]) - (ref[k] - start[k])).double()
                   .norm()) ** 2 for k in ref)
    nu = sum(float((ref[k] - start[k]).double().norm()) ** 2 for k in ref)
    worst = max(ref, key=lambda k: float((got[k] - ref[k]).norm())
                / max(float(ref[k].norm()), 1e-30))
    return same, (d / n) ** 0.5, (du / max(nu, 1e-30)) ** 0.5, worst


def train_rank(torch, np, rank: int, port: int, out_dir: str) -> None:
    """One of phase 13's two ranks, both on cuda:0 over gloo: the full 3B
    on each of TRAIN_MESHES from one rank's start (the same seeded model,
    batch and step draws), TRAIN_STEPS steps on the grouped plan held
    against one rank's run (its losses and sampled parameters, which the
    main process wrote to out_dir); on the tp mesh also
    TRAIN_TP_UNIFORM_STEPS on the uniform plan from the start, held so
    against one rank's state after as many steps; then the
    3B's widths at TRAIN_RANK_LAYERS blocks at fsdp 2, a checkpoint after
    step 2 restored onto the mesh and stepped again. Writes rank<N>.json
    into out_dir and exits non-zero on a miss."""
    import gc

    import torch.distributed as dist

    from seedvr2_tpu_torch.core.configs import DIT_3B
    from seedvr2_tpu_torch.core.weights import read_safetensors
    from seedvr2_tpu_torch.models.dit import nadit
    from seedvr2_tpu_torch.parallel import comm, train
    from seedvr2_tpu_torch.parallel.mesh import make_mesh
    from seedvr2_tpu_torch.utils.text_embeds import load_text_embeddings

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank)
    meshes = {name: make_mesh(2, ("dp", "fsdp", "tp"), shape,
                              backend="gloo")
              for name, shape in TRAIN_MESHES}
    wrappers = kernel_wrappers()
    ref = json.load(open(os.path.join(out_dir, "one_rank.json")))
    cfg = DIT_3B
    embeds = load_text_embeddings(txt_dim=cfg.txt_in_dim)
    batch = train_batch(torch, cfg, device, embeds, 7)
    dplan = nadit.upload_plan(nadit.build_dit_plan(
        cfg, TRAIN_LATENT, TXT_LEN, uniform=True), cfg, device)
    plans = {"grouped": dataclasses.replace(dplan, uniform=None),
             "uniform": dplan}
    report, bad = {"meshes": {}}, []

    def start(mesh, plan):
        model = nadit.init_dit(cfg, device, torch.bfloat16,
                               torch.Generator(device).manual_seed(0))
        init_state, step = train.make_train_step(cfg, plan, mesh,
                                                 device=device)
        state = init_state(model)
        del model
        gc.collect()
        torch.cuda.empty_cache()
        return state, step

    def steps(state, step, n):
        losses, secs = [], []
        for i in range(n):
            t1 = time.perf_counter()
            state, loss = step(state, batch, step_generator(torch, device, i))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t1)
            losses.append(loss.item())
        return state, losses, secs

    for name, shape in TRAIN_MESHES:
        mesh = meshes[name]
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        state, step = start(mesh, plans["grouped"])
        init_s = time.perf_counter() - t0
        held = torch.cuda.memory_allocated(device) / 2 ** 30
        s0 = {k: v.reshape(-1)[::TRAIN_SAMPLE].cpu()
              for k, v in state.params.items()}
        reset_counts(wrappers)
        wrappers["K1"].launches_lse = 0
        whole_before = comm.gather_shards.calls
        step.stats.reset()
        state, losses, secs = steps(state, step, TRAIN_STEPS)
        launches = {k: w.launches // TRAIN_STEPS for k, w in wrappers.items()
                    if w.launches}
        lse = wrappers["K1"].launches_lse
        peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
        got = {k: v.reshape(-1)[::TRAIN_SAMPLE].cpu()
               for k, v in state.params.items()}
        want = read_safetensors(os.path.join(out_dir,
                                             f"ref_{name}_{rank}.safetensors"))
        same, p_rel, u_rel, worst = sample_errors(torch, got, want, s0)
        loss_rel = max(abs(a - b) / abs(b)
                       for a, b in zip(losses, ref["grouped"]))
        ways = {k: int(np.prod([mesh.shape[a] for a in
                                state.layout.specs[k] if a]))
                for k in state.params}
        sized = all(state.params[k].numel() * ways[k]
                    == int(np.prod(state.shapes[k])) for k in state.params)
        cut = sum(w == mesh.shape["fsdp"] * mesh.shape["tp"]
                  for w in ways.values())
        rec = dict(losses=losses, loss_rel=loss_rel, bit_equal=same,
                   params_rel=p_rel, updates_rel=u_rel, worst=worst,
                   step_seconds=secs, init_seconds=init_s,
                   state_gib=held, peak_gib=peak, launches=launches,
                   k1_lse=lse, heads=cfg.heads // mesh.shape["tp"],
                   pieces=f"{cut} of {len(ways)} tensors at "
                   f"1/{mesh.shape['fsdp'] * mesh.shape['tp']}",
                   sized=sized, gathers=dict(step.stats.gathers),
                   gathered_high_water_gib=step.stats.high_water / 2 ** 30,
                   whole_gathers=comm.gather_shards.calls - whole_before)
        rec["gathers"] = {str(k): v for k, v in rec["gathers"].items()}
        if name == "fsdp2":
            if not max(loss_rel, p_rel, u_rel) <= TRAIN_RANKS_REL:
                bad.append(f"{name} against one rank: loss {loss_rel}, "
                           f"params {p_rel}, updates {u_rel} beyond "
                           f"{TRAIN_RANKS_REL}")
        elif not (loss_rel <= TRAIN_TP_LOSS_REL
                  and p_rel <= TRAIN_TP_PARAM_REL
                  and u_rel <= TRAIN_TP_UPDATE_REL):
            bad.append(f"{name} against one rank: loss {loss_rel} (bound "
                       f"{TRAIN_TP_LOSS_REL}), params {p_rel} (bound "
                       f"{TRAIN_TP_PARAM_REL}), updates {u_rel} (bound "
                       f"{TRAIN_TP_UPDATE_REL})")
        lo, hi = TRAIN_RANK_PEAK_GIB[name]
        if peak > hi + TRAIN_RANK_PEAK_SLACK_GIB:
            bad.append(f"{name} peak {peak:.2f} GiB beyond the reckoned "
                       f"{lo}-{hi} GiB")
        if not sized or not cut or rec["whole_gathers"]:
            bad.append(f"{name}: pieces sized {sized}, {rec['pieces']}, "
                       f"{rec['whole_gathers']} whole-parameter gathers")
        need = ("K1", "K2", "K1bwd_dq", "K1bwd_dkdv", "K1bwd_prepass",
                "K2bwd")
        if any(not launches.get(k) for k in need) or lse == 0:
            bad.append(f"{name}: the train path's kernels not all launched: "
                       f"{launches}, K1 lse {lse}")
        del state, step, got, want, s0
        gc.collect()
        torch.cuda.empty_cache()
        if name == "tp2":
            # the uniform plan's step at the local heads (K9)
            torch.cuda.reset_peak_memory_stats(device)
            state, step = start(mesh, plans["uniform"])
            s0 = {k: v.reshape(-1)[::TRAIN_SAMPLE].cpu()
                  for k, v in state.params.items()}
            reset_counts(wrappers)
            wrappers["K9"].launches_lse = 0
            state, u_losses, u_secs = steps(state, step,
                                            TRAIN_TP_UNIFORM_STEPS)
            u_launches = {k: w.launches for k, w in wrappers.items()
                          if w.launches}
            u_rel = max(abs(a - b) / abs(b)
                        for a, b in zip(u_losses, ref["uniform"]))
            got = {k: v.reshape(-1)[::TRAIN_SAMPLE].cpu()
                   for k, v in state.params.items()}
            want = read_safetensors(os.path.join(
                out_dir, f"ref_{name}_uniform_{rank}.safetensors"))
            _, up_rel, uu_rel, u_worst = sample_errors(torch, got, want, s0)
            rec.update(uniform_losses=u_losses, uniform_loss_rel=u_rel,
                       uniform_params_rel=up_rel, uniform_updates_rel=uu_rel,
                       uniform_worst=u_worst,
                       uniform_seconds=u_secs, uniform_launches=u_launches,
                       uniform_k9_lse=wrappers["K9"].launches_lse,
                       uniform_peak_gib=torch.cuda.max_memory_allocated(
                           device) / 2 ** 30)
            if not (u_rel <= TRAIN_TP_LOSS_REL
                    and up_rel <= TRAIN_TP_PARAM_REL
                    and uu_rel <= TRAIN_TP_UPDATE_REL):
                bad.append(f"tp2 uniform plan against one rank: loss "
                           f"{u_rel} (bound {TRAIN_TP_LOSS_REL}), params "
                           f"{up_rel} (bound {TRAIN_TP_PARAM_REL}), updates "
                           f"{uu_rel} (bound {TRAIN_TP_UPDATE_REL})")
            if any(not u_launches.get(k) for k in TRAIN_UNIFORM_KERNELS) \
                    or u_launches.get("K1") or u_launches.get("K2"):
                bad.append(f"tp2 uniform plan's launches {u_launches}")
            del state, step, got, want, s0
            gc.collect()
            torch.cuda.empty_cache()
        if not all(np.isfinite(losses)):
            bad.append(f"{name}: non-finite losses {losses}")
        report["meshes"][name] = rec

    # the checkpoint round trip at TRAIN_RANK_LAYERS blocks, fsdp 2
    small = dataclasses.replace(DIT_3B, num_layers=TRAIN_RANK_LAYERS)
    model = nadit.init_dit(small, device, torch.bfloat16,
                           torch.Generator(device).manual_seed(0))
    init_state, step = train.make_train_step(small, plans["grouped"],
                                             meshes["fsdp2"], device=device)
    state = init_state(model)
    del model
    losses = []
    path = os.path.join(out_dir, "state.safetensors")
    for i in range(3):
        if i == 2:
            t1 = time.perf_counter()
            train.save_train_state(state, path)
            report["save_seconds"] = time.perf_counter() - t1
        state, loss = step(state, batch, step_generator(torch, device, i))
        losses.append(loss.item())
    t1 = time.perf_counter()
    back = train.restore_train_state(path, state)
    report["restore_seconds"] = time.perf_counter() - t1
    back, loss = step(back, batch, step_generator(torch, device, 2))
    same = all(torch.equal(back.params[k], state.params[k])
               for k in state.params) and loss.item() == losses[2]
    report["restored_bit_equal"] = bool(same)
    if not same:
        bad.append("the restored state's step 3 differs from the run that "
                   "never stopped")
    report["bad"] = bad
    with open(os.path.join(out_dir, f"train_rank{rank}.json"), "w") as f:
        json.dump(report, f)
    dist.barrier()
    dist.destroy_process_group()
    if bad:
        fail(f"train rank {rank}: {bad}")


def train_ranks(here, out_dir) -> dict:
    """Phase 13's two ranks (train_rank) in two processes; their reports.
    out_dir holds one rank's reference (written by the caller)."""
    port = free_port()
    procs = [subprocess.Popen([sys.executable, os.path.join(
        here, "chip_smoke.py"), "--train-rank", str(r), str(port), out_dir])
        for r in range(2)]
    deadline = time.time() + TRAIN_WORLD_TIMEOUT
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.time()))
    except subprocess.TimeoutExpired:
        fail(f"the two training ranks did not finish in "
             f"{TRAIN_WORLD_TIMEOUT} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode for p in procs):
        fail(f"a training rank failed: exit codes "
             f"{[p.returncode for p in procs]}")
    reports = [json.load(open(os.path.join(out_dir, f"train_rank{r}.json")))
               for r in range(2)]
    for name in os.listdir(out_dir):  # the references and the checkpoint
        os.remove(os.path.join(out_dir, name))
    return reports


def train_phase(torch, np, nadit, fa, gather, device, here, counts, embeds,
                wrappers, k1_ms):
    """Phase 13: K1's, K2's and K9's backward against their plain
    versions (K1's and K9's also at a tp 2 rank's heads), then the full
    32-layer 3B on the grouped and on the uniform window plan (the same
    parameters, batch and draws): on each one backward with every
    gradient checked leaf by leaf against the plain versions' and the two
    plans' losses against each other, then three AdamW steps with the
    kernels (the path's launches, none of the other plan's kernels, step
    times, peak memory) and the same steps with the plain versions; the
    xla attention mode's steps against the flash mode's; then the two-rank
    worlds on the full 3B at fsdp 2 and tp 2 against the one-rank run.
    Returns the backward kernels' records."""
    import gc

    from seedvr2_tpu_torch.core.configs import DIT_3B
    from seedvr2_tpu_torch.core.diffusion import logitnormal_timesteps
    from seedvr2_tpu_torch.core.weights import write_safetensors
    from seedvr2_tpu_torch.parallel import train

    cfg = DIT_3B
    recs = check_k1_backward(torch, fa, nadit, cfg, device, k1_ms)
    recs["K2bwd"] = check_k2_backward(torch, gather, nadit, cfg, device)
    recs.update(check_k9_backward(torch, fa, nadit, cfg, device))
    torch.cuda.empty_cache()

    # the full 3B: every parameter's gradient from one backward
    t0 = time.perf_counter()
    model = nadit.init_dit(cfg, device, torch.bfloat16,
                           torch.Generator(device).manual_seed(0))
    batch = train_batch(torch, cfg, device, embeds, 7)
    plan = nadit.build_dit_plan(cfg, TRAIN_LATENT, TXT_LEN, uniform=True)
    dplan = nadit.upload_plan(plan, cfg, device)
    plans = {"grouped": dataclasses.replace(dplan, uniform=None),
             "uniform": dplan}
    n_params = sum(p.numel() for p in model.parameters())
    gen = step_generator(torch, device, 0)
    noise = torch.randn(batch["latent"].shape, generator=gen, device=device)
    tt = logitnormal_timesteps(gen, (TRAIN_BATCH,))
    one_loss = {}
    for name, pl in plans.items():
        reset_counts(wrappers)
        loss = train.flow_loss(model, batch, noise, tt, pl)
        loss.backward()
        torch.cuda.synchronize()
        launched = {k: w.launches for k, w in wrappers.items() if w.launches}
        missing = [k for k, p in model.named_parameters() if p.grad is None]
        bad = [k for k, p in model.named_parameters()
               if p.grad is not None and not torch.isfinite(p.grad).all()]
        say(f"3B ({cfg.num_layers} blocks, width {cfg.vid_dim}, "
            f"{n_params / 1e9:.3f} B parameters) one flow_loss backward on "
            f"the {name} plan, latent {TRAIN_LATENT} x {TRAIN_BATCH} "
            f"({plan.seq_len} tokens a row, {TXT_LEN} text): loss "
            f"{loss.item():.6g}; {len(missing)} parameters without a "
            f"gradient, {len(bad)} with non-finite values; launches "
            f"{launched}")
        if missing or bad or not torch.isfinite(loss):
            fail(f"3B backward ({name} plan): no gradient for {missing[:4]}, "
                 f"non-finite {bad[:4]}, loss {loss.item()}")
        # the same backward through the plain versions, leaf by leaf
        grads = {k: p.grad for k, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        plain_loss = train.flow_loss(model, batch, noise, tt, pl,
                                     use_kernels=False)
        plain_loss.backward()
        overall, leaf, order = leaf_errors(model, grads)
        say(f"3B backward with the kernels against the plain versions on the "
            f"{name} plan, leaf by leaf: loss {loss.item():.6g} against "
            f"{plain_loss.item():.6g}; relative L2 over every gradient "
            f"{overall:.4g} (bound {BWD_3B_REL}), median leaf "
            f"{leaf[order[len(order) // 2]]:.4g}, worst leaves "
            + ", ".join(f"{k} {leaf[k]:.4g}" for k in order[:4])
            + f" (bound {BWD_LEAF_REL})")
        if not (overall <= BWD_3B_REL and leaf[order[0]] <= BWD_LEAF_REL):
            fail(f"3B backward ({name} plan): kernels against plain relative "
                 f"L2 {overall} overall (bound {BWD_3B_REL}), "
                 f"{[(k, leaf[k]) for k in order[:4]]} on the worst leaves "
                 f"(bound {BWD_LEAF_REL})")
        one_loss[name] = loss.item()
        model.zero_grad(set_to_none=True)
        del loss, plain_loss, grads
    plan_rel = abs(one_loss["uniform"] - one_loss["grouped"]) / abs(
        one_loss["grouped"])
    say(f"3B loss on the uniform plan {one_loss['uniform']:.6g} against the "
        f"grouped plan's {one_loss['grouped']:.6g} (same parameters and "
        f"draws; relative {plan_rel:.3g}, bound {TRAIN_LOSS_REL}: the two "
        "plans compute one function)")
    if not plan_rel <= TRAIN_LOSS_REL:
        fail(f"3B uniform plan's loss {one_loss['uniform']} against the "
             f"grouped plan's {one_loss['grouped']}: {plan_rel}")
    del noise, tt

    # TRAIN_STEPS steps on each plan with the kernels and with the plain
    # versions, each run from the same start
    init_state, _ = train.make_train_step(cfg, dplan, None, device=device)
    state = init_state(model)
    host = {k: v.cpu() for k, v in state.params.items()}  # the start
    del model
    torch.cuda.empty_cache()
    say(f"3B training state built in {time.perf_counter() - t0:.1f} s: "
        f"{torch.cuda.memory_allocated(device) / 2 ** 30:.2f} GiB on the card "
        "(fp32 parameters and both moments)")

    def run_steps(pl, use_kernels, mode="flash", n=TRAIN_STEPS, after=None):
        """n steps on plan `pl` from the start, after(i) called after step
        i: (losses, step seconds, peak GiB)."""
        nonlocal state
        for k, v in host.items():
            state.params[k].copy_(v)
            state.opt_state["mu"][k].zero_()
            state.opt_state["nu"][k].zero_()
        state = state._replace(step=0)
        _, step = train.make_train_step(cfg, pl, None, device=device,
                                        use_kernels=use_kernels,
                                        attention_mode=mode)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        losses, secs = [], []
        for i in range(n):
            t1 = time.perf_counter()
            state, loss = step(state, batch, step_generator(torch, device, i))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t1)
            losses.append(loss.item())
            if after is not None:
                after(i)
        return losses, secs, torch.cuda.max_memory_allocated(device) / 2 ** 30

    out_dir = os.path.join(here, "build", "train_smoke")
    os.makedirs(out_dir, exist_ok=True)
    for name in os.listdir(out_dir):
        os.remove(os.path.join(out_dir, name))
    one_rank, one_rank_secs = {}, {}
    per_step = {}

    def write_refs(mesh_name, shape):
        """Each of the two ranks' sampled pieces of the state as it is now,
        under mesh `shape`, for the two-rank worlds."""
        t1 = time.perf_counter()
        for r in range(2):
            write_safetensors(
                os.path.join(out_dir, f"ref_{mesh_name}_{r}.safetensors"),
                piece_samples(torch, np, train, cfg, shape, r, state.params))
        say(f"one rank's sampled pieces (every {TRAIN_SAMPLE}th element) "
            f"for the two-rank {mesh_name} world written in "
            f"{time.perf_counter() - t1:.1f} s")

    tp_shape = dict(TRAIN_MESHES)["tp2"]

    def uniform_refs(i):
        if i == TRAIN_TP_UNIFORM_STEPS - 1:
            write_refs("tp2_uniform", tp_shape)
    for name, path, needed, absent in (
            ("grouped", "train", TRAIN_KERNELS, ("K9",) + tuple(
                k for k in TRAIN_UNIFORM_KERNELS if k != "K9")),
            ("uniform", "train_uniform", TRAIN_UNIFORM_KERNELS,
             TRAIN_KERNELS)):
        reset_counts(wrappers)
        fa.packed_window_attention.launches_lse = 0
        fa.flash_windowed_attention.launches_lse = 0
        losses, secs, peak = run_steps(
            plans[name], True, after=uniform_refs if name == "uniform"
            else None)
        counts[path] = read_counts(wrappers, needed, path)
        mu = state.opt_state["mu"]
        dead = [k for k, v in mu.items() if not v.abs().sum().item() > 0]
        nonfinite = [k for k in state.params
                     if not (torch.isfinite(state.params[k]).all()
                             and torch.isfinite(mu[k]).all())]
        per_step[name] = {k: counts[path][k] // TRAIN_STEPS
                          for k in needed + absent}
        lse_step = (fa.packed_window_attention.launches_lse
                    if name == "grouped" else
                    fa.flash_windowed_attention.launches_lse) // TRAIN_STEPS
        say(f"3B train steps on the {name} plan with the kernels: losses "
            f"{losses}; step seconds {[round(x, 3) for x in secs]}; peak "
            f"{peak:.2f} GiB allocated (reckoned "
            f"{TRAIN_PEAK_GIB[0]}-{TRAIN_PEAK_GIB[1]} GiB); launches a step "
            f"{per_step[name]}, of {needed[0]} {lse_step} through its "
            f"training (lse) launch; {len(dead)} parameters whose first "
            f"moment stayed zero, {len(nonfinite)} non-finite")
        stray = [k for k in absent if per_step[name][k]]
        dq_step = per_step[name][f"{needed[0]}bwd_dq"]
        # the uniform plan: one K9 call and one of each backward part a
        # layer
        short = [k for k in needed if name == "uniform"
                 and per_step[name][k] != cfg.num_layers]
        if (dead or nonfinite or stray or short
                or not all(np.isfinite(losses)) or lse_step != dq_step):
            fail(f"3B train steps ({name} plan): zero moments {dead[:4]}, "
                 f"non-finite {nonfinite[:4]}, losses {losses}, launched "
                 f"{stray} of the other plan, {short} not once a layer, "
                 f"{needed[0]} lse launches a step {lse_step} against "
                 f"{dq_step} dq launches")
        one_rank[name] = losses
        one_rank_secs[name] = secs
        if name == "grouped":
            # the two-rank worlds' reference after the grouped steps
            for mesh_name, shape in TRAIN_MESHES:
                write_refs(mesh_name, shape)
        plain, plain_secs, _ = run_steps(plans[name], False)
        errs = [abs(a - b) / abs(b) for a, b in zip(losses, plain)]
        say(f"3B train steps on the {name} plan with the plain versions: "
            f"losses {plain} (relative to the kernels' "
            f"{[f'{e:.3g}' for e in errs]}, bound {TRAIN_LOSS_REL}); step "
            f"seconds {[round(x, 3) for x in plain_secs]}")
        if not max(errs) <= TRAIN_LOSS_REL:
            fail(f"3B train steps ({name} plan): kernels vs plain losses "
                 f"{errs} beyond {TRAIN_LOSS_REL}")
    # the xla attention mode (SDPA and its autograd backward, K2 and its
    # backward still) from the same start on the same draws
    reset_counts(wrappers)
    xla, xla_secs, xla_peak = run_steps(plans["grouped"], True, "xla",
                                        TRAIN_XLA_STEPS)
    xla_launches = {k: w.launches for k, w in wrappers.items() if w.launches}
    errs = [abs(a - b) / abs(b) for a, b in zip(xla, one_rank["grouped"])]
    say(f"3B train steps on the grouped plan under attention_mode=\"xla\": "
        f"losses {xla} against the flash mode's "
        f"{one_rank['grouped'][:TRAIN_XLA_STEPS]} (relative "
        f"{[f'{e:.3g}' for e in errs]}, bound {TRAIN_LOSS_REL}); step "
        f"seconds {[round(x, 3) for x in xla_secs]} against the flash "
        f"mode's {[round(x, 3) for x in one_rank_secs['grouped']]} (the "
        f"step's library baseline: SDPA and its backward in place of K1 "
        f"and K1's backward); peak {xla_peak:.2f} GiB; launches "
        f"{xla_launches}")
    if (not max(errs) <= TRAIN_LOSS_REL or xla_launches.get("K1")
            or any(xla_launches.get(k) for k in TRAIN_KERNELS[2:5])
            or not xla_launches.get("K2") or not xla_launches.get("K2bwd")):
        fail(f"3B train steps under xla: losses {errs} beyond "
             f"{TRAIN_LOSS_REL}, or launches {xla_launches} (no K1 nor its "
             "backward, K2 and its backward)")
    del state, batch, dplan, plans, host, mu
    gc.collect()
    torch.cuda.empty_cache()
    for key in TRAIN_KERNELS[2:]:
        recs[key]["launches_per_step"] = per_step["grouped"][key]
    for key in TRAIN_UNIFORM_KERNELS[1:]:
        recs[key]["launches_per_step"] = per_step["uniform"][key]

    # two ranks on the full 3B at fsdp 2 and at tp 2
    with open(os.path.join(out_dir, "one_rank.json"), "w") as f:
        json.dump(one_rank, f)
    say(f"device memory held before the two-rank worlds: "
        f"{torch.cuda.memory_allocated(device) / 2 ** 30:.3f} GiB")
    t0 = time.perf_counter()
    reports = train_ranks(here, out_dir)
    for name, shape in TRAIN_MESHES:
        lo, hi = TRAIN_RANK_PEAK_GIB[name]
        for r, rep in enumerate(reports):
            m = rep["meshes"][name]
            bound = (f"{TRAIN_RANKS_REL} on each" if name == "fsdp2" else
                     f"loss {TRAIN_TP_LOSS_REL}, params {TRAIN_TP_PARAM_REL}, "
                     f"updates {TRAIN_TP_UPDATE_REL}")
            say(f"full 3B, two ranks on cuda:0 over gloo, mesh (dp, fsdp, "
                f"tp) = {shape}, rank {r} ({m['heads']} heads): losses "
                f"{m['losses']} against one rank's "
                f"{one_rank['grouped']} (loss rel {m['loss_rel']:.3g}; "
                f"sampled parameters rel {m['params_rel']:.3g}, their "
                f"updates rel {m['updates_rel']:.3g}, worst tensor "
                f"{m['worst']}; bound {bound}; bit-equal {m['bit_equal']}); "
                f"step seconds {[round(x, 2) for x in m['step_seconds']]} "
                f"(two ranks share one card over gloo: correctness, not "
                f"speed); state built in {m['init_seconds']:.1f} s, "
                f"{m['state_gib']:.2f} GiB; peak {m['peak_gib']:.2f} GiB "
                f"allocated (reckoned {lo}-{hi} GiB); {m['pieces']}; "
                f"gathers {m['gathers']}, gathered bytes alive at most "
                f"{m['gathered_high_water_gib']:.3f} GiB; whole-parameter "
                f"gathers in the steps {m['whole_gathers']}; launches a "
                f"step {m['launches']}, K1 training (lse) launches "
                f"{m['k1_lse']}")
            if name == "tp2":
                say(f"  tp 2 rank {r} on the uniform plan: losses "
                    f"{m['uniform_losses']} against one rank's "
                    f"{one_rank['uniform'][:TRAIN_TP_UNIFORM_STEPS]} (rel "
                    f"{m['uniform_loss_rel']:.3g}, bound "
                    f"{TRAIN_TP_LOSS_REL}); sampled parameters rel "
                    f"{m['uniform_params_rel']:.3g} (bound "
                    f"{TRAIN_TP_PARAM_REL}), their update rel "
                    f"{m['uniform_updates_rel']:.3g} (bound "
                    f"{TRAIN_TP_UPDATE_REL}), worst tensor "
                    f"{m['uniform_worst']}; seconds "
                    f"{[round(x, 2) for x in m['uniform_seconds']]}; peak "
                    f"{m['uniform_peak_gib']:.2f} GiB; launches "
                    f"{m['uniform_launches']}, K9 training (lse) launches "
                    f"{m['uniform_k9_lse']}")
    r0 = reports[0]
    say(f"the 3B's widths at {TRAIN_RANK_LAYERS} blocks at fsdp 2: "
        f"checkpoint saved in {r0['save_seconds']:.2f} s, restored in "
        f"{r0['restore_seconds']:.2f} s, its step bit-equal "
        f"{r0['restored_bit_equal']} on both ranks; two-rank worlds "
        f"{time.perf_counter() - t0:.1f} s")
    return recs


def kernel_wrappers():
    """Each kernel's wrapper, whose `launches` counts its launches."""
    from seedvr2_tpu_torch.ops import flash_attention as fa
    from seedvr2_tpu_torch.ops import fused_norm as fn
    from seedvr2_tpu_torch.ops import fused_quant as fq
    from seedvr2_tpu_torch.ops import gather
    from seedvr2_tpu_torch.ops import int8_conv as ic
    from seedvr2_tpu_torch.ops import int8_matmul as im
    from seedvr2_tpu_torch.ops import quant_matmul as qm

    return {"K1": fa.packed_window_attention, "K2": gather.gather_rows,
            "K3": im.int8_matmul, "K4": fq.rms_ada_quantize,
            "K5": fq.silu_mul_quantize, "K6": qm.quant_matmul_q8,
            "K7": qm.quant_matmul_affine, "K8": fa.flash_attention,
            "K9": fa.flash_windowed_attention, "K10": im.int8_matmul_qx,
            "K11": ic.int8_conv3d, "K12": fn.norm_silu_head,
            "K1bwd_dq": fa.attention_backward_dq,
            "K1bwd_dkdv": fa.attention_backward_dkdv,
            "K1bwd_prepass": fa.prepass_backward, "K2bwd": gather.GatherRows,
            "K9bwd_dq": fa.windowed_backward_dq,
            "K9bwd_dkdv": fa.windowed_backward_dkdv,
            "K9bwd_prepass": fa.windowed_rope_backward}


def f32_wrappers():
    """The wrappers of the fp32-output variants, whose `launches_f32`
    counts the launches with the fp32 epilogue."""
    from seedvr2_tpu_torch.ops import int8_matmul as im
    from seedvr2_tpu_torch.ops import quant_matmul as qm

    return {"K3f32": im.int8_matmul, "K6f32": qm.quant_matmul_q8,
            "K7f32": qm.quant_matmul_affine}


def main() -> None:
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "seedvr2_tpu_torch")):
        fail("the seedvr2_tpu_torch package is not next to chip_smoke.py")
    sys.path.insert(0, here)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false; this smoke needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    if sys.argv[1:2] == ["--parallel-rank"]:  # phase 2b's ranks
        parallel_rank(torch, np, int(sys.argv[2]), int(sys.argv[3]),
                      sys.argv[4])
        return
    if sys.argv[1:2] == ["--train-rank"]:  # phase 13's ranks
        train_rank(torch, np, int(sys.argv[2]), int(sys.argv[3]),
                   sys.argv[4])
        return

    from seedvr2_tpu_torch import cli
    from seedvr2_tpu_torch.core import pipeline
    from seedvr2_tpu_torch.core.configs import DIT_3B, VAE_V3
    from seedvr2_tpu_torch.models.dit import nadit
    from seedvr2_tpu_torch.models.vae.pipeline_vae import VideoVAE
    from seedvr2_tpu_torch.ops import _build, gather, gguf, native
    from seedvr2_tpu_torch.ops.attention import attention
    from seedvr2_tpu_torch.ops import flash_attention as fa
    from seedvr2_tpu_torch.ops import fused_norm as fn
    from seedvr2_tpu_torch.ops import fused_quant as fq
    from seedvr2_tpu_torch.ops import int8_conv as ic
    from seedvr2_tpu_torch.ops import int8_matmul as im
    from seedvr2_tpu_torch.ops import quant_matmul as qm
    from seedvr2_tpu_torch.profile_requests import make_frames
    from seedvr2_tpu_torch.utils.text_embeds import load_text_embeddings

    wrappers = kernel_wrappers()
    t_phase = [time.perf_counter()]

    def phase_done(label):
        now = time.perf_counter()
        say(f"phase {label}: {now - t_phase[0]:.1f} s")
        t_phase[0] = now

    # 1. environment and build
    card = card_line()
    say(f"card: {card}")
    say(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    lib = _build.kernel_library()
    say(f"kernels built in {lib.build_seconds:.2f} s -> {lib.path.name}")
    for line in lib.ptxas_log.splitlines():  # per-kernel resource report
        if any(w in line for w in ("Compiling entry", "registers", "spill",
                                   "(C75")):
            say(f"  {line.strip()}")

    # 2. kernels against their plain versions at 3B shapes, among them the
    # token counts of the throughput requests served in phase 5
    path_latents = [(label, latent_shape(VAE_V3, t, h, w, res))
                    for label, t, h, w, res in FAST_REQUESTS]
    path_rows = [(label, nadit.build_dit_plan(DIT_3B, shape,
                                              TXT_LEN).seq_len)
                 for label, shape in path_latents]
    say(f"throughput requests' latents {path_latents}, DiT rows {path_rows}")
    recs = {"K1": check_k1(torch, fa, nadit, DIT_3B, device, path_latents),
            "K2": check_k2(torch, gather, nadit, DIT_3B, device,
                           path_latents),
            "K3": check_k3(torch, im, DIT_3B, device, path_rows)}
    recs.update(check_k4_k5(torch, fq, DIT_3B, device, path_rows))

    def rows_of(label, t, h, w, res):
        shape = latent_shape(VAE_V3, t, h, w, res)
        return label, nadit.build_dit_plan(DIT_3B, shape, TXT_LEN).seq_len

    lane_rows = {"K6": [rows_of("image 1080", 1, 540, 960, 1080),
                        rows_of("clip 720", 5, 360, 640, 720)],
                 "K7": [rows_of("clip 1080", 5, 540, 960, 1080),
                        rows_of("clip 720", 5, 360, 640, 720)]}
    say(f"quantised lanes' DiT rows {lane_rows}")
    recs.update(check_k6_k7(torch, qm, DIT_3B, device, lane_rows))
    recs["K8"], k8_case = check_k8(torch, fa, nadit, DIT_3B, device)
    recs["K9"] = check_k9(torch, fa, nadit, DIT_3B, device)
    recs["K10"], k10_ops = check_k10(torch, im, device)

    # K8's and K10's own paths, which no product code takes: the
    # dispatcher's dense branch at K8's first shape, and the op at each
    # 1080p linear, each driven once with the counts from 0
    counts = {}
    q, k, v, cos, sin, kv = k8_case
    reset_counts(wrappers)
    out = attention(q, k, v, rope_cos=cos, rope_sin=sin, kv_len=kv)
    torch.cuda.synchronize()
    counts[DENSE_PATH] = read_counts(wrappers, ("K8",), DENSE_PATH)
    if not torch.isfinite(out).all():
        fail("the attention dispatcher's dense path: non-finite output")
    reset_counts(wrappers)
    for x, wq, ws in k10_ops:
        out = im.int8_matmul_qx(x, wq, ws)
    torch.cuda.synchronize()
    counts[OP_PATH] = read_counts(wrappers, ("K10",), OP_PATH)
    del q, k, v, cos, sin, k8_case, k10_ops, x, wq, ws, out
    torch.cuda.empty_cache()
    recs["K11"] = check_k11(torch, ic, device)
    recs["K12"] = check_k12(torch, fn, device)
    phase_done("2 (kernels against plain versions)")

    # 2b. serving parallelism on the one card: the fp32 variants, two
    # ranks sharing it (tp2 lanes, a dp2 request), the NCCL path
    recs.update(parallel_phase(torch, np, im, qm, cli, device, here, counts))
    phase_done("2b (serving parallelism)")

    # 3. the default path: three requests at full width (the models cached
    # for phase 3b's CLI runs)
    t0 = time.perf_counter()
    runner = cli.make_runner(device, seed=0, dit_cache=True, vae_cache=True)
    torch.cuda.synchronize()
    n_dit = sum(p.numel() for p in runner.dit.parameters())
    n_vae = sum(p.numel() for p in runner.vae.model.parameters())
    say(f"models built on the card in {time.perf_counter() - t0:.2f} s: "
        f"DiT {n_dit / 1e9:.3f} B params ({DIT_3B.num_layers} layers, width "
        f"{DIT_3B.vid_dim}), VAE {n_vae / 1e6:.1f} M params, bf16")
    embeds = load_text_embeddings(txt_dim=DIT_3B.txt_in_dim)
    if embeds["pos"].shape[0] != TXT_LEN:
        fail(f"positive text embedding has {embeds['pos'].shape[0]} tokens, "
             f"the kernel checks assumed {TXT_LEN}")
    image = make_frames(1, 360, 640, seed=3)
    clip = make_frames(5, 360, 640, seed=4)
    reset_counts(wrappers)
    serve(torch, np, cli, runner, (
        ("image 1x360x640 -> 720", image, 720, (1, 720, 1280, 3)),
        ("clip 5x360x640 -> 720", clip, 720, (5, 720, 1280, 3)),
        ("clip again", clip, 720, (5, 720, 1280, 3))), device, embeds)
    counts["default"] = read_counts(wrappers, ("K1", "K2"), "default")
    phase_done("3 (default path)")

    # 3b. the CLI surface on those models
    cli_surface_phase(torch, np, cli, nadit, pipeline, runner, device,
                      embeds, wrappers, counts, make_frames, here)
    phase_done("3b (CLI surface)")

    # 3c. the ComfyUI node surface and the shipped image workflows
    node_phase(torch, np, pipeline, device, wrappers, counts, make_frames,
               here)
    phase_done("3c (nodes and workflows)")

    # 4. whole DiT, kernels against plain versions, on the clip's latent
    txt = torch.as_tensor(embeds["pos"], dtype=torch.bfloat16,
                          device=device)[None]
    tt = torch.full((1,), 1000.0, device=device)

    def dit_inputs(r, frames, res):
        """The DiT's input for one request encoded by runner r (noise from
        a seed beside the condition) and its plan."""
        ctx = pipeline.setup_generation_context(device)
        ctx = pipeline.encode_all_batches(r, ctx, frames, resolution=res)
        latent = ctx["all_latents"][0]
        gen = torch.Generator(device).manual_seed(42)
        noise = torch.randn(latent.shape, generator=gen, device=device).to(
            torch.bfloat16)
        vid_in = torch.cat([noise, r.get_condition(noise, latent)], -1)[None]
        return vid_in, r.plan(tuple(latent.shape[:3]), txt.shape[1])

    def dit_runs(model, label, vid_in, dplan, limit):
        """Outputs {use_kernels: out} of one forward each, relative L2 of
        kernels against plain versions held to `limit`."""
        outs, ms = {}, {}
        with torch.no_grad():
            for uk in (True, False):
                fwd = (lambda uk=uk: nadit.nadit_forward(
                    model, vid_in, txt, tt, dplan, use_kernels=uk))
                outs[uk] = fwd()  # also the warm-up
                # the plain versions timed once: their times only frame
                # the kernels'
                ms[uk] = cuda_ms(torch, fwd, 3 if uk else 1, warmup=0)
        rel = rel_l2(outs[True], outs[False])
        say(f"whole {label} DiT on latent {dplan.plan.vid_shape} "
            f"({dplan.plan.seq_len} tokens): relative L2 kernels vs plain "
            f"{rel:.6g} (bound {limit}); forward {ms[True]:.2f} ms with "
            f"kernels, {ms[False]:.2f} ms plain")
        if not torch.isfinite(outs[True]).all() or rel > limit:
            fail(f"whole {label} DiT kernels vs plain: relative L2 {rel} > "
                 f"{limit}")
        return outs, rel

    vid_in, dplan = dit_inputs(runner, clip, 720)
    if dplan.plan.vid_shape != latent_shape(VAE_V3, 5, 360, 640, 720):
        fail(f"latent_shape disagrees with the encoded clip "
             f"{dplan.plan.vid_shape}")
    dit_runs(runner.dit, "bf16", vid_in, dplan, DIT_REL_L2)
    clip_in = (vid_in, dplan)
    phase_done("4 (whole bf16 DiT)")

    # 4b. the rest of the request surface: RGBA, the colour methods, ref
    # tiles with the tile_debug overlay, the t2v / i2v conditions
    counts["request_surface"], finish_surface = check_request_surface(
        torch, np, cli, pipeline, nadit, runner, device, embeds, txt, tt,
        clip, wrappers)
    phase_done("4b (request surface)")

    # 5. the throughput path: the same weights in w8a8, tiled VAE
    args = cli.parse_arguments(["unused.npy", "--preset", "throughput"])
    tiling = cli.tiling_from_args(args)
    t0 = time.perf_counter()
    fast = cli.make_runner(device, seed=0, quant=args.quant, tiling=tiling)
    torch.cuda.synchronize()
    w8 = [m for m in fast.dit.modules() if isinstance(m, im.W8A8Linear)]
    w8_bytes = sum(m.w8a8.numel() + m.ws.numel() * 4 for m in w8)
    dense_bytes = sum(p.numel() * p.element_size()
                      for p in fast.dit.parameters())
    say(f"w8a8 DiT built and converted in {time.perf_counter() - t0:.2f} s: "
        f"{len(w8)} linears int8 ({w8_bytes / 2 ** 30:.3f} GiB), "
        f"{dense_bytes / 2 ** 30:.3f} GiB left in bf16; tiling {tiling}")
    fast_frames = [make_frames(t, h, w, seed=5 + i)
                   for i, (_, t, h, w, _) in enumerate(FAST_REQUESTS)]
    fast_inputs = []
    for (label, shape), frames, (*_, res) in zip(path_latents, fast_frames,
                                                 FAST_REQUESTS):
        fast_inputs.append(dit_inputs(fast, frames, res))
        if fast_inputs[-1][1].plan.vid_shape != shape:
            fail(f"{label}: encoded latent {fast_inputs[-1][1].plan.vid_shape}"
                 f" is not the {shape} the kernel checks used")
    # the whole w8a8 DiT on the 1080p clip's latent, against its plain
    # versions and against the bf16 DiT on the same weights
    vid_in, dplan = fast_inputs[0]
    w8_outs, w8_rel = dit_runs(fast.dit, "w8a8", vid_in, dplan,
                               W8A8_DIT_REL_L2)
    with torch.no_grad():
        dense = nadit.nadit_forward(runner.dit, vid_in, txt, tt, dplan)
        dense_plain = nadit.nadit_forward(runner.dit, vid_in, txt, tt, dplan,
                                          use_kernels=False)
    to_dense = rel_l2(w8_outs[True], dense)
    gap_plain = rel_l2(w8_outs[False], dense_plain)
    say(f"w8a8 against bf16 DiT, same weights, same latent: relative L2 "
        f"{to_dense:.6g} with kernels, {gap_plain:.6g} plain; w8a8 kernels "
        f"vs w8a8 plain {w8_rel:.6g} must be the smaller")
    if not w8_rel < to_dense:
        fail(f"the w8a8 DiT with kernels is no closer to its plain w8a8 "
             f"version ({w8_rel}) than to the bf16 DiT ({to_dense})")
    phase_done("5 (w8a8 DiT)")

    # 5b. the uniform window plan: the bf16 and w8a8 DiTs above on both
    # clip latents, against their plain versions and the grouped plan
    counts["uniform"] = check_uniform(
        torch, nadit, DIT_3B, device, wrappers, txt, tt,
        {"bf16": runner.dit, "w8a8": fast.dit},
        {"720p clip": clip_in, "1080p clip": fast_inputs[0]})
    phase_done("5b (uniform window plan)")

    # 6. the q8 and q4 lanes: the same weights quantised on the card
    t0 = time.perf_counter()
    q8 = cli.make_runner(device, seed=0, quant="q8")
    torch.cuda.synchronize()
    say(f"q8 DiT built and converted in {time.perf_counter() - t0:.2f} s: "
        f"{dit_bytes(torch, im, qm, q8.dit)}")
    say(f"bf16 DiT: {dit_bytes(torch, im, qm, runner.dit)}; w8a8 DiT: "
        f"{dit_bytes(torch, im, qm, fast.dit)}")
    vid_in, dplan = clip_in
    q8_outs, q8_rel = dit_runs(q8.dit, "q8", vid_in, dplan, QUANT_DIT_REL_L2)
    with torch.no_grad():
        dense = nadit.nadit_forward(runner.dit, vid_in, txt, tt, dplan)
    q8_to_dense = rel_l2(q8_outs[True], dense)
    say(f"q8 against bf16 DiT, same weights, 720p clip latent: relative L2 "
        f"{q8_to_dense:.6g} with kernels; q8 kernels vs q8 plain "
        f"{q8_rel:.6g} must be the smaller")
    if not q8_rel < q8_to_dense:
        fail(f"the q8 DiT with kernels is no closer to its plain q8 version "
             f"({q8_rel}) than to the bf16 DiT ({q8_to_dense})")
    # one real layer: K6 within an ulp of the plain q8 product, and farther
    # than that from the bf16 product of the unconverted weight
    lin = runner.dit.blocks[0].attn.proj_qkv["vid"]
    qlin = q8.dit.blocks[0].attn.proj_qkv["vid"]
    if not isinstance(qlin, qm.Q8Linear):
        fail(f"q8 lane: blocks.0 qkv is a {type(qlin).__name__}")
    gen = torch.Generator(device).manual_seed(9)
    x = torch.randn(dplan.plan.seq_len, lin.in_features, generator=gen,
                    device=device).to(torch.bfloat16)
    with torch.no_grad():
        out_k = qm.quant_matmul_q8(x, qlin.q8, qlin.scales)
        out_p = qm.quant_matmul_q8_plain(x, qlin.q8, qlin.scales)
        out_d = torch.matmul(x.float(), lin.weight.float().t()).to(
            torch.bfloat16)
    to_plain = bf16_ulps(torch, out_k, out_p)
    to_dense = bf16_ulps(torch, out_k, out_d)
    say(f"q8 layer blocks.0 qkv at {x.shape[0]} rows: K6 vs plain q8 max "
        f"{to_plain.max().item():.3g} ulps (rel L2 "
        f"{rel_l2(out_k, out_p):.3g}); K6 vs the bf16 weight's product max "
        f"{to_dense.max().item():.3g} ulps, {(to_dense > 1).float().mean()
        .item() * 100:.2f} % beyond one (rel L2 {rel_l2(out_k, out_d):.3g})")
    if to_plain.max().item() > K6_MAX_ULPS or not (
            to_dense.max().item() > K6_MAX_ULPS
            and rel_l2(out_k, out_d) > 4 * rel_l2(out_k, out_p)):
        fail("q8 layer: K6's output is not the quantised product (within an "
             "ulp of plain q8, clearly off the bf16 product)")

    args = cli.parse_arguments(["unused.npy", "--preset", "throughput",
                                "--quant", "q4"])
    q4_tiling = cli.tiling_from_args(args)
    t0 = time.perf_counter()
    q4 = cli.make_runner(device, seed=0, quant=args.quant, tiling=q4_tiling)
    torch.cuda.synchronize()
    say(f"q4 DiT built and converted in {time.perf_counter() - t0:.2f} s: "
        f"{dit_bytes(torch, im, qm, q4.dit)}; tiling {q4_tiling}")
    vid_in, dplan = fast_inputs[0]
    q4_outs, q4_rel = dit_runs(q4.dit, "q4", vid_in, dplan, QUANT_DIT_REL_L2)
    with torch.no_grad():
        dense = nadit.nadit_forward(runner.dit, vid_in, txt, tt, dplan)
    q4_to_dense = rel_l2(q4_outs[True], dense)
    say(f"q4 against bf16 DiT, same weights, 1080p clip latent: relative L2 "
        f"{q4_to_dense:.6g} with kernels; q4 kernels vs q4 plain "
        f"{q4_rel:.6g} must be the smaller")
    if not q4_rel < q4_to_dense:
        fail(f"the q4 DiT with kernels is no closer to its plain q4 version "
             f"({q4_rel}) than to the bf16 DiT ({q4_to_dense})")
    del runner, fast_inputs, vid_in, dplan, w8_outs, q8_outs, q4_outs, dense
    del dense_plain, clip_in, lin, qlin, x, out_k, out_p, out_d, to_plain
    del to_dense, w8  # w8 holds the w8a8 DiT's linears
    torch.cuda.empty_cache()
    phase_done("6 (q8 and q4 DiTs)")

    # 7. serving: the throughput, q8 and q4 lanes
    def lane(name, r, reqs, needed, phase="7"):
        requests = []
        for i, (label, t, h, w, res) in enumerate(reqs):
            frames = make_frames(t, h, w, seed=20 + i)
            requests.append((label, frames, res, (t, res, res * w // h, 3)))
        reset_counts(wrappers)
        serve(torch, np, cli, r, requests, device, embeds)
        counts[name] = read_counts(wrappers, needed, name)
        phase_done(f"{phase} ({name} lane served)")

    requests = []
    for (label, t, h, w, res), frames in zip(FAST_REQUESTS, fast_frames):
        expect = (t, res, res * w // h, 3)
        requests.append((label, frames, res, expect))
    reset_counts(wrappers)
    serve(torch, np, cli, fast, requests, device, embeds)
    counts["throughput"] = read_counts(
        wrappers, ("K1", "K2", "K3", "K4", "K5"), "throughput")
    phase_done("7 (throughput lane served)")
    del fast
    torch.cuda.empty_cache()
    lane("q8", q8, Q8_REQUESTS, ("K1", "K2", "K6"))
    lane("q4", q4, Q4_REQUESTS, ("K1", "K2", "K7"))
    del q4
    torch.cuda.empty_cache()
    finish_surface()  # phase 4b's CPU references, run beside phases 4b-7
    phase_done("4b's CPU references (the wait left after phase 7)")

    # 8. the GGUF lane: a full-size Q4_K_M-like file through the loader,
    # loaded with the host library and with the numpy dequantizers
    import tempfile

    label, t, h, w, res = Q8_REQUESTS[1]
    frames = make_frames(t, h, w, seed=30)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "seedvr2_ema_3b-Q4_K_M.gguf")
        t0 = time.perf_counter()
        expect, layout = gguf_from_q8_runner(torch, qm, q8.dit, path, device)
        size = os.path.getsize(path)
        say(f"GGUF written in {time.perf_counter() - t0:.2f} s: "
            f"{size / 2 ** 30:.3f} GiB, {gguf_kinds(expect)}")
        gg, gg_np, _ = gguf_loads(torch, cli, gguf, native, path, device,
                                  "3B")
        say(f"GGUF DiT on the card: {dit_bytes(torch, im, qm, gg.dit)}")
        finish = gguf_block_check(np, gguf, native, path, layout)
        check_gguf_modules(torch, qm, gg.dit, q8.dit, expect, "3B")
        del q8
        torch.cuda.empty_cache()
        reset_counts(wrappers)
        serve(torch, np, cli, gg, ((f"GGUF q4k {label}", frames, res,
                                    (t, res, res * w // h, 3)),), device,
              embeds)
        counts["gguf"] = read_counts(wrappers, ("K1", "K2", "K6", "K7"),
                                     "gguf")
        same_request(torch, np, cli, (gg, gg_np), frames, res, embeds,
                     f"3B GGUF q4k {label}")
        del gg, gg_np
        torch.cuda.empty_cache()
        finish("3B")
    phase_done("8 (GGUF lane)")

    # 9. the VAE's opt-in lanes: --vae_quant int8 and SEEDVR2_FUSED_NORM=1
    t0 = time.perf_counter()
    base = cli.make_runner(device, seed=0)
    int8_vae = cli.make_runner(device, seed=0, vae_quant="int8")
    torch.cuda.synchronize()
    served = sum(1 for m in int8_vae.vae.model.modules() if hasattr(m, "wq"))
    say(f"bf16 and int8-VAE runners built in {time.perf_counter() - t0:.2f} "
        f"s; {served} decoder convs quantized to int8")
    samples = []  # the encoder's input, kept for the fused-norm comparison
    encode = base.vae_encode
    base.vae_encode = lambda s: (samples.extend(s), encode(s))[1]
    ctx = pipeline.encode_all_batches(
        base, pipeline.setup_generation_context(device), clip, resolution=720)
    del base.vae_encode
    latent = ctx["all_latents"][0]
    del ctx

    def decode(r, use_kernels=True):
        r.vae.lowering = dataclasses.replace(r.vae.lowering,
                                             use_kernels=use_kernels)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = r.vae_decode([latent])[0]
        torch.cuda.synchronize()
        r.vae.lowering = dataclasses.replace(r.vae.lowering, use_kernels=True)
        return out, time.perf_counter() - t1

    reset_counts(wrappers)
    dec_k, sec_k = decode(int8_vae)
    k11_n = ic.int8_conv3d.launches
    dec_p, sec_p = decode(int8_vae, use_kernels=False)
    dec_b, sec_b = decode(base)
    rel = rel_l2(dec_k, dec_p)
    to_bf16 = rel_l2(dec_k, dec_b)
    gap = rel_l2(dec_p, dec_b)
    say(f"whole int8 VAE decode of the 720p clip latent {tuple(latent.shape)}"
        f" -> {tuple(dec_k.shape)}: {k11_n} K11 launches; relative L2 "
        f"kernels vs plain {rel:.6g} (bound {INT8_DECODE_REL_L2}), kernels vs "
        f"the bf16 decode {to_bf16:.6g}, plain int8 vs bf16 {gap:.6g}; "
        f"decode {sec_k:.3f} s with kernels, {sec_p:.3f} s plain, bf16 "
        f"{sec_b:.3f} s")
    if not torch.isfinite(dec_k).all() or k11_n == 0 \
            or rel > INT8_DECODE_REL_L2 or not INT8_DECODE_REL_L2 < gap \
            or not rel < to_bf16:
        fail(f"int8 decode: kernels vs plain {rel} (limit "
             f"{INT8_DECODE_REL_L2}, which must sit below the int8-vs-bf16 "
             f"gap {gap}; kernels vs bf16 {to_bf16})")
    del dec_k, dec_p, dec_b
    lane("vae_int8", int8_vae, INT8_REQUESTS, ("K1", "K2", "K11"), "9")
    del int8_vae
    torch.cuda.empty_cache()

    args = cli.parse_arguments(["unused.npy", "--preset", "throughput",
                                "--vae_quant", "int8"])
    fast8 = cli.make_runner(device, seed=0, quant=args.quant,
                            tiling=cli.tiling_from_args(args),
                            vae_quant=args.vae_quant)
    lane("throughput_vae_int8", fast8, INT8_FAST_REQUESTS,
         ("K1", "K2", "K3", "K4", "K5", "K11"), "9")
    del fast8
    torch.cuda.empty_cache()

    os.environ["SEEDVR2_FUSED_NORM"] = "1"
    try:
        fused = cli.make_runner(device, seed=0)
    finally:
        del os.environ["SEEDVR2_FUSED_NORM"]
    if not fused.vae.lowering.fused_norm or base.vae.lowering.fused_norm:
        fail("SEEDVR2_FUSED_NORM=1 did not reach the VAE built under it")
    x_in = samples[0][None]
    z = (latent.float() / VAE_V3.scaling_factor + VAE_V3.shifting_factor)[None]
    vae32 = VideoVAE(copy.deepcopy(base.vae.model).float(), torch.float32)
    reset_counts(wrappers)
    k12_shapes = {}  # (C, T, H, W) -> [encode, decode] launches
    k12_call, stage = fn.norm_silu_head_ncdhw, [0]

    def k12_recorded(x, *args, **kwargs):
        k12_shapes.setdefault(tuple(x.shape[1:]), [0, 0])[stage[0]] += 1
        return k12_call(x, *args, **kwargs)

    fn.norm_silu_head_ncdhw = k12_recorded
    try:
        with torch.no_grad():
            outs = {"fused": (fused.vae.encode(x_in),)}
            k12_n = fn.norm_silu_head.launches
            stage[0] = 1
            outs["fused"] += (fused.vae.decode(z.to(torch.bfloat16)),)
            k12_d = fn.norm_silu_head.launches - k12_n
    finally:
        fn.norm_silu_head_ncdhw = k12_call
    with torch.no_grad():
        outs["unfused"] = (base.vae.encode(x_in),
                           base.vae.decode(z.to(torch.bfloat16)))
        outs["fp32"] = (vae32.encode(x_in.float()), vae32.decode(z))
    del vae32
    bad = k12_n == 0 or k12_d == 0
    for i, what in enumerate(("encode", "decode")):
        f, u, t32 = (outs[k][i] for k in ("fused", "unfused", "fp32"))
        rel, err_f, err_u = rel_l2(f, u), rel_l2(f, t32), rel_l2(u, t32)
        say(f"fused-norm VAE {what}, 720p clip, same weights: relative L2 to "
            f"the unfused bf16 path {rel:.6g} (bound {FUSED_VAE_REL_L2}); to "
            f"the fp32 VAE {err_f:.6g} fused, {err_u:.6g} unfused (bound "
            f"{FUSED_FP32_RATIO}x the unfused)")
        bad |= rel > FUSED_VAE_REL_L2 or err_f > FUSED_FP32_RATIO * err_u
    say(f"K12 launches: encode {k12_n}, decode {k12_d}")
    k12_request_sum(recs["K12"], k12_shapes)
    if bad:
        fail("fused-norm VAE: K12 not launched by encode and decode, or "
             "beyond the limits above")
    del outs, x_in, z, samples, base, encode
    torch.cuda.empty_cache()
    lane("fused_norm", fused, FUSED_REQUESTS, ("K1", "K2", "K12"), "9")
    del fused
    torch.cuda.empty_cache()

    # 10. the VAE's lowering switches, each set alone, against the default
    check_vae_lowerings(torch, np, cli, pipeline, VideoVAE, VAE_V3, device,
                        embeds, clip)
    phase_done("10 (VAE lowering switches)")

    # 10b. the legacy VAE family at full width, beside the 3B DiT
    counts.update(legacy_vae_lanes(torch, np, cli, VideoVAE, VAE_V3, device,
                                   embeds, make_frames, wrappers, fn, ic))
    phase_done("10b (legacy VAE)")

    # 10c. --vae_*_tile_size auto: memory probes on the card
    auto_tile_phase(torch, np, cli, device, embeds, make_frames)
    phase_done("10c (auto tiles)")

    # 11. the 7B family at full width, with no 3B model left on the card
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated(device) / 2 ** 30
    say(f"device memory held before the 7B phase: {held:.3f} GiB")
    if held > 1.0:
        big = sorted((o.numel() * o.element_size(), tuple(o.shape), o.dtype)
                     for o in gc.get_objects() if torch.is_tensor(o)
                     and o.is_cuda)[-8:]
        fail(f"a 3B model is still on the card before the 7B phase; the "
             f"largest device tensors alive: {big}")
    recs_7b = check_7b_kernels(torch, fa, gather, im, fq, qm, nadit, device)
    torch.cuda.empty_cache()
    phase_done("11a (kernels at 7B shapes)")
    run_7b(torch, np, cli, nadit, im, qm, gguf, native, device, txt, tt,
           embeds, dit_inputs, dit_runs, lane, counts, phase_done, wrappers)

    # 13. the trainer: K1's and K2's backward, two ranks at fsdp 2, the full
    # 3B's train steps
    gc.collect()
    torch.cuda.empty_cache()
    recs.update(train_phase(torch, np, nadit, fa, gather, device, here,
                            counts, embeds, wrappers, recs["K1"]["ms"]))
    phase_done("13 (trainer)")

    # 12. records and the contract line
    kernels = []
    for key, (name, source, replaces) in KERNELS.items():
        by_path = {path: c[key] for path, c in counts.items() if key in c}
        extra = {"7b": recs_7b[key]} if key in recs_7b else {}
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            design=DESIGN[key],
            launches=by_path[MAIN_PATH[key]], launches_by_path=by_path,
            **{k: v for k, v in recs[key].items() if k != "launches"},
            **extra))
    say(json.dumps({"kernels": kernels}))
    say(card_line())
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
