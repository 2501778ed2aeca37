#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
GPU, from the root of a checkout:

    python3 chip_smoke.py

1. Prints the card's name and power limit, builds the CUDA kernels from
   ``src/repro_torch/csrc`` with nvcc (one per source, in parallel) and
   prints the build time.
2. Holds each kernel against its plain PyTorch version on the card, at the
   shapes of the main paths and at odd ones: flash_decode and
   rowstream_matmul with the tolerances of tests/test_kernels.py, rwkv_scan
   at its test shapes, with extreme decay and with rwkv6's own decays,
   ragged lengths, bf16 inputs and rwkv6-3b's full width; rwkv_scan_bwd
   (the scan's gradient) at the same cases and one full-width layer at the
   training shape (4 x 128, H 40), with and without a gradient of the
   final state, to the forward's tolerance, to identical bits from two
   calls and to one device kernel of its own per call. rowstream_matmul
   is also held, at the decode path's shapes, to a norm-wise bound per
   slice of 256 columns, to identical bits from two calls, and to one
   device kernel and one allocation (the output) per call. The path
   shapes include whisper-small's and llama-3.2-vision's products (the
   tied head (768, 51968) among them) and flash_decode's cross-attention
   over 1500 frames and 1601 vision tokens (neither a whole number of
   4 KB rows). flash_decode's partial entry (one shard of a cache split
   by sequence, with its softmax statistics) on every flash_decode case:
   out bit for bit the whole entry's, m and l against the plain version;
   each case cut into 2, 4 and 8 contiguous shards (some empty, ring
   buffers among them), the shards' partials merged against the unsplit
   kernel, and a planted fault (two shards' m swapped) that must fail.
3. Drives the main paths at full width in bf16 with random weights from a
   seed, each with the launch counters set to 0 just before it and read
   just after, each model freed before the next:
   * qwen2-7b served through ``repro_torch.launch.serve`` with the
     driver's defaults (12 requests, 4 slots, prompt 16, 24 new tokens,
     max_seq 128): every step goes through flash_decode and
     rowstream_matmul. One decode step's logits are held against the same
     step on the plain path, which also serves the same requests, to count
     the greedy tokens that agree. Then ``forward`` on 4 x 1024 prompt
     tokens (plain torch ops: no kernel launches), and the first 64 tokens
     of each prompt stepped through ``decode_step`` against forward's
     logits: reported in bf16, held in fp32 (weights from the same seed,
     an fp32 KV cache) within 0.15. Then qwen2-7b on meshes: served on a
     1x1 mesh (a one-rank NCCL group, parameters placed as the serve
     driver places them) with the meshless run's tokens and launches, and
     meshless again; then two ranks spawned on the one card over gloo
     (1x2: each rank half of every weight split over ``model``, its half
     of the KV cache's slots), fed 8 tokens of the meshless run's greedy
     steps in fp32 at full width cut to 4 layers and in bf16 whole, the
     gathered logits held at 0.15 against the meshless run's, then
     serving the driver's requests (the greedy tokens that differ are
     counted; its step time is that of two ranks sharing one card).
   * granite-moe-3b served as qwen2-7b (32 flash_decode and 161
     rowstream_matmul launches a step: attention, router and head
     products; the expert products are torch.einsum); each layer of one
     step held against the plain path on the same input in bf16, and the
     whole step in fp32, with the (token, layer) routing decisions that
     differ between the paths printed with their gate-probability gaps;
     then ``forward`` on 4 x 1024 tokens.
   * zamba2-1.2b (38 Mamba2 blocks, one shared attention + SwiGLU block
     after every sixth; the full run cuts it to FULL_RUN_ZAMBA_LAYERS
     blocks, a line says so, `--only zamba2` runs all 38) served as
     qwen2-7b: 119 rowstream_matmul launches a step at full depth (in_proj
     and out_proj of each block, seven per application of the shared
     block, the head) and 6 flash_decode (the shared block's attention);
     the greedy tokens against the plain path's; each Mamba2
     block and the shared block at each depth held against the plain path
     on the same input in bf16; ``forward`` on 4 x 1024 tokens (plain
     torch ops, the SSD recurrence token by token as in the reference);
     in fp32 one step against the plain path and 64 tokens through
     ``decode_step`` against ``forward``. Then the row-paged KV cache
     (``serve/kv_cache.py``) on the card: 4 interleaved sequences of 4096
     tokens of one qwen2-7b layer written token by token, each gathered
     bit for bit against a CPU copy and attended by flash_decode against
     its plain version.
   * whisper-small, whole, and llama-3.2-vision-90b at full width with
     its depth cut to 2 pattern units (8 self-attention and 2
     cross-attention layers, 21.3 GB; the whole 100 layers do not fit one
     card; a line says so), each with its biases and LayerNorms (whisper)
     or tanh gates (mllama) set from the seed: served as qwen2-7b (97
     rowstream_matmul and 24 flash_decode launches a whisper step, 67 and
     10 an mllama step; the cross KV stays zero, as the reference driver
     leaves it), the greedy tokens against the plain path's; each layer
     of one step, the cross KV precomputed from the stub frames or vision
     embeddings, held against the plain path in bf16; whisper's encoder
     on 4 x 1500 frames; ``forward`` on 4 x 448 decoder tokens with those
     frames, or 4 x 1024 tokens with 4 x 1601 vision embeddings; in fp32,
     64 tokens through ``decode_step`` (cross KV filled, fp32 cache)
     against ``forward``.
   * rwkv6-3b trained through ``repro_torch.launch.train`` at full width
     and depth in bf16 on its default 1x1 mesh (parameters and AdamW
     moments as DTensors under the family's specs) with the reference
     driver's defaults (seq 128, global batch 8, 2 microbatches, lr 1e-3)
     for 10 steps: finite losses, 128 rwkv_scan launches a step (32
     layers x 2 microbatches, each layer's forward twice with remat) and
     64 rwkv_scan_bwd; ms per step, tokens/s, peak memory and the step's
     bound. Then the checkpoint check at full width cut to 4 layers
     (steps 0-4 with an async save of step 4 into a temporary directory,
     then a second run that restores it and runs steps 5-9, its launches
     counted; both runs' losses must be those of an uninterrupted 10-step
     run bit for bit): the bytes of the save on disk, the seconds it
     blocked the loop and took to write, the host copy's bytes and the
     restore's seconds, each line with the card's name and power limit.
     Then one step's fp32 loss and grads at full width cut to 4 layers,
     kernel path against plain path, per leaf norm-wise.
   * rwkv6-3b trained tensor-parallel: two ranks spawned on the one card
     over gloo (a 1x2 mesh; NCCL puts no two ranks on one device), each
     computing on its model shards through the driver's step (20 of the
     40 heads a rank through rwkv_scan and rwkv_scan_bwd): one fp32 step
     at full width cut to 4 layers against the single-process step (the
     loss at 1e-5 relative, each gradient leaf norm-wise), and the same
     for qwen2-7b cut to 2 layers (the dense family), then 3 bf16
     steps at full width and depth, the launch counters set to 0 just
     before each step and read just after (the 1x1 step's counts on each
     rank), the heads of every scan launch, the parameter bytes each
     forward saw, peak memory and step time. The recorded 20-head
     launches are held against the plain versions and timed, and the
     ranks' launches joined along the heads (the single-process launches
     of the same layers) timed beside them.
   * The MoE family and rwkv6-3b on model shards: granite-moe-3b (full
     width and depth), phi3.5-moe-42b at full width cut to 8 of its 32
     layers (21.3 GB in bf16; the whole model does not fit one card; a
     line says so) and rwkv6-3b, each served without a mesh (granite also
     on a 1x1 mesh: the meshless tokens at the meshless launches), then
     two ranks spawned on the one card over gloo: 8 fed steps at 4 slots
     on 1x2 (20 of 40 experts, 8 of 16, 20 of 40 heads a rank) in fp32 at
     a cut depth, held at 0.15 against the meshless run, and in bf16
     (reported), the ranks' routing decisions compared (they must agree)
     and those that differ from the meshless run counted, then the bf16
     model serving the driver's requests on 1x2 (`--only moe_tp`; the
     full run leaves the serves out); phi3.5-moe also on 2x1 in fp32 at
     2 layers over 32 steps (its routing groups spanning both ranks'
     rows), its dropped assignments a step equal to the meshless run's;
     then granite-moe-3b's train step on 1x2, fp32 at 4 layers against
     the single-process step and 3 bf16 steps (cut to 8 layers in the
     full run). rowstream_matmul and flash_decode_partial are timed at the
     shapes a rank launches, each beside the whole product or cache.
   * zamba2-1.2b on model shards: served without a mesh and on a 1x1 mesh
     (the meshless tokens at the meshless launches), then two ranks
     spawned on the one card over gloo (32 of its 64 SSM heads a rank,
     in_proj and the conv laid out by a rank's parts: its heads' z, x and
     dt and all of B and C, a (2048, 4256) in_proj a block; 64 of the 128
     slots of the shared block's KV cache): 8 fed steps at 4 slots on 1x2
     in fp32 cut to 6 blocks (one application of the shared block), held
     at 0.15 against the meshless run, each rank at the meshless step's
     launches; then the train step on 1x2 in fp32 at 6 blocks against the
     single-process step. `--only zamba2_tp` adds the bf16 fed steps at
     all 38 blocks (reported), the bf16 serve on 1x2 and 3 bf16 train
     steps at all 38, beside the same steps in one process (the first
     loss held at 1e-2 relative); the full run serves at
     FULL_RUN_ZAMBA_LAYERS blocks.
     rowstream_matmul is timed at a rank's products (in_proj by parts,
     out_proj, the shared block's halves, the head) beside the whole ones,
     and flash_decode_partial over a rank's 64 of 128 slots.
   * whisper-small and llama-3.2-vision on model shards: served without
     a mesh and on a 1x1 mesh (the meshless tokens at the meshless
     launches), then two ranks spawned on the one card over gloo, each on
     half of the heads, the products' columns or rows, the vocabulary and
     the self KV's slots, the cross KV filled from the stub input by
     precompute_cross_kv on the rank's shards: whisper's 1500 frames 750
     a rank through flash_decode_partial, mllama's 1601 vision tokens
     (which 2 does not divide) whole on both ranks; 8 fed steps at 4 slots
     in fp32 (whisper whole, mllama at 1 unit) held at 0.15 and 1e-4 of
     the largest logit against the meshless run, in bf16 reported, each
     rank at the meshless step's rowstream_matmul launches and the
     attention calls its slots hold. The full run takes mllama at 1
     pattern unit and leaves out the serves on 1x2 and the timings that
     `--only cross_tp` adds (mllama at 2 units, both bf16 serves on 1x2,
     rowstream_matmul at a rank's products beside the whole ones,
     flash_decode_partial over 750 of 1500 frames, flash_decode with SDPA
     over both whole cross KVs).
   * rwkv6-3b: (a) ``forward`` on 4 x 1024 prompt tokens, one rwkv_scan
     launch per layer, logits held against the plain path's; (b) the first
     64 tokens of those prompts stepped through ``decode_step``, held
     against forward's logits; (c) served with the driver's defaults,
     every weight product through rowstream_matmul.
4. Times each kernel, its plain version and, where there is one, one
   library call (a yardstick only; the port never calls it) over the
   kernel's launches of one decode step (flash_decode, rowstream_matmul),
   one forward (rwkv_scan) or one training microbatch (rwkv_scan_bwd, on
   the inputs the training run gave it): the kernel's wall time on the
   device's clock
   from CUDA events, then device times from torch.profiler, and profiled
   splits of each forward and of a decode step of each model (zamba2's
   by SSD scan, conv, shared attention and products; whisper's and
   mllama's steps by rowstream_matmul, self and cross flash_decode;
   whisper's forward by encoder, decoder self-attention, cross-attention
   and products; a training step by scan forward, scan backward, products,
   optimizer and other), the cross flash_decode launches of a step at their
   shapes, zamba2's, whisper's and mllama's products one line per shape;
   each
   profiled window must hold as many device kernels per call as a
   profiled single call, or the run fails. All host-clock and CUDA-event
   timings come before the first use of the profiler, so the qwen2-7b,
   granite and zamba2 weights are made again from the same seed for their
   profiled parts. Then
   flash_decode shows one device kernel and one allocation (the output)
   per call, and is timed at long context: 28 layers' caches of S 4096
   and 32768 slots, pos S - 1. Each profiled decode step must run one
   rowstream_matmul device kernel per launch.
5. Prints a ``{"kernels": [...]}`` line, then as the last line
   ``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --only flash_decode`` runs only that kernel's
phase: the card line, its build, its checks (long-context ones included),
the one-kernel-per-call check and its timings at the serve shape and at
S 4096 and 32768; it prints no ``ok`` line. ``--only rowstream_matmul``
likewise: its build, its checks, the one-kernel check, then one line per
distinct product shape of the qwen2-7b and rwkv6-3b decode steps (kernel,
torch.matmul and byte-bound time per launch, the plan's blocks, splits and
workspace) and each step's totals. ``--only rwkv_scan``: its build, its
checks, then the 32 launches of one rwkv6-3b forward at full width, each
on its own inputs synthesised from a seed with rwkv6's decays (wall and
device time, plain time, bound) and the kernel's plan. ``--only zamba2``
builds and checks all four kernels, then runs only zamba2's phases and
the paged pool, profiled parts included (no ``ok`` line); ``--only
whisper`` and ``--only mllama`` likewise run only that model's phases.
``--only rwkv_scan`` also checks rwkv_scan_bwd and times the 32
launches of one training microbatch on synthesised inputs. ``--only
train`` builds and checks rwkv_scan, forward and backward, then runs only
the training phases, profiled split and backward timings included (no
``ok`` line), its checkpoint check at full depth (30.7 GB a save).
``--only train_tp`` builds rwkv_scan and rwkv_scan_bwd and runs only the
tensor-parallel training phase and its kernel checks and timings (no
``ok`` line).
``--only mesh`` builds flash_decode and rowstream_matmul, checks both
(the partial entry and its merges included), serves qwen2-7b without a
mesh and on a 1x1 mesh, then runs the two ranks on the card (no ``ok``
line). The partial entry's per-launch times, at S 4096 and 32768 as one
shard and split over 2 and 4 ranks, come with flash_decode's own timings.
``--only moe_tp`` builds and checks the same two kernels, then runs only
the MoE / rwkv6 phase on model shards and its timings, its bf16 training
at all 32 layers (no ``ok`` line). ``--only zamba2_tp`` likewise runs
only zamba2's phase on model shards at full depth, its bf16 fed steps,
serve and training on 1x2 included, and its timings (no ``ok`` line).
``--only cross_tp`` likewise runs only whisper's and mllama's phase on
model shards and its timings (no ``ok`` line).
``--baseline`` runs either on a tree whose kernel predates its redesign
(copy this script into that tree's root): it leaves out the checks and
plan that the redesign added and times the old kernel's device kernels
(for rwkv_scan_bwd without the plain version, the same code on both
trees). For rwkv_scan it takes either device kernel name of the forward,
and checks and times the backward too where that tree has one.

Any failed check raises, so the script exits non-zero and prints no
result; so does a machine without a CUDA card, or a directory without the
repo's ``src/``. It imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import resource
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Published peaks of one H100 SXM (NVIDIA data sheet, dense, at 700 W).
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}
# Logits of one bf16 decode step, kernel path against plain path: the
# repo's bf16 decode tolerance (tests/test_models_smoke.py, decode against
# forward). The two paths round to bf16 at the same places and differ only
# in the order of fp32 sums.
LOGITS_ATOL = 0.15
# The fp32 cross families (whisper, mllama) beside it, relative to the
# largest logit: decode and forward differ only in the order of fp32 sums
# (a few 1e-6 of it on the H100), while whisper's logits are small enough
# (max about 2.5) that LOGITS_ATOL alone would pass a cross-attention that
# drops part of its KV.
CROSS_FP32_RTOL = 1e-4
SEED = 0
# Device kernels of each port kernel, by name (csrc/*.cu).
FD_KERNELS = ("flash_decode_simt", "flash_decode_mma")
RM_KERNELS = ("rowstream_tiles", "rowstream_scalar")
# rowstream_matmul's device kernels before the one-kernel design
# (`--baseline`).
BASELINE_RM_KERNELS = ("rowstream_kernel", "splitk_reduce")
RS_KERNELS = ("rwkv_scan_head",)
RS_BWD_KERNELS = ("rwkv_scan_bwd_head",)
# rwkv_scan's device kernel before the one-block-per-head design, and
# rwkv_scan_bwd's before its tiled design (`--baseline`).
BASELINE_RS_KERNELS = ("rwkv_scan_kernel",)
BASELINE_RS_BWD_KERNELS = ("rwkv_scan_bwd_head",)
# Products of one decode step, per layer (plus the head).
QWEN_PRODUCTS = [("attn", "wq"), ("attn", "wk"), ("attn", "wv"),
                 ("attn", "wo"), ("ffn", "w_gate"), ("ffn", "w_up"),
                 ("ffn", "w_down")]
RWKV_PRODUCTS = ["wr", "wk", "wv", "wg", "w_lora_a", "w_lora_b", "wo", "ck",
                 "cv", "cr"]
# rowstream_matmul's decode-path shapes at 4 slots: qwen2-7b's (wq and wo,
# wk and wv, w_gate and w_up, w_down, head), then rwkv6-3b's (wr wk wv wg
# wo cr, w_lora_a, w_lora_b, ck, cv, head), whisper-small's (the attention
# products, w_up, w_down, the tied head) and llama-3.2-vision's (wq and
# wo, wk and wv, w_gate and w_up, w_down, head).
RM_PATH = [(4, 3584, 3584), (4, 3584, 512), (4, 3584, 18944),
           (4, 18944, 3584), (4, 3584, 152064),
           (4, 2560, 2560), (4, 2560, 64), (4, 64, 2560), (4, 2560, 8960),
           (4, 8960, 2560), (4, 2560, 65536),
           (4, 768, 768), (4, 768, 3072), (4, 3072, 768), (4, 768, 51968),
           (4, 8192, 8192), (4, 8192, 1024), (4, 8192, 28672),
           (4, 28672, 8192), (4, 8192, 128256)]
# Norm-wise bound of rowstream_matmul against its plain version, per slice
# of RM_SLICE columns: ||out - ref|| / ||ref|| over the slice (all rows).
# Both round the same fp32 sum, taken in another order, to the output
# dtype; an output one bf16 ulp off is off by at most 2^-7 of itself, so
# 2^-7 holds unless some output is more than an ulp off. fp32: the repo's
# fp32 matmul tolerance (tests/test_kernels.py). A slice of 256 columns
# keeps a fault confined to one 4 KB column tile visible in a 152064-wide
# head: four rows of 2560 left out of a slice move it by (4 / 2560)^0.5 =
# 0.04, five times the bf16 bound.
RM_NORM_BOUND = {"bfloat16": 2.0 ** -7, "float32": 1e-5}
RM_SLICE = 256
# Defaults of launch/serve.py, and the prompt batch of each forward.
SLOTS, MAX_SEQ, N_REQ, PROMPT_LEN, MAX_NEW = 4, 128, 12, 16, 24
PREFILL_B, PREFILL_S, DECODE_T = 4, 1024, 64
# The training phase: rwkv6-3b through launch/train.py with the reference
# driver's defaults (seq 128, global batch 8, 2 microbatches, lr 1e-3) for
# TRAIN_STEPS steps, so that its closing loss line prints. The fp32 step
# check runs the full width at TRAIN_CHECK_LAYERS layers.
TRAIN_ARCH = "rwkv6-3b"
TRAIN_STEPS, TRAIN_SEQ, TRAIN_BATCH, TRAIN_MICRO = 10, 128, 8, 2
TRAIN_LR = 1e-3
TRAIN_CHECK_LAYERS = 4
# The checkpoint check: a run of the first TRAIN_CKPT_EVERY steps saves
# its last (``--ckpt-every TRAIN_CKPT_EVERY``, async, the reference's
# format, a temporary directory); a second run restores it and runs the
# remaining steps of TRAIN_STEPS, saving none (``--ckpt-every``
# RESUMED_CKPT_EVERY). Both runs' losses must be the uninterrupted run's
# bit for bit. One save only: a full-depth save is 30.7 GB (28.6 GiB),
# and the H100 host it was measured on ends a command once it has written
# 45 GiB to its disk, deleted files counted. `--only train` checks at
# full depth; the full script at full width cut to TRAIN_CHECK_LAYERS
# layers, since a full-depth save and restore take about 130 s at the
# 0.58 GB/s np.savez wrote there, more than its time limit leaves.
TRAIN_CKPT_EVERY = 5
RESUMED_CKPT_EVERY = 100
# One training step's fp32 loss and grads, kernel path against plain path,
# per leaf: ||kernel - plain|| <= TRAIN_GRAD_TOL ||plain||. Both paths sum
# in fp32 in other orders, and the forward kernel's state products carry
# 22 of fp32's 24 bits (3xTF32); a wrong backward is off by O(1).
TRAIN_GRAD_TOL = 1e-3
TRAIN_LOSS_RTOL = 1e-4
# Host ops whose kernels are the step's products, forward and backward
# (autograd's backward of torch.matmul runs aten::mm and aten::bmm).
TRAIN_PRODUCT_OPS = ("aten::matmul", "aten::mm", "aten::bmm", "aten::addmm")
# rwkv_scan_bwd launches per profiler window of the plain backward's
# timing: about 18000 kernels a window at the training shape.
PLAIN_BWD_GROUP = 4
# The full run times rwkv_scan_bwd (kernel, wall, plain and bound) over
# this many of a training microbatch's 32 launches: the plain backward's
# 4480 kernels a launch take about 3 s of profiling each. `--only train`
# and `--only rwkv_scan` time all 32.
FULL_RUN_BWD_LAUNCHES = 4
# `--only` choices that build and check every kernel, then run a model's
# phases.
MODEL_ONLY = (None, "zamba2", "whisper", "mllama")
GRANITE = "granite-moe-3b-a800m"
PHI = "phi3.5-moe-42b-a6.6b"
ZAMBA = "zamba2-1.2b"
WHISPER = "whisper-small"
MLLAMA = "llama-3.2-vision-90b"
# llama-3.2-vision-90b (100 layers, about 180 GB in bf16) does not fit one
# 80 GB card: it runs at full width with its depth cut to this many pattern
# units of 4 self-attention layers and 1 cross-attention layer.
MLLAMA_UNITS = 2
# The full run cuts zamba2-1.2b to this many Mamba2 blocks (one
# application of its shared block): its profiled forward, whose SSD scan
# runs token by token (as the reference's), took 250 s of a 1000 s run at
# all 38 on the H100, 76-96 s at 12. `--only zamba2` runs all 38.
FULL_RUN_ZAMBA_LAYERS = 6
# Stub inputs of the cross-attention families: frames and vision
# embeddings N(0, 1) from SEED + 14.
CROSS_SEED = SEED + 14
# rowstream_matmul launches per layer of a decode step: qwen2-7b's seven
# products, rwkv6-3b's ten, the MoE family's q, k, v, o and router (its
# expert products are torch.einsum, as in the reference), zamba2's in_proj and
# out_proj (plus seven for each application of its shared block: q, k, v,
# o and the three FFN products); plus one for the head.
RM_PER_LAYER = {"qwen2-7b": 7, "rwkv6-3b": 10, GRANITE: 5, PHI: 5,
                ZAMBA: 2}
# zamba2's shared block has a dense layer's seven products.
SHARED_PRODUCTS = QWEN_PRODUCTS
# The paged-pool phase: qwen2-7b's layer geometry (4 KV heads of 128 in
# bf16, 4 tokens per 4 KB row), pages of 16 rows, 4 sequences of 4096
# tokens appended in alternating chunks of POOL_CHUNK tokens, so that the
# sequences' pages interleave in the pool and chunks straddle pages.
POOL_KV, POOL_HD, POOL_HEADS, POOL_ROWS = 4, 128, 28, 16
POOL_SEQS, POOL_S, POOL_CHUNK = 4, 4096, 96
# Names of the torch.profiler ranges that `labelled` opens; left out of
# every device-kernel count and time, like the pads.
LABEL = "smoke::"
# flash_decode's timed cache lengths: the serve shape and long context.
FD_LENGTHS = (MAX_SEQ, 4096, 32768)
# Weight bytes a per-product timing round reads between two reads of one
# weight: twice the 50 MB L2, so every weight comes from device memory, as
# in a decode step. (On an H100 a round of two 80 MB copies of whisper's
# tied head read part of each from L2: 16.5 us a launch against a 23.95 us
# byte bound.)
REUSE_BYTES = 100 << 20
# Kernels that open every profiler window and are left out of its counts
# and times (see `profiled`): torch.cuda._sleep's.
PAD_LAUNCHES = 256
PAD_KERNEL = "spin_kernel"
PROFILE_TRIES = 3


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


class Laps:
    """Seconds of each phase of the full run, printed as it ends."""

    def __init__(self):
        self.t = time.perf_counter()

    def __call__(self, phase: str) -> None:
        now = time.perf_counter()
        print(f"[run] {phase}: {now - self.t:.1f} s", flush=True)
        self.t = now


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    return out.splitlines()[0]


def timed_ms(fn, reps: int) -> float:
    """Wall time of one call of `fn` on the device's clock: CUDA events
    around `reps` calls after one warm-up call. Where the host launches
    more slowly than the device runs, this includes the device's idle
    gaps; :func:`device_ms` does not."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


@contextlib.contextmanager
def profiled(cpu: bool = False):
    """torch.profiler over the body, opened by PAD_LAUNCHES tiny kernels
    and a synchronise; the pad kernels are left out of every count and
    time here. torch.profiler loses device records of a window, as a rule
    its first ones, more the older the process (about one more every
    8 s, idle or busy) and now and then many more
    (scripts/profiler_drops.py, PERF.md). The pads take the usual loss;
    :func:`profile_calls` and :func:`check_flash_launches` check their
    windows' counts and open a new window when records are missing. Only
    device activity is recorded unless `cpu` asks for host ops too (they
    cost host time on every launch and in key_averages)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]
                 + [ProfilerActivity.CPU] * cpu) as prof:
        for _ in range(PAD_LAUNCHES):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        yield prof
        torch.cuda.synchronize()


def _kernel_events(prof, pads=False) -> list:
    """The GPU kernels of a profile, by name: the pad kernels of
    :func:`profiled`, or (by default) every other. The device-side ranges
    of :func:`labelled` are not kernels."""
    import torch
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and (PAD_KERNEL in e.key) == pads
            and not e.key.startswith(LABEL)]


def _device_kernels(prof, names=None) -> tuple[float, int]:
    """Self device time (us) and count of the GPU kernels a profile
    recorded, all of them or those whose name contains one of `names`."""
    total, count = 0.0, 0
    for e in _kernel_events(prof):
        if names is None or any(n in e.key for n in names):
            total += e.self_device_time_total
            count += e.count
    return total, count


def _device_us(prof, names=None) -> float:
    return _device_kernels(prof, names)[0]


def pads_kept(prof) -> int:
    return sum(e.count for e in _kernel_events(prof, pads=True))


def profile_calls(fn, reps: int, cpu: bool = False):
    """torch.profiler's record of `reps` calls of `fn`, after a warm-up
    call and a profiled single call. The record must keep some of its
    pad kernels and hold `reps` times the single call's device kernels;
    else both windows are opened again, up to PROFILE_TRIES times, and
    then the run fails: a lost record never shortens a time."""
    fn()
    for _ in range(PROFILE_TRIES):
        with profiled(cpu) as one:
            fn()
        with profiled(cpu) as prof:
            for _ in range(reps):
                fn()
        n1, n = _device_kernels(one)[1], _device_kernels(prof)[1]
        if n1 > 0 and n == reps * n1 and pads_kept(one) and pads_kept(prof):
            return prof
        print(f"[profile] lost records: {n} device kernels over {reps} "
              f"calls, {n1} over one call, {pads_kept(prof)} and "
              f"{pads_kept(one)} of {PAD_LAUNCHES} pads kept; again")
    raise SmokeFailure(f"the profiler lost records in {PROFILE_TRIES} "
                       f"windows in a row")


def device_ms(fn, reps: int, names=None) -> float:
    """Device time of one call of `fn`: the kernels' own time from
    torch.profiler (CUPTI) over `reps` calls (:func:`profile_calls`), gaps
    between kernels left out. `names` picks kernels by name."""
    us = _device_us(profile_calls(fn, reps), names)
    check(us > 0, f"the profiler recorded no device time for {names}")
    return us / reps / 1e3


def bound(bytes_moved: float, ops: float, dtype: str,
          fp32_ops: float = 0.0) -> tuple[float, str]:
    """Least time (ms) of work moving `bytes_moved` bytes with `ops`
    operations in `dtype` and `fp32_ops` more in fp32 outside the tensor
    cores, and which of the two bounds it."""
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = (ops / PEAK_OPS_PER_S[dtype]
             + fp32_ops / PEAK_OPS_PER_S["float32"]) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@contextlib.contextmanager
def labelled(*targets):
    """Run each (module, function name) of `targets` inside a
    torch.profiler range named LABEL + name for the duration, so that
    :func:`op_split` can tell its kernels apart (a measurement only)."""
    from torch.profiler import record_function
    saved = [(mod, name, getattr(mod, name)) for mod, name in targets]
    for mod, name, fn in saved:
        def wrapper(*args, _fn=fn, _label=LABEL + name, **kwargs):
            with record_function(_label):
                return _fn(*args, **kwargs)
        setattr(mod, name, wrapper)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def op_split(prof, reps: int, kernel_parts: dict, label_parts: dict,
             products: bool, claims=(),
             product_ops=("aten::matmul",)) -> dict:
    """Device ms per call, by part, of a profile that recorded host ops
    (``profile_calls(..., cpu=True)``). The device kernels that a part of
    `kernel_parts` (part -> device kernel names) names go to that part,
    unless they run inside the device-side range of a labelled function
    named in `claims`: then to that function's part of `label_parts`
    (the port's kernels are launched through ctypes, outside any host op
    the profiler links them to; "<part> kernels" counts them). Each other
    kernel goes to the part of `label_parts` (name given to
    :func:`labelled` -> part) of the first name in `label_parts`' order
    whose range is around the host op that launched it; else, with
    `products`, to "products" if one of `product_ops` is the host op that
    launched it or one of its parents; else to
    "other", which also takes device time no host op claims. "device" is
    the total."""
    import torch
    cpu = torch.autograd.DeviceType.CPU
    named = {n: part for part, names in kernel_parts.items() for n in names}
    us = {part: _device_us(prof, names)
          for part, names in kernel_parts.items()}
    us.update({part: 0.0 for part in label_parts.values()})
    if products:
        us["products"] = 0.0
    for op in prof.events():
        if op.device_type != cpu or not op.kernels:
            continue
        chain, e = [], op
        while e is not None:
            chain.append(e.name)
            e = e.cpu_parent
        labels = {n[len(LABEL):] for n in chain if n.startswith(LABEL)}
        owner = next((part for n, part in label_parts.items()
                      if n in labels), None)
        if owner is None and products \
                and any(o in chain for o in product_ops):
            owner = "products"
        if owner is None:
            continue
        us[owner] += sum(k.duration for k in op.kernels
                         if not k.name.startswith(LABEL)
                         and PAD_KERNEL not in k.name
                         and not any(n in k.name for n in named))
    claimed = {}
    if claims:
        device = torch.autograd.DeviceType.CUDA
        events = [e for e in prof.events() if e.device_type == device]
        spans = [(label_parts[e.name[len(LABEL):]], e.time_range)
                 for e in events if e.name.startswith(LABEL)
                 and e.name[len(LABEL):] in claims]
        for e in events:
            part = next((p for n, p in named.items() if n in e.name), None)
            if part is None or e.name.startswith(LABEL):
                continue
            t = e.time_range
            owner = next((c for c, r in spans
                          if r.start <= t.start and t.end <= r.end), None)
            if owner is not None:
                us[part] -= t.elapsed_us()
                us[owner] += t.elapsed_us()
                claimed[owner] = claimed.get(owner, 0) + 1
    total = _device_us(prof)
    out = {part: t / reps / 1e3 for part, t in us.items()}
    out["other"] = (total - sum(us.values())) / reps / 1e3
    out["device"] = total / reps / 1e3
    if claims:
        out["claim ranges"] = len(spans) / reps
        out.update((f"{part} kernels", n / reps)
                   for part, n in claimed.items())
    return out


@contextlib.contextmanager
def recorded_routing(calls: list):
    """Append (gate probabilities, chosen experts) of every MoE layer's
    top-k to `calls` for the duration, in layer order."""
    from repro_torch.models import moe
    top_k = moe.top_k

    def record(probs, k):
        vals, idx = top_k(probs, k)
        calls.append((probs.float().reshape(-1, probs.shape[-1]).clone(),
                      idx.reshape(-1, k).clone()))
        return vals, idx

    moe.top_k = record
    try:
        yield
    finally:
        moe.top_k = top_k


def routing_flips(kernel_calls: list, plain_calls: list) -> list:
    """(layer, token, gap, shift) of each token that one MoE layer routes
    to another set of experts on the kernel path than on the plain path:
    gap is the plain path's k-th minus (k+1)-th largest gate probability,
    shift the largest change of any of the token's gate probabilities
    between the paths. A flip that rounding explains has gap <= 2 shift."""
    flips = []
    for layer, ((pk, ik), (pp, ip)) in enumerate(zip(kernel_calls,
                                                      plain_calls)):
        k = ik.shape[-1]
        differs = (ik.sort(-1).values != ip.sort(-1).values).any(-1)
        top = pp.sort(-1, descending=True).values
        for t in differs.nonzero().flatten().tolist():
            gap = (top[t, k - 1] - top[t, k]).item() if k < top.shape[-1] \
                else float("inf")
            flips.append((layer, t, gap, (pk[t] - pp[t]).abs().max().item()))
    return flips


def print_flips(what: str, flips: list, decisions: int) -> None:
    print(f"[routing] {what}: {len(flips)} of {decisions} (token, layer) "
          f"routing decisions differ between kernel and plain path"
          + "".join(f"; layer {layer} token {t}: gap between k-th and "
                    f"(k+1)-th gate probability {gap!r}, largest shift "
                    f"{shift!r}" for layer, t, gap, shift in flips))


@contextlib.contextmanager
def plain_path():
    """Route the model's products and attention to the plain versions for
    the duration (a comparison only; the port itself never does this).
    models/moe.py takes its router product from ``layers.matmul``, and
    models/zamba2.py every product of its decode step, so the patched
    ``layers.rowstream_matmul`` covers them too."""
    from repro_torch.kernels.flash_decode.ref import flash_decode_ref
    from repro_torch.kernels.rowstream_matmul.ref import rowstream_matmul_ref
    from repro_torch.kernels.rwkv_scan.ref import rwkv_scan_ref
    from repro_torch.models import layers, rwkv6
    saved = layers.flash_decode, layers.rowstream_matmul, rwkv6.rwkv_scan
    layers.flash_decode = flash_decode_ref
    layers.rowstream_matmul = rowstream_matmul_ref
    rwkv6.rwkv_scan = rwkv_scan_ref
    try:
        yield
    finally:
        layers.flash_decode, layers.rowstream_matmul, rwkv6.rwkv_scan = saved


# --- phase 2: kernels against their plain versions ---------------------------

def check_rowstream(torch, dev) -> float:
    """Returns the largest error at the decode path's shapes."""
    from repro_torch.kernels.rowstream_matmul.ops import rowstream_matmul
    from repro_torch.kernels.rowstream_matmul.ref import rowstream_matmul_ref
    gen = torch.Generator(device=dev).manual_seed(SEED)
    path = RM_PATH
    odd = [(m, k, n) for m in (1, 4, 33)
           for k, n in ((1000, 1000), (100, 37), (777, 4100), (64, 2056))]
    cases = [(s, "bfloat16") for s in path + odd] \
        + [(s, "float32") for s in path[:2] + path[5:7] + odd]
    worst_path = 0.0
    for (m, k, n), dt in cases:
        dtype = getattr(torch, dt)
        x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
        w = (torch.randn((k, n), generator=gen, device=dev)
             / math.sqrt(k)).to(dtype)
        out = rowstream_matmul(x, w)
        torch.cuda.synchronize()
        ref = rowstream_matmul_ref(x, w)
        tol = 2e-2 if dt == "bfloat16" else 1e-5
        err = (out.float() - ref.float()).abs()
        ok = bool((err <= tol * 8 + tol * ref.float().abs()).all())
        check(ok and out.dtype == dtype and out.shape == (m, n),
              f"rowstream_matmul {dt} ({m},{k})@({k},{n}): max err "
              f"{err.max().item()}")
        if (m, k, n) in path and dt == "bfloat16":
            worst_path = max(worst_path, err.max().item())
    print(f"[kernels] rowstream_matmul: {len(cases)} shapes agree with the "
          f"plain version (bf16 rtol 2e-2 atol 0.16, fp32 rtol 1e-5 atol "
          f"8e-5); max abs err at the path's shapes {worst_path!r}")
    return worst_path


def rowstream_inputs(torch, gen, m, k, n, dtype):
    """x (m, k) N(0, 1) and w (k, n) N(0, 1 / k) in `dtype`, so outputs
    are about unit size."""
    dev = gen.device
    x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
    w = (torch.randn((k, n), generator=gen, device=dev)
         / math.sqrt(k)).to(dtype)
    return x, w


def slice_norm_error(torch, out, ref) -> float:
    """Largest ||out - ref|| / ||ref|| over slices of RM_SLICE columns (all
    rows of each)."""
    import torch.nn.functional as F
    d = out.float() - ref.float()
    r = ref.float()
    pad = -r.shape[1] % RM_SLICE
    d, r = (F.pad(t, (0, pad)).view(t.shape[0], -1, RM_SLICE)
            for t in (d, r))
    return (d.square().sum((0, 2)).sqrt()
            / r.square().sum((0, 2)).sqrt()).max().item()


def check_rowstream_norms(torch, dev) -> dict:
    """At the decode path's shapes (bf16, and fp32 at four of them):
    RM_NORM_BOUND per slice against the plain version, and identical bits
    from two calls. Returns the largest norm-wise error by dtype."""
    from repro_torch.kernels.rowstream_matmul.ops import rowstream_matmul
    from repro_torch.kernels.rowstream_matmul.ref import rowstream_matmul_ref
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    cases = [(s, "bfloat16") for s in RM_PATH] \
        + [(s, "float32") for s in RM_PATH[:2] + RM_PATH[5:7]]
    worst = {"bfloat16": 0.0, "float32": 0.0}
    for (m, k, n), dt in cases:
        x, w = rowstream_inputs(torch, gen, m, k, n, getattr(torch, dt))
        out = rowstream_matmul(x, w)
        again = rowstream_matmul(x, w)
        torch.cuda.synchronize()
        err = slice_norm_error(torch, out, rowstream_matmul_ref(x, w))
        check(err <= RM_NORM_BOUND[dt],
              f"rowstream_matmul {dt} ({m},{k})@({k},{n}): norm-wise error "
              f"{err} per {RM_SLICE} columns (bound {RM_NORM_BOUND[dt]})")
        check(torch.equal(out, again),
              f"rowstream_matmul {dt} ({m},{k})@({k},{n}): two calls differ")
        worst[dt] = max(worst[dt], err)
    print(f"[kernels] rowstream_matmul: {len(cases)} path shapes within the "
          f"norm-wise bound per {RM_SLICE} columns (bf16 2^-7, fp32 1e-5; "
          f"largest {worst!r}); two calls give identical bits")
    return worst


def check_rowstream_launches(torch, dev) -> None:
    """One device kernel per rowstream_matmul call and no allocation but
    the output: 28 calls at qwen2-7b's wq shape, whose plan sums its K
    split over clusters and the workspace."""
    from repro_torch.kernels.rowstream_matmul import kernel
    from repro_torch.kernels.rowstream_matmul.ops import rowstream_matmul
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    x, w = rowstream_inputs(torch, gen, *RM_PATH[0], torch.bfloat16)
    p = kernel.plan_for(x, w)
    check(p.groups > 1 and 0 < p.ws_floats * 4 * kernel.WS_SHARE
          <= w.numel() * w.element_size(),
          f"rowstream_matmul plan at {RM_PATH[0]}: {p}")
    outs = [rowstream_matmul(x, w)]
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        before = torch.cuda.memory_stats()["allocation.all.allocated"]
        with profiled() as prof:
            outs += [rowstream_matmul(x, w) for _ in range(28)]
        allocs = (torch.cuda.memory_stats()["allocation.all.allocated"]
                  - before)
        kernels = {e.key: e.count for e in _kernel_events(prof)}
        if sum(kernels.values()) >= 28 and pads_kept(prof):
            break
        print(f"[profile] lost records: {kernels}, {pads_kept(prof)} of "
              f"{PAD_LAUNCHES} pads kept; again")
    check(sum(kernels.values()) == 28 and allocs == 28 and pads_kept(prof)
          and all(any(n in k for n in RM_KERNELS) for k in kernels),
          f"rowstream_matmul: 28 calls launched device kernels {kernels} "
          f"and made {allocs} allocations (expected 28 kernels, 28 outputs)")
    print(f"[kernels] rowstream_matmul: 28 calls at {RM_PATH[0]} ran device "
          f"kernels {kernels} and allocated {allocs} tensors (the outputs); "
          f"plan: {p.blocks} blocks, clusters of {p.cluster}, {p.groups} "
          f"per tile, workspace {p.ws_floats * 4} bytes")


def flash_cases() -> list:
    """flash_decode's cases (b, h, hkv, S, d, pos, q dtype, kv dtype,
    [offset of the caches in elements]); the first FD_PATH_CASES are the
    serve paths' shapes: qwen2-7b's (also granite's), whisper-small's and
    llama-3.2-vision's self-attention at 128 slots, and their
    cross-attention over all 1500 frames (46.875 4 KB rows a head) and
    1601 vision tokens (100 rows and one token)."""
    cases = [(4, 28, 4, 128, 128, p, "bfloat16", "bfloat16")
             for p in (0, 63, 127)]
    cases += [(4, 12, 12, 128, 64, 127, "bfloat16", "bfloat16"),
              (4, 64, 8, 128, 128, 127, "bfloat16", "bfloat16"),
              (4, 64, 8, 1601, 128, 1600, "bfloat16", "bfloat16"),
              (4, 12, 12, 1500, 64, 1499, "bfloat16", "bfloat16")]
    # g * d = 4096, the widest group the wrapper takes: over 48 KB of
    # shared memory, which the kernel opts into.
    cases += [(1, 32, 2, 300, 256, 150, qt, kt) for qt, kt in
              (("bfloat16", "bfloat16"), ("float32", "float32"))]
    for g in (1, 7, 8):
        for d in (64, 80, 128):
            for S, pos in ((200, 0), (200, 99), (200, 199), (200, 450),
                           (4096, 2047), (4096, 4095)):
                for qt, kt in (("bfloat16", "bfloat16"),
                               ("float32", "bfloat16"),
                               ("float32", "float32")):
                    cases.append((2, 2 * g, 2, S, d, pos, qt, kt))
    # qwen2-7b's heads at long context: the whole 32768-slot cache, and a
    # prefix of it; pos 100 ends off a 4 KB row and takes fewer than 8
    # splits.
    for qt in ("bfloat16", "float32"):
        cases += [(4, 28, 4, 32768, 128, p, qt, "bfloat16")
                  for p in (32767, 20000)]
        cases.append((4, 28, 4, 4096, 128, 100, qt, "bfloat16"))
    # The element-load path: head dims that are not a multiple of 8, and
    # caches one element off 16-byte alignment (the last field).
    cases += [(2, 6, 2, 300, d, 250, qt, kt) for d in (100, 36)
              for qt, kt in (("bfloat16", "bfloat16"),
                             ("float32", "bfloat16"),
                             ("float32", "float32"))]
    cases += [(4, 28, 4, 1000, 128, 999, "bfloat16", "bfloat16", 1),
              (2, 14, 2, 500, 64, 300, "float32", "float32", 1)]
    return cases


FD_PATH_CASES = 7


def flash_inputs(torch, gen, case) -> tuple:
    """q, k_cache, v_cache and pos of a case of :func:`flash_cases`,
    N(0, 1) on the generator's device."""
    b, h, hkv, S, d, pos, qt, kt, *shift = case
    dev = gen.device
    q = torch.randn((b, h, d), generator=gen, device=dev).to(
        getattr(torch, qt))
    n = b * hkv * S * d + sum(shift)
    kc, vc = (torch.randn(n, generator=gen, device=dev).to(
                  getattr(torch, kt))[sum(shift):].view(b, hkv, S, d)
              for _ in range(2))
    return q, kc, vc, pos


def flash_verdict(torch, out, ref) -> tuple[bool, bool, float, float]:
    """(elementwise, scaled, max err, max |ref|) of flash_decode's output
    against its plain version. Elementwise: |err| <= tol + tol |ref|, tol
    3e-2 for bf16 q (bf16 output) and 1e-5 for fp32 q. Scaled, for bf16
    q: max |err| <= 3e-2 max |ref|. With N(0, 1) inputs the output
    shrinks as n^-1/2 (about 0.01 at 32768 valid slots), below the 3e-2
    floor, so only the scaled check fails a kernel that leaves out one
    chunk or one tile of each (scripts/flash_decode_latency.py plants
    both)."""
    bf16 = out.dtype == torch.bfloat16
    tol = 3e-2 if bf16 else 1e-5
    err = (out.float() - ref.float()).abs()
    scale = ref.float().abs().max().item()
    elementwise = bool((err <= tol + tol * ref.float().abs()).all())
    scaled = not bf16 or err.max().item() <= tol * scale
    return elementwise, scaled, err.max().item(), scale


def check_flash_decode(torch, dev) -> float:
    from repro_torch.kernels.flash_decode.ops import flash_decode
    from repro_torch.kernels.flash_decode.ref import flash_decode_ref
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    cases = flash_cases()
    worst_path = 0.0
    for i, case in enumerate(cases):
        q, kc, vc, pos = flash_inputs(torch, gen, case)
        out = flash_decode(q, kc, vc, pos)
        torch.cuda.synchronize()
        ref = flash_decode_ref(q, kc, vc, pos)
        elementwise, scaled, err, scale = flash_verdict(torch, out, ref)
        check(elementwise and scaled and out.dtype == q.dtype
              and out.shape == q.shape,
              f"flash_decode case {case}: max err {err} (max |ref| "
              f"{scale})")
        if i < FD_PATH_CASES:
            worst_path = max(worst_path, err)
    # Slots after pos must not leak, whatever they hold.
    q = torch.randn((4, 28, 128), generator=gen, device=dev)
    kc, vc = (torch.randn((4, 4, 128, 128), generator=gen, device=dev)
              for _ in range(2))
    out1 = flash_decode(q, kc, vc, 10)
    kc[:, :, 11:] = 1e9
    vc[:, :, 11:] = -1e9
    out2 = flash_decode(q, kc, vc, 10)
    check(torch.allclose(out1, out2, rtol=1e-6, atol=0),
          "flash_decode: slots after pos leak into the output")
    # pos 100 ends off a 4 KB row (16 tokens at d 128 bf16): row-aligned
    # chunks, fewer than 8 of them.
    from repro_torch.kernels.flash_decode import kernel
    chunk, nsplit = kernel.plan(101, 16, 128, 2, 132)
    check(nsplit < 8 and chunk % 16 == 0,
          f"flash_decode plan for 101 tokens: chunk {chunk}, {nsplit} splits")
    print(f"[kernels] flash_decode: {len(cases) + 2} cases agree with the "
          f"plain version (bf16 rtol/atol 3e-2 and max err <= 3e-2 max "
          f"|ref|, fp32 1e-5), future slots masked; max abs err at the "
          f"path's shape {worst_path!r}")
    return worst_path


def check_flash_launches(torch, dev) -> None:
    """One device kernel per flash_decode call and no allocation but the
    output: 28 calls at the serve shape, counted by the profiler and the
    allocator."""
    from repro_torch.kernels.flash_decode.ops import flash_decode
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    q = torch.randn((4, 28, 128), generator=gen, device=dev).to(
        torch.bfloat16)
    kc, vc = (torch.randn((4, 4, MAX_SEQ, 128), generator=gen,
                          device=dev).to(torch.bfloat16) for _ in range(2))
    outs = [flash_decode(q, kc, vc, MAX_SEQ - 1)]
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        before = torch.cuda.memory_stats()["allocation.all.allocated"]
        with profiled() as prof:
            outs += [flash_decode(q, kc, vc, MAX_SEQ - 1) for _ in range(28)]
        allocs = (torch.cuda.memory_stats()["allocation.all.allocated"]
                  - before)
        kernels = {e.key: e.count for e in _kernel_events(prof)}
        # A lost record can only lower the count: open a new window then.
        if sum(kernels.values()) >= 28 and pads_kept(prof):
            break
        print(f"[profile] lost records: {kernels}, {pads_kept(prof)} of "
              f"{PAD_LAUNCHES} pads kept; again")
    check(sum(kernels.values()) == 28 and allocs == 28 and pads_kept(prof)
          and all(any(n in k for n in FD_KERNELS) for k in kernels),
          f"flash_decode: 28 calls launched device kernels {kernels} and "
          f"made {allocs} allocations (expected 28 kernels, 28 outputs)")
    print(f"[kernels] flash_decode: 28 calls at the serve shape ran device "
          f"kernels {kernels} and allocated {allocs} tensors (the outputs)")


# The partial flash_decode (one shard of a cache split by sequence): its
# statistics against the plain version's, m within FD_M_RTOL of max(1, |m|)
# and l within FD_L_RTOL of l by q's dtype. The tensor-core path rounds each
# probability to bf16 before it enters the product with V and the sum alike
# (csrc/flash_decode.cu), so l is off by at most 2^-9 of itself there;
# 2^-8 leaves a margin and still fails a probability left out of 256.
FD_M_RTOL = 1e-5
FD_L_RTOL = {"float32": 1e-5, "bfloat16": 2.0 ** -8}
# Shard counts of the merge checks: each case whose S they divide is cut
# into that many contiguous copies, as the ranks of a model axis hold it.
FD_SHARDS = (2, 4, 8)


def shard_parts(flash_partial, q, kc, vc, n_valid: int, n: int) -> list:
    """(out, m, l) of each of `n` contiguous copies of the caches' slots,
    shard r valid for the slots of 0..n_valid-1 it holds (a model axis's
    rank r: ``layers.cached_attention_update``)."""
    S_loc = kc.shape[2] // n
    return [flash_partial(q, kc[:, :, r * S_loc:(r + 1) * S_loc].contiguous(),
                          vc[:, :, r * S_loc:(r + 1) * S_loc].contiguous(),
                          min(max(n_valid - r * S_loc, 0), S_loc))
            for r in range(n)]


def check_flash_partial(torch, dev) -> dict:
    """flash_decode_partial on every case of :func:`flash_cases` (their
    inputs drawn as :func:`check_flash_decode` draws them): its output
    against its plain version at flash_decode's tolerances and equal bit
    for bit to the whole-cache entry's, its statistics at FD_M_RTOL and
    FD_L_RTOL. Then each case cut into 2, 4 and 8 shards where S divides:
    the shards' partials on the kernel, merged by ``merge_partials``,
    against the unsplit kernel at flash_decode's tolerances, shards with
    no valid slot and ring buffers (pos >= S) among them; and a planted
    fault, the first two non-empty shards' m swapped, which the same
    verdict must fail in every case where it is planted."""
    from repro_torch.kernels.flash_decode.ops import (flash_decode,
                                                      flash_decode_partial)
    from repro_torch.kernels.flash_decode.ref import (
        flash_decode_partial_ref, merge_partials)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    worst = {"out": 0.0, "m": 0.0, "l": 0.0, "merged": 0.0}
    merges = empty = planted = caught = 0
    cases = flash_cases()
    for case in cases:
        q, kc, vc, pos = flash_inputs(torch, gen, case)
        S = kc.shape[2]
        n_valid = min(pos + 1, S)
        out, m, l = flash_decode_partial(q, kc, vc, n_valid)
        whole = flash_decode(q, kc, vc, pos)
        ro, rm, rl = flash_decode_partial_ref(q, kc, vc, n_valid)
        elementwise, scaled, err, scale = flash_verdict(torch, out, ro)
        m_err = ((m - rm).abs() / rm.abs().clamp(min=1.0)).max().item()
        l_err = ((l - rl).abs() / rl).max().item()
        qt = str(q.dtype).split(".")[-1]
        check(elementwise and scaled and torch.equal(out, whole)
              and m.dtype == l.dtype == torch.float32
              and m_err <= FD_M_RTOL and l_err <= FD_L_RTOL[qt],
              f"flash_decode_partial case {case}: out err {err} (max |ref| "
              f"{scale}), equal to flash_decode {torch.equal(out, whole)}, "
              f"m err {m_err}, l err {l_err}")
        worst["out"] = max(worst["out"], err)
        worst["m"] = max(worst["m"], m_err)
        worst["l"] = max(worst["l"], l_err)
        for n in FD_SHARDS:
            if S % n:
                continue
            parts = shard_parts(flash_decode_partial, q, kc, vc, n_valid, n)
            outs, ms, ls = (list(x) for x in zip(*parts))
            merged = merge_partials(outs, ms, ls)
            elementwise, scaled, err, scale = flash_verdict(torch, merged,
                                                            whole)
            check(elementwise and scaled,
                  f"flash_decode_partial case {case} over {n} shards, "
                  f"merged: max err {err} against the unsplit kernel (max "
                  f"|out| {scale})")
            worst["merged"] = max(worst["merged"], err)
            merges += 1
            empty += sum(int(not x.any()) for x in ls)
            live = [r for r, x in enumerate(ls) if x.all()]
            if len(live) >= 2:
                a, b = live[:2]
                ms[a], ms[b] = ms[b], ms[a]
                bad = merge_partials(outs, ms, ls)
                planted += 1
                caught += not all(flash_verdict(torch, bad, whole)[:2])
    check(planted > 0 and caught == planted,
          f"flash_decode_partial: two shards' m swapped went unnoticed in "
          f"{planted - caught} of {planted} merges")
    print(f"[kernels] flash_decode_partial: {len(cases)} cases agree with "
          f"the plain version (out as flash_decode, bit for bit the whole "
          f"entry's; m within {FD_M_RTOL} relative, l within "
          f"{FD_L_RTOL}), worst out {worst['out']!r}, m {worst['m']!r}, l "
          f"{worst['l']!r}; {merges} merges over {FD_SHARDS} shards "
          f"({empty} shards empty) agree with the unsplit kernel, worst "
          f"{worst['merged']!r}; the planted fault (two shards' m "
          f"swapped) caught in {caught} of {planted}")
    return dict(worst, merges=merges, empty_shards=empty, planted=planted,
                caught=caught)


def scan_inputs(torch, gen, b, s, H, hd, dtype="float32", decay="test"):
    """r, k, v, w (b, s, H, hd) and u (H, hd) on the generator's device.
    decay "test": w in (0.4, 0.9) and u at 0.1, as tests/test_kernels.py
    draws them; "extreme": w 1e-35 at 40 % of the entries (0.9 elsewhere)
    and u zero; "model": w = exp(-exp(-5 + 0.5 n)), about 0.993 as rwkv6's
    init gives it, so the carried state dominates the output, and u zero."""
    dev = gen.device
    shape = (b, s, H, hd)
    r, k, v, n = (torch.randn(shape, generator=gen, device=dev)
                  for _ in range(4))
    u = torch.zeros((H, hd), device=dev)
    if decay == "extreme":
        w = torch.where(torch.rand(shape, generator=gen, device=dev) < 0.4,
                        1e-35, 0.9)
    elif decay == "model":
        w = torch.exp(-torch.exp(-5.0 + 0.5 * n))
    else:
        w = torch.sigmoid(n) * 0.5 + 0.4
        u = torch.randn((H, hd), generator=gen, device=dev) * 0.1
    return [x.to(getattr(torch, dtype)) for x in (r, k, v, w)] + [u]


def rwkv_scan_cases() -> list:
    """(shape, chunk, decay, dtype) of check_rwkv_scan:
    tests/test_kernels.py's three shapes and its extreme-decay case; the
    full width; ragged s at the model's head dim (the default chunk of 16
    does not divide them), with extreme and with the model's decays too;
    bf16 inputs."""
    full = (PREFILL_B, PREFILL_S, 40, 64)
    cases = [((2, 64, 3, 16), 16, "test", "float32"),
             ((1, 128, 2, 32), 32, "test", "float32"),
             ((2, 48, 4, 16), 8, "test", "float32"),
             ((1, 32, 2, 16), 8, "extreme", "float32"),
             (full, None, "test", "float32")]
    cases += [((2, s, 3, 64), None, "test", "float32") for s in (1, 6, 1000)]
    cases += [((2, 1000, 3, 64), None, "extreme", "float32"),
              ((2, 1000, 3, 64), None, "model", "float32"),
              ((2, 64, 3, 16), 16, "test", "bfloat16"),
              ((2, 1000, 3, 64), None, "test", "bfloat16"),
              (full, None, "test", "bfloat16")]
    return cases


def scan_verdict(torch, x, o, S, decay: str, dt: str) -> tuple:
    """(within tolerance, max err of o, of S) of one rwkv_scan result
    against its plain version on the same inputs."""
    from repro_torch.kernels.rwkv_scan.ref import rwkv_scan_ref
    ro, rS = rwkv_scan_ref(*x)
    finite = bool(o.isfinite().all()) and bool(S.isfinite().all())
    atol = 2e-3 if decay == "extreme" else 1e-3
    # o in bf16 rounds once from fp32 sums taken in another order:
    # tests/test_kernels.py's bf16 tolerance, 2e-2.
    o_tol = (2e-2, 2e-2) if dt == "bfloat16" else (1e-3, atol)
    err_o = (o.float() - ro.float()).abs()
    err_s = (S - rS).abs()
    ok = finite \
        and bool((err_o <= o_tol[1] + o_tol[0] * ro.float().abs()).all()) \
        and bool((err_s <= atol + 1e-3 * rS.abs()).all()) \
        and o.dtype == x[0].dtype and o.shape == x[0].shape \
        and S.dtype == torch.float32
    return ok, err_o.max().item(), err_s.max().item()


def check_rwkv_scan(torch, dev) -> float:
    """Returns the largest error at rwkv6-3b's full-width shape."""
    from repro_torch.kernels.rwkv_scan.ops import rwkv_scan
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    cases = rwkv_scan_cases()
    worst_full = 0.0
    for shape, chunk, decay, dt in cases:
        x = scan_inputs(torch, gen, *shape, dtype=dt, decay=decay)
        o, S = rwkv_scan(*x, chunk=chunk)
        torch.cuda.synchronize()
        ok, err_o, err_s = scan_verdict(torch, x, o, S, decay, dt)
        check(ok, f"rwkv_scan {shape} chunk {chunk} {dt} decay {decay}: "
                  f"max err o {err_o}, S {err_s}")
        if shape == cases[4][0] and dt == "float32":
            worst_full = max(err_o, err_s)
    print(f"[kernels] rwkv_scan: {len(cases)} cases agree with the plain "
          f"version (fp32 rtol/atol 1e-3, atol 2e-3 with decays of 1e-35, "
          f"all finite; decays near 0.993 as rwkv6's init gives them; bf16 "
          f"o 2e-2); max abs err at rwkv6-3b's full width {worst_full!r}")
    return worst_full


def train_scan_shape() -> tuple:
    """(b, s, H, hd) of each rwkv_scan launch of a training step: one
    microbatch of rwkv6-3b at the train driver's defaults."""
    return (TRAIN_BATCH // TRAIN_MICRO, TRAIN_SEQ, 40, 64)


def rwkv_scan_bwd_cases() -> list:
    """(shape, decay, dtype) of check_rwkv_scan_bwd: the forward's check
    cases (rwkv_scan_cases) and one full-width layer at the training
    shape, with rwkv6's own decays, in fp32 and bf16."""
    train = train_scan_shape()
    return [(shape, decay, dt) for shape, _, decay, dt in rwkv_scan_cases()] \
        + [(train, "model", "float32"), (train, "model", "bfloat16")]


def scan_bwd_verdict(torch, x, got, want, decay: str, dt: str) -> tuple:
    """(within tolerance, max err of each gradient) of one rwkv_scan_bwd
    result against its plain version on the same inputs: the forward's
    rule (scan_verdict). fp32 gradients within 1e-3 + 1e-3 |ref| (atol
    2e-3 with decays of 1e-35); bf16 ones, rounded once from fp32 sums
    taken in another order, within 2e-2 + 2e-2 |ref|. du is fp32 (u is)."""
    errs, ok = [], True
    for g, ref, inp in zip(got, want, x):
        atol = 2e-3 if decay == "extreme" else 1e-3
        tol = (2e-2, 2e-2) if g.dtype == torch.bfloat16 else (1e-3, atol)
        err = (g.float() - ref.float()).abs()
        errs.append(err.max().item())
        ok = ok and bool(g.isfinite().all()) and g.dtype == inp.dtype \
            and g.shape == inp.shape \
            and bool((err <= tol[1] + tol[0] * ref.float().abs()).all())
    return ok, errs


def check_rwkv_scan_bwd(torch, dev) -> float:
    """The backward kernel against rwkv_scan_bwd_ref on the card, half the
    cases with a gradient of the final state and half without; identical
    bits from two calls at the training shape. Returns the largest error
    at the training shape in fp32."""
    from repro_torch.kernels.rwkv_scan import kernel
    from repro_torch.kernels.rwkv_scan.ref import rwkv_scan_bwd_ref
    gen = torch.Generator(device=dev).manual_seed(SEED + 15)
    cases = rwkv_scan_bwd_cases()
    worst_train = 0.0
    for n, (shape, decay, dt) in enumerate(cases):
        b, s, H, hd = shape
        x = scan_inputs(torch, gen, *shape, dtype=dt, decay=decay)
        do = torch.randn(shape, generator=gen, device=dev).to(x[0].dtype)
        dS = torch.randn((b, H, hd, hd), generator=gen, device=dev) \
            if n % 2 == 0 else None
        got = kernel.rwkv_scan_bwd(*x, do, dS)
        torch.cuda.synchronize()
        want = rwkv_scan_bwd_ref(*x, do, dS)
        ok, errs = scan_bwd_verdict(torch, x, got, want, decay, dt)
        check(ok, f"rwkv_scan_bwd {shape} {dt} decay {decay} dS "
                  f"{dS is not None}: max err dr dk dv dw du {errs}")
        if shape == train_scan_shape():
            if dt == "float32":
                worst_train = max(errs)
            again = kernel.rwkv_scan_bwd(*x, do, dS)
            check(all(torch.equal(a, c) for a, c in zip(got, again)),
                  f"rwkv_scan_bwd {shape} {dt}: two calls differ")
        del got, want
    print(f"[kernels] rwkv_scan_bwd: {len(cases)} cases agree with the plain "
          f"backward (the forward's rule: fp32 rtol/atol 1e-3, atol 2e-3 "
          f"with decays of 1e-35; bf16 gradients 2e-2), with and without a "
          f"final-state gradient; identical bits from two calls at the "
          f"training shape {train_scan_shape()} in fp32 and bf16; max abs "
          f"err there (fp32) {worst_train!r}")
    return worst_train


def check_rwkv_scan_bwd_launches(torch, dev) -> dict:
    """One rwkv_scan_bwd device kernel per call: 8 calls at the training
    shape, counted by the profiler. The wrapper's other device kernels
    (the layout copies in and out and du's sum over b) are printed."""
    from repro_torch.kernels.rwkv_scan import kernel
    gen = torch.Generator(device=dev).manual_seed(SEED + 16)
    shape = train_scan_shape()
    x = scan_inputs(torch, gen, *shape, decay="model")
    do = torch.randn(shape, generator=gen, device=dev)
    outs = [kernel.rwkv_scan_bwd(*x, do, None)]
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with profiled() as prof:
            outs += [kernel.rwkv_scan_bwd(*x, do, None) for _ in range(8)]
        kernels = {e.key: e.count for e in _kernel_events(prof)}
        ours = sum(c for k, c in kernels.items()
                   if any(n in k for n in RS_BWD_KERNELS))
        if ours >= 8 and pads_kept(prof):
            break
        print(f"[profile] lost records: {kernels}, {pads_kept(prof)} of "
              f"{PAD_LAUNCHES} pads kept; again")
    check(ours == 8 and pads_kept(prof),
          f"rwkv_scan_bwd: 8 calls ran device kernels {kernels} (expected "
          f"8 of {RS_BWD_KERNELS})")
    print(f"[kernels] rwkv_scan_bwd: 8 calls at {shape} ran {ours} "
          f"{RS_BWD_KERNELS[0]} device kernels, one per call; all device "
          f"kernels of the calls (the wrapper's layout copies and du's sum "
          f"included): {kernels}")
    return kernels


# --- timing over one decode step's launches ----------------------------------

def rowstream_work(torch, ws: list, slots: int) -> dict:
    """The products of one decode step on weights `ws`, in step order,
    each layer's own weights (so every weight is cold in L2, as in the
    step): on the kernel, on the plain version and on torch.matmul."""
    from repro_torch.kernels.rowstream_matmul.ops import rowstream_matmul
    from repro_torch.kernels.rowstream_matmul.ref import rowstream_matmul_ref
    dev = ws[0].device
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    xs = {k: torch.randn((slots, k), generator=gen, device=dev).to(
        torch.bfloat16) for k in {w.shape[0] for w in ws}}
    pairs = [(xs[w.shape[0]], w) for w in ws]

    def run(fn):
        return lambda: [fn(x, w) for x, w in pairs]

    nbytes = sum(2 * (x.numel() + w.numel() + x.shape[0] * w.shape[1])
                 for x, w in pairs)
    ops = sum(2 * x.shape[0] * w.numel() for x, w in pairs)
    bound_ms, bound_by = bound(nbytes, ops, "bfloat16")
    return {"launches_per_step": len(pairs), "names": RM_KERNELS,
            "reps": 5, "bytes": nbytes, "kernel": run(rowstream_matmul),
            "plain": run(rowstream_matmul_ref), "library": run(torch.matmul),
            "bound_ms": bound_ms, "bound_by": bound_by}


def qwen_weights(cfg, params) -> list:
    """qwen2-7b's 197 decode products: 7 per layer and the head."""
    blocks = params["blocks"]
    return [blocks[a][w][i] for i in range(cfg.n_layers)
            for a, w in QWEN_PRODUCTS] + [params["lm_head"]]


def rwkv_weights(cfg, params) -> list:
    """rwkv6-3b's 321 decode products: 10 per layer and the head."""
    blocks = params["blocks"]
    return [blocks[w][i] for i in range(cfg.n_layers)
            for w in RWKV_PRODUCTS] + [params["lm_head"]]


def granite_weights(cfg, params) -> list:
    """granite-moe-3b's 161 decode products: q, k, v, o and the router
    per layer, and the head (the expert products are torch.einsum)."""
    blocks = params["blocks"]
    return [blocks[a][w][i] for i in range(cfg.n_layers)
            for a, w in QWEN_PRODUCTS[:4] + [("moe", "router")]] \
        + [params["lm_head"]]


def zamba_weights(cfg, params) -> list:
    """zamba2-1.2b's 119 decode products in step order: in_proj and
    out_proj of each Mamba2 block, the shared block's seven after every
    k-th block (the same tensors at each application), and the head."""
    from repro_torch.models import zamba2
    k, n_shared = zamba2._pattern(cfg)
    blocks, sp = params["blocks"], params["shared"]
    out = []
    for i in range(cfg.n_layers):
        out += [blocks["in_proj"][i], blocks["out_proj"][i]]
        if i < n_shared * k and (i + 1) % k == 0:
            out += [sp[a][w] for a, w in SHARED_PRODUCTS]
    return out + [params["lm_head"]]


def rwkv_scan_ops(b: int, s: int, H: int, hd: int, C: int) -> float:
    """Operations of the chunked scan at chunk C (an exp counts as one):
    per chunk of each (b, h), the strictly lower C x C matrix (sub, exp,
    two multiply-adds per channel), its diagonal, the logs, cumsum and
    decays, A v, the state term r S, and the state update."""
    per_chunk = (C * (C - 1) // 2 * hd * 4 + C * hd * 2 + C * hd * 6
                 + C * (C + 1) // 2 * hd * 2 + C * hd * hd * 2
                 + hd * hd * (1 + 2 * C))
    return b * H * -(-s // C) * per_chunk


def scan_work(torch, launches: list) -> dict:
    """The rwkv_scan launches of one rwkv6-3b forward, on the inputs the
    forward gave them: on the kernel and on the plain version. No single
    PyTorch call computes this recurrence, so there is no library time."""
    from repro_torch.kernels.rwkv_scan.kernel import default_chunk
    from repro_torch.kernels.rwkv_scan.ops import rwkv_scan
    from repro_torch.kernels.rwkv_scan.ref import rwkv_scan_ref

    def run(fn):
        return lambda: [fn(*x) for x in launches]

    nbytes, ops = 0, 0
    for r, k, v, w, u in launches:
        b, s, H, hd = r.shape
        nbytes += sum(t.numel() * t.element_size() for t in (r, k, v, w, u))
        nbytes += r.numel() * r.element_size() + b * H * hd * hd * 4
        ops += rwkv_scan_ops(b, s, H, hd, default_chunk(hd))
    bound_ms, bound_by = bound(nbytes, ops, "float32")
    return {"launches_per_step": len(launches), "names": RS_KERNELS,
            "reps": 3, "plain_reps": 1, "kernel": run(rwkv_scan),
            "plain": run(rwkv_scan_ref), "library": None,
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
            "ops": ops}


def rwkv_scan_bwd_ops(b: int, s: int, H: int, hd: int) -> float:
    """Operations of the scan's backward, as the plain backward counts
    them: per token and head, one forward state update (the states the
    gradients read) and the five hd x hd products of the walk back (dr,
    dk, dv, dw and the G update), a multiply-add each: 12 hd^2."""
    return 12.0 * hd * hd * b * s * H


def scan_bwd_work(torch, launches: list) -> dict:
    """rwkv_scan_bwd launches, each on its own (r, k, v, w, u, do, dS):
    on the kernel wrapper and on the plain backward. Bytes: each input
    read once, each gradient written once (the kernel's checkpoint scratch
    is its own traffic, not the function's). No single PyTorch call
    computes this gradient, so there is no library time. The plain
    backward runs 4480 kernels a launch at the training shape; its device
    time is taken over all the launches in profiler windows of
    PLAIN_BWD_GROUP launches each (``plain_one``), since windows of 10^5
    kernels lose records (PERF.md)."""
    from repro_torch.kernels.rwkv_scan import kernel
    from repro_torch.kernels.rwkv_scan.ref import rwkv_scan_bwd_ref

    def run(fn):
        return lambda: [fn(*x) for x in launches]

    nbytes, ops = 0, 0
    for x in launches:
        r, u = x[0], x[4]
        b, s, H, hd = r.shape
        nbytes += sum(t.numel() * t.element_size() for t in x
                      if t is not None)
        nbytes += 4 * r.numel() * r.element_size() + u.numel() * 4
        ops += rwkv_scan_bwd_ops(b, s, H, hd)
    bound_ms, bound_by = bound(nbytes, ops, "float32")
    return {"launches_per_step": len(launches), "names": RS_BWD_KERNELS,
            "reps": 3, "kernel": run(kernel.rwkv_scan_bwd), "plain": None,
            "plain_one": lambda i: [rwkv_scan_bwd_ref(*x) for x in launches[
                i * PLAIN_BWD_GROUP:(i + 1) * PLAIN_BWD_GROUP]],
            "plain_windows": -(-len(launches) // PLAIN_BWD_GROUP),
            "library": None,
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
            "ops": ops}


def flash_work(torch, cfg, slots: int, S: int, kernel=None) -> dict:
    """One launch per layer of `cfg` (its n_layers, heads and head dim),
    each on its own bf16 cache of S slots (28
    distinct caches for qwen2-7b: 0.94 GB at S 4096 and 7.5 GB at S 32768,
    so no length but the serve shape's fits in the 50 MB L2), with every
    slot valid (pos = S - 1): on the kernel, on the plain version and on
    scaled_dot_product_attention. SDPA takes the grouped heads itself
    (enable_gqa=True) where a probe on layer 0 shows that it accepts them
    and agrees with the plain version; else it runs on layer 0's cache with
    the KV heads expanded beforehand, reused for every layer. `kernel`
    stands in for the port's flash_decode where it is given."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_decode.ops import flash_decode
    from repro_torch.kernels.flash_decode.ref import flash_decode_ref
    dev = torch.device("cuda")
    L, h, hkv, d = cfg.n_layers, cfg.n_heads, cfg.n_kv_heads, \
        cfg.resolved_head_dim
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    q = torch.randn((L, slots, h, d), generator=gen, device=dev).to(
        torch.bfloat16)
    kc, vc = (torch.empty((L, slots, hkv, S, d), dtype=torch.bfloat16,
                          device=dev) for _ in range(2))
    for c in (kc, vc):
        for i in range(L):
            c[i] = torch.randn(c.shape[1:], generator=gen, device=dev)
    pos = S - 1
    g = h // hkv
    q4 = q[:, :, :, None, :]

    def run(fn):
        return lambda: [fn(q[i], kc[i], vc[i], pos) for i in range(L)]

    ref0 = flash_decode_ref(q[0], kc[0], vc[0], pos).float()
    try:
        out0 = F.scaled_dot_product_attention(q4[0], kc[0], vc[0],
                                              enable_gqa=True)
        gqa = bool(((out0[:, :, 0].float() - ref0).abs()
                    <= 3e-2 + 3e-2 * ref0.abs()).all())
    except (TypeError, RuntimeError):
        gqa = False
    if gqa:
        how = "scaled_dot_product_attention(enable_gqa=True), own caches"

        def library():
            return [F.scaled_dot_product_attention(
                q4[i], kc[i], vc[i], enable_gqa=True) for i in range(L)]
    else:
        how = ("scaled_dot_product_attention on layer 0's cache with the "
               "KV heads expanded beforehand, reused for every layer")
        kx = kc[0].repeat_interleave(g, dim=1)
        vx = vc[0].repeat_interleave(g, dim=1)

        def library():
            return [F.scaled_dot_product_attention(q4[i], kx, vx)
                    for i in range(L)]

    n_valid = pos + 1
    nbytes = L * 2 * (2 * slots * h * d + 2 * slots * hkv * n_valid * d)
    ops = L * 4 * slots * h * n_valid * d
    bound_ms, bound_by = bound(nbytes, ops, "bfloat16")
    reps = 20 if S <= 4096 else 5
    return {"launches_per_step": L, "names": FD_KERNELS, "reps": reps,
            "plain_reps": max(1, reps // 4), "S": S, "pos": pos,
            "library_how": how, "kernel": run(kernel or flash_decode),
            "plain": run(flash_decode_ref), "library": library,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "per": f"{L} {cfg.name} layers' caches at {slots} slots, S {S}, "
                   f"pos {pos}"}


def flash_timings(torch, cfg, lengths=FD_LENGTHS) -> dict:
    """flash_decode, its plain version and the library call at each cache
    length, each work timed and freed before the next is made."""
    out = {}
    for S in lengths:
        w = flash_work(torch, cfg, SLOTS, S)
        time_works({f"flash_decode S {S}": w})
        n = w["launches_per_step"]
        print(f"[time] flash_decode S {S}: per launch kernel "
              f"{w['ms'] / n!r} ms, plain {w['plain_ms'] / n!r} ms, library "
              f"{w['library_ms'] / n!r} ms ({w['library_how']}), bound "
              f"{w['bound_ms'] / n!r} ms; kernel at "
              f"{w['bound_ms'] / w['ms']!r} of its bound")
        out[f"S{S}"] = numbers(w)
        del w
        torch.cuda.empty_cache()
    return out


def flash_phase(lengths=FD_LENGTHS) -> dict:
    """The one-kernel-per-call check, then flash_decode's timings at each
    cache length, then the partial entry's at the long lengths."""
    import torch
    from repro_torch.configs.registry_configs import ALL_ARCHS
    check_flash_launches(torch, torch.device("cuda"))
    cfg = ALL_ARCHS["qwen2-7b"]
    out = flash_timings(torch, cfg, lengths)
    out["partial"] = partial_timings(torch, cfg)
    return out


def partial_timings(torch, cfg, lengths=FD_LENGTHS[1:],
                    shards=(1, 2, 4)) -> dict:
    """flash_decode_partial per launch over `cfg`'s layers' caches at
    each length S, as one shard of S slots and as one rank's shard of S / n
    slots for n in `shards` (every slot valid): device time from the
    profiler (its pads and checks, as the other timings), against the
    byte bound of the shard."""
    from repro_torch.kernels.flash_decode.ops import flash_decode_partial

    def partial(q, kc, vc, pos):
        return flash_decode_partial(q, kc, vc, pos + 1)

    out = {}
    for S in lengths:
        for n in shards:
            w = flash_work(torch, cfg, SLOTS, S // n, kernel=partial)
            L = w["launches_per_step"]
            ms = device_ms(w["kernel"], w["reps"], FD_KERNELS) / L
            bound_ms = w["bound_ms"] / L
            out[f"S{S}/{n}"] = {"ms": ms, "bound_ms": bound_ms,
                                "slots": S // n}
            print(f"[time] flash_decode_partial S {S} over {n} rank(s): "
                  f"{S // n} slots a shard, per launch {ms!r} ms, bound "
                  f"{bound_ms!r} ms (bytes); at {bound_ms / ms!r} of its "
                  f"bound")
            del w
            torch.cuda.empty_cache()
    return out


def rowstream_products(torch, shapes, baseline=False) -> list:
    """Per launch at each (k, n) of `shapes`, x of SLOTS rows, bf16: device
    time of the kernel and of torch.matmul over distinct weights of the
    shape (REUSE_BYTES or more read between two reads of one weight, so
    each comes cold from device memory), the byte bound and, unless
    `baseline`, the plan."""
    from repro_torch.kernels.rowstream_matmul import kernel
    from repro_torch.kernels.rowstream_matmul.ops import rowstream_matmul
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    rows = []
    for k, n in shapes:
        copies = 1 if 2 * k * n >= REUSE_BYTES \
            else 1 + -(-REUSE_BYTES // (2 * k * n))
        x, w = rowstream_inputs(torch, gen, SLOTS, k, n, torch.bfloat16)
        ws = [w] + [rowstream_inputs(torch, gen, 1, k, n, torch.bfloat16)[1]
                    for _ in range(copies - 1)]
        ms = device_ms(lambda: [rowstream_matmul(x, w) for w in ws], 3,
                       RM_KERNELS) / copies
        lib = device_ms(lambda: [torch.matmul(x, w) for w in ws], 3) / copies
        b, _ = bound(2 * (SLOTS * k + k * n + SLOTS * n), 2 * SLOTS * k * n,
                     "bfloat16")
        row = {"shape": [SLOTS, k, n], "us": ms * 1e3,
               "library_us": lib * 1e3, "bound_us": b * 1e3}
        text = ""
        if not baseline:
            p = kernel.plan_for(x, w)
            row.update(blocks=p.blocks, cluster=p.cluster,
                       splits=[p.cluster * g for _, _, g in p.classes],
                       ws_bytes=p.ws_floats * 4,
                       device_kernel=RM_KERNELS[p.vec == 1])
            text = (f"; device kernel {row['device_kernel']}, {p.blocks} "
                    f"blocks in clusters of {p.cluster}, "
                    f"splits per tile {row['splits']}, workspace "
                    f"{row['ws_bytes']} bytes")
        print(f"[product] ({SLOTS}, {k}) @ ({k}, {n}) bf16: kernel "
              f"{row['us']!r} us, torch.matmul {row['library_us']!r} us, "
              f"bound {row['bound_us']!r} us (kernel at "
              f"{row['bound_us'] / row['us']!r} of it){text}")
        rows.append(row)
        del ws, w
    torch.cuda.empty_cache()
    return rows


def scan_phase(baseline=False) -> dict:
    """rwkv_scan alone: the launches of one rwkv6-3b forward at full width
    (b PREFILL_B x s PREFILL_S, fp32, one per layer), each on its own
    inputs, synthesised from a seed with rwkv6's own decays
    (``scan_inputs(..., decay="model")``): kernel wall and device time,
    plain time and bound, and the kernel's plan. A `baseline` run leaves
    out the plan and the plain version, which is the same code on both
    trees and takes minutes under the profiler (about 260,000 kernels per
    forward)."""
    import torch
    from repro_torch.configs.registry_configs import ALL_ARCHS
    from repro_torch.models.rwkv6 import HEAD_DIM, n_heads
    cfg = ALL_ARCHS["rwkv6-3b"]
    H = n_heads(cfg)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    launches = [tuple(scan_inputs(torch, gen, PREFILL_B, PREFILL_S, H,
                                  HEAD_DIM, decay="model"))
                for _ in range(cfg.n_layers)]
    work = scan_work(torch, launches)
    if baseline:
        work["plain"] = None
    work["per"] = (f"one rwkv6-3b forward at b {PREFILL_B} x s {PREFILL_S}, "
                   f"inputs synthesised with rwkv6's decays")
    time_works({"rwkv_scan": work})
    out = numbers(work)
    n = work["launches_per_step"]
    plain_ms = None if baseline else work["plain_ms"] / n
    print(f"[time] rwkv_scan per launch: kernel {work['ms'] / n!r} ms (wall "
          f"{work['wall_ms'] / n!r}), plain {plain_ms!r} ms, "
          f"bound {work['bound_ms'] / n!r} ms; kernel at "
          f"{work['bound_ms'] / work['ms']!r} of its bound")
    if not baseline:
        from repro_torch.kernels.rwkv_scan import kernel
        p = kernel.plan(PREFILL_B, H, PREFILL_S,
                        kernel.default_chunk(HEAD_DIM), 4)
        out["plan"] = {"blocks": p.blocks, "tiles": p.tiles,
                       "smem": p.smem, "blocks_per_sm": p.blocks_per_sm}
        print(f"[plan] rwkv_scan: {p.blocks} blocks of {kernel.THREADS} "
              f"threads, {p.tiles} tiles each, {p.smem} bytes of shared "
              f"memory a block, {p.blocks_per_sm} blocks per SM")
    return out


def scan_bwd_phase(baseline=False) -> dict:
    """rwkv_scan_bwd alone: the 32 launches of one microbatch of an
    rwkv6-3b training step (b 4 x s 128, fp32, no final-state gradient,
    as the model gives none), each on its own inputs synthesised from a
    seed with rwkv6's decays: kernel wall and device time, plain time
    (unless `baseline`) and bound."""
    import torch
    from repro_torch.configs.registry_configs import ALL_ARCHS
    cfg = ALL_ARCHS[TRAIN_ARCH]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 17)
    shape = train_scan_shape()
    launches = []
    for _ in range(cfg.n_layers):
        x = scan_inputs(torch, gen, *shape, decay="model")
        do = torch.randn(shape, generator=gen, device="cuda")
        launches.append((*x, do, None))
    work = scan_bwd_work(torch, launches)
    if baseline:
        del work["plain_one"]
    work["per"] = (f"one rwkv6-3b training microbatch at b {shape[0]} x s "
                   f"{shape[1]}, inputs synthesised with rwkv6's decays")
    time_works({"rwkv_scan_bwd": work})
    n = work["launches_per_step"]
    plain_ms = None if baseline else work["plain_ms"] / n
    print(f"[time] rwkv_scan_bwd per launch: kernel {work['ms'] / n!r} ms "
          f"(wall {work['wall_ms'] / n!r}), plain {plain_ms!r} "
          f"ms, bound {work['bound_ms'] / n!r} ms; kernel at "
          f"{work['bound_ms'] / work['ms']!r} of its bound")
    return numbers(work)


# --- training ----------------------------------------------------------------

def train_bound(cfg, params) -> dict:
    """The least time of one training step of `cfg` at the driver's
    defaults, from its work: the products (forward, the remat recompute of
    every layer, and the backward's two products per forward product) at
    bf16's 989 TFLOP/s, the scan's forward (twice: remat) and backward
    at fp32's 67 TFLOP/s, and the optimizer's bytes at 3.35 TB/s. The
    update reads every gradient, so it follows the backward: the bound is
    the sum of the two phases."""
    from repro_torch.models.rwkv6 import HEAD_DIM, n_heads
    from repro_torch.kernels.rwkv_scan.kernel import default_chunk
    tokens = TRAIN_BATCH * TRAIN_SEQ
    blocks = sum(params["blocks"][w].numel() for w in RWKV_PRODUCTS)
    head = params["lm_head"].numel()
    mm_ops = 2 * tokens * (blocks + head) * 3 + 2 * tokens * blocks
    b, s, H = TRAIN_BATCH // TRAIN_MICRO, TRAIN_SEQ, n_heads(cfg)
    scans = cfg.n_layers * TRAIN_MICRO
    scan_ops = scans * (2 * rwkv_scan_ops(b, s, H, HEAD_DIM,
                                          default_chunk(HEAD_DIM))
                        + rwkv_scan_bwd_ops(b, s, H, HEAD_DIM))
    n_params = sum(t.numel() for t in _tensors(params))
    # AdamW reads each fp32 gradient twice (the global norm, the update),
    # reads and writes both fp32 moments and the bf16 parameter: 28 bytes.
    opt_bytes = 28 * n_params
    compute_ms = (mm_ops / PEAK_OPS_PER_S["bfloat16"]
                  + scan_ops / PEAK_OPS_PER_S["float32"]) * 1e3
    opt_ms = opt_bytes / PEAK_BYTES_PER_S * 1e3
    return {"params": n_params, "product_ops": mm_ops, "scan_ops": scan_ops,
            "optimizer_bytes": opt_bytes, "compute_ms": compute_ms,
            "optimizer_ms": opt_ms, "bound_ms": compute_ms + opt_ms}


def train_counts(n_layers: int) -> dict:
    """Each kernel's launches in one training step of rwkv6-3b at
    `n_layers` layers: each layer's forward and its remat recompute, per
    microbatch, through rwkv_scan, and its backward through
    rwkv_scan_bwd."""
    return {"flash_decode": 0, "rowstream_matmul": 0,
            "rwkv_scan": 2 * n_layers * TRAIN_MICRO,
            "rwkv_scan_bwd": n_layers * TRAIN_MICRO}


def train_phase(torch, timed_launches: int | None = None,
                ckpt_layers: int | None = None) -> dict:
    """rwkv6-3b trained at full width and depth in bf16 through
    ``repro_torch.launch.train`` on its default 1x1 mesh with the
    reference driver's defaults for TRAIN_STEPS steps, random weights from
    SEED, the launch counters set to 0 just before and read just after:
    per step 2 x 32 x 2 rwkv_scan (each layer's forward and its remat
    recompute, per microbatch) and 32 x 2 rwkv_scan_bwd launches. The
    losses must be finite. Timed on the host clock (each step ends in
    reading its loss back). The inputs of the first `timed_launches`
    rwkv_scan_bwd launches (by default all 32 of step 0's first
    microbatch, left out of the median) are kept, and their CUDA-event
    wall time taken, for phase 4 (``bwd_work``).

    Then the checkpoint check (``resume_check``), at full depth against
    this run's losses, or with `ckpt_layers` at full width cut to that
    many layers."""
    from repro_torch.configs.registry_configs import ALL_ARCHS
    from repro_torch.kernels import launch_counters, reset_launch_counters
    from repro_torch.kernels.rwkv_scan import kernel
    from repro_torch.launch import train as port_train
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    full = ALL_ARCHS[TRAIN_ARCH]
    L = full.n_layers
    timed = timed_launches or L
    launches = []
    bwd = kernel.rwkv_scan_bwd

    def record(*args):
        if len(launches) < timed:
            launches.append(tuple(a.clone() if a is not None else None
                                  for a in args))
        return bwd(*args)

    reset_launch_counters()
    kernel.rwkv_scan_bwd = record
    t0 = time.perf_counter()
    try:
        run = port_train.train(TRAIN_ARCH, steps=TRAIN_STEPS,
                               seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                               microbatches=TRAIN_MICRO, lr=TRAIN_LR,
                               seed=SEED, device="cuda", mesh="1x1")
        torch.cuda.synchronize()
    finally:
        kernel.rwkv_scan_bwd = bwd
    total_s = time.perf_counter() - t0
    counts = {name: c.count for name, c in launch_counters().items()}
    per_step_counts = train_counts(L)
    check(counts == {n: k * TRAIN_STEPS for n, k in per_step_counts.items()},
          f"rwkv6-3b training: launches {counts} in {TRAIN_STEPS} steps, "
          f"expected {per_step_counts} per step")
    check(all(math.isfinite(x) for x in run.losses),
          f"rwkv6-3b training losses {run.losses}")
    check(tuple(run.mesh.shape) == (1, 1),
          f"rwkv6-3b training ran on a {tuple(run.mesh.shape)} mesh")
    step_ms = [x * 1e3 for x in run.step_s]
    warm = sorted(step_ms[1:])
    median = warm[len(warm) // 2]
    out = {"counts": counts, "per_step": per_step_counts,
           "losses": run.losses, "step_ms": step_ms,
           "median_step_ms": median, "first_step_ms": step_ms[0],
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (median / 1e3),
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "run_s": total_s, "bound": train_bound(run.cfg, run.state.params)}
    check(len(launches) == timed,
          f"recorded {len(launches)} rwkv_scan_bwd launches, expected "
          f"{timed}")
    losses = run.losses
    del run
    torch.cuda.empty_cache()
    if ckpt_layers is None:
        out["ckpt"] = resume_check(torch, full, losses)
    else:
        print(f"[depth] {TRAIN_ARCH} checkpoint check: {L} layers cut to "
              f"{ckpt_layers} at full width (the full-depth check runs "
              f"with --only train)")
        out["ckpt"] = resume_check(
            torch, dataclasses.replace(full, n_layers=ckpt_layers))
    torch.cuda.empty_cache()
    work = out["bwd_work"] = scan_bwd_work(torch, launches)
    work["per"] = (f"{'' if timed == L else f'{timed} of '}the {L} "
                   f"launches of one rwkv6-3b training microbatch at b "
                   f"{TRAIN_BATCH // TRAIN_MICRO} x s {TRAIN_SEQ}")
    work["wall_ms"] = timed_ms(work["kernel"], work["reps"])
    t1 = time.perf_counter()
    out["fp32"] = train_fp32_check(torch)
    print(f"[run] training: {TRAIN_STEPS} steps and the backward's wall "
          f"time {t1 - t0:.1f} s, the fp32 step check "
          f"{time.perf_counter() - t1:.1f} s")
    return out


def resume_check(torch, cfg, losses: list | None = None) -> dict:
    """The checkpoint check of rwkv6-3b at `cfg`'s depth, full width, bf16,
    the driver's defaults on its 1x1 mesh, from SEED, against the losses
    of an uninterrupted TRAIN_STEPS-step run (`losses`, or such a run
    made here): a run of the first TRAIN_CKPT_EVERY steps saves its last
    step (async) into a temporary directory; a second run restores it and
    runs the rest, saving none. Both runs' losses must be the
    uninterrupted run's bit for bit. The counters are set to 0 just before
    the second run and read just after. Reports the bytes of the save on
    disk, what the save blocked and took (``AsyncCheckpointer.saves``),
    the restore's seconds and the peak resident host memory."""
    from repro_torch.distributed import checkpoint as ckpt
    from repro_torch.kernels import launch_counters, reset_launch_counters
    from repro_torch.launch import train as port_train
    args = dict(seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                microbatches=TRAIN_MICRO, lr=TRAIN_LR, seed=SEED,
                device="cuda", mesh="1x1")
    if losses is None:
        losses = port_train.train(cfg, steps=TRAIN_STEPS, **args).losses
        torch.cuda.empty_cache()
    kept = TRAIN_CKPT_EVERY - 1
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        first = port_train.train(cfg, steps=TRAIN_CKPT_EVERY,
                                 ckpt_dir=ckpt_dir,
                                 ckpt_every=TRAIN_CKPT_EVERY,
                                 async_ckpt=True, **args)
        first_losses, saves = first.losses, first.saves
        del first
        torch.cuda.empty_cache()
        check(first_losses == losses[:kept + 1],
              f"checkpointed run's losses {first_losses} against the "
              f"uninterrupted run's {losses[:kept + 1]}")
        check([s["step"] for s in saves] == [kept]
              and ckpt.latest_step(ckpt_dir) == kept,
              f"saves {saves} in {ckpt_dir}")
        step_dir = os.path.join(ckpt_dir, f"step_{kept:06d}")
        disk_bytes = sum(os.path.getsize(os.path.join(step_dir, f))
                         for f in os.listdir(step_dir))
        n_steps = TRAIN_STEPS - kept - 1
        reset_launch_counters()
        t0 = time.perf_counter()
        resumed = port_train.train(cfg, steps=n_steps, ckpt_dir=ckpt_dir,
                                   ckpt_every=RESUMED_CKPT_EVERY,
                                   async_ckpt=True, **args)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = {name: c.count for name, c in launch_counters().items()}
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    per_step = train_counts(cfg.n_layers)
    check(resumed.start_step == kept + 1 and not resumed.saves,
          f"resumed at step {resumed.start_step} with saves "
          f"{resumed.saves}, expected step {kept + 1} and none")
    check(counts == {n: k * n_steps for n, k in per_step.items()},
          f"resumed training: launches {counts} in {n_steps} steps, "
          f"expected {per_step} per step")
    check(resumed.losses == losses[kept + 1:],
          f"resumed losses {resumed.losses} against the uninterrupted "
          f"run's {losses[kept + 1:]}")
    out = {"layers": cfg.n_layers, "disk_bytes": disk_bytes,
           "saves": saves, "restore_s": resumed.restore_s,
           "resumed_losses": resumed.losses, "counts": counts,
           "per_step": per_step, "run_s": run_s,
           "peak_host_rss_bytes": resource.getrusage(
               resource.RUSAGE_SELF).ru_maxrss * 1024}
    del resumed
    torch.cuda.empty_cache()
    return out


def print_ckpt(c: dict, card: str) -> None:
    s = c["saves"][0]
    kept = TRAIN_CKPT_EVERY - 1
    print(f"[ckpt] {TRAIN_ARCH} at {c['layers']} layers, full width: the "
          f"async save of step {s['step']} holds {c['disk_bytes']} bytes on "
          f"disk; it blocked the loop {s['block_s']!r} s (the host copy of "
          f"{s['host_bytes']} bytes {s['copy_s']!r} s) and wrote in "
          f"{s['write_s']!r} s; the restore took {c['restore_s']!r} s; "
          f"peak host RSS {c['peak_host_rss_bytes']} bytes; {card}")
    print(f"[ckpt] {TRAIN_ARCH} at {c['layers']} layers resumed from step "
          f"{kept}: steps {kept + 1}-{TRAIN_STEPS - 1} losses "
          f"{c['resumed_losses']!r} equal the uninterrupted run's bit for "
          f"bit; launches {c['counts']} ({c['per_step']} per step); "
          f"{c['run_s']!r} s with the restore; {card}")


def train_step_grads(torch, ad, params, batch) -> tuple:
    """(loss, fp32 grads in leaf order) of one training step: the train
    step's own per-microbatch loss and grads, with remat, summed in fp32
    and averaged as ``make_train_step`` does."""
    from repro_torch.train.train_step import _grads
    parts = {k: v.chunk(TRAIN_MICRO, 0) for k, v in batch.items()}
    acc, loss_sum = None, 0.0
    for i in range(TRAIN_MICRO):
        loss, grads = _grads(lambda p, b: ad.loss(p, b, remat=True), params,
                             {k: v[i] for k, v in parts.items()})
        loss_sum += float(loss)
        acc = [g.float() for g in grads] if acc is None \
            else [a.add_(g) for a, g in zip(acc, grads)]
    return loss_sum / TRAIN_MICRO, [a / TRAIN_MICRO for a in acc]


def train_fp32_check(torch) -> dict:
    """One training step's loss and grads of rwkv6-3b in fp32 at full
    width, its depth cut to TRAIN_CHECK_LAYERS layers, on the kernel path
    (rwkv_scan and rwkv_scan_bwd; the launch counters read) against the
    same step on the plain path, per leaf within TRAIN_GRAD_TOL
    norm-wise."""
    from repro_torch.configs.registry_configs import ALL_ARCHS
    from repro_torch.data.pipeline import make_pipeline
    from repro_torch.kernels import launch_counters, reset_launch_counters
    from repro_torch.models.registry import get_adapter
    full = ALL_ARCHS[TRAIN_ARCH]
    cfg = dataclasses.replace(full, dtype="float32",
                              n_layers=TRAIN_CHECK_LAYERS)
    print(f"[depth] {TRAIN_ARCH} fp32 training-step check: {full.n_layers} "
          f"layers cut to {cfg.n_layers} at full width (d_model "
          f"{cfg.d_model}, d_ff {cfg.d_ff}, vocab {cfg.vocab})")
    ad = get_adapter(cfg)
    params = ad.init(torch.Generator(device="cuda").manual_seed(SEED))
    batch = {k: torch.from_numpy(v).cuda() for k, v in make_pipeline(
        cfg.vocab, TRAIN_SEQ, TRAIN_BATCH, seed=SEED).batch_at(0).items()}
    reset_launch_counters()
    loss_k, grads_k = train_step_grads(torch, ad, params, batch)
    counts = {n: c.count for n, c in launch_counters().items()}
    check(counts["rwkv_scan"] == 2 * cfg.n_layers * TRAIN_MICRO
          and counts["rwkv_scan_bwd"] == cfg.n_layers * TRAIN_MICRO,
          f"fp32 training step launched {counts}")
    with plain_path():
        loss_p, grads_p = train_step_grads(torch, ad, params, batch)
    from repro_torch.train.optimizer import _leaves
    worst, worst_leaf = 0.0, ""
    for (path, _), gk, gp in zip(_leaves(params), grads_k, grads_p):
        err = ((gk - gp).norm() / gp.norm()).item()
        check(bool(gk.isfinite().all()) and err <= TRAIN_GRAD_TOL,
              f"fp32 training step: leaf {'/'.join(path)} kernel against "
              f"plain path ||diff|| / ||plain|| {err}")
        if err > worst:
            worst, worst_leaf = err, "/".join(path)
    loss_err = abs(loss_k - loss_p) / abs(loss_p)
    check(loss_err <= TRAIN_LOSS_RTOL,
          f"fp32 training step loss {loss_k} against plain {loss_p}")
    del params, grads_k, grads_p
    torch.cuda.empty_cache()
    return {"layers": cfg.n_layers, "loss": loss_k, "plain_loss": loss_p,
            "loss_rel_err": loss_err, "worst_leaf_err": worst,
            "worst_leaf": worst_leaf, "counts": counts}


def print_train(t: dict) -> None:
    b = t["bound"]
    f = t["fp32"]
    print(f"[train] {TRAIN_ARCH} bf16 full width and depth, {TRAIN_STEPS} "
          f"steps of {TRAIN_BATCH} x {TRAIN_SEQ} tokens in {TRAIN_MICRO} "
          f"microbatches: step median {t['median_step_ms']!r} ms (first "
          f"{t['first_step_ms']!r} ms), {t['tokens_per_s']!r} tokens/s, "
          f"peak memory {t['peak_bytes']} bytes; loss {t['losses'][0]!r} -> "
          f"{t['losses'][-1]!r}; launches {t['counts']} ({t['per_step']} "
          f"per step); {t['run_s']!r} s in all")
    print(f"[bound] {TRAIN_ARCH} training step: {b['params']} parameters; "
          f"products {b['product_ops']!r} operations and the scans' "
          f"{b['scan_ops']!r} fp32 operations, {b['compute_ms']!r} ms; the "
          f"optimizer's {b['optimizer_bytes']} bytes {b['optimizer_ms']!r} "
          f"ms; bound {b['bound_ms']!r} ms; bound / median step "
          f"{b['bound_ms'] / t['median_step_ms']!r}")
    print(f"[train] {TRAIN_ARCH} fp32 at {f['layers']} layers, one step on "
          f"the kernel path against the plain path: loss {f['loss']!r} "
          f"against {f['plain_loss']!r} (rel err {f['loss_rel_err']!r}, "
          f"tolerance {TRAIN_LOSS_RTOL}); largest per-leaf ||kernel - "
          f"plain|| / ||plain|| {f['worst_leaf_err']!r} ({f['worst_leaf']}, "
          f"tolerance {TRAIN_GRAD_TOL}); launches {f['counts']}")


def train_profiled(torch, t: dict) -> dict:
    """A profiled training step of rwkv6-3b (bf16, full width, from SEED,
    the driver's step), split by part: the scan's forward and backward
    kernels, the products (forward and backward), the optimizer (every
    kernel under ``adamw_update``) and the rest, with the device-idle
    share of the median step's host time `host_ms`. Then the device times
    of ``t["bwd_work"]`` (taken out of `t`): the 32 rwkv_scan_bwd launches
    of one training microbatch, on the kernel and the plain backward."""
    from repro_torch.data.pipeline import make_pipeline
    from repro_torch.launch import train as port_train
    from repro_torch.launch.mesh import process_group_scope
    from repro_torch.train import train_step as ts_mod
    with process_group_scope():
        cfg, ad, mesh, step, tp = port_train.build(
            TRAIN_ARCH, False, TRAIN_MICRO, TRAIN_LR, (1, 1), "cuda")
        state = [port_train.init_state(ad, mesh, tp, SEED, "cuda")]
        batch = {k: torch.from_numpy(v).cuda() for k, v in make_pipeline(
            cfg.vocab, TRAIN_SEQ, TRAIN_BATCH, seed=SEED).batch_at(0).items()}

        def one():
            state[0], metrics = step(state[0], batch)
            return float(metrics["loss"])

        t0 = time.perf_counter()
        with labelled((ts_mod, "adamw_update")):
            prof = profile_calls(one, 1, cpu=True)
        t1 = time.perf_counter()
        split = op_split(prof, 1, {"scan forward": RS_KERNELS,
                                   "scan backward": RS_BWD_KERNELS},
                         {"adamw_update": "optimizer"}, products=True,
                         product_ops=TRAIN_PRODUCT_OPS)
    check(all(t > 0 for t in split.values()),
          f"training step: a part took no device time: {split}")
    print_split(f"{TRAIN_ARCH} training step", split, t["median_step_ms"])
    del state, prof
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    work = t.pop("bwd_work")
    time_works({"rwkv_scan_bwd": work})
    print(f"[run] training profiled: 3 steps {t1 - t0:.1f} s, their split "
          f"{t2 - t1:.1f} s, the backward's device times "
          f"{time.perf_counter() - t2:.1f} s")
    return {"split": split, "rwkv_scan_bwd": numbers(work)}


def rowstream_phase(baseline=False) -> dict:
    """rowstream_matmul alone: unless `baseline`, the one-kernel-per-call
    check; then for qwen2-7b and rwkv6-3b at full width, the launches of
    one decode step on the model's own weights (kernel, plain version and
    torch.matmul) and one line per distinct product shape."""
    import torch
    from repro_torch.configs.registry_configs import ALL_ARCHS
    if not baseline:
        check_rowstream_launches(torch, torch.device("cuda"))
    out = {}
    for name, weights in (("qwen2-7b", qwen_weights),
                          ("rwkv6-3b", rwkv_weights)):
        cfg = ALL_ARCHS[name]
        params = init_params(torch, cfg)
        ws = weights(cfg, params)
        shapes = list(dict.fromkeys(tuple(w.shape) for w in ws))
        work = rowstream_work(torch, ws, SLOTS)
        work["per"] = f"one {name} decode step at {SLOTS} slots"
        time_works({f"rowstream_matmul on {name}": work})
        out[name] = {"step": numbers(work)}
        del params, ws, work
        torch.cuda.empty_cache()
        out[name]["products"] = rowstream_products(torch, shapes, baseline)
    return out


# --- phase 3: serve ------------------------------------------------------------

def serve_phase(torch, cfg, params, per_step: dict, slots=SLOTS,
                max_seq=MAX_SEQ, n_requests=N_REQ, prompt_len=PROMPT_LEN,
                max_new=MAX_NEW, mesh=None) -> dict:
    """Serve with the launch counters set to 0 just before and read just
    after; `per_step` is each kernel's launches per decode step (the
    kernels it names). On a `mesh`, `params` are this rank's shards."""
    from repro_torch.kernels import launch_counters, reset_launch_counters
    from repro_torch.launch.serve import make_requests, serve
    requests = make_requests(n_requests, prompt_len, max_new, cfg.vocab,
                             SEED)
    reset_launch_counters()
    run = serve(cfg, params, requests, slots, max_seq, "cuda", mesh)
    counts = {name: c.count for name, c in launch_counters().items()}
    b = run.batcher
    check(len(b.completed) == n_requests,
          f"serve answered {len(b.completed)} of {n_requests} requests")
    V = vocab_width(cfg)
    for req in b.completed:
        check(len(req.out_tokens) == max_new
              and all(0 <= t < V for t in req.out_tokens),
              f"request {req.rid}: tokens {req.out_tokens}")
    for name, n in per_step.items():
        check(counts[name] == n * b.steps,
              f"{cfg.name} serve: {name} launched {counts[name]} times in "
              f"{b.steps} steps, expected {n} per step")
    generated = sum(len(r.out_tokens) for r in b.completed)
    warm = sorted(run.step_seconds[1:])
    return {"run": run, "counts": counts, "steps": b.steps,
            "generated": generated,
            "tokens_per_s": generated / run.seconds,
            "first_step_ms": run.step_seconds[0] * 1e3,
            "median_step_ms": warm[len(warm) // 2] * 1e3,
            "mean_step_ms": sum(warm) / len(warm) * 1e3,
            "tokens": {r.rid: r.out_tokens for r in b.completed}}


def fed_steps(torch, ad, params, requests_tokens, slots, max_seq,
              steps=8, cross=None):
    """A decode state after `steps` greedy steps on the kernel path from
    the first token of each of the first `slots` requests, and the next
    tokens; the state's cross KV filled from `cross` (xk, xv) where
    given."""
    from repro_torch.launch.serve import greedy_sample
    cache = filled_state(ad, slots, max_seq, cross)
    tok = torch.tensor([[t[0]] for t in requests_tokens[:slots]],
                       dtype=torch.int32, device="cuda")
    with torch.inference_mode():
        for pos in range(steps):
            logits, cache = ad.decode(params, {"tokens": tok}, cache, pos)
            tok = greedy_sample(logits)[:, None]
    return cache, tok


def logits_phase(torch, cfg, params, requests_tokens, slots, max_seq):
    """Feed 8 steps on the kernel path, then run step 8 from copies of the
    same cache on the kernel path and on the plain path. For an MoE model
    also reports the routing decisions that differ between the paths; each
    must be one that rounding explains."""
    from repro_torch.models.registry import get_adapter
    ad = get_adapter(cfg)
    cache, tok = fed_steps(torch, ad, params, requests_tokens, slots,
                           max_seq)
    rk, rp = [], []
    with torch.inference_mode():
        plain_cache = {k: v.clone() for k, v in cache.items()}
        with recorded_routing(rk):
            lk, _ = ad.decode(params, {"tokens": tok}, cache, 8)
        with plain_path(), recorded_routing(rp):
            lp, _ = ad.decode(params, {"tokens": tok}, plain_cache, 8)
    torch.cuda.synchronize()
    if cfg.moe:
        flips = routing_flips(rk, rp)
        print_flips(f"{cfg.name} {cfg.dtype} step at pos 8", flips,
                    slots * len(rk))
        check(all(gap <= 2 * shift for _, _, gap, shift in flips),
              f"{cfg.name}: a routing decision differs between the paths "
              f"by more than rounding explains: {flips}")
    V = vocab_width(cfg)
    check(tuple(lk.shape) == (slots, 1, V) and bool(lk.isfinite().all()),
          f"kernel-path logits {tuple(lk.shape)} not finite")
    diff = (lk.float() - lp.float()).abs().max().item()
    scale = lp.float().abs().max().item()
    check(diff <= LOGITS_ATOL,
          f"kernel-path logits differ from the plain path by {diff} "
          f"(> {LOGITS_ATOL})")
    agree = int((lk.argmax(-1) == lp.argmax(-1)).sum().item())
    print(f"[logits] {cfg.name} {cfg.dtype} step at pos 8, {slots} slots: "
          f"max |kernel - plain| = "
          f"{diff!r} (tolerance {LOGITS_ATOL}; max |logit| {scale!r}); "
          f"greedy argmax agrees in {agree}/{slots} slots")
    return diff


def step_breakdown(torch, cfg, params, rm_launches: int, slots=SLOTS,
                   max_seq=MAX_SEQ, steps=5, labels=(), claims=()) -> dict:
    """Device time of one decode step (after the first few), by kernel
    group, from torch.profiler over `steps` steps that each end with the
    sampled tokens on the host; the step must run one rowstream_matmul
    device kernel for each of its `rm_launches` launches. With `labels`
    ((module, name, part) each) host ops are recorded too, and the device
    time of those functions is split out of "other" (:func:`op_split`);
    those named in `claims` also take the port's kernels they launch out
    of "rowstream_ms" and "flash_ms"."""
    from repro_torch.launch.serve import greedy_sample
    from repro_torch.models.registry import get_adapter
    ad = get_adapter(cfg)
    state = {"cache": ad.init_decode_state(slots, max_seq, device="cuda"),
             "pos": 0}
    tok = torch.ones((slots, 1), dtype=torch.int32, device="cuda")

    def step():
        logits, state["cache"] = ad.decode(params, {"tokens": tok},
                                           state["cache"], state["pos"])
        state["pos"] += 1
        greedy_sample(logits).cpu()

    with torch.inference_mode(), labelled(*[(m, n) for m, n, _ in labels]):
        step()
        prof = profile_calls(step, steps, cpu=bool(labels))
    total = _device_us(prof) / steps / 1e3
    check(total > 0, "the profiler recorded no device time for the step")
    rm_us, rm_count = _device_kernels(prof, RM_KERNELS)
    check(rm_count == rm_launches * steps,
          f"{cfg.name}: {rm_count} rowstream_matmul device kernels in "
          f"{steps} steps, expected {rm_launches} per step")
    rm = rm_us / steps / 1e3
    fd = _device_us(prof, FD_KERNELS) / steps / 1e3
    out = {"device_ms": total, "rowstream_ms": rm,
           "rowstream_kernels": rm_count // steps, "flash_ms": fd,
           "other_ms": total - rm - fd}
    if labels:
        split = op_split(prof, steps, {"rowstream_matmul": RM_KERNELS,
                                       "flash_decode": FD_KERNELS},
                         {n: part for _, n, part in labels}, products=False,
                         claims=claims)
        out["parts"] = {part: split[part] for _, _, part in labels}
        check(all(t > 0 for t in out["parts"].values()),
              f"{cfg.name} step: a part took no device time: {split}")
        out["rowstream_ms"] = split["rowstream_matmul"]
        out["flash_ms"] = split["flash_decode"]
        out["claimed"] = {label_part: split.get(f"{label_part} kernels", 0)
                          for _, n, label_part in labels if n in claims}
        out["other_ms"] = total - out["rowstream_ms"] - out["flash_ms"] \
            - sum(out["parts"].values())
    return out


def rwkv_forward_phase(torch, cfg, params) -> dict:
    """rwkv6-3b in bf16: (a) forward on PREFILL_B x PREFILL_S prompt
    tokens with the launch counters set to 0 just before and read just
    after, then timed on the host clock; the inputs of its rwkv_scan
    launches, recorded from one more forward for phase 4; every layer run
    on the same input through the kernel path and the plain path; and,
    reported only, the whole forward on the plain path, the first
    DECODE_T tokens through decode_step, and the plain path's logits
    after a one-ulp change of the embedding (see rwkv_fp32_phase)."""
    from repro_torch.kernels import launch_counters, reset_launch_counters
    from repro_torch.models import rwkv6
    from repro_torch.models.registry import get_adapter
    ad = get_adapter(cfg)
    V = params["lm_head"].shape[1]
    tokens = prompt_tokens(torch, cfg)
    batch = {"tokens": tokens}
    out = {"tokens": tokens}
    with torch.inference_mode():
        torch.cuda.synchronize()
        reset_launch_counters()
        t0 = time.perf_counter()
        logits = ad.forward(params, batch)
        torch.cuda.synchronize()
        out["first_ms"] = (time.perf_counter() - t0) * 1e3
        counts = {name: c.count for name, c in launch_counters().items()}
        out["counts"] = counts
        check(counts == {"flash_decode": 0, "rowstream_matmul": 0,
                         "rwkv_scan": cfg.n_layers, "rwkv_scan_bwd": 0},
              f"rwkv6-3b forward launched {counts}, expected "
              f"{cfg.n_layers} rwkv_scan and nothing else")
        check(tuple(logits.shape) == (PREFILL_B, PREFILL_S, V)
              and bool(logits.isfinite().all()),
              f"forward logits {tuple(logits.shape)} not finite")
        t0 = time.perf_counter()
        ad.forward(params, batch)
        torch.cuda.synchronize()
        out["forward_ms"] = (time.perf_counter() - t0) * 1e3

        launches = []
        scan = rwkv6.rwkv_scan

        def record(*args):
            launches.append(tuple(a.clone() for a in args))
            return scan(*args)

        rwkv6.rwkv_scan = record
        try:
            ad.forward(params, batch)
        finally:
            rwkv6.rwkv_scan = scan
        out["launches"] = launches

        # Each layer on the same input: the two paths differ in the scan
        # only, by fp32 rounding, which flips the last bit of some bf16
        # values downstream. A flipped bit of a large intermediate (the
        # channel mix squares activations into the hundreds) moves small
        # outputs by more than their own ulp, so the bound is
        # tests/test_kernels.py's bf16 tolerance, 3e-2, relative to the
        # layer output's largest magnitude.
        h = params["embed"][tokens]
        worst = 0.0
        for i in range(cfg.n_layers):
            bp = rwkv6._index(params["blocks"], i)
            hk = rwkv6._layer_seq(bp, cfg, h)
            with plain_path():
                hp = rwkv6._layer_seq(bp, cfg, h)
            err = (hk.float() - hp.float()).abs().max().item()
            scale = hp.float().abs().max().item()
            check(err <= 3e-2 * scale,
                  f"rwkv6-3b layer {i}: kernel and plain paths differ by "
                  f"{err} on the same input (largest |output| {scale})")
            worst = max(worst, err / scale)
            h = hk
        out["layer_err"] = worst

        with plain_path():
            plain = ad.forward(params, batch)
            bumped = dict(params, embed=(params["embed"].view(torch.int16)
                                         + 1).view(torch.bfloat16))
            out["ulp_diff"] = (ad.forward(bumped, batch)
                               .float() - plain.float()).abs().max().item()
        out["plain_diff"] = (logits.float() - plain.float()).abs().max().item()
        out["max_logit"] = plain.float().abs().max().item()
        del plain, bumped
        dec = decode_logits(torch, ad, params, tokens)
        out["decode_diff"] = (dec - logits[:, :DECODE_T].float()
                              ).abs().max().item()
    return out


def filled_state(ad, batch, max_seq, cross=None, cache_dtype=None):
    """A zeroed decode state on the card, its KV cache in `cache_dtype`
    where given (bf16 by default, as in the reference), and its cross KV
    set to `cross` (xk, xv; cast to the cache's dtype) where given."""
    kw = {} if cache_dtype is None else {"dtype": cache_dtype}
    state = ad.init_decode_state(batch, max_seq, device="cuda", **kw)
    if cross is not None:
        state["xk"].copy_(cross[0])
        state["xv"].copy_(cross[1])
    return state


def decode_logits(torch, ad, params, tokens, cache_dtype=None, cross=None):
    """Logits (b, DECODE_T, V) fp32 of the first DECODE_T tokens of
    `tokens`, stepped one by one through decode_step from
    :func:`filled_state`."""
    state = filled_state(ad, tokens.shape[0], MAX_SEQ, cross, cache_dtype)
    steps = []
    for t in range(DECODE_T):
        lg, state = ad.decode(params, {"tokens": tokens[:, t:t + 1]}, state,
                              t)
        steps.append(lg[:, 0].float())
    return torch.stack(steps, 1)


def prompt_tokens(torch, cfg, seq=PREFILL_S):
    """PREFILL_B x `seq` prompt tokens from SEED, on the card."""
    import numpy as np
    return torch.from_numpy(np.random.default_rng(SEED).integers(
        1, cfg.vocab, (PREFILL_B, seq))).to("cuda")


def vocab_width(cfg) -> int:
    """Logit columns: the vocabulary padded as the models pad it."""
    from repro_torch.distributed.sharding import padded_vocab
    return padded_vocab(cfg.vocab)


def forward_phase(torch, cfg, params, extra=None, seq=PREFILL_S) -> dict:
    """`cfg`'s forward on PREFILL_B x `seq` prompt tokens (and the family's
    `extra` inputs) with the launch counters set to 0 just before and read
    just after, then timed on the host clock. The prefill path is plain
    torch ops (the JAX package has no prefill kernel), so it launches none
    of the port's kernels. Keeps the batch, and the logits of the first
    DECODE_T positions in fp32."""
    from repro_torch.kernels import launch_counters, reset_launch_counters
    from repro_torch.models.registry import get_adapter
    ad = get_adapter(cfg)
    tokens = prompt_tokens(torch, cfg, seq)
    batch = {"tokens": tokens, **(extra or {})}
    V = vocab_width(cfg)
    out = {"tokens": tokens, "batch": batch}
    with torch.inference_mode():
        torch.cuda.synchronize()
        reset_launch_counters()
        t0 = time.perf_counter()
        logits = ad.forward(params, batch)
        torch.cuda.synchronize()
        out["first_ms"] = (time.perf_counter() - t0) * 1e3
        out["counts"] = {n: c.count for n, c in launch_counters().items()}
        check(not any(out["counts"].values()),
              f"{cfg.name} forward launched {out['counts']}, expected none")
        check(tuple(logits.shape) == (PREFILL_B, seq, V)
              and bool(logits.isfinite().all()),
              f"{cfg.name} forward logits {tuple(logits.shape)} not finite")
        out["logits"] = logits[:, :DECODE_T].float()
        del logits
        t0 = time.perf_counter()
        ad.forward(params, batch)
        torch.cuda.synchronize()
        out["forward_ms"] = (time.perf_counter() - t0) * 1e3
    return out


def decode_against_forward(torch, cfg, params, tokens, fwd_logits,
                           cache_dtype=None, cross=None) -> dict:
    """The first DECODE_T tokens of `tokens` stepped through decode_step
    (from a cross KV `cross` where given), with the launch counters set to
    0 just before and read just after (both decode kernels every step),
    against forward's logits of those positions: max abs difference and
    argmax agreement."""
    from repro_torch.kernels import launch_counters, reset_launch_counters
    from repro_torch.models.registry import get_adapter
    with torch.inference_mode():
        reset_launch_counters()
        dec = decode_logits(torch, get_adapter(cfg), params, tokens,
                            cache_dtype, cross)
        counts = {n: c.count for n, c in launch_counters().items()}
    check(counts == {n: k * DECODE_T for n, k in per_step(cfg).items()},
          f"{cfg.name} decode against forward launched {counts}, expected "
          f"{per_step(cfg)} per step")
    ref = fwd_logits[:tokens.shape[0]]
    return {"counts": counts,
            "decode_diff": (dec - ref).abs().max().item(),
            "max_logit": ref.abs().max().item(),
            "decode_argmax": (dec.argmax(-1) == ref.argmax(-1)
                              ).float().mean().item()}


def dense_fp32_phase(torch, cfg, tokens) -> dict:
    """`cfg` at full width in fp32, random weights from the same seed:
    the first DECODE_T tokens of one prompt through decode_step, with an
    fp32 KV cache, against forward's logits, within LOGITS_ATOL. In bf16
    a random full-width model moves its logits by more than that under a
    one-ulp change of its input (see rwkv_fp32_phase), and a bf16 cache
    rounds K and V where forward does not."""
    from repro_torch.models.registry import get_adapter
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params = init_params(torch, cfg32)
    tokens = tokens[:1, :DECODE_T]
    with torch.inference_mode():
        logits = get_adapter(cfg32).forward(params, {"tokens": tokens})
    out = decode_against_forward(torch, cfg32, params, tokens,
                                 logits.float(), torch.float32)
    check(out["decode_diff"] <= LOGITS_ATOL,
          f"{cfg.name} fp32 decode differs from forward by "
          f"{out['decode_diff']} (> {LOGITS_ATOL})")
    rel = out["decode_diff"] / out["max_logit"]
    check(rel <= CROSS_FP32_RTOL,
          f"{cfg.name} fp32 decode differs from forward by {rel} of the "
          f"largest logit (> {CROSS_FP32_RTOL})")
    print(f"[decode] {cfg.name} fp32: max |decode - forward| logits "
          f"{rel!r} of max |logit| (tolerance {CROSS_FP32_RTOL})")
    del params, logits
    torch.cuda.empty_cache()
    return out


def moe_layer_phase(torch, cfg, params, requests_tokens) -> dict:
    """Each layer of an MoE decode step at pos 8 (after 8 steps on the
    kernel path) run on the same input through the kernel path and the
    plain path. Held to 3e-2 of the layer output's largest magnitude (the
    bound of rwkv_forward_phase) over the tokens that both paths route to
    the same experts. The paths differ by rounding, which can move a gate
    probability across a near tie; such a token then takes another expert
    on one path, and its output differs by that expert's share. It is
    counted and printed with its gap instead, and its gap must be one that
    rounding explains (routing_flips). Reports the whole step's logits on
    both paths, and how far a one-ulp input change moves them."""
    from repro_torch.models import transformer
    from repro_torch.models.registry import get_adapter
    ad = get_adapter(cfg)
    cache, tok = fed_steps(torch, ad, params, requests_tokens, SLOTS,
                           MAX_SEQ)
    worst, flips = 0.0, []
    with torch.inference_mode():
        h = params["embed"][tok]
        for i in range(cfg.n_layers):
            bp = transformer._index(params["blocks"], i)
            kc, vc = cache["k"][i], cache["v"][i]
            kp, vp = kc.clone(), vc.clone()
            rk, rp = [], []
            with recorded_routing(rk):
                hk = transformer.block_decode(cfg, h, bp, kc, vc, 8, 8)
            with plain_path(), recorded_routing(rp):
                hp = transformer.block_decode(cfg, h, bp, kp, vp, 8, 8)
            layer_flips = [(i, t, gap, shift)
                           for _, t, gap, shift in routing_flips(rk, rp)]
            check(all(gap <= 2 * shift for *_, gap, shift in layer_flips),
                  f"{cfg.name} layer {i}: routing differs between the "
                  f"paths by more than rounding explains: {layer_flips}")
            same = torch.ones(hk.shape[0], dtype=torch.bool, device="cuda")
            same[[t for _, t, _, _ in layer_flips]] = False
            err = (hk.float() - hp.float())[same].abs().max().item() \
                if bool(same.any()) else 0.0
            scale = hp.float().abs().max().item()
            check(err <= 3e-2 * scale,
                  f"{cfg.name} layer {i}: kernel and plain paths differ by "
                  f"{err} on the same input (largest |output| {scale})")
            worst = max(worst, err / scale)
            flips += layer_flips
            h = hk
        # Reported only: the whole step on both paths, and on the plain
        # path after a one-ulp change of every embedding value. Slot 8 of
        # each cache copy is written anew before it is read.
        bumped = dict(params, embed=(params["embed"].view(torch.int16) + 1)
                      .view(torch.bfloat16))
        runs = {}
        for name, p, ctx in (("kernel", params, contextlib.nullcontext),
                             ("plain", params, plain_path),
                             ("plain, one ulp up", bumped, plain_path)):
            calls = []
            with ctx(), recorded_routing(calls):
                lg, _ = ad.decode(p, {"tokens": tok},
                                  {k: v.clone() for k, v in cache.items()},
                                  8)
            runs[name] = (lg.float(), calls)
    print_flips(f"{cfg.name} bf16, each layer of the step at pos 8 on the "
                f"same input", flips, SLOTS * cfg.n_layers)
    (lk, rk), (lp, rp), (lu, ru) = runs.values()
    out = {"layer_err": worst, "flips": len(flips),
           "step_diff": (lk - lp).abs().max().item(),
           "step_flips": len(routing_flips(rk, rp)),
           "ulp_diff": (lu - lp).abs().max().item(),
           "ulp_flips": len(routing_flips(ru, rp))}
    print(f"[logits] {cfg.name} bf16 step at pos 8, reported only: max "
          f"|kernel - plain| logits {out['step_diff']!r} (max |logit| "
          f"{lp.abs().max().item()!r}), {out['step_flips']} of "
          f"{SLOTS * cfg.n_layers} routing decisions differ; on the plain "
          f"path a one-ulp change of every embedding value moves the "
          f"logits by {out['ulp_diff']!r} and changes {out['ulp_flips']} "
          f"routing decisions")
    return out


def zamba2_layer_phase(torch, cfg, params, requests_tokens) -> dict:
    """One decode step at pos 8 (after 8 steps on the kernel path) of each
    Mamba2 block and of the shared block at each of its depths, run on the
    same input and state through the kernel path and the plain path. Each
    output, and each block's new SSM state, is held to 3e-2 of its largest
    magnitude (the bound of rwkv_forward_phase): a random full-width bf16
    model moves its whole-model logits by more than any useful bound under
    a one-ulp change (PERF.md), so bf16 is held block by block."""
    from repro_torch.models import zamba2
    from repro_torch.models.registry import get_adapter
    from repro_torch.models.transformer import block_decode
    state, tok = fed_steps(torch, get_adapter(cfg), params, requests_tokens,
                           SLOTS, MAX_SEQ)
    k, n_shared = zamba2._pattern(cfg)
    sp = params["shared"]
    worst = {"mamba": 0.0, "mamba state": 0.0, "shared": 0.0}

    def held(what, i, got, ref):
        err = (got.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        check(err <= 3e-2 * scale,
              f"zamba2 {what} {i}: kernel and plain paths differ by {err} "
              f"on the same input (largest |output| {scale})")
        worst[what] = max(worst[what], err / scale)

    with torch.inference_mode():
        h = params["embed"][tok][:, 0]
        for i in range(cfg.n_layers):
            bp = zamba2._index(params["blocks"], i)
            ks, ps = ([state[n][i].clone() for n in ("ssm", "conv")]
                      for _ in range(2))
            hk = zamba2._mamba_block_step(bp, cfg, h, *ks)
            with plain_path():
                hp = zamba2._mamba_block_step(bp, cfg, h, *ps)
            held("mamba", i, hk, hp)
            held("mamba state", i, ks[0], ps[0])
            h = hk
            if i < n_shared * k and (i + 1) % k == 0:
                u = i // k
                kk, pp = ([state[n][u].clone() for n in ("k", "v")]
                          for _ in range(2))
                hk = block_decode(cfg, h[:, None], sp, *kk, 8, 8)[:, 0]
                with plain_path():
                    hp = block_decode(cfg, h[:, None], sp, *pp, 8, 8)[:, 0]
                held("shared", u, hk, hp)
                h = hk
    print(f"[logits] zamba2-1.2b bf16: each block of the step at pos 8 on "
          f"the same input, kernel against plain path, max err / max "
          f"|output|: {worst!r} (tolerance 3e-2; {cfg.n_layers} Mamba2 "
          f"blocks, the shared block at {n_shared} depths)")
    return worst


def zamba2_fp32_phase(torch, cfg, prompts, tokens) -> dict:
    """zamba2 at full width in fp32, random weights from the same seed:
    one decode step at pos 8 on the kernel path against the plain path
    (logits_phase), and the first DECODE_T tokens of the PREFILL_B prompts
    stepped through decode_step, with an fp32 KV cache, against forward's
    logits; both within LOGITS_ATOL."""
    from repro_torch.models.registry import get_adapter
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params = init_params(torch, cfg32)
    out = {"step_diff": logits_phase(torch, cfg32, params, prompts, SLOTS,
                                     MAX_SEQ)}
    tokens = tokens[:, :DECODE_T]
    with torch.inference_mode():
        logits = get_adapter(cfg32).forward(params, {"tokens": tokens})
    out.update(decode_against_forward(torch, cfg32, params, tokens,
                                      logits.float(), torch.float32))
    check(out["decode_diff"] <= LOGITS_ATOL,
          f"{cfg.name} fp32 decode differs from forward by "
          f"{out['decode_diff']} (> {LOGITS_ATOL})")
    rel = out["decode_diff"] / out["max_logit"]
    check(rel <= CROSS_FP32_RTOL,
          f"{cfg.name} fp32 decode differs from forward by {rel} of the "
          f"largest logit (> {CROSS_FP32_RTOL})")
    print(f"[decode] {cfg.name} fp32: max |decode - forward| logits "
          f"{rel!r} of max |logit| (tolerance {CROSS_FP32_RTOL})")
    del params, logits
    torch.cuda.empty_cache()
    return out


def paged_pool_phase(torch) -> dict:
    """The port's RowPagedKVCache on the card: POOL_SEQS sequences of POOL_S
    tokens of one qwen2-7b layer, pages of POOL_ROWS 4 KB rows, appended in
    alternating chunks so that their pages interleave; every token written
    with ``write``; each sequence gathered with ``gather_seq`` and held bit
    for bit against a CPU copy of the same cache, then attended by
    flash_decode as (1, POOL_KV, POOL_S, POOL_HD) against its plain version
    at the bf16 check's tolerance (flash_verdict). The gather is timed."""
    from repro_torch.kernels.flash_decode.ops import flash_decode
    from repro_torch.kernels.flash_decode.ref import flash_decode_ref
    from repro_torch.serve.kv_cache import RowPagedKVCache, tokens_per_row
    pt = tokens_per_row(POOL_HD, POOL_KV, 2, POOL_ROWS)
    per_seq = POOL_S // pt
    kw = dict(n_pages=POOL_SEQS * per_seq, page_tokens=pt,
              n_kv_heads=POOL_KV, head_dim=POOL_HD, max_seqs=POOL_SEQS,
              max_pages_per_seq=per_seq)
    dev_cache, cpu_cache = RowPagedKVCache(**kw), RowPagedKVCache(
        **kw, device="cpu")
    check(dev_cache.pool_k.is_cuda and dev_cache.rows_per_page() == POOL_ROWS,
          f"paged pool: {dev_cache.pool_k.device}, "
          f"{dev_cache.rows_per_page()} rows a page")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    kv = torch.randn((2, POOL_SEQS, POOL_S, POOL_KV, POOL_HD), generator=gen,
                     device="cuda").to(torch.bfloat16)
    kv_cpu = kv.cpu()
    for c in (dev_cache, cpu_cache):
        for sid in range(POOL_SEQS):
            c.alloc_seq(sid, 0)
        while any(c.seq_lens < POOL_S):
            for sid in range(POOL_SEQS):
                c.append_chunk(sid, min(POOL_CHUNK,
                                        POOL_S - int(c.seq_lens[sid])))
    row = [int(p) for p in dev_cache.page_table[0]]
    check(bool((dev_cache.page_table == cpu_cache.page_table).all())
          and any(b - a != 1 for a, b in zip(row, row[1:]))
          and dev_cache.free_pages == 0,
          f"paged pool: page tables differ or pages do not interleave "
          f"(sequence 0: {row})")
    t0 = time.perf_counter()
    for c, vals in ((dev_cache, kv), (cpu_cache, kv_cpu)):
        for sid in range(POOL_SEQS):
            for t in range(POOL_S):
                pg, slot = divmod(t, pt)
                c.write(int(c.page_table[sid, pg]), slot, vals[0, sid, t],
                        vals[1, sid, t])
        if c is dev_cache:
            torch.cuda.synchronize()
            write_s = time.perf_counter() - t0
    worst = 0.0
    q = torch.randn((1, POOL_HEADS, POOL_HD), generator=gen,
                    device="cuda").to(torch.bfloat16)
    for sid in range(POOL_SEQS):
        k, v = dev_cache.gather_seq(sid)
        kc, vc = cpu_cache.gather_seq(sid)
        check(torch.equal(k.cpu(), kc) and torch.equal(v.cpu(), vc)
              and torch.equal(kc, kv_cpu[0, sid])
              and tuple(k.shape) == (POOL_S, POOL_KV, POOL_HD),
              f"paged pool: sequence {sid} gathers other bits on the card "
              f"than on the CPU or than were written")
        kh, vh = (x.permute(1, 0, 2)[None].contiguous() for x in (k, v))
        out = flash_decode(q, kh, vh, POOL_S - 1)
        torch.cuda.synchronize()
        elementwise, scaled, err, scale = flash_verdict(
            torch, out, flash_decode_ref(q, kh, vh, POOL_S - 1))
        check(elementwise and scaled,
              f"paged pool: flash_decode over sequence {sid} differs from "
              f"its plain version by {err} (max |ref| {scale})")
        worst = max(worst, err)
    gather_ms = timed_ms(lambda: dev_cache.gather_seq(0), 50)
    nbytes = 2 * 2 * POOL_S * POOL_KV * POOL_HD * 2
    out = {"gather_ms": gather_ms, "gather_bound_ms": bound(
        nbytes, 0, "bfloat16")[0], "write_s": write_s,
        "flash_max_abs_err": worst, "pages": dev_cache.n_pages,
        "page_tokens": pt}
    print(f"[pool] RowPagedKVCache on {dev_cache.device}: {POOL_SEQS} "
          f"sequences of {POOL_S} tokens, {dev_cache.n_pages} pages of {pt} "
          f"tokens ({POOL_ROWS} rows), interleaved; {POOL_SEQS * POOL_S} "
          f"writes in {write_s!r} s; gather_seq bit for bit against the CPU "
          f"copy; flash_decode over each gathered sequence against its plain "
          f"version, max abs err {worst!r}; gather_seq of one sequence "
          f"{gather_ms!r} ms wall (CUDA events), bound {out['gather_bound_ms']!r}"
          f" ms ({nbytes} bytes read and written)")
    return out


def ssd_ops(cfg, tokens: int) -> int:
    """fp32 operations of the SSD recurrence over `tokens` tokens of every
    Mamba2 layer: per (head, channel, state) entry, (B outer x) * dt,
    a * H + that, and the read-out's multiply-add."""
    from repro_torch.models import zamba2
    return 6 * tokens * cfg.n_layers * zamba2.ssm_heads(cfg) \
        * cfg.ssm.head_dim * cfg.ssm.state_dim


def cell_bounds(cfg, params) -> dict:
    """Least device times (:func:`bound`) of a decode step at SLOTS slots
    and of a forward on PREFILL_B x PREFILL_S tokens. Bytes: every weight
    but the embedding, read once (a step of an MoE model streams every
    expert: at SLOTS tokens each expert's capacity is top_k slots; a step
    of zamba2 streams its shared block once per application, as it does
    not fit the 50 MB L2, and reads and writes the fp32 SSM state).
    Operations: 2 per weight that a token uses (top_k of the experts;
    the shared block once per application), the causal attention's two
    products, and zamba2's SSD recurrence in fp32."""
    ws = [t for k, v in params.items() if k != "embed"
          for t in (_tensors(v) if isinstance(v, dict) else [v])]
    n_w = sum(t.numel() for t in ws)
    nbytes = sum(t.numel() * t.element_size() for t in ws)
    step_bytes, attn_layers = nbytes, cfg.n_layers
    step_fp32, fwd_fp32 = 0, 0
    if cfg.moe:
        m = cfg.moe
        n_w -= cfg.n_layers * (m.n_experts - m.top_k) * 3 * cfg.d_model \
            * m.expert_d_ff
    if cfg.family == "hybrid":
        from repro_torch.models import zamba2
        _, attn_layers = zamba2._pattern(cfg)
        shared = list(_tensors(params["shared"]))
        n_w += (attn_layers - 1) * sum(t.numel() for t in shared)
        step_bytes += (attn_layers - 1) * sum(
            t.numel() * t.element_size() for t in shared)
        state = zamba2.init_state(cfg, SLOTS, 1, device="meta")["ssm"]
        step_bytes += 2 * state.numel() * state.element_size()
        step_fp32, fwd_fp32 = ssd_ops(cfg, SLOTS), \
            ssd_ops(cfg, PREFILL_B * PREFILL_S)
    hd, s = cfg.resolved_head_dim, PREFILL_S
    attn = 4 * PREFILL_B * cfg.n_heads * hd * s * (s + 1) // 2 * attn_layers
    step_ms, step_by = bound(step_bytes, 2 * SLOTS * n_w, "bfloat16",
                             step_fp32)
    fwd_ops = 2 * PREFILL_B * s * n_w + attn
    fwd_ms, fwd_by = bound(nbytes, fwd_ops, "bfloat16", fwd_fp32)
    print(f"[bound] {cfg.name}: {nbytes} bytes of weights beside the "
          f"embedding, {n_w} used per token; decode step at {SLOTS} slots "
          f"{step_bytes} bytes, {2 * SLOTS * n_w} operations"
          f"{f' and {step_fp32} in fp32' if step_fp32 else ''}: "
          f"{step_ms!r} ms ({step_by}); forward on {PREFILL_B} x {s} tokens, "
          f"{fwd_ops} operations"
          f"{f' and {fwd_fp32} in fp32' if fwd_fp32 else ''}, {fwd_ms!r} ms "
          f"({fwd_by})")
    return {"step_ms": step_ms, "forward_ms": fwd_ms,
            "step_bytes": step_bytes}


def plain_agreement(torch, cfg, params, sv) -> int:
    """The same requests served on the plain path: the greedy tokens that
    agree with the kernel path's, position by position."""
    from repro_torch.launch.serve import make_requests, serve
    with plain_path():
        plain = serve(cfg, params, make_requests(N_REQ, PROMPT_LEN, MAX_NEW,
                                                 cfg.vocab, SEED),
                      SLOTS, MAX_SEQ, "cuda")
    agree = sum(a == b for r in plain.batcher.completed
                for a, b in zip(r.out_tokens, sv["tokens"][r.rid]))
    print(f"[serve] {cfg.name} plain path: {agree}/{sv['generated']} greedy "
          f"tokens agree with the kernel path, position by position")
    return agree


def rwkv_fp32_phase(torch, cfg, tokens) -> dict:
    """rwkv6-3b at full width in fp32, random weights from the same seed:
    the forward on the kernel path against the plain path, and the first
    DECODE_T tokens through decode_step against forward, both within
    LOGITS_ATOL. In bf16 the random-weight model at full width amplifies
    any rounding: a one-ulp change of its embedding moves the plain path's
    own logits by far more than LOGITS_ATOL, so bf16 logits cannot tell a
    right kernel from a wrong one; in fp32 they can."""
    from repro_torch.models.registry import get_adapter
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params = init_params(torch, cfg32)
    ad = get_adapter(cfg32)
    out = {}
    with torch.inference_mode():
        logits = ad.forward(params, {"tokens": tokens}).float()
        with plain_path():
            plain = ad.forward(params, {"tokens": tokens}).float()
        torch.cuda.synchronize()
        out["plain_diff"] = (logits - plain).abs().max().item()
        out["max_logit"] = plain.abs().max().item()
        out["plain_argmax"] = (logits.argmax(-1) == plain.argmax(-1)
                               ).float().mean().item()
        del plain
        check(out["plain_diff"] <= LOGITS_ATOL,
              f"rwkv6-3b fp32 forward logits differ from the plain path by "
              f"{out['plain_diff']} (> {LOGITS_ATOL})")
        dec = decode_logits(torch, ad, params, tokens)
        ref = logits[:, :DECODE_T]
        out["decode_diff"] = (dec - ref).abs().max().item()
        out["decode_argmax"] = (dec.argmax(-1) == ref.argmax(-1)
                                ).float().mean().item()
        check(out["decode_diff"] <= LOGITS_ATOL,
              f"rwkv6-3b fp32 decode differs from forward by "
              f"{out['decode_diff']} (> {LOGITS_ATOL})")
    del params, logits
    torch.cuda.empty_cache()
    return out


def forward_breakdown(torch, cfg, params, batch, kernel_parts=None,
                      labels=()) -> dict:
    """Device time of one forward on `batch` from torch.profiler, by part
    (:func:`op_split`): the port's kernels named in `kernel_parts`, the
    functions of `labels` ((module, name, part) each; the first listed
    whose range is around a kernel's host op takes it), the torch.matmul
    products outside them, and the rest. Each part must have taken device
    time."""
    from repro_torch.models.registry import get_adapter
    ad = get_adapter(cfg)
    kernel_parts = kernel_parts or {}
    with torch.inference_mode(), labelled(*[(m, n) for m, n, _ in labels]):
        prof = profile_calls(lambda: ad.forward(params, batch), 1, cpu=True)
    split = op_split(prof, 1, kernel_parts,
                     {n: part for _, n, part in labels}, products=True)
    check(all(t > 0 for t in split.values()),
          f"{cfg.name} forward: a part took no device time: {split}")
    return split


def print_split(what: str, split: dict, host_ms: float) -> None:
    parts = ", ".join(f"{p} {t!r}" for p, t in split.items()
                      if p != "device")
    print(f"[profile] {what} device time {split['device']!r} ms: {parts}; "
          f"device idle share of the host time {host_ms!r} ms "
          f"{1 - split['device'] / host_ms!r}")


def time_works(works: dict) -> None:
    """Each work's wall time (CUDA events), then its kernel, plain and
    library device times (torch.profiler); printed and kept in `works`."""
    for w in works.values():
        if "wall_ms" not in w:
            w["wall_ms"] = timed_ms(w["kernel"], w["reps"])
    for name, w in works.items():
        w["ms"] = device_ms(w["kernel"], w["reps"], w["names"])
        w["plain_ms"] = (device_ms(w["plain"], w.get("plain_reps", w["reps"]))
                         if w["plain"] is not None else None)
        if "plain_one" in w:
            w["plain_ms"] = sum(
                device_ms(lambda i=i: w["plain_one"](i), 1)
                for i in range(w["plain_windows"]))
        w["library_ms"] = (device_ms(w["library"], w["reps"])
                           if w["library"] is not None else None)
        print(f"[time] {name}, {w['launches_per_step']} launches of "
              f"{w['per']}, device time: kernel {w['ms']!r} ms (wall "
              f"{w['wall_ms']!r} ms), plain {w['plain_ms']!r} ms, library "
              f"{w['library_ms']!r} ms, bound {w['bound_ms']!r} ms "
              f"({w['bound_by']})")
        if "ops" in w:
            print(f"[time] {name}: {w['bytes']!r} bytes, {w['ops']!r} "
                  f"operations (bytes over 3.35 TB/s "
                  f"{w['bytes'] / PEAK_BYTES_PER_S * 1e3!r} ms, operations "
                  f"over fp32's 67 TFLOP/s "
                  f"{w['ops'] / PEAK_OPS_PER_S['float32'] * 1e3!r} ms)")


def print_breakdown(name: str, bd: dict, median_ms: float,
                    flash: str = "flash_decode") -> None:
    parts = "".join(f"{p} {t!r}, " for p, t in bd.get("parts", {}).items())
    print(f"[profile] {name} decode step device time {bd['device_ms']!r} "
          f"ms: rowstream_matmul {bd['rowstream_ms']!r} "
          f"({bd['rowstream_kernels']} device kernels per step), {flash} "
          f"{bd['flash_ms']!r}, {parts}"
          f"other torch kernels {bd['other_ms']!r}; device idle share at "
          f"the median step {1 - bd['device_ms'] / median_ms!r}")


def zamba2_phase(torch, layers: int | None = None) -> dict:
    """zamba2-1.2b in bf16 (its depth cut to `layers` Mamba2 blocks where
    given, at full width), everything timed on the host clock or with
    CUDA events: its bounds; served with the driver's defaults (the
    launch counters set to 0 just before and read just after: 119
    rowstream_matmul and 6 flash_decode launches a step), the same
    requests on the plain path; each block of one step against the plain
    path; the CUDA-event wall time of the step's 119 products; forward on
    PREFILL_B x PREFILL_S tokens; then in fp32 one step against the plain
    path and decode against forward; then the paged pool."""
    from repro_torch.configs.registry_configs import ALL_ARCHS
    cfg = ALL_ARCHS[ZAMBA]
    if layers is not None:
        print(f"[depth] {ZAMBA}: {cfg.n_layers} Mamba2 blocks cut to "
              f"{layers} at full width (d_model {cfg.d_model}; the shared "
              f"block after every {cfg.shared_attn_every}th); the full depth "
              f"runs with --only zamba2")
        cfg = dataclasses.replace(cfg, n_layers=layers)
    params = init_params(torch, cfg)
    z = {"cfg": cfg, "bound": cell_bounds(cfg, params)}
    sv = z["serve"] = serve_phase(torch, cfg, params, per_step(cfg))
    print_serve("zamba2-1.2b", sv)
    prompts = [r.prompt for r in sorted(sv["run"].batcher.completed,
                                        key=lambda r: r.rid)]
    plain_agreement(torch, cfg, params, sv)
    zamba2_layer_phase(torch, cfg, params, prompts)
    z["rm_wall_ms"] = timed_ms(rowstream_work(
        torch, zamba_weights(cfg, params), SLOTS)["kernel"], 5)
    zf = z["forward"] = forward_phase(torch, cfg, params)
    print_forward("zamba2-1.2b", zf)
    del params, zf["logits"]
    torch.cuda.empty_cache()
    z32 = zamba2_fp32_phase(torch, cfg, prompts, zf["tokens"])
    print_decode("zamba2-1.2b fp32 (fp32 cache)", z32)
    z["pool"] = paged_pool_phase(torch)
    return z


def zamba2_profiled(torch, z: dict) -> tuple[dict, list]:
    """zamba2-1.2b's profiled parts, on weights made again from the same
    seed: the step's 119 rowstream_matmul launches (kernel, plain version,
    torch.matmul), the profiled split of a decode step and of the forward,
    and one line per distinct product shape (in_proj's (2048, 8384) among
    them: its rows of 16768 bytes are not whole 4 KB rows)."""
    from repro_torch.models import layers, zamba2
    cfg, sv, zf = z["cfg"], z["serve"], z["forward"]
    params = init_params(torch, cfg)
    name = "rowstream_matmul on zamba2-1.2b"
    works = {name: rowstream_work(torch, zamba_weights(cfg, params), SLOTS)}
    works[name].update(per=f"one zamba2-1.2b decode step at {SLOTS} slots",
                       wall_ms=z["rm_wall_ms"])
    time_works(works)
    bd = step_breakdown(torch, cfg, params,
                        per_step(cfg)["rowstream_matmul"], labels=[
                            (zamba2, "_ssd_scan", "SSD scan"),
                            (zamba2, "_mamba_block_step",
                             "other Mamba2 block ops (conv, norms, gate)")])
    print_breakdown("zamba2-1.2b", bd, sv["median_step_ms"])
    b = z["bound"]
    print(f"[bound] zamba2-1.2b decode step, {b['step_bytes']} bytes: bound "
          f"{b['step_ms']!r} ms, device time {bd['device_ms']!r} ms at "
          f"{b['step_ms'] / bd['device_ms']!r} of it")
    fb = forward_breakdown(torch, cfg, params, zf["batch"], labels=[
        (zamba2, "_ssd_scan", "SSD scan"), (zamba2, "_causal_conv", "conv"),
        (layers, "attention_scores", "shared attention")])
    print_split("zamba2-1.2b forward", fb, zf["forward_ms"])
    shapes = list(dict.fromkeys(tuple(w.shape)
                                for w in zamba_weights(cfg, params)))
    del params
    torch.cuda.empty_cache()
    return ({n: numbers(w) for n, w in works.items()},
            rowstream_products(torch, shapes))


# --- the cross-attention families: whisper-small, llama-3.2-vision ----------

def cross_cfg(name: str, units: int = MLLAMA_UNITS):
    """whisper-small whole, or llama-3.2-vision at full width with its depth
    cut to `units` pattern units."""
    from repro_torch.configs.registry_configs import ALL_ARCHS
    cfg = ALL_ARCHS[name]
    if name == MLLAMA:
        cfg = dataclasses.replace(
            cfg, n_layers=units * cfg.cross_attn_every)
    return cfg


def cross_params(torch, cfg) -> dict:
    """init_params, then from SEED + 15 the leaves that init makes
    constant, so that the checks see them: whisper's biases and LayerNorm
    shifts N(0, 0.02) and LayerNorm scales 1 + N(0, 0.1); mllama's tanh
    gates U(0.5, 1.0) (zero gates make every cross layer the identity)."""
    params = init_params(torch, cfg)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 15)

    def draw(v):
        return torch.randn(v.shape, generator=gen, device="cuda")

    def walk(tree, ln=False):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, k.startswith("ln_"))
            elif k.startswith("gate_"):
                v.copy_(torch.rand(v.shape, generator=gen, device="cuda")
                        * 0.5 + 0.5)
            elif ln and k == "w":
                v.copy_(1 + draw(v) * 0.1)
            elif cfg.family == "audio" and (ln or k.startswith("b")):
                v.copy_(draw(v) * 0.02)

    walk(params)
    return params


def cross_inputs(torch, cfg) -> dict:
    """The stub input of PREFILL_B requests in the model's dtype, N(0, 1)
    from CROSS_SEED: whisper's frames (b, 1500, 768), mllama's vision
    embeddings (b, 1601, 8192)."""
    gen = torch.Generator(device="cuda").manual_seed(CROSS_SEED)
    name, S = (("frames", cfg.n_audio_frames) if cfg.family == "audio"
               else ("vision_embeds", cfg.n_vision_tokens))
    x = torch.randn((PREFILL_B, S, cfg.d_model), generator=gen,
                    device="cuda")
    return {name: x.to(getattr(torch, cfg.dtype))}


def cross_kv(torch, cfg, params, extra: dict) -> tuple:
    """(xk, xv) of the stub input: whisper's from its encoder output,
    mllama's from the vision embeddings (``precompute_cross_kv``)."""
    from repro_torch.models import mllama, whisper
    with torch.inference_mode():
        if cfg.family == "audio":
            return whisper.precompute_cross_kv(
                params, cfg, whisper.encode(params, cfg, extra["frames"]))
        return mllama.precompute_cross_kv(params, cfg,
                                          extra["vision_embeds"])


def cross_source(torch, cfg, params):
    """What ``precompute_cross_kv`` takes for the stub input of
    :func:`cross_inputs` (PREFILL_B rows): whisper's encoder output, made
    with `params` whole, or mllama's vision embeddings."""
    from repro_torch.models import whisper
    extra = cross_inputs(torch, cfg)
    if cfg.family == "vlm":
        return extra["vision_embeds"]
    with torch.inference_mode():
        return whisper.encode(params, cfg, extra["frames"])


def meshless_cross_kv(torch, cfg, params) -> tuple:
    """(xk, xv) of the stub input through ``precompute_cross_kv`` without
    a mesh: the cross KV that the mesh runs are held against."""
    from repro_torch.models import mllama, whisper
    mod = whisper if cfg.family == "audio" else mllama
    with torch.inference_mode():
        return mod.precompute_cross_kv(params, cfg,
                                       cross_source(torch, cfg, params))


def cross_weights(cfg, params) -> list:
    """The decode products' weights in step order: whisper-small's 97 (per
    layer self q, k, v, o, cross q, o, the MLP's up and down; the tied
    head, made once by ``whisper.tied_head``), mllama's 67 at two units (a
    dense layer's seven per self layer; q, o and the SwiGLU's three per
    cross layer; the head)."""
    from repro_torch.models import mllama, whisper
    if cfg.family == "audio":
        dec = params["decoder"]
        names = [("attn", w) for w in ("wq", "wk", "wv", "wo")] \
            + [("xattn", "wq"), ("xattn", "wo"), ("mlp", "w_up"),
               ("mlp", "w_down")]
        return [dec[a][w][i] for i in range(cfg.n_layers)
                for a, w in names] + [whisper.tied_head(params["embed"])]
    k, n_units = mllama._pattern(cfg)
    sb, cb = params["self_blocks"], params["cross_blocks"]
    cross = [("attn", "wq"), ("attn", "wo")] + QWEN_PRODUCTS[4:]
    out = []
    for u in range(n_units):
        out += [sb[a][w][u * (k - 1) + j] for j in range(k - 1)
                for a, w in QWEN_PRODUCTS]
        out += [cb[a][w][u] for a, w in cross]
    return out + [params["lm_head"]]


def cross_bounds(cfg, params) -> dict:
    """Least device times (:func:`bound`) of a decode step at SLOTS slots
    and of a forward of whisper-small or llama-3.2-vision, as
    :func:`cell_bounds` gives them for the other families. A step reads
    every weight it uses once (whisper: the decoder's and the tied
    embedding as its head; mllama: the self and cross layers' and the
    head; neither the cross K/V projections, which run once per request,
    nor an embedding gather) and the SLOTS requests' bf16 cross KV; its
    operations are 2 per weight a token uses and the cross-attention's two
    products over all S slots (the self KV, 128 slots, is left out, as in
    cell_bounds). A forward on PREFILL_B requests (whisper: 448 decoder
    tokens and 1500 frames; mllama: PREFILL_S tokens and 1601 vision
    tokens) reads every weight once; its operations are 2 per weight per
    token through it (the encoder's and the cross K/V projections' frames
    or vision tokens, the decoder's tokens) and the attention products:
    the encoder's full, the decoder's causal, the cross over all S."""
    from repro_torch.models import mllama
    B, hd, H = PREFILL_B, cfg.resolved_head_dim, cfg.n_heads
    if cfg.family == "audio":
        dec = params["decoder"]
        S, s, kv_heads = cfg.n_audio_frames, cfg.max_target_positions, H
        n_self = n_cross = cfg.n_layers
        kv_proj = [dec["xattn"][w] for w in ("wk", "wv", "bv")]
        other = [dec, params["ln_dec"], params["embed"]]
        enc = list(_tensors(params["encoder"])) \
            + list(_tensors(params["ln_enc"]))
        enc_ops = 2 * B * S * sum(t.numel() for t in enc) \
            + 4 * B * H * hd * S * S * cfg.encoder_layers
    else:
        k, n_cross = mllama._pattern(cfg)
        S, s, kv_heads = cfg.n_vision_tokens, PREFILL_S, cfg.n_kv_heads
        n_self = n_cross * (k - 1)
        cb = params["cross_blocks"]["attn"]
        kv_proj = [cb["wk"], cb["wv"]]
        other = [v for key, v in params.items() if key != "embed"]
        enc, enc_ops = [], 0
    step_w = [t for v in other
              for t in (_tensors(v) if isinstance(v, dict) else [v])
              if not any(t is x for x in kv_proj)]
    n_w = sum(t.numel() for t in step_w)
    w_bytes = sum(t.numel() * t.element_size() for t in step_w)
    kv_bytes = 2 * n_cross * SLOTS * kv_heads * S * hd * 2
    step_ops = 2 * SLOTS * n_w + 4 * SLOTS * H * S * hd * n_cross
    step_ms, step_by = bound(w_bytes + kv_bytes, step_ops, "bfloat16")
    fwd_bytes = sum(t.numel() * t.element_size()
                    for t in step_w + kv_proj + enc)
    fwd_ops = enc_ops + 2 * B * s * n_w \
        + 2 * B * S * sum(t.numel() for t in kv_proj) \
        + 4 * B * H * hd * s * (s + 1) // 2 * n_self \
        + 4 * B * H * hd * s * S * n_cross
    fwd_ms, fwd_by = bound(fwd_bytes, fwd_ops, "bfloat16")
    print(f"[bound] {cfg.name}: decode step at {SLOTS} slots {w_bytes} bytes "
          f"of weights and {kv_bytes} of cross KV, {step_ops} operations: "
          f"{step_ms!r} ms ({step_by}); forward on {B} x {s} tokens and "
          f"{B} x {S} cross tokens, {fwd_bytes} bytes, {fwd_ops} operations: "
          f"{fwd_ms!r} ms ({fwd_by})")
    return {"step_ms": step_ms, "forward_ms": fwd_ms,
            "step_bytes": w_bytes + kv_bytes, "step_by": step_by,
            "forward_by": fwd_by}


def cross_layer_phase(torch, cfg, params, prompts, cross) -> dict:
    """One decode step at pos 8, after 8 steps on the kernel path with the
    cross KV `cross`, layer by layer: each whisper decoder layer, or each
    mllama self and cross layer, run on the same input and cache through
    the kernel path and the plain path. Each output is held to 3e-2 of
    its largest magnitude (the bound of rwkv_forward_phase)."""
    from repro_torch.models import mllama, transformer, whisper
    from repro_torch.models.registry import get_adapter
    state, tok = fed_steps(torch, get_adapter(cfg), params, prompts, SLOTS,
                           MAX_SEQ, cross=cross)
    worst = {}

    def both(step, i=None):
        """`step`(kc, vc) on both paths, on copies of self layer i's
        caches."""
        outs = []
        for ctx in (contextlib.nullcontext, plain_path):
            kv = (None, None) if i is None else \
                (state["k"][i].clone(), state["v"][i].clone())
            with ctx():
                outs.append(step(*kv))
        return outs

    def held(what, i, got, ref):
        err = (got.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        check(err <= 3e-2 * scale,
              f"{cfg.name} {what} layer {i}: kernel and plain paths differ "
              f"by {err} on the same input (largest |output| {scale})")
        worst[what] = max(worst.get(what, 0.0), err / scale)
        return got

    xk, xv = state["xk"], state["xv"]
    with torch.inference_mode():
        h = params["embed"][tok]
        if cfg.family == "audio":
            posb = torch.full((SLOTS, 1), 8, dtype=torch.int32,
                              device="cuda")
            h = h + whisper.sinusoid_pos(posb, cfg.d_model).to(h.dtype)
            for i in range(cfg.n_layers):
                bp = whisper._index(params["decoder"], i)
                h = held("decoder", i, *both(
                    lambda kc, vc: whisper.dec_block_step(
                        cfg, h, bp, kc, vc, xk[i], xv[i], 8), i))
        else:
            k, n_units = mllama._pattern(cfg)
            for u in range(n_units):
                for j in range(k - 1):
                    i = u * (k - 1) + j
                    bp = mllama._index(params["self_blocks"], i)
                    h = held("self", i, *both(
                        lambda kc, vc: transformer.block_decode(
                            cfg, h, bp, kc, vc, 8, 8), i))
                bp = mllama._index(params["cross_blocks"], u)
                h = held("cross", u, *both(
                    lambda *_: mllama._cross_decode(cfg, h, bp, xk[u],
                                                    xv[u])))
    print(f"[logits] {cfg.name} bf16: each layer of the step at pos 8 on the "
          f"same input, the cross KV filled, kernel against plain path, max "
          f"err / max |output|: {worst!r} (tolerance 3e-2)")
    return worst


def cross_fp32_phase(torch, cfg, tokens) -> dict:
    """`cfg` in fp32, random weights from the same seed: the first
    DECODE_T tokens of one prompt through decode_step, with an fp32 KV
    cache and the cross KV precomputed from the same stub input, against
    forward's logits, within LOGITS_ATOL and within CROSS_FP32_RTOL of
    the largest logit."""
    from repro_torch.models.registry import get_adapter
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params = cross_params(torch, cfg32)
    extra = {n: x[:1] for n, x in cross_inputs(torch, cfg32).items()}
    tokens = tokens[:1, :DECODE_T]
    with torch.inference_mode():
        logits = get_adapter(cfg32).forward(params, {"tokens": tokens,
                                                     **extra})
    out = decode_against_forward(torch, cfg32, params, tokens,
                                 logits.float(), torch.float32,
                                 cross_kv(torch, cfg32, params, extra))
    check(out["decode_diff"] <= LOGITS_ATOL,
          f"{cfg.name} fp32 decode differs from forward by "
          f"{out['decode_diff']} (> {LOGITS_ATOL})")
    rel = out["decode_diff"] / out["max_logit"]
    check(rel <= CROSS_FP32_RTOL,
          f"{cfg.name} fp32 decode differs from forward by {rel} of the "
          f"largest logit (> {CROSS_FP32_RTOL})")
    print(f"[decode] {cfg.name} fp32: max |decode - forward| logits "
          f"{rel!r} of max |logit| (tolerance {CROSS_FP32_RTOL})")
    del params, logits
    torch.cuda.empty_cache()
    return out


def cross_phase(torch, name: str) -> dict:
    """whisper-small or llama-3.2-vision (at MLLAMA_UNITS units) in bf16,
    everything timed on the host clock or with CUDA events: its bounds;
    served with the driver's defaults (the launch counters set to 0 just
    before and read just after; the cross KV stays zero, as the reference
    driver leaves it), the same requests on the plain path; each layer of
    one step with the cross KV of the stub input against the plain path;
    the CUDA-event wall time of the step's products; whisper's encoder on
    PREFILL_B x 1500 frames; the forward (PREFILL_B x 448 tokens with the
    frames, or PREFILL_B x PREFILL_S with 1601 vision embeddings each);
    then in fp32 decode against forward."""
    from repro_torch.configs.registry_configs import ALL_ARCHS
    from repro_torch.models import whisper
    cfg = cross_cfg(name)
    if name == MLLAMA:
        full = ALL_ARCHS[name]
        k = cfg.cross_attn_every
        print(f"[depth] {name}: {full.n_layers} layers ({full.n_layers // k} "
              f"units of {k - 1} self + 1 cross) cut to {cfg.n_layers} "
              f"({MLLAMA_UNITS} units: {MLLAMA_UNITS * (k - 1)} self, "
              f"{MLLAMA_UNITS} cross) at full width (d_model {cfg.d_model}, "
              f"{cfg.n_heads} q / {cfg.n_kv_heads} KV heads of "
              f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}):"
              f" the whole model does not fit one 80 GB card in bf16")
    params = cross_params(torch, cfg)
    c = {"cfg": cfg, "bound": cross_bounds(cfg, params)}
    sv = c["serve"] = serve_phase(torch, cfg, params, per_step(cfg))
    print_serve(name, sv)
    prompts = [r.prompt for r in sorted(sv["run"].batcher.completed,
                                        key=lambda r: r.rid)]
    plain_agreement(torch, cfg, params, sv)
    extra = cross_inputs(torch, cfg)
    cross_layer_phase(torch, cfg, params, prompts,
                      cross_kv(torch, cfg, params, extra))
    c["rm_wall_ms"] = timed_ms(rowstream_work(
        torch, cross_weights(cfg, params), SLOTS)["kernel"], 5)
    seq = PREFILL_S
    if cfg.family == "audio":
        seq = cfg.max_target_positions
        with torch.inference_mode():
            whisper.encode(params, cfg, extra["frames"])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            enc = whisper.encode(params, cfg, extra["frames"])
            torch.cuda.synchronize()
            c["encode_ms"] = (time.perf_counter() - t0) * 1e3
        check(tuple(enc.shape) == tuple(extra["frames"].shape)
              and bool(enc.isfinite().all()),
              f"whisper encoder output {tuple(enc.shape)} not finite")
        print(f"[forward] {name} bf16 encoder, {PREFILL_B} x "
              f"{cfg.n_audio_frames} frames: host time {c['encode_ms']!r} ms")
        del enc
    cf = c["forward"] = forward_phase(torch, cfg, params, extra, seq)
    print_forward(name, cf)
    del params, cf["logits"]
    torch.cuda.empty_cache()
    c32 = cross_fp32_phase(torch, cfg, cf["tokens"])
    print_decode(f"{name} fp32 (fp32 cache, cross KV filled)", c32)
    return c


@contextlib.contextmanager
def whisper_attention_told_apart(whisper):
    """For a profile of whisper's forward (a measurement only): route
    ``whisper._attn`` through two module attributes made for the duration,
    ``_causal_attn`` for the decoder's causal self-attention and
    ``_full_attn`` for the rest (the encoder's self-attention and the
    decoder's cross-attention), so that :func:`labelled` can label each.
    Listed after ``encode``, ``_full_attn`` then takes the decoder's
    cross-attention alone."""
    attn = whisper._attn
    whisper._causal_attn = whisper._full_attn = attn

    def route(*args, **kwargs):
        fn = whisper._causal_attn if kwargs.get("causal") \
            else whisper._full_attn
        return fn(*args, **kwargs)

    whisper._attn = route
    try:
        yield
    finally:
        whisper._attn = attn
        del whisper._causal_attn, whisper._full_attn


def cross_profiled(torch, c: dict) -> dict:
    """The profiled parts of :func:`cross_phase`'s model, on weights made
    again from the same seed: the step's rowstream_matmul launches and
    the cross flash_decode launches at the path's shape (kernel, plain
    version, library call), the profiled split of a decode step (self and
    cross flash_decode told apart by a labelled range around the cross
    call) and of the forward, and one line per distinct product shape (the
    tied head's (768, 51968) among whisper's)."""
    from repro_torch.models import mllama, transformer, whisper
    cfg, sv, cf = c["cfg"], c["serve"], c["forward"]
    audio = cfg.family == "audio"
    mod = whisper if audio else mllama
    params = cross_params(torch, cfg)
    name = f"rowstream_matmul on {cfg.name}"
    works = {name: rowstream_work(torch, cross_weights(cfg, params), SLOTS)}
    works[name].update(per=f"one {cfg.name} decode step at {SLOTS} slots",
                       wall_ms=c["rm_wall_ms"])
    k, n_cross = (1, cfg.n_layers) if audio else mllama._pattern(cfg)
    S = cfg.n_audio_frames if audio else cfg.n_vision_tokens
    works[f"cross flash_decode on {cfg.name}"] = flash_work(
        torch, dataclasses.replace(cfg, n_layers=n_cross), SLOTS, S)
    time_works(works)
    cross = (mod, "cross_decode_attention", "cross flash_decode")
    bd = step_breakdown(torch, cfg, params,
                        per_step(cfg)["rowstream_matmul"], labels=[cross],
                        claims=("cross_decode_attention",))
    check(bd["claimed"] == {"cross flash_decode": n_cross},
          f"{cfg.name} step: {bd['claimed']} flash_decode kernels a step "
          f"inside the cross-attention's range, expected {n_cross}")
    print_breakdown(cfg.name, bd, sv["median_step_ms"],
                    flash="self flash_decode")
    b = c["bound"]
    print(f"[bound] {cfg.name} decode step, {b['step_bytes']} bytes: bound "
          f"{b['step_ms']!r} ms, device time {bd['device_ms']!r} ms at "
          f"{b['step_ms'] / bd['device_ms']!r} of it")
    if audio:
        labels = [(whisper, "encode", "encoder"),
                  (whisper, "_full_attn", "cross-attention"),
                  (whisper, "_causal_attn", "decoder self-attention")]
        with whisper_attention_told_apart(whisper):
            fb = forward_breakdown(torch, cfg, params, cf["batch"],
                                   labels=labels)
    else:
        fb = forward_breakdown(torch, cfg, params, cf["batch"], labels=[
            (mllama, "cross_attention", "cross-attention"),
            (transformer, "self_attention", "self-attention")])
    print_split(f"{cfg.name} forward", fb, cf["forward_ms"])
    print(f"[bound] {cfg.name} forward: bound {b['forward_ms']!r} ms, device "
          f"time {fb['device']!r} ms at {b['forward_ms'] / fb['device']!r} "
          f"of it")
    shapes = list(dict.fromkeys(tuple(w.shape)
                                for w in cross_weights(cfg, params)))
    del params
    torch.cuda.empty_cache()
    return {"works": {n: numbers(w) for n, w in works.items()},
            "products": rowstream_products(torch, shapes),
            "step": bd, "forward": fb}


# --- serving on a mesh ---------------------------------------------------------
# The two-rank check: qwen2-7b on a 1 x MESH_RANKS mesh whose ranks share
# the one card over gloo (NCCL puts no two ranks on one device), each rank
# holding its share of every weight split over ``model`` and its slots of
# the KV cache. MESH_STEPS decode steps are fed the tokens of the meshless
# run's greedy steps: in fp32 at full width cut to MESH_FP32_LAYERS layers
# and in bf16 whole, each held against the meshless run at LOGITS_ATOL;
# then the rank serves the driver's requests. MESH_TIMEOUT_S bounds the
# ranks' run; they are killed past it.
MESH_RANKS = 2
MESH_FP32_LAYERS = 4
MESH_STEPS = 8
MESH_TIMEOUT_S = 600


def fed_logits(torch, ad, params, tokens, cache_dtype=None, mesh=None,
               cross=None):
    """Logits (steps, b, V) in fp32 of decode steps fed tokens[t] (b, 1) at
    pos t from a fresh state, its cache in `cache_dtype` where given, on
    `mesh` where given (`params` then this rank's shards, and the logits
    its rows of the b); its cross KV set to `cross` (xk, xv: this rank's
    shards of it on a mesh) where given."""
    from repro_torch.distributed.sharding import batch_rows, local
    kw = {} if cache_dtype is None else {"dtype": cache_dtype}
    state = ad.init_decode_state(tokens.shape[1], MAX_SEQ, device="cuda",
                                 mesh=mesh, **kw)
    if cross is not None:
        local(state["xk"]).copy_(cross[0])
        local(state["xv"]).copy_(cross[1])
    r0, r1 = batch_rows(tokens.shape[1], mesh)
    out = []
    with torch.inference_mode():
        for pos in range(tokens.shape[0]):
            lg, state = ad.decode(params, {"tokens": tokens[pos][r0:r1]},
                                  state, pos, mesh)
            out.append(lg[:, 0].float())
    return torch.stack(out)


def mesh_serve_phase(torch, cfg, params, sv: dict) -> dict:
    """`cfg` served again on a 1x1 mesh (a one-rank NCCL group, destroyed
    after), its parameters placed as the driver places them, then once
    more without a mesh: the mesh's tokens equal the meshless runs' bit for
    bit at the same launches per step."""
    from repro_torch.launch.mesh import make_mesh, process_group_scope
    from repro_torch.launch.serve import place_params
    from repro_torch.models.registry import get_adapter
    with process_group_scope():
        mesh = make_mesh((1, 1), ("data", "model"), "cuda")
        placed = place_params(get_adapter(cfg), params, mesh, 1)
        one = serve_phase(torch, cfg, placed, per_step(cfg), mesh=mesh)
    del placed
    again = serve_phase(torch, cfg, params, per_step(cfg))
    check(one["tokens"] == sv["tokens"] == again["tokens"]
          and one["counts"] == sv["counts"] == again["counts"],
          f"{cfg.name} on a 1x1 mesh: tokens or launches differ from the "
          f"meshless serve ({one['counts']} against {sv['counts']})")
    print(f"[mesh] {cfg.name} bf16 on a 1x1 mesh: {one['steps']} steps, "
          f"the meshless run's tokens bit for bit at its launches "
          f"{one['counts']}; step median {one['median_step_ms']!r} ms "
          f"against the meshless {sv['median_step_ms']!r} before and "
          f"{again['median_step_ms']!r} after (mean {one['mean_step_ms']!r}"
          f", {sv['mean_step_ms']!r}, {again['mean_step_ms']!r})")
    return {"mesh_1x1": one, "meshless_again": again}


def mesh_reference(torch, cfg, params, prompts) -> dict:
    """What the two-rank check holds its ranks against: MESH_STEPS greedy
    steps of `cfg` from the first token of each of the first SLOTS
    prompts on the kernel path (a bf16 cache), the tokens fed at each step
    and the logits; then the same tokens through `cfg` in fp32 cut to
    MESH_FP32_LAYERS layers (weights from the same seed, an fp32 cache)."""
    from repro_torch.launch.serve import greedy_sample
    from repro_torch.models.registry import get_adapter
    ad = get_adapter(cfg)
    state = ad.init_decode_state(SLOTS, MAX_SEQ, device="cuda")
    tok = torch.tensor([[t[0]] for t in prompts[:SLOTS]], dtype=torch.int32,
                       device="cuda")
    toks, lgs = [], []
    with torch.inference_mode():
        for pos in range(MESH_STEPS):
            toks.append(tok)
            lg, state = ad.decode(params, {"tokens": tok}, state, pos)
            lgs.append(lg[:, 0].float())
            tok = greedy_sample(lg)[:, None]
    tokens = torch.stack(toks)
    cfg32 = dataclasses.replace(cfg, dtype="float32",
                                n_layers=MESH_FP32_LAYERS)
    p32 = init_params(torch, cfg32)
    lg32 = fed_logits(torch, get_adapter(cfg32), p32, tokens, torch.float32)
    del p32
    torch.cuda.empty_cache()
    return {"tokens": tokens.cpu(), "bfloat16": torch.stack(lgs).cpu(),
            "float32": lg32.cpu()}


def _mesh_rank(rank: int, world: int, store: str, tmp: str) -> None:
    """One rank of the two-rank check (a spawned process): a gloo group
    through a FileStore, the run, its results saved for the parent."""
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        out = mesh_rank_run(torch, Path(tmp))
        torch.save(out, Path(tmp) / f"mesh_out_{rank}.pt")
    finally:
        dist.destroy_process_group()


def mesh_rank_run(torch, tmp: Path) -> dict:
    """This rank's part of the two-rank check: qwen2-7b in fp32 cut to
    MESH_FP32_LAYERS layers and in bf16 whole, each from init(tp) on the
    seed and placed by the serve driver's ``place_params``, fed the
    reference's tokens; then the bf16 model serves the driver's requests
    on the mesh. Launches are counted on this rank."""
    from repro_torch.configs.registry_configs import ALL_ARCHS
    from repro_torch.kernels import launch_counters, reset_launch_counters
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import place_params
    from repro_torch.models.registry import get_adapter
    ref = torch.load(tmp / "mesh_ref.pt")
    mesh = make_mesh((1, MESH_RANKS), ("data", "model"), "cuda")
    tokens = ref["tokens"].to("cuda")
    qcfg = ALL_ARCHS["qwen2-7b"]
    out = {}
    for cfg, cache_dtype in ((dataclasses.replace(
            qcfg, dtype="float32", n_layers=MESH_FP32_LAYERS),
            torch.float32), (qcfg, None)):
        ad = get_adapter(cfg)
        params = None     # the previous model's shards, freed first
        torch.cuda.empty_cache()
        params = place_params(ad, ad.init(torch.Generator(
            device="cuda").manual_seed(SEED), tp=MESH_RANKS), mesh,
            MESH_RANKS)
        torch.cuda.empty_cache()
        reset_launch_counters()
        lg = fed_logits(torch, ad, params, tokens, cache_dtype, mesh)
        out[cfg.dtype] = {
            "logits": lg.cpu(),
            "counts": {n: c.count for n, c in launch_counters().items()},
            "weight_bytes": sum(t.numel() * t.element_size()
                                for t in _tensors(params))}
    sv = serve_phase(torch, qcfg, params, {"rowstream_matmul": per_step(
        qcfg)["rowstream_matmul"]}, mesh=mesh)
    out["serve"] = {k: sv[k] for k in (
        "counts", "steps", "tokens", "generated", "tokens_per_s",
        "median_step_ms", "mean_step_ms", "first_step_ms")}
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    return out


def _spawned(fn, tmp: Path, timeout_s: int, what: str, ranks: int):
    """Run `fn` on `ranks` spawned processes (rank, world, store, tmp),
    killed past `timeout_s`; the seconds from spawn to join."""
    import torch.multiprocessing as mp
    t0 = time.perf_counter()
    ctx = mp.start_processes(fn, args=(ranks, str(tmp / "store"), str(tmp)),
                             nprocs=ranks, start_method="spawn", join=False)
    deadline = time.monotonic() + timeout_s
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.kill()
                proc.join()
            raise SmokeFailure(f"the {ranks} {what} ranks ran past "
                               f"{timeout_s} s and were killed")
    return time.perf_counter() - t0


def two_rank_phase(torch, ref: dict, sv: dict) -> dict:
    """Spawn MESH_RANKS ranks on the card (:func:`_mesh_rank`), wait for
    them within MESH_TIMEOUT_S, and hold their logits against `ref`'s
    (:func:`mesh_reference`) at LOGITS_ATOL, fp32 and bf16; count the
    served greedy tokens that differ from the meshless serve `sv`'s."""
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_mesh_"))
    try:
        torch.save(ref, tmp / "mesh_ref.pt")
        torch.cuda.empty_cache()
        seconds = _spawned(_mesh_rank, tmp, MESH_TIMEOUT_S, "mesh",
                           MESH_RANKS)
        outs = [torch.load(tmp / f"mesh_out_{r}.pt")
                for r in range(MESH_RANKS)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    res = {"seconds": seconds, "peak_bytes": [o["peak_bytes"] for o in outs]}
    for dt in ("float32", "bfloat16"):
        got, want = outs[0][dt]["logits"], ref[dt]
        check(all(torch.equal(o[dt]["logits"], got) for o in outs),
              f"mesh ranks return different {dt} logits")
        diff = (got - want).abs().max().item()
        scale = want.abs().max().item()
        agree = int((got.argmax(-1) == want.argmax(-1)).sum().item())
        check(tuple(got.shape) == tuple(want.shape)
              and bool(got.isfinite().all()) and diff <= LOGITS_ATOL,
              f"qwen2-7b {dt} on 1x{MESH_RANKS}: logits differ from the "
              f"meshless run by {diff} (> {LOGITS_ATOL})")
        res[dt] = {"max_diff": diff, "max_logit": scale,
                   "argmax_agree": agree, "positions": got.shape[0]
                   * got.shape[1],
                   "counts": [o[dt]["counts"] for o in outs],
                   "weight_bytes": [o[dt]["weight_bytes"] for o in outs]}
        print(f"[mesh] qwen2-7b {dt} on a 1x{MESH_RANKS} mesh sharing the "
              f"card (gloo), {MESH_STEPS} fed steps: max |mesh - meshless| "
              f"logits {diff!r} (tolerance {LOGITS_ATOL}; max |logit| "
              f"{scale!r}), argmax agrees at {agree}/{res[dt]['positions']};"
              f" launches by rank {res[dt]['counts']}; weight bytes by rank "
              f"{res[dt]['weight_bytes']}")
    served = outs[0]["serve"]
    check(all(o["serve"]["tokens"] == served["tokens"] for o in outs),
          "mesh ranks recorded different tokens")
    differ = sum(a != b for rid, toks in sv["tokens"].items()
                 for a, b in zip(toks, served["tokens"][rid]))
    res["serve"] = dict(served, tokens_differ=differ,
                        tokens_total=sum(map(len, sv["tokens"].values())),
                        counts=[o["serve"]["counts"] for o in outs])
    del res["serve"]["tokens"]
    print(f"[mesh] qwen2-7b bf16 served on a 1x{MESH_RANKS} mesh sharing "
          f"the card: {served['steps']} steps, {differ} of "
          f"{res['serve']['tokens_total']} greedy tokens differ from the "
          f"meshless serve; step median {served['median_step_ms']!r} ms, "
          f"mean {served['mean_step_ms']!r} ms (two ranks on one card, "
          f"collectives staged through the host: a correctness run, not a "
          f"speed); launches by rank {res['serve']['counts']}; peak bytes "
          f"by rank {res['peak_bytes']}; {seconds:.1f} s from spawn to "
          f"join")
    return res


def mesh_phases(torch, cfg, params, sv: dict, prompts) -> tuple:
    """The 1x1-mesh serve and the reference of the two-rank check, both
    on `params`, which the caller frees before :func:`two_rank_phase`."""
    one = mesh_serve_phase(torch, cfg, params, sv)
    return one, mesh_reference(torch, cfg, params, prompts)


# The tensor-parallel training check (``--only train_tp``, and in the full
# run): TP_RANKS ranks spawned on the one card over gloo (NCCL puts no two
# ranks on one device; the collectives stage CUDA tensors through the
# host), a 1xTP_RANKS mesh on which each rank computes on its model
# shards. First one fp32 step of rwkv6-3b at full width cut to
# TRAIN_CHECK_LAYERS layers, and of qwen2-7b cut to TP_DENSE_LAYERS,
# against the single-process step on the card: the loss within
# TP_LOSS_RTOL relative (the loss tolerance of tests/test_torch_train.py)
# and each gradient leaf within TRAIN_GRAD_TOL norm-wise (the rule of the
# single-process fp32 step check, train_fp32_check). The CPU tests'
# gradient rule, max |diff| within TP_REPORTED_GRAD_TOL of the leaf's
# largest, is printed but not held: at full width fp32 rounding alone
# moves some leaves by more (rwkv6-3b: up to 1.3e-4 here, and 1.4e-4
# between the single-process step's kernel and plain paths;
# scripts/train_tp_diagnostics.py), while a fault of the split (a sum
# missed or made twice, a wrong slice) is off by O(1). Then rwkv6-3b in
# bf16 at full width and depth for TP_STEPS steps of the driver's
# defaults: finite losses, the 1x1 step's launch counts on every rank and
# step, each on TP_RANKS-th of the heads (20 of 40). Each rank keeps the
# inputs of its first TP_RECORDED rwkv_scan and rwkv_scan_bwd launches:
# rank 0's are held against the plain versions and timed, and both ranks'
# joined along the heads give the single-process launches, timed beside
# them.
TP_RANKS = 2
TP_STEPS = 3
# The dense family's fp32 check beside rwkv6-3b's: qwen2-7b at full width
# cut to this many layers (its 28 query and 4 KV heads, d_ff and padded
# vocab all split over 2).
TP_DENSE_ARCH, TP_DENSE_LAYERS = "qwen2-7b", 2
TP_LOSS_RTOL = 1e-5
TP_REPORTED_GRAD_TOL = 1e-4
TP_RECORDED = 4
TP_TIMEOUT_S = 600


def _tp_rank(rank: int, world: int, store: str, tmp: str) -> None:
    """One rank of the tensor-parallel training check (a spawned process):
    a gloo group through a FileStore, the run, its results saved for the
    parent."""
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        out = tp_rank_run(torch, rank)
        torch.save(out, Path(tmp) / f"tp_out_{rank}.pt")
    finally:
        dist.destroy_process_group()


def train_cfg():
    from repro_torch.configs.registry_configs import ALL_ARCHS
    return ALL_ARCHS[TRAIN_ARCH]


def _tp_batch(torch, cfg, step: int) -> dict:
    from repro_torch.data.pipeline import make_pipeline
    return {k: torch.from_numpy(v).cuda() for k, v in make_pipeline(
        cfg.vocab, TRAIN_SEQ, TRAIN_BATCH, seed=SEED).batch_at(step).items()}


def tp_fp32_check(torch, mesh, cfg) -> dict:
    """`cfg` (fp32, full width, its depth cut), parameters from SEED: the
    first step's loss and fp32 mean gradient on this rank's model shards
    (the driver's loss, remat on) against the single-process step this
    rank computes on the whole parameters. Per
    leaf, over this rank's part of it: the largest |difference| and the
    whole leaf's largest |gradient|, and the sums of squares of the
    difference and of the single-process gradient (the caller adds them
    over the ranks where the leaf is split)."""
    from repro_torch.distributed import sharding
    from repro_torch.models.registry import get_adapter
    from repro_torch.train.optimizer import _leaves
    from repro_torch.train.train_step import accumulate
    ad = get_adapter(cfg)
    params = ad.init(torch.Generator(device="cuda").manual_seed(SEED),
                     tp=TP_RANKS)
    batch = _tp_batch(torch, cfg, 0)

    def loss_fn(p, b, mesh=None):
        return ad.loss(p, b, remat=True, mesh=mesh)

    loss_ref, grads_ref = accumulate(loss_fn, params, batch, TRAIN_MICRO)
    specs = ad.param_specs("data", TP_RANKS)
    placed = sharding.constrain_like(params, specs, mesh)
    del params
    check(ad.supports_train_tp(TP_RANKS),
          f"{cfg.name} does not compute on model shards on 1x{TP_RANKS}")
    loss, grads = accumulate(loss_fn, placed, batch, TRAIN_MICRO,
                             shards=True)
    leaves = {}
    for (path, g), (_, ref), (_, p) in zip(_leaves(grads),
                                          _leaves(grads_ref),
                                          _leaves(placed)):
        want = sharding.local_shard(ref, mesh, p.placements)
        diff = sharding.local(g) - want
        leaves["/".join(path)] = (
            diff.abs().max().item(), ref.abs().max().item(),
            diff.square().sum().item(), want.square().sum().item(),
            any(isinstance(q, sharding.Shard) for q in p.placements))
    return {"arch": cfg.name, "layers": cfg.n_layers, "loss": float(loss),
            "single_loss": float(loss_ref), "leaves": leaves}


def tp_fp32_cfgs() -> list:
    """The configs of the fp32 checks: rwkv6-3b cut to TRAIN_CHECK_LAYERS
    layers, qwen2-7b to TP_DENSE_LAYERS."""
    from repro_torch.configs.registry_configs import ALL_ARCHS
    return [dataclasses.replace(ALL_ARCHS[name], dtype="float32",
                                n_layers=layers)
            for name, layers in ((TRAIN_ARCH, TRAIN_CHECK_LAYERS),
                                 (TP_DENSE_ARCH, TP_DENSE_LAYERS))]


def tp_fp32_verdict(parts: list) -> dict:
    """Check and print one fp32 check from the ranks' :func:`tp_fp32_check`
    parts: the losses equal over the ranks and within TP_LOSS_RTOL of the
    single-process loss; each leaf's ||diff|| over ||gradient|| (a split
    leaf's sums added over the ranks, a replicated leaf's from rank 0)
    within TRAIN_GRAD_TOL; max |diff| over the leaf's largest |gradient|
    reported."""
    f = parts[0]
    errs = {}
    for path, first in f["leaves"].items():
        rows = [p["leaves"][path] for p in parts] if first[4] else [first]
        errs[path] = (max(r[0] for r in rows) / first[1],
                      math.sqrt(sum(r[2] for r in rows)
                                / sum(r[3] for r in rows)))
    loss_err = abs(f["loss"] - f["single_loss"]) / abs(f["single_loss"])
    worst_max = max(errs, key=lambda k: errs[k][0])
    worst_norm = max(errs, key=lambda k: errs[k][1])
    out = {"arch": f["arch"], "layers": f["layers"], "loss": f["loss"],
           "single_loss": f["single_loss"], "loss_rel_err": loss_err,
           "worst_norm_err": errs[worst_norm][1],
           "worst_norm_leaf": worst_norm,
           "worst_max_err": errs[worst_max][0], "worst_max_leaf": worst_max,
           "max_over_reported_tol": sorted(
               k for k, e in errs.items() if e[0] > TP_REPORTED_GRAD_TOL)}
    check(all(p["loss"] == f["loss"] for p in parts)
          and loss_err <= TP_LOSS_RTOL
          and all(e[1] <= TRAIN_GRAD_TOL for e in errs.values()),
          f"{f['arch']} fp32 step on 1x{TP_RANKS} against the single-"
          f"process step: losses {[p['loss'] for p in parts]} against "
          f"{f['single_loss']}; per leaf (max, norm-wise) errors {errs}")
    print(f"[depth] {f['arch']} tensor-parallel fp32 check: cut to "
          f"{f['layers']} layers at full width")
    print(f"[train_tp] {f['arch']} on 1x{TP_RANKS}, fp32 at {f['layers']} "
          f"layers, the first step on model shards against the single-"
          f"process step: loss {out['loss']!r} against "
          f"{out['single_loss']!r} (rel err {loss_err!r}, tolerance "
          f"{TP_LOSS_RTOL}); largest per-leaf ||grad - single|| / "
          f"||single|| {out['worst_norm_err']!r} ({worst_norm}, tolerance "
          f"{TRAIN_GRAD_TOL}); reported only: largest max |grad - single| "
          f"/ max |single| {out['worst_max_err']!r} ({worst_max}); leaves "
          f"past {TP_REPORTED_GRAD_TOL} by that measure: "
          f"{out['max_over_reported_tol']}")
    return out


def tp_rank_run(torch, rank: int) -> dict:
    """This rank's part of the tensor-parallel training check (see
    TP_RANKS): the fp32 checks (:func:`tp_fp32_cfgs`), then TP_STEPS
    bf16 steps of the driver's step on a 1xTP_RANKS mesh, the launch
    counters set to 0 just before each step and read just after, the head
    count of every rwkv_scan and rwkv_scan_bwd launch recorded, and the
    inputs of the first TP_RECORDED of each kept (on the host)."""
    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.kernels import launch_counters, reset_launch_counters
    from repro_torch.kernels.rwkv_scan import kernel
    from repro_torch.launch import train as port_train
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.registry import get_adapter, train_tp_path
    mesh = make_mesh((1, TP_RANKS), ("data", "model"), "cuda")
    out = {"fp32": []}
    for cfg in tp_fp32_cfgs():
        out["fp32"].append(tp_fp32_check(torch, mesh, cfg))
        torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = train_cfg()
    ad = get_adapter(cfg)
    out["path"] = train_tp_path(cfg, TP_RANKS)
    step = port_train.make_step(ad, mesh, TP_RANKS, TRAIN_MICRO, TRAIN_LR)
    seen = []
    loss = ad.loss

    def seen_loss(params, batch, remat=False, mesh=None):
        seen.append(sum(t.numel() * t.element_size()
                        for t in _tensors(params)))
        return loss(params, batch, remat, mesh)

    ad.loss = seen_loss
    heads = {"rwkv_scan": [], "rwkv_scan_bwd": []}
    kept = {"rwkv_scan": [], "rwkv_scan_bwd": []}
    fns = {"rwkv_scan": kernel.rwkv_scan,
           "rwkv_scan_bwd": kernel.rwkv_scan_bwd}

    def recording(name):
        def fn(*args):
            heads[name].append(args[0].shape[2])
            if len(kept[name]) < TP_RECORDED:
                # the forward's r, k, v, w, u (not its chunk); the
                # backward's r, k, v, w, u, do, dS (None: no final-state
                # gradient in training)
                kept[name].append(tuple(
                    a.cpu() if a is not None else None
                    for a in args[:5 if name == "rwkv_scan" else 7]))
            return fns[name](*args)
        return fn

    kernel.rwkv_scan = recording("rwkv_scan")
    kernel.rwkv_scan_bwd = recording("rwkv_scan_bwd")
    counts, losses, step_ms = [], [], []
    try:
        with use_mesh(mesh):
            state = port_train.init_state(ad, mesh, TP_RANKS, SEED, "cuda")
            whole = sum(p.numel() * p.element_size()
                        for p in _tensors(state.params))
            for i in range(TP_STEPS):
                batch = _tp_batch(torch, cfg, i)
                torch.cuda.synchronize()
                reset_launch_counters()
                t0 = time.perf_counter()
                state, metrics = step(state, batch)
                losses.append(float(metrics["loss"]))
                step_ms.append((time.perf_counter() - t0) * 1e3)
                counts.append({n: c.count
                               for n, c in launch_counters().items()})
    finally:
        kernel.rwkv_scan = fns["rwkv_scan"]
        kernel.rwkv_scan_bwd = fns["rwkv_scan_bwd"]
        ad.loss = loss
    out.update(losses=losses, step_ms=step_ms, counts=counts, heads=heads,
               kept=kept, seen_bytes=seen, whole_bytes=whole,
               peak_bytes=torch.cuda.max_memory_allocated())
    return out


def train_tp_phase(torch) -> dict:
    """Spawn TP_RANKS ranks on the card (:func:`_tp_rank`), wait for them
    within TP_TIMEOUT_S, and check what they return: each fp32 step
    against the single-process one (:func:`tp_fp32_verdict`); the bf16
    steps' finite losses, equal on every rank, at the 1x1 step's launches
    on TP_RANKS-th of the heads."""
    cfg = train_cfg()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_tp_"))
    try:
        torch.cuda.empty_cache()
        seconds = _spawned(_tp_rank, tmp, TP_TIMEOUT_S, "training",
                           TP_RANKS)
        outs = [torch.load(tmp / f"tp_out_{r}.pt", weights_only=False)
                for r in range(TP_RANKS)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    H = cfg.d_model // 64
    per_step = train_counts(cfg.n_layers)
    fp32 = [tp_fp32_verdict([o["fp32"][i] for o in outs])
            for i in range(len(outs[0]["fp32"]))]
    for r, o in enumerate(outs):
        check(o["path"][0], f"rank {r}: {o['path'][1]}")
        check(all(math.isfinite(x) for x in o["losses"])
              and o["losses"] == outs[0]["losses"],
              f"rank {r}: bf16 losses {o['losses']} (rank 0: "
              f"{outs[0]['losses']})")
        check(all(c == per_step for c in o["counts"]),
              f"rank {r}: launches by step {o['counts']}, expected "
              f"{per_step} a step")
        check(all(set(h) == {H // TP_RANKS} for h in o["heads"].values()),
              f"rank {r}: heads of the scan launches "
              f"{ {n: sorted(set(h)) for n, h in o['heads'].items()} }")
    res = {"seconds": seconds, "ranks": TP_RANKS, "layers": cfg.n_layers,
           "heads_per_rank": H // TP_RANKS, "path": outs[0]["path"][1],
           "losses": outs[0]["losses"], "fp32": fp32,
           "counts": [o["counts"] for o in outs],
           "per_step": per_step,
           "step_ms": [o["step_ms"] for o in outs],
           "seen_bytes": [o["seen_bytes"][0] for o in outs],
           "whole_bytes": outs[0]["whole_bytes"],
           "peak_bytes": [o["peak_bytes"] for o in outs],
           "kept": [o["kept"] for o in outs]}
    print(f"[train_tp] {res['path']}")
    for r in range(TP_RANKS):
        print(f"[train_tp] rank {r}: bf16 full width and depth, "
              f"{TP_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} tokens in "
              f"{TRAIN_MICRO} microbatches: losses {res['losses']!r}; "
              f"launches a step {res['counts'][r][0]} on "
              f"{res['heads_per_rank']} of {H} heads each; parameter bytes "
              f"the forward saw {res['seen_bytes'][r]} of "
              f"{res['whole_bytes']}; peak memory {res['peak_bytes'][r]} "
              f"bytes; step ms {res['step_ms'][r]!r} (two ranks sharing "
              f"one card over host-staged gloo: a correctness run, not a "
              f"speed)")
    print(f"[train_tp] {seconds:.1f} s from spawn to join")
    return res


def train_tp_kernels(torch, res: dict) -> dict:
    """The recorded rwkv_scan and rwkv_scan_bwd launches of the
    tensor-parallel run (taken out of `res`): rank 0's (20 heads) held
    against the plain versions by check_rwkv_scan's and
    check_rwkv_scan_bwd's rules and timed (kernel, wall, plain, bound);
    the ranks' launches joined along the heads (40, the single-process
    launches of the same layers) timed beside them, kernel only."""
    from repro_torch.kernels.rwkv_scan import kernel
    from repro_torch.kernels.rwkv_scan.ref import rwkv_scan_bwd_ref
    kept = res.pop("kept")
    dev = [{n: [tuple(a.cuda() if a is not None else None for a in x)
                for x in ls] for n, ls in k.items()} for k in kept]
    fwd, bwd = dev[0]["rwkv_scan"], dev[0]["rwkv_scan_bwd"]
    worst = {"rwkv_scan": 0.0, "rwkv_scan_bwd": 0.0}
    for x in fwd:
        o, S = kernel.rwkv_scan(*x)
        torch.cuda.synchronize()
        dt = "bfloat16" if x[0].dtype == torch.bfloat16 else "float32"
        ok, err_o, err_s = scan_verdict(torch, x, o, S, "model", dt)
        check(ok, f"rwkv_scan at {tuple(x[0].shape)} {dt} (a rank's "
                  f"heads): max err o {err_o}, S {err_s}")
        worst["rwkv_scan"] = max(worst["rwkv_scan"], err_o, err_s)
    for x in bwd:
        got = kernel.rwkv_scan_bwd(*x)
        torch.cuda.synchronize()
        dt = "bfloat16" if x[0].dtype == torch.bfloat16 else "float32"
        ok, errs = scan_bwd_verdict(torch, x[:5], got,
                                    rwkv_scan_bwd_ref(*x), "model", dt)
        check(ok, f"rwkv_scan_bwd at {tuple(x[0].shape)} {dt} (a rank's "
                  f"heads): max err dr dk dv dw du {errs}")
        worst["rwkv_scan_bwd"] = max(worst["rwkv_scan_bwd"], *errs)
    print(f"[kernels] rwkv_scan and rwkv_scan_bwd on a rank's "
          f"{fwd[0][0].shape[2]} heads: {len(fwd)} and {len(bwd)} recorded "
          f"launches of the 1x{TP_RANKS} run agree with the plain versions "
          f"(check_rwkv_scan's and check_rwkv_scan_bwd's rules); max abs "
          f"err {worst}")

    def joined(name):
        out = []
        for parts in zip(*(d[name] for d in dev)):
            out.append(tuple(
                None if parts[0][i] is None else torch.cat(
                    [p[i] for p in parts], 0 if parts[0][i].dim() == 2
                    else 2).contiguous()
                for i in range(len(parts[0]))))
        return out

    per = (f"{{}} of the recorded launches of one microbatch of the "
           f"1x{TP_RANKS} run at b {TRAIN_BATCH // TRAIN_MICRO} x s "
           f"{TRAIN_SEQ}, {{}} heads")
    H = fwd[0][0].shape[2]
    works = {"rwkv_scan on a rank's heads": scan_work(torch, fwd),
             "rwkv_scan_bwd on a rank's heads": scan_bwd_work(torch, bwd),
             "rwkv_scan on all heads": scan_work(torch, joined("rwkv_scan")),
             "rwkv_scan_bwd on all heads": scan_bwd_work(
                 torch, joined("rwkv_scan_bwd"))}
    for name, w in works.items():
        w["per"] = per.format(len(fwd) if "bwd" not in name else len(bwd),
                              H if "rank" in name else H * TP_RANKS)
        if "all heads" in name:
            w["plain"] = None
            w.pop("plain_one", None)
    time_works(works)
    return {"max_abs_err": worst,
            "works": {n: numbers(w) for n, w in works.items()}}


# The MoE family and rwkv6 on model shards (``--only moe_tp``, and in the
# full run): MOE_TP_RANKS ranks spawned on the one card over gloo, as the
# two-rank checks above. The parent serves each model without a mesh
# (granite-moe-3b also on a 1x1 mesh, which must give the meshless tokens
# at the meshless launches) and keeps MESH_STEPS greedy steps of it: the
# tokens fed, the logits in bf16 and in fp32 at a cut depth
# (MOE_TP_FP32_LAYERS), each MoE layer's routing and dropped assignments.
# The ranks then run the same steps on their shards: granite-moe-3b at
# full width and depth on 1x2 (20 of 40 experts a rank), phi3.5-moe at
# full width cut to PHI_LAYERS layers on 2x1 (each rank its 2 of the 4
# rows, the routing groups spanning both) and on 1x2 (8 of 16 experts a
# rank), rwkv6-3b on 1x2 (20 of 40 heads a rank); each bf16 model then
# serves the driver's requests on 1x2. fp32 logits are held at
# LOGITS_ATOL against the meshless run's, on 2x1 also the dropped
# assignments of each step; the ranks of a model axis must choose the
# same experts for every token (their disagreements are counted and must
# be 0), and the decisions that differ from the meshless run's are
# counted and printed. Then granite-moe-3b's train step on 1x2: fp32 at
# MOE_TRAIN_FP32_LAYERS layers against the single-process step
# (tp_fp32_check's rules), and bf16 for TP_STEPS steps. MOE_TP_TIMEOUT_S
# bounds the ranks' run.
MOE_TP_RANKS = 2
PHI_LAYERS = 8
MOE_TP_FP32_LAYERS = {GRANITE: 4, PHI: 2, "rwkv6-3b": 4}
# Fed steps a model. At the driver's 4 slots granite's capacity (8, its
# top_k) never binds, phi3.5-moe's (2) does when 3 of the 4 tokens pick one
# of its 16 experts: about once in 13 (step, layer)s of its bf16 run on
# the H100, so its fp32 run at 2 layers takes 32 steps.
MOE_TP_STEPS = {GRANITE: MESH_STEPS, PHI: 32, "rwkv6-3b": MESH_STEPS}
# The full run keeps the fed steps on 1x2 but serves none of the three
# models there (granite's serve took 35 s of a full run on the H100);
# `--only moe_tp` serves all three.
FULL_RUN_MOE_TP_SERVES = ()
MOE_TRAIN_FP32_LAYERS = 4
# The full run cuts the bf16 training steps' depth to this many layers;
# `--only moe_tp` trains all 32.
FULL_RUN_MOE_TRAIN_LAYERS = 8
MOE_TP_TIMEOUT_S = 900


@contextlib.contextmanager
def recorded_route(calls: list):
    """Append, for every MoE layer's ``moe.route`` call, the experts chosen
    for this process's own tokens (one row a token) and the assignments of
    those tokens that capacity drops."""
    from repro_torch.models import moe

    route = moe.route

    def record(*args, **kwargs):
        r = route(*args, **kwargs)
        idx = r.gate_idx.reshape(-1, r.gate_idx.shape[-1])
        if r.own is not None:
            idx = idx[r.own.reshape(-1)]
        calls.append((idx.cpu(), moe.dropped(r)))
        return r

    moe.route = record
    try:
        yield
    finally:
        moe.route = route


@contextlib.contextmanager
def recorded_attention(calls: dict):
    """Count, in `calls`, each call that ``layers`` makes of flash_decode
    and flash_decode_partial, by entry and the slots of the cache or
    shard it was given ("flash_decode_partial over 750 slots"). A call of
    the partial entry on a shard with no valid slot is counted here but
    launches nothing."""
    from repro_torch.models import layers
    saved = {name: getattr(layers, name)
             for name in ("flash_decode", "flash_decode_partial")}

    def wrap(name, fn):
        def call(q, k, *args):
            key = f"{name} over {k.shape[2]} slots"
            calls[key] = calls.get(key, 0) + 1
            return fn(q, k, *args)
        return call

    for name, fn in saved.items():
        setattr(layers, name, wrap(name, fn))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(layers, name, fn)


def decisions_differ(a: list, b: list) -> int:
    """(token, layer) routing decisions that differ between two runs'
    recorded_route calls: tokens whose set of experts differs."""
    return sum(int((x.sort(-1).values != y.sort(-1).values).any(-1).sum())
               for (x, _), (y, _) in zip(a, b))


def drops_by_step(calls: list, layers: int) -> list:
    """Dropped assignments of each decode step (`layers` calls a step)."""
    d = [n for _, n in calls]
    return [sum(d[i:i + layers]) for i in range(0, len(d), layers)]


def tp_reference(torch, cfg, params, prompts, fp32_layers: int,
                 steps: int, cross: bool = False) -> dict:
    """What the MoE / rwkv6 ranks are held against: `steps` greedy
    steps of `cfg` (bf16) from the first token of each of the first SLOTS
    prompts, their tokens, logits and MoE routing; then the same tokens
    through `cfg` in fp32 cut to `fp32_layers` layers (weights from the
    same seed, an fp32 cache), its logits and routing. With `cross`
    (whisper, mllama) the weights are :func:`cross_params` and each
    state's cross KV is filled from the stub input
    (:func:`meshless_cross_kv`)."""
    from repro_torch.launch.serve import greedy_sample
    from repro_torch.models.registry import get_adapter
    ad = get_adapter(cfg)
    state = filled_state(ad, SLOTS, MAX_SEQ, meshless_cross_kv(
        torch, cfg, params) if cross else None)
    tok = torch.tensor([[t[0]] for t in prompts[:SLOTS]], dtype=torch.int32,
                       device="cuda")
    toks, lgs, route16, route32 = [], [], [], []
    with torch.inference_mode(), recorded_route(route16):
        for pos in range(steps):
            toks.append(tok)
            lg, state = ad.decode(params, {"tokens": tok}, state, pos)
            lgs.append(lg[:, 0].float())
            tok = greedy_sample(lg)[:, None]
    del state
    tokens = torch.stack(toks)
    cfg32 = dataclasses.replace(cfg, dtype="float32", n_layers=fp32_layers)
    p32 = (cross_params if cross else init_params)(torch, cfg32)
    with recorded_route(route32):
        lg32 = fed_logits(torch, get_adapter(cfg32), p32, tokens,
                          torch.float32, cross=meshless_cross_kv(
                              torch, cfg32, p32) if cross else None)
    del p32
    torch.cuda.empty_cache()
    return {"cfg": cfg, "fp32_layers": fp32_layers, "tokens": tokens.cpu(),
            "bfloat16": torch.stack(lgs).cpu(), "float32": lg32.cpu(),
            "route": {"bfloat16": route16, "float32": route32}}


def _moe_tp_rank(rank: int, world: int, store: str, tmp: str) -> None:
    """One rank of the MoE / rwkv6 check (a spawned process): a gloo group
    through a FileStore, the run, its results saved for the parent."""
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        out = moe_tp_rank_run(torch, Path(tmp))
        torch.save(out, Path(tmp) / f"moe_tp_out_{rank}.pt")
    finally:
        dist.destroy_process_group()


def _tp_model_runs(torch, ref: dict, mesh, whole: bool = True,
                   serve: bool = True) -> dict:
    """This rank's runs of one model on `mesh`: fp32 at the reference's
    cut depth and, with `whole`, bf16 at the reference's depth, each from
    init(tp) on the seed placed by the serve driver's ``place_params`` and
    fed the reference's tokens, the logits gathered over the batch axes,
    the MoE routing and the attention calls recorded, the launches
    counted; then, with `whole` and `serve`, the bf16 model serves the
    driver's requests on the mesh. whisper and mllama take
    :func:`cross_params` instead, and their cross KV is filled by
    ``precompute_cross_kv(mesh)`` on this rank's shards from the stub
    input's source (:func:`cross_source`, computed with the whole model
    before it is cut)."""
    import torch.distributed as dist
    from repro_torch.distributed.sharding import (BATCH_AXES, all_gather,
                                                  batch_rows, model_size)
    from repro_torch.kernels import launch_counters, reset_launch_counters
    from repro_torch.launch.serve import place_params
    from repro_torch.models import mllama, whisper
    from repro_torch.models.registry import get_adapter
    cfg, n = ref["cfg"], model_size(mesh)
    cross = cfg.family in ("audio", "vlm")
    tokens = ref["tokens"].to("cuda")
    out = {}
    params = None
    runs = [(dataclasses.replace(cfg, dtype="float32",
                                 n_layers=ref["fp32_layers"]), torch.float32)]
    for c, cache_dtype in runs + ([(cfg, None)] if whole else []):
        ad = get_adapter(c)
        params = None     # the previous model's shards, freed first
        torch.cuda.empty_cache()
        # Each rank builds the whole model before it keeps its shards:
        # they take turns, so that one whole model at a time is on the
        # card (phi3.5-moe's 8 layers are 21.3 GB).
        for turn in range(dist.get_world_size()):
            if turn == dist.get_rank():
                if cross:
                    full = cross_params(torch, c)
                    src = cross_source(torch, c, full)
                else:
                    full = ad.init(torch.Generator(
                        device="cuda").manual_seed(SEED), tp=n)
                params = place_params(ad, full, mesh, n)
                del full
                torch.cuda.empty_cache()
            dist.barrier()
        kv = None
        if cross:
            r0, r1 = batch_rows(SLOTS, mesh)
            mod = whisper if c.family == "audio" else mllama
            with torch.inference_mode():
                kv = mod.precompute_cross_kv(params, c, src[r0:r1], mesh)
            del src
        calls, attention = [], {}
        reset_launch_counters()
        with recorded_route(calls), recorded_attention(attention):
            lg = fed_logits(torch, ad, params, tokens, cache_dtype, mesh, kv)
        del kv
        out[c.dtype] = {
            "logits": all_gather(lg, mesh, BATCH_AXES, 1).cpu(),
            "route": calls, "attention": attention,
            "counts": {k: v.count for k, v in launch_counters().items()},
            "weight_bytes": sum(t.numel() * t.element_size()
                                for t in _tensors(params))}
    if whole and serve:
        sv = serve_phase(torch, cfg, params, {"rowstream_matmul": per_step(
            cfg)["rowstream_matmul"]}, mesh=mesh)
        out["serve"] = {k: sv[k] for k in (
            "counts", "steps", "tokens", "generated", "tokens_per_s",
            "median_step_ms", "mean_step_ms", "first_step_ms")}
    del params
    torch.cuda.empty_cache()
    return out


def tp_train_run(torch, mesh, name: str, fp32_layers: int,
                 layers: int | None) -> dict:
    """`name`'s train step on this rank's model shards: the fp32 check at
    `fp32_layers` layers (tp_fp32_check), then, unless `layers` is None,
    the bf16 steps at `layers` layers (bf16_train_run)."""
    from repro_torch.configs.registry_configs import ALL_ARCHS
    base = ALL_ARCHS[name]
    out = {"fp32": tp_fp32_check(torch, mesh, dataclasses.replace(
        base, dtype="float32", n_layers=fp32_layers))}
    torch.cuda.empty_cache()
    if layers is not None:
        out.update(bf16_train_run(torch, mesh, dataclasses.replace(
            base, n_layers=layers)))
    return out


def bf16_train_run(torch, mesh, cfg) -> dict:
    """TP_STEPS steps of the driver's step for `cfg` from SEED's
    parameters, on this rank's shards of `mesh`, or in one process where
    `mesh` is None: the path taken, each step's loss and host ms, the
    parameter bytes its forward saw, and the peak memory."""
    from repro_torch.distributed.sharding import model_size, use_mesh
    from repro_torch.launch import train as port_train
    from repro_torch.models.registry import get_adapter, train_tp_path
    n = model_size(mesh)
    torch.cuda.reset_peak_memory_stats()
    ad = get_adapter(cfg)
    out = {"path": train_tp_path(cfg, n)}
    step = port_train.make_step(ad, mesh, n, TRAIN_MICRO, TRAIN_LR)
    seen, loss = [], ad.loss

    def seen_loss(params, batch, remat=False, mesh=None):
        seen.append(sum(t.numel() * t.element_size()
                        for t in _tensors(params)))
        return loss(params, batch, remat, mesh)

    ad.loss = seen_loss
    losses, step_ms = [], []
    try:
        with use_mesh(mesh):
            state = port_train.init_state(ad, mesh, n, SEED, "cuda")
            whole = sum(p.numel() * p.element_size()
                        for p in _tensors(state.params))
            for i in range(TP_STEPS):
                batch = _tp_batch(torch, cfg, i)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, metrics = step(state, batch)
                losses.append(float(metrics["loss"]))
                step_ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        ad.loss = loss
    del state
    out.update(layers=cfg.n_layers, losses=losses, step_ms=step_ms,
               seen_bytes=seen[0], whole_bytes=whole,
               peak_bytes=torch.cuda.max_memory_allocated())
    torch.cuda.empty_cache()
    return out


def moe_tp_rank_run(torch, tmp: Path) -> dict:
    """This rank's part of the MoE / rwkv6 check (see MOE_TP_RANKS)."""
    from repro_torch.launch.mesh import make_mesh
    refs = torch.load(tmp / "moe_tp_ref.pt", weights_only=False)
    one_by_two = make_mesh((1, MOE_TP_RANKS), ("data", "model"), "cuda")
    two_by_one = make_mesh((MOE_TP_RANKS, 1), ("data", "model"), "cuda")
    out = {}
    for name, ref in refs["models"].items():
        out[name] = {"1x2": _tp_model_runs(torch, ref, one_by_two,
                                           serve=name in refs[
                                               "serve_on_mesh"])}
        if name == PHI:
            out[name]["2x1"] = _tp_model_runs(torch, ref, two_by_one, False)
    out["train"] = tp_train_run(torch, one_by_two, GRANITE,
                                MOE_TRAIN_FP32_LAYERS, refs["train_layers"])
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    return out


def moe_tp_references(torch) -> dict:
    """The parent's side of the MoE / rwkv6 check: each model served
    without a mesh (granite-moe-3b also on a 1x1 mesh), then its
    reference (:func:`tp_reference`), each model freed before the next."""
    from repro_torch.configs.registry_configs import ALL_ARCHS
    models, serves, one = {}, {}, None
    pcfg = dataclasses.replace(ALL_ARCHS[PHI], n_layers=PHI_LAYERS)
    for cfg in (ALL_ARCHS[GRANITE], pcfg, ALL_ARCHS["rwkv6-3b"]):
        params = init_params(torch, cfg)
        if cfg is pcfg:
            n = sum(t.numel() * t.element_size() for t in _tensors(params))
            print(f"[depth] {PHI} at full width cut to {PHI_LAYERS} of its "
                  f"32 layers: {n / 1e9:.2f} GB of bf16 weights, about "
                  f"{n / 2e9:.2f} GB a rank on 1x{MOE_TP_RANKS} (the whole "
                  f"model is about 84 GB, more than the card holds)")
        sv = serve_phase(torch, cfg, params, per_step(cfg))
        print_serve(f"{cfg.name} ({cfg.n_layers} layers)", sv)
        if cfg.name == GRANITE:
            one = mesh_serve_phase(torch, cfg, params, sv)
        prompts = [r.prompt for r in sorted(sv["run"].batcher.completed,
                                            key=lambda r: r.rid)]
        models[cfg.name] = tp_reference(torch, cfg, params, prompts,
                                        MOE_TP_FP32_LAYERS[cfg.name],
                                        MOE_TP_STEPS[cfg.name])
        serves[cfg.name] = sv
        del params
        torch.cuda.empty_cache()
    return {"models": models, "serves": serves, "mesh_1x1": one}


def moe_tp_phase(torch, train_layers: int, serves=(GRANITE, PHI,
                                                  "rwkv6-3b")) -> dict:
    """The MoE / rwkv6 check (see MOE_TP_RANKS): references, the ranks'
    run (the bf16 training at `train_layers` layers, the models of
    `serves` serving on 1x2), the verdicts."""
    t_ref = time.perf_counter()
    refs = moe_tp_references(torch)
    ref_s = time.perf_counter() - t_ref
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_moe_tp_"))
    try:
        torch.save({"models": refs["models"], "train_layers": train_layers,
                    "serve_on_mesh": tuple(serves)}, tmp / "moe_tp_ref.pt")
        torch.cuda.empty_cache()
        print(f"[moe_tp] the parent holds {torch.cuda.memory_allocated()} "
              f"bytes on the card ({torch.cuda.memory_reserved()} reserved) "
              f"while the ranks run", flush=True)
        seconds = _spawned(_moe_tp_rank, tmp, MOE_TP_TIMEOUT_S, "MoE / rwkv6",
                           MOE_TP_RANKS)
        outs = [torch.load(tmp / f"moe_tp_out_{r}.pt", weights_only=False)
                for r in range(MOE_TP_RANKS)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    res = {"seconds": seconds, "reference_seconds": ref_s,
           "mesh_1x1": numbers_of_serve(refs["mesh_1x1"]),
           "meshless_counts": {name: sv["counts"]
                               for name, sv in refs["serves"].items()},
           "peak_bytes": [o["peak_bytes"] for o in outs], "models": {}}
    for name, ref in refs["models"].items():
        res["models"][name] = {
            mesh: tp_model_verdict(name, mesh, ref, [o[name][mesh]
                                                     for o in outs],
                                   refs["serves"][name])
            for mesh in outs[0][name]}
    res["train"] = tp_train_verdict([o["train"] for o in outs], GRANITE,
                                    "moe_tp")
    print(f"[moe_tp] references {ref_s:.1f} s; ranks {seconds:.1f} s from "
          f"spawn to join; peak bytes by rank {res['peak_bytes']}")
    return res


def tp_model_verdict(name: str, mesh: str, ref: dict, outs: list,
                     sv: dict, tag: str = "moe_tp") -> dict:
    """Check and print (lines tagged `tag`) one model's runs on `mesh`
    against its reference: equal logits on every rank, fp32 logits within
    LOGITS_ATOL, no routing disagreement between the ranks of a model
    axis, on 2x1 the meshless run's dropped assignments a step; the bf16
    logits, routing flips and served tokens that differ reported."""
    import torch
    res = {}
    for dt in ("float32", "bfloat16"):
        if dt not in outs[0]:
            continue
        got, want = outs[0][dt]["logits"], ref[dt]
        check(all(torch.equal(o[dt]["logits"], got) for o in outs),
              f"{name} on {mesh}: the ranks return different {dt} logits")
        diff = (got - want).abs().max().item()
        calls = [o[dt]["route"] for o in outs]
        r = {"max_diff": diff, "max_logit": want.abs().max().item(),
             "argmax_agree": int((got.argmax(-1) == want.argmax(-1)).sum()),
             "positions": got.shape[0] * got.shape[1],
             "counts": [o[dt]["counts"] for o in outs],
             "weight_bytes": [o[dt]["weight_bytes"] for o in outs]}
        steps = ref["tokens"].shape[0]
        if calls[0]:
            per_step = len(calls[0]) // steps
            if mesh == "1x2":
                r["rank_disagreements"] = decisions_differ(calls[0], calls[1])
                check(r["rank_disagreements"] == 0,
                      f"{name} {dt} on {mesh}: the ranks route "
                      f"{r['rank_disagreements']} (token, layer) decisions "
                      f"differently")
                mine = calls[0]
            else:
                # each rank recorded its own rows: join them per call
                mine = [(torch.cat([c[i][0] for c in calls]),
                         sum(c[i][1] for c in calls))
                        for i in range(len(calls[0]))]
            r["routing_flips"] = decisions_differ(mine, ref["route"][dt])
            r["decisions"] = sum(int(x.shape[0]) for x, _ in mine)
            r["dropped_by_step"] = drops_by_step(mine, per_step)
            r["meshless_dropped_by_step"] = drops_by_step(ref["route"][dt],
                                                          per_step)
        if dt == "float32" or mesh == "2x1":
            check(tuple(got.shape) == tuple(want.shape)
                  and bool(got.isfinite().all()) and diff <= LOGITS_ATOL,
                  f"{name} {dt} on {mesh}: logits differ from the meshless "
                  f"run by {diff} (> {LOGITS_ATOL})")
        if mesh == "2x1":
            check(r["dropped_by_step"] == r["meshless_dropped_by_step"],
                  f"{name} {dt} on {mesh}: dropped assignments a step "
                  f"{r['dropped_by_step']} against the meshless run's "
                  f"{r['meshless_dropped_by_step']}")
        routing = "" if "routing_flips" not in r else (
            f"; {r['routing_flips']} of {r['decisions']} (token, layer) "
            f"routing decisions differ from the meshless run's, "
            f"{r.get('rank_disagreements', 'n/a')} between the ranks; "
            f"dropped assignments a step {r['dropped_by_step']} (meshless "
            f"{r['meshless_dropped_by_step']}, "
            f"{sum(r['meshless_dropped_by_step'])} in all)")
        layers = ref["fp32_layers"] if dt == "float32" \
            else ref["cfg"].n_layers
        print(f"[{tag}] {name} {dt} at {layers} layers on {mesh} (ranks "
              f"sharing the card over gloo), {steps} fed steps at "
              f"{SLOTS} slots: max |mesh - meshless| logits {diff!r} "
              f"({'held at ' + str(LOGITS_ATOL) if dt == 'float32' or mesh == '2x1' else 'reported only'}; "
              f"max |logit| {r['max_logit']!r}), argmax agrees at "
              f"{r['argmax_agree']}/{r['positions']}{routing}; launches by "
              f"rank {r['counts']}; weight bytes by rank "
              f"{r['weight_bytes']}")
        res[dt] = r
    if "serve" in outs[0]:
        served = outs[0]["serve"]
        check(all(o["serve"]["tokens"] == served["tokens"] for o in outs),
              f"{name} on {mesh}: the ranks recorded different tokens")
        differ = sum(a != b for rid, toks in sv["tokens"].items()
                     for a, b in zip(toks, served["tokens"][rid]))
        res["serve"] = dict(
            {k: v for k, v in served.items() if k != "tokens"},
            tokens_differ=differ,
            tokens_total=sum(map(len, sv["tokens"].values())),
            counts=[o["serve"]["counts"] for o in outs],
            meshless_median_step_ms=sv["median_step_ms"])
        print(f"[{tag}] {name} bf16 served on {mesh}: {served['steps']} "
              f"steps, {differ} of {res['serve']['tokens_total']} greedy "
              f"tokens differ from the meshless serve; step median "
              f"{served['median_step_ms']!r} ms (meshless "
              f"{sv['median_step_ms']!r}; two ranks on one card, "
              f"collectives staged through the host: a correctness run, "
              f"not a speed); launches by rank {res['serve']['counts']}")
    return res


def tp_train_verdict(parts: list, name: str, tag: str) -> dict:
    """Check and print (lines tagged `tag`) `name`'s train step on 1x2:
    the fp32 step by tp_fp32_verdict's rules; the bf16 steps' finite
    losses, equal on every rank, where they ran."""
    fp32 = tp_fp32_verdict([p["fp32"] for p in parts])
    f = parts[0]
    if "losses" not in f:
        return {"fp32": fp32}
    for r, p in enumerate(parts):
        check(p["path"][0], f"rank {r}: {p['path'][1]}")
        check(all(math.isfinite(x) for x in p["losses"])
              and p["losses"] == f["losses"],
              f"rank {r}: bf16 losses {p['losses']} (rank 0: "
              f"{f['losses']})")
    out = {"fp32": fp32, "layers": f["layers"], "losses": f["losses"],
           "step_ms": [p["step_ms"] for p in parts],
           "seen_bytes": [p["seen_bytes"] for p in parts],
           "whole_bytes": f["whole_bytes"],
           "peak_bytes": [p["peak_bytes"] for p in parts]}
    print(f"[{tag}] {f['path'][1]}")
    print(f"[{tag}] {name} bf16 train step on 1x{len(parts)} at "
          f"{f['layers']} layers, {TP_STEPS} steps of {TRAIN_BATCH} x "
          f"{TRAIN_SEQ} tokens in {TRAIN_MICRO} microbatches: losses "
          f"{f['losses']!r}; parameter bytes the forward saw by rank "
          f"{out['seen_bytes']} of {out['whole_bytes']}; peak memory by "
          f"rank {out['peak_bytes']} bytes; step ms by rank "
          f"{out['step_ms']!r} (two ranks sharing one card over host-staged "
          f"gloo: a correctness run, not a speed)")
    return out


def moe_tp_kernels(torch) -> dict:
    """rowstream_matmul at the products a rank of 1x2 launches at decode
    (granite-moe-3b, phi3.5-moe, rwkv6-3b), each beside the whole
    product, and flash_decode_partial over a rank's half of the serve
    cache (granite-moe-3b, phi3.5-moe) beside the whole one."""
    from repro_torch.configs.registry_configs import ALL_ARCHS
    from repro_torch.distributed.sharding import padded_vocab
    n = MOE_TP_RANKS
    shapes = []     # (a rank's shard, the whole product) pairs
    for name in (GRANITE, PHI):
        c = ALL_ARCHS[name]
        d, q, kv = c.d_model, c.n_heads * c.resolved_head_dim, \
            c.n_kv_heads * c.resolved_head_dim
        V = padded_vocab(c.vocab)
        shapes += [((d, q // n), (d, q)), ((d, kv // n), (d, kv)),
                   ((q // n, d), (q, d)), ((d, V // n), (d, V))]
    r = ALL_ARCHS["rwkv6-3b"]
    d, ff, V = r.d_model, r.d_ff, padded_vocab(r.vocab)
    shapes += [((d, d // n), (d, d)), ((d // n, d), (d, d)),
               ((d, ff // n), (d, ff)), ((ff // n, d), (ff, d)),
               ((d, V // n), (d, V))]
    shapes = list(dict.fromkeys(s for pair in shapes for s in pair))
    products = rowstream_products(torch, shapes)
    partial = {name: partial_timings(torch, ALL_ARCHS[name], (MAX_SEQ,),
                                     (1, n))
               for name in (GRANITE, PHI)}
    return {"rowstream_matmul": products, "flash_decode_partial": partial}


# zamba2 on model shards (``--only zamba2_tp``, and in the full run):
# ZAMBA_TP_RANKS ranks spawned on the one card over gloo, as the checks
# above. The parent serves zamba2-1.2b without a mesh and on a 1x1 mesh
# (the meshless tokens at the meshless launches), and keeps MESH_STEPS
# greedy steps of it (tp_reference): the tokens fed, the bf16 logits and
# the logits in fp32 cut to ZAMBA_TP_FP32_LAYERS blocks (one application
# of the shared block). The ranks then run the same steps on 1x2, each on
# its 32 of the 64 SSM heads with in_proj and the conv laid out by its
# parts (a (2048, 4256) in_proj a block) and its 64 of the 128 slots of
# the shared block's KV cache: fp32 held at LOGITS_ATOL against the
# meshless run, bf16 at all 38 blocks reported; every rank must launch
# the meshless step's rowstream_matmul and flash_decode counts; the bf16
# model serves the driver's requests on 1x2. Then the train step on 1x2:
# fp32 at ZAMBA_TP_FP32_LAYERS blocks against the single-process step
# (tp_fp32_check's rules) and TP_STEPS bf16 steps at all 38, which the
# parent then runs in one process from the same seed and batches
# (zamba2_single_train). The full run
# keeps the 1x1 check, the fp32 fed steps and the fp32 train step at
# FULL_RUN_ZAMBA_LAYERS blocks and leaves the bf16 runs and the serve on
# 1x2 to `--only zamba2_tp`. ZAMBA_TP_TIMEOUT_S bounds the ranks' run.
ZAMBA_TP_RANKS = 2
ZAMBA_TP_FP32_LAYERS = 6
ZAMBA_TP_TIMEOUT_S = 900
# The first bf16 training loss on 1x2 against one process's, relative.
ZAMBA_TP_FIRST_LOSS_RTOL = 1e-2


def _zamba2_tp_rank(rank: int, world: int, store: str, tmp: str) -> None:
    """One rank of the zamba2 check (a spawned process): a gloo group
    through a FileStore, the run, its results saved for the parent."""
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        out = zamba2_tp_rank_run(torch, Path(tmp))
        torch.save(out, Path(tmp) / f"zamba2_tp_out_{rank}.pt")
    finally:
        dist.destroy_process_group()


def zamba2_tp_rank_run(torch, tmp: Path) -> dict:
    """This rank's part of the zamba2 check (see ZAMBA_TP_RANKS)."""
    from repro_torch.launch.mesh import make_mesh
    refs = torch.load(tmp / "zamba2_tp_ref.pt", weights_only=False)
    mesh = make_mesh((1, ZAMBA_TP_RANKS), ("data", "model"), "cuda")
    out = {"1x2": _tp_model_runs(torch, refs["ref"], mesh, refs["whole"],
                                 refs["whole"])}
    out["train"] = tp_train_run(torch, mesh, ZAMBA, ZAMBA_TP_FP32_LAYERS,
                                refs["train_layers"])
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    return out


def zamba2_tp_phase(torch, layers: int | None = None) -> dict:
    """The zamba2 check (see ZAMBA_TP_RANKS): with `layers` (the full run)
    the parent's serves at that depth and neither the bf16 runs nor the
    serve on 1x2; without it all of them at full depth."""
    from repro_torch.configs.registry_configs import ALL_ARCHS
    t_ref = time.perf_counter()
    cfg = ALL_ARCHS[ZAMBA]
    whole = layers is None
    if not whole:
        print(f"[depth] {ZAMBA} on 1x{ZAMBA_TP_RANKS}: the 1x1 serve at "
              f"{layers} of its {cfg.n_layers} blocks, the fp32 fed steps "
              f"and train step at {ZAMBA_TP_FP32_LAYERS}; --only zamba2_tp "
              f"adds the bf16 fed steps, serve and train steps at all "
              f"{cfg.n_layers}")
        cfg = dataclasses.replace(cfg, n_layers=layers)
    params = init_params(torch, cfg)
    sv = serve_phase(torch, cfg, params, per_step(cfg))
    print_serve(f"{ZAMBA} ({cfg.n_layers} blocks)", sv)
    one = mesh_serve_phase(torch, cfg, params, sv)
    prompts = [r.prompt for r in sorted(sv["run"].batcher.completed,
                                        key=lambda r: r.rid)]
    ref = tp_reference(torch, cfg, params, prompts, ZAMBA_TP_FP32_LAYERS,
                       MESH_STEPS)
    del params
    torch.cuda.empty_cache()
    ref_s = time.perf_counter() - t_ref
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_zamba2_tp_"))
    try:
        torch.save({"ref": ref, "whole": whole,
                    "train_layers": cfg.n_layers if whole else None},
                   tmp / "zamba2_tp_ref.pt")
        seconds = _spawned(_zamba2_tp_rank, tmp, ZAMBA_TP_TIMEOUT_S,
                           "zamba2", ZAMBA_TP_RANKS)
        outs = [torch.load(tmp / f"zamba2_tp_out_{r}.pt",
                           weights_only=False)
                for r in range(ZAMBA_TP_RANKS)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    runs = [o["1x2"] for o in outs]
    verdict = tp_model_verdict(ZAMBA, "1x2", ref, runs, sv, "zamba2_tp")
    slots = MAX_SEQ // ZAMBA_TP_RANKS
    for dt, r in verdict.items():
        if dt == "serve":
            continue
        depth = ZAMBA_TP_FP32_LAYERS if dt == "float32" else cfg.n_layers
        meshless = per_step(dataclasses.replace(cfg, n_layers=depth))
        for rank, counts in enumerate(r["counts"]):
            # a rank's shard of the KV cache launches flash_decode once
            # it holds a valid slot (pos >= rank * slots)
            steps = {"flash_decode": sum(pos >= rank * slots
                                         for pos in range(MESH_STEPS))}
            want = {k: n * steps.get(k, MESH_STEPS)
                    for k, n in meshless.items()}
            check(counts == want,
                  f"{ZAMBA} {dt} on 1x{ZAMBA_TP_RANKS}, rank {rank}: "
                  f"launches {counts} in {MESH_STEPS} steps; the meshless "
                  f"step's {meshless} a step make {want}")
    res = {"seconds": seconds, "reference_seconds": ref_s,
           "layers": cfg.n_layers, "mesh_1x1": numbers_of_serve(one),
           "meshless_counts": sv["counts"], "models": {"1x2": verdict},
           "peak_bytes": [o["peak_bytes"] for o in outs],
           "train": tp_train_verdict([o["train"] for o in outs], ZAMBA,
                                     "zamba2_tp")}
    if whole:
        res["train"]["single"] = zamba2_single_train(
            torch, cfg, res["train"]["losses"])
    print(f"[zamba2_tp] references {ref_s:.1f} s; ranks {seconds:.1f} s "
          f"from spawn to join; peak bytes by rank {res['peak_bytes']}")
    return res


def zamba2_single_train(torch, cfg, tp_losses: list) -> dict:
    """The bf16 steps of the 1x2 run (bf16_train_run) in one process, from
    the same parameters and batches: each loss printed beside the 1x2
    run's `tp_losses`, the first held within ZAMBA_TP_FIRST_LOSS_RTOL (the
    same parameters and batch; the split changes only where bf16 rounds),
    the later ones, which follow AdamW's steps through bf16 rounding,
    reported."""
    single = bf16_train_run(torch, None, cfg)
    losses = single["losses"]
    check(all(math.isfinite(x) for x in losses),
          f"{ZAMBA} bf16 single-process losses {losses}")
    rel = [abs(a - b) / abs(b) for a, b in zip(tp_losses, losses)]
    check(rel[0] <= ZAMBA_TP_FIRST_LOSS_RTOL,
          f"{ZAMBA} bf16 first loss on 1x{ZAMBA_TP_RANKS} {tp_losses[0]} "
          f"against {losses[0]} in one process: {rel[0]} relative (held at "
          f"{ZAMBA_TP_FIRST_LOSS_RTOL})")
    print(f"[zamba2_tp] {ZAMBA} bf16 train steps at {cfg.n_layers} blocks "
          f"in one process: losses {losses!r} against {tp_losses!r} on "
          f"1x{ZAMBA_TP_RANKS}, relative differences {rel!r} (the first "
          f"held at {ZAMBA_TP_FIRST_LOSS_RTOL}, the rest reported); step ms "
          f"{single['step_ms']!r}; peak memory {single['peak_bytes']} bytes")
    return {k: single[k] for k in ("losses", "step_ms", "peak_bytes")} \
        | {"rel": rel}


def zamba2_tp_kernels(torch) -> dict:
    """rowstream_matmul at the products a rank of 1x2 launches in a
    zamba2-1.2b decode step (in_proj by parts, out_proj, the shared
    block's halves, the head), each beside the whole product, and
    flash_decode_partial over a rank's half of the serve cache of the
    shared block's applications beside the whole one."""
    from repro_torch.configs.registry_configs import ALL_ARCHS
    from repro_torch.distributed.sharding import padded_vocab
    from repro_torch.models import zamba2
    n = ZAMBA_TP_RANKS
    c = ALL_ARCHS[ZAMBA]
    d, ff, V = c.d_model, c.d_ff, padded_vocab(c.vocab)
    q = c.n_heads * c.resolved_head_dim
    kv = c.n_kv_heads * c.resolved_head_dim
    din = zamba2.inner_dim(c)
    widths = zamba2._part_widths(c, n)
    shapes = [((d, widths["in_proj"]), (d, zamba2._in_width(c))),
              ((din // n, d), (din, d)), ((d, q // n), (d, q)),
              ((d, kv // n), (d, kv)), ((q // n, d), (q, d)),
              ((d, ff // n), (d, ff)), ((ff // n, d), (ff, d)),
              ((d, V // n), (d, V))]
    shapes = list(dict.fromkeys(s for pair in shapes for s in pair))
    products = rowstream_products(torch, shapes)
    _, n_shared = zamba2._pattern(c)
    attn = dataclasses.replace(c, n_layers=n_shared)
    partial = partial_timings(torch, attn, (MAX_SEQ,), (1, n))
    return {"rowstream_matmul": products, "flash_decode_partial": partial}


# whisper and llama-3.2-vision on model shards (``--only cross_tp``, and in
# the full run): CROSS_TP_RANKS ranks spawned on the one card over gloo, as
# the checks above. The parent serves whisper-small whole and
# llama-3.2-vision at full width cut to MLLAMA_UNITS pattern units
# (FULL_RUN_CROSS_TP_UNITS in the full run) without a mesh and on a 1x1
# mesh (the meshless tokens at the meshless launches), and keeps
# MESH_STEPS greedy steps of each with its cross KV filled from the stub
# input (tp_reference with `cross`): the tokens fed, the bf16 logits and
# the logits in fp32 (whisper at full depth, mllama at CROSS_TP_FP32_UNITS
# unit). The ranks then run the same steps on 1x2, each on its half of
# the heads, of the products' columns or rows, of the vocabulary and of
# the self KV's slots, the cross KV filled by precompute_cross_kv on the
# rank's shards and laid out as the reference lays it out: whisper's 1500
# frames split, 750 a rank, through flash_decode_partial; mllama's 1601
# vision tokens, which 2 does not divide, whole on both ranks through
# flash_decode. fp32 logits are held at LOGITS_ATOL and at
# CROSS_FP32_RTOL of the largest logit, bf16 reported; each rank must
# launch the meshless step's rowstream_matmul count and the attention its
# slots hold; then each bf16 model serves the driver's requests on 1x2
# (`--only cross_tp`; the full run leaves the serves out).
# CROSS_TP_TIMEOUT_S bounds the ranks' run.
CROSS_TP_RANKS = 2
CROSS_TP_FP32_UNITS = 1
FULL_RUN_CROSS_TP_UNITS = 1
CROSS_TP_TIMEOUT_S = 900


def _cross_tp_rank(rank: int, world: int, store: str, tmp: str) -> None:
    """One rank of the whisper / mllama check (a spawned process): a gloo
    group through a FileStore, the run, its results saved for the
    parent."""
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        from repro_torch.launch.mesh import make_mesh
        refs = torch.load(Path(tmp) / "cross_tp_ref.pt", weights_only=False)
        mesh = make_mesh((1, CROSS_TP_RANKS), ("data", "model"), "cuda")
        out = {name: _tp_model_runs(torch, ref, mesh, serve=refs["serve"])
               for name, ref in refs["models"].items()}
        out["peak_bytes"] = torch.cuda.max_memory_allocated()
        torch.save(out, Path(tmp) / f"cross_tp_out_{rank}.pt")
    finally:
        dist.destroy_process_group()


def cross_tp_phase(torch, units: int = MLLAMA_UNITS,
                   serve: bool = True) -> dict:
    """The whisper / mllama check (see CROSS_TP_RANKS), mllama at `units`
    pattern units; with `serve` each bf16 model also serves on 1x2."""
    from repro_torch.models import mllama
    t_ref = time.perf_counter()
    refs, serves, ones = {}, {}, {}
    for name in (WHISPER, MLLAMA):
        cfg = cross_cfg(name, units)
        params = cross_params(torch, cfg)
        sv = serve_phase(torch, cfg, params, per_step(cfg))
        print_serve(f"{name} ({cfg.n_layers} layers)", sv)
        ones[name] = numbers_of_serve(mesh_serve_phase(torch, cfg, params,
                                                       sv))
        prompts = [r.prompt for r in sorted(sv["run"].batcher.completed,
                                            key=lambda r: r.rid)]
        fp32_layers = cfg.n_layers if name == WHISPER \
            else CROSS_TP_FP32_UNITS * cfg.cross_attn_every
        refs[name] = tp_reference(torch, cfg, params, prompts, fp32_layers,
                                  MESH_STEPS, cross=True)
        serves[name] = sv
        del params
        torch.cuda.empty_cache()
    ref_s = time.perf_counter() - t_ref
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_cross_tp_"))
    try:
        torch.save({"models": refs, "serve": serve}, tmp / "cross_tp_ref.pt")
        seconds = _spawned(_cross_tp_rank, tmp, CROSS_TP_TIMEOUT_S,
                           "whisper / mllama", CROSS_TP_RANKS)
        outs = [torch.load(tmp / f"cross_tp_out_{r}.pt", weights_only=False)
                for r in range(CROSS_TP_RANKS)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    res = {"seconds": seconds, "reference_seconds": ref_s, "units": units,
           "mesh_1x1": ones,
           "meshless_counts": {n: sv["counts"] for n, sv in serves.items()},
           "peak_bytes": [o["peak_bytes"] for o in outs], "models": {}}
    slots = MAX_SEQ // CROSS_TP_RANKS
    for name, ref in refs.items():
        runs = [o[name] for o in outs]
        verdict = tp_model_verdict(name, "1x2", ref, runs, serves[name],
                                   "cross_tp")
        for dt, r in verdict.items():
            if dt == "serve":
                continue
            depth = ref["fp32_layers"] if dt == "float32" \
                else ref["cfg"].n_layers
            c = dataclasses.replace(ref["cfg"], n_layers=depth)
            if c.family == "audio":
                n_self = n_cross = depth
                S = c.n_audio_frames
            else:
                k, n_cross = mllama._pattern(c)
                n_self = n_cross * (k - 1)
                S = c.n_vision_tokens
            if dt == "float32":
                rel = r["max_diff"] / r["max_logit"]
                r["rel_diff"] = rel
                check(rel <= CROSS_FP32_RTOL,
                      f"{name} fp32 on 1x{CROSS_TP_RANKS}: logits differ "
                      f"from the meshless run by {rel} of the largest "
                      f"(> {CROSS_FP32_RTOL})")
            meshless = per_step(c)
            split = S % CROSS_TP_RANKS == 0
            cross_call = (f"flash_decode_partial over "
                          f"{S // CROSS_TP_RANKS} slots" if split
                          else f"flash_decode over {S} slots")
            r["attention"] = [run[dt]["attention"] for run in runs]
            for rank, (counts, calls) in enumerate(zip(r["counts"],
                                                       r["attention"])):
                # a rank's half of the self KV launches flash_decode once
                # it holds a valid slot (pos >= rank * slots)
                self_steps = sum(pos >= rank * slots
                                 for pos in range(MESH_STEPS))
                want = {kn: v * MESH_STEPS for kn, v in meshless.items()}
                want["flash_decode"] = n_cross * MESH_STEPS \
                    + n_self * self_steps
                check(counts == want,
                      f"{name} {dt} on 1x{CROSS_TP_RANKS}, rank {rank}: "
                      f"launches {counts} in {MESH_STEPS} steps; the "
                      f"meshless step's {meshless} a step and this rank's "
                      f"slots make {want}")
                want_calls = {cross_call: n_cross * MESH_STEPS,
                              f"flash_decode_partial over {slots} slots":
                              n_self * MESH_STEPS}
                check(calls == want_calls,
                      f"{name} {dt} on 1x{CROSS_TP_RANKS}, rank {rank}: "
                      f"attention calls {calls}, expected {want_calls}")
            print(f"[cross_tp] {name} {dt} at {depth} layers on "
                  f"1x{CROSS_TP_RANKS}: attention calls by rank "
                  f"{r['attention']} over {MESH_STEPS} steps (the cross KV "
                  f"{'split by sequence' if split else 'whole on each rank'}"
                  f"; its {S} slots)"
                  + (f"; fp32 logits {r['rel_diff']!r} of the largest from "
                     f"the meshless run (held at {CROSS_FP32_RTOL})"
                     if dt == "float32" else ""))
        res["models"][name] = {"1x2": verdict}
    print(f"[cross_tp] references {ref_s:.1f} s; ranks {seconds:.1f} s "
          f"from spawn to join; peak bytes by rank {res['peak_bytes']}")
    return res


def cross_tp_kernels(torch) -> dict:
    """rowstream_matmul at the products a rank of 1x2 launches in a
    whisper-small and a llama-3.2-vision decode step (its columns of the
    query, key and value heads and of the MLP's or SwiGLU's first
    products, its rows of the outputs and of the MLP's or SwiGLU's last,
    its vocabulary of the head), each beside the whole product;
    flash_decode_partial over a rank's 750 of whisper's 1500 cross frames
    beside the partial entry over all 1500; flash_decode with SDPA beside
    it over whisper's 1500 frames and over mllama's 1601 vision tokens,
    which each rank of 1x2 attends whole."""
    from repro_torch.configs.registry_configs import ALL_ARCHS
    from repro_torch.distributed.sharding import padded_vocab
    from repro_torch.models import mllama
    n = CROSS_TP_RANKS
    shapes = []     # (a rank's shard, the whole product) pairs
    for name in (WHISPER, MLLAMA):
        c = ALL_ARCHS[name]
        d, ff, V = c.d_model, c.d_ff, padded_vocab(c.vocab)
        q = c.n_heads * c.resolved_head_dim
        kv = c.n_kv_heads * c.resolved_head_dim
        shapes += [((d, q // n), (d, q)), ((d, kv // n), (d, kv)),
                   ((q // n, d), (q, d)), ((d, ff // n), (d, ff)),
                   ((ff // n, d), (ff, d)), ((d, V // n), (d, V))]
    shapes = list(dict.fromkeys(s for pair in shapes for s in pair))
    products = rowstream_products(torch, shapes)
    w = ALL_ARCHS[WHISPER]
    partial = partial_timings(torch, w, (w.n_audio_frames,), (1, n))
    m = cross_cfg(MLLAMA)
    mc = dataclasses.replace(m, n_layers=mllama._pattern(m)[1])
    whole = {WHISPER: flash_timings(torch, w, (w.n_audio_frames,)),
             MLLAMA: flash_timings(torch, mc, (m.n_vision_tokens,))}
    return {"rowstream_matmul": products, "flash_decode_partial": partial,
            "flash_decode": whole}


def main(argv=None) -> int:
    global RM_KERNELS, RS_KERNELS, RS_BWD_KERNELS
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", choices=["flash_decode", "rowstream_matmul",
                                       "rwkv_scan", "zamba2", "whisper",
                                       "mllama", "train", "train_tp",
                                       "mesh", "moe_tp", "zamba2_tp",
                                       "cross_tp"],
                    help="run only this kernel's phase (the card line, its "
                         "build, its checks and its timings) or this "
                         "model's phases (all kernels built and checked); "
                         "no ok line")
    ap.add_argument("--baseline", action="store_true",
                    help="with --only rowstream_matmul or rwkv_scan: the "
                         "tree's kernel predates its redesign; time its "
                         "device kernels and leave out the checks and plan "
                         "it lacks")
    args = ap.parse_args(argv)
    if args.baseline and args.only not in ("rowstream_matmul", "rwkv_scan"):
        ap.error("--baseline goes with --only rowstream_matmul or rwkv_scan")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    from repro_torch.configs.registry_configs import ALL_ARCHS
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[card] {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; {torch.cuda.device_count()} device(s)")

    # A baseline tree from before the scan's backward has no rwkv_scan_bwd.
    has_bwd = (build.CSRC / "rwkv_scan_bwd.cu").exists()
    if args.only in MODEL_ONLY:
        names = build.KERNELS
    elif args.only in ("rwkv_scan", "train", "train_tp") and has_bwd:
        names = ("rwkv_scan", "rwkv_scan_bwd")
    elif args.only in ("mesh", "moe_tp", "zamba2_tp", "cross_tp"):
        names = ("flash_decode", "rowstream_matmul")
    else:
        names = (args.only,)
    t0 = time.perf_counter()
    logs = build.build(names)
    build_s = time.perf_counter() - t0
    print(f"[build] {len(names)} kernels, nvcc in parallel: "
          f"{build_s:.1f} s")
    for name, log in logs.items():
        fn = ""
        for line in log.splitlines():
            if "Function properties for" in line:
                fn = line.split("Function properties for")[-1].strip()
            elif "registers" in line or "spill" in line:
                print(f"[ptxas {name}] {fn}: {line.strip()}")

    if args.only == "rowstream_matmul":
        if args.baseline:
            RM_KERNELS = BASELINE_RM_KERNELS
        check_rowstream(torch, dev)
        check_rowstream_norms(torch, dev)
        print(json.dumps({"rowstream_matmul": rowstream_phase(args.baseline)}))
        print(card)
        return 0
    if args.only == "rwkv_scan":
        if args.baseline:
            RS_KERNELS = RS_KERNELS + BASELINE_RS_KERNELS
            RS_BWD_KERNELS = BASELINE_RS_BWD_KERNELS
        check_rwkv_scan(torch, dev)
        out = {"rwkv_scan": scan_phase(args.baseline)}
        if has_bwd:
            check_rwkv_scan_bwd(torch, dev)
            check_rwkv_scan_bwd_launches(torch, dev)
            out["rwkv_scan_bwd"] = scan_bwd_phase(args.baseline)
        print(json.dumps(out))
        print(card)
        return 0
    if args.only == "train":
        check_rwkv_scan(torch, dev)
        t0 = time.perf_counter()
        check_rwkv_scan_bwd(torch, dev)
        print(f"[run] rwkv_scan_bwd checks {time.perf_counter() - t0:.1f} s")
        check_rwkv_scan_bwd_launches(torch, dev)
        t = train_phase(torch)
        print_train(t)
        print_ckpt(t["ckpt"], card)
        tp = train_profiled(torch, t)
        print(json.dumps({"train": dict(t, profiled=tp)}))
        print(f"[run] {time.perf_counter() - t_start:.0f} s")
        print(card)
        return 0
    if args.only == "train_tp":
        tp = train_tp_phase(torch)
        tp["kernels"] = train_tp_kernels(torch, tp)
        print(json.dumps({"train_tp": tp}))
        print(f"[run] {time.perf_counter() - t_start:.0f} s")
        print(card)
        return 0
    errs = {"flash_decode": check_flash_decode(torch, dev)}
    partial = check_flash_partial(torch, dev)
    if args.only == "flash_decode":
        flash_phase()
        print(card)
        return 0
    if args.only == "moe_tp":
        errs["rowstream_matmul"] = check_rowstream(torch, dev)
        mt = moe_tp_phase(torch, ALL_ARCHS[GRANITE].n_layers)
        mt["kernels"] = moe_tp_kernels(torch)
        print(json.dumps({"moe_tp": dict(mt, partial_checks=partial,
                                         max_abs_err=errs)}))
        print(f"[run] {time.perf_counter() - t_start:.0f} s")
        print(card)
        return 0
    if args.only == "zamba2_tp":
        errs["rowstream_matmul"] = check_rowstream(torch, dev)
        zt = zamba2_tp_phase(torch)
        zt["kernels"] = zamba2_tp_kernels(torch)
        print(json.dumps({"zamba2_tp": dict(zt, partial_checks=partial,
                                            max_abs_err=errs)}))
        print(f"[run] {time.perf_counter() - t_start:.0f} s")
        print(card)
        return 0
    if args.only == "cross_tp":
        errs["rowstream_matmul"] = check_rowstream(torch, dev)
        ct = cross_tp_phase(torch)
        ct["kernels"] = cross_tp_kernels(torch)
        print(json.dumps({"cross_tp": dict(ct, partial_checks=partial,
                                           max_abs_err=errs)}))
        print(f"[run] {time.perf_counter() - t_start:.0f} s")
        print(card)
        return 0
    if args.only == "mesh":
        errs["rowstream_matmul"] = check_rowstream(torch, dev)
        qcfg = ALL_ARCHS["qwen2-7b"]
        params = init_params(torch, qcfg)
        sv = serve_phase(torch, qcfg, params, per_step(qcfg))
        print_serve("qwen2-7b", sv)
        prompts = [r.prompt for r in sorted(sv["run"].batcher.completed,
                                            key=lambda r: r.rid)]
        one, ref = mesh_phases(torch, qcfg, params, sv, prompts)
        del params
        torch.cuda.empty_cache()
        two = two_rank_phase(torch, ref, sv)
        print(json.dumps({"mesh": {
            "partial_checks": partial, "mesh_1x1": numbers_of_serve(one),
            "mesh_1x2": two}}))
        print(f"[run] {time.perf_counter() - t_start:.0f} s")
        print(card)
        return 0
    errs.update({"rowstream_matmul": check_rowstream(torch, dev),
                 "rwkv_scan": check_rwkv_scan(torch, dev),
                 "rwkv_scan_bwd": check_rwkv_scan_bwd(torch, dev)})
    check_rowstream_norms(torch, dev)
    if args.only == "zamba2":
        z = zamba2_phase(torch)
        works, products = zamba2_profiled(torch, z)
        print(json.dumps({"zamba2": {"works": works, "products": products,
                                     "pool": z["pool"]}}))
        print(f"[run] {time.perf_counter() - t_start:.0f} s")
        print(card)
        return 0
    if args.only in ("whisper", "mllama"):
        name = {"whisper": WHISPER, "mllama": MLLAMA}[args.only]
        c = cross_phase(torch, name)
        print(json.dumps({name: cross_profiled(torch, c)}))
        print(f"[run] {time.perf_counter() - t_start:.0f} s")
        print(card)
        return 0

    # Everything timed on the host clock or with CUDA events comes before
    # the first use of the profiler: its hooks stay behind and slow later
    # launches from the host.
    lap = Laps()
    qcfg = ALL_ARCHS["qwen2-7b"]
    params = init_params(torch, qcfg)
    cell_bounds(qcfg, params)
    sv = serve_phase(torch, qcfg, params, per_step(qcfg))
    print_serve("qwen2-7b", sv)
    prompts = [r.prompt for r in sorted(sv["run"].batcher.completed,
                                        key=lambda r: r.rid)]
    mesh_one, mesh_ref = mesh_phases(torch, qcfg, params, sv, prompts)
    logits_phase(torch, qcfg, params, prompts, SLOTS, MAX_SEQ)
    plain_agreement(torch, qcfg, params, sv)
    walls = {"flash_decode": timed_ms(
                 flash_work(torch, qcfg, SLOTS, MAX_SEQ)["kernel"], 20),
             "rowstream_matmul": timed_ms(
                 rowstream_work(torch, qwen_weights(qcfg, params),
                                SLOTS)["kernel"], 5)}
    qf = forward_phase(torch, qcfg, params)
    print_forward("qwen2-7b", qf)
    qd = decode_against_forward(torch, qcfg, params, qf["tokens"],
                                qf.pop("logits"))
    print_decode("qwen2-7b bf16 (bf16 cache), reported only", qd)
    del params
    torch.cuda.empty_cache()
    qd32 = dense_fp32_phase(torch, qcfg, qf["tokens"])
    print_decode("qwen2-7b fp32 (fp32 cache)", qd32)
    lap("qwen2-7b serve, 1x1 mesh, forward, fp32 decode")
    mesh_two = two_rank_phase(torch, mesh_ref, sv)
    lap("qwen2-7b on 1x2")

    gcfg = ALL_ARCHS[GRANITE]
    params = init_params(torch, gcfg)
    cell_bounds(gcfg, params)
    gs = serve_phase(torch, gcfg, params, per_step(gcfg))
    print_serve("granite-moe-3b", gs)
    gprompts = [r.prompt for r in sorted(gs["run"].batcher.completed,
                                         key=lambda r: r.rid)]
    plain_agreement(torch, gcfg, params, gs)
    gl = moe_layer_phase(torch, gcfg, params, gprompts)
    print(f"[logits] granite-moe-3b bf16: each layer on the same input, "
          f"kernel against plain path: max err / max |output| over tokens "
          f"routed alike {gl['layer_err']!r} (tolerance 3e-2)")
    gf = forward_phase(torch, gcfg, params)
    print_forward("granite-moe-3b", gf)
    del params, gf["logits"]
    torch.cuda.empty_cache()
    g32 = dataclasses.replace(gcfg, dtype="float32")
    params = init_params(torch, g32)
    logits_phase(torch, g32, params, gprompts, SLOTS, MAX_SEQ)
    del params
    torch.cuda.empty_cache()

    lap("granite-moe-3b")
    z = zamba2_phase(torch, FULL_RUN_ZAMBA_LAYERS)
    lap("zamba2-1.2b and the paged pool")
    cross = {}
    for name in (WHISPER, MLLAMA):
        cross[name] = cross_phase(torch, name)
        lap(name)
    t0 = time.perf_counter()
    train = train_phase(torch, FULL_RUN_BWD_LAUNCHES, TRAIN_CHECK_LAYERS)
    print_train(train)
    print_ckpt(train["ckpt"], card)
    lap("rwkv6-3b training on 1x1")
    train_tp = train_tp_phase(torch)
    lap("rwkv6-3b training on 1x2")
    train_s = time.perf_counter() - t0
    print(f"[depth] {GRANITE} bf16 train step on 1x{MOE_TP_RANKS}: cut to "
          f"{FULL_RUN_MOE_TRAIN_LAYERS} of its "
          f"{gcfg.n_layers} layers in the full run; --only moe_tp trains "
          f"all {gcfg.n_layers}")
    print(f"[depth] on 1x{MOE_TP_RANKS} the full run serves "
          f"{', '.join(FULL_RUN_MOE_TP_SERVES) or 'none of the models'} "
          f"(their fed steps run); --only moe_tp serves {GRANITE}, {PHI} "
          f"and rwkv6-3b")
    moe_tp = moe_tp_phase(torch, FULL_RUN_MOE_TRAIN_LAYERS,
                          FULL_RUN_MOE_TP_SERVES)
    lap("the MoE family and rwkv6-3b on 1x2 and 2x1")
    zamba_tp = zamba2_tp_phase(torch, FULL_RUN_ZAMBA_LAYERS)
    lap("zamba2-1.2b on 1x2")
    print(f"[depth] {MLLAMA} on 1x{CROSS_TP_RANKS}: cut to "
          f"{FULL_RUN_CROSS_TP_UNITS} pattern unit in the full run, the "
          f"serves on 1x{CROSS_TP_RANKS} and the shard timings left out; "
          f"--only cross_tp runs {MLLAMA_UNITS} units, both serves and the "
          f"timings")
    cross_tp = cross_tp_phase(torch, FULL_RUN_CROSS_TP_UNITS, serve=False)
    lap("whisper-small and llama-3.2-vision on 1x2")

    rcfg = ALL_ARCHS["rwkv6-3b"]
    params = init_params(torch, rcfg)
    pf = rwkv_forward_phase(torch, rcfg, params)
    print(f"[forward] rwkv6-3b bf16, {PREFILL_B} x {PREFILL_S} tokens: "
          f"launches {pf['counts']}; host time {pf['forward_ms']!r} ms "
          f"(first call {pf['first_ms']!r} ms); each layer on the same "
          f"input, kernel against plain path: max err / max |output| "
          f"{pf['layer_err']!r} (tolerance 3e-2)")
    print(f"[forward] rwkv6-3b bf16, reported only: max |kernel - plain| "
          f"logits {pf['plain_diff']!r} (max |logit| {pf['max_logit']!r}); "
          f"{DECODE_T} tokens through decode_step against forward "
          f"{pf['decode_diff']!r}; the plain path's logits move by "
          f"{pf['ulp_diff']!r} when each embedding value moves by one bf16 "
          f"ulp")
    fp = rwkv_fp32_phase(torch, rcfg, pf["tokens"])
    print(f"[forward] rwkv6-3b fp32, same seed: max |kernel - plain| logits "
          f"{fp['plain_diff']!r} (tolerance {LOGITS_ATOL}; max |logit| "
          f"{fp['max_logit']!r}), argmax agrees at {fp['plain_argmax']!r} of "
          f"positions")
    print(f"[decode] rwkv6-3b fp32: {DECODE_T} tokens of {PREFILL_B} "
          f"prompts through decode_step: max |decode - forward| logits "
          f"{fp['decode_diff']!r} (tolerance {LOGITS_ATOL}), argmax agrees "
          f"at {fp['decode_argmax']!r} of positions")
    rs = serve_phase(torch, rcfg, params, per_step(rcfg))
    print_serve("rwkv6-3b", rs)

    works = {"rwkv_scan": scan_work(torch, pf.pop("launches")),
             "rowstream_matmul on rwkv6-3b": rowstream_work(
                 torch, rwkv_weights(rcfg, params), SLOTS)}
    works["rwkv_scan"]["per"] = (f"one rwkv6-3b forward at b {PREFILL_B} x "
                                 f"s {PREFILL_S}")
    works["rowstream_matmul on rwkv6-3b"]["per"] = \
        f"one rwkv6-3b decode step at {SLOTS} slots"
    time_works(works)     # CUDA-event walls first, then the profiler
    fb = forward_breakdown(torch, rcfg, params, {"tokens": pf["tokens"]},
                           {"rwkv_scan": RS_KERNELS})
    print_split("rwkv6-3b forward", fb, pf["forward_ms"])
    rbd = step_breakdown(torch, rcfg, params,
                         per_step(rcfg)["rowstream_matmul"])
    print_breakdown("rwkv6-3b", rbd, rs["median_step_ms"])
    works = {name: numbers(w) for name, w in works.items()}
    del params, pf["tokens"]
    lap("rwkv6-3b forward, serve and their profiled parts")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    train_prof = train_profiled(torch, train)
    works["rwkv_scan_bwd"] = train_prof["rwkv_scan_bwd"]
    check_rwkv_scan_bwd_launches(torch, dev)
    train_tp["kernels"] = train_tp_kernels(torch, train_tp)
    train_s += time.perf_counter() - t0
    print(f"[run] the training phases took {train_s:.0f} s")
    lap("training profiled, 1x2 kernels timed")
    moe_tp["kernels"] = moe_tp_kernels(torch)
    zamba_tp["kernels"] = zamba2_tp_kernels(torch)
    lap("rowstream_matmul and flash_decode_partial on a rank's shards")

    # qwen2-7b and granite again, from the same seed, for their profiled
    # parts.
    from repro_torch.models import layers, moe
    attention = (layers, "attention_scores", "attention")
    params = init_params(torch, qcfg)
    qworks = {"flash_decode": flash_work(torch, qcfg, SLOTS, MAX_SEQ),
              "rowstream_matmul": rowstream_work(
                  torch, qwen_weights(qcfg, params), SLOTS)}
    for name, w in qworks.items():
        w["wall_ms"] = walls[name]
        w["per"] = f"one qwen2-7b decode step at {SLOTS} slots"
    time_works(qworks)
    qbd = step_breakdown(torch, qcfg, params,
                         per_step(qcfg)["rowstream_matmul"])
    print_breakdown("qwen2-7b", qbd, sv["median_step_ms"])
    qfb = forward_breakdown(torch, qcfg, params, qf["batch"],
                            labels=[attention])
    print_split("qwen2-7b forward", qfb, qf["forward_ms"])
    works.update((name, numbers(w)) for name, w in qworks.items())
    del params, qworks
    torch.cuda.empty_cache()

    params = init_params(torch, gcfg)
    experts = (moe, "_experts", "experts")
    gbd = step_breakdown(torch, gcfg, params,
                         per_step(gcfg)["rowstream_matmul"],
                         labels=[experts])
    print_breakdown("granite-moe-3b", gbd, gs["median_step_ms"])
    gfb = forward_breakdown(torch, gcfg, params, gf["batch"], labels=[
        experts, (moe, "moe_ffn", "routing, dispatch and combine"),
        attention])
    print_split("granite-moe-3b forward", gfb, gf["forward_ms"])
    gbound = rowstream_work(torch, granite_weights(gcfg, params), SLOTS)
    gbound_ms = gbound["bound_ms"]
    print(f"[bound] rowstream_matmul on one granite-moe-3b decode step: "
          f"{gbound['launches_per_step']} products, {gbound['bytes']} bytes, "
          f"bound {gbound_ms!r} ms ({gbound['bound_by']})")
    del params, gbound
    torch.cuda.empty_cache()

    lap("qwen2-7b and granite-moe-3b profiled")
    zworks, zproducts = zamba2_profiled(torch, z)
    lap("zamba2-1.2b profiled")
    works.update(zworks)
    cross_prof = {name: cross_profiled(torch, c) for name, c in cross.items()}
    lap("whisper-small and llama-3.2-vision profiled")
    long_fd = flash_phase(FD_LENGTHS[1:])
    check_rowstream_launches(torch, dev)
    lap("flash_decode at long context, rowstream_matmul launches")

    paths = {"qwen2-7b serve": sv["counts"],
             "qwen2-7b serve on a 1x1 mesh": mesh_one["mesh_1x1"]["counts"],
             "qwen2-7b serve again": mesh_one["meshless_again"]["counts"],
             "qwen2-7b forward": qf["counts"],
             "granite-moe-3b serve": gs["counts"],
             "granite-moe-3b forward": gf["counts"],
             "rwkv6-3b forward": pf["counts"],
             "rwkv6-3b serve": rs["counts"],
             "zamba2 serve": z["serve"]["counts"],
             "zamba2 forward": z["forward"]["counts"],
             "whisper-small serve": cross[WHISPER]["serve"]["counts"],
             "whisper-small forward": cross[WHISPER]["forward"]["counts"],
             "llama-3.2-vision serve": cross[MLLAMA]["serve"]["counts"],
             "llama-3.2-vision forward": cross[MLLAMA]["forward"]["counts"],
             "rwkv6-3b train": train["counts"],
             "rwkv6-3b resumed train": train["ckpt"]["counts"]}
    for r, steps in enumerate(train_tp["counts"]):
        paths[f"rwkv6-3b train on 1x{TP_RANKS}, rank {r}"] = {
            n: sum(c[n] for c in steps) for n in steps[0]}
    paths[f"{GRANITE} serve on a 1x1 mesh"] = \
        moe_tp["mesh_1x1"]["mesh_1x1"]["counts"]
    for name, c in moe_tp["meshless_counts"].items():
        paths[f"{name} serve before its mesh runs"] = c
    for name, runs in moe_tp["models"].items():
        for mesh, r in runs.items():
            for dt in ("float32", "bfloat16"):
                for rank, c in enumerate(r.get(dt, {}).get("counts", [])):
                    paths[f"{name} {dt} fed steps on {mesh}, rank {rank}"] \
                        = c
            for rank, c in enumerate(r.get("serve", {}).get("counts", [])):
                paths[f"{name} serve on {mesh}, rank {rank}"] = c
    paths[f"{ZAMBA} serve on a 1x1 mesh"] = \
        zamba_tp["mesh_1x1"]["mesh_1x1"]["counts"]
    paths[f"{ZAMBA} serve before its mesh runs"] = zamba_tp["meshless_counts"]
    for dt, r in zamba_tp["models"]["1x2"].items():
        for rank, c in enumerate(r.get("counts", [])):
            paths[f"{ZAMBA} {dt} fed steps on 1x2, rank {rank}"] = c
    for name in (WHISPER, MLLAMA):
        paths[f"{name} serve on a 1x1 mesh"] = \
            cross_tp["mesh_1x1"][name]["mesh_1x1"]["counts"]
        paths[f"{name} serve before its mesh runs"] = \
            cross_tp["meshless_counts"][name]
        for dt, r in cross_tp["models"][name]["1x2"].items():
            for rank, c in enumerate(r.get("counts", [])):
                paths[f"{name} {dt} fed steps on 1x2, rank {rank}"] = c
    # rwkv_scan_bwd is the gradient of the rwkv_scan TPU kernel, which the
    # JAX package takes by autodiff of its jnp scan (no Pallas backward).
    replaces = {"flash_decode": "src/repro/kernels/flash_decode/kernel.py:74",
                "rowstream_matmul":
                    "src/repro/kernels/rowstream_matmul/kernel.py:49",
                "rwkv_scan": "src/repro/kernels/rwkv_scan/kernel.py:93",
                "rwkv_scan_bwd": "src/repro/kernels/rwkv_scan/kernel.py:93"}
    kernels = []
    for name, line in replaces.items():
        t = works[name]
        entry = {
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu", "replaces": line,
            "launches": sum(c[name] for c in paths.values()),
            "max_abs_err": errs[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "wall_ms": t["wall_ms"],
            "per": f"{t['per']}: {t['launches_per_step']} launches",
            "launches_by_path": {p: c[name] for p, c in paths.items()}}
        if name == "rowstream_matmul":
            entry["moe_tp_shards"] = moe_tp["kernels"]["rowstream_matmul"]
            entry["zamba2_tp_shards"] = \
                zamba_tp["kernels"]["rowstream_matmul"]
            entry["on_rwkv6_step"] = works["rowstream_matmul on rwkv6-3b"]
            entry["on_zamba2_step"] = works[
                "rowstream_matmul on zamba2-1.2b"]
            entry["zamba2_products"] = zproducts
            entry["granite_step_bound_ms"] = gbound_ms
            for m, cp in cross_prof.items():
                entry[f"on_{m}_step"] = cp["works"][f"{name} on {m}"]
                entry[f"{m}_products"] = cp["products"]
        if name in ("rwkv_scan", "rwkv_scan_bwd"):
            entry["train_tp"] = {
                k: w for k, w in train_tp["kernels"]["works"].items()
                if k.split(" on ")[0] == name}
        if name == "rwkv_scan_bwd":
            entry["gradient_of"] = "rwkv_scan"
            entry["train"] = {k: v for k, v in train.items()
                              if k not in ("counts", "per_step")}
            entry["train_split"] = train_prof["split"]
        if name == "flash_decode":
            entry["partial"] = {"checks": partial,
                                "per_launch": long_fd.pop("partial")}
            entry["mesh"] = {"1x1": numbers_of_serve(mesh_one),
                             "1x2": mesh_two}
            entry["moe_tp_partial"] = moe_tp["kernels"]["flash_decode_partial"]
            entry["zamba2_tp_partial"] = \
                zamba_tp["kernels"]["flash_decode_partial"]
            entry["zamba2_tp"] = {k: v for k, v in zamba_tp.items()
                                  if k != "kernels"}
            entry["cross_tp"] = cross_tp
            entry["long_context"] = long_fd
            entry["paged_pool"] = z["pool"]
            for m, cp in cross_prof.items():
                entry[f"cross_on_{m}"] = cp["works"][f"cross {name} on {m}"]
        kernels.append(entry)
    print(f"[run] {time.perf_counter() - t_start:.0f} s from the card line "
          f"to the kernels line")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


def numbers_of_serve(mesh_one: dict) -> dict:
    """The 1x1-mesh phase's step times and launches, without its runs."""
    return {name: {k: sv[k] for k in ("counts", "steps", "median_step_ms",
                                      "mean_step_ms", "first_step_ms")}
            for name, sv in mesh_one.items()}


def numbers(work: dict) -> dict:
    """A timed work's results, without the closures that hold its
    tensors."""
    return {k: v for k, v in work.items() if not callable(v)}


def init_params(torch, cfg) -> dict:
    from repro_torch.models.registry import get_adapter
    t0 = time.perf_counter()
    params = get_adapter(cfg).init(
        torch.Generator(device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    n_bytes = sum(t.numel() * t.element_size() for t in _tensors(params))
    print(f"[init] {cfg.name} full width, {cfg.dtype}, {n_bytes / 1e9:.2f} GB of "
          f"weights in {time.perf_counter() - t0:.1f} s")
    return params


def per_step(cfg) -> dict:
    """Each kernel's launches in one decode step of `cfg`: no rwkv_scan,
    and no backward."""
    return dict(_rowstream_flash_per_step(cfg), rwkv_scan=0,
                rwkv_scan_bwd=0)


def _rowstream_flash_per_step(cfg) -> dict:
    if cfg.family == "audio":
        # Per layer self q, k, v, o, cross q, o and the MLP's up and down;
        # a self and a cross flash_decode; plus the tied head.
        return {"flash_decode": 2 * cfg.n_layers,
                "rowstream_matmul": 8 * cfg.n_layers + 1}
    if cfg.family == "vlm":
        # A dense layer's seven per self layer; q, o and the SwiGLU's three
        # per cross layer (its K/V are precomputed); plus the head.
        from repro_torch.models import mllama
        k, n_units = mllama._pattern(cfg)
        n_self = n_units * (k - 1)
        return {"flash_decode": n_self + n_units,
                "rowstream_matmul": 7 * n_self + 5 * n_units + 1}
    rm = RM_PER_LAYER[cfg.name] * cfg.n_layers + 1
    if cfg.family == "hybrid":
        from repro_torch.models import zamba2
        _, n_shared = zamba2._pattern(cfg)
        return {"flash_decode": n_shared,
                "rowstream_matmul": rm + len(SHARED_PRODUCTS) * n_shared}
    if cfg.family == "ssm":
        return {"flash_decode": 0, "rowstream_matmul": rm}
    return {"flash_decode": cfg.n_layers, "rowstream_matmul": rm}


def print_forward(name: str, f: dict) -> None:
    b, seq = f["tokens"].shape
    print(f"[forward] {name} bf16, {b} x {seq} tokens: "
          f"launches {f['counts']}; host time {f['forward_ms']!r} ms (first "
          f"call {f['first_ms']!r} ms)")


def print_decode(what: str, d: dict) -> None:
    print(f"[decode] {what}: {DECODE_T} tokens of each prompt through "
          f"decode_step, launches {d['counts']}: max |decode - forward| "
          f"logits {d['decode_diff']!r} (tolerance {LOGITS_ATOL}; max |logit| "
          f"{d['max_logit']!r}), argmax agrees at {d['decode_argmax']!r} of "
          f"positions")


def print_serve(name: str, sv: dict) -> None:
    per_step = {n: c // sv["steps"] for n, c in sv["counts"].items()}
    print(f"[serve] {name} bf16: {N_REQ} requests, {sv['steps']} steps, "
          f"{sv['generated']} tokens, {sv['tokens_per_s']!r} tok/s; step "
          f"median {sv['median_step_ms']!r} ms, mean {sv['mean_step_ms']!r} "
          f"ms, first {sv['first_step_ms']!r} ms; launches {sv['counts']} "
          f"({per_step} per step)")


def _tensors(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _tensors(v)
        else:
            yield v


def close_process_group() -> None:
    """Destroy the training driver's process group (its 1x1 mesh's NCCL
    communicator), if a phase made one."""
    if "torch" not in sys.modules:
        return
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    try:
        code = main()
    finally:
        close_process_group()
    sys.exit(code)
