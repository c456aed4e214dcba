#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --plain-peak ARCH  # PLAIN_TRAIN_PEAK's bytes

Builds the kernels from ``src/repro_torch/kernels/csrc`` and drives the
simulator's main path and the LM serving path through their public entry
points at full width:

  1. build     — one nvcc per source for sm_90a, all started together;
                 build seconds, the card's name and power limit, and the
                 host's MemTotal and CPU count;
     sass      — the wgmma kernels (tiled_gemm's TMA and in-place
                 kernels, fused_gemm, flash_attention's bf16 kernel,
                 ssd_chunk's and ssd_chunk_bwd's wgmma kernels) must hold
                 HGMMA in their SASS (cuobjdump), the four bf16
                 instantiations of tiled_gemm's in-place kernel and of
                 fused_gemm among them; flash_attention_bwd's bf16 kernel
                 (mma.sync) must hold HMMA;
     dryrun    — the dry-run matrix (repro_torch.launch.dryrun) on the
                 meta device: every (arch x shape) cell of the ten
                 architectures on both production meshes (16 x 16 and
                 2 x 16 x 16) at each arch's sharding recipe, 64 records
                 and 16 skips (long_500k for the 8 full-attention archs,
                 exactly cell_applicable's); no cell errors, every tensor
                 any operation returned on the meta device (a dispatch
                 mode watches), torch.cuda.memory_allocated unmoved, every
                 record's collective term a number (the sharded step's
                 collectives counted from the resolved specs); a few
                 cells' per-rank bytes, bound, collective term and
                 dominant term, and the phase's seconds, printed;
  2. kernels   — each contraction kernel (tiled_gemm, fused_gemm,
                 chain_gemm) at the shapes of the 30-qubit plan (its
                 largest tiled step, largest fused step, longest chain),
                 held against its plain PyTorch version on the card (max
                 error relative to max|plain| <= 1e-4: another summation
                 order than the library's), timed with CUDA events beside
                 its bound (tiled_gemm and fused_gemm, 3xTF32, against
                 the TF32 rate / 3; tiled_gemm on complex64 in place in
                 GEMM order and through ops.tiled_step, the path's call
                 on the step's native layouts, beside its real TMA route
                 and that route's plane split;
                 fused_gemm on complex64 in place and through
                 ops.fused_matmul, the path's call; chain_gemm as the
                 kernel alone on the profiler's device clock, with its
                 launch state built once, at each cluster size, for one
                 step of the chain, beside an empty cluster launch, and
                 through ops.fused_chain, the path's call); the bf16
                 routes of the three (bf16 inputs, fp32 accumulation; the
                 chain with every step bf16) at the same shapes, each
                 within 1e-5 of max|plain| of its plain twin (round to
                 bf16, then the fp32 product: only the order of the sum
                 differs; the chain step by step on its own carries, and
                 whole within 2^-8, a carry's bf16 rounding apart),
                 bounded at the bf16 rate; then
                 flash_attention at the prefill shapes of qwen3-4b,
                 deepseek-moe-16b (MHA, bh 64), qwen2-vl-72b (bh 256
                 on 32 kv heads) and llama4-scout-17b-a16e (bh 160 on
                 32: GQA group 5), batch 4 x 512, and of zamba2-7b (bh 32
                 on 32, 1 x 8192, head dim 112, window 4096: the bound
                 counts only the pairs the window leaves; SDPA takes the
                 band as a boolean mask), and seamless-m4t-medium's
                 encoder and cross-attention (bh 64 on 64, d 64,
                 non-causal, s 512; the cross-attention's 512 queries on
                 1024 keys) (bf16, <= 1e-2: the output's bf16 rounding
                 alone is 2^-8; each beside SDPA and its bound), and
                 ssd_chunk at mamba2-130m's (fp32, <= 1e-4; its wgmma
                 route, the kernel alone on the profiler's device clock,
                 beside its simt route at the same shape, and an
                 overflowing decay through the wgmma route); the backward
                 kernels at the training shapes, each route: flash_attention_bwd
                 at qwen3-4b's (bf16, bh 64 on 16 kv heads, s 512, d 128,
                 causal), at seamless-m4t-medium's encoder (bh 64 on
                 64, s 512, d 64, non-causal) and at qwen2-vl-72b's (bh
                 128 on 16: GQA group 8) (<= 2e-2 of max|plain| per
                 gradient; its mma
                 route, which bf16 takes, beside its simt route forced on
                 the same inputs and SDPA's autograd backward) and
                 ssd_chunk_bwd at mamba2-130m's (fp32, batch 4 x 512;
                 <= 1e-4, also at overflowing decays; its wgmma route
                 beside its simt route forced), each route run twice for
                 the same bits; and flash_attention_bwd with a sliding
                 window on both routes, at a small shape (window 100,
                 q_offset 64: bf16 mma <= 2e-2, fp32 simt <= 1e-4) and at
                 zamba2-7b's training shape (bh 32, s 8192, d 112, window
                 4096, bf16, <= 2e-2; the bound counts the window's pairs
                 only; SDPA's autograd backward takes the band as a
                 boolean mask), every call counted as windowed on its
                 route;
  3. amplitude — simulate_amplitude on sycamore_like(5, 6, 14), 30 qubits,
                 every slice, held against the port's statevector on the
                 card (relative error <= 1e-3: fp32 sums over ~150 steps
                 and 2^|S| slices against ~600 fp32 gate applications);
                 its measured peak device memory against the planner's
                 certified peak (<= planned x 1.10 + 256 MiB: allocator
                 rounding, the kernels' launch tables and the dot
                 backend's blocks of at most 64 MiB);
     precision — the same circuit in peak-mode slicing at precision="fp32"
                 and at precision="auto", fidelity_tol=0.05: the auto plan
                 must demote steps to bf16, keep |S| <= the fp32 plan's,
                 stay within 0.05 of the statevector and within its
                 certified peak (as above), and launch every bf16 step
                 through a bf16 route (the counted bf16 launches equal
                 those its schedule asks for);
     trace     — a profiler trace of one slice of that plan: device busy
                 share and the kernels that take the time;
  4. sampling  — sample_bitstrings with the last 4 qubits open, 1000
                 samples; the batch against the einsum oracle backend and
                 the statevector;
     engine    — the contraction server (EngineServer, max_batch=32) on
                 samp30 with the sampling phase's planner seed and
                 restarts: first obs.calibrate_plan on one slice of the
                 amp30 plan (measured/modeled per backend class), then,
                 with the plan cache emptied, two bursts of the same
                 family, cold then warm: 16 amplitudes (0…0 outside
                 qubits 26-29, each of their 16 patterns) and 2 sampling
                 tenants (qubits 26-29 open, 1000 samples, sampler seeds
                 0 and 1).  Every amplitude within 1e-3 of the
                 statevector; the tenants' batches and every amplitude
                 answered from a batch over qubits 26-29 bitwise the
                 sampling phase's batch (same network, same plan, one
                 fixed summation order); a coalesced group in each burst;
                 in the warm burst every batch contraction a plan-cache
                 hit planned in < 1% of the cold plan's time, and
                 hoist-cache hits; each contraction's own peak (over the
                 bytes resident when it starts, measured by the execution
                 gate) within its certified peak (as above); never two
                 executions at once.  Prints each burst's wall, server
                 counters, and queue and compute latency (p50, max);
     search    — amp30 planned by the anytime plan search
                 (optimize="anytime", 64 evaluations, 4 workers, seed 0)
                 and executed through simulate_amplitude: evaluations,
                 search wall, trace points, improvement, log2 objective of
                 the one-shot seed and of the searched plan, |S|, certified
                 peak against the search's budget, exec_s beside the
                 amplitude phase's one-shot exec_s.  Checks: feasible,
                 improvement >= 1, the search.evals counter equals the
                 evaluations, the amplitude within 1e-3 of the
                 statevector, the measured peak within the certified peak
                 (as above).  Also samp30 searched at planner seed 0 on
                 the host, beside the one-shot plans of seeds 0 and 2;
     resume    — amp30's one-shot plan through contract_resumable(chunk=16)
                 with a simulated failure at range 32 (raised on purpose:
                 catching it is the point), then a resume at chunk=8 from
                 the state it left: within 1e-6 of |amp| of the amplitude
                 phase's value, each of the 128 ids summed exactly once,
                 the peak within the certified peak;
     multihost — the same plan through contract_multihost at world size 1
                 with a claim store in a temporary directory and a
                 simulated host failure after 2 ranges, then an epoch-1
                 resume (merged value within 1e-6 of |amp|, ids covered
                 exactly once, schedule_imbalance / steal_count /
                 overlap_fraction printed); then samp30 through
                 contract_sharded([cuda:0]) and sample_bitstrings(devices=
                 [cuda:0]), bitwise the sampling phase's batch (the same
                 summation order), and contract_sharded([cuda:0, cuda:0],
                 slice_batch=4) within 1e-6 (another order); a list
                 naming cuda:1 is refused.  One process
                 drives the card: two processes would break the
                 per-process execution gate and the one-contraction
                 certified peak;
  5. share     — open_session on sycamore_like(6, 6, 14), 36 qubits (more
                 than any statevector on one card holds), run_slices on 2
                 slice ids against the einsum oracle on the same ids; its
                 measured peak against the certified peak (as above);
  6. serve     — for qwen3-4b, mamba2-130m, deepseek-moe-16b and
                 seamless-m4t-medium: the full config (36, 24, 28 and
                 12 + 12 layers) through
                 repro_torch.launch.decode_demo.serve, and zamba2-7b's
                 (81 layers, the hybrid: its prompt 1 x 8192, twice its
                 window, so the window binds in prefill and decode wraps
                 its KV rings; its agreement at 7 layers, one group and
                 the shared block and one tail layer, fp32 on 4608
                 tokens and 4 decode steps, bf16 on 256 tokens; every K4
                 launch of its serve the windowed wgmma kernel, of its
                 fp32 agreement the windowed FFMA kernel, every
                 ssd_chunk launch wgmma); for qwen2-vl-72b
                 (80 layers, 145 GB in bf16) its published widths at 8
                 layers through the same steps (decode_demo's
                 prompt_inputs, with the stub frontend's embeddings and
                 M-RoPE positions, then generate), and for
                 llama4-scout-17b-a16e (48 layers, 215 GB) its published
                 widths at 8 layers likewise (16 routed experts, top 1,
                 1 shared; every K4 launch the wgmma kernel at bh 160 on
                 32 kv heads; the prefill's dropped slots at 160 slots
                 an expert recorded, layer by layer; its agreement's
                 CPU run takes the card's routing decisions and
                 attention inputs, its own and a free CPU run's logits
                 reported); batch 4, prompt 512,
                 32 tokens, finite logits of the right shapes, peak
                 device memory, the decode step beside its weights'
                 bound; the card's prefill logits against the port's own
                 CPU run on the same weights and prompt, at full width:
                 in bf16 at 2 layers <= 3e-2 of max|logit| (the bf16
                 attention tolerance of the JAX suite), in fp32 (the
                 attention models at 2 layers, deepseek-moe-16b's layer
                 0 dense and layer 1 MoE, llama4-scout-17b-a16e's both
                 MoE; mamba2-130m whole) <= 1e-3, with
                 the MoE layer's routing decisions that differ between
                 the card and the CPU counted; the encoder-decoder at
                 2 + 2 layers, 256 frames and 128 tokens, then 4 decode
                 steps, prefill and every step's logits fp32 <= 1e-3,
                 bf16 <= 3e-2, its CPU run taking the card's attention
                 inputs (its hard attention turns one rounding of q or k
                 into other weights; the free CPU run reported), every
                 serve K4 launch on the wgmma kernel, 12 of them
                 non-causal in its encoder and 12 in its
                 cross-attention, its fp32 agreement's on the FFMA
                 kernel; profiler traces of one
                 prefill and one decode step at the serve shapes, with
                 each kernel's share of the device time and, for MoE, the
                 shares of the expert products and the dispatch; the
                 phase's flash_attention launches (every attention
                 model) and ssd_chunk launches must be > 0, and every
                 ssd_chunk launch must take its wgmma route; after each
                 serve, the served model's parameters and a cache at the
                 serve's batch and length (init_cache) held leaf by leaf
                 to their abstract trees (meta tensors, shape and dtype),
                 their per-rank bytes on a 1 x 1 mesh equal to the card's
                 tensors' bytes exactly (world size 1); the prefill's
                 analytic bound on the H100 at batch x prompt beside its
                 prefill_s (a report, not a gate);
     train     — LM training on the card through the sharded step on a
                 one-rank nccl mesh (1, 1) ("data", "model"; the state's
                 blocks are the model's own tensors, the batch's rows the
                 whole batch), make_train_step with a TrainLayout
                 (chunked cross-entropy, AdamW, each layer checkpointed):
                 qwen3-4b at full width and depth, batch 2 x 512,
                 mamba2-130m, batch 4 x 512, deepseek-moe-16b at full
                 width and 5 layers (layer 0 dense), 2 x 512, its first
                 two steps run again from the same seed for the same
                 bits, and zamba2-7b at full width and 7 layers (one
                 group of 6 and the shared block, one tail layer), 1 x
                 8192 (twice its window), seamless-m4t-medium whole
                 (4 x 512 frames and tokens), and qwen2-vl-72b at full
                 width and 2 of its 80 layers, 2 x 512, on the stub
                 frontend's embeds and (3, B, S) M-RoPE positions (its
                 loss on a batch again the same bits and with the
                 height and width positions shifted another loss; every
                 K4 backward on mma, GQA group 8), 4 steps each: finite
                 losses,
                 the first within 0.1 of ln V + d s^2 / 2 (s the head's
                 init std: the logits of a random head have variance
                 d s^2), each parameter block the model's own tensor
                 (the same storage), step ms, tokens/s, peak
                 device memory (within 1% of the plain step's peak for
                 the same model and shapes, PLAIN_TRAIN_PEAK: bytes that
                 an earlier run measured, so the gate is tied to the
                 PyTorch and allocator of that run), a profiler
                 trace of one more step; the sharded step against the
                 plain one at 2
                 layers (TRAIN_AGREE's batch, seq and steps, bf16):
                 losses, grad norms and every parameter after 2 steps
                 equal bit for bit; the
                 training state after the steps held to abstract_state
                 leaf by leaf (every parameter, moment, count and step;
                 its bytes on a 1 x 1 mesh exact: world size 1), and a
                 step's analytic bound on the H100 beside the mean of
                 steps 2-4 (a report); the
                 card's first two steps of each at 2 layers against the
                 port's CPU run of the same weights and batch (loss and
                 grad norm: fp32 <= 1e-3, bf16 <= 3e-2 relative; a
                 step whose state no check reads, a run's last or one the
                 card's state replaces, computes them without the update;
                 qwen2-vl-72b at 1 layer, fp32 2
                 steps and bf16 1, its 2 layers' fp32 state not fitting
                 the card (TRAIN_AGREE_CUT, stated in the record); for the
                 MoE each step from the card's state, the CPU taking the
                 card's routing decisions, and a free CPU run with its
                 routing flips reported; the encoder-decoder likewise,
                 the CPU taking the card's attention inputs, 256 frames
                 and 128 tokens); the hybrid at 7 layers, 256
                 tokens, its window cut to 64: one backward held to the
                 port's CPU run in fp64 (fp32 loss <= 1e-3, grad norm and
                 gradients <= 1e-3 or no further than the CPU's fp32 run,
                 every block from the fp64 input and upstream gradient
                 <= 1e-3 in fp32 and 3e-2 in bf16); then the
                 llama3-100m example twin's configuration through the
                 launcher for 100 steps at seq 128 (finite, first loss as
                 expected), and the learning gate: llama3.2-3b's smoke
                 shrink for 200 steps (batch 4 x 128, lr 5e-3) must lower
                 its loss by > 0.1, through flash_attention's forward and
                 backward kernels.  flash_attention's and ssd_chunk's backward
                 kernels must be launched, qwen3-4b's bf16 steps through
                 flash_attention_bwd's mma route and every mamba2-130m
                 backward through ssd_chunk_bwd's wgmma route, every
                 zamba2-7b K4 backward windowed on mma (its fp32
                 agreement's on simt) and every K5 backward on wgmma, every
                 seamless-m4t-medium K4 backward on mma, 24 a step
                 non-causal (its fp32 agreement's on simt) (the
                 counts are zeroed before each model and read after it);
     tp_local  — the sharded step's products split over "model", rank by
                 rank, at published widths: qwen3-4b, 2 of its 36
                 layers, 2 x 512 tokens; seamless-m4t-medium, 1 encoder
                 and 1 decoder layer, 2 x 512 tokens on 1024 frames;
                 zamba2-7b, 1 mamba layer and the shared block, 1 x
                 8192; deepseek-moe-16b, its dense and first MoE layer,
                 2 x 512 tokens; qwen2-vl-72b, 1 layer, 2 x 512 tokens,
                 its attention on M-RoPE positions of an image of 16 x
                 16 patches and text (4 q heads on the kv head they
                 read at P = 16).  For P in 2, 4, 8, 16 each rank's blocks
                 (parallel.tp_local.BLOCKS: every attention on its H/P
                 q heads and its kv heads or the one its q heads read —
                 2 on 1 at P = 16 for qwen3-4b —, the encoder's
                 non-causal, the decoder's causal, the cross-attention's
                 sq 512 on sk 1024, the shared block's windowed at d
                 112; every SwiGLU on F/P columns; the Mamba-2 mixer on
                 112/P SSD heads; the MoE layer's MLP on 64/P routed
                 experts and 2816/P shared columns, the routing whole
                 on each rank) run alone (no group: each conjugate
                 all-reduce the identity; the mixer's norm statistic
                 replayed from the ranks' sums, its ranks in three
                 passes), their outputs, input gradients (the memory's
                 too) and weight gradients summed (or laid side by side)
                 against the whole blocks' in fp32 (1e-5 of max|whole|)
                 and bf16 (3e-2) — in fp32 seamless-m4t-medium's,
                 zamba2-7b's and qwen2-vl-72b's attention blocks run on
                 the ranks' own
                 inputs (reported) and then with the whole block's
                 q, k and v replayed into each rank (held, the ranks'
                 own within 1e-5 of them), qwen2-vl-72b's in bf16 too
                 (within 3e-2); K4 and its backward launched
                 once for each whole attention and once for each rank's
                 in each run, on the type's route (fp32 simt, bf16 wgmma
                 and mma) and
                 non-causal or windowed as the block is, K5 and its
                 backward on wgmma once for the whole mixer and once for
                 each rank in each pass, the heads of every call
                 recorded;
     pipeline  — parallel.pipeline.pipeline_forward at world size 1 (a
                 one-rank "pod" axis on nccl) over 2 decoder layers of
                 qwen3-4b's published widths, 4 microbatches of 1 x 512
                 (K4 and its backward): the schedule's loop and its
                 broadcast (forward and backward) on the card, with no
                 hand-off (send/recv needs two stages: the CPU tests
                 run those); the output equal bit for bit to the layer
                 stack applied to each microbatch, one backward's
                 gradients equal to the stack's, bubble_fraction as the
                 GPipe formula; its seconds and launches;
  7. kernels   — one JSON line listing every kernel with its launches on
                 its path (phases 3-5, engine, search, resume and
                 multihost for the contraction kernels, the
                 serve phase for the LM kernels, the train phase for their
                 backward kernels; each must be > 0) and
                 its design (wgmma-bf16, 3xtf32-wgmma, cluster-simt-fp32),
                 and the bf16 routes of tiled_gemm and fused_gemm
                 with their launches in the precision phase, and
                 flash_attention at deepseek-moe-16b's, qwen2-vl-72b's,
                 zamba2-7b's and llama4-scout-17b-a16e's shapes with
                 their launches serving those models, at
                 seamless-m4t-medium's encoder and
                 cross-attention shapes with the non-causal launches of
                 each serving it, flash_attention_bwd's non-causal record
                 with its non-causal launches training seamless-m4t-medium,
                 its windowed record with its launches training
                 zamba2-7b and its group-8 record with its launches
                 training qwen2-vl-72b, and flash_attention and
                 flash_attention_bwd
                 on one rank's heads of qwen3-4b, of seamless-m4t-medium's
                 encoder and cross-attention and of zamba2-7b's shared
                 block, and ssd_chunk and ssd_chunk_bwd on one rank's
                 heads of zamba2-7b's mixer, for each P of tp_local with
                 their bf16 launches there (one a layer, rank and pass);
                 every fused_gemm launch of those phases must
                 have taken the wgmma kernel with the coalesced (uniform)
                 gather.

Each phase prints one JSON line; any failed check raises, so the exit code
is non-zero.  The last line is the device summary.  With no CUDA device,
or without the repository around it, the script fails before printing any
result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

FP32_PEAK = 67e12  # H100 SXM data sheet, FP32 on the CUDA cores
BF16_PEAK = 989e12  # H100 SXM data sheet, dense bf16 tensor cores
TF32_PEAK = 495e12  # H100 SXM data sheet, dense TF32 tensor cores
HBM_BW = 3.35e12  # H100 SXM data sheet, HBM3
KERNEL_TOL = 1e-4
BF16_ROUTE_TOL = 1e-5  # bf16 products are exact in fp32: sum order only
# a chain of bf16 steps against the plain chain: a carry rounded to bf16
# from two fp32 sums of another order may land one bf16 ulp apart, which
# read 5.04e-5 on the H100.  The same chain with its carries left
# unrounded (bf16 externals, fp32 steps) must read above this limit: the
# smoke checks that too (readings in PERF.md §6).
BF16_CHAIN_TOL = 5e-4
PRECISION_TOL = 0.05  # the auto plan's XEB budget, against the statevector
# measured peak device memory <= planned x PEAK_MARGIN + PEAK_SLACK: the
# slack covers the allocator's rounding, the kernels' launch tables and
# the dot backend's blocks (lowering/gemm_form._dot, 64 MiB each)
PEAK_MARGIN = 1.10
PEAK_SLACK = 256 << 20
FLASH_TOL = 1e-2  # bf16 output: its rounding alone is 2^-8 = 3.9e-3
AMP_TOL = 1e-3
# card against CPU prefill logits, relative to max|logit|.  bf16: the JAX
# suite's bf16 attention tolerance.  Random weights amplify bf16 rounding
# with depth (bf16 against fp32 logits differ 0.5% at 2 layers of
# qwen3-4b, 14% at 24 of mamba2-130m, on the H100), so the bf16 check
# runs 2 layers.  fp32: other summation orders only; the readings were
# 1.9e-6 (qwen3-4b, 2 layers) and 3.1e-5 (mamba2-130m, 24 layers).
SERVE_TOL = 3e-2
SERVE_TOL_FP32 = 1e-3
BF16_LAYERS = 2
TPU_KERNELS = {
    "tiled_gemm": "src/repro/kernels/contract_gemm.py:45",
    "fused_gemm": "src/repro/kernels/contract_gemm.py:164",
    "chain_gemm": "src/repro/kernels/contract_gemm.py:421",
    "flash_attention": "src/repro/kernels/flash_attention.py:71",
    "ssd_chunk": "src/repro/kernels/mamba2_ssd.py:57",
    # no TPU kernel: the reference differentiates these jnp functions
    "flash_attention_bwd": "src/repro/models/layers.py:131",
    "ssd_chunk_bwd": "src/repro/models/layers.py:393",
}
# how each kernel computes (the route of every kernel is CUDA C++)
DESIGNS = {
    "tiled_gemm": "3xtf32-wgmma",
    "fused_gemm": "3xtf32-wgmma",
    "chain_gemm": "cluster-simt-fp32",
    "flash_attention": "wgmma-bf16",  # its fp32 inputs take simt-fp32
    "ssd_chunk": "3xtf32-wgmma",  # shapes outside its rule take simt-fp32
    "flash_attention_bwd": "mma-bf16",  # its fp32 inputs take simt-ffma
    "ssd_chunk_bwd": "3xtf32-wgmma",  # shapes outside its rule take simt-ffma-fp32
}
# how each bf16 route computes
BF16_DESIGNS = {"tiled_gemm": "bf16-wgmma", "fused_gemm": "bf16-wgmma"}
# the kernels that must run on the tensor cores: (library, CUDA kernel)
WGMMA_KERNELS = {
    "tiled_gemm": ("gemm", "tiled_gemm_kernel"),
    "fused_gemm": ("gemm", "fused_gemm_kernel"),
    "flash_attention": ("flash_attention", "flash_attention_wgmma_kernel"),
    "ssd_chunk": ("mamba2_ssd", "ssd_chunk_wgmma_kernel"),
    "ssd_chunk_bwd": ("mamba2_ssd", "ssd_chunk_bwd_wgmma_kernel"),
}
# the kernels that must run on the tensor cores through mma.sync (HMMA)
MMA_KERNELS = {
    "flash_attention_bwd": ("flash_attention", "fa_bwd_mma_kernel"),
}
# the kernels whose bf16 instantiations (the third template argument
# true) must hold HGMMA: 4 each (complex or real, 64- or 128-wide tile)
BF16_INSTANCES = ("tiled_gemm", "fused_gemm")
# kernels whose share of a trace's device time the traces report
TRACED_KERNELS = ("tiled_gemm", "fused_gemm", "chain_gemm",
                  "flash_attention", "ssd_chunk", "fa_bwd", "fa_bwd_mma",
                  "ssd_chunk_bwd", "ssd_chunk_bwd_wgmma", "ssd_bwd_group_sum")
# the bf16 routes the precision phase launches: their records in the
# kernels line.  chain_gemm's bf16 route (per-step precisions) is held
# against its plain twin in the kernels phase, but no plan of this
# script's circuits puts a bf16 step in a chain: the steps demoted to
# bf16 run on tiled_gemm and fused_gemm, whose operands exceed a chain's
# workspace budget.
BF16_ROUTES = ("tiled_gemm", "fused_gemm")
SOURCES = {
    "tiled_gemm": "src/repro_torch/kernels/csrc/gemm.cu",
    "fused_gemm": "src/repro_torch/kernels/csrc/gemm.cu",
    "chain_gemm": "src/repro_torch/kernels/csrc/gemm.cu",
    "flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "ssd_chunk": "src/repro_torch/kernels/csrc/mamba2_ssd.cu",
    "flash_attention_bwd": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "ssd_chunk_bwd": "src/repro_torch/kernels/csrc/mamba2_ssd.cu",
}
CHAIN_CLUSTERS = (1, 2, 4, 8, 16)  # K3's cluster sizes timed
SERVE = dict(batch=4, prompt_len=512, gen_tokens=32, seed=0)
# the served models, each with its cut of depth (None: the published
# depth; qwen2-vl-72b's 80 layers hold 145 GB in bf16, 8 of them 20 GB,
# cut from 16 for the smoke's time once it also trains the model;
# llama4-scout-17b-a16e's 48 hold 215 GB, 8 of them 39.4 GB) and the
# depth of its traces (None: the served depth; qwen3-4b's per layer the
# same at 2 layers)
# zamba2-7b serves its own prompt: one sequence of 8192 tokens, twice its
# window of 4096, so the window binds in prefill and decode wraps the ring
# (8192 % 4096 == 0: the reference's own ring layout agrees there)
# replay: the agreement's CPU run takes the card's routing decisions and
# attention inputs (``_replayed``: the encoder-decoder's always does, and
# holds its logits only), holds its own attention inputs against the
# card's at the type's tolerance, and reports a free CPU run's logits
# beside them.  llama4-scout-17b-a16e routes each token to one expert of
# 16, so one decision flipped by a rounding swaps the token's whole routed
# output, and its attention is as hard as the encoder-decoder's at the
# reference's init (scores of std ~128: no q/k norm): on the H100 its bf16
# prefill logits read 3.37e-2 of max|logit| from the CPU's free run and
# with the routing alone replayed (11 decisions of its last layer
# flipped, none of the last token's), 4.65e-3 with the attention inputs
# replayed too (their own 6.4e-3 apart)
SERVE_MODELS = {
    "qwen3-4b": dict(layers=None, trace_layers=2),
    "mamba2-130m": dict(layers=None, trace_layers=None),
    "deepseek-moe-16b": dict(layers=None, trace_layers=None),
    "qwen2-vl-72b": dict(layers=8, trace_layers=None),
    # 40 query heads on 8 kv heads (K4 at GQA group 5), 16 routed
    # experts, top 1, and 1 shared expert in every layer, V 202 048
    "llama4-scout-17b-a16e": dict(layers=8, trace_layers=None, replay=True),
    "zamba2-7b": dict(layers=None, trace_layers=None, batch=1,
                      prompt_len=8192),
    # the encoder-decoder whole (12 + 12 layers); its frames are the
    # prompt's length, as in the reference's demo
    "seamless-m4t-medium": dict(layers=None, trace_layers=None),
}
# K4's records: the key in the kernels line -> the prefill shape of the
# served model it times (batch B, query heads H, kv heads KV, sequence
# S, keys Sk (None: S), head dim d, window, causal; K4_DEFAULT where not
# given).  seamless-m4t-medium's encoder (non-causal) and its
# cross-attention, whose 512 queries here meet 1024 frames' keys (its
# serve couples frames to the prompt, 512 each)
K4_DEFAULT = dict(B=4, S=512, Sk=None, d=128, window=0, causal=True)
K4_SHAPES = {
    "flash_attention": dict(H=32, KV=8),  # qwen3-4b
    "flash_attention:deepseek-moe-16b": dict(H=16, KV=16),
    "flash_attention:qwen2-vl-72b": dict(H=64, KV=8),
    "flash_attention:zamba2-7b": dict(B=1, H=32, KV=32, S=8192, d=112,
                                      window=4096),
    "flash_attention:seamless-m4t-medium": dict(H=16, KV=16, d=64,
                                                causal=False),
    "flash_attention:seamless-m4t-medium:cross": dict(H=16, KV=16, d=64,
                                                      Sk=1024, causal=False),
    # GQA group 5: bh 160 on 32 kv heads
    "flash_attention:llama4-scout-17b-a16e": dict(H=40, KV=8),
}
# K4's backward records beside qwen3-4b's: seamless-m4t-medium's encoder
# shape at training (4 x 512, non-causal), and qwen2-vl-72b's training
# shape (2 x 512, 64 query heads on 8 kv heads: GQA group 8, bh 128 on 16)
K4_BWD_SHAPES = {
    "flash_attention_bwd": dict(B=2, H=32, KV=8, S=512, d=128, causal=True),
    "flash_attention_bwd:seamless-m4t-medium": dict(B=4, H=16, KV=16, S=512,
                                                    d=64, causal=False),
    "flash_attention_bwd:qwen2-vl-72b": dict(B=2, H=64, KV=8, S=512, d=128,
                                             causal=True),
}
# the hybrid's card-against-CPU agreement: 2 layers hold no attention (the
# shared block follows every 6th mamba layer), so it runs 7 of the 81:
# one group of 6 and the shared block, then one tail layer.  fp32 on a
# prompt of 4608 tokens, so the window of 4096 binds on the last 512
# queries, and 4 decode steps after it, the ring wrapping on the side
# where 4608 % 4096 != 0; bf16 on AGREE's prompt.  Besides the fp32
# prefill logits, each block, in the prefill and in every decode step,
# runs on the card from the CPU's input to it and is held to the CPU's
# output (fp32 1e-3, bf16 3e-2 of max|value|).  That is the gate of the
# decode steps and of bf16: the reference's init takes the head count as
# wq's and wk's fan-in, so the shared block's attention scores reach ~740
# (std ~113) at the published widths, hard attention that turns the
# carried states' rounding (fp32, over the decode steps) and single bf16
# roundings of q and k into other attention weights (PERF.md §6, PR 23);
# those logits' readings are reported
HYBRID_AGREE = dict(layers=7, prompt_len=4608, decode_steps=4)
# the spans the MoE traces read: the whole layer, its routing (router,
# top-k, positions in the experts) and its three expert products; the
# dispatch's share is the layer's less the products'
MOE_SPANS = {"moe_layer": "moe.layer", "moe_route": "moe.route",
             "expert_ffn": "moe.experts"}
AGREE = dict(batch=1, prompt_len=256)  # the CPU half of the agreement
# the encoder-decoder's agreement: AGREE's prompt as frames, the decoder
# on the first 128 of its tokens (so the cross-attention's queries and
# keys differ in length: sq 128 on sk 256), then 4 decode steps
ENCDEC_AGREE = dict(tokens=128, decode_steps=4)
FLASH_BWD_TOL = 2e-2  # bf16 gradients: each output's rounding is 2^-8
# K4's windowed backward record: zamba2-7b's training shape (its shared
# block's attention at 1 x 8192, twice its window)
K4_BWD_WINDOW = dict(B=1, H=32, KV=32, S=8192, d=112, window=4096)
# training: batch and seq per model, and its depth (None: the published
# depth), TRAIN_STEPS steps each.  deepseek-moe-16b's 28 layers are
# 16.4 B parameters: with bf16 weights and gradients and fp32 moments
# (12 bytes each) ~197 GB, so it trains layer 0 (dense) and 4 MoE layers
# (2.85 B, ~34 GB).  zamba2-7b trains one group of 6 mamba layers and the
# shared block, then one tail layer (2 layers hold no attention), on one
# sequence of 8192 tokens, twice its window, so the window binds in the
# backward too.  qwen2-vl-72b trains 2 of its 80 layers (4.247 B
# parameters, ~51 GB of state; the embedding and the untied head hold
# 1.246 B each) on the stub frontend's embeds with M-RoPE positions
TRAIN = {
    "qwen3-4b": dict(batch=2, seq=512),
    "mamba2-130m": dict(batch=4, seq=512),
    "deepseek-moe-16b": dict(batch=2, seq=512, layers=5),
    "zamba2-7b": dict(batch=1, seq=8192, layers=7),
    # whole (977.8 M parameters, ~11.7 GB of state), 512 frames and 512
    # tokens a sequence
    "seamless-m4t-medium": dict(batch=4, seq=512),
    "qwen2-vl-72b": dict(batch=2, seq=512, layers=2),
}
TRAIN_STEPS = 4
MOE_REPEAT = 2  # an MoE model's first steps, run twice for the same bits
# the agreement's CPU half: 2 layers (an MoE model's layer 0 dense, layer
# 1 MoE), 2 steps, one sequence of 128 tokens; the hybrid's one backward
# at 7 layers (as its serve agreement) on 256 tokens, its window cut to 64
# so that it binds (the record states it as window_cut)
TRAIN_AGREE = dict(batch=1, seq=128, steps=2, layers=2, lr=1e-4)
HYBRID_TRAIN_AGREE = dict(batch=1, seq=256, layers=7, window=64)
# a model's own cut of TRAIN_AGREE, and why (the record states both):
# qwen2-vl-72b's 2 layers hold 4.247 B parameters, 68 GB of fp32 state
# (weights, gradients, two moments) on the card before the update's
# temporaries and as much on the host, so its agreement runs 1 layer
# (3.369 B, 53.9 GB on each side) at the published widths; its CPU half
# (steps over the 1.246 B-row embedding and head on the host) is most of
# the phase's time (PERF.md §6), so bf16 runs one step and fp32 keeps
# both, so that the update is held once
TRAIN_AGREE_CUT = {
    "qwen2-vl-72b": dict(
        layers=1, bf16_steps=1,
        reason="2 layers hold 68 GB of fp32 training state on the card and "
               "on the host; the CPU half is most of the phase's time, so "
               "bf16 runs one step (fp32 two: the update is held once)"),
}
TRAIN_TOL = {"fp32": 1e-3, "bf16": 3e-2}
EXAMPLE_STEPS = 100  # the llama3-100m twin, seq 128
# the learning gate: the synthetic stream (next = prev + delta mod V) is
# learned only where each token id is seen often; at the twin's V of
# 32000, 100 steps of 512 tokens show most ids once or twice, and
# neither package's twin lowers its loss (PERF.md §6).  The
# reference's own learning test's model (V 512) learns it: over 200
# steps its loss must drop > 0.1 on the card.  Sequences of 128 take
# the flash kernel's forward and backward, which must launch.
LEARN = dict(arch="llama3.2-3b", steps=200, batch=4, seq=128, lr=5e-3)
# the train phase's peak device memory of each model through the plain
# step, as this script measured it before the steps went through the
# sharded one, or with --plain-peak (NVIDIA H100 80GB HBM3 at 700 W; the
# same bytes in two calls): the sharded step on one rank must stay within
# PEAK_SAME of it,
# its blocks being the model's own tensors.  The bytes are that run's
# PyTorch and allocator's: another version may move them with no change
# here (the storage itself is checked block by block)
PLAIN_TRAIN_PEAK = {
    "qwen3-4b": 59465043456,
    "mamba2-130m": 3832926208,
    "deepseek-moe-16b": 37617935872,
    "zamba2-7b": 15025669632,
    "seamless-m4t-medium": 20416514048,
    # --plain-peak qwen2-vl-72b (torch 2.11.0+cu128)
    "qwen2-vl-72b": 70959735296,
}
PEAK_SAME = 0.01
ONE_RANK = ((1, 1), ("data", "model"))  # the train phase's live mesh
# the sharded step's products split over "model" (tp_local), at published
# widths, each of P ranks' blocks (parallel.tp_local.BLOCKS) run alone on
# the card, their partial outputs and input gradients summed, held
# against the whole blocks in fp32 (1e-5 of max|whole|) and bf16
# (TRAIN_TOL's 3e-2): qwen3-4b, 2 of its 36 layers, 2 x 512 tokens (H/P q
# heads; its kv heads where 8 divides P, else the one its q heads read: 2
# q heads on 1 at P = 16; F/P columns); seamless-m4t-medium, 1 encoder
# and 1 decoder layer, 2 x 512 tokens on 1024 frames (16/P heads of 64:
# the encoder's non-causal attention at 1024, the decoder's causal one at
# 512, the cross-attention's 512 queries on 1024 keys; F/P columns);
# zamba2-7b, 1 mamba layer and the shared block, 1 x 8192 (the mixer on
# 112/P SSD heads, 3 passes of its ranks; the shared block's windowed
# attention on 32/P heads of 112, F/P columns); deepseek-moe-16b, its
# dense layer and its first MoE layer, 2 x 512 tokens (the MoE layer's
# MLP on 64/P routed experts and F/P shared columns).  With ``replay`` the
# checks of the types it names feed each rank's attention the whole
# block's q, k and v of its heads (the rank's own held to them at the
# type's tolerance; gradients flow to the rank's projections), as the
# train phase's agreements replay attention
# inputs: without q/k norms the reference's init makes these attentions
# near hard (scores of std ~64 and ~112), and a rank's own q and k, one
# rounding from the whole's (cuBLAS takes other kernels for other product
# widths), move the summed blocks by ~1e-4 of max|whole| where the
# projections and SwiGLUs read 1e-6: those runs on the ranks' own inputs
# go first and are reported (``own_inputs_errors``), not held.  bf16 runs
# each rank on its own inputs, held, unless ``replay`` names it
TP_LOCAL = {
    "qwen3-4b": dict(layers=2, batch=2, seq=512, blocks=("attention", "mlp")),
    "seamless-m4t-medium": dict(
        layers=1, encoder_layers=1, batch=2, seq=512, frames=1024,
        blocks=("enc_attention", "enc_mlp", "self_attention",
                "cross_attention", "mlp"), replay=("fp32",)),
    "zamba2-7b": dict(layers=1, batch=1, seq=8192,
                      blocks=("mamba", "shared_attention", "shared_mlp"),
                      replay=("fp32",)),
    # one dense layer and one MoE layer: the MoE layer's MLP (64 routed
    # experts, 6 a token, 2 shared) on each rank's 64/P experts and its
    # shared experts' 2816/P columns, the routing whole on every rank
    "deepseek-moe-16b": dict(layers=2, batch=2, seq=512, blocks=("moe",)),
    # one layer: its attention on 64/P q heads (4 on the one kv head they
    # read at P = 16) with M-RoPE positions (VLM_GRID), its SwiGLU on
    # 29 568/P columns (1848 at P = 16); its attention replayed in bf16
    # too: its scores (std ~128 at the reference's init) make it harder
    # still, and a rank's own bf16 q and k, one rounding from the whole's,
    # read up to 0.16 of max|whole| in dx on the H100
    "qwen2-vl-72b": dict(layers=1, batch=2, seq=512,
                         blocks=("attention", "mlp"),
                         replay=("fp32", "bf16")),
}
# the VLM's M-RoPE positions in tp_local: an image of 16 x 16 patches
# (temporal 0, height its row, width its column), then text, all three
# axes from 16 on, as Qwen2-VL numbers a prompt that opens with an image
VLM_GRID = 16
TP_SIZES = (2, 4, 8, 16)
TP_TOL = {"fp32": 1e-5, "bf16": 3e-2}
# K4 and its backward, K5 and its backward, on one rank's heads of the
# tp_local models at P ranks (each head count divided by P): the key in
# the kernels line (its suffix, before ":tp<P>") -> the shape
TP_K4_SHAPES = {
    "qwen3-4b": dict(B=2, H=32, KV=8, S=512, d=128),
    # the encoder's non-causal attention, the cross-attention (sq != sk)
    "seamless-m4t-medium": dict(B=2, H=16, KV=16, S=1024, d=64,
                                causal=False),
    "seamless-m4t-medium:cross": dict(B=2, H=16, KV=16, S=512, Sk=1024, d=64,
                                      causal=False),
    # the shared block's windowed attention
    "zamba2-7b": dict(B=1, H=32, KV=32, S=8192, d=112, window=4096),
}
# zamba2-7b's mixer: 1 x 8192 in chunks of 64, 112 heads of 64, state 64
TP_K5_SHAPE = dict(B=1, H=112, C=128, L=64, D=64, N=64)
# each head-subset record's model and the tp_local block whose launches it
# counts, and the kernels each block launches
TP_RECORD_BLOCKS = {
    "qwen3-4b": ("qwen3-4b", "attention"),
    "seamless-m4t-medium": ("seamless-m4t-medium", "enc_attention"),
    "seamless-m4t-medium:cross": ("seamless-m4t-medium", "cross_attention"),
    "zamba2-7b": ("zamba2-7b", "shared_attention"),
    "zamba2-7b:mixer": ("zamba2-7b", "mamba"),
}
KERNEL_BASES = {block: ("flash_attention", "flash_attention_bwd")
                for block in ("attention", "enc_attention", "cross_attention",
                              "shared_attention")}
KERNEL_BASES["mamba"] = ("ssd_chunk", "ssd_chunk_bwd")
# the pipeline phase: 2 decoder layers of qwen3-4b, 4 microbatches of
# 1 x 512, on a one-rank "pod" axis
PIPELINE = dict(arch="qwen3-4b", layers=2, n_micro=4, mb=1, seq=512)


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def emit(**kw) -> None:
    print(json.dumps(kw, default=float), flush=True)


def _mem_total() -> str | None:
    """The host's ``MemTotal`` line of /proc/meminfo (the CPU halves of
    the agreements hold tens of GB there)."""
    try:
        with open("/proc/meminfo") as fh:
            return next((line.split(":", 1)[1].strip() for line in fh
                         if line.startswith("MemTotal:")), None)
    except OSError:
        return None


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn) -> float:
    """Mean milliseconds of ``fn`` on the card (CUDA events, warm)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    once = max(start.elapsed_time(end), 1e-3)
    if once >= 200.0:  # a call this long is its own mean
        return once
    n = int(max(3, min(50, 200.0 / once)))
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def device_ms(torch, fn, name: str, n: int = 20, tries: int = 3) -> float:
    """Mean milliseconds on the card's own clock of the kernels whose name
    holds ``name``, over ``n`` calls of ``fn`` under the profiler (a
    launch shorter than the host's issue time is not measured by events
    around back-to-back calls).

    The profiler now and then reports no kernel record for a launch of a
    few microseconds; it is asked again up to ``tries`` times, and if it
    never sees one the time is taken with CUDA events around the ``n``
    calls instead (an upper bound: it holds the host's issue gaps), and a
    ``device_ms_fallback`` line says so."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as _profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with _profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA and name in e.key)
        if us > 0:
            return us / 1e3 / n
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / n
    check(ms > 0, f"no device time for {name}")
    emit(phase="device_ms_fallback", name=name, tries=tries, events_ms=ms)
    return ms


def bound(flops: float, nbytes: float, peak: float = FP32_PEAK):
    """(least ms for the work, what bounds it) on the data-sheet peaks."""
    t_ops, t_mem = flops / peak, nbytes / HBM_BW
    return 1e3 * max(t_ops, t_mem), "operations" if t_ops >= t_mem else "bytes"


def rel_err(torch, got, want) -> tuple[float, float]:
    """(max |got - want|, that over max |want|)."""
    diff = max(float((g - w).abs().max()) for g, w in zip(got, want))
    scale = max(float(w.abs().max()) for w in want)
    return diff, diff / max(scale, 1e-30)


def network(circuits, simplify_network, circ, bits, open_qubits=None):
    kw = {"bitstring": bits}
    if open_qubits is not None:
        kw["open_qubits"] = open_qubits
    return simplify_network(*circuits.circuit_to_network(circ, **kw))


def phase_kernels(torch, plan, cg, ops, hw) -> dict:
    """Each kernel at the main path's own shapes against its plain
    version; returns per-kernel timing records."""
    from repro_torch.kernels.ref import round16

    gen = torch.Generator(device="cpu").manual_seed(0)
    dev = torch.device("cuda")

    def rnd(shape, scale=1.0):
        return (scale * torch.randn(tuple(shape), generator=gen)).to(dev)

    specs = plan.schedule.specs
    out = {}

    # K1: the largest tiled step, complex64 read in place, in GEMM order
    # and (the path's call) in the step's native layouts
    tiled = [s for s in specs if s.backend == "tiled"]
    check(bool(tiled), "the plan has no tiled step")
    f = max(tiled, key=lambda s: s.form.flops).form
    B, M, N, K = f.B, f.M, f.N, f.K
    a, b = rnd((B, M, K)), rnd((B, K, N))
    ac = torch.complex(a, rnd((B, M, K)))
    bc = torch.complex(b, rnd((B, K, N)))
    before = cg.LAUNCHES["tiled_gemm"]
    got = cg.tiled_gemm(ac, bc)
    check(cg.LAUNCHES["tiled_gemm"] == before + 1, "tiled_gemm: not one launch")
    want = cg.tiled_gemm_plain(ac, bc)
    torch.cuda.synchronize()
    err, rel = rel_err(torch, [got], [want])
    check(rel <= KERNEL_TOL, f"tiled_gemm disagrees: {rel}")
    nbytes = 8.0 * B * (M * K + K * N + M * N)
    # 3xTF32 on Karatsuba's three real products (3 x 6MNK) at the TF32
    # rate; the kernel's direct form issues 4/3 of that
    b_ms, b_by = bound(3.0 * 6.0 * B * M * N * K, nbytes, TF32_PEAK)
    # the path's call: the step's operands in their native layouts
    an = torch.complex(rnd(f.a_shape), rnd(f.a_shape))
    bn = torch.complex(rnd(f.b_shape), rnd(f.b_shape))
    out["tiled_gemm"] = dict(
        shape=[B, M, N, K], dtype="complex64", max_abs_err=err, rel_err=rel,
        ms=cuda_ms(torch, lambda: cg.tiled_gemm(ac, bc)),
        path_ms=cuda_ms(torch, lambda: ops.tiled_step(an, bn, f)),
        plain_ms=cuda_ms(torch, lambda: cg.tiled_gemm_plain(ac, bc)),
        library_ms=cuda_ms(torch, lambda: torch.matmul(ac, bc)),
        bound_ms=b_ms, bound_by=b_by,
    )
    # its bf16 route: Karatsuba's three real products (6MNK), as the fp32
    # bound counts them, at the bf16 rate
    got = cg.tiled_gemm(ac, bc, precision="bf16")
    want = cg.tiled_gemm_plain(ac, bc, "bf16")
    torch.cuda.synchronize()
    err, rel = rel_err(torch, [got], [want])
    check(rel <= BF16_ROUTE_TOL, f"tiled_gemm bf16 route disagrees: {rel}")
    flops16 = 6.0 * B * M * N * K
    b_ms, b_by = bound(flops16, nbytes, BF16_PEAK)
    out["tiled_gemm:bf16"] = dict(
        shape=[B, M, N, K], dtype="complex64", max_abs_err=err, rel_err=rel,
        ms=cuda_ms(torch, lambda: cg.tiled_gemm(ac, bc, precision="bf16")),
        plain_ms=cuda_ms(torch, lambda: cg.tiled_gemm_plain(ac, bc, "bf16")),
        library_ms=None, bound_ms=b_ms, bound_by=b_by,
        path_ms=cuda_ms(torch, lambda: ops.tiled_step(an, bn, f, precision="bf16")),
        # hw.bf16_peak_flops was measured counting four real products
        measured_rate_bound_ms=bound(
            8.0 * B * M * N * K, nbytes, hw.bf16_peak_flops)[0],
    )
    del a, b, ac, bc, an, bn, got, want

    # K2: the largest fused step, complex64 read and written in place
    fused = [s for s in specs if s.backend == "fused"]
    check(bool(fused), "the plan has no fused step")
    f = max(fused, key=lambda s: s.form.flops).form
    pa = (rnd(f.a_shape), rnd(f.a_shape))
    pb = (rnd(f.b_shape), rnd(f.b_shape))
    ac, bc = torch.complex(*pa), torch.complex(*pb)
    before = cg.LAUNCHES["fused_gemm"]
    got = cg.fused_gemm_c64(ac, bc, f)
    check(cg.LAUNCHES["fused_gemm"] == before + 1, "fused_gemm: not one launch")
    want = cg.fused_gemm_plain(pa, pb, f)
    torch.cuda.synchronize()
    err, rel = rel_err(torch, [got.real, got.imag], want)
    check(rel <= KERNEL_TOL, f"fused_gemm disagrees: {rel}")
    B, M, N, K = f.B, f.M, f.N, f.K
    nbytes = 8.0 * B * (M * K + K * N + M * N)
    # 3xTF32 on Karatsuba's three real products (3 x 6MNK) at the TF32
    # rate; the kernel's direct form issues 4/3 of that
    b_ms, b_by = bound(3.0 * 6.0 * B * M * N * K, nbytes, TF32_PEAK)
    ffma = 6.0 * B * M * N * K + 2.0 * B * (M * K + K * N) + 3.0 * B * M * N
    ffma_ms, _ = bound(ffma, nbytes)  # the FFMA kernel's bound (PR 11-13)
    out["fused_gemm"] = dict(
        shape=[B, M, N, K], max_abs_err=err, rel_err=rel,
        uniform=cg.fused_plan(f).uniform,
        ms=cuda_ms(torch, lambda: cg.fused_gemm_c64(ac, bc, f)),
        path_ms=cuda_ms(torch, lambda: ops.fused_matmul(ac, bc, f)),
        plain_ms=cuda_ms(torch, lambda: cg.fused_gemm_plain(pa, pb, f)),
        library_ms=cuda_ms(torch, lambda: torch.einsum(f.expr, ac, bc)),
        bound_ms=b_ms, bound_by=b_by, ffma_bound_ms=ffma_ms,
    )
    # its bf16 route on the same operands
    got = cg.fused_gemm_c64(ac, bc, f, precision="bf16")
    want = cg.fused_gemm_plain(pa, pb, f, "bf16")
    torch.cuda.synchronize()
    err, rel = rel_err(torch, [got.real, got.imag], want)
    check(rel <= BF16_ROUTE_TOL, f"fused_gemm bf16 route disagrees: {rel}")
    flops16 = 6.0 * B * M * N * K
    b_ms, b_by = bound(flops16, nbytes, BF16_PEAK)
    out["fused_gemm:bf16"] = dict(
        shape=[B, M, N, K], dtype="complex64", max_abs_err=err, rel_err=rel,
        ms=cuda_ms(torch, lambda: cg.fused_gemm_c64(ac, bc, f, precision="bf16")),
        plain_ms=cuda_ms(torch, lambda: cg.fused_gemm_plain(pa, pb, f, "bf16")),
        library_ms=None, bound_ms=b_ms, bound_by=b_by,
        # hw.bf16_peak_flops was measured counting four real products
        measured_rate_bound_ms=bound(
            8.0 * B * M * N * K, nbytes, hw.bf16_peak_flops)[0],
    )
    del pa, pb, ac, bc, got, want

    # K3: the longest chain of the epilogue (the per-slice segment)
    chains = plan.chain_plan.segment_chains("epilogue") or list(
        plan.chain_plan.chains
    )
    ch = max(chains, key=lambda c: (c.n_steps, sum(
        specs[p].form.flops for p in c.positions)))
    forms = tuple(specs[p].form for p in ch.positions)
    shapes = [forms[0].a_shape, forms[0].b_shape] + [
        forms[t].b_shape if ch.carry_side[t] == "l" else forms[t].a_shape
        for t in range(1, len(forms))
    ]
    scales = [forms[0].K ** -0.25] * 2 + [fm.K ** -0.5 for fm in forms[1:]]
    comps = [rnd(s, sc) for s, sc in zip(shapes, scales) for _ in range(2)]
    ext = [torch.complex(comps[2 * i], comps[2 * i + 1]) for i in range(len(shapes))]
    chain = dict(forms=forms, carry_side=ch.carry_side, slot_ids=ch.slot_ids,
                 slot_elems=ch.slot_elems)
    before = cg.LAUNCHES["chain_gemm"]
    got = ops.fused_chain(ext, **chain)
    check(cg.LAUNCHES["chain_gemm"] == before + 1, "fused_chain: not one launch")
    want = cg.chain_gemm_plain(comps, forms, ch.carry_side, True)
    torch.cuda.synchronize()
    err, rel = rel_err(torch, [got.real, got.imag], want)
    check(rel <= KERNEL_TOL, f"chain_gemm disagrees: {rel}")
    flops = sum(
        6.0 * fm.B * fm.M * fm.N * fm.K + 2.0 * fm.B * (fm.M * fm.K + fm.K * fm.N)
        + 3.0 * fm.B * fm.M * fm.N for fm in forms
    )
    nbytes = 8.0 * (sum(e.numel() for e in ext) + got.numel())
    b_ms, b_by = bound(flops, nbytes)
    args = (comps, forms, ch.carry_side, ch.slot_ids, ch.slot_elems)
    # the kernel alone, on the card's clock: relaunches of the cached
    # launch state, at each cluster size; the default size's outputs are
    # then the wrapper's result
    by_cluster, rel_relaunch = {}, 0.0
    for size in CHAIN_CLUSTERS:
        launch, outs = cg.chain_gemm_launcher(*args, complex_mode=True,
                                              cluster=size)
        by_cluster[size] = device_ms(torch, launch, "chain_gemm")
        torch.cuda.synchronize()
        _, r = rel_err(torch, outs, want)
        rel_relaunch = max(rel_relaunch, r)
    check(rel_relaunch <= KERNEL_TOL,
          f"chain_gemm relaunches disagree: {rel_relaunch}")
    one, _ = cg.chain_gemm_launcher(comps[:4], forms[:1], ch.carry_side[:1],
                                    (), (), complex_mode=True)
    default = cg.chain_state(forms, ch.carry_side, ch.slot_ids, ch.slot_elems,
                             True, ext[0].device).segments[0][3]
    out["chain_gemm"] = dict(
        steps=ch.n_steps, shapes=[[fm.B, fm.M, fm.N, fm.K] for fm in forms],
        max_abs_err=err, rel_err=rel, relaunch_rel_err=rel_relaunch,
        cluster=default, ms=by_cluster[default],
        ms_by_cluster=by_cluster,
        one_step_ms=device_ms(torch, one, "chain_gemm"),
        empty_launch_ms=device_ms(
            torch, lambda: cg.empty_cluster_launch(default, dev), "empty_cluster"),
        empty_launch_wall_ms=cuda_ms(
            torch, lambda: cg.empty_cluster_launch(default, dev)),
        # an empty launch that meets at the chain's barriers between steps
        barriers_launch_ms=device_ms(
            torch, lambda: cg.empty_cluster_launch(default, dev, ch.n_steps - 1),
            "empty_cluster"),
        path_ms=cuda_ms(torch, lambda: ops.fused_chain(ext, **chain)),
        plain_ms=cuda_ms(
            torch, lambda: cg.chain_gemm_plain(comps, forms, ch.carry_side, True)
        ),
        library_ms=None, bound_ms=b_ms, bound_by=b_by,
    )
    # its bf16 route: every step bf16, every slot held as bf16.  Step by
    # step against the plain step on the kernel's own carry (the chain's
    # first t steps, one launch): bf16 products are exact, so only the
    # order of the sum differs.  The whole chain against the plain chain
    # differs by more: a carry rounded to bf16 from two fp32 sums of
    # another order can land one bf16 ulp apart, so that is held at
    # BF16_CHAIN_TOL, which the same chain with unrounded carries must
    # exceed.
    prec = ("bf16",) * len(forms)
    sp = ("bf16",) * len(ch.slot_elems)
    err = rel = 0.0
    carry = None
    for t, fm in enumerate(forms):
        got = cg.chain_gemm_c64(ext[:t + 2], forms[:t + 1], ch.carry_side[:t + 1],
                                ch.slot_ids[:t], ch.slot_elems,
                                precisions=prec[:t + 1], slot_prec=sp)
        if t == 0:
            a_, b_ = ext[0], ext[1]
        else:
            a_, b_ = ((carry, ext[t + 1]) if ch.carry_side[t] == "l"
                      else (ext[t + 1], carry))
        want = cg.fused_gemm_plain((a_.real, a_.imag), (b_.real, b_.imag), fm, "bf16")
        torch.cuda.synchronize()
        e, r = rel_err(torch, [got.real, got.imag], want)
        err, rel, carry = max(err, e), max(rel, r), got
    check(rel <= BF16_ROUTE_TOL, f"chain_gemm bf16 route disagrees: {rel}")
    got = ops.fused_chain(ext, **chain, precisions=prec, slot_prec=sp)
    want = cg.chain_gemm_plain(comps, forms, ch.carry_side, True, prec)
    torch.cuda.synchronize()
    _, chain_rel = rel_err(torch, [got.real, got.imag], want)
    check(chain_rel <= BF16_CHAIN_TOL, f"chain_gemm bf16 chain disagrees: {chain_rel}")
    # the control: bf16 externals through the fp32 route (a product of
    # bf16 values is exact in fp32), so only the carries go unrounded
    ext16 = [round16(e) for e in ext]
    ctrl = ops.fused_chain(ext16, **chain)
    torch.cuda.synchronize()
    _, unrounded_rel = rel_err(torch, [ctrl.real, ctrl.imag], want)
    check(unrounded_rel > BF16_CHAIN_TOL,
          f"chain_gemm: unrounded carries pass the bf16 chain limit: {unrounded_rel}")
    del ext16, ctrl
    launch, outs = cg.chain_gemm_launcher(*args, complex_mode=True,
                                          precisions=prec, slot_prec=sp)
    ms16 = device_ms(torch, launch, "chain_gemm")
    torch.cuda.synchronize()
    _, r = rel_err(torch, outs, [got.real, got.imag])
    check(r == 0.0, f"chain_gemm bf16 relaunch disagrees: {r}")
    out["chain_gemm:bf16"] = dict(
        steps=ch.n_steps, max_abs_err=err, rel_err=rel, chain_rel_err=chain_rel,
        unrounded_chain_rel_err=unrounded_rel,
        ms=ms16,
        path_ms=cuda_ms(torch, lambda: ops.fused_chain(
            ext, **chain, precisions=prec, slot_prec=sp)),
        plain_ms=cuda_ms(torch, lambda: cg.chain_gemm_plain(
            comps, forms, ch.carry_side, True, prec)),
        # FFMA on bf16-rounded values: the fp32 rate, as the fp32 route
        library_ms=None, bound_ms=b_ms, bound_by=b_by,
    )
    return out


def phase_lm_kernels(torch, fa, ssd) -> dict:
    """flash_attention (at each served model's heads) and ssd_chunk at
    the serve path's own shapes (batch 4, prompt 512) against their plain
    versions."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(0)
    dev = torch.device("cuda")
    out = {}

    # K4 at each served model's prefill (causal): batch 4 x 512, heads
    # of 128, qwen3-4b 32 query heads on 8 kv heads, deepseek-moe-16b
    # 16 on 16 (MHA), qwen2-vl-72b 64 on 8; zamba2-7b 1 x 8192, 32 on 32
    # heads of 112, window 4096
    # (qwen3-4b's draws from ``gen`` as before; each other shape from a
    # generator of its own, so the K5 inputs below stay the same)
    for i, (name, shape) in enumerate(K4_SHAPES.items()):
        g = gen if i == 0 else torch.Generator(device="cuda").manual_seed(i)
        out[name] = _k4_record(torch, fa, F, g, **{**K4_DEFAULT, **shape})

    # K5: mamba2-130m prefill, 24 heads of 64, state 128, chunks of 64,
    # head-free B/C (one group per batch row)
    B, H, C, L, D, N = 4, 24, 8, 64, 64, 128
    x = torch.randn(B * H, C, L, D, generator=gen, device=dev)
    dt = 0.1 + 0.9 * torch.rand(B * H, C, L, generator=gen, device=dev)
    a = -(0.01 + 0.49 * torch.rand(B * H, C, L, generator=gen, device=dev))
    b = torch.randn(B, C, L, N, generator=gen, device=dev)
    c = torch.randn(B, C, L, N, generator=gen, device=dev)
    check(ssd.ssd_route(L, D, N) == "wgmma", "ssd_chunk: serve shape not wgmma")
    before = dict(ssd.SSD_ROUTES)
    got = ssd.ssd_intra_chunk(x, dt, a, b, c)
    check(ssd.SSD_ROUTES["wgmma"] == before["wgmma"] + 1,
          "ssd_chunk: the serve shape did not take the wgmma route")
    want = ssd.ssd_intra_chunk_plain(x, dt, a, b, c)
    simt = ssd.ssd_intra_chunk(x, dt, a, b, c, route="simt")
    torch.cuda.synchronize()
    err, rel = rel_err(torch, got, want)
    simt_err, simt_rel = rel_err(torch, simt, want)
    check(all(bool(torch.isfinite(g).all()) for g in got), "ssd_chunk: non-finite")
    check(rel <= KERNEL_TOL, f"ssd_chunk disagrees: {rel}")
    check(simt_rel <= KERNEL_TOL, f"ssd_chunk (simt) disagrees: {simt_rel}")
    # decays of -5..-10 a step: exp(cum_i - cum_j) overflows above the
    # diagonal, where the kernel must select 0 before the TF32 split
    a_big = -(5.0 + 5.0 * torch.rand(B * H, C, L, generator=gen, device=dev))
    big = ssd.ssd_intra_chunk(x, dt, a_big, b, c)
    big_want = ssd.ssd_intra_chunk_plain(x, dt, a_big, b, c)
    torch.cuda.synchronize()
    _, big_rel = rel_err(torch, big, big_want)
    check(all(bool(torch.isfinite(g).all()) for g in big),
          "ssd_chunk: non-finite with overflowing decays")
    check(big_rel <= KERNEL_TOL, f"ssd_chunk disagrees on overflow: {big_rel}")
    cells = B * H * C
    tri = L * (L + 1) // 2  # the lower triangle the decay mask keeps
    nbytes = 4.0 * (x.numel() + dt.numel() + a.numel() + b.numel() + c.numel()
                    + got[0].numel() + got[1].numel())
    b_ms, b_by = _k5_bound(B, H, C, L, D, N, nbytes)
    # the simt kernel's bound: C B^T for every cell, fp32 on the CUDA cores
    ffma = cells * (2.0 * tri * (N + D) + 2.0 * N * D * L + N * L + L * D)
    ffma_ms, _ = bound(ffma, nbytes)
    out["ssd_chunk"] = dict(
        shape=dict(BH=B * H, C=C, L=L, D=D, S=N, groups=B,
                   heads_per_block=ssd.heads_per_block(
                       H, B * C, torch.cuda.get_device_properties(
                           dev).multi_processor_count)),
        max_abs_err=err, rel_err=rel, simt_rel_err=simt_rel,
        overflow_rel_err=big_rel,
        # the kernels alone on the device clock; wrapper_ms: the call
        ms=device_ms(torch, lambda: ssd.ssd_intra_chunk(x, dt, a, b, c),
                     "ssd_chunk_wgmma"),
        simt_ms=device_ms(
            torch, lambda: ssd.ssd_intra_chunk(x, dt, a, b, c, route="simt"),
            "ssd_chunk_kernel"),
        wrapper_ms=cuda_ms(torch, lambda: ssd.ssd_intra_chunk(x, dt, a, b, c)),
        plain_ms=cuda_ms(torch, lambda: ssd.ssd_intra_chunk_plain(x, dt, a, b, c)),
        library_ms=None, bound_ms=b_ms, bound_by=b_by, ffma_bound_ms=ffma_ms,
    )

    # K5 backward at the same (training) shape: gradients of y and of the
    # chunk states in, the five input gradients out; the wgmma route the
    # shape takes, and the simt route forced, each against the plain
    # version, at overflowing decays too, and twice for the same bits
    gy = torch.randn(B * H, C, L, D, generator=gen, device=dev)
    gst = torch.randn(B * H, C, N, D, generator=gen, device=dev)
    want = ssd.ssd_intra_chunk_bwd_plain(x, dt, a, b, c, gy, gst)
    big_want = ssd.ssd_intra_chunk_bwd_plain(x, dt, a_big, b, c, gy, gst)
    rels, big_rels = {}, {}
    for route in ("wgmma", "simt"):
        before = ssd.SSD_BWD_ROUTES[route]
        force = None if route == "wgmma" else route
        got = ssd.ssd_intra_chunk_bwd(x, dt, a, b, c, gy, gst, route=force)
        check(ssd.SSD_BWD_ROUTES[route] == before + 1,
              f"ssd_chunk_bwd: the call did not take the {route} route")
        again = ssd.ssd_intra_chunk_bwd(x, dt, a, b, c, gy, gst, route=force)
        big = ssd.ssd_intra_chunk_bwd(x, dt, a_big, b, c, gy, gst, route=force)
        torch.cuda.synchronize()
        check(all(bool(torch.isfinite(g).all()) for g in got + big),
              f"ssd_chunk_bwd ({route}): non-finite")
        rels[route] = [rel_err(torch, [g], [w])[1] for g, w in zip(got, want)]
        big_rels[route] = max(rel_err(torch, [g], [w])[1]
                              for g, w in zip(big, big_want))
        check(max(rels[route]) <= KERNEL_TOL,
              f"ssd_chunk_bwd ({route}) disagrees: {rels[route]}")
        check(big_rels[route] <= KERNEL_TOL,
              f"ssd_chunk_bwd ({route}) disagrees on overflow: {big_rels[route]}")
        check(all(torch.equal(g, h) for g, h in zip(got, again)),
              f"ssd_chunk_bwd ({route}): two runs differ")
        if route == "wgmma":
            err = max(rel_err(torch, [g], [w])[0] for g, w in zip(got, want))
        del got, again, big
    # each input read once, each output (want's shapes) written once
    nbytes = 4.0 * sum(t.numel() for t in (x, dt, a, b, c, gy, gst, *want))
    b_ms, b_by = _k5_bound(B, H, C, L, D, N, nbytes, backward=True)
    ffma_ms, _ = _k5_bound(B, H, C, L, D, N, nbytes, backward=True,
                           peak=FP32_PEAK)

    def k5_bwd(route=None):
        return lambda: ssd.ssd_intra_chunk_bwd(x, dt, a, b, c, gy, gst,
                                               route=route)

    out["ssd_chunk_bwd"] = dict(
        shape=dict(BH=B * H, C=C, L=L, D=D, S=N, groups=B,
                   heads_per_block=out["ssd_chunk"]["shape"]["heads_per_block"]),
        max_abs_err=err, rel_err=max(rels["wgmma"]),
        simt_rel_err=max(rels["simt"]),
        overflow_rel_err=big_rels["wgmma"],
        simt_overflow_rel_err=big_rels["simt"],
        # the call with CUDA events (the kernel table's reading), each
        # route; then the kernels alone on the device clock: the wgmma
        # kernel, its group sum of the block shares, the simt route's two
        ms=cuda_ms(torch, k5_bwd()),
        simt_ms=cuda_ms(torch, k5_bwd("simt")),
        kernel_ms=device_ms(torch, k5_bwd(), "ssd_chunk_bwd_wgmma"),
        group_sum_ms=device_ms(torch, k5_bwd(), "ssd_bwd_group_sum"),
        simt_kernel_ms=device_ms(torch, k5_bwd("simt"), "ssd_chunk_bwd_kernel"),
        simt_group_sum_ms=device_ms(torch, k5_bwd("simt"), "ssd_bwd_group_sum"),
        plain_ms=cuda_ms(torch, lambda: ssd.ssd_intra_chunk_bwd_plain(
            x, dt, a, b, c, gy, gst)),
        library_ms=None, bound_ms=b_ms, bound_by=b_by, ffma_bound_ms=ffma_ms,
    )
    del x, dt, a, b, c, gy, gst, want, big_want

    # K4 backward at qwen3-4b's training shape (batch 2 x 512: 32 query
    # heads on 8 kv heads of 128, causal), drawn from ``gen`` after K5's
    # inputs, and at seamless-m4t-medium's encoder (4 x 512, 16 heads of
    # 64, non-causal) from a generator of its own
    for i, (name, shape) in enumerate(K4_BWD_SHAPES.items()):
        g = gen if i == 0 else torch.Generator(device="cuda").manual_seed(
            len(K4_SHAPES) + i)
        out[name] = _k4_bwd_record(torch, fa, F, g, **shape)
    out["flash_attention_bwd:zamba2-7b"] = _k4_bwd_window_record(torch, fa, F)

    out.update(_tp_kernel_records(torch, fa, F, ssd))
    return out


def _tp_kernel_records(torch, fa, F, ssd) -> dict:
    """K4 and its backward on one rank's heads of each tp_local model
    split over "model" (TP_K4_SHAPES at each P, each from a generator of
    its own; qwen3-4b's backward also timed on the simt route and its
    kernels alone), then K5 and its backward on zamba2-7b's mixer's."""
    out = {}
    for i, (model, base) in enumerate(TP_K4_SHAPES.items()):
        for size in TP_SIZES:
            H, KV = _tp_heads(base["H"], base["KV"], size)
            g = torch.Generator(device="cuda").manual_seed(
                100 + 20 * i + size)
            shape = {**K4_DEFAULT, **base, "H": H, "KV": KV}
            out[f"flash_attention:{model}:tp{size}"], given = _k4_record(
                torch, fa, F, g, keep=True, **shape)
            out[f"flash_attention_bwd:{model}:tp{size}"] = _k4_bwd_record(
                torch, fa, F, g, timed_routes=i == 0, given=given, **shape)
            del given
    for size in TP_SIZES:
        g = torch.Generator(device="cuda").manual_seed(200 + size)
        shape = {**TP_K5_SHAPE, "H": TP_K5_SHAPE["H"] // size}
        (out[f"ssd_chunk:zamba2-7b:mixer:tp{size}"],
         out[f"ssd_chunk_bwd:zamba2-7b:mixer:tp{size}"]) = _k5_records(
            torch, ssd, g, **shape)
    return out


def _k5_bound(B, H, C, L, D, N, nbytes, backward=False, peak=None):
    """K5's (or its backward's) least time at (B groups of H heads, C
    chunks of L, head dim D, state N) against ``nbytes``: the forward's
    arithmetic C B^T once per (group, chunk), the masked y product and the
    state product per cell; the backward's C B^T once per (group, chunk)
    and per cell the masked products gM = gy Xd^T, M^T gy, G B, G^T C
    (lower triangle) and the full B gst and Xd gst^T; each as three TF32
    products (3xTF32) at the TF32 rate, or once at ``peak``."""
    cells = B * H * C
    tri = L * (L + 1) // 2  # the lower triangle the decay mask keeps
    if backward:
        flops = B * C * 2.0 * tri * N + cells * (
            2.0 * tri * (2 * D + 2 * N) + 4.0 * L * N * D)
    else:
        flops = B * C * 2.0 * tri * N + cells * (2.0 * tri * D
                                                 + 2.0 * N * D * L)
    if peak is not None:
        return bound(flops, nbytes, peak)
    return bound(3.0 * flops, nbytes, TF32_PEAK)


def _k5_records(torch, ssd, gen, B, H, C, L, D, N) -> tuple[dict, dict]:
    """K5 and its backward at (B groups of H heads, C chunks of L, head
    dim D, state N) on the route the shape takes, each against its plain
    version (<= KERNEL_TOL of max|plain|; the backward twice for the same
    bits), timed beside the plain version and its bound."""
    dev = torch.device("cuda")
    x = torch.randn(B * H, C, L, D, generator=gen, device=dev)
    dt = 0.1 + 0.9 * torch.rand(B * H, C, L, generator=gen, device=dev)
    a = -(0.01 + 0.49 * torch.rand(B * H, C, L, generator=gen, device=dev))
    b = torch.randn(B, C, L, N, generator=gen, device=dev)
    c = torch.randn(B, C, L, N, generator=gen, device=dev)
    gy = torch.randn(B * H, C, L, D, generator=gen, device=dev)
    gst = torch.randn(B * H, C, N, D, generator=gen, device=dev)
    route = ssd.ssd_route(L, D, N)
    shape = dict(BH=B * H, C=C, L=L, D=D, S=N, groups=B, route=route,
                 heads_per_block=ssd.heads_per_block(
                     H, B * C, torch.cuda.get_device_properties(
                         dev).multi_processor_count))
    before = dict(ssd.SSD_ROUTES), dict(ssd.SSD_BWD_ROUTES)
    got = ssd.ssd_intra_chunk(x, dt, a, b, c)
    want = ssd.ssd_intra_chunk_plain(x, dt, a, b, c)
    gb = ssd.ssd_intra_chunk_bwd(x, dt, a, b, c, gy, gst)
    again = ssd.ssd_intra_chunk_bwd(x, dt, a, b, c, gy, gst)
    want_b = ssd.ssd_intra_chunk_bwd_plain(x, dt, a, b, c, gy, gst)
    torch.cuda.synchronize()
    check(ssd.SSD_ROUTES[route] == before[0][route] + 1
          and ssd.SSD_BWD_ROUTES[route] == before[1][route] + 2,
          f"ssd_chunk {shape}: not on the {route} route")
    err, rel = rel_err(torch, got, want)
    bwd_err, bwd_rel = rel_err(torch, gb, want_b)
    check(all(bool(torch.isfinite(t).all()) for t in (*got, *gb)),
          f"ssd_chunk {shape}: non-finite")
    check(rel <= KERNEL_TOL and bwd_rel <= KERNEL_TOL,
          f"ssd_chunk {shape} disagrees: {rel}, backward {bwd_rel}")
    check(all(torch.equal(g, h) for g, h in zip(gb, again)),
          f"ssd_chunk_bwd {shape}: two runs differ")
    nbytes = 4.0 * sum(t.numel() for t in (x, dt, a, b, c, *got))
    b_ms, b_by = _k5_bound(B, H, C, L, D, N, nbytes)
    fwd = dict(shape=shape, max_abs_err=err, rel_err=rel,
               ms=cuda_ms(torch, lambda: ssd.ssd_intra_chunk(x, dt, a, b, c)),
               plain_ms=cuda_ms(torch, lambda: ssd.ssd_intra_chunk_plain(
                   x, dt, a, b, c)),
               library_ms=None, bound_ms=b_ms, bound_by=b_by)
    nbytes = 4.0 * sum(t.numel() for t in (x, dt, a, b, c, gy, gst, *want_b))
    b_ms, b_by = _k5_bound(B, H, C, L, D, N, nbytes, backward=True)
    bwd = dict(shape=shape, max_abs_err=bwd_err, rel_err=bwd_rel,
               ms=cuda_ms(torch, lambda: ssd.ssd_intra_chunk_bwd(
                   x, dt, a, b, c, gy, gst)),
               plain_ms=cuda_ms(torch, lambda: ssd.ssd_intra_chunk_bwd_plain(
                   x, dt, a, b, c, gy, gst)),
               library_ms=None, bound_ms=b_ms, bound_by=b_by)
    return fwd, bwd


def _tp_heads(H: int, KV: int, size: int) -> tuple[int, int]:
    """(q heads, kv heads) of one rank of H q heads on KV kv heads split
    over ``size`` ranks: the kv heads split where KV divides ``size``,
    else the one kv head its q heads read."""
    return H // size, KV // size if KV % size == 0 else 1


def _k4_bwd_record(torch, fa, F, gen, B, H, KV, S, d, causal, Sk=None,
                   window=0, timed_routes=True, given=None) -> dict:
    """K4's backward on bf16 (B·H, S, d) queries over (B·KV, Sk, d) keys
    and values (Sk None: S), causal or not, with ``window`` where it is >
    0, from the kernel forward's output and lse (held to the plain
    version's lse at 1e-3): the mma route bf16 takes and the simt route
    forced on the same inputs, each against the plain version (<=
    FLASH_BWD_TOL of max|plain| per gradient) and twice for the same
    bits, counted on its route (and as non-causal or windowed where it
    is); timed beside the plain version, SDPA's autograd backward (the
    window as a boolean band mask) and its bound, and with
    ``timed_routes`` the simt route, each route's kernels alone and the
    forward too.  ``given`` (q, k, v and the plain forward's lse, from
    :func:`_k4_record`) spares drawing them and the plain forward again."""
    dev = torch.device("cuda")
    Sk = Sk or S
    if given is None:
        q = torch.randn(B * H, S, d, generator=gen, device=dev).bfloat16()
        k = torch.randn(B * KV, Sk, d, generator=gen, device=dev).bfloat16()
        v = torch.randn(B * KV, Sk, d, generator=gen, device=dev).bfloat16()
    else:
        q, k, v, want_lse = given
    do = torch.randn(B * H, S, d, generator=gen, device=dev).bfloat16()
    kw = dict(causal=causal, window=window)
    o, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    if given is None:
        _, want_lse = fa.flash_attention_plain(q, k, v, return_lse=True,
                                               **kw)
    lse_err = float((lse - want_lse).abs().max())
    check(lse_err <= 1e-3, f"flash_attention lse disagrees: {lse_err}")
    rels = {}
    for route in ("mma", "simt"):
        before = (fa.BWD_ROUTES[route], fa.BWD_NONCAUSAL[route],
                  fa.BWD_WINDOW_ROUTES[route])
        force = None if route == "mma" else route
        got = fa.flash_attention_bwd(q, k, v, o, lse, do, route=force, **kw)
        check(fa.BWD_ROUTES[route] == before[0] + 1,
              f"flash_attention_bwd: the call did not take the {route} route")
        check(causal or fa.BWD_NONCAUSAL[route] == before[1] + 1,
              f"flash_attention_bwd ({route}): not counted as non-causal")
        check(not window or fa.BWD_WINDOW_ROUTES[route] == before[2] + 1,
              f"flash_attention_bwd ({route}): not counted as windowed")
        again = fa.flash_attention_bwd(q, k, v, o, lse, do, route=force,
                                       **kw)
        torch.cuda.synchronize()
        check(all(bool(torch.isfinite(g).all()) for g in got),
              f"flash_attention_bwd ({route}): non-finite")
        rels[route] = [rel_err(torch, [g.float()], [w.float()])[1]
                       for g, w in zip(got, want)]
        check(max(rels[route]) <= FLASH_BWD_TOL,
              f"flash_attention_bwd ({route}) {kw} disagrees: "
              f"{rels[route]}")
        check(all(torch.equal(g, h) for g, h in zip(got, again)),
              f"flash_attention_bwd ({route}): two runs differ")
        if route == "mma":
            err = max(rel_err(torch, [g.float()], [w.float()])[0]
                      for g, w in zip(got, want))
            outs = got
        del again
    # the (q, k) pairs: causal query q sees min(q + 1, window) keys (q + 1
    # without a window), a non-causal one every key
    pairs = (sum(min(i + 1, window or S) for i in range(S)) if causal
             else S * Sk)
    # the least arithmetic: five products over the pairs (S = QK^T to
    # recompute P, dP = dO V^T, dV = P^T dO, dK = dS^T Q, dQ = dS K)
    flops = 10.0 * B * H * pairs * d
    nbytes = 2.0 * (q.numel() + k.numel() + v.numel() + o.numel() + do.numel()
                    + sum(g.numel() for g in outs)) + 4.0 * lse.numel()
    b_ms, b_by = bound(flops, nbytes, BF16_PEAK)
    q4, k4, v4 = (t.view(B, -1, t.shape[1], d).detach().requires_grad_()
                  for t in (q, k, v))
    if window:
        pos = torch.arange(S, device=dev)
        band = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None]
                                                 - window)
        sdpa = dict(attn_mask=band)
    else:
        sdpa = dict(is_causal=causal)
    o4 = F.scaled_dot_product_attention(q4, k4, v4, enable_gqa=KV != H,
                                        **sdpa)
    do4 = do.view(B, H, S, d)

    def k4_bwd(route=None):
        return lambda: fa.flash_attention_bwd(q, k, v, o, lse, do,
                                              route=route, **kw)

    timed = {}
    if timed_routes:
        # each route's kernels on the device clock (fa_bwd_*), and the
        # forward with and without its lse
        timed = dict(
            simt_ms=cuda_ms(torch, k4_bwd("simt")),
            kernel_ms=device_ms(torch, k4_bwd(), "fa_bwd"),
            simt_kernel_ms=device_ms(torch, k4_bwd("simt"), "fa_bwd"),
            fwd_lse_ms=cuda_ms(torch, lambda: fa.flash_attention(
                q, k, v, return_lse=True, **kw)),
            fwd_ms=cuda_ms(torch, lambda: fa.flash_attention(q, k, v, **kw)))
    return dict(
        shape=dict(bh=B * H, bh_kv=B * KV, sq=S, sk=Sk, d=d, dtype="bf16",
                   causal=causal, window=window),
        max_abs_err=err, rel_err=rels["mma"], simt_rel_err=rels["simt"],
        lse_abs_err=lse_err, pairs=pairs,
        # the call with CUDA events (the kernel table's reading)
        ms=cuda_ms(torch, k4_bwd()), **timed,
        plain_ms=cuda_ms(torch, lambda: fa.flash_attention_bwd_plain(
            q, k, v, o, lse, do, **kw)),
        # SDPA's backward through autograd on the same inputs
        library_ms=cuda_ms(torch, lambda: torch.autograd.grad(
            o4, (q4, k4, v4), do4, retain_graph=True)),
        bound_ms=b_ms, bound_by=b_by,
    )


def _k4_bwd_window_record(torch, fa, F) -> dict:
    """K4's backward with a sliding window on both routes: first at a
    small shape whose window is no multiple of 64 and whose queries start
    at q_offset > 0 (bf16 on mma, <= FLASH_BWD_TOL; fp32 on simt, <=
    KERNEL_TOL), then at K4_BWD_WINDOW, zamba2-7b's training shape (bf16,
    the mma route the dtype takes and the simt route forced, each <=
    FLASH_BWD_TOL of max|plain| per gradient); every call twice for the
    same bits and counted as windowed on its route.  Timed beside the
    plain version, SDPA's autograd backward with the band as a boolean
    mask, and the bound of the pairs the window leaves."""
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(7)

    def inputs(bh, kv, sq, sk, d, dtype):
        return [torch.randn(n, s, d, generator=gen, device=dev).to(dtype)
                for n, s in ((bh, sq), (kv, sk), (kv, sk), (bh, sq))]

    def held(q, k, v, do, routes, **kw):
        """{route: per-gradient errors relative to max|plain|}, the
        largest absolute error of the first route, and its gradients."""
        o, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
        want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
        rels, err, first = {}, None, None
        for route, tol in routes:
            force = None if route == fa.bwd_route(q.dtype) else route
            before = dict(fa.BWD_WINDOW_ROUTES)
            got = fa.flash_attention_bwd(q, k, v, o, lse, do, route=force,
                                         **kw)
            again = fa.flash_attention_bwd(q, k, v, o, lse, do, route=force,
                                           **kw)
            torch.cuda.synchronize()
            check(fa.BWD_WINDOW_ROUTES[route] == before[route] + 2,
                  f"flash_attention_bwd {kw}: not windowed {route}")
            check(all(bool(torch.isfinite(g).all()) for g in got),
                  f"flash_attention_bwd ({route}) {kw}: non-finite")
            rels[route] = [rel_err(torch, [g.float()], [w.float()])[1]
                           for g, w in zip(got, want)]
            check(max(rels[route]) <= tol,
                  f"flash_attention_bwd ({route}) {kw} disagrees: "
                  f"{rels[route]}")
            check(all(torch.equal(g, h) for g, h in zip(got, again)),
                  f"flash_attention_bwd ({route}) {kw}: two runs differ")
            if first is None:
                err = max(rel_err(torch, [g.float()], [w.float()])[0]
                          for g, w in zip(got, want))
                first = got
            del again
        return rels, err, first, (o, lse)

    small_kw = dict(causal=True, q_offset=64, window=100)
    small = {}
    for route, dtype, tol in (("mma", torch.bfloat16, FLASH_BWD_TOL),
                              ("simt", torch.float32, KERNEL_TOL)):
        q, k, v, do = inputs(8, 2, 192, 256, 112, dtype)
        small[route] = held(q, k, v, do, [(route, tol)], **small_kw)[0][route]

    B, H, KV, S, d, W = (K4_BWD_WINDOW[x] for x in ("B", "H", "KV", "S", "d",
                                                     "window"))
    kw = dict(causal=True, window=W)
    q, k, v, do = inputs(B * H, B * KV, S, S, d, torch.bfloat16)
    rels, err, outs, (o, lse) = held(
        q, k, v, do, [("mma", FLASH_BWD_TOL), ("simt", FLASH_BWD_TOL)], **kw)
    # the least arithmetic: five products (S, dP, dV, dK, dQ) over the
    # pairs the window leaves, at the bf16 rate (the simt route's at
    # FP32's), against each input read and each output written once
    pairs = sum(min(i + 1, W) for i in range(S))
    flops = 10.0 * B * H * pairs * d
    nbytes = 2.0 * (q.numel() + k.numel() + v.numel() + o.numel() + do.numel()
                    + sum(g.numel() for g in outs)) + 4.0 * lse.numel()
    b_ms, b_by = bound(flops, nbytes, BF16_PEAK)
    simt_b_ms, _ = bound(flops, nbytes, FP32_PEAK)
    q4, k4, v4 = (t.view(B, -1, S, d).detach().requires_grad_()
                  for t in (q, k, v))
    pos = torch.arange(S, device=dev)
    band = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - W)
    o4 = F.scaled_dot_product_attention(q4, k4, v4, attn_mask=band,
                                        enable_gqa=KV != H)
    do4 = do.view(B, H, S, d)

    def k4_bwd(route=None):
        return lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, route=route,
                                              **kw)

    return dict(
        shape=dict(bh=B * H, bh_kv=B * KV, sq=S, sk=S, d=d, dtype="bf16",
                   causal=True, window=W),
        pairs=pairs, max_abs_err=err, rel_err=rels["mma"],
        simt_rel_err=rels["simt"],
        small=dict(shape=dict(bh=8, bh_kv=2, sq=192, sk=256, d=112,
                              **small_kw), mma_bf16_rel_err=small["mma"],
                   simt_fp32_rel_err=small["simt"]),
        # the call with CUDA events (the kernel table's reading), each
        # route; the mma route's kernels alone on the device clock
        ms=cuda_ms(torch, k4_bwd()),
        simt_ms=cuda_ms(torch, k4_bwd("simt")),
        kernel_ms=device_ms(torch, k4_bwd(), "fa_bwd"),
        plain_ms=cuda_ms(torch, lambda: fa.flash_attention_bwd_plain(
            q, k, v, o, lse, do, **kw)),
        # SDPA's backward through autograd, the band as a boolean mask
        library_ms=cuda_ms(torch, lambda: torch.autograd.grad(
            o4, (q4, k4, v4), do4, retain_graph=True)),
        bound_ms=b_ms, bound_by=b_by, simt_bound_ms=simt_b_ms,
        seconds=time.perf_counter() - t0,
    )


def _k4_record(torch, fa, F, gen, B, H, KV, S, Sk, d, window,
               causal, keep=False):
    """K4's bf16 kernel on (B·H, S, d) queries over (B·KV, Sk, d) keys and
    values (Sk None: S), causal or not, with ``window`` where it is > 0,
    against its plain version (<= FLASH_TOL of max|plain|), timed beside
    the plain version (a call of 200 ms or more timed once, the check's
    own), SDPA (the window as a boolean band mask) and its bound.  With
    ``keep``, returns (the record, (q, k, v, the plain version's lse))
    for :func:`_k4_bwd_record`."""
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    Sk = Sk or S
    q = torch.randn(B * H, S, d, generator=gen, device=dev).bfloat16()
    k = torch.randn(B * KV, Sk, d, generator=gen, device=dev).bfloat16()
    v = torch.randn(B * KV, Sk, d, generator=gen, device=dev).bfloat16()
    kw = dict(causal=causal, window=window)
    before = dict(fa.WINDOW_ROUTES), dict(fa.NONCAUSAL)
    got = fa.flash_attention(q, k, v, **kw)
    check(not window or fa.WINDOW_ROUTES["wgmma"] == before[0]["wgmma"] + 1,
          "flash_attention: the windowed call did not take the wgmma kernel")
    check(causal or fa.NONCAUSAL["wgmma"] == before[1]["wgmma"] + 1,
          "flash_attention: the non-causal call did not take the wgmma kernel")
    def plain():
        return fa.flash_attention_plain(q, k, v, return_lse=True, **kw)

    (want, want_lse), plain_ms = _timed(torch, plain)
    if plain_ms < 200.0:
        plain_ms = cuda_ms(torch, plain)
    err, rel = rel_err(torch, [got.float()], [want.float()])
    shape = dict(bh=B * H, bh_kv=B * KV, sq=S, sk=Sk, d=d, dtype="bf16",
                 causal=causal, window=window)
    check(bool(torch.isfinite(got).all()), f"flash_attention {shape}: non-finite")
    check(rel <= FLASH_TOL, f"flash_attention {shape} disagrees: {rel}")
    # the (q, k) pairs this input needs: causal query q sees min(q + 1,
    # window) keys (q + 1 without a window); a non-causal one every key
    pairs = (sum(min(i + 1, window or S) for i in range(S)) if causal
             else S * Sk)
    flops = 4.0 * B * H * pairs * d  # q.k and p.v
    nbytes = 2.0 * (q.numel() + k.numel() + v.numel() + got.numel())
    b_ms, b_by = bound(flops, nbytes, BF16_PEAK)
    q4, k4, v4 = (t.view(B, -1, t.shape[1], d) for t in (q, k, v))
    if window:
        pos = torch.arange(S, device=dev)
        band = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None]
                                                 - window)
        sdpa = dict(attn_mask=band)
    else:
        sdpa = dict(is_causal=causal)
    rec = dict(
        shape=shape, max_abs_err=err, rel_err=rel, pairs=pairs,
        ms=cuda_ms(torch, lambda: fa.flash_attention(q, k, v, **kw)),
        plain_ms=plain_ms,
        library_ms=cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            q4, k4, v4, enable_gqa=KV != H, **sdpa)),
        bound_ms=b_ms, bound_by=b_by, seconds=time.perf_counter() - t0,
    )
    return (rec, (q, k, v, want_lse)) if keep else rec


def _timed(torch, fn):
    """``fn()``'s result and its milliseconds on the card (CUDA events
    around one call)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _cpu_params(model) -> dict:
    from repro_torch.tree import tree_map

    return tree_map(lambda t: t.detach().cpu(), model.param_tree())


def _cast(params: dict, dtype, layers: int) -> dict:
    """Copies of the first ``layers`` layers of each of ``params``' layer
    stacks (the encoder-decoder's ``enc_layers`` and ``layers``), in
    ``dtype`` (training updates its weights in place)."""
    from repro_torch.tree import tree_map

    return {k: tree_map(lambda t: t.to(dtype, copy=True),
                        v[:layers] if k in ("enc_layers", "layers") else v)
            for k, v in params.items()}


@contextlib.contextmanager
def _patched(module, wrappers: dict):
    """``module``'s functions named in ``wrappers`` replaced by
    ``wrappers[name](function)`` inside the block."""
    saved = {n: getattr(module, n) for n in wrappers}
    for n, wrap in wrappers.items():
        setattr(module, n, wrap(saved[n]))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(module, n, fn)


def _spans(torch):
    """Wrappers that run each MoE function under its profiler span."""
    def wrap(span):
        def outer(fn):
            def inner(*a, **kw):
                with torch.profiler.record_function(span):
                    return fn(*a, **kw)
            return inner
        return outer
    return {n: wrap(span) for n, span in MOE_SPANS.items()}


def _serve_recorder(routes: list, shapes: list):
    """Wrappers of ``moe_route``, appending each call's dropped slots (a
    count left on the device: no sync), slots and capacity to ``routes``,
    and of ``blockwise_attention`` (K4's forward), appending each call's
    (bh, bh_kv, sq, sk, d) to ``shapes``."""
    def route(fn):
        def inner(*a, **kw):
            out = fn(*a, **kw)
            routes.append(((~out[3]).sum(), out[3].numel(), out[5]))
            return out
        return inner

    def attention(fn):
        def inner(q, k, v, **kw):
            B, Sq, H, d = q.shape
            shapes.append((B * H, B * k.shape[2], Sq, k.shape[1], d))
            return fn(q, k, v, **kw)
        return inner
    return {"moe_route": route, "blockwise_attention": attention}


def _route_recorder(routes: list):
    """A wrapper of ``moe_route`` that appends each call's (ids, keep) to
    ``routes`` on the host."""
    def outer(fn):
        def inner(*a, **kw):
            out = fn(*a, **kw)
            routes.append((out[2].cpu(), out[3].cpu()))
            return out
        return inner
    return {"moe_route": outer}


@contextlib.contextmanager
def _cross_counted(counts, counter: list):
    """Inside the block, ``counter[0]`` adds up the non-causal K4 launches
    made inside ``EncDecLM._cross_attn`` (the cross-attention's; the
    rest of the non-causal launches are the encoder's)."""
    from repro_torch.models.encdec import EncDecLM

    def noncausal():
        return sum(counts()["flash_noncausal"].values())

    def wrap(fn):
        def inner(*a, **kw):
            before = noncausal()
            out = fn(*a, **kw)
            counter[0] += noncausal() - before
            return out
        return inner

    with _patched(EncDecLM, {"_cross_attn": wrap}):
        yield


def _agree_decode(dd, model, cache, fed, start: int) -> list:
    """Logits of decode steps fed the tokens ``fed`` (B, n) from
    position ``start`` on, each on the host."""
    dev = model.top.embed.device
    out = []
    for i in range(fed.shape[1]):
        logits, cache = dd.decode_step(model, cache, fed[:, i:i + 1].to(dev),
                                       start + i)
        out.append(logits.cpu())
    return out


@contextlib.contextmanager
def _hybrid_blocks(on: bool, log: list, record_inputs: bool = False,
                   forced: list | None = None):
    """Inside the block (when ``on``), every call of the hybrid's blocks
    (``mamba_block`` and ``ZambaLM._shared_attn``, prefill and decode)
    appends its output hidden states, on the host, to ``log`` (with
    ``record_inputs``, ``(input, output)`` pairs).  With ``forced`` (a
    log of inputs from another run of the same calls), call ``i`` takes
    ``forced[i]``'s input as its hidden state in place of its own: each
    block runs from the other run's input to it."""
    if not on:
        yield
        return
    from repro_torch.models import hybrid as H

    calls = [0]

    def step(h, run):
        if forced is not None:
            h = forced[calls[0]][0].to(h.device)
        calls[0] += 1
        out = run(h)
        got = out[0].detach().cpu()
        log.append((h.detach().cpu(), got) if record_inputs else got)
        return out

    def mamba(fn):
        return lambda cfg, p, h, *a, **kw: step(
            h, lambda x: fn(cfg, p, x, *a, **kw))

    def shared(fn):
        return lambda self, sp, h, *a, **kw: step(
            h, lambda x: fn(self, sp, x, *a, **kw))

    with _patched(H, {"mamba_block": mamba}), \
            _patched(H.ZambaLM, {"_shared_attn": shared}):
        yield


# the world-size-1 checks: abstract trees (meta tensors) against the real
# ones on the card, and their per-rank bytes on a 1 x 1 mesh
ONE_MESH = ((1, 1), ("data", "model"))


def _world_size_one(abstract, logical, real, what: str) -> dict:
    """``abstract`` (meta tensors) against ``real`` (the card's tensors)
    leaf by leaf, shape and dtype, and its per-rank bytes on a 1 x 1 mesh
    against the sum of the real tensors' bytes: both exact."""
    from repro_torch import tree
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.parallel.sharding import rank_bytes

    want, got = dict(tree.flatten(abstract)), dict(tree.flatten(real))
    check(set(want) == set(got),
          f"{what}: abstract leaves {sorted(set(want) ^ set(got))[:8]} "
          "unmatched")
    bad = [p for p, a in want.items()
           if (tuple(a.shape), a.dtype) != (tuple(got[p].shape), got[p].dtype)
           or a.device.type != "meta"]
    check(not bad, f"{what}: abstract leaves differ from the card's: "
          f"{[(p, want[p], tuple(got[p].shape), got[p].dtype) for p in bad[:4]]}")
    nbytes = sum(t.numel() * t.element_size() for t in got.values())
    per_rank = rank_bytes(abstract, logical, MeshShape(*ONE_MESH))
    check(per_rank == nbytes, f"{what}: per-rank bytes on 1 x 1 {per_rank} "
          f"!= the card's {nbytes}")
    return dict(leaves=len(got), bytes=nbytes, per_rank_bytes=per_rank)


def _roofline(cfg, kind: str, batch: int, seq: int, measured_s: float,
              n_params: int) -> dict:
    """The analytic bound on one H100 of a ``kind`` step of ``cfg`` at
    ``batch`` x ``seq`` (the dry run's model, on a 1-device mesh) beside
    the measured time: a report, not a gate."""
    from repro_torch.configs import ShapeCell
    from repro_torch.roofline.analysis import analytic_roofline

    r = analytic_roofline(cfg, ShapeCell("smoke", seq, batch, kind),
                          n_params, 1)
    return dict(kind=kind, batch=batch, seq=seq, flops=r.flops,
                hbm_bytes=r.bytes_accessed, compute_s=r.compute_s,
                memory_s=r.memory_s, bound_s=r.bound_s, dominant=r.dominant,
                measured_s=measured_s, multiple=measured_s / r.bound_s)


def _serve_checked(torch, checks: dict):
    """A wrapper of ``decode_demo.generate`` that, after the serve, holds
    the model's parameters and a cache at the serve's batch and length
    (``init_cache``, the spec's types) to their abstract trees
    (:func:`_world_size_one`), recording the results in ``checks``."""
    from repro_torch.configs import ShapeCell
    from repro_torch.launch.specs import input_specs
    from repro_torch.models import param_defs
    from repro_torch.models.params import abstract_params, param_specs

    def outer(fn):
        def inner(model, inputs, gen_tokens):
            out = fn(model, inputs, gen_tokens)
            defs = param_defs(model.cfg)
            checks["params"] = _world_size_one(
                abstract_params(defs), param_specs(defs), model.param_tree(),
                f"{model.cfg.name} parameters")
            batch, prompt = inputs["tokens"].shape
            max_len = prompt + gen_tokens
            abs_in, log_in = input_specs(
                model.cfg, ShapeCell("serve", max_len, batch, "decode"))
            cache = model.init_cache(batch, max_len)
            checks["cache"] = dict(batch=batch, max_len=max_len,
                                   **_world_size_one(
                                       abs_in["cache"], log_in["cache"],
                                       cache, f"{model.cfg.name} cache"))
            del cache
            return out
        return inner
    return {"generate": outer}


def phase_serve(torch, arch, dd, build_model, get_config, counts, reset, L,
                layers=None, trace_layers=None, replay=False, **shape):
    """One served model: its config (the published depth, or ``layers``
    of it) through decode_demo's serve path at SERVE's shape (``shape``
    overrides its batch and prompt length), with K4's shapes and an MoE
    prefill's dropped slots recorded, then the card's prefill against the
    port's CPU run on the same weights and prompt (with
    ``replay`` the CPU taking the card's routing and attention inputs,
    their own distance from the card's held at the type's tolerance), then
    traces at ``trace_layers`` (default the served depth)."""
    import dataclasses

    from repro_torch.models import param_defs
    from repro_torch.models.params import count_params

    serve_shape = {**SERVE, **shape}
    full = get_config(arch)
    hybrid = full.family == "hybrid"
    encdec = full.is_encdec
    served = full if layers is None else dataclasses.replace(full,
                                                             num_layers=layers)
    reset()
    torch.cuda.reset_peak_memory_stats()
    cross = [0]
    # after the serve, the served model's parameters and a cache of its
    # batch and length against their abstract trees (world size 1)
    ws1 = {}
    routes, shapes = [], []
    with _patched(dd, _serve_checked(torch, ws1)), \
            _patched(L, _serve_recorder(routes, shapes)):
        if layers is None:
            with _cross_counted(counts, cross) if encdec else \
                    contextlib.nullcontext():
                r = dd.serve(arch, smoke=False, device="cuda", **serve_shape)
        else:
            # serve's own steps on the cut config: the weights from the
            # seed, the prompt from the seeded generator, prefill and
            # greedy decode
            model = build_model(served, seed=serve_shape["seed"],
                                device="cuda")
            gen = torch.Generator(device="cuda").manual_seed(
                serve_shape["seed"])
            r = dd.generate(model, dd.prompt_inputs(
                served, serve_shape["batch"], serve_shape["prompt_len"], gen),
                serve_shape["gen_tokens"])
            del model
    check(set(ws1) == {"params", "cache"},
          f"{arch}: the world-size-1 checks did not run: {ws1}")
    torch.cuda.synchronize()
    launched = counts()
    # the prefill's routing: its first calls, one a MoE layer (the decode
    # steps' follow)
    n_moe = served.num_layers - served.first_k_dense if full.num_experts else 0
    prefill_drops = None
    if n_moe:
        check(len(routes) == n_moe * serve_shape["gen_tokens"],
              f"{arch}: {len(routes)} routing calls for {n_moe} MoE layers "
              f"and {serve_shape['gen_tokens']} forward passes")
        prefill_drops = dict(
            tokens=serve_shape["batch"] * serve_shape["prompt_len"],
            slots=routes[0][1], capacity=routes[0][2],
            dropped=[int(d) for d, _, _ in routes[:n_moe]])
    if encdec:
        launched["cross_noncausal"] = cross[0]
    logits = r["prefill_logits"]
    check(bool(torch.isfinite(logits).all()), f"{arch}: non-finite logits")
    check(tuple(logits.shape) == (serve_shape["batch"], full.vocab_size),
          f"{arch}: prefill logits {tuple(logits.shape)}")
    check(tuple(r["generated"].shape)
          == (serve_shape["batch"], serve_shape["gen_tokens"]),
          f"{arch}: generated {r['generated'].shape}")
    peak = torch.cuda.max_memory_allocated()
    del r["prefill_logits"]
    torch.cuda.empty_cache()
    # a decode step's least time: every weight it reads (all but the
    # embedding table, of which it reads B rows, and an encoder-decoder's
    # encoder, which only the prefill runs) once, at the HBM rate
    defs = param_defs(served)
    weights = count_params(defs)
    if not served.tie_embeddings:
        weights -= served.vocab_size * served.d_model
    if encdec:
        weights -= count_params([defs["enc_norm"], defs["enc_layers"]])
    decode_bound_ms = 1e3 * 2.0 * weights / HBM_BW

    # the fp32 agreement and the traces: attention models at full width
    # and 2 layers (the CPU half holds their weights in fp32; an MoE
    # model's first_k_dense layers dense, the rest MoE), mamba2-130m
    # whole, the hybrid
    # at HYBRID_AGREE's 7 layers (bf16 too), its fp32 prompt past the
    # window and decode steps after it; the encoder-decoder at 2 + 2
    # layers on ENCDEC_AGREE's tokens and AGREE's frames, with decode
    # steps, the CPU taking the card's attention inputs
    if full.family in ("dense", "moe"):
        deep = dataclasses.replace(full, num_layers=2)
    elif encdec:
        deep = dataclasses.replace(full, num_layers=2, encoder_layers=2)
    elif hybrid:
        deep = dataclasses.replace(full, num_layers=HYBRID_AGREE["layers"])
    else:
        deep = full
    gen = torch.Generator().manual_seed(1)
    agree_in = dd.prompt_inputs(deep, AGREE["batch"], AGREE["prompt_len"], gen)
    params = _cpu_params(build_model(deep, seed=1, device="cuda"))
    agree_steps = 0
    if encdec:
        agree_steps = ENCDEC_AGREE["decode_steps"]
        fed = torch.randint(0, full.vocab_size, (AGREE["batch"], agree_steps),
                            generator=gen)
        agree_in["tokens"] = agree_in["tokens"][:, :ENCDEC_AGREE["tokens"]]
    runs = {}
    agree_launches = None
    for name, dtype, n in (
            ("bf16", torch.bfloat16, deep.num_layers if hybrid else BF16_LAYERS),
            ("fp32", torch.float32, deep.num_layers)):
        cfg = dataclasses.replace(full, num_layers=n)
        if encdec:
            cfg = dataclasses.replace(cfg, encoder_layers=n)
        cast = _cast(params, dtype, n)
        inputs, steps = agree_in, agree_steps
        if hybrid and name == "fp32":
            steps = HYBRID_AGREE["decode_steps"]
            inputs = dd.prompt_inputs(
                deep, AGREE["batch"], HYBRID_AGREE["prompt_len"] + steps, gen)
            fed = inputs["tokens"][:, -steps:]
            inputs = {"tokens": inputs["tokens"][:, :-steps]}
        S = inputs["tokens"].shape[1]

        def run(model):
            """Prefill logits and the decode steps' logits, on the host."""
            dev = model.top.embed.device
            cache, logits = dd.prefill(
                model, {k: v.to(dev) for k, v in inputs.items()},
                max_len=S + steps)
            out = _agree_decode(dd, model, cache, fed, S) if steps else []
            return logits.cpu(), out

        model = build_model(cfg, cast, device="cuda")
        card_routes, host_routes = [], []
        # the calls whose values the CPU run takes from the card's
        card_log, host_replay = [], []
        reset()
        with _patched(L, _route_recorder(card_routes)), \
                _replayed(torch, L, card_log) if encdec or replay \
                else contextlib.nullcontext():
            card, card_steps = run(model)
        torch.cuda.synchronize()
        if name == "fp32":
            agree_launches = counts()
        if not hybrid:
            del model
            torch.cuda.empty_cache()
        cpu_model = build_model(cfg, cast, device="cpu")
        host_log = []
        t0 = time.perf_counter()
        with _patched(L, _route_recorder(host_routes)), \
                _hybrid_blocks(hybrid, host_log, record_inputs=True), \
                _replayed(torch, L, host_replay, card_log) \
                if encdec or replay else contextlib.nullcontext():
            host, host_steps = run(cpu_model)
        runs[name] = dict(card=card, host=host, layers=n, prompt_len=S,
                          card_steps=card_steps, host_steps=host_steps,
                          cpu_s=time.perf_counter() - t0)
        if encdec or replay:
            # the CPU's own run, free of the card's values: reported (the
            # reference's init makes the attention near hard, and an fp32
            # encoder-decoder's first encoder layer rounds to bf16, so one
            # rounding moves a score by units; a flipped top-1 routing
            # decision swaps a token's routed output), and how far its own
            # values of the replayed calls were from the card's
            free, free_steps = run(cpu_model)
            runs[name].update(free=free, free_steps=free_steps,
                              replayed=_replay_differs(card_log, host_replay))
        if encdec:
            runs[name]["frames"] = inputs["embeds"].shape[1]
        del card_log, host_replay
        if hybrid:
            # each block on the card from the CPU's input to it, its
            # output against the CPU's (the gate: the reference's random
            # init amplifies any rounding through the shared block, see
            # HYBRID_AGREE)
            card_log = []
            with _hybrid_blocks(True, card_log, forced=host_log):
                run(model)
            runs[name]["blocks"] = [
                float((c - h).abs().max() / h.abs().max())
                for c, (_, h) in zip(card_log, host_log)]
            check(len(card_log) == len(host_log) > 0,
                  f"{arch}: {len(card_log)} card blocks, {len(host_log)} CPU")
            del model, card_log, host_log
            torch.cuda.empty_cache()
        if card_routes:
            # the (token, rank) decisions of the compared (last) MoE
            # layer that differ: another expert, or kept on one side and
            # dropped on the other (a flip early in the flat order moves
            # the later slots of its experts, so drops differ in turn);
            # the compared logits are the last token's, whose decisions
            # come last
            (ci, ck), (hi, hk) = card_routes[-1], host_routes[-1]
            expert = (ci != hi).reshape(-1)
            differ = expert | (ck != hk)
            k = ci.shape[-1]
            runs[name]["routing"] = dict(
                decisions=int(ck.numel()), differ=int(differ.sum()),
                expert_differs=int(expert.sum()),
                kept_differs=int((ck != hk).sum()),
                last_token_differs=int(differ[-k:].sum()),
                dropped_card=int((~ck).sum()), dropped_cpu=int((~hk).sum()))
        del cpu_model, cast

    # where the time goes at the serve shapes, in bf16: one prefill, then
    # one decode step, the MoE functions under their spans
    trace_cfg = (served if trace_layers is None
                 else dataclasses.replace(full, num_layers=trace_layers))
    del params
    model = build_model(trace_cfg, seed=1, device="cuda")
    P = serve_shape["prompt_len"]
    big = {k: v.cuda() for k, v in dd.prompt_inputs(
        trace_cfg, serve_shape["batch"], P,
        torch.Generator().manual_seed(2)).items()}
    dd.prefill(model, big)
    with _patched(L, _spans(torch)):
        prefill_trace = profile(torch, lambda: dd.prefill(model, big))
    cache, logits = dd.prefill(model, big, max_len=P + 2)
    nxt = logits.argmax(-1)[:, None]
    dd.decode_step(model, cache, nxt, P)
    with _patched(L, _spans(torch)):
        decode_trace = profile(torch, lambda: dd.decode_step(
            model, cache, nxt, P + 1))
    del cache, model, big
    torch.cuda.empty_cache()

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    for name, run in runs.items():
        check(bool(torch.isfinite(run["card"]).all()),
              f"{arch}: non-finite {name} card logits")
    err32 = rel(runs["fp32"]["card"], runs["fp32"]["host"])
    err16 = rel(runs["bf16"]["card"], runs["bf16"]["host"])
    # each decode step's logits after the fp32 prompt (the hybrid's; the
    # encoder-decoder's after both prompts)
    err32_steps = [rel(c, h) for c, h in zip(runs["fp32"]["card_steps"],
                                            runs["fp32"]["host_steps"])]
    err16_steps = [rel(c, h) for c, h in zip(runs["bf16"]["card_steps"],
                                            runs["bf16"]["host_steps"])]
    routing = {k: v["routing"] for k, v in runs.items() if "routing" in v}
    blocks = {k: v["blocks"] for k, v in runs.items() if "blocks" in v}
    free = {k: dict(prefill=rel(v["card"], v["free"]),
                    decode_steps=[rel(c, h) for c, h in zip(
                        v["card_steps"], v["free_steps"])],
                    replayed=v["replayed"])
            for k, v in runs.items() if "free" in v}
    if encdec:
        # the prefill logits and every decode step's, the CPU taking the
        # card's attention inputs; the free CPU run reported
        seen = (f"prefill fp32 {err32}, bf16 {err16}; decode steps fp32 "
                f"{err32_steps}, bf16 {err16_steps}; free CPU run {free}")
        check(max([err32] + err32_steps) <= SERVE_TOL_FP32,
              f"{arch}: fp32 card vs CPU: {seen}")
        check(max([err16] + err16_steps) <= SERVE_TOL,
              f"{arch}: bf16 card vs CPU: {seen}")
    elif hybrid:
        # fp32: the prefill logits, and every block of the prefill and of
        # the decode steps; bf16: every block (see HYBRID_AGREE); the
        # decode steps' logits and the bf16 logits reported
        seen = (f"prefill fp32 {err32}, bf16 {err16}; decode steps fp32 "
                f"{err32_steps}; blocks {blocks}")
        check(err32 <= SERVE_TOL_FP32, f"{arch}: fp32 card vs CPU: {seen}")
        for name, tol in (("fp32", SERVE_TOL_FP32), ("bf16", SERVE_TOL)):
            check(max(blocks[name]) <= tol, f"{arch}: {name} blocks: {seen}")
    else:
        check(err32 <= SERVE_TOL_FP32,
              f"{arch}: fp32 card vs CPU prefill {err32} (routing {routing}; "
              f"free CPU run {free})")
        check(err16 <= SERVE_TOL,
              f"{arch}: bf16 card vs CPU prefill {err16} (routing {routing}; "
              f"free CPU run {free})")
        if replay:
            # the card's q, k and v, which the CPU took, held against the
            # CPU's own at the type's tolerance
            for name, tol in (("fp32", SERVE_TOL_FP32), ("bf16", SERVE_TOL)):
                err = free[name]["replayed"]["attention_inputs_rel_err"]
                check(err <= tol, f"{arch}: {name} card's attention inputs "
                                  f"{err} from the CPU's: {free}")
    step_ms = 1e3 * r["decode_s"] / (serve_shape["gen_tokens"] - 1)
    if layers is not None:
        cut = f"depth {layers} of {full.num_layers} layers, published widths"
    elif hybrid:
        cut = (f"none: all {full.num_layers} layers at the published widths; "
               f"the card-vs-CPU agreement at {deep.num_layers} of them (one "
               f"group of {full.attn_every} mamba layers and the shared "
               "block, one tail layer: 2 layers hold no attention)")
    else:
        cut = None
    return dict(
        arch=arch, layers=served.num_layers,
        published_layers=full.num_layers, cut=cut,
        **serve_shape,
        prefill_s=r["prefill_s"], decode_s=r["decode_s"],
        decode_tok_per_s=r["decode_tok_per_s"], decode_step_ms=step_ms,
        decode_weights_bound_ms=decode_bound_ms,
        world_size_one=ws1,
        prefill_roofline=_roofline(served, "prefill", serve_shape["batch"],
                                   serve_shape["prompt_len"], r["prefill_s"],
                                   count_params(defs)),
        first_tokens=r["generated"][0][:8].tolist(), peak_bytes=peak,
        agreement=dict(batch=AGREE["batch"],
                       prompt_len_bf16=runs["bf16"]["prompt_len"],
                       prompt_len_fp32=runs["fp32"]["prompt_len"],
                       layers_bf16=runs["bf16"]["layers"],
                       layers_fp32=runs["fp32"]["layers"], rel_err_bf16=err16,
                       rel_err_fp32=err32,
                       rel_err_fp32_decode_steps=err32_steps,
                       rel_err_bf16_decode_steps=err16_steps,
                       **({"frames": runs["fp32"]["frames"]} if encdec
                          else {}),
                       **({"free_cpu_run": free} if free else {}),
                       routing=routing,
                       blocks={k: dict(n=len(v), max=max(v), each=v)
                               for k, v in blocks.items()},
                       fp32_card_launches=agree_launches,
                       cpu_s={k: v["cpu_s"] for k, v in runs.items()}),
        prefill_trace=dict(layers=trace_cfg.num_layers,
                           batch=serve_shape["batch"], prompt_len=P,
                           **prefill_trace),
        decode_trace=dict(layers=trace_cfg.num_layers,
                          batch=serve_shape["batch"], **decode_trace),
        k4_shapes=sorted(set(shapes)), prefill_drops=prefill_drops,
        launches=launched,
    )


def _layout(cfg, ocfg, device="cuda"):
    """The sharded step's layout of ``cfg``'s state on the one-rank mesh
    (``nccl`` on the card)."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train.train_step import TrainLayout

    return TrainLayout(cfg, ocfg, make_host_mesh(*ONE_RANK, device),
                       cfg.sharding_recipe)


def _train_steps(torch, model, ocfg, batches, layout=None):
    """Run ``batches`` through a fresh training state of ``model`` (the
    sharded step's, with ``layout``; each batch cut to the rank's rows):
    (losses, grad norms, step seconds, state, step function), each step
    ended by a device sync (``float`` of its loss)."""
    from repro_torch.train.train_step import init_state, make_train_step

    state = init_state(model, ocfg, layout)
    step = make_train_step(model, ocfg, layout)
    losses, norms, secs = [], [], []
    for batch in batches:
        t0 = time.perf_counter()
        if layout is not None:
            batch = layout.rows(batch)
        state, met = step(state, batch)
        losses.append(float(met["loss"]))
        secs.append(time.perf_counter() - t0)
        norms.append(float(met["grad_norm"]))
    return losses, norms, secs, state, step


def _train_inputs(get_config, arch, batch, seq, layers=None):
    """The train phase's config of ``arch`` (its published config and its
    cut), TRAIN_STEPS + 1 batches of batch x seq (the reference
    launcher's: embeds and M-RoPE positions for the VLM) and its
    optimizer's config."""
    from repro_torch.launch.train import train_batch, train_dataset
    from repro_torch.train import optimizer as opt

    full = get_config(arch)
    cfg = full if layers is None else dataclasses.replace(full,
                                                          num_layers=layers)
    ds = train_dataset(cfg, seq, batch, seed=0)
    batches = [train_batch(cfg, ds, i) for i in range(TRAIN_STEPS + 1)]
    ocfg = opt.OptimizerConfig(learning_rate=1e-3, warmup_steps=2,
                               total_steps=100)
    return full, cfg, batches, ocfg


def plain_train_peak(torch, arch, build_model, get_config) -> dict:
    """``arch``'s peak device memory over TRAIN_STEPS steps at TRAIN's
    shapes and depth through the plain step (``make_train_step`` with no
    layout): the bytes PLAIN_TRAIN_PEAK records, which the train phase's
    sharded step on one rank is held to (``--plain-peak ARCH``)."""
    spec = TRAIN[arch]
    _, cfg, batches, ocfg = _train_inputs(get_config, arch, spec["batch"],
                                          spec["seq"], spec.get("layers"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    model = build_model(cfg, seed=0, device="cuda")
    losses, norms, secs, state, step = _train_steps(
        torch, model, ocfg, batches[:TRAIN_STEPS])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del model, state, step
    torch.cuda.empty_cache()
    return dict(arch=arch, **{**spec, "layers": cfg.num_layers},
                peak_bytes=peak, recorded_bytes=PLAIN_TRAIN_PEAK.get(arch),
                losses=losses, grad_norms=norms, step_s=secs)


def phase_train(torch, arch, build_model, get_config, counts, reset, L,
                batch, seq, layers=None) -> dict:
    """One model trained on the card at full width, at its published depth
    or ``layers`` of it (batch x seq tokens a step, TRAIN_STEPS steps);
    an MoE model's first MOE_REPEAT steps run again from the same seed
    for the same bits; then the card's first steps at a few layers
    against the port's CPU run (TRAIN_AGREE, the hybrid's
    HYBRID_TRAIN_AGREE)."""
    import dataclasses

    from repro_torch import tree
    from repro_torch.launch.train import train_batch, train_dataset
    from repro_torch.models import param_defs
    from repro_torch.models.params import count_params
    from repro_torch.train.train_step import abstract_state, state_logical

    full, cfg, batches, ocfg = _train_inputs(get_config, arch, batch, seq,
                                             layers)
    moe = full.family == "moe"
    hybrid = full.family == "hybrid"
    layout = _layout(cfg, ocfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset()
    model = build_model(cfg, seed=0, device="cuda")
    losses, norms, secs, state, step = _train_steps(
        torch, model, ocfg, batches[:TRAIN_STEPS], layout)
    torch.cuda.synchronize()
    launched = counts()
    peak = torch.cuda.max_memory_allocated() - base
    # on one rank each parameter block is the model's own tensor
    own = dict(tree.flatten(model.param_tree()))
    blocks = dict(tree.flatten(state.params))
    copies = [p for p, b in blocks.items()
              if b.data_ptr() != own[p].data_ptr()]
    check(set(blocks) == set(own) and not copies,
          f"{arch}: {len(copies)} parameter blocks on the one-rank mesh "
          f"are not the model's own tensors: {copies[:4]}")
    n_blocks = len(blocks)
    del own, blocks  # the weights leave the card with the state below
    want_peak = PLAIN_TRAIN_PEAK[arch]
    check(abs(peak - want_peak) <= PEAK_SAME * want_peak,
          f"{arch}: the sharded step's peak {peak} is not within "
          f"{PEAK_SAME:.0%} of the plain step's {want_peak}")
    # the training state on the card against its abstract twin (world
    # size 1): every parameter, moment, count and step
    ws1 = _world_size_one(abstract_state(cfg, ocfg), state_logical(cfg, ocfg),
                          state, f"{arch} training state")
    with _patched(L, _spans(torch) if moe else {}):
        trace = profile(torch, lambda: float(
            step(state, layout.rows(batches[TRAIN_STEPS]))[1]["loss"]))
    positions = _positions_reach(torch, model, layout.rows(
        batches[TRAIN_STEPS])) if full.mrope else None
    del state, step, model
    torch.cuda.empty_cache()
    check(all(math.isfinite(x) for x in losses + norms),
          f"{arch}: non-finite training loss or grad norm {losses} {norms}")
    # a random head of std s over unit-RMS hidden states gives logits of
    # variance d s^2, so the expected first loss is ln V + d s^2 / 2
    defs = param_defs(cfg)
    s_head = (defs["embed"] if full.tie_embeddings else defs["head"]).scale
    expect = math.log(full.vocab_size) + full.d_model * s_head ** 2 / 2
    first = abs(losses[0] - expect)
    check(first <= 0.1, f"{arch}: first loss {losses[0]} is {first} from "
          f"ln V + d s^2 / 2 = {expect}")
    n_params = count_params(defs)
    repeat = None
    if moe:
        # the dispatch's backward writes each kept gradient once (the
        # trash row's repeats are dropped): the same steps from the same
        # seed give the same bits
        model = build_model(cfg, seed=0, device="cuda")
        again = _train_steps(torch, model, ocfg, batches[:MOE_REPEAT],
                             layout)[:2]
        del model
        torch.cuda.empty_cache()
        repeat = dict(steps=MOE_REPEAT, losses=again[0], grad_norms=again[1])
        check(again[0] == losses[:MOE_REPEAT]
              and again[1] == norms[:MOE_REPEAT],
              f"{arch}: two runs of the same steps differ: {losses} {norms} "
              f"vs {again[:2]}")

    sharded = _sharded_matches_plain(torch, build_model, full)

    # the card against the CPU on the same weights and batches
    spec = (HYBRID_TRAIN_AGREE if hybrid
            else {**TRAIN_AGREE, **TRAIN_AGREE_CUT.get(arch, {})})
    small = dataclasses.replace(full, num_layers=spec["layers"])
    if hybrid:
        small = dataclasses.replace(small, window=spec["window"])
    if full.is_encdec:
        small = dataclasses.replace(small, encoder_layers=spec["layers"])
    params = _cpu_params(build_model(small, seed=1, device="cuda"))
    torch.cuda.empty_cache()
    if hybrid:
        ads = train_dataset(small, spec["seq"], spec["batch"], seed=1)
        agree = _hybrid_agreement(torch, L, build_model, small, params,
                                  train_batch(small, ads, 0), counts, reset)
    else:
        # an encoder-decoder gets twice as many frames as tokens: the
        # cross-attention's queries and keys differ in length (sq 128 on
        # sk 256), forward and back
        frames = 2 * spec["seq"] if full.is_encdec else spec["seq"]
        ads = train_dataset(small, frames, spec["batch"], seed=1)
        agree_batches = [
            {k: v[:, :spec["seq"]] if k in ("tokens", "labels") else v
             for k, v in train_batch(small, ads, i).items()}
            for i in range(spec["steps"])]
        agree = _train_agreement(torch, L, build_model, small, params,
                                 agree_batches, counts, reset,
                                 replay=moe or full.is_encdec,
                                 bf16_steps=spec.get("bf16_steps"))
    del params
    tokens = batch * seq
    if layers is None:
        cut = None
    else:
        cut = f"depth {layers} of {full.num_layers} layers, published widths"
    return dict(
        arch=arch, layers=cfg.num_layers, published_layers=full.num_layers,
        cut=cut, params=n_params, batch=batch, seq=seq, steps=TRAIN_STEPS,
        window=cfg.window, losses=losses, grad_norms=norms,
        ln_vocab=math.log(full.vocab_size), expected_first_loss=expect,
        step_ms=[1e3 * t for t in secs],
        tokens_per_s=tokens * (len(secs) - 1) / sum(secs[1:]),
        world_size_one=ws1,
        sharded=dict(mesh=list(ONE_RANK[0]), axes=list(ONE_RANK[1]),
                     recipe=cfg.sharding_recipe,
                     batch_axes=list(layout.batch_axes),
                     own_blocks=n_blocks, plain_peak_bytes=want_peak,
                     peak_vs_plain=peak / want_peak, against_plain=sharded),
        step_roofline=_roofline(cfg, "train", batch, seq,
                                sum(secs[1:]) / (len(secs) - 1), n_params),
        peak_bytes=peak, step_trace=trace, repeat=repeat,
        mrope_positions=positions,
        agreement=dict(**spec, **({"window_cut": spec["window"]} if hybrid
                                  else {}), **agree),
        launches=launched,
    )


def _positions_reach(torch, model, batch: dict) -> dict:
    """The M-RoPE positions reach the trained model: its loss on
    ``batch`` (no step: the state stays) twice, the same bits, and with
    the height and width positions shifted by each token's index (their
    distances doubled, the temporal ones kept), another loss.  A uniform
    shift of an axis would not do: the rotary phase is relative."""
    shifted = dict(batch, positions=batch["positions"].clone())
    S = shifted["positions"].shape[-1]
    shifted["positions"][1:] += torch.arange(S, dtype=shifted[
        "positions"].dtype)
    with torch.no_grad():
        same = [float(model.loss(batch)[0]) for _ in range(2)]
        other = float(model.loss(shifted)[0])
    check(same[0] == same[1] and other != same[0],
          f"{model.cfg.name}: the M-RoPE positions do not reach the loss: "
          f"{same} and {other} shifted")
    return dict(loss=same[0], again=same[1], shifted_loss=other,
                shift="height and width + token index")


def phase_tp_local(torch, build_model, get_config, counts, reset, L,
                   device="cuda") -> dict:
    """TP_LOCAL: for each model and P, every rank's share of each of its
    blocks on the card (``parallel.tp_local.check_block``, no group: each
    conjugate op the identity, the mixer's norm statistic replayed from
    the ranks' sums), summed and held against the whole block, forward
    and backward, in fp32 and bf16; each attention block's K4 and its
    backward launched once for the whole block and once for each rank's
    heads, on the route of the type (fp32 simt, bf16 wgmma/mma; non-causal
    and windowed where the block is), each mixer's K5 and its backward
    once for the whole and once for each rank in each pass, on wgmma;
    each MoE block's expert products on all the experts for the whole
    block and on E/P for each rank.  The counts are zeroed before each
    model, type and P and read after; each block's launches and seconds
    are kept apart."""
    from repro_torch.kernels import ops
    from repro_torch.parallel import tp_local

    t0 = time.perf_counter()
    attn_heads, ssd_heads, experts = [], [], []
    # the attention inputs replayed into the ranks' calls: the whole
    # block's (its first call), the next rank, the rank's own inputs'
    # largest distance from them
    replay = {"on": False, "whole": None, "rank": 0, "input_err": 0.0}

    def recorded_attention(fn):
        def inner(q, k, v, **kw):
            attn_heads.append((q.shape[2], k.shape[2]))
            if replay["on"]:
                if replay["whole"] is None:
                    replay["whole"] = (q.detach(), k.detach(), v.detach())
                else:
                    r, replay["rank"] = replay["rank"], replay["rank"] + 1
                    # rank r's q heads, and the kv heads they read: its
                    # own where the kv heads split, else the one its q
                    # heads share (q head h reads kv head h // group)
                    wq, wk, _ = replay["whole"]
                    group = wq.shape[2] // wk.shape[2]
                    first = (r * q.shape[2], r * q.shape[2] // group,
                             r * q.shape[2] // group)
                    subs = [w[:, :, f:f + t.shape[2]] for w, t, f in
                            zip(replay["whole"], (q, k, v), first)]
                    replay["input_err"] = max(
                        replay["input_err"],
                        *(float((t.detach() - w).abs().max()
                                / w.abs().max().clamp_min(1e-30))
                          for t, w in zip((q, k, v), subs)))
                    # the whole's values, the rank's gradients
                    q, k, v = (w + (t - t.detach())
                               for t, w in zip((q, k, v), subs))
            return fn(q, k, v, **kw)
        return inner

    def recorded_ssd(fn):
        def inner(x, dt, a, b, c, **kw):
            ssd_heads.append(x.shape[0] // b.shape[0])
            return fn(x, dt, a, b, c, **kw)
        return inner

    def recorded_experts(fn):
        def inner(x, w_gate, w_up, w_down):
            experts.append(x.shape[0])
            return fn(x, w_gate, w_up, w_down)
        return inner

    def launched(before, after):
        """The K4 and K5 launches between two readings of the counts."""
        keys = ("flash_attention", "flash_attention_bwd", "ssd_chunk",
                "ssd_chunk_bwd")
        out = {k: after[k] - before[k] for k in keys}
        for k in ("flash_fwd_routes", "flash_bwd_routes", "flash_noncausal",
                  "flash_bwd_noncausal", "flash_window_routes",
                  "flash_bwd_window_routes", "ssd_routes", "ssd_bwd_routes"):
            out[k] = {r: after[k][r] - before[k][r] for r in after[k]}
        return out

    out, models = {}, {}
    with _patched(L, {"blockwise_attention": recorded_attention,
                      "expert_ffn": recorded_experts}), \
            _patched(ops, {"ssd_scan": recorded_ssd}):
        for arch, spec in TP_LOCAL.items():
            t1 = time.perf_counter()
            full = get_config(arch)
            cfg = dataclasses.replace(
                full, num_layers=spec["layers"],
                **({"encoder_layers": spec["encoder_layers"]}
                   if "encoder_layers" in spec else {}))
            model = build_model(cfg, seed=0, device=device)
            gen = torch.Generator(device=device).manual_seed(0)
            B, S = spec["batch"], spec["seq"]
            frames = spec.get("frames", S)
            h = torch.randn((B, S, cfg.d_model), generator=gen, device=device)
            dy = torch.randn((B, S, cfg.d_model), generator=gen,
                             device=device)
            h_enc = torch.randn((B, frames, cfg.d_model), generator=gen,
                                device=device)
            dy_enc = torch.randn((B, frames, cfg.d_model), generator=gen,
                                 device=device)
            positions = (_vlm_positions(torch, B, S, device) if cfg.mrope
                         else None)
            nheads = (cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim
                      if cfg.ssm_state else 0)
            for name, dtype in (("fp32", torch.float32),
                                ("bf16", torch.bfloat16)):
                stacks = {
                    "layers": [lay.tensors() for lay in model.layers],
                    "enc_layers": [lay.tensors() for lay in
                                   getattr(model, "enc_layers", [])],
                    "shared": [model.top.tensors().get("shared")],
                }
                stacks = {k: [None if p is None else
                              {n: t.to(dtype) for n, t in p.items()}
                              for p in v] for k, v in stacks.items()}
                for size in TP_SIZES:
                    reset()
                    worst, own, per_block = {}, {}, {}
                    attn_heads.clear()
                    ssd_heads.clear()
                    experts.clear()
                    want_attn, want_ssd, want_experts = [], [], []
                    hq, kv = _tp_heads(cfg.num_heads, cfg.num_kv_heads, size)
                    for block in spec["blocks"]:
                        _, _, stack = tp_local.BLOCKS[block]
                        enc = block.startswith("enc_")
                        # with replay: the block on the ranks' own
                        # inputs first (reported, not held), then replayed
                        held = not (name in spec.get("replay", ())
                                    and "attention" in block)
                        calls = [(i, params, replayed) for i, params in
                                 enumerate(stacks[stack])
                                 if params is None
                                 or tp_local.holds(block, params)
                                 for replayed in
                                 ((False,) if held else (False, True))]
                        for i, params, replayed in calls:
                            before = counts()
                            replay.update(on=replayed, whole=None, rank=0)
                            t2 = time.perf_counter()
                            got = tp_local.check_block(
                                model, i, block,
                                (h_enc if enc else h).to(dtype),
                                (dy_enc if enc else dy).to(dtype), size,
                                params,
                                memory=h_enc.to(dtype)
                                if block == "cross_attention" else None,
                                positions=positions
                                if block == "attention" else None)
                            torch.cuda.synchronize()
                            seconds = time.perf_counter() - t2
                            n = launched(before, counts())
                            errs = dict(out=got["out"], dx=got["dx"],
                                        grads=max(got["grads"].values()),
                                        **({"dmem": got["dmem"]}
                                           if "dmem" in got else {}))
                            if replayed:
                                errs["inputs"] = replay["input_err"]
                                replay.update(on=False, input_err=0.0)
                            if held or replayed:
                                per_block[f"{block}:{i}"] = dict(
                                    passes=got["passes"], seconds=seconds,
                                    **n)
                            for k, e in errs.items():
                                key = f"{block}_{k}"
                                table = worst if held or replayed else own
                                table[key] = max(table.get(key, 0.0), e)
                            ranks = 1 + got["passes"] * size
                            if "attention" in block:
                                want_attn += [(cfg.num_heads,
                                               cfg.num_kv_heads)] + [
                                    (hq, kv)] * size
                                _check_tp_attention(
                                    arch, name, size, block, n, 1 + size,
                                    causal=block not in ("enc_attention",
                                                         "cross_attention"),
                                    window=cfg.window > 0)
                            elif block == "mamba":
                                want_ssd += [nheads] + [nheads // size] * (
                                    ranks - 1)
                                check(n["ssd_chunk"] == n["ssd_chunk_bwd"]
                                      == n["ssd_routes"]["wgmma"]
                                      == n["ssd_bwd_routes"]["wgmma"]
                                      == ranks and got["passes"] == 3,
                                      f"tp_local {arch} {name} P={size} "
                                      f"{block}: K5 launches {n}, want "
                                      f"{ranks} on wgmma")
                            elif block == "moe":
                                want_experts += [cfg.num_experts] + [
                                    cfg.num_experts // size] * size
                                check(got["passes"] == 1 and not any(
                                    n[k] for k in ("flash_attention",
                                                   "flash_attention_bwd",
                                                   "ssd_chunk",
                                                   "ssd_chunk_bwd")),
                                      f"tp_local {arch} {name} P={size} "
                                      f"{block}: {got['passes']} passes, "
                                      f"launches {n}")
                    attends = any("attention" in b for b in spec["blocks"])
                    rec = dict(errors=worst,
                               heads_per_rank=[hq, kv] if attends else None,
                               ssd_heads_per_rank=nheads // size
                               if nheads else None,
                               experts_per_rank=cfg.num_experts // size
                               if cfg.num_experts else None,
                               blocks=per_block,
                               own_inputs_errors=own or None)
                    out[f"{arch}:{name}:P{size}"] = rec
                    check(max(worst.values()) <= TP_TOL[name],
                          f"tp_local {arch} {name} P={size}: the ranks' sums "
                          f"are not the whole block's: {worst}")
                    check(attn_heads == want_attn,
                          f"tp_local {arch} {name} P={size}: attention heads "
                          f"{attn_heads}")
                    check(ssd_heads == want_ssd,
                          f"tp_local {arch} {name} P={size}: SSD heads "
                          f"{ssd_heads}")
                    check(experts == want_experts,
                          f"tp_local {arch} {name} P={size}: routed experts "
                          f"{experts}")
                del stacks
            models[arch] = dict(
                layers=cfg.num_layers, published_layers=full.num_layers,
                encoder_layers=cfg.encoder_layers, batch=spec["batch"],
                seq=spec["seq"], frames=spec.get("frames"),
                mrope_positions=f"an image of {VLM_GRID} x {VLM_GRID} "
                f"patches, then text" if cfg.mrope else None,
                blocks=spec["blocks"], seconds=time.perf_counter() - t1)
            del model, h, dy, h_enc, dy_enc
            torch.cuda.empty_cache()
    return dict(models=models, sizes=TP_SIZES, tolerance=TP_TOL, checks=out,
                seconds=time.perf_counter() - t0)


def _vlm_positions(torch, B: int, S: int, device):
    """M-RoPE positions (3, B, S) of a prompt that opens with an image of
    VLM_GRID x VLM_GRID patches (temporal 0, height its row, width its
    column) and goes on in text (all three axes VLM_GRID, VLM_GRID + 1,
    ...), each batch row the same."""
    n = min(S, VLM_GRID * VLM_GRID)
    i = torch.arange(n)
    text = VLM_GRID + torch.arange(S - n)
    pos = torch.stack([torch.cat([torch.zeros(n, dtype=torch.long), text]),
                       torch.cat([i // VLM_GRID, text]),
                       torch.cat([i % VLM_GRID, text])])
    return pos[:, None].expand(3, B, S).to(device)


def _check_tp_attention(arch, name, size, block, n, ranks, causal, window):
    """One attention block's K4 launches in tp_local: forward and
    backward ``ranks`` times (the whole block, then each rank's heads) on
    the route of the type, all non-causal where the block is not causal,
    all windowed where the model's attention is."""
    fwd, bwd = ("simt", "simt") if name == "fp32" else ("wgmma", "mma")
    ok = (n["flash_attention"] == n["flash_attention_bwd"] == ranks
          and n["flash_fwd_routes"][fwd] == n["flash_bwd_routes"][bwd]
          == ranks
          and n["flash_noncausal"][fwd] == n["flash_bwd_noncausal"][bwd]
          == (0 if causal else ranks)
          and n["flash_window_routes"][fwd]
          == n["flash_bwd_window_routes"][bwd] == (ranks if window else 0))
    check(ok, f"tp_local {arch} {name} P={size} {block}: K4 launches {n}, "
              f"want {ranks} on {fwd} and {bwd}")


def _sharded_matches_plain(torch, build_model, full, device="cuda") -> dict:
    """``full`` at TRAIN_AGREE's 2 layers (the encoder-decoder's 2 + 2),
    its bf16 weights drawn from seed 1 twice: TRAIN_AGREE's steps through
    the plain step and through the sharded step on the one-rank mesh.
    The losses, grad norms and every parameter after the steps must be
    equal bit for bit."""
    from repro_torch import tree
    from repro_torch.launch.train import train_batch, train_dataset
    from repro_torch.train import optimizer as opt

    small = dataclasses.replace(full, num_layers=TRAIN_AGREE["layers"])
    if full.is_encdec:
        small = dataclasses.replace(small,
                                    encoder_layers=TRAIN_AGREE["layers"])
    ocfg = opt.OptimizerConfig(learning_rate=TRAIN_AGREE["lr"],
                               warmup_steps=0,
                               total_steps=TRAIN_AGREE["steps"])
    ds = train_dataset(small, TRAIN_AGREE["seq"], TRAIN_AGREE["batch"], seed=1)
    batches = [train_batch(small, ds, i) for i in range(TRAIN_AGREE["steps"])]
    runs = {}
    for how, layout in (("plain", None),
                        ("sharded", _layout(small, ocfg, device))):
        model = build_model(small, seed=1, device=device)
        losses, norms, _, state, step = _train_steps(torch, model, ocfg,
                                                     batches, layout)
        # on the host, and nothing of a run left on the card for the
        # next: qwen2-vl-72b's 8.5 GB of bf16 weights twice beside its
        # 51 GB of state would not fit
        runs[how] = (losses, norms, [t.cpu() for t in
                                     tree.leaves(state.params)])
        del model, state, step
        torch.cuda.empty_cache()
    same = [torch.equal(a, b) for a, b in zip(runs["plain"][2],
                                               runs["sharded"][2])]
    out = dict(layers=small.num_layers, steps=TRAIN_AGREE["steps"],
               losses=runs["sharded"][0], grad_norms=runs["sharded"][1],
               params=len(same), params_equal=sum(same))
    check(runs["plain"][:2] == runs["sharded"][:2] and all(same),
          f"{full.name}: the sharded step on one rank is not the plain "
          f"step: {out}, plain {runs['plain'][:2]}")
    return out


def _train_agreement(torch, L, build_model, small, params, batches, counts,
                     reset, replay: bool,
                     bf16_steps: int | None = None) -> dict:
    """TRAIN_AGREE's steps of ``small`` from ``params`` on the card and on
    the CPU, in fp32 and in bf16 (the first ``bf16_steps`` of ``batches``
    where it is given): losses and grad norms, gated at TRAIN_TOL.  An
    MoE model is chaotic in two places, where one rounding
    flips a discrete outcome or near one: a routing decision on a near
    tie, and its attention, near hard at the reference's init (wq and wk
    drawn with the head count as fan-in), where the backward's
    dS = P (dP - D) cancels on the near-one-hot rows; so is the
    encoder-decoder, whose attention is as hard and whose first encoder
    layer rounds to bf16 in an fp32 model too (the embeds are bf16).  So
    with ``replay`` the gated CPU run takes the card's routing decisions
    and attention inputs and, before each step, its state (``_replayed``,
    ``_copy_state``; how far its own were is reported); a second CPU run
    from the same weights runs free, and its distance from the card and
    its routing decisions that differ are reported, as the serve phase
    reports them.  A step whose state no check reads computes its
    metrics without the update (``_metrics_only``): each run's last, and
    every step of the gated CPU run that takes the card's state before
    the next."""
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import init_state, make_train_step

    acfg = opt.OptimizerConfig(learning_rate=TRAIN_AGREE["lr"], warmup_steps=0,
                               total_steps=len(batches))
    sides = {"cuda": "cuda", "cpu": "cpu"}
    if replay:
        sides["cpu_free"] = "cpu"
    agree = {}
    for name, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        models = {w: build_model(small, _cast(params, dtype, small.num_layers),
                                 device=dev) for w, dev in sides.items()}
        states = {w: init_state(m, acfg) for w, m in models.items()}
        steps = {w: make_train_step(m, acfg) for w, m in models.items()}
        runs = {w: ([], []) for w in models}
        wall = {w: 0.0 for w in models}
        logs = {w: [] for w in models}
        reset()
        run = batches if name == "fp32" else batches[:bf16_steps]
        for i, b in enumerate(run):
            card_calls = len(logs["cuda"])
            last = i + 1 == len(run)
            for w in models:
                t0 = time.perf_counter()
                unread = last or (replay and w == "cpu")
                with (_replayed(torch, L, logs[w], logs["cuda"][card_calls:]
                                if w == "cpu" else None)
                      if replay else contextlib.nullcontext()), \
                        (_patched(opt, {"update": _metrics_only(opt)})
                         if unread else contextlib.nullcontext()):
                    states[w], met = steps[w](states[w], b)
                runs[w][0].append(float(met["loss"]))
                runs[w][1].append(float(met["grad_norm"]))
                wall[w] += time.perf_counter() - t0
            if replay and not last:
                _copy_state(torch, states["cpu"], states["cuda"])
        torch.cuda.synchronize()
        launched = counts()
        del models, states, steps

        def rel(w, k):
            return [abs(a - b) / max(abs(b), 1e-30)
                    for a, b in zip(runs["cuda"][k], runs[w][k])]

        gated = rel("cpu", 0) + rel("cpu", 1)
        agree[name] = dict(card_losses=runs["cuda"][0], cpu_losses=runs["cpu"][0],
                           card_grad_norms=runs["cuda"][1],
                           cpu_grad_norms=runs["cpu"][1],
                           loss_rel_errs=rel("cpu", 0),
                           grad_norm_rel_errs=rel("cpu", 1),
                           max_rel_err=max(gated), cpu_s=wall["cpu"],
                           card_launches=launched)
        if replay:
            agree[name].update(
                replayed=_replay_differs(logs["cuda"], logs["cpu"]),
                free=dict(cpu_losses=runs["cpu_free"][0],
                          cpu_grad_norms=runs["cpu_free"][1],
                          loss_rel_errs=rel("cpu_free", 0),
                          grad_norm_rel_errs=rel("cpu_free", 1),
                          cpu_s=wall["cpu_free"],
                          **_replay_differs(logs["cuda"], logs["cpu_free"])))
        del logs
        check(max(gated) <= TRAIN_TOL[name],
              f"{small.name}: {name} card vs CPU training {agree[name]}")
    return agree


def _metrics_only(opt):
    """A wrapper of the optimizer's ``update`` for a run's last step: the
    metrics it returns (the clipping norm of the gradients, the learning
    rate at the step's count), the same functions on the same values,
    and the parameters and moments left as they are."""
    def outer(update):
        def inner(cfg, grads, state, params, placements=None):
            return params, state, {
                "grad_norm": opt.global_norm(grads, placements),
                "lr": opt.schedule(cfg, state["count"] + 1)}
        return inner
    return outer


def _copy_state(torch, dst, src) -> None:
    """``src``'s training state (parameters, moments, count, step) into
    ``dst``'s tensors, in place, across devices."""
    from repro_torch.tree import leaves

    with torch.no_grad():
        for d, s in zip(leaves(dst), leaves(src)):
            d.copy_(s)


@contextlib.contextmanager
def _replayed(torch, L, log: list, replay: list | None = None):
    """Inside the block, each call of the MoE routing (``moe_route``: its
    experts, kept slots and rows) and of the attention (the prefill's
    ``blockwise_attention`` and the decode step's ``decode_attention``:
    its q, k and v, or its query and cache) appends its values, on the
    host, to ``log``.  With ``replay`` (the log of another run of the same
    calls), each call then takes the replayed values in place of its
    own: the routing's gates are recomputed from the call's own router
    probabilities at the replayed experts, and the attention's inputs
    take the replayed values forward and pass their gradients back
    unchanged."""
    calls = [0]

    class Pin(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, value):
            return value.to(device=x.device, dtype=x.dtype)

        @staticmethod
        def backward(ctx, g):
            return g, None

    def take(kind):
        i = calls[0]
        calls[0] += 1
        if replay is None:
            return None
        check(i < len(replay) and replay[i][0] == kind,
              f"replay: call {i} is {kind}, the log has {len(replay)} calls")
        return replay[i][1:]

    def route(fn):
        def inner(x, router_w, top_k, *a, **kw):
            probs, gate, ids, keep, dest, cap = fn(x, router_w, top_k, *a, **kw)
            log.append(("route", ids.cpu(), keep.cpu(), dest.cpu()))
            r = take("route")
            if r is not None:
                ids, keep, dest = (t.to(x.device) for t in r)
                gate = probs.gather(1, ids)
                gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
            return probs, gate, ids, keep, dest, cap
        return inner

    def attention(fn):
        def inner(q, k, v, *a, **kw):
            log.append(("attention",) + tuple(t.detach().cpu()
                                              for t in (q, k, v)))
            r = take("attention")
            if r is not None:
                q, k, v = (Pin.apply(t, x) for t, x in zip((q, k, v), r))
            return fn(q, k, v, *a, **kw)
        return inner

    with _patched(L, {"moe_route": route, "blockwise_attention": attention,
                      "decode_attention": attention}):
        yield


def _replay_differs(card: list, cpu: list) -> dict:
    """How far the CPU's own values of the replayed calls were from the
    card's: the routing decisions that differ (``_routing_differs``) and
    the attention inputs' largest error over max|card value|."""
    check(len(card) == len(cpu) > 0,
          f"{len(card)} replayed calls on the card, {len(cpu)} on the CPU")
    out = {}
    routes = [(c[1:3], h[1:3]) for c, h in zip(card, cpu) if c[0] == "route"]
    if routes:
        out["routing"] = _routing_differs([c for c, _ in routes],
                                          [h for _, h in routes])
    attn = [(c[1:], h[1:]) for c, h in zip(card, cpu) if c[0] == "attention"]
    if attn:
        out["attention_inputs_rel_err"] = max(
            _unit_err(h, c) for cs_, hs in attn for c, h in zip(cs_, hs))
    return out


def _routing_differs(card: list, cpu: list) -> dict:
    """The (token, rank) routing decisions of two runs of the same MoE
    calls (each call's (ids, keep) in call order, the backward's
    recomputations included) that differ: another expert, or kept on one
    side and dropped on the other; summed over the calls, and those of
    the first call (its input differs only by the roundings of the dense
    layer before it)."""
    check(len(card) == len(cpu) > 0,
          f"{len(card)} MoE routings on the card, {len(cpu)} on the CPU")
    out = dict(calls=len(card), decisions=0, differ=0, expert_differs=0,
               kept_differs=0)
    for i, ((ci, ck), (hi, hk)) in enumerate(zip(card, cpu)):
        expert = (ci != hi).reshape(-1)
        kept = ck != hk
        differ = int((expert | kept).sum())
        out["decisions"] += int(ck.numel())
        out["differ"] += differ
        out["expert_differs"] += int(expert.sum())
        out["kept_differs"] += int(kept.sum())
        if i == 0:
            out["first_call_differ"] = differ
    return out


def _grads(torch, model) -> dict:
    """``model``'s parameter gradients by path, on the host, fp64."""
    from repro_torch.tree import flatten

    return {k: p.grad.detach().to("cpu", torch.float64)
            for k, p in flatten(model.param_tree())}


def _unit_err(a, b) -> float:
    """max|a - b| over max|b|, in fp64."""
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


def _hybrid_agreement(torch, L, build_model, small, params, batch, counts,
                      reset) -> dict:
    """The hybrid's card-against-CPU agreement (HYBRID_TRAIN_AGREE): one
    loss and backward of ``small`` on ``batch`` from ``params``, the
    oracle the port's CPU run in fp64, held to by the card in fp32 and
    bf16 and by the CPU in fp32.

    Gated: fp32's loss at TRAIN_TOL; its grad norm and gradients (the
    largest error over tensors, each over its max|fp64 grad|) at
    TRAIN_TOL or no further from the oracle than the CPU's own fp32 run
    is (these weights make the gradient ill-conditioned: see
    ``witness``); bf16's loss at TRAIN_TOL; and every block
    (``_block_grads``) from the oracle's input and upstream gradient, at
    TRAIN_TOL: in fp32 against the oracle, in bf16 against the CPU's bf16
    run of the block, which takes the card's attention inputs
    (``_replayed``).  bf16's grad norm and gradients, and its blocks
    against the oracle, are reported.  ``witness``: each block's output in the
    CPU's and the card's fp32 chained forward against the oracle's (error
    over max|oracle|), and the norm of layer 0's mixer output at position
    0 against its median over the positions."""
    from repro_torch.models.losses import chunked_cross_entropy

    tokens = torch.as_tensor(batch["tokens"]).long()
    labels = torch.as_tensor(batch["labels"]).long()
    B, S = tokens.shape
    t0 = time.perf_counter()
    oracle = build_model(small, _cast(params, torch.float64, small.num_layers),
                         device="cpu").train_mode(True)
    top = oracle.top.tensors()
    blocks = oracle.blocks(torch.arange(S).expand(B, S))
    h = top["embed"][tokens]
    inputs, outs = [], []
    for _, fn, p in blocks:
        inputs.append(h.detach())
        h = fn(p, h)
        h.retain_grad()
        outs.append(h)
    hn = L.rms_norm(h, top["final_norm"], small.norm_eps)
    loss64 = chunked_cross_entropy(hn, oracle.head_weights(top), labels)
    loss64.backward()
    truth = _grads(torch, oracle)
    pairs = [(x, o.grad.detach()) for x, o in zip(inputs, outs)]
    mix0 = (outs[0] - inputs[0]).detach()[0].norm(dim=-1)
    chain64 = [o.detach() for o in outs]
    del outs, hn
    oracle.zero_grad(set_to_none=True)
    blocks64 = [[t.double() for t in gs]
                for _, gs in _block_grads(torch, oracle, pairs)]
    oracle_s = time.perf_counter() - t0
    norm64 = math.sqrt(sum(float((g * g).sum()) for g in truth.values()))
    runs, witness = {}, {}
    for name, dtype, dev in (("cpu32", torch.float32, "cpu"),
                             ("fp32", torch.float32, "cuda"),
                             ("bf16", torch.bfloat16, "cuda")):
        model = build_model(small, _cast(params, dtype, small.num_layers),
                            device=dev).train_mode(True)
        reset()
        loss, _ = model.loss(batch)
        loss.backward()
        launched = counts()
        g = _grads(torch, model)
        norm = math.sqrt(sum(float((v * v).sum()) for v in g.values()))
        errs = {k: _unit_err(v, truth[k]) for k, v in g.items()}
        worst = max(errs, key=errs.get)
        runs[name] = dict(loss=float(loss), grad_norm=norm,
                          loss_rel_err=abs(float(loss) - float(loss64))
                          / float(loss64),
                          grad_norm_rel_err=abs(norm - norm64) / norm64,
                          grad_rel_err=errs[worst], worst_tensor=worst)
        if dtype == torch.float32 and dev == "cuda":
            runs[name].update(card_launches=launched, blocks=dict(
                against="fp64", **_block_errs(
                    _block_grads(torch, model, pairs), blocks64)))
        elif dtype == torch.bfloat16:
            # in bf16 against the CPU's bf16 from the same inputs, the CPU
            # taking the card's attention inputs (an ulp of bf16 q or k
            # moves a near-hard score by units); against fp64 reported
            logs = {"cuda": [], "cpu": []}
            with _replayed(torch, L, logs["cuda"]):
                card = list(_block_grads(torch, model, pairs))
            host = build_model(small, _cast(params, dtype, small.num_layers),
                               device="cpu").train_mode(True)
            with _replayed(torch, L, logs["cpu"], logs["cuda"]):
                cpu = [gs for _, gs in _block_grads(torch, host, pairs)]
            del host
            runs[name].update(
                card_launches=launched,
                blocks=dict(against="the CPU's bf16", **_block_errs(card, cpu),
                            **_replay_differs(logs["cuda"], logs["cpu"])),
                blocks_vs_fp64=_block_errs(card, blocks64))
            del card, cpu, logs
        if dtype == torch.float32:
            at = model.top.embed.device
            with torch.no_grad():
                x = model.top.embed[tokens.to(at)]
                chain = []
                for (_, fn, p), y64 in zip(
                        model.blocks(torch.arange(S, device=at).expand(B, S)),
                        chain64):
                    x = fn(p, x)
                    chain.append(_unit_err(x.cpu(), y64))
            witness[name] = chain
        del model, g
        torch.cuda.empty_cache()
    del truth, blocks64
    witness["mix0_norm"] = float(mix0[0])
    witness["mix_median_norm"] = float(mix0.median())
    f32, c32 = runs["fp32"], runs["cpu32"]
    gated = dict(
        fp32_loss=f32["loss_rel_err"] / TRAIN_TOL["fp32"],
        bf16_loss=runs["bf16"]["loss_rel_err"] / TRAIN_TOL["bf16"],
        fp32_grad_norm=f32["grad_norm_rel_err"] / max(
            TRAIN_TOL["fp32"], c32["grad_norm_rel_err"]),
        fp32_grads=f32["grad_rel_err"] / max(TRAIN_TOL["fp32"],
                                             c32["grad_rel_err"]),
        fp32_blocks=f32["blocks"]["max"] / TRAIN_TOL["fp32"],
        bf16_blocks=runs["bf16"]["blocks"]["max"] / TRAIN_TOL["bf16"])
    out = dict(oracle="the port on the CPU in fp64", loss64=float(loss64),
               grad_norm64=norm64, oracle_s=oracle_s, gated=gated,
               witness=witness, **runs)
    check(max(gated.values()) <= 1.0,
          f"{small.name}: card vs CPU training {out}")
    return out


def _block_grads(torch, model, pairs: list):
    """Each of ``model``'s blocks (``ZambaLM.blocks``) backward from
    ``pairs``' input to it and gradient of its output (cast to the
    model's device and type): per block, its kind and the gradients of
    its input and its parameters, on the host (one block at a time)."""
    from repro_torch.tree import leaves

    dev, dtype = model.top.embed.device, model.top.embed.dtype
    B, S = pairs[0][0].shape[:2]
    for (kind, fn, p), (x, g) in zip(
            model.blocks(torch.arange(S, device=dev).expand(B, S)), pairs):
        xi = x.to(dev, dtype).requires_grad_()
        got = torch.autograd.grad(fn(p, xi), [xi, *leaves(p)],
                                  g.to(dev, dtype))
        yield kind, [t.detach().cpu() for t in got]


def _block_errs(got, want: list) -> dict:
    """Per block, the largest error of its input's and its parameters'
    gradients (``_block_grads``) against ``want``'s, each over
    max|want|."""
    each = []
    for (kind, gs), ws in zip(got, want):
        errs = [_unit_err(a, b) for a, b in zip(gs, ws)]
        each.append(dict(kind=kind, input=errs[0], params=max(errs[1:])))
    return dict(n=len(each), max=max(max(b["input"], b["params"])
                                     for b in each), each=each)


def phase_pipeline(torch, build_model, get_config, counts, reset,
                   device="cuda") -> dict:
    """PIPELINE's decoder layers through ``pipeline_forward`` on a
    one-rank "pod" axis (its schedule and its broadcast on ``nccl``; no
    hand-off, which needs two stages), forward and one backward, against
    the same layers applied to each microbatch in order: output and
    gradients equal bit for bit; ``bubble_fraction`` as (P-1)/(n+P-1)."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel.pipeline import bubble_fraction, pipeline_forward

    spec = PIPELINE
    cfg = dataclasses.replace(get_config(spec["arch"]),
                              num_layers=spec["layers"])
    model = build_model(cfg, seed=0, device=device).train_mode(True)
    mesh = make_host_mesh((1,), ("pod",), device)
    S = spec["seq"]
    pos = torch.arange(S, device=device).expand(spec["mb"], S)
    gen = torch.Generator(device).manual_seed(0)
    x = torch.randn(spec["n_micro"], spec["mb"], S, cfg.d_model,
                    generator=gen, device=device).to(torch.bfloat16)
    layers = [lp.tensors() for lp in model.layers]
    weights = [t for lp in layers for t in lp.values()]

    def layer_apply(p, h):
        return model._block(p, h, pos, False, None)[0]

    def run(fn):
        for t in weights:
            t.grad = None
        out = fn()
        out.float().square().sum().backward()
        return out.detach(), [t.grad for t in weights]

    torch.cuda.synchronize()
    reset()
    t0 = time.perf_counter()
    got, got_g = run(lambda: pipeline_forward(layer_apply, layers, x, mesh,
                                              axis="pod"))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launched = counts()

    def stack():
        outs = []
        for m in range(spec["n_micro"]):
            h = x[m]
            for p in layers:
                h = layer_apply(p, h)
            outs.append(h)
        return torch.stack(outs)

    want, want_g = run(stack)
    torch.cuda.synchronize()
    same = [torch.equal(a, b) for a, b in zip(got_g, want_g)]
    bubbles = {f"{n}x{p}": bubble_fraction(n, p)
               for n, p in ((spec["n_micro"], 1), (spec["n_micro"], 2),
                            (spec["n_micro"], 4), (8, 2))}
    del model, layers, weights, got_g, want_g
    torch.cuda.empty_cache()
    n_k4 = spec["layers"] * spec["n_micro"]
    check(torch.equal(got, want),
          f"pipeline: the output is not the layer stack's "
          f"(max diff {float((got.float() - want.float()).abs().max())})")
    check(all(same), f"pipeline: {same.count(False)} of {len(same)} "
          "gradients differ from the layer stack's")
    check(bubbles == {k: (p - 1) / (n + p - 1) for k, (n, p) in zip(
        bubbles, ((spec["n_micro"], 1), (spec["n_micro"], 2),
                  (spec["n_micro"], 4), (8, 2)))},
          f"pipeline: bubble fractions {bubbles}")
    check(launched["flash_attention"] >= n_k4
          and launched["flash_attention_bwd"] >= n_k4,
          f"pipeline: K4 and its backward not launched for each layer and "
          f"microbatch: {launched}")
    return dict(arch=spec["arch"], layers=spec["layers"],
                n_micro=spec["n_micro"], microbatch=[spec["mb"], S],
                stages=1, seconds=seconds, output_equal=True,
                gradients_equal=len(same), bubble_fraction=bubbles,
                launches=launched)


def phase_train_example(torch, counts, reset) -> dict:
    """The llama3-100m example twin's configuration through the training
    launcher (the user's entry point; the twin's own script also asserts
    that the loss fell, which neither package's twin does in 100 steps:
    see LEARN), then the learning gate, which must go through K4's
    forward and backward kernels."""
    from repro_torch import configs
    from repro_torch.examples import train_lm
    from repro_torch.launch.train import train

    cfg = train_lm.llama3_100m()
    configs.ARCHS[cfg.name] = cfg  # registered as the twin registers it
    t0 = time.perf_counter()
    losses = train(cfg.name, steps=EXAMPLE_STEPS, smoke=False, global_batch=4,
                   seq_len=128, lr=3e-3, device="cuda")
    wall = time.perf_counter() - t0
    check(all(math.isfinite(x) for x in losses), "llama3-100m: non-finite loss")
    expect = math.log(cfg.vocab_size) + cfg.d_model * 0.02 ** 2 / 2
    check(abs(losses[0] - expect) <= 0.1,
          f"llama3-100m: first loss {losses[0]}, expected {expect}")
    reset()
    t0 = time.perf_counter()
    learn = train(LEARN["arch"], steps=LEARN["steps"], smoke=True,
                  global_batch=LEARN["batch"], seq_len=LEARN["seq"],
                  lr=LEARN["lr"], device="cuda", log_every=50)
    learn_s = time.perf_counter() - t0
    learn_launches = counts()
    drop = learn[0] - learn[-1]
    check(all(math.isfinite(x) for x in learn) and drop > 0.1,
          f"{LEARN['arch']} (smoke) did not learn: {learn[0]} -> {learn[-1]}")
    check(learn_launches["flash_attention"] > 0
          and learn_launches["flash_attention_bwd"] > 0,
          f"the learning gate bypassed K4: {learn_launches}")
    return dict(arch=cfg.name, steps=len(losses), batch=4, seq=128,
                first_loss=losses[0], expected_first_loss=expect,
                last_loss=losses[-1], min_loss=min(losses), wall_s=wall,
                step_ms=1e3 * wall / len(losses),
                learn=dict(**LEARN, first_loss=learn[0], last_loss=learn[-1],
                           drop=drop, wall_s=learn_s, launches=learn_launches))


# the dry run's cells printed by the smoke: (arch, shape, multi-pod,
# moments); the int8 cell is the sweep's llama3-405b training cell
DRYRUN_SHOWN = (("llama3-405b", "train_4k", False, "float32"),
                ("llama3-405b", "train_4k", True, "int8"),
                ("qwen3-4b", "decode_32k", False, "float32"),
                ("deepseek-moe-16b", "prefill_32k", True, "float32"),
                ("mamba2-130m", "long_500k", False, "float32"))


def phase_dryrun(torch) -> dict:
    """Every (arch x shape) cell on both production meshes at each arch's
    recipe, on the meta device: no cell errors, the skips exactly
    ``cell_applicable``'s, every tensor any operation returned on the
    meta device, and the card's allocated bytes unmoved."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.configs import ARCHS, SHAPES, all_cells
    from repro_torch.launch import dryrun

    class Devices(TorchDispatchMode):
        """The devices of every tensor any operation returns."""

        def __init__(self):
            super().__init__()
            self.seen, self.ops = set(), 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            self.ops += 1
            for t in out if isinstance(out, (tuple, list)) else (out,):
                if isinstance(t, torch.Tensor):
                    self.seen.add(t.device.type)
            return out

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    mode = Devices()
    records, skips = {}, {}
    with mode:
        for multi in (False, True):
            for arch in ARCHS:
                for shape in SHAPES:
                    rec = dryrun.dryrun_cell(arch, shape, multi_pod=multi)
                    key = (arch, shape, dryrun.mesh_label(multi))
                    if "skipped" in rec:
                        skips[key] = rec["skipped"]
                    else:
                        records[key] = rec
        shown = {f"{a}__{s}__{dryrun.mesh_label(m)}__{mo}":
                 dryrun.dryrun_cell(a, s, multi_pod=m, moment_dtype=mo)
                 for a, s, m, mo in DRYRUN_SHOWN}
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    want = {(a, s, dryrun.mesh_label(m)): why for m in (False, True)
            for a, s, ok, why in all_cells() if not ok}
    check(len(records) == 64 and len(skips) == 16,
          f"dry run: {len(records)} records, {len(skips)} skips")
    check(skips == want, f"dry run: skips {sorted(skips)} != "
          f"cell_applicable's {sorted(want)}")
    check(mode.seen == {"meta"} and mode.ops > 0,
          f"dry run: tensors on {mode.seen} ({mode.ops} operations)")
    check(after == before, f"dry run: allocated bytes moved {before} -> "
          f"{after}")
    # the collective term: the sharded step's collectives counted from
    # the resolved specs, a number in every record
    unset = [k for k, r in records.items()
             if not isinstance(r["roofline"]["collective_s"], float)]
    check(not unset, f"dry run: no collective term in {unset[:4]}")
    return dict(
        cells=len(records) + len(skips), records=len(records),
        skips=len(skips), operations=mode.ops, devices=sorted(mode.seen),
        allocated_before=before, allocated_after=after, seconds=seconds,
        shown={k: dict(params=r["params"],
                       argument_split=r["memory"]["argument_split"],
                       bound_s=r["roofline"]["bound_s"],
                       collective_s=r["roofline"]["collective_s"],
                       collective_bytes=r["roofline"][
                           "collective_bytes_per_device"],
                       dominant=r["roofline"]["dominant"],
                       recipe=r["recipe"])
               for k, r in shown.items()})


def profile(torch, fn) -> dict:
    """One warm call of ``fn`` under the profiler: wall time, summed
    device time, busy share and the kernels that take most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as _profile

    torch.cuda.synchronize()
    with _profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = set(MOE_SPANS.values())
    rows = []
    for e in prof.key_averages():
        # kernel rows only: an operator's row repeats its kernels' time,
        # and a span's device row its kernels' extent
        if (e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
                and e.key not in spans):
            rows.append((e.self_device_time_total, e.key, e.count))
    rows.sort(reverse=True)
    device_ms = sum(r[0] for r in rows) / 1e3
    # each span's kernels (the host event's device time sums the kernels
    # of every operator under it)
    span_ms = {}
    for e in prof.events():
        if e.name in spans and e.device_type == DeviceType.CPU:
            span_ms[e.name] = span_ms.get(e.name, 0.0) + e.device_time_total / 1e3
    kernels = {}
    for name in TRACED_KERNELS:
        # a forward's name is a prefix of its backward's: keep them apart
        ms = sum(us for us, k, _ in rows if name in k
                 and ("bwd" in name or "bwd" not in k)) / 1e3
        if ms > 0:
            kernels[name] = dict(ms=ms, share=ms / max(device_ms, 1e-9))
    out = dict(
        wall_ms=1e3 * wall, device_ms=device_ms,
        device_busy_share=device_ms / (1e3 * wall),
        top=[dict(name=k[:80], ms=us / 1e3, calls=c) for us, k, c in rows[:8]],
        kernels=kernels,
    )
    if span_ms:
        layer = span_ms.get("moe.layer", 0.0)
        experts = span_ms.get("moe.experts", 0.0)
        parts = {"moe_layer": layer, "expert_products": experts,
                 "routing": span_ms.get("moe.route", 0.0),
                 # routing, the expert buffer, the combine and the aux loss
                 "dispatch": layer - experts}
        out["moe"] = {k: dict(ms=ms, share=ms / max(device_ms, 1e-9))
                      for k, ms in parts.items()}
    return out


def check_peak(phase: str, measured: int, planned: int) -> None:
    """The certified peak holds on the card: the bytes allocated over
    the phase at most ``planned * PEAK_MARGIN + PEAK_SLACK``."""
    limit = planned * PEAK_MARGIN + PEAK_SLACK
    check(measured <= limit,
          f"{phase}: peak {measured} B over the certified {planned} B "
          f"(limit {limit:.0f} B)")


def expected_bf16_launches(plan, cg) -> dict:
    """The bf16-route launches one hoisted run of ``plan`` asks for: its
    bf16 tiled and fused steps outside chains, and its chain launches
    that hold a bf16 step, the prologue's once and the epilogue's once
    per slice."""
    specs = plan.schedule.specs
    want = {"tiled_gemm": 0, "fused_gemm": 0, "chain_gemm": 0}
    segments = (("prologue", plan.prologue_idx, 1),
                ("epilogue", plan.epilogue_idx, 1 << plan.num_sliced))
    for seg, ids, times in segments:
        chains = plan.chain_plan.by_segment(seg)
        i, ids = 0, list(ids)
        while i < len(ids):
            ch = chains.get(ids[i])
            if ch is not None:
                forms = [specs[p].form for p in ch.positions]
                for launch in cg.chain_segments(forms):
                    if any(specs[ch.positions[t]].precision == "bf16"
                           for t in launch):
                        want["chain_gemm"] += times
                i += ch.n_steps
                continue
            spec = specs[ids[i]]
            if spec.precision == "bf16":
                want[{"tiled": "tiled_gemm", "fused": "fused_gemm"}[spec.backend]] += times
            i += 1
    return want


def phase_precision(torch, simulate_amplitude, cg, circ, n, target, sv_amp) -> dict:
    """The amplitude at precision="fp32" and at "auto" (tol 0.05), both in
    peak-mode slicing: bf16 steps, |S|, error against the statevector,
    measured against certified peak, and the bf16-route launches."""
    runs = {}
    for mode, tol in (("fp32", None), ("auto", PRECISION_TOL)):
        cg.reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        res = simulate_amplitude(circ, "0" * n, target_dim=target,
                                 slicing_mode="peak", precision=mode,
                                 fidelity_tol=tol)
        torch.cuda.synchronize()
        exec_s = time.perf_counter() - t0 - res.report.plan_wall_s
        peak = torch.cuda.max_memory_allocated() - base
        amp = complex(res.value)
        rep = res.report
        runs[mode] = dict(
            precision_counts=rep.precision_counts, num_sliced=rep.num_sliced,
            predicted_amp_error=rep.predicted_amp_error, exec_s=exec_s,
            rel_err=abs(amp - sv_amp) / abs(sv_amp), peak_bytes=peak,
            peak_bytes_planned=rep.peak_bytes_hoisted,
            stored_bf16_nodes=len(res.plan.store16),
            backends=rep.lowered_backends, launches=dict(cg.LAUNCHES),
            bf16_launches=dict(cg.BF16_LAUNCHES),
            bf16_launches_planned=expected_bf16_launches(res.plan, cg),
        )
        check_peak(f"precision {mode}", peak, rep.peak_bytes_hoisted)
        del res
        torch.cuda.empty_cache()
    fp32, auto = runs["fp32"], runs["auto"]
    check(fp32["rel_err"] <= AMP_TOL, f"fp32 peak-mode amplitude: {fp32['rel_err']}")
    check(not fp32["precision_counts"].get("bf16"), "the fp32 plan has bf16 steps")
    check(auto["precision_counts"].get("bf16", 0) > 0, "the auto plan demoted nothing")
    check(auto["num_sliced"] <= fp32["num_sliced"],
          f"|S| grew under auto: {auto['num_sliced']} > {fp32['num_sliced']}")
    check(auto["rel_err"] <= PRECISION_TOL, f"auto amplitude: {auto['rel_err']}")
    check(auto["bf16_launches"] == auto["bf16_launches_planned"],
          f"bf16 steps vs bf16-route launches: {auto['bf16_launches']} vs "
          f"{auto['bf16_launches_planned']}")
    return dict(qubits=n, target_dim=target, slicing_mode="peak",
                fidelity_tol=PRECISION_TOL, fp32=fp32, auto=auto,
                bf16_launches=auto["bf16_launches"])


def trace_slice(torch, open_session, circ, n: int, target: int) -> dict:
    """Profile one epilogue slice."""
    sess, _ = open_session(circ, "0" * n, target_dim=target, backend="gemm")
    sess.run_slice(0)
    return profile(torch, lambda: sess.run_slice(1))


def percentiles(xs) -> dict:
    xs = sorted(xs)
    return dict(p50=xs[len(xs) // 2], max=xs[-1])


def phase_engine(torch, cg, circ, n: int, target: int, planner_seed: int,
                 samp_flat, sv_batch, amp_plan, amp_arrays) -> dict:
    """The contraction server on samp30: calibrate_plan on one slice of
    the amp30 plan, then two bursts of one family (16 amplitudes over the
    last 4 qubits, 2 sampling tenants), cold then warm, through
    EngineServer(max_batch=32) on the card.  Checks: amplitudes against
    the statevector; batch-served values bitwise the sampling phase's; a
    coalesced group per burst; warm batch contractions all plan-cache
    hits at < 1% of the cold plan's time, with hoist-cache hits; each
    contraction within its certified peak; one execution at a time."""
    from repro_torch import obs
    from repro_torch.core.executor import running
    from repro_torch.engine import (AmplitudeRequest, EngineServer,
                                    SampleRequest, execution_gate)
    from repro_torch.lowering.cache import PLAN_CACHE

    cal = obs.calibrate_plan(amp_plan, amp_arrays, slice_id=0, repeat=3)
    calibration = dict(device=cal.device, hardware=cal.hardware,
                       by_class=cal.ratio_by_class())
    del amp_plan, amp_arrays, cal
    PLAN_CACHE.clear()  # the first burst plans cold
    torch.cuda.empty_cache()

    open_q = tuple(range(n - 4, n))
    pk = dict(seed=planner_seed, repeats=32)  # the sampling phase's planner

    def requests():
        reqs = []
        for p in range(16):
            bits = ["0"] * n
            for j, q in enumerate(open_q):
                bits[q] = str((p >> (len(open_q) - 1 - j)) & 1)
            reqs.append(AmplitudeRequest(circ, "".join(bits), target_dim=target,
                                         plan_kwargs=pk))
        for seed in (0, 1):
            reqs.append(SampleRequest(circ, num_samples=1000, open_qubits=open_q,
                                      seed=seed, target_dim=target, plan_kwargs=pk))
        return reqs

    def resident() -> int:
        return sum(e.plan._hoist_cache.total_bytes for e in PLAN_CACHE.values())

    gate, counter = execution_gate("cuda"), running("cuda")
    counter.reset()
    gate.probe = []
    cg.reset_launches()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    bursts = []
    try:
        with EngineServer(max_batch=32) as srv:
            for b in range(2):
                before = srv.stats()
                t0 = time.perf_counter()
                tickets = [srv.submit(r) for r in requests()]
                for t in tickets:
                    t.result(timeout=900)
                wall = time.perf_counter() - t0
                after = srv.stats()
                bursts.append(dict(
                    tickets=tickets, wall_s=wall, resident_bytes=resident(),
                    stats={k: after[k] - before[k] for k in (
                        "groups", "coalesced", "cold_groups", "warm_groups",
                        "rejected", "completed", "failed")},
                ))
        probe = gate.probe
    finally:
        gate.probe = None
    launches = dict(cg.LAUNCHES)
    routes = dict(cg.FUSED_ROUTES)
    hoist = [e.plan._hoist_cache.stats() for e in PLAN_CACHE.values()]

    scale = float(abs(sv_batch).max())
    records = []
    cold_plan_s = None
    for b, burst in enumerate(bursts):
        amps, batch_reports = [], []
        for t in burst["tickets"]:
            r = t.request
            if isinstance(r, AmplitudeRequest):
                idx = int("".join(r.bitstring[q] for q in open_q), 2)
                err = abs(t.value - complex(sv_batch[idx])) / scale
                check(err <= AMP_TOL, f"engine burst {b}: amplitude {idx} off "
                      f"the statevector by {err}")
                amps.append(err)
                if t.open_qubits == open_q:
                    check(t.value == complex(samp_flat[idx]),
                          f"engine burst {b}: amplitude {idx} from the batch is not "
                          f"bitwise the sampling phase's")
            else:
                got = t.value.batch.flat()
                check(got.tobytes() == samp_flat.tobytes(),
                      f"engine burst {b}: tenant {r.seed}'s batch is not bitwise "
                      f"the sampling phase's")
                check(t.value.num_samples == 1000, "wrong sample count")
            if t.open_qubits:
                batch_reports.append(t.report)
        check(burst["stats"]["coalesced"] > 0, f"engine burst {b}: nothing coalesced")
        check(burst["stats"]["failed"] == 0, f"engine burst {b}: failed tickets")
        reports = {id(rep): rep for rep in batch_reports}.values()
        if b == 0:
            cold = [rep.plan_wall_s for rep in reports if not rep.cache_hit]
            check(bool(cold), "engine burst 0: no batch contraction planned cold")
            cold_plan_s = cold[0]
        else:
            check(all(rep.cache_hit for rep in reports),
                  "engine burst 1: a batch contraction missed the plan cache")
            check(all(rep.plan_wall_s < 0.01 * cold_plan_s for rep in reports),
                  f"engine burst 1: warm plan_wall_s "
                  f"{[rep.plan_wall_s for rep in reports]} vs cold {cold_plan_s}")
        tix = burst["tickets"]
        records.append(dict(
            wall_s=burst["wall_s"], stats=burst["stats"],
            batch_contractions=len(reports),
            batch_served=sum(1 for t in tix if t.open_qubits == open_q),
            plan_wall_s=[rep.plan_wall_s for rep in reports],
            cache_hit=[rep.cache_hit for rep in reports],
            queue_s=percentiles([t.queue_s for t in tix]),
            compute_s=percentiles([t.compute_s for t in tix]),
            max_amp_err=max(amps), hoist_resident_bytes=burst["resident_bytes"],
        ))
    check(sum(h["hits"] for h in hoist) > 0, f"no hoist-cache hit: {hoist}")
    contractions = [r for r in probe if r["planned_bytes"] is not None]
    check(bool(contractions), "the gate measured no contraction")
    for r in contractions:
        check_peak(f"engine contraction {r['label']}", r["peak_bytes"],
                   r["planned_bytes"])
    check(counter.peak == 1, f"{counter.peak} executions ran at once")
    phase_peak = max(r["resident_bytes"] + r["peak_bytes"] for r in probe) - base
    return dict(
        qubits=n, target_dim=target, open_qubits=list(open_q), plan_kwargs=pk,
        calibration=calibration, bursts=records, cold_plan_s=cold_plan_s,
        contractions=[{k: r[k] for k in ("label", "peak_bytes", "planned_bytes",
                                         "resident_bytes")} for r in contractions],
        max_concurrent_executions=counter.peak, phase_peak_bytes=phase_peak,
        hoist_cache=hoist, launches=launches, fused_routes=routes,
    )


SEARCH = dict(optimize="anytime", search_evals=64, search_workers=4, seed=0)
RESUME_TOL = 1e-6  # resumed / merged sums against run_all, of max|amp|


def phase_search(torch, obs, cg, circ, tn, tn4, target: int, sv_amp: complex,
                 amp_plan, amp_exec_s: float, samp_costs: dict) -> dict:
    """amp30 planned by the anytime search (64 evaluations, 4 workers,
    seed 0) through plan_compiled with telemetry on, then executed through
    simulate_amplitude (a plan-cache hit).  Checks: the searched plan is
    feasible (certified peak within the search's budget, which the
    one-shot seed fixes), improvement >= 1, the search.evals counter
    equals the report's evaluations, the amplitude within 1e-3 of the
    statevector, the measured peak within the certified peak.  Then samp30
    at planner seed 0 searched on the host with the same budget, beside
    the one-shot plans of seeds 0 and 2."""
    from repro_torch.core import plan_compiled, plan_contraction, simulate_amplitude
    from repro_torch.lowering.memory import certified_peak

    n = circ.num_qubits
    obs.reset()
    t0 = time.perf_counter()
    plan, rep = plan_compiled(tn, target, telemetry=True, **SEARCH)
    search_wall = time.perf_counter() - t0
    counters = rep.telemetry["metrics"]["counters"]
    spans = rep.telemetry["spans"]
    obs.reset()
    # the budget the search itself derived (the one-shot seed's certified
    # envelope) and its own verdict, held against a recount of the peak
    budget = rep.budget_bytes
    peak = certified_peak(plan.tree, plan.smask, 8)
    trace = rep.search_trace
    objective = (plan.partition.hoisted_cost() if plan.smask
                 else plan.tree.total_cost())
    improvement = trace[0]["objective"] / objective
    check(rep.feasible and 0 < peak <= budget,
          f"search: certified peak {peak} over budget {budget} "
          f"(feasible={rep.feasible})")
    check(improvement >= 1.0, f"search: improvement {improvement} < 1")
    check(counters.get("search.evals") == rep.search_evals,
          f"search: counter {counters.get('search.evals')} vs "
          f"{rep.search_evals} evaluations")
    check(trace[0]["move"] == "init" and trace[0]["worker"] == 0,
          "search: the trace does not start at the one-shot seed")

    cg.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    res = simulate_amplitude(circ, "0" * n, target_dim=target, **SEARCH)
    torch.cuda.synchronize()
    exec_s = time.perf_counter() - t0 - res.report.plan_wall_s
    mem_peak = torch.cuda.max_memory_allocated() - base
    check(res.report.cache_hit and res.plan is plan,
          "search: simulate_amplitude did not reuse the searched plan")
    check_peak("search", mem_peak, res.report.peak_bytes_hoisted)
    amp = complex(res.value)
    amp_err = abs(amp - sv_amp) / abs(sv_amp)
    check(amp_err <= AMP_TOL, f"search: amplitude vs statevector {amp_err}")
    launches, routes = dict(cg.LAUNCHES), dict(cg.FUSED_ROUTES)

    # samp30 (planner seed 0, the sampling phase's restarts), host only
    t0 = time.perf_counter()
    _, _, srep = plan_contraction(tn4, target, repeats=32, **SEARCH)
    samp_wall = time.perf_counter() - t0
    return dict(
        qubits=n, target_dim=target, **SEARCH,
        evaluations=rep.search_evals, search_wall_s=search_wall,
        plan_build_s=spans["plan.build"]["total_s"],
        eval_spans=spans["search.eval"]["count"],
        accepted=counters.get("search.accepted", 0),
        rejected=counters.get("search.rejected", 0),
        restarts=counters.get("search.restarts", 0),
        trace_points=len(trace), improvement=improvement,
        log2_objective_oneshot=math.log2(trace[0]["objective"]),
        log2_objective_searched=math.log2(objective),
        log2_sliced_cost_oneshot=math.log2(
            amp_plan.tree.sliced_cost(amp_plan.smask)),
        log2_sliced_cost_searched=rep.log2_sliced_cost,
        num_sliced_oneshot=amp_plan.num_sliced, num_sliced=plan.num_sliced,
        certified_peak_bytes=peak, budget_bytes=budget, feasible=rep.feasible,
        exec_s=exec_s, exec_s_oneshot=amp_exec_s, rel_err=amp_err,
        amplitude=[amp.real, amp.imag], peak_bytes=mem_peak,
        peak_bytes_planned=res.report.peak_bytes_hoisted,
        backends=res.report.lowered_backends, launches=launches,
        fused_routes=routes,
        samp30=dict(planner_seed=0, repeats=32, wall_s=samp_wall,
                    evaluations=srep.search_evals,
                    log2_sliced_cost_searched=srep.log2_sliced_cost,
                    log2_sliced_cost_oneshot_seed0=samp_costs[0],
                    log2_sliced_cost_oneshot_seed2=samp_costs[2],
                    num_sliced=srep.num_sliced),
    )


def phase_resume(torch, obs, cg, amp_plan, amp_arrays, amp: complex) -> dict:
    """amp30's one-shot plan through contract_resumable(chunk=16) with a
    simulated failure at range 32 (expected: raising it is the point),
    then the resume from the state it left, at chunk=8.  Checks: the
    failure was raised after exactly ids 0-31; the value within 1e-6 of
    |amp| of the amplitude phase's run_all value; each of the 128 ids
    summed exactly once (state and exec.slices_executed); the measured
    peak within the certified peak."""
    import numpy as np

    from repro_torch.core.distributed import SliceRangeCheckpoint, contract_resumable

    n_slices = 1 << amp_plan.num_sliced
    state = SliceRangeCheckpoint(n_slices, set(), np.zeros((), np.complex64))
    cg.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    raised = None
    with obs.enabled_scope(True):
        obs.reset()
        t0 = time.perf_counter()
        try:
            contract_resumable(amp_plan, amp_arrays, chunk=16, state=state,
                               fail_on={32})
        except RuntimeError as e:  # the simulated node failure
            raised = str(e)
        fail_s = time.perf_counter() - t0
        done_at_failure = sorted(state.done_ids())
        t0 = time.perf_counter()
        value, state = contract_resumable(amp_plan, amp_arrays, chunk=8,
                                          state=state)
        resume_s = time.perf_counter() - t0
        counters = obs.telemetry_summary()["metrics"]["counters"]
        spans = obs.trace.summary()
    obs.reset()
    torch.cuda.synchronize()
    mem_peak = torch.cuda.max_memory_allocated() - base
    check(raised is not None and "simulated failure" in raised,
          f"resume: the simulated failure was not raised ({raised})")
    check(done_at_failure == list(range(32)),
          f"resume: {len(done_at_failure)} ids done at the failure, not 0-31")
    check(state.done_ids() == set(range(n_slices)),
          "resume: the resumed state does not cover every id")
    check(counters.get("exec.slices_executed") == n_slices,
          f"resume: {counters.get('exec.slices_executed')} slices summed, "
          f"not {n_slices}")
    val = complex(value)
    err = abs(val - amp) / abs(amp)
    check(err <= RESUME_TOL, f"resume: value off run_all by {err} of |amp|")
    check_peak("resume", mem_peak, amp_plan.memory_plan().peak_bytes_hoisted)
    return dict(
        slices=n_slices, chunk_first=16, fail_on=32, chunk_resume=8,
        raised=raised, done_at_failure=len(done_at_failure),
        slices_executed=counters.get("exec.slices_executed"),
        ranges=spans["exec.slice_range"]["count"],
        fail_s=fail_s, resume_s=resume_s, value=[val.real, val.imag],
        rel_err_vs_run_all=err, peak_bytes=mem_peak,
        peak_bytes_planned=amp_plan.memory_plan().peak_bytes_hoisted,
        launches=dict(cg.LAUNCHES), fused_routes=dict(cg.FUSED_ROUTES),
    )


def phase_multihost(torch, cg, amp_plan, amp_arrays, amp_report, amp: complex,
                    samp_plan, samp_arrays, samp_flat, circ, open_q,
                    target: int, planner_seed: int, dev) -> dict:
    """amp30's one-shot plan through contract_multihost at world size 1
    with a claim store (a temporary directory) and a simulated host
    failure after 2 ranges, then an epoch-1 resume; then samp30 through
    contract_sharded and sample_bitstrings with an explicit device list.
    Checks: the failure was raised; the merged value within 1e-6 of |amp|
    of run_all; every id covered exactly once; the sharded batches bitwise
    the sampling phase's where they sum in its order (one device,
    slice_batch 1: ids in order, one running sum) and within 1e-6 of
    max|batch| where they do not (the card listed twice, slice_batch 4:
    batch partials, then the two devices' partials in device order); a
    list naming a second card, or a card other than the current one, is
    refused before any launch (one process per card)."""
    import shutil
    import tempfile

    from repro_torch.core import sample_bitstrings
    from repro_torch.core.distributed import contract_sharded
    from repro_torch.distributed import ClaimStore, contract_multihost

    n_slices = 1 << amp_plan.num_sliced
    root = tempfile.mkdtemp(prefix="repro_multihost_")
    report = dataclasses.replace(amp_report)
    cg.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    try:
        raised = None
        t0 = time.perf_counter()
        try:
            contract_multihost(amp_plan, amp_arrays, world_size=1,
                               checkpoint_dir=root, fail_after=2)
        except RuntimeError as e:  # the simulated host failure
            raised = str(e)
        fail_s = time.perf_counter() - t0
        before = ClaimStore(root, n_slices, host=0).merged()
        done_before = before.done_ids()
        t0 = time.perf_counter()
        res = contract_multihost(amp_plan, amp_arrays, world_size=1,
                                 checkpoint_dir=root, epoch=1, report=report)
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    mem_peak = torch.cuda.max_memory_allocated() - base
    check(raised is not None and "simulated host 0" in raised,
          f"multihost: the simulated host failure was not raised ({raised})")
    resumed = [i for s, e in res.executed_ranges for i in range(s, e)]
    check(len(resumed) == len(set(resumed)) and done_before.isdisjoint(resumed)
          and done_before | set(resumed) == set(range(n_slices)),
          "multihost: slice ids not covered exactly once")
    check(res.complete and res.state.done_ids() == set(range(n_slices)),
          "multihost: the merged state is incomplete")
    val = complex(res.value)
    err = abs(val - amp) / abs(amp)
    check(err <= RESUME_TOL, f"multihost: merged value off run_all by {err}")
    check_peak("multihost", mem_peak, amp_plan.memory_plan().peak_bytes_hoisted)
    check(report.schedule_imbalance == res.schedule_imbalance,
          "multihost: the report's schedule fields were not filled")

    # samp30 through the explicit-device paths
    scale = float(abs(samp_flat).max())
    t0 = time.perf_counter()
    one = contract_sharded(samp_plan, samp_arrays, [dev]).cpu().numpy().ravel()
    torch.cuda.synchronize()
    sharded_s = time.perf_counter() - t0
    check(one.tobytes() == samp_flat.tobytes(),
          "multihost: contract_sharded([cuda:0]) is not bitwise the "
          "sampling phase's batch")
    twice = contract_sharded(samp_plan, samp_arrays, [dev, dev],
                             slice_batch=4).cpu().numpy().ravel()
    twice_err = float(abs(twice - samp_flat).max()) / scale
    check(twice_err <= RESUME_TOL,
          f"multihost: contract_sharded([cuda:0, cuda:0]) off by {twice_err}")
    t0 = time.perf_counter()
    samp = sample_bitstrings(circ, num_samples=1000, open_qubits=open_q,
                             target_dim=target, seed=planner_seed, repeats=32,
                             devices=[dev])
    torch.cuda.synchronize()
    samp_s = time.perf_counter() - t0
    check(samp.batch.flat().tobytes() == samp_flat.tobytes(),
          "multihost: sample_bitstrings(devices=[cuda:0]) is not bitwise the "
          "sampling phase's batch")
    launches = dict(cg.LAUNCHES)  # amp30's two runs and samp30's three
    refused = {}
    for devs in (["cuda:0", "cuda:1"], ["cuda:1"]):
        try:
            contract_sharded(samp_plan, samp_arrays, devs)
        except ValueError as e:  # one card per process: refused up front
            refused[",".join(devs)] = str(e)
    check(len(refused) == 2 and cg.LAUNCHES == launches,
          f"multihost: a device list beyond the current card was not "
          f"refused before any launch ({refused})")
    return dict(
        slices=n_slices, fail_after=2, raised=raised,
        done_before_resume=len(done_before),
        executed_on_resume=res.executed_slices, complete=res.complete,
        value=[val.real, val.imag], rel_err_vs_run_all=err,
        schedule_imbalance=res.schedule_imbalance,
        initial_imbalance=res.initial_imbalance, steal_count=res.steal_count,
        overlap_fraction=res.overlap_fraction, fail_s=fail_s, resume_s=resume_s,
        peak_bytes=mem_peak,
        peak_bytes_planned=amp_plan.memory_plan().peak_bytes_hoisted,
        sharded_one_device_s=sharded_s, sharded_bitwise=True,
        sharded_twice_rel_err=twice_err, sampling_devices_s=samp_s,
        sampling_bitwise=True, refused=refused,
        orders={"contract_sharded([cuda:0])": "ids in order, one running sum "
                "(the sampling phase's order): bitwise",
                "sample_bitstrings(devices=[cuda:0])": "the same: bitwise",
                "contract_sharded([cuda:0, cuda:0], slice_batch=4)":
                "4-id batch partials, then the two chunks' partials in device "
                "order: within 1e-6",
                "contract_multihost": "per-range partials, rounds of pushes, "
                "claim-store partials on the host: within 1e-6"},
        launches=launches, fused_routes=dict(cg.FUSED_ROUTES),
    )


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="Smoke run of the port on one "
                                 "GPU (module docstring).")
    ap.add_argument("--plain-peak", metavar="ARCH", choices=sorted(TRAIN),
                    help="only build the kernels and print ARCH's train "
                    "phase peak through the plain step (PLAIN_TRAIN_PEAK)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke: src/repro_torch not found beside the script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    from repro_torch.core import (
        open_amplitude_batch,
        open_session,
        plan_compiled,
        plan_contraction,
        sample_bitstrings,
        simulate_amplitude,
    )
    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.core.executor import simplify_network
    from repro_torch.kernels import build, contract_gemm as cg
    from repro_torch.kernels import flash_attention as fa, mamba2_ssd as ssd
    from repro_torch.kernels import ops
    from repro_torch.launch import decode_demo
    from repro_torch.models import layers as lm_layers
    from repro_torch.models import build_model
    from repro_torch.core.executor import exact_fp32_matmul
    from repro_torch.hardware import H100_SXM
    from repro_torch.lowering.cache import PLAN_CACHE
    from repro_torch.quantum import circuits, statevector
    from repro_torch.sampling.batch import open_batch_network

    def lm_counts() -> dict:
        return {**fa.LAUNCHES, **ssd.LAUNCHES,
                "flash_fwd_routes": dict(fa.FWD_ROUTES),
                "flash_window_routes": dict(fa.WINDOW_ROUTES),
                "flash_noncausal": dict(fa.NONCAUSAL),
                "ssd_routes": dict(ssd.SSD_ROUTES),
                "flash_bwd_routes": dict(fa.BWD_ROUTES),
                "flash_bwd_window_routes": dict(fa.BWD_WINDOW_ROUTES),
                "flash_bwd_noncausal": dict(fa.BWD_NONCAUSAL),
                "ssd_bwd_routes": dict(ssd.SSD_BWD_ROUTES)}

    def lm_reset() -> None:
        fa.reset_launches()
        ssd.reset_launches()

    t_start = time.perf_counter()
    exact_fp32_matmul()  # the plain versions' and the library's fp32 products
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)

    # 1. build --------------------------------------------------------
    t0 = time.perf_counter()
    info = build.build_all()
    emit(phase="build", seconds=time.perf_counter() - t0, card=smi,
         torch=torch.__version__, cuda=torch.version.cuda,
         host_mem_total=_mem_total(), cpus=os.cpu_count(),
         libraries={k: v["path"] for k, v in info.items()})
    print(smi, flush=True)
    hgmma = {name: build.kernels_with(lib, kernel, "HGMMA")
             for name, (lib, kernel) in WGMMA_KERNELS.items()}
    hmma = {name: build.kernels_with(lib, kernel, "HMMA")
            for name, (lib, kernel) in MMA_KERNELS.items()}
    emit(phase="sass", hgmma=hgmma, hmma=hmma)
    for name, found in hgmma.items():
        check(bool(found) and all(found.values()),
              f"{name}: no HGMMA in the SASS of {WGMMA_KERNELS[name][1]}")
    for name, found in hmma.items():
        check(bool(found) and all(found.values()),
              f"{name}: no HMMA in the SASS of {MMA_KERNELS[name][1]}")
    for name in BF16_INSTANCES:
        bf16 = [k for k in hgmma[name] if k.endswith("Lb1EEv9FusedArgs")]
        check(len(bf16) == 4, f"{name}: bf16 instantiations {bf16}")
    if args.plain_peak:
        emit(phase="plain_train_peak", **plain_train_peak(
            torch, args.plain_peak, build_model, get_config))
        print(smi, flush=True)
        return 0

    # 1a. the dry-run matrix on the meta device (nothing on the card)
    emit(phase="dryrun", **phase_dryrun(torch))

    # 2. kernels against their plain versions at the main path's shapes
    rows, cols, cycles, target = 5, 6, 14, 28
    n = rows * cols
    circ = circuits.sycamore_like(rows, cols, cycles, seed=0)
    tn, amp_arrays = network(circuits, simplify_network, circ, "0" * n)
    t0 = time.perf_counter()
    amp_plan, report = plan_compiled(tn, target)
    plan_s = time.perf_counter() - t0
    kern = phase_kernels(torch, amp_plan, cg, ops, H100_SXM)
    torch.cuda.empty_cache()
    kern.update(phase_lm_kernels(torch, fa, ssd))
    for name, rec in kern.items():
        emit(phase="kernel", name=name, **rec)
    torch.cuda.empty_cache()

    # 3. amplitude, every slice, against the statevector --------------
    cg.reset_launches()
    launches, routes = {}, {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    res = simulate_amplitude(circ, "0" * n, target_dim=target, backend="gemm")
    torch.cuda.synchronize()
    exec_s = time.perf_counter() - t0 - res.report.plan_wall_s
    amp_peak = torch.cuda.max_memory_allocated() - base
    check_peak("amplitude", amp_peak, res.report.peak_bytes_hoisted)
    launches["amplitude"] = dict(cg.LAUNCHES)
    routes["amplitude"] = dict(cg.FUSED_ROUTES)
    if not launches["amplitude"]["tiled_gemm"]:
        # the card's refiner sent every large step to the fused kernel:
        # run once more with the fused backend off, the reference's own
        # switch, so the tiled kernel carries those steps
        res_nf = simulate_amplitude(
            circ, "0" * n, target_dim=target, backend="gemm", fused=False)
        check(abs(res_nf.value - res.value) <= AMP_TOL * abs(res.value),
              "fused=False amplitude disagrees")
    t0 = time.perf_counter()
    psi = statevector.simulate(circ)
    torch.cuda.synchronize()
    sv_s = time.perf_counter() - t0
    sv_amp = complex(psi[0].item())
    open_q = tuple(range(n - 4, n))
    sv_batch = psi[:16].cpu().numpy()  # last 4 qubits vary, base all-zero
    del psi
    torch.cuda.empty_cache()
    amp = complex(res.value)
    amp_exec_s = exec_s
    amp_err = abs(amp - sv_amp) / abs(sv_amp)
    check(amp_err <= AMP_TOL, f"amplitude vs statevector: {amp_err}")
    emit(phase="amplitude", qubits=n, cycles=cycles, target_dim=target,
         num_sliced=res.report.num_sliced, slices=1 << res.report.num_sliced,
         plan_s=res.report.plan_wall_s, exec_s=exec_s, statevector_s=sv_s,
         amplitude=[amp.real, amp.imag], statevector=[sv_amp.real, sv_amp.imag],
         rel_err=amp_err, backends=res.report.lowered_backends,
         chains=res.report.fused_chains, max_chain_len=res.report.max_chain_len,
         peak_bytes=amp_peak, peak_bytes_planned=res.report.peak_bytes_hoisted,
         launches=launches["amplitude"], first_plan_s=plan_s)
    del res
    torch.cuda.empty_cache()

    # 3a. mixed precision under the XEB budget: fp32 and auto, peak mode
    prec = phase_precision(torch, simulate_amplitude, cg, circ, n, target, sv_amp)
    emit(phase="precision", **prec)
    torch.cuda.empty_cache()

    # 3b. where one slice's time goes: a profiler trace of one slice of
    # the same plan (device busy share, time by kernel)
    emit(phase="trace", **trace_slice(torch, open_session, circ, n, target))

    # 4. sampling with 4 open qubits, against einsum and the statevector.
    # The one-shot planner's multi-restart greedy is seed-sensitive on the
    # open-batch network (seed 0 plans 2^51 operations, 2^7 times the
    # closed amplitude's): plan a few seeds on the host, sample with the
    # cheapest plan.
    tn4, _ = open_batch_network(circ, "0" * n, open_q)
    costs = {
        s: plan_contraction(tn4, target, seed=s, repeats=32)[2].log2_sliced_cost
        for s in range(4)
    }
    seed4 = min(costs, key=costs.get)
    cg.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    samp = sample_bitstrings(circ, num_samples=1000, open_qubits=open_q,
                             target_dim=target, backend="gemm", seed=seed4,
                             repeats=32)
    torch.cuda.synchronize()
    samp_s = time.perf_counter() - t0
    launches["sampling"] = dict(cg.LAUNCHES)
    routes["sampling"] = dict(cg.FUSED_ROUTES)
    oracle, _ = open_amplitude_batch(circ, open_qubits=open_q,
                                     target_dim=target, backend="einsum",
                                     seed=seed4, repeats=32)
    got_b, ein_b = samp.batch.flat(), oracle.flat()
    ein_err = float(abs(got_b - ein_b).max() / abs(ein_b).max())
    sv_err = float(abs(got_b - sv_batch).max() / abs(sv_batch).max())
    check(ein_err <= AMP_TOL, f"batch vs einsum: {ein_err}")
    check(sv_err <= AMP_TOL, f"batch vs statevector: {sv_err}")
    check(samp.num_samples == 1000, "wrong sample count")
    emit(phase="sampling", open_qubits=list(open_q), samples=samp.num_samples,
         planner_seed=seed4, log2_sliced_cost_by_seed=costs,
         num_sliced=samp.report.num_sliced,
         seconds=samp_s, rel_err_vs_einsum=ein_err,
         rel_err_vs_statevector=sv_err, xeb=samp.xeb,
         launches=launches["sampling"])
    samp_flat = samp.batch.flat().copy()
    del samp, oracle
    torch.cuda.empty_cache()

    # 4a. the contraction server on samp30: calibration, then a cold and
    # a warm burst of amplitude and sampling tenants
    eng = phase_engine(torch, cg, circ, n, target, seed4, samp_flat, sv_batch,
                       amp_plan, amp_arrays)
    launches["engine"] = eng.pop("launches")
    routes["engine"] = eng.pop("fused_routes")
    emit(phase="engine", **eng)
    torch.cuda.empty_cache()

    # 4b. the anytime plan search on amp30 (and samp30 on the host)
    srch = phase_search(torch, obs, cg, circ, tn, tn4, target, sv_amp,
                        amp_plan, amp_exec_s, costs)
    launches["search"] = srch.pop("launches")
    routes["search"] = srch.pop("fused_routes")
    emit(phase="search", **srch)
    torch.cuda.empty_cache()

    # 4c. slice-level fault tolerance: a failure, then a resume
    resu = phase_resume(torch, obs, cg, amp_plan, amp_arrays, amp)
    launches["resume"] = resu.pop("launches")
    routes["resume"] = resu.pop("fused_routes")
    emit(phase="resume", **resu)
    torch.cuda.empty_cache()

    # 4d. multi-host scheduling at world size 1, and the explicit-device
    # paths on samp30
    tn4, arrays4 = open_batch_network(circ, "0" * n, open_q)
    samp_plan, _ = plan_compiled(tn4, target, seed=seed4, repeats=32)
    mh = phase_multihost(torch, cg, amp_plan, amp_arrays, report, amp,
                         samp_plan, arrays4, samp_flat, circ, open_q, target,
                         seed4, torch.device("cuda", 0))
    launches["multihost"] = mh.pop("launches")
    routes["multihost"] = mh.pop("fused_routes")
    emit(phase="multihost", **mh)
    del amp_plan, amp_arrays, samp_plan, arrays4
    PLAN_CACHE.clear()
    torch.cuda.empty_cache()

    # 5. 36 qubits, two slices of the full width --------------------
    rows5, cols5, target5 = 6, 6, 30
    n5 = rows5 * cols5
    circ5 = circuits.sycamore_like(rows5, cols5, cycles, seed=0)
    ids = [0, 1]
    cg.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    sess, rep5 = open_session(circ5, "0" * n5, target_dim=target5,
                              backend="gemm")
    plan5_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sess.hoisted()
    torch.cuda.synchronize()
    prologue_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    val = sess.run_slices(ids)
    torch.cuda.synchronize()
    slice_s = (time.perf_counter() - t0) / len(ids)
    peak = torch.cuda.max_memory_allocated() - base
    check_peak("share", peak, rep5.peak_bytes_hoisted)
    launches["share"] = dict(cg.LAUNCHES)
    routes["share"] = dict(cg.FUSED_ROUTES)
    del sess
    torch.cuda.empty_cache()
    ein_sess, _ = open_session(circ5, "0" * n5, target_dim=target5,
                               backend="einsum")
    t0 = time.perf_counter()
    ein_val = ein_sess.run_slices(ids)
    torch.cuda.synchronize()
    ein_slice_s = (time.perf_counter() - t0) / len(ids)
    del ein_sess
    share_err = float(abs(val - ein_val).max() / ein_val.abs().max())
    check(share_err <= AMP_TOL, f"36-qubit slices vs einsum: {share_err}")
    emit(phase="share", qubits=n5, target_dim=target5,
         num_sliced=rep5.num_sliced, slice_ids=ids, plan_s=plan5_s,
         prologue_s=prologue_s, seconds_per_slice=slice_s,
         einsum_seconds_per_slice=ein_slice_s, rel_err_vs_einsum=share_err,
         peak_bytes=peak, peak_bytes_planned=rep5.peak_bytes_hoisted,
         backends=rep5.lowered_backends, launches=launches["share"])

    del ein_val, val
    PLAN_CACHE.clear()  # the plans' hoisted buffers leave the card
    torch.cuda.empty_cache()

    # 6. LM serving at full width, each model's own launches ----------
    k4_shapes = {}
    for arch, cut in SERVE_MODELS.items():
        t0 = time.perf_counter()
        rec = phase_serve(torch, arch, decode_demo, build_model, get_config,
                          lm_counts, lm_reset, lm_layers, **cut)
        launches[f"serve:{arch}"] = rec["launches"]
        k4_shapes[arch] = rec["k4_shapes"]
        if arch == "zamba2-7b":
            zamba_agree = rec["agreement"]
        if arch == "seamless-m4t-medium":
            encdec_agree = rec["agreement"]
        emit(phase="serve", seconds=time.perf_counter() - t0, **rec)
        torch.cuda.empty_cache()
    for arch in SERVE_MODELS:
        if get_config(arch).family != "ssm":
            check(launches[f"serve:{arch}"]["flash_attention"] > 0,
                  f"flash_attention was not launched serving {arch}")
    check(launches["serve:mamba2-130m"]["ssd_chunk"] > 0,
          "ssd_chunk was not launched serving mamba2-130m")
    ssd_routes = launches["serve:mamba2-130m"]["ssd_routes"]
    check(ssd_routes["simt"] == 0
          and ssd_routes["wgmma"] == launches["serve:mamba2-130m"]["ssd_chunk"],
          f"ssd_chunk took the simt route serving mamba2-130m: {ssd_routes}")
    # zamba2-7b: every K4 launch of its bf16 serve the wgmma kernel with
    # the window, every ssd_chunk launch on wgmma; its fp32 agreement ran
    # the FFMA kernel with the same window
    zl = launches["serve:zamba2-7b"]
    check(zl["flash_window_routes"] == {"wgmma": zl["flash_attention"],
                                        "simt": 0},
          f"zamba2-7b's K4 launches not all windowed wgmma: {zl}")
    check(zl["ssd_chunk"] > 0 and zl["ssd_routes"] == {
        "wgmma": zl["ssd_chunk"], "simt": 0},
        f"ssd_chunk took the simt route serving zamba2-7b: {zl['ssd_routes']}")
    za = zamba_agree["fp32_card_launches"]
    check(za["flash_window_routes"]["simt"] == za["flash_attention"] > 0,
          f"zamba2-7b's fp32 agreement did not run the windowed FFMA K4: {za}")
    # seamless-m4t-medium: one prefill, every K4 launch on the wgmma
    # kernel, 12 non-causal in the encoder and 12 in the
    # cross-attention; its fp32 agreement (2 + 2 layers) on the FFMA
    # kernel, 2 + 2 of them non-causal
    el = launches["serve:seamless-m4t-medium"]
    n = get_config("seamless-m4t-medium").num_layers
    check(el["flash_fwd_routes"] == {"wgmma": el["flash_attention"], "simt": 0}
          and el["flash_attention"] == 3 * n,
          f"seamless-m4t-medium's K4 launches not all wgmma, 3 a layer: {el}")
    check(el["flash_noncausal"] == {"wgmma": 2 * n, "simt": 0}
          and el["cross_noncausal"] == n,
          f"seamless-m4t-medium's non-causal K4 launches: {el}")
    ea = encdec_agree["fp32_card_launches"]
    check(ea["flash_noncausal"] == {"wgmma": 0, "simt": 4}
          and ea["flash_fwd_routes"]["simt"] == ea["flash_attention"] == 6,
          f"seamless-m4t-medium's fp32 agreement did not run the FFMA K4 "
          f"non-causal: {ea}")
    # llama4-scout-17b-a16e: one prefill launch a layer, every one the
    # wgmma kernel at bh 160 on 32 kv heads (GQA group 5)
    arch = "llama4-scout-17b-a16e"
    ll = launches[f"serve:{arch}"]
    check(ll["flash_attention"] == SERVE_MODELS[arch]["layers"]
          and ll["flash_fwd_routes"] == {"wgmma": ll["flash_attention"],
                                         "simt": 0}
          and k4_shapes[arch] == [(160, 32, 512, 512, 128)],
          f"{arch}'s K4 launches: {ll}, shapes {k4_shapes[arch]}")

    # 6a. LM training at full width (each model's depth in TRAIN), each
    # model's own launches
    train_agree = {}
    for arch, spec in TRAIN.items():
        t0 = time.perf_counter()
        rec = phase_train(torch, arch, build_model, get_config, lm_counts,
                          lm_reset, lm_layers, **spec)
        launches[f"train:{arch}"] = rec["launches"]
        train_agree[arch] = rec["agreement"]
        emit(phase="train", seconds=time.perf_counter() - t0, **rec)
        torch.cuda.empty_cache()
    emit(phase="train", **phase_train_example(torch, lm_counts, lm_reset))
    torch.cuda.empty_cache()
    # the sharded step's products split over "model": each rank's share
    # of qwen3-4b's, seamless-m4t-medium's, zamba2-7b's and
    # deepseek-moe-16b's blocks against the whole blocks (TP_LOCAL)
    tpl = phase_tp_local(torch, build_model, get_config, lm_counts, lm_reset,
                         lm_layers)
    emit(phase="tp_local", **tpl)
    emit(phase="sharded_train", mesh=list(ONE_RANK[0]), axes=list(ONE_RANK[1]),
         launches={arch: launches[f"train:{arch}"] for arch in TRAIN})
    t0 = time.perf_counter()
    pipe = phase_pipeline(torch, build_model, get_config, lm_counts, lm_reset)
    launches["pipeline"] = pipe["launches"]
    emit(phase="pipeline", wall_s=time.perf_counter() - t0, **pipe)
    import torch.distributed as dist

    dist.destroy_process_group()  # the one-rank run of train and pipeline
    check(launches["train:qwen3-4b"]["flash_attention_bwd"] > 0,
          "flash_attention_bwd was not launched training qwen3-4b")
    check(launches["train:mamba2-130m"]["ssd_chunk_bwd"] > 0,
          "ssd_chunk_bwd was not launched training mamba2-130m")
    ssd_routes = launches["train:mamba2-130m"]["ssd_routes"]
    check(ssd_routes["simt"] == 0,
          f"ssd_chunk took the simt route training mamba2-130m: {ssd_routes}")
    fa_routes = launches["train:qwen3-4b"]["flash_bwd_routes"]
    check(fa_routes["mma"] > 0,
          f"flash_attention_bwd's mma route was not launched training "
          f"qwen3-4b: {fa_routes}")
    ssd_routes = launches["train:mamba2-130m"]["ssd_bwd_routes"]
    check(ssd_routes["simt"] == 0 and ssd_routes["wgmma"]
          == launches["train:mamba2-130m"]["ssd_chunk_bwd"],
          f"ssd_chunk_bwd took the simt route training mamba2-130m: {ssd_routes}")
    for arch in ("deepseek-moe-16b", "zamba2-7b"):
        check(launches[f"train:{arch}"]["flash_attention_bwd"] > 0,
              f"flash_attention_bwd was not launched training {arch}")
    # qwen2-vl-72b: every K4 backward of its bf16 steps on mma (GQA group
    # 8); its M-RoPE positions reached the loss (phase_train)
    vt = launches["train:qwen2-vl-72b"]
    check(vt["flash_attention_bwd"] > 0
          and vt["flash_bwd_routes"] == {"mma": vt["flash_attention_bwd"],
                                         "simt": 0},
          f"qwen2-vl-72b's K4 backward launches not all mma: {vt}")
    # zamba2-7b: every K4 backward of its bf16 run windowed on mma, of its
    # fp32 agreement windowed on simt; every ssd_chunk_bwd launch wgmma
    zt = launches["train:zamba2-7b"]
    check(zt["flash_bwd_window_routes"] == {"mma": zt["flash_attention_bwd"],
                                            "simt": 0},
          f"zamba2-7b's K4 backward launches not all windowed mma: {zt}")
    za = train_agree["zamba2-7b"]["fp32"]["card_launches"]
    check(za["flash_bwd_window_routes"]["simt"] == za["flash_attention_bwd"] > 0,
          f"zamba2-7b's fp32 agreement did not run the windowed simt "
          f"backward: {za}")
    check(zt["ssd_chunk_bwd"] > 0 and zt["ssd_bwd_routes"] == {
        "wgmma": zt["ssd_chunk_bwd"], "simt": 0},
        f"ssd_chunk_bwd took the simt route training zamba2-7b: {zt}")
    # seamless-m4t-medium: 3 K4 backward launches a layer and step, all
    # on mma, 2 of them non-causal (the encoder's, the cross-attention's);
    # its fp32 agreement's on simt
    et = launches["train:seamless-m4t-medium"]
    n = get_config("seamless-m4t-medium").num_layers * TRAIN_STEPS
    check(et["flash_attention_bwd"] == 3 * n
          and et["flash_bwd_routes"] == {"mma": 3 * n, "simt": 0}
          and et["flash_bwd_noncausal"] == {"mma": 2 * n, "simt": 0},
          f"seamless-m4t-medium's K4 backward launches: {et}")
    ea = train_agree["seamless-m4t-medium"]["fp32"]["card_launches"]
    check(ea["flash_bwd_noncausal"]["simt"] > 0
          and ea["flash_bwd_noncausal"]["mma"] == 0,
          f"seamless-m4t-medium's fp32 agreement did not run the non-causal "
          f"simt backward: {ea}")

    # 7. every kernel went through its path ---------------------------
    total = {k: sum(launches[ph][k]
                    for ph in ("amplitude", "sampling", "engine", "search",
                               "resume", "multihost", "share"))
             for k in cg.LAUNCHES}
    total["flash_attention"] = launches["serve:qwen3-4b"]["flash_attention"]
    for name in K4_SHAPES:
        if ":" in name:  # the other served models' K4 launches
            total[name] = launches[f"serve:{name.split(':')[1]}"]["flash_attention"]
    # seamless-m4t-medium's encoder and cross-attention launches: the
    # serve's non-causal ones, those inside the cross-attention apart
    el = launches["serve:seamless-m4t-medium"]
    total["flash_attention:seamless-m4t-medium:cross"] = el["cross_noncausal"]
    total["flash_attention:seamless-m4t-medium"] = (
        el["flash_noncausal"]["wgmma"] - el["cross_noncausal"])
    total["flash_attention_bwd:seamless-m4t-medium"] = launches[
        "train:seamless-m4t-medium"]["flash_bwd_noncausal"]["mma"]
    total["flash_attention_bwd:qwen2-vl-72b"] = launches[
        "train:qwen2-vl-72b"]["flash_bwd_routes"]["mma"]
    total["ssd_chunk"] = launches["serve:mamba2-130m"]["ssd_chunk"]
    total["flash_attention_bwd"] = launches["train:qwen3-4b"]["flash_attention_bwd"]
    total["ssd_chunk_bwd"] = launches["train:mamba2-130m"]["ssd_chunk_bwd"]
    for name, count in total.items():
        check(count > 0, f"{name} was not launched on its path")
    # every fused_gemm launch of phases 3-5 and engine took the wgmma
    # kernel, with the coalesced gather of one map for every tile
    fused_routes = {r: sum(routes[ph][r] for ph in routes) for r in cg.FUSED_ROUTES}
    check(sum(fused_routes.values()) == total["fused_gemm"],
          f"fused_gemm launches {total['fused_gemm']} vs routes {fused_routes}")
    check(fused_routes["general"] == 0,
          f"fused_gemm took the general gather on the path: {fused_routes}")
    for name in BF16_ROUTES:
        check(prec["bf16_launches"][name] > 0,
              f"{name}'s bf16 route was not launched in the precision phase")
    # the LM kernels' launches in the sharded train phase (every trained
    # model) and in the pipeline phase, beside their path's count
    extra = {name: dict(sharded_train_launches=sum(
        launches[f"train:{arch}"][name] for arch in TRAIN))
        for name in ("flash_attention", "flash_attention_bwd", "ssd_chunk",
                     "ssd_chunk_bwd")}
    for name in ("flash_attention", "flash_attention_bwd"):
        extra[name]["pipeline_launches"] = launches["pipeline"][name]
    for name in ("flash_attention_bwd", "ssd_chunk_bwd"):
        check(extra[name]["sharded_train_launches"] > 0,
              f"{name} was not launched by the sharded train phase")
    records = []
    for name in TPU_KERNELS:
        rec = kern[name]
        records.append(dict(
            name=name, route="cuda", design=DESIGNS[name],
            source=SOURCES[name],
            replaces=TPU_KERNELS[name], launches=total[name],
            max_abs_err=rec["max_abs_err"], ms=rec["ms"],
            plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
            bound_by=rec["bound_by"], library_ms=rec["library_ms"],
            **{k: rec[k] for k in ("simt_ms",) if k in rec},
            **extra.get(name, {}),
        ))
    for name in K4_SHAPES:
        if ":" not in name:
            continue
        rec = kern[name]
        records.append(dict(
            name=name, route="cuda", design=DESIGNS["flash_attention"],
            source=SOURCES["flash_attention"],
            replaces=TPU_KERNELS["flash_attention"], launches=total[name],
            max_abs_err=rec["max_abs_err"], ms=rec["ms"],
            plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
            bound_by=rec["bound_by"], library_ms=rec["library_ms"],
        ))
    # K4's backward at seamless-m4t-medium's encoder shape, with the
    # non-causal backward launches of that model's training run (24 a
    # step: 12 encoder layers, 12 cross-attentions), and at qwen2-vl-72b's
    # training shape (GQA group 8), with its training run's (2 a step)
    for name in ("flash_attention_bwd:seamless-m4t-medium",
                 "flash_attention_bwd:qwen2-vl-72b"):
        rec = kern[name]
        records.append(dict(
            name=name, route="cuda", design=DESIGNS["flash_attention_bwd"],
            source=SOURCES["flash_attention_bwd"],
            replaces=TPU_KERNELS["flash_attention_bwd"],
            launches=total[name], launches_per_step=total[name] / TRAIN_STEPS,
            max_abs_err=rec["max_abs_err"], ms=rec["ms"],
            simt_ms=rec["simt_ms"], plain_ms=rec["plain_ms"],
            bound_ms=rec["bound_ms"], bound_by=rec["bound_by"],
            library_ms=rec["library_ms"],
        ))
    # K4's windowed backward at zamba2-7b's training shape, with the
    # launches of that model's training run (one a step: one shared-block
    # application at 7 layers)
    rec = kern["flash_attention_bwd:zamba2-7b"]
    records.append(dict(
        name="flash_attention_bwd:zamba2-7b", route="cuda",
        design=DESIGNS["flash_attention_bwd"],
        source=SOURCES["flash_attention_bwd"],
        replaces=TPU_KERNELS["flash_attention_bwd"],
        launches=launches["train:zamba2-7b"]["flash_attention_bwd"],
        launches_per_step=launches["train:zamba2-7b"]["flash_attention_bwd"]
        / TRAIN_STEPS,
        max_abs_err=rec["max_abs_err"], ms=rec["ms"], simt_ms=rec["simt_ms"],
        plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
        bound_by=rec["bound_by"], simt_bound_ms=rec["simt_bound_ms"],
        library_ms=rec["library_ms"],
    ))
    # K4 and its backward, K5 and its backward, on one rank's heads of the
    # tp_local models: the rank launches of the block that runs that shape
    # in the bf16 checks of the tp_local phase at that P (one a layer, rank
    # and pass), beside its fp32 launches (K4's on the simt kernels)
    for key, (arch, block) in TP_RECORD_BLOCKS.items():
        for size in TP_SIZES:
            for base in KERNEL_BASES[block]:
                name = f"{base}:{key}:tp{size}"
                rec = kern[name]
                runs = {t: [b for k, b in tpl["checks"][
                    f"{arch}:{t}:P{size}"]["blocks"].items()
                    if k.split(":")[0] == block] for t in ("bf16", "fp32")}
                # the whole block launches once; the ranks the rest
                local = {t: sum(b[base] - 1 for b in bs)
                         for t, bs in runs.items()}
                want = sum(b["passes"] * size for b in runs["bf16"])
                records.append(dict(
                    name=name, route="cuda", design=DESIGNS[base],
                    source=SOURCES[base], replaces=TPU_KERNELS[base],
                    launches=local["bf16"], simt_launches=local["fp32"]
                    if base.startswith("flash") else None,
                    fp32_launches=local["fp32"],
                    launches_per_rank_layer=runs["bf16"][0]["passes"],
                    max_abs_err=rec["max_abs_err"], ms=rec["ms"],
                    plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
                    bound_by=rec["bound_by"], library_ms=rec["library_ms"],
                    shape=rec["shape"],
                ))
                check(local["bf16"] == local["fp32"] == want,
                      f"{name}: {local} launches, want {want}")
    for name in BF16_ROUTES:
        rec = kern[f"{name}:bf16"]
        records.append(dict(
            name=f"{name}:bf16", route="cuda", design=BF16_DESIGNS[name],
            source=SOURCES[name], replaces=TPU_KERNELS[name],
            launches=prec["bf16_launches"][name],
            max_abs_err=rec["max_abs_err"], ms=rec["ms"],
            plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
            bound_by=rec["bound_by"], library_ms=rec["library_ms"],
        ))
    emit(phase="done", seconds=time.perf_counter() - t_start,
         launches_by_phase=launches, fused_routes_by_phase=routes,
         bf16_launches_precision_phase=prec["bf16_launches"])
    print(json.dumps({"kernels": records}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
