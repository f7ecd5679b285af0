"""Drive the PyTorch + CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit, then builds every kernel of the
   serving, training and evaluation paths from ``src/repro_torch/csrc`` (one
   ``nvcc`` per source, all started together: 6 libraries, 7 kernels, B1,
   B2 and B3 each also with an expert axis), and
   prints each entry's registers, shared memory and spills (-Xptxas -v);
   B4b's bodies must use no stack and spill nothing, B4a's head-wide
   body no spills.
2. Checks each kernel against its plain PyTorch version on the card at the
   full-width qwen3-1.7b shapes of the serving path and the full-width
   llama-paper-200m shapes of a training step (16 x 512 tokens): B1 (QuEST
   quantize) bit for bit, with an E8M0 edge sweep; B5 (paged attention) on
   both pools at decode and prefill shapes and at the edges of its split
   over CTAs (lengths 1, 16, 32, a full table, a page of E8M0 scale codes
   1 and 2) and at the speculative verify's S = k + 1 for k = 1, 4, 7; B4a
   (KV quantize-pack and its pool scatter, K and V in one launch, strided
   inputs) bit for bit, with an E8M0 edge sweep; B4b (unpack-dequantize
   and its page gather, K and V in one launch) bit for bit over every
   (byte, scale code) pair and over ragged page tables; B2 (SR-Hadamard
   quantize) bit for bit at the four backward operands of the up and down
   projections as the training path lays them out; B3 (MXFP4 GEMM) bit for
   bit at ragged M and N and at E8M0-edge scales; B6 (flash
   attention) at the evaluation shape, qwen3-1.7b's GQA at 4096, a ragged
   f32 case and a ragged hd-64 bf16 case, with SDPA as a second reading;
   and one full-width ``quartet_linear`` backward on the kernels against
   the same backward on the plain versions (a mismatch raises).
3. Serves 8 requests with the port's ``Engine`` on full-width, full-depth
   qwen3-1.7b (random weights from a seed, MXFP4 KV pool, paged attention,
   greedy decoding, Quartet linears through the kernels), with every launch
   counter set to 0 just before and read just after, against the predicted
   counts (B4a one launch per layer write, and every B1 launch on its
   vector body, on every path); then
   the first 4 requests on the gather backend (per-slot
   prefill, gather-dequantize, dense attention, scatter back), its launches
   against the per-slot schedule and its first-token log-probs against the
   paged run's; then holds a reduced model's engine tokens against its own
   teacher-forced forward and the gather tokens against the paged ones.
3b. Features, on the same model and requests (paged backend, MXFP4 pool):
   sampled decoding (temperature 0.8, top-k 50, top-p 0.95, seeds 0-7) run
   twice, the streams equal; speculative decoding at k = 4 with the self,
   n-gram and draft proposers (the draft: full-width qwen3-1.7b at the
   target's seed), launches against the count of target and draft step
   calls, acceptance, tokens per verify call and tok/s; every proposer's
   tokens equal to the non-speculative run's, self-speculation's verify rows
   equal to its decode rows bit for bit and its log-probs against the
   teacher-forced forward, and sampled self-speculation equal to the
   sampled stream; the prefix cache on 8 prompts sharing 256 tokens,
   cold and warm, its counts against the schedule's, warm tokens and
   first-token log-probs against cold, the pool audited after every tick.
3c. MoE serving (``--phases moe``): the expert-axis B1 and B3 against
   their plain versions and E launches of the 2-d kernels, bit for bit, at a
   full-width MoE layer's decode and prefill shapes, its stacked weights'
   transposed views and B1's E8M0 edge rows; B5 at the MoE's group of 16 at
   R = 16, 80 and 1024 query rows a head; then the engine phase's traffic
   on qwen3-moe-235b-a22b at its published widths, 8 of its 94 layers
   (random weights from a seed; MXFP4 pool, paged backend, greedy), its
   launches against the per-step-call prediction (14 B1, 7 B3, 1 B5, 1 B4a
   a layer), its log-probs against the teacher-forced forward, tok/s, TTFT,
   tick times, pool, weight and peak bytes; self-speculation at k = 4
   token-exact with verify rows equal to decode rows; the expert-axis
   kernels timed on layer 0's experts at a decode and a prefill tick, and
   B4a at a MoE decode tick's KV write; and
   reduced qwen3-moe and arctic on the card against the CPU and their own
   teacher-forced forward, paged against gather.
4. Trains: a reduced Llama 3 steps on the card (kernels) and on the CPU
   (plain versions), losses and grad-norms compared; checkpoint and resume
   at full width, 2 layers deep (two unbroken runs and one stopped and
   started again; the checkpoint's bytes and write time); then full-width,
   full-depth llama-paper-200m 5 steps through ``train.loop.train`` (batch
   32 x 512, 2 microbatches, Quartet on every transformer linear), with every
   launch counter set to 0 just before and read just after, beside the
   predicted counts (every B2 launch on its vector body); prints tokens/s,
   the median step time and peak memory;
   then evaluates the trained state on 4 held-out batches of 16 x 512 with
   the training model (blocked attention) and a flash-built one (B6, 40
   launches), the two nll values held to a stated tolerance.
4b. MoE training (``--phases moe-train``): B2's expert axis against its
   plain version and against 128 launches of the 2-d kernel, bit for bit,
   at the four backward operands of a full-width expert linear (gate/up
   and down, 320 tokens an expert, seeds on both sides of 2^31); one
   full-width ``quartet_linear_experts`` backward on the kernels against
   the plain versions; reduced qwen3-moe 3 steps on the card and on the CPU
   from equal states (8-bit AdamW, bf16 master, aux weight 0.01), and
   ``moe_ffn``'s backward with no host sync; then qwen3-moe-235b-a22b at
   its published widths, 1 of its 94 layers, 5 steps of 8 x 512 tokens
   through ``train.loop.train`` with the 8-bit AdamW and a bf16 master,
   its launches against the prediction (28 B1, 28 B2, 28 B3 a layer a
   step, 12 of the B2 on the expert axis), tokens/s, the median step, peak
   memory, loss and aux per step, the state's checkpoint bytes and one
   profiled step's device time by kernel kind and idle share; and B1, B2
   and B3 timed over one full-width expert linear's training launches.
4c. Quartet's variants (``--phases variants``, no kernel of its own: the
   reference computes them outside its kernels): every format (MXFP4,
   NVFP4, MXFP6, MXFP8, FP8 E4M3/E5M2, INT4, INT8) x every quantizer
   (RTN-AbsMax, also with E8M0-floor scales; SR-AbsMax; QuEST; RTN-PMA; the
   fast SR) on a [4096, 1280] activation plus edge rows (E4M3 underflow
   and overflow, grid-midpoint ties, zeros, E8M0 floor edges), card against
   CPU bit for bit, NaN places included; Table 2 through the port's twin,
   beside the paper's values (QuEST < RTN < SR in MSE asserted); full-width
   llama-paper-200m 2 steps of 4 x 512 tokens under the FP8 baseline,
   RTN- and SR-AbsMax forwards, an RTN or unquantized backward, the fixed
   backward Hadamard and MXFP8 with QuEST (plain path), and one step of
   Quartet on the kernels: losses, grad-norms and step times, all finite;
   one full-width linear under NVFP4 at group 16 at upstream-gradient
   scales 1 and 1e-3, card against CPU; ``use_kernels=True`` raising on the
   FP8 baseline.
4d. The paper's baselines and gradient compression (``--phases
   baselines``, no kernel of their own: the reference computes them outside
   its kernels, with f32 products, and ``allow_tf32`` stays False):
   rmsnorm on the card against the CPU bit for bit at the ported widths
   (one summation order on every device) and a [B, 5] call's rows against
   [B, 1] calls; each of LUQ-INT4, LUQ-FP4, Jetfire, HALO and LSS on
   llama-paper-200m's up and down projections at 4 x 512 tokens, card
   against CPU (the quantized operands and stochastic decisions bit for
   bit, y, dx and dW within a stated tolerance); full-width llama-paper-200m
   2 steps of 4 x 512 tokens under each method and bf16 (plain path):
   losses, grad-norms and step times, all finite; Quartet on the kernels as
   the train phase trains it, without and with the SR-int8 gradient round
   trip, launches against the prediction (the compression adds none),
   tokens/s, the median step and peak memory; and a 2-layer stop-and-resume
   with the compression's error restored bit for bit.  Also rope's tables
   (cos/sin of the f32 angles in float64, rounded once) on the card against
   the CPU bit for bit at the ported head widths and thetas.
4e. The remaining dense configs (``--phases dense-configs``): starcoder2-3b
   (GELU MLP with biases, GQA 24/2) at full width and depth through the
   engine phase's traffic on the paged and gather backends (launches
   against the prediction, each backend's first-token log-probs within
   the gather-vs-paged bounds of the teacher-forced forward); 2 Quartet
   steps at 4 of its 30 layers (B1, B2 and B3 launches against the
   prediction); ``repro_torch.examples.train_c4 --tiny`` stopped after
   step 2 and resumed bit for bit.
4f. The SSM family (``--phases ssm``): B4a and B4b through their 2-d
   entries on the state rings' views at falcon-mamba-7b's full width, bit
   for bit against their plain versions; falcon-mamba-7b at full width and
   depth serving 8 requests from MXFP4 state rings (the ``statepool``
   backend): B1, B3, B4a and B4b launches against the prediction, tok/s,
   TTFT, ticks, ring bytes against the dense slots', peak memory, and the
   first-token log-probs within stated bounds of the teacher-forced
   forward; at 2 layers, ``statepool`` with dense rings token-exact against
   ``dense_slots``.
4g. The hybrid family (``--phases hybrid``): B4a and B4b with the
   head-wide block (one scale a head of 112) bit for bit against their plain
   versions (the K+V scatter at a decode tick and a prefill chunk, strided
   and unaligned rows; the E8M0 edge sweep; the K+V gather over ragged
   tables and the 2-d dequantize over every (byte, scale code) pair) and on
   the zamba2 rings' views; rope at hd 112 card = CPU bit for bit and one
   full-width Mamba2 block card against CPU within stated bounds;
   zamba2-7b at full width and depth serving the first HYBRID_REQUESTS of
   the ssm phase's prompts from an MXFP4 attention-KV plane and MXFP4 rings
   (launches against the prediction, tok/s, TTFT, ticks, prefill calls by
   shape, plane bytes against the dense slots', peak memory, first-token
   log-probs within the ssm phase's gate); at 13 layers, dense planes
   token-exact against ``dense_slots``; with ``times``, B4a and B4b timed
   at the KV plane's and both SSM families' rings' shapes.
4h. The enc-dec and VLM families (``--phases cross``): B4a and B4b at
   whisper's head dim of 64 bit for bit against their plain versions (the
   K+V scatter at a decode tick and a prefill chunk, strided and unaligned;
   the E8M0 edge rows; the ragged K+V gather over every (byte, scale code)
   pair), each cross plane's one-launch scatter of a whole source (1500
   and 1600 tokens) and its gather sliced to the source's length; B1 and
   B3 at whisper's linears (K and N of 384 and 1536; 8, 64 and 1500 rows);
   layernorm card = CPU bit for bit at d 384 and 4096; whisper-tiny and
   llama-3.2-vision-11b (gates set) at full width and depth serving 4
   prompts each, with its own source or image, from MXFP4 self- and
   cross-KV planes (launches against the prediction, tok/s, TTFT, ticks,
   plane bytes against the dense slots', peak memory, first-token log-probs
   against the teacher-forced forward), a second wave of the same sources
   under the prefix cache encoding nothing and token-exact against the
   first, the VLM's logits moved by its gates, and statepool (dense
   planes) token-exact against ``dense_slots``; with ``times``, the cross
   plane's gather of a decode tick and its scatter of a source timed.  A
   one-chunk VLM prompt, and (in the hybrid phase) a one-chunk zamba2-7b
   prompt, read no quantized state: their first-token log-probs must equal
   the teacher-forced forward's bit for bit.
4i. Quartet training of the SSM, hybrid, enc-dec and VLM families
   (``--phases state-train``): B2 and B3 bit for bit against their plain
   versions at falcon-mamba-7b's and zamba2-7b's in_proj backward operands
   (N 16384, and 14576 padded to 14592), and each whole backward on the
   kernels against the plain versions; each family's reduced config one
   step from equal states with the kernels and with their plain versions on
   the card (bit for bit) and on the CPU (loss, nll, grad-norm and the
   updated parameters, tolerances in
   :func:`train_state_reduced_card_vs_cpu`); then whisper-tiny at full
   depth, falcon-mamba-7b at 4 of 64 layers, zamba2-7b at 12 of 81 (the
   shared block applied twice) and llama-3.2-vision-11b at one super-block
   (gates set), each 3 Quartet steps of 8 x 512 tokens through
   ``train.loop.train`` (the cross families with ``extra_batch``): step 0's
   loss in (1, 12) (the VLM's, with 128256 tokens, in (1, ln(V) + 1)),
   finite grad-norms above 1e-3, the VLM's cross-block
   gradients non-zero, B1/B2/B3 launches against
   :func:`state_train_launches`, the median step, tokens/s, peak memory and
   one profiled step's device idle share; with ``times``, B1, B2 and B3
   over one falcon-mamba-7b in_proj's training launches (4 x 512 tokens).
4j. The engine's telemetry (``--phases telemetry``): qwen3-1.7b at full
   width and depth on the engine phase's 8 requests (paged backend, the
   kernels), telemetry off (the hub's per-tick work stubbed out) and at its
   defaults in turns for tok/s, then fully on (JSONL metrics, request
   traces, Prometheus text, pool health every 4 ticks, the profiler and its
   Chrome trace): tokens, pool bytes and launch counts equal to the off
   run's, the metrics and trace files valid, ``prefill_calls`` and
   ``decode_calls`` equal to the step calls, pool health on the card equal
   to the same reduction over the pool copied to the host, the per-phase
   utilization printed; then whisper-tiny (full depth; ``kv`` and
   ``cross`` health) and falcon-mamba-7b (full width, 4 layers; ``state``
   health) on the state pool, fully on against off in tokens, pool bytes
   and launches, health card = host.
5. Times each kernel (CUDA events, median, L2 flushed before each launch)
   beside its plain version and, where one PyTorch call computes the same
   function, that call, at serving, training and evaluation shapes; B1, B2,
   B3, B4a, B4b and B5 also as a CUDA-graph replay (device time without the
   host gaps), B1's serving layer also as its 7 weight and its 7 activation
   calls apart; B4a as the layer's KV write through ``scatter_token``; B5
   also at a verify tick (S = k + 1 = 5).
6. Prints one JSON line of kernel records (B2's expert axis its own
   record, on the MoE training path), the ``nvidia-smi`` line, and last
   ``{"ok": true, "device": {...}}``.

It exits non-zero, printing no result, when no CUDA device is present or
when run outside a checkout of the repository.  ``--phases`` runs a subset
(for iterating); the default runs them all.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import functools
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_BF16_OPS = 989e12  # dense tensor-core peak
H100_INT8_OPS = 1979e12
# one instruction a lane outside the tensor cores: f32 at 128 a clock a SM
# (the data sheet's 67 TFLOP/s of f32 counts an FMA as two flops), int32 at
# 64 a clock a SM, half that (CUDA C++ Programming Guide, throughput of the
# arithmetic instructions, compute capability 9.0); a SM issues at most 128
# instructions a clock in all (one warp instruction a scheduler)
H100_F32_OPS = 67e12 / 2
H100_INT32_OPS = H100_F32_OPS / 2

# B2's operations per element, the fewest its exact form needs (the vector
# body's arithmetic in csrc/sr_hadamard_quant.cu), by the unit that runs
# them.  f32 (add, multiply, compare, min/max, select, conversion): the sign
# (1), the butterfly (5), the two prescalings (2), the absmax (1), v·2^-e
# (1); the uniform's int -> float and ·2^-24 (2); the SR's max(|v|, 1),
# |v|·2^(1-E), floor, x - floor, the compare with u, + 1, the select, ·2^E
# and the min with 12 (9); the code byte's + 1.5·2^23 (1).  int32: the
# index (1), two murmur3 fmix rounds (2 x (3 shifts, 3 xors, 2
# multiplies)), the hash's constant add and its shift by 8 (2); the SR's
# exponent mask, 2^(1-E) from it and the sign copy (3); 3 byte permutes
# for a word of 4 codes (0.75).  The per-group division and E8M0 rounding
# are 1/32 of that and left out.  The bound is the larger of the int32
# work at its rate and all of it at the issue rate.
B2_F32_OPS = 1 + 5 + 2 + 1 + 1 + 2 + 9 + 1
B2_INT32_OPS = 1 + 16 + 2 + 3 + 0.75

# serving traffic of the engine phase
N_SLOTS, PAGE_SIZE, MAX_LEN, PREFILL_CHUNK = 8, 16, 640, 64
LONG_CONTEXT = 32768  # qwen3-1.7b's published context: B5's widest table checked
N_REQUESTS, MIN_PROMPT, MAX_PROMPT, MAX_NEW = 8, 128, 512, 32
SEED = 0

# the features phase: speculation at k = SPEC_K; sampling; the prefix
# cache's shared prefix (16 full pages) and its prompts' tail lengths
SPEC_K = 4
SAMPLING = {"temperature": 0.8, "top_k": 50, "top_p": 0.95}
PREFIX_TOKENS, MIN_TAIL, MAX_TAIL = 256, 64, 200

# the moe phase: qwen3-moe-235b-a22b at its published widths, its depth cut
# to MOE_LAYERS of 94 (4.98 GB of bf16 weights a layer: 8 layers and the
# untied embedding and head hold ~42 GB of the card's 80; all 94, 468 GB)
MOE_ARCH, MOE_LAYERS = "qwen3-moe-235b-a22b", 8

# the gather-backend run of the engine phase: the first GATHER_REQUESTS of
# the phase's requests, GATHER_NEW new tokens each
GATHER_REQUESTS, GATHER_NEW = 4, 16

# evaluation of the train phase: held-out batches of EVAL_BATCH x TRAIN_SEQ
EVAL_BATCHES, EVAL_BATCH = 4, 16

# training traffic of the train phase (the paper's sequence length; its batch
# of 512 sequences would be --microbatch 32 at the same per-microbatch size)
TRAIN_ARCH, TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO = "llama-paper-200m", 5, 32, 512, 2
TRAIN_TOKENS_MB = TRAIN_BATCH // TRAIN_MICRO * TRAIN_SEQ  # 8192 tokens per microbatch
# the train phase's resume check: full width, depth cut to RESUME_LAYERS
RESUME_LAYERS, RESUME_STEPS = 2, 4

# the moe-train phase: qwen3-moe-235b-a22b at its published widths, its depth
# cut to MOE_TRAIN_LAYERS of 94 (a layer holds 2.49 B parameters; with the
# embedding and the untied head, 3.73 B: the 8-bit AdamW's state with a bf16
# master and bf16 gradients is ~22.5 GB, and a step's temporaries take it to
# a predicted 45-60 GB; two layers would need ~85 GB), MOE_TRAIN_STEPS steps
# of MOE_TRAIN_BATCH x TRAIN_SEQ tokens in one microbatch: one group of 4096
# tokens, so MOE_TRAIN_CAPACITY = 1.25 x 8 x 4096 / 128 tokens an expert
MOE_TRAIN_LAYERS, MOE_TRAIN_STEPS, MOE_TRAIN_BATCH, MOE_TRAIN_CAPACITY = 1, 5, 8, 320

# the variants phase: the quantizers on a [VARIANT_ROWS, d_model] activation
# of llama-paper-200m, and each Quartet variant training it at full width
# (VARIANT_LAYERS of its 10 layers) VARIANT_STEPS steps of VARIANT_BATCH x
# TRAIN_SEQ tokens on the plain path
VARIANT_ROWS, VARIANT_LAYERS, VARIANT_STEPS, VARIANT_BATCH = 4096, 10, 2, 4

# the dense-configs phase: starcoder2-3b (GELU MLP with biases, GQA 24/2) at
# full width and depth on the engine phase's traffic; trained at full width,
# DENSE_TRAIN_LAYERS of its 30 layers, DENSE_TRAIN_STEPS Quartet steps of
# VARIANT_BATCH x TRAIN_SEQ tokens; the training example's twin (--tiny)
# TRAIN_C4_STEPS steps, a checkpoint every 2, resumed after step 2
DENSE_ARCH, DENSE_TRAIN_LAYERS, DENSE_TRAIN_STEPS, TRAIN_C4_STEPS = "starcoder2-3b", 4, 2, 4

# the ssm phase: falcon-mamba-7b at full width and depth (64 layers, d 4096,
# Di 8192, N 16; 7.3 B parameters, ~14.6 GB in bf16) serving SSM_REQUESTS
# prompts of SSM_MIN_PROMPT..SSM_MAX_PROMPT tokens, SSM_NEW new each, from
# MXFP4 state rings on N_SLOTS slots; prefill in [1, SSM_CHUNK] chunks, then
# [1, 1] remainders.  The statepool-vs-dense_slots oracle at full width,
# SSM_ORACLE_LAYERS layers deep, on the first SSM_ORACLE_REQUESTS prompts
SSM_ARCH, SSM_REQUESTS, SSM_MIN_PROMPT, SSM_MAX_PROMPT, SSM_NEW, SSM_CHUNK = (
    "falcon-mamba-7b", 8, 64, 192, 32, 64)
SSM_ORACLE_LAYERS, SSM_ORACLE_REQUESTS, SSM_ORACLE_NEW = 2, 4, 8
# the hybrid phase: zamba2-7b at full width and depth (81 Mamba2 layers at d
# 3584, Di 7168, N 64, 112 SSM heads of 64; the shared attention + SwiGLU
# block, 32 heads of 112, before each of 13 groups of 6, then a 3-layer
# tail; 6.75 B stored parameters, 13.5 GB in bf16) serving the ssm phase's
# prompts (the first HYBRID_REQUESTS), SSM_NEW new each, from an MXFP4
# attention-KV plane of PAGE_SIZE
# pages and MXFP4 state rings; its statepool-vs-dense_slots oracle at full
# width, HYBRID_ORACLE_LAYERS deep (2 groups and a 1-layer tail), on the
# first SSM_ORACLE_REQUESTS prompts
HYBRID_ARCH, HYBRID_ORACLE_LAYERS = "zamba2-7b", 13
# of the ssm phase's prompts the hybrid serves the first HYBRID_REQUESTS (a
# [1, 1] call of its 81 layers and 13 attentions takes ~0.33 s of host
# time: all 8 prompts held the phase at 224 s)
HYBRID_REQUESTS = 4
# one full-width Mamba2 block on the card against the CPU on equal inputs
# (f32, plain f32 linears): max |Δ| of the output and of the new state, as
# fractions of max |CPU|
MAMBA2_CARD_CPU_OUT, MAMBA2_CARD_CPU_STATE = 1e-4, 1e-4
# first-token log-probs of the MXFP4 rings against the teacher-forced
# forward (the rings quantize the state at every prefill call and decode
# step; a reduced 4-layer d-512 model on the CPU read max 1.8-4.3, mean
# 0.34-0.83): max |Δ| and mean |Δ| bounds
SSM_LOGPROB_MAX, SSM_LOGPROB_MEAN = 8.0, 1.5

# the cross phase: whisper-tiny (4 + 4 layers, d 384, 6 heads of 64, LayerNorm,
# absolute positions, a 1500-frame source; 36.4 M stored weights) and
# llama-3.2-vision-11b (40 dense layers and 8 gated cross blocks, d 4096, GQA
# 32/8, 1600 image tokens; 11.5 B) at full width and depth, served from
# MXFP4 self- and cross-KV planes of PAGE_SIZE pages on N_SLOTS slots:
# CROSS_PROMPTS (whole [1, CROSS_CHUNK] chunks: no [1, 1] remainders), CROSS_NEW
# new each, request i's conditioning drawn from SEED + i; a second wave of the
# same prompts and sources under the prefix cache encodes nothing; the
# statepool (dense planes) vs dense_slots oracle at full depth for whisper and
# CROSS_ORACLE_LAYERS (2 super-blocks, the whole 1600-token cross plane) for
# the VLM, CROSS_ORACLE_NEW new each.  The VLM's gates are set to VLM_GATES
# (attention, MLP) in every cross block: at their initial 0 the cross path
# adds nothing to the logits.
WHISPER_ARCH, VLM_ARCH = "whisper-tiny", "llama-3.2-vision-11b"
CROSS_PROMPTS, CROSS_NEW, CROSS_CHUNK = (64, 128, 64, 128), 16, 64
CROSS_ORACLE_LAYERS, CROSS_ORACLE_NEW = 10, 8
VLM_GATES = (0.5, -0.3)
# first-token log-probs against the teacher-forced forward: the dense
# engine's gate (max |Δ|, mean |Δ|)
CROSS_LOGPROB_MAX, CROSS_LOGPROB_MEAN = 5.0, 1.0

# the state-train phase: Quartet training of the SSM, hybrid, enc-dec and VLM
# families at their published widths, STATE_TRAIN_STEPS steps of
# STATE_TRAIN_BATCH x TRAIN_SEQ tokens; by arch: (layers, None for full depth;
# microbatches; the 8-bit AdamW with a bf16 master).  whisper-tiny at full
# depth; falcon-mamba-7b at 4 of 64 layers (687,591,424 parameters, ~11 GB as
# f32 master, gradients and two moments; Mamba1's a, bx and h take 268 MB a
# sequence each, so one layer's backward under remat holds ~1 GB a sequence:
# the 8 sequences fit one microbatch); zamba2-7b at 12 of 81 (two groups, so
# the shared block is applied twice; 1,370,644,416, ~22 GB);
# llama-3.2-vision-11b at one super-block, 5 dense layers and a cross block
# (2,359,349,250: an f32 AdamW step holds about eight f32 copies of them at
# once, ~75 GB of the card's 80, so the 8-bit AdamW and a bf16 master, as the
# moe-train phase trains)
STATE_TRAIN_STEPS, STATE_TRAIN_BATCH = 3, 8
STATE_TRAIN = {"whisper-tiny": (None, 1, False), "falcon-mamba-7b": (4, 1, False),
               "zamba2-7b": (12, 1, False), "llama-3.2-vision-11b": (5, 1, True)}
STATE_TRAIN_PATH = {"whisper-tiny": "whisper_train", "falcon-mamba-7b": "falcon_mamba_train",
                    "zamba2-7b": "zamba2_train", "llama-3.2-vision-11b": "vlm_train"}

# the telemetry phase: pool health sampled every TEL_QUANT_STRIDE ticks, the
# first TEL_HEALTH_CHECKS samples of each run checked card against host;
# falcon-mamba-7b at full width, TEL_SSM_LAYERS of its 64 layers,
# TEL_SSM_REQUESTS of the ssm phase's prompts, TEL_SSM_NEW new each
TEL_QUANT_STRIDE, TEL_HEALTH_CHECKS = 4, 2
# telemetry off and at its defaults timed in TEL_AB_ROUNDS rounds of (off,
# defaults, defaults, off)
TEL_AB_ROUNDS = 2
TEL_SSM_LAYERS, TEL_SSM_REQUESTS, TEL_SSM_NEW = 4, 4, 16

# the baselines phase: each baseline method on one full-width llama-paper-200m
# linear of BASELINE_ROWS tokens (4 x 512), card against CPU; each training
# the model at full width and depth VARIANT_STEPS steps of VARIANT_BATCH x
# TRAIN_SEQ tokens (plain path); Quartet on the kernels with the gradient
# compression as the train phase trains it
BASELINE_ROWS = VARIANT_BATCH * TRAIN_SEQ


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def sass_counts(path: str, key: str) -> dict[str, int]:
    """Static SASS instruction count of each entry of the built library at
    ``path`` whose (mangled) name contains ``key`` (``cuobjdump -sass``);
    empty where the toolkit has no cuobjdump."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return {}
    out = subprocess.run([tool, "-sass", path], capture_output=True, text=True,
                         timeout=120).stdout
    counts, name = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1) if key in m.group(1) else None
            if name:
                counts[name] = 0
        elif name and re.match(r"\s+/\*[0-9a-f]{4,}\*/", line):
            counts[name] += 1
    return counts


def entry_resources(report: str, key: str) -> dict[str, dict[str, int]]:
    """Registers, stack frame and spill bytes of each entry whose (mangled)
    name contains ``key``, from an ``-Xptxas -v`` report."""
    import re

    out, name = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1) if key in m.group(1) else None
            if name:
                out[name] = {}
        elif name and "stack frame" in line:
            st, ss, sl = (int(x) for x in re.findall(r"(\d+) bytes", line)[:3])
            out[name].update(stack=st, spill_stores=ss, spill_loads=sl)
        elif name and "registers" in line:
            out[name]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
    return out


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


class Timer:
    """Median CUDA-event time of a callable, with the 50 MB L2 flushed before
    every timed call (the serving path streams 3.4 GB of weights per step,
    so it never finds its operands in L2)."""

    def __init__(self, torch, reps: int = 15):
        self.torch, self.reps = torch, reps
        self.flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn) -> float:
        torch = self.torch
        fn()
        times = []
        for _ in range(self.reps):
            self.flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        times.sort()
        return times[len(times) // 2]

    def device(self, fn) -> float:
        """Device time of ``fn``'s launches without the host between them:
        ``fn`` captured once in a CUDA graph (after a warm-up call, so that
        one-time set-up stays outside), the graph's replay timed as above."""
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()
        return self(graph.replay)


# ---------------------------------------------------------------------------
# shapes of the serving path
# ---------------------------------------------------------------------------


def linear_shapes(cfg):
    """(name, K, N) of the 7 Quartet linears of one layer."""
    d, hd = cfg.d_model, cfg.head_dim_
    return [("q", d, cfg.num_heads * hd), ("k", d, cfg.num_kv_heads * hd),
            ("v", d, cfg.num_kv_heads * hd), ("o", cfg.num_heads * hd, d),
            ("gate", d, cfg.d_ff), ("up", d, cfg.d_ff), ("down", cfg.d_ff, d)]


def make_pool(torch, cfg, lengths, packed: bool, dtype, gen, device, n_pp: int):
    """One layer's pool with every slot's first ``lengths[b]`` positions
    written through the port's quantize-on-write, plus its page tables."""
    from repro_torch.kernels.paged_attention import quant_block, scatter_token

    B, Hkv, hd = len(lengths), cfg.num_kv_heads, cfg.head_dim_
    n_pages = 1 + B * n_pp
    if packed:
        nb = hd // quant_block(hd)
        pool = {n: torch.zeros(s, dtype=torch.uint8, device=device) for n, s in (
            ("k_codes", (n_pages, PAGE_SIZE, Hkv, hd // 2)),
            ("k_scales", (n_pages, PAGE_SIZE, Hkv, nb)),
            ("v_codes", (n_pages, PAGE_SIZE, Hkv, hd // 2)),
            ("v_scales", (n_pages, PAGE_SIZE, Hkv, nb)))}
    else:
        pool = {n: torch.zeros((n_pages, PAGE_SIZE, Hkv, hd), dtype=dtype, device=device)
                for n in ("k", "v")}
    tables = torch.zeros((B, n_pp), dtype=torch.int32, device=device)
    nxt = 1
    for b, n in enumerate(lengths):
        for p in range(-(-n // PAGE_SIZE)):
            tables[b, p] = nxt
            nxt += 1
    for b, n in enumerate(lengths):
        t = torch.arange(n, device=device)
        k = torch.randn((n, Hkv, hd), generator=gen, device=device) * 1.5
        v = torch.randn((n, Hkv, hd), generator=gen, device=device) * 1.5
        scatter_token(pool, tables[b, t // PAGE_SIZE], t % PAGE_SIZE, k.to(dtype), v.to(dtype))
    return pool, tables


def attention_bytes_ops(cfg, lengths, S: int, packed: bool, q_bytes: int):
    """Least bytes and operations of paged attention for this run's data:
    q read and out written once, each slot's visible KV read once."""
    Hq, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    kv_tok = Hkv * (hd // 2 + hd // 32) if packed else Hkv * hd * q_bytes
    nbytes = 2 * len(lengths) * S * Hq * hd * q_bytes
    ops = 0
    for n in lengths:
        nbytes += 2 * kv_tok * (n + S - 1) + 4 * (-(-(n + S - 1) // PAGE_SIZE))
        ops += sum(4 * Hq * hd * (n + s) for s in range(S))
    return nbytes, ops


# ---------------------------------------------------------------------------
# phase 2: kernels vs plain
# ---------------------------------------------------------------------------


def e8m0_edge_rows(torch, gen, device):
    """Rows whose first group is one nonzero v: after the Hadamard every
    element is ±fl(v/√32), so c*·rms/6 lands within a few ulps of √2·2^k —
    the rounding edge of the E8M0-nearest scale — for k in [-30, 30]."""
    import numpy as np

    from repro_torch.kernels.hadamard_quant import _H_SCALE, _clip_c

    vs = []
    for k in range(-30, 31):
        v0 = np.float32(np.sqrt(2.0) * 2.0**k * 6.0 / _clip_c() / _H_SCALE)
        bits = v0.view(np.int32)
        vs.extend((bits + np.arange(-6, 7, dtype=np.int32)).view(np.float32).tolist())
    x = torch.zeros((len(vs), 64), dtype=torch.float32, device=device)
    x[:, 0] = torch.tensor(vs, dtype=torch.float32, device=device)
    x[:, 32:] = torch.randn((len(vs), 32), generator=gen, device=device)
    return x


def check_kernels(torch, cfg, device="cuda"):
    """Every kernel against its plain version at the serving path's shapes;
    raises on a mismatch.  Returns {kernel: max abs error}."""
    from repro_torch.kernels import hadamard_quant as HQ
    from repro_torch.kernels import mxfp4_matmul as MM
    from repro_torch.kernels import paged_attention as PA

    gen = torch.Generator(device=device).manual_seed(SEED)
    err = {}

    # hadamard_quest_quantize: bit-exact (codes, scales, mask) on activations
    # at decode and prefill-chunk rows, on every weight's Wᵀ view, and on the
    # E8M0 edge sweep
    cases = [("edge", e8m0_edge_rows(torch, gen, device))]
    for m in (N_SLOTS, N_SLOTS * PREFILL_CHUNK):
        for K in (cfg.d_model, cfg.d_ff):
            cases.append((f"x[{m},{K}]", torch.randn((m, K), generator=gen, device=device)
                          .mul_(1.9).to(torch.bfloat16)))
    for name, K, N in linear_shapes(cfg):
        w = (torch.randn((K, N), generator=gen, device=device) / K**0.5).to(torch.bfloat16)
        cases.append((f"W_{name}ᵀ", w.t()))
    for name, x in cases:
        got = HQ.hadamard_quest_quantize(x)
        want = HQ.hadamard_quest_quantize_plain(x)
        for g, w_, what in zip(got, want, ("codes", "scales", "mask")):
            if not torch.equal(g, w_):
                n = int((g != w_).sum())
                raise AssertionError(f"hadamard_quest_quantize {name}: {what} differ at {n} places")
    err["hadamard_quest_quantize"] = 0.0

    # mxfp4_matmul: A codes from activations, B = the transposed view of Wᵀ
    # codes, exactly as quartet_linear passes them
    worst = 0.0
    for m in (N_SLOTS, N_SLOTS * PREFILL_CHUNK):
        for name, K, N in linear_shapes(cfg):
            x = torch.randn((m, K), generator=gen, device=device).to(torch.bfloat16)
            w = (torch.randn((K, N), generator=gen, device=device) / K**0.5).to(torch.bfloat16)
            ac, as_, _ = HQ.hadamard_quest_quantize(x)
            wc, ws, _ = HQ.hadamard_quest_quantize(w.t())
            got = MM.mxfp4_matmul(ac, as_, wc.t(), ws.t())
            want = MM.mxfp4_matmul_plain(ac, as_, wc.t(), ws.t())
            # the kernel adds the exact per-group integer products in group
            # order, as the plain version does: equal up to rtol 1e-6 / atol
            # 1e-5, the reference's own tolerance, for K up to 6144
            if not torch.allclose(got, want, rtol=1e-6, atol=1e-5):
                raise AssertionError(f"mxfp4_matmul M={m} {name}: max |Δ| "
                                     f"{float((got - want).abs().max())}")
            worst = max(worst, float((got - want).abs().max()))
    err["mxfp4_matmul"] = worst

    # mxfp4_matmul bit for bit at ragged M and N (every tile configuration:
    # decode M <= 16, prefill, training) and at the E8M0 edges
    for m in (8, 100, 1100):
        x = torch.randn((m, cfg.d_model), generator=gen, device=device).to(torch.bfloat16)
        w = (torch.randn((cfg.d_model, 1000), generator=gen, device=device)
             / cfg.d_model**0.5).to(torch.bfloat16)
        ac, as_, _ = HQ.hadamard_quest_quantize(x)
        wc, ws, _ = HQ.hadamard_quest_quantize(w.t())
        cases = [(f"ragged M={m} N=1000", (ac, as_, wc.t(), ws.t()))]
        cases += [(f"E8M0 {name} M={m}", args)
                  for name, args in mxfp4_edge_operands(torch, gen, device, m)]
        for name, args in cases:
            got, want = MM.mxfp4_matmul(*args), MM.mxfp4_matmul_plain(*args)
            if not torch.equal(got, want):
                bad = got != want
                raise AssertionError(f"mxfp4_matmul {name}: differs at {int(bad.sum())} places, "
                                     f"e.g. {got[bad][:4].tolist()} vs {want[bad][:4].tolist()}")

    # paged_attention: both pool kinds, S = 1 (decode) and S = C (prefill
    # chunk), f32 queries (tolerance 2e-5: online vs full softmax, another
    # summation order) and bf16 queries (the engine's type: one bf16
    # rounding step, rtol 2^-7)
    lengths = [640 - 16 * i * 7 for i in range(N_SLOTS)]  # 640 .. 24, ragged
    n_pp = MAX_LEN // PAGE_SIZE + 1
    worst = 0.0
    for packed in (True, False):
        for dtype, rtol, atol in ((torch.float32, 0.0, 2e-5), (torch.bfloat16, 2**-7, 1e-5)):
            for S in (1, PREFILL_CHUNK):
                lens = [max(n - S + 1, 1) for n in lengths]
                pool, tables = make_pool(torch, cfg, [n + S - 1 for n in lens], packed,
                                         dtype, gen, device, n_pp)
                q = torch.randn((N_SLOTS, S, cfg.num_heads, cfg.head_dim_), generator=gen,
                                device=device).to(dtype)
                q = q[:, 0] if S == 1 else q
                ln = torch.tensor(lens, dtype=torch.int32, device=device)
                got = PA.paged_attention(q, pool, tables, ln).float()
                want = PA.paged_attention_plain(q, pool, tables, ln).float()
                bad = (got - want).abs() > atol + rtol * want.abs()
                if bool(bad.any()) or not bool(torch.isfinite(got).all()):
                    raise AssertionError(
                        f"paged_attention packed={packed} {dtype} S={S}: {int(bad.sum())} "
                        f"elements off, max |Δ| {float((got - want).abs().max())}")
                if dtype == torch.float32:
                    worst = max(worst, float((got - want).abs().max()))
    worst = max(worst, check_paged_edges(torch, cfg, gen, device))
    worst = max(worst, check_paged_verify(torch, cfg, gen, device))
    err["paged_attention"] = worst
    torch.cuda.synchronize()
    return err


def check_paged_edges(torch, cfg, gen, device):
    """B5 at the edges of the split over CTAs, both pool kinds, f32 and bf16,
    S = 1 and S = 64: slots of length 1 (one visible key), 16 and 32 (page
    multiples: the last chunk's tail empty), one whose rows pass the end of a
    full table (clamped at n_pp) and long ones; on the packed pool slot 0's
    first page and slot 5's second carry E8M0 scale codes 1 and 2 (2^-126,
    2^-125: subnormal bf16 operands, which the tensor core may flush, far
    below the atol).  Then the same over a table of 32768 positions
    (qwen3-1.7b's published context), where the split's chunk cap gives
    each CTA several sub-blocks.  Raises on a mismatch; returns the f32 max
    |Δ|."""
    from repro_torch.kernels import paged_attention as PA

    worst = 0.0
    tables = ((MAX_LEN // PAGE_SIZE + 1,
               lambda full, S: [1, 16, 32, full - S // 2, 1, 300, full - 16 * 7 - S + 1, 17]),
              (LONG_CONTEXT // PAGE_SIZE,
               lambda full, S: [1, 700, full - S // 2, 9000, 16, 20000, 4096, 33]))
    for n_pp, lengths in tables:
        worst = max(worst, _check_paged_edges_at(torch, PA, cfg, gen, device, n_pp, lengths))
    return worst


def check_paged_verify(torch, cfg, gen, device):
    """B5 at the speculative verify's shape, S = k + 1 query rows a slot
    (R = 2·S at qwen3's group of 2) for k in 1, 4 and 7, over the verify's
    table (MAX_LEN + k positions: 41 pages), at lengths 1, 16 and 32, one
    slot whose last row reads the full table, and others; both pool kinds,
    f32 and bf16, with the tolerances above.  Returns the f32 max |Δ|."""
    from repro_torch.kernels import paged_attention as PA

    n_pp = -(-(MAX_LEN + 7) // PAGE_SIZE)
    return _check_paged_edges_at(
        torch, PA, cfg, gen, device, n_pp,
        lambda full, S: [1, 16, 32, full - S + 1, 1, 300, 17, MAX_LEN - S], S_values=(2, 5, 8))


def _check_paged_edges_at(torch, PA, cfg, gen, device, n_pp, lengths,
                          S_values=(1, PREFILL_CHUNK)):
    full = n_pp * PAGE_SIZE
    worst = 0.0
    for packed in (True, False):
        for dtype, rtol, atol in ((torch.float32, 0.0, 2e-5), (torch.bfloat16, 2**-7, 1e-5)):
            for S in S_values:
                lens = lengths(full, S)
                pool, tables = make_pool(torch, cfg, [min(n + S - 1, full) for n in lens],
                                         packed, dtype, gen, device, n_pp)
                if packed:
                    for b, p in ((0, 0), (5, 1)):
                        page = int(tables[b, p])
                        for name in ("k_scales", "v_scales"):
                            pick = torch.randint(1, 3, pool[name][page].shape, generator=gen,
                                                 device=device, dtype=torch.int32)
                            pool[name][page] = pick.to(torch.uint8)
                q = torch.randn((N_SLOTS, S, cfg.num_heads, cfg.head_dim_), generator=gen,
                                device=device).to(dtype)
                q = q[:, 0] if S == 1 else q
                ln = torch.tensor(lens, dtype=torch.int32, device=device)
                got = PA.paged_attention(q, pool, tables, ln).float()
                want = PA.paged_attention_plain(q, pool, tables, ln).float()
                bad = (got - want).abs() > atol + rtol * want.abs()
                if bool(bad.any()) or not bool(torch.isfinite(got).all()):
                    raise AssertionError(
                        f"paged_attention edges n_pp={n_pp} packed={packed} {dtype} S={S}: "
                        f"{int(bad.sum())} elements off, max |Δ| "
                        f"{float((got - want).abs().max())}")
                if dtype == torch.float32:
                    worst = max(worst, float((got - want).abs().max()))
    return worst


def mxfp4_edge_operands(torch, gen, device, m: int, k: int = 256, n: int = 200):
    """B3 operands [m, k] x [k, n] (B K-major, as the call sites pass it) at
    the E8M0 edges, half-codes from the E2M1 grid.  "low": signed codes and
    scale codes 1, 2 (2^-126, 2^-125) beside 100 and 127, so terms underflow
    to zero or round in f32's subnormal range; "high": codes >= 0 and scale
    codes 253, 254 (2^126, 2^127) beside 1, 2, 120, 127 and 134, so terms
    overflow to +inf (never inf - inf, so no NaN); "fold limits": scale codes
    67 and 177 (2^-60, 2^50), the bounds of the kernel's folded-scale path."""
    grid = torch.tensor([0, 1, 2, 3, 4, 6, 8, 12], dtype=torch.int8, device=device)

    def codes(shape, signed):
        c = grid[torch.randint(0, 8, shape, generator=gen, device=device)]
        if signed:
            c = c * (torch.randint(0, 2, shape, generator=gen, device=device) * 2 - 1).to(torch.int8)
        return c

    def scales(shape, e8m0):
        e = torch.tensor(e8m0, dtype=torch.int32, device=device)
        pick = e[torch.randint(0, len(e8m0), shape, generator=gen, device=device)]
        return (pick << 23).view(torch.float32)  # 2^(code - 127), built from the bits

    out = []
    for name, kk, signed, ea, eb in (
            ("low", k, True, (1, 2, 100, 127), (1, 2, 100, 127)),
            # two groups, so that most outputs stay finite beside the +inf ones
            ("high", 64, False, (253, 254, 127, 127, 120, 1), (1, 2, 127, 127, 134, 254)),
            ("fold limits", k, True, (67, 177, 127), (67, 177, 127))):
        out.append((name, (codes((m, kk), signed), scales((m, kk // 32), ea),
                           codes((n, kk), signed).t(), scales((n, kk // 32), eb).t())))
    return out


def kv_edge_rows(np):
    """Rows of two 32-groups whose first group's absmax/6 lies within ±8 ulps
    of √2·2^k (the E8M0-nearest rounding edge) or exactly at 2^k, for k in
    [-100, 100], plus all-zero rows (f32)."""
    rng = np.random.default_rng(SEED)
    amax = []
    for k in range(-100, 101):
        a0 = np.float32(np.sqrt(2.0) * 2.0**k * 6.0)
        amax.extend((a0.view(np.int32) + np.arange(-8, 9, dtype=np.int32)).view(np.float32))
        amax.append(np.float32(6.0 * 2.0**k))
    amax = np.asarray(amax, np.float32)
    x = np.zeros((amax.size + 8, 64), np.float32)
    x[:amax.size, 1:32] = rng.uniform(-0.9, 0.9, (amax.size, 31)) * amax[:, None]
    x[:amax.size, 0] = amax * np.where(rng.random(amax.size) < 0.5, -1, 1)
    x[:amax.size, 32:] = rng.standard_normal((amax.size, 32))
    return x


def every_pair(torch, shape_codes, shape_scales, shift, device):
    """B4b operands holding every (byte, scale code) pair once in every 4096
    consecutive groups of 16 code bytes: byte f of the flat codes is (f +
    16·shift) mod 256, group g's scale code (g // 16 + shift) mod 256 (0 and
    255, the zero and infinite scales, included)."""
    nc, ns = math.prod(shape_codes), math.prod(shape_scales)
    codes = ((torch.arange(nc, device=device) + 16 * shift) % 256).to(torch.uint8)
    scales = ((torch.arange(ns, device=device) // 16 + shift) % 256).to(torch.uint8)
    return codes.reshape(shape_codes), scales.reshape(shape_scales)


def bit_pattern(torch, x):
    """x's bits as integers of its width (``torch.equal`` is false on NaN)."""
    return x.view({torch.float32: torch.int32, torch.bfloat16: torch.int16}[x.dtype])


def plain_quant_scatter(torch, codes, scales, page_ids, offsets, x):
    """B4a's scatter form from its plain version: quantize the rows, then
    write them with PyTorch indexing (leaves with a leading [L] axis)."""
    from repro_torch.kernels import kv_pack as KV

    L, n, H, K = x.shape
    c, s = KV.kv_quant_pack_plain(x.reshape(-1, K), K // scales.shape[-1])
    pid, off = page_ids.long(), offsets.long()
    codes[:, pid, off] = c.reshape(L, n, H, -1)
    scales[:, pid, off] = s.reshape(L, n, H, -1)


def flash_plain(FA, q, k, v, causal):
    """B6's plain version over [B, S, Hq, hd] x [B, T, Hkv, hd], in the
    kernel's 64-blocks."""
    B, S, Hq, hd = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    o = FA.flash_attention_plain(q.transpose(1, 2).reshape(B * Hq, S, hd),
                                 k.transpose(1, 2).reshape(B * Hkv, T, hd),
                                 v.transpose(1, 2).reshape(B * Hkv, T, hd), causal,
                                 q_heads=Hq, kv_heads=Hkv)
    return o.reshape(B, Hq, S, hd).transpose(1, 2)


def sdpa(torch, q, k, v, causal):
    """One PyTorch call computing B6's function (a yardstick, never on the
    port's path): [B, H, S, hd] operands, GQA by ``enable_gqa``."""
    return torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                            enable_gqa=True)


def flash_shapes(cfg, tcfg):
    """(name, B, S, T, Hq, Hkv, hd, causal, dtype name) of B6's checks: the
    evaluation shape, qwen3-1.7b's GQA at 4096, a ragged f32 case and a
    ragged bf16 case at hd 64 with S != T (the tensor-core body's other
    head size)."""
    return [("eval", EVAL_BATCH, TRAIN_SEQ, TRAIN_SEQ, tcfg.num_heads, tcfg.num_kv_heads,
             tcfg.head_dim_, True, "bfloat16"),
            ("gqa4096", 1, 4096, 4096, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_, True,
             "bfloat16"),
            ("f32_1000", 2, 1000, 1000, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_, False,
             "float32"),
            ("hd64_700x1000", 2, 700, 1000, 4, 2, 64, False, "bfloat16")]


def check_gather_dequant(torch, cfg, gen, device="cuda"):
    """B4b against its plain version, bit-exact in f32 and bf16 (compared
    by bit pattern: NaN included); raises on a mismatch.  The gather of a
    full-width decode tick (28 layers, 8 slots x 40 pages of 16), K's leaves
    holding every (byte, scale code) pair, V's random bytes at the scale
    codes of real data; the one-launch K+V form against the one-leaf form and
    the plain version, also over ragged tables (the scratch page 0, a page
    read twice, P = 1); the 2-d form over every pair, with a short last
    chunk, with rows longer than a tile, and over a whole pool's rows."""
    from repro_torch.kernels import kv_pack as KV

    Hkv, hd, L = cfg.num_kv_heads, cfg.head_dim_, cfg.num_layers
    n_pages = 1 + N_SLOTS * (MAX_LEN // PAGE_SIZE)
    leaves = list(every_pair(torch, (L, n_pages, PAGE_SIZE, Hkv, hd // 2),
                             (L, n_pages, PAGE_SIZE, Hkv, hd // 32), 0, device))
    leaves.append(torch.randint(0, 256, (L, n_pages, PAGE_SIZE, Hkv, hd // 2), generator=gen,
                                device=device, dtype=torch.uint8))
    leaves.append(torch.randint(100, 155, (L, n_pages, PAGE_SIZE, Hkv, hd // 32), generator=gen,
                                device=device, dtype=torch.uint8))
    tick = (1 + torch.randperm(n_pages - 1, generator=gen, device=device)
            ).to(torch.int32).reshape(N_SLOTS, -1)
    ragged = torch.tensor([[7, 1, 0, 0, 0], [n_pages - 1, 3, 3, 9, 0], [2, 0, 0, 0, 0]],
                          dtype=torch.int32, device=device)
    for tables in (tick, ragged, ragged[:, :1].contiguous()):
        idx = tables.long()
        for dt in (torch.float32, torch.bfloat16):
            before = KV.kv_dequant_unpack.launches
            got = KV.kv_gather_dequant_kv(*leaves, tables, dt)
            if KV.kv_dequant_unpack.launches - before != 1:
                raise AssertionError("kv_gather_dequant_kv: not one launch for K and V")
            for name, g, (c, sc) in (("K", got[0], leaves[:2]), ("V", got[1], leaves[2:])):
                want = KV.kv_dequant_unpack_plain(c[:, idx], sc[:, idx], dt).reshape(g.shape)
                one = KV.kv_gather_dequant(c, sc, tables, dt)
                for what, x in (("kv_gather_dequant_kv", g), ("kv_gather_dequant", one)):
                    if not torch.equal(bit_pattern(torch, x), bit_pattern(torch, want)):
                        raise AssertionError(
                            f"{what} {name} {dt} tables {tuple(tables.shape)}: differ at "
                            f"{int((bit_pattern(torch, x) != bit_pattern(torch, want)).sum())} "
                            f"places")
                del want, one
            del got
    del leaves
    for m, kh in ((4096, 256), (1000, 48), (5, 2 * KV.TILE + 64),
                  (L * n_pages * PAGE_SIZE * Hkv, hd // 2)):
        flat_c, flat_s = every_pair(torch, (m, kh), (m, kh // 16), 5, device)
        for dt in (torch.float32, torch.bfloat16):
            got = KV.kv_dequant_unpack(flat_c, flat_s, dt)
            want = KV.kv_dequant_unpack_plain(flat_c, flat_s, dt)
            if not torch.equal(bit_pattern(torch, got), bit_pattern(torch, want)):
                raise AssertionError(f"kv_dequant_unpack [{m}, {kh}] {dt}: differs from its "
                                     f"plain version")


def check_kv_and_flash(torch, cfg, tcfg, device="cuda"):
    """B4a, B4b and B6 against their plain versions on the card; raises on a
    mismatch.  Returns {kernel: max abs error}."""
    import numpy as np

    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import kv_pack as KV

    gen = torch.Generator(device=device).manual_seed(SEED + 4)
    Hkv, hd, L = cfg.num_kv_heads, cfg.head_dim_, cfg.num_layers
    err = {}

    # B4a, bit-exact: the 2-d form on a [4096, 1024] block and the E8M0 edge
    # sweep; the one-launch K+V scatter at a decode write (8 tokens) and a
    # prefill write (8 x 64 tokens) of the engine, one layer's leaves (as
    # scatter_token passes them) and all layers' (as scatter_tokens does), K
    # a strided slice of a dense cache (as the gather backend passes it), V
    # holding the E8M0 edge rows; the one-leaf form at a decode write
    edge = torch.from_numpy(kv_edge_rows(np)).to(device)
    blocks = [("x[4096,1024] bf16", torch.randn((4096, 1024), generator=gen, device=device)
               .mul_(1.7).to(torch.bfloat16)), ("edge sweep f32", edge)]
    for name, x in blocks:
        for g, w_, what in zip(KV.kv_quant_pack(x), KV.kv_quant_pack_plain(x), ("codes", "scales")):
            if not torch.equal(g, w_):
                raise AssertionError(f"kv_quant_pack {name}: {what} differ at "
                                     f"{int((g != w_).sum())} places")
    n_pages = 1 + N_SLOTS * (MAX_LEN // PAGE_SIZE)
    edge = edge.reshape(-1, hd).to(torch.bfloat16)
    for n_tok, layers in ((N_SLOTS, 1), (N_SLOTS * PREFILL_CHUNK, 1), (N_SLOTS, L),
                          (N_SLOTS * PREFILL_CHUNK, L)):
        shape = (layers, n_pages, PAGE_SIZE, Hkv)
        pools = [[torch.zeros((*shape, w), dtype=torch.uint8, device=device)
                  for w in (hd // 2, hd // 32, hd // 2, hd // 32)] for _ in range(2)]
        perm = torch.randperm((n_pages - 1) * PAGE_SIZE, generator=gen, device=device)[:n_tok]
        pid = (1 + perm // PAGE_SIZE).to(torch.int32)
        off = (perm % PAGE_SIZE).to(torch.int32)
        cache = (torch.randn((layers, 2, n_tok + 5, Hkv, hd), generator=gen, device=device)
                 * 1.5).to(torch.bfloat16)
        k = cache[:, 1, 3:3 + n_tok]
        v = (torch.randn((layers, n_tok, Hkv, hd), generator=gen, device=device) * 1.5
             ).to(torch.bfloat16)
        rows = min(edge.shape[0], v.numel() // hd)
        v.view(-1, hd)[:rows] = edge[:rows]
        if layers == 1:
            KV.kv_quant_scatter_kv(*(t[0] for t in pools[0]), pid, off, k[0], v[0])
        else:
            KV.kv_quant_scatter_kv(*pools[0], pid, off, k, v)
        plain_quant_scatter(torch, pools[1][0], pools[1][1], pid, off, k)
        plain_quant_scatter(torch, pools[1][2], pools[1][3], pid, off, v)
        if n_tok == N_SLOTS and layers == 1:
            one = [torch.zeros_like(t) for t in pools[0][:2]]
            KV.kv_quant_scatter(one[0][0], one[1][0], pid, off, v[0])
            pools[0] += one
            pools[1] += pools[1][2:]
        for g, w_, what in zip(pools[0], pools[1], ("K codes", "K scales", "V codes", "V scales",
                                                    "codes (one leaf)", "scales (one leaf)")):
            if not torch.equal(g, w_):
                raise AssertionError(f"kv_quant_scatter_kv {n_tok} tokens x {layers} layers: "
                                     f"{what} differ at {int((g != w_).sum())} places")
    err["kv_quant_pack"] = 0.0

    check_gather_dequant(torch, cfg, gen, device)
    err["kv_dequant_unpack"] = 0.0

    # B6: f32 to atol 2e-5 (another summation order and expf); bf16 to one
    # bf16 rounding step, |Δ| <= 1e-5 + 2^-7·|plain|.  SDPA is a second
    # reading only.
    worst, readings = 0.0, {}
    for name, B, S, T, hq, hkv, d, causal, dtn in flash_shapes(cfg, tcfg):
        dt = getattr(torch, dtn)
        q = torch.randn((B, S, hq, d), generator=gen, device=device).to(dt)
        k, v = (torch.randn((B, T, hkv, d), generator=gen, device=device).to(dt)
                for _ in range(2))
        got = FA.mha_flash(q, k, v, causal=causal).float()
        want = flash_plain(FA, q, k, v, causal).float()
        rtol, atol = (0.0, 2e-5) if dt == torch.float32 else (2**-7, 1e-5)
        diff = (got - want).abs()
        bad = diff > atol + rtol * want.abs()
        if bool(bad.any()) or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"flash_attention {name}: {int(bad.sum())} elements off, "
                                 f"max |Δ| {float(diff.max())}")
        lib = sdpa(torch, q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                   causal).transpose(1, 2).float()
        readings[name] = {"max_abs_vs_plain": float(diff.max()),
                          "max_abs_vs_sdpa": float((got - lib).abs().max())}
        worst = max(worst, float(diff.max()))
        del q, k, v, got, want, lib
    log(f"  flash_attention vs plain and vs SDPA (second reading): {json.dumps(readings)}")
    err["flash_attention"] = worst
    torch.cuda.synchronize()
    return err


# ---------------------------------------------------------------------------
# phase 3: the engine
# ---------------------------------------------------------------------------


def _count_step_calls(eng, attr: str = "_steps") -> dict:
    """Count the engine's step calls by kind (decode_all, prefill_all,
    prefill_chunk) by wrapping its steps (``attr``: the paged steps, or the
    state pool's ``_state_steps``)."""
    calls = {}

    def wrap(name, fn):
        @functools.wraps(fn)  # keeps a Step's shape signatures readable
        def counted(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **k)
        return counted

    steps = getattr(eng, attr)
    setattr(eng, attr, steps._replace(**{n: wrap(n, f) for n, f in steps._asdict().items()
                                         if f is not None}))
    return calls


def gather_schedule(prompt_lens, max_new: int, chunk: int) -> tuple[int, int]:
    """(prefill calls, decode ticks) of the gather engine when every request
    is admitted at the first step: each tick a prefilling slot runs one
    [1, chunk] call, or all of its remaining tokens as [1, 1] calls and then
    takes its first token; every tick with a decoding slot is one decode
    call, which gives each decoding slot one token."""
    pos, made = [0] * len(prompt_lens), [0] * len(prompt_lens)
    calls = ticks = 0
    while any(m < max_new for m in made):
        for i, n in enumerate(prompt_lens):
            if pos[i] < n:
                step = chunk if n - pos[i] >= chunk else n - pos[i]
                calls += 1 if step == chunk else step
                pos[i] += step
                if pos[i] == n:
                    made[i] = 1
        decoding = [i for i, n in enumerate(prompt_lens) if pos[i] == n and 0 < made[i] < max_new]
        ticks += bool(decoding)
        for i in decoding:
            made[i] += 1
    return calls, ticks


def serve_full_width(torch, ops, device="cuda", arch="qwen3-1.7b", tf_gate=False):
    """8 requests on full-width, full-depth ``arch`` (qwen3-1.7b; the
    dense-configs phase: starcoder2-3b) through the engine (paged backend),
    then the first GATHER_REQUESTS of them on the gather backend.  With
    ``tf_gate`` each backend's first-token log-probs are also held against
    the teacher-forced forward at the gather-vs-paged bounds.  Returns
    (summary, launch counts of the paged run, gather summary, launch counts
    of the gather run)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.convert import init_params
    from repro_torch.launch.serve_engine import kernel_config
    from repro_torch.models import build_model
    from repro_torch.serve import Engine, EngineConfig

    cfg = kernel_config(get_config(arch))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()  # the engine's own peak, not the checks'
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=device).manual_seed(SEED), device)
    torch.cuda.synchronize()
    log(f"  init: {sum(p.numel() for p in _leaves(params)) / 1e9:.3f} B params "
        f"in {time.perf_counter() - t0:.1f} s")
    model = build_model(cfg)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(MIN_PROMPT, MAX_PROMPT + 1)))
               .astype(np.int32) for _ in range(N_REQUESTS)]

    def run(keep_logits: bool, backend: str = "paged", prompts=prompts, max_new=MAX_NEW):
        eng = Engine(model, params, EngineConfig(
            n_slots=N_SLOTS, max_len=MAX_LEN, page_size=PAGE_SIZE, kv_dtype="mxfp4",
            prefill_chunk=PREFILL_CHUNK, keep_logits=keep_logits, decode_backend=backend))
        calls = _count_step_calls(eng)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reqs = [eng.submit(p, max_new, arrival_time=0.0) for p in prompts]
        first, ticks = {}, {"prefill": [], "decode": []}
        while eng.sched.pending:
            kind = "prefill" if eng.sched.queue or eng.sched.prefilling() else "decode"
            s0 = time.perf_counter()
            eng.step(now=s0 - t0)
            ticks[kind].append(time.perf_counter() - s0)  # ends in a host read
            for r in reqs:
                if r.tokens and r.rid not in first:
                    first[r.rid] = time.perf_counter() - t0
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for r in reqs:
            if len(r.tokens) != max_new or r.finish_reason != "max_tokens":
                raise AssertionError(f"{backend} request {r.rid} finished with "
                                     f"{len(r.tokens)} tokens ({r.finish_reason!r})")
            for row in r.logits_trace:
                if row.shape != (cfg.vocab_size,) or not np.isfinite(row).all():
                    raise AssertionError(f"{backend} request {r.rid}: non-finite or "
                                         f"misshapen logits")
            if not all(0 <= t < cfg.vocab_size for t in r.tokens):
                raise AssertionError(f"{backend} request {r.rid}: token out of range")
        return eng, reqs, wall, first, ticks, calls

    L = cfg.num_layers
    lin = 4 + (3 if cfg.mlp == "swiglu" else 2)  # quantized linears a layer
    run(False)  # warm-up: first-use costs (allocator, library handles)
    ops.reset_launch_counts()
    eng, reqs, wall, _, _, calls = run(True)
    counts = ops.launch_counts()
    vec = ops.vector_launches()
    # per forward (one step call): 2 B1 and 1 B3 in each of the lin (7 with
    # SwiGLU, 6 with GELU) quantized linears of a layer (the lm-head stays
    # bf16), 1 B5 and 1 B4a (K and V in one launch) per layer
    n = sum(calls.values())
    predicted = {"hadamard_quest_quantize": 2 * lin * L * n, "mxfp4_matmul": lin * L * n,
                 "paged_attention": L * n, "kv_quant_pack": L * n}
    predicted = {k: predicted.get(k, 0) for k in counts}
    log(f"  main-path run: {len(reqs)} requests x {MAX_NEW} tokens, prompts "
        f"{[int(p.size) for p in prompts]}, {eng.steps} steps, step calls {calls}, "
        f"{wall:.3f} s (logits copied to the host for the checks)")
    if counts != predicted:
        raise AssertionError(f"paged run launches {counts} != predicted {predicted}")
    paged_reqs = reqs
    _, reqs, wall, first, ticks, _ = run(False)
    ttft = sorted(first.values())
    toks = sum(len(r.tokens) for r in reqs)
    summary = {"requests": len(reqs), "tokens": toks, "wall_s": wall,
               "tok_per_s": toks / wall, "ttft_mean_s": float(np.mean(ttft)),
               "ttft_median_s": ttft[len(ttft) // 2], "ttft_max_s": ttft[-1],
               "prefill_ticks": len(ticks["prefill"]),
               "prefill_tick_ms_median": 1e3 * sorted(ticks["prefill"])[len(ticks["prefill"]) // 2],
               "decode_ticks": len(ticks["decode"]),
               "decode_tick_ms_median": 1e3 * sorted(ticks["decode"])[len(ticks["decode"]) // 2],
               "step_calls": calls, "predicted_launches": predicted,
               "vector_launches": vec,
               "kv_pool_bytes": eng.cache_bytes(),
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}

    # the gather backend at full width: per-slot prefill ([1, 64] chunks,
    # then [1, 1] remainders), decode over the gathered dense view
    g_prompts = prompts[:GATHER_REQUESTS]
    ops.reset_launch_counts()
    geng, greqs, gwall, gfirst, _, gcalls = run(True, "gather", g_prompts, GATHER_NEW)
    gcounts = ops.launch_counts()
    gvec = ops.vector_launches()
    n_pre, n_dec = gather_schedule([p.size for p in g_prompts], GATHER_NEW, PREFILL_CHUNK)
    if gcalls != {"prefill_chunk": n_pre, "decode_all": n_dec}:
        raise AssertionError(f"gather step calls {gcalls} != predicted "
                             f"{{'prefill_chunk': {n_pre}, 'decode_all': {n_dec}}}")
    # per forward: 2·lin B1 and lin B3 per layer as above; per step call one
    # gather (1 B4b, all layers, K and V) and one scatter (1 B4a, all
    # layers, K and V)
    n = n_pre + n_dec
    gpredicted = {"hadamard_quest_quantize": 2 * lin * L * n, "mxfp4_matmul": lin * L * n,
                  "kv_quant_pack": n, "kv_dequant_unpack": n}
    gpredicted = {k: gpredicted.get(k, 0) for k in gcounts}
    if gcounts != gpredicted:
        raise AssertionError(f"gather run launches {gcounts} != predicted {gpredicted}")
    # first-token log-probs of gather against paged, held to max |Δ| < 5.0
    # and mean |Δ| < 1.0: twice the reference test's bound for an MXFP4 pool
    # against unquantized K/V (2.5, 0.5), because the two backends quantize
    # different K/V and each may sit that far from the unquantized forward.
    # A gather prefill call attends over its own chunk's K/V before
    # quantization and the earlier chunks' after it; the paged one quantizes
    # each chunk before it attends; and the two chunk a prompt differently
    # ([1, 64] + [1, 1] calls vs [8, 64] ticks).  Each backend against the
    # teacher-forced forward of the prompt is printed beside, as a reading.
    def logp(row):
        return torch.log_softmax(torch.as_tensor(row).float().cpu(), -1)

    lp, tf = [], {"paged": [], "gather": []}
    with torch.inference_mode():
        for p, g, p_ in zip(g_prompts, greqs, paged_reqs):
            feats, _ = model.forward(params, torch.from_numpy(p)[None].to(device), 0,
                                     features_only=True)
            ref = logp(model.head(params, feats[:, -1:], 0)[0, 0])
            for name, r in (("paged", p_), ("gather", g)):
                d = (logp(r.logits_trace[0]) - ref).abs()
                tf[name].append((float(d.max()), float(d.mean())))
            d = (logp(g.logits_trace[0]) - logp(p_.logits_trace[0])).abs()
            lp.append((float(d.max()), float(d.mean())))
    agree = [sum(int(x == y) for x, y in zip(g.tokens, p_.tokens[:GATHER_NEW]))
             for g, p_ in zip(greqs, paged_reqs)]
    gttft = sorted(gfirst.values())
    gtoks = sum(len(r.tokens) for r in greqs)
    gsummary = {"requests": len(greqs), "prompts": [int(p.size) for p in g_prompts],
                "tokens": gtoks, "wall_s": gwall, "tok_per_s": gtoks / gwall,
                "ttft_mean_s": float(np.mean(gttft)), "ttft_max_s": gttft[-1],
                "steps": geng.steps, "step_calls": gcalls, "predicted_launches": gpredicted,
                "vector_launches": gvec,
                "first_token_logprob_max_abs_vs_paged": [x for x, _ in lp],
                "first_token_logprob_mean_abs_vs_paged": [y for _, y in lp],
                "first_token_logprob_vs_teacher_forced": tf,
                "tokens_agreeing_with_paged": agree}
    log(f"  gather run: {json.dumps(gsummary)} (logits copied to the host for the checks)")
    if not all(x < 5.0 and y < 1.0 for x, y in lp):
        raise AssertionError(f"gather vs paged first-token log-probs out of tolerance: {lp}")
    if tf_gate and not all(x < 5.0 and y < 1.0 for v in tf.values() for x, y in v):
        raise AssertionError(f"first-token log-probs vs teacher-forced out of tolerance: {tf}")
    summary["arch"] = arch
    del params
    torch.cuda.empty_cache()
    return summary, counts, gsummary, gcounts


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def check_reduced_engine(torch, device="cuda"):
    """The repo's token oracle at a small size on the card: under the bf16
    method with a dense pool the engine's greedy tokens equal the argmax of
    its own teacher-forced forward (f32 model) on the paged backend, and the
    gather backend's tokens equal the paged backend's; with the MXFP4 pool
    and the Quartet kernels its first-token log-probs stay within the
    reference test's bound of the teacher-forced ones."""
    import numpy as np

    from repro_torch.configs import get_reduced_config
    from repro_torch.convert import init_params
    from repro_torch.launch.serve_engine import kernel_config
    from repro_torch.models import build_model
    from repro_torch.serve import Engine, EngineConfig

    cfg = kernel_config(get_reduced_config("qwen3-1.7b", dtype="float32"))
    model = build_model(cfg)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(SEED), device)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (7, 19, 33)]
    tokens = {}
    for kv, method, backend in (("dense", "bf16", "paged"), ("dense", "bf16", "gather"),
                                ("mxfp4", "quartet", "paged")):
        eng = Engine(model, params, EngineConfig(n_slots=2, max_len=48, page_size=8,
                                                 kv_dtype=kv, prefill_chunk=8,
                                                 method=method, keep_logits=True,
                                                 decode_backend=backend))
        reqs = [eng.submit(p, 6) for p in prompts]
        eng.drain()
        tokens[backend, kv] = [r.tokens for r in reqs]
        for p, r in zip(prompts, reqs):
            seq = torch.tensor(np.concatenate([p, r.tokens[:-1]])[None], device=device)
            tf, _ = model.forward(params, seq, 0, method=method)
            tf = tf[0, p.size - 1:].float().cpu()
            if kv == "dense":
                if r.tokens != tf.argmax(-1).tolist():
                    raise AssertionError(f"reduced engine tokens {r.tokens} != "
                                         f"teacher-forced argmax {tf.argmax(-1).tolist()}")
            else:
                d = (torch.log_softmax(tf[0], -1)
                     - torch.log_softmax(torch.from_numpy(r.logits_trace[0]), -1)).abs()
                if float(d.max()) >= 2.5 or float(d.mean()) >= 0.5:
                    raise AssertionError(f"mxfp4 engine log-probs off by max {float(d.max())}")
    if tokens["gather", "dense"] != tokens["paged", "dense"]:
        raise AssertionError(f"reduced engine: gather tokens {tokens['gather', 'dense']} != "
                             f"paged tokens {tokens['paged', 'dense']}")
    log("  reduced engine: dense/bf16 tokens == teacher-forced argmax on both backends "
        "(gather == paged); mxfp4/quartet first-token log-probs within bound")


# ---------------------------------------------------------------------------
# phase 3b: the engine's features (sampling, speculation, prefix cache)
# ---------------------------------------------------------------------------


def run_engine(torch, model, params, waves, *, spec=None, prefix=False, keep_logits=False,
               max_new=MAX_NEW):
    """The full-width engine (paged backend, MXFP4 pool) over ``waves`` of
    (prompt, SamplingParams | None), each wave submitted at once and drained
    before the next.  Step calls are counted by kind (the draft proposer's
    apart), and each tick's host time by kind (a tick with a queued or
    prefilling request counts as prefill); every request must end with
    ``max_new`` tokens in range and
    finite logits.  With ``prefix`` the allocator audits itself after every
    mutation and the pool is audited again after every tick."""
    import numpy as np

    from repro_torch.serve import Engine, EngineConfig

    eng = Engine(model, params, EngineConfig(
        n_slots=N_SLOTS, max_len=MAX_LEN, page_size=PAGE_SIZE, kv_dtype="mxfp4",
        prefill_chunk=PREFILL_CHUNK, keep_logits=keep_logits, spec=spec, prefix_cache=prefix,
        debug_cache=prefix))
    calls = _count_step_calls(eng)
    draft_calls = _count_step_calls(eng.proposer) if hasattr(eng.proposer, "_steps") else {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs, ttft, ticks = [], {}, {"prefill": [], "decode": []}
    for wave in waves:
        w0 = time.perf_counter()
        wreqs = [eng.submit(p, max_new, arrival_time=w0 - t0, sampling=sp) for p, sp in wave]
        reqs += wreqs
        while eng.sched.pending:
            kind = "prefill" if eng.sched.queue or eng.sched.prefilling() else "decode"
            s0 = time.perf_counter()
            eng.step(now=s0 - t0)
            ticks[kind].append(time.perf_counter() - s0)  # each tick ends in a host read
            if prefix:
                eng.cache.check_invariants()
            for r in wreqs:
                if r.tokens and r.rid not in ttft:
                    ttft[r.rid] = time.perf_counter() - w0
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    V = model.cfg.vocab_size
    for r in reqs:
        if len(r.tokens) != max_new or r.finish_reason != "max_tokens":
            raise AssertionError(f"request {r.rid} finished with {len(r.tokens)} tokens "
                                 f"({r.finish_reason!r})")
        if not all(0 <= t < V for t in r.tokens):
            raise AssertionError(f"request {r.rid}: token out of range")
        for row in r.logits_trace:
            if row.shape != (V,) or not np.isfinite(row).all():
                raise AssertionError(f"request {r.rid}: non-finite or misshapen logits")
    toks = sum(len(r.tokens) for r in reqs)
    return {"eng": eng, "reqs": reqs, "wall": wall, "ttft": ttft, "calls": calls,
            "draft_calls": draft_calls, "tok_per_s": toks / wall, "ticks": ticks}


PREFIX_COUNTERS = ("prefix_lookups", "prefix_hit_requests", "prefix_shared_tokens",
                   "prefix_inserted_pages", "prefix_evicted_pages", "prefix_cow_pages")


def _engine_counts(eng, names) -> dict:
    """The named counters of the engine's telemetry registry."""
    return {n: eng.telemetry.registry.counter(n).value for n in names}


def _first_divergence(a: list, b: list):
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)


def _logprob_diff(torch, rows_a, rows_b) -> tuple[float, float]:
    import numpy as np

    a = torch.log_softmax(torch.as_tensor(np.stack(rows_a)).float(), -1)
    b = torch.log_softmax(torch.as_tensor(np.stack(rows_b)).float(), -1)
    d = (a - b).abs()
    return float(d.max()), float(d.mean())


def _teacher_forced_rows(torch, model, params, req, device="cuda"):
    """Log-prob rows of the model's teacher-forced forward (no cache,
    unquantized K/V) at the positions that produced ``req``'s tokens."""
    import numpy as np

    seq = np.concatenate([req.prompt, np.asarray(req.tokens[:-1], np.int32)])
    with torch.inference_mode():
        feats, _ = model.forward(params, torch.from_numpy(seq)[None].to(device), 0,
                                 features_only=True)
        rows = model.head(params, feats[:, req.prompt_len - 1:], 0)[0]
    return list(rows.float().cpu().numpy())


def serve_features(torch, ops, device="cuda"):
    """Sampled decoding, speculative decoding and the prefix cache on
    full-width, full-depth qwen3-1.7b (the engine phase's 8 requests, paged
    backend, MXFP4 pool).  Returns (summary, launch counts by path, vector-body
    launches by path)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.convert import init_params
    from repro_torch.launch.serve_engine import kernel_config
    from repro_torch.models import build_model
    from repro_torch.serve import SamplingParams, SpecConfig
    from repro_torch.serve.sampling import sample_row
    from repro_torch.serve.spec import aggregate_stats

    cfg = kernel_config(get_config("qwen3-1.7b"))
    params = init_params(cfg, torch.Generator(device=device).manual_seed(SEED), device)
    model = build_model(cfg)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(MIN_PROMPT, MAX_PROMPT + 1)))
               .astype(np.int32) for _ in range(N_REQUESTS)]
    L = cfg.num_layers
    out, counts, vectors = {}, {}, {}

    def check_launches(tag, run):
        """Per forward of the target or the draft (every step call): 14 B1
        and 7 B3 a layer, 1 B5 and 1 B4a a layer, whatever its S."""
        got = ops.launch_counts()
        n = sum(run["calls"].values()) + sum(run["draft_calls"].values())
        want = {"hadamard_quest_quantize": 14 * L * n, "mxfp4_matmul": 7 * L * n,
                "paged_attention": L * n, "kv_quant_pack": L * n}
        want = {k: want.get(k, 0) for k in got}
        if got != want:
            raise AssertionError(f"{tag}: launches {got} != predicted {want} "
                                 f"(step calls {run['calls']}, draft {run['draft_calls']})")
        counts[tag] = got
        vectors[tag] = ops.vector_launches()
        return {"step_calls": run["calls"], "draft_step_calls": run["draft_calls"],
                "launches": got}

    greedy = [[(p, None) for p in prompts]]
    base = run_engine(torch, model, params, greedy, keep_logits=True)
    again = run_engine(torch, model, params, greedy, keep_logits=True)
    out["nonspec_rows_equal_run_to_run"] = [
        all(np.array_equal(x, y) for x, y in zip(r.logits_trace, b.logits_trace))
        for r, b in zip(again["reqs"], base["reqs"])]
    del again

    # 1. sampled decoding, twice: the same streams
    sps = [SamplingParams(**SAMPLING, seed=i) for i in range(N_REQUESTS)]
    sampled = [[(p, sp) for p, sp in zip(prompts, sps)]]
    ops.reset_launch_counts()
    s1 = run_engine(torch, model, params, sampled, keep_logits=True)
    rec = check_launches("sampled", s1)
    s2 = run_engine(torch, model, params, sampled)
    streams = [r.tokens for r in s1["reqs"]]
    if streams != [r.tokens for r in s2["reqs"]]:
        raise AssertionError("sampled streams differ between two runs with the same seeds")
    # the first two requests' tokens drawn again on the host (CPU log, same
    # keys) from their rows
    redraw = sum(int(sample_row(torch.from_numpy(row), sp, 0, t) == tok)
                 for r, sp in zip(s1["reqs"][:2], sps)
                 for t, (row, tok) in enumerate(zip(r.logits_trace, r.tokens)))
    out["sampled"] = {**rec, "tok_per_s": s1["tok_per_s"], "tok_per_s_second_run":
                      s2["tok_per_s"], "streams_equal_across_runs": True,
                      "host_redraw_agrees": f"{redraw}/{2 * MAX_NEW}",
                      "tokens_differing_from_greedy": sum(
                          int(a != b) for r, g in zip(s1["reqs"], base["reqs"])
                          for a, b in zip(r.tokens, g.tokens))}
    log(f"  sampled: {json.dumps(out['sampled'])}")

    # 2. speculative decoding, k = SPEC_K, three proposers (greedy)
    specs = {"self": SpecConfig(k=SPEC_K, proposer="self"),
             "ngram": SpecConfig(k=SPEC_K, proposer="ngram", ngram=2),
             "draft": SpecConfig(k=SPEC_K, proposer="draft", draft_arch="qwen3-1.7b",
                                 draft_reduced=False, draft_seed=SEED)}
    for name, spec in specs.items():
        torch.cuda.empty_cache()
        ops.reset_launch_counts()
        run = run_engine(torch, model, params, greedy, spec=spec, keep_logits=name == "self")
        rec = check_launches(f"spec_{name}", run)
        agg = aggregate_stats(run["reqs"])
        rec.update(tok_per_s=run["tok_per_s"], wall_s=run["wall"],
                   acceptance=agg["acceptance_rate"],
                   tokens_per_verify_call=agg["tokens_per_decode_call"],
                   first_divergence_from_nonspec=[
                       _first_divergence(r.tokens, b.tokens)
                       for r, b in zip(run["reqs"], base["reqs"])])
        if name == "self":
            # every emitted token is the argmax of the logits row (prefill or
            # verify) that produced it
            for r, b in zip(run["reqs"], base["reqs"]):
                picks = [int(np.argmax(row)) for row in r.logits_trace]
                if picks != r.tokens:
                    raise AssertionError(f"self-spec request {r.rid}: emitted tokens are not "
                                         f"the picks of their verify rows")
                # and each of those rows equals, bit for bit, the non-spec
                # run's decode row at the same position (the verify's norms
                # and head round each row as a decode step does)
                same = [np.array_equal(x, y) for x, y in zip(r.logits_trace, b.logits_trace)]
                if not all(same):
                    raise AssertionError(f"self-spec request {r.rid}: verify rows differ from "
                                         f"the decode rows, first at token {same.index(False)}")
            # teacher-forced log-probs (unquantized K/V) against the rows
            # that produced each token: max |Δ| < 5.0, mean < 1.0, the
            # gather-vs-paged bound (an MXFP4 pool against unquantized K/V);
            # the non-spec run's own reading beside
            tf = {}
            for tag, reqs in (("self", run["reqs"]), ("nonspec", base["reqs"])):
                tf[tag] = [_logprob_diff(torch, r.logits_trace,
                                         _teacher_forced_rows(torch, model, params, r, device))
                           for r in reqs]
            rec["teacher_forced_logprob_max_mean"] = tf
            if not all(x < 5.0 and y < 1.0 for x, y in tf["self"]):
                raise AssertionError(f"self-spec log-probs vs teacher-forced out of "
                                     f"tolerance: {tf['self']}")
        out[f"spec_{name}"] = rec
        log(f"  spec {name}: {json.dumps(rec)}")
        # speculation changes the schedule, never a greedy token
        if any(d is not None for d in rec["first_divergence_from_nonspec"]):
            raise AssertionError(f"spec {name}: tokens differ from the non-spec run")
        # the draft proposer with the target's weights: its cache holds the
        # target's bits at every accepted position (the prompt synced in the
        # target's prefill chunks, generated positions through decode steps),
        # so its drafts are the target's own
        if name == "draft" and rec["acceptance"] < 0.95:
            raise AssertionError(f"spec draft (the target's weights): acceptance "
                                 f"{rec['acceptance']} < 0.95")
        del run
    # sampled self-speculation against the sampled non-spec streams
    run = run_engine(torch, model, params, sampled, spec=specs["self"])
    agg = aggregate_stats(run["reqs"])
    out["spec_self_sampled"] = {
        "tok_per_s": run["tok_per_s"], "acceptance": agg["acceptance_rate"],
        "tokens_per_verify_call": agg["tokens_per_decode_call"],
        "equals_sampled_nonspec": [r.tokens == t for r, t in zip(run["reqs"], streams)],
        "first_divergence": [_first_divergence(r.tokens, t)
                             for r, t in zip(run["reqs"], streams)]}
    log(f"  spec self, sampled: {json.dumps(out['spec_self_sampled'])}")
    if not all(out["spec_self_sampled"]["equals_sampled_nonspec"]):
        raise AssertionError("sampled self-speculation differs from the sampled stream")

    # 3. the prefix cache: 8 prompts sharing a 256-token prefix (16 full
    # pages), tails of 64-200 tokens; request 0 alone first, then the 7
    # others at once
    rng = np.random.default_rng(SEED)
    shared = rng.integers(0, cfg.vocab_size, PREFIX_TOKENS).astype(np.int32)
    pprompts = [np.concatenate([shared, rng.integers(0, cfg.vocab_size, int(
        rng.integers(MIN_TAIL, MAX_TAIL + 1))).astype(np.int32)]) for _ in range(N_REQUESTS)]
    waves = [[(pprompts[0], None)], [(p, None) for p in pprompts[1:]]]
    ops.reset_launch_counts()
    cold = run_engine(torch, model, params, waves, keep_logits=True)
    check_launches("prefix_cold", cold)
    ops.reset_launch_counts()
    warm = run_engine(torch, model, params, waves, prefix=True, keep_logits=True)
    check_launches("prefix_warm", warm)
    # the schedule's counts: 8 lookups, 7 hits of the 16 prefix pages (no
    # full-prompt hit, so no copy-on-write), no eviction (the pool holds
    # 320 pages); request 0 publishes every full page of its prompt and
    # consumed tokens, each other request those past the prefix
    pages = [(p.size + MAX_NEW - 1) // PAGE_SIZE for p in pprompts]
    want = {"prefix_lookups": N_REQUESTS, "prefix_hit_requests": N_REQUESTS - 1,
            "prefix_shared_tokens": (N_REQUESTS - 1) * PREFIX_TOKENS,
            "prefix_inserted_pages": pages[0] + sum(n - PREFIX_TOKENS // PAGE_SIZE
                                                    for n in pages[1:]),
            "prefix_evicted_pages": 0, "prefix_cow_pages": 0, "spec_acceptance_rate": 0}
    prefix_counts = {**_engine_counts(warm["eng"], PREFIX_COUNTERS),
                     "spec_acceptance_rate": warm["eng"].telemetry.registry.gauge(
                         "spec_acceptance_rate").value}
    if prefix_counts != want:
        raise AssertionError(f"prefix counts {prefix_counts} != predicted {want}")
    # warm against cold: the same tokens (the CPU twin is token-exact on the
    # paged backend), and first-token log-probs predicted equal (each row's
    # arithmetic does not depend on the other rows of its call, and the
    # warm tail starts at a chunk boundary of the cold run); held to 1e-3
    lp = [_logprob_diff(torch, w.logits_trace[:1], c.logits_trace[:1])
          for w, c in zip(warm["reqs"], cold["reqs"])]
    ttft = {tag: float(np.mean([run["ttft"][r.rid] for r in run["reqs"][1:]]))
            for tag, run in (("cold", cold), ("warm", warm))}
    out["prefix"] = {"prompts": [int(p.size) for p in pprompts], "counts": prefix_counts,
                     "step_calls": {"cold": cold["calls"], "warm": warm["calls"]},
                     "ttft_mean_s_wave2": ttft, "tok_per_s": {"cold": cold["tok_per_s"],
                                                              "warm": warm["tok_per_s"]},
                     "first_token_logprob_max_abs_warm_vs_cold": [x for x, _ in lp],
                     "tokens_equal": [w.tokens == c.tokens
                                      for w, c in zip(warm["reqs"], cold["reqs"])]}
    log(f"  prefix: {json.dumps(out['prefix'])}")
    if not all(out["prefix"]["tokens_equal"]) or max(x for x, _ in lp) > 1e-3:
        raise AssertionError(f"prefix cache: warm differs from cold: {out['prefix']}")
    del params, base, s1, s2, run, cold, warm
    torch.cuda.empty_cache()
    return out, counts, vectors


# ---------------------------------------------------------------------------
# phase 3c: MoE serving (qwen3-moe-235b-a22b at full width, MOE_LAYERS deep)
# ---------------------------------------------------------------------------


def moe_config():
    from repro_torch.configs import get_config
    from repro_torch.launch.serve_engine import kernel_config

    return kernel_config(dataclasses.replace(get_config(MOE_ARCH), num_layers=MOE_LAYERS))


def check_moe_kernels(torch, cfg, device="cuda"):
    """The expert-axis B1 and B3 against their plain versions and against E
    launches of the 2-d kernels, bit for bit, at a full-width MoE layer's
    shapes: the dispatched tokens x [128, 8 | 64, 4096] and h [128, 8 | 64,
    1536] of a decode and a prefill tick, the transposed views of the
    stacked gate, up and down weights (read in place), B1's E8M0 edge rows
    on an expert axis, and two small stacks that B1 takes in its tile body; then B5 at the MoE's group of 16 (64 query heads over
    4 KV heads) at S = 1, SPEC_K + 1 and PREFILL_CHUNK (R = 16, 80 and 1024
    query rows a head) at the split's edges, within the tolerances of the
    dense checks.  Returns {kernel: max abs error}."""
    from repro_torch.kernels import hadamard_quant as HQ
    from repro_torch.kernels import mxfp4_matmul as MM
    from repro_torch.kernels import paged_attention as PA

    gen = torch.Generator(device=device).manual_seed(SEED + 7)
    E, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff

    def quantize(name, x):
        got = HQ.hadamard_quest_quantize_experts(x)
        want = HQ.hadamard_quest_quantize_experts_plain(x)
        for e in range(x.shape[0]):
            for g, w, p, what in zip(got, want, HQ.hadamard_quest_quantize(x[e]),
                                     ("codes", "scales", "mask")):
                if not torch.equal(g[e], w[e]):
                    raise AssertionError(f"B1 experts {name}: expert {e}'s {what} differ from "
                                         f"the plain version at {int((g[e] != w[e]).sum())}")
                if not torch.equal(g[e], p):
                    raise AssertionError(f"B1 experts {name}: expert {e}'s {what} differ from "
                                         f"a 2-d launch at {int((g[e] != p).sum())}")
        return got[0], got[1]

    edge = e8m0_edge_rows(torch, gen, device)  # 793 rows = 13 experts x 61
    quantize("E8M0 edge rows", edge.reshape(13, -1, edge.shape[1]))
    # the tile body: rows 2 bytes off a 16-byte boundary, and a transposed
    # view whose columns are 72 bytes apart
    x = torch.randn((4, 24, 72), generator=gen, device=device).to(torch.bfloat16)[..., 1:65]
    w = torch.randn((4, 64, 36), generator=gen, device=device).to(torch.bfloat16)
    before = HQ.hadamard_quest_quantize.vector_launches
    quantize("tile body, rows off 16 B", x)
    quantize("tile body, Wᵀ columns of 72 B", w.transpose(-1, -2))
    if HQ.hadamard_quest_quantize.vector_launches != before:
        raise AssertionError("B1 experts: a tile-body case took the vector body")
    weights = {}
    for name, (K, N) in (("gate", (d, f)), ("up", (d, f)), ("down", (f, d))):
        w = (torch.randn((E, K, N), generator=gen, device=device) / K**0.5).to(torch.bfloat16)
        weights[name] = quantize(f"W_{name}ᵀ [{E}, {N}, {K}]", w.transpose(-1, -2))
        del w
    for c in (N_SLOTS, PREFILL_CHUNK):
        acts = {K: quantize(f"x [{E}, {c}, {K}]", (torch.randn((E, c, K), generator=gen,
                                                               device=device) * 1.9)
                            .to(torch.bfloat16)) for K in (d, f)}
        for name, (wc, ws) in weights.items():
            ac, as_ = acts[wc.shape[2]]
            args = (ac, as_, wc.transpose(-1, -2), ws.transpose(-1, -2))
            got, want = MM.mxfp4_matmul_experts(*args), MM.mxfp4_matmul_experts_plain(*args)
            if not torch.equal(got, want):
                raise AssertionError(f"B3 experts {name} c={c}: differs from the plain version "
                                     f"at {int((got != want).sum())}")
            for e in range(E):
                if not torch.equal(got[e], MM.mxfp4_matmul(*(t[e] for t in args))):
                    raise AssertionError(f"B3 experts {name} c={c}: expert {e} differs from a "
                                         f"2-d launch")
        del acts
    del weights
    n_pp = MAX_LEN // PAGE_SIZE + 1
    worst = _check_paged_edges_at(
        torch, PA, cfg, gen, device, n_pp,
        lambda full, S: [1, 16, 32, full - S + 1, 1, 300, 17, MAX_LEN - S],
        S_values=(1, SPEC_K + 1, PREFILL_CHUNK))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return {"hadamard_quest_quantize": 0.0, "mxfp4_matmul": 0.0, "paged_attention": worst}


def check_reduced_moe(torch, device="cuda"):
    """The MoE family's oracle at a small size: reduced qwen3-moe-235b-a22b
    and reduced arctic-480b (dense residual), f32, the port's weights made
    on the CPU and copied to the card.  Under the bf16 method with a dense
    pool the card's greedy tokens equal the argmax of its teacher-forced
    forward on the paged backend, the gather backend's equal the paged
    ones, and both equal the CPU run's tokens, whose first-token logits the
    card's hold to 1e-4 (f32 sums in another order on each device; a flipped
    routing choice would move them by far more).  With the MXFP4 pool and
    the Quartet kernels the engine's tokens and every logits row equal, bit
    for bit, those of the same engine with the Quartet linears on the
    kernels' plain versions on the card (B1 and B3 equal them bit for bit,
    and nothing else differs).  Its first-token log-probs against the
    teacher-forced ones are held to 5.0 / 1.0, the full-width checks' bound
    (top-2-of-8 routing can turn one MXFP4 rounding into another expert
    choice: on the CPU these prompts read a mean of 0.36–0.47); beside them
    the reading of a planted fault, the engine given every layer's ``down``
    experts shifted by one (a wrong expert's output), is printed."""
    import numpy as np

    from repro_torch.configs import get_reduced_config
    from repro_torch.convert import init_params
    from repro_torch.core import quartet as QC
    from repro_torch.launch.serve_engine import kernel_config
    from repro_torch.models import build_model
    from repro_torch.models.moe import moe_ffn

    out = {}
    for arch in ("qwen3-moe-235b-a22b", "arctic-480b"):
        cfg = kernel_config(get_reduced_config(arch, dtype="float32"))
        model = build_model(cfg)
        host = init_params(cfg, torch.Generator().manual_seed(SEED), "cpu")
        card = {"cpu": host, device: _tree_map(lambda t: t.to(device), host)}
        rng = np.random.default_rng(SEED)
        prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (7, 19, 33)]
        runs, mx, tf_first = {}, [], []
        for dev, kv, method, backend in ((device, "dense", "bf16", "paged"),
                                         (device, "dense", "bf16", "gather"),
                                         ("cpu", "dense", "bf16", "paged"),
                                         (device, "mxfp4", "quartet", "paged")):
            params = card[dev]
            reqs = _reduced_moe_run(model, params, prompts, kv, method, backend)
            runs[dev, kv, backend] = reqs
            if dev == "cpu":
                continue
            for p, r in zip(prompts, reqs):
                seq = torch.tensor(np.concatenate([p, r.tokens[:-1]])[None], device=dev)
                with torch.inference_mode():
                    tf, _ = model.forward(params, seq, 0, method=method)
                tf = tf[0, p.size - 1:].float().cpu()
                if kv == "dense":
                    if r.tokens != tf.argmax(-1).tolist():
                        raise AssertionError(f"reduced {arch} {backend} tokens {r.tokens} != "
                                             f"teacher-forced argmax {tf.argmax(-1).tolist()}")
                else:
                    tf_first.append(torch.log_softmax(tf[0], -1))
                    d = (tf_first[-1]
                         - torch.log_softmax(torch.from_numpy(r.logits_trace[0]), -1)).abs()
                    mx.append((float(d.max()), float(d.mean())))
                    if mx[-1][0] >= 5.0 or mx[-1][1] >= 1.0:
                        raise AssertionError(f"reduced {arch} mxfp4 first-token log-probs off "
                                             f"by (max, mean) {mx[-1]}")
        # the same MXFP4 engine with the Quartet linears on the kernels'
        # plain versions, on the card
        plain_ops, kernel_ops = PlainOps(), QC._kernel_ops
        QC._kernel_ops = lambda ops: plain_ops
        try:
            plain = _reduced_moe_run(model, card[device], prompts, "mxfp4", "quartet", "paged")
        finally:
            QC._kernel_ops = kernel_ops
        kern = runs[device, "mxfp4", "paged"]
        kernels_equal_plain = all(
            a.tokens == b.tokens and len(a.logits_trace) == len(b.logits_trace)
            and all(np.array_equal(x, y) for x, y in zip(a.logits_trace, b.logits_trace))
            for a, b in zip(kern, plain))
        # a planted fault: every layer's down experts shifted by one
        moe = card[device]["layers"]["moe"]
        faulty = {**card[device], "layers": {**card[device]["layers"], "moe": {
            **moe, "down": torch.roll(moe["down"], 1, dims=1)}}}
        fault = []
        for lp, r in zip(tf_first, _reduced_moe_run(model, faulty, prompts, "mxfp4", "quartet",
                                                   "paged")):
            d = (lp - torch.log_softmax(torch.from_numpy(r.logits_trace[0]), -1)).abs()
            fault.append((float(d.max()), float(d.mean())))
        # routing, dispatch and the combine read nothing back to the host
        # (one MoE layer at a prefill chunk's 2 x 8 tokens, a padding lane)
        layer0 = _tree_map(lambda t: t[0], moe)
        x = torch.randn((2, 8, cfg.d_model), generator=torch.Generator(device=device)
                        .manual_seed(SEED), device=device)
        valid = torch.ones((2, 8), dtype=torch.bool, device=device)
        valid[1, 5:] = False
        torch.cuda.set_sync_debug_mode("error")
        try:
            moe_ffn(layer0, x, 0, cfg, "quartet", token_valid=valid)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        tok = {k: [r.tokens for r in v] for k, v in runs.items()}
        paged, gather, cpu = (tok[device, "dense", "paged"], tok[device, "dense", "gather"],
                              tok["cpu", "dense", "paged"])
        dlog = max(float(np.abs(a.logits_trace[0] - b.logits_trace[0]).max())
                   for a, b in zip(runs[device, "dense", "paged"], runs["cpu", "dense", "paged"]))
        out[arch] = {"gather_equals_paged": gather == paged, "card_equals_cpu": paged == cpu,
                     "first_token_logits_max_abs_card_vs_cpu": dlog,
                     "mxfp4_kernels_equal_plain_bitwise": kernels_equal_plain,
                     "mxfp4_first_token_logprob_max_mean_vs_teacher_forced": mx,
                     "planted_fault_logprob_max_mean_vs_teacher_forced": fault,
                     "moe_ffn_syncs_with_host": False}
        if gather != paged or paged != cpu or dlog > 1e-4 or not kernels_equal_plain:
            raise AssertionError(f"reduced {arch}: {out[arch]}")
    log(f"  reduced MoE oracle: {json.dumps(out)}")
    return out


def _reduced_moe_run(model, params, prompts, kv, method, backend):
    """The reduced MoE oracle's engine: 2 slots, 6 new tokens a prompt."""
    from repro_torch.serve import Engine, EngineConfig

    eng = Engine(model, params, EngineConfig(n_slots=2, max_len=48, page_size=8, kv_dtype=kv,
                                             prefill_chunk=8, method=method, keep_logits=True,
                                             decode_backend=backend))
    reqs = [eng.submit(p, 6) for p in prompts]
    eng.drain()
    return reqs


def _tree_map(fn, tree):
    return {k: _tree_map(fn, v) for k, v in tree.items()} if isinstance(tree, dict) else fn(tree)


def serve_moe(torch, ops, device="cuda"):
    """The engine phase's traffic on qwen3-moe-235b-a22b at full width,
    MOE_LAYERS of its 94 layers (random weights from SEED, MXFP4 pool, paged
    backend, greedy, the Quartet linears and the expert-axis kernels): the
    launches of every step call against the prediction, the log-probs
    against the teacher-forced forward, a timed run, then self-speculation
    at k = SPEC_K token-exact with its verify rows equal to the decode rows
    bit for bit; then the expert-axis B1 and B3 timed on layer 0's experts.
    Returns (summary, launch counts by path, vector-body launches by path)."""
    import numpy as np

    from repro_torch.convert import init_params
    from repro_torch.models import build_model
    from repro_torch.serve import SpecConfig

    cfg = moe_config()
    gc.collect()  # a speculating engine and its proposer hold each other
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=device).manual_seed(SEED), device)
    torch.cuda.synchronize()
    weight_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    init = {"params": sum(t.numel() for t in _leaves(params)), "weight_bytes": weight_bytes,
            "init_s": time.perf_counter() - t0,
            "peak_mem_gb_init": torch.cuda.max_memory_allocated() / 1e9}
    log(f"  init: {json.dumps(init)}")
    model = build_model(cfg)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(MIN_PROMPT, MAX_PROMPT + 1)))
               .astype(np.int32) for _ in range(N_REQUESTS)]
    greedy = [[(p, None) for p in prompts]]
    L = cfg.num_layers

    def check_launches(tag, run):
        # per step call, per layer: 14 B1 (x and Wᵀ of q, k, v, o and of the
        # three expert linears, each of those one launch over all experts),
        # 7 B3, 1 B5, 1 B4a (K and V); the router and the untied head are bf16
        counts = ops.launch_counts()
        n = sum(run["calls"].values())
        want = dict.fromkeys(counts, 0)
        want.update(hadamard_quest_quantize=14 * L * n, mxfp4_matmul=7 * L * n,
                    paged_attention=L * n, kv_quant_pack=L * n)
        if counts != want:
            raise AssertionError(f"{tag}: launches {counts} != predicted {want} "
                                 f"(step calls {run['calls']})")
        return counts

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    base = run_engine(torch, model, params, greedy, keep_logits=True)
    counts, vectors = {}, {}
    counts["moe"] = check_launches("moe", base)
    vectors["moe"] = ops.vector_launches()
    tf = [_logprob_diff(torch, r.logits_trace,
                        _teacher_forced_rows(torch, model, params, r, device))
          for r in base["reqs"]]
    if not all(x < 5.0 and y < 1.0 for x, y in tf):
        raise AssertionError(f"MoE log-probs vs teacher-forced out of tolerance: {tf}")
    timed = run_engine(torch, model, params, greedy)
    ttft = sorted(timed["ttft"].values())
    med = lambda v: 1e3 * sorted(v)[len(v) // 2]  # noqa: E731
    summary = {"arch": cfg.name, "layers": f"{L} of 94", "prompts": [int(p.size) for p in prompts],
               **init, "step_calls": base["calls"], "tok_per_s": timed["tok_per_s"],
               "wall_s": timed["wall"], "ttft_mean_s": float(np.mean(ttft)),
               "ttft_median_s": ttft[len(ttft) // 2], "ttft_max_s": ttft[-1],
               "prefill_ticks": len(timed["ticks"]["prefill"]),
               "prefill_tick_ms_median": med(timed["ticks"]["prefill"]),
               "decode_ticks": len(timed["ticks"]["decode"]),
               "decode_tick_ms_median": med(timed["ticks"]["decode"]),
               "kv_pool_bytes": timed["eng"].cache_bytes(),
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
               "teacher_forced_logprob_max_mean": tf, "launches": counts["moe"]}
    log(f"  full width: {json.dumps(summary)}")

    # self-speculation, k = SPEC_K: the non-spec tokens, and every verify row
    # equal bit for bit to the decode row at the same position (the paged
    # kernel's split, the router and the norms round a row alike at R = 16
    # and R = 80 rows a head)
    ops.reset_launch_counts()
    spec = run_engine(torch, model, params, greedy, spec=SpecConfig(k=SPEC_K, proposer="self"),
                      keep_logits=True)
    counts["moe_spec"] = check_launches("moe_spec", spec)
    vectors["moe_spec"] = ops.vector_launches()
    from repro_torch.serve.spec import aggregate_stats

    agg = aggregate_stats(spec["reqs"])
    rec = {"tok_per_s": spec["tok_per_s"], "acceptance": agg["acceptance_rate"],
           "tokens_per_verify_call": agg["tokens_per_decode_call"], "step_calls": spec["calls"],
           "first_divergence_from_nonspec": [_first_divergence(r.tokens, b.tokens)
                                             for r, b in zip(spec["reqs"], base["reqs"])]}
    for r, b in zip(spec["reqs"], base["reqs"]):
        same = [np.array_equal(x, y) for x, y in zip(r.logits_trace, b.logits_trace)]
        rec.setdefault("verify_rows_equal_decode_rows", []).append(all(same))
    summary["spec_self"] = rec
    log(f"  self-speculation: {json.dumps(rec)}")
    if any(d is not None for d in rec["first_divergence_from_nonspec"]):
        raise AssertionError("MoE self-speculation: tokens differ from the non-spec run")
    if not all(rec["verify_rows_equal_decode_rows"]):
        raise AssertionError("MoE self-speculation: verify rows differ from the decode rows")
    # layer 0's expert weights alone for the kernel times: the plain
    # versions' f32 temporaries need the room the model held
    experts = {n: params["layers"]["moe"][n][0].clone() for n in ("gate", "up", "down")}
    del base, timed, spec, params
    gc.collect()  # the speculating engine and its proposer hold each other
    torch.cuda.empty_cache()
    summary["times"] = time_moe_kernels(torch, cfg, experts, device)
    return summary, counts, vectors


def time_moe_kernels(torch, cfg, ws, device="cuda"):
    """The expert-axis B1 and B3 over one MoE layer's experts (``ws``: layer
    0's stacked gate, up and down weights [E, K, N]) at a decode tick (8 tokens: 8 rows an expert, as dispatch pads
    them) and a prefill tick (8 x 64 tokens: 64 rows an expert), each beside
    its bound, its plain version (timed once: it runs seconds) and, for B3,
    one ``torch.bmm`` in bf16 on the dequantized operands; B5 at the MoE's
    group of 16 at a decode, a prefill and a verify tick."""
    from repro_torch.kernels import hadamard_quant as HQ
    from repro_torch.kernels import mxfp4_matmul as MM

    timer, once = Timer(torch), Timer(torch, reps=1)
    gen = torch.Generator(device=device).manual_seed(SEED + 9)
    wq = {n: HQ.hadamard_quest_quantize_experts(w.transpose(-1, -2))[:2] for n, w in ws.items()}
    E, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    rec = {}

    def b1_bytes(ts):  # 2 B read, 1 B code and 1 B mask written per element, 4 B a group
        return sum(t.numel() * (2 + 2) + t.numel() // 32 * 4 for t in ts)

    for c, tag in ((N_SLOTS, "moe decode"), (PREFILL_CHUNK, "moe prefill")):
        x = (torch.randn((E, c, d), generator=gen, device=device) * 1.9).to(torch.bfloat16)
        h = (torch.randn((E, c, f), generator=gen, device=device) * 1.9).to(torch.bfloat16)
        # the layer's six expert-axis B1 calls: x for gate and up, h for
        # down, and each weight's transposed view
        calls = [x, ws["gate"].transpose(-1, -2), x, ws["up"].transpose(-1, -2), h,
                 ws["down"].transpose(-1, -2)]
        for part, ts in (("", calls), (" weights", calls[1::2])):
            rec[("hadamard_quest_quantize_experts", tag + part)] = dict(
                ms=timer(lambda ts=ts: [HQ.hadamard_quest_quantize_experts(t) for t in ts]),
                device_ms=timer.device(
                    lambda ts=ts: [HQ.hadamard_quest_quantize_experts(t) for t in ts]),
                plain_ms=once(lambda ts=ts: [HQ.hadamard_quest_quantize_experts_plain(t)
                                             for t in ts]),
                bound_ms=b1_bytes(ts) / H100_BYTES_PER_S * 1e3, bound_by="bytes",
                library_ms=None, launches_per_layer=len(ts))
        xq = HQ.hadamard_quest_quantize_experts(x)[:2]
        hq = HQ.hadamard_quest_quantize_experts(h)[:2]
        args = [(*a, w[0].transpose(-1, -2), w[1].transpose(-1, -2))
                for a, w in ((xq, wq["gate"]), (xq, wq["up"]), (hq, wq["down"]))]
        deq = [(_deq3(torch, a, s), _deq3(torch, b.transpose(-1, -2), t.transpose(-1, -2))
                .transpose(-1, -2)) for a, s, b, t in args]
        nbytes = sum(a.numel() + s.numel() * 4 + b.numel() + t.numel() * 4
                     + a.shape[0] * a.shape[1] * b.shape[2] * 4 for a, s, b, t in args)
        nops = sum(2 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2] for a, _, b, _ in args)
        rec[("mxfp4_matmul_experts", tag)] = dict(
            ms=timer(lambda: [MM.mxfp4_matmul_experts(*a) for a in args]),
            device_ms=timer.device(lambda: [MM.mxfp4_matmul_experts(*a) for a in args]),
            plain_ms=once(lambda: [MM.mxfp4_matmul_experts_plain(*a) for a in args]),
            bound_ms=max(nbytes / H100_BYTES_PER_S, nops / H100_INT8_OPS) * 1e3,
            bound_by="bytes" if nbytes / H100_BYTES_PER_S >= nops / H100_INT8_OPS
            else "operations",
            library_ms=timer(lambda: [torch.bmm(a, b) for a, b in deq]),
            launches_per_layer=len(args))
        del x, h, xq, hq, args, deq
    rec.update(time_paged_attention(torch, cfg, timer, gen, device, prefix="moe "))
    # B4a at a MoE decode tick: one layer's K and V write of 8 tokens (4 KV
    # heads of 128)
    rec[("kv_quant_pack", "moe decode")] = time_kv_write(torch, cfg, timer, gen, N_SLOTS, device)
    for (name, tag), r in rec.items():
        log(f"  [times] {name} {tag} (one MoE layer, NVIDIA H100 figures of this run): "
            f"{json.dumps(r)}")
    torch.cuda.empty_cache()
    return {f"{name} {tag}": r for (name, tag), r in rec.items()}


def _deq3(torch, codes, scales):
    """Half-codes [E, M, K] and scales [E, M, K/32] → bf16 values (exact)."""
    e, m, k = codes.shape
    v = codes.float().reshape(e, m, k // 32, 32) * (0.5 * scales)[..., None]
    return v.reshape(e, m, k).to(torch.bfloat16)


# ---------------------------------------------------------------------------
# phase 4: times
# ---------------------------------------------------------------------------


def time_kernels(torch, cfg, timer, device="cuda"):
    """Each kernel over one layer's decode-step launches (8 slots), beside its
    plain version, its least time on the H100 and, where one exists, one
    PyTorch call computing the same function.  Also one prefill chunk's, and
    B5 also at a verify tick's S = SPEC_K + 1."""
    from repro_torch.kernels import hadamard_quant as HQ
    from repro_torch.kernels import mxfp4_matmul as MM

    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    rec = {}
    for m, tag in ((N_SLOTS, "decode"), (N_SLOTS * PREFILL_CHUNK, "prefill")):
        xs, ws, qa, qw = [], [], [], []
        for _, K, N in linear_shapes(cfg):
            xs.append(torch.randn((m, K), generator=gen, device=device).to(torch.bfloat16))
            ws.append((torch.randn((K, N), generator=gen, device=device) / K**0.5)
                      .to(torch.bfloat16))
            qa.append(HQ.hadamard_quest_quantize(xs[-1]))
            qw.append(HQ.hadamard_quest_quantize(ws[-1].t()))

        def hq(fn):
            return lambda: [fn(t) for pair in zip(xs, ws) for t in (pair[0], pair[1].t())]

        def hq_bytes(ts):  # 2 B read, 1 B code and 1 B mask written per element
            return sum(t.numel() * (2 + 2) + t.numel() // 32 * 4 for t in ts)

        rec[("hadamard_quest_quantize", tag)] = dict(
            ms=timer(hq(HQ.hadamard_quest_quantize)),
            device_ms=timer.device(hq(HQ.hadamard_quest_quantize)),
            plain_ms=timer(hq(HQ.hadamard_quest_quantize_plain)),
            bound_ms=hq_bytes(xs + ws) / H100_BYTES_PER_S * 1e3, bound_by="bytes",
            library_ms=None, launches_per_layer=2 * len(xs))
        # the same layer's calls apart: the 7 weight views (device time) and
        # the 7 activations (small: the wrapper's host time)
        for part, ts in (("weights", [w.t() for w in ws]), ("activations", xs)):
            rec[("hadamard_quest_quantize", f"{tag} {part}")] = dict(
                ms=timer(lambda ts=ts: [HQ.hadamard_quest_quantize(t) for t in ts]),
                device_ms=timer.device(lambda ts=ts: [HQ.hadamard_quest_quantize(t) for t in ts]),
                plain_ms=timer(lambda ts=ts: [HQ.hadamard_quest_quantize_plain(t) for t in ts]),
                bound_ms=hq_bytes(ts) / H100_BYTES_PER_S * 1e3, bound_by="bytes",
                library_ms=None, launches_per_layer=len(ts))

        args = [(a[0], a[1], w[0].t(), w[1].t()) for a, w in zip(qa, qw)]
        deq = [(_deq(torch, a[0], a[1]).to(torch.bfloat16),
                _deq(torch, w[0], w[1]).to(torch.bfloat16).t()) for a, w in zip(qa, qw)]
        nbytes = sum(a.numel() * 1 + s.numel() * 4 + b.numel() + t.numel() * 4
                     + a.shape[0] * b.shape[1] * 4 for a, s, b, t in args)
        nops = sum(2 * a.shape[0] * a.shape[1] * b.shape[1] for a, _, b, _ in args)
        bound = max(nbytes / H100_BYTES_PER_S, nops / H100_INT8_OPS) * 1e3
        rec[("mxfp4_matmul", tag)] = dict(
            ms=timer(lambda: [MM.mxfp4_matmul(*a) for a in args]),
            device_ms=timer.device(lambda: [MM.mxfp4_matmul(*a) for a in args]),
            plain_ms=timer(lambda: [MM.mxfp4_matmul_plain(*a) for a in args]),
            bound_ms=bound,
            bound_by="bytes" if nbytes / H100_BYTES_PER_S >= nops / H100_INT8_OPS
            else "operations",
            library_ms=timer(lambda: [torch.matmul(a, b) for a, b in deq]),
            launches_per_layer=len(args))

    # B5 at a decode tick (S = 1), a prefill tick (S = 64) and a verify tick
    # (S = SPEC_K + 1: R = 10 query rows a slot and KV head)
    rec.update(time_paged_attention(torch, cfg, timer, gen, device))
    return rec


def time_paged_attention(torch, cfg, timer, gen, device="cuda", prefix=""):
    """B5 over one layer's pool at a decode tick (S = 1), a prefill tick
    (S = 64) and a verify tick (S = SPEC_K + 1), the engine phase's slot
    lengths, beside its plain version, its bound and one SDPA call."""
    from repro_torch.kernels import paged_attention as PA

    rec = {}
    for tag, S in (("decode", 1), ("prefill", PREFILL_CHUNK), ("verify", SPEC_K + 1)):
        lengths = [MIN_PROMPT + (MAX_PROMPT + MAX_NEW - MIN_PROMPT) * i // (N_SLOTS - 1)
                   for i in range(N_SLOTS)]
        lens = [max(n - S + 1, 1) for n in lengths]
        pool, tables = make_pool(torch, cfg, [n + S - 1 for n in lens], True, torch.bfloat16,
                                 gen, device, MAX_LEN // PAGE_SIZE + 1)
        q = torch.randn((N_SLOTS, S, cfg.num_heads, cfg.head_dim_), generator=gen,
                        device=device).to(torch.bfloat16)
        ln = torch.tensor(lens, dtype=torch.int32, device=device)
        nbytes, nops = attention_bytes_ops(cfg, lens, S, True, 2)
        bound = max(nbytes / H100_BYTES_PER_S, nops / H100_BF16_OPS) * 1e3
        lib = _sdpa_operands(torch, cfg, q, pool, tables, ln)
        rec[("paged_attention", prefix + tag)] = dict(
            ms=timer(lambda: PA.paged_attention(q, pool, tables, ln)),
            device_ms=timer.device(lambda: PA.paged_attention(q, pool, tables, ln)),
            plain_ms=timer(lambda: PA.paged_attention_plain(q, pool, tables, ln)),
            bound_ms=bound,
            bound_by="bytes" if nbytes / H100_BYTES_PER_S >= nops / H100_BF16_OPS
            else "operations",
            library_ms=timer(lambda: torch.nn.functional.scaled_dot_product_attention(*lib)),
            launches_per_layer=1)
    return rec


def time_kv_write(torch, cfg, timer, gen, n_tok, device="cuda"):
    """B4a over one layer's KV write of ``n_tok`` tokens (``scatter_token``:
    K and V into random pool slots), beside its plain version and its
    least time on the H100."""
    from repro_torch.kernels import kv_pack as KV
    from repro_torch.kernels.paged_attention import scatter_token

    Hkv, hd = cfg.num_kv_heads, cfg.head_dim_
    n_pages = 1 + N_SLOTS * (MAX_LEN // PAGE_SIZE)
    pool = {n: torch.zeros((n_pages, PAGE_SIZE, Hkv, w), dtype=torch.uint8, device=device)
            for n, w in (("k_codes", hd // 2), ("k_scales", hd // 32), ("v_codes", hd // 2),
                         ("v_scales", hd // 32))}
    perm = torch.randperm((n_pages - 1) * PAGE_SIZE, generator=gen, device=device)[:n_tok]
    pid = (1 + perm // PAGE_SIZE).to(torch.int32)
    off = (perm % PAGE_SIZE).to(torch.int32)
    k, v = [(torch.randn((n_tok, Hkv, hd), generator=gen, device=device) * 1.5)
            .to(torch.bfloat16) for _ in range(2)]
    # K and V: 2 B read per bf16 element, 0.5 + 1/32 B written; 8 B of ids
    # per token
    nbytes = 2 * n_tok * Hkv * hd * (2 + 0.5 + 1 / 32) + 8 * n_tok
    before = KV.kv_quant_pack.launches
    scatter_token(pool, pid, off, k, v)
    per_write = KV.kv_quant_pack.launches - before

    def plain():
        for x, c, sc in ((k, "k_codes", "k_scales"), (v, "v_codes", "v_scales")):
            plain_quant_scatter(torch, pool[c][None], pool[sc][None], pid, off, x[None])

    return dict(ms=timer(lambda: scatter_token(pool, pid, off, k, v)),
                device_ms=timer.device(lambda: scatter_token(pool, pid, off, k, v)),
                plain_ms=timer(plain), bound_ms=nbytes / H100_BYTES_PER_S * 1e3,
                bound_by="bytes", library_ms=None, launches_per_layer=per_write)


def time_kv_and_flash(torch, cfg, tcfg, timer, device="cuda"):
    """B4a over one layer's KV write (``scatter_token``: K and V) of a decode
    tick (8 tokens) and a prefill tick (8 x 64 tokens); B4b over one decode
    tick's gather (``gather_pages``: K and V, 28 layers, 8 slots x 640
    positions, bf16 out); B6
    at the evaluation shape and at qwen3-1.7b's GQA at 4096.  Each beside its
    plain version, its least time on the H100 and, for B6, one SDPA call."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import kv_pack as KV
    from repro_torch.serve.paged_cache import gather_pages

    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    Hkv, hd, L = cfg.num_kv_heads, cfg.head_dim_, cfg.num_layers
    n_pages = 1 + N_SLOTS * (MAX_LEN // PAGE_SIZE)
    rec = {("kv_quant_pack", tag): time_kv_write(torch, cfg, timer, gen, n_tok, device)
           for n_tok, tag in ((N_SLOTS, "decode"), (N_SLOTS * PREFILL_CHUNK, "prefill"))}

    # B4b through the gather backend's entry point (gather_pages: K and V)
    pool = {n: torch.randint(0, 256, (L, n_pages, PAGE_SIZE, Hkv, w), generator=gen,
                             device=device, dtype=torch.uint8)
            for n, w in (("k_codes", hd // 2), ("k_scales", hd // 32), ("v_codes", hd // 2),
                         ("v_scales", hd // 32))}
    pool["k_scales"].clamp_(100, 154)
    pool["v_scales"].clamp_(100, 154)
    tables = (1 + torch.arange(n_pages - 1, device=device, dtype=torch.int32)
              ).reshape(N_SLOTS, -1)
    n_el = L * tables.numel() * PAGE_SIZE * Hkv * hd
    # per K and V: 0.5 + 1/32 B read and 2 B (bf16) written per element
    nbytes = 2 * n_el * (0.5 + 1 / 32 + 2) + 4 * tables.numel()
    idx = tables.long()
    before = KV.kv_dequant_unpack.launches
    gather_pages(pool, tables, torch.bfloat16)
    per_tick = KV.kv_dequant_unpack.launches - before
    rec[("kv_dequant_unpack", "gather")] = dict(
        ms=timer(lambda: gather_pages(pool, tables, torch.bfloat16)),
        device_ms=timer.device(lambda: gather_pages(pool, tables, torch.bfloat16)),
        plain_ms=timer(lambda: [KV.kv_dequant_unpack_plain(pool[c][:, idx], pool[sc][:, idx],
                                                           torch.bfloat16)
                                for c, sc in (("k_codes", "k_scales"), ("v_codes", "v_scales"))]),
        bound_ms=nbytes / H100_BYTES_PER_S * 1e3, bound_by="bytes", library_ms=None,
        launches_per_tick=per_tick)
    del pool

    for name, B, S, T, hq, hkv, d, causal, dtn in flash_shapes(cfg, tcfg)[:2]:
        dt = getattr(torch, dtn)
        q = torch.randn((B, S, hq, d), generator=gen, device=device).to(dt)
        k, v = (torch.randn((B, T, hkv, d), generator=gen, device=device).to(dt)
                for _ in range(2))
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        nops = 4 * B * hq * S * T * d * (0.5 if causal else 1.0)
        nbytes = 2 * (2 * B * S * hq * d + 2 * B * T * hkv * d)
        by_ops, by_bytes = nops / H100_BF16_OPS, nbytes / H100_BYTES_PER_S
        rec[("flash_attention", name)] = dict(
            ms=timer(lambda: FA.mha_flash(q, k, v, causal=causal)),
            plain_ms=timer(lambda: flash_plain(FA, q, k, v, causal)),
            bound_ms=max(by_ops, by_bytes) * 1e3,
            bound_by="operations" if by_ops >= by_bytes else "bytes",
            library_ms=timer(lambda: sdpa(torch, qt, kt, vt, causal)),
            launches_per_layer=1)
        del q, k, v, qt, kt, vt
    return rec


def _deq(torch, codes, scales):
    m, k = codes.shape
    return (codes.float().reshape(m, k // 32, 32) * (0.5 * scales)[..., None]).reshape(m, k)


def _sdpa_operands(torch, cfg, q, pool, tables, lengths):
    """q, K, V, mask for one SDPA call over the gathered, dequantized KV
    (GQA heads expanded), outside the timed call."""
    from repro_torch.serve.paged_cache import gather_pages

    one = {k: v[None] for k, v in pool.items()}
    k, v = gather_pages(one, tables, q.dtype)
    k, v = k[0], v[0]  # [B, T, Hkv, hd]
    g = cfg.num_heads // cfg.num_kv_heads
    k = k.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
    v = v.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
    S = q.shape[1]
    qq = q.transpose(1, 2).contiguous()  # [B, Hq, S, hd]
    T = k.shape[2]
    qpos = lengths.long()[:, None] - 1 + torch.arange(S, device=q.device)[None]
    mask = torch.arange(T, device=q.device)[None, None] <= qpos[..., None]
    return qq, k, v, mask[:, None]

# ---------------------------------------------------------------------------
# phase 2b: the training kernels at full width
# ---------------------------------------------------------------------------


class PlainOps:
    """The kernels' plain versions behind ``kernels.ops``'s signatures, so
    the kernel-path Quartet passes can run on them on the card."""

    def __init__(self):
        import torch

        from repro_torch.kernels import hadamard_quant as HQ
        from repro_torch.kernels import mxfp4_matmul as MM
        from repro_torch.kernels import sr_hadamard_quant as SR

        self.HQ, self.MM, self.SR = HQ, MM, SR
        self.cat = torch.cat

    def hadamard_quest_quantize(self, x, group=32):
        lead = x.shape[:-1]
        out = self.HQ.hadamard_quest_quantize_plain(x.reshape(-1, x.shape[-1]))
        return tuple(t.reshape(*lead, -1) for t in out)

    def sr_hadamard_quantize(self, x, signs, seed, prescale=0.75, salt=0):
        return self.SR.sr_hadamard_quantize_plain(x, signs, seed, prescale, salt)

    def mxfp4_matmul(self, a, sa, b, sb):
        lead = a.shape[:-1]
        out = self.MM.mxfp4_matmul_plain(a.reshape(-1, a.shape[-1]),
                                          sa.reshape(-1, sa.shape[-1]), b, sb)
        return out.reshape(*lead, -1)

    # the expert-axis plain versions a few experts at a time (rows and
    # experts are independent), so that their f32 and int64 temporaries fit
    # beside a full-width layer
    CHUNK = 16

    def hadamard_quest_quantize_experts(self, x, group=32):
        parts = [self.HQ.hadamard_quest_quantize_experts_plain(x[i:i + self.CHUNK])
                 for i in range(0, x.shape[0], self.CHUNK)]
        return tuple(self.cat(p) for p in zip(*parts))

    def sr_hadamard_quantize_experts(self, x, signs, seeds, prescale=0.75, salt=0):
        parts = [self.SR.sr_hadamard_quantize_experts_plain(
            x[i:i + self.CHUNK], signs[i:i + self.CHUNK], seeds[i:i + self.CHUNK], prescale,
            salt) for i in range(0, x.shape[0], self.CHUNK)]
        return tuple(self.cat(p) for p in zip(*parts))

    def mxfp4_matmul_experts(self, a, sa, b, sb):
        return self.cat([self.MM.mxfp4_matmul_experts_plain(
            a[i:i + self.CHUNK], sa[i:i + self.CHUNK], b[i:i + self.CHUNK], sb[i:i + self.CHUNK])
            for i in range(0, a.shape[0], self.CHUNK)])


def backward_operands(torch, K, N, gen, device="cuda", T=TRAIN_TOKENS_MB):
    """The four backward Stage-1 operands of one full-width linear [K, N]
    over one microbatch of T tokens, as ``quartet._backward_kernels`` passes
    them: dy [T, N] (bf16, row-major), and three views with unit stride
    along their rows: the dequantized weight Wq [K, N] (f32, the transpose
    of the [N, K] codes' values), xqᵀ [K, T] (f32) and dyᵀ [N, T] (bf16)."""
    from repro_torch.core.quartet import _dequant_codes
    from repro_torch.kernels import hadamard_quant as HQ

    x = torch.randn((T, K), generator=gen, device=device).to(torch.bfloat16)
    w = (torch.randn((K, N), generator=gen, device=device) / K**0.5).to(torch.bfloat16)
    dy = (torch.randn((T, N), generator=gen, device=device) * 1e-3).to(torch.bfloat16)
    xc, xs, _ = HQ.hadamard_quest_quantize(x)
    wc, ws, _ = HQ.hadamard_quest_quantize(w.t())
    return {"dy": dy, "Wq": _dequant_codes(wc, ws, 32).t(),
            "xqᵀ": _dequant_codes(xc, xs, 32).t(), "dyᵀ": dy.t()}


def check_training_kernels(torch, cfg, device="cuda"):
    """Training-shape checks on the card (full-width llama-paper-200m, one
    microbatch of 16 x 512 tokens); raises on a mismatch.  Returns the max
    abs error of each kernel and of the whole backward."""
    from repro_torch.core import fastrng
    from repro_torch.core.quartet import QuartetConfig, _backward_kernels, _forward_kernels
    from repro_torch.kernels import mxfp4_matmul as MM
    from repro_torch.kernels import sr_hadamard_quant as SR

    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    seed = 12345
    err = {}
    # sr_hadamard_quantize: the four operands of the up projection (K 1280,
    # N 3456) and of the down projection (K 3456, N 1280), codes and scales
    # bit-exact, at the training path's layouts (three of them views with
    # unit stride along M)
    d, f = cfg.d_model, cfg.d_ff
    codes = {}
    for proj, K, N in (("up", d, f), ("down", f, d)):
        for salt, (name, x) in enumerate(backward_operands(torch, K, N, gen, device).items(), 1):
            signs = fastrng.rademacher(seed, x.shape[1], salt=11 if salt < 3 else 12,
                                       device=device)
            got = SR.sr_hadamard_quantize(x, signs, seed, salt=salt)
            want = SR.sr_hadamard_quantize_plain(x, signs, seed, salt=salt)
            for g, w_, what in zip(got, want, ("codes", "scales")):
                if not torch.equal(g, w_):
                    raise AssertionError(f"sr_hadamard_quantize {proj} {name} {tuple(x.shape)} "
                                         f"(strides {x.stride()}): {what} differ at "
                                         f"{int((g != w_).sum())} places")
            codes[proj, name] = got
    err["sr_hadamard_quantize"] = 0.0

    # mxfp4_matmul at the backward's operand layouts: dx [T, N]·[N, K] and
    # dW [K, T]·[T, N] with B the transposed view of the SR codes, and the
    # down projection's dW (M = d_ff rows, 8192-token contraction)
    def gemm(a, b):
        return (*codes[a], codes[b][0].t(), codes[b][1].t())

    cases = {"dx": gemm(("up", "dy"), ("up", "Wq")), "dW": gemm(("up", "xqᵀ"), ("up", "dyᵀ")),
             "dW down": gemm(("down", "xqᵀ"), ("down", "dyᵀ"))}
    worst = 0.0
    for name, args in cases.items():
        got, want = MM.mxfp4_matmul(*args), MM.mxfp4_matmul_plain(*args)
        diff = float((got - want).abs().max())
        if not torch.equal(got, want):
            raise AssertionError(f"mxfp4_matmul {name} {tuple(args[0].shape)} x "
                                 f"{tuple(args[2].shape)}: max |Δ| {diff}")
        worst = max(worst, diff)
    err["mxfp4_matmul"] = worst

    # one full-width quartet_linear backward (the up projection) on the
    # kernels against the same backward on the plain versions
    qc = QuartetConfig(use_kernels=True)
    x = torch.randn((TRAIN_BATCH // TRAIN_MICRO, TRAIN_SEQ, d), generator=gen,
                    device=device).to(torch.bfloat16)
    w = (torch.randn((d, f), generator=gen, device=device) / d**0.5).to(torch.bfloat16)
    dy = (torch.randn((*x.shape[:-1], f), generator=gen, device=device) * 1e-3).to(torch.bfloat16)
    _, res = _forward_kernels(x, w, qc)
    dx, dw = _backward_kernels(qc, seed, res, dy)
    pdx, pdw = _backward_kernels(qc, seed, res, dy, ops=PlainOps())
    for name, a, b in (("dx", dx, pdx), ("dW", dw, pdw)):
        if not torch.allclose(a, b, rtol=1e-5, atol=1e-6 * float(b.abs().max())):
            raise AssertionError(f"quartet_linear backward {name}: kernels vs plain max |Δ| "
                                 f"{float((a - b).abs().max())} (max |plain| "
                                 f"{float(b.abs().max())})")
    err["quartet_linear backward"] = max(float((dx - pdx).abs().max()),
                                         float((dw - pdw).abs().max()))
    torch.cuda.synchronize()
    return err


# ---------------------------------------------------------------------------
# phase 4: training
# ---------------------------------------------------------------------------


def train_reduced_card_vs_cpu(torch, device="cuda"):
    """A reduced Llama (f32) 3 steps on the card with the kernels and on the
    CPU with the plain versions, from the same weights and batches.  Returns
    the max relative differences of loss and grad-norm.

    Tolerance.  Step 0 (same weights, same batch): loss rtol 1e-5, grad-norm
    rtol 1e-3.  Every step: loss rtol 8e-3, grad-norm rtol 3e-2, about twice
    the largest differences this seeded run shows on an H100 (3.84e-3 and
    1.41e-2, the same on every machine).  The kernels equal their plain
    versions bit for bit, but the rest of the step (norms, attention, the
    loss) rounds differently on the card, so now and then a
    stochastic-rounding decision flips and moves one gradient column by a
    grid step; AdamW's first steps follow the sign of each gradient element,
    so the next losses drift apart by a few parts in a thousand."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.convert import init_params
    from repro_torch.data.pipeline import SyntheticC4Dataset, TokenBatcher
    from repro_torch.launch.serve_engine import kernel_config
    from repro_torch.models import build_model
    from repro_torch.optim import adamw, cosine_warmup
    from repro_torch.train.loop import train
    from repro_torch.tree import tree_map

    cfg = kernel_config(get_reduced_config(TRAIN_ARCH, dtype="float32"))
    model = build_model(cfg)
    params = init_params(cfg, torch.Generator().manual_seed(SEED), "cpu")
    batcher = TokenBatcher(SyntheticC4Dataset(cfg.vocab_size, seed=SEED), 8, 64)
    hist = {}
    for dev in (device, "cpu"):
        _, hist[dev] = train(model, adamw(cosine_warmup(1e-3, 3)), batcher, 3,
                             microbatch=2, params=tree_map(lambda t: t.to(dev), params),
                             device=dev, log_fn=lambda *_: None)
    rel, bad = {}, []
    for key, tol0, tol in (("loss", 1e-5, 8e-3), ("grad_norm", 1e-3, 3e-2)):
        a = [h[key] for h in hist[device]]
        b = [h[key] for h in hist["cpu"]]
        r = [abs(x - y) / abs(y) for x, y in zip(a, b)]
        rel[key] = r
        log(f"  reduced {key}: card {a} cpu {b} (rel {r}; tolerance {tol0} at step 0, "
            f"{tol} at every step)")
        if not (r[0] <= tol0 and max(r) <= tol):
            bad.append(key)
    if bad:
        raise AssertionError(f"reduced training: {bad} on the card vs the CPU out of tolerance")
    return rel


def _named_leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named_leaves(tree[k], f"{path}.{k}" if path else k)
    else:
        yield path, tree


def _state_diff(torch, x, y) -> dict[str, float]:
    """Max |Δ| of every tensor leaf (params, AdamW moments and the gradient
    compression's error, where kept) that differs between two train states,
    by leaf name."""
    out = {}
    for (name, a), (_, b) in zip(
            _named_leaves({"params": x.params, "opt": x.opt_state, "err": x.err}),
            _named_leaves({"params": y.params, "opt": y.opt_state, "err": y.err})):
        if isinstance(a, torch.Tensor) and not torch.equal(a, b):
            out[name] = float((a.float() - b.float()).abs().max())
    return out


def train_resume_check(torch, device="cuda", grad_compress=False):
    """Checkpoint and resume on the card: llama-paper-200m at full width with
    its depth cut to RESUME_LAYERS layers (to keep the phase short), batches
    of TRAIN_BATCH x TRAIN_SEQ in TRAIN_MICRO microbatches, a checkpoint every
    2 steps.  Two unbroken runs of RESUME_STEPS steps, and one stopped after
    step 2's checkpoint and started again with the same arguments (it
    resumes from the checkpoint).  If the two unbroken runs are bit-identical
    the resumed one must be too; if they are not, the leaves that differ
    name the op, and the resumed run may differ from the first by no more
    than the second does.  Also the checkpoint's bytes and the seconds to
    write it (blocking, and the host copy of an asynchronous save).  With
    ``grad_compress`` the runs take the SR-int8 gradient round trip, and the
    state's error-feedback leaves are held alike."""
    import dataclasses
    import shutil

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.configs.llama_paper import LEARNING_RATES
    from repro_torch.data.pipeline import SyntheticC4Dataset, TokenBatcher
    from repro_torch.launch.serve_engine import kernel_config
    from repro_torch.models import build_model
    from repro_torch.optim import adamw, cosine_warmup
    from repro_torch.train.loop import train

    cfg = dataclasses.replace(kernel_config(get_config(TRAIN_ARCH)), num_layers=RESUME_LAYERS)
    model = build_model(cfg)
    batcher = TokenBatcher(SyntheticC4Dataset(cfg.vocab_size, seed=SEED), TRAIN_BATCH, TRAIN_SEQ)
    opt = adamw(cosine_warmup(LEARNING_RATES[TRAIN_ARCH], RESUME_STEPS))
    root = os.path.join(HERE, "build", "resume_check")
    shutil.rmtree(root, ignore_errors=True)
    logs = []

    def run(name, steps):
        return train(model, opt, batcher, steps, microbatch=TRAIN_MICRO, seed=SEED,
                     device=device, checkpoint_dir=os.path.join(root, name),
                     checkpoint_every=2, log_every=0, log_fn=logs.append,
                     grad_compress=grad_compress)

    a, ha = run("a", RESUME_STEPS)
    b, hb = run("b", RESUME_STEPS)
    run("c", 2)
    c, hc = run("c", RESUME_STEPS)
    if logs[-1] != f"[resume] restored step 2 from {os.path.join(root, 'c')}" or len(hc) != 2:
        raise AssertionError(f"the second start did not resume at step 2: {logs[-1:]}, "
                             f"{len(hc)} steps")
    if not (c.step == c.opt_state["step"] == RESUME_STEPS):
        raise AssertionError(f"resumed step counters {c.step}, {c.opt_state['step']}")
    d_ab, d_ac = _state_diff(torch, a, b), _state_diff(torch, a, c)
    loss_ab = [x["loss"] - y["loss"] for x, y in zip(ha, hb)]
    loss_ac = [x["loss"] - y["loss"] for x, y in zip(ha[2:], hc)]
    step_dir = os.path.join(root, "a", f"step_{RESUME_STEPS:09d}")
    nbytes = sum(os.path.getsize(os.path.join(step_dir, f)) for f in os.listdir(step_dir))
    ck = Checkpointer(os.path.join(root, "timed"))
    t0 = time.perf_counter()
    ck.save(RESUME_STEPS, a, blocking=True)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ck.save(RESUME_STEPS + 1, a)
    copy_s = time.perf_counter() - t0
    ck.wait()
    async_s = time.perf_counter() - t0
    shutil.rmtree(root, ignore_errors=True)
    if grad_compress and (a.err is None or c.err is None or not any(
            bool(e.any()) for _, e in _named_leaves(c.err))):
        raise AssertionError("the resumed run carries no gradient-compression error")
    out = {"layers": RESUME_LAYERS, "steps": RESUME_STEPS, "grad_compress": grad_compress,
           "losses": [h["loss"] for h in ha],
           "unbroken_vs_unbroken": {"leaves_differing": d_ab, "loss_diff": loss_ab},
           "unbroken_vs_resumed": {"leaves_differing": d_ac, "loss_diff": loss_ac},
           "checkpoint_bytes": nbytes, "checkpoint_write_s_blocking": write_s,
           "checkpoint_host_copy_s_async": copy_s, "checkpoint_write_s_async": async_s}
    log(f"  resume: {json.dumps(out)}")
    if not d_ab:
        if d_ac or any(loss_ac):
            raise AssertionError(f"unbroken runs are bit-identical but the resumed one "
                                 f"differs: {d_ac}, losses {loss_ac}")
    elif set(d_ac) - set(d_ab) or any(d_ac[k] > d_ab[k] for k in d_ac):
        raise AssertionError(f"the resumed run differs beyond the unbroken runs' own "
                             f"nondeterminism: {d_ac} vs {d_ab}")
    del a, b, c
    torch.cuda.empty_cache()
    return out


def train_full_width(torch, ops, device="cuda"):
    """Full-width, full-depth llama-paper-200m through ``train.loop.train``:
    TRAIN_STEPS steps of TRAIN_BATCH x TRAIN_SEQ tokens in TRAIN_MICRO
    microbatches, Quartet on every transformer linear through the kernels.
    Returns (summary, launch counts of the run)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.llama_paper import LEARNING_RATES
    from repro_torch.convert import init_params
    from repro_torch.data.pipeline import SyntheticC4Dataset, TokenBatcher
    from repro_torch.launch.serve_engine import kernel_config
    from repro_torch.models import build_model
    from repro_torch.optim import adamw, cosine_warmup
    from repro_torch.train.loop import train
    from repro_torch.train.steps import make_eval_step

    cfg = kernel_config(get_config(TRAIN_ARCH))
    model = build_model(cfg)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(SEED), device)
    n_params = sum(p.numel() for p in _leaves(params))
    batcher = TokenBatcher(SyntheticC4Dataset(cfg.vocab_size, seed=SEED), TRAIN_BATCH,
                           TRAIN_SEQ)
    opt = adamw(cosine_warmup(LEARNING_RATES[TRAIN_ARCH], TRAIN_STEPS))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    state, hist = train(model, opt, batcher, TRAIN_STEPS, microbatch=TRAIN_MICRO,
                        params=params, device=device, log_every=1,
                        log_fn=lambda m: log("  " + m))
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    vec = ops.vector_launches()
    peak = torch.cuda.max_memory_allocated() / 1e9
    del params
    losses = [h["loss"] for h in hist]
    gnorms = [h["grad_norm"] for h in hist]
    # the loss after the last step, on step 0's batch (the step losses are
    # each on their own batch, which differ by more than 5 steps move them)
    batch0 = {k: torch.from_numpy(v).to(device) for k, v in batcher.batch(0).items()}
    after = float(make_eval_step(model)(state.params, batch0)["nll"])
    if not all(math.isfinite(v) for v in losses + gnorms + [after]):
        raise AssertionError(f"non-finite training metrics: loss {losses}, gnorm {gnorms}, "
                             f"after {after}")
    if not after < losses[0]:
        raise AssertionError(f"loss on step 0's batch did not fall over {TRAIN_STEPS} steps: "
                             f"{losses[0]} -> {after}")
    # remat: each microbatch runs every quantized linear's forward twice
    # (2 B1 + 1 B3 each) and its backward once (4 B2 + 2 B3); the untied
    # lm-head stays bf16 and launches none
    linears = cfg.num_layers * 7
    per_mb = {"hadamard_quest_quantize": 4 * linears, "sr_hadamard_quantize": 4 * linears,
              "mxfp4_matmul": 4 * linears, "paged_attention": 0}
    predicted = {k: v * TRAIN_MICRO * TRAIN_STEPS for k, v in per_mb.items()}
    dts = sorted(h["dt"] for h in hist)
    med = dts[len(dts) // 2]
    summary = {"arch": TRAIN_ARCH, "params": n_params, "steps": TRAIN_STEPS,
               "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "microbatches": TRAIN_MICRO,
               "loss": losses, "loss_after_on_batch0": after, "grad_norm": gnorms,
               "step_s": [h["dt"] for h in hist],
               "median_step_s": med, "tokens_per_s_median_step": TRAIN_BATCH * TRAIN_SEQ / med,
               "tokens_per_s_run": TRAIN_STEPS * TRAIN_BATCH * TRAIN_SEQ / wall,
               "wall_s": wall, "peak_mem_gb": peak,
               "launches": counts, "predicted_launches": predicted,
               "vector_launches": vec}
    summary["breakdown"] = profile_train_step(torch, model, opt, state, batcher, device)
    summary["eval"], eval_counts = evaluate_full_width(torch, ops, model, state, device)
    del state
    torch.cuda.empty_cache()
    return summary, counts, eval_counts


def evaluate_full_width(torch, ops, model, state, device="cuda"):
    """``train.loop.evaluate`` of the trained state over EVAL_BATCHES
    held-out batches of EVAL_BATCH x TRAIN_SEQ, once with the training model
    (blocked attention) and once built with ``attn_backend="flash"``, every
    launch counter set to 0 just before each.  Returns (summary, launch
    counts of the flash run).

    Tolerance: |nll_flash − nll_blocked| <= 0.01 nats.  The two attentions
    round differently (bf16 outputs of f32 sums in another order), and a
    one-ulp change upstream can flip a QuEST rounding decision (ROADMAP C1),
    which moves single logits; the mean over 32768 tokens moves far less."""
    from repro_torch.data.pipeline import SyntheticC4Dataset, TokenBatcher
    from repro_torch.models import build_model
    from repro_torch.train.loop import evaluate

    cfg = model.cfg
    batcher = TokenBatcher(SyntheticC4Dataset(cfg.vocab_size, seed=SEED), EVAL_BATCH, TRAIN_SEQ)
    out, counts = {}, {}
    for backend, m in (("blocked", model), ("flash", build_model(cfg, attn_backend="flash"))):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out[f"nll_{backend}"] = evaluate(m, state, batcher, EVAL_BATCHES, device=device)
        out[f"wall_s_{backend}"] = time.perf_counter() - t0  # evaluate ends in host reads
        counts[backend] = ops.launch_counts()
        out[f"vector_launches_{backend}"] = ops.vector_launches()
    out["nll_diff"] = out["nll_flash"] - out["nll_blocked"]
    out["launches_blocked"], out["launches_flash"] = counts["blocked"], counts["flash"]
    log(f"  evaluation: {json.dumps(out)} (tolerance |Δnll| <= 0.01)")
    want = cfg.num_layers * EVAL_BATCHES
    if counts["flash"]["flash_attention"] != want or counts["blocked"]["flash_attention"]:
        raise AssertionError(f"flash_attention launches: flash-built {counts['flash']} "
                             f"(want {want}), blocked {counts['blocked']} (want 0)")
    if not (math.isfinite(out["nll_flash"]) and abs(out["nll_diff"]) <= 0.01):
        raise AssertionError(f"flash vs blocked evaluation nll out of tolerance: {out}")
    return out, counts["flash"]


KERNEL_NAMES = {"hadamard_quest_": "hadamard_quest_quantize",  # tile, rows and cols bodies
                "sr_hadamard_": "sr_hadamard_quantize",  # tile, rows and cols bodies
                "mxfp4_mma_kernel": "mxfp4_matmul", "paged_attention": "paged_attention"}


def _kind(name: str) -> str:
    for key, kernel in KERNEL_NAMES.items():
        if key in name:
            return kernel
    low = name.lower()
    if "gemm" in low or "xmma" in low or "cutlass" in low:
        return "library GEMM (lm-head, attention bmm, Hadamard epilogue)"
    return "other PyTorch kernels (elementwise, reductions, copies)"


def profile_train_step(torch, model, opt, state, batcher, device="cuda"):
    """Where one more full-width train step's time goes: device time by
    kernel kind from ``torch.profiler`` (kernels on one stream, so their
    sum over the step's wall time is the busy share), and, timed apart with
    a synchronised host clock, the lm-head + loss of one microbatch (forward
    and backward) and one AdamW update of all parameters."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.optim import apply_updates
    from repro_torch.train.losses import chunked_lm_loss
    from repro_torch.train.steps import make_train_step
    from repro_torch.tree import tree_map

    step_fn = make_train_step(model, opt, microbatch=TRAIN_MICRO)
    batch = {k: torch.from_numpy(v).to(device) for k, v in batcher.batch(TRAIN_STEPS).items()}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, m = step_fn(state, batch)
        float(m["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_kind = {}
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA"):
            continue
        us = getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
        by_kind[_kind(e.key)] = by_kind.get(_kind(e.key), 0.0) + us / 1e3
    busy = sum(by_kind.values())
    out = {"profiled_step_ms": wall * 1e3, "device_ms_by_kind": by_kind,
           "device_busy_ms": busy, "device_idle_share": 1 - busy / (wall * 1e3)}

    def host_ms(fn, reps=3):
        ts = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        return sorted(ts)[len(ts) // 2]

    cfg = model.cfg
    cparams = tree_map(lambda p: p.to(torch.bfloat16), state.params)
    feats = torch.randn((TRAIN_BATCH // TRAIN_MICRO, TRAIN_SEQ, cfg.d_model), device=device,
                        dtype=torch.bfloat16, requires_grad=True)
    labels = batch["labels"][:TRAIN_BATCH // TRAIN_MICRO]

    def head():
        loss, _ = chunked_lm_loss(model.head, cparams, feats, labels, 0)
        loss.backward()

    out["lm_head_loss_fwd_bwd_ms_per_microbatch"] = host_ms(head)
    out["adamw_update_ms"] = host_ms(lambda: apply_updates(
        state.params, opt.update(state.params, state.opt_state, state.params)[0]))
    return out


def time_training_kernels(torch, cfg, timer, device="cuda", K=None, N=None, T=TRAIN_TOKENS_MB,
                          tag="train"):
    """Each training kernel over the launches of one full-width linear (by
    default the up projection, K 1280, N 3456) in one microbatch of T
    tokens (16 x 512), beside its plain version, its least time and, where
    one exists, one PyTorch call computing the same function."""
    from repro_torch.core import fastrng
    from repro_torch.kernels import hadamard_quant as HQ
    from repro_torch.kernels import mxfp4_matmul as MM
    from repro_torch.kernels import sr_hadamard_quant as SR

    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    d, f = K or cfg.d_model, N or cfg.d_ff
    rec = {}

    # forward Stage 1: x [T, K] and the Wᵀ view, bf16
    x = torch.randn((T, d), generator=gen, device=device).to(torch.bfloat16)
    w = (torch.randn((d, f), generator=gen, device=device) / d**0.5).to(torch.bfloat16)
    n = x.numel() + w.numel()
    rec[("hadamard_quest_quantize", tag)] = dict(
        ms=timer(lambda: (HQ.hadamard_quest_quantize(x), HQ.hadamard_quest_quantize(w.t()))),
        device_ms=timer.device(lambda: (HQ.hadamard_quest_quantize(x),
                                        HQ.hadamard_quest_quantize(w.t()))),
        plain_ms=timer(lambda: (HQ.hadamard_quest_quantize_plain(x),
                                HQ.hadamard_quest_quantize_plain(w.t()))),
        bound_ms=n * (2 + 1 + 1 + 4 / 32) / H100_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=None, launches_per_linear_fwd=2)

    # backward Stage 1: the four operands (each element read once at its
    # width, 2 B for dy and dyᵀ, 4 B for Wq and xqᵀ; written as a 1 B code
    # and 4/32 B of scale), and B2_F32_OPS + B2_INT32_OPS operations an
    # element, bound by the int32 work at H100_INT32_OPS or by all of it at
    # the issue rate H100_F32_OPS, whichever is longer
    opnds = backward_operands(torch, d, f, gen, device, T)
    signs = {k: fastrng.rademacher(7, v.shape[1], salt=11, device=device)
             for k, v in opnds.items()}
    nbytes = sum(v.numel() * (v.element_size() + 1 + 4 / 32) for v in opnds.values())
    n_el = sum(v.numel() for v in opnds.values())
    by_bytes = nbytes / H100_BYTES_PER_S
    by_ops = max(n_el * B2_INT32_OPS / H100_INT32_OPS,
                 n_el * (B2_F32_OPS + B2_INT32_OPS) / H100_F32_OPS)

    def sr(fn):
        return lambda: [fn(v, signs[k], 7, 0.75, i) for i, (k, v) in enumerate(opnds.items(), 1)]

    rec[("sr_hadamard_quantize", tag)] = dict(
        ms=timer(sr(SR.sr_hadamard_quantize)),
        device_ms=timer.device(sr(SR.sr_hadamard_quantize)),
        plain_ms=timer(sr(SR.sr_hadamard_quantize_plain)),
        bound_ms=max(by_bytes, by_ops) * 1e3, bytes_ms=by_bytes * 1e3, ops_ms=by_ops * 1e3,
        bound_by="bytes" if by_bytes >= by_ops else "operations",
        device_ms_by_operand={k: timer.device(lambda k=k, i=i, v=v: SR.sr_hadamard_quantize(
            v, signs[k], 7, 0.75, i)) for i, (k, v) in enumerate(opnds.items(), 1)},
        library_ms=None, launches_per_linear_bwd=4)

    # the three GEMMs: forward, dx, dW, at their operand layouts
    xc, xs, _ = HQ.hadamard_quest_quantize(x)
    wc, ws, _ = HQ.hadamard_quest_quantize(w.t())
    q = {k: SR.sr_hadamard_quantize(v, signs[k], 7, 0.75, i)
         for i, (k, v) in enumerate(opnds.items(), 1)}
    args = [(xc, xs, wc.t(), ws.t()),
            (*q["dy"], q["Wq"][0].t(), q["Wq"][1].t()),
            (*q["xqᵀ"], q["dyᵀ"][0].t(), q["dyᵀ"][1].t())]
    deq = [(_deq(torch, a, sa).to(torch.bfloat16), _deq(torch, b.t(), sb.t()).to(torch.bfloat16).t())
           for a, sa, b, sb in args]
    nbytes = sum(a.numel() + sa.numel() * 4 + b.numel() + sb.numel() * 4
                 + a.shape[0] * b.shape[1] * 4 for a, sa, b, sb in args)
    nops = sum(2 * a.shape[0] * a.shape[1] * b.shape[1] for a, _, b, _ in args)
    by_bytes, by_ops = nbytes / H100_BYTES_PER_S, nops / H100_INT8_OPS
    rec[("mxfp4_matmul", tag)] = dict(
        ms=timer(lambda: [MM.mxfp4_matmul(*a) for a in args]),
        plain_ms=timer(lambda: [MM.mxfp4_matmul_plain(*a) for a in args]),
        bound_ms=max(by_bytes, by_ops) * 1e3,
        bound_by="bytes" if by_bytes >= by_ops else "operations",
        library_ms=timer(lambda: [torch.matmul(a, b) for a, b in deq]),
        launches_per_linear=3)
    return rec


# ---------------------------------------------------------------------------
# phase 4b: MoE training
# ---------------------------------------------------------------------------


def moe_train_config():
    from repro_torch.configs import get_config
    from repro_torch.launch.serve_engine import kernel_config

    return kernel_config(dataclasses.replace(get_config(MOE_ARCH), num_layers=MOE_TRAIN_LAYERS))


def _expert_seeds(torch, E, device):
    """E per-expert seeds spaced as ``models.moe._expert_ffn`` spaces a
    layer's (seed_fold of consecutive values: 1000003 apart), placed so that
    half of them are 2^31 or more."""
    seeds = (2**31 + 1000003 * (torch.arange(E, device=device) - E // 2)) & 0xFFFFFFFF
    if not bool((seeds >= 2**31).any()) or not bool((seeds < 2**31).any()):
        raise AssertionError("the expert seeds do not straddle 2^31")
    return seeds


def moe_backward_operands(torch, E, T, K, N, gen, device="cuda"):
    """The four backward Stage-1 operands of one full-width expert linear
    [E, K, N] over T tokens an expert, as ``quartet._backward_experts_kernels``
    passes them: dy [E, T, N] (bf16, row-major), and three views with unit
    stride along their rows: Wq [E, K, N] (the transpose of the dequantized
    [E, N, K] weight codes, bf16), xqᵀ [E, K, T] and dyᵀ [E, N, T]."""
    from repro_torch.core.quartet import _dequant_codes
    from repro_torch.kernels import hadamard_quant as HQ

    x = (torch.randn((E, T, K), generator=gen, device=device) * 1.9).to(torch.bfloat16)
    w = (torch.randn((E, K, N), generator=gen, device=device) / K**0.5).to(torch.bfloat16)
    dy = (torch.randn((E, T, N), generator=gen, device=device) * 1e-3).to(torch.bfloat16)
    xc, xs, _ = HQ.hadamard_quest_quantize_experts(x)
    wc, ws, _ = HQ.hadamard_quest_quantize_experts(w.transpose(-1, -2))
    del x, w
    return {"dy": dy, "Wq": _dequant_codes(wc, ws, 32, torch.bfloat16).transpose(-1, -2),
            "xqᵀ": _dequant_codes(xc, xs, 32, torch.bfloat16).transpose(-1, -2),
            "dyᵀ": dy.transpose(-1, -2)}


class RecordingOps:
    """``ops`` (the kernels' wrappers or PlainOps) with every expert-axis B2
    output kept, in call order."""

    def __init__(self, ops):
        self.ops, self.b2 = ops, []

    def sr_hadamard_quantize_experts(self, *a, **k):
        out = self.ops.sr_hadamard_quantize_experts(*a, **k)
        self.b2.append(out)
        return out

    def mxfp4_matmul_experts(self, *a):
        return self.ops.mxfp4_matmul_experts(*a)


def check_moe_train_kernels(torch, cfg, device="cuda"):
    """B2's expert axis at the backward's shapes of one full-width MoE layer
    (128 experts, MOE_TRAIN_CAPACITY tokens an expert): the four operands of
    the gate/up linears (K 4096, N 1536) and of the down linear (K 1536, N
    4096), seeds straddling 2^31, codes and scales against the plain version
    and against E launches of the 2-d kernel, bit for bit; then one
    full-width ``quartet_linear_experts`` backward (the gate linear, all
    experts) on the kernels against the same backward on the plain versions:
    every B2 output bit for bit, dx and dW within rtol 1e-5 and
    atol 1e-6·max|plain| (the dense check's: the same codes, f32 products
    the same on both sides).  Raises on a mismatch; returns max |Δ|."""
    from repro_torch.core import fastrng
    from repro_torch.core.quartet import (QuartetConfig, _backward_experts_kernels,
                                          _forward_experts_kernels)
    from repro_torch.kernels import ops as K
    from repro_torch.kernels import sr_hadamard_quant as SR

    gen = torch.Generator(device=device).manual_seed(SEED + 11)
    E, d, f, T = cfg.num_experts, cfg.d_model, cfg.d_ff, MOE_TRAIN_CAPACITY
    seeds = _expert_seeds(torch, E, device)
    plain = PlainOps()
    for proj, Kd, N in (("gate/up", d, f), ("down", f, d)):
        opnds = moe_backward_operands(torch, E, T, Kd, N, gen, device)
        for salt, (name, x) in enumerate(opnds.items(), 1):
            signs = fastrng.rademacher(seeds, x.shape[2], salt=11 if salt < 3 else 12,
                                       device=device)
            before = SR.sr_hadamard_quantize.vector_launches
            got = SR.sr_hadamard_quantize_experts(x, signs, seeds, salt=salt)
            if x.is_cuda and SR.sr_hadamard_quantize.vector_launches != before + 1:
                raise AssertionError(f"B2 experts {proj} {name}: took its tile body")
            want = plain.sr_hadamard_quantize_experts(x, signs, seeds, salt=salt)
            for g, w, what in zip(got, want, ("codes", "scales")):
                if not torch.equal(g, w):
                    raise AssertionError(f"B2 experts {proj} {name} {tuple(x.shape)} (strides "
                                         f"{x.stride()}): {what} differ from the plain version "
                                         f"at {int((g != w).sum())}")
            for e in range(E):
                two = SR.sr_hadamard_quantize(x[e], signs[e], int(seeds[e]), salt=salt)
                if not (torch.equal(got[0][e], two[0]) and torch.equal(got[1][e], two[1])):
                    raise AssertionError(f"B2 experts {proj} {name}: expert {e} (seed "
                                         f"{int(seeds[e])}) differs from a 2-d launch")
            del got, want
        del opnds
    torch.cuda.empty_cache()

    qc = QuartetConfig(use_kernels=True)
    x = (torch.randn((E, T, d), generator=gen, device=device) * 1.9).to(torch.bfloat16)
    w = (torch.randn((E, d, f), generator=gen, device=device) / d**0.5).to(torch.bfloat16)
    dy = (torch.randn((E, T, f), generator=gen, device=device) * 1e-3).to(torch.bfloat16)
    _, res = _forward_experts_kernels(x, w, qc)
    rk, rp = RecordingOps(K), RecordingOps(plain)
    dx, dw = _backward_experts_kernels(qc, seeds, res, dy, ops=rk)
    pdx, pdw = _backward_experts_kernels(qc, seeds, res, dy, ops=rp)
    for i, (a, b) in enumerate(zip(rk.b2, rp.b2)):
        if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
            raise AssertionError(f"expert backward: B2 operand {i + 1}'s codes differ between "
                                 f"the kernels and the plain versions")
    err = {}
    for name, a, b in (("dx", dx, pdx), ("dW", dw, pdw)):
        if not torch.allclose(a, b, rtol=1e-5, atol=1e-6 * float(b.abs().max())):
            raise AssertionError(f"expert backward {name}: kernels vs plain max |Δ| "
                                 f"{float((a - b).abs().max())} (max |plain| "
                                 f"{float(b.abs().max())})")
        err[name] = float((a - b).abs().max())
    log(f"  expert-linear backward (gate, {E} experts x {T} tokens, K {d}, N {f}): B2 codes "
        f"bit-exact, max |Δ| kernels vs plain {json.dumps(err)}")
    del x, w, dy, res, rk, rp, dx, dw, pdx, pdw
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return {"sr_hadamard_quantize_experts": 0.0, "quartet_linear_experts backward":
            max(err.values())}


def _to_device(torch, tree, dev):
    """A train state (named tuple, dicts, tensors, int step counters) on ``dev``."""
    if isinstance(tree, dict):
        return {k: _to_device(torch, v, dev) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_to_device(torch, v, dev) for v in tree))
    return tree.to(dev) if isinstance(tree, torch.Tensor) else tree


def train_moe_reduced_card_vs_cpu(torch, device="cuda"):
    """Reduced qwen3-moe (f32 compute, bf16 master, the 8-bit AdamW, aux
    weight 0.01) 3 steps on the card with the kernels and on the CPU with the
    plain versions, each step from the CPU run's state on both (the 8-bit
    moments amplify a last-bit difference without bound, so free runs part
    after a step or two; tests/test_torch_moe_train.py says why).  Also
    ``moe_ffn``'s backward once under ``set_sync_debug_mode("error")``: no
    host sync.  Returns the relative differences.

    Tolerance (equal states): at step 0 loss, aux, nll and grad-norm rtol
    1e-5 (the dense check's step-0 bound); at steps 1 and 2 loss, aux and
    nll 1e-3 and grad-norm 3e-2 (the dense check's every-step bound).  The
    kernels equal their plain versions bit for bit, but the rest of the step
    rounds differently on the card (ROADMAP C4 and Queue C).
    ``tools/moe_route_tie_probe.py`` finds at step 0 no routing choice that
    differs (the closest experts 8350 ulps apart); rmsnorm (one summation
    order, a float64 root) and rope (one table a forward, cos/sin in
    float64) give the CPU's bits, and the only op that differs on equal
    inputs is ``blocked_attention`` (its softmax's exp and sums, ≤ 1.04e-7
    relative): step 0 reads loss 7.1e-8, aux 0, nll 7.1e-8, grad-norm
    3.4e-7 (before rope's repair 8.2e-5, 1.1e-4, 8.2e-5, 2.7e-4); step 1's
    grad-norm 2.5e-3, its loss equal."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.convert import init_params
    from repro_torch.data.pipeline import SyntheticC4Dataset, TokenBatcher
    from repro_torch.launch.serve_engine import kernel_config
    from repro_torch.models import build_model
    from repro_torch.models.moe import moe_ffn
    from repro_torch.optim import adamw8bit, cosine_warmup
    from repro_torch.train.state import make_train_state
    from repro_torch.train.steps import make_train_step

    cfg = kernel_config(get_reduced_config(MOE_ARCH, dtype="float32"))
    model = build_model(cfg)
    opt = adamw8bit(cosine_warmup(1e-3, 3))
    step = make_train_step(model, opt, aux_weight=0.01)
    cpu = make_train_state(init_params(cfg, torch.Generator().manual_seed(SEED), "cpu"), opt,
                           "bfloat16")
    batcher = TokenBatcher(SyntheticC4Dataset(cfg.vocab_size, seed=SEED), 8, 64)
    rel, bad = {}, []
    for i in range(3):
        b = batcher.batch(i)
        card = _to_device(torch, cpu, device)
        card, mc = step(card, {k: torch.from_numpy(v).to(device) for k, v in b.items()})
        cpu, mp = step(cpu, {k: torch.from_numpy(v) for k, v in b.items()})
        tols = ({"loss": 1e-5, "aux": 1e-5, "nll": 1e-5, "grad_norm": 1e-5} if i == 0 else
                {"loss": 1e-3, "aux": 1e-3, "nll": 1e-3, "grad_norm": 3e-2})
        for key, tol in tols.items():
            r = abs(float(mc[key]) - float(mp[key])) / abs(float(mp[key]))
            rel.setdefault(key, []).append(r)
            if r > tol:
                bad.append((i, key, float(mc[key]), float(mp[key])))
    log(f"  reduced MoE train, card vs CPU from equal states, relative differences by step: "
        f"{json.dumps(rel)} (tolerance at step 0: loss, aux, nll, grad-norm 1e-5; then "
        f"1e-3 and 3e-2)")
    if bad:
        raise AssertionError(f"reduced MoE training: card vs CPU out of tolerance: {bad}")
    # the backward of one MoE layer reads nothing back to the host
    layer0 = _tree_map(lambda t: t[0].detach().clone().requires_grad_(),
                       _to_device(torch, cpu.params["layers"]["moe"], device))
    x = torch.randn((2, 64, cfg.d_model), generator=torch.Generator(device=device)
                    .manual_seed(SEED), device=device, requires_grad=True)
    torch.cuda.set_sync_debug_mode("error")
    try:
        y, aux = moe_ffn(layer0, x, 0, cfg, "quartet")
        torch.autograd.grad((y.float().square().mean() + aux), [x, *_leaves(layer0)])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return rel


def train_moe_full_width(torch, ops, device="cuda"):
    """qwen3-moe-235b-a22b at its published widths, MOE_TRAIN_LAYERS of its
    94 layers, through ``train.loop.train``: MOE_TRAIN_STEPS steps of
    MOE_TRAIN_BATCH x TRAIN_SEQ tokens (one group of 4096 tokens, capacity
    320 an expert), the 8-bit AdamW with a bf16 master, Quartet on every
    transformer linear through the kernels.  Every launch counter is set to
    0 just before the run and read just after, against the prediction.
    Returns (summary, launch counts, vector-body launches)."""
    from repro_torch.data.pipeline import SyntheticC4Dataset, TokenBatcher
    from repro_torch.kernels import sr_hadamard_quant as SR
    from repro_torch.models import build_model
    from repro_torch.optim import adamw8bit, cosine_warmup
    from repro_torch.train.loop import train
    from repro_torch.train.steps import make_train_step

    cfg = moe_train_config()
    model = build_model(cfg)
    batcher = TokenBatcher(SyntheticC4Dataset(cfg.vocab_size, seed=SEED), MOE_TRAIN_BATCH,
                           TRAIN_SEQ)
    opt = adamw8bit(cosine_warmup(3e-4, MOE_TRAIN_STEPS))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    state, hist = train(model, opt, batcher, MOE_TRAIN_STEPS, master_dtype="bfloat16",
                        seed=SEED, device=device, log_every=1, log_fn=lambda m: log("  " + m))
    wall = time.perf_counter() - t0
    counts, vec = ops.launch_counts(), ops.vector_launches()
    experts_b2 = SR.sr_hadamard_quantize.expert_launches
    peak = torch.cuda.max_memory_allocated() / 1e9
    total = torch.cuda.get_device_properties(0).total_memory / 1e9
    # remat: each linear runs its forward twice (2 B1 + 1 B3 each) and its
    # backward once (4 B2 + 2 B3); the 4 attention linears and the 3 expert
    # linears (each one expert-axis launch per Stage) are the 7 of a layer;
    # the router and the untied lm-head are bf16
    per_step = MOE_TRAIN_LAYERS * 7 * 4
    predicted = dict.fromkeys(counts, 0)
    predicted.update(hadamard_quest_quantize=per_step * MOE_TRAIN_STEPS,
                     sr_hadamard_quantize=per_step * MOE_TRAIN_STEPS,
                     mxfp4_matmul=per_step * MOE_TRAIN_STEPS)
    experts_predicted = MOE_TRAIN_LAYERS * 3 * 4 * MOE_TRAIN_STEPS
    losses = [h["loss"] for h in hist]
    auxes = [h["aux"] for h in hist]
    gnorms = [h["grad_norm"] for h in hist]
    dts = sorted(h["dt"] for h in hist)
    med = dts[len(dts) // 2]
    leaves = _leaves({"params": state.params, "opt": state.opt_state})
    moments = _leaves(state.opt_state)
    n_params = sum(p.numel() for p in _leaves(state.params))
    summary = {"arch": cfg.name, "layers": f"{MOE_TRAIN_LAYERS} of 94", "params": n_params,
               "steps": MOE_TRAIN_STEPS, "batch": MOE_TRAIN_BATCH, "seq": TRAIN_SEQ,
               "microbatches": 1, "optimizer": "adamw8bit", "master": "bfloat16",
               "loss": losses, "aux": auxes, "grad_norm": gnorms,
               "step_s": [h["dt"] for h in hist], "median_step_s": med,
               "tokens_per_s_median_step": MOE_TRAIN_BATCH * TRAIN_SEQ / med,
               "tokens_per_s_run": MOE_TRAIN_STEPS * MOE_TRAIN_BATCH * TRAIN_SEQ / wall,
               "wall_s_with_init": wall, "peak_mem_gb": peak, "card_mem_gb": total,
               "state_checkpoint_bytes": sum(t.numel() * t.element_size() for t in leaves
                                             if isinstance(t, torch.Tensor)),
               "moments_8bit_checkpoint_bytes": sum(t.numel() * t.element_size()
                                                    for t in moments
                                                    if isinstance(t, torch.Tensor)),
               "launches": counts, "predicted_launches": predicted,
               "b2_expert_axis_launches": experts_b2,
               "b2_expert_axis_launches_predicted": experts_predicted,
               "vector_launches": vec}
    if not all(math.isfinite(v) for v in losses + auxes + gnorms):
        raise AssertionError(f"non-finite MoE training metrics: loss {losses}, aux {auxes}, "
                             f"gnorm {gnorms}")
    if counts != predicted or experts_b2 != experts_predicted:
        raise AssertionError(f"MoE training launches {counts} (B2 expert axis {experts_b2}) != "
                             f"predicted {predicted} ({experts_predicted})")
    if peak >= total:
        raise AssertionError(f"MoE training peak memory {peak} GB >= the card's {total} GB")

    # one more step under the profiler: device time by kernel kind, and the
    # busy share of the step's wall time (kernels on one stream)
    from torch.profiler import ProfilerActivity, profile

    step_fn = make_train_step(model, opt)
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in batcher.batch(MOE_TRAIN_STEPS).items()}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        new, m = step_fn(state, batch)
        float(m["loss"])
        torch.cuda.synchronize()
        step_wall = time.perf_counter() - t1
    del new
    by_kind = {}
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA"):
            continue
        us = getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
        by_kind[_kind(e.key)] = by_kind.get(_kind(e.key), 0.0) + us / 1e3
    busy = sum(by_kind.values())
    summary["breakdown"] = {"profiled_step_ms": step_wall * 1e3, "device_ms_by_kind": by_kind,
                            "device_busy_ms": busy,
                            "device_idle_share": 1 - busy / (step_wall * 1e3)}

    # the router's forward and backward over this batch, a [B, 1] column at
    # a time (as the card runs it) against one GEMM over all tokens: host
    # clock around synchronised work, median of 3 (a step runs the forward
    # twice under remat and the backward once, a layer)
    from repro_torch.models.moe import _router_logits

    w = state.params["layers"]["moe"]["router"]["w"][0].detach().requires_grad_()
    xr = (torch.randn((MOE_TRAIN_BATCH, TRAIN_SEQ, cfg.d_model), device=device)
          .to(torch.bfloat16).requires_grad_())

    def host_ms(fn, reps=3):
        ts = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t1) * 1e3)
        return sorted(ts)[len(ts) // 2]

    def router(logits_fn):
        return lambda: torch.autograd.grad(logits_fn().sum(), (xr, w))

    summary["router_fwd_bwd_ms"] = {
        "columns": host_ms(router(lambda: _router_logits(w, xr))),
        "one_gemm": host_ms(router(lambda: xr.float() @ w.float()))}
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return summary, counts, vec


def time_moe_train_kernels(torch, cfg, timer, device="cuda"):
    """B1, B2 and B3 over the launches of one full-width expert linear (the
    gate: 128 experts, K 4096, N 1536, MOE_TRAIN_CAPACITY tokens an expert)
    in one training step: B1 on x and on the weights' transposed view
    (forward), B2 on the four backward operands, B3 for the forward, dx and
    dW; each beside its bound, its plain version (timed once: it runs
    seconds) and, for B3, one ``torch.bmm`` in bf16 on the dequantized
    operands."""
    from repro_torch.core import fastrng
    from repro_torch.kernels import hadamard_quant as HQ
    from repro_torch.kernels import mxfp4_matmul as MM
    from repro_torch.kernels import sr_hadamard_quant as SR

    once = Timer(torch, reps=1)
    plain = PlainOps()
    gen = torch.Generator(device=device).manual_seed(SEED + 13)
    E, d, f, T = cfg.num_experts, cfg.d_model, cfg.d_ff, MOE_TRAIN_CAPACITY
    seeds = _expert_seeds(torch, E, device)
    rec = {}
    x = (torch.randn((E, T, d), generator=gen, device=device) * 1.9).to(torch.bfloat16)
    w = (torch.randn((E, d, f), generator=gen, device=device) / d**0.5).to(torch.bfloat16)
    fwd = [x, w.transpose(-1, -2)]
    n = sum(t.numel() for t in fwd)
    rec[("hadamard_quest_quantize", "moe train")] = dict(
        ms=timer(lambda: [HQ.hadamard_quest_quantize_experts(t) for t in fwd]),
        device_ms=timer.device(lambda: [HQ.hadamard_quest_quantize_experts(t) for t in fwd]),
        plain_ms=once(lambda: [plain.hadamard_quest_quantize_experts(t) for t in fwd]),
        bound_ms=n * (2 + 1 + 1 + 4 / 32) / H100_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=None, launches_per_linear_fwd=len(fwd))

    opnds = moe_backward_operands(torch, E, T, d, f, gen, device)
    signs = {k: fastrng.rademacher(seeds, v.shape[2], salt=11 if i < 3 else 12, device=device)
             for i, (k, v) in enumerate(opnds.items(), 1)}
    # as the 2-d B2's record: each element read once at its width (all bf16
    # here) and written as a 1 B code and 4/32 B of scale; B2_F32_OPS +
    # B2_INT32_OPS operations an element
    nbytes = sum(v.numel() * (v.element_size() + 1 + 4 / 32) for v in opnds.values())
    n_el = sum(v.numel() for v in opnds.values())
    by_bytes = nbytes / H100_BYTES_PER_S
    by_ops = max(n_el * B2_INT32_OPS / H100_INT32_OPS,
                 n_el * (B2_F32_OPS + B2_INT32_OPS) / H100_F32_OPS)

    def sr(fn):
        return lambda: [fn(v, signs[k], seeds, 0.75, i)
                        for i, (k, v) in enumerate(opnds.items(), 1)]

    rec[("sr_hadamard_quantize_experts", "moe train")] = dict(
        ms=timer(sr(SR.sr_hadamard_quantize_experts)),
        device_ms=timer.device(sr(SR.sr_hadamard_quantize_experts)),
        plain_ms=once(sr(plain.sr_hadamard_quantize_experts)),
        bound_ms=max(by_bytes, by_ops) * 1e3, bytes_ms=by_bytes * 1e3, ops_ms=by_ops * 1e3,
        bound_by="bytes" if by_bytes >= by_ops else "operations",
        device_ms_by_operand={k: timer.device(lambda k=k, i=i, v=v: SR.sr_hadamard_quantize_experts(
            v, signs[k], seeds, 0.75, i)) for i, (k, v) in enumerate(opnds.items(), 1)},
        library_ms=None, launches_per_linear_bwd=4)

    xc, xs, _ = HQ.hadamard_quest_quantize_experts(x)
    wc, ws, _ = HQ.hadamard_quest_quantize_experts(w.transpose(-1, -2))
    q = {k: SR.sr_hadamard_quantize_experts(v, signs[k], seeds, 0.75, i)
         for i, (k, v) in enumerate(opnds.items(), 1)}
    tr = lambda t: t.transpose(-1, -2)  # noqa: E731
    args = [(xc, xs, tr(wc), tr(ws)), (*q["dy"], tr(q["Wq"][0]), tr(q["Wq"][1])),
            (*q["xqᵀ"], tr(q["dyᵀ"][0]), tr(q["dyᵀ"][1]))]
    del opnds, q
    deq = [(_deq3(torch, a, s), tr(_deq3(torch, tr(b), tr(t)))) for a, s, b, t in args]
    nbytes = sum(a.numel() + s.numel() * 4 + b.numel() + t.numel() * 4
                 + a.shape[0] * a.shape[1] * b.shape[2] * 4 for a, s, b, t in args)
    nops = sum(2 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2] for a, _, b, _ in args)
    rec[("mxfp4_matmul_experts", "moe train")] = dict(
        ms=timer(lambda: [MM.mxfp4_matmul_experts(*a) for a in args]),
        device_ms=timer.device(lambda: [MM.mxfp4_matmul_experts(*a) for a in args]),
        plain_ms=once(lambda: [plain.mxfp4_matmul_experts(*a) for a in args]),
        bound_ms=max(nbytes / H100_BYTES_PER_S, nops / H100_INT8_OPS) * 1e3,
        bound_by="bytes" if nbytes / H100_BYTES_PER_S >= nops / H100_INT8_OPS
        else "operations",
        library_ms=timer(lambda: [torch.bmm(a, b) for a, b in deq]),
        launches_per_linear=len(args))
    del args, deq, x, w
    for (name, tag), r in rec.items():
        log(f"  [times] {name} {tag} (one full-width expert linear, NVIDIA H100 figures of "
            f"this run): {json.dumps(r)}")
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------


SOURCES = {
    "hadamard_quest_quantize": ("src/repro_torch/csrc/hadamard_quant.cu",
                                "src/repro/kernels/hadamard_quant.py:73"),
    "sr_hadamard_quantize": ("src/repro_torch/csrc/sr_hadamard_quant.cu",
                             "src/repro/kernels/sr_hadamard_quant.py:69"),
    "mxfp4_matmul": ("src/repro_torch/csrc/mxfp4_matmul.cu",
                     "src/repro/kernels/mxfp4_matmul.py:61"),
    "paged_attention": ("src/repro_torch/csrc/paged_attention.cu",
                        "src/repro/kernels/paged_attention.py:238"),
    "kv_quant_pack": ("src/repro_torch/csrc/kv_pack.cu", "src/repro/kernels/kv_pack.py:101"),
    "kv_dequant_unpack": ("src/repro_torch/csrc/kv_pack.cu",
                          "src/repro/kernels/kv_pack.py:140"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:81"),
}
# each kernel's own path (launch counts) and the timing record of its line
PATH_OF = {"hadamard_quest_quantize": ("train", "train"),
           "sr_hadamard_quantize": ("train", "train"), "mxfp4_matmul": ("train", "train"),
           "paged_attention": ("engine", "decode"), "kv_quant_pack": ("engine", "decode"),
           "kv_dequant_unpack": ("gather", "gather"), "flash_attention": ("eval", "eval")}


def variant_configs():
    """The Quartet variants the paper compares Quartet with, by name."""
    from repro_torch.core.quartet import FP8_CONFIG, QuartetConfig

    return {"fp8": FP8_CONFIG,
            "fwd_rtn_absmax": QuartetConfig(fwd_quantizer="rtn_absmax"),
            "fwd_sr_absmax": QuartetConfig(fwd_quantizer="sr_absmax"),
            "bwd_rtn": QuartetConfig(bwd_rounding="rtn"),
            "bwd_unquantized": QuartetConfig(bwd_rounding="none", bwd_hadamard="none"),
            "bwd_fixed_hadamard": QuartetConfig(bwd_hadamard="fixed"),
            "mxfp8_quest": QuartetConfig(fwd_format="mxfp8", bwd_format="mxfp8")}


def quantizer_edge_rows(torch, fmt, k: int):
    """Rows of k for ``fmt``: zeros; blocks whose absmax/max sits around
    2^-10 and around 464 (NVFP4's E4M3 scale underflows to 0 and overflows
    to NaN there); grid midpoints (ties) beside the grid's max (scale 1); and
    blocks whose absmax/max is 2^e (1 - j 2^-24), j = 0..39, the E8M0 floor
    rule's edges."""
    gen = torch.Generator().manual_seed(SEED + 1)
    block = fmt.block or k
    rows = [torch.zeros(k)]
    for s in (2.0**-10 * 0.999, 2.0**-10, 2.0**-10 * 1.5, 448.0, 464.0, 465.0, 500.0):
        r = torch.rand(k, generator=gen) * 2 - 1
        r[::block] = 1.0
        rows.append(r * s * fmt.max_value)
    grid = torch.tensor(fmt.grid_array)
    mids = (grid[1:] + grid[:-1]) / 2
    tie = mids.repeat(k // len(mids) + 1)[:k].clone()
    tie[::block] = fmt.max_value
    rows.append(tie)
    for e in (-20, 0, 7):
        j = torch.arange(k // block if fmt.block else 1, dtype=torch.int32) % 40
        top = ((torch.tensor(2.0**e).view(torch.int32) - j).view(torch.float32)
               * fmt.max_value)
        r = (torch.rand(k, generator=gen) * 2 - 1) * 0.5 * top.repeat_interleave(block)[:k]
        r[::block] = top[: len(r[::block])]
        rows.append(r)
    return torch.stack(rows).to(torch.float32)


def _quantize_both(Q, threefry, name, x, fmt):
    if name == "sr_absmax":
        return Q.sr_absmax(x, threefry.prng_key(3), fmt)
    if name == "sr_absmax_fast":
        return Q.sr_absmax_fast(x, 5, fmt, "ceil", 2)
    if name == "rtn_absmax_floor":
        return Q.rtn_absmax(x, fmt, "floor")
    return getattr(Q, name)(x, fmt)


def check_quantizers_card_vs_cpu(torch, cfg, device="cuda"):
    """Every format x every quantizer (and RTN-AbsMax with E8M0-floor scales)
    on a [VARIANT_ROWS, d_model] activation plus :func:`quantizer_edge_rows`,
    on the card and on the CPU: codes, scales, values and masks bit for bit,
    NaN at the same places.  Returns NaN counts and the wrapped codes seen."""
    from repro_torch.core import formats as F
    from repro_torch.core import quantizers as Q
    from repro_torch.core import threefry

    gen = torch.Generator().manual_seed(SEED)
    k = cfg.d_model
    base = torch.randn((VARIANT_ROWS, k), generator=gen) * torch.exp2(
        torch.randint(-8, 8, (VARIANT_ROWS, 1), generator=gen).to(torch.float32))
    out, bad = {}, []
    for fname, fmt in F.FORMATS.items():
        if not fmt.grid:
            continue
        x = torch.cat([base, quantizer_edge_rows(torch, fmt, k)])
        xc = x.to(device)
        names = ["rtn_absmax", "sr_absmax", "quest", "rtn_absmax_pma", "sr_absmax_fast"]
        if fmt.scale_dtype == "e8m0":
            names.append("rtn_absmax_floor")
        for qname in names:
            card = _quantize_both(Q, threefry, qname, xc, fmt)
            host = _quantize_both(Q, threefry, qname, x, fmt)
            for field, a, b in zip(card._fields, card, host):
                a = a.cpu()
                if a.dtype == torch.float32:
                    same = (a.view(torch.int32) == b.view(torch.int32)) | (a.isnan() & b.isnan())
                else:
                    same = a == b
                if not bool(same.all()):
                    bad.append((fname, qname, field, int((~same).sum())))
            out.setdefault(fname, {})[qname] = {
                "nan_values": int(host.values.isnan().sum()),
                "negative_codes_of_positive_values": int(((host.codes < 0)
                                                          & (host.values > 0)).sum())}
    if bad:
        raise AssertionError(f"quantizers differ between the card and the CPU: {bad}")
    return out


def table2_on_card(torch, device="cuda"):
    """Table 2 through the port's twin on the card: rows beside the paper's;
    QuEST < RTN < SR in MSE, as the original asserts."""
    from repro_torch.benchmarks import table2_quantizer_metrics as T2

    rows = T2.run(device)
    for name, us, value in rows:
        log(f"  {name}: {value} ({us:.0f} us)")
    if rows[-1][2] != "PASS":
        raise AssertionError(f"Table 2 ordering QuEST < RTN < SR in MSE failed: {rows}")
    return {name: value for name, _, value in rows}


def train_variants(torch, device="cuda"):
    """llama-paper-200m at its published widths, VARIANT_LAYERS layers, under
    each Quartet variant on the plain path through ``train.loop.train``
    (VARIANT_STEPS steps of VARIANT_BATCH x TRAIN_SEQ tokens, random weights
    and data from SEED), and one step of Quartet on the kernels beside them.
    Returns each configuration's losses, grad-norms and step times; every
    value must be finite."""
    from repro_torch.configs import get_config
    from repro_torch.configs.llama_paper import LEARNING_RATES
    from repro_torch.data.pipeline import SyntheticC4Dataset, TokenBatcher
    from repro_torch.launch.serve_engine import kernel_config
    from repro_torch.models import build_model
    from repro_torch.optim import adamw, cosine_warmup
    from repro_torch.train.loop import train

    base = dataclasses.replace(get_config(TRAIN_ARCH), num_layers=VARIANT_LAYERS)
    batcher = TokenBatcher(SyntheticC4Dataset(base.vocab_size, seed=SEED), VARIANT_BATCH,
                           TRAIN_SEQ)
    runs = {name: (dataclasses.replace(base, quartet=qc), VARIANT_STEPS)
            for name, qc in variant_configs().items()}
    runs["quartet_kernels"] = (kernel_config(base), 1)
    out = {}
    for name, (cfg, steps) in runs.items():
        opt = adamw(cosine_warmup(LEARNING_RATES[TRAIN_ARCH], steps))
        _, hist = train(build_model(cfg), opt, batcher, steps, device=device, log_every=0,
                        seed=SEED)
        dts = [h["dt"] for h in hist]
        out[name] = {"loss": [h["loss"] for h in hist],
                     "grad_norm": [h["grad_norm"] for h in hist],
                     "step_s": dts, "median_step_s": statistics.median(dts)}
        log(f"  {name}: {json.dumps(out[name])}")
        vals = out[name]["loss"] + out[name]["grad_norm"]
        if not all(math.isfinite(v) for v in vals):
            raise AssertionError(f"variant {name}: non-finite loss or grad-norm {out[name]}")
        gc.collect()
        torch.cuda.empty_cache()
    return out


def check_nvfp4_linear(torch, cfg, device="cuda"):
    """One llama-paper-200m linear (x [VARIANT_ROWS, d_model], W [d_model,
    d_ff]) under NVFP4 at group 16, forward and backward at upstream-gradient
    scales 1 and 1e-3, on the card against the port on the CPU: NaN at the
    same places, the rest within 1e-3 of its norm (f32 GEMMs and the
    Hadamard round differently on the two, and a last-bit difference can
    move a stochastic rounding by a grid step, ROADMAP C4).  The reference's
    E4M3 scales of 0 (ROADMAP C7) are reproduced, not repaired."""
    from repro_torch.core.quartet import QuartetConfig, quartet_linear

    qc = QuartetConfig(fwd_format="nvfp4", bwd_format="nvfp4", group=16)
    gen = torch.Generator().manual_seed(SEED + 2)
    x = torch.randn((VARIANT_ROWS, cfg.d_model), generator=gen)
    w = torch.randn((cfg.d_model, cfg.d_ff), generator=gen) / math.sqrt(cfg.d_model)
    out = {}
    for scale in (1.0, 1e-3):
        dy = torch.randn((VARIANT_ROWS, cfg.d_ff), generator=gen) * scale
        res = {}
        for dev in (device, "cpu"):
            xd, wd = x.to(dev).requires_grad_(), w.to(dev).requires_grad_()
            y = quartet_linear(xd, wd, 11, qc)
            dx, dw = torch.autograd.grad(y, [xd, wd], dy.to(dev))
            res[dev] = [t.detach().cpu() for t in (y, dx, dw)]
        rec = {}
        for name, a, b in zip(("y", "dx", "dW"), res[device], res["cpu"]):
            if not torch.equal(a.isnan(), b.isnan()):
                raise AssertionError(f"NVFP4 {name} at scale {scale}: NaN places differ")
            fin = ~b.isnan()
            err = float((a[fin] - b[fin]).norm() / b[fin].norm().clamp_min(1e-30))
            rec[name] = {"nan": int(b.isnan().sum()), "zero": int((b == 0).sum()),
                         "numel": b.numel(), "rel_err": err}
            if err > 1e-3:
                raise AssertionError(f"NVFP4 {name} at scale {scale}: card vs CPU {err}")
        out[str(scale)] = rec
    return out


def check_kernel_raise(torch, device="cuda"):
    """``use_kernels=True`` with a variant the kernels do not compute raises
    (ROADMAP C6) in ``quartet_linear`` and in ``kernel_config``."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.core.quartet import FP8_CONFIG, quartet_linear
    from repro_torch.launch.serve_engine import kernel_config

    x, w = torch.zeros((64, 128), device=device), torch.zeros((128, 64), device=device)
    raised = 0
    for call in (lambda: quartet_linear(x, w, 0, dataclasses.replace(FP8_CONFIG,
                                                                     use_kernels=True)),
                 lambda: kernel_config(dataclasses.replace(get_reduced_config(TRAIN_ARCH),
                                                           quartet=FP8_CONFIG))):
        try:
            call()
        except ValueError:
            raised += 1
    if raised != 2:
        raise AssertionError("use_kernels=True with FP8_CONFIG did not raise")
    return raised


def _bits_differ(torch, a, b) -> int:
    """Elements whose f32 bit patterns differ (NaN against NaN counts as equal)."""
    a, b = a.detach().cpu().to(torch.float32), b.detach().cpu().to(torch.float32)
    same = (a.view(torch.int32) == b.view(torch.int32)) | (a.isnan() & b.isnan())
    return int((~same).sum())


def _outside(torch, a, b, rtol: float, atol_frac: float) -> int:
    """Elements of ``a`` outside rtol·|b| + atol_frac·max|b| of ``b``."""
    a, b = a.detach().cpu().to(torch.float32), b.detach().cpu().to(torch.float32)
    tol = rtol * b.abs() + atol_frac * float(b.abs().max())
    return int(((a - b).abs() > tol).sum())


def baseline_operands(B, method, x, w, dy, seeds, rotated):
    """The quantized operands of one baseline linear, x [1, M, K], w [1, K,
    N], dy [1, M, N] on one device: the forward's x and W and the
    backward's quantized gradient(s) and LSS's row weights, as ``_bl_fwd``
    and ``_bl_bwd`` form them.  ``rotated``: HALO's and LSS's Hadamard-
    rotated x, W and (HALO's dx operand) dy, made on the CPU."""
    from repro_torch.core import formats as F
    from repro_torch.core import threefry

    k1, k2, k3 = threefry.split_many(threefry.fold_in_many(B._BWD_KEY, seeds), 3)
    xh, wh, gh = rotated
    if method == "halo_fp4":
        return {"xq": B._halo_quantize(xh, F.MXFP4), "wq": B._halo_quantize(wh, F.MXFP4),
                "dy_q": B._halo_quantize(gh, F.MXFP4)}
    if method == "lss_int4":
        xq = B._int4_rtn(xh)
        return {"xq": xq, "wq": B._int4_rtn(wh.transpose(-1, -2)), "dy_q": B._int4_rtn(dy),
                "lss_rows": B._lss_sample(dy, xq, k3)}
    _, xq, wq = B._bl_fwd(x, w, method)
    if method == "jetfire_fp4":
        return {"xq": xq, "wq": wq, "dy_q": B._block2d_rtn(dy, F.MXFP4)}
    if method == "luq_fp4":  # its backward draws are luq_int4's: the same dy and keys
        return {"xq": xq, "wq": wq}
    return {"xq": xq, "wq": wq, "dy_q_dx": B._luq_quantize(dy, k1, True),
            "dy_q_dw": B._luq_quantize(dy, k2, True)}


def check_baselines_card_vs_cpu(torch, cfg, device="cuda"):
    """Each baseline method on llama-paper-200m's up (d_model -> d_ff) and
    down (d_ff -> d_model) projections at BASELINE_ROWS tokens, on the card
    and on the CPU from the same inputs.

    * The quantized operands (forward x and W, the backward's quantized
      gradients and LSS's row weights), card against CPU from the CPU's
      inputs: bit for bit, the stochastic ones too (the keys are hashed on
      each device).  HALO's and LSS's rotated operands are the CPU's on both
      (their group-128 Hadamard is a library product, which sums in
      another order on the card: its max |Δ| relative to max|x| is
      reported); LSS's row weights must take the same decisions, 1/p within
      rtol 1e-5 (its row norms are library sums).
    * y, dx and dW of the whole linear through ``baseline_linear``'s
      autograd: each element within 1e-4·|cpu| + 1e-5·max|cpu| but at most
      1 in 10^5 elements (f32 products sum in another order; in HALO and
      LSS a rotated value within an ulp of a grid midpoint may round the
      other way on the card, moving that element by a grid step).
    Returns the readings by method and projection."""
    from repro_torch.core import baselines as B
    from repro_torch.core import hadamard as H

    gen = torch.Generator().manual_seed(SEED + 3)
    seeds = torch.tensor([2**31 + 11])
    out, bad = {}, []
    for proj, (k, n) in (("up", (cfg.d_model, cfg.d_ff)), ("down", (cfg.d_ff, cfg.d_model))):
        x = torch.randn((1, BASELINE_ROWS, k), generator=gen)
        w = torch.randn((1, k, n), generator=gen) / math.sqrt(k)
        dy = torch.randn((1, BASELINE_ROWS, n), generator=gen) * 1e-2
        g = B._halo_group(k)
        rotated = (H.hadamard_transform(x, g=g, dim=-1), H.hadamard_transform(w, g=g, dim=1),
                   H.hadamard_transform(dy, g=B._halo_group(n), dim=-1))
        rot = float((H.hadamard_transform(x.to(device), g=g, dim=-1).cpu() - rotated[0])
                    .abs().max() / x.abs().max())
        for method in B.BASELINE_METHODS:
            t0 = time.perf_counter()
            rec = {"hadamard_g": g, "hadamard_max_rel_diff": rot}
            host = baseline_operands(B, method, x, w, dy, seeds, rotated)
            card = baseline_operands(B, method, x.to(device), w.to(device), dy.to(device),
                                     seeds.to(device), [t.to(device) for t in rotated])
            for name in host:
                a, b = card[name].cpu(), host[name]
                if name == "lss_rows":
                    rec["lss_rows_kept"] = int((b > 0).sum())
                    rec["lss_decisions_differ"] = int(((a > 0) != (b > 0)).sum())
                    rec["lss_weight_max_rel_diff"] = float(
                        ((a - b).abs() / b.abs().clamp_min(1e-30)).max())
                    if rec["lss_decisions_differ"] or rec["lss_weight_max_rel_diff"] > 1e-5:
                        bad.append((proj, method, name, rec))
                else:
                    rec[f"{name}_bits_differ"] = nd = _bits_differ(torch, a, b)
                    if nd:
                        bad.append((proj, method, name, nd))
            res = {}
            for dev in (device, "cpu"):
                xd = x[0].to(dev).requires_grad_()
                wd = w[0].to(dev).requires_grad_()
                y = B.baseline_linear(xd, wd, int(seeds[0]), method)
                dx, dw = torch.autograd.grad(y, [xd, wd], dy[0].to(dev))
                res[dev] = (y.detach(), dx, dw)
            for name, a, b in zip(("y", "dx", "dW"), res[device], res["cpu"]):
                rec[f"{name}_outside"] = nout = _outside(torch, a, b, 1e-4, 1e-5)
                rec[f"{name}_max_abs_diff"] = float((a.cpu() - b).abs().max())
                if not bool(torch.isfinite(a).all()) or nout > math.ceil(1e-5 * b.numel()):
                    bad.append((proj, method, name, nout))
            rec["s"] = time.perf_counter() - t0
            out.setdefault(method, {})[proj] = rec
            log(f"  {method} {proj} [{BASELINE_ROWS}, {k}] x [{k}, {n}]: {json.dumps(rec)}")
    if bad:
        raise AssertionError(f"baselines differ between the card and the CPU: {bad}")
    return out


def train_baselines(torch, device="cuda"):
    """llama-paper-200m at its published widths, VARIANT_LAYERS layers, under
    each baseline method and bf16 through ``train.loop.train`` on the plain
    path (VARIANT_STEPS steps of VARIANT_BATCH x TRAIN_SEQ tokens, random
    weights and data from SEED), as the reference computes them.  Returns
    each method's losses, grad-norms and step times; every value must be
    finite."""
    from repro_torch.configs import get_config
    from repro_torch.configs.llama_paper import LEARNING_RATES
    from repro_torch.core.baselines import BASELINE_METHODS
    from repro_torch.data.pipeline import SyntheticC4Dataset, TokenBatcher
    from repro_torch.models import build_model
    from repro_torch.optim import adamw, cosine_warmup
    from repro_torch.train.loop import train

    cfg = dataclasses.replace(get_config(TRAIN_ARCH), num_layers=VARIANT_LAYERS)
    model = build_model(cfg)
    batcher = TokenBatcher(SyntheticC4Dataset(cfg.vocab_size, seed=SEED), VARIANT_BATCH,
                           TRAIN_SEQ)
    out = {}
    for method in ("bf16", *BASELINE_METHODS):
        opt = adamw(cosine_warmup(LEARNING_RATES[TRAIN_ARCH], VARIANT_STEPS))
        _, hist = train(model, opt, batcher, VARIANT_STEPS, method=method, device=device,
                        log_every=0, seed=SEED)
        dts = [h["dt"] for h in hist]
        out[method] = {"loss": [h["loss"] for h in hist],
                       "grad_norm": [h["grad_norm"] for h in hist],
                       "step_s": dts, "median_step_s": statistics.median(dts)}
        log(f"  {method}: {json.dumps(out[method])}")
        if not all(math.isfinite(v) for v in out[method]["loss"] + out[method]["grad_norm"]):
            raise AssertionError(f"method {method}: non-finite loss or grad-norm {out[method]}")
        gc.collect()
        torch.cuda.empty_cache()
    return out


def train_grad_compress(torch, ops, device="cuda"):
    """Full-width, full-depth llama-paper-200m as the train phase trains it
    (TRAIN_STEPS steps of TRAIN_BATCH x TRAIN_SEQ in TRAIN_MICRO microbatches,
    Quartet through the kernels) through ``train.loop.train``, without and
    then with the SR-int8 gradient round trip and its error feedback (the
    first run is the second's baseline in the same call).  Every launch
    counter is set to 0 just before each run and read just after, against
    the train phase's prediction: the compression launches no kernel.
    Returns (summaries by setting, launch counts and vector-body launches
    of the compressed run)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.llama_paper import LEARNING_RATES
    from repro_torch.data.pipeline import SyntheticC4Dataset, TokenBatcher
    from repro_torch.launch.serve_engine import kernel_config
    from repro_torch.models import build_model
    from repro_torch.optim import adamw, cosine_warmup
    from repro_torch.train.loop import train

    cfg = kernel_config(get_config(TRAIN_ARCH))
    model = build_model(cfg)
    batcher = TokenBatcher(SyntheticC4Dataset(cfg.vocab_size, seed=SEED), TRAIN_BATCH,
                           TRAIN_SEQ)
    per_mb = 4 * 7 * cfg.num_layers  # 28 B1, 28 B2, 28 B3 a layer a microbatch (remat)
    out = {}
    for compress in (False, True):
        opt = adamw(cosine_warmup(LEARNING_RATES[TRAIN_ARCH], TRAIN_STEPS))
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        state, hist = train(model, opt, batcher, TRAIN_STEPS, microbatch=TRAIN_MICRO,
                            seed=SEED, device=device, grad_compress=compress, log_every=1,
                            log_fn=lambda m: log("  " + m))
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        vec = ops.vector_launches()
        predicted = {k: (per_mb if k in ("hadamard_quest_quantize", "sr_hadamard_quantize",
                                         "mxfp4_matmul") else 0) * TRAIN_MICRO * TRAIN_STEPS
                     for k in counts}
        losses = [h["loss"] for h in hist]
        gnorms = [h["grad_norm"] for h in hist]
        dts = sorted(h["dt"] for h in hist)
        med = dts[len(dts) // 2]
        err_elems = sum(e.numel() for _, e in _named_leaves(state.err)) if compress else 0
        name = "grad_compress" if compress else "no_compress"
        out[name] = {
            "arch": TRAIN_ARCH, "steps": TRAIN_STEPS, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
            "microbatches": TRAIN_MICRO, "loss": losses, "grad_norm": gnorms,
            "step_s": [h["dt"] for h in hist], "median_step_s": med,
            "tokens_per_s_median_step": TRAIN_BATCH * TRAIN_SEQ / med, "wall_s": wall,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "err_elements": err_elems, "err_bytes": 4 * err_elems, "launches": counts,
            "predicted_launches": predicted}
        if counts != predicted:
            raise AssertionError(f"{name} training launches {counts} != predicted {predicted}")
        if not all(math.isfinite(v) for v in losses + gnorms):
            raise AssertionError(f"{name}: non-finite loss {losses} or grad-norm {gnorms}")
        del state
    gc.collect()
    torch.cuda.empty_cache()
    return out, counts, vec


def check_rmsnorm_card_vs_cpu(torch, device="cuda"):
    """``models.layers.rmsnorm`` on the card against the CPU, bit for bit, at
    the widths the ported models normalize (llama-paper-200m's d 1280,
    qwen3's head dim 128 and d 2048, qwen3-moe's d 4096, a width that is no
    power of two's multiple of 32), f32 and bf16; and a [B, 5] call's rows
    against five [B, 1] calls on the card."""
    from repro_torch.models import layers as L

    gen = torch.Generator().manual_seed(SEED + 4)
    out = {}
    for d, rows in ((1280, 8192), (128, 16384), (2048, 4096), (4096, 1024), (1000, 512)):
        for dtype in (torch.float32, torch.bfloat16):
            x = (torch.randn((rows, d), generator=gen)
                 * torch.exp2(torch.randint(-8, 8, (rows, 1), generator=gen).float())).to(dtype)
            scale = (1 + 0.1 * torch.randn(d, generator=gen)).to(dtype)
            card = L.rmsnorm({"scale": scale.to(device)}, x.to(device), 1e-6)
            host = L.rmsnorm({"scale": scale}, x, 1e-6)
            out[f"d{d}_{str(dtype).split('.')[-1]}"] = nd = _bits_differ(torch, card, host)
            if nd:
                raise AssertionError(f"rmsnorm at d {d} {dtype}: {nd} values differ between "
                                     f"the card and the CPU")
    x = torch.randn((8, 5, 2048), generator=gen).to(torch.bfloat16).to(device)
    scale = torch.ones(2048, dtype=torch.bfloat16, device=device)
    whole = L.rmsnorm({"scale": scale}, x, 1e-6)
    cols = torch.cat([L.rmsnorm({"scale": scale}, x[:, s:s + 1], 1e-6) for s in range(5)], 1)
    if not torch.equal(whole, cols):
        raise AssertionError("rmsnorm: a [B, 5] call's rows differ from [B, 1] calls on the card")
    out["verify_rows_equal_decode_rows"] = True
    return out


def train_dense_config(torch, ops, device="cuda"):
    """DENSE_ARCH at its published widths, DENSE_TRAIN_LAYERS of its layers,
    DENSE_TRAIN_STEPS Quartet steps on the kernels through
    ``train.loop.train`` (one microbatch of VARIANT_BATCH x TRAIN_SEQ).
    Returns (summary, launch counts, vector-body launches)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticC4Dataset, TokenBatcher
    from repro_torch.launch.serve_engine import kernel_config
    from repro_torch.models import build_model
    from repro_torch.optim import adamw, cosine_warmup
    from repro_torch.train.loop import train

    cfg = kernel_config(dataclasses.replace(get_config(DENSE_ARCH),
                                            num_layers=DENSE_TRAIN_LAYERS))
    model = build_model(cfg)
    batcher = TokenBatcher(SyntheticC4Dataset(cfg.vocab_size, seed=SEED), VARIANT_BATCH,
                           TRAIN_SEQ)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    state, hist = train(model, adamw(cosine_warmup(3e-4, DENSE_TRAIN_STEPS)), batcher,
                        DENSE_TRAIN_STEPS, seed=SEED, device=device, log_every=1,
                        log_fn=lambda m: log("  " + m))
    wall = time.perf_counter() - t0
    counts, vec = ops.launch_counts(), ops.vector_launches()
    n_params = sum(p.numel() for p in _leaves(state.params))
    del state
    torch.cuda.empty_cache()
    losses = [h["loss"] for h in hist]
    if not all(math.isfinite(h[k]) for h in hist for k in ("loss", "grad_norm")):
        raise AssertionError(f"{DENSE_ARCH}: non-finite training metrics {hist}")
    # remat: every quantized linear (6 a layer with the GELU MLP) runs its
    # forward twice (2 B1 + 1 B3 each) and its backward once (4 B2 + 2 B3);
    # the untied lm-head stays bf16
    linears = 6 * cfg.num_layers * DENSE_TRAIN_STEPS
    predicted = {k: 0 for k in counts}
    predicted.update({"hadamard_quest_quantize": 4 * linears,
                      "sr_hadamard_quantize": 4 * linears, "mxfp4_matmul": 4 * linears})
    if counts != predicted:
        raise AssertionError(f"{DENSE_ARCH} training launches {counts} != predicted {predicted}")
    return ({"arch": DENSE_ARCH, "layers": cfg.num_layers, "params": n_params,
             "steps": DENSE_TRAIN_STEPS, "batch": VARIANT_BATCH, "seq": TRAIN_SEQ,
             "loss": losses, "grad_norm": [h["grad_norm"] for h in hist],
             "step_s": [h["dt"] for h in hist],  # step 0 carries the first-use costs
             "last_step_s": hist[-1]["dt"],
             "wall_s": wall, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
             "launches": counts, "predicted_launches": predicted}, counts, vec)


def train_c4_resume_on_card(torch):
    """``repro_torch.examples.train_c4 --tiny`` on the card: TRAIN_C4_STEPS
    steps twice unbroken, and once stopped after step 2's checkpoint and
    started again (it resumes).  If the unbroken runs are bit-identical the
    resumed one must be too; else the resumed one may differ from the first
    by no more than the second does."""
    import shutil

    from repro_torch.examples import train_c4

    root = os.path.join(HERE, "build", "train_c4_check")
    shutil.rmtree(root, ignore_errors=True)
    args = ["--tiny", "--steps", str(TRAIN_C4_STEPS), "--checkpoint-every", "2"]
    t0 = time.perf_counter()
    a, hist, val = train_c4.main(args + ["--checkpoint-dir", os.path.join(root, "a")])
    b, _, _ = train_c4.main(args + ["--checkpoint-dir", os.path.join(root, "b")])
    part = os.path.join(root, "c")
    train_c4.main(args + ["--checkpoint-dir", part])
    shutil.rmtree(os.path.join(part, f"step_{TRAIN_C4_STEPS:09d}"))  # killed after step 2
    c, hist_c, _ = train_c4.main(args + ["--checkpoint-dir", part])
    shutil.rmtree(root, ignore_errors=True)
    if [h["step"] for h in hist_c] != list(range(2, TRAIN_C4_STEPS)):
        raise AssertionError(f"train_c4 did not resume at step 2: {hist_c}")
    unbroken, resumed = _state_diff(torch, a, b), _state_diff(torch, a, c)
    if not unbroken and resumed:
        raise AssertionError(f"train_c4: the resumed run differs from two identical unbroken "
                             f"ones in {resumed}")
    if unbroken and any(v > unbroken.get(k, 0.0) for k, v in resumed.items()):
        raise AssertionError(f"train_c4: resumed {resumed} differs more than unbroken "
                             f"{unbroken}")
    return {"steps": TRAIN_C4_STEPS, "loss": [h["loss"] for h in hist], "val_loss": val,
            "unbroken_runs_differ": unbroken, "resumed_differs": resumed,
            "bit_identical": not resumed, "wall_s": time.perf_counter() - t0}


def check_ring_kernels(torch, cfg, device="cuda"):
    """B4a and B4b through their 2-d entries on the state rings' views at
    ``cfg``'s full width, N_SLOTS slots (the ring leaves of its cache tree:
    conv [L, K-1, C] in bf16, h in f32, each slot's state as rows of
    ``ring_rows`` elements), bit for bit against their plain versions on the
    card; blocks at 2^-8..2^8 and E8M0 edge rows.  Returns the views."""
    import numpy as np

    from repro_torch.kernels import kv_pack as KV
    from repro_torch.models import build_model
    from repro_torch.models.registry import cache_leaves
    from repro_torch.serve.state_pool import BLOCK, ring_rows

    spec = build_model(cfg).cache_spec(1, 1)
    spec = spec["mamba"] if isinstance(spec, dict) else spec
    gen = torch.Generator(device=device).manual_seed(SEED + 6)
    out = {}
    for name, ((L, _, *rest), dtype) in zip(("conv", "h"), cache_leaves(spec)):
        leaf = (L, *rest)
        elems = math.prod(leaf)
        padded = -(-elems // BLOCK) * BLOCK
        row = ring_rows(padded)
        x = torch.randn((N_SLOTS * padded // BLOCK, BLOCK), generator=gen, device=device)
        x = x * torch.exp2(torch.randint(-8, 9, (x.shape[0], 1), generator=gen, device=device
                                         ).float())
        x = x.reshape(-1, row).to(dtype)
        edge = torch.from_numpy(kv_edge_rows(np)).reshape(-1)[:x.numel() // 2]
        x.view(-1)[:edge.numel()] = edge.to(device, dtype)  # whole blocks, up to half of x
        c, s = KV.kv_quant_pack(x)
        pc, ps = KV.kv_quant_pack_plain(x)
        if not (torch.equal(c, pc) and torch.equal(s, ps)):
            raise AssertionError(f"B4a on the {name} ring view {tuple(x.shape)} differs from "
                                 f"its plain version")
        y = KV.kv_dequant_unpack(c, s, dtype)
        py = KV.kv_dequant_unpack_plain(c, s, dtype)
        if not torch.equal(bit_pattern(torch, y), bit_pattern(torch, py)):
            raise AssertionError(f"B4b on the {name} ring view {tuple(x.shape)} differs from "
                                 f"its plain version")
        out[name] = {"slot_elements": elems, "rows": list(x.shape),
                     "dtype": str(dtype).split(".")[-1]}
    return out


def _ssm_run(torch, model, params, prompts, max_new, *, kv="mxfp4", backend=None,
             keep_logits=False):
    """One engine run of the ssm phase (all requests at t = 0): (engine,
    requests, wall s, first-token s by rid, tick s by kind, step calls)."""
    import numpy as np

    from repro_torch.serve import Engine, EngineConfig

    eng = Engine(model, params, EngineConfig(
        n_slots=N_SLOTS, max_len=-(-(SSM_MAX_PROMPT + max_new) // PAGE_SIZE) * PAGE_SIZE,
        page_size=PAGE_SIZE, kv_dtype=kv,
        prefill_chunk=SSM_CHUNK, keep_logits=keep_logits, decode_backend=backend))
    calls = _count_step_calls(eng, "_state_steps") if eng.backend == "statepool" else {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new, arrival_time=0.0) for p in prompts]
    first, ticks = {}, {"prefill": [], "decode": []}
    while eng.sched.pending:
        kind = "prefill" if eng.sched.queue or eng.sched.prefilling() else "decode"
        s0 = time.perf_counter()
        eng.step(now=s0 - t0)
        ticks[kind].append(time.perf_counter() - s0)
        for r in reqs:
            if r.tokens and r.rid not in first:
                first[r.rid] = time.perf_counter() - t0
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    V = model.cfg.vocab_size
    for r in reqs:
        if len(r.tokens) != max_new or not all(0 <= t < V for t in r.tokens):
            raise AssertionError(f"ssm request {r.rid}: {len(r.tokens)} tokens "
                                 f"({r.finish_reason!r}) or a token out of range")
        if any(row.shape != (V,) or not np.isfinite(row).all() for row in r.logits_trace):
            raise AssertionError(f"ssm request {r.rid}: non-finite or misshapen logits")
    return eng, reqs, wall, first, ticks, calls


def _first_token_vs_teacher_forced(torch, model, params, prompts, reqs, device="cuda"):
    """(max |Δ|, mean |Δ|) of each request's first-token log-probs against
    the teacher-forced forward of its prompt (params cast as the serving
    steps cast them)."""
    from repro_torch.train.serve import cast_params

    cp = cast_params(params, getattr(torch, model.cfg.dtype))
    out = []
    with torch.inference_mode():
        for p, r in zip(prompts, reqs):
            feats, _ = model.forward(cp, torch.from_numpy(p)[None].to(device), 0,
                                     features_only=True)
            ref = torch.log_softmax(model.head(cp, feats[:, -1:], 0)[0, 0].float().cpu(), -1)
            d = (torch.log_softmax(torch.as_tensor(r.logits_trace[0]).float(), -1) - ref).abs()
            out.append((float(d.max()), float(d.mean())))
    return out


def serve_ssm(torch, ops, device="cuda"):
    """SSM_ARCH at full width and depth from MXFP4 state rings (the
    ``statepool`` backend, its default): SSM_REQUESTS requests, launches of
    B1, B3, B4a and B4b against a prediction, first-token log-probs against
    the teacher-forced forward; then, SSM_ORACLE_LAYERS layers deep, the
    statepool tokens with dense rings equal to ``dense_slots``'.  Returns
    (summary, launch counts, vector-body launches)."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.convert import init_params
    from repro_torch.launch.serve_engine import kernel_config
    from repro_torch.models import build_model

    cfg = kernel_config(get_config(SSM_ARCH))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=device).manual_seed(SEED), device)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in _leaves(params))
    log(f"  init: {n_params / 1e9:.3f} B params in {time.perf_counter() - t0:.1f} s")
    model = build_model(cfg)
    rng = np.random.default_rng(SEED + 5)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(SSM_MIN_PROMPT,
                                                                SSM_MAX_PROMPT + 1)))
               .astype(np.int32) for _ in range(SSM_REQUESTS)]
    L = cfg.num_layers
    _ssm_run(torch, model, params, prompts[:2], 2)  # warm-up: first-use costs
    ops.reset_launch_counts()
    eng, reqs, wall, first, ticks, calls = _ssm_run(torch, model, params, prompts, SSM_NEW,
                                                    keep_logits=True)
    counts, vec = ops.launch_counts(), ops.vector_launches()
    # per step call: 2 B1 and 1 B3 in each of a Mamba1 layer's 4 quantized
    # projections (in, x, dt: r = 256, out; the tied head stays bf16); per
    # ring plane (conv, h) one B4b to read the slots' pages and one B4a to
    # write them
    n = sum(calls.values())
    predicted = {k: 0 for k in counts}
    predicted.update({"hadamard_quest_quantize": 8 * L * n, "mxfp4_matmul": 4 * L * n,
                      "kv_quant_pack": 2 * n, "kv_dequant_unpack": 2 * n})
    if counts != predicted:
        raise AssertionError(f"ssm run launches {counts} != predicted {predicted}")
    lp = _first_token_vs_teacher_forced(torch, model, params, prompts, reqs, device)
    sp = eng.cache
    ttft = sorted(first.values())
    toks = sum(len(r.tokens) for r in reqs)
    summary = {"arch": SSM_ARCH, "params": n_params, "requests": len(reqs),
               "prompts": [int(p.size) for p in prompts], "tokens": toks, "wall_s": wall,
               "tok_per_s": toks / wall, "ttft_mean_s": float(np.mean(ttft)),
               "ttft_max_s": ttft[-1], "prefill_ticks": len(ticks["prefill"]),
               "prefill_tick_ms_median": 1e3 * sorted(ticks["prefill"])[
                   len(ticks["prefill"]) // 2],
               "decode_ticks": len(ticks["decode"]),
               "decode_tick_ms_median": 1e3 * sorted(ticks["decode"])[len(ticks["decode"]) // 2],
               "step_calls": calls, "launches": counts, "predicted_launches": predicted,
               "ring_bytes": sp.cache_bytes(),
               "dense_slot_bytes": N_SLOTS * sum(r.dense_bytes() for r in sp.rings),
               "state_bytes_per_decode_step": sp.state_bytes_per_decode_step(sp.max_len),
               "dense_state_bytes_per_decode_step":
                   sp.dense_state_bytes_per_decode_step(sp.max_len),
               "ring_bits_per_element": sp.bits_per_element(),
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
               "first_token_logprob_vs_teacher_forced": lp}
    log(f"  mxfp4 rings: {json.dumps(summary)}")
    if not all(x < SSM_LOGPROB_MAX and y < SSM_LOGPROB_MEAN for x, y in lp):
        raise AssertionError(f"MXFP4-ring first-token log-probs vs teacher-forced beyond "
                             f"({SSM_LOGPROB_MAX}, {SSM_LOGPROB_MEAN}): {lp}")
    del eng, reqs

    # the oracle at full width, SSM_ORACLE_LAYERS deep: dense rings hold the
    # state bit for bit, so statepool's tokens are dense_slots' tokens
    small = build_model(dataclasses.replace(cfg, num_layers=SSM_ORACLE_LAYERS))
    sparams = {**params, "layers": _tree_map(lambda v: v[:SSM_ORACLE_LAYERS], params["layers"])}
    few = prompts[:SSM_ORACLE_REQUESTS]
    _, pooled, _, _, _, _ = _ssm_run(torch, small, sparams, few, SSM_ORACLE_NEW, kv="dense",
                                     keep_logits=True)
    _, oracle, _, _, _, _ = _ssm_run(torch, small, sparams, few, SSM_ORACLE_NEW,
                                     backend="dense_slots")
    if [r.tokens for r in pooled] != [r.tokens for r in oracle]:
        raise AssertionError(f"statepool (dense rings) tokens {[r.tokens for r in pooled]} != "
                             f"dense_slots tokens {[r.tokens for r in oracle]}")
    summary["oracle"] = {"layers": SSM_ORACLE_LAYERS, "requests": len(few),
                         "tokens_equal": True,
                         "dense_rings_first_token_logprob_vs_teacher_forced":
                             _first_token_vs_teacher_forced(torch, small, sparams, few, pooled,
                                                            device)}
    del params, sparams
    torch.cuda.empty_cache()
    return summary, counts, vec


def check_rope_card_vs_cpu(torch, device="cuda"):
    """``models.layers.rope_table`` (the f32 angles, then cos and sin in
    float64 rounded once) on the card against the CPU, bit for bit, at the
    ported head widths and thetas (llama-paper-200m's hd 128 at 1e4,
    qwen3's at 1e6, starcoder2's at 1e5, the reduced configs' 32 at 1e4)
    over positions 0..32767; and a [B, 5] table's rows against [B, 1]
    tables on the card."""
    from repro_torch.models import layers as L

    pos = torch.arange(32768, dtype=torch.int32).reshape(8, 4096)
    out = {}
    for hd, theta in ((128, 1e4), (128, 1e6), (128, 1e5), (32, 1e4)):
        card = L.rope_table(pos.to(device), hd, theta)
        host = L.rope_table(pos, hd, theta)
        out[f"hd{hd}_theta{theta:g}"] = nd = sum(_bits_differ(torch, c.cpu(), h)
                                                 for c, h in zip(card, host))
        if nd:
            raise AssertionError(f"rope table at hd {hd}, theta {theta:g}: {nd} values differ "
                                 f"between the card and the CPU")
    p5 = pos[:, 100:105].to(device)
    whole = L.rope_table(p5, 128, 1e6)
    cols = [L.rope_table(p5[:, s:s + 1], 128, 1e6) for s in range(5)]
    if not all(torch.equal(w[:, s:s + 1], c[i]) for s, c in enumerate(cols)
               for i, w in enumerate(whole)):
        raise AssertionError("rope: a [B, 5] table's rows differ from [B, 1] tables on the card")
    out["verify_rows_equal_decode_rows"] = True
    return out


def head_wide_edge_rows(np, hd):
    """Rows of ``hd`` values whose absmax/6 lies within ±8 ulps of √2·2^k (the
    E8M0-nearest rounding edge) or exactly at 2^k, for k in [-100, 100],
    plus all-zero rows (f32): the head-wide block's edge sweep."""
    rng = np.random.default_rng(SEED + 1)
    amax = []
    for k in range(-100, 101):
        a0 = np.float32(np.sqrt(2.0) * 2.0**k * 6.0)
        amax.extend((a0.view(np.int32) + np.arange(-8, 9, dtype=np.int32)).view(np.float32))
        amax.append(np.float32(6.0 * 2.0**k))
    amax = np.asarray(amax, np.float32)
    x = np.zeros((amax.size + 8, hd), np.float32)
    x[:amax.size, 1:] = rng.uniform(-0.9, 0.9, (amax.size, hd - 1)) * amax[:, None]
    x[:amax.size, 0] = amax * np.where(rng.random(amax.size) < 0.5, -1, 1)
    return x


def every_pair_rows(torch, n_rows, row_bytes, shift, device):
    """Head-wide B4b operands (codes [n_rows, row_bytes], one scale a row)
    holding every (byte, scale code) pair: byte f of the flat codes is (f +
    16·shift) mod 256, row r's scale code (r // 32 + shift) mod 256 (32 rows
    of 56 bytes hold each byte value 7 times; 8192 rows every scale code)."""
    codes = ((torch.arange(n_rows * row_bytes, device=device) + 16 * shift) % 256)
    scales = (torch.arange(n_rows, device=device) // 32 + shift) % 256
    return (codes.to(torch.uint8).reshape(n_rows, row_bytes),
            scales.to(torch.uint8).reshape(n_rows, 1))


def check_head_wide_kernels(torch, cfg, device="cuda"):
    """B4a and B4b with the head-wide block (one scale a head of 112) at
    ``cfg``'s KV plane, bit for bit against their plain versions on the card:
    the K+V scatter at a decode tick (N_SLOTS tokens) and a prefill chunk
    (SSM_CHUNK tokens) of every application's layer, K and V read through
    strides (16-byte loads) and through rows no 16-byte load can read; the
    2-d entry over the E8M0 edge sweep in f32 and bf16; the K+V gather over
    ragged tables from pools holding every (byte, scale code) pair; the 2-d
    dequantize over every pair, with a short last chunk.  Returns a summary
    (one launch each asserted)."""
    import numpy as np

    from repro_torch.kernels import kv_pack as KV

    gen = torch.Generator(device=device).manual_seed(SEED + 7)
    Lkv, H, hd = cfg.num_layers // cfg.attn_every, cfg.num_kv_heads, cfg.head_dim_
    if hd not in KV.HEAD_BLOCKS:
        raise AssertionError(f"head dim {hd} has no head-wide body")
    kh, T = hd // 2, SSM_MAX_PROMPT + SSM_NEW
    n_pages = 1 + N_SLOTS * (-(-T // PAGE_SIZE))
    u8 = torch.uint8
    out = {}

    def leaves():
        return [torch.zeros((Lkv, n_pages, PAGE_SIZE, H, w), dtype=u8, device=device)
                for w in (kh, 1, kh, 1)]

    for tag, n_tok in (("decode", N_SLOTS), ("prefill", SSM_CHUNK)):
        for vec in (True, False):
            width = hd if vec else hd + 1  # rows of 113: no 16-byte load reads them
            base = (torch.randn((Lkv, 2 * n_tok, H, width), generator=gen, device=device)
                    * torch.exp2(torch.randint(-6, 7, (Lkv, 2 * n_tok, H, 1), generator=gen,
                                               device=device).float())).to(torch.bfloat16)
            k, v = base[:, ::2, :, :hd], base[:, 1::2, :, :hd]
            perm = torch.randperm((n_pages - 1) * PAGE_SIZE, generator=gen,
                                  device=device)[:n_tok]
            pid = (1 + perm // PAGE_SIZE).to(torch.int32)
            off = (perm % PAGE_SIZE).to(torch.int32)
            got, want = leaves(), leaves()
            before = KV.kv_quant_pack.launches
            KV.kv_quant_scatter_kv(*got, pid, off, k, v)
            if KV.kv_quant_pack.launches - before != 1:
                raise AssertionError("head-wide K+V scatter took more than one launch")
            plain_quant_scatter(torch, want[0], want[1], pid, off, k)
            plain_quant_scatter(torch, want[2], want[3], pid, off, v)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"head-wide B4a scatter ({tag}, vector loads {vec}) "
                                     f"differs from its plain version")
            out[f"scatter_{tag}{'' if vec else '_scalar_loads'}"] = [Lkv, n_tok, H, hd]
    x = torch.from_numpy(head_wide_edge_rows(np, hd)).to(device)
    for dt in (torch.float32, torch.bfloat16):
        c, s = KV.kv_quant_pack(x.to(dt), hd)
        pc, ps = KV.kv_quant_pack_plain(x.to(dt), hd)
        if not (torch.equal(c, pc) and torch.equal(s, ps) and s.shape == (x.shape[0], 1)):
            raise AssertionError(f"head-wide B4a 2-d ({dt}) differs from its plain version "
                                 f"on the E8M0 edge rows")
    out["edge_rows"] = x.shape[0]

    n_rows = Lkv * n_pages * PAGE_SIZE * H
    kc, ks = every_pair_rows(torch, n_rows, kh, 0, device)
    vc, vs = every_pair_rows(torch, n_rows, kh, 97, device)
    shape = (Lkv, n_pages, PAGE_SIZE, H)
    kc, vc = kc.reshape(*shape, kh), vc.reshape(*shape, kh)
    ks, vs = ks.reshape(*shape, 1), vs.reshape(*shape, 1)
    P = -(-T // PAGE_SIZE)
    perm = 1 + torch.randperm(n_pages - 1, generator=gen, device=device)[:N_SLOTS * P]
    tables = perm.to(torch.int32).reshape(N_SLOTS, P)
    tables[1, 3:] = 0  # a short slot: its unmapped columns read the scratch page
    tables[2, 5] = tables[0, 0]  # a page read twice
    idx = tables.long()
    for dt in (torch.float32, torch.bfloat16):
        before = KV.kv_dequant_unpack.launches
        gk, gv = KV.kv_gather_dequant_kv(kc, ks, vc, vs, tables, dt)
        if KV.kv_dequant_unpack.launches - before != 1:
            raise AssertionError("head-wide K+V gather took more than one launch")
        for g, c, s in ((gk, kc, ks), (gv, vc, vs)):
            want = KV.kv_dequant_unpack_plain(c[:, idx], s[:, idx], dt).reshape(g.shape)
            if not torch.equal(bit_pattern(torch, g), bit_pattern(torch, want)):
                raise AssertionError(f"head-wide B4b gather ({dt}) differs from its plain "
                                     f"version")
    out["gather"] = [Lkv, N_SLOTS, P * PAGE_SIZE, H, hd]
    for m in (16384, 16384 - 37):
        c, s = every_pair_rows(torch, m, kh, 5, device)
        for dt in (torch.float32, torch.bfloat16):
            y = KV.kv_dequant_unpack(c, s, dt)
            if not torch.equal(bit_pattern(torch, y),
                               bit_pattern(torch, KV.kv_dequant_unpack_plain(c, s, dt))):
                raise AssertionError(f"head-wide B4b 2-d ({m} rows, {dt}) differs from its "
                                     f"plain version")
    out["dequant_2d_rows"] = [16384, 16384 - 37]
    return out


def check_hybrid_card_vs_cpu(torch, cfg, device="cuda"):
    """Card against CPU on equal inputs: rope's table at hd 112 over
    positions 0..32767 (bit for bit); one full-width Mamba2 block in f32
    with plain f32 linears, as a decode step of N_SLOTS slots and as a [1,
    SSM_CHUNK] chunk, each from a random cache (output and new state within
    MAMBA2_CARD_CPU_* of max |CPU|); and the SSD scan's ``cumsum`` alone
    (its bits that differ counted).  Returns the measured differences."""
    import dataclasses

    from repro_torch.models import layers as L
    from repro_torch.models import ssm as S

    pos = torch.arange(32768, dtype=torch.int32).reshape(8, 4096)
    card = L.rope_table(pos.to(device), cfg.head_dim_, cfg.rope_theta)
    host = L.rope_table(pos, cfg.head_dim_, cfg.rope_theta)
    out = {"rope_hd112_bits_differ": sum(_bits_differ(torch, c.cpu(), h)
                                         for c, h in zip(card, host))}
    if out["rope_hd112_bits_differ"]:
        raise AssertionError(f"rope table at hd {cfg.head_dim_}: {out} values differ between "
                             f"the card and the CPU")
    fcfg = dataclasses.replace(cfg, dtype="float32")
    gen = torch.Generator().manual_seed(SEED + 8)
    p = S.init_mamba2_block(fcfg, torch.float32, gen, "cpu")
    p["dt_bias"] = torch.randn(p["dt_bias"].shape, generator=gen) * 0.5
    p["conv_b"] = torch.randn(p["conv_b"].shape, generator=gen) * 0.1
    pc = {k: (v.to(device) if isinstance(v, torch.Tensor) else {a: b.to(device)
                                                                for a, b in v.items()})
          for k, v in p.items()}
    d = cfg.d_model
    for tag, B, Sq in (("decode", N_SLOTS, 1), ("chunk", 1, SSM_CHUNK)):
        x = torch.randn((B, Sq, d), generator=gen)
        (cs, _), (hs, _) = S.mamba2_cache_spec(fcfg, B)
        conv, h = torch.randn(cs, generator=gen) * 0.5, torch.randn(hs, generator=gen) * 0.5
        hc, dc = (conv.clone(), h.clone()), (conv.to(device), h.to(device))
        with torch.inference_mode():
            yh, _ = S.mamba2_block(p, x, None, 0, fcfg, hc, "bf16")
            yd, _ = S.mamba2_block(pc, x.to(device), None, 0, fcfg, dc, "bf16")
        e_out = float((yd.cpu() - yh).abs().max() / yh.abs().max())
        e_h = float((dc[1].cpu() - hc[1]).abs().max() / hc[1].abs().max())
        e_conv = float((dc[0].cpu() - hc[0]).abs().max() / hc[0].abs().max())
        out[f"mamba2_{tag}"] = {"out_rel": e_out, "state_rel": e_h, "conv_state_rel": e_conv}
        if e_out > MAMBA2_CARD_CPU_OUT or e_h > MAMBA2_CARD_CPU_STATE:
            raise AssertionError(f"Mamba2 block {tag}: card vs CPU {out[f'mamba2_{tag}']} "
                                 f"beyond ({MAMBA2_CARD_CPU_OUT}, {MAMBA2_CARD_CPU_STATE})")
    nh = cfg.ssm_expand * d // cfg.ssm_head_dim
    dA = -torch.rand((1, SSM_CHUNK, nh), generator=gen) * 4
    cc, ch = torch.cumsum(dA.to(device), 1).cpu(), torch.cumsum(dA, 1)
    out["cumsum_bits_differ"] = _bits_differ(torch, cc, ch)
    out["cumsum_max_abs_diff"] = float((cc - ch).abs().max())
    return out


def _hybrid_prefill_shapes(prompts) -> dict:
    """Prefill calls by shape: each prompt in [1, SSM_CHUNK] chunks, then
    its remainder as [1, 1] calls."""
    return {f"1x{SSM_CHUNK}": sum(int(p.size) // SSM_CHUNK for p in prompts),
            "1x1": sum(int(p.size) % SSM_CHUNK for p in prompts)}


def serve_hybrid(torch, ops, device="cuda"):
    """HYBRID_ARCH at full width and depth from an MXFP4 attention-KV plane
    (PAGE_SIZE) and MXFP4 state rings (the ``statepool`` backend): the first
    HYBRID_REQUESTS of the ssm phase's prompts, SSM_NEW new each; launches of B1, B3, B4a and B4b
    against a prediction, first-token log-probs against the teacher-forced
    forward; then, HYBRID_ORACLE_LAYERS layers deep, statepool with dense
    planes token for token against ``dense_slots``.  Returns (summary,
    launch counts, vector-body launches)."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.convert import init_params
    from repro_torch.launch.serve_engine import kernel_config
    from repro_torch.models import build_model

    cfg = kernel_config(get_config(HYBRID_ARCH))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=device).manual_seed(SEED), device)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in _leaves(params))
    log(f"  init: {n_params} stored params ({cfg.n_params()} without embeddings by the "
        f"reference's formula, the shared block counted once an application) in "
        f"{time.perf_counter() - t0:.1f} s")
    model = build_model(cfg)
    rng = np.random.default_rng(SEED + 5)  # the ssm phase's prompts
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(SSM_MIN_PROMPT,
                                                                SSM_MAX_PROMPT + 1)))
               .astype(np.int32) for _ in range(SSM_REQUESTS)][:HYBRID_REQUESTS]
    L, n_super = cfg.num_layers, cfg.num_layers // cfg.attn_every
    # warm-up (first-use costs): a [1, SSM_CHUNK] chunk, a [1, 1] call, decodes
    _ssm_run(torch, model, params, [p[:SSM_CHUNK + 1] for p in prompts[:2]], 2)
    ops.reset_launch_counts()
    eng, reqs, wall, first, ticks, calls = _ssm_run(torch, model, params, prompts, SSM_NEW,
                                                    keep_logits=True)
    counts, vec = ops.launch_counts(), ops.vector_launches()
    # per step call: 2 B1 and 1 B3 in each of a Mamba2 layer's 2 quantized
    # projections (in, out) and of the shared block's 7 linears at each of
    # its n_super applications (the untied head stays bf16); the KV plane one
    # B4b (gather, K and V) and one B4a (the new tokens' K and V); per ring
    # plane (conv, h) one B4b and one B4a
    n = sum(calls.values())
    predicted = {k: 0 for k in counts}
    predicted.update({"hadamard_quest_quantize": (4 * L + 14 * n_super) * n,
                      "mxfp4_matmul": (2 * L + 7 * n_super) * n,
                      "kv_quant_pack": 3 * n, "kv_dequant_unpack": 3 * n})
    if counts != predicted:
        raise AssertionError(f"hybrid run launches {counts} != predicted {predicted}")
    shapes = _hybrid_prefill_shapes(prompts)
    if sum(shapes.values()) != calls.get("prefill_chunk", 0):
        raise AssertionError(f"prefill calls {calls} != the schedule's {shapes}")
    lp = _first_token_vs_teacher_forced(torch, model, params, prompts, reqs, device)
    sp = eng.cache
    kv = sp.kv
    T = sp.max_len
    kv_token = kv.cache_bytes() // (kv.n_pages * kv.page_size)
    kv_token_dense = 2 * kv.layers * kv.kv_heads * kv.head_dim * 2
    ttft = sorted(first.values())
    toks = sum(len(r.tokens) for r in reqs)
    summary = {"arch": HYBRID_ARCH, "stored_params": n_params,
               "n_params_reference_formula": cfg.n_params(),
               "requests": len(reqs), "prompts": [int(p.size) for p in prompts],
               "tokens": toks, "wall_s": wall, "tok_per_s": toks / wall,
               "ttft_mean_s": float(np.mean(ttft)), "ttft_max_s": ttft[-1],
               "prefill_ticks": len(ticks["prefill"]),
               "prefill_tick_ms_median": 1e3 * sorted(ticks["prefill"])[
                   len(ticks["prefill"]) // 2],
               "decode_ticks": len(ticks["decode"]),
               "decode_tick_ms_median": 1e3 * sorted(ticks["decode"])[len(ticks["decode"]) // 2],
               "step_calls": calls, "prefill_calls_by_shape": shapes, "launches": counts,
               "predicted_launches": predicted,
               "kv_plane_bytes": kv.cache_bytes(), "kv_bytes_per_token": kv_token,
               "kv_bytes_per_token_bf16": kv_token_dense,
               "kv_plane_bytes_bf16_slots": N_SLOTS * T * kv_token_dense,
               "ring_bytes": sum(r.cache_bytes() for r in sp.rings),
               "ring_page_bytes": sum(r.page_bytes() for r in sp.rings),
               "ring_page_bytes_dense": sum(r.dense_bytes() for r in sp.rings),
               "dense_slot_ring_bytes": N_SLOTS * sum(r.dense_bytes() for r in sp.rings),
               "pool_bytes": sp.cache_bytes(), "bits_per_element": sp.bits_per_element(),
               "state_bytes_per_decode_step": sp.state_bytes_per_decode_step(T),
               "dense_state_bytes_per_decode_step": sp.dense_state_bytes_per_decode_step(T),
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
               "first_token_logprob_vs_teacher_forced": lp}
    log(f"  mxfp4 planes: {json.dumps(summary)}")
    if not all(x < SSM_LOGPROB_MAX and y < SSM_LOGPROB_MEAN for x, y in lp):
        raise AssertionError(f"MXFP4-plane first-token log-probs vs teacher-forced beyond "
                             f"({SSM_LOGPROB_MAX}, {SSM_LOGPROB_MEAN}): {lp}")
    del eng, reqs
    # a one-chunk prompt reads no quantized state (the zero ring sentinel,
    # its own chunk's K/V): its first token equals the teacher-forced
    # forward's bit for bit
    one = [prompts[0][:SSM_CHUNK]]
    _, r1, _, _, _, _ = _ssm_run(torch, model, params, one, 1, keep_logits=True)
    summary["one_chunk_first_token_logprob_vs_teacher_forced"] = one_lp = \
        _first_token_vs_teacher_forced(torch, model, params, one, r1, device)
    if one_lp[0][0] != 0:
        raise AssertionError(f"a one-chunk hybrid prompt's first-token log-probs differ from "
                             f"the teacher-forced forward's: {one_lp}")
    del r1

    # the oracle at full width, HYBRID_ORACLE_LAYERS deep (2 groups and a
    # 1-layer tail): dense planes hold the state bit for bit, so statepool's
    # tokens are dense_slots' tokens
    small = build_model(dataclasses.replace(cfg, num_layers=HYBRID_ORACLE_LAYERS))
    sparams = {**params, "mamba_layers": _tree_map(lambda v: v[:HYBRID_ORACLE_LAYERS],
                                                   params["mamba_layers"])}
    few = prompts[:SSM_ORACLE_REQUESTS]
    _, pooled, _, _, _, _ = _ssm_run(torch, small, sparams, few, SSM_ORACLE_NEW, kv="dense",
                                     keep_logits=True)
    _, oracle, _, _, _, _ = _ssm_run(torch, small, sparams, few, SSM_ORACLE_NEW,
                                     backend="dense_slots")
    if [r.tokens for r in pooled] != [r.tokens for r in oracle]:
        raise AssertionError(f"statepool (dense planes) tokens {[r.tokens for r in pooled]} "
                             f"!= dense_slots tokens {[r.tokens for r in oracle]}")
    summary["oracle"] = {"layers": HYBRID_ORACLE_LAYERS, "requests": len(few),
                         "tokens_equal": True,
                         "dense_planes_first_token_logprob_vs_teacher_forced":
                             _first_token_vs_teacher_forced(torch, small, sparams, few, pooled,
                                                            device)}
    del params, sparams
    torch.cuda.empty_cache()
    return summary, counts, vec


def time_state_kernels(torch, timer, device="cuda"):
    """B4a and B4b at the state pool's shapes, N_SLOTS slots: the hybrid's KV
    plane (HYBRID_ARCH: K and V of every application at a decode tick and a
    prefill chunk; the gather of a decode tick, bf16 out) and each ring's
    write and read of a step (HYBRID_ARCH and SSM_ARCH: conv bf16, h f32,
    through the 2-d entries on the rings' views).  Each beside its plain
    version and its least time on the H100 (bytes: each input read once,
    each output written once)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import kv_pack as KV
    from repro_torch.models import build_model
    from repro_torch.models.registry import cache_leaves
    from repro_torch.serve.paged_cache import gather_pages
    from repro_torch.serve.state_pool import BLOCK, ring_rows

    gen = torch.Generator(device=device).manual_seed(SEED + 9)
    cfg = get_config(HYBRID_ARCH)
    Lkv, H, hd = cfg.num_layers // cfg.attn_every, cfg.num_kv_heads, cfg.head_dim_
    T = SSM_MAX_PROMPT + SSM_NEW
    P = -(-T // PAGE_SIZE)
    n_pages = 1 + N_SLOTS * P
    pool = {n: torch.zeros((Lkv, n_pages, PAGE_SIZE, H, w), dtype=torch.uint8, device=device)
            for n, w in (("k_codes", hd // 2), ("k_scales", 1), ("v_codes", hd // 2),
                         ("v_scales", 1))}
    leaves = [pool[n] for n in ("k_codes", "k_scales", "v_codes", "v_scales")]
    rec = {}
    for tag, n_tok in (("hybrid kv decode", N_SLOTS), ("hybrid kv prefill", SSM_CHUNK)):
        perm = torch.randperm((n_pages - 1) * PAGE_SIZE, generator=gen, device=device)[:n_tok]
        pid, off = (1 + perm // PAGE_SIZE).to(torch.int32), (perm % PAGE_SIZE).to(torch.int32)
        k, v = [(torch.randn((Lkv, n_tok, H, hd), generator=gen, device=device) * 1.5)
                .to(torch.bfloat16) for _ in range(2)]
        nbytes = 2 * Lkv * n_tok * H * (hd * 2 + hd / 2 + 1) + 8 * n_tok

        def plain(k=k, v=v, pid=pid, off=off):
            plain_quant_scatter(torch, pool["k_codes"], pool["k_scales"], pid, off, k)
            plain_quant_scatter(torch, pool["v_codes"], pool["v_scales"], pid, off, v)

        def kern(k=k, v=v, pid=pid, off=off):
            KV.kv_quant_scatter_kv(*leaves, pid, off, k, v)

        rec[("kv_quant_pack", tag)] = dict(
            ms=timer(kern), device_ms=timer.device(kern), plain_ms=timer(plain),
            bound_ms=nbytes / H100_BYTES_PER_S * 1e3, bound_by="bytes", library_ms=None)
    for n in ("k_scales", "v_scales"):
        pool[n].random_(100, 155, generator=gen)
    tables = (1 + torch.arange(n_pages - 1, device=device, dtype=torch.int32)).reshape(N_SLOTS, P)
    n_el = Lkv * N_SLOTS * P * PAGE_SIZE * H * hd
    nbytes = 2 * (n_el * (0.5 + 2) + n_el // hd) + 4 * tables.numel()
    idx = tables.long()
    rec[("kv_dequant_unpack", "hybrid kv gather")] = dict(
        ms=timer(lambda: gather_pages(pool, tables, torch.bfloat16)),
        device_ms=timer.device(lambda: gather_pages(pool, tables, torch.bfloat16)),
        plain_ms=timer(lambda: [KV.kv_dequant_unpack_plain(pool[c][:, idx], pool[s][:, idx],
                                                           torch.bfloat16)
                                for c, s in (("k_codes", "k_scales"), ("v_codes", "v_scales"))]),
        bound_ms=nbytes / H100_BYTES_PER_S * 1e3, bound_by="bytes", library_ms=None)
    del pool, leaves

    for arch in (HYBRID_ARCH, SSM_ARCH):
        spec = build_model(get_config(arch)).cache_spec(1, T)
        spec = spec["mamba"] if isinstance(spec, dict) else spec
        for name, (shape, dtype) in zip(("conv", "h"), cache_leaves(spec)):
            elems = math.prod(shape)
            padded = -(-elems // BLOCK) * BLOCK
            x = torch.randn((N_SLOTS * padded // ring_rows(padded), ring_rows(padded)),
                            generator=gen, device=device).to(dtype)
            es = x.element_size()
            c, s = KV.kv_quant_pack(x)
            packed = x.numel() * (0.5 + 1 / BLOCK)
            tag = f"{arch} ring {name}"
            rec[("kv_quant_pack", tag)] = dict(
                ms=timer(lambda x=x: KV.kv_quant_pack(x)),
                device_ms=timer.device(lambda x=x: KV.kv_quant_pack(x)),
                plain_ms=timer(lambda x=x: KV.kv_quant_pack_plain(x)),
                bound_ms=(x.numel() * es + packed) / H100_BYTES_PER_S * 1e3, bound_by="bytes",
                library_ms=None)
            rec[("kv_dequant_unpack", tag)] = dict(
                ms=timer(lambda c=c, s=s, dtype=dtype: KV.kv_dequant_unpack(c, s, dtype)),
                device_ms=timer.device(lambda c=c, s=s, dtype=dtype:
                                       KV.kv_dequant_unpack(c, s, dtype)),
                plain_ms=timer(lambda c=c, s=s, dtype=dtype:
                               KV.kv_dequant_unpack_plain(c, s, dtype)),
                bound_ms=(x.numel() * es + packed) / H100_BYTES_PER_S * 1e3, bound_by="bytes",
                library_ms=None)
            del x, c, s
    return rec


def check_cross_kernels(torch, device="cuda"):
    """B4a and B4b at the cross families' planes, bit for bit against their
    plain versions on the card.  At whisper-tiny's head dim of 64 (two
    32-blocks a head): the K+V scatter of a decode tick (N_SLOTS tokens) and
    a prefill chunk (CROSS_CHUNK tokens) into every layer of the self-KV
    plane's leaves, K and V read through strides (16-byte loads) and through
    rows no 16-byte load can read; the 2-d entry over the E8M0 edge rows in
    f32 and bf16; the K+V gather over ragged tables from leaves holding every
    (byte, scale code) pair.  Then each cross plane's scatter of a whole
    source into one slot's pages (whisper 1500 tokens, the VLM 1600: every
    layer's K and V in one launch) and the gather of N_SLOTS slots' cross
    pages, sliced to the source's length as the steps slice it.  Returns a
    summary (one launch each asserted)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import kv_pack as KV
    from repro_torch.serve.paged_cache import gather_pages

    gen = torch.Generator(device=device).manual_seed(SEED + 11)
    wcfg = get_config(WHISPER_ARCH)
    L, H, hd = wcfg.num_layers, wcfg.num_kv_heads, wcfg.head_dim_
    kh, u8 = hd // 2, torch.uint8
    T = max(CROSS_PROMPTS) + CROSS_NEW
    P = -(-T // PAGE_SIZE)
    n_pages = 1 + N_SLOTS * P
    out = {}

    def leaves(n_layers, n_pg, heads, width):
        return [torch.zeros((n_layers, n_pg, PAGE_SIZE, heads, w), dtype=u8, device=device)
                for w in (width // 2, width // 32, width // 2, width // 32)]

    for tag, n_tok in (("decode", N_SLOTS), ("prefill", CROSS_CHUNK)):
        for vec in (True, False):
            width = hd if vec else hd + 1  # rows of 65: no 16-byte load reads them
            base = (torch.randn((L, 2 * n_tok, H, width), generator=gen, device=device)
                    * torch.exp2(torch.randint(-6, 7, (L, 2 * n_tok, H, 1), generator=gen,
                                               device=device).float())).to(torch.bfloat16)
            k, v = base[:, ::2, :, :hd], base[:, 1::2, :, :hd]
            perm = torch.randperm((n_pages - 1) * PAGE_SIZE, generator=gen,
                                  device=device)[:n_tok]
            pid = (1 + perm // PAGE_SIZE).to(torch.int32)
            off = (perm % PAGE_SIZE).to(torch.int32)
            got, want = leaves(L, n_pages, H, hd), leaves(L, n_pages, H, hd)
            before = KV.kv_quant_pack.launches
            KV.kv_quant_scatter_kv(*got, pid, off, k, v)
            if KV.kv_quant_pack.launches - before != 1:
                raise AssertionError("hd-64 K+V scatter took more than one launch")
            plain_quant_scatter(torch, want[0], want[1], pid, off, k)
            plain_quant_scatter(torch, want[2], want[3], pid, off, v)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"hd-64 B4a scatter ({tag}, vector loads {vec}) differs "
                                     f"from its plain version")
            out[f"hd64_scatter_{tag}{'' if vec else '_scalar_loads'}"] = [L, n_tok, H, hd]
    x = torch.from_numpy(kv_edge_rows(np)).to(device)  # rows of 64: two blocks
    for dt in (torch.float32, torch.bfloat16):
        c, s = KV.kv_quant_pack(x.to(dt))
        pc, ps = KV.kv_quant_pack_plain(x.to(dt))
        if not (torch.equal(c, pc) and torch.equal(s, ps)):
            raise AssertionError(f"hd-64 B4a 2-d ({dt}) differs from its plain version on the "
                                 f"E8M0 edge rows")
    out["hd64_edge_rows"] = x.shape[0]
    shape = (L, n_pages, PAGE_SIZE, H)
    kc, ks = every_pair(torch, (*shape, kh), (*shape, hd // 32), 0, device)
    vc, vs = every_pair(torch, (*shape, kh), (*shape, hd // 32), 97, device)
    perm = 1 + torch.randperm(n_pages - 1, generator=gen, device=device)[:N_SLOTS * P]
    tables = perm.to(torch.int32).reshape(N_SLOTS, P)
    tables[1, 3:] = 0  # a short slot: its unmapped columns read the scratch page
    tables[2, 5] = tables[0, 0]  # a page read twice
    idx = tables.long()
    for dt in (torch.float32, torch.bfloat16):
        before = KV.kv_dequant_unpack.launches
        gk, gv = KV.kv_gather_dequant_kv(kc, ks, vc, vs, tables, dt)
        if KV.kv_dequant_unpack.launches - before != 1:
            raise AssertionError("hd-64 K+V gather took more than one launch")
        for g, c, s in ((gk, kc, ks), (gv, vc, vs)):
            want = KV.kv_dequant_unpack_plain(c[:, idx], s[:, idx], dt).reshape(g.shape)
            if not torch.equal(bit_pattern(torch, g), bit_pattern(torch, want)):
                raise AssertionError(f"hd-64 B4b gather ({dt}) differs from its plain version")
    out["hd64_gather"] = [L, N_SLOTS, P * PAGE_SIZE, H, hd]
    del kc, ks, vc, vs, gk, gv

    for arch in (WHISPER_ARCH, VLM_ARCH):
        cfg = get_config(arch)
        Lc = cfg.num_layers if cfg.family == "encdec" else cfg.num_layers // cfg.cross_attn_every
        n = cfg.max_source_len if cfg.family == "encdec" else cfg.num_image_tokens
        Hc, hdc = cfg.num_kv_heads, cfg.head_dim_
        cpp = -(-n // PAGE_SIZE)
        n_pg = 1 + (N_SLOTS + 2) * cpp
        tables = (1 + torch.randperm(n_pg - 1, generator=gen, device=device)[:N_SLOTS * cpp]
                  ).to(torch.int32).reshape(N_SLOTS, cpp)
        k, v = [(torch.randn((Lc, 1, n, Hc, hdc), generator=gen, device=device)
                 * torch.exp2(torch.randint(-4, 5, (Lc, 1, n, Hc, 1), generator=gen,
                                            device=device).float())).to(torch.bfloat16)
                for _ in range(2)]
        pos = torch.arange(n, device=device)
        pid, off = tables[0][pos // PAGE_SIZE], pos % PAGE_SIZE
        got, want = leaves(Lc, n_pg, Hc, hdc), leaves(Lc, n_pg, Hc, hdc)
        before = KV.kv_quant_pack.launches
        KV.kv_quant_scatter_kv(*got, pid, off, k[:, 0], v[:, 0])  # the encode's scatter
        if KV.kv_quant_pack.launches - before != 1:
            raise AssertionError(f"{arch} cross scatter took more than one launch")
        plain_quant_scatter(torch, want[0], want[1], pid, off, k[:, 0])
        plain_quant_scatter(torch, want[2], want[3], pid, off, v[:, 0])
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"{arch} cross-plane scatter of {n} tokens differs from its "
                                 f"plain version")
        pool = dict(zip(("k_codes", "k_scales", "v_codes", "v_scales"), got))
        before = KV.kv_dequant_unpack.launches
        gk, gv = gather_pages(pool, tables, torch.bfloat16)
        gk, gv = gk[:, :, :n], gv[:, :, :n]
        if KV.kv_dequant_unpack.launches - before != 1:
            raise AssertionError(f"{arch} cross gather took more than one launch")
        idx = tables.long()
        for g, c, s, src in ((gk, got[0], got[1], k), (gv, got[2], got[3], v)):
            plain = KV.kv_dequant_unpack_plain(c[:, idx], s[:, idx], torch.bfloat16)
            plain = plain.reshape(Lc, N_SLOTS, cpp * PAGE_SIZE, Hc, hdc)[:, :, :n]
            rt = KV.kv_dequant_unpack_plain(*KV.kv_quant_pack_plain(
                src[:, 0].reshape(-1, hdc)), torch.bfloat16).reshape(Lc, n, Hc, hdc)
            if not (torch.equal(bit_pattern(torch, g), bit_pattern(torch, plain))
                    and torch.equal(bit_pattern(torch, g[:, 0]), bit_pattern(torch, rt))):
                raise AssertionError(f"{arch} cross-plane gather differs from its plain "
                                     f"version or from the source's round trip")
        out[f"{arch}_cross"] = {"scatter": [Lc, n, Hc, hdc], "gather": list(gk.shape),
                                "pages_a_source": cpp}
        del got, want, pool, gk, gv, k, v
    torch.cuda.empty_cache()
    return out


def check_narrow_linears(torch, device="cuda"):
    """B1 and B3 at whisper-tiny's narrow linears, bit for bit against their
    plain versions on the card: B1 on activations of a decode tick
    (N_SLOTS rows), a prefill chunk (CROSS_CHUNK rows) and the encoder's
    1500 frames at K = 384 and 1536, and on each weight's Wᵀ view (the
    attention's 384 x 384, the MLP's 384 x 1536 and 1536 x 384); B3 on
    those operands as ``quartet_linear`` passes them.  Returns the shapes."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import hadamard_quant as HQ
    from repro_torch.kernels import mxfp4_matmul as MM

    cfg = get_config(WHISPER_ARCH)
    d, f = cfg.d_model, cfg.d_ff
    gen = torch.Generator(device=device).manual_seed(SEED + 15)
    shapes = []
    for m in (N_SLOTS, CROSS_CHUNK, cfg.max_source_len):
        for K, N in ((d, d), (d, f), (f, d)):
            x = (torch.randn((m, K), generator=gen, device=device) * 1.9).to(torch.bfloat16)
            w = (torch.randn((K, N), generator=gen, device=device) / K**0.5).to(torch.bfloat16)
            qs = []
            for name, t in (("x", x), ("Wᵀ", w.t())):
                got = HQ.hadamard_quest_quantize(t)
                for g, w_, what in zip(got, HQ.hadamard_quest_quantize_plain(t),
                                       ("codes", "scales", "mask")):
                    if not torch.equal(g, w_):
                        raise AssertionError(f"hadamard_quest_quantize {name} [{m}, {K}, {N}]: "
                                             f"{what} differ at {int((g != w_).sum())} places")
                qs.append(got)
            (ac, as_, _), (wc, ws, _) = qs
            got = MM.mxfp4_matmul(ac, as_, wc.t(), ws.t())
            want = MM.mxfp4_matmul_plain(ac, as_, wc.t(), ws.t())
            if not torch.equal(got, want):
                raise AssertionError(f"mxfp4_matmul [{m}, {K}, {N}]: max |Δ| "
                                     f"{float((got - want).abs().max())}")
            shapes.append([m, K, N])
    return shapes


def check_layernorm_card_vs_cpu(torch, device="cuda"):
    """``models.layers.layernorm`` on the card against the CPU, bit for bit,
    at whisper-tiny's d 384 and the VLM's width 4096, f32 and bf16, rows at
    scales 2^-8..2^8 with a per-row offset (the mean matters)."""
    from repro_torch.models import layers as L

    gen = torch.Generator().manual_seed(SEED + 12)
    out = {}
    for d, rows in ((384, 8192), (4096, 1024)):
        for dtype in (torch.float32, torch.bfloat16):
            x = ((torch.randn((rows, d), generator=gen) + 3 * torch.randn((rows, 1), generator=gen))
                 * torch.exp2(torch.randint(-8, 8, (rows, 1), generator=gen).float())).to(dtype)
            p = {"scale": (1 + 0.1 * torch.randn(d, generator=gen)).to(dtype),
                 "bias": (0.1 * torch.randn(d, generator=gen)).to(dtype)}
            card = L.layernorm({k: t.to(device) for k, t in p.items()}, x.to(device), 1e-5)
            host = L.layernorm(p, x, 1e-5)
            out[f"d{d}_{str(dtype).split('.')[-1]}"] = nd = _bits_differ(torch, card, host)
            if nd:
                raise AssertionError(f"layernorm at d {d} {dtype}: {nd} values differ between "
                                     f"the card and the CPU")
    return out


def _cross_engine(model, params, *, kv="mxfp4", backend=None, prefix=False):
    from repro_torch.serve import Engine, EngineConfig

    max_len = -(-(max(CROSS_PROMPTS) + CROSS_NEW) // PAGE_SIZE) * PAGE_SIZE
    return Engine(model, params, EngineConfig(
        n_slots=N_SLOTS, max_len=max_len, page_size=PAGE_SIZE, kv_dtype=kv,
        prefill_chunk=CROSS_CHUNK, keep_logits=True, decode_backend=backend,
        prefix_cache=prefix))


def _cross_wave(torch, eng, prompts, extras, max_new):
    """One wave of requests at t = 0 on ``eng``: (requests, wall s,
    first-token s by rid, tick s by kind), each request checked for
    ``max_new`` tokens in range and finite logits."""
    import numpy as np

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new, extra=x, arrival_time=0.0) for p, x in zip(prompts, extras)]
    first, ticks = {}, {"prefill": [], "decode": []}
    while eng.sched.pending:
        kind = "prefill" if eng.sched.queue or eng.sched.prefilling() else "decode"
        s0 = time.perf_counter()
        eng.step(now=s0 - t0)
        ticks[kind].append(time.perf_counter() - s0)
        for r in reqs:
            if r.tokens and r.rid not in first:
                first[r.rid] = time.perf_counter() - t0
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    V = eng.model.cfg.vocab_size
    for r in reqs:
        if len(r.tokens) != max_new or not all(0 <= t < V for t in r.tokens):
            raise AssertionError(f"request {r.rid}: {len(r.tokens)} tokens "
                                 f"({r.finish_reason!r}) or a token out of range")
        if any(row.shape != (V,) or not np.isfinite(row).all() for row in r.logits_trace):
            raise AssertionError(f"request {r.rid}: non-finite or misshapen logits")
    return reqs, wall, first, ticks


def _teacher_forced_last(torch, model, params, prompt, extra, device="cuda"):
    """f32 logits of ``prompt``'s last position by the cache-free forward
    (params cast as the serving steps cast them)."""
    from repro_torch.train.serve import cast_params

    cp = cast_params(params, getattr(torch, model.cfg.dtype))
    with torch.inference_mode():
        feats, _ = model.forward(cp, torch.from_numpy(prompt)[None].to(device), 0, extra=extra,
                                 features_only=True)
        return model.head(cp, feats[:, -1:], 0)[0, 0].float().cpu()


def _cross_first_token(torch, model, params, prompts, extras, reqs, device="cuda"):
    """(max |Δ|, mean |Δ|) of each request's first-token log-probs against
    the teacher-forced forward of its prompt and its conditioning."""
    out = []
    for p, x, r in zip(prompts, extras, reqs):
        ref = torch.log_softmax(_teacher_forced_last(torch, model, params, p, x, device), -1)
        d = (torch.log_softmax(torch.as_tensor(r.logits_trace[0]).float(), -1) - ref).abs()
        out.append((float(d.max()), float(d.mean())))
    return out


def serve_cross(torch, ops, arch, device="cuda"):
    """``arch`` (WHISPER_ARCH or VLM_ARCH) at full width and depth from MXFP4
    self- and cross-KV planes (the ``statepool`` backend, the prefix cache
    on): CROSS_PROMPTS with their own conditioning, CROSS_NEW new each;
    launches of B1, B3, B4a and B4b against a prediction, first-token
    log-probs against the teacher-forced forward; a second wave of the same
    prompts and sources encoding nothing and token-exact against the first;
    for the VLM its logits moved by its gates; then statepool with dense
    planes token for token against ``dense_slots`` (the VLM at
    CROSS_ORACLE_LAYERS).  Returns (summary, launch counts, vector-body
    launches)."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.convert import init_params
    from repro_torch.launch.serve_engine import kernel_config, make_extra
    from repro_torch.models import build_model

    cfg = kernel_config(get_config(arch))
    vlm = cfg.family == "vlm"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=device).manual_seed(SEED), device)
    if vlm:
        params["cross_layers"]["gate_attn"].fill_(VLM_GATES[0])
        params["cross_layers"]["gate_mlp"].fill_(VLM_GATES[1])
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in _leaves(params))
    log(f"  {arch} init: {n_params} stored params ({cfg.n_params()} by the reference's "
        f"formula) in {time.perf_counter() - t0:.1f} s")
    model = build_model(cfg)
    rng = np.random.default_rng(SEED + 13)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in CROSS_PROMPTS]
    extras = [make_extra(cfg, SEED + i, device) for i in range(len(prompts))]
    # warm-up (first-use costs): an encode, a chunk, decodes
    _cross_wave(torch, _cross_engine(model, params), [prompts[0]], extras[:1], 2)
    eng = _cross_engine(model, params, prefix=True)
    calls = _count_step_calls(eng, "_state_steps")
    ops.reset_launch_counts()
    reqs, wall, first, ticks = _cross_wave(torch, eng, prompts, extras, CROSS_NEW)
    counts, vec = ops.launch_counts(), ops.vector_launches()
    step_calls = dict(calls)
    n_dec, n_pre = calls.get("decode_all", 0), calls.get("prefill_chunk", 0)
    n_enc = calls.get("encode_cross", 0)
    L = cfg.num_layers
    if vlm:
        # a dense layer's 7 linears; a cross block reading its cache: wq, wo
        # and 3 MLP linears, recomputing from the image in prefill: + wk, wv;
        # the encode: wk, wv of every cross block (the untied head is bf16)
        n_super = L // cfg.cross_attn_every
        lin = (7 * L + 5 * n_super) * n_dec + (7 * L + 7 * n_super) * n_pre + 2 * n_super * n_enc
    else:
        # a decoder layer's 4 self-attention, 2 cross (wq, wo) and 2 MLP
        # linears; the encode: 6 linears an encoder layer and wk, wv a
        # decoder layer (the tied head is bf16)
        lin = 8 * L * (n_dec + n_pre) + (6 * cfg.encoder_layers + 2 * L) * n_enc
    predicted = {k: 0 for k in counts}
    # B4a: a step's new tokens (K and V in one launch) and an encode's whole
    # source; B4b: a step's self-KV gather and cross-KV gather
    predicted.update({"hadamard_quest_quantize": 2 * lin, "mxfp4_matmul": lin,
                      "kv_quant_pack": n_dec + n_pre + n_enc,
                      "kv_dequant_unpack": 2 * (n_dec + n_pre)})
    if counts != predicted or n_enc != len(prompts):
        raise AssertionError(f"{arch} launches {counts} != predicted {predicted} "
                             f"(step calls {step_calls})")
    lp = _cross_first_token(torch, model, params, prompts, extras, reqs, device)
    # a one-chunk VLM prompt reads no quantized state (its cross K/V are
    # recomputed from the image, its self-KV is the chunk's own): its first
    # token equals the teacher-forced forward's bit for bit (whisper's reads
    # the pooled MXFP4 cross-KV)
    one_chunk = [x for (x, _), p in zip(lp, prompts) if p.size <= CROSS_CHUNK]
    if vlm and any(x != 0 for x in one_chunk):
        raise AssertionError(f"one-chunk VLM prompts' first-token log-probs differ from the "
                             f"teacher-forced forward's: max |Δ| {one_chunk}")
    encodes = eng.telemetry.registry.counter("cross_encode_calls").value
    warm, wwall, _, _ = _cross_wave(torch, eng, prompts, extras, CROSS_NEW)
    if eng.telemetry.registry.counter("cross_encode_calls").value != encodes or \
            [r.tokens for r in warm] != [r.tokens for r in reqs]:
        raise AssertionError(f"{arch} second wave: encodes {encodes} -> "
                             f"{eng.telemetry.registry.counter('cross_encode_calls').value}, "
                             f"tokens equal "
                             f"{[r.tokens for r in warm] == [r.tokens for r in reqs]}")
    eng.cache.check_invariants()
    sp = eng.cache
    kv, cross = sp.kv, sp.cross
    cpp = cross.pages_needed(sp.cross_tokens)
    itemsize = 2
    cross_req = cross.cache_bytes() // cross.n_pages * cpp
    cross_req_dense = 2 * cross.layers * sp.cross_tokens * cross.kv_heads * cross.head_dim * itemsize
    kv_token = kv.cache_bytes() // (kv.n_pages * kv.page_size)
    kv_token_dense = 2 * kv.layers * kv.kv_heads * kv.head_dim * itemsize
    ttft = sorted(first.values())
    toks = sum(len(r.tokens) for r in reqs)
    summary = {"arch": arch, "stored_params": n_params,
               "n_params_reference_formula": cfg.n_params(),
               "n_params_reference_formula_with_embeddings": cfg.n_params(False),
               "requests": len(reqs), "prompts": [int(p.size) for p in prompts],
               "cross_tokens": sp.cross_tokens, "tokens": toks, "wall_s": wall,
               "tok_per_s": toks / wall, "ttft_mean_s": float(np.mean(ttft)),
               "ttft_max_s": ttft[-1], "prefill_ticks": len(ticks["prefill"]),
               "prefill_tick_ms_median": 1e3 * sorted(ticks["prefill"])[
                   len(ticks["prefill"]) // 2],
               "decode_ticks": len(ticks["decode"]),
               "decode_tick_ms_median": 1e3 * sorted(ticks["decode"])[len(ticks["decode"]) // 2],
               "step_calls": step_calls, "launches": counts, "predicted_launches": predicted,
               "warm_wave_wall_s": wwall, "cross_encode_calls": encodes,
               "counters": _engine_counts(eng, PREFIX_COUNTERS + ("cross_encode_calls",)),
               "cross_bytes_per_request": cross_req,
               "cross_bytes_per_request_bf16": cross_req_dense,
               "cross_pages_per_request": cpp, "cross_plane_bytes": cross.cache_bytes(),
               "kv_bytes_per_token": kv_token, "kv_bytes_per_token_bf16": kv_token_dense,
               "kv_plane_bytes": kv.cache_bytes(), "pool_bytes": sp.cache_bytes(),
               "dense_slot_bytes": N_SLOTS * (sp.max_len * kv_token_dense + cross_req_dense),
               "bits_per_element": sp.bits_per_element(),
               "state_bytes_per_decode_step": sp.state_bytes_per_decode_step(sp.max_len),
               "dense_state_bytes_per_decode_step":
                   sp.dense_state_bytes_per_decode_step(sp.max_len),
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
               "first_token_logprob_vs_teacher_forced": lp,
               "one_chunk_first_token_logprob_max_abs": one_chunk}
    log(f"  mxfp4 planes: {json.dumps(summary)}")
    if not all(x < CROSS_LOGPROB_MAX and y < CROSS_LOGPROB_MEAN for x, y in lp):
        raise AssertionError(f"MXFP4-plane first-token log-probs vs teacher-forced beyond "
                             f"({CROSS_LOGPROB_MAX}, {CROSS_LOGPROB_MEAN}): {lp}")
    del eng, reqs, warm
    if vlm:  # the cross path reaches the logits only through the gates
        gated = _teacher_forced_last(torch, model, params, prompts[0], extras[0], device)
        zero = {**params, "cross_layers": {**params["cross_layers"],
                                           "gate_attn": torch.zeros_like(
                                               params["cross_layers"]["gate_attn"]),
                                           "gate_mlp": torch.zeros_like(
                                               params["cross_layers"]["gate_mlp"])}}
        summary["gates_max_abs_logit_change"] = d = float(
            (gated - _teacher_forced_last(torch, model, zero, prompts[0], extras[0], device)
             ).abs().max())
        if not d > 0:
            raise AssertionError("the VLM's logits do not change with its gates")

    # the oracle: dense planes hold the KV bit for bit, so statepool's tokens
    # are dense_slots'
    small, sparams = model, params
    if vlm:
        small = build_model(dataclasses.replace(cfg, num_layers=CROSS_ORACLE_LAYERS))
        n_sup = CROSS_ORACLE_LAYERS // cfg.cross_attn_every
        sparams = {**params,
                   "layers": _tree_map(lambda v: v[:CROSS_ORACLE_LAYERS], params["layers"]),
                   "cross_layers": _tree_map(lambda v: v[:n_sup], params["cross_layers"])}
    runs = {}
    for backend, kv_dtype in (("statepool", "dense"), ("dense_slots", "mxfp4")):
        runs[backend], _, _, _ = _cross_wave(
            torch, _cross_engine(small, sparams, kv=kv_dtype, backend=backend), prompts,
            extras, CROSS_ORACLE_NEW)
    pooled, oracle = ([r.tokens for r in runs[b]] for b in ("statepool", "dense_slots"))
    if pooled != oracle:
        raise AssertionError(f"statepool (dense planes) tokens {pooled} != dense_slots tokens "
                             f"{oracle}")
    summary["oracle"] = {"layers": small.cfg.num_layers, "requests": len(prompts),
                         "new": CROSS_ORACLE_NEW, "tokens_equal": True,
                         "dense_planes_first_token_logprob_vs_teacher_forced":
                             _cross_first_token(torch, small, sparams, prompts, extras,
                                                runs["statepool"], device)}
    del params, sparams, runs
    torch.cuda.empty_cache()
    return summary, counts, vec


def time_cross_kernels(torch, timer, device="cuda"):
    """B4b's cross-plane gather of a decode tick (N_SLOTS slots' whole
    sources, bf16 out, as the decode step gathers them) and B4a's scatter
    of one source (the encode's), for each cross family, beside the plain
    versions and the least time on the H100 (bytes: each input read once,
    each output written once)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import kv_pack as KV
    from repro_torch.serve.paged_cache import gather_pages

    gen = torch.Generator(device=device).manual_seed(SEED + 14)
    rec = {}
    for arch in (WHISPER_ARCH, VLM_ARCH):
        cfg = get_config(arch)
        Lc = cfg.num_layers if cfg.family == "encdec" else cfg.num_layers // cfg.cross_attn_every
        n = cfg.max_source_len if cfg.family == "encdec" else cfg.num_image_tokens
        H, hd = cfg.num_kv_heads, cfg.head_dim_
        cpp = -(-n // PAGE_SIZE)
        n_pages = 1 + N_SLOTS * cpp
        pool = {name: torch.zeros((Lc, n_pages, PAGE_SIZE, H, w), dtype=torch.uint8,
                                  device=device)
                for name, w in (("k_codes", hd // 2), ("k_scales", hd // 32),
                                ("v_codes", hd // 2), ("v_scales", hd // 32))}
        leaves = [pool[m] for m in ("k_codes", "k_scales", "v_codes", "v_scales")]
        k, v = [(torch.randn((Lc, n, H, hd), generator=gen, device=device) * 1.5)
                .to(torch.bfloat16) for _ in range(2)]
        pos = torch.arange(n, device=device)
        pid, off = (1 + pos // PAGE_SIZE).to(torch.int32), (pos % PAGE_SIZE).to(torch.int32)
        n_el = Lc * n * H * hd
        nbytes = 2 * (n_el * 2 + n_el // 2 + n_el // 32) + 8 * n

        def plain(k=k, v=v, pid=pid, off=off, pool=pool):
            plain_quant_scatter(torch, pool["k_codes"], pool["k_scales"], pid, off, k)
            plain_quant_scatter(torch, pool["v_codes"], pool["v_scales"], pid, off, v)

        def kern(k=k, v=v, pid=pid, off=off, leaves=leaves):
            KV.kv_quant_scatter_kv(*leaves, pid, off, k, v)

        rec[("kv_quant_pack", f"{arch} cross encode scatter")] = dict(
            ms=timer(kern), device_ms=timer.device(kern), plain_ms=timer(plain),
            bound_ms=nbytes / H100_BYTES_PER_S * 1e3, bound_by="bytes", library_ms=None)
        for m in ("k_scales", "v_scales"):
            pool[m].random_(100, 155, generator=gen)
        tables = (1 + torch.arange(n_pages - 1, device=device, dtype=torch.int32)
                  ).reshape(N_SLOTS, cpp)
        idx = tables.long()
        n_el = Lc * N_SLOTS * n * H * hd  # what the step reads: the sliced sources
        n_read = Lc * N_SLOTS * cpp * PAGE_SIZE * H * hd
        nbytes = 2 * (n_read // 2 + n_read // 32 + n_el * 2) + 4 * tables.numel()

        def gather(pool=pool, tables=tables, n=n):
            k, v = gather_pages(pool, tables, torch.bfloat16)
            return k[:, :, :n], v[:, :, :n]

        rec[("kv_dequant_unpack", f"{arch} cross decode gather")] = dict(
            ms=timer(gather), device_ms=timer.device(gather),
            plain_ms=timer(lambda pool=pool, idx=idx: [
                KV.kv_dequant_unpack_plain(pool[c][:, idx], pool[s][:, idx], torch.bfloat16)
                for c, s in (("k_codes", "k_scales"), ("v_codes", "v_scales"))]),
            bound_ms=nbytes / H100_BYTES_PER_S * 1e3, bound_by="bytes", library_ms=None)
        del pool, leaves, k, v
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
# phase 4i: Quartet training of the SSM, hybrid, enc-dec and VLM families
# ---------------------------------------------------------------------------


def state_train_launches(cfg) -> dict[str, int]:
    """B1, B2 and B3 launches of one microbatch of a Quartet train step,
    from the model's code.  A quantized linear's forward takes 2 B1 and 1
    B3, its backward 4 B2 and 2 B3; remat runs forwards again.  A layer
    under one checkpoint runs its forward twice.  Under the hierarchical
    remat (the hybrid's and the VLM's super-blocks, each layer inside
    checkpointed again) the backward recomputes a super-block's forward,
    which runs its inner layers as checkpoints, then each inner layer's
    forward again; the recompute stops once the super-block's last saved
    tensor is back (``torch.utils.checkpoint``'s early stop), which is the
    input of its last inner layer: so a super-block's own block (the shared
    attention, the cross block) runs twice, each inner layer but its last
    three times, the last twice.  The heads stay bf16 (``quantize_lm_head``
    is off, as in the reference)."""
    L = cfg.num_layers
    if cfg.family == "ssm":  # in, x, dt, out projections
        fwd, apps = 2 * 4 * L, 4 * L
    elif cfg.family == "encdec":  # 6 an encoder layer, 10 a decoder layer
        lin = 6 * cfg.encoder_layers + 10 * L
        fwd, apps = 2 * lin, lin
    elif cfg.family == "hybrid":  # the shared block's 7, a Mamba2 layer's in and out
        from repro_torch.models.hybrid import split_counts

        n_super, per, tail = split_counts(cfg)
        fwd = 7 * 2 * n_super + 2 * (n_super * (3 * (per - 1) + 2) + 2 * tail)
        apps = 7 * n_super + 2 * L
    else:  # the VLM: a cross block's 7 (wk, wv on the image), a dense layer's 7
        from repro_torch.models.vlm import split_counts

        n_super, per = split_counts(cfg)
        fwd = 7 * 2 * n_super + 7 * n_super * (3 * (per - 1) + 2)
        apps = 7 * n_super + 7 * L
    return {"hadamard_quest_quantize": 2 * fwd, "sr_hadamard_quantize": 4 * apps,
            "mxfp4_matmul": fwd + 2 * apps}


def state_train_config(arch: str):
    """``arch`` at its published widths, its depth cut to STATE_TRAIN's
    layers (None: full depth), Quartet on the kernels."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve_engine import kernel_config

    cfg = get_config(arch)
    layers = STATE_TRAIN[arch][0]
    return kernel_config(dataclasses.replace(cfg, num_layers=layers) if layers else cfg)


def check_state_train_kernels(torch, device="cuda"):
    """B2 and B3 bit for bit against their plain versions at the backward
    operands of the new training shapes: falcon-mamba-7b's in_proj (K 4096,
    N 16384) and zamba2-7b's (K 3584, N 14576, not a multiple of 32: dy and
    Wq padded to 14592 along N, as ``quartet._backward_kernels`` pads them),
    over one microbatch of STATE_TRAIN_BATCH x TRAIN_SEQ tokens; then each
    whole ``quartet_linear`` backward on the kernels against the plain
    versions (rtol 1e-5, as the kernels phase holds it).  Returns the max
    abs errors."""
    from repro_torch.core import fastrng
    from repro_torch.core.quartet import (QuartetConfig, _backward_kernels, _forward_kernels,
                                          _pad32)
    from repro_torch.kernels import mxfp4_matmul as MM
    from repro_torch.kernels import sr_hadamard_quant as SR

    gen = torch.Generator(device=device).manual_seed(SEED + 9)
    seed, T = 4321, STATE_TRAIN_BATCH * TRAIN_SEQ
    err = {"sr_hadamard_quantize": 0.0, "mxfp4_matmul": 0.0, "quartet_linear backward": 0.0}
    for name, K, N in (("falcon-mamba-7b in_proj", 4096, 16384),
                       ("zamba2-7b in_proj", 3584, 14576)):
        opnds = backward_operands(torch, K, N, gen, device, T)
        opnds["dy"], opnds["Wq"] = _pad32(opnds["dy"], -1), _pad32(opnds["Wq"], -1)
        codes = {}
        for salt, (what, x) in enumerate(opnds.items(), 1):
            signs = fastrng.rademacher(seed, x.shape[1], salt=11 if salt < 3 else 12,
                                       device=device)
            got = SR.sr_hadamard_quantize(x, signs, seed, salt=salt)
            want = SR.sr_hadamard_quantize_plain(x, signs, seed, salt=salt)
            if not all(torch.equal(g, w_) for g, w_ in zip(got, want)):
                raise AssertionError(f"sr_hadamard_quantize at {name} {what} {tuple(x.shape)} "
                                     f"differs from its plain version")
            codes[what] = got
        for what, (a, b) in (("dx", ("dy", "Wq")), ("dW", ("xqᵀ", "dyᵀ"))):
            args = (*codes[a], codes[b][0].t(), codes[b][1].t())
            got, want = MM.mxfp4_matmul(*args), MM.mxfp4_matmul_plain(*args)
            if not torch.equal(got, want):
                raise AssertionError(f"mxfp4_matmul at {name} {what}: max |Δ| "
                                     f"{float((got - want).abs().max())}")
        qc = QuartetConfig(use_kernels=True)
        x = torch.randn((STATE_TRAIN_BATCH, TRAIN_SEQ, K), generator=gen,
                        device=device).to(torch.bfloat16)
        w = (torch.randn((K, N), generator=gen, device=device) / K**0.5).to(torch.bfloat16)
        dy = (torch.randn((*x.shape[:-1], N), generator=gen, device=device)
              * 1e-3).to(torch.bfloat16)
        _, res = _forward_kernels(x, w, qc)
        dx, dw = _backward_kernels(qc, seed, res, dy)
        pdx, pdw = _backward_kernels(qc, seed, res, dy, ops=PlainOps())
        for what, a, b in (("dx", dx, pdx), ("dW", dw, pdw)):
            if not torch.allclose(a, b, rtol=1e-5, atol=1e-6 * float(b.abs().max())):
                raise AssertionError(f"quartet_linear backward at {name} {what}: kernels vs "
                                     f"plain max |Δ| {float((a - b).abs().max())}")
            err["quartet_linear backward"] = max(err["quartet_linear backward"],
                                                 float((a - b).abs().max()))
        del opnds, codes, x, w, dy, res
    torch.cuda.synchronize()
    return err


def _reduced_conditioning(torch, cfg, batch: int):
    """f32 standard normals from SEED on the CPU: the enc-dec model's
    ``source_embeds`` or the VLM's ``image_embeds`` of a reduced config, or
    {} for the other families."""
    n = {"encdec": cfg.max_source_len, "vlm": cfg.num_image_tokens}.get(cfg.family)
    if n is None:
        return {}
    x = torch.randn((batch, n, cfg.d_model), generator=torch.Generator().manual_seed(SEED))
    return {"source_embeds" if cfg.family == "encdec" else "image_embeds": x}


def train_state_reduced_card_vs_cpu(torch, device="cuda"):
    """Each family's reduced config (f32 compute, Quartet) takes one train
    step (AdamW at a constant lr of 1e-3, so the step moves every
    parameter; clip 1.0; 4 x 64 tokens, with the conditioning of the cross
    families; the VLM's gates at VLM_GATES) from the same weights and batch
    three times: on the card with the kernels, on the card with their plain
    versions behind ``kernels.ops``'s signatures (:class:`PlainOps`), and on
    the CPU (the plain versions).  Returns (by arch, the relative
    differences of loss, nll and grad-norm card vs CPU and the updated
    parameters' differences; the archs out of tolerance).

    Tolerance.  Kernels against plain versions on the card: loss, nll,
    grad-norm, every updated parameter and moment bit for bit (the kernels
    equal their plain versions, and a step on one device is deterministic).
    Card against CPU: loss and nll rtol 1e-5, the moe-train phase's step-0
    bound (the rest of the step rounds differently on the card: the blocked
    softmax by up to 1.04e-7 relative, the SSD's einsums and the
    broadcast parameters' gradient sums in their own orders); grad-norm
    rtol 1e-3, the dense check's step-0 bound; every updated parameter
    within 2·lr of the CPU's (AdamW's first step moves an element by
    lr·g/(|g| + eps) plus the decay).  The share of parameters more than
    1e-3·lr apart is reported, not bounded: those rounding differences reach
    the backward's stochastic roundings, a flipped decision moves a
    gradient row or column by a grid step, the layers below take it as a
    changed input and flip more, and AdamW's first update follows each
    element's sign (reduced zamba2-7b: 1.5% of its parameters, 4.6% of the
    shared block's wq).  Attention key biases are left out of the
    parameters' comparison (their gradient is rounding noise: softmax is
    invariant to them)."""
    import repro_torch.core.quartet as Q
    from repro_torch.configs import get_reduced_config
    from repro_torch.convert import init_params
    from repro_torch.data.pipeline import SyntheticC4Dataset, TokenBatcher
    from repro_torch.launch.serve_engine import kernel_config
    from repro_torch.models import build_model
    from repro_torch.optim import adamw
    from repro_torch.train.state import make_train_state
    from repro_torch.train.steps import _leaf_paths, make_train_step
    from repro_torch.tree import tree_leaves

    lr, plain, kernel_ops = 1e-3, PlainOps(), Q._kernel_ops
    out, bad = {}, []
    for arch in STATE_TRAIN:
        cfg = kernel_config(get_reduced_config(arch, dtype="float32"))
        model = build_model(cfg)
        params = init_params(cfg, torch.Generator().manual_seed(SEED), "cpu")
        if cfg.family == "vlm":
            params["cross_layers"]["gate_attn"].fill_(VLM_GATES[0])
            params["cross_layers"]["gate_mlp"].fill_(VLM_GATES[1])
        opt = adamw(lr)
        step = make_train_step(model, opt)
        batch = {k: torch.from_numpy(v) for k, v in TokenBatcher(
            SyntheticC4Dataset(cfg.vocab_size, seed=SEED), 4, 64).batch(0).items()}
        batch.update(_reduced_conditioning(torch, cfg, 4))
        on_card = {k: v.to(device) for k, v in batch.items()}
        cpu = make_train_state(params, opt)
        card, mc = step(_to_device(torch, cpu, device), on_card)
        Q._kernel_ops = lambda ops: plain if ops is None else ops
        try:
            card_plain, mpl = step(_to_device(torch, cpu, device), on_card)
        finally:
            Q._kernel_ops = kernel_ops
        cpu, mp = step(cpu, batch)
        same = all(float(mc[k]) == float(mpl[k]) for k in ("loss", "nll", "grad_norm")) and all(
            torch.equal(a, b) for a, b in zip(tree_leaves((card.params, card.opt_state)),
                                              tree_leaves((card_plain.params,
                                                           card_plain.opt_state)))
            if isinstance(a, torch.Tensor))
        rec = {"kernels_equal_plain_versions_on_card": same}
        rec.update({k: abs(float(mc[k]) - float(mp[k])) / abs(float(mp[k]))
                    for k in ("loss", "nll", "grad_norm")})
        worst, off, n, by_leaf = 0.0, 0, 0, {}
        for path, a, b in zip(_leaf_paths(cpu.params), tree_leaves(card.params),
                              tree_leaves(cpu.params)):
            if tuple(path[-2:]) == ("wk", "b"):
                continue
            d = (a.cpu() - b).abs()
            k = int((d > 1e-3 * lr).sum())
            worst, off, n = max(worst, float(d.max())), off + k, n + d.numel()
            if k:
                by_leaf[".".join(path)] = k / d.numel()
        rec.update(param_max_abs_over_lr=worst / lr, param_share_off=off / n,
                   param_share_off_by_leaf=dict(sorted(by_leaf.items(),
                                                       key=lambda kv: -kv[1])[:6]))
        out[arch] = rec
        if (not same or rec["loss"] > 1e-5 or rec["nll"] > 1e-5 or rec["grad_norm"] > 1e-3
                or worst > 2 * lr):
            bad.append(arch)
    log(f"  reduced families, one Quartet step from equal states, the kernels against their "
        f"plain versions on the card and card vs CPU: {json.dumps(out)} (tolerance: kernels = "
        f"plain versions bit for bit; card vs CPU loss, nll 1e-5, grad-norm 1e-3, parameters "
        f"within 2·lr)")
    return out, bad


def train_state_full_width(torch, ops, arch, device="cuda"):
    """``arch`` at its published widths (STATE_TRAIN's depth), random
    weights from SEED (the VLM's gates at VLM_GATES), STATE_TRAIN_STEPS
    Quartet steps of STATE_TRAIN_BATCH x TRAIN_SEQ tokens of synthetic
    C4-like data through ``train.loop.train`` (the cross families with
    ``extra_batch``: a 1500-frame source or 1600 image tokens a sequence,
    bf16 normals from SEED + row, as the cross phase draws them), AdamW on a
    cosine schedule (the VLM: the 8-bit AdamW with a bf16 master).  Gates:
    step 0's loss in (1, 12), or in (1, ln(V) + 1) where that is wider (the
    VLM's vocabulary), every step's loss and grad-norm finite (a
    non-finite gradient leaf makes the norm so) and the norm above 1e-3;
    for the VLM, after the steps, every cross-block leaf's gradient (the
    gates' included) finite and non-zero on two sequences; B1, B2 and B3
    launches equal to :func:`state_train_launches`.  Then one more step
    under ``torch.profiler``: device time against wall time.  Returns
    (summary, launch counts, vector-body launches)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.convert import init_params
    from repro_torch.data.pipeline import SyntheticC4Dataset, TokenBatcher
    from repro_torch.launch.serve_engine import make_extra
    from repro_torch.models import build_model
    from repro_torch.optim import adamw, adamw8bit, cosine_warmup
    from repro_torch.train.loop import train
    from repro_torch.train.losses import chunked_lm_loss
    from repro_torch.train.steps import make_train_step
    from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

    _, micro, eight = STATE_TRAIN[arch]
    cfg = state_train_config(arch)
    model = build_model(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=device).manual_seed(SEED), device)
    if cfg.family == "vlm":
        params["cross_layers"]["gate_attn"].fill_(VLM_GATES[0])
        params["cross_layers"]["gate_mlp"].fill_(VLM_GATES[1])
    n_params = sum(p.numel() for p in _leaves(params))
    rows = [make_extra(cfg, SEED + i, device) for i in range(STATE_TRAIN_BATCH)]
    extra = ({k: torch.cat([r[k] for r in rows]) for k in rows[0]} if rows[0] else None)
    batcher = TokenBatcher(SyntheticC4Dataset(cfg.vocab_size, seed=SEED), STATE_TRAIN_BATCH,
                           TRAIN_SEQ)
    opt = (adamw8bit if eight else adamw)(cosine_warmup(3e-4, STATE_TRAIN_STEPS))
    master = "bfloat16" if eight else "float32"
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    state, hist = train(model, opt, batcher, STATE_TRAIN_STEPS, params=params,
                        extra_batch=extra, microbatch=micro, master_dtype=master,
                        device=device, log_every=1, log_fn=lambda m: log("  " + m))
    wall = time.perf_counter() - t0
    counts, vec = ops.launch_counts(), ops.vector_launches()
    del params
    per_mb = state_train_launches(cfg)
    predicted = {k: 0 for k in counts}
    predicted.update({k: v * micro * STATE_TRAIN_STEPS for k, v in per_mb.items()})
    if counts != predicted:
        raise AssertionError(f"{arch} training launches {counts} != predicted {predicted}")
    losses, norms = [h["loss"] for h in hist], [h["grad_norm"] for h in hist]
    # the reference's bound, (1, 12), "≈ ln(V) at init", written for its
    # reduced vocabulary of 512; its init laws give unit-variance logits, so
    # step 0's loss is about ln(V) + 1/2: 12.26 for the VLM's 128256 tokens,
    # whose upper bound is therefore ln(V) + 1
    top = max(12.0, math.log(cfg.vocab_size) + 1)
    if not (1 < losses[0] < top and all(math.isfinite(x) for x in losses + norms)
            and all(g > 1e-3 for g in norms)):
        raise AssertionError(f"{arch}: loss {losses}, grad-norm {norms} (step 0's loss must lie "
                             f"in (1, {top:.2f}); all finite; norms above 1e-3)")
    summary = {"arch": arch, "layers": cfg.num_layers, "stored_params": n_params,
               "optimizer": "adamw8bit, bf16 master" if eight else "adamw, f32 master",
               "steps": STATE_TRAIN_STEPS, "batch": STATE_TRAIN_BATCH, "seq": TRAIN_SEQ,
               "microbatches": micro, "init_s": init_s, "loss": losses,
               "ln_vocab": math.log(cfg.vocab_size), "step0_loss_bound": [1.0, top],
               "grad_norm": norms,
               "step_s": [h["dt"] for h in hist]}
    med = statistics.median(h["dt"] for h in hist[1:])  # step 0 carries first-use costs
    summary.update(median_step_s=med, tokens_per_s=STATE_TRAIN_BATCH * TRAIN_SEQ / med,
                   wall_s=wall, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                   launches=counts, predicted_launches=predicted,
                   predicted_per_microbatch=per_mb)
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in batcher.batch(STATE_TRAIN_STEPS).items()}
    if extra:
        batch.update(extra)
    if cfg.family == "vlm":  # the gates and the cross blocks learn
        cp = tree_map(lambda p: p.to(torch.bfloat16), state.params)
        leaves = [t.detach().requires_grad_() for t in tree_leaves(cp["cross_layers"])]
        names = [n for n, _ in _named_leaves(cp["cross_layers"])]
        cp["cross_layers"] = tree_unflatten(cp["cross_layers"], leaves)
        feats, _ = model.forward(cp, batch["tokens"][:2], 1, extra={
            "image_embeds": batch["image_embeds"][:2]}, features_only=True)
        loss, _ = chunked_lm_loss(model.head, cp, feats, batch["labels"][:2], 1)
        grads = torch.autograd.grad(loss, leaves)
        summary["cross_grad_max_abs"] = {n: float(g.abs().max()) for n, g in zip(names, grads)}
        if not all(torch.isfinite(g).all() and g.abs().max() > 0 for g in grads):
            raise AssertionError(f"VLM cross-block gradients zero or non-finite: "
                                 f"{summary['cross_grad_max_abs']}")
        del cp, leaves, feats, loss, grads
    step_fn = make_train_step(model, opt, microbatch=micro)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, m = step_fn(state, batch)
        float(m["loss"])
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t0
    busy = sum((getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0))
               for e in prof.key_averages() if str(e.device_type).endswith("CUDA")) / 1e3
    summary.update(profiled_step_ms=pwall * 1e3, device_busy_ms=busy,
                   device_idle_share=1 - busy / (pwall * 1e3))
    del state, m, batch, extra
    torch.cuda.empty_cache()
    return summary, counts, vec


# ---------------------------------------------------------------------------
# the telemetry phase: the engine's telemetry at full width
# ---------------------------------------------------------------------------


def _telemetry_off(eng) -> None:
    """Telemetry off as far as the engine allows: the hub's per-tick work
    (``end_tick``: gauges, histograms, the EWMA, sampling, sinks) and its
    phase sections, and the tracer's events, replaced by no-ops on this
    engine; the counters' increments and the steps' shape signatures stay."""
    tel = eng.telemetry
    tel.end_tick = tel.phase = tel.tracer.event = tel.tracer.tokens = lambda *a: None


def _time_end_tick(eng) -> list:
    """Host seconds of each ``end_tick`` of ``eng`` (the hub's per-tick
    work at its defaults), appended to the returned list."""
    spent, inner = [], eng.telemetry.end_tick

    def timed(*a):
        s0 = time.perf_counter()
        inner(*a)
        spent.append(time.perf_counter() - s0)

    eng.telemetry.end_tick = timed
    return spent


def _full_telemetry(root: str, tag: str):
    """Telemetry fully on: every sink, pool health every TEL_QUANT_STRIDE
    ticks, the profiler and its trace file, under ``root``."""
    from repro_torch.serve import TelemetryConfig

    return TelemetryConfig(
        metrics_path=os.path.join(root, f"{tag}.metrics.jsonl"),
        trace_path=os.path.join(root, f"{tag}.requests.jsonl"),
        prometheus_path=os.path.join(root, f"{tag}.prom"),
        quant_stride=TEL_QUANT_STRIDE, emit_every_ticks=TEL_QUANT_STRIDE,
        profile_trace_path=os.path.join(root, f"{tag}.trace.json"))


def _host_state_pool(sp):
    """A view of a StatePool with every plane's tensors copied to the host
    (the allocator's arrays and the ring cursor shared)."""
    def host(plane):
        if plane is None:
            return None
        view = copy.copy(plane)
        view.pool = {k: v.cpu() for k, v in plane.pool.items()}
        return view

    view = copy.copy(sp)
    view.kv, view.cross = host(sp.kv), host(sp.cross)
    view.rings = tuple(host(r) for r in sp.rings)
    return view


def _health_card_vs_cpu(eng) -> dict:
    """The pool-health reduction on the card equals the same reduction over
    the pool copied to the host, exactly, and the telemetry's gauges of this
    tick's sample equal the card's numbers.  Returns the card's sample."""
    from repro_torch.serve.telemetry.quant_health import (pool_health, sample_pool_health,
                                                          sample_state_health)

    if eng.backend == "paged":
        card = sample_pool_health(eng.cache)
        cpu = pool_health({k: v.cpu() for k, v in eng.cache.pool.items()},
                          eng.cache.page_mask())
        kv = card
    else:
        card = sample_state_health(eng.cache)
        cpu = sample_state_health(_host_state_pool(eng.cache))
        kv = card.get("kv")
    if card != cpu:
        raise AssertionError(f"pool health on the card {card} != on the host {cpu}")
    g = eng.telemetry.registry.gauge
    want = {}
    if kv is not None:
        want.update(kv_clip_fraction_k=kv["k"]["clip_frac"], kv_zero_fraction_v=kv["v"]["zero_frac"])
    if "cross" in card:
        want["cross_clip_fraction_v"] = card["cross"]["v"]["clip_frac"]
    if "state" in card:
        want["state_clip_fraction"] = card["state"]["clip_frac"]
    got = {k: g(k).value for k in want}
    if got != want:
        raise AssertionError(f"telemetry gauges {got} != the card's sample {want}")
    return card


def _telemetry_run(torch, ops, eng, prompts, max_new, extras=None, health=0):
    """Every request at t = 0 on ``eng`` (the wall clock as its clock), to
    the end; with ``health`` > 0 the first ``health`` ticks that sampled the
    pool are checked card against host.  Returns (tokens by request, wall
    s, launch counts, pool health samples checked, median decode tick s
    (a tick with nothing queued or prefilling; each ends in a host read))."""
    extras = extras or [None] * len(prompts)
    samples, decode_ticks = [], []
    gc.collect()
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new, extra=x, arrival_time=0.0) for p, x in zip(prompts, extras)]
    seen = 0
    while eng.sched.pending:
        decode = not (eng.sched.queue or eng.sched.prefilling())
        s0 = time.perf_counter()
        eng.step(now=s0 - t0)
        if decode:
            decode_ticks.append(time.perf_counter() - s0)
        n = eng.telemetry.registry.counter("quant_health_samples").value
        if n > seen:
            seen = n
            if len(samples) < health:
                samples.append(_health_card_vs_cpu(eng))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    for r in reqs:
        if len(r.tokens) != max_new:
            raise AssertionError(f"request {r.rid} finished with {len(r.tokens)} tokens")
    return [r.tokens for r in reqs], wall, counts, samples, statistics.median(decode_ticks)


def _same_pool(torch, a, b) -> bool:
    pa = a.cache.pool if a.backend == "paged" else a.cache.pools()
    pb = b.cache.pool if b.backend == "paged" else b.cache.pools()

    def leaves(t):
        if isinstance(t, dict):
            for k in sorted(t):
                yield from leaves(t[k])
        elif isinstance(t, (tuple, list)):
            for v in t:
                yield from leaves(v)
        elif t is not None:
            yield t

    return all(torch.equal(x, y) for x, y in zip(leaves(pa), leaves(pb), strict=True))


def _health_summary(samples) -> list:
    """The fractions of each checked sample (the histograms left out)."""
    def strip(h):
        return {k: strip(v) if isinstance(v, dict) else v for k, v in h.items()
                if k != "scale_hist"}
    return [strip(h) for h in samples]


def serve_telemetry(torch, ops, device="cuda"):
    """The engine's telemetry on the card.  qwen3-1.7b at full width and
    depth on the engine phase's 8 requests (paged backend, the kernels):
    telemetry off (the hub's per-tick work stubbed, ``_telemetry_off``)
    and at its defaults in turns (off, defaults, defaults, off) for tok/s,
    then fully on (JSONL metrics, request traces, Prometheus text, pool
    health every TEL_QUANT_STRIDE ticks, the profiler with its trace file):
    tokens, pool bytes and launch counts equal to the off run's, the files
    valid, ``prefill_calls``/``decode_calls`` equal to the step calls, the
    first TEL_HEALTH_CHECKS health samples equal on the card and on the
    host.  Then whisper-tiny (full depth, ``kv`` and ``cross`` health) and
    falcon-mamba-7b (full width, TEL_SSM_LAYERS layers, ``state`` health)
    on the state pool, off against fully on.  Returns (summary, launch
    counts of the fully-on qwen3-1.7b run)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.convert import init_params
    from repro_torch.launch.serve_engine import kernel_config, make_extra
    from repro_torch.models import build_model
    from repro_torch.serve import Engine, EngineConfig
    from repro_torch.serve.telemetry.profiling import validate_trace_file
    from repro_torch.serve.telemetry.schema import validate_metrics_file

    out = {"device": nvidia_smi_line()}
    root = tempfile.mkdtemp(prefix="telemetry-")
    cfg = kernel_config(get_config("qwen3-1.7b"))
    torch.cuda.empty_cache()
    params = init_params(cfg, torch.Generator(device=device).manual_seed(SEED), device)
    model = build_model(cfg)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(MIN_PROMPT, MAX_PROMPT + 1)))
               .astype(np.int32) for _ in range(N_REQUESTS)]

    def engine(tel=None):
        return Engine(model, params, EngineConfig(
            n_slots=N_SLOTS, max_len=MAX_LEN, page_size=PAGE_SIZE, kv_dtype="mxfp4",
            prefill_chunk=PREFILL_CHUNK, telemetry=tel))

    _telemetry_run(torch, ops, engine(), prompts, MAX_NEW)  # warm-up
    toks = N_REQUESTS * MAX_NEW
    rates = {"off": [], "defaults": []}
    ticks = {"off": [], "defaults": []}
    end_tick = []
    runs = {}
    for mode in ("off", "defaults", "defaults", "off") * TEL_AB_ROUNDS:
        eng = engine()
        if mode == "off":
            _telemetry_off(eng)
        else:
            end_tick.append(_time_end_tick(eng))
        tokens, wall, counts, _, tick = _telemetry_run(torch, ops, eng, prompts, MAX_NEW)
        rates[mode].append(toks / wall)
        ticks[mode].append(tick)
        runs.setdefault(mode, (eng, tokens, counts))
        if (tokens, counts) != runs[mode][1:]:
            raise AssertionError(f"telemetry {mode}: tokens or launches differ between runs")
        del eng
    off_eng, off_tokens, off_counts = runs["off"]
    if runs["defaults"][1] != off_tokens or runs["defaults"][2] != off_counts:
        raise AssertionError("telemetry at its defaults changed the tokens or the launches")

    def spread(xs):
        return (max(xs) - min(xs)) / statistics.mean(xs)

    out["tok_per_s"] = {
        "order": f"(off, defaults, defaults, off) x {TEL_AB_ROUNDS}",
        "off": rates["off"], "defaults": rates["defaults"],
        "gap_defaults_vs_off": statistics.mean(rates["defaults"]) / statistics.mean(rates["off"])
        - 1, "spread_off": spread(rates["off"]), "spread_defaults": spread(rates["defaults"]),
        "decode_tick_median_s": ticks,
        "tick_gap_defaults_vs_off": statistics.median(ticks["defaults"])
        / statistics.median(ticks["off"]) - 1,
        "end_tick_median_ms": [1e3 * statistics.median(x) for x in end_tick],
        "end_tick_share_of_decode_tick": statistics.median(x for e in end_tick for x in e)
        / statistics.median(ticks["defaults"])}
    log(f"  qwen3-1.7b tok/s, telemetry off vs defaults in turns: {json.dumps(out['tok_per_s'])}"
        f" | {out['device']}")

    eng = engine(_full_telemetry(root, "qwen3"))
    calls = _count_step_calls(eng)
    tokens, wall, counts, samples, _ = _telemetry_run(torch, ops, eng, prompts, MAX_NEW,
                                                      health=TEL_HEALTH_CHECKS)
    if tokens != off_tokens or counts != off_counts or not _same_pool(torch, eng, off_eng):
        raise AssertionError(f"telemetry fully on changed the tokens, the pool or the launches "
                             f"({counts} vs {off_counts})")
    snap = eng.telemetry.finalize()
    c = snap["counters"]
    if (c["prefill_calls"], c["decode_calls"]) != (calls["prefill_all"], calls["decode_all"]):
        raise AssertionError(f"prefill/decode calls {c['prefill_calls']}/{c['decode_calls']} != "
                             f"step calls {calls}")
    if len(samples) < TEL_HEALTH_CHECKS:
        raise AssertionError(f"only {len(samples)} pool-health samples checked")
    n_lines = validate_metrics_file(eng.telemetry.cfg.metrics_path)
    trace = validate_trace_file(eng.telemetry.cfg.profile_trace_path)
    util = eng.telemetry.profiler.utilization_summary()
    out["qwen3"] = {
        "fully_on_tok_per_s": toks / wall, "step_calls": calls, "launches": counts,
        "metrics_lines": n_lines, "trace_events": len(trace["traceEvents"]),
        "health_checked": _health_summary(samples),
        "compile_counts": eng.compile_counts(),
        "costs": eng.telemetry.profiler.phase_costs(), "utilization": util,
        "tick_p50_s": {k: snap["histograms"][f"{k}_tick_s"].get("p50")
                       for k in ("prefill", "decode")}}
    log(f"  qwen3-1.7b utilization (profiled ticks): {json.dumps(util)} | {out['device']}")
    log(eng.telemetry.summary())
    del eng, off_eng, runs, params
    torch.cuda.empty_cache()

    # the state pool: whisper-tiny (self- and cross-KV planes) and
    # falcon-mamba-7b (state rings), off against fully on
    for tag, arch, layers in (("whisper", WHISPER_ARCH, None),
                              ("falcon_mamba", SSM_ARCH, TEL_SSM_LAYERS)):
        scfg = kernel_config(get_config(arch))
        if layers is not None:
            scfg = dataclasses.replace(scfg, num_layers=layers)
        sparams = init_params(scfg, torch.Generator(device=device).manual_seed(SEED), device)
        smodel = build_model(scfg)
        srng = np.random.default_rng(SEED)
        if arch == WHISPER_ARCH:
            sprompts = [srng.integers(0, scfg.vocab_size, n).astype(np.int32)
                        for n in CROSS_PROMPTS]
            extras = [make_extra(scfg, SEED + i, device) for i in range(len(sprompts))]
            chunk, new = CROSS_CHUNK, CROSS_NEW
        else:
            sprompts = [srng.integers(0, scfg.vocab_size,
                                      int(srng.integers(SSM_MIN_PROMPT, SSM_MAX_PROMPT + 1)))
                        .astype(np.int32) for _ in range(TEL_SSM_REQUESTS)]
            extras, chunk, new = None, SSM_CHUNK, TEL_SSM_NEW
        max_len = -(-(max(p.size for p in sprompts) + new) // PAGE_SIZE) * PAGE_SIZE

        def sengine(tel=None):
            return Engine(smodel, sparams, EngineConfig(
                n_slots=N_SLOTS, max_len=max_len, page_size=PAGE_SIZE, kv_dtype="mxfp4",
                prefill_chunk=chunk, telemetry=tel))

        a = sengine()
        _telemetry_off(a)
        a_tokens, a_wall, a_counts, _, _ = _telemetry_run(torch, ops, a, sprompts, new, extras)
        b = sengine(_full_telemetry(root, tag))
        b_tokens, b_wall, b_counts, samples, _ = _telemetry_run(
            torch, ops, b, sprompts, new, extras, health=TEL_HEALTH_CHECKS)
        if b_tokens != a_tokens or b_counts != a_counts or not _same_pool(torch, a, b):
            raise AssertionError(f"{arch}: telemetry fully on changed the tokens, the pool or "
                                 f"the launches ({b_counts} vs {a_counts})")
        want = {"kv", "cross"} if arch == WHISPER_ARCH else {"state"}
        if not samples or any(set(h) != want for h in samples):
            raise AssertionError(f"{arch}: health samples {[sorted(h) for h in samples]} "
                                 f"!= {sorted(want)}")
        snap = b.telemetry.finalize()
        validate_metrics_file(b.telemetry.cfg.metrics_path)
        validate_trace_file(b.telemetry.cfg.profile_trace_path)
        out[tag] = {"arch": arch, "layers": scfg.num_layers, "requests": len(sprompts),
                    "tok_per_s_off": len(sprompts) * new / a_wall,
                    "tok_per_s_fully_on": len(sprompts) * new / b_wall,
                    "launches": b_counts, "health_checked": _health_summary(samples),
                    "gauges": {k: v for k, v in snap["gauges"].items()
                               if k.startswith(("kv_", "cross_", "state_")) and v},
                    "utilization": b.telemetry.profiler.utilization_summary()}
        log(f"  {arch}: on = off in tokens, pool and launches; health card = host "
            f"({len(samples)} samples) | {json.dumps(out[tag]['gauges'])}")
        del a, b, sparams
        torch.cuda.empty_cache()
    return out, counts


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases",
                    default="kernels,engine,features,moe,train,moe-train,variants,baselines,"
                            "dense-configs,ssm,hybrid,cross,state-train,telemetry,times",
                    help="comma-separated subset of kernels,engine,features,moe,train,"
                         "moe-train,variants,baselines,dense-configs,ssm,hybrid,cross,"
                         "state-train,telemetry,times")
    args = ap.parse_args()
    phases = set(args.phases.split(","))
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke.py: src/repro_torch not found beside this script; run it "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; this script runs only on the GPU",
              file=sys.stderr)
        return 1
    # plain f32 products in full f32 (no TF32), for the plain versions and
    # every reference product below
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels import ops

    smi = nvidia_smi_line()
    log(f"device: {smi} | torch {torch.__version__} cuda {torch.version.cuda} | "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    reports = _build.build_all()
    log(f"[build] {len(_build.SOURCES)} kernels in {time.perf_counter() - t0:.1f} s (sm_90a)")
    for name, rep in reports.items():
        for line in rep.splitlines():  # -Xptxas -v: each entry, its registers and spills
            if "entry function" in line or "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    # B4b's body (a CTA per page, 16-byte stores): no stack, no spills
    deq = entry_resources(reports.get("kv_pack", ""), "kv_dequant")
    log(f"[build] kv_dequant bodies (registers, stack and spill bytes): "
        f"{json.dumps(deq) if deq else 'not built in this run'}")
    if "kernels" in phases and any(r.get("stack", 0) or r.get("spill_stores", 0)
                                   or r.get("spill_loads", 0) for r in deq.values()):
        raise AssertionError(f"kv_dequant bodies use a stack or spill: {deq}")
    # B4a's head-wide body (a thread per row of 112 in registers): no spills
    rows = entry_resources(reports.get("kv_pack", ""), "kv_quant_row")
    log(f"[build] kv_quant_row bodies (registers, stack and spill bytes): "
        f"{json.dumps(rows) if rows else 'not built in this run'}")
    if "hybrid" in phases and any(r.get("spill_stores", 0) or r.get("spill_loads", 0)
                                  for r in rows.values()):
        raise AssertionError(f"kv_quant_row bodies spill: {rows}")
    # B2's vector bodies hold one 32-group a thread in straight-line code:
    # their static SASS count over 32 reads the instructions an element
    sass = sass_counts(str(_build.library_path("sr_hadamard_quant")), "sr_hadamard_")
    log(f"[build] sr_hadamard_quant SASS instructions by entry (per element = n / 32): "
        f"{json.dumps(sass) if sass else 'not measured (no cuobjdump)'}")

    cfg = get_config("qwen3-1.7b")
    tcfg = get_config(TRAIN_ARCH)
    err, counts, rec, vectors = {}, {}, {}, {}
    if "kernels" in phases:
        t0 = time.perf_counter()
        err = check_kernels(torch, cfg)
        err.update(check_kv_and_flash(torch, cfg, tcfg))
        for name, e in check_training_kernels(torch, tcfg).items():
            err[name] = max(err.get(name, 0.0), e)
        log(f"[kernels] all kernels agree with their plain versions "
            f"(max |Δ| {err}) in {time.perf_counter() - t0:.1f} s")
    if "engine" in phases:
        t0 = time.perf_counter()
        summary, counts["engine"], gsummary, counts["gather"] = serve_full_width(torch, ops)
        vectors["engine"] = summary["vector_launches"]
        vectors["gather"] = gsummary["vector_launches"]
        log(f"[engine] launches on the main path (paged backend): {counts['engine']}")
        log(f"[engine] launches on the gather backend: {counts['gather']}")
        missing = [k for k in ("hadamard_quest_quantize", "mxfp4_matmul", "paged_attention",
                               "kv_quant_pack") if counts["engine"][k] == 0]
        missing += [f"{k} (gather)" for k in ("kv_quant_pack", "kv_dequant_unpack")
                    if counts["gather"][k] == 0]
        if missing:
            raise AssertionError(f"kernels never launched on the serving paths: {missing}")
        log(f"[engine] {json.dumps(summary)}")
        log(f"[engine] gather {json.dumps(gsummary)}")
        check_reduced_engine(torch)
        log(f"[engine] done in {time.perf_counter() - t0:.1f} s")
    if "features" in phases:
        t0 = time.perf_counter()
        summary, fcounts, fvectors = serve_features(torch, ops)
        counts.update(fcounts)
        vectors.update(fvectors)
        for path, c in fcounts.items():
            log(f"[features] launches on the {path} path: {c}")
            missing = [k for k in ("hadamard_quest_quantize", "mxfp4_matmul", "paged_attention",
                                   "kv_quant_pack") if c[k] == 0]
            if missing:
                raise AssertionError(f"kernels never launched on the {path} path: {missing}")
        log(f"[features] {json.dumps(summary)}")
        log(f"[features] done in {time.perf_counter() - t0:.1f} s")
    if "moe" in phases:
        t0 = time.perf_counter()
        merr = check_moe_kernels(torch, moe_config())
        for name, e in merr.items():
            err[name] = max(err.get(name, 0.0), e)
        log(f"[moe] expert-axis B1 and B3 equal their plain versions and E 2-d launches bit "
            f"for bit; B5 at group 16 (R = 16, 80, 1024) max |Δ| {merr['paged_attention']} "
            f"({time.perf_counter() - t0:.1f} s)")
        summary, mcounts, mvectors = serve_moe(torch, ops)
        counts.update(mcounts)
        vectors.update(mvectors)
        for path, c in mcounts.items():
            log(f"[moe] launches on the {path} path: {c}")
        summary["reduced_oracle"] = check_reduced_moe(torch)
        log(f"[moe] {json.dumps(summary)}")
        log(f"[moe] done in {time.perf_counter() - t0:.1f} s")
    if "train" in phases:
        t0 = time.perf_counter()
        train_reduced_card_vs_cpu(torch)
        resume = train_resume_check(torch)
        summary, counts["train"], counts["eval"] = train_full_width(torch, ops)
        summary["resume"] = resume
        vectors["train"] = summary["vector_launches"]
        vectors["eval"] = summary["eval"]["vector_launches_flash"]
        log(f"[train] launches on the training path: {counts['train']} "
            f"(predicted {summary['predicted_launches']})")
        log(f"[train] launches on the flash evaluation path: {counts['eval']}")
        missing = [k for k in ("hadamard_quest_quantize", "sr_hadamard_quantize",
                               "mxfp4_matmul") if counts["train"][k] == 0]
        if missing or counts["eval"]["flash_attention"] == 0:
            raise AssertionError(f"kernels never launched on the training path: {missing} "
                                 f"or flash_attention on the evaluation path")
        if counts["train"]["flash_attention"]:
            raise AssertionError("flash_attention launched during training")
        log(f"[train] {json.dumps(summary)}")
        log(f"[train] done in {time.perf_counter() - t0:.1f} s")
    expert_b2 = expert_rec = None
    if "moe-train" in phases:
        t0 = time.perf_counter()
        mcfg = moe_train_config()
        for name, e in check_moe_train_kernels(torch, mcfg).items():
            err[name] = max(err.get(name, 0.0), e)
        log(f"[moe-train] B2's expert axis equals its plain version and E 2-d launches bit for "
            f"bit; the expert-linear backward on the kernels matches the plain versions "
            f"({time.perf_counter() - t0:.1f} s)")
        reduced = train_moe_reduced_card_vs_cpu(torch)
        summary, counts["moe_train"], vectors["moe_train"] = train_moe_full_width(torch, ops)
        summary["reduced_card_vs_cpu"] = reduced
        expert_b2 = summary["b2_expert_axis_launches"]
        log(f"[moe-train] launches on the MoE training path: {counts['moe_train']} (predicted "
            f"{summary['predicted_launches']}); B2 expert-axis launches {expert_b2}")
        summary["times"] = time_moe_train_kernels(torch, mcfg, Timer(torch))
        expert_rec = summary["times"][("sr_hadamard_quantize_experts", "moe train")]
        log(f"[moe-train] {json.dumps({k: v for k, v in summary.items() if k != 'times'})}")
        log(f"[moe-train] done in {time.perf_counter() - t0:.1f} s")
    if "variants" in phases:
        t0 = time.perf_counter()
        summary = {"quantizers": check_quantizers_card_vs_cpu(torch, tcfg)}
        log(f"[variants] every format x quantizer equals the CPU bit for bit "
            f"({time.perf_counter() - t0:.1f} s): {json.dumps(summary['quantizers'])}")
        summary["table2"] = table2_on_card(torch)
        summary["training"] = train_variants(torch)
        summary["nvfp4_linear"] = check_nvfp4_linear(torch, tcfg)
        summary["kernel_raise"] = check_kernel_raise(torch)
        log(f"[variants] {json.dumps({k: v for k, v in summary.items() if k != 'quantizers'})}")
        log(f"[variants] done in {time.perf_counter() - t0:.1f} s")
    if "baselines" in phases:
        t0 = time.perf_counter()
        log(f"[baselines] f32 products in full f32: allow_tf32 = "
            f"{torch.backends.cuda.matmul.allow_tf32}")
        summary = {"rmsnorm_card_vs_cpu_bits_differ": check_rmsnorm_card_vs_cpu(torch)}
        log(f"[baselines] rmsnorm equals the CPU bit for bit: "
            f"{json.dumps(summary['rmsnorm_card_vs_cpu_bits_differ'])}")
        summary["rope_card_vs_cpu_bits_differ"] = check_rope_card_vs_cpu(torch)
        log(f"[baselines] rope's cos/sin equal the CPU's bit for bit: "
            f"{json.dumps(summary['rope_card_vs_cpu_bits_differ'])}")
        summary["linear"] = check_baselines_card_vs_cpu(torch, tcfg)
        log(f"[baselines] every method's quantized operands equal the CPU's bit for bit; y, "
            f"dx, dW within tolerance ({time.perf_counter() - t0:.1f} s)")
        summary["training"] = train_baselines(torch)
        summary["compression"], counts["grad_compress"], vectors["grad_compress"] = \
            train_grad_compress(torch, ops)
        log(f"[baselines] launches on the grad-compress training path: "
            f"{counts['grad_compress']} (predicted "
            f"{summary['compression']['grad_compress']['predicted_launches']})")
        summary["compression"]["resume"] = train_resume_check(torch, grad_compress=True)
        log(f"[baselines] {json.dumps({k: v for k, v in summary.items() if k != 'linear'})}")
        log(f"[baselines] done in {time.perf_counter() - t0:.1f} s")
    if "dense-configs" in phases:
        t0 = time.perf_counter()
        summary, counts["starcoder2"], gsummary, counts["starcoder2_gather"] = \
            serve_full_width(torch, ops, arch=DENSE_ARCH, tf_gate=True)
        vectors["starcoder2"] = summary["vector_launches"]
        vectors["starcoder2_gather"] = gsummary["vector_launches"]
        log(f"[dense-configs] {DENSE_ARCH} launches on the paged backend: "
            f"{counts['starcoder2']}; gather: {counts['starcoder2_gather']}")
        log(f"[dense-configs] {json.dumps(summary)}")
        log(f"[dense-configs] gather {json.dumps(gsummary)}")
        summary = {}
        summary["training"], counts["starcoder2_train"], vectors["starcoder2_train"] = \
            train_dense_config(torch, ops)
        log(f"[dense-configs] launches on the {DENSE_ARCH} training path: "
            f"{counts['starcoder2_train']} (predicted "
            f"{summary['training']['predicted_launches']})")
        summary["train_c4"] = train_c4_resume_on_card(torch)
        log(f"[dense-configs] {json.dumps(summary)}")
        log(f"[dense-configs] done in {time.perf_counter() - t0:.1f} s")
    if "ssm" in phases:
        t0 = time.perf_counter()
        scfg = get_config(SSM_ARCH)
        ring = check_ring_kernels(torch, scfg)
        log(f"[ssm] B4a and B4b on the state rings' views equal their plain versions bit for "
            f"bit: {json.dumps(ring)} ({time.perf_counter() - t0:.1f} s)")
        summary, counts["ssm"], vectors["ssm"] = serve_ssm(torch, ops)
        log(f"[ssm] launches on the {SSM_ARCH} statepool path: {counts['ssm']} (predicted "
            f"{summary['predicted_launches']})")
        missing = [k for k in ("hadamard_quest_quantize", "mxfp4_matmul", "kv_quant_pack",
                               "kv_dequant_unpack") if counts["ssm"][k] == 0]
        if missing:
            raise AssertionError(f"kernels never launched on the ssm path: {missing}")
        log(f"[ssm] {json.dumps(summary)}")
        log(f"[ssm] done in {time.perf_counter() - t0:.1f} s")
    if "hybrid" in phases:
        t0 = time.perf_counter()
        hcfg = get_config(HYBRID_ARCH)
        hw = check_head_wide_kernels(torch, hcfg)
        log(f"[hybrid] B4a and B4b with the head-wide block (hd {hcfg.head_dim_}) equal their "
            f"plain versions bit for bit: {json.dumps(hw)}")
        ring = check_ring_kernels(torch, hcfg)
        log(f"[hybrid] B4a and B4b on the rings' views equal their plain versions bit for "
            f"bit: {json.dumps(ring)} ({time.perf_counter() - t0:.1f} s)")
        cvc = check_hybrid_card_vs_cpu(torch, hcfg)
        log(f"[hybrid] card vs CPU: {json.dumps(cvc)} ({time.perf_counter() - t0:.1f} s)")
        summary, counts["hybrid"], vectors["hybrid"] = serve_hybrid(torch, ops)
        log(f"[hybrid] launches on the {HYBRID_ARCH} statepool path: {counts['hybrid']} "
            f"(predicted {summary['predicted_launches']})")
        missing = [k for k in ("hadamard_quest_quantize", "mxfp4_matmul", "kv_quant_pack",
                               "kv_dequant_unpack") if counts["hybrid"][k] == 0]
        if missing:
            raise AssertionError(f"kernels never launched on the hybrid path: {missing}")
        log(f"[hybrid] {json.dumps(summary)}")
        if "times" in phases:
            for (name, tag), r in time_state_kernels(torch, Timer(torch)).items():
                log(f"[hybrid] {name} {tag}: {json.dumps(r)}")
        log(f"[hybrid] done in {time.perf_counter() - t0:.1f} s")
    if "cross" in phases:
        t0 = time.perf_counter()
        ck = check_cross_kernels(torch)
        log(f"[cross] B4a and B4b at hd 64 and the cross planes' source scatter and sliced "
            f"gather equal their plain versions bit for bit: {json.dumps(ck)} "
            f"({time.perf_counter() - t0:.1f} s)")
        log(f"[cross] B1 and B3 at whisper-tiny's linears ([M, K, N]) equal their plain "
            f"versions bit for bit: {json.dumps(check_narrow_linears(torch))}")
        log(f"[cross] layernorm equals the CPU bit for bit: "
            f"{json.dumps(check_layernorm_card_vs_cpu(torch))}")
        for path, arch in (("whisper", WHISPER_ARCH), ("vlm", VLM_ARCH)):
            summary, counts[path], vectors[path] = serve_cross(torch, ops, arch)
            log(f"[cross] launches on the {arch} statepool path: {counts[path]} (predicted "
                f"{summary['predicted_launches']})")
            missing = [k for k in ("hadamard_quest_quantize", "mxfp4_matmul", "kv_quant_pack",
                                   "kv_dequant_unpack") if counts[path][k] == 0]
            if missing:
                raise AssertionError(f"kernels never launched on the {arch} path: {missing}")
            log(f"[cross] {json.dumps(summary)}")
            log(f"[cross] {arch} done ({time.perf_counter() - t0:.1f} s)")
        if "times" in phases:
            for (name, tag), r in time_cross_kernels(torch, Timer(torch)).items():
                log(f"[cross] {name} {tag}: {json.dumps(r)}")
        log(f"[cross] done in {time.perf_counter() - t0:.1f} s")
    if "state-train" in phases:
        t0 = time.perf_counter()
        serr = check_state_train_kernels(torch)
        for name, e in serr.items():
            err[name] = max(err.get(name, 0.0), e)
        log(f"[state-train] B2 and B3 at falcon-mamba-7b's and zamba2-7b's in_proj backward "
            f"operands equal their plain versions bit for bit; the whole backward on the "
            f"kernels against the plain versions: {json.dumps(serr)} "
            f"({time.perf_counter() - t0:.1f} s)")
        _, bad = train_state_reduced_card_vs_cpu(torch)
        for arch, path in STATE_TRAIN_PATH.items():
            summary, counts[path], vectors[path] = train_state_full_width(torch, ops, arch)
            log(f"[state-train] launches on the {arch} training path: {counts[path]} "
                f"(predicted {summary['predicted_launches']})")
            log(f"[state-train] {json.dumps(summary)}")
            log(f"[state-train] {arch} done ({time.perf_counter() - t0:.1f} s)")
        if "times" in phases:
            # B1, B2 and B3 over one falcon-mamba-7b in_proj's training
            # launches (K 4096, N 16384) at 4 x 512 tokens
            for (name, tag), r in time_training_kernels(
                    torch, None, Timer(torch), K=4096, N=16384, T=4 * TRAIN_SEQ,
                    tag="falcon-mamba-7b in_proj").items():
                log(f"[state-train] {name} {tag}: {json.dumps(r)}")
        if bad:
            raise AssertionError(f"reduced training card vs CPU out of tolerance: {bad}")
        log(f"[state-train] done in {time.perf_counter() - t0:.1f} s")
    if "telemetry" in phases:
        t0 = time.perf_counter()
        summary, tcounts = serve_telemetry(torch, ops)
        missing = [k for k in ("hadamard_quest_quantize", "mxfp4_matmul", "paged_attention",
                               "kv_quant_pack") if tcounts[k] == 0]
        if missing:
            raise AssertionError(f"kernels never launched on the telemetry path: {missing}")
        log(f"[telemetry] {json.dumps(summary)}")
        log(f"[telemetry] done in {time.perf_counter() - t0:.1f} s")
    if vectors:
        # every B1 call on the main paths, and every B2 call on the training
        # paths, reads and writes through the vector body (a thread per group,
        # 16-byte loads and stores)
        for tag, name, paths in (("b1", "hadamard_quest_quantize", list(vectors)),
                                 ("b2", "sr_hadamard_quantize",
                                  [p for p in ("train", "moe_train", "grad_compress",
                                               "starcoder2_train", *STATE_TRAIN_PATH.values())
                                   if p in vectors])):
            vs = {p: (vectors[p][name], counts[p][name]) for p in paths}
            log(f"[{tag}] vector-body launches / all launches, by path: {json.dumps(vs)}")
            if any(v != n or n == 0 for v, n in vs.values()):
                raise AssertionError(f"{name} took its tile body on a main path: {vs}")
    if "times" in phases:
        t0 = time.perf_counter()
        timer = Timer(torch)
        rec = time_kernels(torch, cfg, timer)
        rec.update(time_training_kernels(torch, tcfg, timer))
        rec.update(time_kv_and_flash(torch, cfg, tcfg, timer))
        where = {"train": "one full-width linear", "gather": "one decode tick, all layers"}
        for (name, tag), r in rec.items():
            log(f"[times] {name} {tag} ({where.get(tag, 'one layer')}): {json.dumps(r)}")
        log(f"[times] done in {time.perf_counter() - t0:.1f} s")

    if phases >= {"kernels", "engine", "train", "times"}:
        # B5 and B4a at a decode tick, B4b at a decode tick's gather, B6 at
        # the evaluation shape, the training kernels at a training
        # microbatch; launches on each kernel's own path
        kernels = []
        for name, (src, replaces) in SOURCES.items():
            path, tag = PATH_OF[name]
            r = rec[(name, tag)]
            kernels.append({"name": name, "route": "cuda", "source": src,
                            "replaces": replaces, "launches": counts[path][name],
                            "max_abs_err": err[name], "ms": r["ms"],
                            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                            "launches_by_path": {p: c[name] for p, c in counts.items()}})
            if name in ("hadamard_quest_quantize", "sr_hadamard_quantize"):
                kernels[-1]["vector_launches_by_path"] = {p: v[name] for p, v in vectors.items()}
        if expert_b2 is not None:
            # B2's expert axis, new in this slice: launches on the MoE training
            # path, times at one full-width expert linear's backward operands
            r = expert_rec
            kernels.append({"name": "sr_hadamard_quantize_experts", "route": "cuda",
                            "source": SOURCES["sr_hadamard_quantize"][0],
                            "replaces": SOURCES["sr_hadamard_quantize"][1],
                            "launches": expert_b2,
                            "max_abs_err": err["sr_hadamard_quantize_experts"],
                            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                            "launches_by_path": {"moe_train": expert_b2}})
        log(json.dumps({"kernels": kernels}))
    log(nvidia_smi_line())
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
