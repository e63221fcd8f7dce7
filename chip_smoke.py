#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card and check it.

    python3 chip_smoke.py            # needs one card; builds the kernels

1. Card: name, count, ``nvidia-smi`` name and power limit; build every
   CUDA kernel from ``src/repro_torch/kernels/csrc`` (one nvcc per source,
   all four in parallel) and print the build seconds and ptxas reports.
2. Kernels: at the three linear shapes of qwen1.5-0.5b (1024x1024 q/k/v/o,
   1024x2816 wi/wg, 2816x1024 wo), on ``sme_compress`` output of seeded
   Gaussian weights, each kernel is held against its plain PyTorch version
   on the card and against the f64 oracle ``sme_matmul_ref_np`` (relative
   error <= 5e-5): v3's decode kernel at M = 8 and 64 (the smallest and
   largest decode bucket) and prefill kernel at M = 512, v1's ``sme_spmm``
   and v2's ``sme_spmm6`` (one entry point each for decode and prefill) at
   all three.  The decode kernel must equal the prefill kernel bitwise,
   ``plane_depth`` >= the deepest group must be a bitwise no-op and
   ``plane_depth = 2`` must match ``dequant_topk_planes(2)``; v1 and v2,
   after their power-of-two scaling, must equal the v3 prefill kernel
   bitwise, also on a pruned weight with empty tiles and an empty column
   tile (whose output must be exactly 0), where the decode kernel must
   also equal the prefill kernel and hold ``plane_depth`` 1, 2 and 8; v1
   must hold settings v2 cannot (squeeze 0, window 4) against the oracle.
   The launch geometry (blocks, cluster size, dynamic shared memory) of
   all four kernels is printed per shape and M.  Times from CUDA
   events with the L2 cache flushed before every launch: the kernel's
   launch alone (the unscaled product for v1, v2 and v3-prefill; the log
   line adds the time with the backend's scaling epilogue, two elementwise
   launches), beside the plain version's, ``torch.matmul`` on the
   dequantized weight and the bound.
   Before them the card tests (``pytest -m gpu tests/test_torch_cuda.py``,
   in a child process on the same build) must all pass.  From the start
   a pool of :data:`PACK_WORKERS` host processes at the lowest CPU
   priority draws and packs the weights of phases 6-8 (gemma3-12b, then
   mixtral-8x7b, deepseek-v2-lite-16b and llava-next-34b, then
   xlstm-1.3b and jamba-v0.1-52b, then whisper-medium), beside
   the card tests and phases 2-5b, in units of at most
   :data:`UNIT_WEIGHTS` weights, and is paused for every block of timed
   launches, profiled window, serving and engine run without a signal
   (its workers begin no unit while a shared flag is clear, and the pause
   waits for the units in flight); each later phase waits for its
   model.  Once a pooled model's packed tree is uploaded, every packed
   operand is copied back from the card and compared byte for byte with
   the host array it came from, on a line that names the host's CPU and
   numpy's SIMD dispatch (F4, ROADMAP §3); where v2's and v3's f32 logits
   part, the weights whose formats disagree on the card are also
   dequantized by both formats on the host.
3. Serving: qwen1.5-0.5b at full width, its depth cut to 4 of 24 layers
   (:data:`QWEN_LAYERS`; random weights from a numpy seed, every
   attention/MLP weight packed once to v1, v2 and v3)
   serves the same 8 requests three times through ``ServeEngine(slots=4,
   s_max=256)`` with every prompt prefilled in one piece (``chunk_len =
   s_max``, no speculation, no prefix cache: comparable with the one-shot
   engine of earlier revisions): with ``backend="auto"`` (which must
   resolve to v2, as the reference's auto does), ``"v1"`` and ``"v3"``.
   Each run's launch counters, set to 0 just before it, must cover every
   linear of every prefill and decode step with its own kernels and no
   other; the three runs' tokens must be identical; one prefill window's logits through
   v1, v2 and v3 must be bitwise equal (f32 and bf16) and within
   tolerance of the same model run through the plain versions.  A
   torch.profiler window profiles each backend's path (v2, v1, v3).
4. Engine: the same packed model through the continuous engine (4
   slots, s_max 256, ``chunk_len`` 32, ``page_tokens`` 16, prefix cache
   on, ``spec_len`` 4, a draft depth chosen from the weights' plane
   occupancy below the deepest tile group): 8 requests of 16 new tokens
   (3 prompts of 40-120 tokens, 2 pairs sharing a 64-token prefix, 1 at
   temperature 0.8) driven through ``submit``/``pump``/``step``/``poll``,
   four times: v3 with spec, chunking and the prefix cache; spec off;
   prefix cache off; ``auto`` (v2).  Each run must complete every
   request, stream token events equal to ``out_tokens``, launch only its
   backend's kernels, 28 per model pass (7 per layer), and add up its
   spec counters; v3's draft passes must launch the decode kernel (28 per
   draft step);
   the greedy tokens of the four runs must be identical.  Prints ms per
   engine step by kind (chunked, spec, decode), draft and verify ms per
   round, acceptance, tokens/s, TTFT per request, prefix hits and
   snapshots, and the decode kernel's ms per layer at the draft depth.
5. Compile: the offline compiler on the same full-width weights, dense,
   in the reference's layout (4 layers stacked per leaf): ``plan_model``
   at budget 0.06 and ``compile_model`` into a ``.smez`` in a temporary
   directory under ``auto`` (the plan's per-leaf settings, backends,
   crossbar reduction, seconds and megabytes are printed), booted by
   ``ServeEngine.from_artifact`` (its seconds beside the serving phase's
   inline packing) and serving the serving phase's 8 requests: only the
   plan's kernels, 28 launches per pass; one prefill window's logits
   within tolerance of the ``torch`` backend (f32) and of the plain
   versions (bf16); where every leaf is planned (8, 3, 1) the tokens must
   equal the serving phase's auto run bitwise.  Then the same under
   ``v3`` and the engine workload twice, with ``spec_depth="auto"`` and
   without: every draft pass launches the decode kernel 28 times, every
   draft dispatch resolves its layer's plan depth (never full
   precision), and the greedy tokens of the two runs are identical.
   Last, malformed operand lists (``rowid`` past the row tiles, ``nnz``
   past the list) must raise ``ValueError`` on the host, and a launch on
   good operands must still succeed.
5a. Training (``train_phase``, while the pool packs; paused only for the
   timed window and the serving runs): ``launch/train.py``'s main path
   in-process on qwen1.5-0.5b at full width, :data:`QWEN_LAYERS` deep,
   10 steps of 8 x 256 ``lm_batches`` tokens (AdamW, cosine, async
   checkpoints in a temporary directory), the latest checkpoint restored
   bitwise equal to the live params and AdamW state, one step more at
   ``--micro 2`` resumed from it; ms per step over a paused window of 5
   steps, training tokens/s, peak GiB; an overfit of one 4 x 256 batch
   for 30 steps (every loss finite, the last below half the first); the
   params saved alone (``checkpoint.save``), compiled by ``compile
   --ckpt`` under ``auto`` and ``v3`` (analytic plan, budget 0.0665: every
   leaf (8, 3, 1)), booted by ``from_artifact`` and serving 4 prompts (the
   first 64 tokens of each overfit row) for 32 greedy tokens through v2
   and v3: only the backend's kernels, 28 launches per pass, identical
   tokens, one prefill window's f32 logits v2 == v3 bitwise and within
   1e-3 of the plain versions; the distinct tokens served and how many
   equal the batch's continuation are printed, not gated.
5a'. Mesh serving (``mesh_phase``, inside the train phase, on its
   trained artifacts): the four wrappers on two shards of 11 whole column
   tiles of qwen's 1024x2816 equal the whole launch bitwise at M = 8 and
   512; the 4 prompts served for 16 tokens from the v3 and the auto (v2)
   artifact on the 1x1 mesh through an NCCL process group of world size
   1 must give the first 16 of the train phase's tokens; then 4 spawned
   ranks share the
   card over ``gloo`` (which carries CUDA tensors through host memory
   itself: correctness, not speed) and serve the v3 artifact on meshes (2, 2)
   and (1, 4) and the auto artifact on (2, 2): every rank's tokens must
   equal 1x1's and rank 0's f32 prefill logits 1x1's bitwise.  Prints
   whether ``gloo`` takes CUDA tensors natively, each rank's param
   bytes against the 1x1 run's, ms per decode step (correctness only)
   and the phase's seconds (budget 90 s; the pool paused while the
   ranks serve).
5a''. Mesh training (``mesh_train_phase``, inside the train phase, after
   5a'): from the overfit's params and AdamW state (qwen1.5-0.5b at full
   width, :data:`QWEN_LAYERS` deep, f32 with TF32 off), 2 steps on fresh
   batches of 8 x 256 on the 1x1 mesh in this process (the yardstick),
   then on four gloo ranks sharing the card on meshes (2, 2), (1, 4)
   and (4, 1) under the throughput posture (FSDP over 'data', column- and
   row-parallel linears and a vocab-parallel loss over 'model', sharded
   AdamW and clipping).  Every rank's losses must be the same bits and
   within 1e-5 relative of 1x1's, the pre-clip norm within 1e-6, the
   params, ``m`` and ``v`` after the steps within 1e-5 of each tree's
   largest magnitude (each rank's shards against the same slices of
   1x1's), and ``ef_allreduce`` over (2, 2)'s 'data' groups on layer 0's
   gradient the reference's formula (int32 code sums and residuals
   bitwise, the result within 1 ulp).  Prints whether ``gloo``
   all-reduces CUDA tensors natively, each rank's params + ``m`` + ``v``
   bytes against 1x1's, ms per step per rank (correctness only) and the
   phase's seconds (budget 60 s; the pool paused while the ranks train).
   The (2, 2) run saves its params and AdamW state after step 1 through
   the mesh checkpoint (``checkpoint.save(mesh=)``: every rank gathers,
   rank 0 writes the logical arrays); the (4, 1) run restores them
   (``restore(mesh=)``, an elastic reshard) in place of its own step 1
   and takes step 2 under the same gates against 1x1's second step.
   No SME kernel runs here: training takes dense weights.
5a'''. Mesh training of the MoE family and MLA (``mesh_train_moe_phase``,
   inside the train phase, after 5a''): deepseek-v2-lite-16b at full
   width and phase 7's depth (``first0`` and one MoE layer: MLA, 64
   routed experts top-6 and 2 shared, untied head; 1.08 B f32 params
   from a numpy seed), dense, f32 with TF32 off.  Its initial params are
   written once with ``checkpoint.save``; one step of 8 x 256 on the 1x1
   mesh in this process (the yardstick), its state then freed from the
   card; four gloo ranks sharing the card restore the checkpoint onto
   (2, 2) and (1, 4) (``restore(mesh=)``) and take the same step under
   the throughput posture (expert-parallel routed experts, the shared
   experts, MLA and ``first0`` column- and row-parallel, FSDP over
   'data', the vocab-parallel loss), with the gates of 5a''; the routes
   rank 0 took that differ from 1x1's are counted (a reading: a float
   reassociation may flip a near tie).  Prints params + m + v per rank
   against 1x1, ms per step per rank (the first step, with its
   warm-up; correctness only) and the phase's seconds (budget 120 s;
   the pool paused while the ranks train).  No SME kernel runs here.
5b. The paper's CNNs (``cnn_phase``; the reference's CNN task,
   ``benchmarks/_cnn_task.py``: ResNet widths (32, 64, 128, 128),
   MobileNet (32, 64, 96, 128), 12x12 images, 512 to train at seed 0, 384
   to test at seed 99, 60 AdamW steps): both nets trained on the card
   (the pool paused for each training, whose seconds are a reading),
   their float test accuracy and with every conv matrix SME-dequantized
   (8, 3, 1), the crossbar counts (conventional, SME, squeezed 1) of
   their conv matrices; every matrix the reference's converter would
   pack (K and N >= 128: ResNet's stage-2 and stage-3 convs, K = 576 and
   1,152, ``s3b0/proj``, MobileNet's ``ir3/pw2``) packed to v1, v2 and v3
   and run on its real im2col activations through ``sme_apply`` at the
   whole test set (the prefill walks) and one image (the decode walks):
   v1 == v2 == v3 bitwise, within 5e-5 of the f64 oracle, each kernel
   launched; then one kernel row per (K, N, M) as in phase 6.
6. gemma3-12b (``gemma_phase``): full width (d_model 3840, 16 heads of
   240, GQA kv 8, d_ff 15360, vocab 262144, W = 1024, GELU, untied head),
   depth cut from 48 layers to one superblock (5 local layers, 1 global;
   :data:`GEMMA_LAYERS`), every linear and the head packed once to v1, v2
   and v3 by the pool (the head in 16 column slabs that join bitwise into
   one compression, checked at a small size).  Kernel rows: each kernel at
   layer 0's q, k, wi, wo and the head (3840x3840, 3840x1920,
   3840x15360, 15360x3840, 3840x262144), at M = 8 and 64 (v3-decode, v1,
   v2) and 512 (v3-prefill, v1, v2), against its plain version (in blocks
   of 512 rows and 256 column tiles), the f64 oracle on the first 1024
   columns and the v3 prefill kernel bitwise, timed with ``torch.matmul``
   in f32 and bf16.  One-shot serving (4 slots, s_max 2048, ``chunk_len``
   2048) of 4 prompts of 1,100-1,500 tokens, 16 new tokens each, under
   ``auto`` (must resolve to v2) and ``v3``: only the backend's kernels,
   37 per pass (6 per layer and the head), equal tokens; one prefill
   window's f32 logits v2 == v3 bitwise and within tolerance of the
   ``torch`` backend and the plain versions; a profiled window.  Then the
   engine (v3, ``chunk_len`` 544, ``page_tokens`` 16, prefix cache on,
   ``spec_len`` 4) on the same prompts, two of them sharing a 1,088-token
   prefix (the second admitted once the first has scored it, so it hits a
   snapshot whose rings wrapped past W), with spec and without: prefix
   hits and side-slab snapshots counted, greedy tokens equal to each other
   and to the one-shot run's.
7. The MoE family and the vision frontend at full width (``moe_phase``,
   ``vision_phase``): mixtral-8x7b (one layer: 8 experts of 4096x14336
   top-2, W = 4096, 1.58 B packed weights), deepseek-v2-lite-16b (its dense
   ``first0`` and one MoE layer: MLA with a 512 cache and a packed
   ``kv_up``, 64 experts of 2048x1408 top-6 and 2 shared) and
   llava-next-34b (one layer, a packed ``patch_proj`` 7168x7168 for 576
   patch embeddings), each packed to v2 and v3 by the pool (experts stacked
   per layer, heads in column slabs; stacking checked against one
   conversion at a small size).  Kernel rows on the models' own operands at
   the expert shapes (4096x14336 and 14336x4096 at M = 4 and 512, 2048x1408
   at M = 8) and the ragged widths (2048x10944, 10944x2048, 2048x576 at M =
   8 and 512), as in phase 6.  mixtral and deepseek: one-shot serving (4
   slots, s_max 2048) of 4 prompts of 400-600 tokens under auto (v2) and
   v3: only the backend's kernels, 3 x E expert launches per MoE layer per
   pass (a decode pass skips each packed ``kv_up``, read as its dequantized
   matrix), equal tokens, routing drops printed; f32 prefill logits v2 ==
   v3 bitwise and within 5e-5 of the ``torch`` backend; a profiled window;
   the engine on v3 (``chunk_len`` 256, prompts of 272-320 tokens:
   :data:`ENGINE_PROMPTS`): mixtral with spec and without (equal tokens),
   deepseek with spec and the prefix cache, two prompts sharing 256
   tokens (a hit), MLA's ``c`` and ``k_pe`` classified paged
   and one dequantized ``kv_up`` per layer. llava: one-shot through the
   model API with seeded random patches under v2 and v3 (equal tokens,
   ``patch_proj`` launched at prefill only), f32 logits and a profiled
   window as above, and the engine with 2 requests admitted whole in one
   prefill whose ``plen`` counts the 576 frontend tokens (no chunked step,
   no prefix cache).  Each of deepseek's and llava's packed trees is
   then written once as a ``.smez`` (``compiler.artifact.save_artifact``;
   no new packing).
7'. Mesh serving of MLA and the vision frontend (``mesh_family_phase``)
   from those artifacts, at phase 7's widths and depth: 4 prompts of
   64-128 tokens, 16 new tokens each, on the 1x1 mesh through an NCCL
   group of world size 1 in this process (deepseek v2 one-shot, deepseek
   v3 with spec and a prefix hit, llava v2 one-shot; the prompts of the
   spec run cut to one 64-token chunk, the second request the first's
   chunk and one token, so it hits the first's snapshot); then 4 spawned
   ranks share the card over ``gloo`` and serve deepseek
   v2 on (2, 2) and (1, 4), deepseek v3 with spec and the prefix hit on
   (2, 2) and llava v2 on (2, 2) (:data:`SLICE_MESH_RUNS`).  Every
   rank's tokens must equal 1x1's, rank 0's f32 prefill logits 1x1's
   bitwise (llava's behind seeded patches), ``kv_up`` / ``patch_proj``
   must be split over 'model' and each run's kernels launched.  Prints
   params per rank against 1x1, ms per decode step (correctness only),
   the launches per kernel and the phase's seconds (budget 60 s, the pool
   paused while the ranks serve).
8. The recurrent family at full width (``recurrent_phase``):
   xlstm-1.3b (d_model 2048, 4 heads; mLSTM d_in 4096 in heads of 1024,
   sLSTM heads of 512 and an FFN of 2730; untied head 2048x50304) cut to
   one superblock (7 mLSTM, 1 sLSTM: 0.31 B packed weights) and
   jamba-v0.1-52b (d_model 4096, 32 heads, GQA kv 8, d_ff 14336, Mamba
   d_in 8192, state 16, conv 4, dt rank 256; untied head 4096x65536) cut
   to slots 0 (Mamba) and 4 (attention) of its superblock, both with dense
   MLPs (0.77 B), packed to v2 and v3 by the pool; the dense mixer leaves
   (mLSTM's q/k/v, sLSTM's r, Mamba's conv, A_log, D) from a numpy seed.
   Kernel rows on the models' own operands (mLSTM up 2048x8192 and down
   4096x2048, sLSTM ff_wi 2048x2730, Mamba in_proj 4096x16384, x_proj
   8192x288, dt_w 256x8192, out_proj 8192x4096) at M = 4 and 512, as in
   phase 6.  One-shot serving (4 slots, s_max 2048) of 4 prompts of
   400-600 tokens under auto (v2) and v3: only the backend's kernels, 19
   (xLSTM) and 15 (Jamba) per pass, equal tokens; f32 prefill logits v2
   == v3 bitwise and within 5e-5 of the ``torch`` backend; a profiled
   window; the ms of the Python time loops (sLSTM's, Mamba's) beside
   their layers' prefill.  The engine on v3 (``chunk_len`` 256,
   ``page_tokens`` 16, prefix cache, ``spec_len`` 4; prompts of 272-320
   tokens) with spec and without (equal tokens), two prompts sharing 256
   tokens (a hit that
   restores the recurrent side rows, and for Jamba the attention's
   pages); every recurrent leaf classified side, Jamba's K/V paged.
   Each packed tree is then written once as a ``.smez``.
8'. Mesh serving of the recurrent family (``mesh_family_phase``) from
   those artifacts, at phase 8's widths and depth, with phase 7's
   workloads: the 1x1 mesh through an NCCL group of world size 1 in this
   process, made before any rank starts (Jamba v2 one-shot, Jamba v3
   with spec and a prefix hit, xLSTM v2 one-shot; the ranks start
   meanwhile); then 4 spawned ranks share the card over ``gloo`` and serve Jamba v2 on (2, 2)
   and (1, 4), Jamba v3 with spec and the prefix hit on (2, 2) and xLSTM
   v2 on (2, 2) and (1, 4) (:data:`RECURRENT_MESH_RUNS`).  Every rank's
   tokens must equal 1x1's, rank 0's f32 prefill logits 1x1's bitwise,
   every layer's cache rank 0's shard shapes under the engine's rule with
   Mamba's ``conv``/``h`` and mLSTM's ``C`` split over 'model', and each
   run's kernels launched.  Prints params and caches per rank against
   1x1, ms per decode step (correctness only), the launches per kernel and
   the phase's seconds (budget 60 s; the pool packs on meanwhile).
9. The encoder-decoder family at full width (``encdec_phase``):
   whisper-medium (d_model 1024, 16 heads MHA, d_ff 4096, vocab 51865,
   LayerNorm, GELU, sinusoidal positions), depth cut from 24 + 24 to
   :data:`WHISPER_LAYERS` encoder and as many decoder layers, every
   linear and the head packed to v1, v2 and v3 by the pool (0.23 B
   weights at 6 + 6, 53 M of them in the head).  Kernel rows on
   the model's own operands (1024x1024, 1024x4096, 4096x1024 and the
   ragged head 1024x51865) at M = 4 and 512, as in phase 6; the head at
   M = 4 through ``decode_walk`` v2 == v3 bitwise and within 5e-5 of the
   f64 oracle over every column.  One-shot serving (4 slots, s_max 2048)
   of 4 prompts of 400-600 tokens behind the audio stub's zero frames,
   one prefill per request, under auto (v2) and v3: only the backend's
   kernels, 6 per encoder layer, 10 per decoder layer and the head per
   prefill pass, 8 per decoder layer and the head per decode pass, equal
   tokens; the prefill's ms split into encoder and decoder; f32 prefill
   logits v1 == v2 == v3 bitwise and within 1e-3 of the ``torch``
   backend and of the v2 and v3 plain versions; a profiled window (1
   prefill, 5 decode steps).  The engine on v3 with spec (depth from the
   decoder's plane occupancy) and without: every cache leaf paged, equal
   tokens, equal to the one-shot run's; and a request admitted into the
   slot a longer one used (its stale cross keys past the source) serves
   a fresh engine's tokens.  The packed tree is then written once as a
   ``.smez``.
9'. Mesh serving of the encoder-decoder family (``mesh_family_phase``)
   from that artifact, at phase 9's widths and depth, with phase 7's
   prompts (4 of 64-128 tokens, 8 new tokens each, s_max 1024, one
   request per admission window behind its zero frames): the 1x1 mesh
   through an NCCL group of world size 1 in this process, made before
   any rank starts (whisper v2 one-shot and v3 with spec; the ranks start
   meanwhile); then 4 spawned ranks share the card over ``gloo`` and
   serve whisper v2 on (2, 2) and (1, 4) and v3 with spec on (2, 2)
   (:data:`ENCDEC_MESH_RUNS`).  Every rank's tokens must equal 1x1's,
   rank 0's f32 prefill logits (4 x 64 tokens over seeded random frames)
   1x1's bitwise, every layer's self and cross K/V rank 0's shard shapes
   under the engine's rule with the cross K/V's heads split over
   'model', the head's 406 column tiles split over a 'model' axis of 2
   and whole over 4 (``place_tree`` splits whole tiles where the count
   divides), and each run's kernels launched.  Prints params and the
   self and cross caches per rank against 1x1, ms per decode step
   (correctness only), the launches per kernel and the phase's seconds
   (budget 60 s).
10. Prints the compile, train (5a' under ``mesh``, 5a'' under
   ``mesh_train``, 5a''' under ``mesh_train_moe``), cnn, gemma, slice
   (7' under ``mesh``),
   recurrent (8' under ``mesh``) and encdec (9' under ``mesh``) readings
   as JSON, the
   kernels JSON line (qwen times per model layer: 4 q/k/v/o + 2 wi/wg + 1 wo calls; decode
   M = 8 in the top-level keys, every M a kernel ran at under ``at_m``;
   v3-decode adds ``draft_depth``, the draft passes' ``draft_launches``
   and ``draft_ms`` / ``draft_full_ms`` per layer on the model's own
   operands; ``artifact_launches`` counts the compile phase's runs,
   ``train_launches`` the train phase's serving runs, ``mesh_launches``
   the mesh phases' (5a', 7', 8' and 9': the 1x1 NCCL runs and every
   rank's),
   ``cnn_launches``
   the CNN phase's conv matrices on their activations and ``cnn`` its
   kernel rows per shape and M,
   ``gemma_launches`` gemma's serving and engine runs, ``gemma`` its
   kernel rows per shape and M, per call; ``slice_launches`` and
   ``slice`` the same for phase 7, ``recurrent_launches`` and
   ``recurrent`` for phase 8, ``encdec_launches`` and ``encdec`` for
   phase 9; every number measured in this run but
   ``bound_ms``), the card line and, last, ``{"ok": true,
   "device": {...}}``.  Any failed check raises first; the pool's
   processes end either way.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import pathlib
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
SEED = 0
TOL_ORACLE = 5e-5          # DESIGN.md §5 relative bound
#: kernel vs plain version, relative to max |plain|: both sum in f32, in
#: different orders (sequential fmaf vs cuBLAS), over K <= 2816 terms
TOL_PLAIN = 5e-5
#: prefill logits through the kernels vs the plain versions, relative to
#: max |logit|.  f32: the per-linear difference above compounded through 24
#: layers, with 100x room.  bf16 (the served dtype): each linear's output is
#: rounded to bf16 (2^-8 relative), so an f32-level difference can flip one
#: rounding by one bf16 ulp; such flips compound over 24 layers, 10x room
TOL_LOGITS = {"float32": 1e-3, "bfloat16": 5e-2}
#: qwen1.5-0.5b linears per layer: (name, K, N, calls per layer)
SHAPES = (("qkvo", 1024, 1024, 4), ("wi_wg", 1024, 2816, 2),
          ("wo", 2816, 1024, 1))
#: bytes written to flush the 50 MB L2 before each timed launch: ~0.3 ms on
#: the device, longer than the host takes to issue a wrapper's launches
FLUSH_BYTES = 2 ** 30
#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and f32 non-tensor FLOP/s
PEAK_BYTES, PEAK_F32 = 3.35e12, 67e12
#: embedding std of the random serving model: small enough that the layers,
#: not just the tied head's echo of the last prompt token, set the tokens
EMBED_STD = 0.05
#: qwen1.5-0.5b's depth in the serving, engine and compile phases: 4 of its
#: 24 layers, so that the whole script, the gemma3-12b, MoE, vision and
#: recurrent phases included, stays inside its time limit (the kernel phase
#: runs every width)
QWEN_LAYERS = 4


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def ptxas_summary(reports) -> list:
    """One line per compiled kernel of nvcc's ``-Xptxas -v`` reports:
    library, demangled entry function, registers and spills."""
    import re
    import shutil
    filt = shutil.which("c++filt") or shutil.which("cu++filt")
    lines = []
    for lib, rep in reports.items():
        entry, spill = "?", ""
        for line in rep.splitlines():
            found = re.search(r"entry function '(\w+)'", line)
            if found:
                entry = found.group(1)
                if filt:
                    entry = subprocess.run(
                        [filt, entry], capture_output=True,
                        text=True).stdout.strip().split("(")[0]
            elif "spill" in line:
                spill = line.strip()
            elif "registers" in line:
                lines.append(f"{lib}: {entry}: {line.split(':', 1)[1].strip()}"
                             f"; {spill}")
    return lines


def free_card() -> None:
    """Between phases: collect what the last phase left (an engine refers
    to itself through the test hooks, so its model outlives the phase
    until a collection) and return the cached blocks."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def mismatch(a: torch.Tensor, b: torch.Tensor) -> str:
    """Where two tensors that must be bitwise equal part: how many
    elements, the largest finite difference, NaNs on each side and the
    first differing index (for a failure's message)."""
    ne = a != b
    d = (a.double() - b.double()).abs()
    d = d[torch.isfinite(d)]
    return (f"{int(ne.sum())} of {a.numel()} elements differ, max |diff| "
            f"{float(d.max()) if d.numel() else float('nan'):.3e}, NaN "
            f"{int(a.isnan().sum())}/{int(b.isnan().sum())}, first at "
            f"{ne.nonzero()[:1].tolist()}")


#: pauses the packing pool, if one runs, for a measurement: device timings,
#: profiled windows, serving and engine runs (set by :class:`Packer`)
quiet = contextlib.nullcontext


def time_ms(fn, flush, iters: int = 10) -> float:
    """Median device ms of ``fn`` over ``iters`` launches, each after the
    L2 cache was flushed (the main path finds its weights cold).  The flush
    (:data:`FLUSH_BYTES`) keeps the device busy while the host issues the
    start event and ``fn``'s launches, so the events time device work, not
    the host's Python in front of it; the packing pool is paused
    (:data:`quiet`), as a busy host outlasts the flush."""
    with quiet():
        fn()
        fn()
        times = []
        for _ in range(iters):
            flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
    return statistics.median(times)


#: kernel -> the Pallas kernel it replaces.  Each kernel's wrapper is the
#: function of that name in ``repro_torch/kernels/sme_spmm/<name>.py``,
#: its plain version ``<name>_plain`` there, its CUDA source
#: ``kernels/csrc/<name>.cu``
KERNELS = {
    "sme_spmm_planes_decode":
        "src/repro/kernels/sme_spmm/sme_spmm_planes_decode.py:157",
    "sme_spmm_planes": "src/repro/kernels/sme_spmm/sme_spmm_planes.py:77",
    "sme_spmm6": "src/repro/kernels/sme_spmm/sme_spmm6.py:54",
    "sme_spmm": "src/repro/kernels/sme_spmm/sme_spmm.py:54",
}


def _modules():
    import importlib
    return {name: importlib.import_module(
        f"repro_torch.kernels.sme_spmm.{name}") for name in KERNELS}


def wrappers():
    """{kernel name: its wrapper}, resolved from the modules."""
    return {name: getattr(mod, name) for name, mod in _modules().items()}


def zero_counts():
    for fn in wrappers().values():
        fn.launches = 0


#: per kernel, the axis of each operand that indexes the column tile
COL_AXES = {"sme_spmm_planes_decode": (0, 1, 1, 0, 0, 0, 0, 0),
            "sme_spmm_planes": (0, 1, 1, 0, 0, 0, 0),
            "sme_spmm6": (0, 0, 0, 0), "sme_spmm": (0, 0, 0, 0, 0)}


def chunked(name, fn, rows=512, tiles=256):
    """``fn`` (a plain version) over blocks of ``rows`` rows and ``tiles``
    column tiles, concatenated: the same function (rows and column tiles
    are independent), in the memory a block needs.  At gemma3-12b's widths
    one call would hold every decoded tile of a weight at once (28 GB for
    the head's v3 planes)."""
    axes = COL_AXES[name]

    def run(x, *ops, **kw):
        nt = ops[0].shape[0]
        return torch.cat([torch.cat([fn(x[r:r + rows], *(
            o.narrow(a, c, min(tiles, nt - c)).contiguous()
            for o, a in zip(ops, axes)), **kw)
            for c in range(0, nt, tiles)], dim=1)
            for r in range(0, x.shape[0], rows)])
    return run


@contextlib.contextmanager
def plain_kernels(blocks: bool = False):
    """Route every kernel backend through the kernels' plain versions (the
    backends resolve the wrappers from their modules at call time), in
    blocks of rows and column tiles with ``blocks``."""
    mods = _modules()
    saved = {name: getattr(m, name) for name, m in mods.items()}
    for name, m in mods.items():
        plain = getattr(m, f"{name}_plain")
        setattr(m, name, chunked(name, plain) if blocks else plain)
    try:
        yield
    finally:
        for name, m in mods.items():
            setattr(m, name, saved[name])


def bound_of(nbytes: float, flops: float):
    """(bound ms, what bounds it): bytes over the HBM rate or f32 FLOPs
    over the non-tensor peak, whichever takes longer."""
    t_b, t_f = nbytes / PEAK_BYTES, flops / PEAK_F32
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def _agg():
    return dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                max_abs_err=0.0, bytes=0.0, flops=0.0)


def _finish(agg):
    for a in agg.values():
        a["bound_by"] = bound_of(a.pop("bytes"), a.pop("flops"))[1]
    return agg


def check_close(kind, y, yp, ref, what):
    """Finite, kernel vs plain (TOL_PLAIN of max |plain|) and vs the f64
    oracle (TOL_ORACLE); returns (max |kernel - plain|, oracle rel)."""
    check(bool(torch.isfinite(y).all()), f"{kind} {what}: non-finite output")
    err = float((y - yp).abs().max())
    tol = TOL_PLAIN * float(yp.abs().max())
    check(err <= tol, f"{kind} {what}: |kernel - plain| {err} > {tol}")
    got = y[:, :ref.shape[1]].cpu().numpy()
    rel = float(np.abs(got - ref).max() / np.abs(ref).max())
    check(rel <= TOL_ORACLE, f"{kind} {what}: oracle rel {rel}")
    return err, rel


def kernel_phase(dev, flush):
    from repro_torch.core.backend import get_backend
    from repro_torch.core.sme import sme_compress, sme_matmul_ref_np
    from repro_torch.kernels.sme_spmm.sme_spmm import (sme_spmm,
                                                        sme_spmm_plain)
    from repro_torch.kernels.sme_spmm.sme_spmm6 import (sme_spmm6,
                                                         sme_spmm6_plain)
    from repro_torch.kernels.sme_spmm.sme_spmm_planes import (
        sme_spmm_planes, sme_spmm_planes_plain)
    from repro_torch.kernels.sme_spmm.sme_spmm_planes_decode import (
        sme_spmm_planes_decode, sme_spmm_planes_decode_plain)
    from repro_torch.kernels import build
    rng = np.random.default_rng(SEED)
    agg = {k: _agg() for k in RUN_M}
    tile_agg = {(k, m): _agg() for k in ("sme_spmm", "sme_spmm6")
                for _, m in RUN_M}
    for name, K, N, calls in SHAPES:
        w = rng.standard_normal((K, N)) / np.sqrt(K)
        smew = sme_compress(w, n_bits=8, window=3, squeeze=1)
        packed = smew.pack_plane_csc()
        ops = {k: torch.as_tensor(v, device=dev) for k, v in packed.items()}
        args = [ops[k] for k in ("planes", "sign", "rowscale")]
        idx = [ops[k] for k in ("rowid", "shift", "last", "nnz")]
        on = lambda d, keys: [torch.as_tensor(d[k], device=dev) for k in keys]
        csc1 = smew.pack_csc()
        a1 = on(csc1, ("codes", "sign", "rowscale", "rowid", "nnz"))
        a2 = on(get_backend("v2").pack_weight(smew),
                ("packed", "rowscale", "rowid", "nnz"))
        occ = int(csc1["nnz"].sum())
        nt = ops["planes"].shape[0]
        scale = torch.full((nt * 128,), float(smew.scale.reshape(-1)[0]),
                           dtype=torch.float32, device=dev)
        colscale = (scale * 2.0 ** -8).reshape(nt, 128)
        last, nnz = packed["last"], packed["nnz"]
        valid = np.arange(last.shape[1])[None, :] < nnz[:, None]
        groups = int(((last == 1) & valid).sum())
        deepest = 8
        w_dense = torch.as_tensor(smew.dequant(), dtype=torch.float32,
                                  device=dev)
        print_geometry(build, name, K, nt, ops["rowid"].shape[1],
                       a1[0].shape[1])
        for kind, m in RUN_M:
            x = rng.standard_normal((m, K)).astype(np.float32)
            xp = torch.as_tensor(x, device=dev)
            ref = sme_matmul_ref_np(x, smew)
            x128 = torch.zeros((-(-m // 128) * 128, K), device=dev)
            x128[:m] = xp
            # the v3 prefill kernel's scaled rows: what v1 and v2 must equal
            y_pre = (sme_spmm_planes(x128, *args, *idx)[:m]
                     * scale * 2.0 ** -8)[:, :N]
            if kind == "decode":
                def run(depth=None):
                    return sme_spmm_planes_decode(xp, *args, colscale, *idx,
                                                  plane_depth=depth)[:, :N]

                def plain():
                    return sme_spmm_planes_decode_plain(
                        xp, *args, colscale, *idx)[:, :N]
                kernel_only, plain_only = run, plain
            else:
                def kernel_only():
                    return sme_spmm_planes(xp, *args, *idx)

                def plain_only():
                    return sme_spmm_planes_plain(xp, *args, *idx)

                def run():
                    return (kernel_only() * scale * 2.0 ** -8)[:, :N]

                def plain():
                    return (plain_only() * scale * 2.0 ** -8)[:, :N]
            y, yp = run(), plain()
            torch.cuda.synchronize()
            check(y.shape == (m, N), f"{kind} {name}: misshapen output")
            err, rel = check_close(kind, y, yp, ref, name)
            extra = ""
            if kind == "decode":
                # decode kernel == prefill kernel (M padded to one 128 tile)
                check(bool(torch.equal(y, y_pre)),
                      f"{name} M={m}: decode kernel != prefill kernel bitwise")
                check(bool(torch.equal(run(deepest), y)),
                      f"{name}: plane_depth {deepest} is not a no-op")
                ref2 = np.asarray(x, np.float64) @ smew.dequant_topk_planes(2)
                rel2 = float(np.abs(run(2).cpu().numpy() - ref2).max()
                             / np.abs(ref2).max())
                check(rel2 <= TOL_ORACLE, f"{name}: plane_depth 2 rel {rel2}")
                extra = f" depth2_rel={rel2:.2e} decode==prefill"
            else:
                extra = f" (with epilogue {time_ms(run, flush) * 1e3:.1f} us)"
            ms = time_ms(kernel_only, flush)
            plain_ms = time_ms(plain_only, flush)
            lib_ms = time_ms(lambda: torch.matmul(xp, w_dense), flush)
            # bytes: x, every stored plane bitmap, sign + 2^row_exp of every
            # occupied tile, colscale, y; FLOPs: one 128x128 dot per group
            nbytes = (m * K * 4 + int(nnz.sum()) * 2048 + groups * (2048 + 512)
                      + nt * 128 * 4 + m * N * 4)
            flops = 2.0 * m * 128 * 128 * groups
            bound, by = bound_of(nbytes, flops)
            print(f"kernel {kind:7s} {name:6s} M={m:3d} K={K} N={N} "
                  f"planes={int(nnz.sum())} groups={groups}: "
                  f"{ms * 1e3:.1f} us, plain {plain_ms * 1e3:.1f} us, "
                  f"torch.matmul {lib_ms * 1e3:.1f} us, bound "
                  f"{bound * 1e3:.2f} us ({by}: {nbytes} B, {flops:.3g} FLOP)"
                  f" | max|k-p|={err:.2e} oracle_rel={rel:.2e}{extra}",
                  flush=True)
            a = agg[(kind, m)]
            for key, val in (("ms", ms), ("plain_ms", plain_ms),
                             ("library_ms", lib_ms), ("bound_ms", bound),
                             ("bytes", nbytes), ("flops", flops)):
                a[key] += calls * val
            a["max_abs_err"] = max(a["max_abs_err"], err)

            # v1 and v2: one kernel for decode and prefill, unscaled output
            for kname, kern, kplain, kargs, qscale, tile_bytes in (
                    ("sme_spmm", sme_spmm, sme_spmm_plain, a1, 2.0 ** -8,
                     16384 + 2048 + 512),
                    ("sme_spmm6", sme_spmm6, sme_spmm6_plain, a2, 2.0 ** -1,
                     12288 + 512)):
                def krun():
                    return (kern(xp, *kargs) * scale * qscale)[:, :N]

                def kplainrun():
                    return (kplain(xp, *kargs) * scale * qscale)[:, :N]
                y, yp = krun(), kplainrun()
                torch.cuda.synchronize()
                err, rel = check_close(kname, y, yp, ref, f"{name} M={m}")
                check(bool(torch.equal(y, y_pre)),
                      f"{kname} {name} M={m}: != v3 prefill kernel bitwise")
                ms = time_ms(lambda: kern(xp, *kargs), flush)
                plain_ms = time_ms(lambda: kplain(xp, *kargs), flush)
                epi_ms = time_ms(krun, flush)
                # bytes: x, each occupied tile's payload, the index (rowid
                # per occupied slot, nnz), y; FLOPs: one dot per tile
                nbytes = (m * K * 4 + occ * tile_bytes + occ * 4 + nt * 4
                          + m * N * 4)
                flops = 2.0 * m * 128 * 128 * occ
                bound, by = bound_of(nbytes, flops)
                print(f"kernel {kname:9s} {name:6s} M={m:3d} K={K} N={N} "
                      f"tiles={occ}: {ms * 1e3:.1f} us (with epilogue "
                      f"{epi_ms * 1e3:.1f} us), plain "
                      f"{plain_ms * 1e3:.1f} us, torch.matmul "
                      f"{lib_ms * 1e3:.1f} us, bound {bound * 1e3:.2f} us "
                      f"({by}: {nbytes} B, {flops:.3g} FLOP) | max|k-p|="
                      f"{err:.2e} oracle_rel={rel:.2e} == v3", flush=True)
                a = tile_agg[(kname, m)]
                for key, val in (("ms", ms), ("plain_ms", plain_ms),
                                 ("library_ms", lib_ms), ("bound_ms", bound),
                                 ("bytes", nbytes), ("flops", flops)):
                    a[key] += calls * val
                a["max_abs_err"] = max(a["max_abs_err"], err)
    tile_csc_edges(dev, sme_compress, sme_matmul_ref_np)
    return _finish(agg), _finish(tile_agg)


#: (kind, M) the kernel phase runs: the smallest and largest decode bucket
#: and a prefill window
RUN_M = (("decode", 8), ("decode", 64), ("prefill", 512))


def print_geometry(build, name, K, nt, L3, L1):
    """Launch shape of the four kernels at one linear shape (L3: the v3
    list length, L1: the v1 and v2 one)."""
    parts = []
    for kernel, ms, extra in (("sme_spmm_planes_decode", (8, 64), (L3, 0)),
                              ("sme_spmm_planes", (512,), (L3,)),
                              ("sme_spmm6", (8, 64, 512), (L1,)),
                              ("sme_spmm", (8, 64, 512), (L1,))):
        for m in ms:
            g = build.geometry(kernel, m, K, nt, *extra)
            parts.append(f"{kernel} M={m}: {g['grid_x']}x{g['grid_y']} "
                         f"blocks, cluster {g['cluster']}, "
                         f"{g['smem_bytes']} B shared")
    print(f"geometry {name}: " + "; ".join(parts), flush=True)


def tile_csc_edges(dev, sme_compress, oracle):
    """v1, v2 and the v3 decode kernel on a pruned weight (empty tiles,
    column tile 1 empty: its output must be exactly 0) bitwise against the
    v3 prefill kernel, the decode kernel's ``plane_depth`` 1, 2 and 8 on
    those uneven lists, and v1 at settings v2 cannot hold, against the
    oracle."""
    from repro_torch.core.backend import get_backend
    from repro_torch.kernels.sme_spmm.sme_spmm import sme_spmm
    from repro_torch.kernels.sme_spmm.sme_spmm6 import sme_spmm6
    from repro_torch.kernels.sme_spmm.sme_spmm_planes import sme_spmm_planes
    from repro_torch.kernels.sme_spmm.sme_spmm_planes_decode import \
        sme_spmm_planes_decode
    rng = np.random.default_rng(SEED + 2)
    w = rng.standard_normal((384, 384)) / np.sqrt(384)
    w[:, 128:256] = 0.0
    w[256:, :128] = 0.0
    w[:256, 256:] = 0.0
    on = lambda d, keys: [torch.as_tensor(d[k], device=dev) for k in keys]
    smew = sme_compress(w, squeeze=1)
    csc1 = smew.pack_csc()
    check(csc1["nnz"].tolist() == [2, 0, 1], f"pruned nnz {csc1['nnz']}")
    a1 = on(csc1, ("codes", "sign", "rowscale", "rowid", "nnz"))
    a2 = on(get_backend("v2").pack_weight(smew),
            ("packed", "rowscale", "rowid", "nnz"))
    a3 = on(smew.pack_plane_csc(), ("planes", "sign", "rowscale", "rowid",
                                    "shift", "last", "nnz"))
    scale = float(smew.scale.reshape(-1)[0])
    colscale = torch.full((3, 128), scale * 2.0 ** -8, device=dev)
    depth_rel = {}
    for m in (8, 64, 512):
        x = torch.as_tensor(rng.standard_normal((m, 384)), dtype=torch.float32,
                            device=dev)
        x128 = torch.zeros((-(-m // 128) * 128, 384), device=dev)
        x128[:m] = x
        y3 = sme_spmm_planes(x128, *a3)[:m] * scale * 2.0 ** -8
        y1 = sme_spmm(x, *a1) * scale * 2.0 ** -8
        y2 = sme_spmm6(x, *a2) * scale * 2.0 ** -1
        check(bool(torch.equal(y1, y3)) and bool(torch.equal(y2, y3)),
              f"pruned M={m}: v1/v2 != v3 bitwise")
        check(bool((y1[:, 128:256] == 0).all()), "empty column tile not 0")
        ref = oracle(x.cpu().numpy(), smew)
        rel = float(np.abs(y1.cpu().numpy() - ref).max() / np.abs(ref).max())
        check(rel <= TOL_ORACLE, f"pruned M={m}: oracle rel {rel}")
        if 2 * m > 128:
            continue

        def dec(depth=None):
            return sme_spmm_planes_decode(x, *a3[:3], colscale, *a3[3:],
                                          plane_depth=depth)
        yd = dec()
        check(bool(torch.equal(yd, y3)) and bool(torch.equal(dec(8), yd)),
              f"pruned M={m}: decode kernel != prefill kernel, or depth 8 "
              "is not a no-op")
        check(bool((yd[:, 128:256] == 0).all()), "decode: empty column not 0")
        for k in (1, 2):
            ref_k = np.asarray(x.cpu().numpy(), np.float64) \
                @ smew.dequant_topk_planes(k)
            rel_k = float(np.abs(dec(k).cpu().numpy() - ref_k).max()
                          / np.abs(ref_k).max())
            check(rel_k <= TOL_ORACLE, f"pruned M={m} depth {k}: rel {rel_k}")
            depth_rel[(m, k)] = rel_k
    rels = []
    for kw in (dict(squeeze=0), dict(window=4, squeeze=1)):
        wv = rng.standard_normal((1024, 1024)) / 32.0
        sv = sme_compress(wv, **kw)
        check(not get_backend("v2").supports(sv), f"v2 holds {kw}?")
        x = torch.as_tensor(rng.standard_normal((64, 1024)),
                            dtype=torch.float32, device=dev)
        y = sme_spmm(x, *on(sv.pack_csc(), ("codes", "sign", "rowscale",
                                             "rowid", "nnz")))
        y = y * float(sv.scale.reshape(-1)[0]) * 2.0 ** -8
        ref = oracle(x.cpu().numpy(), sv)
        rels.append(float(np.abs(y.cpu().numpy() - ref).max()
                          / np.abs(ref).max()))
        check(rels[-1] <= TOL_ORACLE, f"v1 at {kw}: oracle rel {rels[-1]}")
    torch.cuda.synchronize()
    print(f"kernel edges: pruned weight (tiles per column 2/0/1) v1 == v2 == "
          f"v3 == v3-decode bitwise at M = 8, 64 (and v1 == v2 == v3 at 512), "
          f"empty column exactly 0, decode plane_depth 8 a no-op, depth 1/2 "
          f"oracle rel <= {max(depth_rel.values()):.2e}; v1 at squeeze 0 / "
          f"window 4 oracle rel {rels[0]:.2e} / {rels[1]:.2e}", flush=True)


def card_tests() -> None:
    """The ``gpu``-marked tests, in a child process (it reuses the build)."""
    import os
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-m", "gpu",
         "-p", "no:cacheprovider", "tests/test_torch_cuda.py"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    tail = proc.stdout.strip().splitlines()[-1:] or ["(no output)"]
    print(f"card tests: {tail[0]} ({time.perf_counter() - t0:.1f}s)",
          flush=True)
    check(proc.returncode == 0,
          f"card tests failed:\n{proc.stdout[-4000:]}{proc.stderr[-2000:]}")


def build_model_params(dev, cfg):
    """Full-width random weights, generated and packed layer by layer,
    each weight compressed once and packed for v1, v2 and v3."""
    from repro_torch.core.integrate import convert_params_to_sme, to_torch
    from repro_torch.models.transformer import init_layer
    rng = np.random.default_rng(SEED)
    embed = rng.standard_normal((cfg.vocab, cfg.d_model), dtype=np.float32)
    params = to_torch({"embed": {"w": embed * np.float32(EMBED_STD)},
                       "final_norm": {"w": np.ones(cfg.d_model, np.float32)}},
                      dev)
    params["blocks"] = []
    t0 = time.perf_counter()
    for _ in range(cfg.n_layers):
        params["blocks"].append(convert_params_to_sme(
            init_layer(cfg, rng), backend="all", device=dev))
    return params, time.perf_counter() - t0


#: the serving phase's engine: every prompt prefilled in one piece (chunk
#: length s_max), no speculation, no prefix cache, so its readings compare
#: with the one-shot engine of earlier revisions
ONE_SHOT = dict(slots=4, s_max=256, chunk_len=256, prefix_cache=False)
#: serving runs: backend asked -> (what it must resolve to, its kernels)
RUNS = {"auto": ("v2", ("sme_spmm6",)), "v1": ("v1", ("sme_spmm",)),
        "v3": ("v3", ("sme_spmm_planes", "sme_spmm_planes_decode"))}


def packed_linears(tree) -> int:
    """SME-packed linears of a param tree, a stacked [E, K, N] weight
    counting its E slices: the launches of one model pass."""
    if isinstance(tree, dict):
        if "sme_codes" in tree:
            return int(np.prod(tuple(tree["sme_codes"].shape[:-4])))
        return sum(map(packed_linears, tree.values()))
    if isinstance(tree, (list, tuple)):
        return sum(map(packed_linears, tree))
    return 0


def serve_run(api, params, prompts, backend, card, route=None, label=None,
              engine_kw=None, decode_skip=0, max_new=16):
    """Serve one request of ``max_new`` new tokens per prompt once under
    ``backend``; returns (tokens, launches per kernel).  Counts are set to
    0 just before.  ``route``: (what the weights must resolve to, the
    kernels they launch), by default :data:`RUNS`' entry for ``backend``;
    ``engine_kw``: the engine's settings (default :data:`ONE_SHOT`);
    ``decode_skip``: packed linears a decode pass does not launch (MLA's
    ``kv_up``, read as a dequantized matrix at decode; an enc-dec model's
    encoder and cross K/V projections, which run at prefill only)."""
    from repro_torch.serve import Request, ServeEngine
    want, mine = route or RUNS[backend]
    label = label or backend
    reqs = [Request(rid=i, prompt=p, max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    eng = ServeEngine(api, params, backend=backend, device=api.device,
                      **(engine_kw or ONE_SHOT))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    with quiet():              # its ms per step and per prefill are readings
        stats = eng.run(reqs, max_steps=200)
        torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in wrappers().items()}
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    per_pass = packed_linears(params)
    passes = stats["prefills"] + stats["decode_steps"]
    print(f"serve[{label}]: {stats}", flush=True)
    print(f"serve[{label}]: launches {launches}, per model pass {per_pass}")
    check(stats["backend"] == want,
          f"{label}: backend {backend!r} resolved to {stats['backend']}, "
          f"not {want}")
    check(stats["completed"] == len(reqs),
          f"completed {stats['completed']} of {len(reqs)}")
    check(all(len(r.out_tokens) == max_new for r in reqs), "short outputs")
    check(all(launches[k] == 0 for k in launches if k not in mine),
          f"{label}: kernels of another backend launched: {launches}")
    want = per_pass * passes - decode_skip * stats["decode_steps"]
    check(sum(launches[k] for k in mine) == want,
          f"{label}: {sum(launches[k] for k in mine)} launches of "
          f"{mine} != {want} ({per_pass} x {passes} model passes, "
          f"{decode_skip} fewer per decode pass)")
    check(all(launches[k] > 0 for k in mine),
          f"{label}: a kernel of the path never launched: {launches}")
    if "sme_spmm_planes_decode" in mine:
        # v3 linears of a decode pass
        n3 = len(_v3_params(params)) - decode_skip
        check(launches["sme_spmm_planes_decode"]
              >= n3 * stats["decode_steps"],
              "v3 decode kernel does not cover every decode step")
    n_tok = sum(len(r.out_tokens) for r in reqs)
    print(f"serve[{label}]: {n_tok / stats['wall_s']:.1f} tokens/s end to "
          f"end, {stats['decode_s'] / stats['decode_steps'] * 1e3:.2f} ms per "
          f"decode step ({eng.slots} slots), "
          f"{stats['prefill_s'] / stats['prefills'] * 1e3:.1f} ms per "
          f"prefill, peak memory {peak_gb:.2f} GiB | {card}", flush=True)
    return [r.out_tokens for r in reqs], launches


def qwen_config():
    """qwen1.5-0.5b at full width, cut to :data:`QWEN_LAYERS` layers."""
    from repro_torch.configs import ARCHS
    return dataclasses.replace(ARCHS["qwen1.5-0.5b"], n_layers=QWEN_LAYERS)


def serve_phase(dev, card):
    from repro_torch.core.integrate import sme_operand_bytes
    from repro_torch.models.model import build_model
    cfg = qwen_config()
    print(f"serve: qwen1.5-0.5b at full width, depth cut from 24 layers to "
          f"{cfg.n_layers} (this script's time limit holds the gemma3-12b, "
          f"MoE, vision and recurrent phases too)", flush=True)
    params, pack_s = build_model_params(dev, cfg)
    print(f"serve: packed {cfg.n_layers} layers x 7 linears to v1, v2 and "
          f"v3 in {pack_s:.1f}s", flush=True)
    ob = sme_operand_bytes(params["blocks"])
    print("serve: operand bytes per weight over "
          f"{ob['weights']} weights: " + ", ".join(
              f"{be} {ob[be] / 1e6:.1f} MB = {ob[be] / ob['weights']:.4f} B"
              for be in ("v1", "v2", "v3"))
          + f"; dense bf16 {2 * ob['weights'] / 1e6:.1f} MB = 2 B",
          flush=True)
    api = build_model(cfg, device=dev)
    rng = np.random.default_rng(SEED + 1)
    prompts = [rng.integers(0, cfg.vocab, int(n))
               for n in rng.integers(40, 121, size=8)]
    tokens, launches = {}, {}
    for backend in RUNS:
        tokens[backend], counts = serve_run(api, params, prompts, backend,
                                            card)
        for name in RUNS[backend][1]:
            launches[name] = counts[name]
    check(tokens["auto"] == tokens["v1"] == tokens["v3"],
          "v2 (auto), v1 and v3 served different tokens")
    print("serve: v2 (auto), v1 and v3 tokens identical", flush=True)

    # one prefill window (the engine's first: 4 rows, bucket 128): v1, v2
    # and v3 bitwise equal, and each within tolerance of the plain
    # versions, in f32 (the algorithm) and bf16 (as served)
    toks, plen = prefill_window(prompts, ONE_SHOT["s_max"])
    for dtype in ("float32", "bfloat16"):
        api_d = build_model(dataclasses.replace(cfg, dtype=dtype), device=dev)
        lk = {be: api_d.prefill(params, toks, s_max=256, plen=plen,
                                backend=be)[0] for be in ("v1", "v2", "v3")}
        check(bool(torch.equal(lk["v1"], lk["v2"]))
              and bool(torch.equal(lk["v1"], lk["v3"])),
              f"{dtype} prefill logits differ between v1, v2 and v3 (v1 "
              f"vs v2: {mismatch(lk['v1'], lk['v2'])}; v1 vs v3: "
              f"{mismatch(lk['v1'], lk['v3'])})")
        for be, logits in lk.items():
            with plain_kernels():
                lp, _ = api_d.prefill(params, toks, s_max=256, plen=plen,
                                      backend=be)
            check(bool(torch.isfinite(logits).all())
                  and logits.shape == (4, cfg.vocab),
                  f"{dtype} {be} logits non-finite or misshapen")
            diff = float((logits - lp).abs().max() / lp.abs().max())
            agree = int((logits.argmax(-1) == lp.argmax(-1)).sum())
            print(f"serve: {dtype} {be} prefill logits kernels vs plain: max "
                  f"rel diff {diff:.2e} (tolerance {TOL_LOGITS[dtype]:.0e}), "
                  f"greedy agreement {agree}/4", flush=True)
            check(diff <= TOL_LOGITS[dtype],
                  f"{dtype} {be} logits rel diff {diff}")
        print(f"serve: {dtype} prefill logits v1 == v2 == v3 bitwise",
              flush=True)
    for backend in RUNS:
        profile_window(api, params, prompts[4:], card, backend)
    return launches, params, dict(pack_s=pack_s, prompts=prompts,
                                  auto_tokens=tokens["auto"])


def prefill_window(prompts, s_max):
    """The one-shot engine's first prefill window of ``prompts``: 4 rows
    right-padded to their length bucket, and their lengths."""
    from repro_torch.serve.engine import _prompt_bucket
    lens = [len(p) for p in prompts[:4]]
    toks = np.zeros((4, _prompt_bucket(max(lens), s_max)), np.int64)
    for i, p in enumerate(prompts[:4]):
        toks[i, :len(p)] = p
    return toks, lens


def profile_window(api, params, prompts, card, backend, engine_kw=None):
    """Where a serving window's time goes: torch.profiler over one prefill
    and 5 decode steps of 4 requests (after the counted runs)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve import Request, ServeEngine
    eng = ServeEngine(api, params, backend=backend, device=api.device,
                      **(engine_kw or ONE_SHOT))
    reqs = [Request(rid=i, prompt=p, max_new_tokens=6)
            for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    with quiet(), profile(activities=[ProfilerActivity.CPU,
                                      ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        stats = eng.run(reqs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA" and e.self_device_time_total]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"profile[{stats['backend']}]: 1 prefill + "
          f"{stats['decode_steps']} decode steps, wall "
          f"{wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
          f"({100 * busy_ms / wall_ms:.1f}%), idle "
          f"{100 * (1 - busy_ms / wall_ms):.1f}% | {card}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"profile:   {e.self_device_time_total / 1e3:8.2f} ms "
              f"{e.count:6d} calls  {e.key[:90]}")
    n_ops = sum(e.count for e in prof.key_averages()
                if e.device_type.name == "CPU" and e.key.startswith("aten::"))
    print(f"profile: {n_ops} aten op calls on the host (nested included)",
          flush=True)


#: the engine phase: the reference's continuous engine settings
ENGINE = dict(slots=4, s_max=256, chunk_len=32, page_tokens=16, spec_len=4)
#: share of the weights' magnitude mass the draft depth keeps (the rule of
#: the reference compiler's ``draft_depth_from_occupancy``)
DRAFT_COVERAGE = 0.90
#: engine steps after which the second half of the workload is submitted:
#: by then the first pair members have scored their 64-token prefix
SECOND_WAVE_AT = 2


def _v3_params(tree):
    """Every packed linear (dict with v3 operands) of a param tree."""
    out = []

    def walk(t):
        if isinstance(t, dict):
            if "sme_v3_planes" in t:
                out.append(t)
                return
            for v in t.values():
                walk(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)
    walk(tree)
    return out


def choose_spec_depth(params, coverage=DRAFT_COVERAGE, layers="blocks"):
    """One draft depth for the whole model from its plane occupancy (the
    linears under ``params[layers]``: an enc-dec model's ``dec``, which
    the draft runs): the smallest k whose top k planes per tile group
    keep ``coverage`` of the magnitude mass (set bits x 2^shift, what
    truncation drops), capped below the deepest group so the draft always
    truncates.  Returns (k, deepest, kept mass share, kept plane
    share)."""
    linears = _v3_params(params[layers])
    dev = linears[0]["sme_v3_planes"].device
    lut = torch.tensor([bin(i).count("1") for i in range(256)],
                       dtype=torch.float64, device=dev)
    mass = torch.zeros(64, dtype=torch.float64, device=dev)
    count = torch.zeros(64, dtype=torch.float64, device=dev)
    for p in linears:
        # stacked [E, ...] operands: each slice's columns, one after another
        L = p["sme_v3_shift"].shape[-1]
        planes = p["sme_v3_planes"].reshape(
            (-1, L) + tuple(p["sme_v3_planes"].shape[-2:]))
        shift = p["sme_v3_shift"].reshape(-1, L)
        last = p["sme_v3_last"].reshape(-1, L)
        nnz = p["sme_v3_nnz"].reshape(-1)
        nt, L = shift.shape
        slot = torch.arange(L, device=dev).expand(nt, L)
        start = torch.ones_like(last, dtype=torch.bool)
        start[:, 1:] = last[:, :-1] == 1
        rank = slot - torch.cummax(torch.where(start, slot, 0), dim=1).values
        valid = slot < nnz[:, None].long()
        pop = lut[planes.long()].sum(dim=(-1, -2))
        m = pop * torch.exp2(shift.double())
        mass += torch.bincount(rank[valid], weights=m[valid], minlength=64)
        count += torch.bincount(rank[valid], minlength=64).double()
    deepest = int(torch.nonzero(count).max()) + 1
    share = (mass.cumsum(0) / mass.sum()).cpu().numpy()
    kept = (count.cumsum(0) / count.sum()).cpu().numpy()
    k = next((k for k in range(1, deepest) if share[k - 1] >= coverage),
             deepest - 1)
    return k, deepest, float(share[k - 1]), float(kept[k - 1])


def engine_workload(vocab):
    """8 requests of 16 new tokens: 3 with 40-120-token prompts, 2 pairs
    sharing a 64-token prefix (72-88 tokens each), 1 sampled at
    temperature 0.8.  The first wave holds one member of each pair."""
    from repro_torch.serve import Request
    rng = np.random.default_rng(SEED + 2)
    longs = [rng.integers(0, vocab, int(n)) for n in rng.integers(40, 121, 3)]
    pairs = []
    for _ in range(2):
        prefix = rng.integers(0, vocab, 64)
        pairs.append([np.concatenate([prefix, rng.integers(
            0, vocab, int(rng.integers(8, 25)))]) for _ in range(2)])
    hot = rng.integers(0, vocab, 24)
    first = [pairs[0][0], longs[0], pairs[1][0], longs[1]]
    second = [pairs[0][1], pairs[1][1], longs[2], hot]
    reqs = [Request(rid=i, prompt=p, max_new_tokens=16)
            for i, p in enumerate(first + second)]
    reqs[-1].temperature = 0.8
    return reqs[:4], reqs[4:]


def engine_run(api, params, backend, spec_depth, prefix_cache,
               engine_kw=None, waves=None):
    """Drive a workload once through submit/pump/step/poll: ``waves`` is
    (first requests, second requests, ``ready(engine, steps)``, when the
    second wave is submitted), by default :func:`engine_workload`'s after
    :data:`SECOND_WAVE_AT` steps.  Returns the requests, the engine,
    per-request token events and TTFT, wall seconds, model passes (prefill
    + decode_step calls, counted on the API) and the v3 decode kernel's
    launches inside draft passes."""
    from repro_torch.kernels.sme_spmm.sme_spmm_planes_decode import \
        sme_spmm_planes_decode as dec
    from repro_torch.serve import ServeEngine
    eng = ServeEngine(api, params, backend=backend, device=api.device,
                      spec_depth=spec_depth, prefix_cache=prefix_cache,
                      **(engine_kw or ENGINE))
    passes, prefills, draft_launches = [0], [0], [0]

    def counted(fn, also=None):
        def call(*a, **kw):
            passes[0] += 1
            if also:
                also[0] += 1
            return fn(*a, **kw)
        return call
    api.prefill, api.decode_step = counted(api.prefill, prefills), \
        counted(api.decode_step)
    draft = eng._draft

    def counted_draft(rows):
        n0 = dec.launches
        out = draft(rows)
        draft_launches[0] += dec.launches - n0
        return out
    eng._draft = counted_draft
    first, second, ready = waves or (*engine_workload(api.cfg.vocab),
                                     lambda e, n: n == SECOND_WAVE_AT)
    events, t_sub, ttft = {}, {}, {}
    torch.cuda.synchronize()
    zero_counts()
    with quiet():
        t0 = time.perf_counter()
        for r in first:
            eng.submit(r)
            t_sub[r.rid] = time.perf_counter()
        steps, waiting = 0, list(second)
        while not all(r.done for r in first + second):
            check(steps < 400, f"engine[{backend}]: not done in 400 steps")
            if waiting and ready(eng, steps):
                for r in waiting:
                    eng.submit(r)
                    t_sub[r.rid] = time.perf_counter()
                waiting = []
            eng.pump()
            eng.step()
            steps += 1
            now = time.perf_counter()
            for ev in eng.poll():
                if ev["kind"] == "token":
                    events.setdefault(ev["rid"], []).append(ev["token"])
                    ttft.setdefault(ev["rid"], now - t_sub[ev["rid"]])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in wrappers().items()}
    del api.prefill, api.decode_step
    return dict(reqs=first + second, eng=eng, events=events, ttft=ttft,
                wall=wall, steps=steps, passes=passes[0],
                prefill_passes=prefills[0], launches=launches,
                draft_launches=draft_launches[0])


def draft_layer_ms(params, depth, flush):
    """Device ms of one model layer's 7 decode-kernel launches at M = 8
    (the engine's 4 slots, padded), full precision and at ``depth`` (an
    int, or ``"plan"``: each linear's ``sme_draft_planes``), on layer 0's
    packed operands."""
    from repro_torch.kernels.sme_spmm.sme_spmm_planes_decode import \
        sme_spmm_planes_decode as dec
    ops = ("planes", "sign", "rowscale", "rowid", "shift", "last", "nnz")
    calls = []
    for p in _v3_params(params["blocks"][0]):
        a = {o: p[f"sme_v3_{o}"] for o in ops}
        nt, _, bk8, bn = a["planes"].shape
        nr = -(-p["sme_sign"].shape[-2] // (bk8 * 8))
        x = torch.randn((8, nr * bk8 * 8), device=a["planes"].device)
        cs = torch.full((nt, bn), 1e-3, device=x.device)
        d = int(p["sme_draft_planes"]) if depth == "plan" else depth
        calls.append((x, [a["planes"], a["sign"], a["rowscale"], cs,
                          a["rowid"], a["shift"], a["last"], a["nnz"]], d))

    def layer(truncate):
        for x, args, d in calls:
            dec(x, *args, plane_depth=d if truncate else None)
    with quiet():
        return time_ms(lambda: layer(False), flush), \
            time_ms(lambda: layer(True), flush)


def engine_phase(dev, card, params):
    """The continuous engine on the serving phase's packed model: v3 with
    chunked prefill, the prefix cache and self-speculative decode, then the
    same workload with spec off, with the prefix cache off, and under auto
    (v2).  Returns the v3-decode row's draft keys for the JSON line."""
    from repro_torch.models.model import build_model
    t_phase = time.perf_counter()
    api = build_model(qwen_config(), device=dev)
    per_pass = packed_linears(params)
    depth, deepest, share, kept = choose_spec_depth(params)
    check(1 <= depth < deepest, f"draft depth {depth} of {deepest}")
    print(f"engine: draft depth {depth} of the deepest group's {deepest} "
          f"planes: keeps {100 * share:.2f}% of the weights' magnitude mass "
          f"and {100 * kept:.2f}% of the plane entries ({ENGINE}, prefix "
          f"cache on, spec_len {ENGINE['spec_len']})", flush=True)
    runs = {}
    for name, backend, spec, prefix in (
            ("v3 spec+chunk+prefix", "v3", depth, True),
            ("v3 spec off", "v3", None, True),
            ("v3 prefix off", "v3", depth, False),
            ("auto (v2) spec+chunk+prefix", "auto", depth, True)):
        r = runs[name] = engine_run(api, params, backend, spec, prefix)
        eng, reqs, m = r["eng"], r["reqs"], r["eng"]._m
        stats = eng.stats
        check(all(q.outcome == "completed" and len(q.out_tokens) == 16
                  for q in reqs), f"engine[{name}]: incomplete requests")
        check(all(r["events"].get(q.rid) == q.out_tokens for q in reqs),
              f"engine[{name}]: poll's token events != out_tokens")
        mine = ("sme_spmm6",) if backend == "auto" else \
            ("sme_spmm_planes", "sme_spmm_planes_decode")
        got = sum(r["launches"][k] for k in mine)
        check(all(r["launches"][k] == 0 for k in r["launches"]
                  if k not in mine), f"engine[{name}]: other kernels launched")
        check(got == per_pass * r["passes"],
              f"engine[{name}]: {got} launches of {mine} != {per_pass} x "
              f"{r['passes']} model passes")
        check(all(r["launches"][k] > 0 for k in mine),
              f"engine[{name}]: a kernel of the path never launched: "
              f"{r['launches']}")
        drafted = m["spec_draft_tokens"].value
        check(m["spec_accepted"].value + m["spec_rolled_back"].value
              == drafted, f"engine[{name}]: spec counters do not add up")
        if spec is not None:
            check(m["spec_rounds"].value > 0, f"engine[{name}]: no spec round")
            if backend == "v3":
                check(r["draft_launches"] == per_pass * ENGINE[
                    "spec_len"] * m["spec_rounds"].value,
                      f"engine[{name}]: draft passes launched "
                      f"{r['draft_launches']} decode kernels")
        if prefix:
            check(m["prefix_hits"].value >= 1, f"engine[{name}]: no hit")
        n_tok = sum(len(q.out_tokens) for q in reqs)
        split = ", ".join(f"{k} {n} x {ms:.1f} ms"
                          for k, (n, ms) in eng.step_ms().items())
        ds, vs = m["spec_draft_s"], m["spec_verify_s"]
        pf_ms = 1e3 * stats["prefill_s"] / max(stats["prefills"], 1)
        print(f"engine[{name}]: {r['steps']} steps ({split}); prefills "
              f"{stats['prefills']} x {pf_ms:.1f} ms; "
              f"{r['passes']} model passes; {n_tok} tokens in "
              f"{r['wall']:.2f} s = {n_tok / r['wall']:.2f} tokens/s | "
              f"{card}", flush=True)
        print(f"engine[{name}]: spec rounds {int(m['spec_rounds'].value)}, "
              f"draft {1e3 * ds.sum / max(ds.count, 1):.1f} ms and verify "
              f"{1e3 * vs.sum / max(vs.count, 1):.1f} ms per round, "
              f"accepted {int(m['spec_accepted'].value)} of "
              f"{int(drafted)} drafted "
              f"({100 * m['spec_accepted'].value / max(drafted, 1):.1f}%), "
              f"rolled back {int(m['spec_rolled_back'].value)}; prefix hits "
              f"{int(m['prefix_hits'].value)}, misses "
              f"{int(m['prefix_misses'].value)}, snapshots "
              f"{int(m['prefix_snapshots'].value)}; draft-pass decode "
              f"launches {r['draft_launches']}; launches {r['launches']}",
              flush=True)
        print(f"engine[{name}]: TTFT ms per request " + ", ".join(
            f"{q.rid}:{1e3 * r['ttft'][q.rid]:.0f}" for q in reqs),
              flush=True)
    greedy = {name: [q.out_tokens for q in r["reqs"] if q.temperature == 0]
              for name, r in runs.items()}
    base = greedy["v3 spec+chunk+prefix"]
    check(all(g == base for g in greedy.values()),
          "engine: greedy tokens differ between spec on/off, prefix cache "
          "on/off and v3/v2")
    print("engine: greedy tokens identical across the four runs; "
          "distinct tokens per request: " + ", ".join(
              f"{q.rid}:{len(set(q.out_tokens))}"
              for q in runs["v3 spec+chunk+prefix"]["reqs"]), flush=True)
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32, device=dev)
    full_ms, draft_ms = draft_layer_ms(params, depth, flush)
    del flush
    print(f"engine: decode kernel per model layer at M = 8: full "
          f"{full_ms:.4f} ms, draft (depth {depth}) {draft_ms:.4f} ms "
          f"({draft_ms / full_ms:.3f}x) | {card}", flush=True)
    print(f"engine: phase {time.perf_counter() - t_phase:.1f}s", flush=True)
    return {"draft_depth": depth,
            "draft_launches": runs["v3 spec+chunk+prefix"]["draft_launches"],
            "draft_ms": draft_ms, "draft_full_ms": full_ms}


#: the compile phase: the reference compiler CLI's default error budget
BUDGET = 0.06
#: plan backend -> the kernels its weights launch
KERNELS_OF = {"v1": ("sme_spmm",), "v2": ("sme_spmm6",),
              "v3": ("sme_spmm_planes", "sme_spmm_planes_decode")}


def dense_reference_tree(cfg):
    """``build_model_params``' weights before packing (the same numpy seed
    and draws), in the reference's layout: every layer's leaf stacked."""
    from repro_torch.convert import to_reference
    from repro_torch.models.transformer import init_layer
    rng = np.random.default_rng(SEED)
    embed = rng.standard_normal((cfg.vocab, cfg.d_model), dtype=np.float32)
    return to_reference({
        "embed": {"w": embed * np.float32(EMBED_STD)},
        "final_norm": {"w": np.ones(cfg.d_model, np.float32)},
        "blocks": [init_layer(cfg, rng) for _ in range(cfg.n_layers)]})


def compile_artifact(tree, backend, out, cfg, card):
    """Plan and pack ``tree`` under ``backend`` into ``out``; print the
    per-leaf plan, its summary and the seconds and megabytes.  Returns
    the plan and the readings."""
    from repro_torch.compiler import compile_model, plan_model
    t0 = time.perf_counter()
    plan = plan_model(tree, error_budget=BUDGET, backend=backend)
    plan_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    compile_model(tree, plan=plan, out=out, extra={
        "arch": "qwen1.5-0.5b", "config": cfg.name,
        "dims": {"d_model": cfg.d_model, "d_ff": cfg.d_ff,
                 "vocab": cfg.vocab, "n_layers": cfg.n_layers,
                 "head_dim": cfg.hd}, "serve_backend": "auto"})
    pack_s = time.perf_counter() - t0
    files = [f for f in out.rglob("*") if f.is_file()]
    mb = sum(f.stat().st_size for f in files) / 1e6
    for key, lp in sorted(plan.layers.items()):
        print(f"compile[{backend}]: {key} {lp.shape} x {lp.n_slices}: "
              f"(n_bits, window, squeeze, squeeze_max) = ({lp.n_bits}, "
              f"{lp.window}, {lp.squeeze}, {lp.squeeze_max}) -> {lp.backend}, "
              f"{lp.bytes_per_weight:.4f} B/weight, rel err "
              f"{lp.error_bound:.4f}, crossbars {lp.crossbars} of "
              f"{lp.crossbars_dense} ({lp.crossbar_reduction:.2f}x), draft "
              f"depth {lp.draft_planes}", flush=True)
    print(f"compile[{backend}]: summary {plan.summary()}", flush=True)
    print(f"compile[{backend}]: plan {plan_s:.1f}s, pack and save "
          f"{pack_s:.1f}s, {mb:.1f} MB on disk in {len(files)} files "
          f"(budget {BUDGET}) | {card}", flush=True)
    return plan, dict(plan_s=plan_s, pack_s=pack_s, mb=mb)


@contextlib.contextmanager
def spec_depth_spy():
    """Record ``(id(param), resolved depth)`` of every v3 dispatch made
    under a draft's ``use_spec_depth`` (sme_apply resolves through the
    module's name)."""
    import repro_torch.core.backend as B
    real, seen = B.resolve_spec_depth, []

    def spy(param=None, plane_depth=None):
        got = real(param, plane_depth)
        if B._spec_stack[-1] is not None:
            seen.append((id(param), got))
        return got
    B.resolve_spec_depth = spy
    try:
        yield seen
    finally:
        B.resolve_spec_depth = real


def boot(api, path, card, inline_s):
    """``ServeEngine.from_artifact`` onto the card, timed to the last leaf
    on the device."""
    from repro_torch.serve import ServeEngine
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = ServeEngine.from_artifact(api, path, **ONE_SHOT)
    torch.cuda.synchronize()
    boot_s = time.perf_counter() - t0
    print(f"compile: booted {path.name} in {boot_s:.2f}s (from_artifact: "
          f"map, check every operand list, copy to the card), against "
          f"{inline_s:.1f}s for the inline convert_params_to_sme of the "
          f"serving phase | {card}", flush=True)
    return eng, boot_s


def measured_replan(dev, tree, plan_bytes, tmp, card):
    """The planner on the card's own times: each backend's decode kernel
    at M = 1 (padded to the kernels' 8 rows; the launch alone, L2
    flushed, as in the kernel phase) at the three linear shapes, recorded
    in an autotune cache, then ``plan_model`` under ``auto`` once more
    with it.  Prints each leaf's choice by bytes against its choice by
    measured time."""
    from repro_torch.compiler import plan_model
    from repro_torch.core.backend import get_backend
    from repro_torch.core.sme import sme_compress
    from repro_torch.hardware.autotune import (AutotuneCache, TuneKey,
                                               device_kind)
    kernels = wrappers()
    cache = AutotuneCache(str(tmp / "autotune.json"))
    rng = np.random.default_rng(SEED + 3)
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32, device=dev)

    def on(d, keys):
        return [torch.as_tensor(d[k], device=dev) for k in keys]
    for _, K, N, _ in SHAPES:
        smew = sme_compress(rng.standard_normal((K, N)) / np.sqrt(K))
        v3 = on(smew.pack_plane_csc(), ("planes", "sign", "rowscale",
                                        "rowid", "shift", "last", "nnz"))
        cs = torch.ones((v3[0].shape[0], 128), device=dev)
        calls = {
            "v1": (kernels["sme_spmm"], on(smew.pack_csc(), (
                "codes", "sign", "rowscale", "rowid", "nnz"))),
            "v2": (kernels["sme_spmm6"], on(get_backend("v2").pack_weight(
                smew), ("packed", "rowscale", "rowid", "nnz"))),
            "v3": (kernels["sme_spmm_planes_decode"], v3[:3] + [cs] + v3[3:])}
        x = torch.zeros((8, K), device=dev)
        x[0] = torch.randn(K, device=dev)
        us = {}
        with quiet():
            for be, (fn, args) in calls.items():
                us[be] = 1e3 * time_ms(lambda: fn(x, *args), flush)
                cache.record(TuneKey(be, 1, K, N, 128, device_kind()), us[be])
        print(f"compile: M = 1 decode kernels at {K}x{N} ({device_kind()}): "
              + ", ".join(f"{be} {t:.1f} us" for be, t in us.items())
              + f" | {card}", flush=True)
    del flush
    cache.save()
    t0 = time.perf_counter()
    measured = plan_model(tree, error_budget=BUDGET, backend="auto",
                          autotune=cache)
    plan_s = time.perf_counter() - t0
    moved = 0
    for key, lp in sorted(plan_bytes.layers.items()):
        mp = measured.layers[key]
        moved += lp.backend != mp.backend
        print(f"compile: {key}: by bytes ({lp.n_bits}, {lp.window}, "
              f"{lp.squeeze}) {lp.backend}, by measured time ({mp.n_bits}, "
              f"{mp.window}, {mp.squeeze}) {mp.backend}", flush=True)
    print(f"compile: the measured plan ({plan_s:.1f}s) moved {moved} of "
          f"{len(plan_bytes.layers)} leaves to another backend; summary "
          f"{measured.summary()}", flush=True)
    return {key: lp.backend for key, lp in sorted(measured.layers.items())}


def compile_phase(dev, card, served):
    """The offline compiler on full-width qwen1.5-0.5b (the serving phase's
    weights, dense): plan, pack and persist a ``.smez`` under ``auto``,
    boot it with ``from_artifact`` and serve the serving phase's 8
    requests through the plan's kernels; then the same under ``v3`` and
    the engine workload with ``spec_depth="auto"`` (each layer's plan
    depth) and without; then malformed operand lists refused on the host
    with the context left usable.  Returns the readings and the launches
    per kernel of the artifact runs."""
    import shutil
    import tempfile
    import repro_torch.core.backend as B
    from repro_torch.models.model import build_model
    t_phase = time.perf_counter()
    cfg = qwen_config()
    api = build_model(cfg, device=dev)
    tree = dense_reference_tree(cfg)
    out, launches = {}, {name: 0 for name in KERNELS}
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="smez-"))
    try:
        # -- auto: the plan's backends, one-shot serving
        path = tmp / "auto.smez"
        plan, out["auto"] = compile_artifact(tree, "auto", path, cfg, card)
        eng, out["auto"]["boot_s"] = boot(api, path, card, served["pack_s"])
        params = eng.params
        del eng
        bes = sorted({lp.backend for lp in plan.layers.values()})
        mine = tuple(k for be in bes for k in KERNELS_OF[be])
        tokens, counts = serve_run(api, params, served["prompts"], "auto",
                                   card, route=("+".join(bes), mine),
                                   label="artifact auto")
        for k in launches:
            launches[k] += counts[k]
        toks, plen = prefill_window(served["prompts"], ONE_SHOT["s_max"])
        for dtype, plain in (("float32", "torch"), ("bfloat16", "plain")):
            api_d = build_model(dataclasses.replace(cfg, dtype=dtype),
                                device=dev)
            lk = api_d.prefill(params, toks, s_max=256, plen=plen)[0]
            if plain == "torch":
                lp = api_d.prefill(params, toks, s_max=256, plen=plen,
                                   backend="torch")[0]
            else:
                with plain_kernels():
                    lp = api_d.prefill(params, toks, s_max=256, plen=plen)[0]
            check(bool(torch.isfinite(lk).all())
                  and lk.shape == (4, cfg.vocab), f"{dtype} logits")
            diff = float((lk - lp).abs().max() / lp.abs().max())
            print(f"compile: {dtype} prefill logits of the auto artifact, "
                  f"kernels vs {plain}: max rel diff {diff:.2e} (tolerance "
                  f"{TOL_LOGITS[dtype]:.0e})", flush=True)
            check(diff <= TOL_LOGITS[dtype], f"{dtype} artifact logits {diff}")
        uniform = all((lp.n_bits, lp.window, lp.squeeze, lp.squeeze_max,
                       lp.reorder) == (8, 3, 1, 0, False)
                      for lp in plan.layers.values())
        same = tokens == served["auto_tokens"]
        print(f"compile: every leaf planned (8, 3, 1): {uniform}; tokens "
              f"equal the serving phase's auto run bitwise: {same}",
              flush=True)
        if uniform:
            check(same, "a (8, 3, 1) plan served other tokens than the "
                        "inline (8, 3, 1) weights")
        del params
        shutil.rmtree(path)
        torch.cuda.empty_cache()

        plan_auto = plan

        # -- v3: the engine with spec at each layer's plan depth, and without
        path = tmp / "v3.smez"
        plan, out["v3"] = compile_artifact(tree, "v3", path, cfg, card)
        eng, out["v3"]["boot_s"] = boot(api, path, card, served["pack_s"])
        params = eng.params
        del eng
        layers = [p for blk in params["blocks"] for p in _v3_params(blk)]
        check(len(layers) == 7 * cfg.n_layers, "v3 artifact: packed linears")
        expect = {id(p): int(p["sme_draft_planes"]) for p in layers}
        depths = {k: lp.draft_planes for k, lp in sorted(plan.layers.items())}
        print(f"compile: v3 draft depths per leaf {depths}", flush=True)
        runs = {}
        for name, spec in (("spec auto", "auto"), ("spec off", None)):
            with spec_depth_spy() as seen:
                r = runs[name] = engine_run(api, params, "v3", spec, True)
            m = r["eng"]._m
            per_pass = 7 * cfg.n_layers
            check(all(q.outcome == "completed" for q in r["reqs"]),
                  f"artifact v3 {name}: incomplete requests")
            check(sum(r["launches"][k] for k in KERNELS_OF["v3"])
                  == per_pass * r["passes"]
                  and all(r["launches"][k] == 0 for k in r["launches"]
                          if k not in KERNELS_OF["v3"]),
                  f"artifact v3 {name}: launches {r['launches']} for "
                  f"{r['passes']} passes")
            for k in launches:
                launches[k] += r["launches"][k]
            rounds = int(m["spec_rounds"].value)
            drafted = m["spec_draft_tokens"].value
            if spec is not None:
                check(rounds > 0, "artifact v3: no spec round")
                check(r["draft_launches"]
                      == per_pass * ENGINE["spec_len"] * rounds,
                      f"artifact v3: draft passes launched "
                      f"{r['draft_launches']} decode kernels over {rounds} "
                      f"rounds")
                check(len(seen) == r["draft_launches"]
                      and all(d is not None and d == expect[i]
                              for i, d in seen),
                      "artifact v3: a draft dispatch did not resolve its "
                      "layer's plan depth")
            n_tok = sum(len(q.out_tokens) for q in r["reqs"])
            print(f"compile: engine[v3 artifact, {name}]: {r['steps']} "
                  f"steps, {r['passes']} passes, {n_tok} tokens in "
                  f"{r['wall']:.2f}s = {n_tok / r['wall']:.2f} tokens/s; "
                  f"spec rounds {rounds}, accepted "
                  f"{int(m['spec_accepted'].value)} of {int(drafted)}; "
                  f"draft-pass decode launches {r['draft_launches']}, "
                  f"dispatches at plan depth {len(seen)}; launches "
                  f"{r['launches']} | {card}", flush=True)
        greedy = [[q.out_tokens for q in r["reqs"] if q.temperature == 0]
                  for r in runs.values()]
        check(greedy[0] == greedy[1],
              "artifact v3: greedy tokens differ with and without spec")
        print("compile: v3 artifact greedy tokens identical with spec at "
              "the plan depths and without", flush=True)
        out["v3"]["draft_launches"] = runs["spec auto"]["draft_launches"]
        flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32, device=dev)
        full_ms, plan_ms = draft_layer_ms(params, "plan", flush)
        del flush
        out["v3"].update(layer_full_ms=full_ms, layer_draft_ms=plan_ms)
        print(f"compile: v3 artifact decode kernel per model layer at M = 8: "
              f"full {full_ms:.4f} ms, at the plan depths {plan_ms:.4f} ms "
              f"({plan_ms / full_ms:.3f}x) | {card}", flush=True)

        # -- malformed lists are refused on the host; the card goes on
        p = params["blocks"][0]["mlp"]["wi"]["w"]
        nr, L = p["sme_codes"].shape[0], p["sme_v3_rowid"].shape[1]
        for key, value, what in (("sme_v3_rowid", nr, "rowid"),
                                 ("sme_v3_nnz", L + 1, "nnz")):
            bad = dict(p)
            bad[key] = p[key].clone()
            bad[key].view(-1)[0] = value
            try:
                B.validate_operands(bad, "v3")
            except ValueError as err:
                print(f"compile: malformed {what} refused: {err}", flush=True)
            else:
                raise AssertionError(f"malformed {what} was not refused")
        x = torch.randn((4, p["sme_sign"].shape[-2]), device=dev)
        y = B.sme_apply(x, p, "v3")
        torch.cuda.synchronize()
        with plain_kernels():
            yp = B.sme_apply(x, p, "v3")
        err = float((y - yp).abs().max())
        check(bool(torch.isfinite(y).all())
              and err <= TOL_PLAIN * float(yp.abs().max()),
              f"launch after a refused list: |kernel - plain| {err}")
        print(f"compile: a launch on good operands after the refusals: "
              f"|kernel - plain| {err:.2e}", flush=True)
        del params
        torch.cuda.empty_cache()
        out["measured_plan"] = measured_replan(dev, tree, plan_auto, tmp,
                                               card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"compile: phase {time.perf_counter() - t_phase:.1f}s", flush=True)
    return out, launches


# ------------------------------------------------------------- training
#: the train phase (``launch/train.py`` in-process, qwen1.5-0.5b at full
#: width and :data:`QWEN_LAYERS` deep): steps at ``--micro 1`` (its
#: checkpoint every TRAIN_STEPS - 1 steps, so the last step is saved),
#: then one at ``--micro 2`` resumed from it
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 10, 8, 256
#: steps of the paused timing window (the trained model, fresh batches)
TRAIN_TIMED = 5
#: the overfit: one fixed batch, AdamW at a constant rate (clip 1.0)
OVERFIT_BATCH, OVERFIT_STEPS, OVERFIT_LR = 4, 30, 1e-3
#: the trained model served: the first PROMPT_TOKENS of each overfit row,
#: MAX_NEW greedy tokens
PROMPT_TOKENS, MAX_NEW = 64, 32
#: ``compile --ckpt`` flags of the train phase: analytic planning (error
#: bounds per candidate, no trial compressions), no reordering, and a
#: budget just above the (8, 3, 1) candidate's bound (0.0664) and below
#: the weighted error of moving qwen's smallest leaf to (6, 3, 1) (0.0673
#: at full width), so ``auto`` and ``v3`` plan every leaf (8, 3, 1) and
#: their artifacts hold the same weights (at other budgets the two
#: backends' bytes price the candidates apart)
TRAIN_COMPILE = ("--measure", "analytic", "--budget", "0.0665",
                 "--no-reorder")


def paused_s() -> float:
    """Seconds the packing pool has been paused so far (0 without one)."""
    return getattr(getattr(quiet, "__self__", None), "paused_s", 0.0)


def same_tree(a, b, what):
    """Every leaf of two trees (numpy or tensors) bitwise equal."""
    from repro_torch.tree import flatten
    fa, fb = flatten(a), flatten(b)
    check(list(fa) == list(fb), f"{what}: leaf names differ")
    for k in fa:
        x, y = (t.detach().cpu().numpy() if torch.is_tensor(t)
                else np.asarray(t) for t in (fa[k], fb[k]))
        check(x.dtype == y.dtype and np.array_equal(x, y),
              f"{what}: leaf {k} differs")
    return len(fa)


def train_phase(dev, card):
    """Training on the card through ``launch/train.py``'s main path, a
    bitwise checkpoint round trip, an overfit, then the trained params
    saved alone, compiled with ``compile --ckpt`` under ``auto`` and
    ``v3`` and served from both artifacts.  Returns the readings and the
    serving runs' launches per kernel."""
    import shutil
    import tempfile
    from repro_torch.data import lm_batches
    from repro_torch.launch import compile as launch_compile
    from repro_torch.launch import train as launch_train
    from repro_torch.optim import adamw
    from repro_torch.serve import ServeEngine
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import make_train_step
    from repro_torch.convert import to_reference
    t_phase, p_phase = time.perf_counter(), paused_s()
    out, launches = {}, {name: 0 for name in KERNELS}
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="train-"))
    try:
        argv = ["--arch", "qwen1.5-0.5b", "--n-layers", str(QWEN_LAYERS),
                "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
                "--ckpt-dir", str(tmp / "run"),
                "--ckpt-every", str(TRAIN_STEPS - 1)]
        print(f"train: qwen1.5-0.5b at full width, {QWEN_LAYERS} of 24 "
              f"layers, through launch/train.py: {TRAIN_STEPS} steps of "
              f"{TRAIN_BATCH} x {TRAIN_SEQ} (lm_batches, AdamW, cosine), "
              f"async checkpoints", flush=True)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        run = launch_train.main(argv + ["--steps", str(TRAIN_STEPS)])
        out["train_s"] = time.perf_counter() - t0
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        losses = [run["losses"][i] for i in range(TRAIN_STEPS)]
        check(all(np.isfinite(losses)), f"train losses {losses}")
        out["losses"] = [losses[0], losses[-1]]
        live = run["state_tree"](run["params"], run["opt_state"])
        t0 = time.perf_counter()
        saved = ckpt.restore(tmp / "run", None, live)
        out["restore_s"] = time.perf_counter() - t0
        n = same_tree(saved, live, "restored checkpoint vs live state")
        del saved, live
        print(f"train: {TRAIN_STEPS} steps in {out['train_s']:.1f}s, loss "
              f"{losses[0]:.4f} -> {losses[-1]:.4f}, peak "
              f"{out['peak_gib']:.2f} GiB; step {TRAIN_STEPS - 1}'s "
              f"checkpoint restored in {out['restore_s']:.2f}s, {n} leaves "
              f"(params, m, v) bitwise the live state | {card}", flush=True)
        run2 = launch_train.main(argv + ["--steps", str(TRAIN_STEPS + 1),
                                         "--micro", "2", "--resume"])
        l2 = run2["losses"][TRAIN_STEPS]
        check(run2["step0"] == TRAIN_STEPS and np.isfinite(l2),
              f"--micro 2 --resume: step0 {run2['step0']}, loss {l2}")
        print(f"train: resumed at step {TRAIN_STEPS} with --micro 2: loss "
              f"{l2:.4f}", flush=True)
        api, cfg, params = run2["api"], run2["cfg"], run2["params"]
        del run, run2

        # the step's time: a paused window of fresh batches
        opt = adamw(OVERFIT_LR)
        state = opt.init(params)
        step = make_train_step(api.train_loss, opt, 1)
        data = lm_batches(cfg.vocab, TRAIN_BATCH, TRAIN_SEQ, seed=SEED + 5)
        batches = [next(data) for _ in range(TRAIN_TIMED + 1)]
        params, state, _ = step(params, state, 0, batches[0])
        torch.cuda.synchronize()
        with quiet():
            t0 = time.perf_counter()
            for i, b in enumerate(batches[1:]):
                params, state, _ = step(params, state, i + 1, b)
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t0) / TRAIN_TIMED
        out["step_ms"] = dt * 1e3
        out["tokens_per_s"] = TRAIN_BATCH * TRAIN_SEQ / dt
        print(f"train: {out['step_ms']:.1f} ms per step of {TRAIN_BATCH} x "
              f"{TRAIN_SEQ} (forward, backward, AdamW; {TRAIN_TIMED} steps, "
              f"pool paused) = {out['tokens_per_s']:.0f} training tokens/s "
              f"| {card}", flush=True)

        # the overfit: one fixed batch
        fixed = next(lm_batches(cfg.vocab, OVERFIT_BATCH, TRAIN_SEQ,
                                seed=SEED + 6))
        opt = adamw(OVERFIT_LR)
        state = opt.init(params)
        step = make_train_step(api.train_loss, opt, 1)
        fit = []
        for i in range(OVERFIT_STEPS):
            params, state, loss = step(params, state, i, fixed)
            fit.append(float(loss))
        # the mesh training phase (5a'') starts from the overfit's state
        fit_state = (params, state)
        del state
        check(all(np.isfinite(fit)), f"overfit losses {fit}")
        check(fit[-1] < fit[0] / 2, f"overfit: the loss went {fit[0]:.4f} "
              f"-> {fit[-1]:.4f}, not below half")
        out["overfit"] = [fit[0], fit[-1]]
        print(f"train: overfit one {OVERFIT_BATCH} x {TRAIN_SEQ} batch for "
              f"{OVERFIT_STEPS} steps: loss {fit[0]:.4f} -> {fit[-1]:.4f}",
              flush=True)

        # the params alone, compiled from the checkpoint under auto and v3
        t0 = time.perf_counter()
        ckpt.save(tmp / "params", OVERFIT_STEPS, to_reference(params))
        out["save_s"] = time.perf_counter() - t0
        del params
        free_card()
        print(f"train: params saved alone (checkpoint.save) in "
              f"{out['save_s']:.2f}s", flush=True)
        served = {}
        prompts = [np.asarray(r[:PROMPT_TOKENS]) for r in fixed["tokens"]]
        for be, want in (("auto", "v2"), ("v3", "v3")):
            path = tmp / f"{be}.smez"
            t0 = time.perf_counter()
            plan = launch_compile.main(
                ["--arch", "qwen1.5-0.5b", "--n-layers", str(QWEN_LAYERS),
                 "--ckpt", str(tmp / "params"), "--backend", be, "--out",
                 str(path), *TRAIN_COMPILE])
            compile_s = time.perf_counter() - t0
            check(all((lp.n_bits, lp.window, lp.squeeze, lp.backend)
                      == (8, 3, 1, want) for lp in plan.layers.values()),
                  f"compile --ckpt {be}: not every leaf (8, 3, 1) -> {want}")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params = ServeEngine.from_artifact(api, path, **ONE_SHOT).params
            torch.cuda.synchronize()
            boot_s = time.perf_counter() - t0
            print(f"train: compile --ckpt --backend {be}: {compile_s:.1f}s, "
                  f"every leaf (8, 3, 1) -> {want}; booted in {boot_s:.2f}s",
                  flush=True)
            tokens, counts = serve_run(
                api, params, prompts, be, card, label=f"trained {be}",
                route=(want, KERNELS_OF[want]), max_new=MAX_NEW)
            for k in launches:
                launches[k] += counts[k]
            served[be] = (params, tokens)
            out[be] = dict(compile_s=compile_s, boot_s=boot_s)
        check(served["auto"][1] == served["v3"][1],
              "the trained artifacts served different tokens under v2 and v3")
        toks, plen = prefill_window(prompts, ONE_SHOT["s_max"])
        api32 = type(api)(dataclasses.replace(cfg, dtype="float32"), dev)
        lk = {be: api32.prefill(p, toks, s_max=ONE_SHOT["s_max"],
                                plen=plen)[0] for be, (p, _) in served.items()}
        check(bool(torch.equal(lk["auto"], lk["v3"])),
              f"trained f32 prefill logits differ between v2 and v3: "
              f"{mismatch(lk['auto'], lk['v3'])}")
        for be, (p, _) in served.items():
            with plain_kernels():
                lp = api32.prefill(p, toks, s_max=ONE_SHOT["s_max"],
                                   plen=plen)[0]
            check(bool(torch.isfinite(lk[be]).all())
                  and lk[be].shape == (4, cfg.vocab), f"{be} logits")
            diff = float((lk[be] - lp).abs().max() / lp.abs().max())
            check(diff <= TOL_LOGITS["float32"],
                  f"trained {be} logits vs plain: {diff}")
            out[be]["logits_rel_plain"] = diff
        tokens = served["v3"][1]
        out["distinct"] = len({t for row in tokens for t in row})
        out["matches"] = sum(int(t == fixed["tokens"][i][PROMPT_TOKENS + j])
                             for i, row in enumerate(tokens)
                             for j, t in enumerate(row))
        print(f"train: v2 (auto) and v3 artifacts: identical tokens, f32 "
              f"prefill logits v2 == v3 bitwise, vs the plain versions "
              f"{out['auto']['logits_rel_plain']:.2e} / "
              f"{out['v3']['logits_rel_plain']:.2e}; {out['distinct']} "
              f"distinct tokens served, {out['matches']} of "
              f"{len(tokens) * MAX_NEW} equal to the batch's continuation",
              flush=True)
        out["mesh"], mesh_launches = mesh_phase(
            dev, card, tmp, cfg, prompts,
            {be: tokens for be, (_, tokens) in served.items()},
            (toks, plen, lk))
        del served, lk
        free_card()
        out["mesh_train"] = mesh_train_phase(dev, card, tmp, cfg,
                                             *fit_state)
        del fit_state
        free_card()
        out["mesh_train_moe"] = mesh_train_moe_phase(dev, card, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    out["paused_s"] = paused_s() - p_phase
    print(f"train: phase {out['phase_s']:.1f}s, the pool paused "
          f"{out['paused_s']:.1f}s of it", flush=True)
    return out, launches, mesh_launches


# ---------------------------------------------------------------- the mesh
#: the mesh phase's gloo runs: (the trained artifact's backend, (data,
#: model)), each over the same four ranks sharing the one card
MESH_RUNS = (("v3", (2, 2)), ("v3", (1, 4)), ("auto", (2, 2)))
MESH_RANKS = 4
#: new tokens per request of the mesh runs: the first of the train
#: phase's :data:`MAX_NEW` (greedy, so a prefix of them)
MESH_NEW = 16


def tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(map(tree_bytes, tree.values()))
    if isinstance(tree, (list, tuple)):
        return sum(map(tree_bytes, tree))
    return tree.numel() * tree.element_size()


def cache_kinds(caches) -> dict:
    """Bytes of an enc-dec engine's caches by kind, its ``self`` and
    ``cross`` K/V summed over the layers (empty for another family's)."""
    out = {}
    for layer in caches:
        for kind in ("self", "cross"):
            if isinstance(layer.get(kind), dict):
                out[kind] = out.get(kind, 0) + tree_bytes(layer[kind])
    return out


def kinds_mib(kinds) -> str:
    """``cache_kinds`` as a log phrase ("" when empty)."""
    return "".join(f", {k} K/V {b / 2 ** 20:.1f} MiB" for k, b in
                   kinds.items())


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def mesh_serve(api, path, backend, mesh, prompts, max_new):
    """Serve ``prompts`` once from the artifact at ``path`` on ``mesh``:
    (tokens, the engine's stats, its params' bytes, launches per
    kernel), the counts set to 0 just before the run."""
    from repro_torch.serve import Request, ServeEngine
    eng = ServeEngine.from_artifact(api, path, mesh=mesh, backend=backend,
                                    **ONE_SHOT)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    sync(mesh.device)
    zero_counts()
    with quiet():              # its ms per decode step is a reading
        stats = eng.run(reqs, max_steps=200)
        sync(mesh.device)
    launches = {name: fn.launches for name, fn in wrappers().items()}
    check(stats["completed"] == len(reqs) and eng.rank_mismatches == 0,
          f"mesh {mesh.data}x{mesh.model} {backend}: completed "
          f"{stats['completed']}, rank mismatches {eng.rank_mismatches}")
    return ([r.out_tokens for r in reqs], stats, tree_bytes(eng.params),
            launches, eng)


def mesh_rank(rank, world, store, tmp, cfg, prompts, window, device,
              max_new):
    """One of the four gloo ranks on the one card: probe gloo's CUDA
    collectives, then serve :data:`MESH_RUNS` from the trained artifacts
    and compute the f32 prefill logits of ``window`` on each mesh; the
    results go to ``tmp/mesh{rank}.pt``."""
    import os
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.model import build_model
    from repro_torch.parallel.policy import use_policy
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    tmp = pathlib.Path(tmp)
    out = {"runs": {}}
    x = torch.full((4,), float(rank), device=dev)
    for what, fn in (("all_gather", lambda: dist.all_gather(
            [torch.empty_like(x) for _ in range(world)], x)),
            ("broadcast", lambda: dist.broadcast(x, src=0))):
        try:
            fn()
            out[what] = "native"
        except Exception as e:                      # noqa: BLE001
            out[what] = f"refused ({type(e).__name__}: {str(e)[:80]})"
    api = build_model(cfg, device=dev)
    api32 = build_model(dataclasses.replace(cfg, dtype="float32"), dev)
    (tmp / f"ready{rank}").touch()
    while not (tmp / "go").exists():
        time.sleep(0.05)
    for backend, shape in MESH_RUNS:
        mesh = make_local_mesh(*shape, device=dev)
        tokens, stats, nbytes, launches, eng = mesh_serve(
            api, tmp / f"{backend}.smez", backend, mesh, prompts, max_new)
        toks, plen = window
        with use_policy(eng.policy):
            logits = api32.prefill(eng.params, toks, s_max=ONE_SHOT["s_max"],
                                   plen=plen)[0].cpu()
        out["runs"][(backend, shape)] = dict(
            tokens=tokens, bytes=nbytes, launches=launches,
            backend=stats["backend"],
            ms=stats["decode_s"] / stats["decode_steps"] * 1e3,
            logits=logits if rank == 0 else None)
        del eng
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    out["jax"] = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "repro"))
    torch.save(out, tmp / f"mesh{rank}.pt")
    dist.destroy_process_group()
    os._exit(0)


def shard_check(dev, card):
    """The four wrappers on two shards of qwen's 1024x2816 (22 column
    tiles, 11 per shard, as the mesh places them) against the whole
    launch, bitwise, at M = 8 and 512 (comparison launches: not counted
    as the path's)."""
    from repro_torch.core.backend import sme_apply
    from repro_torch.core.integrate import convert_params_to_sme
    from repro_torch.launch.mesh import Mesh
    from repro_torch.parallel.sharding import place_tree
    w = np.random.default_rng(SEED + 9).standard_normal(
        (1024, 2816), dtype=np.float32) * np.float32(1 / 32)
    tree = convert_params_to_sme({"wi": {"w": w}}, squeeze=1, backend="all",
                                 device="cpu")
    meshes = [Mesh(1, 2, rank=r, device=dev, groups={"world": None})
              for r in range(2)]
    whole_w = place_tree(tree, Mesh(1, 1, device=dev))["wi"]["w"]
    shards = [place_tree(tree, m)["wi"]["w"] for m in meshes]
    wr = wrappers()
    for m in (8, 512):
        x = torch.as_tensor(np.random.default_rng(m).standard_normal(
            (m, 1024), dtype=np.float32), device=dev)
        for backend in ("v1", "v2", "v3"):
            name = {"v1": "sme_spmm", "v2": "sme_spmm6"}.get(
                backend, "sme_spmm_planes_decode" if m == 8
                else "sme_spmm_planes")
            n0 = wr[name].launches
            whole = sme_apply(x, whole_w, backend)
            got = torch.cat([sme_apply(x, sw, backend) for sw in shards],
                            dim=-1)
            check(wr[name].launches == n0 + 3, f"shard check: {name} "
                  f"launched {wr[name].launches - n0} times, not 3")
            check(bool(torch.equal(got, whole)),
                  f"{name} at M = {m}: two shards of 11 column tiles differ "
                  f"from the whole launch: {mismatch(got, whole)}")
    print(f"mesh: the four kernels on two shards of qwen's 1024x2816 (11 "
          f"of its 22 column tiles each) equal the whole launch bitwise at "
          f"M = 8 and 512 | {card}", flush=True)


def mesh_phase(dev, card, tmp, cfg, prompts, want, window):
    """Mesh serving of the trained artifacts for :data:`MESH_NEW` tokens:
    the 1x1 mesh through an NCCL group of world size 1 in this process,
    then :data:`MESH_RUNS` on four gloo ranks sharing the card (correctness only: gloo carries CUDA tensors through
    host memory).  Every rank's tokens must equal the first of the train
    phase's 1x1 tokens and rank 0's f32 prefill logits its logits
    bitwise.  Returns the readings and the launches per kernel of every
    mesh run (the ranks' summed)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.model import build_model
    t_phase = time.perf_counter()
    out, launches = {"runs": {}}, {name: 0 for name in KERNELS}
    want = {be: [t[:MESH_NEW] for t in toks] for be, toks in want.items()}
    shard_check(dev, card)
    api = build_model(cfg, device=dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"file://{tmp}/nccl", rank=0,
                            world_size=1)
    try:
        mesh = make_local_mesh(1, 1, device=dev)
        one = {}
        for be in ("v3", "auto"):
            tokens, stats, one[be], counts, eng = mesh_serve(
                api, tmp / f"{be}.smez", be, mesh, prompts, MESH_NEW)
            del eng
            check(tokens == want[be], f"mesh 1x1 over NCCL ({be}): tokens "
                  f"differ from the train phase's serving")
            for k in launches:
                launches[k] += counts[k]
            out["runs"][f"{be} 1x1 nccl"] = dict(
                ms=stats["decode_s"] / stats["decode_steps"] * 1e3,
                bytes=one[be])
            print(f"mesh[1x1 {be}]: an NCCL group of world size 1 "
                  f"({mesh.backend}): the train phase's tokens, "
                  f"{out['runs'][f'{be} 1x1 nccl']['ms']:.2f} ms per decode "
                  f"step, {one[be] / 2 ** 20:.1f} MiB of params | {card}",
                  flush=True)
    finally:
        dist.destroy_process_group()
    free_card()
    ctx = torch.multiprocessing.start_processes(
        mesh_rank, args=(MESH_RANKS, str(tmp / "gloo"), str(tmp), cfg,
                         prompts, window[:2], str(dev), MESH_NEW),
        nprocs=MESH_RANKS, join=False, start_method="spawn")
    try:
        while not all((tmp / f"ready{r}").exists()
                      for r in range(MESH_RANKS)):
            check(all(p.is_alive() for p in ctx.processes),
                  "a mesh rank died before serving")
            time.sleep(0.1)
        t_ready = time.perf_counter()
        # the pool pauses while the ranks serve: their ms are readings
        with quiet():
            (tmp / "go").touch()
            while not ctx.join(timeout=1):
                pass
        serve_s = time.perf_counter() - t_ready
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    ranks = [torch.load(tmp / f"mesh{r}.pt", weights_only=False)
             for r in range(MESH_RANKS)]
    print(f"mesh: gloo on CUDA tensors here: all_gather "
          f"{ranks[0]['all_gather']}, broadcast {ranks[0]['broadcast']}",
          flush=True)
    check(all(r[c] == "native" for r in ranks
              for c in ("all_gather", "broadcast")),
          "gloo refused a CUDA tensor: the ranks cannot share the card")
    toks_w, plen_w, lk = window
    for backend, shape in MESH_RUNS:
        key = (backend, shape)
        label = f"{backend} {shape[0]}x{shape[1]}"
        runs = [r["runs"][key] for r in ranks]
        for i, run in enumerate(runs):
            check(run["tokens"] == want[backend],
                  f"mesh {label}: rank {i}'s tokens differ from 1x1")
            for k in launches:
                launches[k] += run["launches"][k]
        path = RUNS[backend][1]
        check(all(sum(r["launches"][k] for r in runs) > 0 for k in path),
              f"mesh {label}: a kernel of the path never launched")
        got = runs[0]["logits"]
        ref = lk[backend].cpu()
        check(bool(torch.equal(got, ref)), f"mesh {label}: rank 0's f32 "
              f"prefill logits differ from 1x1: {mismatch(got, ref)}")
        ms = [run["ms"] for run in runs]
        nbytes = [run["bytes"] for run in runs]
        out["runs"][label] = dict(ms=ms, bytes=nbytes, bytes_1x1=one[backend],
                                  launches={k: sum(r["launches"][k]
                                                   for r in runs)
                                            for k in KERNELS})
        mib = ", ".join(f"{b / 2 ** 20:.1f}" for b in nbytes)
        frac = ", ".join(f"{b / one[backend]:.3f}" for b in nbytes)
        print(f"mesh[{label}]: 4 ranks, every rank's tokens == 1x1, rank "
              f"0's f32 prefill logits == 1x1 bitwise; params per rank "
              f"{mib} MiB against 1x1's {one[backend] / 2 ** 20:.1f} MiB "
              f"({frac}); {', '.join(f'{t:.1f}' for t in ms)} ms per decode "
              f"step (gloo, 4 ranks on one card: correctness only) | {card}",
              flush=True)
    check(all(r["jax"] == [] for r in ranks), "a mesh rank imported jax")
    out["serve_s"] = serve_s
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"mesh: phase {out['phase_s']:.1f}s of its 90 s budget "
          f"({serve_s:.1f}s of gloo serving, the pool paused)", flush=True)
    return out, launches


# ------------------------------------------------------- mesh training
#: phase 5a'': the meshes the gloo ranks train on, each over the same
#: four ranks sharing the one card
MESH_TRAIN = ((2, 2), (1, 4), (4, 1))
#: the mesh whose params and AdamW state after step 1 are saved through
#: the mesh checkpoint, and the mesh that restores them in place of its
#: own step 1 and takes step 2 (an elastic reshard)
MESH_SAVE, MESH_RESUME = (2, 2), (4, 1)
#: steps of every run, from the overfit's params and AdamW state on fresh
#: batches of the train phase's global 8 x 256
MESH_TRAIN_STEPS = 2
#: a loss's and the pre-clip norm's relative difference to 1x1's, and a
#: tree's (params, m, v) largest difference over its largest magnitude
TOL_MESH_LOSS, TOL_MESH_NORM, TOL_MESH_TREE = 1e-5, 1e-6, 1e-5


def mesh_train_steps(api, params, state, batches, mesh, ef=False,
                     first=0, save_to=None):
    """Steps ``first``, ... of :data:`MESH_TRAIN_STEPS` (one per batch)
    of ``make_train_step(mesh=)`` with the overfit's AdamW from its step
    count on: (the losses, the pre-clip norms, ms per step, params,
    state, with ``ef`` the first step's gradient shards of layer 0).
    With ``save_to``, the params and AdamW state after the first step
    are saved there through the mesh checkpoint (untimed)."""
    from repro_torch.optim import adamw, global_norm
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import make_train_step
    norms, kept = [], {}
    opt = adamw(OVERFIT_LR)

    def update(grads, state, params, i):
        norms.append(global_norm(grads))
        if ef and not kept:
            kept["g"] = grads["blocks"][0]
        return opt.update(grads, state, params, i)
    step = make_train_step(api.train_loss,
                           dataclasses.replace(opt, update=update), 1,
                           mesh=mesh)
    losses, ms, save_s = [], [], None
    for i, batch in enumerate(batches[first:], first):
        sync(mesh.device)
        t0 = time.perf_counter()
        params, state, loss = step(params, state, OVERFIT_STEPS + i, batch)
        sync(mesh.device)
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        if save_to is not None and i == first:
            t0 = time.perf_counter()
            ckpt.save(save_to, OVERFIT_STEPS + i + 1,
                      {"params": params, "opt": state}, mesh=mesh)
            save_s = time.perf_counter() - t0
    return dict(losses=[float(x) for x in losses],
                norms=[float(x) for x in norms], ms=ms, params=params,
                state=state, g=kept.get("g"), save_s=save_s)


def cut_index(cut) -> tuple:
    """The index of this rank's shard in a leaf of ``cut``'s shape."""
    idx = []
    for dim, ax in zip(cut.shape, cut.spec):
        n = cut.mesh.shape[ax] if ax else 1
        i = cut.mesh.index(ax) if n > 1 else 0
        idx.append(slice(i * dim // n, (i + 1) * dim // n))
    return tuple(idx)


def warm_up(dev) -> None:
    """One plain train step of qwen's 2-layer smoke config on ``dev``: a
    fresh process's first launches (library handles, kernel modules)
    before its timed steps."""
    from repro_torch.configs import ARCHS, scale_down
    from repro_torch.core.integrate import to_torch
    from repro_torch.data import lm_batches
    from repro_torch.models.model import build_model, init_params
    from repro_torch.optim import adamw
    from repro_torch.train import make_train_step
    small = scale_down(ARCHS["qwen1.5-0.5b"], n_layers=2, dtype="float32")
    params = to_torch(init_params(small, np.random.default_rng(SEED)), dev)
    opt = adamw(OVERFIT_LR)
    step = make_train_step(build_model(small, device=dev).train_loss, opt)
    step(params, opt.init(params), 0,
         next(lm_batches(small.vocab, 8, 256, seed=SEED)))
    sync(dev)


def train_rank_start(rank, world, store, device):
    """A spawned training rank's start: the repo's sources importable,
    TF32 off, its device (one intra-op thread on the CPU), the gloo group
    of ``world`` ranks through the file store ``store``; returns the
    device."""
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    return dev


def shard_errs(trees, end, dev) -> dict:
    """{name: the largest difference of this rank's shards of tree
    ``name`` (each carrying its Cut) to the same slices of the whole
    tree ``end[name]``}, taken on ``dev``."""
    from repro_torch.parallel.sharding import cut_of
    from repro_torch.tree import flatten
    errs = {}
    for name, got in trees.items():
        want = flatten(end[name])
        errs[name] = max(float((t - want[k][cut_index(cut_of(t))]
                                .to(dev)).abs().max())
                         for k, t in flatten(got).items())
    return errs


def mesh_train_rank(rank, world, store, tmp, cfg, device):
    """One of the four gloo ranks on the one card: probe gloo's CUDA
    all-reduce, then train :data:`MESH_TRAIN` from ``tmp/start.pt`` and
    hold each rank's shards of the trees after the steps against the same
    slices of the 1x1 run's (``tmp/end.pt``): the gathered trees'
    difference, taken where each part lives; ``ef_allreduce`` over the
    (2, 2) 'data' group on layer 0's gradient.  The results go to
    ``tmp/train{rank}.pt``."""
    import os
    import torch.distributed as dist
    dev = train_rank_start(rank, world, store, device)
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.model import build_model
    from repro_torch.parallel.compress import ef_allreduce, zeros_like_resid
    from repro_torch.parallel.sharding import place_throughput
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.tree import flatten
    tmp = pathlib.Path(tmp)
    out = {"runs": {}}
    x = torch.ones(4, device=dev)
    try:
        dist.all_reduce(x)
        out["all_reduce"] = "native" if float(x[0]) == world else \
            f"wrong sum {float(x[0])}"
    except Exception as e:                          # noqa: BLE001
        out["all_reduce"] = f"refused ({type(e).__name__}: {str(e)[:80]})"
    api = build_model(cfg, device=dev)
    start = torch.load(tmp / "start.pt", mmap=True, weights_only=False)
    t0 = time.perf_counter()
    warm_up(dev)
    out["warm_up"] = time.perf_counter() - t0
    (tmp / f"ready{rank}").touch()
    while not (tmp / "go").exists():
        time.sleep(0.05)
    # written by the phase, while the ranks started, before the go
    end = torch.load(tmp / "end.pt", mmap=True, weights_only=False)
    out["place"], out["compare"] = {}, {}
    saved = tmp / "ckpt"
    for shape in MESH_TRAIN:
        t0 = time.perf_counter()
        mesh = make_local_mesh(*shape, device=dev)
        first = 0
        if shape == MESH_RESUME:
            # MESH_SAVE's step-1 params and AdamW state, resharded
            like = {"params": start["params"],
                    "opt": {k: start[k] for k in ("m", "v")}}
            got = ckpt.restore(saved, None, like, mesh=mesh)
            params, state, first = got["params"], got["opt"], 1
            del got
        else:
            params = place_throughput(start["params"], mesh)
            state = {k: place_throughput(start[k], mesh)
                     for k in ("m", "v")}
        nbytes = tree_bytes(params) + tree_bytes(state)
        sync(dev)
        out["place"][shape] = time.perf_counter() - t0
        run = mesh_train_steps(
            api, params, state, start["batches"], mesh, ef=shape == (2, 2),
            first=first, save_to=saved if shape == MESH_SAVE else None)
        t0 = time.perf_counter()
        errs = shard_errs({"params": run["params"], **run["state"]}, end,
                          dev)
        out["compare"][shape] = time.perf_counter() - t0
        res = dict(losses=run["losses"], norms=run["norms"], ms=run["ms"],
                   bytes=nbytes, errs=errs, first=first,
                   save_s=run["save_s"])
        if run["g"] is not None:
            g = run["g"]
            deq, resid = ef_allreduce(g, zeros_like_resid(g), "data", mesh)
            res["ef"] = {k: {n: x.detach().cpu()
                             for n, x in flatten(t).items()}
                         for k, t in (("g", g), ("deq", deq),
                                      ("resid", resid))}
        out["runs"][shape] = res
        del params, state, run
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    out["jax"] = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "repro"))
    torch.save(out, tmp / f"train{rank}.pt")
    dist.destroy_process_group()
    os._exit(0)


def ef_check(ranks, shape):
    """``ef_allreduce`` over each 'data' group of ``shape`` against the
    reference's formula in numpy from every rank's gradient: the int32
    code sums bitwise, the result within 1 ulp, each rank's residual
    bitwise; returns the number of values checked."""
    data, model = shape
    n = 0
    for r, out in enumerate(ranks):
        group = [d * model + r % model for d in range(data)]
        ef = out["runs"][shape]["ef"]
        for k, got in ef["deq"].items():
            codes, scales = [], []
            for i in group:
                x = ranks[i]["runs"][shape]["ef"]["g"][k].numpy()
                s = np.float32(max(np.abs(x).max(), np.float32(1e-12))
                               / np.float32(127.0))
                q = np.clip(np.round(x / s), -127, 127).astype(np.int8)
                codes.append(q)
                scales.append(s)
                if i == r:
                    want_r = x - q.astype(np.float32) * s
            summed = np.sum(np.stack(codes).astype(np.int32), axis=0)
            scale = np.float32(np.float32(sum(scales, np.float32(0)))
                               / np.float32(data))
            want = summed.astype(np.float32) * scale / np.float32(data)
            got = got.numpy()
            check(np.array_equal(np.rint(got * data / scale).astype(np.int32),
                                 summed),
                  f"ef_allreduce {k} on rank {r}: the int32 sums differ")
            check(bool(np.all(np.abs(got - want) <= np.spacing(
                np.abs(want).astype(np.float32)))),
                  f"ef_allreduce {k} on rank {r}: beyond 1 ulp of the "
                  f"formula")
            check(np.array_equal(ef["resid"][k].numpy(), want_r),
                  f"ef_allreduce {k} on rank {r}: the residual differs")
            n += got.size
    return n


def mesh_train_phase(dev, card, tmp, cfg, params, state):
    """Phase 5a'': :data:`MESH_TRAIN_STEPS` steps from the overfit's
    params and AdamW state on the 1x1 mesh in this process (the
    yardstick), then on :data:`MESH_TRAIN` on four gloo ranks sharing the
    card, the throughput posture in f32 with TF32 off (correctness only:
    gloo carries CUDA tensors through host memory).  Every rank's losses
    must be the same bits, within :data:`TOL_MESH_LOSS` of 1x1's, the
    pre-clip norm within :data:`TOL_MESH_NORM`, the params and m/v after
    the steps within :data:`TOL_MESH_TREE` of each tree's largest
    magnitude, and ``ef_allreduce`` over (2, 2)'s 'data' groups the
    reference's formula.  Returns the readings."""
    from repro_torch.data import lm_batches
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.model import build_model
    from repro_torch.tree import tree_leaves, tree_map
    t_phase = time.perf_counter()
    # a directory of its own: phase 5a' left its ranks' ready and go files
    tmp = tmp / "mesh-train"
    tmp.mkdir()
    cfg = dataclasses.replace(cfg, dtype="float32")
    api = build_model(cfg, device=dev)
    data = lm_batches(cfg.vocab, TRAIN_BATCH, TRAIN_SEQ, seed=SEED + 7)
    batches = [next(data) for _ in range(MESH_TRAIN_STEPS)]
    parts = {}
    t0 = time.perf_counter()
    host = {"params": tree_map(lambda t: t.cpu(), params),
            **{k: tree_map(lambda t: t.cpu(), v) for k, v in state.items()},
            "batches": batches}
    torch.save(host, tmp / "start.pt")
    del host
    parts["write start"] = time.perf_counter() - t0
    with quiet():                # its ms per step are readings
        one = mesh_train_steps(api, params, state, batches,
                               Mesh(1, 1, device=dev))
    end = {"params": one["params"], **one["state"]}
    tops = {k: max(float(t.abs().max()) for t in tree_leaves(v))
            for k, v in end.items()}
    nbytes = tree_bytes(one["params"]) + tree_bytes(one["state"])
    out = {"1x1": dict(losses=one["losses"], norms=one["norms"],
                       ms=one["ms"], bytes=nbytes), "runs": {}}
    del one
    print(f"mesh-train[1x1]: {MESH_TRAIN_STEPS} steps of {TRAIN_BATCH} x "
          f"{TRAIN_SEQ} from the overfit's params and AdamW state (f32, "
          f"TF32 off): losses {out['1x1']['losses']}, pre-clip norms "
          f"{out['1x1']['norms']}, "
          f"{', '.join(f'{t:.1f}' for t in out['1x1']['ms'])} ms per step, "
          f"params + m + v {nbytes / 2 ** 20:.1f} MiB | {card}", flush=True)
    # the ranks start (import, card, warm-up) while this process writes
    # the 1x1 result they are held to
    t_spawn = time.perf_counter()
    ctx = torch.multiprocessing.start_processes(
        mesh_train_rank, args=(MESH_RANKS, str(tmp / "gloo-train"),
                               str(tmp), cfg, str(dev)),
        nprocs=MESH_RANKS, join=False, start_method="spawn")
    try:
        t0 = time.perf_counter()
        torch.save({k: tree_map(lambda t: t.cpu(), v)
                    for k, v in end.items()}, tmp / "end.pt")
        del end
        free_card()
        parts["write end"] = time.perf_counter() - t0
        while not all((tmp / f"ready{r}").exists()
                      for r in range(MESH_RANKS)):
            check(all(p.is_alive() for p in ctx.processes),
                  "a mesh training rank died before training")
            time.sleep(0.1)
        t_ready = time.perf_counter()
        parts["ranks ready"] = t_ready - t_spawn
        # the pool pauses while the ranks train: their ms are readings
        with quiet():
            (tmp / "go").touch()
            while not ctx.join(timeout=1):
                pass
        train_s = time.perf_counter() - t_ready
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    ranks = [torch.load(tmp / f"train{r}.pt", weights_only=False)
             for r in range(MESH_RANKS)]
    print(f"mesh-train: gloo's all_reduce on CUDA tensors here: "
          f"{ranks[0]['all_reduce']}", flush=True)
    check(all(r["all_reduce"] == "native" for r in ranks),
          "gloo refused to all-reduce a CUDA tensor")
    check(all(r["jax"] == [] for r in ranks),
          "a mesh training rank imported jax")
    for shape in MESH_TRAIN:
        label = f"{shape[0]}x{shape[1]}"
        runs = [r["runs"][shape] for r in ranks]
        for i, run in enumerate(runs):
            check(run["losses"] == runs[0]["losses"],
                  f"mesh-train {label}: rank {i}'s losses differ from rank "
                  f"0's")
        first = runs[0]["first"]
        rel = [abs(a / b - 1) for a, b in zip(runs[0]["losses"],
                                             out["1x1"]["losses"][first:])]
        nrel = [abs(a / b - 1) for a, b in zip(runs[0]["norms"],
                                              out["1x1"]["norms"][first:])]
        check(max(rel) <= TOL_MESH_LOSS, f"mesh-train {label}: losses "
              f"{runs[0]['losses']} vs 1x1 {out['1x1']['losses']}")
        check(max(nrel) <= TOL_MESH_NORM, f"mesh-train {label}: pre-clip "
              f"norms {runs[0]['norms']} vs 1x1 {out['1x1']['norms']}")
        errs = {k: max(run["errs"][k] for run in runs) / tops[k]
                for k in tops}
        for k, e in errs.items():
            check(e <= TOL_MESH_TREE, f"mesh-train {label}: {k} differs "
                  f"from 1x1 by {e:.3e} of its largest magnitude")
        frac = [run["bytes"] / out["1x1"]["bytes"] for run in runs]
        out["runs"][label] = dict(losses=runs[0]["losses"],
                                  loss_rel=rel, norm_rel=nrel, tree=errs,
                                  bytes=[run["bytes"] for run in runs],
                                  frac=frac,
                                  ms=[run["ms"] for run in runs])
        how = ""
        if shape == MESH_SAVE:
            out["runs"][label]["save_s"] = runs[0]["save_s"]
            how = (f" (its step-1 params and AdamW state saved through the "
                   f"mesh checkpoint in {runs[0]['save_s']:.2f}s)")
        if first:
            how = (f" (step 2 only: {MESH_SAVE[0]}x{MESH_SAVE[1]}'s step-1 "
                   f"checkpoint restored onto this mesh in "
                   f"{ranks[0]['place'][shape]:.2f}s)")
        print(f"mesh-train[{label}]{how}: 4 ranks, every rank's losses the "
              f"same bits; vs 1x1: losses {max(rel):.2e}, pre-clip norm "
              f"{max(nrel):.2e} relative, params / m / v "
              f"{errs['params']:.2e} / {errs['m']:.2e} / {errs['v']:.2e} "
              f"of each tree's largest magnitude; params + m + v per rank "
              f"{', '.join(f'{b / 2 ** 20:.1f}' for b in out['runs'][label]['bytes'])} "
              f"MiB against 1x1's {out['1x1']['bytes'] / 2 ** 20:.1f} MiB "
              f"({', '.join(f'{f:.3f}' for f in frac)}); ms per step per "
              f"rank {[[round(t, 1) for t in run['ms']] for run in runs]} "
              f"(gloo, 4 ranks on one card: correctness only) | {card}",
              flush=True)
    n = ef_check(ranks, (2, 2))
    out["ef_values"] = n
    print(f"mesh-train: ef_allreduce over the 'data' groups of 2x2 on "
          f"layer 0's gradient ({n} values over 4 ranks): the int32 code "
          f"sums bitwise, within 1 ulp of the formula, residuals bitwise",
          flush=True)
    out["train_s"] = train_s
    out["parts"] = parts
    parts["warm-up (rank 0)"] = ranks[0]["warm_up"]
    for k in ("place", "compare"):
        parts[f"{k} (rank 0)"] = sum(ranks[0][k].values())
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"mesh-train: phase {out['phase_s']:.1f}s of its 60 s budget "
          f"({train_s:.1f}s of gloo training, the pool paused; "
          f"{', '.join(f'{k} {v:.1f}s' for k, v in parts.items())})",
          flush=True)
    return out


# ------------------------------------------- mesh training of MoE and MLA
#: phase 5a''': deepseek-v2-lite-16b at phase 7's depth (``first0`` and
#: one MoE layer) trains one step on these meshes, each over the same
#: four gloo ranks sharing the one card
MOE_MESH_TRAIN = ((2, 2), (1, 4))
#: its seconds' budget
MOE_MESH_BUDGET = 120


@contextlib.contextmanager
def route_spy():
    """Every ``moe_apply`` call's top-k expert indices [G, S, k] (the
    ones its dispatch takes), on the host, in call order."""
    from repro_torch.models import moe
    seen = []
    inner = moe._group_dispatch

    def spy(xg, idx, *rest):
        seen.append(idx.detach().cpu())
        return inner(xg, idx, *rest)
    moe._group_dispatch = spy
    try:
        yield seen
    finally:
        moe._group_dispatch = inner


def moe_mesh_config():
    """deepseek-v2-lite-16b at full width, phase 7's depth, f32."""
    return dataclasses.replace(slice_config("deepseek"), dtype="float32")


def moe_train_rank(rank, world, store, tmp, cfg, device):
    """One of the four gloo ranks of phase 5a''': the initial params
    restored from ``tmp/init`` (the 1x1 run's checkpoint) onto each of
    :data:`MOE_MESH_TRAIN` as this rank's throughput shards, AdamW's
    state cut like them, one step, and the shards of the trees after it
    held against the same slices of the 1x1 run's (``tmp/end_*.pt``).
    Rank 0 keeps its routes.  The results go to ``tmp/moe{rank}.pt``."""
    import os
    import torch.distributed as dist
    dev = train_rank_start(rank, world, store, device)
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw
    from repro_torch.train import checkpoint as ckpt
    tmp = pathlib.Path(tmp)
    api = build_model(cfg, device=dev)
    t0 = time.perf_counter()
    warm_up(dev)
    out = {"runs": {}, "warm_up": time.perf_counter() - t0, "restore": {},
           "compare": {}}
    (tmp / f"ready{rank}").touch()
    while not (tmp / "go").exists():
        time.sleep(0.05)
    batches = torch.load(tmp / "batches.pt", weights_only=False)
    end = {k: torch.load(tmp / f"end_{k}.pt", mmap=True,
                         weights_only=False) for k in ("params", "m", "v")}
    for shape in MOE_MESH_TRAIN:
        t0 = time.perf_counter()
        mesh = make_local_mesh(*shape, device=dev)
        params = ckpt.restore(tmp / "init", None, end["params"], mesh=mesh)
        state = adamw(OVERFIT_LR).init(params)
        nbytes = tree_bytes(params) + tree_bytes(state)
        sync(dev)
        out["restore"][shape] = time.perf_counter() - t0
        with route_spy() as routes:
            run = mesh_train_steps(api, params, state, batches, mesh)
        del params, state
        t0 = time.perf_counter()
        errs = shard_errs({"params": run["params"], **run["state"]}, end,
                          dev)
        out["compare"][shape] = time.perf_counter() - t0
        out["runs"][shape] = dict(losses=run["losses"], norms=run["norms"],
                                  ms=run["ms"], bytes=nbytes, errs=errs,
                                  routes=routes if rank == 0 else None)
        del run
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    out["jax"] = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "repro"))
    torch.save(out, tmp / f"moe{rank}.pt")
    dist.destroy_process_group()
    os._exit(0)


def mesh_train_moe_phase(dev, card, tmp):
    """Phase 5a''': deepseek-v2-lite-16b at full width and phase 7's
    depth, dense, f32 with TF32 off.  Its initial params (numpy, from a
    seed) are written once with ``checkpoint.save``; the 1x1 step runs in
    this process (the yardstick: one step of :data:`TRAIN_BATCH` x
    :data:`TRAIN_SEQ`); four gloo ranks sharing the card restore the
    checkpoint onto each of :data:`MOE_MESH_TRAIN` (``restore(mesh=)``)
    and take the same step under the throughput posture: expert-parallel
    routed experts, the shared experts, MLA and ``first0`` column- and
    row-parallel, FSDP over 'data', a vocab-parallel loss.  Every rank's
    loss must be the same bits and within :data:`TOL_MESH_LOSS` of 1x1's,
    the pre-clip norm within :data:`TOL_MESH_NORM`, the params and m/v
    after the step within :data:`TOL_MESH_TREE` of each tree's largest
    magnitude; the routes rank 0 took that differ from 1x1's are counted
    (a reading).  Returns the readings."""
    from repro_torch.core.integrate import to_torch
    from repro_torch.data import lm_batches
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.model import build_model, init_params
    from repro_torch.optim import adamw
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.tree import tree_leaves, tree_map
    t_phase = time.perf_counter()
    tmp = tmp / "mesh-train-moe"
    tmp.mkdir()
    cfg = moe_mesh_config()
    parts = {}
    t0 = time.perf_counter()
    host = init_params(cfg, np.random.default_rng(SEED + 8))
    n_params = sum(a.size for a in tree_leaves(host))
    parts["draw"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ckpt.save(tmp / "init", 0, host)
    parts["write init"] = time.perf_counter() - t0
    batches = [next(lm_batches(cfg.vocab, TRAIN_BATCH, TRAIN_SEQ,
                               seed=SEED + 9))]
    torch.save(batches, tmp / "batches.pt")
    print(f"mesh-train-moe: deepseek-v2-lite-16b at full width, "
          f"{cfg.first_dense_layers} dense + "
          f"{cfg.n_layers - cfg.first_dense_layers} MoE layer of "
          f"{SLICE_DEPTH['deepseek']} ({n_params / 1e9:.3f} B f32 params; "
          f"{cfg.n_experts} routed experts top-{cfg.top_k} and "
          f"{cfg.n_shared_experts} shared, MLA, untied head); its initial "
          f"params drawn in {parts['draw']:.1f}s and written with "
          f"checkpoint.save in {parts['write init']:.1f}s", flush=True)
    # the ranks start (import, card, warm-up) while this process takes
    # the 1x1 step and writes its result
    t_spawn = time.perf_counter()
    ctx = torch.multiprocessing.start_processes(
        moe_train_rank, args=(MESH_RANKS, str(tmp / "gloo-moe"), str(tmp),
                              cfg, str(dev)),
        nprocs=MESH_RANKS, join=False, start_method="spawn")
    try:
        api = build_model(cfg, device=dev)
        params = to_torch(host, dev)
        del host
        with quiet(), route_spy() as want_routes:
            one = mesh_train_steps(api, params, adamw(OVERFIT_LR).init(
                params), batches, Mesh(1, 1, device=dev))
        del params
        nbytes = tree_bytes(one["params"]) + tree_bytes(one["state"])
        end = {"params": one["params"], **one["state"]}
        tops = {k: max(float(t.abs().max()) for t in tree_leaves(v))
                for k, v in end.items()}
        out = {"1x1": dict(losses=one["losses"], norms=one["norms"],
                           ms=one["ms"], bytes=nbytes), "runs": {},
               "params": n_params}
        del one
        print(f"mesh-train-moe[1x1]: one step of {TRAIN_BATCH} x "
              f"{TRAIN_SEQ} (f32, TF32 off): loss {out['1x1']['losses']}, "
              f"pre-clip norm {out['1x1']['norms']}, "
              f"{out['1x1']['ms'][0]:.1f} ms (the first step: with its "
              f"warm-up), params + m + v {nbytes / 2 ** 30:.2f} GiB "
              f"| {card}", flush=True)
        t0 = time.perf_counter()
        for k, v in end.items():
            torch.save(tree_map(lambda t: t.cpu(), v), tmp / f"end_{k}.pt")
        del end
        free_card()
        parts["write end"] = time.perf_counter() - t0
        while not all((tmp / f"ready{r}").exists()
                      for r in range(MESH_RANKS)):
            check(all(p.is_alive() for p in ctx.processes),
                  "a mesh training rank died before training")
            time.sleep(0.1)
        t_ready = time.perf_counter()
        parts["ranks ready"] = t_ready - t_spawn
        with quiet():
            (tmp / "go").touch()
            while not ctx.join(timeout=1):
                pass
        train_s = time.perf_counter() - t_ready
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    ranks = [torch.load(tmp / f"moe{r}.pt", weights_only=False)
             for r in range(MESH_RANKS)]
    check(all(r["jax"] == [] for r in ranks),
          "a mesh training rank imported jax")
    for shape in MOE_MESH_TRAIN:
        label = f"{shape[0]}x{shape[1]}"
        runs = [r["runs"][shape] for r in ranks]
        for i, run in enumerate(runs):
            check(run["losses"] == runs[0]["losses"],
                  f"mesh-train-moe {label}: rank {i}'s loss differs from "
                  f"rank 0's")
        rel = [abs(a / b - 1) for a, b in zip(runs[0]["losses"],
                                             out["1x1"]["losses"])]
        nrel = [abs(a / b - 1) for a, b in zip(runs[0]["norms"],
                                              out["1x1"]["norms"])]
        # rank 0 holds the first rows over 'data', one group per row
        got = runs[0]["routes"]
        check(len(got) == len(want_routes),
              f"mesh-train-moe {label}: {len(got)} MoE calls, 1x1 made "
              f"{len(want_routes)}")
        flips = sum(int((g != w[:g.shape[0]]).sum())
                    for g, w in zip(got, want_routes))
        routes = sum(g.numel() for g in got)
        errs = {k: max(run["errs"][k] for run in runs) / tops[k]
                for k in tops}
        frac = [run["bytes"] / out["1x1"]["bytes"] for run in runs]
        out["runs"][label] = dict(losses=runs[0]["losses"], loss_rel=rel,
                                  norm_rel=nrel, tree=errs, flips=flips,
                                  routes=routes,
                                  bytes=[run["bytes"] for run in runs],
                                  frac=frac, ms=[run["ms"] for run in runs])
        print(f"mesh-train-moe[{label}]: 4 ranks restored the 1x1 run's "
              f"initial checkpoint onto this mesh "
              f"({ranks[0]['restore'][shape]:.1f}s on rank 0), every "
              f"rank's loss the same bits; vs 1x1: loss {max(rel):.2e}, "
              f"pre-clip norm {max(nrel):.2e} relative, params / m / v "
              f"{errs['params']:.2e} / {errs['m']:.2e} / {errs['v']:.2e} "
              f"of each tree's largest magnitude; route flips (rank 0 vs "
              f"1x1): {flips} of {routes} (token, k) routes; params + m + "
              f"v per rank "
              f"{', '.join(f'{b / 2 ** 30:.2f}' for b in out['runs'][label]['bytes'])} "
              f"GiB against 1x1's {out['1x1']['bytes'] / 2 ** 30:.2f} GiB "
              f"({', '.join(f'{f:.3f}' for f in frac)}); ms per step per "
              f"rank {[round(run['ms'][0], 1) for run in runs]} (the first "
              f"step, with its warm-up; gloo, 4 ranks on one card: "
              f"correctness only) | {card}", flush=True)
        check(max(rel) <= TOL_MESH_LOSS, f"mesh-train-moe {label}: loss "
              f"{runs[0]['losses']} vs 1x1 {out['1x1']['losses']}")
        check(max(nrel) <= TOL_MESH_NORM, f"mesh-train-moe {label}: "
              f"pre-clip norm {runs[0]['norms']} vs 1x1 "
              f"{out['1x1']['norms']}")
        for k, e in errs.items():
            check(e <= TOL_MESH_TREE, f"mesh-train-moe {label}: {k} differs "
                  f"from 1x1 by {e:.3e} of its largest magnitude")
    out["train_s"] = train_s
    parts["warm-up (rank 0)"] = ranks[0]["warm_up"]
    for k in ("restore", "compare"):
        parts[f"{k} (rank 0)"] = sum(ranks[0][k].values())
    out["parts"] = parts
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"mesh-train-moe: phase {out['phase_s']:.1f}s of its "
          f"{MOE_MESH_BUDGET} s budget ({train_s:.1f}s of gloo training, "
          f"the pool paused; "
          f"{', '.join(f'{k} {v:.1f}s' for k, v in parts.items())})",
          flush=True)
    return out


# -------------------------------------------------------------- the CNNs
#: the reference's CNN task (``benchmarks/_cnn_task.py:22-24``, ``_train``
#: and ``get_task``): widths, image size, 512 training images at seed 0,
#: 384 test images at seed 99, 60 AdamW steps at lr 5e-3, cosine, warmup 10
R_WIDTHS, M_WIDTHS, IMG = (32, 64, 128, 128), (32, 64, 96, 128), 12
CNN_TRAIN, CNN_TEST, CNN_STEPS, CNN_LR = 512, 384, 60, 5e-3


@contextlib.contextmanager
def matmul_inputs(weights):
    """Record the left operand of every matmul whose right operand is one
    of ``weights`` ({name: tensor}): {name: [M, K] activations}."""
    from torch.overrides import TorchFunctionMode
    by_id = {id(w): name for name, w in weights.items()}
    seen = {}

    class Spy(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if getattr(func, "__name__", "") in ("matmul", "__matmul__") \
                    and id(args[1]) in by_id:
                seen[by_id[id(args[1])]] = args[0].reshape(
                    -1, args[1].shape[0]).detach().clone()
            return func(*args, **(kwargs or {}))
    with Spy():
        yield seen


def cnn_phase(dev, card):
    """The paper's CNNs trained on the card; their float and SME
    accuracy and crossbar counts; every packable conv matrix through
    v1, v2 and v3 on its real activations.  Returns the readings, the
    kernel rows per shape and the launches of the activations' runs."""
    import functools
    from repro_torch.core import mapping
    from repro_torch.core.backend import sme_apply, smeweight_from_param
    from repro_torch.core.integrate import (pack_sme_param, sme_dequant,
                                            to_torch)
    from repro_torch.core.quant import quantize
    from repro_torch.core.sme import sme_matmul_ref_np
    from repro_torch.core.squeeze import squeeze_out
    from repro_torch.data import image_task
    from repro_torch.models import cnn
    from repro_torch.optim import adamw, cosine_schedule
    from repro_torch.train import make_train_step
    from repro_torch.tree import flatten, unflatten_like
    t_phase, p_phase = time.perf_counter(), paused_s()
    x_tr, y_tr = (torch.as_tensor(a, device=dev)
                  for a in image_task(CNN_TRAIN, size=IMG, seed=0))
    x_te, y_te = (torch.as_tensor(a, device=dev)
                  for a in image_task(CNN_TEST, size=IMG, seed=99))
    nets = {"resnet": (cnn.resnet_init, cnn.resnet_apply, R_WIDTHS),
            "mobilenet": (cnn.mobilenet_init, cnn.mobilenet_apply, M_WIDTHS)}
    out, shapes, eligible = {}, [], {}
    acts_launches = {name: 0 for name in KERNELS}
    for i, (net, (init, apply, widths)) in enumerate(nets.items()):
        apply = functools.partial(apply, widths=widths)
        params = to_torch(init(np.random.default_rng(SEED + i),
                               widths=widths), dev)
        opt = adamw(cosine_schedule(CNN_LR, 10, CNN_STEPS))
        state = opt.init(params)
        step = make_train_step(
            lambda p, b: cnn.cnn_loss(apply, p, b["x"], b["y"]), opt)
        # its seconds are a reading: 60 steps of ~1,500 small launches
        # each, which the packing pool's host load slows up to 10x
        with quiet():
            t0 = time.perf_counter()
            for s in range(CNN_STEPS):
                params, state, loss = step(params, state, s,
                                           {"x": x_tr, "y": y_tr})
            loss = float(loss)
            train_s = time.perf_counter() - t0
        check(np.isfinite(loss), f"{net}: loss {loss}")

        def acc(p):
            with torch.no_grad():
                return float((apply(p, x_te).argmax(-1) == y_te).float()
                             .mean())
        mats = cnn.conv_weight_matrices(params)
        # kernel operands only for the matrices the kernels run
        packed = {k: pack_sme_param(w, backend="all" if min(w.shape) >= 128
                                    else None) for k, w in mats}
        flat = flatten(params)
        deq = unflatten_like(params, [
            sme_dequant(to_torch(packed[k], dev), torch.float32)
            if k in packed else v for k, v in flat.items()])
        a_float, a_sme = acc(params), acc(deq)
        # all conv matrices, and those of >= 128 columns (the paper
        # tables' ``min_cols=128``: the layers a 128-wide crossbar targets)
        xbars = np.zeros((2, 3), np.int64)
        for _, w in mats:
            q = quantize(w, "sme", 8, 3)
            n = np.array([mapping.conventional_crossbar_total(w.shape, 8),
                          mapping.sme_crossbar_count(q.codes, 8),
                          mapping.squeezed_crossbar_count(
                              squeeze_out(q.codes, 8, 1))])
            xbars[0] += n
            xbars[1] += n * (w.shape[1] >= 128)
        out[net] = dict(train_s=train_s, loss=loss, acc_float=a_float,
                        acc_sme=a_sme, crossbars={
                            sel: dict(zip(("conventional", "sme",
                                           "squeezed1"), map(int, x)))
                            for sel, x in zip(("all", "cols128"), xbars)})
        print(f"cnn[{net}]: widths {widths}, {CNN_STEPS} AdamW steps on "
              f"{CNN_TRAIN} images of {IMG}x{IMG} in {train_s:.1f}s, loss "
              f"{loss:.4f}; test accuracy ({CNN_TEST} images) float "
              f"{a_float:.4f}, every conv matrix SME-dequantized (8 bits, "
              f"window 3, squeeze 1) {a_sme:.4f}; crossbars "
              f"(conventional, SME, squeezed 1) of its {len(mats)} conv "
              f"matrices {tuple(map(int, xbars[0]))}, of those with >= 128 "
              f"columns {tuple(map(int, xbars[1]))} ("
              f"{xbars[1, 0] / max(xbars[1, 2], 1):.2f}x) | {card}",
              flush=True)

        # every matrix the reference's converter would pack (K, N >= 128),
        # on its real activations: the full test set and one image
        weights = {k: w for k, w in flat.items()
                   if k in packed and min(w.shape) >= 128}
        with matmul_inputs(weights) as seen, torch.no_grad():
            apply(params, x_te)
        for k in weights:
            p = to_torch(packed[k], dev)
            K, N = weights[k].shape
            x_all = seen[k]
            one = x_all.shape[0] // CNN_TEST
            smew = smeweight_from_param(packed[k])
            for m, x in (("test set", x_all), ("one image", x_all[:one])):
                zero_counts()
                ys = {be: sme_apply(x, p, be, out_dtype=torch.float32)
                      for be in ("v1", "v2", "v3")}
                torch.cuda.synchronize()
                for name in KERNELS:
                    acts_launches[name] += wrappers()[name].launches
                check(bool(torch.equal(ys["v1"], ys["v2"]))
                      and bool(torch.equal(ys["v1"], ys["v3"])),
                      f"cnn {net} {k} {m}: v1, v2, v3 differ: "
                      f"{mismatch(ys['v1'], ys['v3'])}")
                ref = sme_matmul_ref_np(x.cpu().numpy(), smew)
                rel = float(np.abs(ys["v3"].cpu().numpy() - ref).max()
                            / np.abs(ref).max())
                check(rel <= TOL_ORACLE, f"cnn {net} {k} {m}: oracle {rel}")
                print(f"cnn[{net}]: {k} {K}x{N} (K padded to "
                      f"{-(-K // 128) * 128}), {m} (M = {x.shape[0]}): "
                      f"v1 == v2 == v3 bitwise, oracle rel {rel:.2e}",
                      flush=True)
            eligible[f"{net} {k}"] = (p, smew, K, N, (one, x_all.shape[0]))
        del params, state, deq
    for name in KERNELS:
        check(acts_launches[name] > 0,
              f"cnn: {name} never launched on the conv matrices")
    # one kernel row per shape (the first matrix of each (K, N, M))
    seen_shapes = set()
    for label, (p, smew, K, N, ms) in eligible.items():
        if (K, N, ms) not in seen_shapes:
            seen_shapes.add((K, N, ms))
            shapes.append((f"cnn {label} {K}x{N}", p, smew, K, N, ms))
    rows = kernel_rows(dev, shapes, card, SEED + 9)
    out["matrices"] = len(eligible)
    out["phase_s"] = time.perf_counter() - t_phase
    out["paused_s"] = paused_s() - p_phase
    print(f"cnn: {len(eligible)} conv matrices through v1, v2 and v3, "
          f"launches {acts_launches}; phase {out['phase_s']:.1f}s, the pool "
          f"paused {out['paused_s']:.1f}s of it", flush=True)
    return rows, acts_launches, out


# ------------------------------------------------------------ gemma3-12b
#: gemma3-12b's depth here: one superblock of its 5:1 pattern (5 local
#: layers, 1 global) of the config's 48 layers (8 superblocks)
GEMMA_LAYERS = 6
#: the untied head [3840, 262144] is drawn and compressed in slabs of
#: 16384 columns, one pool task each (one compression of the whole head
#: would hold ~110 GB of host intermediates)
HEAD_SLABS = 16
HEAD_STD = 0.02                       # lm_init's head std
#: every column slab of a weight cut in several (a head slab, a pool
#: unit) is clipped to +-this many std and holds +that at [0, 0]: each
#: slab's per-tensor scale (max |w|) is then the whole weight's, so the
#: joined slabs are bitwise one compression of the weight (everything
#: after the scale works per tile or per column tile; checked at a small
#: size)
SLAB_CLIP = 6
#: host processes that compress and pack the full-width models' weights
#: (gemma, mixtral, deepseek, llava, the recurrent models, whisper)
#: beside the card tests and the qwen phases, at the lowest CPU priority.
#: Measurements pause them (:data:`quiet`): beside them, CUDA-event times
#: of the qwen kernel rows came out 30-300x too long, the host's launches
#: falling behind the flush, and host-bound engine steps several times
#: slower
PACK_WORKERS = 6
#: the pool's unit of work: a column slab of whole column tiles of one
#: weight, at most this many weights (one tile where a tile holds more:
#: 1.97 M at gemma's K of 15,360), so that a pause waits for little: on
#: the host of an NVIDIA H100 80GB HBM3 (700.00 W) the script's 102
#: pauses waited 1.9 s in all, 0.253 s at most, and the pool's last
#: result came 352 s after its start (whole weights as units: 835.8 s)
UNIT_WEIGHTS = 2 ** 19
GEMMA_ONE_SHOT = dict(slots=4, s_max=2048, chunk_len=2048, prefix_cache=False)
GEMMA_ENGINE = dict(slots=4, s_max=2048, chunk_len=544, page_tokens=16,
                    spec_len=4)
#: the prefix two of the gemma requests share: 2 chunks of 544, past W
SHARED_PREFIX = 1088
#: gemma prompt lengths are drawn from [lo, hi)
PROMPT_LENS = (1100, 1501)
#: gemma's kernel rows: (label, layer linear or "head", K, N)
GEMMA_SHAPES = (("q 3840x3840", "q", 3840, 3840),
                ("k 3840x1920", "k", 3840, 1920),
                ("wi 3840x15360", "wi", 3840, 15360),
                ("wo 15360x3840", "wo", 15360, 3840),
                ("head 3840x262144", "head", 3840, 262144))
#: columns of each gemma shape held against the f64 oracle on the host
ORACLE_COLS = 1024
V3_OPS = ("planes", "sign", "rowscale", "rowid", "shift", "last", "nnz")
V1_OPS = ("codes", "sign", "rowscale", "rowid", "nnz")
V2_OPS = ("packed", "rowscale", "rowid", "nnz")


def gemma_config():
    from repro_torch.configs import ARCHS
    return dataclasses.replace(ARCHS["gemma3-12b"], n_layers=GEMMA_LAYERS)


def gemma_tasks(cfg):
    """(name, seed, (K, N), std, backends) of every gemma weight the pool
    packs, largest first: per layer q, k, v, o, wi, wo (std 1/sqrt(K)),
    and the head's slabs, each for v1, v2 and v3."""
    d, ff = cfg.d_model, cfg.d_ff
    qd, kvd = cfg.n_heads * cfg.hd, cfg.n_kv_heads * cfg.hd
    shapes = {"q": (d, qd), "k": (d, kvd), "v": (d, kvd), "o": (qd, d),
              "wi": (d, ff), "wo": (ff, d)}
    tasks = [(f"{i}/{name}", (k, n), float(k) ** -0.5)
             for i in range(cfg.n_layers) for name, (k, n) in shapes.items()]
    tasks += [(f"head/{s}", (d, cfg.vocab // HEAD_SLABS), HEAD_STD)
              for s in range(HEAD_SLABS)]
    tasks = [(name, SEED * 1000 + i, shape, std, "all")
             for i, (name, shape, std) in enumerate(tasks)]
    return sorted(tasks, key=lambda t: -t[2][0] * t[2][1])


def slab_values(w, std):
    """A column slab's values with the whole weight's max |w|: clipped to
    :data:`SLAB_CLIP` std, which [0, 0] holds (in place)."""
    clip = np.float32(SLAB_CLIP * std)
    np.clip(w, -clip, clip, out=w)
    w[0, 0] = clip
    return w


def units(task):
    """The pool's units of one task, in column order: (task, first column,
    columns) of each column slab of whole column tiles and at most
    :data:`UNIT_WEIGHTS` weights (one tile at least); one unit, the whole
    weight, where it fits."""
    _, _, (k, n), _, _ = task
    per = max(1, UNIT_WEIGHTS // (k * 128)) * 128
    return [(task, c, min(per, n - c)) for c in range(0, n, per)]


def unit_values(unit):
    """One unit's f32 values times its task's std: the whole weight drawn
    from the task's seed, or a slab of a weight cut in several from (seed,
    first column) and given the whole's max |w| (:func:`slab_values`, as
    every head slab is)."""
    (name, seed, (k, n), std, _), c0, cols = unit
    whole = cols == n
    w = np.random.default_rng(seed if whole else (seed, c0)) \
        .standard_normal((k, cols), dtype=np.float32)
    w *= np.float32(std)
    if name.startswith("head/") or not whole:
        slab_values(w, std)
    return w


def pack_unit(unit):
    """One unit compressed once (8 bits, window 3, squeeze 1) and packed
    for the backends its task names ("all", or a tuple); numpy arrays.  A
    ragged last slab narrower than a tile is packed too."""
    from repro_torch.core.integrate import convert_params_to_sme
    packed = convert_params_to_sme({"w": unit_values(unit)},
                                   backend=unit[0][4], device="cpu",
                                   predicate=lambda *_: True)
    return {key: t.numpy() for key, t in packed["w"].items()}


def pack_task(task):
    """One weight (or head slab) packed in this process: (name, its
    units' packs joined), what the pool gives for it."""
    parts = [pack_unit(u) for u in units(task)]
    return task[0], parts[0] if len(parts) == 1 else join_columns(parts)


def join_columns(parts):
    """One packed param from the packed column slabs of one weight: the
    raw leaves and the v3 sign/rowscale join along their column-tile axis,
    the lists per column tile, padded to the longest slab's with the
    packers' fill (rowscale 1, everything else 0)."""
    out = {}
    for key in parts[0]:
        arrs = [p[key] for p in parts]
        if arrs[0].ndim == 0:
            out[key] = arrs[0]
            continue
        if key.startswith("sme_v") and not key.endswith(("_nnz", "v3_sign",
                                                        "v3_rowscale")):
            L = max(a.shape[1] for a in arrs)
            fill = 1 if key.endswith("rowscale") else 0
            arrs = [np.pad(a, [(0, 0), (0, L - a.shape[1])]
                           + [(0, 0)] * (a.ndim - 2), constant_values=fill)
                    for a in arrs]
        axis = 0 if key.startswith("sme_v") and not key.endswith(
            ("v3_sign", "v3_rowscale")) else 1
        out[key] = np.concatenate(arrs, axis=axis)
    return out


def check_slab_join():
    """At 384 x 1024: two 512-column slabs (the second with an empty row
    tile, so its lists are shorter) joined are byte for byte one
    compression of the whole weight."""
    from repro_torch.core.integrate import convert_params_to_sme
    w = np.random.default_rng(SEED + 5).standard_normal(
        (384, 1024), dtype=np.float32) * np.float32(HEAD_STD)
    w[128:256, 512:] = 0.0
    slab_values(w[:, :512], HEAD_STD)
    slab_values(w[:, 512:], HEAD_STD)

    def pack(a):
        p = convert_params_to_sme({"w": a}, backend="all", device="cpu")
        return {k: t.numpy() for k, t in p["w"].items()}
    whole = pack(w)
    joined = join_columns([pack(np.ascontiguousarray(w[:, :512])),
                           pack(np.ascontiguousarray(w[:, 512:]))])
    check(sorted(joined) == sorted(whole) and all(
        joined[k].dtype == whole[k].dtype and joined[k].shape == whole[k].shape
        and joined[k].tobytes() == whole[k].tobytes() for k in whole),
        "joined column slabs differ from one compression of the weight")


def _low_priority():
    import os
    os.nice(19)


#: a pool worker's (flag, busy count): set by :func:`_pool_worker`
_GATE = None


def _pool_worker(gate, busy):
    """The pool's initializer: the lowest CPU priority, and the pause's
    shared flag and busy count (:class:`Packer`)."""
    global _GATE
    _low_priority()
    _GATE = (gate, busy)


def pool_unit(unit):
    """Pool worker: :func:`pack_unit` of one unit, begun only while the
    pool's flag is set, and counted busy from before that check to its
    end, so that a pause which cleared the flag and then read a count of
    0 has no unit running until it sets the flag again."""
    gate, busy = _GATE
    while True:
        gate.wait()
        with busy.get_lock():
            busy.value += 1
        if gate.is_set():
            break
        with busy.get_lock():         # paused since the wait: stand back
            busy.value -= 1
    try:
        return pack_unit(unit)
    finally:
        with busy.get_lock():
            busy.value -= 1


class Packer:
    """Draws and packs the weights of every full-width model of the later
    phases (:data:`PACK_WORKERS` spawned host processes at the lowest CPU
    priority) from the script's start: gemma's, then the MoE and vision
    models', largest first within each, each weight in units of at most
    :data:`UNIT_WEIGHTS` weights (:func:`units`), joined when its model is
    asked for.  While it runs, :data:`quiet` pauses it for the length of
    a measurement without a signal: the workers begin no unit while the
    pool's flag is clear, and the pause waits for the units in flight
    (:func:`pool_unit`).  :meth:`wait` returns one model's ({name: packed
    numpy param}, seconds from the pool's start to its last result,
    seconds waited); :meth:`close` ends the pool."""

    def __init__(self, groups, dev=None):
        import multiprocessing
        global quiet
        self.t0 = time.perf_counter()
        self.paused_s = 0.0
        self.pauses = 0
        #: seconds the pauses waited for the units in flight: in all, most
        self.drain_s = 0.0
        self.drain_max = 0.0
        self.depth = 0
        self.dev = dev
        self.tasks = groups
        ctx = multiprocessing.get_context("spawn")
        self.gate = ctx.Event()
        self.gate.set()
        self.busy = ctx.Value("i", 0)
        self.pool = ctx.Pool(PACK_WORKERS, initializer=_pool_worker,
                             initargs=(self.gate, self.busy))
        #: per model, seconds from the pool's start to its last result
        self.done_s = {model: 0.0 for model in groups}
        self.pending = {model: [(t[0], [self.pool.apply_async(
            pool_unit, (u,), callback=lambda _, m=model: self._done(m))
            for u in units(t)]) for t in tasks]
            for model, tasks in groups.items()}
        quiet = self.paused

    def _done(self, model):
        self.done_s[model] = time.perf_counter() - self.t0

    @contextlib.contextmanager
    def paused(self):
        """No unit of packing work runs while this is held: the flag
        cleared, then the units in flight waited for (the drain).
        Re-entrant: a block of readings holds one pause."""
        if self.depth:
            self.depth += 1
            try:
                yield
            finally:
                self.depth -= 1
            return
        t0 = time.perf_counter()
        self.depth = 1
        self.gate.clear()
        while self.busy.value:
            time.sleep(0.001)
        drain = time.perf_counter() - t0
        self.drain_s += drain
        self.drain_max = max(self.drain_max, drain)
        self.pauses += 1
        try:
            yield
        finally:
            self.depth = 0
            self.gate.set()
            self.paused_s += time.perf_counter() - t0

    def wait(self, model):
        """One model's results, each weight's units joined, each checked
        on the card (:func:`pack_check`) when the pool has a device."""
        t1 = time.perf_counter()
        got, n_units, join_s = {}, 0, 0.0
        for name, results in self.pending.pop(model):
            parts = [r.get() for r in results]
            t_join = time.perf_counter()
            got[name] = parts[0] if len(parts) == 1 else join_columns(parts)
            join_s += time.perf_counter() - t_join
            n_units += len(parts)
        t2 = time.perf_counter()
        print(f"pack: {model}'s last result {self.done_s[model]:.1f}s from "
              f"the pool's start, asked for at {t1 - self.t0:.1f}s; "
              f"{len(got)} weights from {n_units} units, joined in "
              f"{join_s:.1f}s", flush=True)
        if self.dev is not None:
            pack_check(self.dev, got, self.tasks[model], model, self.pauses)
        return got, t2 - self.t0, t2 - t1

    def close(self):
        """The workers leave once every unit is done (no signal is sent
        to them); a failed run's pool, with units still queued, is
        terminated."""
        global quiet
        quiet = contextlib.nullcontext
        self.gate.set()
        if self.pending:
            self.pool.terminate()
        else:
            self.pool.close()
        self.pool.join()
        print(f"pack: the pool was paused {self.paused_s:.1f}s in all for "
              f"device measurements ({self.pauses} pauses, no signal sent "
              f"to it); draining the units in flight took "
              f"{self.drain_s:.1f}s in all, {self.drain_max:.3f}s at most",
              flush=True)


def pack_check(dev, got, tasks, model, pauses):
    """F4's guard on the pool's results of one model: each packed weight
    uploaded alone and multiplied by one seeded random [8, K] input under
    every format it carries (v1 and v3 where it has them, v2), whose
    products must be bitwise equal (v1 == v2 == v3, the formats'
    contract).  A weight whose formats disagree is packed again in this
    process, outside the pool, and checked again: the line names it, and
    a second disagreement fails the run.  Packs in place in ``got``."""
    from repro_torch.core.backend import sme_apply
    from repro_torch.core.integrate import to_torch
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 21)

    def agree(p):
        w = to_torch(p, dev)
        x = torch.randn((8, w["sme_sign"].shape[-2]), generator=gen,
                        device=dev)
        outs = [sme_apply(x, w, be) for be in ("v1", "v2", "v3")
                if f"sme_{be}_nnz" in w]
        return all(torch.equal(outs[0], o) for o in outs[1:])
    bad = [name for name, p in got.items() if not agree(p)]
    by_name = {t[0]: t for t in tasks}
    for name in bad:
        got[name] = pack_task(by_name[name])[1]
        check(agree(got[name]), f"pack check[{model}]: {name}'s formats "
              "disagree again after an in-process pack")
    torch.cuda.synchronize()
    print(f"pack check[{model}]: {len(got)} packed weights, each format's "
          f"product of one random input bitwise equal on the card"
          + (f" but for {bad}: the pool's pack parted (F4), {pauses} "
             f"pauses of the pool so far; packed again in this process, "
             f"now equal" if bad else "")
          + f" ({time.perf_counter() - t0:.1f}s)", flush=True)


def gemma_params(dev, cfg, got):
    """The packed gemma model on the card from the pool's results, and host
    copies of layer 0's raw weights and the head's first slab for the
    oracle."""
    from repro_torch.core.integrate import to_torch
    host = {k: got[k] for k in ("0/q", "0/k", "0/wi", "0/wo", "head/0")}
    slabs = [got.pop(f"head/{s}") for s in range(HEAD_SLABS)]
    check(len({float(p["sme_scale"][0, 0]) for p in slabs}) == 1,
          "head slabs have different scales")
    d, ff = cfg.d_model, cfg.d_ff
    ones = np.ones(d, np.float32)
    blocks = [{"norm1": {"w": ones},
               "mix": {k: {"w": got.pop(f"{i}/{k}")} for k in "qkvo"},
               "norm2": {"w": ones},
               "mlp": {"wi": {"w": got.pop(f"{i}/wi"),
                              "b": np.zeros(ff, np.float32)},
                       "wo": {"w": got.pop(f"{i}/wo"),
                              "b": np.zeros(d, np.float32)}}}
              for i in range(cfg.n_layers)]
    tree = {"final_norm": {"w": ones}, "blocks": blocks,
            "lm_head": {"w": join_columns(slabs)}}
    params = to_torch(tree, dev)
    upload_check(tree, params, cfg.name)
    del slabs, blocks, tree
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    params["embed"] = {"w": torch.randn((cfg.vocab, d), generator=gen,
                                        device=dev) * EMBED_STD}
    torch.cuda.synchronize()
    return params, host


def oracle_weight(hp, cols):
    """The SMEWeight of a raw packed param's first ``cols`` columns."""
    from repro_torch.core.backend import smeweight_from_param
    t = -(-cols // 128)
    return smeweight_from_param({
        "sme_codes": hp["sme_codes"][:, :t], "sme_rowexp":
        hp["sme_rowexp"][:, :t], "sme_sign": hp["sme_sign"][:, :-(-cols // 8)],
        "sme_scale": hp["sme_scale"][:, :cols], "sme_tilesq":
        hp["sme_tilesq"][:, :t], "sme_nbits": hp["sme_nbits"],
        "sme_squeezed": hp["sme_squeezed"], "sme_window": hp["sme_window"]})


def gemma_kernel_rows(dev, params, host, card):
    """Each kernel at gemma's widths (layer 0's q, k, wi and wo and the
    head, the model's own operands) at M = 8, 64 and 512 (see
    :func:`kernel_rows`).  Returns {kernel: {label: {M: readings}}}."""
    shapes = []
    for label, leaf, K, N in GEMMA_SHAPES:
        p = params["lm_head"]["w"] if leaf == "head" else (
            params["blocks"][0]["mix" if leaf in "qkvo" else "mlp"][leaf]["w"])
        smew = oracle_weight(host["head/0" if leaf == "head" else
                                 f"0/{leaf}"], min(N, ORACLE_COLS))
        shapes.append((f"gemma {label}", p, smew, K, N, (8, 64, 512)))
    return kernel_rows(dev, shapes, card, SEED + 6)


def kernel_rows(dev, shapes, card, seed):
    """Each kernel at the given shapes on a model's own operands
    (``shapes``: (label, packed param with v1, v2 and v3 operands, oracle
    SMEWeight of its first columns, K, N, Ms)): v3-decode, v1 and v2 at M
    <= 64 (rows padded to 8 with zeros, as the backends pad), v3-prefill,
    v1 and v2 above; each against its plain version (in blocks of rows and
    column tiles) and the f64 oracle on the first :data:`ORACLE_COLS`
    columns, v1 == v2 == v3 bitwise; times of the launch alone, the plain
    version, ``torch.matmul`` on the dequantized weight in f32 (the same
    function) and in bf16 (a dense bf16 model's), and the bound.  Returns
    {kernel: {label: {M: readings}}}."""
    from repro_torch.core.integrate import sme_dequant
    from repro_torch.core.sme import sme_matmul_ref_np
    ws = wrappers()
    plains = {n: chunked(n, getattr(m, f"{n}_plain"))
              for n, m in _modules().items()}
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32, device=dev)
    rng = np.random.default_rng(seed)
    rows = {name: {} for name in KERNELS}
    for label, p, smew, K, N, ms in shapes:
        check(tuple(p["sme_sign"].shape) == (K, -(-N // 8)), f"{label} shape")
        a3 = [p[f"sme_v3_{o}"] for o in V3_OPS]
        a1 = [p[f"sme_v1_{o}"] for o in V1_OPS]
        a2 = [p[f"sme_v2_{o}"] for o in V2_OPS]
        nt = a3[0].shape[0]
        kp = p["sme_codes"].shape[0] * p["sme_codes"].shape[2]
        scale = torch.zeros((1, nt * 128), device=dev)
        scale[:, :N] = p["sme_scale"].reshape(1, -1).float()
        colscale = (scale * 2.0 ** -8).reshape(nt, 128)
        nnz3, last = a3[6], a3[5]
        valid = torch.arange(last.shape[1], device=dev)[None] < nnz3[:, None]
        planes, groups = int(nnz3.sum()), int(((last == 1) & valid).sum())
        occ = int(a1[4].sum())
        # the multiply-adds per row of x that the product needs: each
        # occupied tile's real rows times its real columns (a ragged K or
        # N pads its last tiles, which carry no work)
        rowid, nnz1 = a1[3].long(), a1[4]
        slot = torch.arange(rowid.shape[1], device=dev)[None] < nnz1[:, None]
        real_rows = ((K - rowid * 128).clamp(0, 128) * slot).sum(1)
        real_cols = (N - torch.arange(nt, device=dev) * 128).clamp(0, 128)
        macs = int((real_rows * real_cols).sum())
        w32 = sme_dequant(p, torch.float32)
        w16 = w32.to(torch.bfloat16)
        # one pause for the shape's readings (quiet is re-entrant)
        with quiet():
            for m in ms:
                mp = -(-m // 8) * 8
                x = torch.zeros((mp, kp), device=dev)
                x[:m, :K] = torch.as_tensor(rng.standard_normal((m, K)),
                                            dtype=torch.float32, device=dev)
                ref = sme_matmul_ref_np(x[:m, :K].cpu().numpy(), smew)
                x128 = torch.zeros((-(-mp // 128) * 128, kp), device=dev)
                x128[:mp] = x
                y_pre = (ws["sme_spmm_planes"](x128, *a3)[:mp] * scale
                         * 2.0 ** -8)
                runs = []
                if m <= 64:
                    runs.append(("sme_spmm_planes_decode", lambda: ws[
                        "sme_spmm_planes_decode"](x, *a3[:3], colscale,
                                                  *a3[3:]),
                        lambda: plains["sme_spmm_planes_decode"](
                            x, *a3[:3], colscale, *a3[3:]), 1.0))
                else:
                    runs.append((
                        "sme_spmm_planes",
                        lambda: ws["sme_spmm_planes"](x128, *a3)[:mp],
                        lambda: plains["sme_spmm_planes"](x128, *a3)[:mp],
                        2.0 ** -8))
                runs.append(("sme_spmm", lambda: ws["sme_spmm"](x, *a1),
                             lambda: plains["sme_spmm"](x, *a1), 2.0 ** -8))
                runs.append(("sme_spmm6", lambda: ws["sme_spmm6"](x, *a2),
                             lambda: plains["sme_spmm6"](x, *a2), 2.0 ** -1))
                xm = x[:m, :K]
                lib_ms = time_ms(lambda: torch.matmul(xm, w32), flush)
                bf16_ms = time_ms(lambda: torch.matmul(xm.bfloat16(), w16),
                                  flush)
                for name, kern, plain, q in runs:
                    s = scale if name != "sme_spmm_planes_decode" else 1.0
                    y, yp = kern() * s * q, plain() * s * q
                    torch.cuda.synchronize()
                    err, rel = check_close(name, y[:m], yp[:m], ref,
                                           f"{label} M={m}")
                    check(bool(torch.equal(y, y_pre)),
                          f"{name} {label} M={m}: != v3 prefill bitwise")
                    ms_ = time_ms(kern, flush)
                    plain_ms = time_ms(plain, flush, iters=3)
                    if name.startswith("sme_spmm_planes"):
                        nbytes = (m * K * 4 + planes * 2048
                                  + groups * (2048 + 512) + nt * 128 * 4
                                  + m * N * 4)
                    else:
                        tile = 16384 + 2048 + 512 if name == "sme_spmm" \
                            else 12288 + 512
                        nbytes = (m * K * 4 + occ * tile + occ * 4 + nt * 4
                                  + m * N * 4)
                    flops = 2.0 * m * macs
                    bound, by = bound_of(nbytes, flops)
                    print(f"kernel {name:22s} {label:22s} M={m:3d}: "
                          f"{ms_ * 1e3:.1f} us, plain "
                          f"{plain_ms * 1e3:.1f} us, torch.matmul f32 "
                          f"{lib_ms * 1e3:.1f} us (bf16 {bf16_ms * 1e3:.1f} "
                          f"us), bound {bound * 1e3:.2f} us "
                          f"({by}: {nbytes} B, {flops:.3g} FLOP) | max|k-p|="
                          f"{err:.2e} oracle_rel={rel:.2e} (first "
                          f"{ref.shape[1]} columns) == v3 prefill | {card}",
                          flush=True)
                    rows[name].setdefault(label, {})[str(m)] = dict(
                        ms=ms_, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                        library_ms=lib_ms, bf16_matmul_ms=bf16_ms,
                        max_abs_err=err)
        del w32, w16
        torch.cuda.empty_cache()
    del flush
    return rows


def gemma_workload(vocab):
    """4 greedy requests of 1,100-1,500-token prompts, 16 new tokens: A and
    B share the first :data:`SHARED_PREFIX` tokens.  The engine admits A,
    C and D, and B once A has scored the shared prefix (its snapshot there
    holds rings wrapped past W = 1024)."""
    from repro_torch.serve import Request
    rng = np.random.default_rng(SEED + 4)
    prefix = rng.integers(0, vocab, SHARED_PREFIX)
    lens = rng.integers(*PROMPT_LENS, size=4)
    prompts = [np.concatenate([prefix, rng.integers(
        0, vocab, int(n) - SHARED_PREFIX)]) for n in lens[:2]]
    prompts += [rng.integers(0, vocab, int(n)) for n in lens[2:]]
    reqs = [Request(rid=i, prompt=p, max_new_tokens=16)
            for i, p in enumerate(prompts)]
    a = reqs[0]

    def ready(eng, _):
        slot = next((i for i, r in enumerate(eng.active) if r is a), None)
        return slot is not None and eng._pf_next[slot] >= SHARED_PREFIX
    return prompts, ([a] + reqs[2:], [reqs[1]], ready)


def gemma_phase(dev, card, packed):
    """gemma3-12b at full width, one superblock, untied packed head: its
    kernel rows; one-shot serving under auto (v2) and v3; a prefill
    window's f32 logits; a profiled window; the engine with spec and
    without.  Returns the kernel rows, launches per kernel over the
    serving and engine runs, and readings."""
    from repro_torch.core.integrate import sme_operand_bytes
    from repro_torch.models.model import build_model
    t_phase = time.perf_counter()
    cfg = gemma_config()
    print(f"gemma: {cfg.name} at full width (d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads of {cfg.hd}, GQA kv {cfg.n_kv_heads}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab}, W {cfg.swa_window}, rope theta "
          f"{cfg.rope_theta:g}, {cfg.act}, untied packed head); depth cut "
          f"from 48 layers to one superblock of {cfg.n_layers} "
          f"({', '.join(cfg.pattern)})", flush=True)
    check_slab_join()
    got, pack_s, wait_s = packed
    print(f"gemma: weights drawn, compressed once and packed to v1, v2 and "
          f"v3 on the host by {PACK_WORKERS} processes beside the card "
          f"tests: {pack_s:.1f}s from the pool's start, {wait_s:.1f}s waited "
          f"after the card tests", flush=True)
    params, host = gemma_params(dev, cfg, got)
    del got
    ob = sme_operand_bytes(params)
    per_pass = packed_linears(params)
    print(f"gemma: {ob['weights']} weights in {per_pass} packed linears: "
          + ", ".join(
              f"{be} {ob[be] / ob['weights']:.4f} B" for be in ("v1", "v2",
                                                               "v3"))
          + f"; card memory {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB",
          flush=True)
    out = {"weights": ob["weights"], "pack_s": pack_s, "pack_wait_s": wait_s}
    rows = gemma_kernel_rows(dev, params, host, card)
    del host
    api = build_model(cfg, device=dev)
    prompts, waves = gemma_workload(cfg.vocab)
    launches = {name: 0 for name in KERNELS}
    tokens = {}
    for backend in ("auto", "v3"):
        tokens[backend], counts = serve_run(api, params, prompts, backend,
                                            card, engine_kw=GEMMA_ONE_SHOT,
                                            label=f"gemma {backend}")
        for k in launches:
            launches[k] += counts[k]
    check(tokens["auto"] == tokens["v3"], "gemma: v2 and v3 tokens differ")
    print("gemma: one-shot tokens of auto (v2) and v3 identical", flush=True)

    toks, plen = prefill_window(prompts, GEMMA_ONE_SHOT["s_max"])
    api32 = build_model(dataclasses.replace(cfg, dtype="float32"), device=dev)

    def logits(backend, plain=False):
        with plain_kernels(blocks=True) if plain \
                else contextlib.nullcontext():
            return api32.prefill(params, toks, s_max=GEMMA_ONE_SHOT["s_max"],
                                 plen=plen, backend=backend)[0]
    lk = {be: logits(be) for be in ("v2", "v3")}
    check(bool(torch.equal(lk["v2"], lk["v3"])),
          "gemma f32 prefill logits differ between v2 and v3 ("
          f"{mismatch(lk['v2'], lk['v3'])})")
    check(bool(torch.isfinite(lk["v2"]).all())
          and lk["v2"].shape == (4, cfg.vocab), "gemma logits")
    for what, other in (("torch backend", logits("torch")),
                        ("plain versions", logits("v2", plain=True))):
        diff = float((lk["v2"] - other).abs().max() / other.abs().max())
        print(f"gemma: f32 prefill logits (4 x {toks.shape[1]}) v2 == v3 "
              f"bitwise; vs the {what}: max rel diff {diff:.2e} (tolerance "
              f"{TOL_LOGITS['float32']:.0e})", flush=True)
        check(diff <= TOL_LOGITS["float32"], f"gemma logits vs {what}")
        out[f"logits_rel_{what.split()[0]}"] = diff
    del lk, api32
    torch.cuda.empty_cache()
    profile_window(api, params, prompts, card, "auto",
                   engine_kw=GEMMA_ONE_SHOT)

    depth, deepest, share, kept = choose_spec_depth(params)
    runs = {}
    for name, spec in (("spec", depth), ("spec off", None)):
        _, w = gemma_workload(cfg.vocab)
        r = runs[name] = engine_run(api, params, "v3", spec, True,
                                    engine_kw=GEMMA_ENGINE, waves=w)
        eng, reqs, m = r["eng"], r["reqs"], r["eng"]._m
        for k in launches:
            launches[k] += r["launches"][k]
        mine = KERNELS_OF["v3"]
        check(all(q.outcome == "completed" and len(q.out_tokens) == 16
                  for q in reqs), f"gemma engine[{name}]: incomplete")
        check(all(r["events"].get(q.rid) == q.out_tokens for q in reqs),
              f"gemma engine[{name}]: token events != out_tokens")
        check(sum(r["launches"][k] for k in mine) == per_pass * r["passes"]
              and all(r["launches"][k] == 0 for k in r["launches"]
                      if k not in mine) and all(r["launches"][k] > 0
                                                for k in mine),
              f"gemma engine[{name}]: launches {r['launches']} for "
              f"{r['passes']} passes of {per_pass}")
        hits, side = m["prefix_hits"].value, m["prefix_side_rows"].value
        wrapped = sorted(e.length for e in eng._prefix.entries
                         if e.length > cfg.swa_window)
        check(hits >= 1 and side == m["prefix_snapshots"].value > 0,
              f"gemma engine[{name}]: prefix hits {hits}, side rows {side}")
        if spec is not None:
            check(m["spec_rounds"].value > 0 and r["draft_launches"]
                  == per_pass * GEMMA_ENGINE["spec_len"]
                  * m["spec_rounds"].value,
                  f"gemma engine[{name}]: draft launches "
                  f"{r['draft_launches']}")
        n_tok = sum(len(q.out_tokens) for q in reqs)
        split = ", ".join(f"{k} {n} x {ms:.1f} ms"
                          for k, (n, ms) in eng.step_ms().items())
        drafted = m["spec_draft_tokens"].value
        print(f"gemma engine[{name}]: {r['steps']} steps ({split}); "
              f"{r['passes']} passes; {n_tok} tokens in {r['wall']:.2f} s = "
              f"{n_tok / r['wall']:.2f} tokens/s; spec depth "
              f"{depth if spec else '-'} of {deepest}, rounds "
              f"{int(m['spec_rounds'].value)}, accepted "
              f"{int(m['spec_accepted'].value)} of {int(drafted)}; prefix "
              f"hits {int(hits)}, misses {int(m['prefix_misses'].value)}, "
              f"snapshots {int(m['prefix_snapshots'].value)} (side-slab rows "
              f"{int(side)}; live entries past W: {wrapped}); TTFT s "
              + ", ".join(f"{q.rid}:{r['ttft'][q.rid]:.1f}" for q in reqs)
              + f" | {card}", flush=True)
        out[f"engine_{name.replace(' ', '_')}_tokens_per_s"] = \
            n_tok / r["wall"]
    greedy = [[q.out_tokens for q in r["reqs"]] for r in runs.values()]
    one_shot = [tokens["v3"][q.rid] for q in runs["spec"]["reqs"]]
    check(greedy[0] == greedy[1] == one_shot,
          "gemma: engine tokens with spec, without, and one-shot differ")
    print("gemma: engine tokens with spec == without == one-shot; distinct "
          "tokens per request: " + ", ".join(
              f"{q.rid}:{len(set(q.out_tokens))}"
              for q in runs["spec"]["reqs"]),
          flush=True)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"gemma: phase {out['phase_s']:.1f}s", flush=True)
    return rows, launches, out


# ---------------------------------------------------------------------------
# the MoE family and the vision frontend: mixtral-8x7b, deepseek-v2-lite,
# llava-next-34b at full width

#: the slice's models: key -> (arch, layers run on the card)
SLICE = {"mixtral": ("mixtral-8x7b", 1),
         "deepseek": ("deepseek-v2-lite-16b", 2),
         "llava": ("llava-next-34b", 1)}
#: their full depth, for the log
SLICE_DEPTH = {"mixtral": 32, "deepseek": 27, "llava": 60}
SLICE_ONE_SHOT = dict(slots=4, s_max=2048, chunk_len=2048, prefix_cache=False)
SLICE_ENGINE = dict(slots=4, s_max=2048, chunk_len=256, page_tokens=16,
                    spec_len=4)
#: the slice's prompt lengths are drawn from [lo, hi)
SLICE_PROMPTS = (400, 601)
#: the prefix deepseek's first two requests share: one chunk of 256
SLICE_SHARED = 256
#: the engine runs' prompt lengths (phases 7 and 8): one chunk of
#: :data:`SLICE_SHARED` and a tail of 16-64 tokens, a decode pass each
ENGINE_PROMPTS = (272, 321)
#: a weight of more than this many is packed in column slabs (the heads)
SLAB_WEIGHTS = 64 * 2 ** 20
#: f32 prefill logits of the slice's models against the ``torch`` backend,
#: relative to max |logit|: one or two layers of the per-linear difference
#: (<= 5e-5 of a product, DESIGN.md §5)
TOL_SLICE = 5e-5
#: the pool packs these weights for v1 too: the kernel rows'
ROW_WEIGHTS = {"mixtral": ("b0/wi/0", "b0/wo/0"),
               "deepseek": ("b0/wi/0", "first0/wi", "first0/wo",
                            "first0/kv_down"),
               "llava": ()}
#: the slice's kernel rows: (model, label, weight, K, N, Ms): mixtral's
#: and deepseek's expert shapes, and the ragged widths (10944 = 85.5
#: tiles, 576 = 4.5 tiles)
SLICE_SHAPES = (
    ("mixtral", "expert wi 4096x14336", "b0/wi/0", 4096, 14336, (4, 512)),
    ("mixtral", "expert wo 14336x4096", "b0/wo/0", 14336, 4096, (4, 512)),
    ("deepseek", "expert wi 2048x1408", "b0/wi/0", 2048, 1408, (8,)),
    ("deepseek", "first0 wi 2048x10944", "first0/wi", 2048, 10944, (8, 512)),
    ("deepseek", "first0 wo 10944x2048", "first0/wo", 10944, 2048, (8, 512)),
    ("deepseek", "kv_down 2048x576", "first0/kv_down", 2048, 576, (8, 512)))


def slice_config(key):
    from repro_torch.configs import ARCHS
    arch, n = SLICE[key]
    return dataclasses.replace(ARCHS[arch], n_layers=n)


def head_slabs(cfg) -> int:
    """Column slabs of a head: the fewest that split its column tiles
    evenly with at most :data:`SLAB_WEIGHTS` weights each."""
    nt = cfg.vocab // 128
    return next(n for n in range(1, nt + 1)
                if nt % n == 0 and cfg.d_model * cfg.vocab / n
                <= SLAB_WEIGHTS)


def layer_linears(cfg, layer: str, moe: bool):
    """(name, (K, N)) of one layer's packed weights: attention (GQA or
    MLA), then the MLP (dense wi/wg/wo, or each expert's and the shared
    experts')."""
    d, h = cfg.d_model, cfg.n_heads
    if cfg.attn_type == "mla":
        dn, dr, dv = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
        out = [("q", (d, h * (dn + dr))), ("kv_down", (d, cfg.kv_lora + dr)),
               ("kv_up", (cfg.kv_lora, h * (dn + dv))), ("o", (h * dv, d))]
    else:
        qd, kvd = h * cfg.hd, cfg.n_kv_heads * cfg.hd
        out = [("q", (d, qd)), ("k", (d, kvd)), ("v", (d, kvd)),
               ("o", (qd, d))]
    if moe:
        f = cfg.expert_dff
        for e in range(cfg.n_experts):
            out += [(f"wi/{e}", (d, f)), (f"wg/{e}", (d, f)),
                    (f"wo/{e}", (f, d))]
        if cfg.n_shared_experts:
            fs = f * cfg.n_shared_experts
            out += [("shared/wi", (d, fs)), ("shared/wg", (d, fs)),
                    ("shared/wo", (fs, d))]
    else:
        out += [("wi", (d, cfg.d_ff)), ("wg", (d, cfg.d_ff)),
                ("wo", (cfg.d_ff, d))]
    return [(f"{layer}/{n}", shape) for n, shape in out]


def layer_names(cfg):
    """(param name, use_moe) of every layer: ``first{i}``, then ``b{i}``."""
    from repro_torch.models.transformer import layer_slots
    nf = cfg.first_dense_layers
    return [(f"first{i}" if i < nf else f"b{i - nf}", moe)
            for i, (_, moe) in enumerate(layer_slots(cfg))]


def slice_tasks(key, offset):
    """The pool's tasks for one of the slice's models, largest first: every
    packed weight (std 1/sqrt(K)), the head's slabs and a vision model's
    ``patch_proj``, for v2 and v3 (all three formats for the kernel rows'
    weights)."""
    cfg = slice_config(key)
    named = [t for layer, moe in layer_names(cfg)
             for t in layer_linears(cfg, layer, moe)]
    ns = head_slabs(cfg)
    named += [(f"head/{j}", (cfg.d_model, cfg.vocab // ns))
              for j in range(ns)]
    if cfg.frontend:
        named.append(("patch_proj", (cfg.d_model, cfg.d_model)))
    tasks = [(name, SEED * 1000 + offset + i, shape,
              HEAD_STD if name.startswith("head/") else shape[0] ** -0.5,
              "all" if name in ROW_WEIGHTS[key] else ("v2", "v3"))
             for i, (name, shape) in enumerate(named)]
    return sorted(tasks, key=lambda t: -t[2][0] * t[2][1])


def stack_slices(parts):
    """One stacked [E, ...] packed param from E packed slices: every leaf
    on a new lead axis, the operand lists padded to the longest slice's
    with the packers' fill (rowscale 1, everything else 0), as
    ``convert_params_to_sme`` pads a stacked weight."""
    out = {}
    for key in parts[0]:
        arrs = [p[key] for p in parts]
        if key.startswith("sme_v") and not key.endswith(("_nnz", "v3_sign",
                                                        "v3_rowscale")):
            L = max(a.shape[1] for a in arrs)
            fill = 1 if key.endswith("rowscale") else 0
            arrs = [np.pad(a, [(0, 0), (0, L - a.shape[1])]
                           + [(0, 0)] * (a.ndim - 2), constant_values=fill)
                    for a in arrs]
        out[key] = np.stack(arrs)
    return out


def check_stack():
    """At 3 x 256 x 384 (one slice with an empty tile, so its lists are
    shorter): slices packed alone and stacked are byte for byte one
    conversion of the stacked weight."""
    from repro_torch.core.integrate import convert_params_to_sme
    w = np.random.default_rng(SEED + 10).standard_normal(
        (3, 256, 384), dtype=np.float32) * np.float32(0.06)
    w[1, 128:, 128:256] = 0.0

    def pack(a):
        p = convert_params_to_sme({"w": a}, backend=("v2", "v3"),
                                  device="cpu")
        return {k: t.numpy() for k, t in p["w"].items()}
    whole = pack(w)
    stacked = stack_slices([pack(np.ascontiguousarray(w[e]))
                            for e in range(3)])
    check(sorted(stacked) == sorted(whole) and all(
        stacked[k].dtype == whole[k].dtype
        and stacked[k].shape == whole[k].shape
        and stacked[k].tobytes() == whole[k].tobytes() for k in whole),
        "stacked expert slices differ from one conversion of the stack")


def slice_params(dev, key, cfg, got):
    """The packed model on the card from the pool's results: experts
    stacked per layer, a numpy-seeded router (std 0.02), unit norms, the
    head's slabs joined, the embedding drawn on the card; and the host
    copies of the kernel rows' weights (with their v1 operands, which the
    stacked experts do not keep)."""
    from repro_torch.core.integrate import to_torch
    rows = {name: got[name] for name in ROW_WEIGHTS[key]}
    rng = np.random.default_rng(SEED + 8)
    d = cfg.d_model
    ones = np.ones(d, np.float32)

    def lin(name):
        return {"w": got.pop(name)}

    def v2v3(p):
        return {k: v for k, v in p.items() if not k.startswith("sme_v1_")}
    tree = {"final_norm": {"w": ones}, "blocks": []}
    for layer, moe in layer_names(cfg):
        mix = {k: lin(f"{layer}/{k}") for k in (
            ("q", "kv_down", "kv_up", "o") if cfg.attn_type == "mla"
            else "qkvo")}
        if moe:
            mlp = {"router": {"w": rng.standard_normal(
                (d, cfg.n_experts), dtype=np.float32) * np.float32(0.02)}}
            for w in ("wi", "wg", "wo"):
                mlp[w] = stack_slices([v2v3(got.pop(f"{layer}/{w}/{e}"))
                                       for e in range(cfg.n_experts)])
            if cfg.n_shared_experts:
                mlp["shared"] = {w: lin(f"{layer}/shared/{w}")
                                 for w in ("wi", "wg", "wo")}
        else:
            mlp = {w: lin(f"{layer}/{w}") for w in ("wi", "wg", "wo")}
        block = {"norm1": {"w": ones}, "mix": mix, "norm2": {"w": ones},
                 "mlp": mlp}
        if layer.startswith("first"):
            tree[layer] = block
        else:
            tree["blocks"].append(block)
    slabs = [got.pop(f"head/{j}") for j in range(head_slabs(cfg))]
    check(len({float(p["sme_scale"][0, 0]) for p in slabs}) == 1,
          f"{cfg.name}: head slabs have different scales")
    tree["lm_head"] = {"w": join_columns(slabs) if len(slabs) > 1
                       else slabs[0]}
    del slabs
    if cfg.frontend:
        tree["patch_proj"] = lin("patch_proj")
    check(not got, f"{cfg.name}: packed weights left over: {sorted(got)}")
    params = to_torch(tree, dev)
    upload_check(tree, params, cfg.name)
    del tree
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    params["embed"] = {"w": torch.randn((cfg.vocab, d), generator=gen,
                                        device=dev) * EMBED_STD}
    torch.cuda.synchronize()
    return params, rows


def slice_kernel_rows(dev, key, rows_host, card):
    from repro_torch.core.integrate import to_torch
    shapes = []
    for model, label, name, K, N, ms in SLICE_SHAPES:
        if model == key:
            shapes.append((f"{model} {label}", to_torch(rows_host[name], dev),
                           oracle_weight(rows_host[name], min(N, ORACLE_COLS)),
                           K, N, ms))
    return kernel_rows(dev, shapes, card, SEED + 9) if shapes else {}


def slice_workload(key, vocab, lens=SLICE_PROMPTS):
    """4 greedy requests of prompts of ``lens`` tokens (400-600), 16 new
    tokens; for
    deepseek the first two share :data:`SLICE_SHARED` tokens and the
    second is submitted once the first has scored them (a prefix-cache
    hit).  Returns (prompts, (first wave, second wave, ready))."""
    from repro_torch.serve import Request
    rng = np.random.default_rng(SEED + 11 + len(key))
    lens = rng.integers(*lens, size=4)
    prompts = [rng.integers(0, vocab, int(n)) for n in lens]
    if key == "deepseek":
        prompts[1][:SLICE_SHARED] = prompts[0][:SLICE_SHARED]
    reqs = [Request(rid=i, prompt=p, max_new_tokens=16)
            for i, p in enumerate(prompts)]
    if key != "deepseek":
        return prompts, (reqs, [], lambda e, n: False)
    a = reqs[0]

    def ready(eng, _):
        slot = next((i for i, r in enumerate(eng.active) if r is a), None)
        return slot is not None and eng._pf_next[slot] >= SLICE_SHARED
    return prompts, ([a] + reqs[2:], [reqs[1]], ready)


def host_cpu() -> str:
    """The host's CPU model and numpy's SIMD dispatch (``np.show_runtime``'s
    ``found``: the dispatched features this CPU has), to match a run to
    its card host."""
    import os
    import platform
    model = platform.processor() or "unknown"
    try:
        with open("/proc/cpuinfo") as f:
            model = next((ln.split(":", 1)[1].strip() for ln in f
                          if ln.startswith("model name")), model)
    except OSError:
        pass
    model += (f", {os.cpu_count()} CPUs, {platform.system()} "
              f"{platform.release()}")
    try:
        from numpy._core import _multiarray_umath as um
    except ImportError:                       # numpy 1.x
        from numpy.core import _multiarray_umath as um
    found = [f for f in um.__cpu_dispatch__ if um.__cpu_features__.get(f)]
    return f"host CPU {model}; numpy {np.__version__} SIMD found {found}"


def same_bytes(a: np.ndarray, t: torch.Tensor, buf: torch.Tensor) -> bool:
    """Whether card tensor ``t``, copied back through the pinned host
    buffer ``buf`` a buffer's length at a time, is byte for byte host
    array ``a`` (shape and dtype included)."""
    if tuple(a.shape) != tuple(t.shape) or \
            a.dtype != torch.empty(0, dtype=t.dtype).numpy().dtype:
        return False
    ab = np.ascontiguousarray(a).reshape(-1).view(np.uint8)
    tb = t.detach().contiguous().reshape(-1).view(torch.uint8)
    chunk = buf.numel()
    with warnings.catch_warnings():         # a read-only host array
        warnings.simplefilter("ignore", UserWarning)
        for i in range(0, ab.size, chunk):
            part = buf[:min(chunk, ab.size - i)]
            part.copy_(tb[i:i + chunk])
            if not torch.equal(part, torch.from_numpy(ab[i:i + chunk])):
                return False
    return True


def upload_check(host, params, label):
    """F4's first stage: every packed operand of ``params`` copied back
    from the card, byte for byte against the host array it was uploaded
    from (``host``, the same tree in numpy); one line per model with the
    host's CPU and numpy's SIMD dispatch."""
    t0 = time.perf_counter()
    bad, n, nbytes = [], 0, 0
    buf = torch.empty(256 * 2 ** 20, dtype=torch.uint8,
                      pin_memory=torch.cuda.is_available())

    def walk(h, d, path):
        nonlocal n, nbytes
        if isinstance(h, dict):
            for k, v in h.items():
                if isinstance(v, (dict, list, tuple)) or "sme_codes" in h:
                    walk(v, d[k], f"{path}/{k}")
        elif isinstance(h, (list, tuple)):
            for i, v in enumerate(h):
                walk(v, d[i], f"{path}/{i}")
        else:
            n += 1
            if not same_bytes(np.asarray(h), d, buf):
                bad.append(path)
            nbytes += np.asarray(h).nbytes
    walk(host, params, "")
    print(f"{label}: upload check: {n} packed operands ({nbytes / 2 ** 20:.1f}"
          f" MiB) copied back from the card, {len(bad)} differ from the host "
          f"arrays {bad[:8]} ({time.perf_counter() - t0:.1f}s); "
          f"{host_cpu()}", flush=True)
    check(not bad, f"{label}: packed operands changed in the upload: "
          f"{bad[:8]}")


def host_dequant_mismatches(params, found, rows=128):
    """F4's second stage, for the weights :func:`format_mismatches` named:
    v2's and v3's host dequantization (the plain versions on a CPU copy of
    the operands, each row block of the identity) over the row block of
    the card's first differing element; (path, differing elements on the
    host) each.  Differences here are in the packed bytes themselves;
    none here but some on the card point at the upload or the card."""
    from repro_torch.core.backend import sme_apply
    out = []
    for path, _, first in found:
        w = params
        for k in path.strip("/").split("/"):
            w = w[int(k)] if isinstance(w, (list, tuple)) else w[k]
        w = {k: v.cpu() for k, v in w.items()}
        lead = tuple(w["sme_codes"].shape[:-4])
        kk = w["sme_sign"].shape[-2]
        (idx, r0) = first
        r0 = r0 + (idx[-2] // rows) * rows
        b = min(rows, kk - r0)
        eye = torch.zeros((b, kk))
        eye[torch.arange(b), r0 + torch.arange(b)] = 1.0
        x = eye.expand(lead + (b, kk)).contiguous()
        ne = sme_apply(x, w, "v2") != sme_apply(x, w, "v3")
        out.append((path, int(ne.sum())))
    return out


def format_mismatches(params, rows=1024):
    """The packed weights of ``params`` whose v2 and v3 operands hold
    different weights on the card: each format's product with the
    identity (every output one exact product, then the same power-of-two
    scaling), in blocks of ``rows`` rows, compared bitwise.  Returns
    (path, differing elements, first (row, column)) of each."""
    from repro_torch.core.backend import sme_apply
    found = []

    def weight(path, w):
        lead = tuple(w["sme_codes"].shape[:-4])
        k = w["sme_sign"].shape[-2]
        dev = w["sme_codes"].device
        bad, first = 0, None
        for r0 in range(0, k, rows):
            b = min(rows, k - r0)
            eye = torch.zeros((b, k), device=dev)
            eye[torch.arange(b), r0 + torch.arange(b)] = 1.0
            x = eye.expand(lead + (b, k)).contiguous()
            ne = sme_apply(x, w, "v2") != sme_apply(x, w, "v3")
            if ne.any():
                bad += int(ne.sum())
                first = first or (ne.nonzero()[0].tolist(), r0)
        if bad:
            found.append((path, bad, first))

    def walk(t, path):
        if isinstance(t, dict):
            if "sme_codes" in t:
                return weight(path, t)
            for key, v in t.items():
                walk(v, f"{path}/{key}")
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(v, f"{path}/{i}")
    walk(params, "")
    return found


def slice_logits(api32, params, toks, plen, label, patches=None):
    """f32 prefill logits of one window under v2 and v3 (bitwise equal)
    and the ``torch`` backend (within :data:`TOL_SLICE`).  Returns the
    relative difference."""
    def logits(be):
        return api32.prefill(params, toks, s_max=SLICE_ONE_SHOT["s_max"],
                             plen=plen, backend=be, patches=patches)[0]
    lk = {be: logits(be) for be in ("v2", "v3", "torch")}
    if not torch.equal(lk["v2"], lk["v3"]):
        # tell a result that varies from call to call from a stable one,
        # and a kernel that parts from its plain version (the plain v2 and
        # v3 agree there) from operands that differ (they do not)
        again = {be: torch.equal(logits(be), lk[be]) for be in ("v2", "v3")}
        bad = lk["v2"] != lk["v3"]
        with plain_kernels(blocks=True):
            lp = {be: logits(be)[bad] for be in ("v2", "v3")}
        off = {be: float((lk[be][bad] - lp[be]).abs().max())
               for be in ("v2", "v3")}
        found = format_mismatches(params)
        check(False, f"{label}: f32 prefill logits differ between v2 and "
              f"v3 ({mismatch(lk['v2'], lk['v3'])} at "
              f"{bad.nonzero()[:8].tolist()}; a second call reproduces v2: "
              f"{again['v2']}, v3: {again['v3']}; there the plain v2 and v3 "
              f"are equal: {bool(torch.equal(lp['v2'], lp['v3']))}, and "
              f"|kernel - plain| is {off['v2']:.3e} (v2), {off['v3']:.3e} "
              f"(v3); weights whose v2 and v3 operands differ on the card: "
              f"{found}; their v2 and v3 host dequantizations differ in "
              f"{host_dequant_mismatches(params, found)} elements; "
              f"{host_cpu()})")
    check(bool(torch.isfinite(lk["v2"]).all())
          and lk["v2"].shape == (len(plen), api32.cfg.vocab),
          f"{label}: logits non-finite or misshapen")
    diff = float((lk["v2"] - lk["torch"]).abs().max()
                 / lk["torch"].abs().max())
    agree = int((lk["v2"].argmax(-1) == lk["torch"].argmax(-1)).sum())
    print(f"{label}: f32 prefill logits ({toks.shape[0]} x "
          f"{toks.shape[1]}) v2 == v3 bitwise; vs the torch backend: max "
          f"rel diff {diff:.2e} (tolerance {TOL_SLICE:.0e}), greedy "
          f"agreement {agree}/{len(plen)}", flush=True)
    check(diff <= TOL_SLICE, f"{label}: logits vs torch {diff}")
    return diff


def check_engine(r, per_pass, skip, label, card, spec_len):
    """An engine run of the slice: every request complete, token events
    equal to the outputs, only v3's kernels, ``per_pass`` launches per
    prefill pass and ``per_pass - skip`` per decode pass, and a draft's
    passes on the decode kernel; prints its readings."""
    eng, reqs, m = r["eng"], r["reqs"], r["eng"]._m
    mine = KERNELS_OF["v3"]
    check(all(q.outcome == "completed" and len(q.out_tokens) == 16
              for q in reqs), f"{label}: incomplete requests")
    check(all(r["events"].get(q.rid) == q.out_tokens for q in reqs),
          f"{label}: token events != out_tokens")
    want = per_pass * r["passes"] - skip * (r["passes"] - r["prefill_passes"])
    got = sum(r["launches"][k] for k in mine)
    check(got == want and all(r["launches"][k] == 0 for k in r["launches"]
                              if k not in mine)
          and all(r["launches"][k] > 0 for k in mine),
          f"{label}: launches {r['launches']} != {want} over {r['passes']} "
          f"passes ({r['prefill_passes']} prefill) of {per_pass} - {skip}")
    rounds = int(m["spec_rounds"].value)
    if spec_len:
        check(rounds > 0 and r["draft_launches"]
              == (per_pass - skip) * spec_len * rounds,
              f"{label}: draft launches {r['draft_launches']} for {rounds} "
              f"rounds")
    n_tok = sum(len(q.out_tokens) for q in reqs)
    split = ", ".join(f"{k} {n} x {ms:.1f} ms"
                      for k, (n, ms) in eng.step_ms().items())
    print(f"{label}: {r['steps']} steps ({split}); {r['passes']} passes "
          f"({r['prefill_passes']} prefill); {n_tok} tokens in "
          f"{r['wall']:.2f} s = {n_tok / r['wall']:.2f} tokens/s; spec "
          f"rounds {rounds}, accepted {int(m['spec_accepted'].value)} of "
          f"{int(m['spec_draft_tokens'].value)}; prefix hits "
          f"{int(m['prefix_hits'].value)}, snapshots "
          f"{int(m['prefix_snapshots'].value)}; TTFT s "
          + ", ".join(f"{q.rid}:{r['ttft'][q.rid]:.2f}" for q in reqs)
          + f" | {card}", flush=True)
    return n_tok / r["wall"]


def slice_setup(dev, key, packed, card):
    """The phases' common start: the packed model on the card, its
    readings, and its kernel rows."""
    from repro_torch.core.integrate import sme_operand_bytes
    from repro_torch.models.transformer import model_layers
    cfg = slice_config(key)
    got, pack_s, wait_s = packed
    params, rows_host = slice_params(dev, key, cfg, got)
    del got
    ob = sme_operand_bytes(params)
    per_pass = packed_linears(params)
    # MLA decode reads a packed kv_up as its dequantized matrix (R4)
    skip = sum(isinstance(p["mix"].get("kv_up", {}).get("w"), dict)
               for p in model_layers(params, cfg))
    print(f"{cfg.name}: {ob['weights']} packed weights, {per_pass} launches "
          f"per prefill pass ({per_pass - skip - (1 if cfg.frontend else 0)}"
          f" per decode pass), v2 {ob['v2'] / ob['weights']:.4f} B and v3 "
          f"{ob['v3'] / ob['weights']:.4f} B per weight; packed on the host "
          f"by the pool: {pack_s:.1f}s from its start, {wait_s:.1f}s waited "
          f"here; card memory {torch.cuda.memory_allocated() / 2 ** 30:.2f} "
          f"GiB | {card}", flush=True)
    rows = slice_kernel_rows(dev, key, rows_host, card)
    del rows_host
    out = {"weights": ob["weights"], "pack_s": pack_s, "pack_wait_s": wait_s,
           "card_gib": torch.cuda.memory_allocated() / 2 ** 30,
           "launches_per_pass": per_pass}
    return cfg, params, skip, rows, out


def save_slice(params, cfg, path, label):
    """Write a slice model's packed tree once as a ``.smez`` (the
    reference's layout, no plan) for the slice's mesh phase; returns its
    seconds."""
    from repro_torch.compiler.artifact import save_artifact
    from repro_torch.convert import to_reference
    t0 = time.perf_counter()
    save_artifact(path, to_reference(params, len(cfg.pattern)))
    dt = time.perf_counter() - t0
    print(f"{label}: packed tree written to a .smez for the mesh phase in "
          f"{dt:.1f}s", flush=True)
    return dt


def moe_phase(dev, card, key, packed, save_to=None):
    """An MoE model at full width: its kernel rows; one-shot serving under
    auto (v2) and v3 (equal tokens, 3 x E expert launches per MoE layer
    per pass, routing drops); f32 prefill logits; the engine on v3 (mixtral
    with spec and without, equal tokens; deepseek with spec and the prefix
    cache, MLA's leaves paged and each packed ``kv_up`` dequantized
    once).  With ``save_to`` the packed tree is written there as a
    ``.smez`` (:func:`save_slice`).  Returns the kernel rows, launches per
    kernel and readings."""
    from repro_torch.core.backend import cached_dequant
    from repro_torch.models.model import build_model
    from repro_torch.models.moe import moe_drops
    t_phase = time.perf_counter()
    builds0 = cached_dequant.builds
    cfg = slice_config(key)
    label = f"moe[{cfg.name}]"
    n_moe = sum(cfg.moe_for_slot(j) for j in range(len(cfg.pattern))) \
        * cfg.n_super
    mla = f" kv_lora {cfg.kv_lora}" if cfg.kv_lora else ""
    shared = (f" + {cfg.n_shared_experts} shared" if cfg.n_shared_experts
              else "")
    print(f"{label}: full width (d_model {cfg.d_model}, {cfg.n_heads} heads, "
          f"{cfg.attn_type}{mla}, {cfg.n_experts} experts top-{cfg.top_k} of "
          f"{cfg.expert_dff}{shared}, vocab {cfg.vocab}); depth cut from "
          f"{SLICE_DEPTH[key]} layers to {cfg.n_layers} "
          f"({cfg.first_dense_layers} leading dense + {n_moe} MoE); "
          f"{3 * cfg.n_experts} expert launches per MoE layer per pass",
          flush=True)
    check_stack()
    cfg, params, skip, rows, out = slice_setup(dev, key, packed, card)
    api = build_model(cfg, device=dev)
    prompts, waves = slice_workload(key, cfg.vocab)
    launches = {name: 0 for name in KERNELS}
    tokens = {}
    for backend in ("auto", "v3"):
        moe_drops.update(dropped=0, routed=0)
        tokens[backend], counts = serve_run(
            api, params, prompts, backend, card, engine_kw=SLICE_ONE_SHOT,
            label=f"{label} {backend}", decode_skip=skip)
        for k in launches:
            launches[k] += counts[k]
        dropped, routed = int(moe_drops["dropped"]), int(moe_drops["routed"])
        print(f"{label} {backend}: routing drops {dropped} of {routed} "
              f"routed (token, expert) entries, all in the one prefill "
              f"(decode passes run at capacity 1 per row and drop none)",
              flush=True)
        out[f"drops_{backend}"] = dropped
    check(tokens["auto"] == tokens["v3"], f"{label}: v2 and v3 tokens differ")
    print(f"{label}: one-shot tokens of auto (v2) and v3 identical; distinct "
          f"tokens per request: "
          + ", ".join(f"{i}:{len(set(t))}" for i, t in
                      enumerate(tokens["v3"])), flush=True)
    toks, plen = prefill_window(prompts, SLICE_ONE_SHOT["s_max"])
    api32 = build_model(dataclasses.replace(cfg, dtype="float32"), device=dev)
    out["logits_rel_torch"] = slice_logits(api32, params, toks, plen, label)
    del api32
    torch.cuda.empty_cache()
    profile_window(api, params, prompts, card, "auto",
                   engine_kw=SLICE_ONE_SHOT)

    depth, deepest, _, _ = choose_spec_depth(params)
    runs = {}
    specs = (("spec", depth), ("spec off", None)) if key == "mixtral" \
        else (("spec+prefix", depth),)
    for name, spec in specs:
        _, w = slice_workload(key, cfg.vocab, ENGINE_PROMPTS)
        r = runs[name] = engine_run(api, params, "v3", spec, True,
                                    engine_kw=SLICE_ENGINE, waves=w)
        for k in launches:
            launches[k] += r["launches"][k]
        out[f"engine_{name}_tokens_per_s"] = check_engine(
            r, out["launches_per_pass"], skip, f"{label} engine[{name}]",
            card, SLICE_ENGINE["spec_len"] if spec else 0)
    greedy = [[q.out_tokens for q in r["reqs"]] for r in runs.values()]
    check(all(g == greedy[0] for g in greedy),
          f"{label}: engine tokens with spec and without differ")
    if key == "deepseek":
        eng = runs["spec+prefix"]["eng"]
        check(eng._paged is not None and all(
            kinds == {"c": True, "k_pe": True} for kinds in eng._paged),
            f"{label}: MLA cache leaves not classified paged: {eng._paged}")
        check(eng._m["prefix_hits"].value >= 1, f"{label}: no prefix hit")
        built = cached_dequant.builds - builds0
        check(built == skip, f"{label}: {built} dequantized kv_up matrices "
              f"built for {skip} layers")
        print(f"{label}: MLA leaves c/k_pe paged in every layer; "
              f"{built} dequantized kv_up matrices built over the phase, "
              f"one per layer (R4)", flush=True)
    print(f"{label}: engine tokens "
          f"{'with spec == without' if key == 'mixtral' else 'complete'}; "
          f"draft depth {depth} of {deepest}", flush=True)
    out["draft_depth"] = depth
    if save_to is not None:
        out["save_s"] = save_slice(params, cfg, save_to, label)
    del params
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"{label}: phase {out['phase_s']:.1f}s", flush=True)
    return rows, launches, out


def vision_phase(dev, card, packed, save_to=None):
    """llava-next-34b at full width, one layer: one-shot through the model
    API with seeded random patches through the packed ``patch_proj`` (R5)
    under v2 and v3 (equal tokens, counted launches), f32 prefill logits,
    then the engine with 2 requests admitted whole (no chunked step, no
    prefix cache; positions count the 576 frontend tokens).  With
    ``save_to`` the packed tree is written there as a ``.smez``."""
    from repro_torch.models.model import build_model
    from repro_torch.serve import Request
    t_phase = time.perf_counter()
    cfg = slice_config("llava")
    label = f"vision[{cfg.name}]"
    front = cfg.n_frontend_tokens
    print(f"{label}: full width (d_model {cfg.d_model}, {cfg.n_heads} heads "
          f"of {cfg.hd}, GQA kv {cfg.n_kv_heads}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab}, {front} patch embeddings through a packed "
          f"patch_proj {cfg.d_model}x{cfg.d_model}); depth cut from "
          f"{SLICE_DEPTH['llava']} layers to {cfg.n_layers}", flush=True)
    cfg, params, skip, rows, out = slice_setup(dev, "llava", packed, card)
    check(isinstance(params["patch_proj"]["w"], dict), "patch_proj packed")
    per_pass = out["launches_per_pass"]
    api = build_model(cfg, device=dev)
    prompts, _ = slice_workload("llava", cfg.vocab)
    toks, lens = prefill_window(prompts, SLICE_ONE_SHOT["s_max"])
    plen = np.array(lens) + front
    patches = torch.as_tensor(np.random.default_rng(SEED + 12)
                              .standard_normal((4, front, cfg.d_model),
                                               dtype=np.float32),
                              device=dev).to(torch.bfloat16)
    launches = {name: 0 for name in KERNELS}
    tokens = {}
    for backend in ("v2", "v3"):
        mine = KERNELS_OF[backend]
        torch.cuda.synchronize()
        zero_counts()
        with quiet():
            t0 = time.perf_counter()
            logits, caches = api.prefill(params, toks, s_max=SLICE_ONE_SHOT[
                "s_max"], plen=plen, backend=backend, patches=patches)
            seq = [logits.argmax(-1)]
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            pos = torch.as_tensor(plen, device=dev)
            for _ in range(15):
                logits, caches = api.decode_step(params, seq[-1][:, None],
                                                 caches, pos, backend=backend)
                seq.append(logits.argmax(-1))
                pos = pos + 1
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        counts = {name: fn.launches for name, fn in wrappers().items()}
        for k in launches:
            launches[k] += counts[k]
        tokens[backend] = torch.stack(seq, 1).cpu().tolist()
        want = per_pass + 15 * (per_pass - 1)        # patch_proj: prefill
        check(sum(counts[k] for k in mine) == want
              and all(counts[k] == 0 for k in counts if k not in mine)
              and all(counts[k] > 0 for k in mine),
              f"{label} {backend}: launches {counts}, want {want} of {mine}")
        print(f"{label} one-shot {backend}: prefill 4 x {toks.shape[1]} "
              f"tokens + {front} patches {1e3 * (t1 - t0):.1f} ms, "
              f"{1e3 * (t2 - t1) / 15:.2f} ms per decode step; launches "
              f"{counts} | {card}", flush=True)
        out[f"prefill_ms_{backend}"] = 1e3 * (t1 - t0)
        out[f"decode_ms_{backend}"] = 1e3 * (t2 - t1) / 15
        del caches, logits
    check(tokens["v2"] == tokens["v3"], f"{label}: v2 and v3 tokens differ")
    print(f"{label}: one-shot tokens (seeded patches) of v2 and v3 "
          f"identical; distinct tokens per request: "
          + ", ".join(f"{i}:{len(set(t))}" for i, t in
                      enumerate(tokens["v3"])), flush=True)
    api32 = build_model(dataclasses.replace(cfg, dtype="float32"), device=dev)
    out["logits_rel_torch"] = slice_logits(api32, params, toks, plen, label,
                                           patches=patches.float())
    del api32
    torch.cuda.empty_cache()
    profile_window(api, params, prompts, card, "auto",
                   engine_kw=SLICE_ONE_SHOT)

    reqs = [Request(rid=i, prompt=p, max_new_tokens=16)
            for i, p in enumerate(prompts[:2])]
    plens, real = [], api.prefill

    def spy(*a, **kw):
        plens.append(np.asarray(kw["plen"]).tolist())
        return real(*a, **kw)
    api.prefill = spy               # engine_run wraps it and removes both
    r = engine_run(api, params, "v3", None, True, engine_kw=SLICE_ENGINE,
                   waves=(reqs, [], lambda e, n: False))
    for k in launches:
        launches[k] += r["launches"][k]
    eng = r["eng"]
    check(eng._prefix is None and eng.step_ms()["chunked"][0] == 0
          and eng.stats["prefills"] == 1,
          f"{label} engine: admission not whole-prompt ({eng.step_ms()}, "
          f"{eng.stats['prefills']} prefills)")
    check(plens == [[len(q.prompt) + front for q in reqs]],
          f"{label} engine: prefill plen {plens}, want prompt + {front}")
    out["engine_tokens_per_s"] = check_engine(
        r, per_pass, 1, f"{label} engine", card, 0)
    print(f"{label} engine: {len(reqs)} prompts of "
          f"{[len(q.prompt) for q in reqs]} tokens admitted whole in one "
          f"prefill (plen counts the {front} frontend tokens; chunk_len "
          f"{SLICE_ENGINE['chunk_len']} ignored, no prefix cache)", flush=True)
    if save_to is not None:
        out["save_s"] = save_slice(params, cfg, save_to, label)
    del params
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"{label}: phase {out['phase_s']:.1f}s", flush=True)
    return rows, launches, out


# ---------------------------------------------------------------------------
# mesh serving of MLA (deepseek-v2-lite) and the vision frontend (llava) at
# full width, from the trees phase 7 packed

#: the gloo runs, on 4 ranks sharing the card: (model, backend, (data,
#: model), workload)
SLICE_MESH_RUNS = (("deepseek", "v2", (2, 2), "one-shot"),
                   ("deepseek", "v2", (1, 4), "one-shot"),
                   ("deepseek", "v3", (2, 2), "spec+prefix"),
                   ("llava", "v2", (2, 2), "one-shot"))
#: the 1x1 runs they are held to: (model, backend, workload)
#: 4 prompts of 64-128 tokens, 16 new tokens each
SLICE_MESH_PROMPTS = (64, 129)
SLICE_MESH_NEW = 16
#: the spec+prefix workload's chunk: its prompts are cut to one chunk,
#: the second to the first's chunk and one token of its own, so that it
#: hits the first's snapshot and scores one position (a chunked tail is
#: a decode pass per token, which 4 ranks sharing a card over gloo pay
#: many times over)
SLICE_MESH_CHUNK = 64
SLICE_MESH_ENGINE = {
    "one-shot": dict(slots=4, s_max=1024, chunk_len=1024, prefix_cache=False),
    # an enc-dec model's (one request per window, no prefix cache)
    "spec": dict(slots=4, s_max=1024, chunk_len=1024, prefix_cache=False,
                 spec_len=2),
    "spec+prefix": dict(slots=4, s_max=1024, chunk_len=SLICE_MESH_CHUNK,
                        page_tokens=16, prefix_cache=True, spec_len=2)}


def slice_mesh_prompts(vocab, workload="one-shot"):
    rng = np.random.default_rng(SEED + 13)
    lens = rng.integers(*SLICE_MESH_PROMPTS, size=4)
    prompts = [rng.integers(0, vocab, int(n)) for n in lens]
    if workload == "spec+prefix":
        c = SLICE_MESH_CHUNK
        prompts = [p[:c] for p in prompts]
        prompts[1] = np.concatenate([prompts[0], [prompts[1][0]]])
    return prompts


def split_weights(tree, path=""):
    """'/'-joined names of a placed tree's weights split over 'model'."""
    from repro_torch.parallel.sharding import split_of
    if isinstance(tree, dict):
        if "sme_codes" in tree:
            return [path] if split_of(tree) is not None else []
        return [n for k, v in tree.items()
                for n in split_weights(v, f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree)
                for n in split_weights(v, f"{path}/{i}")]
    return [path] if split_of(tree) is not None else []


def slice_mesh_serve(api, path, backend, mesh, workload, depth,
                     params=None, new=SLICE_MESH_NEW):
    """Serve the 4 prompts once from the artifact at ``path`` on ``mesh``
    (or from ``params``, its tree booted whole on the card), ``new`` new
    tokens each:
    (tokens in request order, the engine, launches per kernel), the counts
    set to 0 just before the run.  ``spec+prefix`` drafts at ``depth``
    and submits the second request once the others are admitted, so that
    it hits the first's snapshot; ``spec`` drafts at ``depth`` alone."""
    from repro_torch.serve import Request, ServeEngine
    kw = dict(SLICE_MESH_ENGINE[workload])
    if workload.startswith("spec"):
        kw["spec_depth"] = depth
    eng = ServeEngine.from_artifact(api, path, mesh=mesh, backend=backend,
                                    **kw) if params is None else \
        ServeEngine(api, params, mesh=mesh, backend=backend, **kw)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=new)
            for i, p in enumerate(slice_mesh_prompts(api.cfg.vocab,
                                                     workload))]
    waves = [reqs] if workload != "spec+prefix" else \
        [[reqs[0]] + reqs[2:], [reqs[1]]]
    sync(mesh.device)
    zero_counts()
    with quiet():              # its ms per decode step is a reading
        for wave in waves:
            for r in wave:
                eng.submit(r)
            eng.pump()
        for _ in range(400):
            if all(r.done for r in reqs):
                break
            eng.pump()
            eng.step()
        sync(mesh.device)
    launches = {name: fn.launches for name, fn in wrappers().items()}
    label = (f"{api.cfg.name} {mesh.data}x{mesh.model} {backend} "
             f"{workload}")
    check(all(r.outcome == "completed" and len(r.out_tokens)
              == new for r in reqs)
          and eng.rank_mismatches == 0 and eng.stats["backend"] == backend,
          f"mesh {label}: outcomes {[r.outcome for r in reqs]}, rank "
          f"mismatches {eng.rank_mismatches}, backend {eng.stats['backend']}")
    if workload == "spec+prefix":
        check(eng._m["prefix_hits"].value >= 1,
              f"mesh {label}: no prefix hit")
    if workload.startswith("spec"):
        check(eng._m["spec_rounds"].value > 0,
              f"mesh {label}: no spec round")
    return [r.out_tokens for r in reqs], eng, launches


def slice_mesh_logits(api32, params, policy):
    """f32 logits of the 4 prompts' prefill window (llava's behind seeded
    patches; an enc-dec model's not ragged: the prompts cut to the
    shortest, over as many seeded random frames), computed on every rank
    of the policy's mesh."""
    from repro_torch.parallel.policy import use_policy
    cfg = api32.cfg
    s_max = SLICE_MESH_ENGINE["one-shot"]["s_max"]
    prompts = slice_mesh_prompts(cfg.vocab)
    if api32.encdec:
        n = min(len(q) for q in prompts)
        frames = torch.as_tensor(np.random.default_rng(SEED + 22)
                                 .standard_normal((4, n, cfg.d_model),
                                                  dtype=np.float32),
                                 device=api32.device)
        with use_policy(policy):
            return api32.prefill(params, np.stack([q[:n] for q in prompts]),
                                 s_max=s_max, frames=frames)[0].cpu()
    toks, lens = prefill_window(prompts, s_max)
    plen, extra = np.array(lens), {}
    if cfg.frontend == "vision_stub":
        front = cfg.n_frontend_tokens
        extra["patches"] = torch.as_tensor(
            np.random.default_rng(SEED + 12).standard_normal(
                (4, front, cfg.d_model), dtype=np.float32),
            device=api32.device)
        plen = plen + front
    with use_policy(policy):
        return api32.prefill(params, toks, s_max=s_max, plen=plen,
                             **extra)[0].cpu()


def mesh_family_rank(rank, world, store, tmp, device, family, depths):
    """One of the four gloo ranks on the one card: serve the runs of
    :data:`MESH_FAMILIES` ``[family]`` from the artifacts its phase wrote
    (``tmp/<model>.smez``), with each run's f32 prefill logits (rank 0's
    kept); the results go to ``tmp/<family>{rank}.pt``."""
    import os
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import _leaves
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    tmp = pathlib.Path(tmp)
    fam = MESH_FAMILIES[family]
    apis = {}
    for key in fam["keys"]:
        cfg = family_config(family, key)
        apis[key] = (build_model(cfg, device=dev), build_model(
            dataclasses.replace(cfg, dtype="float32"), device=dev))
    (tmp / f"ready{rank}").touch()
    while not (tmp / "go").exists():
        time.sleep(0.05)
    out = {"runs": {}}
    for run in fam["runs"]:
        key, backend, shape, workload = run
        mesh = make_local_mesh(*shape, device=dev)
        api, api32 = apis[key]
        tokens, eng, launches = slice_mesh_serve(
            api, tmp / f"{key}.smez", backend, mesh, workload, depths[key],
            new=fam["new"])
        logits = slice_mesh_logits(api32, eng.params, eng.policy)
        st = eng.stats
        out["runs"][run] = dict(
            tokens=tokens, bytes=tree_bytes(eng.params),
            state_bytes=tree_bytes(eng.caches), launches=launches,
            ms=st["decode_s"] / st["decode_steps"] * 1e3,
            split=split_weights(eng.params),
            cache=[tuple(t.shape) for _, t in _leaves(eng.caches[0])],
            states=[{k: tuple(t.shape) for k, t in _leaves(layer)}
                    for layer in eng.caches],
            kinds=cache_kinds(eng.caches),
            logits=logits if rank == 0 else None)
        del eng
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    out["jax"] = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "repro"))
    torch.save(out, tmp / f"{family}{rank}.pt")
    dist.destroy_process_group()
    os._exit(0)


def mesh_split(key, got, ref, shape):
    """(what must be split over 'model' in a run of ``key`` on a ``shape``
    mesh, whether rank 0's run ``got`` splits it against the 1x1 run
    ``ref``): deepseek's ``kv_up`` and llava's ``patch_proj`` among its
    split weights; for Jamba, xLSTM and whisper every layer's cache at
    the shard shapes of the engine's rule (``cache_sharding(exact=True)``,
    rank 0's coordinates) and, of Mamba's ``conv``/``h`` (layer 0),
    mLSTM's ``C``/``n`` or whisper's cross ``k``/``v``, those the rule
    splits narrower than 1x1's beyond their slot rows (at full width all
    of them); for whisper also the head, split where 'model' divides its
    column tiles (406: on 2, not on 4) and whole elsewhere."""
    if key in ("deepseek", "llava"):
        want = "patch_proj" if key == "llava" else "kv_up"
        return want, any(want in n for n in got["split"])
    from repro_torch.launch.mesh import Mesh
    from repro_torch.parallel.sharding import cache_sharding, shard_shape
    mesh = Mesh(*shape, rank=0, device="cpu", groups={"world": None})
    whole = [{k: torch.empty(s, device="meta") for k, s in layer.items()}
             for layer in ref["states"]]
    specs = cache_sharding(mesh, whole, whole[0][next(iter(whole[0]))]
                           .shape[0], exact=True)
    rule = [{k: shard_shape(mesh, sp[k], t.shape) for k, t in layer.items()}
            for layer, sp in zip(whole, specs)]
    names = [n for n in {"jamba": ("conv", "h"), "xlstm": ("C", "n"),
                         "whisper": ("cross/k", "cross/v")}[key]
             if got["states"][0][n][1:] != ref["states"][0][n][1:]]
    ok = bool(names) and got["states"] == rule
    if key == "whisper":
        nc = -(-family_config("encdec", key).vocab // 128)
        head = "/lm_head/w" in got["split"]
        names += ["lm_head"] if head else []
        ok = ok and head == (nc % shape[1] == 0)
    return ("/".join(names) or "nothing"), ok


def mesh_family_phase(dev, card, tmp, family, depths):
    """Mesh serving of one family (:data:`MESH_FAMILIES`) from the
    artifacts of its models' packed trees (``tmp/<model>.smez``): the 1x1
    mesh through an NCCL group of world size 1 in this process (each tree
    booted whole on the card), then the family's runs on four gloo ranks
    sharing the card (correctness only).  For MLA and the vision frontend
    the ranks start first and the group is made once they wait; for the
    recurrent family the group is made before any rank starts, and the
    ranks start while the 1x1 runs serve.  Every rank's tokens must equal the 1x1 run's, rank 0's f32
    prefill logits its logits bitwise, :func:`mesh_split`'s leaves must be
    split and each run's kernels launched.  Returns the readings and the
    launches per kernel of every run (the ranks' summed)."""
    import torch.distributed as dist
    from repro_torch.compiler.artifact import load_artifact
    from repro_torch.convert import split_reference
    from repro_torch.launch.mesh import Mesh, make_local_mesh
    from repro_torch.models.model import build_model
    from repro_torch.parallel.sharding import place_tree
    from repro_torch.serve.engine import _leaves
    fam = MESH_FAMILIES[family]
    t_phase = time.perf_counter()
    out, launches = {"runs": {}}, {name: 0 for name in KERNELS}
    one_runs = sorted({(k, b, w) for k, b, _, w in fam["runs"]})
    ctx = None

    def spawn():
        return torch.multiprocessing.start_processes(
            mesh_family_rank,
            args=(MESH_RANKS, str(tmp / f"gloo-{family}"), str(tmp),
                  str(dev), family, depths),
            nprocs=MESH_RANKS, join=False, start_method="spawn")

    def ranks_ready():
        while not all((tmp / f"ready{r}").exists()
                      for r in range(MESH_RANKS)):
            check(all(p.is_alive() for p in ctx.processes),
                  f"a mesh rank died before serving ({family})")
            time.sleep(0.1)

    for r in range(MESH_RANKS):
        (tmp / f"ready{r}").unlink(missing_ok=True)
    (tmp / "go").unlink(missing_ok=True)
    try:
        if fam["ranks_first"]:
            ctx = spawn()
        # each tree booted once, whole on the card (the 1x1 mesh's
        # placement, which its engines take as it is)
        trees = {key: place_tree(split_reference(load_artifact(
            tmp / f"{key}.smez")[0]), Mesh(1, 1, device=dev))
            for key in fam["keys"]}
        if ctx is not None:
            # NCCL starts once the ranks' CUDA contexts exist and they wait
            ranks_ready()
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method=f"file://{tmp}/nccl-{family}",
                                rank=0, world_size=1)
        if ctx is None:
            # the group made, the ranks start while the 1x1 runs serve
            ctx = spawn()
        one = {}
        try:
            mesh = make_local_mesh(1, 1, device=dev)
            for key, backend, workload in one_runs:
                cfg = family_config(family, key)
                api = build_model(cfg, device=dev)
                api32 = build_model(dataclasses.replace(cfg, dtype="float32"),
                                    device=dev)
                tokens, eng, counts = slice_mesh_serve(
                    api, tmp / f"{key}.smez", backend, mesh, workload,
                    depths[key], trees[key], fam["new"])
                check(all(counts[k] > 0 for k in KERNELS_OF[backend]),
                      f"mesh 1x1 {key} {backend}: a kernel of the path "
                      f"never launched: {counts}")
                for k in launches:
                    launches[k] += counts[k]
                st = eng.stats
                run = one[(key, backend, workload)] = dict(
                    tokens=tokens, bytes=tree_bytes(eng.params),
                    state_bytes=tree_bytes(eng.caches),
                    states=[{k: tuple(t.shape) for k, t in _leaves(layer)}
                            for layer in eng.caches],
                    kinds=cache_kinds(eng.caches),
                    ms=st["decode_s"] / st["decode_steps"] * 1e3,
                    logits=slice_mesh_logits(api32, eng.params, eng.policy))
                check(bool(torch.isfinite(run["logits"]).all())
                      and run["logits"].shape == (4, cfg.vocab),
                      f"mesh 1x1 {key} {backend}: logits non-finite or "
                      f"misshapen")
                print(f"mesh[{cfg.name} 1x1 {backend} {workload}]: an NCCL "
                      f"group of world size 1 ({mesh.backend}); "
                      f"{run['ms']:.2f} ms per decode step, "
                      f"{run['bytes'] / 2 ** 20:.1f} MiB of params, "
                      f"{run['state_bytes'] / 2 ** 20:.1f} MiB of caches"
                      f"{kinds_mib(run['kinds'])}; "
                      f"launches {counts} | {card}", flush=True)
                out["runs"][f"{key} {backend} {workload} 1x1 nccl"] = dict(
                    ms=run["ms"], bytes=run["bytes"],
                    state_bytes=run["state_bytes"], kinds=run["kinds"])
                del eng
        finally:
            dist.destroy_process_group()
        del trees
        free_card()
        ranks_ready()
        t_ready = time.perf_counter()
        # the pool pauses while the MLA and vision ranks serve (their ms
        # are readings); it packs on beside the recurrent ranks
        with (quiet() if fam["pause"] else contextlib.nullcontext()):
            (tmp / "go").touch()
            while not ctx.join(timeout=1):
                pass
        serve_s = time.perf_counter() - t_ready
    finally:
        if ctx is not None:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
    ranks = [torch.load(tmp / f"{family}{r}.pt", weights_only=False)
             for r in range(MESH_RANKS)]
    for run in fam["runs"]:
        key, backend, shape, workload = run
        name = family_config(family, key).name
        label = f"{name} {shape[0]}x{shape[1]} {backend} {workload}"
        ref = one[(key, backend, workload)]
        got = [r["runs"][run] for r in ranks]
        for i, g in enumerate(got):
            check(g["tokens"] == ref["tokens"],
                  f"mesh {label}: rank {i}'s tokens differ from 1x1")
        summed = {k: sum(g["launches"][k] for g in got) for k in KERNELS}
        check(all(summed[k] > 0 for k in KERNELS_OF[backend]),
              f"mesh {label}: a kernel of the path never launched: {summed}")
        for k in launches:
            launches[k] += summed[k]
        check(bool(torch.equal(got[0]["logits"], ref["logits"])),
              f"mesh {label}: rank 0's f32 prefill logits differ from 1x1: "
              f"{mismatch(got[0]['logits'], ref['logits'])}")
        want, ok = mesh_split(key, got[0], ref, shape)
        check(ok, f"mesh {label}: {want} not split over 'model': "
              f"{got[0]['split']}, {got[0]['states'][0]}")
        ms = [g["ms"] for g in got]
        nbytes = [g["bytes"] for g in got]
        sbytes = [g["state_bytes"] for g in got]
        split = got[0]["split"]
        out["runs"][label] = dict(ms=ms, bytes=nbytes,
                                  bytes_1x1=ref["bytes"],
                                  state_bytes=sbytes,
                                  state_bytes_1x1=ref["state_bytes"],
                                  launches=summed, split=len(split),
                                  cache=got[0]["cache"],
                                  states=got[0]["states"][0],
                                  kinds=got[0]["kinds"])
        frac = ", ".join(f"{b / ref['bytes']:.3f}" for b in nbytes)
        sfrac = ", ".join(f"{b / ref['state_bytes']:.3f}" for b in sbytes)
        print(f"mesh[{label}]: 4 ranks, every rank's tokens == 1x1, rank 0's "
              f"f32 prefill logits == 1x1 bitwise, rank mismatches 0; params "
              f"per rank {', '.join(f'{b / 2 ** 20:.1f}' for b in nbytes)} "
              f"MiB against 1x1's {ref['bytes'] / 2 ** 20:.1f} MiB ({frac}); "
              f"caches per rank "
              f"{', '.join(f'{b / 2 ** 20:.1f}' for b in sbytes)} MiB "
              f"against {ref['state_bytes'] / 2 ** 20:.1f} MiB ({sfrac})"
              f"{kinds_mib(got[0]['kinds'])} on rank 0; "
              f"{len(split)} weights split over 'model', {want} split; "
              f"rank 0's first layer's cache {got[0]['states'][0]} "
              f"(1x1: {ref['states'][0]}); "
              f"{', '.join(f'{t:.1f}' for t in ms)} ms per decode step "
              f"(gloo, 4 ranks on one card: correctness only); launches "
              f"{summed} | {card}", flush=True)
    check(all(r["jax"] == [] for r in ranks), "a mesh rank imported jax")
    out["serve_s"] = serve_s
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"mesh[{family}]: phase {out['phase_s']:.1f}s of its 60 s budget "
          f"({serve_s:.1f}s of gloo serving, the pool "
          f"{'paused' if fam['pause'] else 'not paused'})", flush=True)
    return out, launches


# ---------------------------------------------------------------------------
# the recurrent family: xlstm-1.3b and jamba-v0.1-52b at full width

#: the recurrent models, in phase order
RECURRENT = ("xlstm", "jamba")
#: their full depth, for the log
RECURRENT_DEPTH = {"xlstm": 48, "jamba": 32}
#: launches of one model pass: xLSTM 2 per mLSTM layer (up, down; the
#: gates are 4 wide), 4 for the sLSTM layer, 1 head; Jamba 4 Mamba, 4
#: attention, 3 + 3 MLP, 1 head
RECURRENT_PER_PASS = {"xlstm": 19, "jamba": 15}
RECURRENT_ENGINE = dict(slots=4, s_max=2048, chunk_len=256, page_tokens=16,
                        spec_len=4)
#: the recurrent kernel rows: (model, label, weight, K, N); the ragged
#: widths are ff_wi's 2730 (21.3 tiles), x_proj's 288 (2.25) and dt_w's K
#: of 256 (two row tiles)
RECURRENT_SHAPES = (
    ("xlstm", "mLSTM up 2048x8192", "b0/up", 2048, 8192),
    ("xlstm", "mLSTM down 4096x2048", "b0/down", 4096, 2048),
    ("xlstm", "sLSTM ff_wi 2048x2730", "b7/ff_wi", 2048, 2730),
    ("jamba", "in_proj 4096x16384", "b0/in_proj", 4096, 16384),
    ("jamba", "x_proj 8192x288", "b0/x_proj", 8192, 288),
    ("jamba", "dt_w 256x8192", "b0/dt_w", 256, 8192),
    ("jamba", "out_proj 8192x4096", "b0/out_proj", 8192, 4096))
#: the kernel rows' M: the one-shot decode batch and a prefill block
RECURRENT_MS = (4, 512)


def recurrent_config(key):
    """xlstm-1.3b cut to one superblock (7 mLSTM, 1 sLSTM); jamba-v0.1-52b
    cut to slots 0 (Mamba) and 4 (attention) of its superblock, both with
    the dense MLP they have in the published model."""
    from repro_torch.configs import ARCHS
    if key == "xlstm":
        return dataclasses.replace(ARCHS["xlstm-1.3b"], n_layers=8)
    return dataclasses.replace(ARCHS["jamba-v0.1-52b"], n_layers=2,
                               block_pattern=("mamba", "attn"),
                               moe_pattern=(0, 0))


#: phase 8': the recurrent family's gloo runs, on 4 ranks sharing the
#: card, from phase 8's packed trees: (model, backend, (data, model),
#: workload); the workloads are phase 7's (:data:`SLICE_MESH_ENGINE`)
RECURRENT_MESH_RUNS = (("jamba", "v2", (2, 2), "one-shot"),
                       ("jamba", "v2", (1, 4), "one-shot"),
                       ("jamba", "v3", (2, 2), "spec+prefix"),
                       ("xlstm", "v2", (2, 2), "one-shot"),
                       ("xlstm", "v2", (1, 4), "one-shot"))


def recurrent_leaves(cfg):
    """Per layer, (leaf, shape, init, std) of its params but the norms:
    the mixer's (a recurrent kind's is the model's own
    ``transformer.ssm_mix_spec``, attention's is q, k, v, o) and, with a
    ``d_ff``, the dense MLP's (``mlp/wi``, ``mlp/wg``, ``mlp/wo``); as
    ``ssm_mix_spec`` gives them."""
    from repro_torch.models.transformer import layer_slots, ssm_mix_spec
    d, ff = cfg.d_model, cfg.d_ff
    qd, kvd = cfg.n_heads * cfg.hd, cfg.n_kv_heads * cfg.hd
    attn = [("q", (d, qd)), ("k", (d, kvd)), ("v", (d, kvd)), ("o", (qd, d))]
    mlp = [("mlp/wi", (d, ff)), ("mlp/wg", (d, ff)), ("mlp/wo", (ff, d))]
    return [(ssm_mix_spec(cfg, kind) if kind != "attn" else
             [(n, sh, "linear", None) for n, sh in attn])
            + [(n, sh, "linear", None) for n, sh in (mlp if ff else [])]
            for kind, _ in layer_slots(cfg)]


def packed_leaf(shape, init) -> bool:
    """A linear of at least 128 x 128 is packed (the eligibility rule); at
    full width every linear of the recurrent models is but mLSTM's gates,
    which are 4 wide."""
    return init == "linear" and min(shape) >= 128


def recurrent_tasks(key, offset):
    """The pool's tasks for one recurrent model, largest first: every packed
    weight (``b{layer}/<leaf>``, std 1/sqrt(K)) and the head's slabs, for
    v2 and v3 (all three formats for the kernel rows' weights)."""
    cfg = recurrent_config(key)
    rows = {name for model, _, name, _, _ in RECURRENT_SHAPES if model == key}
    named = [(f"b{i}/{n}", sh, std if std is not None else sh[0] ** -0.5)
             for i, leaves in enumerate(recurrent_leaves(cfg))
             for n, sh, init, std in leaves if packed_leaf(sh, init)]
    ns = head_slabs(cfg)
    named += [(f"head/{j}", (cfg.d_model, cfg.vocab // ns), HEAD_STD)
              for j in range(ns)]
    tasks = [(name, SEED * 1000 + offset + i, shape, std,
              "all" if name in rows else ("v2", "v3"))
             for i, (name, shape, std) in enumerate(named)]
    return sorted(tasks, key=lambda t: -t[2][0] * t[2][1])


def recurrent_params(dev, key, cfg, got):
    """The packed model on the card from the pool's results, the leaves
    that stay dense drawn from a numpy seed with the model's own init,
    unit norms, the head's slabs joined, the embedding drawn on the card;
    and host copies of the kernel rows' weights."""
    from repro_torch.core.integrate import to_torch
    from repro_torch.models.transformer import ssm_leaf
    rows = {name: got[name] for model, _, name, _, _ in RECURRENT_SHAPES
            if model == key}
    rng = np.random.default_rng(SEED + 13)
    ones = np.ones(cfg.d_model, np.float32)
    tree = {"final_norm": {"w": ones}, "blocks": []}
    for i, leaves in enumerate(recurrent_leaves(cfg)):
        mix, mlp = {}, {}
        for n, sh, init, std in leaves:
            leaf = {"w": got.pop(f"b{i}/{n}")} if packed_leaf(sh, init) \
                else ssm_leaf(rng, sh, init, std)
            if n.startswith("mlp/"):
                mlp[n[4:]] = leaf
            else:
                mix[n] = leaf
        block = {"norm1": {"w": ones}, "mix": mix}
        if mlp:
            block.update(norm2={"w": ones}, mlp=mlp)
        tree["blocks"].append(block)
    slabs = [got.pop(f"head/{j}") for j in range(head_slabs(cfg))]
    check(len({float(p["sme_scale"][0, 0]) for p in slabs}) == 1,
          f"{cfg.name}: head slabs have different scales")
    tree["lm_head"] = {"w": join_columns(slabs)}
    del slabs
    check(not got, f"{cfg.name}: packed weights left over: {sorted(got)}")
    params = to_torch(tree, dev)
    upload_check(tree, params, cfg.name)
    del tree
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    params["embed"] = {"w": torch.randn((cfg.vocab, cfg.d_model),
                                        generator=gen, device=dev)
                       * EMBED_STD}
    torch.cuda.synchronize()
    return params, rows


def recurrent_workload(key, vocab, lens=SLICE_PROMPTS):
    """4 greedy requests of prompts of ``lens`` tokens (400-600), 16 new
    tokens; the first
    two share :data:`SLICE_SHARED` tokens, and the engine submits the
    second once the first has scored them (a prefix-cache hit).  Returns
    (prompts, (first wave, second wave, ready))."""
    from repro_torch.serve import Request
    rng = np.random.default_rng(SEED + 14 + len(key))
    lens = rng.integers(*lens, size=4)
    prompts = [rng.integers(0, vocab, int(n)) for n in lens]
    prompts[1][:SLICE_SHARED] = prompts[0][:SLICE_SHARED]
    reqs = [Request(rid=i, prompt=p, max_new_tokens=16)
            for i, p in enumerate(prompts)]
    a = reqs[0]

    def ready(eng, _):
        slot = next((i for i, r in enumerate(eng.active) if r is a), None)
        return slot is not None and eng._pf_next[slot] >= SLICE_SHARED
    return prompts, ([a] + reqs[2:], [reqs[1]], ready)


#: the Python time loop of each recurrent kind's prefill (in models/ssm.py)
TIME_LOOPS = {"mamba": "_selective_scan", "slstm": "_slstm_scan"}


def time_loops(dev, params, cfg, toks, plen, card):
    """ms of the one-shot prefill's Python time loops (Mamba's selective
    scan, sLSTM's recurrence) inside their layer's prefill: the layer's
    ``*_apply`` on a random input of the prefill window's shape and its
    rows' prompt lengths, with its loop wrapped between two
    synchronizations, so that one call gives the layer's ms and its
    loop's; the medians of 3 calls after a warm one, and the loop's share
    of each call."""
    from repro_torch.models import ssm
    from repro_torch.models.transformer import layer_slots
    b, s = toks.shape
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    x = torch.randn((b, s, cfg.d_model), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    pl = torch.as_tensor(plen, device=dev)
    out = {}
    for i, (kind, _) in enumerate(layer_slots(cfg)):
        if kind not in TIME_LOOPS or kind in out:
            continue
        p, name = params["blocks"][i]["mix"], TIME_LOOPS[kind]
        loop, layer = getattr(ssm, name), getattr(ssm, f"{kind}_apply")
        spans = []

        def timed(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y = loop(*a, **kw)
            torch.cuda.synchronize()
            spans.append(1e3 * (time.perf_counter() - t0))
            return y
        calls = []
        setattr(ssm, name, timed)
        try:
            with quiet():
                for _ in range(4):
                    spans.clear()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    layer(p, x, cfg, plen=pl, backend="v2")
                    torch.cuda.synchronize()
                    calls.append((1e3 * (time.perf_counter() - t0),
                                  sum(spans), len(spans)))
        finally:
            setattr(ssm, name, loop)
        calls = calls[1:]
        check(all(c[2] == 1 for c in calls),
              f"{cfg.name}: {kind} prefill ran its time loop other than "
              "once")
        layer_ms = statistics.median(c[0] for c in calls)
        loop_ms = statistics.median(c[1] for c in calls)
        share = statistics.median(c[1] / c[0] for c in calls)
        out[kind] = dict(layer_ms=layer_ms, loop_ms=loop_ms,
                         loop_share=share, steps=s)
        print(f"recurrent[{cfg.name}]: {kind} layer prefill {b} x {s} "
              f"{layer_ms:.1f} ms, of which its Python time loop ({s} "
              f"steps) {loop_ms:.1f} ms, measured inside the same calls "
              f"(share {share:.3f}) | {card}", flush=True)
    return out


def recurrent_phase(dev, card, key, packed, save_to=None):
    """A recurrent model at full width: its kernel rows; one-shot serving
    under auto (v2) and v3 (equal tokens, :data:`RECURRENT_PER_PASS`
    launches per pass); f32 prefill logits; a profiled window; the Python
    time loops' ms; the engine on v3 with spec and without, and without
    the prefix cache (equal tokens: a prefix hit restores the recurrent
    side rows and, for Jamba, the attention's pages as recomputing the
    prefix leaves them).  The packed tree is then written to ``save_to``
    (a ``.smez`` for phase 8').  Returns the kernel rows, launches per
    kernel and readings."""
    from repro_torch.core.integrate import sme_operand_bytes, to_torch
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import layer_slots
    t_phase = time.perf_counter()
    cfg = recurrent_config(key)
    label = f"recurrent[{cfg.name}]"
    print(f"{label}: full width (d_model {cfg.d_model}, {cfg.n_heads} heads, "
          f"d_ff {cfg.d_ff}, SSM state {cfg.ssm_state}, expand "
          f"{cfg.ssm_expand}, vocab {cfg.vocab}); depth cut from "
          f"{RECURRENT_DEPTH[key]} layers to {cfg.n_layers}: "
          f"{[k for k, _ in layer_slots(cfg)]}", flush=True)
    got, pack_s, wait_s = packed
    params, rows_host = recurrent_params(dev, key, cfg, got)
    del got
    ob = sme_operand_bytes(params)
    per_pass = packed_linears(params)
    check(per_pass == RECURRENT_PER_PASS[key],
          f"{label}: {per_pass} packed linears, want "
          f"{RECURRENT_PER_PASS[key]}")
    print(f"{label}: {ob['weights']} packed weights, {per_pass} launches "
          f"per pass, v2 {ob['v2'] / ob['weights']:.4f} B and v3 "
          f"{ob['v3'] / ob['weights']:.4f} B per weight; packed on the host "
          f"by the pool: {pack_s:.1f}s from its start, {wait_s:.1f}s waited "
          f"here; card memory {torch.cuda.memory_allocated() / 2 ** 30:.2f} "
          f"GiB | {card}", flush=True)
    rows = kernel_rows(dev, [
        (f"{key} {lab}", to_torch(rows_host[name], dev),
         oracle_weight(rows_host[name], min(N, ORACLE_COLS)), K, N,
         RECURRENT_MS)
        for model, lab, name, K, N in RECURRENT_SHAPES if model == key],
        card, SEED + 15)
    del rows_host
    out = {"weights": ob["weights"], "pack_s": pack_s, "pack_wait_s": wait_s,
           "card_gib": torch.cuda.memory_allocated() / 2 ** 30,
           "launches_per_pass": per_pass}
    api = build_model(cfg, device=dev)
    prompts, _ = recurrent_workload(key, cfg.vocab)
    launches = {name: 0 for name in KERNELS}
    tokens = {}
    for backend in ("auto", "v3"):
        tokens[backend], counts = serve_run(
            api, params, prompts, backend, card, engine_kw=SLICE_ONE_SHOT,
            label=f"{label} {backend}")
        for k in launches:
            launches[k] += counts[k]
    check(tokens["auto"] == tokens["v3"], f"{label}: v2 and v3 tokens differ")
    print(f"{label}: one-shot tokens of auto (v2) and v3 identical; distinct "
          f"tokens per request: "
          + ", ".join(f"{i}:{len(set(t))}" for i, t in
                      enumerate(tokens["v3"])), flush=True)
    toks, plen = prefill_window(prompts, SLICE_ONE_SHOT["s_max"])
    api32 = build_model(dataclasses.replace(cfg, dtype="float32"), device=dev)
    out["logits_rel_torch"] = slice_logits(api32, params, toks, plen, label)
    del api32
    torch.cuda.empty_cache()
    profile_window(api, params, prompts, card, "auto",
                   engine_kw=SLICE_ONE_SHOT)
    out["loops"] = time_loops(dev, params, cfg, toks, plen, card)

    depth, deepest, _, _ = choose_spec_depth(params)
    runs = {}
    for name, spec, prefix in (("spec", depth, True),
                               ("spec off", None, True),
                               ("spec off, prefix off", None, False)):
        _, w = recurrent_workload(key, cfg.vocab, ENGINE_PROMPTS)
        r = runs[name] = engine_run(api, params, "v3", spec, prefix,
                                    engine_kw=RECURRENT_ENGINE, waves=w)
        for k in launches:
            launches[k] += r["launches"][k]
        out[f"engine_{name.replace(',', '').replace(' ', '_')}"
            "_tokens_per_s"] = check_engine(
            r, per_pass, 0, f"{label} engine[{name}]", card,
            RECURRENT_ENGINE["spec_len"] if spec else 0)
        m = r["eng"]._m
        check(not prefix or (m["prefix_hits"].value >= 1
                             and m["prefix_side_rows"].value >= 1),
              f"{label} engine[{name}]: no prefix hit, or no side rows in "
              "its snapshots")
    greedy = {name: [q.out_tokens for q in r["reqs"]]
              for name, r in runs.items()}
    check(greedy["spec"] == greedy["spec off"],
          f"{label}: engine tokens with spec and without differ")
    # the hit's restored side rows (and Jamba's pages) against recomputing
    # the shared prefix: the same schedule with the prefix cache off
    check(greedy["spec off"] == greedy["spec off, prefix off"],
          f"{label}: engine tokens with a prefix hit != without the cache")
    eng = runs["spec"]["eng"]
    kinds = {k: tuple(sorted((n, "paged" if v else "side")
                             for n, v in eng._paged[i].items()))
             for i, (k, _) in enumerate(layer_slots(cfg))}
    check(all(not any(eng._paged[i].values()) if k != "attn"
              else all(eng._paged[i].values())
              for i, (k, _) in enumerate(layer_slots(cfg))),
          f"{label}: cache leaves misclassified: {eng._paged}")
    paged = any(any(k.values()) for k in eng._paged)
    print(f"{label}: cache leaves per layer kind {kinds}; the prefix hit "
          f"restored {'side rows and pages' if paged else 'side rows only'}"
          f"; engine tokens with spec == without == without the prefix "
          f"cache; draft depth {depth} of {deepest}", flush=True)
    out["draft_depth"] = depth
    del runs, eng
    if save_to is not None:
        out["save_s"] = save_slice(params, cfg, save_to, label)
    del params
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"{label}: phase {out['phase_s']:.1f}s", flush=True)
    return rows, launches, out


# ---------------------------------------------------------------------------
# the encoder-decoder family: whisper-medium at full width

#: whisper-medium's depth here, the same for both stacks: 6 of the
#: published model's 24 + 24.  At 24 + 24 (0.76 B weights packed by the
#: pool) the script took 762 s on one card host and 1,185 s of its 1,200 s
#: limit on a slower one, whose packing pool finished 80 s after Jamba's
#: and whose phase 9 took 104 s; 6 + 6 packs 0.23 B
WHISPER_LAYERS = 6
#: the published depth of each stack, for the log
WHISPER_DEPTH = 24
ENCDEC_ONE_SHOT = dict(slots=4, s_max=2048, chunk_len=2048,
                       prefix_cache=False)
#: the engine: one request per admission window, whole prompts (an enc-dec
#: model has no chunked prefill and no prefix cache)
ENCDEC_ENGINE = dict(slots=4, s_max=2048, spec_len=4)
#: whisper's kernel rows: (label, weight, K, N); the head's 51,865
#: columns are 405.2 column tiles
#: phase 9's runs: (model, backend, (data, model), workload), each held
#: to the 1x1 run of its model, backend and workload
ENCDEC_MESH_RUNS = (("whisper", "v2", (2, 2), "one-shot"),
                    ("whisper", "v2", (1, 4), "one-shot"),
                    ("whisper", "v3", (2, 2), "spec"))
#: their new tokens per request: 8, not the other mesh phases' 16, to
#: keep the phase inside its 60 s budget: whisper's 6 decoder layers take
#: 200-780 ms per decode step on the 4 gloo ranks sharing an NVIDIA H100
#: 80GB HBM3 (700.00 W; PERF.md §6)
ENCDEC_MESH_NEW = 8
ENCDEC_ROWS = (("q 1024x1024", "e0/attn/q", 1024, 1024),
               ("wi 1024x4096", "e0/mlp/wi", 1024, 4096),
               ("wo 4096x1024", "e0/mlp/wo", 4096, 1024),
               ("head 1024x51865", "head/0", 1024, 51865))
#: the kernel rows' M: the one-shot decode batch and a prefill block
ENCDEC_MS = (4, 512)


#: the mesh phases (7', 8' and 9'): their models, runs, new tokens per
#: request and config functions,
#: whether the ranks start before the 1x1 runs (and the NCCL group is made
#: once they wait) or once the group is made, and whether the pool pauses
#: while the ranks serve
MESH_FAMILIES = {
    "mla+vision": dict(keys=("deepseek", "llava"), runs=SLICE_MESH_RUNS,
                       new=SLICE_MESH_NEW, config="slice_config",
                       ranks_first=True, pause=True),
    "recurrent": dict(keys=("jamba", "xlstm"), runs=RECURRENT_MESH_RUNS,
                      new=SLICE_MESH_NEW, config="recurrent_config",
                      ranks_first=False, pause=False),
    "encdec": dict(keys=("whisper",), runs=ENCDEC_MESH_RUNS,
                   new=ENCDEC_MESH_NEW, config="encdec_config",
                   ranks_first=False, pause=False)}


def family_config(family, key):
    """A mesh family's model config (its config function resolved by name
    at call time, so that a rehearsal's patch reaches it)."""
    return globals()[MESH_FAMILIES[family]["config"]](key)


def encdec_config(key="whisper"):
    """whisper-medium, both stacks :data:`WHISPER_LAYERS` deep (``key``:
    the mesh phase's name of it)."""
    from repro_torch.configs import ARCHS
    return dataclasses.replace(ARCHS["whisper-medium"],
                               n_layers=WHISPER_LAYERS,
                               n_enc_layers=WHISPER_LAYERS)


def encdec_linears(cfg):
    """(name, (K, N), biased) of every packed weight but the head: per
    encoder layer ``e{i}/attn/{q,k,v,o}`` and ``e{i}/mlp/{wi,wo}``, per
    decoder layer ``d{i}/self/...``, ``d{i}/cross/...`` and
    ``d{i}/mlp/...`` (self q/k/v and cross q biased with ``qkv_bias``,
    the GELU MLP's both)."""
    d, ff = cfg.d_model, cfg.d_ff
    qd, kvd = cfg.n_heads * cfg.hd, cfg.n_kv_heads * cfg.hd
    bias = cfg.qkv_bias

    def attn(prefix, kv, cross):
        return [(f"{prefix}/q", (d, qd), bias),
                (f"{prefix}/k", (d, kv), bias and not cross),
                (f"{prefix}/v", (d, kv), bias and not cross),
                (f"{prefix}/o", (qd, d), False)]

    def mlp(prefix):
        return [(f"{prefix}/wi", (d, ff), True),
                (f"{prefix}/wo", (ff, d), True)]
    out = []
    for i in range(cfg.n_enc_layers):
        out += attn(f"e{i}/attn", kvd, False) + mlp(f"e{i}/mlp")
    for i in range(cfg.n_layers):
        out += (attn(f"d{i}/self", kvd, False) + attn(f"d{i}/cross", qd, True)
                + mlp(f"d{i}/mlp"))
    return out


def encdec_tasks(offset):
    """The pool's tasks for whisper, largest first: every packed weight
    (std 1/sqrt(K)) and the head, for v1, v2 and v3."""
    cfg = encdec_config()
    named = [(name, shape, shape[0] ** -0.5)
             for name, shape, _ in encdec_linears(cfg)]
    # one task: 53 M weights, under the slab size of the other heads
    named.append(("head/0", (cfg.d_model, cfg.vocab), HEAD_STD))
    tasks = [(name, SEED * 1000 + offset + i, shape, std, "all")
             for i, (name, shape, std) in enumerate(named)]
    return sorted(tasks, key=lambda t: -t[2][0] * t[2][1])


def encdec_params(dev, cfg, got):
    """The packed whisper model on the card from the pool's results: zero
    biases, LayerNorms of unit weight and zero bias, the embedding drawn
    on the card; and host copies of the kernel rows' weights."""
    from repro_torch.core.integrate import to_torch
    rows = {name: got[name] for _, name, _, _ in ENCDEC_ROWS}
    d = cfg.d_model
    norm = {"w": np.ones(d, np.float32), "b": np.zeros(d, np.float32)}
    tree = {"enc_norm": norm, "dec_norm": norm, "enc": [], "dec": []}
    layers = {}
    for name, (_, n), biased in encdec_linears(cfg):
        layer, part, leaf = name.split("/")
        p = {"w": got.pop(name)}
        if biased:
            p["b"] = np.zeros(n, np.float32)
        layers.setdefault(layer, {}).setdefault(part, {})[leaf] = p
    for i in range(cfg.n_enc_layers):
        tree["enc"].append({"norm1": norm, "norm2": norm, **layers[f"e{i}"]})
    for i in range(cfg.n_layers):
        tree["dec"].append({"norm1": norm, "norm2": norm, "norm3": norm,
                            **layers[f"d{i}"]})
    tree["lm_head"] = {"w": got.pop("head/0")}
    del layers
    check(not got, f"{cfg.name}: packed weights left over: {sorted(got)}")
    params = to_torch(tree, dev)
    upload_check(tree, params, cfg.name)
    del tree
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    params["embed"] = {"w": torch.randn((cfg.vocab, d), generator=gen,
                                        device=dev) * EMBED_STD}
    torch.cuda.synchronize()
    return params, rows


def encdec_workload(vocab):
    """4 greedy requests of 400-600-token prompts, 16 new tokens."""
    from repro_torch.serve import Request
    rng = np.random.default_rng(SEED + 17)
    prompts = [rng.integers(0, vocab, int(n))
               for n in rng.integers(*SLICE_PROMPTS, size=4)]
    return prompts, [Request(rid=i, prompt=p, max_new_tokens=16)
                     for i, p in enumerate(prompts)]


def head_exact(dev, params, host, cfg, card):
    """The ragged head (N = 51,865) through ``decode_walk`` at M = 4 (the
    slots): f32 logits of v2 and v3 bitwise equal, each within
    :data:`TOL_ORACLE` of the f64 oracle on the whole dequantized head."""
    from repro_torch.core.backend import sme_apply
    from repro_torch.core.sme import sme_matmul_ref_np
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 19)
    x = torch.randn((ENCDEC_ONE_SHOT["slots"], cfg.d_model), generator=gen,
                    device=dev)
    head = params["lm_head"]["w"]
    y = {be: sme_apply(x, head, be, out_dtype=torch.float32)
         for be in ("v2", "v3")}
    check(bool(torch.equal(y["v2"], y["v3"])),
          f"head: v2 and v3 logits differ ({mismatch(y['v2'], y['v3'])})")
    ref = sme_matmul_ref_np(x.cpu().numpy(), oracle_weight(host, cfg.vocab))
    got = y["v2"].cpu().numpy()
    rel = float(np.abs(got - ref).max() / np.abs(ref).max())
    n = cfg.vocab % 128 or 128              # the last column tile's
    tail = float(np.abs(got[:, -n:] - ref[:, -n:]).max() / np.abs(ref).max())
    print(f"encdec: head {cfg.d_model}x{cfg.vocab} at M = {x.shape[0]}: v2 "
          f"== v3 bitwise; oracle rel {rel:.2e} over every column, "
          f"{tail:.2e} over the last column tile's {n} (tolerance "
          f"{TOL_ORACLE:.0e}) | {card}", flush=True)
    check(got.shape == ref.shape and rel <= TOL_ORACLE,
          f"head: oracle rel {rel}")
    return rel


def prefill_split(api, params, prompt, card):
    """ms of one request's prefill under v2 and v3 and of the encoder
    inside the same call (``encdec_encode`` wrapped between two
    synchronizations): medians of 3 calls after a warm one."""
    from repro_torch.models import encdec as ed
    dev, cfg = api.device, api.cfg
    toks = np.asarray(prompt)[None]
    frames = torch.zeros((1, max(len(prompt), 2), cfg.d_model),
                         dtype=torch.bfloat16, device=dev)
    encode, spans = ed.encdec_encode, []

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = encode(*a, **kw)
        torch.cuda.synchronize()
        spans.append(1e3 * (time.perf_counter() - t0))
        return y
    out = {}
    ed.encdec_encode = timed
    try:
        for be in ("v2", "v3"):
            calls = []
            with quiet():
                for _ in range(4):
                    spans.clear()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    api.prefill(params, toks, s_max=2048, frames=frames,
                                backend=be)
                    torch.cuda.synchronize()
                    calls.append((1e3 * (time.perf_counter() - t0),
                                  sum(spans)))
            full = statistics.median(c[0] for c in calls[1:])
            enc = statistics.median(c[1] for c in calls[1:])
            out[be] = dict(prefill_ms=full, encoder_ms=enc,
                           decoder_ms=full - enc)
            print(f"encdec: {be} prefill of {len(prompt)} tokens over "
                  f"{frames.shape[1]} frames {full:.1f} ms, of which the "
                  f"encoder {enc:.1f} ms and the decoder and head "
                  f"{full - enc:.1f} ms (inside the same calls) | {card}",
                  flush=True)
    finally:
        ed.encdec_encode = encode
    return out


def encdec_logits(api32, params, prompt, label):
    """f32 prefill logits of one request (seeded random frames) under v1,
    v2 and v3 (bitwise equal), against the ``torch`` backend and the v2
    and v3 plain versions (within ``TOL_LOGITS["float32"]``).  Returns the
    relative differences."""
    dev, d = api32.device, api32.cfg.d_model
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 20)
    frames = torch.randn((1, len(prompt), d), generator=gen, device=dev)
    toks = np.asarray(prompt)[None]

    def logits(be, plain=False):
        with plain_kernels(blocks=True) if plain else \
                contextlib.nullcontext():
            return api32.prefill(params, toks, s_max=2048, frames=frames,
                                 backend=be)[0]
    lk = {be: logits(be) for be in ("v1", "v2", "v3")}
    for be in ("v1", "v3"):
        if not torch.equal(lk["v2"], lk[be]):
            again = {b: torch.equal(logits(b), lk[b]) for b in ("v2", be)}
            check(False, f"{label}: f32 prefill logits differ between v2 "
                  f"and {be} ({mismatch(lk['v2'], lk[be])}; a second call "
                  f"reproduces v2: {again['v2']}, {be}: {again[be]})")
    check(bool(torch.isfinite(lk["v2"]).all())
          and lk["v2"].shape == (1, api32.cfg.vocab),
          f"{label}: logits non-finite or misshapen")
    rel = {}
    for name, other in (("torch", logits("torch")),
                        ("v2 plain", logits("v2", True)),
                        ("v3 plain", logits("v3", True))):
        rel[name] = float((lk["v2"] - other).abs().max()
                          / other.abs().max())
        check(rel[name] <= TOL_LOGITS["float32"],
              f"{label}: f32 logits vs {name} rel {rel[name]}")
        check(int(lk["v2"].argmax()) == int(other.argmax()),
              f"{label}: greedy token differs from {name}")
    print(f"{label}: f32 prefill logits (1 x {toks.shape[1]} tokens over "
          f"as many random frames) v1 == v2 == v3 bitwise; max rel diff vs "
          + ", ".join(f"{k} {v:.2e}" for k, v in rel.items())
          + f" (tolerance {TOL_LOGITS['float32']:.0e}); same greedy token",
          flush=True)
    return rel


def reused_slot(api, params, prompts, card):
    """R6 on the card: the longest prompt served first (2 tokens), then
    the shortest in the slot it used, whose cross K/V keep the first's
    keys past the second's source; the second's tokens equal a fresh
    engine's.  Returns (tokens, launches per kernel)."""
    from repro_torch.serve import Request, ServeEngine
    long_, short = max(prompts, key=len), min(prompts, key=len)
    runs = {}
    zero_counts()
    for name, first in (("reused", long_), ("fresh", None)):
        eng = ServeEngine(api, params, backend="v3", device=api.device,
                          **ENCDEC_ONE_SHOT)
        if first is not None:
            r0 = Request(rid=0, prompt=first, max_new_tokens=2)
            eng.run([r0])
            check(r0.outcome == "completed", "encdec: first request failed")
        req = Request(rid=1, prompt=short, max_new_tokens=16)
        eng.run([req])
        check(req.outcome == "completed" and eng._src[0] == len(short),
              f"encdec: the {name} request did not run in slot 0")
        stale = eng.caches[0]["cross"]["k"][0, len(short):len(long_)]
        runs[name] = (req.out_tokens, bool(stale.abs().sum() > 0))
        del eng
    launches = {name: fn.launches for name, fn in wrappers().items()}
    check(runs["reused"][1] and not runs["fresh"][1],
          "encdec: the reused slot holds no stale cross keys")
    check(runs["reused"][0] == runs["fresh"][0],
          "encdec: a slot reused after a longer request served other "
          "tokens than a fresh one (R6)")
    print(f"encdec: a {len(short)}-token request in the slot a "
          f"{len(long_)}-token one used (its stale cross keys there, past "
          f"the source) serves a fresh engine's tokens | {card}", flush=True)
    return runs["fresh"][0], launches


def encdec_phase(dev, card, packed, save_to=None):
    """whisper-medium at full width: its kernel rows; the ragged head
    exact; one-shot serving under auto (v2) and v3 (equal tokens, 6
    launches per encoder layer, 10 per decoder layer and the head per
    prefill pass, 8 per decoder layer and the head per decode pass); the
    prefill split into encoder and decoder; f32 prefill
    logits; a profiled window; the engine on v3 with spec and without
    (equal tokens, equal to the one-shot run's); a reused slot.  With
    ``save_to`` the packed tree is written there as a ``.smez``.  Returns
    the kernel rows, launches per kernel and readings."""
    from repro_torch.core.integrate import sme_operand_bytes, to_torch
    from repro_torch.models.model import build_model
    t_phase = time.perf_counter()
    cfg = encdec_config()
    label = f"encdec[{cfg.name}]"
    print(f"{label}: full width (d_model {cfg.d_model}, {cfg.n_heads} heads "
          f"MHA, d_ff {cfg.d_ff}, vocab {cfg.vocab}, LayerNorm, GELU, "
          f"sinusoidal positions); depth cut from {WHISPER_DEPTH} + "
          f"{WHISPER_DEPTH} layers to {cfg.n_enc_layers} encoder and "
          f"{cfg.n_layers} decoder layers", flush=True)
    got, pack_s, wait_s = packed
    params, rows_host = encdec_params(dev, cfg, got)
    del got
    ob = sme_operand_bytes(params)
    per_pass = packed_linears(params)
    per_decode = 8 * cfg.n_layers + 1
    check(per_pass == 6 * cfg.n_enc_layers + 10 * cfg.n_layers + 1,
          f"{label}: {per_pass} packed linears")
    skip = per_pass - per_decode
    print(f"{label}: {ob['weights']} packed weights, {per_pass} launches per "
          f"prefill pass, {per_decode} per decode pass; v1 "
          f"{ob['v1'] / ob['weights']:.4f}, v2 {ob['v2'] / ob['weights']:.4f}"
          f" and v3 {ob['v3'] / ob['weights']:.4f} B per weight; packed on "
          f"the host by the pool: {pack_s:.1f}s from its start, "
          f"{wait_s:.1f}s waited here; card memory "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB | {card}",
          flush=True)
    rows = kernel_rows(dev, [
        (f"whisper {lab}", to_torch(rows_host[name], dev),
         oracle_weight(rows_host[name], min(N, ORACLE_COLS)), K, N,
         ENCDEC_MS) for lab, name, K, N in ENCDEC_ROWS], card, SEED + 18)
    out = {"weights": ob["weights"], "pack_s": pack_s, "pack_wait_s": wait_s,
           "card_gib": torch.cuda.memory_allocated() / 2 ** 30,
           "launches_per_prefill_pass": per_pass,
           "launches_per_decode_pass": per_decode,
           "layers": [cfg.n_enc_layers, cfg.n_layers]}
    out["head_oracle_rel"] = head_exact(dev, params, rows_host["head/0"],
                                        cfg, card)
    del rows_host
    api = build_model(cfg, device=dev)
    prompts, _ = encdec_workload(cfg.vocab)
    launches = {name: 0 for name in KERNELS}
    tokens = {}
    for backend in ("auto", "v3"):
        tokens[backend], counts = serve_run(
            api, params, prompts, backend, card, engine_kw=ENCDEC_ONE_SHOT,
            label=f"{label} {backend}", decode_skip=skip)
        for k in launches:
            launches[k] += counts[k]
    check(tokens["auto"] == tokens["v3"], f"{label}: v2 and v3 tokens differ")
    print(f"{label}: one-shot tokens of auto (v2) and v3 identical; distinct "
          f"tokens per request: "
          + ", ".join(f"{i}:{len(set(t))}" for i, t in
                      enumerate(tokens["v3"])), flush=True)
    out["prefill"] = prefill_split(api, params, prompts[0], card)
    api32 = build_model(dataclasses.replace(cfg, dtype="float32"), device=dev)
    out["logits_rel"] = encdec_logits(api32, params, prompts[0], label)
    del api32
    torch.cuda.empty_cache()
    profile_window(api, params, prompts[:1], card, "auto",
                   engine_kw=ENCDEC_ONE_SHOT)

    depth, deepest, _, _ = choose_spec_depth(params, layers="dec")
    runs = {}
    for name, spec in (("spec", depth), ("spec off", None)):
        _, reqs = encdec_workload(cfg.vocab)
        r = runs[name] = engine_run(api, params, "v3", spec, False,
                                    engine_kw=ENCDEC_ENGINE,
                                    waves=(reqs, [], lambda e, n: False))
        for k in launches:
            launches[k] += r["launches"][k]
        check(r["prefill_passes"] == len(reqs),
              f"{label} engine[{name}]: {r['prefill_passes']} prefills for "
              f"{len(reqs)} requests")
        out[f"engine_{name.replace(' ', '_')}_tokens_per_s"] = check_engine(
            r, per_pass, skip, f"{label} engine[{name}]", card,
            ENCDEC_ENGINE["spec_len"] if spec else 0)
        m = r["eng"]._m
        if spec:
            out["spec_acceptance"] = (m["spec_accepted"].value
                                      / m["spec_draft_tokens"].value)
    greedy = {name: [q.out_tokens for q in r["reqs"]]
              for name, r in runs.items()}
    check(greedy["spec"] == greedy["spec off"],
          f"{label}: engine tokens with spec and without differ")
    check(greedy["spec off"] == tokens["v3"],
          f"{label}: engine tokens differ from the one-shot run's")
    eng = runs["spec"]["eng"]
    check(all(all(k.values()) for k in eng._paged),
          f"{label}: cache leaves misclassified: {eng._paged[0]}")
    leaves = sorted(eng._paged[0])
    del runs, eng
    fresh, counts = reused_slot(api, params, prompts, card)
    for k in launches:
        launches[k] += counts[k]
    short = min(range(4), key=lambda i: len(prompts[i]))
    print(f"{label}: engine tokens with spec == without == one-shot; every "
          f"cache leaf paged ({leaves}); draft depth "
          f"{depth} of {deepest}; the reused-slot request's tokens "
          f"{'==' if fresh == tokens['v3'][short] else '!='} its one-shot "
          f"tokens (not required: other rows were live there)", flush=True)
    out["draft_depth"] = depth
    if save_to is not None:
        out["save_s"] = save_slice(params, cfg, save_to, label)
    del params
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"{label}: phase {out['phase_s']:.1f}s", flush=True)
    return rows, launches, out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}; "
          f"{card}", flush=True)
    t0 = time.perf_counter()
    reports = build.build_all()
    for name in build.SIGNATURES:
        build.load(name)
    print(f"build: {time.perf_counter() - t0:.1f}s for "
          f"{len(build.SIGNATURES)} kernels", flush=True)
    for line in ptxas_summary(reports):
        print(f"  ptxas {line}")

    # the full-width models' weights are drawn and packed on the host by
    # a pool at the lowest priority from here on, beside the card tests and
    # the qwen phases; each later phase waits for its own model's
    packer = Packer({"gemma": gemma_tasks(gemma_config()),
                     **{key: slice_tasks(key, 100000 * (i + 1))
                        for i, key in enumerate(SLICE)},
                     **{key: recurrent_tasks(key, 100000 * (i + 4))
                        for i, key in enumerate(RECURRENT)},
                     "whisper": encdec_tasks(100000 * 6)}, dev)
    slice_tmp = pathlib.Path(tempfile.mkdtemp(prefix="slice-mesh-"))
    try:
        card_tests()
        flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32, device=dev)
        with quiet():         # one pause for the qwen kernel rows
            agg, tile_agg = kernel_phase(dev, flush)
        del flush                # not part of the serving peak memory
        launches, params, served = serve_phase(dev, card)
        draft = engine_phase(dev, card, params)
        del params
        free_card()
        compiled, artifact_launches = compile_phase(dev, card, served)
        free_card()
        trained, train_launches, mesh_launches = train_phase(dev, card)
        free_card()
        cnn_rows, cnn_launches, cnn_out = cnn_phase(dev, card)
        free_card()
        gemma_rows, gemma_launches, gemma = gemma_phase(
            dev, card, packer.wait("gemma"))
        free_card()
        slice_rows = {name: {} for name in KERNELS}
        slice_launches = {name: 0 for name in KERNELS}
        slice_out = {}
        for key in SLICE:
            # deepseek's and llava's packed trees are written for the
            # mesh phase that follows
            save_to = slice_tmp / f"{key}.smez" if key in ("deepseek",
                                                          "llava") else None
            rows_k, launches_k, slice_out[key] = (
                vision_phase(dev, card, packer.wait(key), save_to)
                if key == "llava"
                else moe_phase(dev, card, key, packer.wait(key), save_to))
            free_card()
            for name in KERNELS:
                slice_rows[name].update(rows_k.get(name, {}))
                slice_launches[name] += launches_k[name]
        slice_out["mesh"], slice_mesh_launches = mesh_family_phase(
            dev, card, slice_tmp, "mla+vision",
            {"deepseek": slice_out["deepseek"]["draft_depth"],
             "llava": None})
        free_card()
        for name in KERNELS:
            mesh_launches[name] += slice_mesh_launches[name]
        rec_rows = {name: {} for name in KERNELS}
        rec_launches = {name: 0 for name in KERNELS}
        rec_out = {}
        for key in RECURRENT:
            # each packed tree is written for phase 8'
            rows_k, launches_k, rec_out[key] = recurrent_phase(
                dev, card, key, packer.wait(key), slice_tmp / f"{key}.smez")
            free_card()
            for name in KERNELS:
                rec_rows[name].update(rows_k.get(name, {}))
                rec_launches[name] += launches_k[name]
        rec_out["mesh"], rec_mesh_launches = mesh_family_phase(
            dev, card, slice_tmp, "recurrent",
            {key: rec_out[key]["draft_depth"] for key in RECURRENT})
        free_card()
        for name in KERNELS:
            mesh_launches[name] += rec_mesh_launches[name]
        # whisper's packed tree is written for phase 9'
        enc_rows, enc_launches, enc_out = encdec_phase(
            dev, card, packer.wait("whisper"), slice_tmp / "whisper.smez")
        free_card()
        enc_out["mesh"], enc_mesh_launches = mesh_family_phase(
            dev, card, slice_tmp, "encdec",
            {"whisper": enc_out["draft_depth"]})
        shutil.rmtree(slice_tmp, ignore_errors=True)
        free_card()
        for name in KERNELS:
            mesh_launches[name] += enc_mesh_launches[name]
    finally:
        packer.close()
        shutil.rmtree(slice_tmp, ignore_errors=True)
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "max_abs_err")
    rows = []
    for name, pallas in KERNELS.items():
        row = {"name": name, "route": "cuda",
               "source": f"src/repro_torch/kernels/csrc/{name}.cu",
               "replaces": pallas, "launches": launches[name]}
        if name == "sme_spmm_planes":
            at = {"512": agg[("prefill", 512)]}
        elif name == "sme_spmm_planes_decode":
            at = {str(m): agg[(kind, m)] for kind, m in RUN_M
                  if kind == "decode"}
        else:
            at = {str(m): tile_agg[(name, m)] for _, m in RUN_M}
        at = {m: {k: a[k] for k in keys} for m, a in at.items()}
        row.update(at["512" if name == "sme_spmm_planes" else "8"])
        row["at_m"] = at
        if name == "sme_spmm_planes_decode":
            row.update(draft)
        # the compile phase's runs from the two artifacts
        row["artifact_launches"] = artifact_launches[name]
        # the train phase's serving runs of the trained artifacts, and the
        # CNN phase's conv matrices on their activations (rows per shape)
        row["train_launches"] = train_launches[name]
        # the mesh phases' runs: the 1x1 mesh over NCCL in this process
        # and the gloo ranks' meshes, summed over the ranks (the trained
        # qwen artifacts', then deepseek's and llava's, then Jamba's and
        # xLSTM's, then whisper's)
        row["mesh_launches"] = mesh_launches[name]
        row["cnn_launches"] = cnn_launches[name]
        row["cnn"] = cnn_rows[name]
        # gemma3-12b's path (one-shot auto and v3, the engine twice) and
        # its kernel rows: per call at each shape and M
        row["gemma_launches"] = gemma_launches[name]
        row["gemma"] = gemma_rows[name]
        # the MoE and vision phases' main paths (one-shot, engine) and
        # their kernel rows (expert and ragged shapes)
        row["slice_launches"] = slice_launches[name]
        row["slice"] = slice_rows[name]
        # the recurrent phase's main paths and its kernel rows
        row["recurrent_launches"] = rec_launches[name]
        row["recurrent"] = rec_rows[name]
        # the encoder-decoder phase's main paths and its kernel rows
        row["encdec_launches"] = enc_launches[name]
        row["encdec"] = enc_rows[name]
        rows.append(row)
    # qwen times are per model layer: 4 q/k/v/o + 2 wi/wg + 1 wo calls
    print(json.dumps({"compile": compiled, "train": trained, "cnn": cnn_out,
                      "gemma": gemma,
                      "slice": slice_out, "recurrent": rec_out,
                      "encdec": enc_out}))
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
