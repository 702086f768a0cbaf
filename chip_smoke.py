#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py            # from the root of a checkout

What it does, failing (non-zero exit, no result line) on any error:

1. device: the card's name and power limit (``nvidia-smi``), the torch
   and CUDA versions, and the build of every CUDA kernel of the serving
   and training paths from the sources in the checkout (``nvcc`` for
   ``sm_90a``, one process per source, with the ``-Xptxas -v`` register
   / shared-memory summary; a tensor-core kernel or an instantiation of
   the shared decode-attention body that spills fails);
2. each kernel against its plain PyTorch version on the card, at the
   shapes of the full-width ``internlm2-1.8b`` serving path:
   decode attention within a stated tolerance (GQA group 1/2/4, ring,
   window, softcap, f32/bf16), the row scatter-swap bitwise, and the
   swap applied twice is the identity;
3. each kernel's time (CUDA events, warm, L2 exceeded) beside its bound
   (bytes over 3.35 TB/s or operations over the peak rate, whichever is
   larger), its plain version's time and one PyTorch library call's time
   as a yardstick; decode attention's ``torch.profiler`` record at the
   timing case and at serving contexts of max_seq 1024 (one kernel, one
   launch a call) and its output bitwise the same over 3 back-to-back
   launches and 20 CUDA-graph replays;
4. the main path: ``python -m repro_torch.launch.serve`` at the full
   width of ``internlm2-1.8b`` (random weights from a seed, two demo
   adapter tenants, the kernel decode attention), with every kernel's
   launch count reset just before and read just after — a kernel that
   did not launch there fails the run; then a ``DecodeServer`` run with
   200-900-token prompts, so decode crosses several 128-row k-blocks;
5. a teacher-forced check: the same prompts and the same fed tokens for
   16 decode steps through ``attn_impl="kernel"`` and ``"full"``; the
   largest logit difference per step against a stated tolerance, in f32
   compute and in bf16 compute; then a ``torch.profiler`` window of
   steady full-width decode steps (wall vs device busy, top kernels);
6. training (the port's slice 2), ``internlm2-1.8b`` at full width:
   masked Adam (f32 moments) and Q8 masked Adam against their plain
   versions on the card (ragged sizes and the main path's leaf shapes;
   f32 within 2 ulp, bf16 parameters within one bf16 ulp, Q8 codes and
   scales bitwise), then their times over the main path's whole
   12-leaf selection beside the bound, the plain version and
   ``torch._fused_adam_``;
7. the training main path: ``python -m repro_torch.launch.train --arch
   internlm2-1.8b --reduce 0 --optimizer blockllm+q8 --batch 8 --seq 256
   --steps 8`` (full width, full depth, random weights from a seed) with
   the launch counts reset just before and read just after — the Q8
   kernel must have launched; loss per step, step times, peak memory;
8. through the API: ``blockllm`` with f32 moments and
   ``fused_update="kernel"`` (the f32 kernel must launch), then full
   ``adam`` at the same batch: the paper's memory comparison; then a
   ``torch.profiler`` window of 2 steady ``blockllm`` steps;
9. checkpoint -> crash -> resume -> export -> serve at full width with
   the depth cut to 4 layers (full depth would write about 12 GB of npz
   per checkpoint): the resumed run equals the uninterrupted one
   bitwise, its exported BlockDelta tenant is served through
   ``DecodeServer`` with kernel attention and gives the tokens of a
   server whose base has the trained rows written in;
10. paged KV serving (the port's slice 3): the fused paged write+attend
   kernel against its plain version (o within the dense kernel's
   tolerance, one bf16 ulp at bf16 output; pools bitwise outside the
   null page) and against the dense kernel on the gathered view at equal
   block_k (bitwise), over G 1/2/8, hd 64/128, f32/bf16 q, window,
   softcap, inactive slots, shared prefix pages, writes on a page's first
   and last row and a shuffled page table; its time at the main path's
   shapes beside the dense kernel, the bound, the plain version and
   gather + SDPA, its profiler record (one launch a call) and its output
   bitwise over back-to-back launches and graph replays;
11. the paged main path: ``python -m repro_torch.launch.serve --paged``
   at full width and depth (8 slots, max_seq 1024, 16 requests, base + 2
   demo tenants over a shared system prompt) with the launch counts reset
   just before and read just after: streams equal to a dense run of the
   same requests, 24 paged-kernel launches per decode step and no dense
   decode-attention launch, prefix hits, step p50/p99, peak memory;
12. a tight pool (16 slots over the pages of 8, one tenant: admission
   throttles) whose streams equal a dense run, then ``--paged
   --speculate 4`` whose streams equal the plain paged run, with one
   paged-kernel launch per layer per decode pass of its rounds (rounds,
   acceptance, rollback pages);
13. the paged decode step against the dense one at 300-900-row
   contexts in alternating segments, and a ``torch.profiler`` window of
   the paged decode step, beside phase 5's dense one;
14. the hybrid RG-LRU family (the port's slice 4; the chunked scan of
   slice 8): the forward scan kernel and the backward kernel (the
   reversed scan with the VJP's elementwise passes taken in) against
   their plain versions, bitwise (y and h_last; da, db and dh0; with and
   without h0, at [8, 256, 2560], [2, 96, 192], [1, 33, 130], past one
   group of 8 chunks at [2, 291, 200], and at B * W < 32), the backward
   through ``ops.rglru_scan`` (da, db, dh0 bitwise), and the forward's
   and the whole backward's times beside their bounds and the plain
   versions;
15. the decode kernel at ``recurrentgemma-2b``'s local layers (MQA, 10
   query heads, head_dim 256, a ring over the 2048-token window; the
   tensor-core kernel over the bf16 cache) against its plain version with
   phase 2's tolerances, bf16 and f32 q, also with softcap and with a
   non-ring window, and its time beside SDPA's and the bound, with a
   profile of its two launches beside the f32 cache's CUDA-core body;
16. the training main path: ``python -m repro_torch.launch.train --arch
   recurrentgemma-2b --reduce 0 --optimizer blockllm --batch 8 --seq 256
   --steps 8`` (full width and depth, remat on) with the launch counts
   reset just before and read just after: every loss finite, the first
   within 1.0 of ln(vocab), none more than 0.5 above the first; the scan
   launches equal to those the recorded selections give (18 forward
   scans per step, plus one recompute and one backward scan per
   recurrent block the gradient passes through), the masked-Adam
   launches one per selected leaf per non-refresh step; step times and
   peak memory; a ``torch.profiler`` window of 2 more steps (with the
   scan kernels' share of device busy); full
   ``adam``'s peak at one step (BlockLLM must stay below it); 6 reduced
   steps on the card against the CPU;
17. checkpoint -> crash -> resume -> export -> serve at full width and 5
   layers (both stage shapes): resume bitwise, the exported tenant served
   (per-token priming, 2 slots, so slots are reused) with the merged
   weights' streams, the reused slot's stream equal to a fresh server's,
   one decode-attention launch per local layer per decode pass;
18. the flash-attention kernel (the port's slice 5; bf16 on the tensor
   cores since slice 6) against its plain version over a sweep
   (``tests/test_kernels.py``'s shapes, ragged S, Sq != Sk non-causal, hd
   32 / 64 / 128 / 256, S 2048 causal, S 1000 windowed at hd 256; f32
   within 2e-5 and bf16 within one bf16 ulp of the plain output plus
   2e-5), then at two main shapes, ``internlm2-1.8b`` attention (B 2, S
   4096, H 16, KV 8, hd 128, causal) and ``recurrentgemma-2b``'s local
   attention (H 10, KV 1, hd 256, window 2048), its time beside the bound,
   the plain version and SDPA, with the achieved and issued TFLOP/s;
19. ``ops.flash_attention`` through autograd at the ``internlm2-1.8b``
   shape under the kernel profiler (launch counts reset just before and
   read just after: one launch per forward call; the record's bytes and
   the ``kernels/flash_attention_calls`` counter), its q/k/v gradients
   (the chunked recompute) bitwise those of ``mode="plain"``, and a small
   f32 case within atol 1e-4 of autograd through the plain attention;
20. long-context BlockLLM training of ``internlm2-1.8b`` at full width and
   depth through the trainer API with ``attn_impl="chunked"`` (batch 2 x
   4096, 4 steps, remat on): finite losses, the first within 1.0 of
   ln(vocab), step times, peak memory, a ``torch.profiler`` window with
   the chunked attention's share, and at 2 layers in f32 the chunked
   and full attention's losses within 1e-5 relative;
21. Q8 tenants through the device AdapterCache (the port's slice 9), at
   full width and depth: three demo tenants quantized
   (``adapters.quantize_delta``), their rows dequantized on the card
   bitwise equal to the CPU's; the same 24 requests over base + 3
   tenants served without and with a cache budget of two tenants' device
   rows (so it evicts), launch counts reset just before each and read
   just after (decode attention and the swap kernel must launch): streams
   equal (a gate), ``h2d_bytes`` equal to the q8 payload bytes the cache
   promoted (a gate), the weights reverted bit-exactly, hits, misses,
   evictions, captures, d2d bytes, tokens/s and the ms per flip (revert +
   apply, synchronized) cached and uncached; then ``python -m
   repro_torch.launch.serve --arch internlm2-1.8b --reduce 0
   --demo-adapters 2 --cache-bytes <budget>`` (the swap kernel must
   launch);
22. the paper's baselines through ``python -m repro_torch.launch.train
   --arch internlm2-1.8b --reduce 0 --batch 8 --seq 256``: ``galore`` (3
   steps, the first its SVD refresh, timed apart), ``lora``, ``badam``
   and ``badam+q8`` (4 steps each), and ``adam+q8`` (2 steps, for its
   peak), launch counts reset just before each and read just after:
   finite losses, the first within 1.0 of ln(vocab), none of the
   baselines' 0.5 or more above it; BAdam's masked-Adam launches equal to
   steps x the selected block's leaves; ``badam`` and ``badam+q8``
   reduced by 8 on the card against the CPU (6 steps, a block switch
   every 2, Adam eps 1e-3, losses within rtol 1e-4); then the peak
   device memory of all
   eight trainer cores at one batch (phases 7-8 give BlockLLM's and
   Adam's), with their memory reports and step p50s;
23. the serving fleet (the port's slice 10) at the full width and depth
   of ``internlm2-1.8b``: base + 3 q8 demo tenants with a cache budget
   of two, 8 slots, 48 requests (Zipf 1.2 tenancy, prompts of 3-6
   tokens) x 12 new tokens, no SLO, as ``benchmarks/bench_fleet.py``
   shapes its traffic.  One ``DecodeServer`` gives the reference
   streams; then ``runtime.fleet.Router`` at 1 and 2 replicas (streams
   bitwise the server's; tokens per round at 2 replicas at least 1.8x
   one replica's), a kill of the busiest replica at round 4 with a
   replacement (streams bitwise, one fence, zero sheds, the replays
   counted, the device memory the fence freed; the merged trace passes
   ``tools/check_trace.py --require-fleet --require-failover``) and
   ``adapter_read_error:n=2`` (retried reads counted, streams bitwise),
   launch counts reset just before each leg and read just after (decode
   attention and the swap kernel must launch); each replica's device
   memory at its peak, tokens per round, rounds to recover;
24. the MoE family (the port's slice 11), ``granite-moe-3b-a800m`` (32
   layers, 40 experts top-8, GQA 24 / 8 at head_dim 64): (a) the dense
   and paged decode kernels at G = 3 against their plain versions (bf16
   and f32 q, caches and pools; phase 2's and phase 10's checks) and
   their times at B 8, contexts 200-900 of 1024, beside the bound, the
   plain versions, SDPA and gather + SDPA; (b) at full width and 2
   layers in f32, ``forward``, ``prefill_into_slots`` and ``decode_step``
   logits of granite and ``qwen2-moe-a2.7b`` on the card within rtol
   1e-4 of the largest CPU logit, the routes (top-k in order, keep)
   equal; (c) ``python -m repro_torch.launch.train --arch
   granite-moe-3b-a800m --reduce 0 --optimizer blockllm --batch 8 --seq
   256 --steps 8`` with launch counts reset just before and read just
   after (phase 16's loss gates, the aux loss > 0 at every step,
   masked-Adam launches from the selections, peak memory), then
   checkpoint -> crash -> resume -> export -> serve at 2 layers; (d)
   ``python -m repro_torch.launch.serve --arch granite-moe-3b-a800m
   --reduce 0 --layers 8`` (8 of 32 layers: the serving legs are
   host-bound; bf16, kernel attention, base + 2 demo tenants, 16
   requests over 8 slots x 16 new tokens), dense and ``--paged``, each
   twice: streams complete and bitwise a second run, one decode
   launch per layer per decode step, (token, slot) pairs dropped per
   leg, paged streams bitwise a dense run of the same requests when
   neither dropped a pair (else the first divergence and its top-2
   margin); and a profile of the MoE decode step at full depth;
25. the xLSTM family (the port's slice 12), ``xlstm-1.3b`` (48 blocks,
   7 mLSTM : 1 sLSTM, d_model 2048, 4 heads, no attention): (a) at full
   width and 8 layers (one pattern) in f32, ``forward`` at B 2, S 512
   (two mLSTM chunks) and 8 ``decode_step``s from a fresh cache on the
   card within rtol 1e-4 of the largest CPU logit; (b) ``python -m
   repro_torch.launch.train --arch xlstm-1.3b --reduce 0 --layers 16
   --optimizer blockllm --batch 8 --seq 256 --steps 8`` at full width and
   16 of 48 blocks (the sLSTM's time loop makes each step host-bound) with
   launch counts reset just before and read just after (phase 16's loss
   gates, masked-Adam launches from the selections, peak memory, step
   p50); (c) checkpoint -> crash -> resume -> export -> serve at 8
   layers (2 slots, so a slot is reused: its stream equals a fresh
   server's; no decode-attention launch); (d) ``python -m
   repro_torch.launch.serve --arch xlstm-1.3b --reduce 0 --layers 16``
   (bf16, base + 2 demo tenants, 16 requests over 8 slots x 16 new
   tokens, per-token
   priming) and a second run of its requests: streams complete and
   bitwise the second run, swap launches counted, no decode-attention
   launch, the first request admitted into a reused slot equal to a
   fresh server's stream; and a profile of the xLSTM decode step at full
   depth;
26. the encoder-decoder family (the port's slice 13),
   ``whisper-large-v3`` (32 encoder + 32 decoder layers, d_model 1280,
   MHA 20 x 64, 1500 frames of 1280 stub features, sinusoidal positions):
   (a) the decode kernel at G = 1, head_dim 64 (B 8, KV 20, a 448-row
   cache, bf16 and f32 q, an f32 cache) against its plain version with
   phase 2's tolerances, and its time at contexts 100-440 beside the
   bound, the plain version and SDPA; (b) at full width and 2 + 2 layers
   in f32, ``forward`` (B 2, 64 tokens, 1500 frames), its ``cross_kv``
   and 8 ``decode_step``s on the card within rtol 1e-4 of the largest
   CPU value; (c) ``python -m repro_torch.launch.train --arch
   whisper-large-v3 --reduce 0 --optimizer blockllm --batch 8 --seq 256
   --steps 8`` with launch counts reset just before and read just after
   (phase 16's loss gates, masked-Adam launches from the selections with
   the ``encoder`` unit's nested leaves, peak memory, step p50) and every
   decoder row's ``xattn.wk`` / ``xattn.wv`` bitwise unchanged (the
   reference's zero gradient through the overlay); (d) checkpoint ->
   crash -> resume -> export -> apply at 2 + 2 layers (``blockllm+q8``,
   the ``encoder`` always active): resume bitwise, the tenant applied
   with ``apply_delta`` decoding the merged weights' greedy streams, the
   swap kernel launched exactly when the delta has row entries; (e) bf16
   decode at full width and depth: ``prefill``'s ``cross_kv`` over [8,
   1500, 1280] frames in ``init_cache(8, 448)``, 8-token prompts primed
   per token, 16 new tokens: 32 decode-attention launches per step,
   streams bitwise a second run, teacher-forced kernel against full
   logits within 0.25, and a profile of the decode step;
27. the VLM family (the port's slice 14), ``pixtral-12b`` (40 layers,
   d_model 5120, GQA 32 / 8 at head_dim 128, vocab 131072, 256 stub patch
   embeddings of 1024 projected in by ``vision_proj``), and whole-sequence
   prefill of the recurrent families: (a) the decode kernel at G = 4,
   head_dim 128 (B 8, KV 8, a 512-row cache, bf16 and f32 q) against its
   plain version with phase 2's tolerances, and its time at contexts
   288-302 beside the bound, the plain version and SDPA; (b) at full width
   and 2 layers in f32, B 1 over 256 patches + 32 tokens, ``forward``'s
   logits and ``loss_fn`` with its ``vision_proj`` gradient on the card
   within rtol 1e-4 of the largest CPU value; (c) ``python -m
   repro_torch.launch.train --arch pixtral-12b --reduce 0 --layers 8
   --optimizer blockllm --batch 8 --seq 288 --steps 8`` with launch counts
   reset just before and read just after (phase 16's loss gates,
   masked-Adam launches from the selections, step p50, the peak under 70
   GiB), then checkpoint -> crash -> resume -> export -> apply at 3 layers
   (``blockllm+q8``, ``vision_proj`` always active, one of the 3 rows
   selected, reselected after step 4): resume bitwise, the tenant's row
   entries applied by the swap kernel, decoding the merged weights'
   greedy streams; (d) bf16 decode at full width and depth, B 8:
   ``prefill`` over [8, 256, 1024] patch embeddings and a 288-token
   prompt, its rows in ``init_cache(8, 512)``, 16 greedy decode steps: 40
   decode-attention launches per step (640), streams bitwise a second
   run, and a profile of the decode step (the kernel's function is held
   against its plain version in (a), and on the model path in f32 in
   (b); in bf16 at 40 layers kernel and full-attention logits part by
   more than phase 26's 0.25, so (d) holds none to them); (e) ``prefill`` of a
   64-token prompt on ``recurrentgemma-2b`` at 5 layers (the scan kernel
   launched once per RG-LRU block) and ``xlstm-1.3b`` at 8 layers, f32,
   against the same prompt primed token by token: every cache leaf within
   rtol 1e-4 of its largest value, and the greedy tokens after each;
28. the rest of the zoo (the port's slice 15): ``gemma3-1b`` (26 layers
   of 5 local : 1 global attention, a 512-token window, MQA 4 / 1 at
   head_dim 256, a tied 262144-row vocabulary), ``gemma-2b`` (18 layers,
   MQA 8 / 1 at head_dim 256, a tied 256000-row vocabulary) and
   ``deepseek-7b`` (30 layers, MHA 32 x 128, vocab 102400): the dense
   decode kernel at G = 4, head_dim 256 over a 512-row ring and a global
   cache, G = 8 at head_dim 256 and G = 1 at head_dim 128 with 32 kv
   heads, and the paged kernel at G = 4 and 8, head_dim 256, against
   their plain versions (phases 2 and 10's checks) and timed beside the
   bound, the plain version and SDPA (gather + SDPA paged); then per
   architecture (a) at full width in f32 (``gemma3-1b`` at 6 layers,
   the others at 2), ``forward`` logits, ``loss_fn``'s gradient of the
   head (the tied ``embed``), chunked slot prefill of two prompts
   (``gemma3-1b``: 600 and 563 tokens, so the rings wrap) and 8
   teacher-forced ``decode_step``s, kernel attention on the card and
   plain on the CPU, within rtol 1e-4 of the largest CPU value; (b)
   ``python -m repro_torch.launch.train --arch <arch> --reduce 0
   --optimizer blockllm --batch 8 --seq 256 --steps 8`` (phase 16's loss
   gates, masked-Adam launches from the selections, the peak under 70
   GiB; ``deepseek-7b`` at 16 of 30 layers, the deepest cut that stays
   clear of that peak); (c) ``DecodeServer`` at full width and depth,
   bf16 cache, dense and paged with streams bitwise equal (``gemma3-1b``:
   520-720-token prompts, the local rings dense beside the global page
   pools, prefix sharing off; ``gemma-2b``: a tenant, prefix hits, and
   ``--speculate 4`` equal to plain decoding; ``deepseek-7b``: dense,
   bitwise a second run), one decode launch per layer per decode pass,
   and the decode step's wall and busy ms under the profiler;
29. distributed BlockLLM training (the port's slice 16) over NCCL at
   world size 1 (one card: NCCL refuses two ranks on one device; the
   multi-rank numerics are the CPU tests'): ``launch.steps.
   build_train_setup`` for ``internlm2-1.8b`` at full width and depth,
   8 x 256, f32 masters, on ``make_host_mesh()``'s (1, 1) mesh, then
   ``StepSetup.shard`` and 3 calls, against the same 3 steps through the
   core's single-device raw step from the same state: (a) loss, updated
   rows and both moments bitwise, one ``masked_adam`` launch per
   selected leaf per step, peak memory and step times (host clock and
   CUDA events); (b) the int8 error-feedback all-reduce over the step's
   selected-row gradients, twice: codes and scales bitwise the CPU
   codec's, ``new_e`` bitwise ``gc - deq`` and within half its block's
   scale (beyond it only where ``gc / scale`` rounds onto a tie, by at
   most that rounding), the mean bitwise ``deq``; (c) (a)'s collective
   counter, calls and bytes by kind;
30. the sharded serving setups (the port's slice 17): (a) the decode
   kernel's shard variant at gemma3-1b's global shape (G 4, KV 1, hd
   256, a bf16 cache of 524288 rows, 2 slots, one of which leaves the
   later shards without a visible row): the whole-cache call with offset
   0 and the log-sum-exp bitwise the call without them, the cache split
   into 8 and 256 shards merged with ``shard_ctx.merge_softmax`` within
   ``SHARD_RTOL`` of one whole call and within the kernel tolerance of
   today's call, sampled shards against the plain version, a ring case
   at gemma3-1b's local layers and recurrentgemma-2b's G 10 ring; a
   shard call's and the whole call's times beside the bound and SDPA;
   (b) ``build_setup``'s decode setup at world size 1 over NCCL for
   ``gemma3-1b`` at long_500k (1 x 524288) and ``internlm2-1.8b`` at
   decode_32k cut to one data rank's share of (32, 8) (4 x 32768), 4
   greedy steps with ``kernel``: logits and the whole cache bitwise the
   single-device ``decode_step``, logits within ``LOGIT_BF16_TOL`` of
   ``full``, decode-attention launches = attention layers x steps, no
   collective at world size 1, step p50 and peak memory, then the
   decode kernel against its plain version on one global layer's cache
   of the leg (its B, C, G, hd, bf16 q and cache) with a query whose
   scores peak on rows spread over the cache (``peaked_query``); (c) the
   prefill setup of ``gemma3-1b`` at prefill_32k cut to 1 x 32768:
   bitwise the single-device ``prefill``, wall time and peak memory;
then a ``kernels:`` summary and one JSON line with every kernel's
numbers, the card's name and power limit again, and as the last line
``{"ok": true, "device": {...}}``.

Every checkpoint -> crash -> resume leg (phases 9, 17, 24, 25, 26 and
27) runs 6 steps uninterrupted, then the same 6 steps checkpointed at
step 3 and crashed after step 5, then resumes from step 3 to step 6
without writing another checkpoint (a checkpoint at step 6 would never
be read).  Each must reselect after its checkpoint: the uninterrupted
run's selections exceed those in the checkpoint's host meta.

It imports nothing of the JAX package.  Long logs (ptxas output, the
profile tables) go to the ``OUT`` directory beside it; checkpoints and
the adapter registry (gigabytes) go to ``SCRATCH``, which ``.gitignore``
lists, and are deleted at the end.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time
from contextlib import contextmanager, nullcontext
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out"
SCRATCH = ROOT / "build" / "chip_smoke"
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
F32_FLOPS = 67e12                  # f32 outside the tensor cores
BF16_FLOPS = 989e12                # bf16 dense tensor cores
ARCH = "internlm2-1.8b"

# tolerances (reasons beside each)
ATTN_F32_RTOL, ATTN_F32_ATOL = 1e-4, 2e-5   # f32 output: summation order
ATTN_BF16_ATOL = 2e-2     # bf16 output: one rounding step apart at |o| < 4
LOGIT_F32_TOL = 2e-3      # f32 model: the two attentions differ in order only
LOGIT_BF16_TOL = 0.25     # bf16 model: the full path rounds probabilities
                          # to bf16 before PV, the kernel keeps f32
ADAM_F32_ULPS = 2         # masked Adam: the kernel and its plain version do
ADAM_BF16_ULPS = 1        # the same IEEE ops in the same order (no FMA)
SERVE_KERNELS = ("decode_attention", "scatter_swap")
RG_ARCH = "recurrentgemma-2b"
RG_TRAIN_ARGV = ["--arch", RG_ARCH, "--reduce", "0", "--optimizer",
                 "blockllm", "--batch", "8", "--seq", "256", "--steps", "8"]
RG_SCAN_SHAPES = ((8, 256, 2560), (2, 96, 192), (1, 33, 130), (2, 291, 200),
                  (1, 40, 7))
PAGED_ARGV = ["--arch", ARCH, "--reduce", "0", "--attn-impl", "kernel",
              "--demo-adapters", "2", "--slots", "8", "--max-seq", "1024",
              "--requests", "16", "--new-tokens", "32", "--paged",
              "--prefill-chunk", "32", "--steps-per-turn", "2"]
TRAIN_ARGV = ["--arch", ARCH, "--reduce", "0", "--optimizer", "blockllm+q8",
              "--batch", "8", "--seq", "256", "--steps", "8"]
# flash attention (slice 5).  f32 output: the JAX sweep's bound (sums in
# another order); bf16 output: one bf16 ulp of the plain output plus this
# atol (each rounds its own f32 result once; near zero an ulp is below it)
FLASH_F32_ATOL = 2e-5
# (B, Sq, Sk, H, KV, hd, causal, window): tests/test_kernels.py's sweep,
# ragged S (f32: tiles of 64 rows, 32 at hd 256, and 32 keys; bf16: 64-row
# tiles against 64 keys, 32 at hd 256), a q-tile smaller than a tile, Sq !=
# Sk non-causal (windowed rows past Sk see no key), hd 32 / 64 / 128 / 256;
# S 2048 causal at hd 128 (many pipeline stages, interior blocks unmasked)
# and S 1000 at hd 256 with window 300 and the local layers' 10 / 1 heads
# (ragged, windowed)
FLASH_SWEEP = ((2, 256, 256, 4, 2, 64, True, 0),
               (1, 512, 512, 4, 1, 64, True, 64),
               (2, 128, 128, 2, 2, 32, False, 0),
               (1, 384, 384, 4, 4, 128, True, 0),
               (1, 256, 256, 8, 2, 64, True, 128),
               (1, 1000, 1000, 4, 2, 128, True, 0),
               (1, 1000, 1000, 2, 1, 256, True, 300),
               (1, 100, 100, 2, 1, 256, True, 0),
               (2, 77, 77, 4, 1, 32, True, 0),
               (1, 200, 333, 4, 2, 32, False, 0),
               (1, 333, 200, 4, 1, 64, False, 64),
               (1, 384, 384, 10, 1, 256, True, 128),
               (1, 2048, 2048, 4, 2, 128, True, 0),
               (2, 1000, 1000, 10, 1, 256, True, 300))
# the main shapes: (B, S, H, KV, hd, window), causal, bf16
FLASH_MAIN = {"internlm2-1.8b": (2, 4096, 16, 8, 128, 0),
              "recurrentgemma-2b local": (2, 4096, 10, 1, 256, 2048)}
LONG_BATCH, LONG_SEQ = 2, 4096     # phase 20
# the crash -> resume legs: the run's steps, the checkpoint step and the
# crash step; the resumed run writes no checkpoint (at full width each is
# gigabytes of npz)
CRASH_STEPS, CRASH_CKPT, CRASH_AT = 6, 3, 5
# phase 24: the MoE family (slice 11)
MOE_ARCH = "granite-moe-3b-a800m"
MOE_TRAIN_ARGV = ["--arch", MOE_ARCH, "--reduce", "0", "--optimizer",
                  "blockllm", "--batch", "8", "--seq", "256", "--steps", "8"]
# the serving and xLSTM training legs below are host-bound (their step
# time is Python and launch overhead), so their depth is cut to keep the
# script inside its limit; the decode profiles keep the full depth
MOE_SERVE_LAYERS = 8       # of 32
MOE_SERVE_ARGV = ["--arch", MOE_ARCH, "--reduce", "0", "--layers",
                  str(MOE_SERVE_LAYERS), "--attn-impl",
                  "kernel", "--demo-adapters", "2", "--slots", "8",
                  "--max-seq", "256", "--requests", "16", "--new-tokens",
                  "16"]
MOE_LOGIT_RTOL = 1e-4     # card vs CPU, f32: relative to the largest logit
# phase 25: the xLSTM family (slice 12)
XLSTM_ARCH = "xlstm-1.3b"
XLSTM_LAYERS = 16          # of 48: two patterns (7 mLSTM : 1 sLSTM)
XLSTM_TRAIN_ARGV = ["--arch", XLSTM_ARCH, "--reduce", "0", "--layers",
                    str(XLSTM_LAYERS), "--optimizer",
                    "blockllm", "--batch", "8", "--seq", "256", "--steps",
                    "8"]
XLSTM_SERVE_ARGV = ["--arch", XLSTM_ARCH, "--reduce", "0", "--layers",
                    str(XLSTM_LAYERS), "--demo-adapters",
                    "2", "--slots", "8", "--max-seq", "256", "--requests",
                    "16", "--new-tokens", "16"]
XLSTM_LOGIT_RTOL = 1e-4   # card vs CPU, f32: relative to the largest logit
# phase 26: the whisper encoder-decoder (slice 13)
WHISPER_ARCH = "whisper-large-v3"
WHISPER_TRAIN_ARGV = ["--arch", WHISPER_ARCH, "--reduce", "0", "--optimizer",
                      "blockllm", "--batch", "8", "--seq", "256", "--steps",
                      "8"]
WHISPER_LOGIT_RTOL = 1e-4  # card vs CPU, f32: relative to the largest value
WHISPER_CONTEXT = 448      # whisper's decoder context (its config's note)
# whisper-large-v3's decode shape (MHA 20 heads, G = 1, hd 64)
DECODE_G1_CASES = (
    ("G1 hd64 bf16", 1, 64, WHISPER_CONTEXT, 0, False, 0.0, "bf16", "bf16"),
    ("G1 hd64 f32 q", 1, 64, WHISPER_CONTEXT, 0, False, 0.0, "f32", "bf16"),
    ("G1 hd64 f32 cache", 1, 64, WHISPER_CONTEXT, 0, False, 0.0, "bf16",
     "f32"),
)
# phase 27: the pixtral VLM (slice 14) and whole-sequence prefill
PIXTRAL_ARCH = "pixtral-12b"
PIXTRAL_TEXT = 32          # text tokens after the 256 patch positions
PIXTRAL_CONTEXT = 512      # rows of the decode cache
PIXTRAL_NEW = 16           # greedy decode steps after the prefill
# 8 layers: 13.1 GiB of f32 weights, the deepest cut whose BlockLLM peak
# stays under 70 GiB by the earlier families' 3.2-5.5x the f32 weights
PIXTRAL_TRAIN_LAYERS = 8
PIXTRAL_TRAIN_ARGV = ["--arch", PIXTRAL_ARCH, "--reduce", "0", "--layers",
                      str(PIXTRAL_TRAIN_LAYERS), "--optimizer", "blockllm",
                      "--batch", "8", "--seq", str(256 + PIXTRAL_TEXT),
                      "--steps", "8"]
PIXTRAL_PEAK_GIB = 70.0
PIXTRAL_RTOL = 1e-4        # card vs CPU, f32: relative to the largest value
PREFILL_RTOL = 1e-4        # prefill vs per-token priming, f32: relative to
                           # the leaf's largest value (sums in other orders)
# pixtral-12b's decode shape (GQA 32 / 8, hd 128) over its bf16 cache
DECODE_G4_CASES = (
    ("G4 hd128 bf16", 4, 128, PIXTRAL_CONTEXT, 0, False, 0.0, "bf16",
     "bf16"),
    ("G4 hd128 f32 q", 4, 128, PIXTRAL_CONTEXT, 0, False, 0.0, "f32",
     "bf16"),
)
# phase 28: the rest of the zoo (slice 15)
ZOO_ARCHS = ("gemma3-1b", "gemma-2b", "deepseek-7b")
ZOO_RTOL = 1e-4            # card vs CPU, f32: relative to the largest value
ZOO_CPU_LAYERS = {"gemma3-1b": 6, "gemma-2b": 2, "deepseek-7b": 2}
GEMMA3_WINDOW = 512        # gemma3-1b's local window (its config)
GEMMA3_PROMPT = 600        # (a): past the window, so the rings wrap
ZOO_PROMPT = 96            # (a): gemma-2b and deepseek-7b (no window)
ZOO_FED = 8                # (a): teacher-forced decode steps
ZOO_NEW = 16               # (c): new tokens a request
# deepseek-7b trains at the deepest cut whose BlockLLM peak stays under
# 70 GiB with room to spare (3.1 GiB of f32 embedding and head, 0.75 GiB
# a layer): 16 layers peak at 62.62 GiB; 17 select a fifth row (a quarter
# of the stack, rounded up) and peaked at 69.18 GiB alone and 69.56 after
# the earlier phases, 18 at 69.94 (scripts/zoo_probe.py, PERF.md)
ZOO_TRAIN_LAYERS = {"deepseek-7b": 16}
ZOO_PEAK_GIB = 70.0
# the decode shapes: gemma3-1b's MQA 4 / 1 at hd 256 (its 512-row ring and
# its global layers), gemma-2b's 8 / 1 at hd 256, deepseek-7b's MHA 32 x 128
DECODE_GEMMA_CASES = (
    ("G4 hd256 ring 512 bf16", 4, 256, GEMMA3_WINDOW, GEMMA3_WINDOW, True,
     0.0, "bf16", "bf16"),
    ("G4 hd256 ring 512 f32 q", 4, 256, GEMMA3_WINDOW, GEMMA3_WINDOW, True,
     0.0, "f32", "bf16"),
    ("G4 hd256 bf16", 4, 256, 1024, 0, False, 0.0, "bf16", "bf16"),
    ("G4 hd256 f32 q", 4, 256, 1024, 0, False, 0.0, "f32", "bf16"),
    ("G8 hd256 bf16", 8, 256, 1024, 0, False, 0.0, "bf16", "bf16"),
    ("G8 hd256 f32 q", 8, 256, 1024, 0, False, 0.0, "f32", "bf16"),
)
DECODE_DEEPSEEK_CASES = (
    ("G1 hd128 KV32 bf16", 1, 128, 1024, 0, False, 0.0, "bf16", "bf16"),
    ("G1 hd128 KV32 f32 q", 1, 128, 1024, 0, False, 0.0, "f32", "bf16"),
)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def host_yardstick(torch) -> str:
    """The host's speed, for comparing the host-bound phases of two runs:
    a fixed pure-Python loop and the host cost of one eager CUDA op (5000
    in-place adds on one element, then a synchronize)."""
    t0 = time.monotonic()
    sum(i * i for i in range(2_000_000))
    py_ms = (time.monotonic() - t0) * 1e3
    x = torch.zeros(1, device="cuda")
    for _ in range(100):
        x.add_(1)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(5000):
        x.add_(1)
    torch.cuda.synchronize()
    op_us = (time.monotonic() - t0) * 1e6 / 5000
    return (f"host yardstick: python loop {py_ms:.1f} ms, eager CUDA op "
            f"{op_us:.2f} us")


def cuda_time_ms(fn, iters: int) -> float:
    """Mean milliseconds per call over ``iters`` warm calls (CUDA events)."""
    import torch
    for _ in range(3):
        fn(0)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def median_time_ms(fn, iters: int = 50, runs: int = 5) -> float:
    """The median of ``runs`` runs of ``cuda_time_ms(fn, iters)``: a
    kernel of tens of microseconds varies by 15% from run to run."""
    return sorted(cuda_time_ms(fn, iters) for _ in range(runs))[runs // 2]


def graph_time_ms(fn, iters: int = 20, reps: int = 5) -> float:
    """Mean device milliseconds per call: ``iters`` calls captured in one
    CUDA graph and replayed, so host launch overhead is not counted."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * iters)


def replay_bitwise(torch, fn, ref) -> bool:
    """3 back-to-back calls, then 20 calls captured in one CUDA graph and
    replayed twice: whether every output equals ``ref`` bit for bit (an
    arrival counter that a launch left non-zero would change the next
    launch's merge)."""
    outs = [fn() for _ in range(3)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = [fn() for _ in range(20)]
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    return all(torch.equal(o, ref) for o in outs + captured)


def kernel_times(torch, prof) -> dict:
    """``{kernel: [records, device us]}`` of a finished ``torch.profiler``
    session, summed over its raw device records: what the device-type
    rows of ``key_averages()`` hold, without the Python event per record
    that ``key_averages()`` builds first (tens of seconds for the trace
    of a full-depth training step).  Names are demangled as the
    profiler's own rows are."""
    from torch.autograd import DeviceType
    out, names = {}, {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or e.is_async():
            continue
        raw = e.name()
        if raw not in names:
            names[raw] = torch._C._demangle(raw) if len(raw) > 1 else raw
        rec = out.setdefault(names[raw], [0, 0.0])
        rec[0] += 1
        rec[1] += e.duration_ns() / 1e3
    return out


def kernel_table(times: dict, n: int, rows: int = 40) -> str:
    """The ``rows`` kernels of ``kernel_times`` with the most device time,
    per step of ``n``: the table each profile writes to ``OUT``."""
    lines = [f"{'device ms/step':>14} {'calls/step':>10}  kernel"]
    for name, (count, us) in sorted(times.items(),
                                    key=lambda kv: -kv[1][1])[:rows]:
        lines.append(f"{us / 1e3 / n:14.3f} {count / n:10.1f}  {name}")
    return "\n".join(lines) + "\n"


def profile_records(torch, fn, calls: int = 20):
    """({kernel: (launches per call, device us per launch)}, sessions
    run) of ``fn(i)`` over ``calls`` warm calls under ``torch.profiler``.
    The tracer can lose the records of kernels launched from the port's
    libraries (all of a session's, once in some runs, and every one of
    three device-only sessions late in a run): a session that recorded
    no device kernel is run again, up to 3 device-only sessions and then
    3 that trace the host too (as the step profiles, which have not lost
    their records)."""
    from torch.profiler import ProfilerActivity, profile
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    rec = {}                 # by kernel name, template arguments dropped
    device = [ProfilerActivity.CUDA]
    both = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for session, acts in enumerate([device] * 3 + [both] * 3):
        with profile(activities=acts) as prof:
            for i in range(calls):
                fn(i)
            torch.cuda.synchronize()
        for key, (count, us) in kernel_times(torch, prof).items():
            if us > 0:
                name = key.split("(")[0].split("::")[-1].split("<")[0]
                n, t = rec.get(name, (0, 0.0))
                rec[name] = (n + count, t + us)
        if rec:
            break
        print(f"  profiler session {session + 1} recorded no device kernel")
    return {k: (n / calls, t / n) for k, (n, t) in rec.items()}, session + 1


def one_launch_profile(torch, name, shape, fn, calls: int = 20):
    """The profile of one decode-attention call: one kernel, launched
    once a call (the wrapper's count; the profiler's records, which can
    miss some launches, show no second kernel)."""
    from repro_torch.kernels import build
    before = build.LAUNCHES[name]
    rec, sessions = profile_records(torch, fn, calls)
    # 3 warm-up calls, then calls a session
    launched = (build.LAUNCHES[name] - before - 3) / sessions
    split = ", ".join(f"{k} x{n:g} {us:.2f} us" for k, (n, us) in rec.items())
    print(f"{name} profile [{shape}], per call: {split}; {launched:g} "
          f"wrapper launches for {calls} calls")
    if len(rec) != 1 or launched != calls or next(iter(rec.values()))[0] > 1:
        raise AssertionError(f"{name}: {len(rec)} kernels, {launched} "
                             f"launches for {calls} calls, not one a call")


def ptxas_summary(log: str, want: str):
    """(entry, registers, spill line) for entries whose name holds
    ``want``, plus the largest register count of the whole library."""
    rows, entry, most = [], None, 0
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else line
        elif "Used" in line and "registers" in line and entry:
            regs = int(line.split("Used")[1].split("registers")[0])
            most = max(most, regs)
            if want in entry:
                rows.append((entry, line.strip()))
        elif "spill" in line and entry and want in entry:
            rows.append((entry, line.strip()))
    return rows, most


# --------------------------------------------------------------------- #
# phase 2 + 3: kernels against their plain versions, and their times
# --------------------------------------------------------------------- #


# dense decode-attention checks: name, G, hd, C, window, ring, softcap,
# q dtype, cache dtype
DECODE_CASES = (
    ("main G2 bf16", 2, 128, 2048, 0, False, 0.0, "bf16", "bf16"),
    ("G2 f32 q", 2, 128, 2048, 0, False, 0.0, "f32", "bf16"),
    ("G1", 1, 128, 2048, 0, False, 0.0, "f32", "bf16"),
    ("G4", 4, 128, 2048, 0, False, 0.0, "f32", "bf16"),
    ("window 256", 2, 128, 2048, 256, False, 0.0, "f32", "bf16"),
    ("ring C512", 2, 128, 512, 512, True, 0.0, "f32", "bf16"),
    ("softcap 30", 2, 128, 2048, 0, False, 30.0, "f32", "bf16"),
    ("f32 cache", 2, 128, 2048, 0, False, 0.0, "f32", "f32"),
)
# phase 24: granite-moe-3b-a800m's decode shape (GQA 24 / 8, hd 64)
DECODE_G3_CASES = (
    ("G3 hd64 bf16", 3, 64, 1024, 0, False, 0.0, "bf16", "bf16"),
    ("G3 hd64 f32 cache", 3, 64, 1024, 0, False, 0.0, "bf16", "f32"),
    ("G3 hd64 f32 q", 3, 64, 1024, 0, False, 0.0, "f32", "bf16"),
    ("G3 hd64 f32 q f32 cache", 3, 64, 1024, 0, False, 0.0, "f32", "f32"),
)
DECODE_POS = [0, 127, 128, 1000, 2047, 513, 1536, 64]   # clipped to C - 1


def dtypes(torch):
    return {"bf16": torch.bfloat16, "f32": torch.float32}


def decode_cases(torch, da, cases, g, KV=8):
    """The dense kernel against its plain version on each of ``cases``
    (B 8, ``KV`` kv heads, q and caches drawn from ``g``).  Returns each
    case's max |kernel - plain|."""
    dev, B, dt = "cuda", 8, dtypes(torch)
    errs = {}
    for name, G, hd, C, window, ring, softcap, qs, cs in cases:
        qd, cd = dt[qs], dt[cs]
        q = torch.randn(B, 1, KV * G, hd, generator=g, device=dev).to(qd)
        k = torch.randn(B, C, KV, hd, generator=g, device=dev).to(cd)
        v = torch.randn(B, C, KV, hd, generator=g, device=dev).to(cd)
        pos = ([0, 100, 511, 512, 900, 1500, 2047, 3000] if ring
               else [min(p, C - 1) for p in DECODE_POS])
        pos = torch.tensor(pos, dtype=torch.int32, device=dev)
        kw = dict(window=window, ring=ring, softcap=softcap)
        o = da.decode_attention_cuda(q, k, v, pos, **kw)
        r = da.decode_attention_plain(q, k, v, pos, **kw)
        torch.cuda.synchronize()
        err = (o.float() - r.float()).abs()
        if qd == torch.float32:
            tol = ATTN_F32_ATOL + ATTN_F32_RTOL * r.float().abs()
            tol_s = f"rtol {ATTN_F32_RTOL} atol {ATTN_F32_ATOL}"
        else:
            tol = torch.full_like(err, ATTN_BF16_ATOL)
            tol_s = f"atol {ATTN_BF16_ATOL}"
        ok = bool((err <= tol).all()) and bool(torch.isfinite(o).all())
        print(f"decode_attention [{name}] B{B} C{C} KV{KV} G{G} hd{hd} "
              f"q {str(qd)[6:]} cache {str(cd)[6:]}: max|kernel-plain| "
              f"{err.max().item():.3g} ({tol_s}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"decode_attention [{name}] disagrees "
                                 f"with its plain version")
        errs[name] = err.max().item()
    return errs


def time_decode_attention(torch, da, results, g, *, G, hd, C, pos, worst,
                          prefix="", KV=8, window=0, ring=False):
    """Device times of the dense kernel (B 8, ``KV`` kv heads, bf16) at
    contexts ``pos`` of a ``C``-row cache (``ring``: a ring buffer of the
    last ``window`` = ``C`` positions) beside its plain version, SDPA and
    the bound; one launch per call; bitwise over launches and graph
    replays.  The numbers go into ``results["decode_attention"]`` under
    ``prefix``.  Returns q and the ring of cache copies."""
    dev, B = "cuda", 8
    copies = 8                                   # a ring of copies > L2
    q = torch.randn(B, 1, KV * G, hd, generator=g, device=dev).bfloat16()
    ks = [torch.randn(B, C, KV, hd, generator=g, device=dev).bfloat16()
          for _ in range(copies)]
    vs = [torch.randn(B, C, KV, hd, generator=g, device=dev).bfloat16()
          for _ in range(copies)]
    pos_t = torch.tensor(pos, dtype=torch.int32, device=dev)
    from repro_torch.models.layers import decode_valid
    mask = decode_valid(pos_t, C, window=window, ring=ring)[:, None, None, :]
    qt = q.transpose(1, 2)
    kw = dict(window=window, ring=ring)
    fns = {
        "kernel": lambda i: da.decode_attention_cuda(
            q, ks[i % copies], vs[i % copies], pos_t, **kw),
        "plain": lambda i: da.decode_attention_plain(
            q, ks[i % copies], vs[i % copies], pos_t, **kw),
        "sdpa": lambda i: torch.nn.functional.scaled_dot_product_attention(
            qt, ks[i % copies].transpose(1, 2),
            vs[i % copies].transpose(1, 2), attn_mask=mask,
            enable_gqa=True)}
    # device time (CUDA graph replay) and eager time per call (host
    # launch overhead included), each in turns
    dev_ms = {k: graph_time_ms(f) for k, f in fns.items()}
    eager_ms = {k: cuda_time_ms(f, 50) for k, f in fns.items()}
    # bound: q read, each slot's K/V rows lo*bk..pos read once (a ring:
    # its min(pos + 1, C) live rows), o written
    lo, _ = da.block_bounds(pos_t.cpu(), seq_len=C, **kw)
    rows = sum(min(int(p) + 1, C) - int(l) * 128 for p, l in zip(pos, lo))
    nbytes = 2 * q.nbytes + rows * KV * hd * 2 * 2
    flops = rows * KV * G * hd * 4               # QK and PV
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    bound = max(t_bytes, t_ops)
    shape = f"G{G} hd{hd} C{C}{' ring' if ring else ''}"
    one_launch_profile(torch, "decode_attention", f"{shape} pos {pos}",
                       fns["kernel"])
    same = replay_bitwise(torch, lambda: fns["kernel"](0), fns["kernel"](0))
    print(f"decode_attention [{shape} bf16] 3 back-to-back launches "
          f"and 20 graph replays bitwise the first: {same}")
    if not same:
        raise AssertionError("decode_attention varies across launches")
    results.setdefault("decode_attention", {}).update({
        prefix + "max_abs_err": worst, prefix + "ms": dev_ms["kernel"],
        prefix + "plain_ms": dev_ms["plain"], prefix + "bound_ms": bound,
        prefix + "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        prefix + "library_ms": dev_ms["sdpa"]})
    print(f"decode_attention time B{B} KV{KV} {shape} bf16, pos "
          f"{pos}: device (graph replay) kernel {dev_ms['kernel']:.4f} ms, "
          f"plain {dev_ms['plain']:.4f} ms, sdpa {dev_ms['sdpa']:.4f} ms; "
          f"bound {bound:.4f} ms ({nbytes / 1e6:.2f} MB), "
          f"{dev_ms['kernel'] / bound:.1f}x the bound; eager per call "
          f"kernel {eager_ms['kernel']:.4f} ms, plain "
          f"{eager_ms['plain']:.4f} ms, sdpa {eager_ms['sdpa']:.4f} ms")
    return q, ks, vs


def check_decode_attention(torch, da, results):
    g = torch.Generator("cuda").manual_seed(0)
    errs = decode_cases(torch, da, DECODE_CASES, g)
    q, ks, vs = time_decode_attention(
        torch, da, results, g, G=2, hd=128, C=2048, pos=DECODE_POS,
        worst=errs["main G2 bf16"])
    # one launch per call at serving contexts of the main path's max_seq
    # 1024
    srv_pos = torch.tensor([351, 420, 500, 610, 700, 760, 800, 821],
                           dtype=torch.int32, device="cuda")
    k1 = [k[:, :1024].contiguous() for k in ks]
    v1 = [v[:, :1024].contiguous() for v in vs]

    def serving(i):
        return da.decode_attention_cuda(q, k1[i % len(k1)], v1[i % len(v1)],
                                        srv_pos)
    srv_ms = graph_time_ms(serving)
    one_launch_profile(torch, "decode_attention", f"G2 hd128 C1024 pos "
                       f"{srv_pos.tolist()}", serving)
    print(f"decode_attention time B8 C1024 KV8 G2 hd128 bf16, pos "
          f"{srv_pos.tolist()}: device (graph replay) kernel {srv_ms:.4f} "
          f"ms")


def check_scatter_swap(torch, sa, results):
    dev = "cuda"
    G, C = 24, 2048 * 8192                      # w_gate [24, 2048, 8192]
    idx = [1, 3]
    for dt in (torch.float32, torch.bfloat16):
        full = torch.randn(G, C, device=dev).to(dt)
        orig = full.clone()
        rows = torch.randn(len(idx), C, device=dev).to(dt)
        bits = torch.int16 if dt == torch.bfloat16 else torch.int32
        kf, kd = sa.scatter_swap_cuda(full.clone(), idx, rows)
        pf, pd = sa.scatter_swap_plain(full.clone(), idx, rows)
        torch.cuda.synchronize()
        ok = (torch.equal(kf.view(bits), pf.view(bits))
              and torch.equal(kd.view(bits), pd.view(bits)))
        back, bd = sa.scatter_swap_cuda(kf, idx, kd)      # in place on kf
        torch.cuda.synchronize()
        ok = (ok and torch.equal(back.view(bits), orig.view(bits))
              and torch.equal(bd.view(bits), rows.view(bits)))
        print(f"scatter_swap [{str(dt)[6:]}] full [{G}, {C}] K {len(idx)}: "
              f"bitwise vs plain and apply∘apply == identity: "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("scatter_swap disagrees with its plain "
                                 "version or is not an involution")
        del kf, kd, pf, pd, back, bd
    full = torch.randn(G, C, device=dev)
    rows = [torch.randn(len(idx), C, device=dev) for _ in range(2)]
    ms = cuda_time_ms(lambda i: sa.scatter_swap_cuda(full, idx,
                                                     rows[i % 2]), 50)
    plain_ms = cuda_time_ms(lambda i: sa.scatter_swap_plain(
        full, idx, rows[i % 2]), 20)
    ix = torch.tensor(idx, device=dev)

    def library(i):
        disp = full.index_select(0, ix)
        full.index_copy_(0, ix, rows[i % 2])
        return disp

    lib_ms = cuda_time_ms(library, 50)
    nbytes = 4 * len(idx) * C * 4               # 2 row reads + 2 row writes
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    results["scatter_swap"] = dict(
        max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound,
        bound_by="bytes", library_ms=lib_ms)
    print(f"scatter_swap time full [{G}, {C}] f32 K {len(idx)}: kernel "
          f"{ms:.4f} ms, bound {bound:.4f} ms ({nbytes / 1e6:.1f} MB), "
          f"plain {plain_ms:.4f} ms, index_select+index_copy_ "
          f"{lib_ms:.4f} ms")


PAGED_PS, PAGED_NP = 16, 64   # the paged main path: max_seq 1024, 16-row pages


def bf16_ulps(torch, a, b) -> int:
    """Largest distance of two bf16 tensors in units of the last place,
    across zero too (sign-magnitude bits mapped to ordered integers)."""
    def ordered(t):
        i = t.contiguous().view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return int((ordered(a) - ordered(b)).abs().max())


def paged_state(torch, np, *, G, hd, qd, pd, pos, act, shared, seed, B=8,
                KV=8):
    """A valid paged decode state on the card: a shuffled page numbering,
    entries past each slot's ``pos`` unmapped (the null page 0), and the
    slots in ``shared`` mapping the same first two pages (none of them
    writes there: their pos >= 2 pages)."""
    rng = np.random.default_rng(seed)
    P = B * PAGED_NP + 1
    tbl = (1 + rng.permutation(P - 1))[:B * PAGED_NP].reshape(B, PAGED_NP)
    for b in shared:
        if pos[b] < 2 * PAGED_PS:
            raise ValueError("a slot sharing prefix pages would write one")
        tbl[b, :2] = tbl[shared[0], :2]
    for b, p in enumerate(pos):
        tbl[b, p // PAGED_PS + 1:] = 0
    g = torch.Generator("cuda").manual_seed(seed)

    def rn(*shape):
        return torch.randn(*shape, generator=g, device="cuda")
    return dict(
        q=rn(B, 1, KV * G, hd).to(qd), nk=rn(B, KV, hd), nv=rn(B, KV, hd),
        kp=rn(P, PAGED_PS, KV, hd).to(pd), vp=rn(P, PAGED_PS, KV, hd).to(pd),
        pos=torch.tensor(pos, dtype=torch.int32, device="cuda"),
        tbl=torch.tensor(tbl, dtype=torch.int32, device="cuda"),
        act=torch.tensor(act, dtype=torch.bool, device="cuda"))


def gathered(torch, pool, tbl):
    """Each slot's dense view [B, NP * ps, KV, hd] through the table."""
    P, ps, KV, hd = pool.shape
    ridx = (tbl.long()[:, :, None] * ps
            + torch.arange(ps, device=tbl.device)).reshape(tbl.shape[0], -1)
    return pool.view(P * ps, KV, hd)[ridx]


# paged decode-attention checks: name, G, hd, q dtype, pool dtype,
# window, softcap
PAGED_CASES = (
    ("main G2 hd128 bf16", 2, 128, "bf16", "bf16", 0, 0.0),
    ("G1 f32 q", 1, 128, "f32", "bf16", 0, 0.0),
    ("G8 hd64 f32 q", 8, 64, "f32", "bf16", 0, 0.0),
    ("G2 hd64 bf16", 2, 64, "bf16", "bf16", 0, 0.0),
    ("window 100", 2, 128, "f32", "bf16", 100, 0.0),
    ("softcap 30", 2, 128, "f32", "bf16", 0, 30.0),
    ("f32 pools", 2, 128, "f32", "f32", 0, 0.0),
)
# phase 24: granite-moe-3b-a800m's decode shape (GQA 24 / 8, hd 64)
PAGED_G3_CASES = (
    ("G3 hd64 bf16", 3, 64, "bf16", "bf16", 0, 0.0),
    ("G3 hd64 f32 q", 3, 64, "f32", "bf16", 0, 0.0),
    ("G3 hd64 f32 pools", 3, 64, "f32", "f32", 0, 0.0),
)
# phase 28: gemma3-1b's and gemma-2b's global layers (MQA at hd 256)
PAGED_GEMMA_CASES = (
    ("G4 hd256 bf16", 4, 256, "bf16", "bf16", 0, 0.0),
    ("G4 hd256 f32 q", 4, 256, "f32", "bf16", 0, 0.0),
    ("G8 hd256 bf16", 8, 256, "bf16", "bf16", 0, 0.0),
    ("G8 hd256 f32 q", 8, 256, "f32", "bf16", 0, 0.0),
)


def paged_cases(torch, np, da, cases, seed, KV=8, near_zero_atol=0.0):
    """The fused paged kernel on each of ``cases`` (``KV`` kv heads)
    against its plain version (o within the dense kernel's tolerance,
    pools bitwise outside the null page 0) and against the dense kernel
    on the gathered view at equal block_k (bitwise).  A bf16 output is
    held to one bf16 ulp of the plain output, plus ``near_zero_atol``
    where it is given (the flash check's bound: each rounds its own f32
    result once, and near zero an ulp is below the two f32 sums'
    difference).  Returns each case's max |kernel - plain|."""
    f32, dt = torch.float32, dtypes(torch)
    # pos: first / last row of a page (16, 31, 47, 64, 1023), long and
    # short contexts; slots 3 and 7 inactive; 2, 6, 7 share prefix pages
    pos = [16, 31, 200, 511, 900, 1023, 47, 64]
    act = [True, True, True, False, True, True, True, False]
    errs = {}
    for i, (name, G, hd, qs, ps, window, softcap) in enumerate(cases):
        qd, pd = dt[qs], dt[ps]
        x = paged_state(torch, np, G=G, hd=hd, qd=qd, pd=pd, pos=pos,
                        act=act, shared=(2, 6, 7), seed=seed + i, KV=KV)
        kw = dict(window=window, softcap=softcap)
        kk, kv = x["kp"].clone(), x["vp"].clone()
        pk, pv = x["kp"].clone(), x["vp"].clone()
        o, _, _ = da.paged_decode_attention_cuda(
            x["q"], x["nk"], x["nv"], kk, kv, x["pos"], x["tbl"], x["act"],
            **kw)
        r, _, _ = da.paged_decode_attention_plain(
            x["q"], x["nk"], x["nv"], pk, pv, x["pos"], x["tbl"], x["act"],
            **kw)
        od = da.decode_attention_cuda(
            x["q"], gathered(torch, kk, x["tbl"]),
            gathered(torch, kv, x["tbl"]), x["pos"], block_k=128, **kw)
        torch.cuda.synchronize()
        err = (o.float() - r.float()).abs()
        if qd == f32:
            ok_o = bool((err <= ATTN_F32_ATOL
                         + ATTN_F32_RTOL * r.float().abs()).all())
            tol_s = f"rtol {ATTN_F32_RTOL} atol {ATTN_F32_ATOL}"
        elif near_zero_atol:
            ok_o = bool((err <= bf16_ulp(torch, r.float()).float()
                         + near_zero_atol).all())
            tol_s = (f"1 bf16 ulp + {near_zero_atol:g}; "
                     f"{bf16_ulps(torch, o, r)} ulps apart at most")
        else:
            ok_o = bf16_ulps(torch, o, r) <= 1
            tol_s = "1 bf16 ulp"
        ok_pools = (torch.equal(kk[1:], pk[1:]) and torch.equal(kv[1:], pv[1:])
                    and not torch.equal(kk[1:], x["kp"][1:]))
        ok_dense = torch.equal(o, od)
        ok = ok_o and ok_pools and ok_dense and bool(torch.isfinite(o).all())
        print(f"paged_decode_attention [{name}] B8 KV{KV} G{G} hd{hd} ps "
              f"{PAGED_PS} q {str(qd)[6:]} pools {str(pd)[6:]}, shuffled "
              f"table, shared prefix pages, 2 inactive: max|kernel-plain| "
              f"{err.max().item():.3g} ({tol_s}), pools bitwise outside "
              f"page 0 {ok_pools}, bitwise == dense kernel on the gathered "
              f"view (block_k 128) {ok_dense}: {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"paged_decode_attention [{name}] "
                                 f"disagrees")
        errs[name] = err.max().item()
    return errs


def check_paged_decode_attention(torch, np, da, results):
    """The paged kernel's checks (``paged_cases``), then its time at the
    main path's shapes."""
    errs = paged_cases(torch, np, da, PAGED_CASES, seed=10)
    time_paged_decode_attention(torch, np, da, results,
                                errs["main G2 hd128 bf16"], G=2, hd=128,
                                seed=4)


def time_paged_decode_attention(torch, np, da, results, worst, *, G, hd,
                                seed, prefix="", KV=8):
    """Device times (B 8, ``KV`` kv heads, ps 16, contexts 200-900 drawn from
    ``seed``, bf16): the paged kernel, the dense kernel at the same
    contexts, the plain version, and gather + SDPA (several calls: no
    one PyTorch call computes the fused function).  The numbers go into
    ``results["paged_decode_attention"]`` under ``prefix``."""
    B, ps, NP = 8, PAGED_PS, PAGED_NP
    ctx = [int(c) for c in np.random.default_rng(seed).integers(200, 901, B)]
    x = paged_state(torch, np, G=G, hd=hd, qd=torch.bfloat16,
                    pd=torch.bfloat16, pos=ctx, act=[True] * B, shared=(),
                    seed=seed, KV=KV)
    copies = 8                         # > L2 between launches
    kps = [x["kp"]] + [x["kp"].clone() for _ in range(copies - 1)]
    vps = [x["vp"]] + [x["vp"].clone() for _ in range(copies - 1)]
    cks = [gathered(torch, k, x["tbl"]) for k in kps]
    cvs = [gathered(torch, v, x["tbl"]) for v in vps]
    q, pos, tbl, act = x["q"], x["pos"], x["tbl"], x["act"]
    nk, nv = x["nk"].bfloat16(), x["nv"].bfloat16()
    C = NP * ps
    valid = (torch.arange(C, device="cuda")[None, :]
             <= pos[:, None].long())[:, None, None, :]
    qt = q.transpose(1, 2)

    def library(i):
        ck = gathered(torch, kps[i % copies], tbl)
        cv = gathered(torch, vps[i % copies], tbl)
        return torch.nn.functional.scaled_dot_product_attention(
            qt, ck.transpose(1, 2), cv.transpose(1, 2), attn_mask=valid,
            enable_gqa=True)

    fns = {
        "kernel": lambda i: da.paged_decode_attention_cuda(
            q, nk, nv, kps[i % copies], vps[i % copies], pos, tbl, act),
        "dense": lambda i: da.decode_attention_cuda(
            q, cks[i % copies], cvs[i % copies], pos),
        "plain": lambda i: da.paged_decode_attention_plain(
            q, nk, nv, kps[i % copies], vps[i % copies], pos, tbl, act),
        "gather+sdpa": library}
    dev_ms = {k: graph_time_ms(f) for k, f in fns.items()}
    eager_ms = {k: cuda_time_ms(f, 50) for k, f in fns.items()}
    one_launch_profile(torch, "paged_decode_attention",
                       f"G{G} hd{hd} ps{ps} NP{NP} contexts {ctx}",
                       fns["kernel"])
    same = replay_bitwise(torch, lambda: fns["kernel"](0)[0],
                          fns["kernel"](0)[0])
    print(f"paged_decode_attention [G{G} hd{hd} bf16] 3 back-to-back "
          f"launches and 20 graph replays bitwise the first: {same}")
    if not same:
        raise AssertionError("paged_decode_attention varies across "
                             "launches")
    # bound: q, the new rows read; rows 0..pos-1 of K and V read once
    # (row pos comes from the new row); o and the new rows written
    rows = sum(ctx)
    nbytes = (2 * q.nbytes + 2 * (nk.nbytes + nv.nbytes)
              + rows * KV * hd * 2 * 2
              + sum(c // ps + 1 for c in ctx) * 4)     # the table slices
    flops = (rows + B) * KV * 2 * hd * 2 * G       # QK and PV
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    bound = max(t_bytes, t_ops)
    results.setdefault("paged_decode_attention", {}).update({
        prefix + "max_abs_err": worst, prefix + "ms": dev_ms["kernel"],
        prefix + "plain_ms": dev_ms["plain"], prefix + "bound_ms": bound,
        prefix + "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        prefix + "library_ms": dev_ms["gather+sdpa"]})
    print(f"paged_decode_attention time B{B} KV{KV} G{G} hd{hd} ps{ps} "
          f"bf16, contexts {ctx}: device (graph replay) kernel "
          f"{dev_ms['kernel']:.4f} ms, dense kernel same contexts "
          f"{dev_ms['dense']:.4f} ms, plain {dev_ms['plain']:.4f} ms, "
          f"gather+sdpa (several calls) {dev_ms['gather+sdpa']:.4f} ms; "
          f"bound {bound:.4f} ms ({nbytes / 1e6:.2f} MB), "
          f"{dev_ms['kernel'] / bound:.1f}x the bound; eager per call "
          f"kernel {eager_ms['kernel']:.4f} ms, dense "
          f"{eager_ms['dense']:.4f} ms, plain {eager_ms['plain']:.4f} ms, "
          f"gather+sdpa {eager_ms['gather+sdpa']:.4f} ms")
    del kps, vps, cks, cvs
    torch.cuda.empty_cache()


# --------------------------------------------------------------------- #
# phase 4 + 5: the serving path at full width
# --------------------------------------------------------------------- #


def serve_long_prompts(torch, np):
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import make_demo_registry
    from repro_torch.models import model as model_lib
    from repro_torch.runtime.serve_config import ServeConfig
    from repro_torch.runtime.serve_loop import DecodeServer, Request

    cfg = get_config(ARCH)
    params = model_lib.init_params(
        cfg, generator=torch.Generator("cuda").manual_seed(1), device="cuda")
    registry, ids = make_demo_registry(params, 2)
    tenants = [None] + ids
    srv = DecodeServer(cfg, params, ServeConfig(
        batch_slots=8, max_seq=1024, attn_impl="kernel"), registry=registry)
    del params
    rng = np.random.default_rng(1)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size,
                                               int(rng.integers(200, 901))),
                    max_new_tokens=32, adapter_id=tenants[i % 3])
            for i in range(16)]
    for r in reqs:
        srv.submit(r)
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    srv.run_until_drained()
    torch.cuda.synchronize()
    dt = time.monotonic() - t0
    launches = dict(ops.LAUNCHES)
    st = srv.stats()
    tok = sum(len(r.out) for r in reqs)
    print(f"long-prompt serve ({ARCH}, 8 slots, prompts 200-900, 3 "
          f"tenants): {tok} tokens in {dt:.2f} s ({tok / dt:.1f} tok/s), "
          f"decode step ms p50 {st['decode']['step_ms']['p50']:.2f} "
          f"p99 {st['decode']['step_ms']['p99']:.2f}, "
          f"{st['decode']['steps']} steps, prefill "
          f"{st['prefill']['prompt_tokens']} prompt tokens in "
          f"{st['prefill']['dispatches']} dispatches, swaps "
          f"{st['sched']['swaps']}, launches {launches}")
    if not all(r.done and len(r.out) == 32 for r in reqs):
        raise AssertionError("long-prompt serve left requests unfinished")
    if not all(launches[k] for k in SERVE_KERNELS):
        raise AssertionError(f"a kernel did not launch: {launches}")
    srv.restore_base()
    return srv


def teacher_forced(torch, np):
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as model_lib

    base_cfg = get_config(ARCH)
    rng = np.random.default_rng(2)
    B, steps, max_seq = 8, 16, 1024
    lengths = rng.integers(300, 900, B)
    prompt = rng.integers(0, base_cfg.vocab_size, (B, int(lengths.max())))
    params = model_lib.init_params(
        base_cfg, generator=torch.Generator("cuda").manual_seed(2),
        device="cuda")
    for dtype, tol in (("float32", LOGIT_F32_TOL),
                       ("bfloat16", LOGIT_BF16_TOL)):
        cfg = base_cfg.replace(dtype=dtype)
        logits = {}
        fed = []
        for impl in ("kernel", "full"):
            cache = model_lib.init_cache(cfg, B, max_seq, device="cuda")
            last = None
            for s in range(0, prompt.shape[1], 128):
                toks = torch.as_tensor(prompt[:, s:s + 128], device="cuda")
                lg, _ = model_lib.prefill_into_slots(
                    params, cfg, cache, toks, lengths, chunk_start=s)
                done = (lengths > s) & (lengths <= s + toks.shape[1])
                last = lg if last is None else torch.where(
                    torch.as_tensor(done, device="cuda")[:, None], lg, last)
            tok = last.argmax(-1)
            pos = torch.as_tensor(lengths, dtype=torch.int32, device="cuda")
            out = []
            for i in range(steps):
                t = fed[i] if impl == "full" else tok
                if impl == "kernel":
                    fed.append(t)
                lg, _ = model_lib.decode_step(params, cfg, cache, t[:, None],
                                              pos, attn_impl=impl)
                out.append(lg.float())
                tok = lg.argmax(-1)
                pos = pos + 1
            logits[impl] = out
        diffs = [(a - b).abs().max().item()
                 for a, b in zip(logits["kernel"], logits["full"])]
        finite = all(bool(torch.isfinite(a).all()) for a in logits["kernel"])
        scale = max(a.abs().max().item() for a in logits["full"])
        print(f"teacher-forced {dtype} ({ARCH}, B{B}, prompts "
              f"{int(lengths.min())}-{int(lengths.max())}, {steps} steps): "
              f"max|logit kernel - full| per step "
              f"{[round(d, 5) for d in diffs]} (tol {tol}; max|logit| "
              f"{scale:.3g}) {'ok' if max(diffs) <= tol and finite else 'FAIL'}")
        if not finite or max(diffs) > tol:
            raise AssertionError(f"teacher-forced {dtype} logits disagree")


def decode_stepper(torch, np, cfg, params, paged):
    """A steady full-width decode step over 8 slots primed with
    300-900-token contexts (the same prompts for both layouts; bf16
    cache, kernel attention; ``paged``: 16-row pages in order after the
    null page).  Returns ``(step, lengths)``; each ``step()`` decodes one
    token per slot and syncs on the host, as the server does."""
    from repro_torch.models import model as model_lib

    rng = np.random.default_rng(3)
    B, max_seq = 8, 1024
    kw, table = {}, None
    if not model_lib.supports_slot_prefill(cfg):
        # an xLSTM state is one size at every context: prime 8 tokens
        # per slot through the decode step, as the server does
        lengths = np.full(B, 8)
        cache = model_lib.init_cache(cfg, B, max_seq, device="cuda")
        for t, col in enumerate(rng.integers(0, cfg.vocab_size, (8, B))):
            model_lib.decode_step(
                params, cfg, cache, torch.as_tensor(col[:, None],
                                                    device="cuda"),
                torch.full((B,), t, dtype=torch.int32, device="cuda"))
        prompt = np.zeros((B, 0), np.int64)
    else:
        lengths = rng.integers(300, 900, B)
        prompt = rng.integers(0, cfg.vocab_size, (B, int(lengths.max())))
    if paged:
        table = (1 + np.arange(B * PAGED_NP)).reshape(B, PAGED_NP)
        cache = model_lib.init_paged_cache(cfg, B, B * PAGED_NP + 1,
                                           PAGED_PS, max_seq, device="cuda")
        kw = dict(page_table=table, begin=np.zeros(B, np.int32))
    elif prompt.shape[1]:
        cache = model_lib.init_cache(cfg, B, max_seq, device="cuda")
    for s in range(0, prompt.shape[1], 128):
        model_lib.prefill_into_slots(
            params, cfg, cache,
            torch.as_tensor(prompt[:, s:s + 128], device="cuda"), lengths,
            chunk_start=s, **kw)
    pos = torch.as_tensor(lengths, dtype=torch.int32, device="cuda")
    tok = torch.zeros(B, 1, dtype=torch.int64, device="cuda")
    tbl = (None if table is None else
           torch.as_tensor(table, dtype=torch.int32, device="cuda"))

    def step():
        nonlocal pos, tok
        lg, _ = model_lib.decode_step(params, cfg, cache, tok, pos,
                                      attn_impl="kernel", page_table=tbl)
        tok = lg.argmax(-1, keepdim=True).cpu().to("cuda")
        pos = pos + 1

    return step, lengths


def paged_vs_dense_steps(torch, np):
    """The paged decode step against the dense one at realistic contexts
    (``decode_stepper``: 8 slots, 300-900 rows, the same weights and
    prompts), in alternating segments (dense, paged, paged, dense, ...)
    of 6 steps, so drift of the shared host falls on both: wall ms per
    step, median of each layout and the median of the per-pair ratios."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as model_lib

    cfg = get_config(ARCH)
    params = model_lib.init_params(
        cfg, generator=torch.Generator("cuda").manual_seed(3), device="cuda")
    steps = {"dense": decode_stepper(torch, np, cfg, params, False)[0],
             "paged": decode_stepper(torch, np, cfg, params, True)[0]}
    for f in steps.values():
        for _ in range(2):
            f()
    ms = {"dense": [], "paged": []}
    seg = {"dense": [], "paged": []}
    for i in range(8):
        name = ("dense", "paged")[(i + i // 2) % 2]       # d p p d d p p d
        got = []
        for _ in range(6):
            t0 = time.perf_counter()
            steps[name]()
            got.append((time.perf_counter() - t0) * 1e3)
        ms[name] += got
        seg[name].append(float(np.median(got)))
    ratio = float(np.median(np.asarray(seg["paged"]) / np.asarray(seg["dense"])))
    print(f"paged vs dense decode step ({ARCH}, bf16, B8, contexts 300-900, "
          f"kernel attention, 4 alternating 6-step segments each): wall "
          f"ms/step median dense {np.median(ms['dense']):.3f} paged "
          f"{np.median(ms['paged']):.3f}; segment medians dense "
          f"{[round(x, 3) for x in seg['dense']]} paged "
          f"{[round(x, 3) for x in seg['paged']]}; median paged/dense "
          f"ratio of paired segments {ratio:.4f}")
    del params, steps
    torch.cuda.empty_cache()


def profile_decode(torch, np, paged=False, arch=ARCH):
    """Where a full-width decode step's time goes: 4 steady bf16 decode
    steps (``decode_stepper``: 8 slots, 300-900-token contexts, kernel
    attention; ``paged``: through 16-row pages and the fused paged
    kernel) under ``torch.profiler``: wall per step, device busy per
    step, top kernels.  Returns the device ms per step by kind."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as model_lib

    cfg = get_config(arch)
    params = model_lib.init_params(
        cfg, generator=torch.Generator("cuda").manual_seed(3), device="cuda")
    step, lengths = decode_stepper(torch, np, cfg, params, paged)
    label = ("paged" if paged else "dense") + (
        "" if arch == ARCH else f"_{arch}")
    out = profile_steps(torch, step, label, f"{arch}, bf16, B8, contexts "
                        f"{int(lengths.min())}-{int(lengths.max())}, kernel "
                        f"attention")
    del params, step
    return out


def profile_steps(torch, step, label, desc, n=4):
    """``n`` steady ``step()``s (after 2 warm ones) under
    ``torch.profiler``: wall per step, device busy per step, the idle
    share, device ms per step by kind and the top kernels; the table goes
    to ``OUT``.  Returns ``(groups, wall_ms, busy)``."""
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.monotonic()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3 / n
    times = kernel_times(torch, prof)
    busy = sum(us for _, us in times.values()) / 1e3 / n
    print(f"decode step profile, {label} ({desc}, {n} steps): wall "
          f"{wall_ms:.2f} ms/step, device busy {busy:.2f} ms/step, idle "
          f"share {max(0.0, 1 - busy / wall_ms):.1%}")
    groups = {"decode attention (both passes)": 0.0, "gemm/gemv": 0.0,
              "elementwise/copy": 0.0, "other": 0.0}
    for key, (_, us) in times.items():
        name = key.lower()
        t = us / 1e3 / n
        if "decode_attention" in name:
            groups["decode attention (both passes)"] += t
        elif any(w in name for w in ("gemm", "gemv", "cutlass", "sm90_",
                                     "matmul", "nvjet")):
            groups["gemm/gemv"] += t
        elif any(w in name for w in ("elementwise", "copy", "cast",
                                     "vectorized", "unrolled")):
            groups["elementwise/copy"] += t
        else:
            groups["other"] += t
    print("  device ms/step by kind: " + ", ".join(
        f"{k} {v:.2f}" for k, v in groups.items()))
    for key, (count, us) in sorted(times.items(),
                                   key=lambda kv: -kv[1][1])[:8]:
        print(f"  {us / 1e3 / n:8.3f} ms/step {count // n:5d} calls/step  "
              f"{key[:70]}")
    (OUT / f"decode_profile_{label}.txt").write_text(kernel_table(times, n))
    return groups, wall_ms, busy

# --------------------------------------------------------------------- #
# phases 10-13: paged KV serving (slice 3)
# --------------------------------------------------------------------- #


def dense_streams(torch, np, reqs, *, slots, prefill_chunk, seed,
                  steps_per_turn=8):
    """The same requests (prompts, tenants, budgets) through a dense
    ``DecodeServer`` with the launcher's weights and demo tenants (the
    same seed): the reference a paged run's streams must equal.  Returns
    the streams and the run's decode step ms (p50, p99)."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import make_demo_registry
    from repro_torch.models import model as model_lib
    from repro_torch.runtime.serve_config import SchedConfig, ServeConfig
    from repro_torch.runtime.serve_loop import DecodeServer, Request

    cfg = get_config(ARCH)
    params = model_lib.init_params(
        cfg, generator=torch.Generator("cuda").manual_seed(seed),
        device="cuda")
    registry, _ = make_demo_registry(params, 2)
    srv = DecodeServer(cfg, params, ServeConfig(
        batch_slots=slots, max_seq=1024, attn_impl="kernel",
        prefill_chunk=prefill_chunk,
        sched=SchedConfig(steps_per_turn=steps_per_turn)),
        registry=registry)
    del params
    out = [Request(rid=r.rid, prompt=np.asarray(r.prompt),
                   max_new_tokens=r.max_new_tokens, adapter_id=r.adapter_id)
           for r in reqs]
    for r in out:
        srv.submit(r)
    srv.run_until_drained()
    step_ms = srv.stats()["decode"]["step_ms"]
    del srv, registry
    torch.cuda.empty_cache()
    return [r.out for r in out], (step_ms["p50"], step_ms["p99"])


def paged_main_path(torch, np, ops):
    """``--paged`` through the launcher at full width and depth (kernel
    attention, 8 slots, max_seq 1024, 16 requests, base + 2 demo
    tenants sharing a 24-token system prompt; 2-step turns, so a tenant
    is admitted in several waves and later waves map the first wave's
    prefix pages): streams equal to a dense run of the same requests,
    one paged-kernel launch per layer per decode step and no dense
    decode-attention launch, prefix hits.  The prefill
    chunk is 32, so every prompt (28-31 tokens) is one chunk in both
    layouts and rows computed for one request are bitwise the rows
    another maps (the JAX package's condition for paged == dense under
    prefix sharing: prompt lengths aligned with the chunk grid)."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import serve
    layers = get_config(ARCH).num_layers
    print(f"paged main path: python -m repro_torch.launch.serve "
          f"{' '.join(PAGED_ARGV)}")
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    srv, reqs = serve.run(PAGED_ARGV)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    st = srv.stats()
    kv, dec = st["kv"], st["decode"]
    steps = dec["steps"]
    streams = [r.out for r in reqs]
    del srv
    torch.cuda.empty_cache()
    print(f"paged main path: {sum(map(len, streams))} tokens, {wall:.2f} s "
          f"wall including init, {steps} decode steps, step ms p50 "
          f"{dec['step_ms']['p50']:.2f} p99 {dec['step_ms']['p99']:.2f}, "
          f"launches {launches}, peak device memory {peak:.2f} GiB; kv: "
          f"{kv['num_pages']} pages x {kv['page_size']}, prefix hits "
          f"{kv['prefix_hit_pages']} pages ({kv['prefix_hit_tokens']} "
          f"tokens), cow splits {kv['cow_split']}, allocs "
          f"{kv['page_alloc']}, frees {kv['page_free']}")
    for r in reqs[:4]:
        print(f"  req {r.rid} [{r.adapter_id or 'base'}] prompt "
              f"{len(r.prompt)} -> {r.out[:12]}...")
    dense, (d50, d99) = dense_streams(torch, np, reqs, slots=8,
                                      prefill_chunk=32, seed=0,
                                      steps_per_turn=2)
    same = streams == dense
    print(f"paged main path: streams equal to a dense run of the same "
          f"requests (prefill chunk 32, 2-step turns, kernel attention): "
          f"{same}; the dense run's step ms p50 {d50:.2f} p99 {d99:.2f}")
    fails = []
    if sum(map(len, streams)) != 16 * 32:
        fails.append("tokens")
    if not same:
        fails.append("streams differ from the dense run")
    if launches["paged_decode_attention"] != layers * steps:
        fails.append(f"paged launches {launches['paged_decode_attention']}"
                     f" != {layers} layers x {steps} decode steps")
    if launches["decode_attention"] or not launches["scatter_swap"]:
        fails.append("dense decode attention launched, or no swap")
    if not kv["prefix_hit_pages"]:
        fails.append("no prefix hits")
    if fails:
        raise AssertionError(f"paged main path: {fails}")
    return launches, streams


def paged_tight_pool(torch, np):
    """16 slots over the auto page count of 8 slots (513 pages), one
    tenant (the base model), so the page pool and not the scheduler
    bounds admission: prompts of 192-896 tokens (multiples of the
    64-token prefill chunk, so rows do not depend on which requests are
    primed together) reserve their worst case at admission, so fewer
    than 16 are ever live; every request finishes, and the streams equal
    a dense 16-slot run."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as model_lib
    from repro_torch.runtime.serve_config import KVConfig, ServeConfig
    from repro_torch.runtime.serve_loop import DecodeServer, Request

    cfg = get_config(ARCH)
    params = model_lib.init_params(
        cfg, generator=torch.Generator("cuda").manual_seed(5), device="cuda")
    srv = DecodeServer(cfg, params, ServeConfig(
        batch_slots=16, max_seq=1024, attn_impl="kernel", prefill_chunk=64,
        kv=KVConfig(layout="paged", page_size=PAGED_PS,
                    pages=8 * PAGED_NP + 1)))
    del params
    rng = np.random.default_rng(5)
    reqs = [Request(rid=i, prompt=rng.integers(
        0, cfg.vocab_size, 64 * int(rng.integers(3, 15))),
        max_new_tokens=32) for i in range(16)]
    for r in reqs:
        srv.submit(r)
    most = [0]

    def watch(s):
        most[0] = max(most[0], sum(r is not None for r in s.active))
    t0 = time.monotonic()
    srv.run_until_drained(on_step=watch)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    kv = srv.stats()["kv"]
    need = sum(-(-(len(r.prompt) + 32) // PAGED_PS) for r in reqs)
    del srv
    torch.cuda.empty_cache()
    dense, _ = dense_streams(torch, np, reqs, slots=16, prefill_chunk=64,
                             seed=5)
    same = [r.out for r in reqs] == dense
    done = all(r.done and len(r.out) == 32 for r in reqs)
    print(f"tight pool: 16 slots over {kv['num_pages']} pages (the auto "
          f"count of 8 slots), one tenant, prompts "
          f"{min(len(r.prompt) for r in reqs)}-"
          f"{max(len(r.prompt) for r in reqs)}, {need} pages reserved if "
          f"all were live: most slots active at once {most[0]}, all "
          f"finished {done}, {wall:.2f} s, allocs {kv['page_alloc']}, "
          f"streams equal to a dense 16-slot run: {same}")
    if not (done and same and most[0] < 16):
        raise AssertionError("tight pool: unfinished, unequal streams or "
                             "no throttling")


def paged_speculative(torch, np, ops, plain_streams):
    """``--paged --speculate 4``: streams equal to the plain paged run,
    and one paged-kernel launch per layer per decode pass: n draft plus
    n + 1 verify passes per round (``spec.passes``) and one per plain
    step (a round whose budget leaves no draft), no dense launch."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import serve
    layers = get_config(ARCH).num_layers
    argv = PAGED_ARGV + ["--speculate", "4"]
    print(f"speculative: python -m repro_torch.launch.serve {' '.join(argv)}")
    ops.reset_launches()
    t0 = time.monotonic()
    srv, reqs = serve.run(argv)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    st = srv.stats()
    sp, kv = st["spec"], st["kv"]
    plain = st["decode"]["steps"] - sp["rounds"]
    launches = dict(ops.LAUNCHES)
    del srv
    torch.cuda.empty_cache()
    same = [r.out for r in reqs] == plain_streams
    print(f"speculative: {wall:.2f} s wall including init, "
          f"{sp['rounds']} rounds, acceptance {sp['acceptance_rate']:.3f} "
          f"({sp['accepted']} / {sp['drafted']}), "
          f"{sp['tokens_per_step']:.2f} tokens per round, "
          f"{sp['rollbacks']} rounds with a rejection, rollback pages "
          f"{kv['spec_rollback_pages']}, flips {sp['flips']}, step ms "
          f"p50 {st['decode']['step_ms']['p50']:.2f}, {sp['passes']} "
          f"decode passes in rounds + {plain} plain steps, launches "
          f"{launches}; streams equal to the plain paged run: {same}")
    want = layers * (sp["passes"] + plain)
    if not same or launches["paged_decode_attention"] != want \
            or launches["decode_attention"]:
        raise AssertionError(
            f"speculative: streams equal {same}, paged launches "
            f"{launches['paged_decode_attention']} (want {layers} layers x "
            f"({sp['passes']} + {plain}) passes = {want}), dense launches "
            f"{launches['decode_attention']}")


# --------------------------------------------------------------------- #
# phases 6-9: training (masked Adam, the BlockLLM trainers)
# --------------------------------------------------------------------- #


def ulps(torch, a, b) -> int:
    """Largest distance in units of the last place (f32 or bf16)."""
    bits = torch.int16 if a.element_size() == 2 else torch.int32
    return int((a.view(bits).long() - b.view(bits).long()).abs().max())


def selection_shapes(cfg, k):
    """Leaf shapes of the main path's BlockLLM selection: K rows of each of
    the 9 stacked leaves, plus the embed, head and final_norm units."""
    d, f, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    hq, hkv = cfg.num_heads * cfg.resolved_head_dim, (
        cfg.num_kv_heads * cfg.resolved_head_dim)
    rows = {"ln1": (d,), "ln2": (d,), "wq": (d, hq), "wk": (d, hkv),
            "wv": (d, hkv), "wo": (hq, d), "w_up": (d, f), "w_gate": (d, f),
            "w_down": (f, d)}
    out = {n: (k,) + shp for n, shp in rows.items()}
    out.update(embed=(V, d), head=(d, V), final_norm=(d,))
    return out


def adam_inputs(torch, shape, dtype, seed, offset=0):
    g = torch.Generator("cuda").manual_seed(seed)
    n = 1
    for x in shape:
        n *= x

    def mk():
        return torch.randn(n + offset, generator=g,
                           device="cuda")[offset:].view(shape)
    p, gr = mk().to(dtype), (mk() * 0.01).to(dtype)
    m = mk() * 1e-3
    v = mk().abs_() * 1e-5
    mask = torch.rand(shape, generator=g, device="cuda") > 0.875
    return p, gr, m, v, mask


def check_masked_adam(torch, ma, results):
    """Both kernels against their plain versions: ragged and misaligned
    sizes, and the main path's largest leaf shapes (a stacked leaf's 6
    selected rows, the embedding table)."""
    from repro_torch.configs.base import get_config
    from repro_torch.runtime.compression import quantize_int8
    cfg = get_config(ARCH)
    shapes = selection_shapes(cfg, 6)
    cases = [((100, 257), 0), ((4099,), 1), ((7,), 0),
             (shapes["w_gate"], 0), (shapes["embed"], 0)]
    scal = ma.scalars(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01,
                      count=3, tau=0.7)
    worst = {"masked_adam": 0.0, "masked_adam_q8": 0.0}
    for shape, off in cases:
        big = shape in (shapes["w_gate"], shapes["embed"])
        for dt in ((torch.float32,) if big else
                   (torch.float32, torch.bfloat16)):
            for gate in ("mask", "none", "tau"):
                p, g, m, v, mask = adam_inputs(torch, shape, dt, 11, off)
                mk = mask if gate == "mask" else None
                tau = gate == "tau"
                # f32 moments
                kp, km, kv = p.clone(), m.clone(), v.clone()
                ma.masked_adam_cuda(kp, g, km, kv, mk, scal, use_tau=tau)
                pp, pm, pv = p.clone(), m.clone(), v.clone()
                ma.masked_adam_plain(pp, g, pm, pv, mk, scal, use_tau=tau)
                torch.cuda.synchronize()
                lim = ADAM_BF16_ULPS if dt == torch.bfloat16 else ADAM_F32_ULPS
                u = (ulps(torch, kp, pp), ulps(torch, km, pm),
                     ulps(torch, kv, pv))
                err = (kp.float() - pp.float()).abs().max().item()
                ok = u[0] <= lim and max(u[1:]) <= ADAM_F32_ULPS
                print(f"masked_adam [{gate}] {tuple(shape)} "
                      f"{str(dt)[6:]}{' misaligned' if off else ''}: ulps "
                      f"p/m/v {u}, max|kernel-plain| p {err:.3g} "
                      f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError("masked_adam disagrees with its "
                                         "plain version")
                if big and dt == torch.float32:
                    worst["masked_adam"] = max(worst["masked_adam"], err)
                del kp, km, kv, pp, pm, pv
                # Q8 moments
                q = [t for pair in (quantize_int8(m), quantize_int8(v))
                     for t in pair]
                k8 = [p.clone()] + [t.clone() for t in q]
                ma.masked_adam_q8_cuda(k8[0], g, *k8[1:], mk, scal,
                                       use_tau=tau)
                p8 = [p.clone()] + [t.clone() for t in q]
                ma.masked_adam_q8_plain(p8[0], g, *p8[1:], mk, scal,
                                        use_tau=tau)
                torch.cuda.synchronize()
                codes = (torch.equal(k8[1], p8[1])
                         and torch.equal(k8[3], p8[3]))
                scales = (torch.equal(k8[2].view(torch.int32),
                                      p8[2].view(torch.int32))
                          and torch.equal(k8[4].view(torch.int32),
                                          p8[4].view(torch.int32)))
                up = ulps(torch, k8[0], p8[0])
                err = (k8[0].float() - p8[0].float()).abs().max().item()
                ok = codes and scales and up <= lim
                print(f"masked_adam_q8 [{gate}] {tuple(shape)} "
                      f"{str(dt)[6:]}: codes bitwise {codes}, scales "
                      f"bitwise {scales}, p ulps {up} "
                      f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError("masked_adam_q8 disagrees with its "
                                         "plain version")
                if big and dt == torch.float32:
                    worst["masked_adam_q8"] = max(worst["masked_adam_q8"],
                                                  err)
                del k8, p8, q, p, g, m, v, mask
    for name in worst:
        results[name] = {"max_abs_err": worst[name]}
    torch.cuda.empty_cache()


def time_masked_adam(torch, ops, results):
    """Device time of one optimizer step over the main path's whole
    selection (12 leaves, 756.6 M elements): the kernels, their plain
    versions, and ``torch._fused_adam_`` (Adam without a mask) as the
    nearest one-call yardstick."""
    from repro_torch.configs.base import get_config
    from repro_torch.optim.q8adam import quantize_tree
    cfg = get_config(ARCH)
    shapes = selection_shapes(cfg, 6)
    n = sum(int(torch.Size(s).numel()) for s in shapes.values())
    g = torch.Generator("cuda").manual_seed(12)
    p = {k: torch.randn(s, generator=g, device="cuda") for k, s in
         shapes.items()}
    gr = {k: torch.randn(s, generator=g, device="cuda") * 0.01
          for k, s in shapes.items()}
    m = {k: torch.randn(s, generator=g, device="cuda") * 1e-3
         for k, s in shapes.items()}
    v = {k: torch.rand(s, generator=g, device="cuda") * 1e-5
         for k, s in shapes.items()}
    mask = {k: torch.rand(s, generator=g, device="cuda") > 0.875
            for k, s in shapes.items()}
    kw = dict(lr=1e-3, count=3, weight_decay=0.0)
    f32 = {"kernel": lambda i: ops.masked_adam_tree(p, gr, m, v, mask,
                                                    mode="kernel", **kw),
           "plain": lambda i: ops.masked_adam_tree(p, gr, m, v, mask,
                                                   mode="plain", **kw)}
    steps = [torch.full((), 4.0, device="cuda") for _ in p]
    args = [list(t.values()) for t in (p, gr, m, v)]
    lib = (lambda i: torch._fused_adam_(
        *args, [], steps, lr=1e-3, beta1=0.9, beta2=0.999, weight_decay=0.0,
        eps=1e-8, amsgrad=False, maximize=False))
    ms = {"kernel": cuda_time_ms(f32["kernel"], 10),
          "plain": cuda_time_ms(f32["plain"], 3),
          "library": cuda_time_ms(lib, 10)}
    ms["kernel2"] = cuda_time_ms(f32["kernel"], 10)
    mq, ms_, vq, vs = (*quantize_tree(m), *quantize_tree(v))
    del m, v, args
    torch.cuda.empty_cache()
    q8 = {"kernel": lambda i: ops.masked_adam_q8_tree(
              p, gr, mq, ms_, vq, vs, mask, mode="kernel", **kw),
          "plain": lambda i: ops.masked_adam_q8_tree(
              p, gr, mq, ms_, vq, vs, mask, mode="plain", **kw)}
    ms8 = {"kernel": cuda_time_ms(q8["kernel"], 10),
           "plain": cuda_time_ms(q8["plain"], 3)}
    ms8["kernel2"] = cuda_time_ms(q8["kernel"], 10)
    # bounds: every input read once, every output written once
    nb = n // 256 + len(shapes)                      # codec blocks, rounded up
    f32_bytes = n * (4 * 4 + 1) + n * 3 * 4          # p g m v mask; p m v
    q8_bytes = (n * (4 + 4 + 1 + 2) + nb * 8         # p g mask codes, scales
                + n * (4 + 2) + nb * 8)              # p codes, scales
    f32_ops, q8_ops = 16 * n, 22 * n                 # flops per element
    for name, nbytes, nops, t, lib_ms in (
            ("masked_adam", f32_bytes, f32_ops, ms, ms["library"]),
            ("masked_adam_q8", q8_bytes, q8_ops, ms8, None)):
        tb, to = nbytes / HBM_BYTES_PER_S * 1e3, nops / F32_FLOPS * 1e3
        results[name].update(
            ms=t["kernel"], plain_ms=t["plain"], bound_ms=max(tb, to),
            bound_by="bytes" if tb >= to else "operations",
            library_ms=lib_ms)
        print(f"{name} time, one step over the {len(shapes)}-leaf selection "
              f"({n / 1e6:.1f} M elements, {nbytes / 1e9:.2f} GB moved): "
              f"kernel {t['kernel']:.3f} ms (again {t['kernel2']:.3f}), "
              f"bound {max(tb, to):.3f} ms, plain {t['plain']:.3f} ms"
              + (f", torch._fused_adam_ {lib_ms:.3f} ms (no mask: reads "
                 f"1 B/element less)" if lib_ms is not None else
                 ", no one-call library equivalent"))
    del p, gr, mask, mq, ms_, vq, vs
    torch.cuda.empty_cache()


def reference_small(torch, np, arch=ARCH, q8s=(False, True), **replace):
    """Small-input reference: 6 BlockLLM steps of ``arch`` reduced by 8
    (f32; ``replace``: further config fields) on the card (the kernels)
    and on the CPU (their plain versions), from the same weights and
    batches, with the moments of ``q8s``.  Adam eps 1e-3, as in
    tests/test_torch_blockllm.py (with 1e-8 the refresh-step mask is
    decided by rounding).  Losses within rtol 1e-4, the same selections."""
    from repro_torch import trainers
    from repro_torch.adapters import copy_tree
    from repro_torch.checkpoint.checkpointer import tree_map
    from repro_torch.configs.base import get_config, reduce_config
    from repro_torch.core.blockllm import BlockLLMConfig
    from repro_torch.core.selection import SelectorConfig
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.models import model as model_lib
    from repro_torch.optim.adam import Adam
    cfg = reduce_config(get_config(arch), 8).replace(dtype="float32",
                                                     **replace)
    params = model_lib.init_params(cfg, generator=torch.Generator(
        "cpu").manual_seed(4), device="cpu")
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                    global_batch=4, seed=4))
    sel = SelectorConfig(sparsity=0.9, static_k_frac=0.34, reselect_every=3)
    for q8 in q8s:
        runs = {}
        for dev, fused in (("cuda", "kernel"), ("cpu", "plain")):
            tr = trainers.handle(
                "blockllm", cfg, tree_map(lambda a: a.to(dev),
                                          copy_tree(params)),
                device=dev, adam=Adam(lr=1e-3, eps=1e-3), quantize_state=q8,
                bcfg=BlockLLMConfig(selector=sel, fused_update=fused))
            runs[dev] = ([tr.train_step(pipe.batch(s))["loss"]
                          for s in range(6)], tr.state.meta)
        lc, lp = runs["cuda"][0], runs["cpu"][0]
        rel = max(abs(a - b) / abs(b) for a, b in zip(lc, lp))
        same = all(runs["cuda"][1][k] == runs["cpu"][1][k] for k in
                   ("stack_idx", "probe_idx", "active_leaves"))
        ok = rel <= 1e-4 and same and np.isfinite(lc).all()
        print(f"small-input reference ({'Q8' if q8 else 'f32'} moments, "
              f"reduced {arch} ({cfg.num_layers} layers), 6 steps, 2 "
              f"reselections): card (kernels) "
              f"vs CPU (plain) losses max rel diff {rel:.2e} (rtol 1e-4), "
              f"same selections {same} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("training on the card disagrees with the "
                                 "CPU reference")


def train_main_path(torch, np, ops):
    """The slice's main path through the launcher a user calls."""
    from repro_torch.launch import train as tlaunch
    print(f"train main path: python -m repro_torch.launch.train "
          f"{' '.join(TRAIN_ARGV)}")
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    out = tlaunch.main(TRAIN_ARGV)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    losses, step_ms = out["losses"], out["step_ms"]
    rest = np.asarray(step_ms[1:])
    vocab = out["trainer"].cfg.vocab_size
    print(f"train main path: losses per step {[round(x, 4) for x in losses]}"
          f"; step ms: refresh step {step_ms[0]:.1f}, the other "
          f"{len(rest)} p50 {np.percentile(rest, 50):.1f} p99 "
          f"{np.percentile(rest, 99):.1f}; {wall:.1f} s wall including "
          f"init; launches {launches}; peak device memory "
          f"{peak / 2 ** 30:.2f} GiB")
    if not (np.isfinite(losses).all() and len(losses) == 8):
        raise AssertionError("train main path: non-finite or missing loss")
    if abs(losses[0] - np.log(vocab)) > 1.0:
        raise AssertionError(f"first loss {losses[0]:.3f} is not near "
                             f"ln(vocab) = {np.log(vocab):.3f}")
    if launches["masked_adam_q8"] == 0:
        raise AssertionError("masked_adam_q8 did not launch on the train "
                             "main path")
    # the Q8 state: a v code of 0 beside a non-zero m code makes Adam's
    # step m_hat / eps (the reference's Q8 divergence, ROADMAP C)
    from repro_torch.checkpoint.checkpointer import _flatten_with_names
    opt = out["trainer"].state.arrays["opt"]
    pairs = list(zip(_flatten_with_names(opt.mu_q)[1],
                     _flatten_with_names(opt.nu_q)[1]))
    flushed = sum(int(((vq == 0) & (mq != 0)).sum()) for mq, vq in pairs)
    total = sum(vq.numel() for _, vq in pairs)
    print(f"train main path: Q8 state after the run: {flushed} of {total} "
          f"moment elements ({flushed / total:.1%}) have v code 0 beside a "
          f"non-zero m code")
    report = out["trainer"].memory_report()
    del out, opt, pairs
    torch.cuda.empty_cache()
    return launches, peak, report, float(np.percentile(rest, 50))


def profile_train(torch, core, state, pipe, first, arch=ARCH,
                  label="batch 8 x 256"):
    """2 steady BlockLLM steps under torch.profiler: wall vs device busy,
    the masked-Adam kernels' (and RG-LRU scan kernel's) share, the top
    kernels."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    n = 2
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.monotonic()
        for s in range(first, first + n):
            state, _ = core.step(state, pipe.batch(s))
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3 / n
    times = kernel_times(torch, prof)
    busy = sum(us for _, us in times.values()) / 1e3 / n
    adam = sum(us for key, (_, us) in times.items()
               if "masked_adam" in key) / 1e3 / n
    print(f"train step profile ({arch}, blockllm f32 moments, fused "
          f"kernel, {label}, {n} steady steps): wall {wall_ms:.1f} "
          f"ms/step, device busy {busy:.1f} ms/step, idle share "
          f"{max(0.0, 1 - busy / wall_ms):.1%}, masked_adam "
          f"{adam:.3f} ms/step ({adam / max(busy, 1e-9):.1%} of busy)")
    groups = {"gemm": 0.0, "elementwise/copy": 0.0, "reduce/softmax": 0.0,
              "masked_adam": 0.0, "rglru scan": 0.0, "other": 0.0}
    for key, (_, us) in times.items():
        name = key.lower()
        t = us / 1e3 / n
        if "masked_adam" in name:
            groups["masked_adam"] += t
        elif "rglru_scan" in name:
            groups["rglru scan"] += t
        elif any(w in name for w in ("gemm", "cutlass", "sm90_", "nvjet",
                                     "matmul")):
            groups["gemm"] += t
        elif any(w in name for w in ("reduce", "softmax", "norm", "sort",
                                     "scan")):
            groups["reduce/softmax"] += t
        elif any(w in name for w in ("elementwise", "copy", "cast",
                                     "vectorized", "unrolled", "index",
                                     "gather", "scatter")):
            groups["elementwise/copy"] += t
        else:
            groups["other"] += t
    print("  device ms/step by kind: " + ", ".join(
        f"{k} {v:.2f}" for k, v in groups.items()))
    if groups["rglru scan"]:
        # the forward and backward kernels; the backward's elementwise
        # passes run inside its kernel
        print(f"  rglru scan kernels {groups['rglru scan']:.3f} ms/step "
              f"({groups['rglru scan'] / max(busy, 1e-9):.1%} of busy)")
    for key, (count, us) in sorted(times.items(),
                                   key=lambda kv: -kv[1][1])[:8]:
        print(f"  {us / 1e3 / n:8.3f} ms/step {count // n:5d} calls/step  "
              f"{key[:70]}")
    (OUT / f"train_profile_{arch}_{label.split(',')[0].replace(' ', '')}"
           f".txt").write_text(kernel_table(times, n))
    return state, dict(wall_ms=wall_ms, busy_ms=busy, **groups)


def train_api(torch, np, ops, q8_peak, q8_report, q8_p50):
    """blockllm (f32 moments, fused_update="kernel") then full adam, at
    the main path's width, depth and batch: the memory comparison.
    Returns the f32 run's launches and the three runs' peaks, memory
    reports and step p50s (phase 22's table)."""
    from repro_torch import trainers
    from repro_torch.configs.base import get_config
    from repro_torch.core.blockllm import BlockLLMConfig
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.optim.adam import Adam
    cfg = get_config(ARCH)
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=256,
                                    global_batch=8, seed=0))
    core = trainers.make("blockllm", cfg, adam=Adam(lr=1e-3),
                         bcfg=BlockLLMConfig(fused_update="kernel"),
                         device="cuda")
    state = core.init(torch.Generator("cuda").manual_seed(0))
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    for s in range(8):
        t0 = time.monotonic()
        state, m = core.step(state, pipe.batch(s))   # ends in a host read
        step_ms.append((time.monotonic() - t0) * 1e3)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    peak_f32 = torch.cuda.max_memory_allocated()
    rep_f32 = core.memory_report(state)
    print(f"blockllm f32 moments (fused_update='kernel'), 8 steps: losses "
          f"{[round(x, 4) for x in losses]}; step ms: refresh step "
          f"{step_ms[0]:.1f}, the other 7 p50 "
          f"{np.percentile(step_ms[1:], 50):.1f} p99 "
          f"{np.percentile(step_ms[1:], 99):.1f}; launches {launches}, peak "
          f"device memory {peak_f32 / 2 ** 30:.2f} GiB")
    if launches["masked_adam"] == 0 or not np.isfinite(losses).all():
        raise AssertionError("masked_adam did not launch (or the loss is "
                             "not finite) on the f32 path")
    state, _ = profile_train(torch, core, state, pipe, 8)
    del state, core
    torch.cuda.empty_cache()
    core = trainers.make("adam", cfg, adam=Adam(lr=1e-3), device="cuda")
    state = core.init(torch.Generator("cuda").manual_seed(0))
    torch.cuda.reset_peak_memory_stats()
    a_losses, a_ms = [], []
    for s in range(3):
        t0 = time.monotonic()
        state, m = core.step(state, pipe.batch(s))
        a_ms.append((time.monotonic() - t0) * 1e3)
        a_losses.append(m["loss"])
    torch.cuda.synchronize()
    peak_adam = torch.cuda.max_memory_allocated()
    rep_adam = core.memory_report(state)
    print(f"adam (dense), 3 steps: losses {[round(x, 4) for x in a_losses]}"
          f", step ms {[round(x, 1) for x in a_ms]}, peak device memory "
          f"{peak_adam / 2 ** 30:.2f} GiB")
    if not np.isfinite(a_losses).all():
        raise AssertionError("adam loss is not finite")
    del state, core
    torch.cuda.empty_cache()
    gib = lambda r: {k: round(v / 2 ** 30, 3) for k, v in r.items()}
    print(f"peak device memory ({ARCH}, batch 8 x 256): blockllm+q8 "
          f"{q8_peak / 2 ** 30:.2f} GiB, blockllm {peak_f32 / 2 ** 30:.2f} "
          f"GiB, adam {peak_adam / 2 ** 30:.2f} GiB")
    for name, rep in (("blockllm+q8", q8_report), ("blockllm", rep_f32),
                      ("adam", rep_adam)):
        print(f"  memory_report {name} (GiB): {gib(rep)}")
    peaks = {"blockllm+q8": q8_peak, "blockllm": peak_f32, "adam": peak_adam,
             "reports": {"blockllm+q8": q8_report, "blockllm": rep_f32,
                         "adam": rep_adam},
             "p50": {"blockllm+q8": q8_p50,
                     "blockllm": float(np.percentile(step_ms[1:], 50)),
                     "adam": float(np.percentile(a_ms[1:], 50))}}
    return launches, peaks


@contextmanager
def payload_io():
    """Files, bytes and seconds of the payloads (checkpoints, base
    snapshots, adapter deltas) written and read inside the block:
    ``{"written": [files, bytes, s], "read": [...]}``."""
    from repro_torch.checkpoint import checkpointer as ck
    rec = {"written": [0, 0, 0.0], "read": [0, 0, 0.0]}
    write, read = ck.write_payload, ck.read_payload

    def add(kind, leaves, t0):
        r = rec[kind]
        r[0] += 1
        r[1] += sum(leaf.nbytes for leaf in leaves)
        r[2] += time.monotonic() - t0

    def timed_write(final, named, **kw):
        t0 = time.monotonic()
        out = write(final, named, **kw)
        add("written", named.values(), t0)
        return out

    def timed_read(path):
        t0 = time.monotonic()
        out = read(path)
        add("read", out[0].values(), t0)
        return out

    ck.write_payload, ck.read_payload = timed_write, timed_read
    try:
        yield rec
    finally:
        ck.write_payload, ck.read_payload = write, read


def crash_resume(torch, ops, handle, batch_fn, lcfg):
    """The crash -> resume legs' runs: ``CRASH_STEPS`` steps of a fresh
    ``handle()`` uninterrupted, then the same steps under ``lcfg`` (its
    checkpoint and adapter directories) checkpointed at ``CRASH_CKPT`` and
    crashed after ``CRASH_AT``, then a fresh handle resumed from that
    checkpoint to ``CRASH_STEPS`` without writing another.  Fails unless
    the resumed state equals the uninterrupted one bitwise, host meta
    included, and the run reselected after its checkpoint.  Returns
    ``(resumed, its leaf names, its launches, seconds)``."""
    import dataclasses
    import shutil
    from repro_torch.checkpoint.checkpointer import _flatten_with_names, \
        read_meta
    from repro_torch.runtime import train_loop
    shutil.rmtree(SCRATCH, ignore_errors=True)
    t0 = time.monotonic()
    whole = handle()
    train_loop.run(whole, batch_fn, train_loop.TrainLoopConfig(
        total_steps=CRASH_STEPS, log_every=0))
    lcfg = dataclasses.replace(lcfg, total_steps=CRASH_STEPS,
                               ckpt_every=CRASH_CKPT, log_every=0)
    with payload_io() as io:
        crashed = handle()
        try:
            train_loop.run(crashed, batch_fn, lcfg, crash_at=CRASH_AT)
            raise AssertionError("the simulated crash did not happen")
        except RuntimeError as e:
            if "simulated node failure" not in str(e):
                raise
        del crashed
        ops.reset_launches()
        resumed = handle()
        train_loop.run(resumed, batch_fn,
                       dataclasses.replace(lcfg, ckpt_every=CRASH_STEPS + 1))
        torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    na, la, _ = _flatten_with_names(whole.state.arrays)
    nb, lb, _ = _flatten_with_names(resumed.state.arrays)
    same = (na == nb and resumed.state.meta == whole.state.meta and all(
        a.dtype == b.dtype and torch.equal(a.reshape(-1).view(torch.uint8),
                                           b.reshape(-1).view(torch.uint8))
        for a, b in zip(la, lb)))
    at_ckpt = read_meta(lcfg.ckpt_dir, CRASH_CKPT)["host"]["reselections"]
    total = whole.state.meta["reselections"]
    print(f"  crash -> resume: ckpt at {CRASH_CKPT}, crash at {CRASH_AT}, "
          f"resumed to {CRASH_STEPS}; {at_ckpt} selections at the "
          f"checkpoint, {total} at the end; resumed == uninterrupted "
          f"bitwise over {len(la)} leaves and the host meta: {same}; "
          f"payload files (checkpoint, base snapshot, deltas) "
          + ", ".join(f"{n} {kind} ({b / 2 ** 30:.2f} GiB, {sec:.1f} s)"
                      for kind, (n, b, sec) in io.items()))
    if not same:
        raise AssertionError("the resumed run differs from the "
                             "uninterrupted run")
    if total <= at_ckpt:
        raise AssertionError("the run did not reselect after its checkpoint")
    return resumed, na, launches, time.monotonic() - t0


def checkpoint_export_serve(torch, np, ops, arch=ARCH, layers=4, slots=4):
    """Checkpoint -> crash -> resume -> export -> serve, full width, depth
    cut to ``layers`` (full depth writes about 12 GB of npz per
    checkpoint), through ``crash_resume``.  blockllm+q8 (the fused Q8
    kernel), patience 2 so it reselects, the leaf units always active
    (restore takes the fresh state's structure).  The tenant is served over ``slots`` slots.  A
    model with recurrent blocks is primed token by token: there the
    decode-attention launches must equal (local layers) x (decode passes,
    priming included), and the last request, in a reused slot, must give
    the stream a fresh server gives it.  The swap kernel must launch
    exactly when the delta has row entries (a leaf whose every row
    trained is exported, and swapped in, whole).  A model without
    attention (xLSTM) must launch no decode attention."""
    import shutil
    from repro_torch import trainers
    from repro_torch.adapters import AdapterRegistry, copy_tree
    from repro_torch.configs.base import get_config
    from repro_torch.core.blockllm import BlockLLMConfig
    from repro_torch.core.selection import SelectorConfig
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.models import model as model_lib
    from repro_torch.optim.adam import Adam
    from repro_torch.runtime import train_loop
    from repro_torch.runtime.serve_config import ServeConfig
    from repro_torch.runtime.serve_loop import DecodeServer, Request
    cfg = get_config(arch).replace(num_layers=layers)
    params0 = model_lib.init_params(cfg, generator=torch.Generator(
        "cuda").manual_seed(7), device="cuda")
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=256,
                                    global_batch=8, seed=7))
    bcfg = BlockLLMConfig(selector=SelectorConfig(
        patience=2, always_active_leaves=("final_norm", "embed", "head")),
        fused_update="kernel")

    def handle():
        core = trainers.make("blockllm+q8", cfg, adam=Adam(lr=1e-3),
                             bcfg=bcfg, device="cuda")
        return trainers.TrainerHandle(core, core.init(None,
                                                      copy_tree(params0)))

    resumed, _, _, secs = crash_resume(
        torch, ops, handle, pipe.batch, train_loop.TrainLoopConfig(
            ckpt_dir=str(SCRATCH / "ckpt"),
            adapter_dir=str(SCRATCH / "adapters"), adapter_id="tuned"))
    print(f"crash-resume ({arch} width, {layers} layers, blockllm+q8, "
          f"stages {cfg.stages()}): resumed == uninterrupted ({secs:.1f} s "
          f"with checkpoint I/O)")
    registry = AdapterRegistry(SCRATCH / "adapters")
    delta = registry.get("tuned")
    print(f"exported tenant 'tuned': {delta.num_rows()} rows, "
          f"{delta.nbytes / 2 ** 20:.1f} MiB, step {delta.meta['step']}")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(16, 48)))
               for _ in range(4)]
    scfg = ServeConfig(batch_slots=slots, max_seq=128, attn_impl="kernel")

    def serve(params, reg, tenant, prompts):
        srv = DecodeServer(cfg, params, scfg, registry=reg)
        reqs = [Request(rid=i, prompt=p, max_new_tokens=16,
                        adapter_id=tenant) for i, p in enumerate(prompts)]
        for r in reqs:
            srv.submit(r)
        srv.run_until_drained()
        torch.cuda.synchronize()
        out = [r.out for r in reqs]
        passes = srv.steps + srv.prefill_dispatches
        del srv
        return out, passes

    ops.reset_launches()
    got, passes = serve(params0, registry, "tuned", prompts)
    launches = dict(ops.LAUNCHES)
    want, _ = serve(resumed.merged_params(), None, None, prompts)
    ok = got == want and all(len(o) == 16 for o in got)
    n_attn = sum(t in ("global", "local") for t in cfg.layer_types())
    # a leaf whose every row trained is exported (and swapped in) whole;
    # the others as row entries, through the swap kernel
    row_entries = sum(e.idx is not None for e in delta.entries.values())
    print(f"serve the exported tenant ({len(prompts)} requests over {slots} "
          f"slots, kernel attention; the delta holds {row_entries} row "
          f"entries of {len(delta.entries)}): launches {launches}; tokens "
          f"equal a server with the trained rows written in: {ok}")
    if not ok or bool(launches["decode_attention"]) != bool(n_attn) \
            or bool(launches["scatter_swap"]) != bool(row_entries):
        raise AssertionError("the served tenant disagrees, or a serving "
                             "kernel did not launch")
    if not model_lib.supports_slot_prefill(cfg):
        fresh, _ = serve(params0, registry, "tuned", prompts[-1:])
        print(f"  per-token priming: {passes} decode passes (priming "
              f"included) x {n_attn} attention layers = "
              f"{passes * n_attn} decode_attention launches, counted "
              f"{launches['decode_attention']}; the last request (a reused "
              f"slot) equals a fresh server's stream: {fresh[0] == got[-1]}")
        if launches["decode_attention"] != passes * n_attn:
            raise AssertionError("decode_attention launches are not one "
                                 "per local layer per decode pass")
        if fresh[0] != got[-1]:
            raise AssertionError("a request in a reused slot differs from "
                                 "a fresh server's")
    del resumed, params0, delta, registry
    shutil.rmtree(SCRATCH, ignore_errors=True)
    torch.cuda.empty_cache()



# --------------------------------------------------------------------- #
# phases 14-17: the hybrid RG-LRU family (slice 4)
# --------------------------------------------------------------------- #


def scan_inputs(torch, B, S, W, seed):
    g = torch.Generator("cuda").manual_seed(seed)
    a = torch.rand(B, S, W, generator=g, device="cuda") * 0.199 + 0.8
    b = torch.randn(B, S, W, generator=g, device="cuda") * 0.1
    h0 = torch.randn(B, W, generator=g, device="cuda") * 0.1
    return a, b, h0


def same_bits(torch, x, y) -> bool:
    return torch.equal(x.contiguous().view(torch.int32),
                       y.contiguous().view(torch.int32))


def check_rglru_scan(torch, rs, ops, results):
    """The forward scan kernel and the backward kernel (the reversed scan
    with the VJP's passes taken in) against their plain versions, bitwise
    (y, h_last; da, db, dh0; with and without h0), the backward through
    ``ops.rglru_scan`` (da, db, dh0 bitwise), and the times at the main
    path's shape of the forward and of the backward as a whole (the one
    kernel the op's backward runs) beside their bounds and the plain
    versions."""
    for B, S, W in RG_SCAN_SHAPES:
        for with_h0 in (True, False):
            a, b, h0 = scan_inputs(torch, B, S, W, 0)
            h0 = h0 if with_h0 else None
            dh_last = torch.randn(B, W, device="cuda")
            ky, kh = rs.rglru_scan_cuda(a, b, h0)
            py, ph = rs.rglru_scan_plain(a, b, h0)
            kg = rs.rglru_scan_bwd_cuda(a, py, h0, b, dh_last,
                                        need_dh0=with_h0)
            pg = rs.rglru_scan_bwd_plain(a, py, h0, b, dh_last,
                                         need_dh0=with_h0)
            torch.cuda.synchronize()
            ok = (same_bits(torch, ky, py) and same_bits(torch, kh, ph)
                  and bool(torch.isfinite(ky).all()))
            bwd_ok = ((kg[2] is None) == (pg[2] is None) == (not with_h0)
                      and all(same_bits(torch, k, p)
                              for k, p in zip(kg, pg) if p is not None)
                      and bool(torch.isfinite(kg[0]).all()))
            print(f"rglru_scan [{B}, {S}, {W}] h0 "
                  f"{'given' if with_h0 else 'none'}: y and h_last bitwise "
                  f"vs plain {'ok' if ok else 'FAIL'}; backward kernel da, "
                  f"db{', dh0' if with_h0 else ''} bitwise vs plain "
                  f"{'ok' if bwd_ok else 'FAIL'}")
            if not (ok and bwd_ok):
                raise AssertionError("rglru_scan disagrees with its "
                                     "plain version")
        ins = scan_inputs(torch, B, S, W, 1)
        outs = {}
        for mode in ("kernel", "plain"):
            ts = [t.clone().requires_grad_() for t in ins]
            y, h = ops.rglru_scan(*ts, mode=mode)
            grads = torch.autograd.grad((y ** 2).sum() + (h ** 2).sum(), ts)
            outs[mode] = [t.detach() for t in (y, h) + grads]
        torch.cuda.synchronize()
        ok = all(same_bits(torch, k, p) for k, p in zip(outs["kernel"],
                                                        outs["plain"]))
        print(f"rglru_scan backward [{B}, {S}, {W}] through ops.rglru_scan "
              f"(kernel vs plain): y, h_last, da, db, dh0 bitwise "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("rglru_scan's backward disagrees with its "
                                 "plain version")
    # times at the main path's shape; two input copies (126 MB) > L2
    B, S, W = RG_SCAN_SHAPES[0]
    ins = [scan_inputs(torch, B, S, W, 2 + i) for i in range(2)]
    ys = [rs.rglru_scan_cuda(*x)[0] for x in ins]
    dh_last = torch.randn(B, W, device="cuda")

    def bwd(fn, i):
        a, dy, h0 = ins[i % 2]
        return fn(a, ys[i % 2], h0, dy, dh_last)
    ms = median_time_ms(lambda i: rs.rglru_scan_cuda(*ins[i % 2]))
    bwd_ms = median_time_ms(lambda i: bwd(rs.rglru_scan_bwd_cuda, i))
    plain_ms = cuda_time_ms(lambda i: rs.rglru_scan_plain(*ins[i % 2]), 5)
    bwd_plain_ms = cuda_time_ms(lambda i: bwd(rs.rglru_scan_bwd_plain, i), 5)
    bounds = {}
    for name, nbytes, nops in (
            ("rglru_scan", rs.scan_bytes(B, S, W), 2 * B * S * W),
            ("rglru_scan_bwd", rs.scan_bwd_bytes(B, S, W), 3 * B * S * W)):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = nops / F32_FLOPS * 1e3
        bounds[name] = (max(t_bytes, t_ops),
                        "bytes" if t_bytes >= t_ops else "operations",
                        nbytes)
    for name, t, plain in (("rglru_scan", ms, plain_ms),
                           ("rglru_scan_bwd", bwd_ms, bwd_plain_ms)):
        bound, by, _ = bounds[name]
        results[name] = dict(max_abs_err=0.0, ms=t, plain_ms=plain,
                             bound_ms=bound, bound_by=by, library_ms=None)
    print(f"rglru_scan time [{B}, {S}, {W}] f32 (chunk {rs.SCAN_CHUNK}): "
          f"forward {ms:.4f} ms vs bound {bounds['rglru_scan'][0]:.4f} ms "
          f"({bounds['rglru_scan'][2] / 1e6:.1f} MB, "
          f"{bounds['rglru_scan'][0] / ms:.0%} of it), plain "
          f"{plain_ms:.3f} ms; backward as a whole (one kernel) "
          f"{bwd_ms:.4f} ms vs bound {bounds['rglru_scan_bwd'][0]:.4f} ms "
          f"({bounds['rglru_scan_bwd'][2] / 1e6:.1f} MB, "
          f"{bounds['rglru_scan_bwd'][0] / bwd_ms:.0%} of it), plain "
          f"{bwd_plain_ms:.3f} ms; no one PyTorch call computes a linear "
          f"recurrence")
    del ins, ys
    torch.cuda.empty_cache()


def check_decode_attention_g10(torch, da, results):
    """The decode kernel at recurrentgemma-2b's local layers: MQA, 10
    query heads, head_dim 256, a ring over the 2048-token window (slots
    before and after the wrap), bf16 and f32 q, phase 2's tolerances; the
    same with softcap 30, and with a non-ring window of 700 < C; then its
    time with every slot past the wrap."""
    from repro_torch.models.layers import decode_valid
    g = torch.Generator("cuda").manual_seed(14)
    B, C, KV, G, hd = 8, 2048, 1, 10, 256
    ring_pos = [0, 100, 2047, 2048, 2500, 3000, 4095, 9000]
    cases = [  # name, kwargs, pos
        ("ring 2048", dict(window=C, ring=True), ring_pos),
        ("ring 2048 softcap 30", dict(window=C, ring=True, softcap=30.0),
         ring_pos),
        ("window 700", dict(window=700),
         [0, 100, 699, 700, 1000, 1500, 2000, 2047])]
    k = torch.randn(B, C, KV, hd, generator=g, device="cuda").bfloat16()
    v = torch.randn(B, C, KV, hd, generator=g, device="cuda").bfloat16()
    worst = 0.0
    for name, kw, pos in cases:
        pos = torch.tensor(pos, dtype=torch.int32, device="cuda")
        for qd in (torch.bfloat16, torch.float32):
            q = torch.randn(B, 1, KV * G, hd, generator=g,
                            device="cuda").to(qd)
            o = da.decode_attention_cuda(q, k, v, pos, **kw)
            r = da.decode_attention_plain(q, k, v, pos, **kw)
            torch.cuda.synchronize()
            err = (o.float() - r.float()).abs()
            if qd == torch.float32:
                tol = ATTN_F32_ATOL + ATTN_F32_RTOL * r.float().abs()
                tol_s = f"rtol {ATTN_F32_RTOL} atol {ATTN_F32_ATOL}"
            else:
                tol = torch.full_like(err, ATTN_BF16_ATOL)
                tol_s = f"atol {ATTN_BF16_ATOL}"
                worst = max(worst, err.max().item())
            ok = bool((err <= tol).all()) and bool(torch.isfinite(o).all())
            print(f"decode_attention [G10 hd256 {name}] B{B} KV{KV} q "
                  f"{str(qd)[6:]} cache bfloat16, pos {pos.tolist()}: "
                  f"max|kernel-plain| {err.max().item():.3g} ({tol_s}) "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError("decode_attention at G = 10 disagrees "
                                     "with its plain version")
    kw = dict(window=C, ring=True)
    copies = 8
    q = torch.randn(B, 1, KV * G, hd, generator=g, device="cuda").bfloat16()
    ks = [torch.randn(B, C, KV, hd, generator=g, device="cuda").bfloat16()
          for _ in range(copies)]
    vs = [torch.randn(B, C, KV, hd, generator=g, device="cuda").bfloat16()
          for _ in range(copies)]
    pos = torch.tensor([2100, 2500, 3000, 3500, 4000, 5000, 6000, 9000],
                       dtype=torch.int32, device="cuda")
    mask = decode_valid(pos, C, window=C, ring=True)[:, None, None, :]
    qt = q.transpose(1, 2)
    fns = {
        "kernel": lambda i: da.decode_attention_cuda(
            q, ks[i % copies], vs[i % copies], pos, **kw),
        "plain": lambda i: da.decode_attention_plain(
            q, ks[i % copies], vs[i % copies], pos, **kw),
        "sdpa": lambda i: torch.nn.functional.scaled_dot_product_attention(
            qt, ks[i % copies].transpose(1, 2),
            vs[i % copies].transpose(1, 2), attn_mask=mask,
            enable_gqa=True)}
    dev_ms = {k: graph_time_ms(f) for k, f in fns.items()}
    rows = B * C                                 # every slot past the wrap
    nbytes = 2 * q.nbytes + rows * KV * hd * 2 * 2
    flops = rows * KV * G * hd * 4               # QK and PV
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    results["decode_attention"].update(
        g10_max_abs_err=worst, g10_ms=dev_ms["kernel"],
        g10_plain_ms=dev_ms["plain"], g10_bound_ms=max(t_bytes, t_ops),
        g10_bound_by="bytes" if t_bytes >= t_ops else "operations",
        g10_library_ms=dev_ms["sdpa"])
    print(f"decode_attention time [G10 hd256 ring 2048] B{B} bf16, every "
          f"slot past the wrap: device (graph replay) kernel "
          f"{dev_ms['kernel']:.4f} ms, plain {dev_ms['plain']:.4f} ms, sdpa "
          f"{dev_ms['sdpa']:.4f} ms; bound {max(t_bytes, t_ops):.4f} ms "
          f"({'bytes' if t_bytes >= t_ops else 'operations'}: "
          f"{nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP); "
          f"{dev_ms['kernel'] / dev_ms['sdpa']:.2f}x sdpa, "
          f"{dev_ms['kernel'] / max(t_bytes, t_ops):.1f}x the bound, "
          f"{nbytes / dev_ms['kernel'] / 1e6:.0f} GB/s")
    # where the time goes: the tensor-core kernel and its merge (10
    # single-head groups) over the bf16 cache, against the CUDA-core body
    # and its grouped merge over an f32 cache of the same rows
    from torch.profiler import ProfilerActivity, profile
    for name, kc, vc in (("bf16 cache", ks[0], vs[0]),
                         ("f32 cache", ks[0].float(), vs[0].float())):
        for _ in range(3):
            da.decode_attention_cuda(q, kc, vc, pos, **kw)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                da.decode_attention_cuda(q, kc, vc, pos, **kw)
            torch.cuda.synchronize()
        split = ", ".join(
            f"{key.split('(')[0].split('::')[-1]} {us / count:.2f} us"
            for key, (count, us) in kernel_times(torch, prof).items()
            if us > 0)
        print(f"decode_attention profile [G10 hd256 ring 2048] {name}, per "
              f"call: {split}")
    del ks, vs
    torch.cuda.empty_cache()


def layer_of(cfg):
    """Stack id "s{si}/pos{j}" and row g -> layer index, and the layer
    indices of the recurrent blocks."""
    offsets, off = [], 0
    for pattern, groups in cfg.stages():
        offsets.append(off)
        off += len(pattern) * groups

    def index(sid, g):
        si, j = sid.split("/")
        pattern = cfg.stages()[int(si[1:])][0]
        return offsets[int(si[1:])] + g * len(pattern) + int(j[3:])
    recurrent = [i for i, t in enumerate(cfg.layer_types())
                 if t == "recurrent"]
    return index, recurrent


def rg_train_main_path(torch, np, ops):
    """The slice's main path: the training launcher on recurrentgemma-2b
    at full width and depth, f32 moments.  The scan launches are worked
    out from each step's selection, recorded as the loop calls
    ``TrainerHandle.train_step``: every step runs the 18 recurrent
    blocks' forward scans, and with remat each block the gradient passes
    through (every block from the lowest selected or probe row up, all of
    them when the tied embedding trains) recomputes its forward and runs
    one backward scan."""
    from repro_torch.checkpoint.checkpointer import _flatten_with_names
    from repro_torch.launch import train as tlaunch
    from repro_torch.trainers import api
    print(f"train main path (slice 4): python -m repro_torch.launch.train "
          f"{' '.join(RG_TRAIN_ARGV)}")
    seen, peaks = [], []
    step = api.TrainerHandle.train_step

    def spy(self, batch):
        # the peak since the last mark: init before step 0, else the step
        peaks.append(torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()
        m = self.state.meta
        seen.append({"stack_idx": m["stack_idx"],
                     "probe_idx": m["probe_idx"],
                     "active_leaves": list(m["active_leaves"]),
                     "refresh": bool(m["needs_mask_refresh"]),
                     "leaves": len(_flatten_with_names(
                         self.state.arrays["sel"])[1])})
        return step(self, batch)

    api.TrainerHandle.train_step = spy
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    try:
        out = tlaunch.main(RG_TRAIN_ARGV)
    finally:
        api.TrainerHandle.train_step = step
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = dict(ops.LAUNCHES)
    peaks.append(torch.cuda.max_memory_allocated())
    peak = max(peaks)
    losses, step_ms = out["losses"], out["step_ms"]
    rest = np.asarray(step_ms[1:])
    cfg = out["trainer"].cfg
    index, recurrent = layer_of(cfg)
    want_fwd = want_bwd = want_adam = 0
    for s in seen:
        if "embed" in s["active_leaves"]:
            lowest = 0
        else:
            rows = [index(sid, g) for d in (s["stack_idx"], s["probe_idx"])
                    for sid, gs in d.items() for g in gs]
            lowest = min(rows) if rows else cfg.num_layers
        n_bwd = sum(i >= lowest for i in recurrent)
        want_fwd += len(recurrent) + (n_bwd if cfg.remat else 0)
        want_bwd += n_bwd
        want_adam += 0 if s["refresh"] else s["leaves"]
    print(f"train main path: losses per step {[round(x, 4) for x in losses]}"
          f" (first - ln V {losses[0] - np.log(cfg.vocab_size):+.3f}, "
          f"largest rise over the first {max(losses) - losses[0]:+.4f}); "
          f"step ms: refresh step {step_ms[0]:.1f}, the other {len(rest)} "
          f"p50 {np.percentile(rest, 50):.1f} p99 "
          f"{np.percentile(rest, 99):.1f}; {wall:.1f} s wall including "
          f"init; peak device memory {peak / 2 ** 30:.2f} GiB (init "
          f"{peaks[0] / 2 ** 30:.2f}, per step "
          f"{[round(x / 2 ** 30, 2) for x in peaks[1:]]})")
    print(f"train main path: launches {launches}; from the selections "
          f"({len(recurrent)} recurrent blocks, remat {cfg.remat}, embed "
          f"trained at {sum('embed' in s['active_leaves'] for s in seen)} "
          f"of {len(seen)} steps, {len(seen[0]['stack_idx'])} stacks): "
          f"rglru_scan {want_fwd}, rglru_scan_bwd {want_bwd}, masked_adam "
          f"{want_adam}")
    if not (np.isfinite(losses).all() and len(losses) == 8):
        raise AssertionError("train main path: non-finite or missing loss")
    if abs(losses[0] - np.log(cfg.vocab_size)) > 1.0:
        raise AssertionError(f"first loss {losses[0]:.3f} is not near "
                             f"ln(vocab) = {np.log(cfg.vocab_size):.3f}")
    if max(losses) > losses[0] + 0.5:
        raise AssertionError("the loss rose more than 0.5 above the first")
    if launches["rglru_scan"] != want_fwd:
        raise AssertionError("rglru_scan launches differ from the count "
                             "the selections give")
    if not 0 < launches["rglru_scan_bwd"] <= len(recurrent) * len(seen) \
            or launches["rglru_scan_bwd"] != want_bwd:
        raise AssertionError("rglru_scan_bwd launches out of range")
    if launches["masked_adam"] != want_adam or want_adam == 0:
        raise AssertionError("masked_adam did not launch once per selected "
                             "leaf per (non-refresh) step")
    report = out["trainer"].memory_report()
    trainer = out["trainer"]
    del out
    return trainer, launches, peak, report


def rg_train(torch, np, ops):
    """Phase 16: the main path, 2 more steps of its trainer under the
    profiler, full Adam's peak at one step, and the small-input
    reference on the card against the CPU."""
    from repro_torch import trainers
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.optim.adam import Adam
    trainer, launches, peak, report = rg_train_main_path(torch, np, ops)
    cfg = trainer.cfg
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=256,
                                    global_batch=8, seed=0))
    state, prof = profile_train(torch, trainer.core, trainer.state, pipe,
                                8, arch=RG_ARCH)
    del trainer, state
    torch.cuda.empty_cache()
    core = trainers.make("adam", cfg, adam=Adam(lr=1e-3), device="cuda")
    state = core.init(torch.Generator("cuda").manual_seed(0))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    state, m = core.step(state, pipe.batch(0))
    adam_ms = (time.monotonic() - t0) * 1e3
    torch.cuda.synchronize()
    peak_adam = torch.cuda.max_memory_allocated()
    rep_adam = core.memory_report(state)
    del state, core
    torch.cuda.empty_cache()
    gib = lambda r: {k: round(v / 2 ** 30, 3) for k, v in r.items()}
    print(f"peak device memory ({RG_ARCH}, batch 8 x 256): blockllm "
          f"{peak / 2 ** 30:.2f} GiB, adam {peak_adam / 2 ** 30:.2f} GiB "
          f"(one step, loss {m['loss']:.4f}, {adam_ms:.1f} ms incl. the "
          f"first use)")
    for name, rep in (("blockllm", report), ("adam", rep_adam)):
        print(f"  memory_report {name} (GiB): {gib(rep)}")
    if not np.isfinite(m["loss"]) or peak >= peak_adam:
        raise AssertionError("adam's loss is not finite, or BlockLLM's peak "
                             "is not below Adam's")
    reference_small(torch, np, arch=RG_ARCH, q8s=(False,), num_layers=5)
    torch.cuda.empty_cache()
    return launches, prof


# --------------------------------------------------------------------- #
# phases 18-20: the flash-attention op and long-context training (slice 5)
# --------------------------------------------------------------------- #


def bf16_ulp(torch, x):
    """The spacing of bf16 values at |x| (8 significant bits), in f64."""
    e = torch.floor(torch.log2(x.double().abs().clamp(min=2.0 ** -133)))
    return torch.exp2(e - 7)


def flash_inputs(torch, B, Sq, Sk, H, KV, hd, dtype, seed):
    g = torch.Generator("cuda").manual_seed(seed)
    return [torch.randn(B, S, n, hd, generator=g, device="cuda").to(dtype)
            for S, n in ((Sq, H), (Sk, KV), (Sk, KV))]


def flash_parity(torch, fa, q, k, v, causal, window):
    """Kernel vs plain: (max |diff|, ok).  f32 within FLASH_F32_ATOL; bf16
    within one bf16 ulp of the plain output plus FLASH_F32_ATOL (each rounds
    its own f32 result once)."""
    o = fa.flash_attention_cuda(q, k, v, causal=causal, window=window)
    r = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    err = (o.double() - r.double()).abs()
    tol = FLASH_F32_ATOL + (bf16_ulp(torch, r) if q.dtype == torch.bfloat16
                            else 0.0)
    ok = bool((err <= tol).all()) and bool(torch.isfinite(o).all())
    return err.max().item(), ok


def check_flash_attention(torch, fa, results):
    """Phase 18: the flash kernel against its plain version over the
    sweep, then at the two main shapes (bf16) with its time beside the
    bound, the plain version and SDPA."""
    worst = 0.0
    for B, Sq, Sk, H, KV, hd, causal, window in FLASH_SWEEP:
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = flash_inputs(torch, B, Sq, Sk, H, KV, hd, dt, Sq + hd)
            err, ok = flash_parity(torch, fa, q, k, v, causal, window)
            worst = max(worst, err)
            print(f"flash_attention [B{B} Sq{Sq} Sk{Sk} H{H} KV{KV} hd{hd} "
                  f"{'causal' if causal else 'full'} window {window}] "
                  f"{str(dt)[6:]}: max|kernel-plain| {err:.3g} "
                  f"({'atol' if dt == torch.float32 else '1 bf16 ulp +'} "
                  f"{FLASH_F32_ATOL}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError("flash_attention disagrees with its "
                                     "plain version")
    out = {}
    for tag, (B, S, H, KV, hd, window) in FLASH_MAIN.items():
        copies = [flash_inputs(torch, B, S, S, H, KV, hd, torch.bfloat16,
                               100 + i) for i in range(2)]
        err, ok = flash_parity(torch, fa, *copies[0], True, window)
        worst = max(worst, err)
        print(f"flash_attention [{tag}: B{B} S{S} H{H} KV{KV} hd{hd} causal "
              f"window {window}] bfloat16: max|kernel-plain| {err:.3g} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash_attention disagrees with its plain "
                                 f"version at the {tag} shape")
        if window:
            i = torch.arange(S, device="cuda")
            mask = (i[:, None] >= i[None]) & (i[:, None] - i[None] < window)
            sdpa_kw = dict(attn_mask=mask)
        else:
            sdpa_kw = dict(is_causal=True)
        tr = [[t.transpose(1, 2) for t in c] for c in copies]
        ms = cuda_time_ms(lambda j: fa.flash_attention_cuda(
            *copies[j % 2], causal=True, window=window), 10)
        plain_ms = cuda_time_ms(lambda j: fa.flash_attention_plain(
            *copies[j % 2], causal=True, window=window), 3)
        lib_ms = cuda_time_ms(
            lambda j: torch.nn.functional.scaled_dot_product_attention(
                *tr[j % 2], enable_gqa=True, **sdpa_kw), 10)
        nbytes = fa.flash_bytes(*copies[0])
        flops = fa.flash_flops(B, S, S, H, hd, causal=True, window=window)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / BF16_FLOPS * 1e3
        # the bf16 kernel issues Q.K^T once and P.V three times (p in
        # three bf16 pieces): 4 units of tensor work where the function's
        # operations count 2
        tflops = flops / ms * 1e-9
        out[tag] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                        bound_ms=max(t_bytes, t_ops),
                        bound_by="bytes" if t_bytes >= t_ops else
                        "operations", tflops=tflops, issued_tflops=2 * tflops)
        print(f"flash_attention time [{tag}] bf16: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.3f} ms, sdpa {lib_ms:.4f} ms "
              f"({'boolean mask' if window else 'is_causal'}); bound "
              f"{max(t_bytes, t_ops):.4f} ms ({out[tag]['bound_by']}: "
              f"{flops / 1e9:.1f} GFLOP at 989 TFLOP/s, {nbytes / 1e6:.1f} "
              f"MB at 3.35 TB/s); {tflops:.1f} TFLOP/s of the function's "
              f"operations, {2 * tflops:.1f} TFLOP/s of tensor work issued "
              f"(4 units per pair and head dim); {ms / lib_ms:.2f}x sdpa, "
              f"{ms / max(t_bytes, t_ops):.1f}x the bound")
        del copies, tr
        torch.cuda.empty_cache()
    main, rg = out["internlm2-1.8b"], out["recurrentgemma-2b local"]
    results["flash_attention"] = dict(
        max_abs_err=worst, **main,
        **{f"rg_{k}": v for k, v in rg.items()})


def bits(torch, t):
    return t.contiguous().view(torch.int16 if t.element_size() == 2
                               else torch.int32)


def flash_op(torch, fa, ops):
    """Phase 19: the op through autograd at the internlm2-1.8b shape under
    the kernel profiler; its gradients bitwise mode="plain"'s; a small f32
    case against autograd through the plain attention.  Returns the
    launch counts of the profiled run."""
    from repro_torch.obs import MetricsRegistry, Tracer
    B, S, H, KV, hd, _ = FLASH_MAIN["internlm2-1.8b"]
    q, k, v = flash_inputs(torch, B, S, S, H, KV, hd, torch.bfloat16, 19)
    w = torch.randn(B, S, H, hd, generator=torch.Generator(
        "cuda").manual_seed(20), device="cuda").bfloat16()   # d(loss)/do
    n = 3
    tracer, metrics = Tracer(), MetricsRegistry()
    ops.reset_launches()
    prof = ops.enable_kernel_profiling(tracer=tracer, metrics=metrics)
    bwd_ms = []
    try:
        for _ in range(n):
            ins = [t.clone().requires_grad_() for t in (q, k, v)]
            o = ops.flash_attention(*ins, True, 0)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            grads = torch.autograd.grad(o, ins, w)
            end.record()
            end.synchronize()
            bwd_ms.append(start.elapsed_time(end))
    finally:
        ops.disable_kernel_profiling()
    launches = dict(ops.LAUNCHES)
    recs = prof.records
    spans = tracer.spans("flash_attention")
    calls = metrics.counter("kernels/flash_attention_calls").value
    rec_ok = (len(recs) == n and len(spans) == n and calls == n
              and all(r["op"] == "flash_attention" and r["bytes"] ==
                      2 * q.nbytes + k.nbytes + v.nbytes for r in recs)
              and all(sp.lane == "kernels" for sp in spans))
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    o_p = ops.flash_attention(*ins, True, 0, mode="plain")
    plain = torch.autograd.grad(o_p, ins, w)
    torch.cuda.synchronize()
    same = all(torch.equal(bits(torch, a), bits(torch, b))
               for a, b in zip(grads, plain))
    print(f"flash_attention op [B{B} S{S} H{H} KV{KV} hd{hd} bf16 causal] "
          f"x{n} under the kernel profiler: forward "
          f"{[round(r['ms'], 3) for r in recs]} ms, backward (chunked "
          f"recompute) {[round(x, 2) for x in bwd_ms]} ms; records {len(recs)}"
          f", spans {len(spans)}, kernels/flash_attention_calls {calls}, "
          f"bytes {recs[0]['bytes'] if recs else None} "
          f"{'ok' if rec_ok else 'FAIL'}; launches {launches}; dq, dk, dv "
          f"bitwise mode='plain' {'ok' if same else 'FAIL'}")
    if not rec_ok:
        raise AssertionError("the kernel profiler's flash_attention record "
                             "or counter is wrong")
    if launches["flash_attention"] != n:
        raise AssertionError("flash_attention launches differ from the "
                             "number of forward calls")
    if not same:
        raise AssertionError("the op's gradients differ from mode='plain'")
    q, k, v = flash_inputs(torch, 1, 128, 128, 4, 2, 32, torch.float32, 21)
    gk = torch.autograd.grad((ops.flash_attention(
        *[t.requires_grad_() for t in (q, k, v)]) ** 2).sum(), (q, k, v))
    ins = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    gr = torch.autograd.grad((fa.flash_attention_plain(*ins) ** 2).sum(), ins)
    err = max((a - b).abs().max().item() for a, b in zip(gk, gr))
    print(f"flash_attention op gradients [1, 128, 4 / 2, 32] f32 vs autograd "
          f"through the plain attention: max|diff| {err:.3g} (atol 1e-4) "
          f"{'ok' if err <= 1e-4 else 'FAIL'}")
    if not err <= 1e-4:
        raise AssertionError("the op's gradients disagree with the plain "
                             "attention's")
    return launches, dict(fwd_ms=[r["ms"] for r in recs], bwd_ms=bwd_ms)


def long_context_attention_ms(torch, cfg, B, S):
    """Device ms (``torch.profiler``'s kernel time, as the step's busy
    time) of one attention block's chunked attention as a remat training
    step runs it: the forward, then under the block's recompute the
    forward again and, per q-chunk, its recompute and backward."""
    from repro_torch.models import layers
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q, k, v = flash_inputs(torch, B, S, S, H, KV, hd, torch.bfloat16, 22)
    do = torch.randn_like(q)
    pos = torch.arange(S, dtype=torch.int32, device="cuda")[None].expand(B, S)

    def once(_):
        with torch.no_grad():
            layers.attention_chunked(q, k, v, pos, pos)
        ins = [t.clone().requires_grad_() for t in (q, k, v)]
        torch.autograd.grad(layers.attention_chunked(*ins, pos, pos), ins,
                            do)
    once(0)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        once(0)
        torch.cuda.synchronize()
    return sum(us for _, us in kernel_times(torch, prof).values()) / 1e3


def long_context_train(torch, np, ops):
    """Phase 20: BlockLLM training of internlm2-1.8b at full width and
    depth over 2 x 4096-token batches with ``attn_impl="chunked"``, then a
    reduced-depth f32 check of chunked against full attention."""
    from repro_torch import trainers
    from repro_torch.configs.base import get_config
    from repro_torch.core.blockllm import BlockLLMConfig
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.models import layers
    from repro_torch.models import model as model_lib
    from repro_torch.optim.adam import Adam
    cfg = get_config(ARCH)
    B, S = LONG_BATCH, LONG_SEQ
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                    global_batch=B, seed=0))
    core = trainers.make("blockllm", cfg, adam=Adam(lr=1e-3),
                         bcfg=BlockLLMConfig(fused_update="kernel"),
                         attn_impl="chunked", device="cuda")
    state = core.init(torch.Generator("cuda").manual_seed(0))
    chunked, calls = layers.attention_chunked, []
    layers.attention_chunked = lambda *a, **kw: (calls.append(1)
                                                 or chunked(*a, **kw))
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    try:
        for s in range(4):
            t0 = time.monotonic()
            state, m = core.step(state, pipe.batch(s))   # ends in a host read
            step_ms.append((time.monotonic() - t0) * 1e3)
            losses.append(m["loss"])
    finally:
        layers.attention_chunked = chunked
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    print(f"long-context training ({ARCH}, blockllm f32 moments, fused "
          f"kernel, attn_impl='chunked', remat {cfg.remat}, batch {B} x "
          f"{S}): losses {[round(x, 4) for x in losses]} (first - ln V "
          f"{losses[0] - np.log(cfg.vocab_size):+.3f}); step ms "
          f"{[round(x, 1) for x in step_ms]}; attention_chunked calls "
          f"{len(calls)} ({cfg.num_layers} layers x 4 steps x forward and "
          f"remat recompute); launches {launches}; peak device memory "
          f"{peak / 2 ** 30:.2f} GiB")
    if not (np.isfinite(losses).all() and len(losses) == 4):
        raise AssertionError("long-context training: non-finite loss")
    if abs(losses[0] - np.log(cfg.vocab_size)) > 1.0:
        raise AssertionError("long-context training: first loss not near "
                             "ln(vocab)")
    if not calls or launches["masked_adam"] == 0:
        raise AssertionError("long-context training did not run "
                             "attention_chunked or masked_adam")
    state, prof = profile_train(torch, core, state, pipe, 4,
                                label=f"batch {B} x {S}, chunked attention")
    del state, core
    torch.cuda.empty_cache()
    attn = long_context_attention_ms(torch, cfg, B, S) * cfg.num_layers
    print(f"long-context step: chunked attention {attn:.1f} ms/step "
          f"(one block's forward + remat recompute + backward, profiled "
          f"alone, x {cfg.num_layers}) = {attn / max(prof['busy_ms'], 1e-9):.1%} of "
          f"device "
          f"busy {prof['busy_ms']:.1f} ms/step")
    torch.cuda.empty_cache()
    small = cfg.replace(num_layers=2, dtype="float32")
    params = model_lib.init_params(small, generator=torch.Generator(
        "cuda").manual_seed(5), device="cuda")
    batch = {k: t.to("cuda") for k, t in pipe.batch(9).items()}
    with torch.no_grad():
        lc = model_lib.loss_fn(params, small, batch,
                               attn_impl="chunked")[0].item()
        lf = model_lib.loss_fn(params, small, batch,
                               attn_impl="full")[0].item()
        logit_diff = (model_lib.forward(params, small, batch["tokens"],
                                        attn_impl="chunked")
                      - model_lib.forward(params, small, batch["tokens"],
                                          attn_impl="full")).abs().max()
    rel = abs(lc - lf) / abs(lf)
    print(f"chunked vs full attention ({ARCH} at 2 layers, f32, batch {B} x "
          f"{S}): losses {lc:.7f} / {lf:.7f}, rel diff {rel:.2e} (1e-5) "
          f"{'ok' if rel <= 1e-5 else 'FAIL'}; largest logit difference "
          f"{logit_diff.item():.3g}")
    if not rel <= 1e-5:
        raise AssertionError("chunked and full attention disagree")
    del params
    torch.cuda.empty_cache()
    return dict(losses=losses, step_ms=step_ms, peak=peak, attn_ms=attn,
                **prof)


# --------------------------------------------------------------------- #
# phases 21-22: Q8 tenants through the device AdapterCache, and the
# paper's baseline trainers (slice 9)
# --------------------------------------------------------------------- #


def device_nbytes(torch, delta) -> int:
    """Bytes of a delta once promoted: the rows dequantized to their
    original dtype, the row indices."""
    from repro_torch.checkpoint.checkpointer import dtype_of
    nb = 0
    for e in delta.entries.values():
        if e.quantized:
            n = 1
            for d in e.row_shape:
                n *= d
            nb += n * torch.empty((), dtype=dtype_of(e.row_dtype)) \
                .element_size()
        else:
            nb += e.rows.nbytes
        nb += e.idx.nbytes if e.idx is not None else 0
    return nb


def flip_ms(torch, srv, tenants, flips: int = 12) -> float:
    """Mean ms of a flip (revert + apply, synchronized) between
    ``tenants`` on a drained server; the first two flips warm up."""
    times = []
    for i in range(flips + 2):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        srv._ensure_adapter(tenants[i % len(tenants)])
        torch.cuda.synchronize()
        times.append((time.monotonic() - t0) * 1e3)
    return sum(times[2:]) / flips


def q8_cache_serving(torch, np, ops, card):
    """Phase 21: three q8 demo tenants over one full-width, full-depth
    ``internlm2-1.8b`` base, served without and with the device
    AdapterCache (a budget of two tenants, so it evicts); then the
    launcher with ``--cache-bytes``."""
    from repro_torch.adapters import InMemoryRegistry, quantize_delta
    from repro_torch.checkpoint.checkpointer import _flatten_with_names
    from repro_torch.configs.base import get_config
    from repro_torch.launch import serve
    from repro_torch.models import model as model_lib
    from repro_torch.runtime.serve_config import SchedConfig, ServeConfig
    from repro_torch.runtime.serve_loop import DecodeServer, Request

    cfg = get_config(ARCH)
    params = model_lib.init_params(
        cfg, generator=torch.Generator("cuda").manual_seed(21),
        device="cuda")
    t0 = time.monotonic()
    fp_reg, ids = serve.make_demo_registry(params, 3)
    q8 = {a: quantize_delta(fp_reg.get(a)) for a in ids}
    fp_bytes = {a: fp_reg.get(a).nbytes for a in ids}
    del fp_reg
    print(f"q8 tenants ({ARCH}, full width and depth, 3 demo tenants, "
          f"built and quantized in {time.monotonic() - t0:.1f} s): "
          + ", ".join(f"{a} {q8[a].nbytes / 2 ** 20:.1f} MiB q8 vs "
                      f"{fp_bytes[a] / 2 ** 20:.1f} MiB f32 "
                      f"({sum(e.quantized for e in q8[a].entries.values())}"
                      f" of {len(q8[a].entries)} entries quantized)"
                      for a in ids))
    # 1. the card's dequantization is bitwise the CPU's
    n_bad, n_el = 0, 0
    for d in q8.values():
        for e in d.entries.values():
            if e.quantized:
                a = e.materialize_rows("cuda").cpu()
                b = e.materialize_rows("cpu")
                n_el += b.numel()
                n_bad += int((a.view(torch.int32) != b.view(torch.int32))
                             .sum())
    print(f"q8 dequantization on the card vs the CPU: {n_bad} of {n_el} "
          f"elements differ in any bit {'ok' if n_bad == 0 else 'FAIL'}")
    if n_bad:
        raise AssertionError("the card's dequantized rows differ from the "
                             "CPU's")
    # 2. the same requests uncached and cached
    dev_nb = sorted((device_nbytes(torch, d) for d in q8.values()),
                    reverse=True)
    budget = dev_nb[0] + dev_nb[1] + 4096
    if budget >= sum(dev_nb):
        raise AssertionError("the cache budget would hold all three tenants")
    tenants = [None] + ids
    rng = np.random.default_rng(21)
    prompts = [rng.integers(0, cfg.vocab_size, 8 + (7 * i) % 33)
               for i in range(24)]
    class Counting(InMemoryRegistry):
        """Adds up the payload bytes handed out through ``get`` (the
        cache's promotions), each checked to be an int8 payload."""
        promoted_bytes = 0

        def get(self, adapter_id):
            d = super().get(adapter_id)
            if not d.quantized:
                raise AssertionError(f"{adapter_id}: promoted a payload "
                                     f"that is not q8")
            self.promoted_bytes += d.nbytes
            return d

    legs = {}
    for leg, cache_bytes in (("uncached", 0), ("cached", budget)):
        reg = Counting(q8)
        srv = DecodeServer(cfg, params, ServeConfig(
            batch_slots=8, max_seq=256, attn_impl="kernel",
            sched=SchedConfig(steps_per_turn=2, cache_bytes=cache_bytes)),
            registry=reg)
        reqs = [Request(rid=i, prompt=p, max_new_tokens=16,
                        adapter_id=tenants[i % 4])
                for i, p in enumerate(prompts)]
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for r in reqs:
            srv.submit(r)
        srv.run_until_drained()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = dict(ops.LAUNCHES)
        tok = sum(len(r.out) for r in reqs)
        st = srv.stats()
        promoted = reg.promoted_bytes
        ms = flip_ms(torch, srv, ids[:2])
        srv.restore_base()
        exact = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                    for a, b in zip(_flatten_with_names(srv.params)[1],
                                    _flatten_with_names(params)[1]))
        legs[leg] = dict(streams=[r.out for r in reqs], tok_s=tok / wall,
                         flip_ms=ms, swaps=st["sched"]["swaps"],
                         cache=st.get("cache"), promoted=promoted,
                         exact=exact, launches=launches)
        del srv, reg
        torch.cuda.empty_cache()
    c, u = legs["cached"], legs["uncached"]
    cs = c["cache"]
    equal = c["streams"] == u["streams"]
    print(f"q8 cache serving ({ARCH}, 24 requests x 16 tokens over base + "
          f"3 q8 tenants, 8 slots, 2-step turns; budget "
          f"{budget / 2 ** 20:.1f} MiB = two tenants' device rows "
          f"{dev_nb[0] / 2 ** 20:.1f} + {dev_nb[1] / 2 ** 20:.1f} MiB): "
          f"hits {cs['hits']}, misses {cs['misses']}, evictions "
          f"{cs['evictions']}, captures {cs['captures']}, h2d_bytes "
          f"{cs['h2d_bytes']}, d2d_bytes {cs['d2d_bytes']}, hit rate "
          f"{cs['hit_rate']:.0%}; swaps {c['swaps']} (uncached "
          f"{u['swaps']}); tokens/s cached {c['tok_s']:.1f}, uncached "
          f"{u['tok_s']:.1f}; ms per flip (revert + apply, synchronized, "
          f"12 flips between 2 tenants) cached {c['flip_ms']:.3f}, uncached "
          f"{u['flip_ms']:.3f} ({card})")
    print(f"q8 cache serving: launches cached {c['launches']}, uncached "
          f"{u['launches']}; streams equal to uncached serving: {equal}; "
          f"h2d_bytes {cs['h2d_bytes']} == q8 payload bytes promoted "
          f"{c['promoted']}: {cs['h2d_bytes'] == c['promoted']}; weights "
          f"revert bit-exactly: cached {c['exact']}, uncached {u['exact']}")
    if not equal:
        raise AssertionError("cached streams differ from uncached streams")
    if cs["h2d_bytes"] != c["promoted"] or not c["promoted"]:
        raise AssertionError("h2d_bytes is not the q8 payload bytes "
                             "promoted")
    if cs["evictions"] < 1 or cs["hits"] < 1:
        raise AssertionError("the cache neither hit nor evicted")
    if not (c["exact"] and u["exact"]):
        raise AssertionError("the served weights did not revert exactly")
    for k in SERVE_KERNELS:
        if c["launches"][k] == 0 or u["launches"][k] == 0:
            raise AssertionError(f"{k} did not launch on the cached or the "
                                 f"uncached leg")
    del params
    torch.cuda.empty_cache()
    # 3. the launcher with the cache
    argv = ["--arch", ARCH, "--reduce", "0", "--demo-adapters", "2",
            "--cache-bytes", str(budget)]
    print(f"cache launcher: python -m repro_torch.launch.serve "
          f"{' '.join(argv)}")
    ops.reset_launches()
    srv, reqs = serve.run(argv)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    cst = srv.stats()["cache"]
    print(f"cache launcher: {sum(len(r.out) for r in reqs)} tokens, "
          f"launches {launches}, cache {cst}")
    if launches["scatter_swap"] == 0 or cst["misses"] == 0:
        raise AssertionError("the cached launcher did not swap through the "
                             "kernel")
    del srv, reqs
    torch.cuda.empty_cache()
    return c["launches"]


BASELINE_RUNS = (("galore", 3), ("lora", 4), ("badam", 4), ("badam+q8", 4),
                 ("adam+q8", 2))


def badam_reference_small(torch, np):
    """``badam`` and ``badam+q8`` reduced by 8 (f32), 6 steps with a block
    switch every 2, on the card (the masked-Adam kernels, no mask, as the
    factory chooses there) and on the CPU (their plain versions), from
    the same weights and batches: losses within rtol 1e-4, the same
    blocks.  Adam eps 1e-3, as in ``reference_small``: with 1e-8 a v
    code that rounds to 0 beside a non-zero m code steps m_hat / eps
    (the reference's Q8 divergence, ROADMAP C), so last-bit differences
    in the gradients move the Q8 losses by 1e-3 (measured on the card,
    and between the unfused and the fused update on the CPU alone)."""
    from repro_torch import trainers
    from repro_torch.adapters import copy_tree
    from repro_torch.checkpoint.checkpointer import tree_map
    from repro_torch.configs.base import get_config, reduce_config
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.models import model as model_lib
    from repro_torch.optim.adam import Adam
    from repro_torch.trainers.badam import badam_config
    cfg = reduce_config(get_config(ARCH), 8).replace(dtype="float32")
    params = model_lib.init_params(cfg, generator=torch.Generator(
        "cpu").manual_seed(4), device="cpu")
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                    global_batch=4, seed=4))
    for name in ("badam", "badam+q8"):
        runs = {}
        for dev, fused in (("cuda", "kernel"), ("cpu", "plain")):
            tr = trainers.handle(name, cfg, tree_map(
                lambda a: a.to(dev), copy_tree(params)), device=dev,
                adam=Adam(lr=1e-3, eps=1e-3), bcfg=badam_config(
                    2, fused_update=fused))
            runs[dev] = ([tr.train_step(pipe.batch(s))["loss"]
                          for s in range(6)], tr.state.meta,
                         tr.core.bcfg.fused_update)
        lc, lp = runs["cuda"][0], runs["cpu"][0]
        rel = max(abs(a - b) / abs(b) for a, b in zip(lc, lp))
        same = all(runs["cuda"][1][k] == runs["cpu"][1][k]
                   for k in ("stack_idx", "active_leaves", "reselections"))
        ok = rel <= 1e-4 and same and np.isfinite(lc).all()
        print(f"small-input reference ({name}, reduced {ARCH} "
              f"({cfg.num_layers} layers), 6 steps, a block switch every "
              f"2, eps 1e-3): card (fused_update={runs['cuda'][2]!r}) vs CPU "
              f"({runs['cpu'][2]!r}) losses max rel diff {rel:.2e} (rtol "
              f"1e-4), same blocks {same} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} on the card disagrees with the "
                                 f"CPU reference")


def baselines_train(torch, np, ops, peaks, card):
    """Phase 22: the baselines (and ``adam+q8``, the last core without a
    card peak) through the launcher at 8 x 256, full width and depth;
    then the eight-core peak-memory table."""
    from repro_torch.checkpoint.checkpointer import _flatten_with_names
    from repro_torch.launch import train as tlaunch
    reports = dict(peaks.pop("reports"))
    p50 = dict(peaks.pop("p50"))
    for opt, steps in BASELINE_RUNS:
        argv = ["--arch", ARCH, "--reduce", "0", "--optimizer", opt,
                "--batch", "8", "--seq", "256", "--steps", str(steps)]
        print(f"baseline: python -m repro_torch.launch.train "
              f"{' '.join(argv)}")
        ops.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        out = tlaunch.main(argv)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = {k: v for k, v in ops.LAUNCHES.items() if v}
        peak = torch.cuda.max_memory_allocated()
        losses, step_ms = out["losses"], out["step_ms"]
        tr = out["trainer"]
        ln_v = float(np.log(tr.cfg.vocab_size))
        rest = np.asarray(step_ms[1:])
        print(f"baseline {opt}: losses {[round(x, 4) for x in losses]} "
              f"(first - ln V {losses[0] - ln_v:+.3f}); step ms: first "
              f"{step_ms[0]:.1f}"
              + (" (the SVD refresh)" if opt == "galore" else "")
              + f", the other {len(rest)} p50 {np.percentile(rest, 50):.1f}"
              f" ({[round(float(x), 1) for x in rest]}); {wall:.1f} s wall "
              f"including init; launches {launches}; peak device memory "
              f"{peak / 2 ** 30:.2f} GiB ({card})")
        if not (np.isfinite(losses).all() and len(losses) == steps):
            raise AssertionError(f"{opt}: non-finite or missing loss")
        if abs(losses[0] - ln_v) > 1.0:
            raise AssertionError(f"{opt}: first loss {losses[0]:.3f} is not "
                                 f"near ln(vocab) = {ln_v:.3f}")
        if opt != "adam+q8" and max(losses) >= ln_v + 0.5:
            raise AssertionError(f"{opt}: a loss is 0.5 or more above "
                                 f"ln(vocab)")
        if opt.startswith("badam"):
            kernel = "masked_adam_q8" if opt.endswith("q8") else "masked_adam"
            leaves = len(_flatten_with_names(tr.state.arrays["sel"])[1])
            want = steps * leaves
            print(f"baseline {opt}: {kernel} launches {launches.get(kernel)}"
                  f" = {steps} steps x {leaves} active leaves "
                  f"({tr.state.meta['stack_idx']}, "
                  f"{tr.state.meta['active_leaves']}): "
                  f"{launches.get(kernel) == want}")
            if launches.get(kernel) != want or tr.reselections != 1:
                raise AssertionError(f"{opt}: {kernel} launches "
                                     f"{launches.get(kernel)}, not {want}")
        peaks[opt] = peak
        reports[opt] = tr.memory_report()
        p50[opt] = float(np.percentile(rest, 50))
        if opt == "galore":
            p50["galore refresh"] = step_ms[0]
        del out, tr
        torch.cuda.empty_cache()
    badam_reference_small(torch, np)
    print(f"peak device memory, all eight cores ({ARCH}, full width and "
          f"depth, batch 8 x 256; {card}):")
    print("  core          peak GiB   train state GiB   step p50 ms")
    for name in ("blockllm", "blockllm+q8", "adam", "adam+q8", "galore",
                 "lora", "badam", "badam+q8"):
        print(f"  {name:12s}  {peaks[name] / 2 ** 30:8.2f}   "
              f"{reports[name]['total_train_state'] / 2 ** 30:15.3f}   "
              f"{p50.get(name, float('nan')):11.1f}")
    print(f"  (galore's first step, the SVD refresh: "
          f"{p50['galore refresh']:.1f} ms)")
    if not peaks["blockllm"] < peaks["adam"]:
        raise AssertionError("BlockLLM's peak is not below Adam's")
    return peaks


# --------------------------------------------------------------------- #
# phase 23: the serving fleet (slice 10)
# --------------------------------------------------------------------- #

FLEET_REQUESTS, FLEET_NEW_TOKENS, FLEET_SLOTS = 48, 12, 8


def replica_bytes(srv) -> int:
    """Device bytes one replica holds: its weights, KV cache, displaced
    base rows and cached delta rows."""
    from repro_torch.checkpoint.checkpointer import _flatten_with_names
    trees = [srv.params, srv.cache_state]
    if srv._displaced is not None:
        trees.append({n: e.rows for n, e in srv._displaced.entries.items()})
    nb = sum(t.nbytes for tree in trees for t in _flatten_with_names(tree)[1])
    return nb + (srv.cache.resident_bytes() if srv.cache is not None else 0)


def first_divergence(torch, cfg, params, registry, reqs, want) -> str:
    """The first request and token where ``reqs`` leave the reference
    streams ``want``, with the reference's top-2 logit margin there (a
    teacher-forced forward under the request's tenant)."""
    from repro_torch.models import model as model_lib
    from repro_torch.runtime.serve_config import ServeConfig
    from repro_torch.runtime.serve_loop import DecodeServer
    for r in reqs:
        ref = want[r.rid]
        if tuple(r.out) == ref:
            continue
        j = next((i for i, (a, b) in enumerate(zip(r.out, ref)) if a != b),
                 min(len(r.out), len(ref)))
        srv = DecodeServer(cfg, params, ServeConfig(batch_slots=1),
                           registry=registry)
        srv._ensure_adapter(r.adapter_id)
        toks = torch.as_tensor(list(r.prompt) + list(ref[:j]),
                               device="cuda")[None]
        with torch.no_grad():
            lg = model_lib.forward(srv.params, cfg, toks,
                                   attn_impl="full")[0, -1].float()
        top = torch.topk(lg, 2).values
        del srv
        return (f"rid {r.rid} (tenant {r.adapter_id}, prompt "
                f"{len(r.prompt)} tokens) first differs at new token {j}: "
                f"reference {ref[j] if j < len(ref) else None}, got "
                f"{r.out[j] if j < len(r.out) else None}; the reference's "
                f"top-2 logit margin there {float(top[0] - top[1]):.6g}")
    return "no divergence"


def fleet_serving(torch, np, ops, card):
    """Phase 23: the serving fleet at the full width and depth of
    ``internlm2-1.8b``: base + 3 q8 demo tenants (a cache budget of two),
    8 slots, Zipf (alpha 1.2) tenancy, 48 requests of 3-6 prompt tokens x
    12 new tokens, no SLO.  One ``DecodeServer`` gives the reference
    streams; then the Router at 1 and 2 replicas, a kill of the busiest
    replica at round 4 with a replacement, and two failed registry reads,
    launch counts reset just before each leg and read just after.
    Returns the 2-replica leg's launches."""
    import gc
    from repro_torch.adapters import InMemoryRegistry, quantize_delta
    from repro_torch.configs.base import get_config
    from repro_torch.launch import serve
    from repro_torch.launch.fleet import zipf_tenant_mix
    from repro_torch.models import model as model_lib
    from repro_torch.runtime.elastic import FaultPlan
    from repro_torch.runtime.fleet import Router
    from repro_torch.runtime.serve_config import (FleetConfig, SchedConfig,
                                                  ServeConfig)
    from repro_torch.runtime.serve_loop import DecodeServer, Request

    t_phase = time.monotonic()
    cfg = get_config(ARCH)
    params = model_lib.init_params(
        cfg, generator=torch.Generator("cuda").manual_seed(23),
        device="cuda")
    fp_reg, ids = serve.make_demo_registry(params, 3)
    q8 = {a: quantize_delta(fp_reg.get(a)) for a in ids}
    del fp_reg
    dev_nb = sorted((device_nbytes(torch, d) for d in q8.values()),
                    reverse=True)
    budget = dev_nb[0] + dev_nb[1] + 4096
    tenants = [None] + ids
    rng = np.random.default_rng(23)
    mix = zipf_tenant_mix(tenants, FLEET_REQUESTS, rng, alpha=1.2)
    prompts = [rng.integers(0, cfg.vocab_size, 3 + i % 4)
               for i in range(FLEET_REQUESTS)]
    counts = {str(t): mix.count(t) for t in tenants}
    print(f"fleet ({ARCH}, full width and depth, bf16, base + 3 q8 demo "
          f"tenants, cache budget {budget / 2 ** 20:.1f} MiB = two "
          f"tenants' device rows, {FLEET_SLOTS} slots, 4-step turns; "
          f"{FLEET_REQUESTS} requests x {FLEET_NEW_TOKENS} new tokens, "
          f"prompts of 3-6 tokens, Zipf 1.2 tenancy {counts}, no SLO; "
          f"tenants built in {time.monotonic() - t_phase:.1f} s) ({card})")

    def config(**fleet):
        return ServeConfig(batch_slots=FLEET_SLOTS, max_seq=64,
                           attn_impl="kernel",
                           sched=SchedConfig(steps_per_turn=4,
                                             cache_bytes=budget),
                           fleet=FleetConfig(**fleet))

    def requests():
        return [Request(rid=i, prompt=p, max_new_tokens=FLEET_NEW_TOKENS,
                        adapter_id=t)
                for i, (p, t) in enumerate(zip(prompts, mix))]

    # the reference: one DecodeServer on the same requests
    ops.reset_launches()
    reg = InMemoryRegistry(dict(q8))
    srv = DecodeServer(cfg, params, config(), registry=reg)
    reqs = requests()
    t0 = time.monotonic()
    for r in reqs:
        srv.submit(r)
    srv.run_until_drained()
    torch.cuda.synchronize()
    want = {r.rid: tuple(r.out) for r in reqs}
    tok = sum(len(r.out) - 1 for r in reqs)
    print(f"fleet reference: one DecodeServer, {srv.steps} decode steps, "
          f"{tok / srv.steps:.3f} decode tokens per step, "
          f"{time.monotonic() - t0:.2f} s wall, launches "
          f"{dict(ops.LAUNCHES)} ({card})")
    del srv, reqs
    gc.collect()
    torch.cuda.empty_cache()

    legs = {}
    gate_fail = []

    def leg(name, replicas, plan=None, fault=None, trace=False, **fleet):
        reg = InMemoryRegistry(dict(q8))
        ops.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        t0 = time.monotonic()
        router = Router(cfg, params, config(**fleet), replicas=replicas,
                        registry=reg, trace=trace,
                        fault_plan=FaultPlan.parse(plan))
        reqs = requests()
        for r in reqs:
            if router.submit(r) is None:
                raise AssertionError(f"{name}: request {r.rid} was shed")
        victim = None
        freed = {}
        if fault is not None:
            victim = max(router.replicas,
                         key=lambda n: router.replicas[n].depth())
            router.faults = FaultPlan.parse(fault.format(victim=victim))
            rep = router.replicas[victim]
            release = rep.release

            def measured_release():
                torch.cuda.synchronize()
                m0 = torch.cuda.memory_allocated()
                release()
                gc.collect()
                torch.cuda.synchronize()
                freed["bytes"] = m0 - torch.cuda.memory_allocated()

            rep.release = measured_release
        held = {}

        def on_round(rt):
            for n, rp in rt.replicas.items():
                held[n] = max(held.get(n, 0), replica_bytes(rp.server))

        on_round(router)
        router.run_until_drained(on_round=on_round)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = dict(ops.LAUNCHES)
        s = router.stats()
        f = s["fleet"]
        streams = {r.rid: tuple(r.out) for r in reqs}
        equal = streams == want and all(r.done for r in reqs)
        out = dict(router=router, f=f, wall=wall, launches=launches,
                   equal=equal, held=held, victim=victim, freed=freed,
                   peak=torch.cuda.max_memory_allocated() - base_mem,
                   retried=reg.retried_reads, plan=router.faults)
        print(f"fleet {name}: {replicas} replica(s), {f['rounds']} rounds, "
              f"{f['tokens']} decode tokens, {f['tps_per_round']:.3f} "
              f"tokens per round; {f['routed_home']} home / {f['spills']} "
              f"spilled / {f['steals']} stolen / {f['sheds']} shed; swaps "
              f"{f['swaps']}, peer hits {f['peer_hits']} "
              f"({f['xrep_bytes'] / 2 ** 20:.1f} MiB shared), h2d "
              f"{f['h2d_bytes'] / 2 ** 20:.1f} MiB; {wall:.2f} s wall; "
              f"launches {launches}; streams bitwise the single server's: "
              f"{equal} ({card})")
        print(f"fleet {name}: device memory held per replica at its peak "
              f"(weights + KV + displaced + cached rows) "
              + ", ".join(f"{n} {b / 2 ** 30:.3f} GiB"
                          for n, b in sorted(held.items()))
              + f"; the leg's peak above its start "
              f"{out['peak'] / 2 ** 30:.3f} GiB ({card})")
        for k in SERVE_KERNELS:
            if launches[k] == 0:
                gate_fail.append(f"{name}: {k} did not launch")
        if not equal:
            gate_fail.append(f"{name}: streams differ from the single "
                             f"server's; " + first_divergence(
                                 torch, cfg, params, reg, reqs, want))
        legs[name] = out
        return out

    one = leg("1 replica", 1)
    two = leg("2 replicas", 2)
    ratio = two["f"]["tps_per_round"] / one["f"]["tps_per_round"]
    print(f"fleet tokens per round: 2 replicas {two['f']['tps_per_round']:.3f}"
          f" / 1 replica {one['f']['tps_per_round']:.3f} = {ratio:.3f}x "
          f"(gate >= 1.8x) ({card})")
    if ratio < 1.8:
        gate_fail.append(f"tokens per round at 2 replicas only {ratio:.3f}x "
                         f"one replica's")
    del one, two
    legs.clear()
    gc.collect()
    torch.cuda.empty_cache()

    kill = leg("kill", 2, fault="kill:{victim}@round4", trace=True,
               replace_after_fence=True)
    f = kill["f"]
    recs = f["recoveries"]
    print(f"fleet kill: fenced {f['fenced_replicas']}, fences {f['fences']},"
          f" failovers (replayed in-flight requests) {f['failovers']}, "
          f"recoveries {recs}, rounds to recover {f['recover_rounds']}, "
          f"sheds {f['sheds']}; device memory freed at the fence "
          f"{kill['freed'].get('bytes', 0) / 2 ** 30:.3f} GiB "
          f"({card})")
    if f["fences"] != 1 or f["sheds"] != 0 or f["failovers"] < 1 \
            or f["fenced_replicas"] != {kill["victim"]: "killed"}:
        gate_fail.append("kill: expected one fence of the victim, zero "
                         "sheds and at least one replay")
    if kill["freed"].get("bytes", 0) <= 0:
        gate_fail.append("kill: the fence freed no device memory")
    trace = OUT / "fleet_kill_trace.json"
    kill["router"].write_trace(trace)
    r = subprocess.run([sys.executable, str(ROOT / "tools" / "check_trace.py"),
                        "--kind", "serve", "--require-fleet",
                        "--require-failover", str(trace)],
                       capture_output=True, text=True, timeout=120)
    print(f"fleet kill trace: {(r.stdout + r.stderr).strip()} ({card})")
    if r.returncode != 0:
        gate_fail.append("kill: check_trace.py refused the merged trace")
    del kill
    legs.clear()
    gc.collect()
    torch.cuda.empty_cache()

    err = leg("adapter_read_error", 2, plan="adapter_read_error:n=2")
    print(f"fleet adapter_read_error: injected {err['plan'].injected}, "
          f"registry retried reads {err['retried']}, fenced "
          f"{err['f']['fenced_replicas']} ({card})")
    if err["retried"] < 2 or err["plan"].injected["read_error"] != 2 \
            or err["f"]["fences"]:
        gate_fail.append("adapter_read_error: the retries were not "
                         "counted, or a replica was fenced")
    launches = legs["adapter_read_error"]["launches"]
    del err
    legs.clear()
    del params, q8
    gc.collect()
    torch.cuda.empty_cache()
    print(f"fleet phase: {time.monotonic() - t_phase:.1f} s ({card})")
    if gate_fail:
        raise AssertionError("fleet phase: " + "; ".join(gate_fail))
    return launches


# --------------------------------------------------------------------- #
# phase 24: the MoE family (slice 11)
# --------------------------------------------------------------------- #


def route_flips(np, card_log, cpu_log, k):
    """Chunks and tokens whose routes (top-k in order, keep) differ
    between two ``moe.RouteLog``s, with the CPU's probability margin at
    the top-k boundary (k-th minus (k+1)-th probability)."""
    flips = []
    for c, ((ti, tk, _), (ci, ck, probs)) in enumerate(
            zip(card_log.routes, cpu_log.routes)):
        bad = ((ti != ci).any(-1) | (tk != ck).any(-1)).nonzero()[:, 0]
        for t in bad.tolist()[:4]:
            p = np.sort(probs[t].numpy())[::-1]
            margin = p[k - 1] - p[k] if k < len(p) else float("nan")
            flips.append(f"chunk {c} token {t}: card {ti[t].tolist()} "
                         f"cpu {ci[t].tolist()}, margin {margin:.3g}")
    return flips


def moe_card_vs_cpu(torch, np):
    """(b) Full width, 2 layers, f32: ``forward``, ``prefill_into_slots``
    (4 slots, one idle, a 16-row chunk) and 4 ``decode_step``s (kernel
    attention on the card, its plain version on the CPU) of
    ``granite-moe-3b-a800m`` and ``qwen2-moe-a2.7b`` on the card against
    the port's CPU run on the same weights: logits within rtol 1e-4 of
    the largest logit, routes (top-k in order and the keep mask) equal;
    a route that flips is printed with its probability margin."""
    from repro_torch.checkpoint.checkpointer import tree_map
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as model_lib
    from repro_torch.models import moe
    for arch in (MOE_ARCH, "qwen2-moe-a2.7b"):
        t0 = time.monotonic()
        cfg = get_config(arch).replace(num_layers=2, dtype="float32")
        params = model_lib.init_params(cfg, generator=torch.Generator(
            "cuda").manual_seed(24), device="cuda")
        host = tree_map(lambda a: a.cpu(), params)
        rng = np.random.default_rng(24)
        toks = rng.integers(0, cfg.vocab_size, (2, 16))
        prompt = rng.integers(0, cfg.vocab_size, (4, 16))
        lengths = np.asarray([16, 9, 0, 12], np.int32)
        fed = rng.integers(0, cfg.vocab_size, (4, 4))

        def run(dev, p):
            outs, logs = [], []
            with torch.no_grad():
                with moe.route_log(keep_routes=True) as log:
                    outs.append(model_lib.forward(
                        p, cfg, torch.as_tensor(toks, device=dev),
                        attn_impl="full"))
                logs.append(log)
                cache = model_lib.init_cache(cfg, 4, 32, dtype=torch.float32,
                                             device=dev)
                with moe.route_log(keep_routes=True) as log:
                    lg, _ = model_lib.prefill_into_slots(
                        p, cfg, cache, torch.as_tensor(prompt, device=dev),
                        lengths)
                outs.append(lg)
                logs.append(log)
                pos = lengths.copy()
                act = torch.as_tensor(lengths > 0, device=dev)
                with moe.route_log(keep_routes=True) as log:
                    for t in fed:
                        lg, _ = model_lib.decode_step(
                            p, cfg, cache, torch.as_tensor(
                                t[:, None], device=dev),
                            torch.as_tensor(pos, device=dev),
                            attn_impl="kernel", active=act)
                        outs.append(lg)
                        pos = pos + 1
                logs.append(log)
            return [o.float().cpu() for o in outs], logs

        card, card_logs = run("cuda", params)
        cpu, cpu_logs = run("cpu", host)
        rel = [float((a - b).abs().max() / b.abs().max())
               for a, b in zip(card, cpu)]
        flips = []
        for name, cl, hl in zip(("forward", "prefill", "decode"), card_logs,
                                cpu_logs):
            flips += [f"{name} {f}" for f in route_flips(
                np, cl, hl, cfg.num_experts_per_tok)]
        drops = [(cl.dropped, hl.dropped) for cl, hl in
                 zip(card_logs, cpu_logs)]
        ok = max(rel) <= MOE_LOGIT_RTOL and not flips
        print(f"moe card vs CPU ({arch}, full width, 2 layers, f32, "
              f"{cfg.num_experts} experts top-{cfg.num_experts_per_tok}): "
              f"max|card-cpu| / max|cpu| forward {rel[0]:.2e}, prefill "
              f"{rel[1]:.2e}, decode steps "
              f"{[float(f'{r:.2e}') for r in rel[2:]]} (rtol "
              f"{MOE_LOGIT_RTOL}); routes equal in "
              f"{sum(len(l.routes) for l in cpu_logs)} chunks: "
              f"{not flips}; drops (card, cpu) forward / prefill / decode "
              f"{drops}; {time.monotonic() - t0:.1f} s "
              f"{'ok' if ok else 'FAIL'}")
        for f in flips[:8]:
            print(f"  route flip: {f}")
        if not ok:
            raise AssertionError(f"{arch}: the card disagrees with the CPU")
        del params, host
        torch.cuda.empty_cache()


def family_train_main_path(torch, np, ops, argv=MOE_TRAIN_ARGV,
                           label="moe"):
    """``python -m repro_torch.launch.train`` with ``argv`` (phase 24 (c):
    ``--arch granite-moe-3b-a800m --reduce 0 --optimizer blockllm --batch
    8 --seq 256 --steps 8`` at full depth; phase 25 (b): ``xlstm-1.3b``
    likewise at ``XLSTM_LAYERS`` blocks; full width, f32 moments, the
    fused kernel) with the launch
    counts reset just before and read just after: losses finite, the
    first within 1.0 of the initial model's expected loss, none 0.5
    above it; the aux loss of every step reported, > 0 for an MoE model
    and 0 without one;
    masked-Adam launches one per selected leaf per non-refresh step (the
    selections recorded as the loop calls ``TrainerHandle.train_step``);
    peak device memory."""
    from repro_torch.checkpoint.checkpointer import _flatten_with_names
    from repro_torch.launch import train as tlaunch
    from repro_torch.trainers import api
    print(f"{label} train main path: python -m repro_torch.launch.train "
          f"{' '.join(argv)}")
    seen, peaks, auxes = [], [], []
    step = api.TrainerHandle.train_step

    def spy(self, batch):
        peaks.append(torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()
        m = self.state.meta
        seen.append({"refresh": bool(m["needs_mask_refresh"]),
                     "stacks": {k: list(v) for k, v in
                                m["stack_idx"].items()},
                     "leaves": len(_flatten_with_names(
                         self.state.arrays["sel"])[1])})
        out = step(self, batch)
        auxes.append(out["aux"])
        return out

    api.TrainerHandle.train_step = spy
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    try:
        out = tlaunch.main(argv)
    finally:
        api.TrainerHandle.train_step = step
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = dict(ops.LAUNCHES)
    peaks.append(torch.cuda.max_memory_allocated())
    peak = max(peaks)
    losses, step_ms = out["losses"], out["step_ms"]
    rest = np.asarray(step_ms[1:])
    cfg = out["trainer"].cfg
    want_adam = sum(0 if s["refresh"] else s["leaves"] for s in seen)
    p50 = float(np.percentile(rest, 50))
    print(f"{label} train main path: losses per step "
          f"{[round(x, 4) for x in losses]} (first - ln V "
          f"{losses[0] - np.log(cfg.vocab_size):+.3f}, largest rise over "
          f"the first {max(losses) - losses[0]:+.4f}); aux per step "
          f"{[round(a, 6) for a in auxes]}; step ms: refresh step "
          f"{step_ms[0]:.1f}, the other {len(rest)} p50 {p50:.1f} p99 "
          f"{np.percentile(rest, 99):.1f}; {wall:.1f} s wall including "
          f"init; peak device memory {peak / 2 ** 30:.2f} GiB (init "
          f"{peaks[0] / 2 ** 30:.2f}, per step "
          f"{[round(x / 2 ** 30, 2) for x in peaks[1:]]})")
    print(f"{label} train main path: launches {launches}; selections "
          f"{seen[0]['stacks']} then {seen[-1]['stacks']}, "
          f"{seen[-1]['leaves']} leaves; masked_adam from the selections "
          f"{want_adam}")
    if not (np.isfinite(losses).all() and len(losses) == 8):
        raise AssertionError(f"{label} train main path: non-finite or "
                             f"missing loss")
    # the logits are the unit-RMS final hidden state times the N(0, 0.02^2)
    # head (or tied embedding), so about N(0, s^2) with s^2 = 0.02^2
    # d_model, and E[logsumexp] - E[gold] is ln(vocab) + s^2 / 2: 0.26 to
    # 0.41 above ln(vocab) at d_model 1280 to 2048, 1.02 at 5120
    want = np.log(cfg.vocab_size) + 0.02 ** 2 * cfg.d_model / 2
    if abs(losses[0] - want) > 1.0:
        raise AssertionError(f"first loss {losses[0]:.3f} is not near "
                             f"{want:.3f} (ln(vocab) = "
                             f"{np.log(cfg.vocab_size):.3f})")
    if max(losses) > losses[0] + 0.5:
        raise AssertionError("the loss rose more than 0.5 above the first")
    moe_model = bool(cfg.num_experts)
    if len(auxes) != 8 or not all(np.isfinite(a) and (a > 0) == moe_model
                                  for a in auxes):
        raise AssertionError(f"the aux loss is missing, or not > 0 with "
                             f"experts and 0 without: {auxes}")
    if launches["masked_adam"] != want_adam or want_adam == 0:
        raise AssertionError("masked_adam did not launch once per selected "
                             "leaf per (non-refresh) step")
    report = out["trainer"].memory_report()
    print(f"  memory_report blockllm (GiB): "
          f"{ {k: round(v / 2 ** 30, 3) for k, v in report.items()} }")
    del out
    torch.cuda.empty_cache()
    return launches, peak, p50


def moe_serve_leg(torch, ops, run, count_routes=True):
    """One serving run with the launch counts reset just before and read
    just after; with ``count_routes``, routed pairs and drops counted
    (a device sum per MoE layer per step: a run timed for its step p50
    goes without).  ``run()`` returns ``(server, requests)``; the server
    is kept for the next run."""
    from repro_torch.models import moe
    ops.reset_launches()
    t0 = time.monotonic()
    with (moe.route_log() if count_routes else nullcontext()) as log:
        srv, reqs = run()
        torch.cuda.synchronize()
    st = srv.stats()
    return dict(srv=srv, streams=[tuple(r.out) for r in reqs], reqs=reqs,
                launches=dict(ops.LAUNCHES),
                pairs=log.pairs if log else None,
                dropped=log.dropped if log else None, steps=srv.steps,
                wall=time.monotonic() - t0,
                p50=st["decode"]["step_ms"]["p50"],
                prefill=srv.prefill_dispatches,
                hits=(st["kv"]["prefix_hit_pages"] if srv.alloc is not None
                      else 0))


def moe_rerun(srv, reqs, config=None):
    """The same requests (prompts, tenants, budgets) through a fresh
    ``DecodeServer`` over ``srv``'s base weights and tenants, with
    ``srv``'s serving config unless ``config`` is given."""
    import numpy as np
    from repro_torch.runtime.serve_loop import DecodeServer, Request
    srv.restore_base()
    new = DecodeServer(srv.cfg, srv.params, config or srv.config,
                       registry=srv.registry)
    out = [Request(rid=r.rid, prompt=np.asarray(r.prompt),
                   max_new_tokens=r.max_new_tokens, adapter_id=r.adapter_id)
           for r in reqs]
    for r in out:
        new.submit(r)
    new.run_until_drained()
    return new, out


def moe_serving(torch, np, ops):
    """(d) ``python -m repro_torch.launch.serve --arch
    granite-moe-3b-a800m --reduce 0 --layers 8`` at full width, bf16,
    kernel attention (G = 3), base + 2 demo tenants, 16 requests over 8
    slots x 16 new tokens, dense and ``--paged`` (a shared 24-token
    system prompt).  Each launcher run is followed by a second run of
    its requests on a fresh server over the same base weights and
    tenants.  Gates: every stream complete; each leg bitwise its second
    run; one decode-attention launch per layer per decode step in both
    runs; paged streams bitwise a dense run of the same requests when
    neither dropped a (token, slot) pair, else the first divergence and
    its top-2 logit margin are printed."""
    from repro_torch.launch import serve
    from repro_torch.runtime.serve_config import KVConfig
    L = MOE_SERVE_LAYERS
    legs = {}
    for name, argv in (("dense", MOE_SERVE_ARGV),
                       ("paged", MOE_SERVE_ARGV + ["--paged"])):
        print(f"moe serving ({name}): python -m repro_torch.launch.serve "
              f"{' '.join(argv)}")
        a = moe_serve_leg(torch, ops, lambda: serve.run(argv))
        b = moe_serve_leg(torch, ops, lambda: moe_rerun(a["srv"], a["reqs"]),
                          count_routes=False)
        kern = "decode_attention" if name == "dense" else \
            "paged_decode_attention"
        other = "paged_decode_attention" if name == "dense" else \
            "decode_attention"
        complete = all(len(s) == 16 for s in a["streams"]) and \
            len(a["streams"]) == 16
        same = a["streams"] == b["streams"]
        print(f"moe serving ({name}): {sum(map(len, a['streams']))} tokens, "
              f"{a['steps']} decode steps, {a['prefill']} prefill "
              f"dispatches, step ms p50 {a['p50']:.2f} with the routes "
              f"counted ({b['p50']:.2f} in the second run, without), "
              f"{a['wall']:.2f} s wall including init (second run "
              f"{b['wall']:.2f}); launches {a['launches']}; (token, slot) "
              f"pairs routed {a['pairs']}, dropped {a['dropped']}; prefix "
              f"hits "
              f"{a['hits']} pages; every stream complete {complete}; "
              f"bitwise a second run: {same}")
        fails = []
        if not complete:
            fails.append("incomplete streams")
        if not same:
            fails.append("differs from a second run of itself")
        for r in (a, b):
            if r["launches"][kern] != L * r["steps"] or r["launches"][other]:
                fails.append(f"{kern} launches {r['launches'][kern]} != "
                             f"{L} layers x {r['steps']} steps")
            if not r["launches"]["scatter_swap"]:
                fails.append("no swap")
        if fails:
            raise AssertionError(f"moe serving ({name}): {fails}")
        del b
        legs[name] = a
    paged = legs["paged"]
    del legs["dense"]["srv"]
    torch.cuda.empty_cache()
    dense = moe_serve_leg(torch, ops, lambda: moe_rerun(
        paged["srv"], paged["reqs"],
        paged["srv"].config.replace(kv=KVConfig())))
    equal = paged["streams"] == dense["streams"]
    print(f"moe serving: paged streams vs a dense run of the same requests "
          f"(prefill chunk 64): equal {equal}; drops: paged "
          f"{paged['dropped']}, dense {dense['dropped']}")
    if paged["dropped"] == 0 and dense["dropped"] == 0 and not equal:
        raise AssertionError("moe serving: paged streams differ from dense "
                             "ones with no pair dropped")
    if not equal:
        srv = paged["srv"]
        srv.restore_base()
        want = {r.rid: s for r, s in zip(paged["reqs"], dense["streams"])}
        where = first_divergence(torch, srv.cfg, srv.params, srv.registry,
                                 paged["reqs"], want)
        print(f"moe serving: first divergence of the paged leg from the "
              f"dense run: {where}")
    del paged["srv"], dense
    torch.cuda.empty_cache()
    return legs


def moe_family(torch, np, ops, da, results, card):
    """Phase 24: (a) decode attention at G = 3, (b) card vs CPU at 2
    layers, (c) BlockLLM training at full width and depth, then crash ->
    resume -> export -> serve at 2 layers, (d) serving at full width and
    ``MOE_SERVE_LAYERS`` layers, dense and paged, and the MoE decode
    step's profile at full depth."""
    t0 = time.monotonic()
    g = torch.Generator("cuda").manual_seed(24)
    errs = decode_cases(torch, da, DECODE_G3_CASES, g)
    ctx = [int(c) for c in np.random.default_rng(24).integers(200, 901, 8)]
    time_decode_attention(torch, da, results, g, G=3, hd=64, C=1024,
                          pos=ctx, worst=errs["G3 hd64 bf16"], prefix="g3_")
    errs = paged_cases(torch, np, da, PAGED_G3_CASES, seed=240)
    time_paged_decode_attention(torch, np, da, results, errs["G3 hd64 bf16"],
                                G=3, hd=64, seed=24, prefix="g3_")
    torch.cuda.empty_cache()
    moe_card_vs_cpu(torch, np)
    t1 = time.monotonic()
    launches, peak, p50 = family_train_main_path(torch, np, ops)
    checkpoint_export_serve(torch, np, ops, arch=MOE_ARCH, layers=2)
    t2 = time.monotonic()
    legs = moe_serving(torch, np, ops)
    _, wall_ms, busy = profile_decode(torch, np, arch=MOE_ARCH)
    torch.cuda.empty_cache()
    print(f"phase 24 ({MOE_ARCH}): kernels and card vs CPU {t1 - t0:.1f} s, "
          f"training and crash-resume-export-serve {t2 - t1:.1f} s, serving "
          f"and profile {time.monotonic() - t2:.1f} s; training peak "
          f"{peak / 2 ** 30:.2f} GiB, step p50 {p50:.1f} ms; decode step "
          f"(32 layers) wall {wall_ms:.2f} ms, busy {busy:.2f} ms; serving "
          f"({MOE_SERVE_LAYERS} layers) drops dense "
          f"{legs['dense']['dropped']} of {legs['dense']['pairs']}, paged "
          f"{legs['paged']['dropped']} of {legs['paged']['pairs']} ({card})")
    return launches, legs

# --------------------------------------------------------------------- #
# phase 25: the xLSTM family (slice 12)
# --------------------------------------------------------------------- #


def xlstm_card_vs_cpu(torch, np):
    """(a) Full width, 8 layers (one pattern: 7 mLSTM + 1 sLSTM), f32:
    ``forward`` at B 2, S 512 (two 256-token mLSTM chunks, a 512-step
    sLSTM loop) and 8 ``decode_step``s from a fresh cache, on the card
    against the port's CPU run on the same weights: logits within rtol
    1e-4 of the largest CPU logit."""
    from repro_torch.checkpoint.checkpointer import tree_map
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as model_lib
    t0 = time.monotonic()
    cfg = get_config(XLSTM_ARCH).replace(num_layers=8, dtype="float32")
    params = model_lib.init_params(cfg, generator=torch.Generator(
        "cuda").manual_seed(25), device="cuda")
    host = tree_map(lambda a: a.cpu(), params)
    rng = np.random.default_rng(25)
    toks = rng.integers(0, cfg.vocab_size, (2, 512))
    fed = rng.integers(0, cfg.vocab_size, (8, 2, 1))

    def run(dev, p):
        with torch.no_grad():
            outs = [model_lib.forward(p, cfg, torch.as_tensor(toks,
                                                              device=dev))]
            cache = model_lib.init_cache(cfg, 2, 16, dtype=torch.float32,
                                         device=dev)
            for t, tok in enumerate(fed):
                lg, _ = model_lib.decode_step(
                    p, cfg, cache, torch.as_tensor(tok, device=dev),
                    torch.full((2,), t, dtype=torch.int32, device=dev))
                outs.append(lg)
        return [o.float().cpu() for o in outs]

    card = run("cuda", params)
    t1 = time.monotonic()
    cpu = run("cpu", host)
    rel = [float((a - b).abs().max() / b.abs().max())
           for a, b in zip(card, cpu)]
    ok = max(rel) <= XLSTM_LOGIT_RTOL and all(
        bool(torch.isfinite(a).all()) for a in card)
    print(f"xlstm card vs CPU ({XLSTM_ARCH}, full width, 8 layers "
          f"{cfg.stages()}, f32): max|card-cpu| / max|cpu| forward (B 2, "
          f"S 512) {rel[0]:.2e}, decode steps "
          f"{[float(f'{r:.2e}') for r in rel[1:]]} (rtol "
          f"{XLSTM_LOGIT_RTOL}); card {t1 - t0:.1f} s with init, CPU "
          f"{time.monotonic() - t1:.1f} s {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("xlstm: the card disagrees with the CPU")
    del params, host
    torch.cuda.empty_cache()


def xlstm_serving(torch, np, ops):
    """(d) ``python -m repro_torch.launch.serve --arch xlstm-1.3b
    --reduce 0 --layers 16`` at full width, bf16, base + 2 demo tenants,
    16 requests over 8 slots x 16 new tokens (per-token priming), then a
    second run of its requests on a fresh server over the same base
    weights and tenants, then the first request admitted into a slot an
    earlier request used, alone on a fresh server.  Gates: every stream
    complete; bitwise the second run; the reused slot's stream equal to
    the fresh server's; the swap kernel launched in both runs, no decode
    attention; one priming dispatch per prompt token."""
    from repro_torch.runtime import serve_loop
    from repro_torch.launch import serve
    print(f"xlstm serving: python -m repro_torch.launch.serve "
          f"{' '.join(XLSTM_SERVE_ARGV)}")
    admitted = []
    prime = serve_loop.DecodeServer._prime_tokenwise

    def spy(self, adm):
        admitted.append([(slot, req.rid) for slot, req in adm])
        return prime(self, adm)

    serve_loop.DecodeServer._prime_tokenwise = spy
    torch.cuda.reset_peak_memory_stats()
    try:
        a = moe_serve_leg(torch, ops, lambda: serve.run(XLSTM_SERVE_ARGV),
                          count_routes=False)
    finally:
        serve_loop.DecodeServer._prime_tokenwise = prime
    peak = torch.cuda.max_memory_allocated()
    b = moe_serve_leg(torch, ops, lambda: moe_rerun(a["srv"], a["reqs"]),
                      count_routes=False)
    del b["srv"]
    used, reused = set(), None
    for wave in admitted:
        for slot, rid in wave:
            if slot in used and reused is None:
                reused = rid
            used.add(slot)
    req = next(r for r in a["reqs"] if r.rid == reused)
    alone = moe_serve_leg(torch, ops, lambda: moe_rerun(a["srv"], [req]),
                          count_routes=False)
    del alone["srv"]
    prompt_tokens = sum(len(r.prompt) for r in a["reqs"])
    complete = len(a["streams"]) == 16 and all(len(s) == 16
                                               for s in a["streams"])
    same = a["streams"] == b["streams"]
    fresh = alone["streams"][0] == tuple(req.out)
    print(f"xlstm serving: {sum(map(len, a['streams']))} tokens, "
          f"{a['steps']} decode steps, {a['prefill']} priming dispatches for "
          f"{prompt_tokens} prompt tokens, step ms p50 {a['p50']:.2f} (second "
          f"run {b['p50']:.2f}), {a['wall']:.2f} s wall including init "
          f"(second run {b['wall']:.2f}); peak device memory "
          f"{peak / 2 ** 30:.2f} GiB; launches {a['launches']} (second run "
          f"{b['launches']}); every stream complete {complete}; bitwise a "
          f"second run: {same}; rid {reused} (admitted into a reused slot) "
          f"equals a fresh server's stream: {fresh}")
    fails = []
    if not complete:
        fails.append("incomplete streams")
    if not same:
        fails.append("differs from a second run of itself")
    if not fresh:
        fails.append("a reused slot differs from a fresh server")
    if a["prefill"] != prompt_tokens:
        fails.append("not one priming dispatch per prompt token")
    for r in (a, b):
        if not r["launches"]["scatter_swap"]:
            fails.append("no swap")
        if r["launches"]["decode_attention"] or \
                r["launches"]["paged_decode_attention"]:
            fails.append("a decode-attention launch in a model without "
                         "attention")
    if fails:
        raise AssertionError(f"xlstm serving: {fails}")
    del a["srv"]
    torch.cuda.empty_cache()
    return a


def xlstm_family(torch, np, ops, card):
    """Phase 25: (a) card vs CPU at 8 layers, (b) BlockLLM training at
    full width and ``XLSTM_LAYERS`` blocks, (c) crash -> resume -> export
    -> serve at 8 layers, (d) serving at full width and ``XLSTM_LAYERS``
    blocks and the xLSTM decode step's profile at full depth."""
    t0 = time.monotonic()
    xlstm_card_vs_cpu(torch, np)
    t1 = time.monotonic()
    launches, peak, p50 = family_train_main_path(
        torch, np, ops, argv=XLSTM_TRAIN_ARGV, label="xlstm")
    t2 = time.monotonic()
    checkpoint_export_serve(torch, np, ops, arch=XLSTM_ARCH, layers=8,
                            slots=2)
    t3 = time.monotonic()
    leg = xlstm_serving(torch, np, ops)
    groups, wall_ms, busy = profile_decode(torch, np, arch=XLSTM_ARCH)
    torch.cuda.empty_cache()
    print(f"phase 25 ({XLSTM_ARCH}): card vs CPU {t1 - t0:.1f} s, training "
          f"{t2 - t1:.1f} s, crash-resume-export-serve {t3 - t2:.1f} s, "
          f"serving and profile {time.monotonic() - t3:.1f} s; training "
          f"({XLSTM_LAYERS} blocks) peak {peak / 2 ** 30:.2f} GiB, step p50 "
          f"{p50:.1f} ms; serving ({XLSTM_LAYERS} blocks) step p50 "
          f"{leg['p50']:.2f} ms; decode step (48 blocks) wall {wall_ms:.2f} "
          f"ms, busy {busy:.2f} ms, idle {max(0.0, 1 - busy / wall_ms):.1%} "
          f"({card})")
    return launches, leg["launches"]


# --------------------------------------------------------------------- #
# phase 26: the whisper encoder-decoder (slice 13)
# --------------------------------------------------------------------- #


def whisper_greedy(torch, cfg, params, prompt, frames, n_new, impl,
                   fed=None):
    """Model-level greedy decode: ``prefill`` over the frames (and the
    prompt) for its ``cross_kv``, put into ``init_cache(B, 448)``; the
    prompt fed token by token, then each argmax (or, teacher-forced, the
    tokens ``fed``) fed back.  Returns ``(streams [B, n_new], per-step
    logits, decode passes)``."""
    from repro_torch.models import model as model_lib
    B, P = prompt.shape
    with torch.no_grad():
        _, pre = model_lib.prefill(params, cfg, {"tokens": prompt,
                                                 "frames": frames})
        cache = model_lib.init_cache(cfg, B, WHISPER_CONTEXT, device="cuda")
        for st, src in zip(cache["cross_kv"], pre["cross_kv"]):
            for pos, kv in st.items():
                for n, a in kv.items():
                    a.copy_(src[pos][n])
        del pre
        out, logits = [], []
        for t in range(P + n_new - 1):
            cur = (prompt[:, t:t + 1] if t < P else
                   (fed[:, t - P:t - P + 1] if fed is not None
                    else out[-1][:, None]))
            lg, _ = model_lib.decode_step(
                params, cfg, cache, cur,
                torch.full((B,), t, dtype=torch.int32, device="cuda"),
                attn_impl=impl)
            logits.append(lg.float())
            if t >= P - 1:
                out.append(lg.argmax(-1))
    return torch.stack(out, 1), logits, P + n_new - 1


def whisper_card_vs_cpu(torch, np, ops):
    """(b) Full width, 2 encoder + 2 decoder layers, f32: ``forward``
    (``mode="prefill"``) at B 2 over 64 tokens and 1500 frames, its
    ``cross_kv``, and 8 ``decode_step``s from ``init_cache`` with that
    ``cross_kv`` (kernel attention on the card, plain on the CPU), the
    card against the port's CPU run on the same weights: each within
    rtol 1e-4 of the largest CPU value."""
    from repro_torch.checkpoint.checkpointer import (_flatten_with_names,
                                                     tree_map)
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as model_lib
    t0 = time.monotonic()
    cfg = get_config(WHISPER_ARCH).replace(num_layers=2,
                                           num_encoder_layers=2,
                                           dtype="float32")
    params = model_lib.init_params(cfg, generator=torch.Generator(
        "cuda").manual_seed(26), device="cuda")
    host = tree_map(lambda a: a.cpu(), params)
    rng = np.random.default_rng(26)
    toks = rng.integers(0, cfg.vocab_size, (2, 64))
    frames = rng.standard_normal((2, cfg.encoder_seq_len,
                                  cfg.encoder_feature_dim), np.float32)
    fed = rng.integers(0, cfg.vocab_size, (8, 2, 1))

    def run(dev, p, impl):
        with torch.no_grad():
            logits, pre = model_lib.forward(
                p, cfg, torch.as_tensor(toks, device=dev),
                frames=torch.as_tensor(frames, device=dev), mode="prefill")
            outs = [logits]
            cache = model_lib.init_cache(cfg, 2, 16, dtype=torch.float32,
                                         device=dev)
            cache["cross_kv"] = pre["cross_kv"]
            for t, tok in enumerate(fed):
                lg, _ = model_lib.decode_step(
                    p, cfg, cache, torch.as_tensor(tok, device=dev),
                    torch.full((2,), t, dtype=torch.int32, device=dev),
                    attn_impl=impl)
                outs.append(lg)
        kv = _flatten_with_names(pre["cross_kv"])[1]
        return [o.float().cpu() for o in outs], [a.cpu() for a in kv]

    ops.reset_launches()
    card, card_kv = run("cuda", params, "kernel")
    launched = ops.LAUNCHES["decode_attention"]
    t1 = time.monotonic()
    cpu, cpu_kv = run("cpu", host, "full")

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())
    r_out = [rel(a, b) for a, b in zip(card, cpu)]
    r_kv = max(rel(a, b) for a, b in zip(card_kv, cpu_kv))
    ok = (max(r_out + [r_kv]) <= WHISPER_LOGIT_RTOL and launched == 2 * 8
          and all(bool(torch.isfinite(a).all()) for a in card))
    print(f"whisper card vs CPU ({WHISPER_ARCH}, full width, 2 encoder + 2 "
          f"decoder layers, f32, 1500 frames): max|card-cpu| / max|cpu| "
          f"forward (B 2, S 64) {r_out[0]:.2e}, cross_kv {r_kv:.2e}, decode "
          f"steps {[float(f'{r:.2e}') for r in r_out[1:]]} (rtol "
          f"{WHISPER_LOGIT_RTOL}); decode_attention launches {launched} "
          f"(2 layers x 8 steps); card {t1 - t0:.1f} s with init, CPU "
          f"{time.monotonic() - t1:.1f} s {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("whisper: the card disagrees with the CPU")
    del params, host
    torch.cuda.empty_cache()


def whisper_train(torch, np, ops):
    """(c) ``python -m repro_torch.launch.train --arch whisper-large-v3
    --reduce 0 --optimizer blockllm --batch 8 --seq 256 --steps 8``
    through ``family_train_main_path`` (its gates; the masked-Adam count
    takes the ``encoder`` unit's nested leaves), then the reference's
    behaviour: every decoder row's ``xattn.wk`` / ``xattn.wv``, those of
    the selected rows included, bitwise the initial weights after the
    run (their gradient through the overlay is zero)."""
    from repro_torch.checkpoint.checkpointer import _flatten_with_names
    from repro_torch.trainers import api
    cross = ("xattn/wk", "xattn/wv")
    first, selected, handles = {}, set(), []
    step = api.TrainerHandle.train_step

    def spy(self, batch):
        if not handles:
            handles.append(self)
            names, leaves, _ = _flatten_with_names(self.state.arrays["params"])
            first.update({n: a.cpu() for n, a in zip(names, leaves)
                          if n.endswith(cross + ("xattn/wq",))})
        selected.update((sid, int(g)) for sid, rows in
                        self.state.meta["stack_idx"].items() for g in rows)
        return step(self, batch)

    api.TrainerHandle.train_step = spy
    try:
        launches, peak, p50 = family_train_main_path(
            torch, np, ops, argv=WHISPER_TRAIN_ARGV, label="whisper")
    finally:
        api.TrainerHandle.train_step = step
    names, leaves, _ = _flatten_with_names(handles[0].merged_params())
    after = {n: a.cpu() for n, a in zip(names, leaves) if n in first}
    handles.clear()
    rows = sorted(selected)
    same = all(torch.equal(after[n], first[n]) for n in first
               if n.endswith(cross))

    def wq(sid):                        # "s0/pos0" -> its stacked wq leaf
        si, pos = sid.split("/")
        return f"stages/{si[1:]}/{pos}/xattn/wq"
    moved = sum(not torch.equal(after[wq(sid)][g], first[wq(sid)][g])
                for sid, g in rows)
    print(f"whisper train: {len(rows)} decoder rows selected {rows}; every "
          f"row's xattn.wk / xattn.wv bitwise the initial weights after the "
          f"run: {same}; the selected rows' xattn.wq moved in {moved} of "
          f"{len(rows)}")
    if not same or not rows:
        raise AssertionError("whisper train: a selected row's xattn.wk / "
                             "xattn.wv changed, as the reference's never do")
    del first, after
    torch.cuda.empty_cache()
    return launches, peak, p50


def whisper_crash_resume_apply(torch, np, ops):
    """(d) Checkpoint -> crash -> resume -> export -> apply at full width,
    2 encoder + 2 decoder layers: ``blockllm+q8`` (the fused Q8 kernel),
    patience 2 so it reselects, the leaf units (``encoder`` among them)
    always active, the frames drawn per step as the launcher draws them.
    The resumed run must equal the uninterrupted one bitwise; the
    exported tenant, applied to the base with ``apply_delta``, must give
    the greedy streams of the merged weights (kernel attention); the
    swap kernel must launch exactly when the delta has row entries."""
    import shutil
    from repro_torch import trainers
    from repro_torch.adapters import AdapterRegistry, apply_delta, copy_tree
    from repro_torch.configs.base import get_config
    from repro_torch.core.blockllm import BlockLLMConfig
    from repro_torch.core.selection import SelectorConfig
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.launch.train import frames_for
    from repro_torch.models import model as model_lib
    from repro_torch.optim.adam import Adam
    from repro_torch.runtime import train_loop
    cfg = get_config(WHISPER_ARCH).replace(num_layers=2, num_encoder_layers=2)
    params0 = model_lib.init_params(cfg, generator=torch.Generator(
        "cuda").manual_seed(7), device="cuda")
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=256,
                                    global_batch=8, seed=7))

    def batch_fn(step):
        return {**pipe.batch(step),
                "frames": frames_for(cfg, 8, 7, step, "cuda")}

    bcfg = BlockLLMConfig(selector=SelectorConfig(
        patience=2, always_active_leaves=("final_norm", "embed", "head",
                                          "encoder")),
        fused_update="kernel")

    def handle():
        core = trainers.make("blockllm+q8", cfg, adam=Adam(lr=1e-3),
                             bcfg=bcfg, device="cuda")
        return trainers.TrainerHandle(core, core.init(None,
                                                      copy_tree(params0)))

    resumed, na, _, secs = crash_resume(
        torch, ops, handle, batch_fn, train_loop.TrainLoopConfig(
            ckpt_dir=str(SCRATCH / "ckpt"),
            adapter_dir=str(SCRATCH / "adapters"), adapter_id="tuned"))
    enc = sum(n.startswith("sel/leaves/encoder/") for n in na)
    print(f"crash-resume ({WHISPER_ARCH} width, 2 encoder + 2 decoder "
          f"layers, blockllm+q8, the encoder's {enc} leaves always active): "
          f"resumed == uninterrupted ({secs:.1f} s with checkpoint I/O)")
    delta = AdapterRegistry(SCRATCH / "adapters").get("tuned")
    row_entries = sum(e.idx is not None for e in delta.entries.values())
    ops.reset_launches()
    applied, _ = apply_delta(copy_tree(params0), delta)
    torch.cuda.synchronize()
    swaps = ops.LAUNCHES["scatter_swap"]
    rng = np.random.default_rng(7)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, 8)),
                             device="cuda")
    frames = frames_for(cfg, 4, 70, 0, "cuda")
    got = whisper_greedy(torch, cfg, applied, prompt, frames, 16, "kernel")[0]
    want = whisper_greedy(torch, cfg, resumed.merged_params(), prompt,
                          frames, 16, "kernel")[0]
    ok = torch.equal(got, want)
    print(f"apply the exported tenant 'tuned' ({delta.num_rows()} rows, "
          f"{delta.nbytes / 2 ** 20:.1f} MiB, step {delta.meta['step']}; "
          f"{row_entries} row entries of {len(delta.entries)}, encoder "
          f"leaves {sum(n.startswith('encoder/') for n in delta.entries)}): "
          f"scatter_swap launches {swaps}; greedy streams (4 x 16, kernel "
          f"attention) equal to the merged weights': {ok}")
    if not ok or bool(swaps) != bool(row_entries):
        raise AssertionError("whisper: the applied tenant disagrees, or the "
                             "swap kernel did not launch with row entries")
    del resumed, params0, applied, delta
    shutil.rmtree(SCRATCH, ignore_errors=True)
    torch.cuda.empty_cache()
    return swaps


def whisper_decode(torch, np, ops):
    """(e) Full width and depth, bf16 weights: ``prefill`` over [8, 1500,
    1280] frames and an 8-token prompt for the ``cross_kv`` of
    ``init_cache(8, 448)``, the prompt primed token by token, 16 greedy
    tokens, kernel attention.  Gates: 32 decode-attention launches per
    decode step; streams bitwise a second run; teacher-forced logits of
    ``kernel`` against ``full`` within ``LOGIT_BF16_TOL``.  Then a
    profile of the decode step."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.train import frames_for
    from repro_torch.models import model as model_lib
    cfg = get_config(WHISPER_ARCH)
    params = model_lib.init_params(cfg, generator=torch.Generator(
        "cuda").manual_seed(26), device="cuda", dtype=torch.bfloat16)
    B = 8
    prompt = torch.as_tensor(np.random.default_rng(26).integers(
        0, cfg.vocab_size, (B, 8)), device="cuda")
    frames = frames_for(cfg, B, 26, 0, "cuda")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.monotonic()
    out, logits, passes = whisper_greedy(torch, cfg, params, prompt, frames,
                                         16, "kernel")
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    again = whisper_greedy(torch, cfg, params, prompt, frames, 16,
                           "kernel")[0]
    full = whisper_greedy(torch, cfg, params, prompt, frames, 16, "full",
                          fed=out)[1]
    worst = max(float((a - b).abs().max()) for a, b in zip(logits, full))
    n_attn = cfg.num_layers
    same = torch.equal(out, again)
    print(f"whisper decode ({WHISPER_ARCH}, full width and depth, bf16, B "
          f"{B}, 8-token prompts primed per token, 16 new tokens, "
          f"init_cache({B}, {WHISPER_CONTEXT}), cross_kv from prefill over "
          f"[{B}, {cfg.encoder_seq_len}, {cfg.encoder_feature_dim}] "
          f"frames): {passes} decode passes, launches {launches} "
          f"({n_attn} x {passes} = {n_attn * passes} expected); {wall:.2f} s "
          f"wall with prefill; peak device memory {peak / 2 ** 30:.2f} GiB; "
          f"streams bitwise a second run: {same}; teacher-forced "
          f"max|kernel - full| {worst:.4f} (tol {LOGIT_BF16_TOL}); stream 0 "
          f"{out[0].tolist()}")
    fails = []
    if launches["decode_attention"] != n_attn * passes:
        fails.append("not 32 decode-attention launches per decode step")
    if not same:
        fails.append("differs from a second run of itself")
    if not worst <= LOGIT_BF16_TOL:
        fails.append("kernel and full logits disagree")
    if fails:
        raise AssertionError(f"whisper decode: {fails}")
    with torch.no_grad():
        _, pre = model_lib.prefill(params, cfg, {"tokens": prompt,
                                                 "frames": frames})
        cache = model_lib.init_cache(cfg, B, WHISPER_CONTEXT, device="cuda")
        cache["cross_kv"] = pre["cross_kv"]
        del pre
        pos = torch.full((B,), 100, dtype=torch.int32, device="cuda")
        tok = prompt[:, :1]

        def step():
            nonlocal pos, tok
            lg, _ = model_lib.decode_step(params, cfg, cache, tok, pos,
                                          attn_impl="kernel")
            tok = lg.argmax(-1, keepdim=True).cpu().to("cuda")
            pos = pos + 1
        _, wall_ms, busy = profile_steps(
            torch, step, f"dense_{WHISPER_ARCH}", f"{WHISPER_ARCH}, bf16, "
            f"B{B}, contexts 102-106 of {WHISPER_CONTEXT}, cross-attention "
            f"over {cfg.encoder_seq_len} frames, kernel attention")
    del params, cache
    torch.cuda.empty_cache()
    return launches, wall_ms, busy, peak


def whisper_family(torch, np, ops, da, results, card):
    """Phase 26: (a) decode attention at G = 1, head_dim 64, (b) card vs
    CPU at 2 + 2 layers, (c) BlockLLM training at full width and depth,
    (d) crash -> resume -> export -> apply at 2 + 2 layers, (e) decode at
    full width and depth and its profile."""
    t0 = time.monotonic()
    g = torch.Generator("cuda").manual_seed(26)
    errs = decode_cases(torch, da, DECODE_G1_CASES, g, KV=20)
    ctx = [int(c) for c in np.random.default_rng(26).integers(100, 441, 8)]
    time_decode_attention(torch, da, results, g, G=1, hd=64,
                          C=WHISPER_CONTEXT, pos=ctx,
                          worst=errs["G1 hd64 bf16"], prefix="g1_", KV=20)
    torch.cuda.empty_cache()
    whisper_card_vs_cpu(torch, np, ops)
    t1 = time.monotonic()
    launches, peak, p50 = whisper_train(torch, np, ops)
    t2 = time.monotonic()
    swaps = whisper_crash_resume_apply(torch, np, ops)
    t3 = time.monotonic()
    dec, wall_ms, busy, dec_peak = whisper_decode(torch, np, ops)
    print(f"phase 26 ({WHISPER_ARCH}): kernel and card vs CPU "
          f"{t1 - t0:.1f} s, training {t2 - t1:.1f} s, crash-resume-export-"
          f"apply {t3 - t2:.1f} s, decode and profile "
          f"{time.monotonic() - t3:.1f} s; training peak "
          f"{peak / 2 ** 30:.2f} GiB, step p50 {p50:.1f} ms; decode peak "
          f"{dec_peak / 2 ** 30:.2f} GiB, step wall {wall_ms:.2f} ms, busy "
          f"{busy:.2f} ms, idle {max(0.0, 1 - busy / wall_ms):.1%} ({card})")
    return launches, swaps, dec


# --------------------------------------------------------------------- #
# phase 27: the pixtral VLM (slice 14) and whole-sequence prefill
# --------------------------------------------------------------------- #


def cache_from_prefill(torch, cfg, pre, B, max_seq, dtype, device="cuda"):
    """``init_cache(B, max_seq)`` with ``prefill``'s cache copied in: an
    attention block's rows into its first rows (a local block's in their
    ring slots, which at a prompt shorter than the window are the same),
    a recurrent block's final state whole."""
    from repro_torch.checkpoint.checkpointer import _flatten_with_names
    from repro_torch.models import model as model_lib
    cache = model_lib.init_cache(cfg, B, max_seq, dtype=dtype, device=device)
    names, dst, _ = _flatten_with_names(cache["stages"])
    src_names, src, _ = _flatten_with_names(pre["stages"])
    if names != src_names:
        raise AssertionError(f"prefill cache leaves {src_names} are not "
                             f"init_cache's {names}")
    for a, b in zip(dst, src):
        a[:, :, :b.shape[2]] = b
    return cache


def pixtral_greedy(torch, cfg, params, tokens, patches, impl, fed=None):
    """Model-level greedy decode of a VLM: ``prefill`` over the patch
    embeddings and the prompt (its last logits give the first token), its
    rows copied into ``init_cache(B, 512)``, then ``PIXTRAL_NEW``
    ``decode_step``s feeding each argmax back (or, teacher-forced, the
    tokens ``fed``).  Returns ``(streams [B, PIXTRAL_NEW + 1], per-step
    logits)``."""
    from repro_torch.models import model as model_lib
    B, S = tokens.shape
    with torch.no_grad():
        last, pre = model_lib.prefill(params, cfg, {"tokens": tokens,
                                                    "patch_embeds": patches})
        cache = cache_from_prefill(torch, cfg, pre, B, PIXTRAL_CONTEXT,
                                   torch.bfloat16)
        del pre
        out, logits = [last.argmax(-1)], [last.float()]
        for i in range(PIXTRAL_NEW):
            cur = fed[:, i:i + 1] if fed is not None else out[-1][:, None]
            lg, _ = model_lib.decode_step(
                params, cfg, cache, cur,
                torch.full((B,), S + i, dtype=torch.int32, device="cuda"),
                attn_impl=impl)
            logits.append(lg.float())
            out.append(lg.argmax(-1))
    return torch.stack(out, 1), logits


def pixtral_card_vs_cpu(torch, np):
    """(b) Full width, 2 layers, f32, B 1 over 256 patch embeddings and 32
    text tokens: ``forward(mode="prefill")``'s logits, 8 teacher-forced
    ``decode_step``s from ``init_cache(1, 512)`` holding the prefill's
    rows (kernel attention at G = 4 on the card, plain on the CPU), and
    ``loss_fn`` with its gradient with respect to ``vision_proj``, on the
    card against the port's CPU run on the same weights (drawn once on
    the card, copied to the host): each within rtol 1e-4 of the largest
    CPU value.  Returns the decode-attention launches on the card."""
    from repro_torch.checkpoint.checkpointer import tree_map
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import model as model_lib
    t0 = time.monotonic()
    cfg = get_config(PIXTRAL_ARCH).replace(num_layers=2, dtype="float32")
    params = model_lib.init_params(cfg, generator=torch.Generator(
        "cuda").manual_seed(27), device="cuda")
    host = tree_map(lambda a: a.cpu(), params)
    rng = np.random.default_rng(27)
    S = cfg.num_patches + PIXTRAL_TEXT
    toks = rng.integers(0, cfg.vocab_size, (1, S))
    patches = rng.standard_normal((1, cfg.num_patches,
                                   cfg.vision_embed_dim), np.float32)
    fed = rng.integers(0, cfg.vocab_size, (8, 1, 1))

    def run(dev, p, impl):
        batch = {"tokens": torch.as_tensor(toks, device=dev),
                 "patch_embeds": torch.as_tensor(patches, device=dev)}
        with torch.no_grad():
            logits, pre = model_lib.forward(
                p, cfg, batch["tokens"], patch_embeds=batch["patch_embeds"],
                mode="prefill")
            outs = [logits]
            cache = cache_from_prefill(torch, cfg, pre, 1, PIXTRAL_CONTEXT,
                                       torch.float32, device=dev)
            for t, tok in enumerate(fed):
                lg, _ = model_lib.decode_step(
                    p, cfg, cache, torch.as_tensor(tok, device=dev),
                    torch.full((1,), S + t, dtype=torch.int32, device=dev),
                    attn_impl=impl)
                outs.append(lg)
        vp = p["vision_proj"].detach().requires_grad_()
        loss, _ = model_lib.loss_fn({**p, "vision_proj": vp}, cfg, batch,
                                    loss_chunk=0)
        grad, = torch.autograd.grad(loss, vp)
        return [o.cpu() for o in outs] + [loss.detach().cpu(), grad.cpu()]

    ops.reset_launches()
    card = run("cuda", params, "kernel")
    launched = ops.LAUNCHES["decode_attention"]
    t1 = time.monotonic()
    cpu = run("cpu", host, "full")

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())
    r = [rel(a, b) for a, b in zip(card, cpu)]
    ok = (max(r) <= PIXTRAL_RTOL and launched == 2 * len(fed)
          and all(bool(torch.isfinite(a).all()) for a in card))
    print(f"pixtral card vs CPU ({PIXTRAL_ARCH}, full width, 2 layers, f32, "
          f"B 1, {cfg.num_patches} patches + {PIXTRAL_TEXT} tokens): "
          f"max|card-cpu| / max|cpu| forward {r[0]:.2e}, decode steps "
          f"{[float(f'{x:.2e}') for x in r[1:-2]]}, loss {r[-2]:.2e} "
          f"({float(cpu[-2]):.5f}), vision_proj gradient {r[-1]:.2e} (rtol "
          f"{PIXTRAL_RTOL}); decode_attention launches {launched} (2 layers "
          f"x {len(fed)} steps); card {t1 - t0:.1f} s with init, CPU "
          f"{time.monotonic() - t1:.1f} s {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("pixtral: the card disagrees with the CPU")
    del params, host
    torch.cuda.empty_cache()
    return launched


def pixtral_train(torch, np, ops):
    """(c) ``python -m repro_torch.launch.train --arch pixtral-12b --reduce
    0 --layers 8 --optimizer blockllm --batch 8 --seq 288 --steps 8``
    through ``family_train_main_path`` (its gates; the launcher draws the
    patch embeddings per step), and the peak under ``PIXTRAL_PEAK_GIB``."""
    launches, peak, p50 = family_train_main_path(
        torch, np, ops, argv=PIXTRAL_TRAIN_ARGV, label="pixtral")
    print(f"pixtral train: {PIXTRAL_TRAIN_LAYERS} of 40 layers at full "
          f"width, peak {peak / 2 ** 30:.2f} GiB (limit {PIXTRAL_PEAK_GIB})")
    if peak / 2 ** 30 >= PIXTRAL_PEAK_GIB:
        raise AssertionError("pixtral train: the peak is not under the limit")
    return launches, peak, p50


def pixtral_crash_resume_apply(torch, np, ops):
    """(c) Checkpoint -> crash -> resume -> export -> apply at full width
    and 3 layers: ``blockllm+q8`` (the fused Q8 kernel), ``vision_proj``
    the one selectable leaf and always active with ``final_norm`` (the
    active leaf set stays fixed, which resume needs: ROADMAP C; ``embed``
    and ``head`` stay frozen), batch 2 x 288 with the patch embeddings
    drawn per step as the launcher draws them, one row of the 3 selected
    and reselected after step 4 (the loss-patience trigger may not fire
    after the checkpoint in 6 steps; 3 rows so that one never trains and
    the delta keeps row entries), through ``crash_resume``.  Each
    checkpoint holds the whole 8.1 GiB of f32 weights, so the leg writes
    one and reads one (no adapter directory: the tenant is exported in
    memory with ``delta_from_trainer``, as the loop's exporter does).  The
    tenant, applied with ``apply_delta``, must give the greedy streams of
    the merged weights; its row entries must be there, and the swap
    kernel must launch exactly when the delta has row
    entries."""
    import shutil
    from repro_torch import trainers
    from repro_torch.adapters import apply_delta, copy_tree, \
        delta_from_trainer
    from repro_torch.configs.base import get_config
    from repro_torch.core.blockllm import BlockLLMConfig
    from repro_torch.core.selection import SelectorConfig
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.launch.train import patch_embeds_for
    from repro_torch.models import model as model_lib
    from repro_torch.optim.adam import Adam
    from repro_torch.runtime import train_loop
    cfg = get_config(PIXTRAL_ARCH).replace(num_layers=3)
    S = cfg.num_patches + PIXTRAL_TEXT
    params0 = model_lib.init_params(cfg, generator=torch.Generator(
        "cuda").manual_seed(7), device="cuda")
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                    global_batch=2, seed=7))

    def batch_fn(step):
        return {**pipe.batch(step),
                "patch_embeds": patch_embeds_for(cfg, 2, 7, step, "cuda")}

    bcfg = BlockLLMConfig(selector=SelectorConfig(
        reselect_every=4, always_active_leaves=("final_norm", "vision_proj"),
        selectable_leaves=("vision_proj",)), fused_update="kernel")

    def handle():
        core = trainers.make("blockllm+q8", cfg, adam=Adam(lr=1e-3),
                             bcfg=bcfg, device="cuda")
        return trainers.TrainerHandle(core, core.init(None,
                                                      copy_tree(params0)))

    t0 = time.monotonic()
    resumed, _, launched, secs = crash_resume(
        torch, ops, handle, batch_fn,
        train_loop.TrainLoopConfig(ckpt_dir=str(SCRATCH / "ckpt")))
    q8 = launched["masked_adam_q8"]
    print(f"crash-resume ({PIXTRAL_ARCH} width, 3 layers, blockllm+q8, "
          f"vision_proj and final_norm always active, batch 2 x {S}, "
          f"reselecting every 4 steps; rows "
          f"{resumed.state.meta['stack_idx']}, masked_adam_q8 launches in "
          f"the resumed run {q8}): resumed == uninterrupted ({secs:.1f} s "
          f"with checkpoint I/O)")
    if not q8:
        raise AssertionError("pixtral: Q8 Adam did not launch")
    shutil.rmtree(SCRATCH, ignore_errors=True)
    delta = delta_from_trainer(resumed, params0, meta={"adapter_id": "tuned"})
    row_entries = sum(e.idx is not None for e in delta.entries.values())
    ops.reset_launches()
    applied, _ = apply_delta(copy_tree(params0), delta)
    torch.cuda.synchronize()
    swaps = ops.LAUNCHES["scatter_swap"]
    rng = np.random.default_rng(7)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, S)),
                             device="cuda")
    patches = patch_embeds_for(cfg, 2, 70, 0, "cuda")
    got = pixtral_greedy(torch, cfg, applied, tokens, patches, "kernel")[0]
    want = pixtral_greedy(torch, cfg, resumed.merged_params(), tokens,
                          patches, "kernel")[0]
    ok = torch.equal(got, want)
    print(f"apply the exported tenant ({delta.num_rows()} rows, "
          f"{delta.nbytes / 2 ** 20:.1f} MiB; {row_entries} row entries of "
          f"{len(delta.entries)}, vision_proj "
          f"{'vision_proj' in delta.entries}): scatter_swap launches "
          f"{swaps}; greedy streams (2 x {PIXTRAL_NEW + 1}, kernel "
          f"attention) equal to the merged weights': {ok} "
          f"({time.monotonic() - t0:.1f} s for the leg)")
    if not ok or not row_entries or bool(swaps) != bool(row_entries):
        raise AssertionError("pixtral: the applied tenant disagrees, has no "
                             "row entries, or the swap kernel did not launch "
                             "with them")
    del resumed, params0, applied, delta
    torch.cuda.empty_cache()
    return swaps, q8


def pixtral_decode(torch, np, ops):
    """(d) Full width and depth (40 layers), bf16 weights, B 8: ``prefill``
    over [8, 256, 1024] patch embeddings and a 288-token prompt (its
    first 256 positions the patches), the rows copied into
    ``init_cache(8, 512)``, then 16 greedy ``decode_step``s with kernel
    attention.  Gates: 40 decode-attention launches per decode step;
    streams bitwise a second run.  (The kernel's function at this shape
    is held in (a), on the model path in f32 in (b); in bf16 at 40 layers
    the ``full`` path, which rounds the probabilities to bf16 before P V,
    parts from the kernel's logits by 0.44, PERF.md.)  Then a profile of
    the decode step."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.train import patch_embeds_for
    from repro_torch.models import model as model_lib
    cfg = get_config(PIXTRAL_ARCH)
    t0 = time.monotonic()
    params = model_lib.init_params(cfg, generator=torch.Generator(
        "cuda").manual_seed(27), device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    B, S = 8, cfg.num_patches + PIXTRAL_TEXT
    tokens = torch.as_tensor(np.random.default_rng(27).integers(
        0, cfg.vocab_size, (B, S)), device="cuda")
    patches = patch_embeds_for(cfg, B, 27, 0, "cuda")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.monotonic()
    out = pixtral_greedy(torch, cfg, params, tokens, patches, "kernel")[0]
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    again = pixtral_greedy(torch, cfg, params, tokens, patches, "kernel")[0]
    same = torch.equal(out, again)
    want = cfg.num_layers * PIXTRAL_NEW
    print(f"pixtral decode ({PIXTRAL_ARCH}, full width and depth, bf16 "
          f"weights ({init_s:.2f} s to draw on the card), B {B}, prefill "
          f"over [{B}, {cfg.num_patches}, {cfg.vision_embed_dim}] patch "
          f"embeddings + {PIXTRAL_TEXT} tokens, init_cache({B}, "
          f"{PIXTRAL_CONTEXT}), {PIXTRAL_NEW} decode steps): launches "
          f"{launches} ({cfg.num_layers} x {PIXTRAL_NEW} = {want} expected); "
          f"{wall:.2f} s wall with prefill; peak device memory "
          f"{peak / 2 ** 30:.2f} GiB; streams bitwise a second run: {same}; "
          f"stream 0 {out[0].tolist()}")
    fails = []
    if launches["decode_attention"] != want:
        fails.append(f"not {cfg.num_layers} decode-attention launches per "
                     f"decode step")
    if not same:
        fails.append("differs from a second run of itself")
    if fails:
        raise AssertionError(f"pixtral decode: {fails}")
    with torch.no_grad():
        _, pre = model_lib.prefill(params, cfg, {"tokens": tokens,
                                                 "patch_embeds": patches})
        cache = cache_from_prefill(torch, cfg, pre, B, PIXTRAL_CONTEXT,
                                   torch.bfloat16)
        del pre
        pos = torch.full((B,), S, dtype=torch.int32, device="cuda")
        tok = out[:, :1]

        def step():
            nonlocal pos, tok
            lg, _ = model_lib.decode_step(params, cfg, cache, tok, pos,
                                          attn_impl="kernel")
            tok = lg.argmax(-1, keepdim=True).cpu().to("cuda")
            pos = pos + 1
        _, wall_ms, busy = profile_steps(
            torch, step, f"dense_{PIXTRAL_ARCH}", f"{PIXTRAL_ARCH}, bf16, "
            f"B{B}, contexts {S}-{S + 5} of {PIXTRAL_CONTEXT}, kernel "
            f"attention")
    del params, cache
    torch.cuda.empty_cache()
    return launches, wall_ms, busy, peak


def prefill_vs_priming(torch, np, ops):
    """(e) Whole-sequence prefill on the card: ``recurrentgemma-2b`` at
    full width and 5 layers (4 RG-LRU blocks and a local attention block)
    and ``xlstm-1.3b`` at 8 layers (7 mLSTM blocks and an sLSTM block),
    f32, B 2: ``prefill`` of a 64-token prompt (the scan kernel's
    launches counted: one per RG-LRU block) against the same prompt
    primed token by token through ``decode_step`` from a fresh cache.
    Every cache leaf within ``PREFILL_RTOL`` of the leaf's largest value,
    the last logits too; then 8 greedy tokens from each cache (kernel
    attention), equal, or parting only where the primed run's top two
    logits are within the tolerance.  Returns the scan launches."""
    from repro_torch.checkpoint.checkpointer import _flatten_with_names
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as model_lib
    B, S, n_new = 2, 64, 8
    scans = 0
    for arch, layers in ((RG_ARCH, 5), (XLSTM_ARCH, 8)):
        t0 = time.monotonic()
        cfg = get_config(arch).replace(num_layers=layers, dtype="float32")
        params = model_lib.init_params(cfg, generator=torch.Generator(
            "cuda").manual_seed(27), device="cuda")
        prompt = torch.as_tensor(np.random.default_rng(27).integers(
            0, cfg.vocab_size, (B, S)), device="cuda")
        want_scans = sum(t == "recurrent" for t in cfg.layer_types())
        ops.reset_launches()
        with torch.no_grad():
            last, pre = model_lib.prefill(params, cfg, {"tokens": prompt})
        torch.cuda.synchronize()
        launched = ops.LAUNCHES["rglru_scan"]
        scans += launched
        filled = cache_from_prefill(torch, cfg, pre, B, 2 * S,
                                    torch.float32)
        del pre
        primed = model_lib.init_cache(cfg, B, 2 * S, dtype=torch.float32,
                                      device="cuda")
        with torch.no_grad():
            for t in range(S):
                plast, _ = model_lib.decode_step(
                    params, cfg, primed, prompt[:, t:t + 1],
                    torch.full((B,), t, dtype=torch.int32, device="cuda"),
                    attn_impl="kernel")

        def rel(a, b):
            return float((a - b).abs().max()
                         / b.abs().max().clamp(min=1e-30))
        names, got, _ = _flatten_with_names(filled["stages"])
        want = _flatten_with_names(primed["stages"])[1]
        errs = {n: rel(a, b) for n, a, b in zip(names, got, want)}
        worst = max(errs, key=errs.get)
        r_last = rel(last, plast)

        def greedy(cache, first):
            out, tok, logits = [], first.argmax(-1), [first]
            with torch.no_grad():
                for i in range(n_new):
                    out.append(tok)
                    lg, _ = model_lib.decode_step(
                        params, cfg, cache, tok[:, None],
                        torch.full((B,), S + i, dtype=torch.int32,
                                   device="cuda"), attn_impl="kernel")
                    tok = lg.argmax(-1)
                    logits.append(lg)
            return torch.stack(out, 1), logits
        a_out, _ = greedy(filled, last)
        b_out, b_logits = greedy(primed, plast)
        same = torch.equal(a_out, b_out)
        tie = None
        if not same:
            i = int((a_out != b_out).any(0).nonzero()[0])
            top = b_logits[i].topk(2, dim=-1).values
            margin = float((top[:, 0] - top[:, 1]).min())
            tie = margin <= PREFILL_RTOL * float(b_logits[i].abs().max())
        ok = (max(errs.values()) <= PREFILL_RTOL and r_last <= PREFILL_RTOL
              and launched == want_scans and (same or tie))
        print(f"prefill vs per-token priming ({arch}, full width, {layers} "
              f"layers, f32, B {B}, {S}-token prompt): rglru_scan launches "
              f"in the prefill {launched} ({want_scans} RG-LRU blocks); "
              f"{len(names)} cache leaves, max|prefill-primed| / max|primed| "
              f"{errs[worst]:.2e} ({worst}), last logits {r_last:.2e} (rtol "
              f"{PREFILL_RTOL}); {n_new} greedy tokens after each equal: "
              f"{same}{'' if same else f' (parted at a tie: {tie})'}; "
              f"{time.monotonic() - t0:.1f} s {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{arch}: prefill disagrees with per-token "
                                 f"priming")
        del params, filled, primed
        torch.cuda.empty_cache()
    return scans


def pixtral_family(torch, np, ops, da, results, card):
    """Phase 27: (a) decode attention at G = 4, head_dim 128, (b) card vs
    CPU at 2 layers, (c) BlockLLM training at full width and 8 layers,
    then crash -> resume -> export -> apply at 3 layers, (d) decode at
    full width and depth and its profile, (e) whole-sequence prefill of
    the recurrent and xLSTM families against per-token priming."""
    t0 = time.monotonic()
    g = torch.Generator("cuda").manual_seed(27)
    errs = decode_cases(torch, da, DECODE_G4_CASES, g, KV=8)
    S = 256 + PIXTRAL_TEXT
    ctx = list(range(S, S + PIXTRAL_NEW, 2))
    time_decode_attention(torch, da, results, g, G=4, hd=128,
                          C=PIXTRAL_CONTEXT, pos=ctx,
                          worst=errs["G4 hd128 bf16"], prefix="g4_")
    torch.cuda.empty_cache()
    pixtral_card_vs_cpu(torch, np)
    t1 = time.monotonic()
    print(f"phase 27 (a) and (b): {t1 - t0:.1f} s")
    launches, peak, p50 = pixtral_train(torch, np, ops)
    t2 = time.monotonic()
    swaps, q8 = pixtral_crash_resume_apply(torch, np, ops)
    t3 = time.monotonic()
    dec, wall_ms, busy, dec_peak = pixtral_decode(torch, np, ops)
    t4 = time.monotonic()
    scans = prefill_vs_priming(torch, np, ops)
    print(f"phase 27 ({PIXTRAL_ARCH} and prefill): kernel and card vs CPU "
          f"{t1 - t0:.1f} s, training {t2 - t1:.1f} s, crash-resume-export-"
          f"apply {t3 - t2:.1f} s, decode and profile {t4 - t3:.1f} s, "
          f"prefill vs priming {time.monotonic() - t4:.1f} s; training "
          f"({PIXTRAL_TRAIN_LAYERS} layers) peak {peak / 2 ** 30:.2f} GiB, "
          f"step p50 {p50:.1f} ms; decode peak {dec_peak / 2 ** 30:.2f} "
          f"GiB, step wall {wall_ms:.2f} ms, busy {busy:.2f} ms, idle "
          f"{max(0.0, 1 - busy / wall_ms):.1%} ({card})")
    return launches, swaps, dec, scans


# --------------------------------------------------------------------- #
# phase 28: the rest of the zoo (slice 15)
# --------------------------------------------------------------------- #


def zoo_kernels(torch, np, da, results):
    """(a') The decode kernels at the new model shapes against their plain
    versions (phase 2's and phase 10's checks), then each shape's time
    beside the bound, the plain version and SDPA (gather + SDPA for the
    paged kernel)."""
    g = torch.Generator("cuda").manual_seed(28)
    errs = decode_cases(torch, da, DECODE_GEMMA_CASES, g, KV=1)
    errs.update(decode_cases(torch, da, DECODE_DEEPSEEK_CASES, g, KV=32))
    # gemma3-1b's local layers: a 512-row ring, every slot past the wrap
    ring_pos = [600, 700, 800, 900, 1000, 1100, 1300, 1500]
    ctx = [int(c) for c in np.random.default_rng(28).integers(200, 901, 8)]
    for prefix, G, hd, C, pos, KV, window, case in (
            ("g4hd256ring_", 4, 256, GEMMA3_WINDOW, ring_pos, 1,
             GEMMA3_WINDOW, "G4 hd256 ring 512 bf16"),
            ("g4hd256_", 4, 256, 1024, ctx, 1, 0, "G4 hd256 bf16"),
            ("g8hd256_", 8, 256, 1024, ctx, 1, 0, "G8 hd256 bf16"),
            ("g1hd128kv32_", 1, 128, 1024, ctx, 32, 0,
             "G1 hd128 KV32 bf16")):
        time_decode_attention(torch, da, results, g, G=G, hd=hd, C=C,
                              pos=pos, worst=errs[case], prefix=prefix,
                              KV=KV, window=window, ring=bool(window))
        torch.cuda.empty_cache()
    # at G = 8, hd 256 an output element can cancel to within 1e-7 of
    # zero: the bf16 outputs are held as the flash kernel's are
    perrs = paged_cases(torch, np, da, PAGED_GEMMA_CASES, seed=280, KV=1,
                        near_zero_atol=FLASH_F32_ATOL)
    for prefix, G in (("g4hd256_", 4), ("g8hd256_", 8)):
        time_paged_decode_attention(torch, np, da, results,
                                    perrs[f"G{G} hd256 bf16"], G=G, hd=256,
                                    seed=28 + G, prefix=prefix, KV=1)


def zoo_card_vs_cpu(torch, np, arch):
    """(a) Full width and ``ZOO_CPU_LAYERS`` layers in f32 (``gemma3-1b``:
    5 local blocks and a global one): ``forward(mode="train")``'s logits
    at B 1, ``loss_fn`` with its gradient with respect to the head
    (``embed`` where it is tied), chunked slot prefill of 2 slots
    (``gemma3-1b``: 600- and 563-token prompts, so the 512-row local rings
    wrap while they are primed) and ``ZOO_FED`` teacher-forced
    ``decode_step``s past them (kernel attention on the card, plain on
    the CPU), on the card against the port's CPU run on the same weights:
    each within ``ZOO_RTOL`` of the largest CPU value, and one
    decode-attention launch per layer per decode step on the card."""
    from repro_torch.checkpoint.checkpointer import tree_map
    from repro_torch.configs.base import BLOCK_LOCAL_ATTN, get_config
    from repro_torch.kernels import ops
    from repro_torch.models import model as model_lib
    t0 = time.monotonic()
    cfg = get_config(arch).replace(num_layers=ZOO_CPU_LAYERS[arch],
                                   dtype="float32")
    params = model_lib.init_params(cfg, generator=torch.Generator(
        "cuda").manual_seed(28), device="cuda")
    host = tree_map(lambda a: a.cpu(), params)
    S = GEMMA3_PROMPT if cfg.window_size else ZOO_PROMPT
    rng = np.random.default_rng(28)
    toks = rng.integers(0, cfg.vocab_size, (2, S))
    lengths = np.asarray([S, S - 37])
    fed = rng.integers(0, cfg.vocab_size, (ZOO_FED, 2, 1))
    leaf = "embed" if cfg.tie_embeddings else "head"

    def run(dev, p, impl):
        tokens = torch.as_tensor(toks, device=dev)
        with torch.no_grad():
            outs = [model_lib.forward(p, cfg, tokens[:1], attn_impl="full")]
            cache = model_lib.init_cache(cfg, 2, S + ZOO_FED,
                                         dtype=torch.float32, device=dev)
            for s in range(0, S, 64):
                lg, _ = model_lib.prefill_into_slots(
                    p, cfg, cache, tokens[:, s:s + 64], lengths,
                    chunk_start=s)
                outs.append(lg)
            for t, tok in enumerate(fed):
                lg, _ = model_lib.decode_step(
                    p, cfg, cache, torch.as_tensor(tok, device=dev),
                    torch.as_tensor(lengths + t, dtype=torch.int32,
                                    device=dev), attn_impl=impl)
                outs.append(lg)
        w = p[leaf].detach().requires_grad_()
        loss, _ = model_lib.loss_fn({**p, leaf: w}, cfg,
                                    {"tokens": tokens[:1]}, attn_impl="full")
        grad, = torch.autograd.grad(loss, w)
        return [o.cpu() for o in outs] + [loss.detach().cpu(), grad.cpu()]

    ops.reset_launches()
    card = run("cuda", params, "kernel")
    torch.cuda.synchronize()
    launched = ops.LAUNCHES["decode_attention"]
    t1 = time.monotonic()
    cpu = run("cpu", host, "full")

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())
    r = [rel(a, b) for a, b in zip(card, cpu)]
    n_chunks = -(-S // 64)
    want = cfg.num_layers * ZOO_FED
    local = sum(t == BLOCK_LOCAL_ATTN for t in cfg.layer_types())
    ok = (max(r) <= ZOO_RTOL and launched == want
          and all(bool(torch.isfinite(a).all()) for a in card))
    print(f"zoo card vs CPU ({arch}, full width, {cfg.num_layers} layers "
          f"({local} local, window {cfg.window_size}), f32, prompts "
          f"{lengths.tolist()}): max|card-cpu| / max|cpu| forward "
          f"{r[0]:.2e}, {n_chunks} prefill chunks "
          f"{max(r[1:1 + n_chunks]):.2e}, decode steps "
          f"{[float(f'{x:.2e}') for x in r[1 + n_chunks:-2]]}, loss "
          f"{r[-2]:.2e} ({float(cpu[-2]):.5f}), {leaf} gradient "
          f"{r[-1]:.2e} (rtol {ZOO_RTOL}); decode_attention launches "
          f"{launched} ({cfg.num_layers} layers x {ZOO_FED} steps); card "
          f"{t1 - t0:.1f} s with init, CPU {time.monotonic() - t1:.1f} s "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{arch}: the card disagrees with the CPU")
    del params, host, card, cpu
    torch.cuda.empty_cache()


def zoo_train(torch, np, ops, arch):
    """(b) ``python -m repro_torch.launch.train --arch <arch> --reduce 0
    --optimizer blockllm --batch 8 --seq 256 --steps 8`` through
    ``family_train_main_path`` (its gates): ``gemma3-1b`` and
    ``gemma-2b`` at full depth, ``deepseek-7b`` at
    ``DEEPSEEK_TRAIN_LAYERS``; the peak under ``ZOO_PEAK_GIB``."""
    from repro_torch.configs.base import get_config
    argv = ["--arch", arch, "--reduce", "0", "--optimizer", "blockllm",
            "--batch", "8", "--seq", "256", "--steps", "8"]
    full = get_config(arch).num_layers
    layers = ZOO_TRAIN_LAYERS.get(arch, full)
    if layers != full:
        argv += ["--layers", str(layers)]
    launches, peak, p50 = family_train_main_path(torch, np, ops, argv=argv,
                                                 label=arch)
    print(f"{arch} train: {layers} of {full} layers at full width, peak "
          f"{peak / 2 ** 30:.2f} GiB (limit {ZOO_PEAK_GIB}), step p50 "
          f"{p50:.1f} ms")
    if peak / 2 ** 30 >= ZOO_PEAK_GIB:
        raise AssertionError(f"{arch} train: the peak is not under the "
                             f"limit")
    return launches, peak, p50


def zoo_tenant(torch, params, seed):
    """A tenant on the card: row 1 of every stack leaf moved by N(0, 0.01^2)
    noise (torch draws: no host noise), published to an in-memory
    registry as ``tuned``."""
    from repro_torch.adapters import InMemoryRegistry, extract_delta
    from repro_torch.checkpoint.checkpointer import tree_map
    g = torch.Generator("cuda").manual_seed(seed)

    def bump(a):
        out = a.clone()
        out[1] += 0.01 * torch.randn(a.shape[1:], generator=g,
                                     device=a.device, dtype=a.dtype)
        return out
    tuned = dict(params)
    tuned["stages"] = [{pos: tree_map(bump, sub) for pos, sub in st.items()}
                       for st in params["stages"]]
    registry = InMemoryRegistry()
    registry.put("tuned", extract_delta(params, tuned,
                                        meta={"adapter_id": "tuned"}))
    return registry


def zoo_serve_leg(torch, ops, cfg, params, reqs, config, registry=None):
    """One ``DecodeServer`` run of ``reqs`` ((prompt, tenant) pairs,
    ``ZOO_NEW`` new tokens each) with the launch counts reset just before
    and read just after; the base weights restored after it."""
    from repro_torch.runtime.serve_loop import DecodeServer, Request
    srv = DecodeServer(cfg, params, config, registry=registry)
    out = [Request(rid=i, prompt=p, max_new_tokens=ZOO_NEW, adapter_id=a)
           for i, (p, a) in enumerate(reqs)]
    for r in out:
        srv.submit(r)
    ops.reset_launches()
    t0 = time.monotonic()
    srv.run_until_drained()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = dict(ops.LAUNCHES)
    st = srv.stats()
    srv.restore_base()
    kv = st.get("kv") or {}
    leg = dict(streams=[tuple(r.out) for r in out], launches=launches,
               steps=st["decode"]["steps"], wall=wall,
               p50=st["decode"]["step_ms"]["p50"],
               hits=kv.get("prefix_hit_pages", 0),
               share=srv.alloc is not None and srv.alloc.share_prefix,
               spec=st.get("spec") if srv.speculate else None,
               prefill=srv.prefill_dispatches)
    del srv
    torch.cuda.empty_cache()
    return leg


def zoo_serving(torch, np, ops, arch):
    """(c) Full width and depth, f32 weights, bf16 compute and cache,
    kernel attention, 8 slots, ``ZOO_NEW`` new tokens a request, through
    ``DecodeServer``, dense and paged (16-row pages): streams complete and
    bitwise equal between the layouts; one dense decode-attention launch
    per layer per decode step dense, and paged one per local layer (its
    ring stays dense) plus one paged launch per global layer.
    ``gemma3-1b``: 12 requests of 520-720-token prompts (the 512-row rings
    wrap while a prompt is primed and while it decodes; the second wave
    reuses rings the first filled), prefix sharing off as in JAX.
    ``gemma-2b``: 24 requests, half of them a tenant's (``zoo_tenant``),
    over a shared 48-token system prompt, 2-step turns (each tenant is
    admitted in more than one wave): prefix hits in the paged run, then
    ``--speculate 4`` (paged): streams equal plain decoding, one paged
    launch per layer per decode pass.
    ``deepseek-7b``: 12 requests of 64-320 tokens, dense, and a second
    run of them, bitwise.  Then the profile of a steady decode step
    (``decode_stepper``: 8 slots at 300-900-token contexts; ``gemma3-1b``
    dense and paged).  Returns the legs' launches and the profiles'
    (wall, busy) ms per step."""
    from repro_torch.configs.base import BLOCK_GLOBAL_ATTN, get_config
    from repro_torch.models import model as model_lib
    from repro_torch.runtime.serve_config import (KVConfig, SchedConfig,
                                                  ServeConfig, SpecConfig)
    cfg = get_config(arch)
    L = cfg.num_layers
    n_global = sum(t == BLOCK_GLOBAL_ATTN for t in cfg.layer_types())
    t0 = time.monotonic()
    params = model_lib.init_params(cfg, generator=torch.Generator(
        "cuda").manual_seed(28), device="cuda")
    rng = np.random.default_rng(28)
    registry = None
    if arch == "gemma3-1b":
        reqs = [(rng.integers(0, cfg.vocab_size, int(n)), None)
                for n in rng.integers(520, 721, 12)]
        max_seq, turn = 768, 8
    elif arch == "gemma-2b":
        registry = zoo_tenant(torch, params, 28)
        system = rng.integers(0, cfg.vocab_size, 48)
        reqs = [(np.concatenate([system, rng.integers(
            0, cfg.vocab_size, int(rng.integers(8, 40)))]),
            "tuned" if i % 2 else None) for i in range(24)]
        max_seq, turn = 256, 2
    else:
        reqs = [(rng.integers(0, cfg.vocab_size, int(n)), None)
                for n in rng.integers(64, 321, 12)]
        max_seq, turn = 512, 8
    init_s = time.monotonic() - t0
    base = ServeConfig(batch_slots=8, max_seq=max_seq, attn_impl="kernel",
                       prefill_chunk=64,
                       sched=SchedConfig(steps_per_turn=turn))
    paged = base.replace(kv=KVConfig(layout="paged", page_size=PAGED_PS))
    legs = {"dense": zoo_serve_leg(torch, ops, cfg, params, reqs, base,
                                   registry)}
    if arch == "deepseek-7b":
        legs["again"] = zoo_serve_leg(torch, ops, cfg, params, reqs, base,
                                      registry)
    else:
        legs["paged"] = zoo_serve_leg(torch, ops, cfg, params, reqs, paged,
                                      registry)
    if arch == "gemma-2b":
        legs["speculative"] = zoo_serve_leg(
            torch, ops, cfg, params, reqs,
            paged.replace(spec=SpecConfig(draft=4)), registry)
    fails = []
    ref = legs["dense"]["streams"]
    for name, leg in legs.items():
        la, steps = leg["launches"], leg["steps"]
        spec = leg["spec"]
        passes = steps if spec is None else \
            spec["passes"] + steps - spec["rounds"]
        if name in ("dense", "again"):
            want = {"decode_attention": L * passes,
                    "paged_decode_attention": 0}
        else:
            want = {"decode_attention": (L - n_global) * passes,
                    "paged_decode_attention": n_global * passes}
        got = {k: la[k] for k in want}
        same = leg["streams"] == ref
        complete = all(len(s) == ZOO_NEW for s in leg["streams"])
        extra = ""
        if spec is not None:
            extra = (f"; {spec['rounds']} rounds, acceptance "
                     f"{spec['acceptance_rate']:.3f} ({spec['accepted']} / "
                     f"{spec['drafted']}), {spec['passes']} passes in "
                     f"rounds + {steps - spec['rounds']} plain steps")
        print(f"zoo serving ({arch}, {name}): {sum(map(len, leg['streams']))}"
              f" tokens, {steps} decode steps, {leg['prefill']} prefill "
              f"dispatches, step ms p50 {leg['p50']:.2f}, {leg['wall']:.2f} s"
              f" wall; launches {got} (want {want}), scatter_swap "
              f"{la['scatter_swap']}; prefix sharing {leg['share']}, hits "
              f"{leg['hits']} pages{extra}; complete {complete}; streams "
              f"bitwise the dense run's: {same}")
        if not (same and complete):
            fails.append(f"{name}: streams differ from the dense run's or "
                         f"are incomplete")
        if got != want:
            fails.append(f"{name}: launches {got} != {want}")
        if registry is not None and not la["scatter_swap"]:
            fails.append(f"{name}: no tenant swap")
    if arch == "gemma3-1b" and (legs["paged"]["share"]
                                or legs["paged"]["hits"]):
        fails.append("prefix sharing on with local rings")
    if arch == "gemma-2b":
        if not legs["paged"]["hits"]:
            fails.append("no prefix hits")
        if not legs["speculative"]["spec"]["rounds"]:
            fails.append("no speculative round")
    if fails:
        raise AssertionError(f"zoo serving ({arch}): {fails}")
    profiles = {}
    for paged_step in ((False, True) if arch == "gemma3-1b" else (False,)):
        with torch.no_grad():
            step, lengths = decode_stepper(torch, np, cfg, params, paged_step)
            _, wall_ms, busy = profile_steps(
                torch, step, ("paged_" if paged_step else "dense_") + arch,
                f"{arch}, bf16, B8, contexts {int(lengths.min())}-"
                f"{int(lengths.max())}, kernel attention")
        profiles["paged" if paged_step else "dense"] = (wall_ms, busy)
        del step
        torch.cuda.empty_cache()
    print(f"zoo serving ({arch}): weights drawn in {init_s:.2f} s, legs and "
          f"profiles {time.monotonic() - t0 - init_s:.1f} s")
    del params, registry
    torch.cuda.empty_cache()
    return legs, profiles


def zoo_family(torch, np, ops, da, results, card):
    """Phase 28: the decode kernels at the new shapes, then per
    architecture (a) card vs CPU, (b) BlockLLM training through the
    launcher, (c) serving at full width and depth with the decode-step
    profiles."""
    t0 = time.monotonic()
    zoo_kernels(torch, np, da, results)
    times = {"kernels": time.monotonic() - t0}
    out = {}
    for arch in ZOO_ARCHS:
        t = time.monotonic()
        zoo_card_vs_cpu(torch, np, arch)
        t1 = time.monotonic()
        train, peak, p50 = zoo_train(torch, np, ops, arch)
        t2 = time.monotonic()
        legs, profiles = zoo_serving(torch, np, ops, arch)
        times[arch] = (t1 - t, t2 - t1, time.monotonic() - t2)
        out[arch] = dict(train=train, peak=peak, p50=p50, legs=legs,
                         profiles=profiles)
    parts = []
    for a in ZOO_ARCHS:
        steps = ", ".join(f"{k} {w:.2f} / {b:.2f} ms"
                          for k, (w, b) in out[a]["profiles"].items())
        parts.append(f"{a} card vs CPU {times[a][0]:.1f} s, training "
                     f"{times[a][1]:.1f} s, serving and profile "
                     f"{times[a][2]:.1f} s, training peak "
                     f"{out[a]['peak'] / 2 ** 30:.2f} GiB, step p50 "
                     f"{out[a]['p50']:.1f} ms, decode step wall / busy "
                     f"{steps}")
    print(f"phase 28 (the zoo): kernels {times['kernels']:.1f} s; "
          + "; ".join(parts) + f" ({card})")
    return out


# ---------------------------------------------------------------------
# phase 29: distributed BlockLLM training over NCCL (slice 16)
# ---------------------------------------------------------------------


def _selected_grads(torch, core, params, sel, plan, batch):
    """The selected rows' (and leaf units') gradients of ``batch``'s
    loss, through the overlay the step itself uses."""
    from repro_torch.checkpoint.checkpointer import (_flatten_with_names,
                                                     tree_map)
    sel_g = tree_map(lambda a: a.detach().requires_grad_(), sel)
    overlay = {sid: {"idx": plan.stack_idx[sid].tolist(), "rows": rows,
                     "pidx": None, "probe": None}
               for sid, rows in sel_g["stacks"].items()}
    merged = dict(params)
    merged.update(sel_g["leaves"])
    loss, _ = core._loss_fn(merged, batch, overlay=overlay)
    names, leaves, _ = _flatten_with_names(sel_g)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return dict(zip(names, grads))


def _check_compressed(torch, rules, grads, card):
    """Phase 29 (b): the int8 error-feedback all-reduce over the step's
    selected-row gradients, twice (zero errors, then the errors the first
    call left).  Gates: the codes and scales on the card are the CPU
    codec's bit for bit; ``new_e`` is ``gc - deq`` bit for bit and within
    half its block's scale, except where ``gc / scale`` rounds onto a tie
    (there within the division's rounding of it); the mean is ``deq`` bit
    for bit (one rank)."""
    from repro_torch.runtime import compression, shard_ctx
    errors = compression.init_errors(grads)
    n_el, ties, worst = 0, 0, 0.0
    for call in range(2):
        with shard_ctx.use(rules):
            mean, new_e = compression.compressed_psum_tree(grads, errors)
        for name, g in grads.items():
            gc = g.float() + errors[name]
            q, s = compression.quantize_int8(gc)
            qc, sc = compression.quantize_int8(gc.cpu())
            if not (torch.equal(q.cpu(), qc) and torch.equal(s.cpu(), sc)):
                raise AssertionError(f"{name}: codes or scales differ from "
                                     f"the CPU codec")
            deq = compression.dequantize_int8(q, s, g.shape)
            e = new_e[name]
            if not torch.equal(e, gc - deq):
                raise AssertionError(f"{name}: new_e is not gc - deq")
            if not torch.equal(mean[name], deq.to(g.dtype)):
                raise AssertionError(f"{name}: the mean is not deq")
            half = (s / 2).repeat_interleave(compression.BLOCK)[:g.numel()]
            half = half.reshape(g.shape)
            over = e.abs() > half
            if over.any():
                # gc / scale rounded onto a tie k + 1/2, and round-half-
                # even took the farther code: past half a step by at most
                # the division's rounding, |gc / scale| * 2^-24 steps
                r = (gc / (2 * half))[over]
                tie = (r.abs() - r.abs().floor()) == 0.5
                lim = 2 * half[over] * (0.5 + r.abs() * 2.0 ** -23)
                if not (tie.all() and (e.abs()[over] <= lim).all()):
                    raise AssertionError(f"{name}: |new_e| above half a step")
                ties += int(over.sum())
            worst = max(worst, float((e.abs() / half.clamp_min(1e-30))
                                     .max()))
            n_el += g.numel()
        errors = new_e
    print(f"phase 29 (b) compressed all-reduce (int8 error feedback, NCCL, "
          f"world 1) over {len(grads)} selected leaves, {n_el} elements in "
          f"2 calls: codes and scales bitwise the CPU codec's, new_e bitwise "
          f"gc - deq, max |new_e| / (scale / 2) {worst:.7f} ({ties} rounded "
          f"onto a tie), mean bitwise deq: ok ({card})")


@contextmanager
def world_of_one():
    """A process group of this process alone over NCCL (a ``FileStore``
    in a temporary directory), destroyed on the way out; yields
    ``torch.distributed``."""
    import shutil
    import tempfile

    import torch.distributed as dist
    rdv = tempfile.mkdtemp(prefix="phase29_")
    dist.init_process_group("nccl", init_method=f"file://{rdv}/store",
                            rank=0, world_size=1)
    try:
        yield dist
    finally:
        dist.destroy_process_group()
        shutil.rmtree(rdv, ignore_errors=True)


def distributed_setup(torch):
    """Phase 29's step: ``build_train_setup`` for ``internlm2-1.8b`` at
    full width and depth on the (1, 1) mesh, 8 x 256, f32 masters; the
    core, its state, 3 batches, the full arguments and this rank's
    shards of them (a list)."""
    from repro_torch.configs.base import get_config
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps as steps_lib
    mesh = mesh_lib.make_host_mesh()
    cfg = get_config(ARCH)
    shape = ShapeConfig("phase29", seq_len=256, global_batch=8, kind="train")
    setup = steps_lib.build_train_setup(
        cfg, shape, mesh, optimizer="blockllm", attn_impl="full",
        param_dtype=torch.float32, device="cuda")
    core = setup.meta["core"]
    state = core.init(torch.Generator("cuda").manual_seed(0))
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=256,
                                    global_batch=8, seed=0))
    batches = [core.to_device(pipe.batch(s)) for s in range(3)]
    full = core.lowerable(state, batches[0]).args
    return setup, core, state, batches, full, list(setup.shard(full))


def distributed_train(torch, np, ops, card):
    """Phase 29: ``launch.steps.build_train_setup`` for ``internlm2-1.8b``
    at full width and depth over NCCL at world size 1 (one card: NCCL
    refuses two ranks on one device; the multi-rank numerics are the CPU
    tests'), 8 x 256, f32 masters.  (a) 3 distributed steps against the
    core's single-device raw step from the same state: loss, updated rows
    and moments bitwise, the masked-Adam launches the plan's (one per
    selected leaf per step); (b) the compressed all-reduce; (c) the
    collective counter of (a).  Returns (a)'s masked-Adam launches."""
    from repro_torch.checkpoint.checkpointer import _flatten_with_names
    from repro_torch.runtime import shard_ctx
    t0 = time.monotonic()
    with world_of_one():
        setup, core, state, batches, full, local = distributed_setup(torch)
        n_leaves = len(_flatten_with_names(full[1])[1])
        # (a) the distributed steps, counted
        ops.reset_launches()
        shard_ctx.reset_collectives()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        d_loss, host_ms, dev_ms = [], [], []
        for b in batches:
            local[7] = setup.shard((None,) * 7 + (b,))[7]
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            h0 = time.monotonic()
            ev[0].record()
            sel, opt, masks, loss, _, _ = setup(*local)
            ev[1].record()
            torch.cuda.synchronize()
            host_ms.append((time.monotonic() - h0) * 1e3)
            dev_ms.append(ev[0].elapsed_time(ev[1]))
            local[1], local[5], local[6] = sel, opt, masks
            d_loss.append(loss.clone())
        launches = dict(ops.LAUNCHES)
        counts = {k: list(v) for k, v in shard_ctx.COLLECTIVES.items()}
        peak = torch.cuda.max_memory_allocated()
        # the same steps through the core's single-device raw step
        fn = core.lowerable(state, batches[0]).fn
        args = list(full)
        s_loss = []
        for b in batches:
            args[7] = b
            sel1, opt1, masks1, loss1, _, _ = fn(*args)
            args[1], args[5], args[6] = sel1, opt1, masks1
            s_loss.append(loss1.clone())
        pairs = [("loss", a, b) for a, b in zip(d_loss, s_loss)]
        for what, x, y in (("rows", local[1], args[1]),
                           ("mu", local[5].mu, args[5].mu),
                           ("nu", local[5].nu, args[5].nu)):
            pairs += [(what, a, b) for a, b in zip(
                _flatten_with_names(x)[1], _flatten_with_names(y)[1])]
        bad = [w for w, a, b in pairs if not torch.equal(a, b)]
        print(f"phase 29 (a) distributed BlockLLM step ({ARCH}, full width "
              f"and depth, 8 x 256, f32 masters, mesh (1, 1) NCCL): losses "
              f"{[round(float(x), 6) for x in d_loss]}; single-device raw "
              f"step {[round(float(x), 6) for x in s_loss]}; loss, "
              f"{n_leaves} selected leaves' rows and both moments over 3 "
              f"steps bitwise: {not bad}; step ms host "
              f"{[round(x, 1) for x in host_ms]} (p50 "
              f"{np.percentile(host_ms, 50):.1f}), CUDA events "
              f"{[round(x, 1) for x in dev_ms]} (p50 "
              f"{np.percentile(dev_ms, 50):.1f}); peak device memory "
              f"{peak / 2 ** 30:.2f} GiB; launches {launches} ({card})")
        if bad:
            raise AssertionError(f"distributed step differs from the "
                                 f"single-device step in {sorted(set(bad))}")
        want = 3 * n_leaves
        if launches["masked_adam"] != want:
            raise AssertionError(f"masked_adam launched "
                                 f"{launches['masked_adam']} times, the plan "
                                 f"gives {want} (3 steps x {n_leaves} leaves)")
        # (b) the compressed all-reduce over the step's gradients
        grads = _selected_grads(torch, core, full[0], local[1],
                                setup.meta["plan"], batches[0])
        _check_compressed(torch, setup.rules, grads, card)
        # (c) the collective counter of (a)
        print(f"phase 29 (c) collectives of (a), kind: [calls, bytes]: "
              f"{counts}")
        del setup, core, state, full, local, args, grads
    torch.cuda.empty_cache()
    print(f"phase 29: {time.monotonic() - t0:.1f} s")
    return launches["masked_adam"]


# ---------------------------------------------------------------------
# phase 30: sharded prefill and decode setups (slice 17)
# ---------------------------------------------------------------------

SHARD_C = 524288           # gemma3-1b's global layers at long_500k
SHARD_SPLITS = (8, 256)    # sequence shards: a node's model axis, (32, 8)
SHARD_POS = [SHARD_C - 1, 400000]   # slot 1: the shards past it see no row
SHARD_RTOL = 1e-5          # merged shards vs one call, f32 o: the same
#                            partials merged in another grouping, relative
#                            to the largest |o|
SERVE_STEPS = 4            # decode steps of each phase 30 (b) leg
# (arch, shape name, batch, cache rows): gemma3-1b at long_500k's own
# shape; internlm2-1.8b at decode_32k cut to one data rank's share of
# (32, 8): 128 / 32 = 4 slots
SERVE_LEGS = (("gemma3-1b", "long_500k", 1, 524288),
              ("internlm2-1.8b", "decode_32k", 4, 32768))
PREFILL_LEG = ("gemma3-1b", "prefill_32k", 1, 32768)   # 32 / 32 data ranks


def _shard_sweep(torch, da, q, k, v, pos, n, window=0, ring=False):
    """Attend the ``n`` sequence shards of ``k`` / ``v`` with the kernel's
    shard variant (f32 q) and merge them (``shard_ctx.merge_softmax``):
    ``(merged o [B, 1, H, hd] f32, lse [B, H], per-shard (o, lse), shard
    caches)``."""
    from repro_torch.runtime import shard_ctx
    B, C = k.shape[:2]
    c = C // n
    ks = [k[:, r * c:(r + 1) * c].contiguous() for r in range(n)]
    vs = [v[:, r * c:(r + 1) * c].contiguous() for r in range(n)]
    parts = [da.decode_attention_cuda(q, ks[r], vs[r], pos, offset=r * c,
                                      total=C, return_lse=True, window=window,
                                      ring=ring) for r in range(n)]
    H, hd = q.shape[2], q.shape[3]
    o, lse = shard_ctx.merge_softmax(
        torch.stack([p[0].reshape(B, H, hd) for p in parts]),
        torch.stack([p[1] for p in parts]))
    return o[:, None], lse, parts, ks, vs


def _check_shards(torch, da, name, q, k, v, pos, n, sample, window=0,
                  ring=False):
    """The merged shards against one whole-cache call (f32 q) within
    ``SHARD_RTOL`` of its largest |o| (lse likewise); the ``sample``
    shards against their plain version (``ATTN_F32_*``); shards past a
    slot's window give lse -inf.  Returns the worst |merged - whole|."""
    kw = dict(window=window, ring=ring)
    C = k.shape[1]
    whole, wlse = da.decode_attention_cuda(q, k, v, pos, offset=0, total=C,
                                           return_lse=True, **kw)
    # today's whole call (at G 10 over a bf16 cache the tensor-core kernel)
    today = da.decode_attention_cuda(q, k, v, pos, **kw)
    o, lse, parts, ks, vs = _shard_sweep(torch, da, q, k, v, pos, n, **kw)
    torch.cuda.synchronize()
    err = (o - whole).abs().max().item()
    lerr = (lse - wlse).abs().max().item()
    terr = (o - today).abs()
    ok = (err <= SHARD_RTOL * whole.abs().max().item()
          and lerr <= SHARD_RTOL * wlse.abs().max().item()
          and bool((terr <= ATTN_F32_ATOL
                    + ATTN_F32_RTOL * today.abs()).all())
          and bool(torch.isfinite(o).all()))
    c = C // n
    perr = 0.0
    for r in sample:
        po, pl = da.decode_attention_plain(q, ks[r], vs[r], pos, offset=r * c,
                                           total=C, return_lse=True, **kw)
        d = (parts[r][0] - po).abs()
        ok &= bool((d <= ATTN_F32_ATOL + ATTN_F32_RTOL * po.abs()).all())
        fin = torch.isfinite(pl)
        ok &= torch.equal(fin, torch.isfinite(parts[r][1]))
        ok &= bool(((parts[r][1] - pl).abs()[fin]
                    <= ATTN_F32_ATOL + ATTN_F32_RTOL * pl.abs()[fin]).all())
        perr = max(perr, d.max().item())
    empty = sum(bool(torch.isneginf(p[1]).any()) for p in parts)
    print(f"decode_attention shards [{name}] {n} x {c} rows of C {C}, pos "
          f"{pos.tolist()}: max|merged - whole| {err:.3g} (lse {lerr:.3g}; "
          f"rtol {SHARD_RTOL} of the largest), vs the call without the "
          f"variant {terr.max().item():.3g}, {empty} shards with a slot "
          f"that sees no row, shards {list(sample)} vs plain max "
          f"{perr:.3g} (rtol {ATTN_F32_RTOL} atol {ATTN_F32_ATOL}) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"decode_attention shards [{name}] disagree")
    return max(err, perr), parts, ks, vs


def decode_shard_kernel(torch, da, results, card):
    """Phase 30 (a): the decode kernel's shard variant at gemma3-1b's
    global shape (G 4, KV 1, hd 256, bf16 cache of 524288 rows, 2 slots):
    the whole-cache call with the log-sum-exp bitwise today's call, the
    cache split into 8 and 256 shards and merged against one whole call,
    a ring (gemma3-1b's local layers) and recurrentgemma-2b's G 10 ring
    (whose shards run the shared body, the whole call the tensor-core
    kernel); times of a shard call and the whole call beside the bound
    and SDPA over the same rows."""
    from repro_torch.models.layers import decode_valid
    g = torch.Generator("cuda").manual_seed(30)
    B, G, hd, C = 2, 4, 256, SHARD_C
    q = torch.randn(B, 1, G, hd, generator=g, device="cuda").bfloat16()
    k = torch.randn(B, C, 1, hd, generator=g, device="cuda").bfloat16()
    v = torch.randn(B, C, 1, hd, generator=g, device="cuda").bfloat16()
    pos = torch.tensor(SHARD_POS, dtype=torch.int32, device="cuda")
    today = da.decode_attention_cuda(q, k, v, pos)
    o, _ = da.decode_attention_cuda(q, k, v, pos, offset=0, total=C,
                                    return_lse=True)
    torch.cuda.synchronize()
    same = torch.equal(o, today)
    print(f"decode_attention [G4 hd256 C{C}] whole-cache call with offset 0 "
          f"and the log-sum-exp: o bitwise the call without them: {same}")
    if not same:
        raise AssertionError("the shard variant changed the whole call")
    qf = q.float()
    worst = 0.0
    sweeps = {}
    for n in SHARD_SPLITS:
        c = C // n
        sample = sorted({0, SHARD_POS[1] // c, n - 1})
        err, parts, ks, vs = _check_shards(torch, da, f"G4 hd256 n{n}", qf,
                                           k, v, pos, n, sample)
        worst = max(worst, err)
        sweeps[n] = (ks, vs)
    rg = torch.Generator("cuda").manual_seed(31)
    for name, G_, C_, n, pos_ in (("ring G4 hd256 C512", 4, 512, 8,
                                   [1000, 300]),
                                  ("ring G4 hd256 C512", 4, 512, 256,
                                   [1000, 300]),
                                  ("ring G10 hd256 C2048", 10, 2048, 8,
                                   [5000, 700])):
        qr = torch.randn(B, 1, G_, hd, generator=rg, device="cuda")
        kr = torch.randn(B, C_, 1, hd, generator=rg, device="cuda").bfloat16()
        vr = torch.randn(B, C_, 1, hd, generator=rg, device="cuda").bfloat16()
        pr = torch.tensor(pos_, dtype=torch.int32, device="cuda")
        err, *_ = _check_shards(torch, da, name, qr, kr, vr, pr, n,
                                range(n) if n <= 8 else [0, 1, n - 1],
                                window=C_, ring=True)
        worst = max(worst, err)
    # times: a shard call (the mean over a sweep of every shard, so the
    # rows read exceed L2) and the whole call, each beside its bound
    # (q, o and lse once, each slot's visible rows of K and V once) and
    # SDPA over the same rows (no log-sum-exp)
    H = G

    def bound(offset, rows_c):
        vis = decode_valid(pos, rows_c, offset=offset, total=C).sum().item()
        nbytes = qf.nbytes + qf.nbytes + B * H * 4 + vis * hd * 2 * 2
        return nbytes / HBM_BYTES_PER_S * 1e3, vis * H * hd * 4 / F32_FLOPS \
            * 1e3

    out = {}
    for n, (ks, vs) in sweeps.items():
        c = C // n
        masks = [decode_valid(pos, c, offset=r * c, total=C)[:, None, None]
                 for r in range(n)]
        qt = q.transpose(1, 2)
        fns = {"kernel": lambda i: da.decode_attention_cuda(
                   qf, ks[i % n], vs[i % n], pos, offset=(i % n) * c,
                   total=C, return_lse=True),
               "sdpa": lambda i: torch.nn.functional.scaled_dot_product_attention(
                   qt, ks[i % n].transpose(1, 2), vs[i % n].transpose(1, 2),
                   attn_mask=masks[i % n], enable_gqa=True)}
        if n == max(SHARD_SPLITS):
            fns["plain"] = lambda i: da.decode_attention_plain(
                qf, ks[i % n], vs[i % n], pos, offset=(i % n) * c, total=C,
                return_lse=True)
        ms = {key: graph_time_ms(f, iters=n, reps=3) for key, f in fns.items()}
        tb = [bound(r * c, c) for r in range(n)]
        t_bytes = sum(b for b, _ in tb) / n
        t_ops = sum(o_ for _, o_ in tb) / n
        out[n] = dict(ms=ms["kernel"], plain_ms=ms.get("plain"),
                      bound_ms=max(t_bytes, t_ops),
                      bound_by="bytes" if t_bytes >= t_ops else "operations",
                      library_ms=ms["sdpa"])
        print(f"decode_attention shard time [G4 hd256, {n} x {c} rows, B{B}, "
              f"f32 q, pos {SHARD_POS}]: kernel {ms['kernel']:.4f} ms a call "
              f"(graph replay, mean over the {n} shards), plain "
              f"{'%.4f ms' % ms['plain'] if 'plain' in ms else 'not timed'}, "
              f"SDPA "
              f"{ms['sdpa']:.4f} ms, bound {out[n]['bound_ms']:.4f} ms "
              f"({out[n]['bound_by']}) ({card})")
    mask = decode_valid(pos, C)[:, None, None]
    whole = {"kernel": graph_time_ms(lambda i: da.decode_attention_cuda(
                 q, k, v, pos), iters=4, reps=3),
             "sdpa": graph_time_ms(
                 lambda i: torch.nn.functional.scaled_dot_product_attention(
                     q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                     attn_mask=mask, enable_gqa=True), iters=4, reps=3)}
    vis = decode_valid(pos, C).sum().item()
    t_bytes = (2 * q.nbytes + vis * hd * 2 * 2) / HBM_BYTES_PER_S * 1e3
    t_ops = vis * H * hd * 4 / F32_FLOPS * 1e3
    print(f"decode_attention whole time [G4 hd256 C{C}, B{B}, bf16 q, pos "
          f"{SHARD_POS}]: kernel {whole['kernel']:.4f} ms, SDPA "
          f"{whole['sdpa']:.4f} ms, bound {max(t_bytes, t_ops):.4f} ms "
          f"({card})")
    r = results["decode_attention"]
    r["shard_max_abs_err"] = worst
    for n, d in out.items():
        r.update({f"shard{n}_{key}": val for key, val in d.items()
                  if val is not None})
    r.update({f"whole{C}_ms": whole["kernel"],
              f"whole{C}_bound_ms": max(t_bytes, t_ops),
              f"whole{C}_library_ms": whole["sdpa"]})
    del k, v, sweeps
    torch.cuda.empty_cache()


def _random_cache(torch, cache, g):
    """Fill every leaf of a decode cache with normal draws (in place, one
    layer row at a time)."""
    from repro_torch.checkpoint.checkpointer import _flatten_with_names
    for t in _flatten_with_names(cache)[1]:
        for row in t:
            row.copy_(torch.randn(row.shape, generator=g, device=t.device,
                                  dtype=torch.float32).to(t.dtype))


def peaked_query(torch, k, pos, H, per_head=4, score=20.0):
    """A query [B, 1, H, hd] (f32) whose scaled scores are ``score`` at a
    few rows of the cache ``k`` [B, C, KV, hd] and near 0 elsewhere: head
    h aims at ``per_head`` rows of its KV head, the H * per_head rows
    spread evenly over [0, pos[b]] (0 and pos[b] among them), and the
    last head also at row pos[b] + 1, which the masks must reject (q is
    the least-norm solution of q . k_row / sqrt(hd) = score).  Over a
    random cache a near-uniform softmax leaves o close to 0, so a dropped
    or misweighted k-block moves o little; here the aimed rows share most
    of the weight and o is near the mean of their V rows, so losing a
    k-block that holds one, or seeing row pos[b] + 1, moves o by a good
    part of |V| / per_head."""
    B, C, KV, hd = k.shape
    G = H // KV
    n = H * per_head
    q = torch.zeros(B, 1, H, hd, device=k.device)
    for b in range(B):
        p = int(pos[b])
        rows = [round(i * p / (n - 1)) for i in range(n)]
        for h in range(H):
            aim = rows[h::H] + ([p + 1] if h == H - 1 and p + 1 < C else [])
            kt = k[b, aim, h // G].float()                      # [m, hd]
            want = torch.full((len(aim), 1), score * hd ** 0.5,
                              device=k.device)
            q[b, 0, h] = (kt.T @ torch.linalg.solve(kt @ kt.T, want))[:, 0]
    return q


def _peaked_check(torch, da, cfg, cache, pos, label, card):
    """Phase 30 (b)'s kernel check: ``decode_attention_cuda`` against
    ``decode_attention_plain`` on the first global layer's cache of a
    leg, at the leg's B, C, G, hd and dtypes (bf16 q, bf16 cache), with
    ``peaked_query``'s query at the step's position: within
    ``ATTN_BF16_ATOL``.  Returns max |kernel - plain|."""
    from repro_torch.configs.base import BLOCK_GLOBAL_ATTN
    k, v = next((st[f"pos{j}"]["k"][0], st[f"pos{j}"]["v"][0])
                for (pattern, _), st in zip(cfg.stages(), cache["stages"])
                for j, btype in enumerate(pattern)
                if btype == BLOCK_GLOBAL_ATTN)
    B, C, KV, hd = k.shape
    pos_b = torch.full((B,), pos, dtype=torch.int32, device=k.device)
    q = peaked_query(torch, k, pos_b, cfg.num_heads).bfloat16()
    kw = dict(softcap=cfg.attn_softcap)
    got = da.decode_attention_cuda(q, k, v, pos_b, **kw).float()
    want = da.decode_attention_plain(q, k, v, pos_b, **kw).float()
    err = (got - want).abs().max().item()
    ok = err <= ATTN_BF16_ATOL and bool(torch.isfinite(got).all())
    print(f"phase 30 (b) decode_attention [{label}: G {cfg.num_heads // KV}"
          f" hd {hd} KV {KV}, {B} x {C} rows, bf16 q and cache, pos {pos}, "
          f"peaked query] vs plain: max|diff| {err:.3g} (atol "
          f"{ATTN_BF16_ATOL}; max|o| {want.abs().max().item():.3g}, mean|o| "
          f"{want.abs().mean().item():.3g}) {'ok' if ok else 'FAIL'} ({card})")
    if not ok:
        raise AssertionError(f"phase 30 (b) {label} decode_attention "
                             f"disagrees with its plain version")
    return err


def serving_leg(torch, np, ops, da, arch, shape_name, B, S, card):
    """Phase 30 (b), one leg: ``build_setup`` of ``arch``'s decode cell
    (``B`` slots of ``S`` rows, random bf16 weights and cache) at world
    size 1 over NCCL, ``SERVE_STEPS`` greedy steps with ``kernel`` from
    position S - 8.  Gates: logits and the whole cache bitwise the
    single-device ``decode_step`` fed the same tokens, logits within
    ``LOGIT_BF16_TOL`` of ``full``, the decode-attention launches the
    attention layers times the steps, no collective at world size 1;
    then ``_peaked_check`` on the leg's cache.  Returns the setup's
    decode-attention launches and the check's max |kernel - plain|."""
    from repro_torch.checkpoint.checkpointer import _flatten_with_names
    from repro_torch.configs.base import get_config
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import model as model_lib
    from repro_torch.runtime import shard_ctx
    cfg = get_config(arch)
    shape = ShapeConfig(shape_name, S, B, "decode")
    setup = steps_lib.build_setup(cfg, shape, mesh_lib.make_host_mesh(),
                                  attn_impl="kernel")
    g = torch.Generator("cuda").manual_seed(30)
    params = model_lib.init_params(cfg, generator=g, device="cuda",
                                   dtype=torch.bfloat16)
    cache = model_lib.init_cache(cfg, B, S, torch.bfloat16, device="cuda")
    _random_cache(torch, cache, g)
    token = torch.randint(0, cfg.vocab_size, (B, 1), generator=g,
                          device="cuda", dtype=torch.int32)
    p0 = S - 8
    # the rows the steps write in each K/V leaf (a ring leaf: its slots)
    leaves = _flatten_with_names(cache)[1]
    rows = [[(p0 + i) % t.shape[2] for i in range(SERVE_STEPS)]
            for t in leaves]
    saved = [t[:, :, r].clone() for t, r in zip(leaves, rows)]
    local = list(setup.shard((params, cache, token, torch.tensor(
        p0, dtype=torch.int32, device="cuda"))))
    ops.reset_launches()
    shard_ctx.reset_collectives()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fed, got, host_ms, dev_ms = [token], [], [], []
    for i in range(SERVE_STEPS):
        local[2] = fed[-1]
        local[3] = torch.tensor(p0 + i, dtype=torch.int32, device="cuda")
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        h0 = time.monotonic()
        ev[0].record()
        logits, local[1] = setup(*local)
        ev[1].record()
        torch.cuda.synchronize()
        host_ms.append((time.monotonic() - h0) * 1e3)
        dev_ms.append(ev[0].elapsed_time(ev[1]))
        got.append(logits)
        fed.append(logits.argmax(-1)[:, None].int())
    launches = ops.LAUNCHES["decode_attention"]
    counts = {k: list(v) for k, v in shard_ctx.COLLECTIVES.items()}
    peak = torch.cuda.max_memory_allocated()
    attn = sum(t in ("global", "local") for t in cfg.layer_types())
    with torch.no_grad():
        ref = [model_lib.decode_step(params, cfg, cache, fed[i],
                                     p0 + i, attn_impl="kernel")[0]
               for i in range(SERVE_STEPS)]
        bitwise = all(torch.equal(a, b) for a, b in zip(got, ref)) and all(
            torch.equal(a, b) for a, b in zip(
                _flatten_with_names(local[1])[1],
                _flatten_with_names(cache)[1]))
        for t, r, old in zip(leaves, rows, saved):
            t[:, :, r] = old
        full = [model_lib.decode_step(params, cfg, cache, fed[i], p0 + i,
                                      attn_impl="full")[0].float()
                for i in range(SERVE_STEPS)]
    diff = max((a.float() - b).abs().max().item() for a, b in zip(got, full))
    scale = max(b.abs().max().item() for b in full)
    finite = all(bool(torch.isfinite(a).all()) for a in got)
    ok = (bitwise and finite and diff <= LOGIT_BF16_TOL
          and launches == attn * SERVE_STEPS
          and not any(k.startswith("decode/") for k in counts))
    print(f"phase 30 (b) decode setup ({arch}, full width and depth, "
          f"{shape_name}: {B} x {S} rows, bf16, mesh (1, 1) NCCL, kernel): "
          f"{SERVE_STEPS} greedy steps from pos {p0}: logits and the whole "
          f"cache bitwise the single-device decode_step: {bitwise}; "
          f"max|logit kernel - full| {diff:.4f} (tol {LOGIT_BF16_TOL}; "
          f"max|logit| {scale:.3g}); decode_attention launches {launches} "
          f"(want {attn} layers x {SERVE_STEPS}); collectives {counts}; "
          f"step ms host {[round(x, 2) for x in host_ms]} (p50 "
          f"{np.percentile(host_ms, 50):.2f}), CUDA events "
          f"{[round(x, 2) for x in dev_ms]} (p50 "
          f"{np.percentile(dev_ms, 50):.2f}); peak device memory "
          f"{peak / 2 ** 30:.2f} GiB {'ok' if ok else 'FAIL'} ({card})")
    if not ok:
        raise AssertionError(f"phase 30 (b) {arch} decode setup failed")
    with torch.no_grad():
        err = _peaked_check(torch, da, cfg, cache, p0 + SERVE_STEPS - 1,
                            f"{arch} {shape_name}", card)
    del setup, params, cache, local, leaves, saved
    torch.cuda.empty_cache()
    return launches, err


def prefill_leg(torch, card):
    """Phase 30 (c): ``build_setup`` of gemma3-1b's prefill cell cut to
    one data rank's share (1 x 32768) at world size 1: logits and the
    returned cache bitwise the single-device ``prefill``; wall time and
    peak memory."""
    from repro_torch.checkpoint.checkpointer import _flatten_with_names
    from repro_torch.configs.base import get_config
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import model as model_lib
    arch, shape_name, B, S = PREFILL_LEG
    cfg = get_config(arch)
    setup = steps_lib.build_setup(cfg, ShapeConfig(shape_name, S, B,
                                                   "prefill"),
                                  mesh_lib.make_host_mesh())
    g = torch.Generator("cuda").manual_seed(32)
    params = model_lib.init_params(cfg, generator=g, device="cuda",
                                   dtype=torch.bfloat16)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                                     device="cuda", dtype=torch.int32)}
    local = setup.shard((params, batch))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    logits, cache = setup(*local)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    peak = torch.cuda.max_memory_allocated()
    with torch.no_grad():
        rl, rc = model_lib.prefill(params, cfg, batch)
    bitwise = torch.equal(logits, rl) and all(
        torch.equal(a, b) for a, b in zip(_flatten_with_names(cache)[1],
                                          _flatten_with_names(rc)[1]))
    finite = bool(torch.isfinite(logits).all())
    print(f"phase 30 (c) prefill setup ({arch}, full width and depth, "
          f"{shape_name} cut to {B} x {S}, bf16, chunked attention, mesh "
          f"(1, 1) NCCL): logits and the returned cache bitwise the "
          f"single-device prefill: {bitwise}; wall {wall:.2f} s; peak device "
          f"memory {peak / 2 ** 30:.2f} GiB {'ok' if bitwise and finite else 'FAIL'}"
          f" ({card})")
    if not (bitwise and finite):
        raise AssertionError("phase 30 (c) prefill setup differs")
    del setup, params, local, logits, cache, rl, rc
    torch.cuda.empty_cache()


def sharded_serving(torch, np, ops, da, results, card):
    """Phase 30: (a) the decode kernel's shard variant, (b) the decode
    setups at full width and depth, (c) the prefill setup.  Returns the
    decode-attention launches of (b)."""
    t0 = time.monotonic()
    decode_shard_kernel(torch, da, results, card)
    ta = time.monotonic()
    launches, worst = 0, 0.0
    with world_of_one():
        for arch, shape_name, B, S in SERVE_LEGS:
            n, err = serving_leg(torch, np, ops, da, arch, shape_name, B, S,
                                 card)
            launches += n
            worst = max(worst, err)
        tb = time.monotonic()
        prefill_leg(torch, card)
    results["decode_attention"]["phase30_setup_max_abs_err"] = worst
    print(f"phase 30: {time.monotonic() - t0:.1f} s ((a) {ta - t0:.1f}, (b) "
          f"{tb - ta:.1f}, (c) {time.monotonic() - tb:.1f})")
    return launches


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "__init__.py").exists():
        print(f"chip_smoke: the port (src/repro_torch) is not next to "
              f"{Path(__file__).name}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    OUT.mkdir(exist_ok=True)
    t_start = time.monotonic()
    last = [t_start]

    def stamp(label):
        """Print the seconds since the last stamp (phases 1-20)."""
        now = time.monotonic()
        print(f"{label}: {now - last[0]:.1f} s")
        last[0] = now

    # phase 1: device and build
    card = smi()
    print(f"device: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; {torch.cuda.get_device_name(0)}; "
          f"{os.cpu_count()} host cores")
    print(host_yardstick(torch))
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import masked_adam as ma
    from repro_torch.kernels import rglru_scan as rs
    from repro_torch.kernels import scatter_apply as sa
    t0 = time.monotonic()
    build.build_all()
    print(f"kernel build: {time.monotonic() - t0:.1f} s "
          f"(nvcc sm_90a, one process per source, in parallel)")
    for name, info in build.BUILD_INFO.items():
        (OUT / f"ptxas_{name}.txt").write_text(info["log"])
        wants = {"decode_attention": ["Li128ELi2E",       # hd 128, G 2
                                      "Li128ELi4E",       # hd 128, G 4
                                      "Li64ELi3E",        # hd 64, G 3
                                      "Li64ELi1E",        # hd 64, G 1
                                      "Li256ELi4E",       # hd 256, G 4
                                      "Li256ELi8E",       # hd 256, G 8
                                      "Li128ELi1E",       # hd 128, G 1
                                      "Li256ELi10E",      # f32 cache, G 10
                                      # bf16 cache, G 10: tensor cores
                                      "decode_attention_g10_mma_kernel"],
                 "paged_decode_attention": ["Li128ELi2ELb1E",
                                            "Li64ELi3ELb1E",
                                            "Li256ELi4ELb1E",
                                            "Li256ELi8ELb1E"],
                 "scatter_swap": ["scatter_swap"],
                 "rglru_scan": ["rglru_scan"],
                 # bf16 on the tensor cores at hd 128 and hd 256; f32
                 "flash_attention": [
                     "flash_attention_mma_kernelILi128E",
                     "flash_attention_mma_kernelILi256E",
                     "flash_attention_kernelILi128ELi64E"],
                 # f32 p, stored mask: the main path's instantiations
                 "masked_adam": ["masked_adam_kernelIfLb0ELb1E",
                                 "masked_adam_q8_kernelIfLb0ELb1E"]}[name]
        for want in wants:
            rows, most = ptxas_summary(info["log"], want)
            if want == wants[0]:
                print(f"  {name}: {info['seconds']:.1f} s, compiled="
                      f"{info['compiled']}, max registers over all entries "
                      f"{most}")
            for entry, line in rows:
                at = max(entry.find("decode_attention"),
                         entry.find("flash_attention"))
                short = entry[entry.find(name) if at < 0 else at:][:60]
                print(f"    {short}: "
                      f"{line.replace('ptxas info    : ', '')}")
                # the tensor-core kernels and the decode body's model
                # instantiations must not spill
                spill = re.search(r"(\d+) bytes spill stores", line)
                if ("mma" in want or "decode_attention" in name) \
                        and spill and int(spill.group(1)):
                    raise AssertionError(f"{short} spills: {line}")
        if name == "rglru_scan":
            # nor the scan kernels, forward and backward
            rows, _ = ptxas_summary(info["log"], "rglru_scan_kernel")
            if sum("Used" in l for _, l in rows) != 2:
                raise AssertionError(f"ptxas reported {len(rows)} lines for "
                                     f"the 2 scan kernels")
            for entry, line in rows:
                if re.search(r"[1-9]\d* bytes spill stores", line):
                    raise AssertionError(f"{entry} spills: {line}")
        if name in ("decode_attention", "paged_decode_attention"):
            # nor any instantiation of the shared decode body
            rows, _ = ptxas_summary(info["log"], "decode_attention_kernel")
            regs = [int(l.split("Used")[1].split("registers")[0])
                    for _, l in rows if "Used" in l]
            spills = [e for e, l in rows if re.search(
                r"[1-9]\d* bytes spill stores", l)]
            print(f"    decode_attention_kernel: {len(regs)} "
                  f"instantiations, {min(regs)}-{max(regs)} registers, "
                  f"{len(spills)} spilling")
            if spills:
                raise AssertionError(f"{name}: {spills[0]} spills")

    stamp("phase 1")
    # phases 2 + 3
    results = {}
    check_decode_attention(torch, da, results)
    check_scatter_swap(torch, sa, results)
    torch.cuda.empty_cache()

    stamp("phases 2 + 3")
    # phase 4: the main path through the launcher a user calls
    from repro_torch.launch import serve
    argv = ["--arch", ARCH, "--reduce", "0", "--attn-impl", "kernel",
            "--demo-adapters", "2", "--slots", "8", "--max-seq", "1024",
            "--requests", "16", "--new-tokens", "32"]
    print(f"main path: python -m repro_torch.launch.serve {' '.join(argv)}")
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    reqs = serve.main(argv)
    torch.cuda.synchronize()
    main_s = time.monotonic() - t0
    launches = dict(ops.LAUNCHES)
    tok = sum(len(r.out) for r in reqs)
    print(f"main path: {tok} tokens, {main_s:.2f} s wall including init "
          f"and adapter build, launches {launches}, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    if tok != 16 * 32:
        raise AssertionError(f"main path emitted {tok} tokens, not 512")
    missing = [k for k in SERVE_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing}")
    torch.cuda.empty_cache()
    serve_long_prompts(torch, np)
    torch.cuda.empty_cache()

    stamp("phase 4")
    # phase 5
    teacher_forced(torch, np)
    torch.cuda.empty_cache()
    profile_decode(torch, np)
    torch.cuda.empty_cache()

    stamp("phase 5")
    # phase 6: the training kernels against their plain versions, times
    check_masked_adam(torch, ma, results)
    time_masked_adam(torch, ops, results)
    reference_small(torch, np)
    torch.cuda.empty_cache()

    stamp("phase 6")
    # phase 7: the training main path through the launcher
    t_launches, q8_peak, q8_report, q8_p50 = train_main_path(torch, np, ops)

    stamp("phase 7")
    # phase 8: the f32 kernel path and the memory comparison via the API
    f32_launches, peaks = train_api(torch, np, ops, q8_peak, q8_report,
                                    q8_p50)

    stamp("phase 8")
    # phase 9: checkpoint -> crash -> resume -> export -> serve, 2 layers
    checkpoint_export_serve(torch, np, ops)

    stamp("phase 9")
    # phase 10: the fused paged kernel against its plain version and the
    # dense kernel, and its times
    check_paged_decode_attention(torch, np, da, results)
    torch.cuda.empty_cache()

    stamp("phase 10")
    # phase 11: the paged main path through the launcher, against dense
    p_launches, p_streams = paged_main_path(torch, np, ops)

    stamp("phase 11")
    # phase 12: a tight page pool, then speculative decoding
    paged_tight_pool(torch, np)
    paged_speculative(torch, np, ops, p_streams)

    stamp("phase 12")
    # phase 13: the paged decode step against the dense one, alternating,
    # and its profile beside the dense one's
    paged_vs_dense_steps(torch, np)
    profile_decode(torch, np, paged=True)
    torch.cuda.empty_cache()

    stamp("phase 13")
    # phase 14: the RG-LRU scan kernel against its plain version, times
    check_rglru_scan(torch, rs, ops, results)

    stamp("phase 14")
    # phase 15: the decode kernel at recurrentgemma-2b's local layers
    check_decode_attention_g10(torch, da, results)

    stamp("phase 15")
    # phase 16: BlockLLM training of recurrentgemma-2b through the launcher
    rg_launches, _ = rg_train(torch, np, ops)

    stamp("phase 16")
    # phase 17: checkpoint -> crash -> resume -> export -> serve, 5 layers
    # (both stage shapes), 2 slots so slots are reused.  Every stack has
    # one row here, so each trained leaf changes in all its rows and the
    # delta holds whole leaves, swapped in without the swap kernel
    checkpoint_export_serve(torch, np, ops, arch=RG_ARCH, layers=5, slots=2)

    stamp("phase 17")
    # phase 18: the flash-attention kernel against its plain version over
    # the sweep, and its times at the two main shapes
    from repro_torch.kernels import flash_attention as fa
    check_flash_attention(torch, fa, results)

    stamp("phase 18")
    # phase 19: the op through autograd (kernel forward, chunked backward)
    # under the kernel profiler; its launches are the path's count
    fa_launches, fa_times = flash_op(torch, fa, ops)

    stamp("phase 19")
    # phase 20: long-context BlockLLM training through the trainer API
    long_ctx = long_context_train(torch, np, ops)

    stamp("phase 20")
    # phase 21: three q8 tenants served without and with the device
    # AdapterCache (streams equal), then the launcher with --cache-bytes
    t0 = time.monotonic()
    print(f"phases 1-20: {t0 - t_start:.1f} s")
    q8_cache_serving(torch, np, ops, card)

    # phase 22: the paper's baselines through the launcher at 8 x 256,
    # and the eight-core peak-memory table
    t1 = time.monotonic()
    print(f"phase 21: {t1 - t0:.1f} s")
    baselines_train(torch, np, ops, peaks, card)
    t2 = time.monotonic()
    print(f"phase 22: {t2 - t1:.1f} s")

    # phase 23: the serving fleet: one server's streams, the Router at 1
    # and 2 replicas, a kill with replay, failed registry reads
    fleet_launches = fleet_serving(torch, np, ops, card)
    t3 = time.monotonic()
    print(f"phase 23: {t3 - t2:.1f} s; fleet launches "
          f"(adapter_read_error leg) "
          f"{ {k: fleet_launches[k] for k in SERVE_KERNELS} } ({card})")

    # phase 24: the MoE family: decode attention at G = 3, card vs CPU,
    # BlockLLM training of granite-moe-3b-a800m, crash -> resume ->
    # export -> serve, serving dense and paged
    _, moe_legs = moe_family(torch, np, ops, da, results, card)
    t4 = time.monotonic()
    print(f"phase 24: {t4 - t3:.1f} s")
    results["decode_attention"]["g3_launches"] = \
        moe_legs["dense"]["launches"]["decode_attention"]
    results["paged_decode_attention"]["g3_launches"] = \
        moe_legs["paged"]["launches"]["paged_decode_attention"]

    # phase 25: the xLSTM family: card vs CPU, BlockLLM training of
    # xlstm-1.3b, crash -> resume -> export -> serve, serving
    x_train, x_serve = xlstm_family(torch, np, ops, card)
    t5 = time.monotonic()
    print(f"phase 25: {t5 - t4:.1f} s")

    # phase 26: the whisper encoder-decoder: decode attention at G = 1,
    # card vs CPU, BlockLLM training of whisper-large-v3, crash -> resume
    # -> export -> apply, full-depth decode
    w_train, w_swaps, w_decode = whisper_family(torch, np, ops, da, results,
                                                card)
    t6 = time.monotonic()
    print(f"phase 26: {t6 - t5:.1f} s")
    results["decode_attention"]["g1_launches"] = \
        w_decode["decode_attention"]

    # phase 27: the pixtral VLM: decode attention at G = 4, card vs CPU,
    # BlockLLM training at 8 layers, crash -> resume -> export -> apply,
    # full-depth decode; whole-sequence prefill of the recurrent families
    p_train, p_swaps, p_decode, p_scans = pixtral_family(torch, np, ops, da,
                                                         results, card)
    t7 = time.monotonic()
    print(f"phase 27: {t7 - t6:.1f} s")
    results["decode_attention"]["g4_launches"] = \
        p_decode["decode_attention"]
    results["rglru_scan"]["prefill_launches"] = p_scans

    # phase 28: the rest of the zoo: the decode kernels at G = 4 / 8, hd
    # 256 and G = 1, hd 128, KV 32; gemma3-1b, gemma-2b and deepseek-7b
    # card vs CPU, BlockLLM training through the launcher, serving at
    # full width and depth
    zoo = zoo_family(torch, np, ops, da, results, card)
    print(f"phase 28: {time.monotonic() - t7:.1f} s")
    zoo_legs = [leg for a in ZOO_ARCHS for leg in zoo[a]["legs"].values()]
    for name in ("decode_attention", "paged_decode_attention"):
        results[name]["zoo_launches"] = sum(leg["launches"][name]
                                            for leg in zoo_legs)
    zoo_swaps = sum(leg["launches"]["scatter_swap"] for leg in zoo_legs)
    zoo_adam = sum(zoo[a]["train"]["masked_adam"] for a in ZOO_ARCHS)

    # phase 29: distributed BlockLLM training (build_train_setup ->
    # StepSetup.shard -> 3 calls) over NCCL at world size 1, bitwise the
    # single-device step; the int8 error-feedback all-reduce
    dist_adam = distributed_train(torch, np, ops, card)

    # phase 30: the sharded serving setups: the decode kernel's shard
    # variant against one whole-cache call, the decode setups of
    # gemma3-1b (long_500k) and internlm2-1.8b (decode_32k, one data
    # rank's share) and gemma3-1b's prefill setup at world size 1 over
    # NCCL, bitwise the single-device steps
    serve_setup_launches = sharded_serving(torch, np, ops, da, results, card)
    results["decode_attention"]["phase30_launches"] = serve_setup_launches

    # summary: launches are each kernel's count on its path's run:
    # serving main path, training main path (Q8), the f32 API run, the
    # paged serving main path; the swap and the f32 masked Adam add the
    # xLSTM serving and training runs (phase 25), the whisper apply and
    # training runs (phase 26), the pixtral ones (phase 27) and the zoo's
    # serving and training runs (phase 28), whose decode launches add to
    # both decode kernels' counts
    launches = {"decode_attention": (launches["decode_attention"]
                                     + results["decode_attention"][
                                         "zoo_launches"]
                                     + serve_setup_launches),
                "scatter_swap": (launches["scatter_swap"]
                                 + x_serve["scatter_swap"] + w_swaps
                                 + p_swaps + zoo_swaps),
                "paged_decode_attention": (
                    p_launches["paged_decode_attention"]
                    + results["paged_decode_attention"]["zoo_launches"]),
                "masked_adam_q8": t_launches["masked_adam_q8"],
                "masked_adam": (f32_launches["masked_adam"]
                                + x_train["masked_adam"]
                                + w_train["masked_adam"]
                                + p_train["masked_adam"] + zoo_adam
                                + dist_adam),
                "rglru_scan": rg_launches["rglru_scan"],
                "rglru_scan_bwd": rg_launches["rglru_scan_bwd"],
                "flash_attention": fa_launches["flash_attention"]}
    zoo_names = ", ".join(ZOO_ARCHS)
    path_of = {"decode_attention": f"serving main path, the {zoo_names} "
                                   f"serving runs and the phase 30 decode "
                                   f"setups",
               "scatter_swap": f"serving main path, the {XLSTM_ARCH} "
                               f"serving run, the {WHISPER_ARCH} and "
                               f"{PIXTRAL_ARCH} applies and the gemma-2b "
                               f"tenant's serving runs",
               "paged_decode_attention": f"paged serving main path and the "
                                         f"gemma3-1b and gemma-2b paged "
                                         f"serving runs",
               "masked_adam_q8": "training main path (blockllm+q8)",
               "masked_adam": f"blockllm f32 run (fused_update='kernel'), "
                              f"the {XLSTM_ARCH}, {WHISPER_ARCH}, "
                              f"{PIXTRAL_ARCH} and {zoo_names} training "
                              f"main paths and the distributed step "
                              f"(phase 29)",
               "rglru_scan": f"{RG_ARCH} training main path (forward "
                             f"and remat recompute)",
               "rglru_scan_bwd": f"{RG_ARCH} training main path "
                                 f"(backward)",
               "flash_attention": "flash_attention op (forward kernel, "
                                  "chunked backward)"}
    csrc = "src/repro_torch/kernels/csrc/"
    sources = {"decode_attention": csrc + "decode_attention.cu",
               "scatter_swap": csrc + "scatter_swap.cu",
               "paged_decode_attention": csrc + "paged_decode_attention.cu",
               "masked_adam": csrc + "masked_adam.cu",
               "masked_adam_q8": csrc + "masked_adam.cu",
               "rglru_scan": csrc + "rglru_scan.cu",
               "rglru_scan_bwd": csrc + "rglru_scan.cu",
               "flash_attention": csrc + "flash_attention.cu"}
    replaces = {"decode_attention": "src/repro/kernels/decode_attention.py:186",
                "scatter_swap": "src/repro/kernels/scatter_apply.py:81",
                "paged_decode_attention":
                    "src/repro/kernels/decode_attention.py:352",
                "masked_adam": "src/repro/kernels/masked_adam.py:152",
                "masked_adam_q8": "src/repro/kernels/masked_adam.py:117",
                "rglru_scan": "src/repro/kernels/rglru_scan.py:67",
                # the same kernel, reversed, in JAX's backward (ops.py:499)
                "rglru_scan_bwd": "src/repro/kernels/rglru_scan.py:67",
                "flash_attention": "src/repro/kernels/flash_attention.py:101"}
    kernels = []
    for name in ("decode_attention", "scatter_swap", "paged_decode_attention",
                 "masked_adam", "masked_adam_q8", "rglru_scan",
                 "rglru_scan_bwd",
                 "flash_attention"):
        r = results[name]
        kernels.append({"name": name, "route": "cuda",
                        "source": sources[name], "replaces": replaces[name],
                        "launches": launches[name], **r})
        print(f"kernels: {name} launches {launches[name]} on the "
              f"{path_of[name]}, parity ok (max_abs_err "
              f"{r['max_abs_err']:.3g}), {r['ms']:.4f} ms vs bound "
              f"{r['bound_ms']:.4f} ms")
    print(f"total {time.monotonic() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
